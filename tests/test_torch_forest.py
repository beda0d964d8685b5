"""The port's forest descent and tree predict against the JAX package's.

Both run on the CPU: the JAX package through its XLA path (and, where the
JAX tests do so too, its Pallas kernels in interpret mode), the port through
the plain PyTorch versions of its kernels. Inputs are made with numpy from
a seed and handed to both.

Tolerances: leaf ids and slots must match exactly; forest sums within
rtol 1e-5, atol 1e-6 (the JAX package sums trees through a one-hot matmul,
the port tree after tree: same terms, another order); probabilities
within atol 1e-6, predictions exactly wherever |p - 0.5| > 1e-5.
"""
from __future__ import annotations

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from transmogrifai_tpu.models.api import (
    MODEL_REGISTRY as JAX_FAMILIES, FittedParams as JaxFitted,
)
from transmogrifai_tpu.models import trees as jt
from transmogrifai_tpu.ops import forest as jf
from transmogrifai_tpu_torch.models import trees as tt
from transmogrifai_tpu_torch.models.api import (
    MODEL_REGISTRY as PORT_FAMILIES, FittedParams as PortFitted,
)
from transmogrifai_tpu_torch.ops import forest as tf
from transmogrifai_tpu_torch.testing import random_chain, random_heap

RTOL, ATOL = 1e-5, 1e-6
PROB_ATOL = 1e-6
PRED_MARGIN = 1e-5
NB = 32


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


@pytest.fixture
def reference_path(request, monkeypatch):
    """JAX package path under test: 'xla' (its CPU default) or 'pallas'
    (its kernels in interpret mode, as its own tests run them)."""
    monkeypatch.setenv("TG_TREE_PALLAS",
                       "1" if request.param == "pallas" else "0")
    jax.clear_caches()
    return request.param


def _mask_trees(rng, leaf):
    """Zero a random third of the trees' leaves: masked trees."""
    out = leaf.copy()
    out[rng.rand(leaf.shape[0]) < 0.33] = 0.0
    return out


#: JAX's XLA descent, compiled once per shape (op-by-op dispatch of its
#: per-level gathers costs seconds per case on the CPU)
_jax_route = jax.jit(jf.route_codes_xla, static_argnums=(3, 4))
_jax_predict = jax.jit(jf.forest_predict, static_argnames=("depth", "n_bins"))
_jax_route_chain = jax.jit(jf.route_codes_chain_xla, static_argnums=(4,))
_jax_predict_chain = jax.jit(jf.forest_predict_chain,
                             static_argnames=("n_bins",))


@pytest.mark.parametrize("reference_path", ["xla"], indirect=True)
@pytest.mark.parametrize("depth,T,k", [
    (1, 1, 1), (2, 17, 3), (3, 130, 1), (4, 5, 3), (5, 64, 1), (6, 20, 1),
    (7, 128, 3), (8, 130, 1)])
def test_heap_matches_jax(reference_path, depth, T, k):
    rng = np.random.RandomState(100 * depth + T)
    h = random_heap(rng, 150, 7, T, depth, k, NB)
    h["leaf"] = _mask_trees(rng, h["leaf"])
    want_ids = np.asarray(_jax_route(
        _j(h["codes"]), _j(h["feat"]), _j(h["bins"]), depth, NB))
    got_ids = tf.route_codes(_t(h["codes"]), _t(h["feat"]), _t(h["bins"]),
                             depth, NB)
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    want = np.asarray(_jax_predict(
        _j(h["codes"]), _j(h["feat"]), _j(h["bins"]), _j(h["leaf"]),
        depth=depth, n_bins=NB))
    got = tf.forest_predict(_t(h["codes"]), _t(h["feat"]), _t(h["bins"]),
                            _t(h["leaf"]), depth=depth, n_bins=NB)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("reference_path", ["xla", "pallas"], indirect=True)
def test_heap_matches_jax_pallas_kernel(reference_path):
    rng = np.random.RandomState(11)
    h = random_heap(rng, 270, 6, 9, 5, 3, NB)
    want = np.asarray(jf.forest_predict(
        _j(h["codes"]), _j(h["feat"]), _j(h["bins"]), _j(h["leaf"]),
        depth=5, n_bins=NB))
    got = tf.forest_predict(_t(h["codes"]), _t(h["feat"]), _t(h["bins"]),
                            _t(h["leaf"]), depth=5, n_bins=NB)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("reference_path", ["xla"], indirect=True)
@pytest.mark.parametrize("W,T,k", [(4, 130, 1), (64, 1, 3), (256, 33, 1),
                                   (256, 130, 3)])
def test_chain_matches_jax(reference_path, W, T, k):
    rng = np.random.RandomState(W + T)
    c = random_chain(rng, 120, 9, T, 12, W, k, NB)
    c["leaf"] = _mask_trees(rng, c["leaf"])
    jargs = [_j(c[key]) for key in ("codes", "feat", "bins", "base")]
    targs = [_t(c[key]) for key in ("codes", "feat", "bins", "base")]
    want_ids = np.asarray(_jax_route_chain(*jargs, NB))
    np.testing.assert_array_equal(
        tf.route_codes_chain(*targs, NB).numpy(), want_ids)
    want = np.asarray(_jax_predict_chain(*jargs, _j(c["leaf"]), n_bins=NB))
    got = tf.forest_predict_chain(*targs, _t(c["leaf"]), n_bins=NB)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("reference_path", ["pallas"], indirect=True)
def test_chain_matches_jax_pallas_kernel(reference_path):
    rng = np.random.RandomState(12)
    c = random_chain(rng, 100, 5, 40, 12, 64, 2, NB)
    keys = ("codes", "feat", "bins", "base", "leaf")
    want = np.asarray(jf.forest_predict_chain(*[_j(c[k]) for k in keys],
                                              n_bins=NB))
    got = tf.forest_predict_chain(*[_t(c[k]) for k in keys], n_bins=NB)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_bins_and_slots_above_256_raise_in_both():
    rng = np.random.RandomState(13)
    h = random_heap(rng, 10, 3, 2, 2, 1, NB)
    for mod, conv in ((jf, _j), (tf, _t)):
        with pytest.raises(ValueError, match="n_bins=257"):
            mod.forest_predict(conv(h["codes"]), conv(h["feat"]),
                               conv(h["bins"]), conv(h["leaf"]), depth=2,
                               n_bins=257)
    c = random_chain(rng, 10, 3, 2, 10, 257, 1, NB)
    keys = ("codes", "feat", "bins", "base", "leaf")
    for mod, conv in ((jf, _j), (tf, _t)):
        with pytest.raises(ValueError, match="n_slots=257"):
            mod.forest_predict_chain(*[conv(c[k]) for k in keys], n_bins=NB)


def test_non_cpu_non_cuda_tensors_raise():
    codes = torch.zeros((2, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no forest kernel"):
        tf.forest_predict(codes, codes, codes,
                          torch.zeros((2, 4, 1), device="meta"), depth=2,
                          n_bins=NB)


def test_cuda_wrappers_refuse_cpu_tensors():
    rng = np.random.RandomState(14)
    h = {k: _t(v) for k, v in random_heap(rng, 5, 3, 2, 2, 1, NB).items()}
    before = tf.FOREST_PREDICT_HEAP.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tf.forest_predict_heap_cuda(h["codes"], h["feat"], h["bins"],
                                    h["leaf"], depth=2, n_bins=NB)
    assert tf.FOREST_PREDICT_HEAP.launches == before


# ---------------------------------------------------------------------------
# Tree families: binning and the predict functions
# ---------------------------------------------------------------------------

def _edges_and_X(rng, n, d, nb):
    edges = np.sort(rng.randn(d, nb - 1).astype(np.float32), axis=1)
    edges[:, 5] = edges[:, 4]                       # a tied edge
    X = rng.randn(n, d).astype(np.float32)
    X[: d, :] = edges[:, 4][None, :]                # values ON an edge
    return edges, X


def test_bin_features_counts_edges_strictly_below():
    rng = np.random.RandomState(15)
    edges, X = _edges_and_X(rng, 64, 6, NB)
    want = np.asarray(jt._bin_features(_j(X), _j(edges)))
    got = tt._bin_features(_t(X), _t(edges))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _compare_parts(family, params, X, num_classes):
    jfit = JaxFitted(family, params, {}, num_classes)
    want = JAX_FAMILIES[family].predict_one(jfit, jnp.asarray(X))
    pfit = PortFitted(family, tt.params_from_numpy(params, "cpu"), {},
                      num_classes)
    got = PORT_FAMILIES[family].predict_one(pfit, _t(X))
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["probability"], want["probability"],
                               rtol=0, atol=PROB_ATOL)
    np.testing.assert_allclose(got["rawPrediction"], want["rawPrediction"],
                               rtol=1e-5, atol=1e-5)
    p = want["probability"]
    far = (np.abs(p - 0.5) > PRED_MARGIN).all(axis=1)
    np.testing.assert_array_equal(got["prediction"][far],
                                  want["prediction"][far])
    return got


def _rf_chain_params(rng, d, T, C, mask):
    c = random_chain(rng, 1, d, T, 12, 64, C, NB)
    leaf = np.abs(c["leaf"])
    leaf /= leaf.sum(-1, keepdims=True)             # per-leaf class shares
    edges, _ = _edges_and_X(rng, 1, d, NB)
    return {"feat_lv": c["feat"], "bins_lv": c["bins"], "base_lv": c["base"],
            "thresh_lv": np.zeros(c["feat"].shape, np.float32),
            "leaf": leaf.astype(np.float32), "edges": edges,
            "tree_mask": mask.astype(np.float32)}


@pytest.mark.parametrize("mask", ["some", "none_left"])
def test_rf_binary_chain_routes_class1_and_averages_unmasked(mask):
    rng = np.random.RandomState(16)
    T, d = 12, 6
    m = (rng.rand(T) < 0.6) if mask == "some" else np.zeros(T)
    params = _rf_chain_params(rng, d, T, 2, m)
    _, X = _edges_and_X(rng, 90, d, NB)
    got = _compare_parts("OpRandomForestClassifier", params, X, 2)
    if mask == "none_left":     # divided by max(0, 1): every p1 is 0
        np.testing.assert_array_equal(got["probability"][:, 1], 0.0)


@pytest.mark.parametrize("num_classes", [2, 3])
def test_rf_heap_matches_jax(num_classes):
    rng = np.random.RandomState(17 + num_classes)
    T, d, depth = 9, 5, 4
    h = random_heap(rng, 1, d, T, depth, num_classes, NB)
    leaf = np.abs(h["leaf"])
    leaf /= leaf.sum(-1, keepdims=True)
    edges, X = _edges_and_X(rng, 80, d, NB)
    params = {"feat": h["feat"], "bins": h["bins"],
              "thresh": np.zeros(h["feat"].shape, np.float32),
              "leaf": leaf.astype(np.float32), "edges": edges,
              "tree_mask": (rng.rand(T) < 0.7).astype(np.float32)}
    _compare_parts("OpRandomForestClassifier", params, X, num_classes)


@pytest.mark.parametrize("layout", ["heap", "chain"])
def test_gbt_binary_margins_sigmoid_and_raw(layout):
    rng = np.random.RandomState(19)
    T, d = 14, 6
    edges, X = _edges_and_X(rng, 100, d, NB)
    if layout == "heap":
        h = random_heap(rng, 1, d, T, 6, 1, NB)
        params = {"feat": h["feat"][:, None], "bins": h["bins"][:, None],
                  "thresh": np.zeros((T, 1, 63), np.float32),
                  "leaf": h["leaf"][:, None, :, 0]}
    else:
        c = random_chain(rng, 1, d, T, 12, 64, 1, NB)
        params = {"feat_lv": c["feat"][:, None], "bins_lv": c["bins"][:, None],
                  "base_lv": c["base"][:, None],
                  "thresh_lv": np.zeros((T, 1, 12, 64), np.float32),
                  "leaf": c["leaf"][:, None, :, 0]}
    params.update(edges=edges, f0=np.array([0.3], np.float32),
                  eta=np.array(0.1, np.float32),
                  tree_mask=(rng.rand(T) < 0.8).astype(np.float32))
    got = _compare_parts("OpGBTClassifier", params, X, 2)
    np.testing.assert_allclose(
        got["rawPrediction"],
        np.log(np.maximum(got["probability"], 1e-12)), rtol=1e-6)


def test_n_bins_comes_from_the_edge_table():
    """A 40-bin model: n_bins = edges.shape[-1] + 1 = 41 is the sentinel."""
    rng = np.random.RandomState(20)
    T, d, nb = 6, 4, 41
    h = random_heap(rng, 1, d, T, 3, 2, nb)
    assert (h["bins"] == nb).any()
    leaf = np.abs(h["leaf"])
    leaf /= leaf.sum(-1, keepdims=True)
    edges, X = _edges_and_X(rng, 60, d, nb)
    params = {"feat": h["feat"], "bins": h["bins"],
              "leaf": leaf.astype(np.float32), "edges": edges,
              "tree_mask": np.ones(T, np.float32)}
    _compare_parts("OpRandomForestClassifier", params, X, 2)
