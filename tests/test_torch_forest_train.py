"""The RF/DT training slice of the PyTorch port against the JAX package:
the slot-chain grower, the Gini gain, the depth grouping and the RF and DT
fits, all on the CPU (the leaf-sum entry points are in
``test_torch_leaf_sums.py``, the end-to-end trains in
``test_torch_forest_e2e.py``).

Tolerances (stated once, used throughout):

* bin edges and codes, split tables (feat, bins, base), node and slot
  assignments, tree masks, kept columns and the winner: equal;
* RF/DT leaf values (shares of integer class counts): within 1e-6;
* split thresholds: equal. They are ``edges[f, b]`` of the chosen split,
  which XLA evaluates inside the fused gather with other rounding than
  the edge table it returns in some programs (``trees._thr_table``);
The JAX package pins ``jax_threefry_partitionable`` on when it is
imported, so its RF bootstrap draws as in production here.
"""
from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from transmogrifai_tpu.models import trees as jtrees  # noqa: E402
from transmogrifai_tpu_torch.models import trees as ptrees  # noqa: E402
from transmogrifai_tpu_torch.utils.padding import bucket_for  # noqa: E402

LEAF_TOL = 1e-6
TABLES = ("feat", "bins", "feat_lv", "bins_lv", "base_lv", "edges",
          "tree_mask", "thresh", "thresh_lv")


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_params_match(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        if k in TABLES:
            np.testing.assert_array_equal(g, w, err_msg=k)
            if k.startswith("thresh"):      # bit for bit
                np.testing.assert_array_equal(g.view(np.int32),
                                              w.view(np.int32), err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=LEAF_TOL,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# the slot-chain grower
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chain_grow_reference():
    """The JAX package's chain grower on the inputs of its own
    ``test_chain_sibling_subtraction_parity``."""
    out = {}
    for mode, W, depth in (("counts", 8, 5), ("counts", 16, 7),
                           ("gh", 8, 6)):
        rng = np.random.RandomState(11)
        S, d, Tb, nb = 512, 6, 12, 16
        codes = rng.randint(0, nb, size=(S, d), dtype=np.int32)
        edges = np.sort(rng.randn(d, nb - 1).astype(np.float32), axis=1)
        k = 2 if mode == "counts" else 3
        sw = [rng.rand(S, Tb).astype(np.float32) + 0.1 for _ in range(k)]
        cfg = {"max_depth": np.full(Tb, float(depth), np.float32),
               "min_instances": np.full(Tb, 1.0, np.float32),
               "min_info_gain": np.full(Tb, 1e-4, np.float32),
               "lam": np.full(Tb, 1e-6, np.float32),
               "min_child_weight": np.zeros(Tb, np.float32)}
        fmasks = np.ones((Tb, d), bool)
        fmasks[3, :2] = False
        # jitted, as inside the JAX package's fits: run op by op, XLA
        # fuses no multiply-adds and tie-close gains round otherwise
        grow = jax.jit(lambda c, e, s, f, g, depth=depth, mode=mode, W=W:
                       jtrees._grow_forest_capped(
                           c, e, s, f, g, depth=depth, n_bins=nb, mode=mode,
                           n_slots=W))
        want = grow(jnp.asarray(codes), jnp.asarray(edges),
                    list(map(jnp.asarray, sw)), jnp.asarray(fmasks),
                    {k_: jnp.asarray(v) for k_, v in cfg.items()})
        out[(mode, W, depth)] = ((codes, edges, sw, fmasks, cfg),
                                 [np.asarray(a) for a in want])
    return out


@pytest.mark.parametrize("sibling", [False, True])
@pytest.mark.parametrize("case", [("counts", 8, 5), ("counts", 16, 7),
                                  ("gh", 8, 6)])
def test_grow_forest_capped_matches_jax(chain_grow_reference, case, sibling,
                                        monkeypatch):
    (codes, edges, sw, fmasks, cfg), want = chain_grow_reference[case]
    monkeypatch.setattr(ptrees, "_CHAIN_SIBLING_MIN_TB",
                        1 if sibling else 1 << 30)
    mode, W, depth = case
    got = ptrees._grow_forest_capped(
        _t(codes), _t(edges), list(map(_t, sw)), _t(fmasks),
        {k: _t(v) for k, v in cfg.items()}, depth=depth, n_bins=16,
        mode=mode, n_slots=W)
    for name, g, w in zip(("feat_lv", "thr_lv", "bin_lv", "base_lv",
                           "node_s"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_gini_gain_is_bit_equal_to_jax():
    """XLA on the CPU fuses the Gini sums of squares and both subtractions
    into multiply-adds; tie-close gains pick their splits by those bits."""
    rng = np.random.RandomState(0)
    m, d, nb = 64, 6, 32
    for k in (2, 3):
        hist = (rng.poisson(3, (m, d, nb, k))
                * rng.choice([1.0, 2.40625, 0.5], (m, 1, 1, 1))
                ).astype(np.float32)
        cum = np.cumsum(hist, axis=2)
        total, SL = cum[:, 0, -1, :], cum[:, :, :-1, :]
        SR = total[:, None, None, :] - SL
        mi = np.full(m, 5.0, np.float32)
        want, wv = jax.jit(lambda a, b, c, e: jtrees._split_gain(
            a, b, c, {"min_instances": e}, "counts"))(
            jnp.asarray(SL), jnp.asarray(SR), jnp.asarray(total),
            jnp.asarray(mi))
        got, gv = ptrees._split_gain(_t(SL), _t(SR), _t(total),
                                     {"min_instances": _t(mi)}, "counts")
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("nb", [2, 7, 16, 32, 37])
def test_cumsum_bins_is_bit_equal_to_jax(nb):
    """The grower's cumulative sum over the bins adds in XLA's CPU order
    (sequential within blocks of 16, then the block totals); on fractional
    stats ``torch.cumsum`` on the CPU (a float64 accumulator) rounds
    otherwise."""
    x = (np.random.RandomState(nb).randn(9, 4, nb, 3) * 10).astype(
        np.float32)
    want = jax.jit(lambda a: jnp.cumsum(a, axis=2))(jnp.asarray(x))
    got = ptrees._cumsum_bins(_t(x))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


# ---------------------------------------------------------------------------
# depth grouping
# ---------------------------------------------------------------------------

def _random_heap_params(rng, lead, depth, k, nb=32):
    H, L = 2 ** depth - 1, 2 ** depth
    return {"feat": rng.randint(0, 5, lead + (H,)).astype(np.int32),
            "bins": rng.randint(0, nb + 1, lead + (H,)).astype(np.int32),
            "thresh": rng.randn(*(lead + (H,))).astype(np.float32),
            "leaf": rng.rand(*(lead + (L, k))).astype(np.float32),
            "tree_mask": np.ones(lead[:1] + lead[1:2], np.float32),
            "edges": rng.randn(5, nb - 1).astype(np.float32)}


@pytest.mark.parametrize("d_small,d_big", [(3, 6), (6, 12), (3, 12)])
def test_heap_to_chain_and_embedding_are_exact(d_small, d_big):
    rng = np.random.RandomState(d_small + d_big)
    p = _random_heap_params(rng, (2, 4), d_small, 2)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    if d_big <= 8:
        pairs = [(ptrees._embed_depth(tp, d_small, d_big, 32, -2),
                  jtrees._embed_depth(jp, d_small, d_big, 32, -2))]
    else:
        got = ptrees._heap_to_chain(tp, d_small, d_big, 256, 32, -2)
        want = jtrees._heap_to_chain(jp, d_small, d_big, 256, 32, -2)
        pairs = [(got, want), (
            ptrees._pad_chain_depth(got, d_big, d_big + 2, 32, -2),
            jtrees._pad_chain_depth(want, d_big, d_big + 2, 32, -2))]
    for got, want in pairs:
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)


# ---------------------------------------------------------------------------
# RF and DT fits
# ---------------------------------------------------------------------------

def _fit_frame(n_fit=500, d=5, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n_fit, d).astype(np.float32)
    y = (X @ rng.randn(d).astype(np.float32) > 0).astype(np.float32)
    n = bucket_for(n_fit)
    X = np.concatenate([X, np.zeros((n - n_fit, d), np.float32)])
    y = np.concatenate([y, np.zeros(n - n_fit, np.float32)])
    W = np.zeros((3, n), np.float32)
    W[0, :n_fit] = 1.0
    W[1, :n_fit:2] = 1.0
    W[2, 1:n_fit:3] = 1.0
    return X, y, W


def _grid(**kw):
    return {k: np.asarray(v, np.float32) for k, v in kw.items()}


FITS = {
    "dt_mixed": ("DecisionTreeClassifierFamily",
                 _grid(maxDepth=[3, 6, 12], minInstancesPerNode=[5, 5, 5],
                       minInfoGain=[0.001] * 3)),
    "rf_chain": ("RandomForestClassifierFamily",
                 _grid(maxDepth=[12] * 3, minInstancesPerNode=[5] * 3,
                       minInfoGain=[0.001] * 3, numTrees=[20] * 3,
                       subsamplingRate=[1.0, 0.8, 0.5])),
    "rf_mixed": ("RandomForestClassifierFamily",
                 _grid(maxDepth=[3, 6, 12], minInstancesPerNode=[5] * 3,
                       minInfoGain=[0.001] * 3, numTrees=[4, 6, 5],
                       subsamplingRate=[1.0, 0.5, 0.8])),
}


#: (case, sweep): the mixed-depth RF grid refits only (its sweep runs the
#: same programs as the others')
FIT_CASES = [("dt_mixed", False), ("dt_mixed", True), ("rf_chain", False),
             ("rf_chain", True), ("rf_mixed", False)]


@pytest.fixture(scope="module")
def fits_reference():
    """The JAX package's fit_batch of each FITS case, sweep and refit."""
    jax.clear_caches()             # no program traced for its Pallas path
    X, y, W = _fit_frame()
    out = {}
    for key, sweep in FIT_CASES:
        fam, grid = FITS[key]
        jfam = getattr(jtrees, fam)()
        out[key, sweep] = jfam.fit_batch(
            jnp.asarray(X), jnp.asarray(y), jnp.asarray(W),
            {k: jnp.asarray(v) for k, v in grid.items()}, 2, sweep=sweep)
    return (X, y, W), out


@pytest.mark.parametrize("key,sweep", FIT_CASES)
def test_fit_batch_matches_jax(fits_reference, key, sweep):
    (X, y, W), ref = fits_reference
    fam, grid = FITS[key]
    pfam, jfam = getattr(ptrees, fam)(), getattr(jtrees, fam)()
    got = pfam.fit_batch(_t(X), _t(y), _t(W), grid, 2, sweep=sweep)
    want = ref[key, sweep]
    _assert_params_match(got, want)
    scores = pfam.predict_batch(got, _t(X[:200]), 2).numpy()
    np.testing.assert_allclose(scores, np.asarray(jfam.predict_batch(
        want, jnp.asarray(X[:200]), 2)), rtol=0, atol=LEAF_TOL)


def test_rf_sweep_caps_trees_and_chunks_stitch(fits_reference, monkeypatch):
    (X, y, W), ref = fits_reference
    fam, grid = FITS["rf_chain"]
    whole = ptrees.RandomForestClassifierFamily().fit_batch(
        _t(X), _t(y), _t(W), grid, 2, sweep=True)
    assert whole["feat_lv"].shape[1] == ptrees._SWEEP_RF_TREES
    monkeypatch.setattr(ptrees, "_CFG_CHUNK_ELEMS", 1)     # one per chunk
    chunked = ptrees.RandomForestClassifierFamily().fit_batch(
        _t(X), _t(y), _t(W), grid, 2, sweep=True)
    for k in whole:
        assert torch.equal(chunked[k], whole[k]), k


@pytest.mark.parametrize("sweep", [False, True])
def test_dt_fit_chunks_stitch(sweep, monkeypatch):
    """A DT fit grows as a one-tree forest per configuration; chunking its
    configurations one at a time changes no bit."""
    X, y, W = _fit_frame()
    fam, grid = FITS["dt_mixed"]
    whole = ptrees.DecisionTreeClassifierFamily().fit_batch(
        _t(X), _t(y), _t(W), grid, 2, sweep=sweep)
    monkeypatch.setattr(ptrees, "_CFG_CHUNK_ELEMS", 1)
    chunked = ptrees.DecisionTreeClassifierFamily().fit_batch(
        _t(X), _t(y), _t(W), grid, 2, sweep=sweep)
    assert sorted(chunked) == sorted(whole)
    for k in whole:
        assert torch.equal(chunked[k], whole[k]), k


@pytest.mark.parametrize("B,budget,folded", [(1, None, True),
                                             (3, None, False), (3, 1, True)])
def test_rf_fit_picks_the_cdf_table_of_its_chunking(B, budget, folded,
                                                    monkeypatch):
    """One chunk of several configurations draws with the run-time
    gammaln table, a refit or a chunked sweep with the folded one (the
    tables are held to the JAX package's programs in test_torch_rng.py)."""
    seen = []
    draw = ptrees.bootstrap.draw
    monkeypatch.setattr(ptrees.bootstrap, "draw",
                        lambda *a: seen.append(a[-1]) or draw(*a))
    if budget:
        monkeypatch.setattr(ptrees, "_CFG_CHUNK_ELEMS", budget)
    X, y, W = _fit_frame(n_fit=120, d=3)
    grid = _grid(maxDepth=[3] * B, numTrees=[2] * B)
    ptrees.RandomForestClassifierFamily().fit_batch(_t(X), _t(y), _t(W[:B]),
                                                    grid, 2, sweep=True)
    assert seen and set(seen) == {folded}


def test_default_grids_match_jax():
    for name in ("DecisionTreeClassifierFamily",
                 "RandomForestClassifierFamily"):
        assert getattr(ptrees, name)().default_grid("binary") == \
            getattr(jtrees, name)().default_grid("binary")
