"""The training slice of the PyTorch port against the JAX package.

Each fitted stage, the GBT grower and fit, the metrics, the splitter and
the folds get the same numpy inputs in both packages; a tiny end-to-end
train of ``transmogrify -> sanity_check -> selector`` runs in both and the
summaries, tree tables and probabilities are compared. Everything runs on
the CPU (``device="cpu"``).

Tolerances (stated once, used throughout):

* bin edges, bin codes, samples, fold masks, kept columns, removal
  reasons, split tables (feat/bins/thresh, and the slot chains'
  feat_lv/bins_lv/base_lv/thresh_lv), tree masks: equal;
* quantities summed in f32 in another order than XLA's (histograms, leaf
  sums, moments, correlations, metrics): rtol 1e-6 / atol 1e-6 against
  the JAX package where the inputs are identical, leaves within 1e-6;
* the end-to-end train: fold metrics and evaluations within 1e-5,
  probability_1 within 1e-5 (the sigmoid's ``exp`` differs between the
  two CPU backends in the last bit, so boosting state drifts by ulps).
"""
from __future__ import annotations

import os
import subprocess
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
sys.path.insert(0, os.path.join(REPO, "tests"))

from test_torch_serve import (  # noqa: E402
    TINY_D, TINY_MODELS, TINY_REALNN, jax_table, prediction_parts,
    score_frame, train_jax_model,
)
from transmogrifai_tpu.models import trees as jtrees  # noqa: E402
from transmogrifai_tpu.ops import metrics as jmetrics  # noqa: E402
from transmogrifai_tpu.impl.tuning import splitters as jsplit  # noqa: E402
from transmogrifai_tpu.impl.tuning.validators import (  # noqa: E402
    OpCrossValidation as JaxCV,
)
import transmogrifai_tpu_torch as port  # noqa: E402
from transmogrifai_tpu_torch.features import Feature  # noqa: E402
from transmogrifai_tpu_torch.impl.preparators.sanity_checker import (  # noqa
    SanityChecker,
)
from transmogrifai_tpu_torch.impl.tuning import (  # noqa: E402
    splitters as psplit,
)
from transmogrifai_tpu_torch.impl.tuning.validators import (  # noqa: E402
    OpCrossValidation,
)
from transmogrifai_tpu_torch.models import trees as ptrees  # noqa: E402
from transmogrifai_tpu_torch.models.api import ModelFamily  # noqa: E402
from transmogrifai_tpu_torch.ops import metrics as pmetrics  # noqa: E402
from transmogrifai_tpu_torch.table import Column, FeatureTable  # noqa: E402
from transmogrifai_tpu_torch.testing import (  # noqa: E402
    serve_bench_data, serve_bench_workflow,
)
from transmogrifai_tpu_torch.types import (  # noqa: E402
    FeatureType, OPVector, RealNN,
)
from transmogrifai_tpu_torch.utils.padding import bucket_for  # noqa: E402
from transmogrifai_tpu_torch.vector_metadata import (  # noqa: E402
    VectorColumnMetadata, VectorMetadata,
)
from transmogrifai_tpu_torch.workflow import raw_table  # noqa: E402

TOL = 1e-6
E2E_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, tol=TOL):
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(_n(got).astype(np.float64), want, rtol=tol,
                               atol=tol)


def _padded_frame(n, d, seed, pad_to=None):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X @ rng.randn(d).astype(np.float32) > 0).astype(np.float32)
    if pad_to:
        X = np.concatenate([X, np.zeros((pad_to - n, d), np.float32)])
        y = np.concatenate([y, np.zeros(pad_to - n, np.float32)])
    return X, y


# ---------------------------------------------------------------------------
# binning and the grower
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d", [(400, 5), (1531, 3), (19, 2)])
def test_quantile_edges_and_codes_are_bit_equal(n, d):
    X, _ = _padded_frame(n, d, seed=n, pad_to=bucket_for(n))
    X[::7, 0] = 0.25                                   # ties
    want = np.asarray(jax.jit(lambda x: jtrees._quantile_edges(x, 32))(
        jnp.asarray(X)))
    got = ptrees._quantile_edges(_t(X), 32)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ptrees._bin_features(_t(X), got).numpy(),
        np.asarray(jtrees._bin_features(jnp.asarray(X), jnp.asarray(want))))


def test_nan_column_gets_nan_edges():
    X = np.random.RandomState(0).randn(50, 2).astype(np.float32)
    X[3, 1] = np.nan
    got = ptrees._quantile_edges(_t(X), 8).numpy()
    want = np.asarray(jtrees._quantile_edges(jnp.asarray(X), 8))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("n,cap", [(100, 65536), (19712, 8192), (70000,
                                                                  65536)])
def test_sample_rows(n, cap):
    np.testing.assert_array_equal(ptrees._sample_rows(n, cap),
                                  jtrees._sample_rows(n, cap))


@pytest.mark.parametrize("full_bin,sweep", [(True, False), (False, True),
                                            (False, False)])
def test_prep_tree_inputs(full_bin, sweep):
    X, y = _padded_frame(9000, 4, seed=1, pad_to=bucket_for(9000))
    def jax_prep(X, y):       # the mode string cannot leave a jit
        out = jtrees._prep_tree_inputs(X, y, 32, 2, "classification",
                                       full_bin=full_bin, sweep=sweep)
        return out[:5] + out[6:]

    want = jax.jit(jax_prep)(jnp.asarray(X), jnp.asarray(y))
    got = ptrees._prep_tree_inputs(_t(X), _t(y), 32, 2, "classification",
                                   full_bin=full_bin, sweep=sweep)
    assert got[5] == "counts"
    for g, w in zip(got[:5] + got[6:], want):
        if g is None:
            assert w is None
        else:
            np.testing.assert_array_equal(_n(g), np.asarray(w))


@pytest.mark.parametrize("mode", ["gh", "counts"])
def test_split_gain(mode):
    rng = np.random.RandomState(2)
    m, d, nb, k = 3, 4, 6, 3
    hist = np.abs(rng.randn(m, d, nb, k)).astype(np.float32)
    cum = np.cumsum(hist, axis=2)
    total, SL = cum[:, 0, -1, :], cum[:, :, :-1, :]
    SR = total[:, None, None, :] - SL
    cfg = {"lam": np.full(m, 0.5, np.float32),
           "min_child_weight": np.full(m, 0.1, np.float32),
           "min_instances": np.array([0.0, 1.0, 3.0], np.float32)}
    jg, jv = jtrees._split_gain(jnp.asarray(SL), jnp.asarray(SR),
                                jnp.asarray(total),
                                {k_: jnp.asarray(v) for k_, v in cfg.items()},
                                mode)
    pg, pv = ptrees._split_gain(_t(SL), _t(SR), _t(total),
                                {k_: _t(v) for k_, v in cfg.items()}, mode)
    _close(pg, jg)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def _grow_inputs(S=600, d=5, Tb=3, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(S, d).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    edges = np.asarray(jtrees._quantile_edges(jnp.asarray(X), 32))
    codes = np.asarray(jtrees._bin_features(jnp.asarray(X),
                                            jnp.asarray(edges)))
    w = (rng.rand(S, Tb) < 0.7).astype(np.float32)
    p = np.full((S, Tb), 0.5, np.float32)
    sw = [((p - y[:, None]) * w).astype(np.float32),
          (p * (1 - p) * w).astype(np.float32), w]
    cfg = {"max_depth": np.array([3, 2, 3], np.float32)[:Tb],
           "min_instances": np.full(Tb, 5, np.float32),
           "min_info_gain": np.full(Tb, 1e-3, np.float32),
           "lam": np.zeros(Tb, np.float32),
           "min_child_weight": np.zeros(Tb, np.float32)}
    fmasks = np.ones((Tb, d), bool)
    fmasks[1, 0] = False
    return codes, edges, sw, fmasks, cfg


@pytest.mark.parametrize("leaf_stats", [False, True])
def test_grow_forest_matches_jax(leaf_stats):
    codes, edges, sw, fmasks, cfg = _grow_inputs()
    want = jtrees._grow_forest(
        jnp.asarray(codes), jnp.asarray(edges), [jnp.asarray(s) for s in sw],
        jnp.asarray(fmasks), {k: jnp.asarray(v) for k, v in cfg.items()},
        depth=3, n_bins=32, mode="gh", return_leaf_stats=leaf_stats)
    got = ptrees._grow_forest(
        _t(codes), _t(edges), [_t(s) for s in sw], _t(fmasks),
        {k: _t(v) for k, v in cfg.items()}, depth=3, n_bins=32, mode="gh",
        return_leaf_stats=leaf_stats)
    for g, w in zip(got[:4], want[:4]):                # feat thr bins node
        np.testing.assert_array_equal(_n(g), np.asarray(w))
    if leaf_stats:
        _close(got[4], want[4])


def test_diag_leaf_hist_matches_jax():
    rng = np.random.RandomState(4)
    S, Tb, L = 500, 70, 8
    node = rng.randint(0, L, (S, Tb)).astype(np.int32)
    A = rng.randn(S, 2, Tb).astype(np.float32)
    want = np.asarray(jtrees._diag_leaf_hist(jnp.asarray(node),
                                             jnp.asarray(A), L))
    got = ptrees._diag_leaf_hist(_t(node), _t(A), L)
    _close(got, want)
    one = ptrees._diag_leaf_hist(_t(node), _t(A[:, 0]), L)
    _close(one, want[0])


@pytest.mark.parametrize("sweep", [False, True])
def test_tiny_gbt_fit_matches_jax(sweep):
    """Edges, codes and feat/bin heaps equal, leaves within 1e-6."""
    n_fit = 700
    n = bucket_for(n_fit)
    X, y = _padded_frame(n_fit, 4, seed=5, pad_to=n)
    W = np.zeros((2, n), np.float32)
    W[0, :n_fit] = 1.0
    W[1, :n_fit:2] = 1.0
    grid = {"maxDepth": np.array([3.0, 3.0], np.float32),
            "maxIter": np.array([14.0, 14.0], np.float32),
            "stepSize": np.array([0.1, 0.3], np.float32),
            "minInstancesPerNode": np.array([5.0, 10.0], np.float32),
            "minInfoGain": np.array([0.001, 0.001], np.float32)}
    jfam = jtrees.GBTClassifierFamily()
    pfam = ptrees.GBTClassifierFamily()
    want = jfam.fit_batch(jnp.asarray(X), jnp.asarray(y), jnp.asarray(W),
                          {k: jnp.asarray(v) for k, v in grid.items()}, 2,
                          sweep=sweep)
    got = pfam.fit_batch(_t(X), _t(y), _t(W), grid, 2, sweep=sweep)
    assert sorted(got) == sorted(want)
    for k in ("edges", "feat", "bins", "thresh", "tree_mask", "f0", "eta"):
        np.testing.assert_array_equal(_n(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(_n(got["leaf"]), np.asarray(want["leaf"]),
                               rtol=0, atol=TOL)
    assert got["feat"].shape[1] == (12 if sweep else 14)   # sweep cap
    scores = pfam.predict_batch(got, _t(X[:300]), 2)
    _close(scores, jfam.predict_batch(want, jnp.asarray(X[:300]), 2))


def test_config_chunks_stitch_to_the_unchunked_fit(monkeypatch):
    """Configs fitted in chunks (a small per-level budget) and stitched back
    give the unchunked fit's params, tail chunk wrapped around."""
    X, y = _padded_frame(300, 3, seed=8, pad_to=bucket_for(300))
    W = np.ones((3, X.shape[0]), np.float32)
    W[:, 300:] = 0.0
    W[1, ::3] = 0.0
    grid = {"maxDepth": np.full(3, 2.0, np.float32),
            "maxIter": np.array([3.0, 3.0, 3.0], np.float32),
            "stepSize": np.array([0.1, 0.2, 0.3], np.float32)}
    fam = ptrees.GBTClassifierFamily()
    whole = fam.fit_batch(_t(X), _t(y), _t(W), grid, 2)
    monkeypatch.setattr(ptrees, "_LEVEL_HIST_ELEMS", 2 * 3 * 32 * 3)
    chunked = fam.fit_batch(_t(X), _t(y), _t(W), grid, 2)
    assert sorted(chunked) == sorted(whole)
    for k in whole:
        assert torch.equal(chunked[k], whole[k]), k


def test_sweep_ensemble_cap_matches_jax():
    for vals in ([20.0, 20.0], [5.0, 8.0], [30.0, 60.0, 90.0]):
        a = ptrees._sweep_ensemble_cap(np.asarray(vals), 12, "maxIter")
        b = jtrees._sweep_ensemble_cap(np.asarray(vals), 12, "maxIter")
        assert (a is None and b is None) or np.array_equal(a, b)


#: the tables that must be equal in a fitted GBT batch, per layout
_GBT_TABLES = ("edges", "feat", "bins", "thresh", "feat_lv", "bins_lv",
               "base_lv", "thresh_lv", "tree_mask", "f0", "eta")


def _deep_frame(n_fit, d, seed, n_cfg):
    """A padded frame and n_cfg fold-like 0/1 weight rows."""
    n = bucket_for(n_fit)
    X, y = _padded_frame(n_fit, d, seed=seed, pad_to=n)
    W = np.zeros((n_cfg, n), np.float32)
    for b in range(n_cfg):
        W[b, b:n_fit:b + 1] = 1.0
    return X, y, W


def _gbt_fits(grid, X, y, W, sweep):
    """(port, JAX) fit_batch of one GBT grid on the same inputs."""
    want = jtrees.GBTClassifierFamily().fit_batch(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(W),
        {k: jnp.asarray(v) for k, v in grid.items()}, 2, sweep=sweep)
    got = ptrees.GBTClassifierFamily().fit_batch(_t(X), _t(y), _t(W), grid,
                                                 2, sweep=sweep)
    return got, want


def _assert_gbt_match(got, want, X):
    """Chain tables and thresholds equal to the bit, leaves within 1e-6,
    scores within 1e-6."""
    assert sorted(got) == sorted(want)
    for k in _GBT_TABLES:
        if k in want:
            np.testing.assert_array_equal(_n(got[k]), np.asarray(want[k]),
                                          err_msg=k)
    np.testing.assert_allclose(_n(got["leaf"]), np.asarray(want["leaf"]),
                               rtol=0, atol=TOL)
    _close(ptrees.GBTClassifierFamily().predict_batch(got, _t(X[:300]), 2),
           jtrees.GBTClassifierFamily().predict_batch(
               want, jnp.asarray(X[:300]), 2))


@pytest.mark.parametrize("sweep", [False, True])
def test_deep_gbt_fit_matches_jax(sweep):
    """One depth-12 configuration boosts slot chains (W 256 in the refit,
    64 in the sweep) with exact Newton leaves."""
    X, y, W = _deep_frame(500, 4, seed=9, n_cfg=1)
    grid = {"maxDepth": np.array([12.0], np.float32),
            "maxIter": np.array([3.0], np.float32),
            "stepSize": np.array([0.3], np.float32),
            "minInstancesPerNode": np.array([5.0], np.float32),
            "minInfoGain": np.array([0.001], np.float32)}
    got, want = _gbt_fits(grid, X, y, W, sweep)
    assert tuple(got["feat_lv"].shape) == (1, 3, 1, 12,
                                           64 if sweep else 256)
    assert "feat" not in got
    _assert_gbt_match(got, want, X)


@pytest.mark.parametrize("sweep", [False, True])
def test_mixed_depth_gbt_grid_matches_jax_and_stitches(sweep):
    """A (3, 12) grid boosts both configurations in one slot-chain scan.
    In the refit, where heaps and chains alike take exact leaves, the
    shallow one's scores match a heap fit of it alone (as
    ``tests/test_deep_trees.py::test_mixed_depth_grid_stitches_exactly``
    holds the JAX package), within the same 2e-4; a sweep's heap takes
    its leaves off the bf16 histogram instead."""
    X, y, W = _deep_frame(500, 4, seed=10, n_cfg=2)
    shallow = {"maxDepth": 3.0, "minInstancesPerNode": 5.0,
               "minInfoGain": 0.001, "maxIter": 3.0, "stepSize": 0.2}
    rows = [shallow, dict(shallow, maxDepth=12.0)]
    grid = {k: np.array([r[k] for r in rows], np.float32) for k in shallow}
    got, want = _gbt_fits(grid, X, y, W, sweep)
    assert "base_lv" in got
    _assert_gbt_match(got, want, X)
    if sweep:
        return
    fam = ptrees.GBTClassifierFamily()
    alone = fam.fit_batch(_t(X), _t(y), _t(W[:1]),
                          {k: v[:1] for k, v in grid.items()}, 2,
                          sweep=sweep)
    assert "feat" in alone
    np.testing.assert_allclose(
        _n(fam.predict_batch(got, _t(X), 2))[0],
        _n(fam.predict_batch(alone, _t(X), 2))[0], rtol=0, atol=2e-4)


@pytest.mark.parametrize("sweep", [False, True])
def test_default_gbt_grid_fits_like_jax(sweep):
    """The reference's default grid (maxDepth 3, 6 and 12 x
    minInstancesPerNode x minInfoGain) at a tiny size: 200 rows of 3
    predictors, 3 fold weights, its boosting cut to 2 rounds."""
    jg = jtrees.GBTClassifierFamily().default_grid("binary")
    fam = ptrees.GBTClassifierFamily()
    assert fam.default_grid("binary") == jg and len(jg) == 18
    grid = fam.grid_to_arrays([dict(g, maxIter=2) for g in jg])
    X, y, W = _deep_frame(200, 3, seed=11, n_cfg=3)
    W = np.repeat(W, 6, axis=0)                        # 18 weight rows
    got, want = _gbt_fits(grid, X, y, W, sweep)
    # the depth-6 heaps fit in the chain budget: 64 sweep slots, 256 refit
    assert got["feat_lv"].shape[-1] == (64 if sweep else 256)
    _assert_gbt_match(got, want, X)


# ---------------------------------------------------------------------------
# fitted stages: vectorizer, sanity checker, splitter, folds, metrics
# ---------------------------------------------------------------------------

def test_real_vectorizer_fills_match_jax():
    from transmogrifai_tpu import FeatureBuilder as JFB
    from transmogrifai_tpu.impl.feature.vectorizers import (
        RealVectorizer as JRV,
    )
    from transmogrifai_tpu.table import Column as JColumn
    from transmogrifai_tpu.table import FeatureTable as JTable
    from transmogrifai_tpu.types import Real as JReal
    from transmogrifai_tpu_torch.impl.feature.vectorizers import (
        RealVectorizer,
    )
    rng = np.random.RandomState(7)
    cols = {f"r{i}": rng.randn(300).astype(np.float32) * (i + 1) + i
            for i in range(3)}
    cols["r1"][rng.rand(300) < 0.3] = np.nan
    cols["r2"][:] = np.nan
    jt = JTable({k: JColumn(JReal, np.nan_to_num(v), ~np.isnan(v))
                 for k, v in cols.items()}, 300)
    jm = JRV().set_input(*[JFB.Real(k).extract_field().as_predictor()
                           for k in cols]).fit(jt)
    feats = [port.FeatureBuilder.Real(k).extract_field().as_predictor()
             for k in cols]
    pt = raw_table(feats, cols, require_response=False).to_device("cpu")
    pm = RealVectorizer().set_input(*feats).fit(pt)
    assert pm.fills == jm.fills
    out = pm.transform_column(pt)
    np.testing.assert_array_equal(out.values.numpy(), np.asarray(
        jm.transform_column(jt).values))


def _checker_table(n=200, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 2, n).astype(np.float32)
    good = (y + rng.randn(n)).astype(np.float32)
    leaky = (y * 2.0 - 1.0 + rng.randn(n) * 0.01).astype(np.float32)
    const = np.full(n, 3.0, dtype=np.float32)
    noise = rng.randn(n).astype(np.float32)
    ind = (rng.rand(n) < 0.3).astype(np.float32)        # an indicator slot
    leaky_ind = y.copy()                          # an indicator equal to y
    X = np.stack([good, leaky, const, noise, ind, leaky_ind, 1 - leaky_ind],
                 axis=1)
    names = [("good", None, None), ("leaky", None, None),
             ("const", None, None), ("noise", "noise", None),
             ("noise", "noise", "NullIndicatorValue"),
             ("cat", "cat", "a"), ("cat", "cat", "b")]
    return y, X, names


@pytest.mark.parametrize("spearman,correlations", [(False, "label"),
                                                   (True, "label"),
                                                   (False, "full")])
def test_sanity_checker_matches_jax(spearman, correlations):
    from transmogrifai_tpu import FeatureBuilder as JFB
    from transmogrifai_tpu.impl.preparators import SanityChecker as JSC
    from transmogrifai_tpu.table import Column as JColumn
    from transmogrifai_tpu.table import FeatureTable as JTable
    from transmogrifai_tpu.types import OPVector as JVec
    from transmogrifai_tpu.types import RealNN as JRealNN
    from transmogrifai_tpu.vector_metadata import (
        VectorColumnMetadata as JVCM, VectorMetadata as JVM,
    )
    y, X, names = _checker_table()
    jvm = JVM.of("features", [JVCM(p, "Real", g, i) for p, g, i in names])
    pvm = VectorMetadata.of("features", [VectorColumnMetadata(p, "Real", g, i)
                                         for p, g, i in names])
    jt = JTable({"label": JColumn(JRealNN, y, None),
                 "features": JColumn(JVec, X, None, {"vector_meta": jvm})},
                len(y))
    pt = FeatureTable({"label": Column(RealNN, _t(y), None),
                       "features": Column(OPVector, _t(X), None,
                                          {"vector_meta": pvm})}, len(y))
    jm = JSC(correlation_type_spearman=spearman, sample_lower_limit=50,
             check_sample=0.5, correlations=correlations).set_input(
        JFB.RealNN("label").extract_field().as_response(),
        JFB.OPVector("features").extract_field().as_predictor()).fit(jt)
    label = port.FeatureBuilder.RealNN("label").extract_field().as_response()
    vec = Feature("features", OPVector, False, None, ())
    pm = SanityChecker(correlation_type_spearman=spearman,
                       sample_lower_limit=50, check_sample=0.5,
                       correlations=correlations).set_input(
        label, vec).fit(pt)
    if correlations == "full":
        np.testing.assert_allclose(pm.summary.feature_correlations,
                                   jm.summary.feature_correlations,
                                   rtol=1e-5, atol=1e-5)
    assert pm.keep_indices == jm.keep_indices
    assert pm.summary.reasons == jm.summary.reasons
    assert pm.summary.dropped == jm.summary.dropped
    assert pm.summary.sample_size == jm.summary.sample_size
    assert pm.summary.categorical.cramers_v == pytest.approx(
        jm.summary.categorical.cramers_v, rel=TOL)
    _close(pm.summary.correlations_with_label,
           jm.summary.correlations_with_label)
    _close(pm.summary.stats.variance, jm.summary.stats.variance)
    out = pm.transform_column(pt)
    assert out.metadata["vector_meta"].column_names() == \
        jm.transform_column(jt).metadata["vector_meta"].column_names()


def test_data_balancer_matches_jax():
    rng = np.random.RandomState(8)
    for frac in (0.5, 0.05):
        y = (rng.rand(5000) < frac).astype(np.float32)
        jb = jsplit.DataBalancer(seed=3)
        pb = psplit.DataBalancer(seed=3)
        jp, pp = jb.pre_validation_prepare(y), pb.pre_validation_prepare(y)
        np.testing.assert_array_equal(pp.indices, jp.indices)
        assert pb.summary == jb.summary
        for a, b in zip(pb.split(777), jb.split(777)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("stratify", [False, True])
def test_kfold_masks_match_jax(stratify):
    y = (np.random.RandomState(9).rand(1001) < 0.4).astype(np.float32)
    np.testing.assert_array_equal(
        OpCrossValidation(seed=5, stratify=stratify).make_splits(y),
        JaxCV(seed=5, stratify=stratify).make_splits(y))


def _scores_with_ties(n, seed):
    rng = np.random.RandomState(seed)
    s = np.round(rng.rand(n), 2).astype(np.float32)
    y = (rng.rand(n) < s).astype(np.float32)
    mask = rng.rand(n) < 0.7
    return s, y, mask


@pytest.mark.parametrize("binned", [None, True])
def test_exact_and_binned_auroc_aupr_match_jax(binned):
    s, y, mask = _scores_with_ties(3000, 10)
    args_j = (jnp.asarray(s), jnp.asarray(y), jnp.asarray(mask))
    args_p = (_t(s), _t(y), _t(mask))
    _close(pmetrics.auroc_masked(*args_p, binned=binned),
           jmetrics.auroc_masked(*args_j, binned=binned))
    _close(pmetrics.aupr_masked(*args_p, binned=binned),
           jmetrics.aupr_masked(*args_j, binned=binned))
    if binned is None:
        _close(pmetrics.auroc(_t(s), _t(y)), jmetrics.auroc(*args_j[:2]))
        _close(pmetrics.aupr(_t(s), _t(y)), jmetrics.aupr(*args_j[:2]))


def test_metric_known_values_and_ties():
    s = _t(np.array([0.9, 0.8, 0.7, 0.6, 0.5, 0.4], np.float32))
    y = _t(np.array([1.0, 1.0, 0.0, 1.0, 0.0, 0.0], np.float32))
    assert float(pmetrics.auroc(s, y)) == pytest.approx(8 / 9, abs=1e-6)
    assert float(pmetrics.auroc(torch.full((4,), 0.5),
                                _t(np.array([1., 0., 1., 0.],
                                            np.float32)))) == 0.5


def test_threshold_metrics_and_log_loss_match_jax():
    s, y, mask = _scores_with_ties(500, 11)
    for g, w in zip(pmetrics.threshold_metrics(_t(s), _t(y)),
                    jmetrics.threshold_metrics(jnp.asarray(s),
                                               jnp.asarray(y))):
        _close(g, w)
    _close(pmetrics.log_loss_masked(_t(s), _t(y), _t(mask)),
           jmetrics.log_loss_masked(jnp.asarray(s), jnp.asarray(y),
                                    jnp.asarray(mask)))
    got = pmetrics.binary_threshold_metrics_masked(_t(s), _t(y), _t(mask))
    want = jmetrics.binary_threshold_metrics_masked(
        jnp.asarray(s), jnp.asarray(y), jnp.asarray(mask))
    for k in want:
        _close(got[k], want[k])


# ---------------------------------------------------------------------------
# the tiny end-to-end train
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_trained():
    """(JAX model, port model) of TINY_MODELS['gbt'] on the same 400 rows."""
    family, hyper = TINY_MODELS["gbt"]
    jm = train_jax_model(family, hyper, n=400, d=TINY_D, seed=3,
                         realnn=TINY_REALNN["gbt"])
    data = serve_bench_data(400, TINY_D, seed=3)
    pm = serve_bench_workflow(family, hyper, TINY_D, seed=3,
                              realnn=TINY_REALNN["gbt"], device="cpu"
                              ).set_input_dataset(data).train()
    return jm, pm


def test_tiny_train_summary_matches_jax(tiny_trained):
    jm, pm = tiny_trained
    assert [type(s).__name__ for s in pm.stages] == [
        type(s).__name__ for s in jm.stages]
    js, ps = jm.stages[-1].summary, pm.stages[-1].summary
    assert ps.best_model_type == js.best_model_type
    assert ps.best_hyper == js.best_hyper
    assert ps.validation_type == js.validation_type
    assert ps.validation_metric == js.validation_metric
    assert ps.splitter_summary == js.splitter_summary
    assert ps.best_metric_value == pytest.approx(js.best_metric_value,
                                                 abs=E2E_TOL)
    np.testing.assert_allclose(ps.validation_results[0].fold_metrics,
                               js.validation_results[0].fold_metrics,
                               rtol=0, atol=E2E_TOL)
    for ev in ("train_evaluation", "holdout_evaluation"):
        got, want = getattr(ps, ev), getattr(js, ev)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], abs=E2E_TOL), (ev, k)
    assert pm.stages[-2].keep_indices == jm.stages[-2].keep_indices


def test_tiny_train_tree_tables_match_jax(tiny_trained):
    jm, pm = tiny_trained
    jp = jm.stages[-1].fitted.params
    pp = pm.stages[-1].fitted.params
    for k in ("edges", "feat", "bins", "thresh", "tree_mask", "f0", "eta"):
        np.testing.assert_array_equal(pp[k].numpy(), np.asarray(jp[k]),
                                      err_msg=k)
    np.testing.assert_allclose(pp["leaf"].numpy(), np.asarray(jp["leaf"]),
                               rtol=0, atol=TOL)


def test_tiny_train_scores_match_jax(tiny_trained):
    jm, pm = tiny_trained
    frame = score_frame(300, TINY_D, seed=4, nan_rate=0.05)
    want = prediction_parts(jm.score(table=jax_table(frame)), jm)
    got = prediction_parts(pm.score(data=frame), pm)
    np.testing.assert_allclose(got["probability_1"], want["probability_1"],
                               rtol=0, atol=E2E_TOL)
    far = np.abs(want["probability_1"] - 0.5) > E2E_TOL
    np.testing.assert_array_equal(got["prediction"][far],
                                  want["prediction"][far])
    fn = pm.score_function()
    row = {k: float(v[0]) for k, v in frame.items()}
    assert fn(row)[pm.result_features[0].name]["probability_1"] == \
        pytest.approx(float(want["probability_1"][0]), abs=E2E_TOL)


def test_workflow_without_device_needs_cuda():
    res = subprocess.run(
        [sys.executable, "-c",
         "import transmogrifai_tpu_torch as p\np.OpWorkflow()\n"],
        cwd=REPO, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "no CUDA device is available" in res.stderr, res.stderr


def test_unported_inputs_raise():
    class Date(FeatureType):        # a type the port does not vectorize
        is_abstract = False
        column_kind = "date"

    date = Feature("d", Date, False, None, ())
    with pytest.raises(NotImplementedError, match="no vectorizer for Date"):
        port.transmogrify([date])
    # every family of the JAX registry is ported (the MLP last); a family
    # name the registry lacks raises
    with pytest.raises(KeyError, match="OpNoSuchFamily"):
        port.BinaryClassificationModelSelector.with_cross_validation(
            models=[("OpNoSuchFamily", None)])
    class NoGrid(ModelFamily):
        name = "NoGrid"

        def params_from_numpy(self, params, device):
            return params

        def predict_parts(self, fitted, X):
            return {}

    with pytest.raises(NotImplementedError, match="default grid"):
        NoGrid().default_grid("binary")
    wf = port.OpWorkflow(device="cpu")
    with pytest.raises(ValueError, match="set_result_features"):
        wf.train()
