"""Regression and multiclass problems through the tree families: the
PyTorch port against the JAX package on the CPU, on the same numpy inputs.

Covered: the multiclass and regression metrics, ``DataCutter``, the five
families the port gained (``OpDecisionTreeRegressor``,
``OpRandomForestRegressor``, ``OpGBTRegressor``, ``OpXGBoostRegressor``,
``OpXGBoostClassifier``) and the two multiclass classifiers (DT, RF)
through ``fit_batch``/``predict_batch`` on ``tests/test_trees.py``'s
frames and grids, the boosting state's softmax and base score, and the
SanityChecker on a continuous and a 6-class label. Both new selectors end
to end and tiny JAX-saved regression and multiclass models are in
``test_torch_tasks_e2e.py``.

Tolerances (stated once, used throughout):

* bin edges, split tables (feat/bins/thresh, chains' *_lv), tree masks,
  f0, eta, fold masks, kept columns, the winner and its hyperparameters:
  equal;
* GBT/XGBoost leaves: equal in regression (the boosting state is f32
  adds and fused multiply-adds written out, the softmax's ``exp`` is
  XLA's own, f0 is summed in XLA's order); within 1e-6 for classifiers,
  whose refit leaves are one-hot contractions that the CPU adds in
  another order than XLA (measured: 2 of 720 multiclass leaves, 6e-8)
  and whose binary sigmoid differs in the last bit;
* DT/RF regressor leaves: rtol 1e-6 (the mean of ``[-y, 1, 1]`` stats
  summed in another order; measured 9 of 16 DT leaves, 51 of 160 RF
  leaves, max relative 3.2e-7); classifier leaves equal (integer counts);
* predictions and metrics: within 1e-5.
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
sys.path.insert(0, os.path.join(REPO, "tests"))

from test_trees import (  # noqa: E402
    GRID_RF, GRID_TREE, GRID_GBT, GRID_XGB, _binary_data, _multiclass_data,
    _regression_data,
)
from transmogrifai_tpu.models import trees as jtrees  # noqa: E402
from transmogrifai_tpu.models.api import (  # noqa: E402
    MODEL_REGISTRY as JAX_REGISTRY,
)
from transmogrifai_tpu.ops import metrics as jmetrics  # noqa: E402
from transmogrifai_tpu.impl.tuning import splitters as jsplit  # noqa: E402
import transmogrifai_tpu_torch as port  # noqa: E402
from transmogrifai_tpu_torch.features import Feature  # noqa: E402
from transmogrifai_tpu_torch.impl.tuning import (  # noqa: E402
    splitters as psplit,
)
from transmogrifai_tpu_torch.models import trees as ptrees  # noqa: E402
from transmogrifai_tpu_torch.models.api import (  # noqa: E402
    MODEL_REGISTRY as PORT_REGISTRY,
)
from transmogrifai_tpu_torch.ops import metrics as pmetrics  # noqa: E402
from transmogrifai_tpu_torch.table import Column, FeatureTable  # noqa: E402
from transmogrifai_tpu_torch.types import OPVector, RealNN  # noqa: E402

TOL = 1e-6
LEAF_RTOL = 1e-6
E2E_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=E2E_TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got.astype(np.float64),
                               np.asarray(want, dtype=np.float64), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# metrics and the label cutter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,seed", [(3, 0), (6, 1)])
def test_multiclass_metrics_match_jax(C, seed):
    rng = np.random.RandomState(seed)
    n = 1000
    label = rng.randint(0, C, n)
    pred = np.where(rng.rand(n) < 0.6, label, rng.randint(0, C, n))
    mask = rng.rand(n) < 0.7
    probs = rng.dirichlet(np.ones(C), n).astype(np.float32)
    np.testing.assert_array_equal(
        pmetrics.multiclass_confusion(_t(pred), _t(label), C).numpy(),
        np.asarray(jmetrics.multiclass_confusion(
            jnp.asarray(pred), jnp.asarray(label), C)))
    for got, want in (
            (pmetrics.multiclass_metrics_masked(_t(pred), _t(label),
                                                _t(mask), C),
             jmetrics.multiclass_metrics_masked(
                 jnp.asarray(pred), jnp.asarray(label), jnp.asarray(mask),
                 C)),
            (pmetrics.multiclass_metrics(_t(pred), _t(label), C),
             jmetrics.multiclass_metrics(jnp.asarray(pred),
                                         jnp.asarray(label), C))):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], TOL)
    _close(pmetrics.multiclass_log_loss(_t(probs), _t(label)),
           jmetrics.multiclass_log_loss(jnp.asarray(probs),
                                        jnp.asarray(label)), TOL)


def test_regression_metrics_match_jax():
    rng = np.random.RandomState(2)
    n = 1000
    label = (rng.randn(n) * 4 + 1).astype(np.float32)
    pred = (label + rng.randn(n)).astype(np.float32)
    mask = rng.rand(n) < 0.7
    for got, want in (
            (pmetrics.regression_metrics_masked(_t(pred), _t(label),
                                                _t(mask)),
             jmetrics.regression_metrics_masked(
                 jnp.asarray(pred), jnp.asarray(label), jnp.asarray(mask))),
            (pmetrics.regression_metrics(_t(pred), _t(label)),
             jmetrics.regression_metrics(jnp.asarray(pred),
                                         jnp.asarray(label)))):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], TOL)


@pytest.mark.parametrize("kw", [{"max_label_categories": 3, "seed": 0},
                                {"min_label_fraction": 0.05}])
def test_data_cutter_matches_jax(kw):
    """``tests/test_model_selector.py::test_data_cutter``'s labels."""
    rng = np.random.RandomState(6)
    y = rng.choice([0, 1, 2, 3, 4], p=[0.4, 0.3, 0.2, 0.06, 0.04],
                   size=5000).astype(np.float32)
    got = psplit.DataCutter(**kw).pre_validation_prepare(y)
    want = jsplit.DataCutter(**kw).pre_validation_prepare(y)
    np.testing.assert_array_equal(got.indices, want.indices)
    assert got.label_mapping == want.label_mapping
    assert got.summary == want.summary
    with pytest.raises(ValueError):
        psplit.DataCutter(min_label_fraction=0.6)


# ---------------------------------------------------------------------------
# the families' fit_batch and predict_batch
# ---------------------------------------------------------------------------

#: (family, frame, grid); the frame also fixes num_classes
FAMILY_CASES = [
    ("OpDecisionTreeRegressor", "regression", GRID_TREE),
    ("OpRandomForestRegressor", "regression", GRID_RF),
    ("OpGBTRegressor", "regression", GRID_GBT),
    ("OpXGBoostRegressor", "regression", GRID_XGB),
    ("OpXGBoostClassifier", "multiclass", GRID_XGB),
    ("OpXGBoostClassifier", "binary", GRID_XGB),
    ("OpDecisionTreeClassifier", "multiclass", GRID_TREE),
    ("OpRandomForestClassifier", "multiclass", GRID_RF),
]
FRAMES = {"regression": (_regression_data, 2),
          "multiclass": (_multiclass_data, 3), "binary": (_binary_data, 2)}


@pytest.mark.parametrize("sweep", [False, True])
@pytest.mark.parametrize("family,frame,grid", FAMILY_CASES)
def test_family_fit_matches_jax(family, frame, grid, sweep):
    make, C = FRAMES[frame]
    X, y = (np.asarray(a) for a in make())
    W = np.ones((1, X.shape[0]), np.float32)
    jf, pf = JAX_REGISTRY[family], PORT_REGISTRY[family]
    want = jf.fit_batch(jnp.asarray(X), jnp.asarray(y), jnp.asarray(W),
                        jf.grid_to_arrays(grid), num_classes=C, sweep=sweep)
    got = pf.fit_batch(_t(X), _t(y), _t(W), pf.grid_to_arrays(grid), C,
                       sweep=sweep)
    assert sorted(got) == sorted(want)
    for k in want:
        if k != "leaf":
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
    leaf, jleaf = got["leaf"].numpy(), np.asarray(want["leaf"])
    if family in ("OpGBTRegressor", "OpXGBoostRegressor"):
        np.testing.assert_array_equal(leaf, jleaf)
    elif family.startswith(("OpGBT", "OpXGBoost")):
        np.testing.assert_allclose(leaf, jleaf, rtol=0, atol=TOL)
    elif frame == "regression":
        np.testing.assert_allclose(leaf, jleaf, rtol=LEAF_RTOL, atol=0)
    else:
        np.testing.assert_array_equal(leaf, jleaf)
    scores = pf.predict_batch(got, _t(X), C)
    want_scores = np.asarray(jf.predict_batch(want, jnp.asarray(X), C))
    assert tuple(scores.shape) == want_scores.shape
    _close(scores, want_scores)


def test_xla_softmax_and_f0_sum_are_bit_equal_to_jax():
    """The multiclass boosting state's softmax (XLA's float32 ``exp`` and
    class sum) and the regression base score f0 (``pinned_row_sum``)."""
    from transmogrifai_tpu.histeng.kernels import pinned_row_sum as jprs
    from transmogrifai_tpu_torch.histeng import pinned_row_sum
    from transmogrifai_tpu_torch.ops.xla_cpu import xla_softmax
    rng = np.random.RandomState(3)
    F = (rng.randn(2, 6, 3000) * 4).astype(np.float32)
    F[0, :, :5] = [[-120.0], [-90.0], [0.0], [30.0], [89.0], [-87.5]]
    want = np.asarray(jax.jit(lambda f: jax.nn.softmax(f, axis=1))(
        jnp.asarray(F)))
    np.testing.assert_array_equal(xla_softmax(_t(F)).numpy(), want)
    for n in (7, 400, 1001, 19712):
        w = (rng.rand(3, n) < 0.7).astype(np.float32)
        y = (rng.randn(n) * 5).astype(np.float32)
        want = np.asarray(jax.jit(lambda w, y: jprs(w * y[None], axis=1))(
            jnp.asarray(w), jnp.asarray(y)))
        np.testing.assert_array_equal(
            pinned_row_sum(_t(w) * _t(y)[None], dim=1).numpy(), want)


def test_multiclass_gbt_chunks_with_the_class_factor(monkeypatch):
    """A budget that fits two configurations of one class but not of three
    chunks a 3-class fit one configuration at a time, as the JAX
    package's ``C_g`` budget does; the stitched fit equals the whole."""
    X, y = (np.asarray(a) for a in _multiclass_data(n=200))
    W = np.ones((2, X.shape[0]), np.float32)
    W[1, ::3] = 0.0
    grid = {"maxDepth": np.full(2, 2.0, np.float32),
            "maxIter": np.full(2, 2.0, np.float32),
            "stepSize": np.array([0.1, 0.3], np.float32)}
    fam = ptrees.XGBoostClassifierFamily()
    whole = fam.fit_batch(_t(X), _t(y), _t(W), grid, 3)
    calls = []
    real = ptrees._fit_gbt_batch
    monkeypatch.setattr(ptrees, "_fit_gbt_batch",
                        lambda *a, **k: calls.append(len(a[2])) or
                        real(*a, **k))
    monkeypatch.setattr(ptrees, "_LEVEL_HIST_ELEMS", 2 * 2 * 6 * 32 * 3)
    chunked = fam.fit_batch(_t(X), _t(y), _t(W), grid, 3)
    assert calls == [1, 1]
    for k in whole:
        assert torch.equal(chunked[k], whole[k]), k


def test_new_families_default_grids_match_jax():
    for name in ("DecisionTreeRegressorFamily", "RandomForestRegressorFamily",
                 "GBTRegressorFamily", "XGBoostClassifierFamily",
                 "XGBoostRegressorFamily"):
        p, j = getattr(ptrees, name)(), getattr(jtrees, name)()
        assert (p.name, p.supports) == (j.name, j.supports)
        if hasattr(j, "lam_default"):
            assert (p.lam_default, p.mcw_default) == (j.lam_default,
                                                      j.mcw_default)
        for problem in sorted(j.supports):
            assert p.default_grid(problem) == j.default_grid(problem)


# ---------------------------------------------------------------------------
# SanityChecker on a continuous and a 6-class label
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label_kind", ["regression", "multiclass"])
def test_sanity_checker_label_kinds_match_jax(label_kind):
    from transmogrifai_tpu import FeatureBuilder as JFB
    from transmogrifai_tpu.impl.preparators import SanityChecker as JSC
    from transmogrifai_tpu.table import Column as JColumn
    from transmogrifai_tpu.table import FeatureTable as JTable
    from transmogrifai_tpu.types import OPVector as JVec
    from transmogrifai_tpu.types import RealNN as JRealNN
    from transmogrifai_tpu.vector_metadata import (
        VectorColumnMetadata as JVCM, VectorMetadata as JVM,
    )
    from transmogrifai_tpu_torch.impl.preparators.sanity_checker import (
        SanityChecker,
    )
    from transmogrifai_tpu_torch.vector_metadata import (
        VectorColumnMetadata, VectorMetadata,
    )
    rng = np.random.RandomState(5)
    n = 600
    y = (rng.randn(n) * 3 if label_kind == "regression"
         else rng.randint(0, 6, n)).astype(np.float32)
    cat = rng.randint(0, 3, n)
    X = np.stack([y + rng.randn(n) * 2, y * 0.5 + rng.randn(n) * 0.01,
                  np.full(n, 2.0), rng.randn(n),
                  (cat == 0) * 1.0, (cat == 1) * 1.0, (cat == 2) * 1.0,
                  (y > 2) * 1.0, (y <= 2) * 1.0], axis=1).astype(np.float32)
    names = [("good", None, None), ("leaky", None, None),
             ("const", None, None), ("noise", None, None),
             ("cat", "cat", "a"), ("cat", "cat", "b"), ("cat", "cat", "c"),
             ("big", "big", "yes"), ("big", "big", "no")]
    jvm = JVM.of("features", [JVCM(p, "Real", g, i) for p, g, i in names])
    pvm = VectorMetadata.of("features", [VectorColumnMetadata(p, "Real", g, i)
                                         for p, g, i in names])
    jt = JTable({"label": JColumn(JRealNN, y, None),
                 "features": JColumn(JVec, X, None, {"vector_meta": jvm})}, n)
    pt = FeatureTable({"label": Column(RealNN, _t(y), None),
                       "features": Column(OPVector, _t(X), None,
                                          {"vector_meta": pvm})}, n)
    jm = JSC(sample_lower_limit=50).set_input(
        JFB.RealNN("label").extract_field().as_response(),
        JFB.OPVector("features").extract_field().as_predictor()).fit(jt)
    label = port.FeatureBuilder.RealNN("label").extract_field().as_response()
    pm = SanityChecker(sample_lower_limit=50).set_input(
        label, Feature("features", OPVector, False, None, ())).fit(pt)
    assert pm.keep_indices == jm.keep_indices
    assert pm.summary.reasons == jm.summary.reasons
    assert pm.summary.dropped == jm.summary.dropped
    jc, pc = jm.summary.categorical, pm.summary.categorical
    assert sorted(pc.cramers_v) == sorted(jc.cramers_v) == (
        [] if label_kind == "regression" else ["big::big", "cat::cat"])
    for group in jc.cramers_v:
        assert pc.cramers_v[group] == pytest.approx(jc.cramers_v[group],
                                                    rel=TOL)
        assert pc.mutual_info[group] == pytest.approx(jc.mutual_info[group],
                                                      rel=TOL, abs=TOL)
    _close(pm.summary.correlations_with_label,
           jm.summary.correlations_with_label, TOL)
