"""The three selectors with their default model lists, end to end, against
the JAX package on the CPU: ``tests/test_model_selector.py``'s frames, the
default lists (linear families, GLM and the tree families), the
``TG_FAST_GRIDS`` truncation, the train/validation split, exact sweep
fits, the refit fallback and ``summary_pretty``.

The suite runs with ``TG_FAST_GRIDS=1`` (``tests/conftest.py``), so default
grids hold two configurations, as in the JAX package's own tests; the
binary case runs the full default grids (``TG_FAST_GRIDS=0``) and pins the
LR fold-metric shape (3, 6), as ``test_binary_selector_cv`` does.

Tolerances: the winner, its hyperparameters, the families' order and
grids equal; fold metrics within 5e-5 (bf16 sweeps; measured 1.2e-7 on
these frames) and 1e-5 with exact sweep fits; holdout metrics within
1e-5.
"""
from __future__ import annotations

import logging
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import jax  # noqa: F401
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

from test_torch_serve import FIXTURE_DIR  # noqa: E402
import transmogrifai_tpu_torch as port  # noqa: E402
from transmogrifai_tpu_torch.features import Feature  # noqa: E402
from transmogrifai_tpu_torch.impl.selector import (  # noqa: E402
    model_selector as pms,
)
from transmogrifai_tpu_torch.models.api import (  # noqa: E402
    MODEL_REGISTRY as PORT_REGISTRY,
)
from transmogrifai_tpu_torch.table import Column, FeatureTable  # noqa: E402
from transmogrifai_tpu_torch.types import OPVector, RealNN  # noqa: E402

FOLD_ATOL = 5e-5
EXACT_ATOL = 1e-5
HOLDOUT_ATOL = 1e-5

FACTORY = {"binary": "BinaryClassificationModelSelector",
           "multiclass": "MultiClassificationModelSelector",
           "regression": "RegressionModelSelector"}

#: the JAX package's default model types (its model_selector.py:132-140)
JAX_DEFAULTS = {
    "binary": ["OpLogisticRegression", "OpRandomForestClassifier",
               "OpGBTClassifier", "OpLinearSVC"],
    "multiclass": ["OpLogisticRegression", "OpRandomForestClassifier"],
    "regression": ["OpLinearRegression", "OpRandomForestRegressor",
                   "OpGBTRegressor", "OpGeneralizedLinearRegression"],
}


def _frame(kind):
    """``tests/test_model_selector.py``'s frames: binary ``_binary_table``
    (300 x 4, seed 0), multiclass (300 x 3, seed 3), regression (300 x 3,
    seed 4)."""
    if kind == "binary":
        rng = np.random.RandomState(0)
        X = rng.randn(300, 4).astype(np.float32)
        w = rng.randn(4).astype(np.float32)
        y = ((X @ w + 0.2 * rng.randn(300)) > 0).astype(np.float32)
    elif kind == "multiclass":
        rng = np.random.RandomState(3)
        X = rng.randn(300, 3).astype(np.float32)
        y = np.argmax(X[:, :3] + 0.3 * rng.randn(300, 3),
                      axis=1).astype(np.float32)
    else:
        rng = np.random.RandomState(4)
        X = rng.randn(300, 3).astype(np.float32)
        y = (X @ np.array([1.0, -2.0, 0.5]) + 3.0
             + 0.1 * rng.randn(300)).astype(np.float32)
    return X, y


def _fit_both(kind, make="with_cross_validation", **kw):
    """(JAX model, port model) of ``kind``'s selector fitted on its frame
    with the factory method ``make`` and keywords ``kw``."""
    from transmogrifai_tpu import FeatureBuilder as JFB
    from transmogrifai_tpu.impl.selector import factories as jfac
    from transmogrifai_tpu.table import Column as JColumn
    from transmogrifai_tpu.table import FeatureTable as JTable
    from transmogrifai_tpu.types import OPVector as JVec
    from transmogrifai_tpu.types import RealNN as JRealNN
    X, y = _frame(kind)
    n = len(y)
    jsel = getattr(getattr(jfac, FACTORY[kind]), make)(**kw)
    jsel.set_input(JFB.RealNN("label").extract_field().as_response(),
                   JFB.OPVector("features").extract_field().as_predictor())
    jt = JTable({"label": JColumn(JRealNN, y, None),
                 "features": JColumn(JVec, X, None)}, n)
    psel = getattr(getattr(port, FACTORY[kind]), make)(**kw)
    psel.set_input(
        port.FeatureBuilder.RealNN("label").extract_field().as_response(),
        Feature("features", OPVector, False, None, ()))
    pt = FeatureTable({"label": Column(RealNN, torch.from_numpy(y), None),
                       "features": Column(OPVector, torch.from_numpy(X),
                                          None)}, n)
    return jsel.fit(jt), psel.fit(pt)


def _assert_same_selection(jm, pm, atol=FOLD_ATOL):
    js, ps = jm.summary, pm.summary
    assert (ps.best_model_type, ps.best_hyper) == (js.best_model_type,
                                                   js.best_hyper)
    assert ps.validation_type == js.validation_type
    assert [r.family for r in ps.validation_results] == [
        r.family for r in js.validation_results]
    for jr, pr in zip(js.validation_results, ps.validation_results):
        assert pr.grid == jr.grid, jr.family
        jf = np.asarray(jr.fold_metrics)
        assert np.asarray(pr.fold_metrics).shape == jf.shape
        np.testing.assert_allclose(np.asarray(pr.fold_metrics), jf, rtol=0,
                                   atol=atol, err_msg=jr.family)
    assert ps.best_metric_value == pytest.approx(js.best_metric_value,
                                                 abs=atol)
    keys = sorted(js.holdout_evaluation)
    assert sorted(ps.holdout_evaluation) == keys
    # NaN where a metric is undefined (an SVC has no LogLoss)
    np.testing.assert_allclose([ps.holdout_evaluation[k] for k in keys],
                               [js.holdout_evaluation[k] for k in keys],
                               rtol=0, atol=HOLDOUT_ATOL, equal_nan=True)


@pytest.mark.parametrize("kind", ["binary", "multiclass", "regression"])
def test_default_selector_matches_jax(kind, monkeypatch):
    kw = {}
    if kind == "binary":
        # the full default grids, as test_binary_selector_cv runs them
        monkeypatch.setenv("TG_FAST_GRIDS", "0")
        kw = {"seed": 7}
    jm, pm = _fit_both(kind, **kw)
    _assert_same_selection(jm, pm)
    assert [r.family for r in pm.summary.validation_results] == \
        JAX_DEFAULTS[kind]
    if kind == "binary":
        lr = pm.summary.validation_results[0]
        assert np.asarray(lr.fold_metrics).shape == (3, 6)
        assert pm.summary.best_model_type == "OpLinearSVC"
    else:
        for r in pm.summary.validation_results:
            assert np.asarray(r.fold_metrics).shape == (3, 2)
    # the same text but the first line, which names each stage's own uid
    ptext, jtext = pm.summary_pretty(), jm.summary_pretty()
    assert ptext.splitlines()[0] == f"-- ModelSelector ({pm.uid}) --"
    assert ptext.splitlines()[1:] == jtext.splitlines()[1:]


def test_default_lists_and_fast_grid_truncation(caplog):
    """models=None resolves to the JAX package's default lists; with
    TG_FAST_GRIDS set only default grids shrink to two configurations,
    with the JAX package's warning."""
    assert pms.DEFAULT_MODELS == JAX_DEFAULTS
    assert os.environ.get("TG_FAST_GRIDS") == "1"
    with caplog.at_level(logging.WARNING):
        sel = pms.ModelSelector("regression")
    assert [f.name for f, _ in sel.models] == JAX_DEFAULTS["regression"]
    for fam, grid in sel.models:
        assert grid == fam.default_grid("regression")[:2]
    assert ("TG_FAST_GRIDS is set: default OpGeneralizedLinearRegression "
            "grid truncated 8 -> 2 configs (test mode)") in caplog.text
    passed = [{"regParam": r} for r in (0.01, 0.1, 0.2)]
    sel = pms.ModelSelector("binary", models=[("OpLinearSVC", passed)])
    assert sel.models == [(PORT_REGISTRY["OpLinearSVC"], passed)]


LINEAR_ONLY = {"binary": [("OpLogisticRegression", None),
                          ("OpLinearSVC", None)],
               "regression": [("OpLinearRegression", None),
                              ("OpGeneralizedLinearRegression", None)]}


@pytest.mark.parametrize("kind", ["binary", "regression"])
def test_train_validation_split_matches_jax(kind):
    jm, pm = _fit_both(kind, make="with_train_validation_split", seed=1,
                       models=LINEAR_ONLY[kind])
    _assert_same_selection(jm, pm)
    assert pm.summary.validation_type == "OpTrainValidationSplit"
    for r in pm.summary.validation_results:
        assert np.asarray(r.fold_metrics).shape == (1, 2)


def test_exact_sweep_fits_take_fit_batch(monkeypatch):
    """exact_sweep_fits=True fits CV candidates through fit_batch (f32,
    the refit's schedule) in both packages."""
    for name in ("OpLogisticRegression", "OpLinearSVC"):
        def refuse(*a, **k):
            raise AssertionError("sweep_fit_batch with exact_sweep_fits")
        monkeypatch.setattr(PORT_REGISTRY[name], "sweep_fit_batch", refuse)
    jm, pm = _fit_both("binary", models=LINEAR_ONLY["binary"],
                       exact_sweep_fits=True)
    _assert_same_selection(jm, pm, atol=EXACT_ATOL)


def test_refit_fallback_matches_jax(monkeypatch):
    """A winner whose refit yields non-finite params yields to the
    next-ranked candidate, which both packages choose alike, and the
    failure is recorded as a quarantined candidate."""
    from transmogrifai_tpu.models.api import (
        MODEL_REGISTRY as JAX_REGISTRY,
    )
    name = "OpLinearSVC"           # the binary frame's winner
    jfam, pfam = JAX_REGISTRY[name], PORT_REGISTRY[name]
    jfit, pfit = jfam.fit_batch, pfam.fit_batch

    def jax_nan(*a, **k):
        out = jfit(*a, **k)
        return dict(out, coef=out["coef"] * float("nan"))

    def port_nan(*a, **k):
        out = pfit(*a, **k)
        return dict(out, coef=out["coef"] * float("nan"))
    monkeypatch.setattr(jfam, "fit_batch", jax_nan)
    monkeypatch.setattr(pfam, "fit_batch", port_nan)
    jm, pm = _fit_both("binary", seed=7, models=LINEAR_ONLY["binary"])
    js, ps = jm.summary, pm.summary
    assert js.best_model_type == "OpLogisticRegression"
    assert (ps.best_model_type, ps.best_hyper) == (js.best_model_type,
                                                   js.best_hyper)
    assert ps.best_metric_value == pytest.approx(js.best_metric_value,
                                                 abs=FOLD_ATOL)
    assert [(q["family"], q["hyper"], q["reason"]) for q in ps.quarantined
            ] == [(q["family"], q["hyper"], q["reason"])
                  for q in js.quarantined]
    assert ps.quarantined[0]["reason"] == (
        "refit failed: ArithmeticError: refit produced non-finite fitted "
        "params")
    assert torch.isfinite(pm.fitted.params["coef"]).all()


def _linear_binary_selector_and_table():
    X, y = _frame("binary")
    sel = port.BinaryClassificationModelSelector.with_cross_validation(
        seed=7, models=LINEAR_ONLY["binary"])
    sel.set_input(
        port.FeatureBuilder.RealNN("label").extract_field().as_response(),
        Feature("features", OPVector, False, None, ()))
    table = FeatureTable({"label": Column(RealNN, torch.from_numpy(y), None),
                          "features": Column(OPVector, torch.from_numpy(X),
                                             None)}, len(y))
    return sel, table


@pytest.mark.parametrize("error", [ArithmeticError, torch.linalg.LinAlgError])
def test_ranked_candidates_order_and_attempt_cap(monkeypatch, caplog, error):
    """Every refit failing numerically exhausts three ranked candidates,
    each with a warning, then raises with every failure recorded."""
    def fail(*a, **k):
        raise error("no refit")
    for name in ("OpLogisticRegression", "OpLinearSVC"):
        monkeypatch.setattr(PORT_REGISTRY[name], "fit_batch", fail)
    sel, table = _linear_binary_selector_and_table()
    with caplog.at_level(logging.WARNING, logger=pms.__name__), \
            pytest.raises(pms.AllCandidatesFailedError) as err:
        sel.fit(table)
    assert len(err.value.records) == pms._MAX_REFIT_ATTEMPTS
    assert all(r["reason"] == f"refit failed: {error.__name__}: no refit"
               for r in err.value.records)
    warned = [r for r in caplog.records
              if "refitting the next-ranked candidate" in r.getMessage()]
    assert len(warned) == pms._MAX_REFIT_ATTEMPTS


def test_refit_raises_other_errors(monkeypatch):
    """An error that is not numeric (a kernel's launch or build error is a
    RuntimeError) stops the selection at the first refit: no other
    candidate is fitted in its place."""
    calls = []

    def fail(*a, **k):
        calls.append(1)
        raise RuntimeError("node_hist: CUDA error 700 (an illegal memory "
                           "access was encountered)")
    for name in ("OpLogisticRegression", "OpLinearSVC"):
        monkeypatch.setattr(PORT_REGISTRY[name], "fit_batch", fail)
    sel, table = _linear_binary_selector_and_table()
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        sel.fit(table)
    assert len(calls) == 1


@pytest.mark.parametrize("key", ["default_reg", "svc", "lrmc"])
def test_summary_pretty_of_a_saved_summary_matches_jax(key):
    """The same saved summaries print the same text in both packages, the
    selector's and the whole workflow's: the regression default list's
    (four families) and the binary and multiclass lists' refits (the
    pinned models that stand for them)."""
    from transmogrifai_tpu.persistence import load_model as jax_load
    path = os.path.join(FIXTURE_DIR, key)
    jm, pm = jax_load(path), port.load_model(path, device="cpu")
    assert pm.stages[-1].summary_pretty() == jm.stages[-1].summary_pretty()
    assert pm.summary_pretty() == jm.summary_pretty()
    assert "-- SanityChecker" in pm.summary_pretty()
