"""Sweep and train robustness of the PyTorch port against the JAX package
(``tests/test_robustness.py``'s and ``tests/test_pressure.py``'s cases):
quarantine, retries, guards, checkpoint skip-and-refit, and the sweep's
grid split under memory pressure.

Two repairs are pinned here against the JAX package's result on the same
frame: a family whose sweep raises is quarantined and the sweep goes on
(it ended the train), and ``with_fault_policy`` retries an in-core stage
fit (it did nothing there).
"""
from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import torch

import transmogrifai_tpu as tg
from transmogrifai_tpu.features import reset_uids as jax_reset
from transmogrifai_tpu.impl.selector.factories import (
    BinaryClassificationModelSelector as JSel,
)
from transmogrifai_tpu.impl.tuning import validators as JV
from transmogrifai_tpu.models.api import MODEL_REGISTRY as JREG
from transmogrifai_tpu.robustness import faults as jfaults
from transmogrifai_tpu.robustness import guards as jguards
from transmogrifai_tpu.robustness.policy import RetryPolicy as JRetry
from transmogrifai_tpu.workflow import OpWorkflow as JWF

from transmogrifai_tpu_torch.dsl import transmogrify as ptransmogrify
from transmogrifai_tpu_torch.features import (
    FeatureBuilder as PFB, reset_uids as port_reset,
)
from transmogrifai_tpu_torch.impl.selector.factories import (
    BinaryClassificationModelSelector as PSel,
)
from transmogrifai_tpu_torch.impl.tuning.validators import OpCrossValidation
from transmogrifai_tpu_torch.models.api import MODEL_REGISTRY
from transmogrifai_tpu_torch.robustness import faults, resources
from transmogrifai_tpu_torch.robustness.guards import (
    AllCandidatesFailedError, params_finite, quarantine_non_finite,
)
from transmogrifai_tpu_torch.robustness.policy import FaultLog, RetryPolicy
from transmogrifai_tpu_torch.workflow import OpWorkflow as PWF

pytestmark = pytest.mark.chaos

LR_GRID = [{"regParam": 0.01, "elasticNetParam": 0.0},
           {"regParam": 0.1, "elasticNetParam": 0.0}]
TWO = [("OpLogisticRegression", LR_GRID),
       ("OpLinearSVC", [{"regParam": 0.01}])]

JAX = SimpleNamespace(FB=tg.FeatureBuilder, transmogrify=tg.transmogrify,
                      Sel=JSel, reset=jax_reset, faults=jfaults,
                      Retry=JRetry, reg=JREG,
                      wf=lambda data: JWF().set_input_dataset(
                          pd.DataFrame(data)))
PORT = SimpleNamespace(FB=PFB, transmogrify=ptransmogrify, Sel=PSel,
                       reset=port_reset, faults=faults, Retry=RetryPolicy,
                       reg=MODEL_REGISTRY,
                       wf=lambda data: PWF(device="cpu").set_input_dataset(
                           data))


def _data(n=300, seed=7):
    rng = np.random.RandomState(seed)
    x1, x2 = rng.randn(n), rng.randn(n)
    return {"x1": x1, "x2": x2, "y": ((x1 + 0.5 * x2) > 0).astype(float)}


def _workflow(ns, data, models=None):
    ns.reset()
    FB = ns.FB
    label = FB.RealNN("y").extract_field().as_response()
    f1 = FB.Real("x1").extract_field().as_predictor()
    f2 = FB.Real("x2").extract_field().as_predictor()
    checked = ns.transmogrify([f1, f2]).sanity_check(label)
    pred = (ns.Sel.with_cross_validation(
        models=models or [("OpLogisticRegression", LR_GRID)])
        .set_input(label, checked).get_output())
    return ns.wf(data).set_result_features(pred), pred


def _selection(model, pred):
    s = model.summary()[pred.origin_stage.uid]
    return {k: s[k] for k in ("bestModelType", "bestHyperparameters",
                              "bestMetricValue")}, s


def _quarantine_view(sel):
    return [{k: q[k] for k in ("family", "gridIndex", "hyper", "reason")}
            for q in sel["quarantinedCandidates"]]


def _same_quarantine_outcome(jmodel, jpred, pmodel, ppred):
    jsel, jfull = _selection(jmodel, jpred)
    psel, pfull = _selection(pmodel, ppred)
    assert psel == jsel
    assert _quarantine_view(pfull) == _quarantine_view(jfull)
    pq = pmodel.summary()["faults"]["quarantined"]
    jq = jmodel.summary()["faults"]["quarantined"]
    assert [(r["site"], r["detail"]["family"], r["detail"]["gridIndex"])
            for r in pq] == [(r["site"], r["detail"]["family"],
                              r["detail"]["gridIndex"]) for r in jq]


@pytest.fixture(scope="module")
def data():
    return _data()


# -- repair: a family that raises is quarantined, the sweep goes on ------------

def test_family_whose_fit_raises_is_quarantined_as_in_the_jax_package(
        data, monkeypatch):
    """A family's sweep fit raises with no site involved (a bug, a
    failed solve): the port quarantines it with its reason and selects
    among the others, as the JAX package does."""
    def boom(*a, **k):
        raise RuntimeError("boom")
    for ns in (JAX, PORT):
        monkeypatch.setattr(ns.reg["OpLinearSVC"], "sweep_fit_batch", boom)
    JV._FUSED_CACHE.clear()       # no cached JAX program skips the trace
    try:
        out = {}
        for key, ns in (("jax", JAX), ("port", PORT)):
            wf, pred = _workflow(ns, data, TWO)
            out[key] = (wf.train(), pred)
    finally:
        JV._FUSED_CACHE.clear()
    _same_quarantine_outcome(*out["jax"], *out["port"])
    _, sel = _selection(*out["port"])
    assert sel["bestModelType"] == "OpLogisticRegression"
    assert sel["quarantinedCandidates"][0]["reason"] == \
        "fit raised RuntimeError: boom"


def test_family_fit_site_quarantines_family_not_sweep(data):
    out = {}
    for key, ns in (("jax", JAX), ("port", PORT)):
        with ns.faults.injected({"validator.family_fit": {
                "mode": "raise", "key": "OpLinearSVC", "count": 99}}):
            wf, pred = _workflow(ns, data, TWO)
            out[key] = (wf.train(), pred)
    _same_quarantine_outcome(*out["jax"], *out["port"])
    qs = out["port"][0].summary()["faults"]["quarantined"]
    assert qs and all(r["detail"]["family"] == "OpLinearSVC" for r in qs)
    assert all("fit raised" in r["detail"]["reason"] for r in qs)


# -- repair: with_fault_policy retries an in-core stage fit --------------------

@pytest.mark.parametrize("cv", [False, True], ids=["dag", "workflow_cv"])
def test_stage_fit_transient_error_retried_under_policy(data, cv):
    kinds = {}
    for key, ns in (("jax", JAX), ("port", PORT)):
        with ns.faults.injected({"dag.stage_fit": {"mode": "raise",
                                                   "nth": 1}}):
            wf, pred = _workflow(ns, data)
            if cv:
                wf.with_workflow_cv()
            model = wf.with_fault_policy(
                ns.Retry(max_retries=2, base_delay=0.0)).train()
        faults_ = model.summary()["faults"]
        assert any(r["site"].startswith("dag.stage_fit")
                   and r["retries"] == 1 for r in faults_["retries"])
        kinds[key] = {k: [(r["site"], r["kind"], r["retries"])
                          for r in v] for k, v in faults_.items()
                      if isinstance(v, list)}
        kinds[key + "_sel"] = _selection(model, pred)[0]
    assert kinds["port"] == kinds["jax"]
    assert kinds["port_sel"] == kinds["jax_sel"]


def test_stage_fit_fatal_without_policy(data):
    for ns in (JAX, PORT):
        with ns.faults.injected({"dag.stage_fit": {"mode": "raise",
                                                   "nth": 1}}):
            wf, _ = _workflow(ns, data)
            with pytest.raises(ns.faults.TransientFaultError):
                wf.train()


# -- guards ------------------------------------------------------------------------

def test_quarantine_non_finite_masks_and_records():
    fm = np.array([[0.9, np.nan, 0.8], [0.7, 0.5, np.inf]])
    grid = [{"a": 1}, {"a": 2}, {"a": 3}]
    log = FaultLog()
    with log.activate():
        mean, masked, recs = quarantine_non_finite("fam", grid, fm, "AuPR",
                                                   True)
    jmean, jmasked, jrecs = jguards.quarantine_non_finite(
        "fam", grid, fm, "AuPR", True)
    np.testing.assert_array_equal(masked, jmasked)
    np.testing.assert_array_equal(mean, jmean)
    assert repr(recs) == repr(jrecs)         # NaN fold metrics included
    assert [r["gridIndex"] for r in recs] == [1, 2]
    assert [r.site for r in log.of_kind("quarantine")] == [
        "validator.candidate"] * 2
    fm2 = np.array([[0.9, 0.8]])
    mean2, masked2, recs2 = quarantine_non_finite("fam", grid[:2], fm2,
                                                  "AuPR", True)
    assert recs2 == [] and masked2 is mean2
    _, _, recs3 = quarantine_non_finite("fam", grid[:1],
                                        np.array([[np.nan]]), "AuPR", True,
                                        reason="fit raised X")
    assert recs3[0]["reason"] == "fit raised X"


def test_params_finite_and_the_inf_sentinel():
    t = torch.tensor
    assert params_finite({"coef": t([1.0, 2.0]),
                          "nested": {"b": t([0.0])},
                          "pair": (t([1.0]), t([2.0])),
                          "ints": t([1, 2], dtype=torch.int32)})
    assert not params_finite({"coef": t([1.0, float("nan")])})
    assert not params_finite({"nested": {"b": t([float("inf")])}})
    assert not params_finite({"pair": (t([1.0]), t([float("inf")]))})
    p = {"thresh": t([float("inf"), 1.0]), "leaf": t([0.5])}
    assert params_finite(p, allow_inf=("thresh",))
    assert not params_finite(p)
    assert not params_finite({"thresh": t([float("nan")])},
                             allow_inf=("thresh",))
    # the old names resolve
    from transmogrifai_tpu_torch.impl.selector import model_selector as ms
    from transmogrifai_tpu_torch.impl.tuning import validators as pv
    assert pv.AllCandidatesFailedError is AllCandidatesFailedError
    assert pv.quarantine_non_finite is quarantine_non_finite
    assert ms._params_finite is params_finite


# -- quarantine and retries end to end --------------------------------------------

def test_nan_candidate_quarantined_sweep_completes(data):
    with faults.injected({"validator.fold_metrics": {
            "mode": "nan", "index": 1, "key": "OpLogisticRegression"}}):
        wf, pred = _workflow(PORT, data)
        model = wf.train()
    s = model.summary()
    sel = s[pred.origin_stage.uid]
    assert sel["bestHyperparameters"] == LR_GRID[0]
    assert np.isfinite(sel["bestMetricValue"])
    (q,) = s["faults"]["quarantined"]
    assert q["detail"]["gridIndex"] == 1
    assert q["detail"]["hyper"] == LR_GRID[1]
    assert "non-finite" in q["detail"]["reason"]
    assert pred.name in model.score(data=data).column_names


def test_all_candidates_failed_raises_aggregated(data):
    with faults.injected({"validator.fold_metrics": {"mode": "nan",
                                                     "index": None}}):
        wf, _ = _workflow(PORT, data)
        with pytest.raises(AllCandidatesFailedError) as ei:
            wf.train()
    assert len(ei.value.records) == len(LR_GRID)
    assert "all 2 sweep candidate(s) were quarantined" in str(ei.value)


def test_workflow_cv_quarantine():
    data = _data(n=400)
    with faults.injected({"validator.fold_metrics": {
            "mode": "nan", "index": 1, "key": "OpLogisticRegression"}}):
        wf, pred = _workflow(PORT, data)
        model = wf.with_workflow_cv().train()
    sel = model.summary()[pred.origin_stage.uid]
    assert sel["bestHyperparameters"] == LR_GRID[0]
    assert any(r["gridIndex"] == 1 for r in sel["quarantinedCandidates"])


def test_transient_transfer_retried_two_attempts(data):
    with faults.injected({"distributed.to_host": {
            "mode": "raise", "nth": 1, "count": 2}}):
        wf, _ = _workflow(PORT, data)
        model = wf.with_fault_policy().train()
    retries = model.summary()["faults"]["retries"]
    (rep,) = [r for r in retries if r["site"] == "distributed.to_host"]
    assert rep["retries"] == 2 and rep["attempts"] == 3
    assert model.summary()["faults"]["quarantined"] == []


def test_selector_refit_fault_falls_back_to_next_candidate(data):
    with faults.injected({"selector.refit": {"mode": "raise", "nth": 1}}):
        wf, pred = _workflow(PORT, data)
        model = wf.train()
    quarantined = model.summary()["faults"]["quarantined"]
    assert any(q["site"] == "selector.refit" for q in quarantined)
    sel = model.summary()[pred.origin_stage.uid]
    assert sel["bestHyperparameters"] == LR_GRID[1]


def test_corrupt_checkpoint_skipped_and_reported(tmp_path, data):
    ck = str(tmp_path / "ckpt")
    wf, pred1 = _workflow(PORT, data)
    m1 = wf.with_checkpoint_dir(ck).train()
    npzs = sorted(f for f in os.listdir(ck) if f.endswith(".npz"))
    with open(os.path.join(ck, npzs[0]), "wb") as fh:
        fh.write(b"not-an-npz")
    wf, pred2 = _workflow(PORT, data)
    m2 = wf.with_checkpoint_dir(ck).train()
    (rep,) = m2.summary()["faults"]["checkpointsSkipped"]
    assert rep["detail"]["uid"] == npzs[0][:-4] and "error" in rep["detail"]
    np.testing.assert_array_equal(
        m1.score(data=data)[pred1.name].values.numpy(),
        m2.score(data=data)[pred2.name].values.numpy())


def test_no_injection_bit_identical_selection(data):
    runs = [_workflow(PORT, data) for _ in range(2)]
    sels = [_selection(wf.train(), pred)[0] for wf, pred in runs]
    assert sels[0] == sels[1]
    wf, _ = _workflow(PORT, data)
    f = wf.train().summary()["faults"]
    assert f["quarantined"] == [] and f["retries"] == []
    assert f["checkpointsSkipped"] == [] and f["fatal"] == []


# -- memory pressure: the sweep's grid split (tests/test_pressure.py) ---------

def _sweep_inputs(n=800, d=6, seed=31):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X @ rng.randn(d).astype(np.float32) > 0).astype(np.float32)
    return X, y


def _sweep_models(reg):
    lr = [{"regParam": r, "elasticNetParam": e}
          for r in (0.001, 0.01, 0.1, 0.3) for e in (0.0, 0.5)]
    svc = [{"regParam": float(r)} for r in (0.001, 0.01, 0.1)]
    return [(reg["OpLogisticRegression"], lr), (reg["OpLinearSVC"], svc)]


def _validate(models, X, y, folds=3):
    return OpCrossValidation(num_folds=folds, seed=0).validate(
        models, torch.as_tensor(X), torch.as_tensor(y), "binary", "AuROC",
        True, 2)


def test_oom_sweep_splits_grid_winner_identical():
    import jax.numpy as jnp
    X, y = _sweep_inputs()
    clean = _validate(_sweep_models(MODEL_REGISTRY), X, y)
    jclean = JV.OpCrossValidation(num_folds=3, seed=0).validate(
        _sweep_models(JREG), jnp.asarray(X), jnp.asarray(y), "binary",
        "AuROC", True, 2)
    assert (clean.family_name, clean.hyper) == (jclean.family_name,
                                                jclean.hyper)
    log = FaultLog()
    with log.activate(), faults.injected({"oom.sweep": {
            "mode": "oom", "nth": 1, "count": 2,
            "key": "OpLogisticRegression"}}):
        forced = _validate(_sweep_models(MODEL_REGISTRY), X, y)
    assert (forced.family_name, forced.hyper, forced.metric_value) == (
        clean.family_name, clean.hyper, clean.metric_value)
    assert not forced.quarantined
    for rc, rf in zip(clean.results, forced.results):
        np.testing.assert_array_equal(rc.fold_metrics, rf.fold_metrics)
    ds = log.of_kind("oom_downshift")
    assert [d.detail["splitConfigs"] for d in ds] == [[4, 4], [2, 2]]
    assert all(d.site == "oom.sweep" and
               d.detail["family"] == "OpLogisticRegression" for d in ds)


def test_oom_sweep_single_config_exhaustion_quarantines_family():
    X, y = _sweep_inputs(400, 4, seed=32)
    with faults.injected({"oom.sweep": {"mode": "oom", "nth": 1,
                                        "count": 10_000,
                                        "key": "OpLinearSVC"}}):
        best = _validate(_sweep_models(MODEL_REGISTRY), X, y, folds=2)
    assert best.family_name == "OpLogisticRegression"
    assert any(q["family"] == "OpLinearSVC" for q in best.quarantined)


RF_GRID = [{"maxDepth": d, "minInstancesPerNode": 1, "minInfoGain": 0.0,
            "numTrees": 3, "subsamplingRate": 1.0} for d in (2, 3)]


def test_tree_split_is_bit_equal_and_reads_a_cuda_oom(monkeypatch):
    """An RF family's halves keep each configuration's place in the whole
    batch (its bootstrap seed), so the merged fold metrics are the
    unsplit ones bit for bit; a ``torch.cuda.OutOfMemoryError`` raised
    from the family's fit splits the grid as the site does."""
    X, y = _sweep_inputs(400, 4, seed=33)
    rf = [(MODEL_REGISTRY["OpRandomForestClassifier"], RF_GRID)]
    clean = _validate(rf, X, y)
    fam = MODEL_REGISTRY["OpRandomForestClassifier"]
    orig = type(fam).sweep_fit_batch
    calls = []

    def once(self, X, y, W, grid, num_classes):
        calls.append(W.shape[0])
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return orig(self, X, y, W, grid, num_classes)
    assert resources.classify_exhaustion(
        torch.cuda.OutOfMemoryError("x")) is not None
    log = FaultLog()
    monkeypatch.setattr(type(fam), "sweep_fit_batch", once)
    with log.activate():
        split = _validate(rf, X, y)
    assert calls == [6, 3, 3]
    np.testing.assert_array_equal(split.results[0].fold_metrics,
                                  clean.results[0].fold_metrics)
    assert (split.family_name, split.hyper) == (clean.family_name,
                                                clean.hyper)
    (ds,) = log.of_kind("oom_downshift")
    assert ds.detail["splitConfigs"] == [1, 1]
    assert "OutOfMemoryError" in ds.detail["error"]
