"""Workflow-level cross-validation, ``validate(val_masks=...)``, the random
grid builder and the Brier evaluator of the PyTorch port, against the JAX
package on the CPU.

The workflow cases run ``tests/test_workflow_cv.py``'s 400-row frame
(``x1``, ``x2`` -> ``transmogrify`` -> SanityChecker -> the binary CV
selector) through both packages from the same uids.

Tolerances, stated once:

* the winner, its hyperparameters, every fold's SanityChecker choices and
  the random grids: equal (the grids bit for bit: the same numpy draws);
* fold metrics: the logistic regression's bf16 sweep 5e-5, the GBT's
  1e-5 (the same trees; metrics summed in another order), as
  ``test_torch_titanic_e2e.py``;
* the Brier evaluator: the bins' counts equal, every float within 1e-12
  (the same float64 arithmetic on the same float32 inputs).
"""
from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pandas as pd
import pytest
import jax  # noqa: F401
import jax.numpy as jnp
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import transmogrifai_tpu  # noqa: E402,F401
from transmogrifai_tpu.features import FeatureBuilder as JFB  # noqa: E402
from transmogrifai_tpu.features import reset_uids as jax_reset  # noqa: E402
from transmogrifai_tpu.impl.feature.transmogrifier import (  # noqa: E402
    transmogrify as jax_transmogrify,
)
from transmogrifai_tpu.impl.selector.factories import (  # noqa: E402
    BinaryClassificationModelSelector as JBinary,
)
from transmogrifai_tpu.impl.selector.random_param_builder import (  # noqa: E402
    RandomParamBuilder as JRandom,
)
from transmogrifai_tpu.workflow import OpWorkflow as JWorkflow  # noqa: E402
import transmogrifai_tpu_torch as port  # noqa: E402
from transmogrifai_tpu_torch.features import reset_uids as port_reset  # noqa: E402
from transmogrifai_tpu_torch.impl.selector.random_param_builder import (  # noqa: E402
    RandomParamBuilder as PRandom,
)
from transmogrifai_tpu_torch.testing import (  # noqa: E402
    assert_same_sanity, sanity_summary, selection_gaps, selection_summary,
)
from test_torch_titanic_wcv_e2e import jax_fold_sanity_recorder  # noqa: E402

LINEAR_FOLD_ATOL = 5e-5
TREE_FOLD_ATOL = 1e-5
BRIER_ATOL = 1e-12

MODELS = [
    ("OpLogisticRegression", None),
    ("OpGBTClassifier", [{"maxDepth": 3, "maxIter": 10, "stepSize": 0.1,
                          "minInstancesPerNode": 10,
                          "minInfoGain": 0.001}]),
]


def _df(n=400, seed=9):
    """``tests/test_workflow_cv.py``'s frame."""
    rng = np.random.RandomState(seed)
    x1, x2 = rng.randn(n), rng.randn(n)
    y = ((x1 + 0.5 * x2 + 0.5 * rng.randn(n)) > 0).astype(float)
    return pd.DataFrame({"x1": x1, "x2": x2, "y": y})


def _fold_limit(family, hyper, value):
    return (LINEAR_FOLD_ATOL if family in ("OpLogisticRegression",
                                            "OpLinearSVC")
            else TREE_FOLD_ATOL)


def _jax_graph(models=MODELS):
    y = JFB.RealNN("y").extract_field().as_response()
    x1 = JFB.Real("x1").extract_field().as_predictor()
    x2 = JFB.Real("x2").extract_field().as_predictor()
    checked = jax_transmogrify([x1, x2]).sanity_check(y, min_variance=1e-8)
    return (JBinary.with_cross_validation(seed=2, models=models)
            .set_input(y, checked).get_output())


def _port_graph(models=MODELS):
    FB = port.FeatureBuilder
    y = FB.RealNN("y").extract_field().as_response()
    x1 = FB.Real("x1").extract_field().as_predictor()
    x2 = FB.Real("x2").extract_field().as_predictor()
    checked = port.transmogrify([x1, x2]).sanity_check(y, min_variance=1e-8)
    return (port.BinaryClassificationModelSelector.with_cross_validation(
        seed=2, models=models).set_input(y, checked).get_output())


def _columns(df):
    return {c: df[c].to_numpy() for c in df.columns}


def _train_both(df, fast_grids="1"):
    os.environ["TG_FAST_GRIDS"] = fast_grids
    jax_reset()
    jpred = _jax_graph()
    folds, undo = jax_fold_sanity_recorder()
    try:
        jm = (JWorkflow().set_input_dataset(df).set_result_features(jpred)
              .with_workflow_cv().train())
    finally:
        undo()
    port_reset()
    ppred = _port_graph()
    pwf = (port.OpWorkflow(device="cpu").set_input_dataset(_columns(df))
           .set_result_features(ppred).with_workflow_cv())
    pm = pwf.train()
    sel = next(s for s in pwf.stages
               if type(s).__name__ == "ModelSelector")
    return jm, jpred, folds, pm, ppred, sel


def test_workflow_cv_matches_jax():
    jm, jpred, jfolds, pm, ppred, sel = _train_both(_df())
    # each fold's SanityChecker, then the one refit on every row
    assert len(jfolds) == len(sel.fold_models) == 3
    for jf, pf in zip(jfolds, sel.fold_models):
        assert len(pf) == 1
        assert_same_sanity(sanity_summary(pf[0]), sanity_summary(jf))
    js = jm.get_stage(jpred.origin_stage.uid).summary
    ps = pm.get_stage(ppred.origin_stage.uid).summary
    gaps = selection_gaps(selection_summary(ps), selection_summary(js),
                          _fold_limit)
    assert set(gaps) == {"OpLogisticRegression", "OpGBTClassifier"}
    assert ps.best_metric_value == pytest.approx(js.best_metric_value,
                                                 abs=LINEAR_FOLD_ATOL)
    # fold metrics are (F, G): three folds of each family's whole grid
    for r in ps.validation_results:
        assert np.asarray(r.fold_metrics).shape == (3, len(r.grid))
    jsc = next(s for s in jm.stages
               if type(s).__name__ == "SanityCheckerModel")
    psc = next(s for s in pm.stages
               if type(s).__name__ == "SanityCheckerModel")
    assert_same_sanity(sanity_summary(psc), sanity_summary(jsc))
    assert set(sel.phase_seconds) == {"fold_prep", "sweep"}
    # the recorded winner was consumed by the refit
    assert getattr(sel, "_preset_best", None) is None


def test_workflow_cv_refit_scores_match_jax():
    df = _df()
    jm, jpred, _, pm, ppred, _ = _train_both(df)
    jv = np.asarray(jm.score(df=df)[jpred.name].values)
    pv = pm.score(data=_columns(df))[ppred.name].values.numpy()
    # the winner's refit on the same rows: TITANIC_LIN_* scale
    np.testing.assert_allclose(pv, jv, rtol=0, atol=2e-4)


def test_workflow_cv_requires_single_selector():
    df = _df()
    FB = port.FeatureBuilder
    FB.RealNN("y").extract_field().as_response()
    x1 = FB.Real("x1").extract_field().as_predictor()
    vec = port.transmogrify([x1])
    wf = (port.OpWorkflow(device="cpu").set_input_dataset(_columns(df))
          .set_result_features(vec).with_workflow_cv())
    with pytest.raises(ValueError, match="exactly one ModelSelector"):
        wf.train()
    # the JAX package's message, word for word
    y = JFB.RealNN("y").extract_field().as_response()
    jx1 = JFB.Real("x1").extract_field().as_predictor()
    jwf = (JWorkflow().set_input_dataset(df)
           .set_result_features(jax_transmogrify([jx1])).with_workflow_cv())
    with pytest.raises(ValueError) as jerr:
        jwf.train()
    with pytest.raises(ValueError) as perr:
        wf.train()
    assert str(perr.value) == str(jerr.value)
    del y


def test_failed_rest_phase_clears_the_recorded_winner(monkeypatch):
    from transmogrifai_tpu_torch.impl.selector.model_selector import (
        ModelSelector,
    )
    df = _df(200)
    port_reset()
    pred = _port_graph([("OpLogisticRegression",
                         [{"regParam": 0.1, "elasticNetParam": 0.0}])])
    wf = (port.OpWorkflow(device="cpu").set_input_dataset(_columns(df))
          .set_result_features(pred).with_workflow_cv())

    def broken_fit(self, table):
        raise RuntimeError("refit failed")
    monkeypatch.setattr(ModelSelector, "fit", broken_fit)
    with pytest.raises(RuntimeError, match="refit failed"):
        wf.train()
    assert pred.origin_stage._preset_best is None


def _seeded_xy(n=500, d=6, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    w = rng.randn(d).astype(np.float32)
    y = ((X @ w + 0.3 * rng.randn(n)) > 0).astype(np.float32)
    return X, y


@pytest.mark.parametrize("masks", ["one_fold", "two_folds_partial"])
def test_validate_with_masks_matches_jax(masks):
    from transmogrifai_tpu.impl.selector.model_selector import (
        ModelSelector as JSelector,
    )
    from transmogrifai_tpu.impl.tuning.validators import (
        OpCrossValidation as JCV,
    )
    from transmogrifai_tpu_torch.impl.selector.model_selector import (
        ModelSelector as PSelector,
    )
    from transmogrifai_tpu_torch.impl.tuning.validators import (
        OpCrossValidation as PCV,
    )
    X, y = _seeded_xy()
    kfold = PCV(num_folds=3, seed=5).make_splits(y)
    np.testing.assert_array_equal(kfold, JCV(num_folds=3,
                                             seed=5).make_splits(y))
    if masks == "one_fold":
        vm = kfold[1][None, :]
    else:
        # two disjoint folds that leave some rows train-only
        vm = kfold[:2].copy()
        vm[:, ::7] = False
    os.environ["TG_FAST_GRIDS"] = "1"
    jsel = JSelector("binary", JCV(num_folds=3, seed=5), None, MODELS)
    psel = PSelector("binary", PCV(num_folds=3, seed=5), None, MODELS)
    jb = jsel.validator.validate(jsel.models, jnp.asarray(X), jnp.asarray(y),
                                 "binary", "AuPR", True, 2, val_masks=vm)
    pb = psel.validator.validate(psel.models, torch.as_tensor(X),
                                 torch.as_tensor(y), "binary", "AuPR", True,
                                 2, val_masks=vm)
    assert (pb.family_name, pb.hyper) == (jb.family_name, jb.hyper)
    for jr, pr in zip(jb.results, pb.results):
        assert (pr.family, pr.grid) == (jr.family, jr.grid)
        assert np.asarray(pr.fold_metrics).shape == (vm.shape[0],
                                                     len(pr.grid))
        np.testing.assert_allclose(
            np.asarray(pr.fold_metrics), np.asarray(jr.fold_metrics),
            rtol=0, atol=_fold_limit(pr.family, None, None))


def test_validate_refuses_overlapping_masks():
    from transmogrifai_tpu_torch.impl.selector.model_selector import (
        ModelSelector as PSelector,
    )
    X, y = _seeded_xy(100)
    sel = PSelector("binary", None, None, MODELS[1:])
    vm = np.zeros((2, 100), bool)
    vm[:, :10] = True
    with pytest.raises(ValueError, match="disjoint"):
        sel.validator.validate(sel.models, torch.as_tensor(X),
                               torch.as_tensor(y), "binary", "AuPR", True, 2,
                               val_masks=vm)


def _builders(cls, seed):
    return (cls(seed=seed)
            .log_uniform("regParam", 1e-4, 1.0)
            .uniform("elasticNetParam", 0.0, 1.0)
            .integers("maxDepth", 2, 12)
            .choice("impurity", ["gini", "entropy", "variance"])
            .uniform("stepSize", -3.5, 2.25))


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 12345])
def test_random_param_builder_bit_equal(seed):
    got = _builders(PRandom, seed).build(64)
    want = _builders(JRandom, seed).build(64)
    assert got == want
    for g, w in zip(got, want):
        for k in w:
            assert type(g[k]) is type(w[k])
            if isinstance(w[k], float):
                assert np.float64(g[k]).tobytes() == np.float64(
                    w[k]).tobytes()


def test_random_param_builder_refuses_bad_bounds():
    with pytest.raises(ValueError, match="positive"):
        PRandom().log_uniform("regParam", 0.0, 1.0)


def test_random_grid_feeds_the_port_selector():
    df = _df(200)
    grid = (PRandom(seed=1).log_uniform("regParam", 1e-3, 0.5)
            .uniform("elasticNetParam", 0.0, 1.0).build(12))
    FB = port.FeatureBuilder
    y = FB.RealNN("y").extract_field().as_response()
    x1 = FB.Real("x1").extract_field().as_predictor()
    pred = (port.BinaryClassificationModelSelector
            .with_train_validation_split(
                seed=1, models=[("OpLogisticRegression", grid)])
            .set_input(y, port.transmogrify([x1])).get_output())
    model = (port.OpWorkflow(device="cpu").set_input_dataset(_columns(df))
             .set_result_features(pred).train())
    sel = model.get_stage(pred.origin_stage.uid)
    assert sel.summary.validation_results[0].grid == grid


def _scored_tables(n, seed):
    """Both packages' tables of a label and a binary Prediction column
    from the same seeded float32 scores; rows 0-2 score exactly 1.0 (the
    last bin) and row 3 exactly 0.0."""
    from transmogrifai_tpu.table import Column as JColumn
    from transmogrifai_tpu.table import FeatureTable as JTable
    from transmogrifai_tpu.types import Prediction as JPrediction
    from transmogrifai_tpu.types import RealNN as JRealNN
    from transmogrifai_tpu_torch.table import Column, FeatureTable
    from transmogrifai_tpu_torch.types import Prediction, RealNN

    rng = np.random.RandomState(seed)
    p1 = rng.rand(n).astype(np.float32)
    p1[:3] = 1.0
    p1[3] = 0.0
    p1[4] = np.float32(0.01)            # a bin edge in float32
    y = (rng.rand(n) < p1).astype(np.float32)
    keys = ("prediction", "rawPrediction_0", "rawPrediction_1",
            "probability_0", "probability_1")
    P = np.stack([(p1 >= 0.5).astype(np.float32), -p1, p1, 1 - p1, p1],
                 axis=1).astype(np.float32)
    jt = JTable({"y": JColumn(JRealNN, y, None, {}),
                 "p": JColumn(JPrediction, P, None, {"keys": keys})}, n)
    pt = FeatureTable({"y": Column(RealNN, y, None),
                       "p": Column(Prediction, P, None, {"keys": keys})}, n)
    return jt, pt


@pytest.mark.parametrize("n,seed", [(1000, 0), (4096, 1), (37, 2)])
def test_bin_score_evaluator_matches_jax(n, seed):
    from transmogrifai_tpu.evaluators import Evaluators as JEvaluators
    jt, pt = _scored_tables(n, seed)
    want = (JEvaluators.BinaryClassification.brier_score()
            .set_label_col("y").set_prediction_col("p").evaluate_all(jt))
    ev = (port.Evaluators.BinaryClassification.brier_score()
          .set_label_col("y").set_prediction_col("p"))
    got = ev.evaluate_all(pt)
    assert (ev.default_metric, ev.larger_better) == ("BrierScore", False)
    assert sorted(got) == sorted(want)
    assert got["numberOfDataPoints"] == want["numberOfDataPoints"]
    assert got["numberOfDataPoints"][-1] >= 3      # the scores of 1.0
    for k in ("binCenters", "averageScore", "averageConversionRate"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=BRIER_ATOL)
    assert got["BrierScore"] == pytest.approx(want["BrierScore"], rel=0,
                                              abs=BRIER_ATOL)
    assert ev.evaluate(pt) == got["BrierScore"]
