"""Regression and multiclass problems end to end: the multiclass and
regression selectors over the tree families, and tiny serve-bench
workflows trained by both packages and saved by the JAX package, against
the JAX package on the CPU (the family-level parity is in
``test_torch_tasks.py``, whose tolerances hold here too).
"""
from __future__ import annotations

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

from test_torch_serve import (  # noqa: E402
    _assert_parts_agree, bench_frame, jax_table, prediction_parts,
    save_jax_model, score_frame, train_jax_model,
)
from test_trees import (  # noqa: E402
    GRID_RF, GRID_TREE, GRID_GBT, GRID_XGB,
)
import transmogrifai_tpu_torch as port  # noqa: E402
from transmogrifai_tpu_torch.features import Feature  # noqa: E402
from transmogrifai_tpu_torch.table import Column, FeatureTable  # noqa: E402
from transmogrifai_tpu_torch.testing import serve_bench_data  # noqa: E402
from transmogrifai_tpu_torch.types import OPVector, RealNN  # noqa: E402

TOL = 1e-6
E2E_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=E2E_TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got.astype(np.float64),
                               np.asarray(want, dtype=np.float64), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# the selectors end to end
# ---------------------------------------------------------------------------

#: the tree families each new selector sweeps in one train
SELECTOR_MODELS = {
    "regression": [("OpDecisionTreeRegressor", GRID_TREE),
                   ("OpRandomForestRegressor", GRID_RF),
                   ("OpGBTRegressor", GRID_GBT),
                   ("OpXGBoostRegressor", GRID_XGB)],
    "multiclass": [("OpDecisionTreeClassifier", GRID_TREE),
                   ("OpRandomForestClassifier", GRID_RF),
                   ("OpXGBoostClassifier", GRID_XGB)],
}


def _selector_frame(kind):
    """``tests/test_model_selector.py``'s multiclass and regression
    frames (300 rows, 3 features)."""
    if kind == "multiclass":
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


def _fit_selectors(kind):
    from transmogrifai_tpu import FeatureBuilder as JFB
    from transmogrifai_tpu.impl.selector import factories as jfac
    from transmogrifai_tpu.table import Column as JColumn
    from transmogrifai_tpu.table import FeatureTable as JTable
    from transmogrifai_tpu.types import OPVector as JVec
    from transmogrifai_tpu.types import RealNN as JRealNN
    X, y = _selector_frame(kind)
    n = len(y)
    make = {"multiclass": "MultiClassificationModelSelector",
            "regression": "RegressionModelSelector"}[kind]
    models = SELECTOR_MODELS[kind]
    jsel = getattr(jfac, make).with_cross_validation(models=models)
    jsel.set_input(JFB.RealNN("label").extract_field().as_response(),
                   JFB.OPVector("features").extract_field().as_predictor())
    jt = JTable({"label": JColumn(JRealNN, y, None),
                 "features": JColumn(JVec, X, None)}, n)
    psel = getattr(port, make).with_cross_validation(models=models)
    psel.set_input(
        port.FeatureBuilder.RealNN("label").extract_field().as_response(),
        Feature("features", OPVector, False, None, ()))
    pt = FeatureTable({"label": Column(RealNN, _t(y), None),
                       "features": Column(OPVector, _t(X), None)}, n)
    return jsel.fit(jt), psel.fit(pt), jt, pt


@pytest.mark.parametrize("kind", ["regression", "multiclass"])
def test_selector_matches_jax(kind):
    jm, pm, jt, pt = _fit_selectors(kind)
    js, ps = jm.summary, pm.summary
    assert (ps.problem, ps.validation_metric, ps.larger_better) == (
        js.problem, js.validation_metric, js.larger_better)
    assert ps.best_model_type == js.best_model_type
    assert ps.best_hyper == js.best_hyper
    assert ps.splitter_summary == js.splitter_summary
    assert [r.family for r in ps.validation_results] == [
        r.family for r in js.validation_results]
    for pr, jr in zip(ps.validation_results, js.validation_results):
        _close(pr.fold_metrics, np.asarray(jr.fold_metrics))
    assert pm.label_mapping == jm.label_mapping
    assert pm.fitted.num_classes == jm.fitted.num_classes
    for ev in ("train_evaluation", "holdout_evaluation"):
        got, want = getattr(ps, ev), getattr(js, ev)
        assert sorted(got) == sorted(want), ev
        for k in want:
            _close(got[k], want[k])
    from transmogrifai_tpu.evaluators.base import (
        prediction_parts as jax_parts,
    )
    from transmogrifai_tpu_torch.evaluators.base import (
        prediction_parts as port_parts,
    )
    want = jax_parts(jm.transform_column(jt))
    got = port_parts(pm.transform_column(pt))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])


def test_unknown_problem_and_default_models_raise():
    from transmogrifai_tpu_torch.impl.selector.model_selector import (
        ModelSelector,
    )
    with pytest.raises(ValueError, match="unknown problem kind"):
        ModelSelector(problem="ranking", models=[])
    # without models= the selectors take the default lists (the linear
    # families, GLM and the trees); every family of the JAX registry is
    # ported, the MLP last, and a family name the registry lacks raises
    for make, first in ((port.MultiClassificationModelSelector,
                         "OpLogisticRegression"),
                        (port.RegressionModelSelector, "OpLinearRegression")):
        assert make.with_cross_validation().models[0][0].name == first
        with pytest.raises(KeyError, match="OpNoSuchFamily"):
            make.with_cross_validation(models=[("OpNoSuchFamily", None)])
    mlp = port.MultiClassificationModelSelector.with_cross_validation(
        models=[("OpMultilayerPerceptronClassifier", None)]).models
    assert [f.name for f, _ in mlp] == ["OpMultilayerPerceptronClassifier"]
    assert mlp[0][1] == mlp[0][0].default_grid("multiclass")[:len(mlp[0][1])]
    for fam in ("OpGBTClassifier", "OpMultilayerPerceptronClassifier"):
        with pytest.raises(ValueError, match="does not support"):
            port.RegressionModelSelector.with_cross_validation(
                models=[(fam, None)])


# ---------------------------------------------------------------------------
# workflows: trained by both packages, JAX-saved models served by the port
# ---------------------------------------------------------------------------

#: tiny serve-bench trains: (family, hyperparameters) per problem kind
TINY_TASK_MODELS = {
    "regression": ("OpGBTRegressor",
                   {"maxDepth": 3, "maxIter": 5, "stepSize": 0.3,
                    "minInstancesPerNode": 5, "minInfoGain": 0.001}),
    "multiclass": ("OpXGBoostClassifier",
                   {"maxDepth": 3, "maxIter": 5, "stepSize": 0.3,
                    "minChildWeight": 1.0, "lambda": 1.0,
                    "minInfoGain": 0.0, "minInstancesPerNode": 0.0}),
}
TINY_N, TINY_D, TINY_SEED = 400, 5, 3


@pytest.fixture(scope="module")
def tiny_task_models(tmp_path_factory):
    """{task: (JAX model, its saved dir, port model)} on the same rows."""
    from transmogrifai_tpu_torch.testing import serve_bench_workflow
    out = {}
    for task, (family, hyper) in TINY_TASK_MODELS.items():
        jm = train_jax_model(family, hyper, TINY_N, TINY_D, TINY_SEED,
                             task=task)
        path = str(tmp_path_factory.mktemp(f"tiny_{task}"))
        save_jax_model(jm, path)
        pm = serve_bench_workflow(
            family, hyper, TINY_D, TINY_SEED, device="cpu",
            problem=task).set_input_dataset(serve_bench_data(
                TINY_N, TINY_D, TINY_SEED, task)).train()
        out[task] = (jm, path, pm)
    return out


@pytest.mark.parametrize("task", ["regression", "multiclass"])
def test_tiny_task_workflow_trains_like_jax(tiny_task_models, task):
    jm, _, pm = tiny_task_models[task]
    js, ps = jm.stages[-1].summary, pm.stages[-1].summary
    assert ps.best_model_type == js.best_model_type
    assert pm.stages[-2].keep_indices == jm.stages[-2].keep_indices
    _close(ps.validation_results[0].fold_metrics,
           np.asarray(js.validation_results[0].fold_metrics))
    jp, pp = jm.stages[-1].fitted.params, pm.stages[-1].fitted.params
    for k in jp:
        if k != "leaf":
            np.testing.assert_array_equal(pp[k].numpy(), np.asarray(jp[k]),
                                          err_msg=k)
    np.testing.assert_allclose(pp["leaf"].numpy(), np.asarray(jp["leaf"]),
                               rtol=0, atol=TOL)
    frame = score_frame(300, TINY_D, seed=4, nan_rate=0.05)
    _assert_parts_agree(prediction_parts(pm.score(data=frame), pm),
                        prediction_parts(jm.score(table=jax_table(frame)),
                                         jm))


@pytest.mark.parametrize("task", ["regression", "multiclass"])
def test_tiny_saved_task_model_scores_match_jax(tiny_task_models, task):
    jm, path, _ = tiny_task_models[task]
    loaded = port.load_model(path, device="cpu")
    sel, jsel = loaded.stages[-1], jm.stages[-1]
    assert sel.fitted.num_classes == jsel.fitted.num_classes
    assert sel.label_mapping == jsel.label_mapping
    frame = score_frame(300, TINY_D, seed=4, nan_rate=0.05)
    want = prediction_parts(jm.score(table=jax_table(frame)), jm)
    got = prediction_parts(loaded.score(data=frame), loaded)
    assert list(got) == list(want)
    _assert_parts_agree(got, want)
    name = jm.result_features[0].name
    jfn, pfn = jm.score_function(), loaded.score_function()
    for i in range(3):
        row = {k: (None if np.isnan(v[i]) else float(v[i]))
               for k, v in frame.items()}
        w, g = jfn(row)[name], pfn(row)[name]
        assert sorted(g) == sorted(w)
        for k in w:
            if k != "prediction" or task == "regression":
                assert g[k] == pytest.approx(w[k], abs=E2E_TOL), k


def test_bench_frames_label_as_the_tasks_say():
    """The regression label is the binary frame's score (its sign is the
    binary label but where the two sums round across 0), the multiclass
    one spans six classes."""
    b = bench_frame(2000, 8, 0)
    r = bench_frame(2000, 8, 0, "regression")
    m = bench_frame(2000, 8, 0, "multiclass")
    assert ((r["y"] > 0) == (b["y"] > 0.5)).mean() > 0.999
    assert sorted(np.unique(m["y"]).tolist()) == [0, 1, 2, 3, 4, 5]
    np.testing.assert_array_equal(serve_bench_data(2000, 8, 0,
                                                   "multiclass")["y"],
                                  m["y"])
