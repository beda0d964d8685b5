"""Tiny end-to-end trains of the tree slices: ``transmogrify ->
sanity_check -> BinaryClassificationModelSelector`` with a two-point RF
(depth 12, slot chains), DT (depth 6, heaps) or GBT (depths 12 and 3:
one slot-chain boosting scan) grid, trained by the JAX package and by the
port on the CPU, on the same 400 rows of 5 predictors.

Tolerances: edges, kept columns, split tables (feat, bins, base) and the
winner: equal; thresholds equal and leaf values within 1e-6 (see
``test_torch_forest_train.py``); probability_1 within 1e-6; DT fold
metrics and evaluations within 1e-6, RF ones within 1e-4. An RF score is
the mean of its trees' leaf shares: the JAX package adds the trees inside
a one-hot matmul in its own blocked order, the port one tree after the
other, so scores differ in the last bit, and two rows that close swap
places in a ~130-row fold; one swap moves AuPR by ~1e-4. GBT metrics and
probability_1 within 1e-5: the sigmoid's ``exp`` differs between the two
CPU backends in the last bit (as in ``test_torch_train.py``).
"""
from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

from test_torch_forest_train import _assert_params_match  # noqa: E402
from test_torch_serve import (  # noqa: E402
    bench_frame, jax_table, prediction_parts, score_frame,
)
from transmogrifai_tpu_torch.testing import serve_bench_data  # noqa: E402

E2E_TOL = 1e-6
RF_METRIC_TOL = 1e-4
GBT_TOL = 1e-5


TINY = {
    "OpRandomForestClassifier": [
        {"maxDepth": 12, "numTrees": 4, "minInstancesPerNode": 5,
         "minInfoGain": 0.001, "subsamplingRate": 1.0},
        {"maxDepth": 12, "numTrees": 4, "minInstancesPerNode": 20,
         "minInfoGain": 0.001, "subsamplingRate": 0.8}],
    "OpDecisionTreeClassifier": [
        {"maxDepth": 6, "minInstancesPerNode": 5, "minInfoGain": 0.001},
        {"maxDepth": 6, "minInstancesPerNode": 30, "minInfoGain": 0.01}],
    "OpGBTClassifier": [
        {"maxDepth": 12, "maxIter": 4, "stepSize": 0.3,
         "minInstancesPerNode": 5, "minInfoGain": 0.001},
        {"maxDepth": 3, "maxIter": 4, "stepSize": 0.3,
         "minInstancesPerNode": 5, "minInfoGain": 0.001}],
}
#: metric and probability tolerance per family (see above)
TOL = {"OpRandomForestClassifier": RF_METRIC_TOL,
       "OpDecisionTreeClassifier": E2E_TOL, "OpGBTClassifier": GBT_TOL}
TINY_N, TINY_D, TINY_SEED = 400, 5, 3


def _jax_train(family, grid):
    import pandas as pd

    import transmogrifai_tpu as tg
    from transmogrifai_tpu.features import FeatureBuilder
    from transmogrifai_tpu.impl.selector.factories import (
        BinaryClassificationModelSelector)
    from transmogrifai_tpu.workflow import OpWorkflow
    df = pd.DataFrame(bench_frame(TINY_N, TINY_D, TINY_SEED))
    label = FeatureBuilder.RealNN("y").extract_field().as_response()
    feats = [FeatureBuilder.Real(f"x{i}").extract_field().as_predictor()
             for i in range(TINY_D)]
    pred = (BinaryClassificationModelSelector.with_cross_validation(
        seed=TINY_SEED, models=[(family, grid)])
        .set_input(label, tg.transmogrify(feats).sanity_check(label))
        .get_output())
    return OpWorkflow().set_input_dataset(df).set_result_features(
        pred).train()


def _port_train(family, grid):
    import transmogrifai_tpu_torch as port
    label = port.FeatureBuilder.RealNN("y").extract_field().as_response()
    feats = [port.FeatureBuilder.Real(f"x{i}").extract_field()
             .as_predictor() for i in range(TINY_D)]
    pred = (port.BinaryClassificationModelSelector.with_cross_validation(
        seed=TINY_SEED, models=[(family, grid)])
        .set_input(label, port.transmogrify(feats).sanity_check(label))
        .get_output())
    return port.OpWorkflow(device="cpu").set_input_dataset(
        serve_bench_data(TINY_N, TINY_D, TINY_SEED)).set_result_features(
        pred).train()


@pytest.fixture(scope="module")
def tiny_trains():
    jax.clear_caches()             # no program traced for its Pallas path
    return {fam: (_jax_train(fam, grid), _port_train(fam, grid))
            for fam, grid in TINY.items()}


@pytest.mark.parametrize("family", sorted(TINY))
def test_tiny_train_matches_jax(tiny_trains, family):
    jm, pm = tiny_trains[family]
    js, ps = jm.stages[-1].summary, pm.stages[-1].summary
    assert ps.best_model_type == js.best_model_type == family
    assert ps.best_hyper == js.best_hyper
    assert pm.stages[-2].keep_indices == jm.stages[-2].keep_indices
    tol = TOL[family]
    np.testing.assert_allclose(ps.validation_results[0].fold_metrics,
                               js.validation_results[0].fold_metrics,
                               rtol=0, atol=tol)
    for ev in ("train_evaluation", "holdout_evaluation"):
        got, want = getattr(ps, ev), getattr(js, ev)
        assert sorted(got) == sorted(want)
        np.testing.assert_allclose([got[k] for k in sorted(want)],
                                   [want[k] for k in sorted(want)], rtol=0,
                                   atol=tol, equal_nan=True, err_msg=ev)
    _assert_params_match(
        pm.stages[-1].fitted.params,
        {k: v for k, v in jm.stages[-1].fitted.params.items()})
    frame = score_frame(300, TINY_D, seed=4, nan_rate=0.05)
    want = prediction_parts(jm.score(table=jax_table(frame)), jm)
    got = prediction_parts(pm.score(data=frame), pm)
    np.testing.assert_allclose(got["probability_1"], want["probability_1"],
                               rtol=0, atol=GBT_TOL
                               if family == "OpGBTClassifier" else E2E_TOL)
