"""The serve slice of the PyTorch port against the JAX package.

Models are trained and saved by the JAX package, loaded by the port on the
CPU, and scored by both; the port must agree with the JAX package's outputs.

The committed fixture under ``transmogrifai_tpu_torch/fixtures/serve64`` is
written by this file's ``__main__`` entry (the card has no JAX, so the JAX
package's outputs travel with the fixture as ``expected.npz``)::

    python tests/test_torch_serve.py            # regenerate every model
    python tests/test_torch_serve.py dt         # regenerate only ``dt``

Tolerances (stated once, used throughout):

* ``probability_1``: atol 1e-5 — the forest sums run in another order
  than the JAX package's one-hot matmul, so values differ by f32 rounding;
* ``prediction``: equal wherever |p - 0.5| > 1e-5 (a row that close to the
  threshold may flip under that rounding);
* a linear SVC's ``rawPrediction_1`` (its margin; it has no probability):
  within 1e-5 relative, the prediction equal wherever the margin is
  farther than that from 0.

The ``default_*`` fixtures sweep their problem kind's default model list at
full default grids (``TG_FAST_GRIDS=0``) and also keep ``summary.json``:
the JAX package's winner, its hyperparameters and metric, and every
family's (folds, configs) fold-metric matrix. Where a default list's
refit is a pinned key's model (``testing.SHARED_REFITS``: the binary
list's SVC is ``svc``, the multiclass list's softmax LR ``lrmc``), the
fixture keeps only ``summary.json`` and that key's saved model stands for
its refit. Saved manifests carry no drift baseline
(``drop_drift_baseline``).
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import jax  # noqa: F401
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import transmogrifai_tpu.models.glm  # noqa: E402,F401  (registers families)
import transmogrifai_tpu.models.linear  # noqa: E402,F401
import transmogrifai_tpu.models.mlp  # noqa: E402,F401
import transmogrifai_tpu.models.trees  # noqa: E402,F401
from transmogrifai_tpu.persistence import (  # noqa: E402
    load_model as jax_load_model,
)
import transmogrifai_tpu_torch as port  # noqa: E402
from transmogrifai_tpu_torch.local.scoring import (  # noqa: E402
    SCORE_ERROR_KEY,
)
from transmogrifai_tpu_torch.persistence import (  # noqa: E402
    CorruptModelError,
)
from transmogrifai_tpu_torch.testing import (  # noqa: E402
    CALIBRATED_KEY, SAVED_KEYS, SCORE_ROWS, SCORE_SEED,
    SERVE_MODELS as PORT_SERVE_MODELS, SHARED_REFITS, TRAIN_ROWS, TRAIN_SEED,
    calibration_labels, serve_bench_data,
)

FIXTURE_DIR = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures",
                           "serve64")

PROB_ATOL = 1e-5
PRED_MARGIN = 1e-5
#: a naive Bayes model's probabilities: its logits are 64-term sums of
#: log-probabilities (~ -5) times features, up to ~300 in magnitude, and
#: another summation order moves them by a few ulp there (measured on
#: ``nbmc``: 1.06e-5 on one row of 4,096)
NB_PROB_ATOL = 5e-5
#: a regression prediction: a sum of float32 leaf values in another order
REG_RTOL = 1e-5
#: the JAX package against its own saved outputs (same package, same
#: params; only its compiled programs may differ between processes)
JAX_SELF_ATOL = 1e-6

#: the serve-bench model shape (bench.py ``_serve_model``) at full width,
#: with the winner pinned to one family, or (family None) the default
#: model list: {key: (family, hyperparameters, problem kind)}
SERVE_MODELS = {
    "rf": ("OpRandomForestClassifier",
           {"maxDepth": 12, "numTrees": 50, "minInstancesPerNode": 10,
            "minInfoGain": 0.001, "subsamplingRate": 1.0},
           "binary"),
    "gbt": ("OpGBTClassifier",
            {"maxDepth": 6, "maxIter": 20, "stepSize": 0.1,
             "minInstancesPerNode": 10, "minInfoGain": 0.001},
            "binary"),
    "dt": ("OpDecisionTreeClassifier",
           {"maxDepth": 6, "minInstancesPerNode": 10, "minInfoGain": 0.001},
           "binary"),
    "gbt12": ("OpGBTClassifier",
              {"maxDepth": 12, "maxIter": 20, "stepSize": 0.1,
               "minInstancesPerNode": 10, "minInfoGain": 0.001},
              "binary"),
    "rfreg": ("OpRandomForestRegressor",
              {"maxDepth": 12, "numTrees": 50, "minInstancesPerNode": 10,
               "minInfoGain": 0.001, "subsamplingRate": 1.0},
              "regression"),
    "gbtreg": ("OpGBTRegressor",
               {"maxDepth": 6, "maxIter": 20, "stepSize": 0.1,
                "minInstancesPerNode": 10, "minInfoGain": 0.001},
               "regression"),
    "rfmc": ("OpRandomForestClassifier",
             {"maxDepth": 12, "numTrees": 50, "minInstancesPerNode": 10,
              "minInfoGain": 0.001, "subsamplingRate": 1.0},
             "multiclass"),
    "xgbmc": ("OpXGBoostClassifier",
              {"maxDepth": 6, "maxIter": 100, "stepSize": 0.3,
               "minChildWeight": 1.0, "lambda": 1.0, "minInfoGain": 0.0,
               "minInstancesPerNode": 0.0},
              "multiclass"),
    "lr": ("OpLogisticRegression",
           {"regParam": 0.01, "elasticNetParam": 0.5}, "binary"),
    "svc": ("OpLinearSVC", {"regParam": 0.01}, "binary"),
    "lrmc": ("OpLogisticRegression", {"regParam": 0.01}, "multiclass"),
    "nbmc": ("OpNaiveBayes", {"smoothing": 1.0}, "multiclass"),
    "linreg": ("OpLinearRegression",
               {"regParam": 0.01, "elasticNetParam": 0.5}, "regression"),
    "glm": ("OpGeneralizedLinearRegression",
            {"family": "gaussian", "regParam": 0.01}, "regression"),
    "default_binary": (None, None, "binary"),
    "default_mc": (None, None, "multiclass"),
    "default_reg": (None, None, "regression"),
    "mlp": ("OpMultilayerPerceptronClassifier",
            {"hiddenLayer1": 50, "hiddenLayer2": 50, "stepSize": 0.05},
            "binary"),
    "mlpmc": ("OpMultilayerPerceptronClassifier",
              {"hiddenLayer1": 50, "hiddenLayer2": 50, "stepSize": 0.05},
              "multiclass"),
}

#: pinned families whose fixture also keeps ``summary.json`` (their
#: trains on the card are held to its fold metrics)
SUMMARY_FAMILIES = ("OpMultilayerPerceptronClassifier",)

#: the fixtures trained on a default model list
DEFAULT_KEYS = [k for k, (family, _, _) in SERVE_MODELS.items()
                if family is None]


# ---------------------------------------------------------------------------
# JAX-side helpers: train, save, score
# ---------------------------------------------------------------------------

#: classes of the multiclass frame
N_CLASSES = 6


def bench_frame(n: int, d: int, seed: int, task: str = "binary"):
    """The serve bench's training frame, as the fixtures were trained on:
    ``d`` standard-normal float32 predictors and a label from random
    linear scores: their sign (binary), the score itself (regression) or
    the argmax of ``N_CLASSES`` of them, weights drawn after the binary
    ones (multiclass). Scores add the products in feature order in
    float64, rounded once to float32, so every machine gets the same
    label bits."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    w = rng.randn(d).astype(np.float32)
    frame = {f"x{i}": X[:, i] for i in range(d)}
    if task == "binary":
        frame["y"] = (X @ w > 0).astype(np.float32)
        return frame
    W = (w[:, None] if task == "regression"
         else rng.randn(d, N_CLASSES).astype(np.float32)).astype(np.float64)
    score = np.zeros((n, W.shape[1]), np.float64)
    for i in range(d):
        score += X[:, i, None].astype(np.float64) * W[i]
    score = score.astype(np.float32)
    frame["y"] = (score[:, 0] if task == "regression"
                  else score.argmax(1).astype(np.float32))
    return frame


def train_jax_model(family, hyper, n: int, d: int, seed: int,
                    realnn: int = 0, task: str = "binary"):
    """Train ``transmogrify -> sanity_check -> selector`` (the ``task``'s
    factory, cross-validated) with the JAX package on ``n`` rows of ``d``
    predictors (the first ``realnn`` of them RealNN, the rest Real),
    labelled as the serve bench labels them (``bench_frame``); the
    selector sweeps ``family`` at ``hyper`` or, with ``family`` None, the
    default model list."""
    import pandas as pd

    import transmogrifai_tpu as tg
    from transmogrifai_tpu.features import FeatureBuilder
    from transmogrifai_tpu.impl.selector import factories
    from transmogrifai_tpu.workflow import OpWorkflow

    selector = {"binary": factories.BinaryClassificationModelSelector,
                "multiclass": factories.MultiClassificationModelSelector,
                "regression": factories.RegressionModelSelector}[task]
    df = pd.DataFrame(bench_frame(n, d, seed, task))
    label = FeatureBuilder.RealNN("y").extract_field().as_response()
    feats = [(FeatureBuilder.RealNN if i < realnn else FeatureBuilder.Real)(
        f"x{i}").extract_field().as_predictor() for i in range(d)]
    checked = tg.transmogrify(feats).sanity_check(label)
    models = None if family is None else [(family, [dict(hyper)])]
    pred = (selector.with_cross_validation(seed=seed, models=models)
            .set_input(label, checked).get_output())
    return (OpWorkflow().set_input_dataset(df)
            .set_result_features(pred).train())


def score_frame(n: int, d: int, seed: int, nan_rate: float = 0.01):
    """A scoring frame: ``{name: float32 column}`` with NaN as missing."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    X[rng.rand(n, d) < nan_rate] = np.nan
    return {f"x{i}": X[:, i] for i in range(d)}


def jax_table(frame):
    from transmogrifai_tpu.table import Column, FeatureTable
    from transmogrifai_tpu.types import Real
    cols = {}
    for name, v in frame.items():
        m = ~np.isnan(v)
        cols[name] = Column(Real, np.where(m, v, 0.0).astype(np.float32), m)
    return FeatureTable(cols, len(next(iter(frame.values()))))


def prediction_parts(table, model):
    """{key: (n,) float32} of the model's one Prediction column, from either
    package's scored table (tensors are brought to the host)."""
    name = model.result_features[0].name
    col = table[name]
    vals = col.values
    if isinstance(vals, torch.Tensor):
        vals = vals.cpu().numpy()
    vals = np.asarray(vals)
    return {k: vals[:, i] for i, k in enumerate(col.metadata["keys"])}


def save_jax_model(model, path: str) -> None:
    from transmogrifai_tpu.persistence import save_model
    prev = os.environ.get("TG_AOT_SAVE")
    os.environ["TG_AOT_SAVE"] = "0"     # no jax.export blobs in the dir
    try:
        save_model(model, path)
    finally:
        if prev is None:
            os.environ.pop("TG_AOT_SAVE", None)
        else:
            os.environ["TG_AOT_SAVE"] = prev


def expected_parts(parts, task: str):
    """The prediction parts a fixture's ``expected.npz`` keeps: the
    prediction, and each class probability but the binary one's class 0
    (the rawPredictions are their logs); a model without probabilities
    (the linear SVC) keeps its margin ``rawPrediction_1``."""
    keep = [k for k in parts if k == "prediction" or (
        k.startswith("probability_") and (task != "binary"
                                          or k == "probability_1"))]
    if task == "binary" and "probability_1" not in parts:
        keep.append("rawPrediction_1")
    return {k: parts[k] for k in keep}


def selection_summary(model):
    """The JAX package's selection, as a default-list fixture keeps it:
    winner, hyperparameters, metric, and each family's grid and (folds,
    configs) fold metrics (float32 values, exact in JSON)."""
    s = model.stages[-1].summary
    return {"winner": s.best_model_type, "hyper": dict(s.best_hyper),
            "metric": s.validation_metric,
            "value": float(s.best_metric_value),
            "families": [{"family": r.family, "grid": list(r.grid),
                          "fold_metrics": np.asarray(
                              r.fold_metrics, np.float32).tolist()}
                         for r in s.validation_results]}


def drop_drift_baseline(path: str) -> None:
    """Remove the drift baseline from a saved model's manifest: per-feature
    sketches (~120 KB at 64 features) that only the JAX package's serving
    registry reads. The JAX package saves no baseline for a model without
    a train table, so both loaders accept a manifest without one; the
    checksums cover plan.json and arrays.npz, not the manifest."""
    manifest = os.path.join(path, "MANIFEST.json")
    with open(manifest) as fh:
        entries = json.load(fh)
    if entries.pop("drift", None) is not None:
        with open(manifest, "w") as fh:
            fh.write(json.dumps(entries, indent=1))


def same_refit(model, path: str, parts, task: str) -> bool:
    """Whether the JAX-trained ``model`` is the saved model at ``path``:
    the same family and fitted params, kept columns, holdout metrics and
    prediction parts on the scoring frame."""
    saved = jax_load_model(path)
    a, b = model.stages[-1], saved.stages[-1]
    exp = np.load(os.path.join(path, "expected.npz"))
    got = expected_parts(parts, task)
    return (a.fitted.family == b.fitted.family
            and sorted(a.fitted.params) == sorted(b.fitted.params)
            and all(np.array_equal(np.asarray(a.fitted.params[k]),
                                   np.asarray(b.fitted.params[k]))
                    for k in a.fitted.params)
            and model.stages[-2].keep_indices == saved.stages[-2].keep_indices
            and json.dumps(a.summary.holdout_evaluation, sort_keys=True)
            == json.dumps(b.summary.holdout_evaluation, sort_keys=True)
            and sorted(got) == sorted(exp.files)
            and all(np.array_equal(got[k], exp[k]) for k in got))


def generate_fixture(out_dir: str = FIXTURE_DIR, n: int = TRAIN_ROWS,
                     d: int = 64, seed: int = TRAIN_SEED, keys=None) -> None:
    """Train the serve models named by ``keys`` (default: all) at full
    width, save them without the drift baseline, and write
    ``expected.npz``: the JAX package's prediction parts on the scoring
    frame ``fixture_frame()``, which the port rebuilds from its seed. A
    default list also writes ``summary.json``; one whose refit is a
    pinned key's model (``testing.SHARED_REFITS``, checked here) keeps
    nothing else."""
    frame = fixture_frame()
    os.environ["TG_FAST_GRIDS"] = "0"          # full default grids
    for key in keys or SERVE_MODELS:
        family, hyper, task = SERVE_MODELS[key]
        model = train_jax_model(family, hyper, n, d, seed, task=task)
        path = os.path.join(out_dir, key)
        parts = prediction_parts(model.score(table=jax_table(frame)), model)
        shutil.rmtree(path, ignore_errors=True)
        if key in SHARED_REFITS:
            shared = os.path.join(out_dir, SHARED_REFITS[key])
            if not same_refit(model, shared, parts, task):
                raise AssertionError(f"{key}: the refit is not {shared}'s "
                                     f"saved model")
            os.makedirs(path)
        else:
            save_jax_model(model, path)
            drop_drift_baseline(path)
            np.savez_compressed(os.path.join(path, "expected.npz"),
                                **expected_parts(parts, task))
        if family is None or family in SUMMARY_FAMILIES:
            with open(os.path.join(path, "summary.json"), "w") as fh:
                json.dump(selection_summary(model), fh, indent=1)
        if key == CALIBRATED_KEY:
            write_calibration(path, parts["probability_1"])


def write_calibration(path: str, scores) -> None:
    """``calibration.npz``: the JAX package's isotonic fit to ``scores``
    (the saved model's probability_1 on the scoring frame) against
    ``testing.calibration_labels``, its boundaries and values (``pav_fit``)
    and the calibrated column, so the card can hold the port's fit and
    interpolation to them bit for bit."""
    import jax.numpy as jnp

    from transmogrifai_tpu.impl.regression.isotonic import (
        IsotonicCalibratorModel, pav_fit,
    )
    scores = np.asarray(scores, np.float32)
    b, v = pav_fit(scores, calibration_labels(scores))
    calibrated = np.asarray(IsotonicCalibratorModel(b, v)._interp(
        jnp.asarray(scores)))
    np.savez_compressed(os.path.join(path, "calibration.npz"),
                        boundaries=b, values=v, calibrated=calibrated)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

#: tiny models: an RF deep enough to grow slot chains, a shallow heap GBT
#: whose first two predictors are RealNN (so its vector is RealVectorizer
#: and RealNNVectorizer output joined by VectorsCombiner)
TINY_MODELS = {
    "rf": ("OpRandomForestClassifier",
           {"maxDepth": 12, "numTrees": 4, "minInstancesPerNode": 5,
            "minInfoGain": 0.001, "subsamplingRate": 1.0}),
    "gbt": ("OpGBTClassifier",
            {"maxDepth": 3, "maxIter": 5, "stepSize": 0.1,
             "minInstancesPerNode": 5, "minInfoGain": 0.001}),
}
TINY_D = 5
TINY_REALNN = {"rf": 0, "gbt": 2}
TINY_STAGES = {
    "rf": ["RealVectorizerModel", "SanityCheckerModel", "SelectedModel"],
    "gbt": ["RealNNVectorizer", "RealVectorizerModel", "VectorsCombiner",
            "SanityCheckerModel", "SelectedModel"],
}


@pytest.fixture(scope="module")
def tiny_models(tmp_path_factory):
    """{key: (JAX model, saved dir)} trained on 400 rows."""
    out = {}
    for key, (family, hyper) in TINY_MODELS.items():
        model = train_jax_model(family, hyper, n=400, d=TINY_D, seed=3,
                                realnn=TINY_REALNN[key])
        path = str(tmp_path_factory.mktemp(f"tiny_{key}"))
        save_jax_model(model, path)
        out[key] = (model, path)
    return out


def decided_rows(want):
    """Rows whose predicted class no rounding can flip: the two highest
    probabilities more than PRED_MARGIN apart (binary: probability_1 that
    far from 0.5)."""
    probs = [want[k] for k in sorted(want) if k.startswith("probability_")]
    if len(probs) == 1:
        return np.abs(probs[0] - 0.5) > PRED_MARGIN
    top2 = np.sort(np.stack(probs, axis=1), axis=1)[:, -2:]
    return top2[:, 1] - top2[:, 0] > PRED_MARGIN


def _assert_parts_agree(got, want, prob_atol=PROB_ATOL):
    """Probabilities within ``prob_atol``; predicted classes equal on the
    decided rows; a regression's prediction and an SVC's margin within
    REG_RTOL (the SVC's prediction equal where the margin is farther from
    0)."""
    assert list(got) == list(want)
    if "rawPrediction_1" in want:
        m = want["rawPrediction_1"]
        np.testing.assert_allclose(got["rawPrediction_1"], m, rtol=REG_RTOL,
                                   atol=REG_RTOL)
        far = np.abs(m) > REG_RTOL * (1 + np.abs(m))
        np.testing.assert_array_equal(got["prediction"][far],
                                      want["prediction"][far])
        return
    if not any(k.startswith("probability_") for k in want):
        np.testing.assert_allclose(got["prediction"], want["prediction"],
                                   rtol=REG_RTOL, atol=REG_RTOL)
        return
    for key in want:
        if key != "prediction":
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=prob_atol, err_msg=key)
    far = decided_rows(want)
    np.testing.assert_array_equal(got["prediction"][far],
                                  want["prediction"][far])


def _rows(frame, n):
    return [{k: (None if np.isnan(v[i]) else float(v[i]))
             for k, v in frame.items()} for i in range(n)]


@pytest.mark.parametrize("key", ["rf", "gbt"])
def test_tiny_model_scores_match_jax(tiny_models, key):
    model, path = tiny_models[key]
    frame = score_frame(300, TINY_D, seed=4, nan_rate=0.05)
    want = prediction_parts(model.score(table=jax_table(frame)), model)
    loaded = port.load_model(path, device="cpu")
    assert loaded.device == torch.device("cpu")
    assert sorted(type(s).__name__ for s in loaded.stages) == sorted(
        TINY_STAGES[key])
    scored = loaded.score(data=frame)
    assert scored[loaded.result_features[0].name].values.device.type == "cpu"
    _assert_parts_agree(prediction_parts(scored, loaded), want)


@pytest.mark.parametrize("key", ["rf", "gbt"])
def test_tiny_score_function_matches_jax(tiny_models, key):
    model, path = tiny_models[key]
    loaded = port.load_model(path, device="cpu")
    name = model.result_features[0].name
    jax_fn, port_fn = model.score_function(), loaded.score_function()
    rows = _rows(score_frame(6, TINY_D, seed=5, nan_rate=0.2), 6)
    for row in rows:
        want, got = jax_fn(row)[name], port_fn(row)[name]
        assert sorted(got) == sorted(want)
        for k in want:
            if k == "prediction" and abs(want["probability_1"] - 0.5) \
                    <= PRED_MARGIN:
                continue
            assert got[k] == pytest.approx(want[k], abs=PROB_ATOL), k
    batch = port.micro_batch_score_function(loaded)(rows)
    assert batch == [port_fn(row) for row in rows]


def test_micro_batch_quarantines_only_bad_rows(tiny_models):
    _, path = tiny_models["gbt"]
    loaded = port.load_model(path, device="cpu")
    rows = _rows(score_frame(3, TINY_D, seed=6), 3)
    rows[1]["x2"] = "not a number"
    out = port.micro_batch_score_function(loaded)(rows)
    assert SCORE_ERROR_KEY in out[1] and "x2" in out[1][SCORE_ERROR_KEY]
    assert all(v is None for k, v in out[1].items() if k != SCORE_ERROR_KEY)
    fn = loaded.score_function()
    assert [out[0], out[2]] == [fn(rows[0]), fn(rows[2])]


#: the fitted tables of each committed fixture: {key: {param: shape}}
FIXTURE_SHAPES = {
    "rf": {"feat_lv": (50, 12, 256)},        # depth-12 refit: slot chains
    "gbt": {"feat": (20, 1, 63)},            # depth-6 complete heaps
    "gbt12": {"feat_lv": (20, 1, 12, 256), "leaf": (20, 1, 256)},
    "dt": {"feat": (63,)},                   # one depth-6 heap
    "rfreg": {"feat_lv": (50, 12, 256), "leaf": (50, 256, 1)},
    "gbtreg": {"feat": (20, 1, 63), "f0": (1,)},
    "rfmc": {"feat_lv": (50, 12, 256), "leaf": (50, 256, N_CLASSES)},
    "xgbmc": {"feat": (100, N_CLASSES, 63),
              "leaf": (100, N_CLASSES, 64)},
    "lr": {"coef": (64,), "bias": ()},
    "svc": {"coef": (64,), "bias": ()},
    "lrmc": {"W": (64, N_CLASSES), "b": (N_CLASSES,)},
    "nbmc": {"log_prob": (N_CLASSES, 64), "log_prior": (N_CLASSES,)},
    "linreg": {"coef": (64,), "bias": ()},
    "glm": {"coef": (64,), "bias": (), "family": ()},
    "default_reg": {"coef": (64,), "bias": ()},
    "mlp": {"params": [(64, 50), (50,), (50, 50), (50,), (50, 2), (2,)],
            "masks": [(50,), (50,)]},
    "mlpmc": {"params": [(64, 50), (50,), (50, 50), (50,), (50, 6), (6,)],
              "masks": [(50,), (50,)]},
}

#: the winners the JAX package chose from the default lists on the serve
#: bench's frames (the fixtures' summary.json)
DEFAULT_WINNERS = {
    "default_binary": ("OpLinearSVC", {"regParam": 0.01}),
    "default_mc": ("OpLogisticRegression",
                   {"regParam": 0.01, "elasticNetParam": 0.0}),
    "default_reg": ("OpLinearRegression",
                    {"regParam": 0.001, "elasticNetParam": 0.5}),
}


def fixture_frame():
    """The scoring frame of the committed fixtures: the port's
    ``testing.score_frame()`` rows and seed, through this file's
    recipe."""
    return score_frame(SCORE_ROWS, 64, SCORE_SEED)


@pytest.mark.parametrize("key", SAVED_KEYS)
def test_committed_fixture_matches_expected_in_both_packages(key):
    path = os.path.join(FIXTURE_DIR, key)
    exp = np.load(os.path.join(path, "expected.npz"))
    assert "X" not in exp.files        # the frame is rebuilt from its seed
    want = {k: exp[k] for k in exp.files}
    frame = fixture_frame()
    jm = jax_load_model(path)
    jp = prediction_parts(jm.score(table=jax_table(frame)), jm)
    for k in want:
        np.testing.assert_allclose(jp[k], want[k], rtol=0,
                                   atol=JAX_SELF_ATOL, err_msg=k)
    pm = port.load_model(path, device="cpu")
    assert [type(s).__name__ for s in pm.stages] == [
        "RealVectorizerModel", "SanityCheckerModel", "SelectedModel"]
    params = pm.stages[-1].fitted.params
    for name, shape in FIXTURE_SHAPES[key].items():
        got = params[name]
        assert (tuple(got.shape) if isinstance(got, torch.Tensor)
                else [tuple(t.shape) for t in got]) == shape, name
    pp = prediction_parts(pm.score(data=frame), pm)
    _assert_parts_agree({k: pp[k] for k in want}, want, prob_atol=(
        NB_PROB_ATOL if params.keys() >= {"log_prob"} else PROB_ATOL))


@pytest.mark.parametrize("key", DEFAULT_KEYS)
def test_default_fixture_keeps_the_jax_selection(key, monkeypatch):
    """A default-list fixture's summary.json is the selection summary of
    the saved model that stands for its refit (its own, or the pinned
    key's whose refit it is), with every default family's full grid."""
    from transmogrifai_tpu.impl.selector.model_selector import (
        ModelSelector,
    )
    path = os.path.join(FIXTURE_DIR, key)
    with open(os.path.join(path, "summary.json")) as fh:
        kept = json.load(fh)
    jm = jax_load_model(os.path.join(FIXTURE_DIR,
                                     SHARED_REFITS.get(key, key)))
    if key in SHARED_REFITS:
        assert sorted(os.listdir(path)) == ["summary.json"]
        fitted = jm.stages[-1].fitted
        assert kept["winner"] == fitted.family
        family, hyper, _ = SERVE_MODELS[SHARED_REFITS[key]]
        assert family == fitted.family and hyper == fitted.hyper
    else:
        assert kept == json.loads(json.dumps(selection_summary(jm)))
    assert (kept["winner"], kept["hyper"]) == DEFAULT_WINNERS[key]
    monkeypatch.setenv("TG_FAST_GRIDS", "0")
    defaults = ModelSelector(SERVE_MODELS[key][2]).models
    assert [f["family"] for f in kept["families"]] == [
        fam.name for fam, _ in defaults]
    for f, (_, grid) in zip(kept["families"], defaults):
        assert f["grid"] == list(grid)
        assert np.asarray(f["fold_metrics"]).shape == (3, len(grid))


def test_port_rebuilds_the_fixture_scoring_frame_bit_for_bit():
    """The card has no JAX, so the port rebuilds the fixtures' scoring
    frame from its seed (``testing.score_frame``); it must be this file's
    frame to the bit, NaNs in the same places."""
    from transmogrifai_tpu_torch.testing import score_frame as port_frame
    for got, want in ((port_frame(), fixture_frame()),
                      (port_frame(300, 5, 4, 0.05),
                       score_frame(300, 5, 4, 0.05))):
        assert list(got) == list(want)
        for name in want:
            assert got[name].dtype == want[name].dtype
            np.testing.assert_array_equal(got[name].view(np.int32),
                                          want[name].view(np.int32))


def test_cpu_replay_of_the_xgbmc_tied_split_takes_the_fixture_bin():
    """At round 26, class 1, heap node 14 of the xgbmc fixture, feature
    57's bins 20 and 21 split the node's rows alike (no row there has code
    21), so only the rounding of the node's sibling-subtracted histogram
    decides between them. Replayed from the fixture's state, the port's
    grower on the CPU takes the fixture's bin."""
    from transmogrifai_tpu_torch.experiments.tie_replay import (
        XGBMC_TIE, replay,
    )
    assert XGBMC_TIE == ("xgbmc", 26, 1, 14, 57, (20, 21))
    model = port.load_model(os.path.join(FIXTURE_DIR, "xgbmc"), device="cpu")
    data = serve_bench_data(TRAIN_ROWS, 64, TRAIN_SEED, "multiclass")
    r = replay(model, data, model.stages[-1].fitted.params, *XGBMC_TIE)
    assert r["leaves_before"]["differ"] == 0
    assert r["bins"][21]["rows"] == 0 < r["bins"][20]["rows"]
    assert r["bins"][21]["cells"]["direct_f64"] == [0.0, 0.0, 0.0]
    assert r["replayed"] == r["fixture"] == [57, 20]


def test_fixture_stays_small():
    """17 saved models, each ~0.2-0.55 MB: the JAX package's plan (146 KB)
    and manifest (58 KB without the drift baseline) dominate."""
    total = sum(os.path.getsize(os.path.join(root, f))
                for root, _, files in os.walk(FIXTURE_DIR) for f in files)
    assert total < 6 * 2 ** 20, total


@pytest.mark.parametrize("task", ["binary", "regression", "multiclass"])
@pytest.mark.parametrize("n,d,seed", [(20_000, 64, 0), (400, 5, 3)])
def test_port_rebuilds_the_fixture_training_frame_bit_for_bit(n, d, seed,
                                                              task):
    """The card has no JAX, so the port rebuilds the frame the fixtures
    were trained on; it must be this file's frame to the bit."""
    got = serve_bench_data(n, d, seed, task)
    want = bench_frame(n, d, seed, task)
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name])


def test_port_pins_the_fixture_models():
    """``chip_smoke.py`` and ``profile_train`` train the port's table of
    the serve models and hold the results to these fixtures."""
    assert PORT_SERVE_MODELS == SERVE_MODELS


def _run(code: str, **env):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, **env), capture_output=True,
                          text=True, timeout=300)


def test_port_imports_neither_jax_nor_the_jax_package():
    res = _run(
        "import importlib, pkgutil, sys\n"
        "import transmogrifai_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib',\n"
        "                                    'transmogrifai_tpu',\n"
        "                                    'pandas', 'pyarrow'))\n"
        "print(bad)\n"
        "print(' '.join(sorted(m for m in sys.modules\n"
        "                      if m.startswith(p.__name__))))\n"
        "sys.exit(1 if bad else 0)\n")
    assert res.returncode == 0, res.stdout + res.stderr
    walked = set(res.stdout.split())
    for mod in ("histeng.kernels", "histeng.engine", "utils.padding",
                "ops.metrics", "ops.stats", "evaluators.binary",
                "impl.tuning.splitters", "impl.tuning.validators",
                "impl.selector.factories", "impl.feature.transmogrifier",
                "dsl", "workflow", "testing", "rng", "models.bootstrap",
                "evaluators.multi", "evaluators.regression",
                "evaluators.factory", "models.trees", "persistence",
                "impl.selector.model_selector", "local.scoring",
                "ops.xla_cpu", "experiments.tie_replay", "models.linear",
                "models.glm", "models.mlp", "impl.regression.isotonic",
                "manifest", "utils.version", "readers.readers",
                "filters.raw_feature_filter", "filters.distribution",
                "utils.streaming_histogram",
                "impl.selector.random_param_builder",
                "insights.model_insights", "impl.feature.dates",
                "impl.feature.geo", "impl.feature.maps",
                "impl.feature.text",
                "impl.preparators.prediction_deindexer",
                "serving", "serving.runtime", "serving.registry",
                "serving.breaker", "serving.drift", "serving.warmup",
                "serving.loadgen", "observability",
                "observability.metrics", "observability.trace",
                "observability.blackbox", "observability.timeseries",
                "observability.slo", "observability.postmortem",
                "observability.ledger", "observability.devicemem",
                "observability.export", "serving.fleet",
                "serving.frontdoor", "serving.placement", "serving.netproto",
                "serving.netedge", "serving.replica_worker",
                "robustness.oracles", "robustness.guards",
                "robustness.campaign", "impl.tuning.sweep_checkpoint",
                "parallel.distributed", "utils.profiler", "cli",
                "utils.parquet", "runner"):
        assert f"transmogrifai_tpu_torch.{mod}" in walked, mod


def test_load_without_device_needs_cuda():
    res = _run("import transmogrifai_tpu_torch as p\n"
               f"p.load_model({os.path.join(FIXTURE_DIR, 'gbt')!r})\n",
               CUDA_VISIBLE_DEVICES="")
    assert res.returncode != 0
    assert "no CUDA device is available" in res.stderr, res.stderr


def test_corrupt_or_unknown_saved_state_raises(tmp_path):
    src = os.path.join(FIXTURE_DIR, "gbt")
    bad = shutil.copytree(src, str(tmp_path / "bitflip"))
    npz = os.path.join(bad, "arrays.npz")
    blob = bytearray(open(npz, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(npz, "wb").write(bytes(blob))
    with pytest.raises(CorruptModelError, match="sha256 mismatch"):
        port.load_model(bad, device="cpu")
    odd = shutil.copytree(src, str(tmp_path / "unknown"))
    os.remove(os.path.join(odd, "MANIFEST.json"))   # loads unverified
    plan_path = os.path.join(odd, "plan.json")
    plan = open(plan_path).read().replace('"RealVectorizerModel"',
                                          '"OpScalarStandardScaler"')
    open(plan_path, "w").write(plan)
    with pytest.raises(ValueError, match="OpScalarStandardScaler.*no "
                                         "counterpart"):
        port.load_model(odd, device="cpu")


if __name__ == "__main__":
    generate_fixture(keys=sys.argv[1:] or None)
