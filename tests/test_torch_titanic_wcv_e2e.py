"""The Titanic workflow with the raw feature filter (reading a scoring
file) and workflow-level cross-validation, in the PyTorch port against the
JAX package on the CPU.

The small trains run both packages on ``test_torch_titanic_e2e``'s
240-row frame, scored against a 200-row frame whose ``Cabin`` is blank
(so the filter excludes it and the DAG loses an input), with the selector
pinned to one tree and one linear family: the filter's results, each
fold's SanityChecker, the selection, the scores, a save and its reload,
and ``model_insights().to_json()``. The committed fixture
``transmogrifai_tpu_torch/fixtures/titanic_wcv`` holds what the JAX package
made of ``testing.titanic_csv(TITANIC_ROWS, TITANIC_SEED)`` with the
filter reading ``titanic_csv(TITANIC_SCORE_ROWS, TITANIC_SCORE_SEED)`` and
the default binary model list at full default grids (the card has no JAX,
so ``chip_smoke.py`` trains the port on the same files and holds it to
this); here the port's filter and fold SanityCheckers run on those files
on the CPU, and the saved model scores. This file's ``__main__`` writes
the fixture (JAX package, CPU)::

    python tests/test_torch_titanic_wcv_e2e.py

Tolerances, stated once:

* the filter's exclusions, counts, rates and reasons, the blacklist, each
  fold's SanityChecker choices, the winner and its hyperparameters: equal;
  JS divergences 1e-9 relative and null-label correlations 1e-6 absolute
  (``test_torch_raw_feature_filter.py``);
* fold metrics: trees 1e-5, the linear sweeps 5e-5; ``probability_1``
  1e-5 on the small trains (``test_torch_titanic_e2e.py``) and 1e-6 for
  the committed model's scores;
* the Brier score: |a - b| <= (2 + d) * d for scores within d of each
  other (labels in {0, 1}: each squared error moves by at most that);
* the model insights: ``testing.insight_limits`` (equal keys and strings,
  each number within the limit of its source).
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile

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
import transmogrifai_tpu.models.trees  # noqa: E402,F401
from transmogrifai_tpu.examples import titanic as jax_titanic  # noqa: E402
from transmogrifai_tpu.features import reset_uids as jax_reset  # noqa: E402
import transmogrifai_tpu_torch as port  # noqa: E402
from transmogrifai_tpu_torch.features import (  # noqa: E402
    reset_uids as port_reset,
)
from transmogrifai_tpu_torch.testing import (  # noqa: E402
    TITANIC_ROWS, TITANIC_SCORE_ROWS, TITANIC_SCORE_SEED, TITANIC_SEED,
    WCV_LIN_FOLD_ATOL, assert_same_sanity, insight_limits, insights_by_feature, json_gaps,
    sanity_summary, selection_gaps, selection_summary, titanic_csv,
    titanic_wcv_workflow,
)

TITANIC_SCHEMA = jax_titanic.TITANIC_SCHEMA
FIXTURE_DIR = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures",
                           "titanic_wcv")


def jax_fold_sanity_recorder():
    """Patch the JAX package's queued-fit resolver so that the
    SanityChecker models fitted inside ``find_best_estimator`` (one per
    fold) are kept; returns (the list they land in, an undo)."""
    import transmogrifai_tpu.stages.base as jbase
    from transmogrifai_tpu.impl.selector.model_selector import ModelSelector

    folds, inside = [], [False]
    orig_mp, orig_find = jbase.materialize_pending, \
        ModelSelector.find_best_estimator

    def materialize(pend):
        out = orig_mp(pend)
        if inside[0]:
            folds.extend(m for m in out
                         if type(m).__name__ == "SanityCheckerModel")
        return out

    def find(self, *a, **kw):
        inside[0] = True
        try:
            return orig_find(self, *a, **kw)
        finally:
            inside[0] = False

    jbase.materialize_pending = materialize
    ModelSelector.find_best_estimator = find

    def undo():
        jbase.materialize_pending = orig_mp
        ModelSelector.find_best_estimator = orig_find
    return folds, undo


def jax_wcv_workflow(train_csv: str, score_csv: str):
    """The JAX package's Titanic workflow on ``train_csv`` with a
    ``RawFeatureFilter`` (default thresholds) reading ``score_csv`` and
    workflow-level CV: (workflow, label, prediction)."""
    from transmogrifai_tpu.filters import RawFeatureFilter
    from transmogrifai_tpu.readers import DataReaders

    wf, survived, pred = jax_titanic.build_workflow(train_csv, seed=42)
    score_reader = DataReaders.Simple.csv(
        score_csv, schema=jax_titanic.TITANIC_SCHEMA, header=False,
        key_field="PassengerId")
    wf = (wf.with_raw_feature_filter(RawFeatureFilter(
        score_reader=score_reader)).with_workflow_cv())
    return wf, survived, pred


def generate_fixture(out_dir: str = FIXTURE_DIR) -> None:
    """Train the JAX package's Titanic workflow with the raw feature filter
    and workflow-level CV (the default binary model list at full default
    grids) on ``titanic_csv(TITANIC_ROWS, TITANIC_SEED)``, with
    ``titanic_csv(TITANIC_SCORE_ROWS, TITANIC_SCORE_SEED)`` as the filter's
    scoring file, score that file, and write ``fixture.json`` (both files'
    sha256, the filter's results and blacklist, each fold's SanityChecker
    choices, the final SanityChecker's, the selection, the Brier
    evaluator's output on the scoring file and the train's seconds),
    ``insights.json`` (``model_insights().to_json()``), ``expected.npz``
    (the scores and the scoring file's keys) and ``model/`` (the saved
    workflow without its drift baseline)."""
    import time

    from test_torch_serve import drop_drift_baseline, save_jax_model
    from test_torch_titanic_e2e import prediction_parts
    from transmogrifai_tpu.evaluators import Evaluators
    from transmogrifai_tpu.readers import DataReaders

    os.environ["TG_FAST_GRIDS"] = "0"
    tmp = tempfile.mkdtemp()
    train_csv, score_csv = (os.path.join(tmp, f) for f in ("t.csv",
                                                           "s.csv"))
    train_sha = titanic_csv(train_csv, TITANIC_ROWS, TITANIC_SEED)
    score_sha = titanic_csv(score_csv, TITANIC_SCORE_ROWS,
                            TITANIC_SCORE_SEED)
    jax_reset()
    wf, survived, pred = jax_wcv_workflow(train_csv, score_csv)
    folds, undo = jax_fold_sanity_recorder()
    t0 = time.perf_counter()
    try:
        model = wf.train()
    finally:
        undo()
    secs = time.perf_counter() - t0
    sc = next(s for s in model.stages
              if type(s).__name__ == "SanityCheckerModel")
    reader = DataReaders.Simple.csv(
        score_csv, schema=jax_titanic.TITANIC_SCHEMA, header=False,
        key_field="PassengerId")
    table = reader.generate_table(model.raw_features)
    scored = model.score(table=table)
    parts = prediction_parts(scored, pred)
    brier = (Evaluators.BinaryClassification.brier_score()
             .set_label_col(survived).set_prediction_col(pred)
             .evaluate_all(scored))
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    path = os.path.join(out_dir, "model")
    save_jax_model(model, path)
    drop_drift_baseline(path)
    np.savez_compressed(os.path.join(out_dir, "expected.npz"),
                        probability_1=parts["probability_1"],
                        prediction=parts["prediction"],
                        key=np.asarray(table.key, dtype=str))
    with open(os.path.join(out_dir, "insights.json"), "w") as fh:
        json.dump(model.model_insights().to_json(), fh, indent=1)
    with open(os.path.join(out_dir, "fixture.json"), "w") as fh:
        json.dump({
            "train_csv": {"rows": TITANIC_ROWS, "seed": TITANIC_SEED,
                          "sha256": train_sha},
            "score_csv": {"rows": TITANIC_SCORE_ROWS,
                          "seed": TITANIC_SCORE_SEED, "sha256": score_sha},
            "train_seconds_jax_cpu": secs,
            "rff": model.rff_results.to_json(),
            "blacklist": [f.name for f in model.blacklisted_features],
            "folds": [sanity_summary(m) for m in folds],
            "sanity": sanity_summary(sc),
            "selection": selection_summary(model.stages[-1].summary),
            "brier": brier,
        }, fh, indent=1)
    shutil.rmtree(tmp)


# ---------------------------------------------------------------------------
# Small trains: both packages on ``_titanic_df``
# ---------------------------------------------------------------------------

SMALL_PROB_ATOL = 1e-5
FIXTURE_PROB_ATOL = 1e-6


def _small_frames():
    from test_torch_titanic_e2e import _titanic_df
    train = _titanic_df()
    score = _titanic_df(200, 8)
    score["Cabin"] = None
    return train, score


def _brier_limit(d):
    return (2.0 + d) * d


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    from test_torch_titanic_e2e import (
        PINNED_MODELS, _columns, _jax_workflow, _port_workflow,
    )
    from transmogrifai_tpu.filters import RawFeatureFilter as JRFF
    from transmogrifai_tpu.readers import DataReaders as JReaders
    from transmogrifai_tpu_torch.filters import RawFeatureFilter as PRFF
    train, score = _small_frames()
    jwf, jpred, _ = _jax_workflow(PINNED_MODELS)
    jwf = (jwf.set_input_dataset(train).with_raw_feature_filter(JRFF(
        score_reader=JReaders.Simple.dataframe(score))).with_workflow_cv())
    folds, undo = jax_fold_sanity_recorder()
    try:
        jm = jwf.train()
    finally:
        undo()
    pwf, ppred, _ = _port_workflow(PINNED_MODELS)
    pwf = (pwf.set_input_dataset(_columns(train)).with_raw_feature_filter(
        PRFF(score_reader=port.DataReaders.Simple.dataframe(
            _columns(score)))).with_workflow_cv())
    pm = pwf.train()
    sel = next(s for s in pwf.stages if type(s).__name__ == "ModelSelector")
    path = str(tmp_path_factory.mktemp("wcv") / "port")
    port.save_model(pm, path)
    return dict(train=train, score=score, jm=jm, pm=pm, jpred=jpred,
                ppred=ppred, jfolds=folds, sel=sel, pwf=pwf, path=path,
                columns=_columns)


def _stage(model, name):
    return next(s for s in model.stages if type(s).__name__ == name)


def test_small_filter_and_blacklist_match_jax(small):
    from test_torch_raw_feature_filter import assert_same_results
    jm, pm = small["jm"], small["pm"]
    assert [f.name for f in pm.blacklisted_features] == [
        f.name for f in jm.blacklisted_features]
    assert "Cabin" in [f.name for f in pm.blacklisted_features]
    assert_same_results(pm.rff_results.to_json(), jm.rff_results.to_json())
    assert ([(s.uid, [f.uid for f in s.input_features]) for s in pm.stages]
            == [(s.uid, [f.uid for f in s.input_features])
                for s in jm.stages])
    assert set(small["pwf"].phase_seconds) == {
        "filter", "before", "fold_prep", "sweep", "rest"}


def test_small_folds_and_selection_match_jax(small):
    from test_torch_titanic_e2e import assert_folds_agree
    jm, pm, sel = small["jm"], small["pm"], small["sel"]
    assert len(small["jfolds"]) == len(sel.fold_models) == 3
    for jf, (pf,) in zip(small["jfolds"], sel.fold_models):
        assert_same_sanity(sanity_summary(pf), sanity_summary(jf))
    assert_same_sanity(sanity_summary(_stage(pm, "SanityCheckerModel")),
                       sanity_summary(_stage(jm, "SanityCheckerModel")))
    assert_folds_agree(selection_summary(pm.stages[-1].summary),
                       selection_summary(jm.stages[-1].summary))


def test_small_scores_brier_and_reload(small):
    from test_torch_titanic_e2e import assert_scores_agree, prediction_parts
    from transmogrifai_tpu.evaluators import Evaluators as JEvaluators
    score, cols = small["score"], small["columns"]
    jscored = small["jm"].score(df=score)
    # a reader's table keeps the label, which the Brier score reads
    pscored = small["pm"].score(table=port.DataReaders.Simple.dataframe(
        cols(score)).generate_table(small["pm"].raw_features))
    want = prediction_parts(jscored, small["jpred"])
    got = prediction_parts(pscored, small["ppred"])
    np.testing.assert_allclose(got["probability_1"], want["probability_1"],
                               rtol=0, atol=SMALL_PROB_ATOL)
    assert_scores_agree(got, want)
    jb = (JEvaluators.BinaryClassification.brier_score()
          .set_label_col("Survived").set_prediction_col(small["jpred"])
          .evaluate_all(jscored))
    pb = (port.Evaluators.BinaryClassification.brier_score()
          .set_label_col("Survived").set_prediction_col(small["ppred"])
          .evaluate_all(pscored))
    assert abs(pb["BrierScore"] - jb["BrierScore"]) <= _brier_limit(
        SMALL_PROB_ATOL)
    loaded = port.load_model(small["path"], device="cpu",
                             workflow=small["pwf"])
    again = prediction_parts(loaded.score(data=cols(score)),
                             small["ppred"])
    for k in got:
        assert again[k].tobytes() == got[k].tobytes()
    assert [f.name for f in loaded.blacklisted_features] == [
        f.name for f in small["pm"].blacklisted_features]
    assert loaded.rff_results.to_json() == small["pm"].rff_results.to_json()


def test_small_model_insights_match_jax(small):
    jm, pm = small["jm"], small["pm"]
    want = jm.model_insights().to_json()
    got = pm.model_insights().to_json()
    winner = pm.stages[-1].fitted.family
    gaps = json_gaps(insights_by_feature(got), insights_by_feature(want),
                     insight_limits(winner, want))
    assert {"features", "rawFeatureFilterResults",
            "modelValidationResults"} <= set(gaps)
    assert got["blacklistedFeatures"] == ["Cabin"]
    assert got["versionInfo"]["version"] == want["versionInfo"]["version"]
    # the report's features are sorted by contribution
    contrib = [max([abs(d["contribution"]) for d in f["derived"]
                    if d["contribution"] is not None], default=0.0)
               for f in got["features"]]
    assert contrib == sorted(contrib, reverse=True)
    text = pm.model_insights().pretty_print()
    assert "Model Insights" in text and "Blacklisted raw features" in text
    assert text.splitlines()[:5] == jm.model_insights().pretty_print(
    ).splitlines()[:5]


# ---------------------------------------------------------------------------
# The committed fixture
# ---------------------------------------------------------------------------

def _fixture():
    with open(os.path.join(FIXTURE_DIR, "fixture.json")) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("titanic_wcv_fixture")
    train, score = str(d / "train.csv"), str(d / "score.csv")
    return (train, titanic_csv(train, TITANIC_ROWS, TITANIC_SEED),
            score, titanic_csv(score, TITANIC_SCORE_ROWS,
                               TITANIC_SCORE_SEED))


def test_port_rebuilds_the_fixture_files(fixture_files):
    fx = _fixture()
    assert fixture_files[1] == fx["train_csv"]["sha256"]
    assert fixture_files[3] == fx["score_csv"]["sha256"]


class _StopAtTheSweep(Exception):
    pass


@pytest.fixture(scope="module")
def fold_inputs(fixture_files):
    """The port's Titanic workflow with both options on the fixture's
    files, on the CPU, up to the sweep: (the filter's blacklist and
    results, the selector, [(X, y, validation masks)] of each fold's
    sweep). The sweep is the card's: it is stopped at its third call."""
    from transmogrifai_tpu_torch.impl.tuning.validators import OpValidator
    calls = []

    def grab(self, models, X, y, *a, val_masks=None, **kw):
        calls.append((X.numpy().copy(), y.numpy().copy(),
                      np.asarray(val_masks).copy()))
        if len(calls) == 3:
            raise _StopAtTheSweep()
        return None

    port_reset()
    wf, _, _ = titanic_wcv_workflow(fixture_files[0], fixture_files[2],
                                    device="cpu")
    _, blacklist, results = wf._raw_feature_filter.filter_raw(
        wf.reader.generate_table(wf.raw_features), wf.raw_features)
    saved = OpValidator.validate
    OpValidator.validate = grab
    try:
        with pytest.raises(_StopAtTheSweep):
            wf.train()
    finally:
        OpValidator.validate = saved
    sel = next(s for s in wf.stages if type(s).__name__ == "ModelSelector")
    return blacklist, results, sel, calls


def test_port_filter_and_folds_on_the_fixture_files(fold_inputs):
    """The port's filter on the fixture's two files and each fold's
    SanityChecker on the training file, on the CPU."""
    from test_torch_raw_feature_filter import assert_same_results
    fx = _fixture()
    blacklist, results, sel, calls = fold_inputs
    assert_same_results(results.to_json(), fx["rff"])
    assert [f.name for f in blacklist] == fx["blacklist"]
    assert sorted(fx["rff"]["excludedFeatures"]) == sorted(fx["blacklist"])
    assert len(sel.fold_models) == len(fx["folds"]) == len(calls)
    for (got,), want in zip(sel.fold_models, fx["folds"]):
        assert_same_sanity(sanity_summary(got), want)
    assert getattr(sel, "_preset_best", None) is None


@pytest.fixture(scope="module")
def lr_folds(fold_inputs):
    """The fixture's LR grid on each fold's sweep inputs: (a function of
    a fold's matrix giving the port's fold AuPRs, [(X, the JAX package's
    fold AuPRs, their largest move under a column reordering)])."""
    import jax.numpy as jnp
    from transmogrifai_tpu.impl.selector.model_selector import (
        ModelSelector as JSelector,
    )
    from transmogrifai_tpu.impl.tuning.validators import (
        OpCrossValidation as JCV,
    )
    from transmogrifai_tpu_torch.impl.selector.model_selector import (
        ModelSelector as PSelector,
    )
    fx = _fixture()
    want = {f["family"]: np.asarray(f["fold_metrics"], np.float32)
            for f in fx["selection"]["families"]}
    prev = os.environ.get("TG_FAST_GRIDS")
    os.environ["TG_FAST_GRIDS"] = "0"           # the fixture's full grid
    try:
        models = [("OpLogisticRegression", None)]
        jsel = JSelector("binary", JCV(num_folds=3, seed=42), None, models)
        psel = PSelector("binary", None, None, models)
    finally:
        if prev is None:
            os.environ.pop("TG_FAST_GRIDS")
        else:
            os.environ["TG_FAST_GRIDS"] = prev
    _, _, _, calls = fold_inputs
    folds = []
    for f, (X, y, vm) in enumerate(calls):
        def jax_metrics(M, y=y, vm=vm):
            b = jsel.validator.validate(
                jsel.models, jnp.asarray(np.ascontiguousarray(M)),
                jnp.asarray(y), "binary", "AuPR", True, 2, val_masks=vm)
            return np.asarray(b.results[0].fold_metrics[0])
        ref = jax_metrics(X)
        assert ref.tobytes() == want["OpLogisticRegression"][f].tobytes()
        cols = np.random.RandomState(f).permutation(X.shape[1])
        folds.append((f, X, ref, np.abs(jax_metrics(X[:, cols]) - ref).max()))

    def port_metrics(f, X):
        _, y, vm = calls[f]
        return psel.validator.validate(
            psel.models, torch.as_tensor(X), torch.as_tensor(y), "binary",
            "AuPR", True, 2, val_masks=vm).results[0].fold_metrics[0]
    return port_metrics, folds


def test_the_linear_sweep_gap_is_the_reference_order_noise(lr_folds):
    """Each fold's sweep sees 18,000 rows x 529 columns (most sparse
    one-hot and hash counts). There the linear sweeps' bf16 temporaries
    amplify float32 summation order: the JAX package's own LR fold
    metrics move by up to ~6e-5 when only the columns of its input are
    reordered (CPU readings). The port's gap to the fixture is of that
    size, not a difference of algorithm: the JAX package on the port's
    fold matrices gives the fixture's metrics bit for bit, and the port
    lies within twice that spread of them. ``chip_smoke.py`` holds this
    path's linear sweeps to ``WCV_LIN_FOLD_ATOL``, above that bound."""
    port_metrics, folds = lr_folds
    spread = max(s for *_, s in folds)
    gap = max(np.abs(port_metrics(f, X) - ref).max()
              for f, X, ref, _ in folds)
    print(f"LR fold AuPR: the JAX package under a column reordering moves "
          f"by {spread:.3g}, the port lies {gap:.3g} from it")
    assert spread > 2e-5
    assert gap <= 2 * spread <= WCV_LIN_FOLD_ATOL


def _sweep_variant(linear, monkeypatch, variant):
    """Make the port's LR sweep another one: ``refit`` fits the
    candidates at the refit's settings (float32, Newton-CG 10 x 8),
    ``cg5``/``cg7`` one conjugate-gradient step fewer or more (8 x 5,
    8 x 7), ``no_bf16`` keeps the sweep's schedule but takes out the bf16
    rounding of its (n, B) temporaries."""
    F = linear.LogisticRegressionFamily
    fit = F._fit
    if variant == "refit":
        monkeypatch.setattr(F, "sweep_fit_batch", F.fit_batch)
    elif variant == "no_bf16":
        monkeypatch.setattr(linear, "_rounder", lambda sweep: (lambda x: x))
    else:
        solver, cg = linear._fit_logreg_batch, int(variant[2:])

        def fewer_or_more(*a, **kw):
            return solver(*a, **dict(kw, cg_iters=cg))

        def sweep(self, X, y, weights, grid, num_classes):
            monkeypatch.setattr(linear, "_fit_logreg_batch", fewer_or_more)
            try:
                return fit(self, X, y, weights, grid, num_classes, sweep=True)
            finally:
                monkeypatch.setattr(linear, "_fit_logreg_batch", solver)
        monkeypatch.setattr(F, "sweep_fit_batch", sweep)


@pytest.mark.parametrize("variant,beyond", [
    ("refit", True), ("cg5", True), ("cg7", True), ("no_bf16", False)])
def test_the_fold_limit_against_other_sweeps(lr_folds, monkeypatch, variant,
                                             beyond):
    """The control of the limit above, on the same fold inputs: a sweep at
    the refit's settings or with its conjugate-gradient schedule one step
    off lies beyond ``WCV_LIN_FOLD_ATOL`` from the fixture's fold metrics.
    Taking out only the bf16 rounding moves them by about as much as the
    order noise (CPU: 1.67e-4 at most, 2.3e-5 on average, the port's
    2.3e-5), so at these shapes the limit cannot see it: the rounding is
    held where it shows, by the coefficients of
    ``test_torch_linear.py::test_logreg_batch_matches_jax[sweep]`` (2.4e-3
    off without it)."""
    from transmogrifai_tpu_torch.models import linear
    port_metrics, folds = lr_folds
    _sweep_variant(linear, monkeypatch, variant)
    gaps = [np.abs(port_metrics(f, X) - ref) for f, X, ref, _ in folds]
    gap = max(g.max() for g in gaps)
    print(f"LR fold AuPR, sweep {variant}: {gap:.3g} at most, "
          f"{np.mean(gaps):.3g} on average from the JAX package")
    assert (gap > WCV_LIN_FOLD_ATOL) == beyond


def test_committed_model_scores_in_the_port(fixture_files):
    from test_torch_titanic_e2e import assert_scores_agree, prediction_parts
    fx = _fixture()
    exp = np.load(os.path.join(FIXTURE_DIR, "expected.npz"))
    port_reset()
    pwf, survived, pred = titanic_wcv_workflow(
        fixture_files[0], fixture_files[2], device="cpu")
    pm = port.load_model(os.path.join(FIXTURE_DIR, "model"), device="cpu",
                         workflow=pwf)
    assert [f.name for f in pm.blacklisted_features] == fx["blacklist"]
    assert pm.rff_results.to_json()["excludedFeatures"] == \
        fx["rff"]["excludedFeatures"]
    reader = port.DataReaders.Simple.csv(
        fixture_files[2], schema=TITANIC_SCHEMA, header=False,
        key_field="PassengerId")
    scored = pm.score(table=reader.generate_table(pm.raw_features))
    assert list(scored.key) == exp["key"].tolist()
    got = prediction_parts(scored, pred)
    np.testing.assert_allclose(got["probability_1"], exp["probability_1"],
                               rtol=0, atol=FIXTURE_PROB_ATOL)
    assert_scores_agree(got, {k: exp[k] for k in ("probability_1",
                                                  "prediction")})
    brier = (port.Evaluators.BinaryClassification.brier_score()
             .set_label_col(survived).set_prediction_col(pred)
             .evaluate_all(scored))
    assert abs(brier["BrierScore"] - fx["brier"]["BrierScore"]) <= \
        _brier_limit(FIXTURE_PROB_ATOL)
    assert pm.stages[-1].fitted.family == fx["selection"]["winner"]


def test_fixture_stays_small():
    total = sum(os.path.getsize(os.path.join(root, f))
                for root, _, files in os.walk(FIXTURE_DIR) for f in files)
    assert total < 2 * 2 ** 20, total


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    generate_fixture()
