"""The Titanic workflow of the PyTorch port against the JAX package: typed
raw features (PickList, Text, Integral, Real, RealNN and two derived
``BinaryTransformer`` features), ``transmogrify``, SanityChecker and the
binary selector with 3-fold cross-validation, trained and served.

The small trains run both packages on ``_titanic_df``'s frame (a copy of
``tests/test_plan.py``'s) with the selector pinned to one tree and one
linear family. The committed fixture under
``transmogrifai_tpu_torch/fixtures/titanic`` holds what the JAX package
made of ``testing.titanic_csv(TITANIC_ROWS, TITANIC_SEED)`` with the
default binary model list at full default grids (the card has no JAX and
no pandas, so ``chip_smoke.py`` trains the port on the same file and holds
it to this); this file's ``__main__`` writes it::

    python tests/test_torch_titanic_e2e.py

Tolerances, stated once:

* the feature vector and the SanityChecker's choices: equal (the vector
  bit for bit), the same float32 arithmetic on the same values; the
  statistics quoted in a removal reason within 1e-12 absolute or 1e-4
  relative (float32 moments summed in another order: a constant column's
  variance is 0 here and 2.7e-15 where XLA fuses its mean into the
  subtraction);
* fold metrics: tree families 1e-5 (the same trees; metrics summed in
  another order), the logistic regression's bf16 sweep 5e-5 (as the
  default lists' limits in ``chip_smoke.py``);
* ``probability_1``: atol 1e-5, the prediction equal wherever
  |p - 0.5| > 1e-5 (as ``test_torch_serve.py``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pandas as pd
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
from transmogrifai_tpu.persistence import (  # noqa: E402
    load_model as jax_load_model,
)
import transmogrifai_tpu_torch as port  # noqa: E402
from transmogrifai_tpu_torch.examples import titanic as port_titanic  # noqa: E402
from transmogrifai_tpu_torch.features import (  # noqa: E402
    reset_uids as port_reset,
)
from transmogrifai_tpu_torch.testing import (  # noqa: E402
    TITANIC_ROWS, TITANIC_SCORE_ROWS, TITANIC_SCORE_SEED, TITANIC_SEED,
    assert_same_sanity, sanity_summary, selection_gaps, selection_summary,
    titanic_csv,
)

FIXTURE_DIR = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures",
                           "titanic")
TREE_FOLD_ATOL = 1e-5
LINEAR_FOLD_ATOL = 5e-5
PROB_ATOL = 1e-5
PRED_MARGIN = 1e-5
#: the rows of the training vector the fixture keeps
SAMPLE_ROWS, SAMPLE_SEED = 256, 0

#: the small trains' selector: one tree and one linear family
PINNED_MODELS = [
    ("OpGBTClassifier", [{"maxDepth": 3, "maxIter": 10, "stepSize": 0.1,
                          "minInstancesPerNode": 10,
                          "minInfoGain": 0.001}]),
    ("OpLogisticRegression", [{"regParam": 0.01, "elasticNetParam": 0.0},
                              {"regParam": 0.1, "elasticNetParam": 0.0}]),
]


def _titanic_df(n=240, seed=7):
    """``tests/test_plan.py``'s Titanic-shaped frame."""
    rng = np.random.RandomState(seed)
    sex = rng.choice(["male", "female"], n)
    pclass = rng.choice([1, 2, 3], n)
    age = np.where(rng.rand(n) < 0.15, np.nan, rng.uniform(1, 80, n))
    fare = np.round(rng.lognormal(2.5, 1.0, n), 2)
    survived = ((sex == "female").astype(float) * 0.6
                + (pclass == 1).astype(float) * 0.3
                + rng.rand(n) * 0.4 > 0.5).astype(float)
    return pd.DataFrame({
        "PassengerId": np.arange(1, n + 1),
        "Survived": survived,
        "Pclass": pclass,
        "Name": [f"Passenger, {'Mr.' if s == 'male' else 'Mrs.'} No{i}"
                 for i, s in enumerate(sex)],
        "Sex": sex,
        "Age": age,
        "SibSp": rng.randint(0, 4, n),
        "Parch": rng.randint(0, 3, n),
        "Ticket": [f"T{rng.randint(100, 999)}" for _ in range(n)],
        "Fare": fare,
        "Cabin": [None if rng.rand() < 0.7 else f"C{rng.randint(1, 99)}"
                  for _ in range(n)],
        "Embarked": rng.choice(["S", "C", "Q"], n),
    })


def _columns(df):
    """A DataFrame as the port's column mapping."""
    return {c: df[c].to_numpy() for c in df.columns}


def _jax_workflow(models, seed=42):
    """The JAX package's Titanic DAG (``examples.titanic``) with the
    selector's ``models``; (workflow, prediction, checked)."""
    from transmogrifai_tpu.impl.preparators import SanityChecker
    from transmogrifai_tpu.impl.selector import (
        BinaryClassificationModelSelector,
    )
    from transmogrifai_tpu.workflow import OpWorkflow
    jax_reset()
    survived, vec = jax_titanic.titanic_features()
    checked = survived.transform_with(SanityChecker(seed=seed), vec)
    pred = survived.transform_with(
        BinaryClassificationModelSelector.with_cross_validation(
            seed=seed, models=models), checked)
    return OpWorkflow().set_result_features(pred, checked), pred, checked


def _port_workflow(models, seed=42, device="cpu"):
    from transmogrifai_tpu_torch.impl.preparators.sanity_checker import (
        SanityChecker,
    )
    port_reset()
    survived, vec = port_titanic.titanic_features()
    checked = survived.transform_with(SanityChecker(seed=seed), vec)
    pred = survived.transform_with(
        port.BinaryClassificationModelSelector.with_cross_validation(
            seed=seed, models=models), checked)
    wf = port.OpWorkflow(device=device).set_result_features(pred, checked)
    return wf, pred, checked


def prediction_parts(table, feature):
    """{key: (n,) float32 numpy} of a Prediction column of either
    package's scored table."""
    col = table[feature.name]
    vals = col.values
    vals = vals.cpu().numpy() if isinstance(vals, torch.Tensor) \
        else np.asarray(vals)
    return {k: vals[:, i] for i, k in enumerate(col.metadata["keys"])}


def assert_scores_agree(got, want):
    np.testing.assert_allclose(got["probability_1"], want["probability_1"],
                               rtol=0, atol=PROB_ATOL)
    far = np.abs(want["probability_1"] - 0.5) > PRED_MARGIN
    np.testing.assert_array_equal(got["prediction"][far],
                                  want["prediction"][far])


def vector_meta_json(vm):
    return {"name": vm.name,
            "columns": [dataclasses.asdict(c) for c in vm.columns]}


def assert_folds_agree(got, want):
    """Same winner, hyperparameters, families and grids, and every fold
    metric within its family's limit."""
    selection_gaps(got, want, lambda family, hyper, ref: (
        LINEAR_FOLD_ATOL if family in ("OpLogisticRegression", "OpLinearSVC")
        else TREE_FOLD_ATOL))


# ---------------------------------------------------------------------------
# Small trains: both packages on ``_titanic_df``
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    """Both packages' Titanic workflows trained on ``_titanic_df()`` with
    ``PINNED_MODELS``."""
    df = _titanic_df()
    jwf, jpred, jchk = _jax_workflow(PINNED_MODELS)
    jm = jwf.set_input_dataset(df).train()
    pwf, ppred, pchk = _port_workflow(PINNED_MODELS)
    pm = pwf.set_input_dataset(_columns(df)).train()
    return dict(df=df, jm=jm, pm=pm, jwf=jwf, pwf=pwf, jpred=jpred,
                ppred=ppred, jchk=jchk, pchk=pchk)


def _stage(model, name):
    return next(s for s in model.stages if type(s).__name__ == name)


def test_small_train_same_vector_checks_and_winner(small):
    df, jm, pm = small["df"], small["jm"], small["pm"]
    jsc, psc = (_stage(m, "SanityCheckerModel") for m in (jm, pm))
    vec = psc.input_features[1].name
    assert vec == jsc.input_features[1].name
    jv = jm.score(df=df)[vec]
    pv = pm.score(data=_columns(df))[vec]
    np.testing.assert_array_equal(pv.values.numpy(), np.asarray(jv.values))
    assert vector_meta_json(pv.metadata["vector_meta"]) == vector_meta_json(
        jv.metadata["vector_meta"])
    assert_same_sanity(sanity_summary(psc), sanity_summary(jsc))
    assert_folds_agree(selection_summary(pm.stages[-1].summary),
                       selection_summary(jm.stages[-1].summary))


def test_small_train_scores_agree(small):
    df = small["df"]
    want = prediction_parts(small["jm"].score(df=df), small["jpred"])
    got = prediction_parts(small["pm"].score(data=_columns(df)),
                           small["ppred"])
    assert_scores_agree(got, want)


def test_jax_saved_model_loads_with_the_workflow(small, tmp_path):
    """A JAX-saved Titanic model holds two lambdas (the ``Pclass``
    extract function, the derived features' functions): the port takes
    them from its own workflow's stages of the same uids."""
    from test_torch_serve import save_jax_model
    df, jm = small["df"], small["jm"]
    path = str(tmp_path / "titanic")
    save_jax_model(jm, path)
    with pytest.raises(ValueError, match="unserializable state"):
        port.load_model(path, device="cpu")
    loaded = port.load_model(path, device="cpu", workflow=small["pwf"])
    want = prediction_parts(jm.score(df=df), small["jpred"])
    got = prediction_parts(loaded.score(data=_columns(df)), small["ppred"])
    assert_scores_agree(got, want)


def test_score_function_per_row_equals_score(small):
    df, pm, jm = small["df"], small["pm"], small["jm"]
    name = small["ppred"].name
    rows = df.to_dict("records")[:24]
    batch = prediction_parts(pm.score(data=rows), small["ppred"])
    fn, jfn = pm.score_function(), jm.score_function()
    for i, row in enumerate(rows):
        got = fn(row)[name]
        assert got["probability_1"] == pytest.approx(
            float(batch["probability_1"][i]), abs=1e-7)
        assert got["prediction"] == batch["prediction"][i]
        want = jfn(row)[name]
        assert got["probability_1"] == pytest.approx(
            want["probability_1"], abs=PROB_ATOL)
    assert port.micro_batch_score_function(pm)(rows) == [fn(r) for r in rows]


# ---------------------------------------------------------------------------
# The committed fixture
# ---------------------------------------------------------------------------

def _fixture():
    with open(os.path.join(FIXTURE_DIR, "fixture.json")) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("titanic_fixture")
    train, score = str(d / "train.csv"), str(d / "score.csv")
    return (train, titanic_csv(train, TITANIC_ROWS, TITANIC_SEED),
            score, titanic_csv(score, TITANIC_SCORE_ROWS,
                               TITANIC_SCORE_SEED))


def test_port_rebuilds_the_fixture_files(fixture_files):
    fx = _fixture()
    assert fixture_files[1] == fx["train_csv"]["sha256"]
    assert fixture_files[3] == fx["score_csv"]["sha256"]


@pytest.fixture(scope="module")
def port_checked(fixture_files):
    """The port's transmogrify and SanityChecker fitted on the CPU on the
    fixture's training file: (fitted table, SanityChecker, its fitted
    model, label feature)."""
    from transmogrifai_tpu_torch.dag import (
        compute_dag, fit_and_transform_dag,
    )
    port_reset()
    wf, survived, _ = port_titanic.build_workflow(fixture_files[0],
                                                  device="cpu")
    sc_stage = next(s for s in wf.stages
                    if type(s).__name__ == "SanityChecker")
    table = wf.reader.generate_table(wf.raw_features).to_device("cpu")
    out, fitted = fit_and_transform_dag(
        table, compute_dag([sc_stage.get_output()]))
    return out, sc_stage, fitted[sc_stage.uid], survived


def test_port_vectorizes_and_checks_the_fixture_file(port_checked):
    """The port's transmogrify and SanityChecker on the fixture's 20,000
    rows: the JAX package's metadata, sampled rows bit for bit, kept slots
    and reasons."""
    fx = _fixture()
    out, sc_stage, sc_model, _ = port_checked
    vec = out[sc_stage.input_features[1].name]
    assert vector_meta_json(vec.metadata["vector_meta"]) == fx["vector"]
    sample = np.load(os.path.join(FIXTURE_DIR, "vector_sample.npz"))
    np.testing.assert_array_equal(vec.values.numpy()[sample["rows"]],
                                  sample["X"])
    assert_same_sanity(sanity_summary(sc_model), fx["sanity"])


def test_the_lr_refit_gap_is_the_jax_packages_rounding(port_checked,
                                                        monkeypatch):
    """At the fixture's 529 kept columns (most of them sparse one-hot and
    hash counts) the logistic regression's Newton-CG refit amplifies
    float32 rounding: on 13,000 rows of the fixture's file the JAX
    package's result lies 9.4e-5 of the largest coefficient from a float64
    run of the same algorithm, the port's 6.2e-6, and its probability_1
    on those rows 1.25e-4, the port's 1.6e-5 (CPU readings). The port's
    gap to the JAX package is the JAX package's rounding, so
    ``chip_smoke.py`` holds the Titanic refit's params and probability_1
    to limits of that size (``TITANIC_LIN_COEF_RTOL``,
    ``TITANIC_LIN_PROB_ATOL``)."""
    import jax.numpy as jnp
    from transmogrifai_tpu.models import linear as JL
    from transmogrifai_tpu_torch.models import linear as PL
    out, sc_stage, _, survived = port_checked
    X = out[sc_stage.get_output().name].values.numpy()
    y = out[survived.name].values.numpy().astype(np.float32)
    idx = np.random.RandomState(0).permutation(len(y))[:13000]
    X, y = X[idx], y[idx]
    args = (X, y, np.ones((1, len(y)), np.float32),
            np.array([0.01], np.float32), np.array([0.5], np.float32))
    jc, jb = (np.asarray(a)[0] for a in jax.jit(JL._fit_logreg_batch)(
        *map(jnp.asarray, args)))
    pc, pb = (a.numpy()[0] for a in PL._fit_logreg_batch(
        *map(torch.as_tensor, args)))
    monkeypatch.setattr(PL, "_F32", torch.float64)
    exact, eb = (a.numpy()[0] for a in PL._fit_logreg_batch(
        *(torch.as_tensor(a).double() for a in args)))
    scale = np.abs(exact).max()
    port_gap = np.abs(pc - exact).max() / scale
    jax_gap = np.abs(jc - exact).max() / scale

    def p1(w, b):
        return 1 / (1 + np.exp(-(X.astype(np.float64) @ w + b)))
    p_exact = p1(exact, eb)
    port_p = np.abs(p1(pc, pb) - p_exact).max()
    jax_p = np.abs(p1(jc, jb) - p_exact).max()
    print(f"float64 gap: the port {port_gap:.3g}, the JAX package "
          f"{jax_gap:.3g} of the largest coefficient; probability_1 on "
          f"these rows: the port {port_p:.3g}, the JAX package {jax_p:.3g}")
    assert port_gap < 2e-5 and port_p < 5e-5
    assert jax_gap > 5 * port_gap and jax_p > 5 * port_p


def test_committed_model_scores_in_both_packages(fixture_files):
    from transmogrifai_tpu.readers import DataReaders
    exp = np.load(os.path.join(FIXTURE_DIR, "expected.npz"))
    path = os.path.join(FIXTURE_DIR, "model")
    jax_reset()
    jwf, _, jpred = jax_titanic.build_workflow(fixture_files[2])
    jm = jax_load_model(path, workflow=jwf)
    table = DataReaders.Simple.csv(
        fixture_files[2], schema=jax_titanic.TITANIC_SCHEMA, header=False,
        key_field="PassengerId").generate_table(jm.raw_features)
    jp = prediction_parts(jm.score(table=table), jm.result_features[0])
    np.testing.assert_allclose(jp["probability_1"], exp["probability_1"],
                               rtol=0, atol=1e-6)
    port_reset()
    pwf, _, ppred = port_titanic.build_workflow(fixture_files[2],
                                                device="cpu")
    pm = port.load_model(path, device="cpu", workflow=pwf)
    scored = pm.score(reader=pwf.reader)
    assert list(scored.key) == exp["key"].tolist()
    assert_scores_agree(prediction_parts(scored, pm.result_features[0]),
                        {k: exp[k] for k in ("probability_1",
                                             "prediction")})
    sel = _fixture()["selection"]
    assert pm.stages[-1].fitted.family == sel["winner"]
    assert [f["family"] for f in sel["families"]] == [
        "OpLogisticRegression", "OpRandomForestClassifier",
        "OpGBTClassifier", "OpLinearSVC"]


def test_fixture_stays_small():
    total = sum(os.path.getsize(os.path.join(root, f))
                for root, _, files in os.walk(FIXTURE_DIR) for f in files)
    assert total < 5 * 2 ** 20, total


# ---------------------------------------------------------------------------
# Writing the committed fixture (JAX package, CPU)
# ---------------------------------------------------------------------------

def generate_fixture(out_dir: str = FIXTURE_DIR) -> None:
    """Train the JAX package's ``examples.titanic.build_workflow`` (the
    default binary model list at full default grids) on
    ``titanic_csv(TITANIC_ROWS, TITANIC_SEED)``, score the
    ``TITANIC_SCORE_ROWS``-row file, and write the fixture: ``fixture.json``
    (both files' sha256, the vector's metadata, the SanityChecker's
    choices, the selection, the train's seconds), ``vector_sample.npz`` (the
    vector at ``SAMPLE_ROWS`` seeded rows), ``expected.npz`` (the scores
    and the scoring file's keys) and ``model/`` (the saved workflow
    without its drift baseline)."""
    import time

    from test_torch_serve import drop_drift_baseline, save_jax_model
    from transmogrifai_tpu.readers import DataReaders

    os.environ["TG_FAST_GRIDS"] = "0"
    tmp = tempfile.mkdtemp()
    train_csv, score_csv = (os.path.join(tmp, f) for f in ("t.csv",
                                                           "s.csv"))
    train_sha = titanic_csv(train_csv, TITANIC_ROWS, TITANIC_SEED)
    score_sha = titanic_csv(score_csv, TITANIC_SCORE_ROWS,
                            TITANIC_SCORE_SEED)
    jax_reset()
    wf, _, pred = jax_titanic.build_workflow(train_csv, seed=42)
    t0 = time.perf_counter()
    model = wf.train()
    secs = time.perf_counter() - t0
    sc = next(s for s in model.stages
              if type(s).__name__ == "SanityCheckerModel")
    vec = model.train_table[sc.input_features[1].name]
    idx = np.sort(np.random.RandomState(SAMPLE_SEED).choice(
        TITANIC_ROWS, SAMPLE_ROWS, replace=False))
    reader = DataReaders.Simple.csv(
        score_csv, schema=jax_titanic.TITANIC_SCHEMA, header=False,
        key_field="PassengerId")
    table = reader.generate_table(model.raw_features)
    parts = prediction_parts(model.score(table=table), pred)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    path = os.path.join(out_dir, "model")
    save_jax_model(model, path)
    drop_drift_baseline(path)
    np.savez_compressed(os.path.join(out_dir, "vector_sample.npz"),
                        rows=idx, X=np.asarray(vec.values)[idx])
    np.savez_compressed(os.path.join(out_dir, "expected.npz"),
                        probability_1=parts["probability_1"],
                        prediction=parts["prediction"],
                        key=np.asarray(table.key, dtype=str))
    with open(os.path.join(out_dir, "fixture.json"), "w") as fh:
        json.dump({
            "train_csv": {"rows": TITANIC_ROWS, "seed": TITANIC_SEED,
                          "sha256": train_sha},
            "score_csv": {"rows": TITANIC_SCORE_ROWS,
                          "seed": TITANIC_SCORE_SEED, "sha256": score_sha},
            "train_seconds_jax_cpu": secs,
            "vector": vector_meta_json(vec.metadata["vector_meta"]),
            "sanity": sanity_summary(sc),
            "selection": selection_summary(model.stages[-1].summary),
        }, fh, indent=1)
    shutil.rmtree(tmp)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    generate_fixture()
