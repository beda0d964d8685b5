"""The lead-conversion workflows of the PyTorch port against the JAX
package: dates, geolocations and maps through ``transmogrify``, the
SanityChecker and the selectors, and the stage label indexed before the
multiclass selector and deindexed after it (``testing.leads_dag``).

The small trains run both packages on ``testing.leads_records(1000, 3)``
with the selector pinned to one small tree grid and one linear family.
The committed fixtures ``transmogrifai_tpu_torch/fixtures/leads`` (path
(a): ``Converted``, the default binary model list at full default grids)
and ``fixtures/leads_stage`` (path (b): ``Stage`` indexed, the multiclass
selector pinned to ``testing.SERVE_MODELS["rfmc"]``, the deindexer) hold
what the JAX package made of ``leads_records(LEADS_ROWS, LEADS_SEED)``
with its date clock at ``LEADS_CLOCK_MS`` (the card has no JAX and no
pandas, so ``chip_smoke.py`` trains the port on the same records and
holds it to them); here the port's vector and SanityChecker on those
records, and the saved models' scores, run on the CPU. This file's
``__main__`` writes the fixtures (JAX package, CPU)::

    python tests/test_torch_leads_e2e.py [leads] [leads_stage]

Tolerances, stated once:

* the feature vector, its metadata and the SanityChecker's choices:
  equal (the vector bit for bit); a statistic quoted in a removal reason
  within 1e-12 absolute or 1e-4 relative (``testing.assert_same_sanity``);
* fold metrics: tree families 1e-5, the small trains' linear sweeps
  ``SMALL_LIN_FOLD_ATOL`` (2e-3, the cause at the constant);
* ``probability_*``: 1e-5 on the small trains, 1e-6 for the committed
  models' scores; the prediction, and the deindexed stage, equal wherever
  the top two probabilities differ by more than 1e-5;
* the model insights: ``testing.insight_limits``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
from types import SimpleNamespace

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pandas as pd
import pytest
import jax  # noqa: F401
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import transmogrifai_tpu as tg  # noqa: E402
import transmogrifai_tpu.models.glm  # noqa: E402,F401  (registers families)
import transmogrifai_tpu.models.linear  # noqa: E402,F401
import transmogrifai_tpu.models.trees  # noqa: E402,F401
from transmogrifai_tpu.features import reset_uids as jax_reset  # noqa: E402
from transmogrifai_tpu.impl.feature import dates as jax_dates  # noqa: E402
from transmogrifai_tpu.persistence import (  # noqa: E402
    load_model as jax_load_model,
)
from transmogrifai_tpu_torch.testing import (  # noqa: E402
    LEADS_CLOCK_MS, LEADS_PATHS, LEADS_ROWS, LEADS_SCORE_ROWS,
    LEADS_SCORE_SEED, LEADS_SEED, fixed_clock, leads_dag, leads_records,
    leads_workflow, records_sha256, sanity_summary, selection_summary,
)

FIXTURES = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures")
#: fixture directory -> the label its workflow trains on
PATHS = {name: label for name, (label, _) in LEADS_PATHS.items()}
#: the rows of the training vector a fixture keeps
SAMPLE_ROWS, SAMPLE_SEED = 256, 0


def jax_namespace():
    """``leads_dag``'s names from the JAX package."""
    from transmogrifai_tpu.features import FeatureBuilder
    from transmogrifai_tpu.impl.preparators import PredictionDeIndexer
    from transmogrifai_tpu.impl.selector import factories
    from transmogrifai_tpu.stages.base import UnaryTransformer
    from transmogrifai_tpu.types import RealNN
    return SimpleNamespace(
        FeatureBuilder=FeatureBuilder, transmogrify=tg.transmogrify,
        BinaryClassificationModelSelector=(
            factories.BinaryClassificationModelSelector),
        MultiClassificationModelSelector=(
            factories.MultiClassificationModelSelector),
        UnaryTransformer=UnaryTransformer, RealNN=RealNN,
        PredictionDeIndexer=PredictionDeIndexer)


def jax_leads_workflow(records, label="Converted", models=None, seed=42,
                       clock_ms=LEADS_CLOCK_MS):
    """(workflow, label, prediction, results): the JAX package's leads
    workflow on ``records`` (a DataFrame, keyed by ``LeadId``), built after
    ``reset_uids`` with its date clock at ``clock_ms``."""
    from transmogrifai_tpu.workflow import OpWorkflow
    jax_reset()
    with fixed_clock(jax_dates, clock_ms):
        results, y, pred = leads_dag(jax_namespace(), label, models, seed)
    wf = (OpWorkflow().set_input_dataset(pd.DataFrame(records),
                                         key_field="LeadId")
          .set_result_features(*results))
    return wf, y, pred, results


def host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def prediction_parts(table, feature):
    """{key: (n,) float32 numpy} of a Prediction column of either
    package's scored table."""
    col = table[feature.name]
    vals = host(col.values)
    return {k: vals[:, i] for i, k in enumerate(col.metadata["keys"])}


def vector_meta_json(vm):
    return {"name": vm.name,
            "columns": [dataclasses.asdict(c) for c in vm.columns]}


def _stage(model, name):
    return next(s for s in model.stages if type(s).__name__ == name)


def reference_date_ms(model):
    """The fitted date-list pivot's reference instant."""
    return int(_stage(model, "DateListVectorizer").reference_date_ms)


SMALL_PROB_ATOL = 1e-5
FIXTURE_PROB_ATOL = 1e-6
PRED_MARGIN = 1e-5
TREE_FOLD_ATOL = 1e-5
#: the small train's linear sweep: 1,000 rows x ~620 columns (512 of them
#: hashed note tokens) are near-separable, and there the bf16 sweep
#: amplifies float32 summation order: the port lies up to ~6e-4 AuPR from
#: the JAX package on one fold, on the same vector bit for bit
#: (``test_small_train_same_vector_checks_and_selection`` prints each
#: family's gap). The committed fixture's 20,000-row folds are held on the
#: card (``chip_smoke.py``: ``LEADS_SVC_FOLD_ATOL``, ``LEADS_LIN_F64_ATOL``)
SMALL_LIN_FOLD_ATOL = 2e-3
#: the small trains: rows and seed of ``leads_records``; (a) one tree grid
#: and one linear family, (b) a small RF
SMALL_ROWS, SMALL_SEED = 1000, 3
SMALL_MODELS = {
    "Converted": [("OpGBTClassifier", [{"maxDepth": 3, "maxIter": 5,
                                        "stepSize": 0.1}]),
                  ("OpLogisticRegression", [{"regParam": 0.1,
                                             "elasticNetParam": 0.0}])],
    "Stage": [("OpRandomForestClassifier", [{"maxDepth": 4, "numTrees": 5,
                                             "minInstancesPerNode": 10}])],
}


def port_leads_workflow(records, label, models, seed=42, device="cpu",
                        clock_ms=LEADS_CLOCK_MS):
    """The port's leads workflow, as ``jax_leads_workflow`` builds the JAX
    package's."""
    return leads_workflow(records, label, models, seed, device, clock_ms)


def assert_scores_agree(got, want, atol):
    """Probabilities within ``atol``; the prediction equal wherever the
    top two probabilities (or probability_1 and 0.5) are more than
    PRED_MARGIN apart."""
    keys = sorted(k for k in want if k.startswith("probability_"))
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol)
    decided = decided_rows(want)
    np.testing.assert_array_equal(got["prediction"][decided],
                                  want["prediction"][decided])
    return decided


def decided_rows(want):
    keys = sorted(k for k in want if k.startswith("probability_"))
    top = np.sort(np.stack([want[k] for k in keys], axis=1), axis=1)
    if len(keys) == 2:
        return np.abs(want["probability_1"] - 0.5) > PRED_MARGIN
    return top[:, -1] - top[:, -2] > PRED_MARGIN


def assert_folds_agree(got, want, lin_atol):
    from transmogrifai_tpu_torch.testing import selection_gaps
    return selection_gaps(got, want, lambda family, hyper, ref: (
        lin_atol if family in ("OpLogisticRegression", "OpLinearSVC")
        else TREE_FOLD_ATOL))


def test_generator_is_seeded_and_plain_python():
    a, b = leads_records(64, 11), leads_records(64, 11)
    assert a == b and records_sha256(a) == records_sha256(b)
    assert records_sha256(leads_records(64, 12)) != records_sha256(a)
    for r in a:
        json.dumps(r)                        # python values only
        assert r["Stage"] in ("Open", "Working", "Nurturing", "Qualified")
        assert r["Converted"] in (0.0, 1.0)
        assert r["Location"] is None or len(r["Location"]) == 3


@pytest.fixture(scope="module", params=sorted(PATHS.values()))
def small(request):
    """Both packages' leads workflows for the label ``request.param``
    trained on ``leads_records(SMALL_ROWS, SMALL_SEED)``."""
    label = request.param
    recs = leads_records(SMALL_ROWS, SMALL_SEED)
    models = SMALL_MODELS[label]
    jwf, jy, jpred, jres = jax_leads_workflow(recs, label, models)
    jm = jwf.train()
    pwf, py, ppred, pres = port_leads_workflow(recs, label, models)
    pm = pwf.train()
    return SimpleNamespace(label=label, recs=recs, jwf=jwf, jm=jm,
                           jpred=jpred, jres=jres, pwf=pwf, pm=pm,
                           ppred=ppred, pres=pres,
                           score=leads_records(300, 5))


def test_small_train_same_vector_checks_and_selection(small):
    from transmogrifai_tpu_torch.testing import assert_same_sanity
    jsc, psc = (_stage(m, "SanityCheckerModel") for m in (small.jm,
                                                           small.pm))
    vec = psc.input_features[1].name
    assert vec == jsc.input_features[1].name
    jv, pv = small.jm.train_table[vec], small.pm.train_table[vec]
    np.testing.assert_array_equal(host(pv.values), host(jv.values))
    assert vector_meta_json(pv.metadata["vector_meta"]) == \
        vector_meta_json(jv.metadata["vector_meta"])
    groupings = {c.grouping for c in pv.metadata["vector_meta"].columns
                 if c.parent_feature_name == "Milestones"}
    assert groupings == {"first_call", "demo", "quote"}
    assert_same_sanity(sanity_summary(psc), sanity_summary(jsc))
    got = selection_summary(_stage(small.pm, "SelectedModel").summary)
    want = selection_summary(_stage(small.jm, "SelectedModel").summary)
    gaps = assert_folds_agree(got, want, SMALL_LIN_FOLD_ATOL)
    print(f"{small.label}: fold metric gaps (largest, share of the limit) "
          f"{gaps}")
    assert reference_date_ms(small.pm) == reference_date_ms(small.jm) \
        == LEADS_CLOCK_MS


def test_small_train_scores_agree(small):
    jo = small.jm.score(df=pd.DataFrame(small.score))
    po = small.pm.score(data=small.score)
    want = prediction_parts(jo, small.jpred)
    got = prediction_parts(po, small.ppred)
    decided = assert_scores_agree(got, want, SMALL_PROB_ATOL)
    if small.label == "Stage":
        js = host(jo[small.jres[1].name].values)
        ps = host(po[small.pres[1].name].values)
        np.testing.assert_array_equal(ps[decided], js[decided])
        assert set(ps) <= {"Open", "Working", "Nurturing", "Qualified"}


def test_small_score_function_per_row(small):
    """Request rows without the label score as in the JAX package's row
    scorer: the label is extracted as missing (an indexed label is then
    the unseen index in both), and the prediction and the predicted stage
    are the JAX package's and those of the batch. A row needs every
    training key of the date map (its key space is the batch's,
    ``test_date_map_key_space_is_taken_per_batch``): in both packages a
    row without one raises."""
    full = [r for r in small.score if len(r["Milestones"]) == 3][:12]
    rows = [{k: v for k, v in r.items() if k not in ("Converted", "Stage")}
            for r in full]
    batch = small.pm.score(data=full)
    fn, jfn = small.pm.score_function(), small.jm.score_function()
    probs = prediction_parts(batch, small.ppred)
    for i, row in enumerate(rows):
        out, want = fn(row), jfn(row)
        assert out[small.ppred.name]["prediction"] == probs["prediction"][i]
        assert out[small.ppred.name]["prediction"] == \
            want[small.jpred.name]["prediction"]
        assert out[small.ppred.name]["probability_1"] == pytest.approx(
            float(probs["probability_1"][i]), abs=1e-7)
        assert out[small.ppred.name]["probability_1"] == pytest.approx(
            want[small.jpred.name]["probability_1"], abs=SMALL_PROB_ATOL)
        if small.label == "Stage":
            assert out[small.pres[1].name] == want[small.jres[1].name] == \
                host(batch[small.pres[1].name].values)[i]
    short = dict(rows[0], Milestones={})
    with pytest.raises(IndexError):
        jfn(short)
    with pytest.raises(IndexError):
        fn(short)


def test_small_batch_score_without_the_label(small):
    """A batch table without the label column scores as in the JAX
    package: the indexed label's stage reads the label, and raises
    KeyError in both (path b); path (a)'s stages never read it, and both
    score the batch alike."""
    from transmogrifai_tpu.readers.readers import dataframe_to_table
    from transmogrifai_tpu_torch.readers.readers import Frame, frame_to_table
    rows = [{k: v for k, v in r.items() if k != small.label}
            for r in small.score[:64]]
    jt = dataframe_to_table(pd.DataFrame(rows), [
        f for f in small.jm.raw_features if not f.is_response])
    pt = frame_to_table(Frame.of(rows), small.pm.raw_features,
                        require_response=False)
    assert small.label not in pt
    if small.label == "Stage":
        with pytest.raises(KeyError):
            small.jm.score(table=jt)
        with pytest.raises(KeyError):
            small.pm.score(table=pt)
        return
    got = prediction_parts(small.pm.score(table=pt), small.ppred)
    want = prediction_parts(small.jm.score(table=jt), small.jpred)
    assert_scores_agree(got, want, SMALL_PROB_ATOL)


def test_small_sweep_again_repeats_the_train(small):
    """``testing.sweep_again`` on ``selection_rows`` runs a trained
    model's sweep again from its train table: as trained it gives the
    train's fold metrics bit for bit (path (a)'s LR, path (b)'s RF); path
    (a)'s LR also runs in float64 (the evaluation ``chip_smoke.py`` holds
    the card's leads sweeps to), to finite metrics of the same shape."""
    from transmogrifai_tpu_torch.testing import selection_rows, sweep_again
    selector = small.ppred.origin_stage
    family = ("OpLogisticRegression" if small.label == "Converted"
              else "OpRandomForestClassifier")
    want = next(r.fold_metrics for r in _stage(
        small.pm, "SelectedModel").summary.validation_results
        if r.family == family)
    X, y = selection_rows(selector, small.pm.train_table)
    again = sweep_again(selector, X, y, {family})
    np.testing.assert_array_equal(again[family].astype(np.float32),
                                  np.asarray(want, np.float32))
    if small.label == "Converted":
        f64 = sweep_again(selector, X.double(), y.double(), {family})[family]
        assert f64.shape == again[family].shape
        assert np.isfinite(f64).all()


def test_small_saves_cross_both_packages(small, tmp_path):
    """JAX save -> port load (the stage label's lambda from the port's
    workflow) and port save -> JAX load score as the trained models; the
    port's plan holds the JAX package's stages, classes and state keys;
    the port's reload scores bit for bit."""
    import transmogrifai_tpu_torch as port
    from test_torch_serve import save_jax_model
    jpath, ppath = str(tmp_path / "jax"), str(tmp_path / "port")
    save_jax_model(small.jm, jpath)
    small.pm.save(ppath)
    if small.label == "Stage":
        with pytest.raises(ValueError, match="unserializable state"):
            port.load_model(jpath, device="cpu")
    want = prediction_parts(small.jm.score(df=pd.DataFrame(small.score)),
                            small.jpred)
    loaded = port.load_model(jpath, device="cpu", workflow=small.pwf)
    got = prediction_parts(loaded.score(data=small.score), small.ppred)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
    jl = jax_load_model(ppath, workflow=small.jwf)
    back = prediction_parts(jl.score(df=pd.DataFrame(small.score)),
                            small.jpred)
    mine = prediction_parts(small.pm.score(data=small.score), small.ppred)
    for k in mine:
        np.testing.assert_allclose(back[k], mine[k], rtol=0, atol=1e-6)
    again = port.load_model(ppath, device="cpu", workflow=small.pwf)
    re = prediction_parts(again.score(data=small.score), small.ppred)
    assert all(np.array_equal(re[k], mine[k]) for k in mine)

    def layout(path):
        with open(os.path.join(path, "plan.json")) as fh:
            plan = json.load(fh)
        return [(d["module"], d["className"], d["uid"], sorted(d["state"]))
                for d in plan["stages"] + plan["rawFeatureGenerators"]]
    jax_only = {"SanityCheckerModel": {"_stats_input_sharding"}}
    assert [(m, c, u, sorted(set(s) - jax_only.get(c, set())))
            for m, c, u, s in layout(jpath)] == layout(ppath)


@pytest.mark.parametrize("small", ["Converted"], indirect=True)
def test_small_model_insights_match_jax(small):
    from transmogrifai_tpu_torch.testing import (
        insight_limits, insights_by_feature, json_gaps,
    )
    want = small.jm.model_insights().to_json()
    got = small.pm.model_insights().to_json()
    winner = _stage(small.pm, "SelectedModel").summary.best_model_type
    json_gaps(insights_by_feature(got), insights_by_feature(want),
              insight_limits(winner, want, fold_atol=SMALL_LIN_FOLD_ATOL))
    names = {f["feature_name"] for f in got["features"]}
    assert {"Milestones", "Offices", "Notes", "Activities"} <= names


@pytest.mark.parametrize("small", ["Converted"], indirect=True)
def test_date_map_key_space_is_taken_per_batch(small):
    """A scoring batch in which no row holds a ``Milestones`` key of the
    training data gives a narrower date-map block; the SanityChecker's
    kept indices then run past its metadata, and both packages raise the
    same IndexError (the JAX package's behaviour, kept)."""
    rows = [dict(r, Milestones={k: v for k, v in r["Milestones"].items()
                                if k != "quote"}) for r in small.score]
    with pytest.raises(IndexError, match="tuple index out of range"):
        small.jm.score(df=pd.DataFrame(rows))
    with pytest.raises(IndexError, match="tuple index out of range"):
        small.pm.score(data=rows)


def test_raw_feature_filter_on_the_new_types():
    """``RawFeatureFilter`` on a leads table against the JAX filter: each
    map key its own distribution, the same JS divergences, fill rates,
    exclusions and excluded map keys; a scoring table whose ``Location``
    moved, whose ``Scores`` lost a key and whose ``Visits`` grew tenfold
    (the filter drops those keys)."""
    from test_torch_raw_feature_filter import assert_same_results
    from transmogrifai_tpu.filters import RawFeatureFilter as JRFF
    from transmogrifai_tpu_torch.filters import RawFeatureFilter as PRFF
    from transmogrifai_tpu_torch.readers.readers import Frame, frame_to_table
    from transmogrifai_tpu.readers.readers import dataframe_to_table
    train = leads_records(400, 6)
    score = leads_records(400, 7)
    for r in score:
        if r["Location"] is not None:
            r["Location"] = [r["Location"][0] / 2, r["Location"][1] + 20,
                             r["Location"][2]]
        r["Scores"].pop("s5", None)
        r["Visits"] = {k: v * 10 for k, v in r["Visits"].items()}
    jwf, _, _, _ = jax_leads_workflow(train, "Converted")
    pwf, _, _, _ = port_leads_workflow(train, "Converted", None)
    kw = dict(max_js_divergence=0.5, max_correlation=0.8,
              min_fill_rate=0.02)
    jfeats = sorted(jwf.raw_features, key=lambda f: f.name)
    pfeats = sorted(pwf.raw_features, key=lambda f: f.name)
    assert [f.name for f in pfeats] == [f.name for f in jfeats]
    jt = dataframe_to_table(pd.DataFrame(train), jfeats)
    js = dataframe_to_table(pd.DataFrame(score),
                            [f for f in jfeats if not f.is_response])
    pt = frame_to_table(Frame.of(train), pfeats)
    ps = frame_to_table(Frame.of(score), pfeats, require_response=False)
    _, jbl, jres = JRFF(score_table=js, **kw).filter_raw(jt, jfeats)
    _, pbl, pres = PRFF(score_table=ps, device="cpu", **kw).filter_raw(
        pt, pfeats)
    assert_same_results(pres.to_json(), jres.to_json())
    assert [f.name for f in pbl] == [f.name for f in jbl]
    names = {m.full_name for m in pres.metrics}
    assert {"Scores[s0]", "Milestones[quote]", "Offices[hq]"} <= names
    assert pres.excluded_map_keys["Visits"] == ["email", "web"]


# ---------------------------------------------------------------------------
# The committed fixtures
# ---------------------------------------------------------------------------

def _fixture(name):
    with open(os.path.join(FIXTURES, name, "fixture.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("name", sorted(PATHS))
def test_port_rebuilds_the_fixture_records(name):
    fx = _fixture(name)
    for key, rows, seed in (("train_records", LEADS_ROWS, LEADS_SEED),
                            ("score_records", LEADS_SCORE_ROWS,
                             LEADS_SCORE_SEED)):
        assert (fx[key]["rows"], fx[key]["seed"]) == (rows, seed)
        assert records_sha256(leads_records(rows, seed)) == \
            fx[key]["sha256"]
    assert fx["clock_ms"] == fx["reference_date_ms"] == LEADS_CLOCK_MS


def test_port_vectorizes_and_checks_the_fixture_records():
    """The port's transmogrify and SanityChecker on path (a)'s 20,000
    records on the CPU: the JAX package's metadata, sampled rows bit for
    bit, kept slots and reasons."""
    from transmogrifai_tpu_torch.dag import compute_dag, fit_and_transform_dag
    from transmogrifai_tpu_torch.testing import assert_same_sanity
    fx = _fixture("leads")
    wf, _, _, _ = port_leads_workflow(leads_records(LEADS_ROWS, LEADS_SEED),
                                      "Converted", None)
    sc_stage = next(s for s in wf.stages
                    if type(s).__name__ == "SanityChecker")
    table = wf.reader.generate_table(wf.raw_features).to_device("cpu")
    out, fitted = fit_and_transform_dag(
        table, compute_dag([sc_stage.get_output()]))
    vec = out[sc_stage.input_features[1].name]
    assert vector_meta_json(vec.metadata["vector_meta"]) == fx["vector"]
    sample = np.load(os.path.join(FIXTURES, "leads", "vector_sample.npz"))
    np.testing.assert_array_equal(host(vec.values)[sample["rows"]],
                                  sample["X"])
    assert_same_sanity(sanity_summary(fitted[sc_stage.uid]), fx["sanity"])


@pytest.mark.parametrize("name", sorted(PATHS))
def test_committed_model_scores_in_both_packages(name):
    """The JAX-saved model of each path scores the 4,096 scoring records
    in the JAX package as it did when saved, and in the port within
    FIXTURE_PROB_ATOL (the deindexed stage equal where decided)."""
    import transmogrifai_tpu_torch as port
    fx = _fixture(name)
    label = PATHS[name]
    exp = np.load(os.path.join(FIXTURES, name, "expected.npz"))
    path = os.path.join(FIXTURES, name, "model")
    score = leads_records(LEADS_SCORE_ROWS, LEADS_SCORE_SEED)
    want = {k: exp[k] for k in exp.files if k not in ("key", "stage")}
    jwf, _, jpred, jres = jax_leads_workflow(score, label)
    jm = jax_load_model(path, workflow=jwf)
    jo = jm.score(df=pd.DataFrame(score))
    for k, v in prediction_parts(jo, jpred).items():
        if k in want:
            np.testing.assert_array_equal(v, want[k])
    pwf, _, ppred, pres = port_leads_workflow(score, label, None)
    pm = port.load_model(path, device="cpu", workflow=pwf)
    scored = pm.score(data=score)
    got = prediction_parts(scored, ppred)
    decided = assert_scores_agree(got, want, FIXTURE_PROB_ATOL)
    assert [r["LeadId"] for r in score] == exp["key"].tolist()
    if label == "Stage":
        stages = host(scored[pres[1].name].values)
        np.testing.assert_array_equal(stages[decided],
                                      exp["stage"][decided])
    assert _stage(pm, "SelectedModel").fitted.family == \
        fx["selection"]["winner"]
    assert reference_date_ms(pm) == fx["reference_date_ms"]


@pytest.mark.parametrize("name", sorted(PATHS))
def test_fixture_stays_small(name):
    d = os.path.join(FIXTURES, name)
    total = sum(os.path.getsize(os.path.join(root, f))
                for root, _, files in os.walk(d) for f in files)
    assert total < 5 * 2 ** 20, total


# ---------------------------------------------------------------------------
# Writing the committed fixtures (JAX package, CPU)
# ---------------------------------------------------------------------------

def generate_fixture(name: str, out_dir: str = None,
                     rows: int = LEADS_ROWS) -> None:
    """Train the JAX package's leads workflow for ``name`` (``PATHS``) on
    ``leads_records(LEADS_ROWS, LEADS_SEED)`` with the date clock at
    ``LEADS_CLOCK_MS``, score ``leads_records(LEADS_SCORE_ROWS,
    LEADS_SCORE_SEED)``, and write the fixture: ``fixture.json`` (both
    record sets' sha256, the clock and the fitted ``reference_date_ms``,
    the vector's metadata, the SanityChecker's choices, the selection, the
    train's seconds), ``vector_sample.npz`` (the vector at
    ``SAMPLE_ROWS`` seeded rows), ``expected.npz`` (the scores, the keys
    and, for ``leads_stage``, the deindexed stages), ``insights.json``
    (``leads`` only: ``model_insights().to_json()``) and ``model/`` (the
    saved workflow without its drift baseline)."""
    import time

    from test_torch_serve import drop_drift_baseline, save_jax_model

    os.environ["TG_FAST_GRIDS"] = "0"
    label = PATHS[name]
    out_dir = out_dir or os.path.join(FIXTURES, name)
    train = leads_records(rows, LEADS_SEED)
    score = leads_records(LEADS_SCORE_ROWS, LEADS_SCORE_SEED)
    wf, _, pred, results = jax_leads_workflow(train, label,
                                              LEADS_PATHS[name][1])
    t0 = time.perf_counter()
    model = wf.train()
    secs = time.perf_counter() - t0
    sc = _stage(model, "SanityCheckerModel")
    vec = model.train_table[sc.input_features[1].name]
    idx = np.sort(np.random.RandomState(SAMPLE_SEED).choice(
        rows, SAMPLE_ROWS, replace=False))
    scored = model.score(df=pd.DataFrame(score))
    parts = prediction_parts(scored, pred)
    expected = {k: v for k, v in parts.items()
                if k == "prediction" or k.startswith("probability_")}
    expected["key"] = np.array([r["LeadId"] for r in score], dtype=str)
    if label != "Converted":
        expected["stage"] = np.array(
            list(host(scored[results[1].name].values)), dtype=str)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    path = os.path.join(out_dir, "model")
    save_jax_model(model, path)
    drop_drift_baseline(path)
    np.savez_compressed(os.path.join(out_dir, "vector_sample.npz"),
                        rows=idx, X=np.asarray(vec.values)[idx])
    np.savez_compressed(os.path.join(out_dir, "expected.npz"), **expected)
    if label == "Converted":
        with open(os.path.join(out_dir, "insights.json"), "w") as fh:
            json.dump(model.model_insights().to_json(), fh, indent=1)
    with open(os.path.join(out_dir, "fixture.json"), "w") as fh:
        json.dump({
            "train_records": {"rows": rows, "seed": LEADS_SEED,
                              "sha256": records_sha256(train)},
            "score_records": {"rows": LEADS_SCORE_ROWS,
                              "seed": LEADS_SCORE_SEED,
                              "sha256": records_sha256(score)},
            "clock_ms": LEADS_CLOCK_MS,
            "reference_date_ms": reference_date_ms(model),
            "label": label,
            "train_seconds_jax_cpu": secs,
            "vector": vector_meta_json(vec.metadata["vector_meta"]),
            "sanity": sanity_summary(sc),
            "selection": selection_summary(
                _stage(model, "SelectedModel").summary),
        }, fh, indent=1)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    for _name in sys.argv[1:] or list(PATHS):
        generate_fixture(_name)
