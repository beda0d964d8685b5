"""The customer-event workflow of the PyTorch port against the JAX
package: event files aggregated per user by ``AggregateDataReader`` at a
cutoff and joined to a users file by ``JoinedDataReader``; the scalers,
bucketizers and the percentile calibrator; ``transmogrify``, the
SanityChecker and the binary selector over GBT and RF
(``testing.events_dag``, ``testing.events_reader``).

The small train runs both packages on ``testing.events_files`` of
``SMALL_USERS`` users with the selector pinned to small trees. The
committed fixture ``transmogrifai_tpu_torch/fixtures/events`` holds what
the JAX package made of ``events_files(EVENTS_USERS, EVENTS_SEED)``
(the card has no JAX and no pandas: ``chip_smoke.py`` trains the port on
the same files and holds it to the fixture); here the port rebuilds the
files, aggregates them to the fixture's raw table, and turns the sampled
users into the fixture's vector rows with the JAX-saved model. This
file's ``__main__`` writes the fixture (JAX package, CPU)::

    python tests/test_torch_events_e2e.py

Tolerances, stated once:

* the raw table (keys, order, values, nulls), the vector, its metadata,
  the fitted scalers, bucketizers and calibrator and the SanityChecker's
  choices: equal (bit for bit);
* fold metrics 1e-5 (``TREE_FOLD_ATOL``); ``probability_1`` 1e-5
  (``PROB_ATOL``); the prediction equal wherever probability_1 is more
  than 1e-5 from 0.5.
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
import pytest
import jax  # noqa: F401
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import transmogrifai_tpu as tg  # noqa: E402
import transmogrifai_tpu.dsl  # noqa: E402,F401  (attaches the JAX DSL)
import transmogrifai_tpu.models.trees  # noqa: E402,F401  (registers)
from transmogrifai_tpu.features import reset_uids as jax_reset  # noqa: E402
from transmogrifai_tpu.persistence import (  # noqa: E402
    load_model as jax_load_model,
)
from transmogrifai_tpu_torch.testing import (  # noqa: E402
    EVENTS_SCORE_SEED, EVENTS_SCORE_USERS, EVENTS_SEED, EVENTS_USERS,
    events_dag, events_files, events_loco_sample, events_reader,
    events_workflow, files_sha256, fitted_values, sanity_summary,
    selection_summary, table_digest,
)

FIXTURE = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures",
                       "events")
SAMPLE_ROWS, SAMPLE_SEED = 256, 0
PROB_ATOL = 1e-5
PRED_MARGIN = 1e-5
TREE_FOLD_ATOL = 1e-5
SMALL_USERS, SMALL_SEED = 800, 3
SMALL_MODELS = [
    ("OpGBTClassifier", [{"maxDepth": 3, "maxIter": 5, "stepSize": 0.1}]),
    ("OpRandomForestClassifier", [{"maxDepth": 4, "numTrees": 5}]),
]
LOCO_TOP_K = 20


def jax_namespace():
    """``events_dag``'s and ``events_reader``'s names from the JAX
    package."""
    from transmogrifai_tpu import aggregators
    from transmogrifai_tpu.features import FeatureBuilder
    from transmogrifai_tpu.impl.selector import factories
    from transmogrifai_tpu.readers import aggregates
    from transmogrifai_tpu.readers.readers import CSVReader
    return SimpleNamespace(
        FeatureBuilder=FeatureBuilder, aggregators=aggregators,
        aggregates=aggregates, CSVReader=CSVReader,
        transmogrify=tg.transmogrify,
        BinaryClassificationModelSelector=(
            factories.BinaryClassificationModelSelector))


def jax_events_workflow(events_path, users_path, models=None, seed=42):
    """(workflow, label, prediction, results): the JAX package's events
    workflow, built after ``reset_uids``."""
    from transmogrifai_tpu.workflow import OpWorkflow
    jax_reset()
    ns = jax_namespace()
    results, y, pred = events_dag(ns, models, seed)
    wf = (OpWorkflow().set_reader(events_reader(ns, events_path,
                                                users_path))
          .set_result_features(*results))
    return wf, y, pred, results


def host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def vector_meta_json(vm):
    return {"name": vm.name,
            "columns": [dataclasses.asdict(c) for c in vm.columns]}


def _stage(model, name):
    return next(s for s in model.stages if type(s).__name__ == name)


def prediction_parts(table, feature):
    col = table[feature.name]
    vals = host(col.values)
    return {k: vals[:, i] for i, k in enumerate(col.metadata["keys"])}


def block_sha256(vals) -> str:
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(
        vals, dtype=np.float32).tobytes()).hexdigest()


def vector_blocks(table):
    out = {}
    for name in table.column_names:
        vm = table[name].metadata.get("vector_meta")
        if vm is not None:
            out[name] = (host(table[name].values), vector_meta_json(vm))
    return out


def jax_loco_diffs(loco, table):
    """(group names, (g, n) diffs) of the JAX package's
    ``RecordInsightsLOCO`` on ``table``: its ``transform_column`` up to
    the top-k step, with its chunking (the JAX CPU forest sums its trees
    in a GEMM whose blocking depends on the row count, so the chunks must
    be the same)."""
    import jax.numpy as jnp
    from transmogrifai_tpu.insights.record_insights import _score_of
    from transmogrifai_tpu.models.api import MODEL_REGISTRY
    col = table[loco.input_features[0].name]
    X = np.asarray(col.values, dtype=np.float32)
    n, d = X.shape
    groups = loco._groups(col.metadata.get("vector_meta"), d)
    g = len(groups)
    fitted = loco.model_stage.fitted
    family = MODEL_REGISTRY[fitted.family]
    Xd = jnp.asarray(X)
    base = _score_of(family.predict_one(fitted, Xd))
    keep = np.ones((g, d), np.float32)
    for v, (_, idxs) in enumerate(groups):
        keep[v, idxs] = 0.0
    keep_d = jnp.asarray(keep)
    rows_per_block = max(1, int(loco.VARIANT_BLOCK_BYTES // (4 * d)))
    gc = max(1, min(g, rows_per_block // max(n, 1)) or 1)
    rc = min(n, rows_per_block)
    diffs = np.empty((g, n), np.float32)
    for g0 in range(0, g, gc):
        g1 = min(g0 + gc, g)
        for r0 in range(0, n, rc):
            r1 = min(r0 + rc, n)
            block = Xd[None, r0:r1, :] * keep_d[g0:g1, None, :]
            s = _score_of(family.predict_one(
                fitted, block.reshape((g1 - g0) * (r1 - r0), d)))
            diffs[g0:g1, r0:r1] = base[None, r0:r1] - s.reshape(
                g1 - g0, r1 - r0)
    return [name for name, _ in groups], diffs


def _fixture():
    with open(os.path.join(FIXTURE, "fixture.json")) as fh:
        return json.load(fh)


def test_generator_is_seeded(tmp_path):
    a = events_files(str(tmp_path / "a"), 200, 5)
    b = events_files(str(tmp_path / "b"), 200, 5)
    c = events_files(str(tmp_path / "c"), 200, 6)
    assert files_sha256(*a) == files_sha256(*b) != files_sha256(*c)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """Both packages' events workflows trained on ``SMALL_USERS``
    users."""
    d = tmp_path_factory.mktemp("events_small")
    e, u = events_files(str(d / "train"), SMALL_USERS, SMALL_SEED)
    se, su = events_files(str(d / "score"), 300, SMALL_SEED + 1)
    jwf, jy, jpred, jres = jax_events_workflow(e, u, SMALL_MODELS)
    jm = jwf.train()
    pwf, py, ppred, pres = events_workflow(e, u, SMALL_MODELS, device="cpu")
    pm = pwf.train()
    return SimpleNamespace(jwf=jwf, jm=jm, jpred=jpred, jres=jres, pwf=pwf,
                           pm=pm, ppred=ppred, pres=pres,
                           score=(se, su), jns=jax_namespace())


def test_small_raw_table_vector_fits_and_selection(small):
    """The joined raw table, every vector block and its metadata, the
    fitted scalers, bucketizers and calibrator, the SanityChecker's
    choices and the selection, against the JAX package's."""
    from transmogrifai_tpu_torch.testing import (
        assert_same_sanity, selection_gaps,
    )
    names = [f.name for f in small.pwf.raw_features]
    assert names == [f.name for f in small.jwf.raw_features]
    assert table_digest(small.pm.train_table, names) == \
        table_digest(small.jm.train_table, names)
    jb, pb = vector_blocks(small.jm.train_table), \
        vector_blocks(small.pm.train_table)
    assert sorted(jb) == sorted(pb)
    for name, (vals, meta) in jb.items():
        np.testing.assert_array_equal(pb[name][0], vals, err_msg=name)
        assert pb[name][1] == meta, name
    assert fitted_values(small.pm) == fitted_values(small.jm)
    assert_same_sanity(sanity_summary(_stage(small.pm, "SanityCheckerModel")),
                       sanity_summary(_stage(small.jm, "SanityCheckerModel")))
    got = selection_summary(_stage(small.pm, "SelectedModel").summary)
    want = selection_summary(_stage(small.jm, "SelectedModel").summary)
    assert got["winner"] == want["winner"]
    selection_gaps(got, want, lambda *a: TREE_FOLD_ATOL)


def test_small_scores_and_saves_agree(small, tmp_path):
    """Both packages score the scoring cohort through their readers
    within PROB_ATOL; the JAX save loads in the port (its aggregators and
    lambdas resolved from the port's workflow) and scores as the JAX
    model does, and the port's save loads in the JAX package."""
    import transmogrifai_tpu_torch as port
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_serve import save_jax_model
    from transmogrifai_tpu_torch.testing import port_events_namespace
    se, su = small.score
    jreader = events_reader(small.jns, se, su)
    preader = events_reader(port_events_namespace(), se, su)
    want = prediction_parts(small.jm.score(
        table=jreader.generate_table(small.jm.raw_features)), small.jpred)
    got = prediction_parts(small.pm.score(reader=preader), small.ppred)
    np.testing.assert_allclose(got["probability_1"], want["probability_1"],
                               rtol=0, atol=PROB_ATOL)
    jpath, ppath = str(tmp_path / "jax"), str(tmp_path / "port")
    save_jax_model(small.jm, jpath)
    small.pm.save(ppath)
    loaded = port.load_model(jpath, device="cpu", workflow=small.pwf)
    gen = next(f.origin_stage for f in loaded.raw_features
               if f.name == "spendByCategory")
    assert type(gen.aggregator).__name__ == "UnionMap"
    assert type(gen.aggregator.element).__name__ == "Sum"
    assert gen.aggregate_window == 90 * 86_400_000
    re = prediction_parts(loaded.score(reader=preader), small.ppred)
    np.testing.assert_allclose(re["probability_1"], want["probability_1"],
                               rtol=0, atol=PROB_ATOL)
    back = jax_load_model(ppath, workflow=small.jwf)
    jgen = next(f.origin_stage for f in back.raw_features
                if f.name == "spendByCategory")
    assert type(jgen.aggregator).__module__ == "transmogrifai_tpu.aggregators"
    bk = prediction_parts(back.score(
        table=jreader.generate_table(back.raw_features)), small.jpred)
    np.testing.assert_allclose(bk["probability_1"], got["probability_1"],
                               rtol=0, atol=PROB_ATOL)


# ---------------------------------------------------------------------------
# The committed fixture
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("events_fixture")
    return (events_files(str(d / "train"), EVENTS_USERS, EVENTS_SEED),
            events_files(str(d / "score"), EVENTS_SCORE_USERS,
                         EVENTS_SCORE_SEED))


def test_port_rebuilds_the_fixture_files(fixture_files):
    fx = _fixture()
    (e, u), (se, su) = fixture_files
    assert files_sha256(e, u) == fx["train_files"]["sha256"]
    assert files_sha256(se, su) == fx["score_files"]["sha256"]


def test_raw_table_and_sampled_vector_match_the_fixture(fixture_files):
    """The port aggregates and joins the fixture's 20,000 users to the
    fixture's raw table (keys, order, every column, the nulls), and the
    JAX-saved model turns the 256 sampled users into the fixture's
    vector rows and metadata bit for bit."""
    import transmogrifai_tpu_torch as port
    fx = _fixture()
    (e, u), _ = fixture_files
    pwf, _, _, _ = events_workflow(e, u, device="cpu")
    raw = pwf.reader.generate_table(pwf.raw_features)
    names = [f.name for f in pwf.raw_features]
    assert table_digest(raw, names) == fx["raw_digest"]
    sample = np.load(os.path.join(FIXTURE, "vector_sample.npz"))
    pm = port.load_model(os.path.join(FIXTURE, "model"), device="cpu",
                         workflow=pwf)
    scored = pm.score(table=raw.take(sample["rows"]))
    vec = scored[_stage(pm, "SanityCheckerModel").input_features[1].name]
    assert vector_meta_json(vec.metadata["vector_meta"]) == fx["vector"]
    np.testing.assert_array_equal(host(vec.values), sample["X"])
    assert fitted_values(pm) == {k: v for k, v in json.loads(
        json.dumps(fx["fitted"])).items()}


def test_committed_model_scores_as_saved(fixture_files):
    """The JAX-saved model scores the scoring cohort in the port within
    PROB_ATOL of the JAX package's scores at save time."""
    import transmogrifai_tpu_torch as port
    fx = _fixture()
    (e, u), (se, su) = fixture_files
    exp = np.load(os.path.join(FIXTURE, "expected.npz"))
    pwf, _, ppred, _ = events_workflow(e, u, device="cpu")
    pm = port.load_model(os.path.join(FIXTURE, "model"), device="cpu",
                         workflow=pwf)
    from transmogrifai_tpu_torch.testing import port_events_namespace
    scored = pm.score(reader=events_reader(port_events_namespace(), se, su))
    got = prediction_parts(scored, ppred)
    np.testing.assert_allclose(got["probability_1"], exp["probability_1"],
                               rtol=0, atol=PROB_ATOL)
    assert [str(k) for k in scored.key] == exp["key"].tolist()
    assert _stage(pm, "SelectedModel").fitted.family == \
        fx["selection"]["winner"]


def test_new_modules_load_without_jax_or_pandas(tmp_path):
    """The aggregating readers, Avro, the runner, record insights, the
    testkit, the specs, the examples and the streaming, robustness and
    fidelity modules in a process of their own: the events of 50 users
    aggregate, join and write to Avro and CSV with no jax, pandas or JAX
    package module loaded."""
    import subprocess
    code = (
        "import sys\n"
        "import transmogrifai_tpu_torch.runner as R\n"
        "import transmogrifai_tpu_torch.insights.record_insights\n"
        "import transmogrifai_tpu_torch.testkit, transmogrifai_tpu_torch.test.specs\n"
        "import transmogrifai_tpu_torch.examples.iris, "
        "transmogrifai_tpu_torch.examples.boston, "
        "transmogrifai_tpu_torch.examples.dataprep\n"
        "import transmogrifai_tpu_torch.streaming, "
        "transmogrifai_tpu_torch.robustness, "
        "transmogrifai_tpu_torch.utils.fidelity\n"
        "from transmogrifai_tpu_torch.testing import events_files, "
        "events_workflow\n"
        f"e, u = events_files({str(tmp_path)!r}, 50, 2)\n"
        "wf, y, pred, res = events_workflow(e, u, device='cpu')\n"
        "t = wf.reader.generate_table(wf.raw_features)\n"
        "assert t.num_rows == 50\n"
        f"R.write_scores(R.table_to_frame(t), {str(tmp_path / 'r.avro')!r})\n"
        f"R.write_scores(R.table_to_frame(t), {str(tmp_path / 'r.csv')!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'pandas', 'transmogrifai_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr


def test_fixture_stays_small():
    total = sum(os.path.getsize(os.path.join(root, f))
                for root, _, files in os.walk(FIXTURE) for f in files)
    assert total < 5 * 2 ** 20, total


# ---------------------------------------------------------------------------
# Writing the committed fixture (JAX package, CPU)
# ---------------------------------------------------------------------------

def generate_fixture(out_dir: str = None, users: int = EVENTS_USERS) -> None:
    """Train the JAX package's events workflow on ``events_files(users,
    EVENTS_SEED)``, score ``events_files(EVENTS_SCORE_USERS,
    EVENTS_SCORE_SEED)`` and write the fixture: ``fixture.json`` (the
    files' sha256, the raw table's digest, the vector's metadata, every
    block's sha256, the fitted host stages, the SanityChecker's choices,
    the selection, LOCO's group names, the written records of the sampled
    scoring rows, the train's seconds), ``vector_sample.npz``,
    ``loco.npz`` (the sampled scoring rows' LOCO diffs), ``expected.npz``
    (the scores and keys) and ``model/``."""
    import tempfile
    import time

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_serve import drop_drift_baseline, save_jax_model
    from transmogrifai_tpu.insights.record_insights import (
        RecordInsightsLOCO,
    )
    from transmogrifai_tpu.runner import table_to_dataframe

    out_dir = out_dir or FIXTURE
    tmp = tempfile.mkdtemp()
    e, u = events_files(os.path.join(tmp, "train"), users, EVENTS_SEED)
    se, su = events_files(os.path.join(tmp, "score"), EVENTS_SCORE_USERS,
                          EVENTS_SCORE_SEED)
    wf, _, pred, results = jax_events_workflow(e, u)
    t0 = time.perf_counter()
    model = wf.train()
    secs = time.perf_counter() - t0
    names = [f.name for f in wf.raw_features]
    sc = _stage(model, "SanityCheckerModel")
    table = model.train_table
    vec = table[sc.input_features[1].name]
    blocks = vector_blocks(table)
    idx = np.sort(np.random.RandomState(SAMPLE_SEED).choice(
        users, SAMPLE_ROWS, replace=False))
    ns = jax_namespace()
    score_raw = events_reader(ns, se, su).generate_table(model.raw_features)
    scored = model.score(table=score_raw)
    parts = prediction_parts(scored, pred)
    expected = {k: v for k, v in parts.items()
                if k == "prediction" or k.startswith("probability_")}
    expected["key"] = np.array([str(k) for k in scored.key], dtype=str)
    selected = _stage(model, "SelectedModel")
    loco = RecordInsightsLOCO(selected, top_k=LOCO_TOP_K).set_input(
        selected.input_features[1])
    group_names, diffs = jax_loco_diffs(loco, scored)
    rows = events_loco_sample(len(scored.key))
    written = table_to_dataframe(scored).to_dict("records")
    keep = ["key"] + names + [pred.name]
    avro_sample = [{k: written[i][k] for k in keep} for i in rows]
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    path = os.path.join(out_dir, "model")
    save_jax_model(model, path)
    drop_drift_baseline(path)
    np.savez_compressed(os.path.join(out_dir, "vector_sample.npz"),
                        rows=idx, X=np.asarray(vec.values)[idx])
    np.savez_compressed(os.path.join(out_dir, "loco.npz"), rows=rows,
                        diffs=diffs[:, rows])
    np.savez_compressed(os.path.join(out_dir, "expected.npz"), **expected)
    with open(os.path.join(out_dir, "fixture.json"), "w") as fh:
        json.dump({
            "train_files": {"users": users, "seed": EVENTS_SEED,
                            "sha256": files_sha256(e, u)},
            "score_files": {"users": EVENTS_SCORE_USERS,
                            "seed": EVENTS_SCORE_SEED,
                            "sha256": files_sha256(se, su)},
            "train_seconds_jax_cpu": secs,
            "raw_digest": table_digest(table, names),
            "score_raw_digest": table_digest(score_raw, names),
            "vector": vector_meta_json(vec.metadata["vector_meta"]),
            "blocks": {name: block_sha256(vals)
                       for name, (vals, _) in blocks.items()},
            "fitted": fitted_values(model),
            "sanity": sanity_summary(sc),
            "selection": selection_summary(selected.summary),
            "loco": {"groups": group_names, "top_k": LOCO_TOP_K},
            "avro_sample": avro_sample,
        }, fh, indent=1, default=float)
    shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    generate_fixture()
