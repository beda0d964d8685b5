"""The multilingual support-ticket workflow of the PyTorch port against the
JAX package: the NLP stages (stemmed tokens, stop words, count vectors,
IDF, bigrams, word2vec, LDA), the language, entity, MIME, phone, email
and URL parsers and the text similarities through ``transmogrify``, the
SanityChecker and the binary selector (``testing.tickets_dag``).

The small train runs both packages on ``testing.tickets_records(600, 3)``
with the selector pinned to one small tree grid and one linear family,
word2vec at 10 steps and LDA at 2 sweeps (``SMALL_DAG``).
The committed fixture ``transmogrifai_tpu_torch/fixtures/tickets`` holds
what the JAX package made of ``tickets_records(TICKETS_ROWS,
TICKETS_SEED)`` with the default binary model list at full default grids
(the card has no JAX and no pandas, so ``chip_smoke.py`` trains the port
on the same records and holds it to the fixture); here the JAX-saved
model turns the fixture's 256 sampled records into its vector rows in
the port, and scores the scoring records in both packages, on the CPU.
This file's ``__main__`` writes the fixture (JAX package, CPU)::

    python tests/test_torch_tickets_e2e.py

Tolerances, stated once:

* the feature vector (word2vec and LDA blocks included), its metadata and
  the SanityChecker's choices: equal, the vector bit for bit (word2vec
  and LDA reproduce XLA's CPU arithmetic); a statistic quoted in a
  removal reason within 1e-12 absolute or 1e-4 relative
  (``testing.assert_same_sanity``);
* fold metrics: tree families 1e-5, the small train's linear sweep
  ``SMALL_LIN_FOLD_ATOL`` (2e-3, the cause at the constant);
* ``probability_*``: 1e-5 on the small train, 1e-6 for the committed
  model's scores; the prediction equal wherever probability_1 is more
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
import pandas as pd
import pytest
import jax  # noqa: F401
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import transmogrifai_tpu as tg  # noqa: E402
import transmogrifai_tpu.dsl  # noqa: E402,F401  (attaches the JAX DSL)
import transmogrifai_tpu.models.glm  # noqa: E402,F401  (registers families)
import transmogrifai_tpu.models.linear  # noqa: E402,F401
import transmogrifai_tpu.models.trees  # noqa: E402,F401
from transmogrifai_tpu.features import reset_uids as jax_reset  # noqa: E402
from transmogrifai_tpu.persistence import (  # noqa: E402
    load_model as jax_load_model,
)
from transmogrifai_tpu_torch.testing import (  # noqa: E402
    TICKETS_ROWS, TICKETS_SCORE_ROWS, TICKETS_SCORE_SEED, TICKETS_SEED,
    records_sha256, sanity_summary, selection_summary, tickets_dag,
    tickets_records, tickets_workflow,
)

FIXTURE = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures",
                       "tickets")
#: the rows of the training vector the fixture keeps
SAMPLE_ROWS, SAMPLE_SEED = 256, 0
SMALL_PROB_ATOL = 1e-5
FIXTURE_PROB_ATOL = 1e-6
PRED_MARGIN = 1e-5
TREE_FOLD_ATOL = 1e-5
#: the small train's linear sweep: 600 rows x ~550 columns are
#: near-separable, and there the bf16 sweep amplifies float32 summation
#: order (as on the leads workflow's small train); the vector is equal
#: bit for bit
SMALL_LIN_FOLD_ATOL = 2e-3
SMALL_ROWS, SMALL_SEED = 600, 3
#: the small train's word2vec steps and LDA sweeps (the fixture's: 400
#: and 30), to keep it a few seconds on the CPU
SMALL_DAG = dict(word2vec_steps=10, lda_iters=2)
SMALL_MODELS = [
    ("OpGBTClassifier", [{"maxDepth": 3, "maxIter": 5, "stepSize": 0.1}]),
    ("OpLogisticRegression", [{"regParam": 0.1, "elasticNetParam": 0.0}]),
]
#: a loaded model's raw scores against the saving package's: the two
#: packages add the LR's ~550 products in other orders (measured 5.2e-7
#: relative, 1.43e-6 absolute at a raw score of 2.8)
SAVE_RAW_RTOL = 2e-6
#: the blocks the fixture keeps whole: word2vec and LDA (the device
#: stages), by their stage's operation name
DEVICE_BLOCKS = ("word2vec", "lda")


def jax_namespace():
    """``tickets_dag``'s names from the JAX package."""
    from transmogrifai_tpu.features import FeatureBuilder
    from transmogrifai_tpu.impl.feature.text import (
        IsValidPhoneNumber, ParsePhoneNumber,
    )
    from transmogrifai_tpu.impl.feature.vectorizers import TextTokenizer
    from transmogrifai_tpu.impl.selector import factories
    return SimpleNamespace(
        FeatureBuilder=FeatureBuilder, transmogrify=tg.transmogrify,
        TextTokenizer=TextTokenizer, ParsePhoneNumber=ParsePhoneNumber,
        IsValidPhoneNumber=IsValidPhoneNumber,
        BinaryClassificationModelSelector=(
            factories.BinaryClassificationModelSelector))


def jax_tickets_workflow(records, models=None, seed=42, **dag_kw):
    """(workflow, label, prediction, results): the JAX package's tickets
    workflow on ``records`` (a DataFrame keyed by ``TicketId``), built
    after ``reset_uids``."""
    from transmogrifai_tpu.workflow import OpWorkflow
    jax_reset()
    results, y, pred = tickets_dag(jax_namespace(), models, seed, **dag_kw)
    wf = (OpWorkflow().set_input_dataset(pd.DataFrame(records),
                                         key_field="TicketId")
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


def vector_blocks(table):
    """{column name: (values, metadata json)} of every vector column of a
    trained table."""
    out = {}
    for name in table.column_names:
        vm = table[name].metadata.get("vector_meta")
        if vm is not None:
            out[name] = (host(table[name].values), vector_meta_json(vm))
    return out


def block_sha256(vals) -> str:
    """sha256 of a block's float32 bytes."""
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(
        vals, dtype=np.float32).tobytes()).hexdigest()


def device_block_names(table):
    """The trained table's word2vec and LDA block names, in
    ``DEVICE_BLOCKS`` order."""
    names = table.column_names
    return [next(n for n in names if f"_{op}_" in n)
            for op in DEVICE_BLOCKS]


def assert_scores_agree(got, want, atol):
    np.testing.assert_allclose(got["probability_1"], want["probability_1"],
                               rtol=0, atol=atol)
    decided = np.abs(want["probability_1"] - 0.5) > PRED_MARGIN
    np.testing.assert_array_equal(got["prediction"][decided],
                                  want["prediction"][decided])


def assert_parts_close(got, want):
    """One model's scores in both packages: probabilities and the
    prediction within 1e-6, the raw scores (a ~550-term dot product, up
    to ~5) within SAVE_RAW_RTOL relative."""
    for k in want:
        rtol = SAVE_RAW_RTOL if k.startswith("rawPrediction") else 0.0
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-6)


def test_generator_is_seeded_and_plain_python():
    a, b = tickets_records(64, 11), tickets_records(64, 11)
    assert a == b and records_sha256(a) == records_sha256(b)
    assert records_sha256(tickets_records(64, 12)) != records_sha256(a)
    for r in a:
        json.dumps(r)
        assert r["escalated"] in (0.0, 1.0)
        assert 40 <= len(r["body"].split()) or r["body"][0] > "　"


@pytest.fixture(scope="module")
def small():
    """Both packages' tickets workflows trained on
    ``tickets_records(SMALL_ROWS, SMALL_SEED)``."""
    recs = tickets_records(SMALL_ROWS, SMALL_SEED)
    jwf, jy, jpred, jres = jax_tickets_workflow(recs, SMALL_MODELS,
                                                **SMALL_DAG)
    jm = jwf.train()
    pwf, py, ppred, pres = tickets_workflow(recs, SMALL_MODELS,
                                            device="cpu", **SMALL_DAG)
    pm = pwf.train()
    return SimpleNamespace(recs=recs, jwf=jwf, jm=jm, jpred=jpred,
                           jres=jres, pwf=pwf, pm=pm, ppred=ppred,
                           pres=pres, score=tickets_records(200, 5))


def test_small_train_same_blocks_checks_and_selection(small):
    """Every vector block (word2vec and LDA included) and its metadata
    bit for bit, the same SanityChecker choices, the same winner, fold
    metrics within their limits."""
    from transmogrifai_tpu_torch.testing import (
        assert_same_sanity, selection_gaps,
    )
    jb, pb = vector_blocks(small.jm.train_table), \
        vector_blocks(small.pm.train_table)
    assert sorted(jb) == sorted(pb)
    for name, (vals, meta) in jb.items():
        np.testing.assert_array_equal(pb[name][0], vals, err_msg=name)
        assert pb[name][1] == meta, name
    assert_same_sanity(sanity_summary(_stage(small.pm, "SanityCheckerModel")),
                       sanity_summary(_stage(small.jm, "SanityCheckerModel")))
    got = selection_summary(_stage(small.pm, "SelectedModel").summary)
    want = selection_summary(_stage(small.jm, "SelectedModel").summary)
    assert got["winner"] == want["winner"]
    gaps = selection_gaps(got, want, lambda family, hyper, ref: (
        SMALL_LIN_FOLD_ATOL if family == "OpLogisticRegression"
        else TREE_FOLD_ATOL))
    print("fold gaps", gaps)


def test_small_scores_agree(small):
    want = prediction_parts(small.jm.score(df=pd.DataFrame(small.score)),
                            small.jpred)
    got = prediction_parts(small.pm.score(data=small.score), small.ppred)
    assert_scores_agree(got, want, SMALL_PROB_ATOL)


def test_small_saves_cross_both_packages(small, tmp_path):
    """JAX save -> port load and port save -> JAX load score as the
    trained models; the port's plan has the JAX package's stages, classes
    and state keys; the port's reload scores bit for bit."""
    import transmogrifai_tpu_torch as port
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_serve import save_jax_model
    jpath, ppath = str(tmp_path / "jax"), str(tmp_path / "port")
    save_jax_model(small.jm, jpath)
    small.pm.save(ppath)
    want = prediction_parts(small.jm.score(df=pd.DataFrame(small.score)),
                            small.jpred)
    loaded = port.load_model(jpath, device="cpu", workflow=small.pwf)
    got = prediction_parts(loaded.score(data=small.score), small.ppred)
    assert_parts_close(got, want)
    jl = jax_load_model(ppath, workflow=small.jwf)
    back = prediction_parts(jl.score(df=pd.DataFrame(small.score)),
                            small.jpred)
    mine = prediction_parts(small.pm.score(data=small.score), small.ppred)
    assert_parts_close(back, mine)
    again = port.load_model(ppath, device="cpu", workflow=small.pwf)
    re = prediction_parts(again.score(data=small.score), small.ppred)
    assert all(np.array_equal(re[k], mine[k]) for k in mine)

    def layout(path):
        with open(os.path.join(path, "plan.json")) as fh:
            plan = json.load(fh)
        return [(d["module"], d["className"], d["uid"], sorted(d["state"]))
                for d in plan["stages"] + plan["rawFeatureGenerators"]]
    jax_only = {"SanityCheckerModel": {"_stats_input_sharding"}}
    assert [(m, c, u, sorted(set(st) - jax_only.get(c, set())))
            for m, c, u, st in layout(jpath)] == layout(ppath)


def _fixture():
    with open(os.path.join(FIXTURE, "fixture.json")) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def fixture_records():
    """The fixture's 20,000 training records, rebuilt from their seed."""
    return tickets_records(TICKETS_ROWS, TICKETS_SEED)


def test_port_rebuilds_the_fixture_records(fixture_records):
    fx = _fixture()
    assert fx["train_records"]["rows"] == TICKETS_ROWS
    assert records_sha256(fixture_records) == fx["train_records"]["sha256"]
    assert records_sha256(tickets_records(
        TICKETS_SCORE_ROWS, TICKETS_SCORE_SEED)) == \
        fx["score_records"]["sha256"]


def test_the_jax_model_vectors_the_sampled_records_as_the_fixture(
        fixture_records):
    """The JAX-saved model (vocabularies, IDF weights, word2vec vectors and
    LDA topics fitted on the 20,000 training records) loaded in the port
    on the CPU turns the fixture's 256 sampled training records into the
    fixture's vector rows bit for bit, word2vec means and LDA mixtures
    included."""
    import transmogrifai_tpu_torch as port
    fx = _fixture()
    sample = np.load(os.path.join(FIXTURE, "vector_sample.npz"))
    blocks = np.load(os.path.join(FIXTURE, "device_blocks.npz"))
    recs = [fixture_records[i] for i in sample["rows"]]
    pwf, _, _, results = tickets_workflow(recs, device="cpu")
    pm = port.load_model(os.path.join(FIXTURE, "model"), device="cpu",
                         workflow=pwf)
    scored = pm.score(data=recs)
    vec = scored[_stage(pm, "SanityCheckerModel").input_features[1].name]
    assert vector_meta_json(vec.metadata["vector_meta"]) == fx["vector"]
    np.testing.assert_array_equal(host(vec.values), sample["X"])
    for op, name in zip(DEVICE_BLOCKS, device_block_names(scored)):
        np.testing.assert_array_equal(host(scored[name].values),
                                      blocks[op][sample["rows"]])


def test_committed_model_scores_in_both_packages():
    """The JAX-saved model scores the 2,000 scoring records in the JAX
    package as it did when saved, and in the port within
    FIXTURE_PROB_ATOL."""
    import transmogrifai_tpu_torch as port
    fx = _fixture()
    exp = np.load(os.path.join(FIXTURE, "expected.npz"))
    path = os.path.join(FIXTURE, "model")
    score = tickets_records(TICKETS_SCORE_ROWS, TICKETS_SCORE_SEED)
    want = {k: exp[k] for k in exp.files if k != "key"}
    jwf, _, jpred, _ = jax_tickets_workflow(score)
    jo = jax_load_model(path, workflow=jwf).score(df=pd.DataFrame(score))
    for k, v in prediction_parts(jo, jpred).items():
        if k in want:
            np.testing.assert_array_equal(v, want[k])
    pwf, _, ppred, _ = tickets_workflow(score, device="cpu")
    pm = port.load_model(path, device="cpu", workflow=pwf)
    assert_scores_agree(prediction_parts(pm.score(data=score), ppred),
                        want, FIXTURE_PROB_ATOL)
    assert [r["TicketId"] for r in score] == exp["key"].tolist()
    assert _stage(pm, "SelectedModel").fitted.family == \
        fx["selection"]["winner"]


def test_fixture_stays_small():
    total = sum(os.path.getsize(os.path.join(root, f))
                for root, _, files in os.walk(FIXTURE) for f in files)
    assert total < 5 * 2 ** 20, total


# ---------------------------------------------------------------------------
# Writing the committed fixture (JAX package, CPU)
# ---------------------------------------------------------------------------

def generate_fixture(out_dir: str = None, rows: int = TICKETS_ROWS) -> None:
    """Train the JAX package's tickets workflow on
    ``tickets_records(rows, TICKETS_SEED)`` with the default binary list
    at full default grids, score ``tickets_records(TICKETS_SCORE_ROWS,
    TICKETS_SCORE_SEED)``, and write the fixture: ``fixture.json`` (both
    record sets' sha256, the vector's metadata, every vector block's
    sha256, the
    SanityChecker's choices, the selection, the train's seconds),
    ``vector_sample.npz`` (the checked vector's input at ``SAMPLE_ROWS``
    seeded rows), ``device_blocks.npz`` (the word2vec and LDA blocks
    whole), ``expected.npz`` (the scores and keys) and ``model/`` (the
    saved workflow without its drift baseline)."""
    import time

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_serve import drop_drift_baseline, save_jax_model

    os.environ["TG_FAST_GRIDS"] = "0"
    out_dir = out_dir or FIXTURE
    train = tickets_records(rows, TICKETS_SEED)
    score = tickets_records(TICKETS_SCORE_ROWS, TICKETS_SCORE_SEED)
    wf, _, pred, results = jax_tickets_workflow(train)
    t0 = time.perf_counter()
    model = wf.train()
    secs = time.perf_counter() - t0
    sc = _stage(model, "SanityCheckerModel")
    table = model.train_table
    vec = table[sc.input_features[1].name]
    blocks = vector_blocks(table)
    idx = np.sort(np.random.RandomState(SAMPLE_SEED).choice(
        rows, SAMPLE_ROWS, replace=False))
    parts = prediction_parts(model.score(df=pd.DataFrame(score)), pred)
    expected = {k: v for k, v in parts.items()
                if k == "prediction" or k.startswith("probability_")}
    expected["key"] = np.array([r["TicketId"] for r in score], dtype=str)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    path = os.path.join(out_dir, "model")
    save_jax_model(model, path)
    drop_drift_baseline(path)
    np.savez_compressed(os.path.join(out_dir, "vector_sample.npz"),
                        rows=idx, X=np.asarray(vec.values)[idx])
    np.savez_compressed(os.path.join(out_dir, "device_blocks.npz"), **{
        op: blocks[name][0]
        for op, name in zip(DEVICE_BLOCKS, device_block_names(table))})
    np.savez_compressed(os.path.join(out_dir, "expected.npz"), **expected)
    with open(os.path.join(out_dir, "fixture.json"), "w") as fh:
        json.dump({
            "train_records": {"rows": rows, "seed": TICKETS_SEED,
                              "sha256": records_sha256(train)},
            "score_records": {"rows": TICKETS_SCORE_ROWS,
                              "seed": TICKETS_SCORE_SEED,
                              "sha256": records_sha256(score)},
            "train_seconds_jax_cpu": secs,
            "vector": vector_meta_json(vec.metadata["vector_meta"]),
            "blocks": {name: block_sha256(vals)
                       for name, (vals, _) in blocks.items()},
            "sanity": sanity_summary(sc),
            "selection": selection_summary(
                _stage(model, "SelectedModel").summary),
        }, fh, indent=1)


if __name__ == "__main__":
    generate_fixture()
