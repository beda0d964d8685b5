"""In-core checkpoints and ``train(resume=True)`` of the PyTorch port
against the JAX package (``tests/test_preemption.py``'s cases): a port
train killed at each preemption site resumes to the JAX package's
unkilled outcome, sweep keys are byte-equal across the packages, and a
checkpoint directory either package wrote resumes in the other.

Tolerances are ``test_preemption.py``'s: the selection exact; the train
and holdout evaluations within rtol 1e-6 / atol 1e-7; scores within atol
1e-6 (the packages' LR refits differ by up to ~1e-6 in probability on this
frame, as they do on the Titanic fixture).
"""
from __future__ import annotations

import json
import os
import sys
from types import SimpleNamespace

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np
import pandas as pd
import pytest

import transmogrifai_tpu as tg
from transmogrifai_tpu.features import reset_uids as jax_reset
from transmogrifai_tpu.impl.selector.factories import (
    BinaryClassificationModelSelector as JSel,
)
from transmogrifai_tpu.impl.tuning import sweep_checkpoint as jsc
from transmogrifai_tpu.robustness import faults as jfaults
from transmogrifai_tpu.workflow import OpWorkflow as JWF

from transmogrifai_tpu_torch.dsl import transmogrify as ptransmogrify
from transmogrifai_tpu_torch.features import (
    FeatureBuilder as PFB, reset_uids as port_reset,
)
from transmogrifai_tpu_torch.impl.selector.factories import (
    BinaryClassificationModelSelector as PSel,
)
from transmogrifai_tpu_torch.impl.tuning.sweep_checkpoint import (
    SweepCheckpoint, candidate_key, params_hash,
)
from transmogrifai_tpu_torch.manifest import (
    CheckpointManifest, atomic_write_bytes, clean_tmp_debris, sha256_bytes,
)
from transmogrifai_tpu_torch.robustness import faults
from transmogrifai_tpu_torch.workflow import OpWorkflow as PWF

pytestmark = pytest.mark.chaos

LR_GRID = [{"regParam": 0.01, "elasticNetParam": 0.0},
           {"regParam": 0.1, "elasticNetParam": 0.0}]
MODELS = [("OpLogisticRegression", LR_GRID),
          ("OpLinearSVC", [{"regParam": 0.01}])]

JAX = SimpleNamespace(FB=tg.FeatureBuilder, transmogrify=tg.transmogrify,
                      Sel=JSel, reset=jax_reset, faults=jfaults,
                      wf=lambda data: JWF().set_input_dataset(
                          pd.DataFrame(data)))
PORT = SimpleNamespace(FB=PFB, transmogrify=ptransmogrify, Sel=PSel,
                       reset=port_reset, faults=faults,
                       wf=lambda data: PWF(device="cpu").set_input_dataset(
                           data))


def _data(n=300, seed=7):
    rng = np.random.RandomState(seed)
    x1, x2 = rng.randn(n), rng.randn(n)
    return {"x1": x1, "x2": x2, "y": ((x1 + 0.5 * x2) > 0).astype(float)}


def _workflow(ns, data, ckpt=None):
    """``test_preemption.py``'s workflow from ``ns``'s names, after its
    ``reset_uids``: the two packages' stage uids are equal."""
    ns.reset()
    FB = ns.FB
    label = FB.RealNN("y").extract_field().as_response()
    f1 = FB.Real("x1").extract_field().as_predictor()
    f2 = FB.Real("x2").extract_field().as_predictor()
    checked = ns.transmogrify([f1, f2]).sanity_check(label)
    pred = (ns.Sel.with_cross_validation(models=MODELS)
            .set_input(label, checked).get_output())
    wf = ns.wf(data).set_result_features(pred)
    if ckpt is not None:
        wf.with_checkpoint_dir(ckpt)
    return wf, pred


def _selection(model, pred):
    return model.summary()[pred.origin_stage.uid]


def _scores(model, pred, data):
    vals = model.score(data=data)[pred.name].values
    return vals.numpy() if hasattr(vals, "numpy") else np.asarray(vals)


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def jax_base(data):
    """The JAX package's unkilled train: its selection and scores."""
    wf, pred = _workflow(JAX, data)
    model = wf.train()
    return {"sel": _selection(model, pred),
            "scores": np.asarray(model.score(df=pd.DataFrame(data))[
                pred.name].values)}


def _assert_same_outcome(base, model, pred, data):
    b, r = base["sel"], _selection(model, pred)
    assert r["bestModelType"] == b["bestModelType"]
    assert r["bestHyperparameters"] == b["bestHyperparameters"]
    assert r["bestMetricValue"] == b["bestMetricValue"]
    for section in ("trainEvaluation", "holdoutEvaluation"):
        assert set(r[section]) == set(b[section])
        for k in b[section]:
            np.testing.assert_allclose(r[section][k], b[section][k],
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(_scores(model, pred, data), base["scores"],
                               atol=1e-6)


def _kill(ns, data, ckpt, site, spec, resume=False):
    wf, _ = _workflow(ns, data, ckpt)
    with ns.faults.injected({site: spec}):
        with pytest.raises(BaseException) as info:
            wf.train(resume=resume)
    assert type(info.value).__name__ == "SimulatedPreemption"


# -- kill at each site, resume, the JAX package's unkilled outcome -------------

@pytest.mark.parametrize("site,spec", [
    ("preempt.stage_fit", {"mode": "preempt", "nth": 2}),
    ("preempt.checkpoint_write", {"mode": "preempt", "nth": 1}),
    ("preempt.sweep", {"mode": "preempt", "nth": 2}),
    ("preempt.refit", {"mode": "preempt", "nth": 1}),
])
def test_preempt_then_resume_matches_the_jax_unkilled_train(
        tmp_path, data, jax_base, site, spec):
    ck = str(tmp_path / "ckpt")
    _kill(PORT, data, ck, site, spec)
    wf, pred = _workflow(PORT, data, ck)
    model = wf.train(resume=True)
    _assert_same_outcome(jax_base, model, pred, data)
    res = model.summary()["resume"]
    assert res["requested"] is True
    if site == "preempt.stage_fit":
        assert res["restoredStages"]
    if site == "preempt.checkpoint_write":
        assert res["restoredStages"] == []
        skipped = model.summary()["faults"]["checkpointsSkipped"]
        assert any("manifest" in r["detail"]["reason"] for r in skipped)
    if site == "preempt.sweep":
        fams = [r["family"] for r in res["restoredSweepCandidates"]]
        assert fams == ["OpLogisticRegression"]
    if site == "preempt.refit":
        fams = {r["family"] for r in res["restoredSweepCandidates"]}
        assert fams == {"OpLogisticRegression", "OpLinearSVC"}
        assert res["restoredStages"]
    # a clean exit removes the run sentinel
    assert not os.path.exists(os.path.join(ck, "RUN_SENTINEL.json"))


def test_double_preemption_then_resume(tmp_path, data, jax_base):
    ck = str(tmp_path / "ckpt")
    _kill(PORT, data, ck, "preempt.stage_fit", {"mode": "preempt", "nth": 2},
          resume=True)
    _kill(PORT, data, ck, "preempt.refit", {"mode": "preempt", "nth": 1},
          resume=True)
    wf, pred = _workflow(PORT, data, ck)
    model = wf.train(resume=True)
    _assert_same_outcome(jax_base, model, pred, data)
    assert model.summary()["resume"]["restoredStages"]


def test_resume_without_checkpoint_dir_raises(data):
    wf, _ = _workflow(PORT, data)
    with pytest.raises(ValueError, match="with_checkpoint_dir"):
        wf.train(resume=True)


# -- the integrity manifest ------------------------------------------------------

def test_checkpoint_dir_has_manifest_and_checksums(tmp_path, data):
    ck = str(tmp_path / "ckpt")
    _workflow(PORT, data, ck)[0].train()
    with open(os.path.join(ck, "MANIFEST.json")) as fh:
        doc = json.load(fh)
    assert doc["manifestVersion"] == 1 and doc["stages"] and doc["sweeps"]
    m, err = CheckpointManifest.load(ck, 1)
    assert err is None and m.verify_recorded() == []
    assert not [f for f in os.listdir(ck) if f.endswith(".tmp")]


@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_damaged_checkpoint_detected_and_refit(tmp_path, data, jax_base,
                                               damage):
    """A byte flipped inside a stage's arrays (size kept: only the sha256
    sees it) or the file cut in half: reported with its reason, the stage
    refits, and the outcome is the JAX package's."""
    ck = str(tmp_path / "ckpt")
    _workflow(PORT, data, ck)[0].train()
    npzs = sorted(f for f in os.listdir(ck) if f.endswith(".npz"))
    target = os.path.join(ck, npzs[0])
    raw = bytearray(open(target, "rb").read())
    if damage == "flip":
        raw[len(raw) // 2] ^= 0xFF
    else:
        raw = raw[: len(raw) // 2]
    with open(target, "wb") as fh:
        fh.write(bytes(raw))
    wf, pred = _workflow(PORT, data, ck)
    model = wf.train(resume=True)
    skipped = model.summary()["faults"]["checkpointsSkipped"]
    (rep,) = [r for r in skipped if r["detail"]["uid"] == npzs[0][:-4]]
    assert ("sha256 mismatch" if damage == "flip" else "size mismatch") \
        in rep["detail"]["reason"]
    assert rep["detail"]["file"].endswith(npzs[0])
    assert npzs[0][:-4] not in model.summary()["resume"]["restoredStages"]
    _assert_same_outcome(jax_base, model, pred, data)


def test_manifest_unit_verify_and_debris(tmp_path):
    d = str(tmp_path / "dir")
    os.makedirs(d)
    sha = atomic_write_bytes(os.path.join(d, "a.bin"), b"hello")
    assert sha == sha256_bytes(b"hello")
    m = CheckpointManifest(d, 1)
    m.record_file("a.bin", sha, 5)
    m.complete_stage("st_1", ["a.bin"])
    m.complete_sweep("sel_1", "a.bin")
    m.save()
    m2, err = CheckpointManifest.load(d, 1)
    assert err is None and m2.verify_file("a.bin") is None
    assert m2.verify_file("missing.bin") is not None
    assert m2.sweeps == {"sel_1": {"file": "a.bin"}}
    open(os.path.join(d, "orphan.npz"), "wb").write(b"x")
    open(os.path.join(d, "half.npz.tmp"), "wb").write(b"x")
    assert m2.unrecorded_files() == ["orphan.npz"]
    assert clean_tmp_debris(d) == ["half.npz.tmp"]
    open(os.path.join(d, "a.bin"), "wb").write(b"HELLO")
    assert m2.verify_recorded() == [
        "a.bin: sha256 mismatch: manifest "
        f"{sha[:12]}..., file {sha256_bytes(b'HELLO')[:12]}..."]
    _, err2 = CheckpointManifest.load(d, 2)
    assert err2 is not None and "format" in err2


# -- the sweep checkpoint units, against the JAX package -------------------------

def test_sweep_metrics_roundtrip_bit_exact():
    fm = np.array([[0.5, np.nan, np.inf], [-np.inf, 0.25, 1e-30]],
                  dtype=np.float32)
    rec = SweepCheckpoint.encode_metrics(fm)
    assert rec == jsc.SweepCheckpoint.encode_metrics(fm)
    back = SweepCheckpoint.decode_metrics(json.loads(json.dumps(rec)))
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, fm)


def test_candidate_key_sensitivity_and_bytes():
    fp = {"n": 100, "F": 3, "yhash": "abc", "maxEvalRows": None,
          "exact": False}
    k = candidate_key("fam", LR_GRID, fp)
    assert k == jsc.candidate_key("fam", LR_GRID, fp)
    assert k == candidate_key("fam", [dict(g) for g in LR_GRID], fp)
    assert k != candidate_key("fam2", LR_GRID, fp)
    assert k != candidate_key("fam", LR_GRID[:1], fp)
    assert k != candidate_key("fam", LR_GRID, dict(fp, yhash="zzz"))
    for hyper in ({"a": 1, "b": 2}, {"maxDepth": 12, "minInfoGain": 0.001},
                  {"regParam": 0.1, "elasticNetParam": 0.5}):
        assert params_hash(hyper) == jsc.params_hash(hyper)
    assert params_hash({"a": 1, "b": 2}) == params_hash({"b": 2, "a": 1})


def test_sweep_checkpoint_put_get_and_corruption(tmp_path):
    d = str(tmp_path / "ck")
    os.makedirs(d)
    ck = SweepCheckpoint(d, "sel_1")
    rec = {"family": "f", "grid": LR_GRID, "metricName": "AuPR",
           "paramsHashes": [params_hash(g) for g in LR_GRID],
           **SweepCheckpoint.encode_metrics(np.ones((3, 2), np.float32)),
           "quarantined": False, "reason": None}
    ck.put("k1", rec)
    assert SweepCheckpoint(d, "sel_1").get("k1")["family"] == "f"
    # the JAX package reads the port's file, and the bytes are its own
    assert jsc.SweepCheckpoint(d, "sel_1").get("k1") == rec
    assert SweepCheckpoint(d, "sel_1").get("nope") is None
    with open(ck.path, "wb") as fh:
        fh.write(b"garbage")
    assert SweepCheckpoint(d, "sel_1").get("k1") is None


# -- keys and directories across the packages -----------------------------------

def _sweep_doc(ck):
    names = [f for f in os.listdir(ck) if f.startswith("sweep_")]
    assert len(names) == 1
    with open(os.path.join(ck, names[0])) as fh:
        return names[0], json.load(fh)


def test_checkpoint_dirs_resume_across_the_packages(tmp_path, data,
                                                    jax_base):
    """Both packages killed at ``preempt.refit``: the sweep files have the
    same name, the same candidate keys and the same records but for the
    fold metrics' last bits; the JAX package's directory resumes in the
    port and the port's in the JAX package, each replaying every family,
    to the JAX package's unkilled outcome."""
    jck, pck = str(tmp_path / "jax"), str(tmp_path / "port")
    spec = {"mode": "preempt", "nth": 1}
    _kill(JAX, data, jck, "preempt.refit", spec)
    _kill(PORT, data, pck, "preempt.refit", spec)
    (jname, jdoc), (pname, pdoc) = _sweep_doc(jck), _sweep_doc(pck)
    assert jname == pname
    assert list(jdoc["candidates"]) == list(pdoc["candidates"])
    for key, jrec in jdoc["candidates"].items():
        prec = pdoc["candidates"][key]
        assert {k: v for k, v in prec.items() if k != "foldMetrics"} == \
            {k: v for k, v in jrec.items() if k != "foldMetrics"}

    wf, pred = _workflow(PORT, data, jck)
    model = wf.train(resume=True)
    res = model.summary()["resume"]
    assert {r["family"] for r in res["restoredSweepCandidates"]} == {
        "OpLogisticRegression", "OpLinearSVC"}
    assert res["restoredStages"]
    _assert_same_outcome(jax_base, model, pred, data)

    wf, jpred = _workflow(JAX, data, pck)
    jmodel = wf.train(resume=True)
    jres = jmodel.summary()["resume"]
    assert {r["family"] for r in jres["restoredSweepCandidates"]} == {
        "OpLogisticRegression", "OpLinearSVC"}
    assert jres["restoredStages"] == res["restoredStages"]
    assert _selection(jmodel, jpred)["bestModelType"] == \
        jax_base["sel"]["bestModelType"]


# -- the committed JAX-written checkpoint directory of the chip's train --------

#: the JAX package's checkpoint directory of the serve bench's default
#: binary list (20,000 x 64, full default grids) killed at
#: ``preempt.refit``: stage checkpoints, the sweep file and the manifest
RESUME_FIXTURE = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures",
                              "resume", "default_binary")


def write_resume_fixture(path: str = RESUME_FIXTURE) -> None:
    """Train ``default_binary`` with the JAX package into ``path``, killed
    at ``preempt.refit`` (the sweep committed, no refit), built after
    ``reset_uids`` as the port builds it (``testing.serve_bench_workflow``),
    so the stage uids and the sweep's candidate keys are the port's. The
    run sentinel the kill leaves is removed."""
    import shutil

    from test_torch_serve import bench_frame
    from transmogrifai_tpu.impl.selector import factories
    from transmogrifai_tpu_torch.testing import TRAIN_ROWS, TRAIN_SEED
    os.environ["TG_FAST_GRIDS"] = "0"          # full default grids
    shutil.rmtree(path, ignore_errors=True)
    jax_reset()
    FB = tg.FeatureBuilder
    label = FB.RealNN("y").extract_field().as_response()
    feats = [FB.Real(f"x{i}").extract_field().as_predictor()
             for i in range(64)]
    checked = tg.transmogrify(feats).sanity_check(label)
    pred = (factories.BinaryClassificationModelSelector.with_cross_validation(
        seed=TRAIN_SEED).set_input(label, checked).get_output())
    wf = (JWF().set_input_dataset(pd.DataFrame(
        bench_frame(TRAIN_ROWS, 64, TRAIN_SEED, "binary")))
        .set_result_features(pred).with_checkpoint_dir(path))
    with jfaults.injected({"preempt.refit": {"mode": "preempt", "nth": 1}}):
        try:
            wf.train()
        except jfaults.SimulatedPreemption:
            pass
        else:
            raise AssertionError("the train was not killed at the refit")
    os.remove(os.path.join(path, "RUN_SENTINEL.json"))


def test_the_committed_jax_checkpoint_dir_resumes_in_the_port(tmp_path,
                                                              monkeypatch):
    """The chip's arm (f) on the CPU: the JAX package's directory of the
    full-size default list, killed at the refit, resumes in the port with
    every stage and every family restored (so no tree is grown here), to
    the JAX package's selection (``serve64/default_binary/summary.json``)
    and its refit (the SVC of ``serve64/svc``)."""
    import shutil

    from transmogrifai_tpu_torch.testing import (
        TRAIN_ROWS, TRAIN_SEED, serve_bench_data, serve_bench_workflow)
    monkeypatch.setenv("TG_FAST_GRIDS", "0")
    ck = str(tmp_path / "ckpt")
    shutil.copytree(RESUME_FIXTURE, ck)
    port_reset()
    wf = serve_bench_workflow(None, None, 64, TRAIN_SEED, device="cpu")
    wf.set_input_dataset(serve_bench_data(TRAIN_ROWS, 64, TRAIN_SEED))
    model = wf.with_checkpoint_dir(ck).train(resume=True)
    res = model.summary()["resume"]
    assert {r["family"] for r in res["restoredSweepCandidates"]} == {
        "OpLogisticRegression", "OpRandomForestClassifier",
        "OpGBTClassifier", "OpLinearSVC"}
    assert res["refitStages"] == [model.stages[-1].uid]
    assert len(res["restoredStages"]) == 2
    sel = model.stages[-1].summary
    with open(os.path.join(os.path.dirname(os.path.dirname(RESUME_FIXTURE)),
                           "serve64", "default_binary", "summary.json")) as fh:
        want = json.load(fh)
    assert (sel.best_model_type, sel.best_hyper) == (want["winner"],
                                                     want["hyper"])
    assert sel.best_metric_value == want["value"]
    for r, w in zip(sel.validation_results, want["families"]):
        assert r.family == w["family"]
        np.testing.assert_array_equal(
            np.asarray(r.fold_metrics, np.float32),
            np.asarray(w["fold_metrics"], np.float32))


if __name__ == "__main__":
    # regenerate the committed fixture (JAX package, CPU, ~3 min)
    write_resume_fixture()
