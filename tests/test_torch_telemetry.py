"""The stage profiler, the runner's ``appMetrics`` and the telemetry of the
train paths in the PyTorch port, by the JAX package's names: the
``workflow.train``, ``stage.fit``, ``stage.transform``, ``sweep.family``
and ``stream.pass`` spans, the run's correlated flight-recorder events,
and the streaming feed's and cache's counters.
"""
from __future__ import annotations

import os

import numpy as np
import pytest

from transmogrifai_tpu.utils.profiler import StageProfiler as JProfiler

from transmogrifai_tpu_torch.observability import blackbox as bb
from transmogrifai_tpu_torch.observability import ledger as obs_ledger
from transmogrifai_tpu_torch.observability import metrics as om
from transmogrifai_tpu_torch.observability import trace as ot
from transmogrifai_tpu_torch.readers.readers import FrameReader
from transmogrifai_tpu_torch.runner import OpParams, OpWorkflowRunner
from transmogrifai_tpu_torch.stages.base import Estimator
from transmogrifai_tpu_torch.testing import (
    close_serving_state, port_stream_namespace, pressure_table,
    serve_bench_workflow, stream_dag,
)
from transmogrifai_tpu_torch.utils.profiler import StageProfiler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _observed():
    close_serving_state()
    ot.enable_tracing(True)
    om.enable_metrics(True)
    bb.enable_blackbox(True)
    obs_ledger.enable_ledger(True)
    yield
    for off in (ot.enable_tracing, om.enable_metrics, bb.enable_blackbox,
                obs_ledger.enable_ledger):
        off(None)
    close_serving_state()


def _jax_source(rel: str) -> str:
    with open(os.path.join(REPO, "transmogrifai_tpu", rel)) as fh:
        return fh.read()


def _data(n=240, d=3, seed=5):
    rng = np.random.RandomState(seed)
    cols = {f"x{i}": rng.randn(n) for i in range(d)}
    cols["y"] = (sum(cols.values()) > 0).astype(float)
    return cols


def _two_family_workflow(data):
    from transmogrifai_tpu_torch.features import reset_uids
    from transmogrifai_tpu_torch.models.api import MODEL_REGISTRY
    reset_uids()
    wf = serve_bench_workflow(None, None, 3, seed=0, device="cpu")
    sel = [s for s in wf.stages if type(s).__name__ == "ModelSelector"][0]
    sel.models = [(MODEL_REGISTRY["OpLogisticRegression"],
                   [{"regParam": 0.01, "elasticNetParam": 0.0},
                    {"regParam": 0.1, "elasticNetParam": 0.0}]),
                  (MODEL_REGISTRY["OpLinearSVC"], [{"regParam": 0.01}])]
    return wf.set_input_dataset(data)


def test_profiler_app_metrics_have_the_jax_packages_keys():
    class S:
        uid = "s1"
    prof, jprof = StageProfiler(), JProfiler()
    for p in (prof, jprof):
        with p.track(S(), "fit", 0):
            pass
        with p.track(S(), "transform", 1):
            pass
    m, jm = prof.app_metrics(), jprof.app_metrics()
    assert set(m) - {"deviceMemory"} == set(jm) - {"deviceMemory"}
    assert set(m["compileCache"]) == set(jm["compileCache"])
    assert m["compileCache"]["hits"] == m["compileCache"]["misses"] == 0
    assert m["compileCache"]["builds"] == obs_ledger.ledger().total
    assert m["byOp"].keys() == {"fit", "transform"}
    assert m["byLayer"].keys() == {"layer_0", "layer_1"}
    assert len(m["spans"]) == 2
    for sp, op in zip(m["spans"], ("fit", "transform")):
        assert set(sp) == set(jm["spans"][0])
        assert sp["ph"] == "X" and sp["name"] == f"S.{op}"
        assert sp["args"] == {"uid": "s1", "op": op, "layer": sp["args"][
            "layer"]}
    assert m["spans"][0]["ts"] <= m["spans"][1]["ts"]
    assert "Stage timings (2 ops" in prof.pretty()


def test_runner_log_stage_metrics_writes_app_metrics(tmp_path):
    data = _data()
    wf = _two_family_workflow(data)
    runner = OpWorkflowRunner(wf, train_reader=FrameReader(data))
    metrics_path = str(tmp_path / "m.json")
    res = runner.run("train", OpParams(log_stage_metrics=True,
                                       metrics_location=metrics_path))
    app = res.metrics["appMetrics"]
    fitted = {type(s).__name__ for s in wf.stages
              if isinstance(s, Estimator)}
    assert fitted and fitted <= set(app["byStage"])
    assert app["byOp"]["fit"] > 0 and app["numRecords"] >= 2 * len(fitted)
    assert app["compileCache"]["builds"] == obs_ledger.ledger().total
    assert res.model.profiler is not None           # scores time apart
    assert os.path.isfile(metrics_path)


def test_in_core_train_spans_and_correlated_events():
    wf = _two_family_workflow(_data())
    model = wf.train()
    spans = ot.tracer().finished()
    est = {s.uid for s in wf.stages if isinstance(s, Estimator)}
    assert est <= {s.attrs["uid"] for s in spans if s.name == "stage.fit"}
    assert {s.attrs["uid"] for s in spans if s.name == "stage.transform"}
    assert len([s for s in spans if s.name == "workflow.train"]) == 1
    fams = [s for s in spans if s.name == "sweep.family"]
    assert {s.attrs["family"] for s in fams} == {"OpLogisticRegression",
                                                 "OpLinearSVC"}
    assert all(s.attrs["folds"] == 3 for s in fams)
    obs = model.summary()["observability"]
    assert "ModelSelector" in obs["stages"]
    assert obs["stages"]["ModelSelector"]["fitSeconds"] > 0
    assert set(obs["families"]) == {"OpLogisticRegression", "OpLinearSVC"}
    corr = model._correlation
    assert corr is not None and corr.startswith("run-")
    kinds = [e.kind for e in bb.recorder().slice_for(corr)]
    assert kinds[0] == "workflow.train"
    assert kinds.count("sweep.family") == 2
    assert kinds.index("workflow.train_done") > max(
        i for i, k in enumerate(kinds) if k == "sweep.family")
    src = _jax_source("workflow.py") + _jax_source(
        "impl/tuning/validators.py") + _jax_source("dag.py")
    for name in ("workflow.train", "workflow.train_done", "sweep.family",
                 "stage.fit", "stage.transform"):
        assert f'"{name}"' in src, name


def test_streamed_train_telemetry(monkeypatch):
    monkeypatch.setenv("TG_STREAM_CACHE_BYTES", str(64 << 20))
    ns = port_stream_namespace()
    ns.reset_uids()
    table = pressure_table(ns, 1200, 4, seed=3)
    model = (ns.OpWorkflow(device="cpu")
             .set_result_features(stream_dag(ns, 4))
             .train(stream=ns.streaming.TableChunkSource(table, 300)))
    snap = om.registry().snapshot()
    for name in ("tg_stream_chunks_total", "tg_stream_rows_total",
                 "tg_stream_wait_seconds", "tg_stream_stage_seconds",
                 "tg_stream_cache_hits_total",
                 "tg_stream_cache_misses_total"):
        assert name in snap, name
    stats = model.summary()["streaming"]
    assert sum(snap["tg_stream_chunks_total"].values()) == stats["chunks"]
    assert sum(snap["tg_stream_rows_total"].values()) == stats["rows"]
    assert set(snap["tg_stream_stage_seconds"]) >= {"stage=read",
                                                    "stage=transform"}
    cache = stats["cache"]
    assert sum(snap["tg_stream_cache_hits_total"].values()) == cache["hits"]
    assert sum(snap["tg_stream_cache_misses_total"].values()) == \
        cache["misses"]
    passes = [s for s in ot.tracer().finished() if s.name == "stream.pass"]
    assert passes and all("passId" in s.attrs for s in passes)
    kinds = [e.kind for e in bb.recorder().slice_for(model._correlation)]
    assert kinds.count("stream.pass") == len(passes)
    assert kinds.count("stream.pass_done") == len(passes)
    assert "stream.upload" in kinds
    recs = [r for r in obs_ledger.ledger().entries()
            if r.subsystem == "stream"]
    assert len(recs) == len(passes)
    src = "".join(_jax_source(f"streaming/{m}.py")
                  for m in ("feed", "trainer", "cache"))
    for name in [
            "tg_stream_chunks_total", "tg_stream_rows_total",
            "tg_stream_wait_seconds", "tg_stream_stage_seconds",
            "tg_stream_cache_hits_total", "tg_stream_cache_misses_total",
            "stream.pass", "stream.pass_done", "stream.upload"]:
        assert f'"{name}"' in src, name
