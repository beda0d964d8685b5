"""The PyTorch port's serving runtime and registry against the JAX package
(``transmogrifai_tpu_torch/serving``; the cases of ``tests/test_serving.py``
on the port's CPU path).

Models: the committed JAX-saved ``serve64/rf`` (64 predictors, 50 slot-chain
trees; its forest sums each row's trees in tree order, so the port's
records are bit-equal whatever the flush sizes), a tiny GBT that the JAX
package trains and saves (300 rows, 3 predictors, depth 3, 5 rounds) and the
port loads, and the same workflow trained by the port where a case needs
the port's own save. Tolerances: the port against the JAX package's runtime
on the same saved model and rows, probabilities within ``PROB_ATOL`` (1e-5)
and decided predictions equal (the two packages' tree sums and sigmoids
differ in the last bits: ROADMAP Queue 3); everything within the port
bit-equal (the binary GBT's records across flush sizes on the CPU too,
since the predict runs at the rows' bucket:
``test_gbt_records_across_cpu_flush_sizes_within_an_ulp``).
No test sleeps: breakers take an injected clock, queues are staged before
``start()`` and deadlines set in the past, every wait has its own timeout.
"""
from __future__ import annotations

import json
import os
import shutil
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import jax  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import transmogrifai_tpu.models.trees  # noqa: E402,F401  (registers families)
import transmogrifai_tpu_torch as port  # noqa: E402
from transmogrifai_tpu_torch.local.scoring import (  # noqa: E402
    SCORE_ERROR_KEY, micro_batch_score_function, score_function,
    serve_record_builder, serve_table_builder,
)
from transmogrifai_tpu_torch.observability import ledger  # noqa: E402
from transmogrifai_tpu_torch.robustness import faults  # noqa: E402
from transmogrifai_tpu_torch.robustness.policy import (  # noqa: E402
    FaultLog, FaultReport,
)
from transmogrifai_tpu_torch.serving import (  # noqa: E402
    CircuitBreaker, DeadlineExceededError, ModelRegistry, NetEdge,
    OverloadError, RuntimeStoppedError, ServeConfig, ServingRuntime,
)
from transmogrifai_tpu_torch.serving.loadgen import (  # noqa: E402
    run_open_loop, run_wire_open_loop, synthetic_rows,
)
from transmogrifai_tpu_torch.testing import (  # noqa: E402
    close_serving_state, request_rows, score_frame, serve_bench_workflow,
)

pytestmark = pytest.mark.serve

SERVE64 = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures",
                       "serve64")
#: a probability of the port against the JAX package's, and the margin
#: past which no rounding can flip a prediction
PROB_ATOL = 1e-5
PRED_MARGIN = 1e-5
#: the tiny GBT both packages train: TINY_D predictors, TINY_ROWS rows
TINY_D, TINY_ROWS, TINY_SEED = 3, 300, 7
TINY_GBT = ("OpGBTClassifier",
            {"maxDepth": 3, "maxIter": 5, "stepSize": 0.1,
             "minInstancesPerNode": 5, "minInfoGain": 0.001})


@pytest.fixture(autouse=True)
def _clean_serving(tmp_path, monkeypatch):
    monkeypatch.setenv("TG_POSTMORTEM_DIR", str(tmp_path / "postmortems"))
    yield
    leaks = close_serving_state()
    assert not leaks, f"the test leaked serving state: {leaks}"


@pytest.fixture(scope="module")
def rf():
    return port.load_model(os.path.join(SERVE64, "rf"), device="cpu")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """{"jax": JAX-trained GBT, "path": its save, "port": the port's load
    of it, "trained": the port's train of the same workflow}."""
    from test_torch_serve import bench_frame, save_jax_model, train_jax_model
    jm = train_jax_model(*TINY_GBT, n=TINY_ROWS, d=TINY_D, seed=TINY_SEED)
    path = str(tmp_path_factory.mktemp("tiny_gbt") / "model")
    save_jax_model(jm, path)
    trained = serve_bench_workflow(
        *TINY_GBT, TINY_D, TINY_SEED, device="cpu").set_input_dataset(
        bench_frame(TINY_ROWS, TINY_D, TINY_SEED)).train()
    return {"jax": jm, "path": path,
            "port": port.load_model(path, device="cpu"), "trained": trained}


def _rows(n, d=64, seed=3):
    return request_rows(score_frame(n, d, seed))


def _cfg(**kw):
    base = dict(max_batch=8, max_queue=64, max_wait_ms=2.0)
    base.update(kw)
    return ServeConfig(**base)


def _parts(model, recs):
    name = model.result_features[0].name
    return {k: np.asarray([r[name][k] for r in recs])
            for k in recs[0][name]}


# -- continuous batching ----------------------------------------------------

def test_batched_results_bit_equal_singleton(rf):
    rows = _rows(8)
    mb = micro_batch_score_function(rf)
    singleton = [mb([r])[0] for r in rows]
    with ServingRuntime(rf, "bit", _cfg(pipeline_depth=1),
                        auto_start=False) as rt:
        futs = [rt.submit(r) for r in rows]
        rt.start()
        batched = [f.result(timeout=30) for f in futs]
    assert batched == singleton
    snap = rt.metrics.snapshot()
    assert snap["tg_serve_rows_total"]["model=bit"] == 8.0
    assert snap["tg_serve_batch_rows"]["model=bit"]["count"] == 1


def test_flush_on_size_and_on_deadline(rf):
    """A full max_batch flushes at once; a lone request flushes when it
    ages past max_wait_ms."""
    with ServingRuntime(rf, "flush", _cfg(max_batch=4,
                                          max_wait_ms=30.0)) as rt:
        futs = [rt.submit(r) for r in _rows(4)]
        [f.result(timeout=30) for f in futs]
        assert rt.score(_rows(1)[0], timeout=30) is not None
    assert rt.metrics.snapshot()["tg_serve_batch_rows"][
        "model=flush"]["count"] >= 2


# -- backpressure and deadlines ---------------------------------------------

def test_queue_full_sheds_with_typed_overload_error(rf):
    row = _rows(1)[0]
    rt = ServingRuntime(rf, "of", _cfg(max_queue=2), auto_start=False)
    try:
        rt.submit(row)
        rt.submit(row)
        with pytest.raises(OverloadError, match="full"):
            rt.submit(row)
        snap = rt.metrics.snapshot()
        assert snap["tg_serve_shed_total"]["model=of,reason=overload"] == 1.0
        assert rt.summary()["shed"]["overload"] == 1.0
    finally:
        rt.start()
        rt.close()


def test_deadline_expiry_sheds_before_dispatch(rf, monkeypatch):
    """A request whose deadline passed while queued fails typed and never
    reaches the scorer: its deadline is set in the past while it waits in
    a staged queue."""
    import time
    rt = ServingRuntime(rf, "dl", _cfg(), auto_start=False)
    dispatched = []
    real_gather, real_scorer = rt._stages.gather, rt._scorer
    monkeypatch.setattr(rt._stages, "gather", lambda rows: dispatched.append(
        len(rows)) or real_gather(rows))
    monkeypatch.setattr(rt, "_scorer", lambda rows: dispatched.append(
        len(rows)) or real_scorer(rows))
    rows = _rows(2)
    expired = rt.submit(rows[0], deadline_ms=60_000)
    alive = rt.submit(rows[1], deadline_ms=60_000)
    rt._queue[0].deadline = time.monotonic() - 1.0
    rt.start()
    try:
        with pytest.raises(DeadlineExceededError, match="shed before"):
            expired.result(timeout=30)
        assert alive.result(timeout=30) is not None
        assert dispatched == [1]
        assert rt.summary()["shed"]["deadline"] == 1.0
    finally:
        rt.close()


def test_stopped_runtime_refuses_requests(rf):
    rt = ServingRuntime(rf, "stop", _cfg())
    rt.close()
    with pytest.raises(RuntimeStoppedError):
        rt.submit(_rows(1)[0])


# -- circuit breaker ----------------------------------------------------------

@pytest.mark.chaos
def test_breaker_open_halfopen_close_under_dispatch_chaos(rf):
    clk = [0.0]
    br = CircuitBreaker(name="cb", failure_threshold=2, reset_after=10.0,
                        clock=lambda: clk[0])
    row = _rows(1, seed=5)[0]
    eager = score_function(rf)(row)
    with faults.injected({"serve.dispatch": {
            "mode": "raise", "nth": 1, "count": 2, "transient": True}}):
        with ServingRuntime(rf, "cb", _cfg(max_wait_ms=1.0),
                            breaker=br) as rt:
            assert rt.metrics.snapshot()[
                "tg_breaker_state"]["model=cb"] == 0.0
            r1 = rt.score(row, timeout=30)
            assert br.state == "closed" and r1 == eager
            r2 = rt.score(row, timeout=30)
            assert br.state == "open" and r2 == eager
            assert rt.metrics.snapshot()[
                "tg_breaker_state"]["model=cb"] == 2.0
            assert rt.health_state() == "degraded"
            r3 = rt.score(row, timeout=30)
            assert br.state == "open" and r3 == eager
            clk[0] = 20.0
            r4 = rt.score(row, timeout=30)
            assert br.state == "closed" and r4 == eager
            s = rt.summary()
            assert s["degradedRows"] == 3.0
            assert s["breaker"]["opens"] == 1 and s["breaker"]["probes"] == 1
    degraded = rt.fault_log.of_kind("breaker_degraded")
    assert len(degraded) == 3
    assert {r.site for r in degraded} == {"serve.dispatch"}
    assert rt.fault_log.to_json()["breakerDegraded"]


@pytest.mark.chaos
def test_failed_probe_reopens(rf):
    clk = [0.0]
    br = CircuitBreaker(name="rp", failure_threshold=1, reset_after=5.0,
                        clock=lambda: clk[0])
    row = _rows(1, seed=6)[0]
    with faults.injected({"serve.dispatch": {
            "mode": "raise", "nth": 1, "count": 2, "transient": True}}):
        with ServingRuntime(rf, "rp", _cfg(max_wait_ms=1.0),
                            breaker=br) as rt:
            rt.score(row, timeout=30)
            assert br.state == "open"
            clk[0] = 10.0
            rt.score(row, timeout=30)
            assert br.state == "open" and br.snapshot()["opens"] == 2
            clk[0] = 20.0
            rt.score(row, timeout=30)
            assert br.state == "closed"


@pytest.mark.chaos
def test_flush_and_enqueue_chaos(rf):
    """A serve.flush fault degrades the flush without touching the
    breaker; a serve.enqueue fault is typed and leaves the runtime
    serving."""
    row = _rows(1, seed=7)[0]
    eager = score_function(rf)(row)
    with faults.injected({
            "serve.flush": {"mode": "raise", "nth": 1, "count": 1,
                            "transient": True},
            "serve.enqueue": {"mode": "raise", "nth": 1, "count": 1,
                              "transient": True}}):
        with ServingRuntime(rf, "fl", _cfg(max_wait_ms=1.0)) as rt:
            with pytest.raises(faults.TransientFaultError):
                rt.submit(row)
            out = rt.score(row, timeout=30)
            again = rt.score(row, timeout=30)
    assert out == eager and again == eager
    assert rt.breaker.snapshot()["consecutiveFailures"] == 0
    (rep,) = rt.fault_log.of_kind("breaker_degraded")
    assert rep.site == "serve.flush"


def test_score_error_quarantine_preserved_through_queue(rf):
    rows = _rows(2)
    with ServingRuntime(rf, "qr", _cfg(max_wait_ms=5.0),
                        auto_start=False) as rt:
        f_good = rt.submit(rows[0])
        f_bad = rt.submit(dict(rows[1], x3="not-a-number"))
        rt.start()
        good, bad = f_good.result(timeout=30), f_bad.result(timeout=30)
    assert SCORE_ERROR_KEY not in good
    assert SCORE_ERROR_KEY in bad and "x3" in bad[SCORE_ERROR_KEY]
    assert all(v is None for k, v in bad.items() if k != SCORE_ERROR_KEY)
    assert rt.summary()["quarantinedRows"] == 1.0


# -- registry, warm start, saves across the packages -------------------------

def test_registry_health_snapshot_and_isolation(rf):
    with ModelRegistry(_cfg(max_wait_ms=1.0)) as reg:
        reg.register("a", rf)
        reg.register("b", rf)
        assert reg.names() == ["a", "b"]
        with pytest.raises(ValueError, match="already registered"):
            reg.register("a", rf)
        reg.score("a", _rows(1)[0], timeout=30)
        h = reg.health()
        assert h["ready"] is True and set(h["models"]) == {"a", "b"}
        ha = h["models"]["a"]
        assert ha["state"] == "ready" and ha["breaker"]["state"] == "closed"
        assert ha["latency"]["count"] == 1
        assert {"p50", "p95", "p99"} <= set(ha["latency"])
        assert h["models"]["b"]["rowsScored"] == 0.0
        for _ in range(3):
            reg.runtime("b").breaker.record_failure()
        h = reg.health()
        assert h["models"]["b"]["state"] == "degraded"
        assert h["models"]["a"]["state"] == "ready" and h["ready"] is False
    assert reg.names() == []


def test_registry_requests_follow_a_swap_past_the_closed_runtime(rf):
    """A request that looked its runtime up just before a hot swap closed
    it goes on to the replacement (``submit`` and ``score``); with no
    replacement (unregistered) it is refused as before."""
    row = _rows(1)[0]
    want = micro_batch_score_function(rf)([row])[0]
    with ModelRegistry(_cfg(max_wait_ms=1.0)) as reg:
        reg.register("m", rf)
        old = reg.runtime("m")
        new = reg.swap("m", rf, warm=False)
        assert new is not old and not old.running
        lookup = reg.runtime
        stale = [old, old]
        reg.runtime = lambda name: stale.pop() if stale else lookup(name)
        assert reg.submit("m", row).result(timeout=30) == want
        assert reg.score("m", row, timeout=30) == want
        assert new.summary()["rowsScored"] == 2
        reg.unregister("m")
        stale.append(new)
        with pytest.raises(RuntimeStoppedError):
            reg.submit("m", row)


def test_warm_load_of_a_committed_fixture_copy(tmp_path):
    """registry.load(warm=True) of a copy of ``serve64/gbt``: the JAX
    package's recorded fingerprint matches the port's, the first request
    records no ledger build, and the committed files are byte-unchanged
    (the load may write into the directory it loads: a copy)."""
    src = os.path.join(SERVE64, "gbt")
    before = {f: open(os.path.join(src, f), "rb").read()
              for f in os.listdir(src)}
    path = shutil.copytree(src, str(tmp_path / "gbt"))
    with ModelRegistry(_cfg(max_wait_ms=1.0)) as reg:
        rt = reg.load("warm", path, device="cpu")
        info = rt.warm_info
        assert info["ok"] is True and info["fingerprintMatch"] is True
        assert {"rows", "plansWarmed", "compiles", "compileCauses",
                "aotHits", "aotMisses", "aotExports"} <= set(info)
        mark = ledger.ledger().mark()
        out = reg.score("warm", _rows(1)[0], timeout=30)
        assert not ledger.ledger().since(mark)
        assert SCORE_ERROR_KEY not in out
        assert reg.health()["models"]["warm"]["warm"]["fingerprintMatch"]
    assert {f: open(os.path.join(src, f), "rb").read()
            for f in os.listdir(src)} == before


def test_manifest_serving_entry_is_the_jax_packages(tiny):
    """The port's ``serving`` manifest section equals the JAX package's
    for the same saved model, and equals what the JAX save recorded."""
    from transmogrifai_tpu.serving.warmup import (
        manifest_serving_entry as jax_entry)
    from transmogrifai_tpu_torch.serving.warmup import manifest_serving_entry
    want = jax_entry(tiny["jax"])
    assert manifest_serving_entry(tiny["port"]) == json.loads(
        json.dumps(want))
    saved = json.load(open(os.path.join(tiny["path"], "MANIFEST.json")))
    assert saved["serving"] == json.loads(json.dumps(want))


def test_port_saved_model_warms_in_the_jax_registry(tiny, tmp_path):
    """A model the port trained and saved carries the ``serving`` and
    ``drift`` sections; the JAX registry loads it with
    ``fingerprintMatch`` true and attaches a drift monitor."""
    from transmogrifai_tpu.serving import (
        ModelRegistry as JaxRegistry, ServeConfig as JaxConfig)
    path = str(tmp_path / "port_saved")
    tiny["trained"].save(path)
    man = json.load(open(os.path.join(path, "MANIFEST.json")))
    assert man["serving"]["planFingerprint"] and man["drift"]["features"]
    with JaxRegistry(JaxConfig(max_batch=8, max_wait_ms=1.0)) as reg:
        rt = reg.load("ported", path)
        assert rt.warm_info["fingerprintMatch"] is True
        assert rt.drift_monitor is not None
        out = reg.score("ported", _rows(1, d=TINY_D)[0], timeout=60)
        assert SCORE_ERROR_KEY not in out


@pytest.mark.parametrize("key", ["tiny_gbt", "lr"])
def test_port_runtime_records_against_the_jax_runtime(tiny, key):
    """The port's runtime over a JAX-saved model (the tiny GBT; the
    committed linear ``serve64/lr``) against the JAX package's runtime
    over the JAX model, on the same rows and flushes: every probability
    within PROB_ATOL, decided predictions equal."""
    from transmogrifai_tpu.persistence import load_model as jax_load
    from transmogrifai_tpu.serving import (
        ServeConfig as JaxConfig, ServingRuntime as JaxRuntime)
    import transmogrifai_tpu.models.linear  # noqa: F401  (registers it)
    if key == "lr":
        path = os.path.join(SERVE64, "lr")
        pm, jm, d = port.load_model(path, device="cpu"), jax_load(path), 64
    else:
        pm, jm, d = tiny["port"], tiny["jax"], TINY_D
    rows = _rows(40, d=d, seed=4)
    with ServingRuntime(pm, "p", _cfg(pipeline_depth=2),
                        auto_start=False) as rt:
        futs = [rt.submit(r) for r in rows]
        rt.start()
        got = [f.result(timeout=30) for f in futs]
    with JaxRuntime(jm, "j", JaxConfig(max_batch=8, max_wait_ms=2.0),
                    auto_start=False) as rt:
        futs = [rt.submit(r) for r in rows]
        rt.start()
        want = [f.result(timeout=60) for f in futs]
    g, w = _parts(pm, got), _parts(pm, want)
    assert sorted(g) == sorted(w)
    for k in ("probability_0", "probability_1"):
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=PROB_ATOL)
    decided = np.abs(w["probability_1"] - 0.5) > PRED_MARGIN
    np.testing.assert_array_equal(g["prediction"][decided],
                                  w["prediction"][decided])


def test_gbt_records_across_cpu_flush_sizes_within_an_ulp(tiny):
    """The binary GBT's probability is ``torch.sigmoid`` of its margin:
    on the CPU its vectorized lanes and its scalar tail round differently,
    so a row's record could move by an ulp with the flush it lands in.
    The predict runs at the rows' padding bucket (256 rows for both
    flushes here), so it no longer does; the limit stays. Pinned: a row
    scored alone and inside a 37-row flush within 2 ulps of 0.5."""
    mb = micro_batch_score_function(tiny["port"])
    rows = _rows(37, d=TINY_D, seed=8)
    one = _parts(tiny["port"], [mb([r])[0] for r in rows])
    odd = _parts(tiny["port"], mb(rows))
    for k in one:
        np.testing.assert_allclose(one[k], odd[k], rtol=0,
                                   atol=2 * np.spacing(np.float32(0.5)))


def test_loaded_model_serves_bit_equal_to_original(rf, tmp_path):
    path = str(tmp_path / "model")
    rf.save(path)
    rows = _rows(4, seed=11)
    expect = micro_batch_score_function(rf)(rows)
    with ModelRegistry(_cfg(max_wait_ms=2.0)) as reg:
        rt = reg.load("m", path, device="cpu")
        futs = [rt.submit(r) for r in rows]
        got = [f.result(timeout=30) for f in futs]
    assert got == expect


# -- the fault log's ring ----------------------------------------------------

def test_fault_log_ring_bounds_reports(monkeypatch):
    monkeypatch.setenv("TG_FAULTS_MAX", "8")
    log = FaultLog()
    for i in range(20):
        log.add(FaultReport(site="s", kind="retry", detail={"i": i}))
    assert len(log.reports) == 8 and log.dropped == 12
    assert [r.detail["i"] for r in log.reports] == list(range(12, 20))
    assert log.to_json()["droppedReports"] == 12
    small = FaultLog(max_reports=2)
    for _ in range(5):
        small.add(FaultReport(site="s", kind="retry"))
    assert len(small.reports) == 2 and small.dropped == 3


# -- load generation ---------------------------------------------------------

def _fired(site):
    return faults.fired_counts().get(site, {}).get("raise", 0)


@pytest.mark.chaos
def test_chaos_soak_all_sites_with_overload(rf):
    """serve.enqueue / serve.flush / serve.dispatch faults under open loops
    far above capacity over a tiny queue: every offered request accounted
    for in every run, no untyped failure, the three enqueue faults counted
    as submit errors, the breaker seen in the summary.

    A loaded host can starve the generator: one submit that stalls for
    the whole 0.5 s leaves a run with a single offered request. So runs
    repeat until the enqueue faults fired inside them and one overflowed
    the queue, and requests go one at a time until the four dispatch
    faults fired (an open breaker dispatches again after its 50 ms
    reset): how many runs that takes is the host's business, what each
    run must account for is not."""
    rows = _rows(64, seed=5)
    with faults.injected({
            "serve.enqueue": {"mode": "raise", "nth": 10, "count": 3,
                              "transient": True},
            "serve.flush": {"mode": "raise", "nth": 2, "count": 1,
                            "transient": True},
            "serve.dispatch": {"mode": "raise", "nth": 2, "count": 4,
                               "transient": True}}):
        with ServingRuntime(rf, "soak", _cfg(max_batch=16, max_queue=32,
                                             max_wait_ms=1.0,
                                             breaker_failures=3,
                                             breaker_reset_ms=50.0)) as rt:
            reports = []
            while len(reports) < 60 and not (
                    _fired("serve.enqueue") >= 3
                    and sum(r["shedOverload"] for r in reports)):
                # a deadline the CPU path's flushes meet
                reports.append(run_open_loop(rt, rows, seconds=0.5,
                                             rps=4000.0, deadline_ms=1000.0))
            for i in range(100000):
                if _fired("serve.dispatch") >= 4:
                    break
                rt.score(rows[i % len(rows)], timeout=30)
            summary = rt.summary()
            assert rt.running
    for report in reports:
        assert report["accountingOk"] and report["lost"] == 0
        assert report["failed"] == 0
    assert sum(r["completed"] for r in reports) > 0
    assert sum(r["shedOverload"] for r in reports) > 0
    assert sum(r["submitErrors"] for r in reports) == 3
    assert summary["degradedRows"] >= 1
    assert summary["breaker"]["opens"] >= 1


def test_open_loop_accounting_adds_up(rf):
    """offered = completed + shed + deadline + failed over a 0.5 s run."""
    with ServingRuntime(rf, "ol", _cfg(max_batch=16, max_queue=256)) as rt:
        rep = run_open_loop(rt, _rows(32, seed=12), seconds=0.5, rps=400.0)
    assert rep["offered"] == (rep["completed"] + rep["shedOverload"]
                              + rep["shedDeadline"] + rep["shedNoReplica"]
                              + rep["submitErrors"] + rep["failed"]
                              + rep["lost"])
    assert rep["accountingOk"] and rep["lost"] == 0 and rep["completed"]
    assert rep["slowestRequests"] and rep["p99Ms"] >= rep["p50Ms"]
    # the socket twin through the network edge: the same identity in rows,
    # with its per-protocol breakdown
    with ServingRuntime(rf, "olw", _cfg(max_batch=16, max_queue=256)) as rt:
        with NetEdge(rt, name="olw-edge") as edge:
            wire = run_wire_open_loop(*edge.address, _rows(32, seed=12),
                                      seconds=0.5, rps=200.0, batch_rows=4)
    assert wire["offered"] == (wire["completed"] + wire["shedOverload"]
                               + wire["shedDeadline"]
                               + wire["shedNoReplica"]
                               + wire["shedDisconnect"]
                               + wire["submitErrors"] + wire["failed"]
                               + wire["lost"])
    assert wire["accountingOk"] and wire["lost"] == 0
    assert wire["failed"] == 0 and wire["completed"]
    assert set(wire["protocols"]) == {"http", "binary"}


def test_loadgen_synthetic_rows_match_schema(rf):
    from transmogrifai_tpu.serving.loadgen import (
        synthetic_rows as jax_synthetic_rows)
    rows = synthetic_rows(rf, 16, seed=2)
    assert rows == jax_synthetic_rows(rf, 16, seed=2)
    assert {"x0", "x63", "y"} <= set(rows[0])
    assert all(SCORE_ERROR_KEY not in r
               for r in micro_batch_score_function(rf)(rows[:4]))


# -- observability -----------------------------------------------------------

def test_serve_metrics_mirrored_when_enabled(rf):
    from transmogrifai_tpu_torch.observability import metrics as om
    from transmogrifai_tpu_torch.observability import summarize
    om.enable_metrics(True)
    try:
        with ServingRuntime(rf, "obs", _cfg(max_wait_ms=1.0)) as rt:
            rt.score(_rows(1)[0], timeout=30)
        obs = summarize()
        assert obs["serving"]["tg_serve_rows_total"]["model=obs"] == 1.0
        assert "tg_breaker_state" in obs["serving"]
        assert not any(k.startswith("tg_serve_") for k in obs["counters"])
        prom = om.registry().to_prometheus()
        assert 'tg_serve_request_seconds_bucket{model="obs",le="+Inf"} 1' \
            in prom
        assert 'tg_breaker_state{model="obs"}' in prom
    finally:
        om.enable_metrics(None)


def test_serve_local_metrics_do_not_touch_global_registry(rf):
    from transmogrifai_tpu_torch.observability import metrics as om
    assert not om.metrics_enabled()
    with ServingRuntime(rf, "off", _cfg(max_wait_ms=1.0)) as rt:
        rt.score(_rows(1)[0], timeout=30)
    assert om.registry().snapshot() == {}
    assert rt.summary()["latency"]["count"] == 1


def test_vectorized_table_builder_byte_identical(tiny):
    """The fast homogeneous gather gives the exact per-cell path's table,
    for homogeneous rows and with missing cells, a missing field, bool and
    int scalars; ``ServeStages.gather`` gives the same table; the
    record view gives the scored table's python values."""
    from transmogrifai_tpu_torch.local.scoring import (
        ServeStages, _exact_column)
    model = tiny["port"]
    build = serve_table_builder(model)
    rows = _rows(64, d=TINY_D)
    rows[5] = {"x0": None, "x1": float("nan"), "x2": 0.5}
    rows[6] = {"x1": 0.25}
    rows[7] = {"x0": True, "x1": 3, "x2": -1}
    table = build(rows)
    staged = ServeStages(model).gather(rows)
    for f in model.raw_features:
        ref = _exact_column(f, [f.origin_stage.extract(r) for r in rows])
        for got in (table[f.name], staged[f.name]):
            assert got.values.dtype == ref.values.dtype
            np.testing.assert_array_equal(got.values, ref.values)
            np.testing.assert_array_equal(got.valid_mask(), ref.valid_mask())
    scored = model.score(table=build(rows[:8]))
    recs = serve_record_builder(model)(scored, 8)
    col = scored[model.result_features[0].name]
    keys = col.metadata["keys"]
    for i, rec in enumerate(recs):
        v = col.values[i].tolist()
        assert rec[model.result_features[0].name] == dict(zip(keys, v))
