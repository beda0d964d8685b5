"""The PyTorch port's front door and its replicas on their own
(``transmogrifai_tpu_torch/serving/{frontdoor,fleet,replica_worker}.py``;
the cases of ``tests/test_fleet.py`` that need no JAX model, on the port's
CPU path): load-aware routing, chaos at the ``fleet.*`` sites, the probe
ladder, rolling deploys, pre-flight admission, SLO burn, autoscale, the
load generator through the door, the leak oracle; one subprocess replica
on ``--device cpu`` (a round trip and a kill), the worker's imports, and
the refusal of a CUDA replica without a card.

They serve the committed JAX-saved ``serve64/rf`` (64 predictors), whose
records are bit-equal to the micro-batch scorer at any flush size.
Nothing here depends on the host's speed: queue depths are staged with
the batchers held (``testing.held_flushes``), probes are manual (``probe_interval_ms=0``), faults
fire by count, and clocks are injected. The parity with the JAX package's
front door is in ``test_torch_fleet.py``.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest
import jax  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import transmogrifai_tpu_torch as port  # noqa: E402
from transmogrifai_tpu_torch.local.scoring import (  # noqa: E402
    micro_batch_score_function,
)
from transmogrifai_tpu_torch.observability import devicemem  # noqa: E402
from transmogrifai_tpu_torch.observability import slo as slo_mod  # noqa: E402
from transmogrifai_tpu_torch.observability import timeseries as ts_mod  # noqa: E402
from transmogrifai_tpu_torch.robustness import faults, oracles  # noqa: E402
from transmogrifai_tpu_torch.serving import (  # noqa: E402
    AdmissionRefusedError, FleetConfig, FrontDoor, OverloadError,
    ReplicaLostError, ReplicaSpawnError, ServeConfig, SubprocessReplica,
    live_fleets,
)
from transmogrifai_tpu_torch.serving.loadgen import run_open_loop  # noqa: E402
from transmogrifai_tpu_torch.testing import (  # noqa: E402
    close_serving_state, held_flushes, request_rows, score_frame,
)

pytestmark = pytest.mark.fleet

SERVE64 = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures",
                       "serve64")


@pytest.fixture(autouse=True)
def _clean_serving(tmp_path, monkeypatch):
    monkeypatch.setenv("TG_POSTMORTEM_DIR", str(tmp_path / "postmortems"))
    yield
    leaks = close_serving_state()
    assert not leaks, f"the test leaked serving state: {leaks}"


@pytest.fixture(scope="module")
def rf_path(tmp_path_factory):
    """A copy of the committed ``serve64/rf`` (a load may write into it)."""
    d = str(tmp_path_factory.mktemp("frontdoor_rf") / "rf")
    shutil.copytree(os.path.join(SERVE64, "rf"), d)
    return d


@pytest.fixture(scope="module")
def rf(rf_path):
    return port.load_model(rf_path, device="cpu")


def _rows(n=24, seed=57):
    return request_rows(score_frame(n, 64, seed))


def _cfg(**kw):
    """Slow-flush default: requests sit queued for up to 500 ms, so queue
    depths (and mid-flight kills) are deterministic."""
    base = dict(max_batch=64, max_queue=256, max_wait_ms=500.0)
    base.update(kw)
    return ServeConfig(**base)


def _fc(**kw):
    """Manual probing, no autoscale, replicas on the CPU."""
    base = dict(min_replicas=1, max_replicas=4, probe_interval_ms=0.0,
                probe_failures=3, readmit_probes=2, max_failovers=2,
                autoscale=False, device="cpu")
    base.update(kw)
    return FleetConfig(**base)


def _fleet(model, replicas=2, cfg=None, fc=None, **kw):
    return FrontDoor({"m": model}, replicas=replicas,
                     config=cfg or _cfg(), fleet_config=fc or _fc(), **kw)


# -- routing, chaos and sheds ------------------------------------------------

def test_routing_prefers_shallow_queues(rf):
    rows = _rows(12)
    with _fleet(rf) as fd, held_flushes() as release:
        r0 = fd._replicas["r0"]
        staged = [r0.submit("m", r) for r in rows[:6]]
        routed = [fd.submit(r) for r in rows[6:]]
        dist = fd.replica_distribution()
        assert dist["r1"] == 6 and dist["r0"] == 0, dist
        release.set()
        for f in staged + routed:
            assert f.result(timeout=30) is not None


def test_routing_balances_empty_queues(rf):
    rows = _rows(16)
    with _fleet(rf) as fd, held_flushes() as release:
        futs = [fd.submit(r) for r in rows]
        assert fd.replica_distribution() == {"r0": 8, "r1": 8}
        release.set()
        recs = [f.result(timeout=30) for f in futs]
    assert recs == micro_batch_score_function(rf)(list(rows))


@pytest.mark.chaos
def test_replica_kill_chaos_site_typed_accounting(rf):
    rows = _rows(12)
    baseline = micro_batch_score_function(rf)(list(rows))
    with faults.injected({"fleet.replica_kill":
                          {"mode": "raise", "nth": 1, "count": 1}}):
        with _fleet(rf) as fd:
            recs = [f.result(timeout=30)
                    for f in [fd.submit(r) for r in rows]]
            assert recs == baseline
            assert fd.fleet_snapshot()["kills"] == 1
            states = [r.state for r in fd._replicas.values()]
            assert states.count("dead") == 1


@pytest.mark.chaos
def test_route_chaos_fails_over_bit_equal(rf):
    rows = _rows(8)
    baseline = micro_batch_score_function(rf)(list(rows))
    with faults.injected({"fleet.route":
                          {"mode": "raise", "nth": 1, "count": 2}}):
        with _fleet(rf) as fd:
            recs = [f.result(timeout=30)
                    for f in [fd.submit(r) for r in rows]]
            assert recs == baseline
            assert fd.fleet_snapshot()["failovers"] == 2
            kinds = [r.kind for r in fd.fault_log.reports]
            assert kinds.count("fleet_failover") == 2


def test_no_healthy_replica_sheds_typed_pre_dispatch(rf):
    with _fleet(rf) as fd:
        calls = []
        for rep in fd._replicas.values():
            rt = rep.registry.runtime("m")
            orig = rt._scorer
            rt._scorer = (lambda rs, _o=orig: (calls.append(len(rs))
                                               or _o(rs)))
        fd.kill_replica("r0")
        fd.kill_replica("r1")
        for r in _rows(4):
            with pytest.raises(OverloadError):
                fd.submit(r)
        assert calls == []
        assert fd.fleet_snapshot()["sheds"]["no_replica"] == 4.0


@pytest.mark.chaos
def test_failover_budget_exhausts_typed(rf):
    with faults.injected({"fleet.route":
                          {"mode": "raise", "nth": 1, "count": 99}}):
        with _fleet(rf, fc=_fc(max_failovers=2)) as fd:
            with pytest.raises(OverloadError):
                fd.submit(_rows(1)[0])
            snap = fd.fleet_snapshot()
            assert snap["failovers"] == 3
            assert snap["sheds"]["no_replica"] == 1.0


@pytest.mark.chaos
def test_ejection_and_readmission_ladder(rf):
    rows = _rows(6)
    with _fleet(rf, fc=_fc(probe_failures=2, readmit_probes=2)) as fd:
        with faults.injected({"fleet.probe": {"mode": "raise", "nth": 1,
                                              "count": 2, "key": "r0"}}):
            fd.probe_now()
            assert fd._replicas["r0"].state == "active"
            fd.probe_now()
            assert fd._replicas["r0"].state == "ejected"
        kinds = [r.kind for r in fd.fault_log.reports]
        assert kinds.count("fleet_probe_failed") == 2
        assert "fleet_ejected" in kinds
        futs = [fd.submit(r) for r in rows]
        assert fd.replica_distribution() == {"r0": 0, "r1": 6}
        [f.result(timeout=30) for f in futs]
        fd.probe_now()
        assert fd._replicas["r0"].state == "ejected"
        fd.probe_now()
        assert fd._replicas["r0"].state == "active"
        snap = fd.fleet_snapshot()
        assert snap["ejections"] == 1 and snap["readmissions"] == 1


def test_degraded_readiness_ejects_immediately(rf):
    with _fleet(rf) as fd:
        rt = fd._replicas["r0"].registry.runtime("m")
        rt.breaker.trip(error=RuntimeError("staged device failure"))
        fd.probe_now()
        assert fd._replicas["r0"].state == "ejected"
        reasons = [r.detail.get("reason", "")
                   for r in fd.fault_log.of_kind("fleet_ejected")]
        assert any("degraded readiness" in r for r in reasons)


def test_rolling_deploy_zero_loss(rf, rf_path):
    rows = _rows(24)
    baseline = micro_batch_score_function(rf)(list(rows))
    with _fleet(rf) as fd:
        before = [fd.submit(r) for r in rows[:12]]
        report = fd.deploy(rf_path)
        assert [r["ok"] for r in report] == [True, True]
        after = [fd.submit(r) for r in rows[12:]]
        recs = [f.result(timeout=30) for f in before + after]
        assert recs == baseline
        snap = fd.fleet_snapshot()
        assert snap["sheds"] == {"overload": 0.0, "deadline": 0.0,
                                 "admission": 0.0, "no_replica": 0.0,
                                 "placement": 0.0, "unknown_model": 0.0}
        assert snap["counts"] == {"active": 2}
        assert fd.deploy_history[-1]["ok"] and fd.models["m"] == rf_path
        # the deployed directory loaded onto the replicas' device
        rt = fd._replicas["r0"].registry.runtime("m")
        assert str(rt.model.device) == "cpu"


def test_admission_refusal_typed_and_pre_dispatch(rf):
    devicemem.record_cost("seg0", 256, 10 ** 9)
    with _fleet(rf, replicas=1, fc=_fc(device_budget=10 ** 6)) as fd:
        plan = fd._admission
        assert plan["refused"] and plan["estBytes"] == 10 ** 9
        rt = fd._replicas["r0"].registry.runtime("m")
        calls = []
        orig = rt._scorer
        rt._scorer = lambda rs, _o=orig: calls.append(len(rs)) or _o(rs)
        for r in _rows(4):
            with pytest.raises(AdmissionRefusedError):
                fd.submit(r)
        assert calls == []
        assert fd.fleet_snapshot()["sheds"]["admission"] == 4.0
        assert not fd.health()["ready"]


def test_admission_split_lowers_flush_bucket(rf):
    devicemem.record_cost("seg0", 256, 500)
    with _fleet(rf, cfg=_cfg(max_batch=1024, max_wait_ms=2.0),
                fc=_fc(device_budget=600)) as fd:
        plan = fd._admission
        assert plan["split"] and plan["admittedRows"] == 256
        assert not plan["refused"]
        for rep in fd._replicas.values():
            assert rep.registry.runtime("m").config.max_batch == 256
        assert fd.submit(_rows(1)[0]).result(timeout=30) is not None
        assert "admission_split" in {r.kind for r in fd.fault_log.reports}


def test_admission_admits_without_cost_rows(rf):
    """The port's cost table is empty unless a model's costs were loaded:
    admission admits (it consumes telemetry, it does not guess)."""
    assert devicemem.observatory().cost_table() == {}
    with _fleet(rf, replicas=1, cfg=_cfg(max_wait_ms=2.0),
                fc=_fc(device_budget=1)) as fd:
        assert fd._admission["basis"] == "no-cost-rows"
        assert fd.submit(_rows(1)[0]).result(timeout=30)


def test_frontdoor_shed_moves_slo_burn_rate(rf):
    with _fleet(rf, replicas=1) as fd:
        now = [0.0]
        sampler = ts_mod.MetricsSampler(fd.metrics, name="t",
                                        clock=lambda: now[0], every_s=0.1)
        sampler.tick()
        tracker = slo_mod.SLOTracker(
            slo_mod.SLOSpec(model="m", window_s=720.0), sampler,
            fd.metrics, runtime=fd, clock=lambda: now[0])
        fd.kill_replica("r0")
        for r in _rows(10):
            with pytest.raises(OverloadError):
                fd.submit(r)
        now[0] = 0.5
        sampler.tick()
        avail = tracker.evaluate(now=now[0])["objectives"]["availability"]
        assert avail["badFraction"] == 1.0
        assert avail["burn"]["page"]["long"] >= 14.4
        assert avail["alerts"]["page"] is True
        gauges = fd.metrics.snapshot()["tg_slo_burn_rate"]
        assert gauges["model=m,slo=availability"] > 0.0


def test_autoscale_up_down_from_staged_scale_hints(rf):
    with _fleet(rf, replicas=1, cfg=_cfg(max_wait_ms=2.0),
                fc=_fc(min_replicas=1, max_replicas=3)) as fd:
        assert fd.autoscale_now(hints=["up"]) == "up"
        assert sorted(fd._replicas) == ["r0", "r1"]
        assert fd.autoscale_now(hints=["up", "hold"]) == "up"
        assert fd.autoscale_now(hints=["up"]) == "up"
        assert len([r for r in fd._replicas.values()
                    if r.state == "active"]) == 3
        assert fd.submit(_rows(1)[0]).result(timeout=30)
        assert fd.autoscale_now(hints=["down"] * 3) == "down"
        assert fd._replicas["r2"].state == "retired"
        assert fd.autoscale_now(hints=["down", "down"]) == "down"
        assert fd.autoscale_now(hints=["down"]) == "down"
        assert len([r for r in fd._replicas.values()
                    if r.state == "active"]) == 1
        assert [e["direction"] for e in fd.scale_events] == [
            "up", "up", "down", "down"]


def test_autoscale_from_cached_probe_hints(rf):
    with _fleet(rf, replicas=1, fc=_fc(max_replicas=2)) as fd:
        fd._replicas["r0"].probe.scale_hints = {"m": "up"}
        assert fd.autoscale_now() == "up"
        assert sorted(fd._replicas) == ["r0", "r1"]


def test_loadgen_over_frontdoor_accounting_and_distribution(rf):
    with _fleet(rf, cfg=_cfg(max_wait_ms=2.0)) as fd:
        rep = run_open_loop(fd, _rows(64), seconds=0.6, rps=400.0)
    assert rep["accountingOk"]
    assert rep["lost"] == 0 and rep["failed"] == 0
    assert rep["shedNoReplica"] == 0
    assert set(rep["replicas"]) == {"r0", "r1"}
    assert sum(rep["replicas"].values()) == rep["completed"]
    assert rep["fleet"]["failovers"] == 0


def test_fleet_leak_oracle_detects_and_cleans(rf):
    fd = _fleet(rf, replicas=1, name="leaky")
    assert "leaky" in oracles.leaked_fleets()
    assert fd in live_fleets()
    assert oracles.close_leaked_fleets() == ["leaky"]
    assert oracles.leaked_fleets() == []
    assert not oracles.leaked_threads(("tg-fleet", "tg-serve"))


def test_campaign_violations_sweep_and_the_histeng_probe(rf):
    """``campaign_violations`` reports a leaked fleet and closes it, and
    the histogram engine's probe sees a full-f32 block left open."""
    from transmogrifai_tpu_torch.histeng import kernels as HK
    _fleet(rf, replicas=1, name="swept")
    assert any("swept" in v for v in oracles.campaign_violations())
    assert oracles.campaign_violations() == []
    block = HK._tf32_off()
    block.__enter__()
    try:
        assert oracles.histeng_violations() == [
            "1 full-f32 block(s) of the histogram engine still open"]
    finally:
        block.__exit__(None, None, None)
    assert oracles.histeng_violations() == []


def test_a_replica_without_its_cuda_device_fails_its_spawn(rf_path):
    """No fallback: a replica asked for the CUDA device where there is none
    refuses typed before anything is spawned."""
    if __import__("torch").cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(ReplicaSpawnError, match="no CUDA device"):
        SubprocessReplica("r0", {"m": rf_path})
    with pytest.raises(ReplicaSpawnError):
        _fleet(rf_path, replicas=1, fc=_fc(device=None, subprocess=True))
    assert oracles.leaked_fleets() == []


# -- subprocess replicas ------------------------------------------------------

def test_subprocess_replica_round_trip_and_kill(rf, rf_path):
    """One child on ``--device cpu``: records bit-equal across the JSON
    pipe, its health names its device, a SIGKILL fails it typed."""
    rows = _rows(6)
    baseline = micro_batch_score_function(rf)(list(rows))
    rep = SubprocessReplica("r0", {"m": rf_path}, config=_cfg(
        max_wait_ms=2.0), device="cpu")
    try:
        assert rep.device == "cpu" and rep.spawn_seconds > 0
        recs = [f.result(timeout=60)
                for f in [rep.submit("m", r) for r in rows]]
        assert recs == baseline
        h = rep.health(timeout=30)
        assert h["ready"] and h["device"]["device"] == "cpu"
        assert h["device"]["pid"] != os.getpid()
    finally:
        rep.kill()
    with pytest.raises(ReplicaLostError):
        rep.submit("m", rows[0])
    assert not oracles.leaked_threads(("tg-fleet",))


def test_the_worker_imports_no_jax_and_refuses_what_it_cannot_serve(
        rf_path, tmp_path):
    """The worker, the fleet tier and the oracles import neither ``jax``
    nor the JAX package (checked in a child that then runs the worker);
    a worker told a device it cannot serve on (``cuda:0`` without a card)
    or a model it cannot load answers ``ready: false`` with the typed
    ``ReplicaSpawnError`` on its protocol stream and exits 1."""
    import torch
    device, model = (("cpu", str(tmp_path / "missing"))
                     if torch.cuda.is_available() else ("cuda:0", rf_path))
    code = (
        "import sys\n"
        "import transmogrifai_tpu_torch.serving.fleet\n"
        "import transmogrifai_tpu_torch.serving.frontdoor\n"
        "import transmogrifai_tpu_torch.serving.netedge\n"
        "import transmogrifai_tpu_torch.robustness.oracles\n"
        "from transmogrifai_tpu_torch.serving import replica_worker\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'transmogrifai_tpu' or "
        "m.startswith('transmogrifai_tpu.')]\n"
        "print('imported:', bad, file=sys.stderr)\n"
        "sys.exit(replica_worker.main(sys.argv[1:]))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code, "--device", device,
         "--model", f"m={model}"],
        stdin=subprocess.DEVNULL, capture_output=True, text=True, env=env,
        timeout=120)
    assert "imported: []" in proc.stderr, proc.stderr
    assert proc.returncode == 1, proc.stderr
    msg = json.loads(proc.stdout.strip().splitlines()[-1])
    assert msg["ready"] is False
    assert msg["error"]["type"] == "ReplicaSpawnError"
    if device.startswith("cuda"):
        assert "CUDA" in msg["error"]["msg"]
