"""The PyTorch port's observability package against the JAX package's
(``transmogrifai_tpu_torch/observability``; the cases of
``tests/test_observability.py``, ``test_blackbox.py``, ``test_slo.py`` and
``test_ledger.py`` that need no plan compiler and no program store).

Each case feeds the same sequence to both packages, made from a seed with
numpy, with a fake clock where a clock is read, and compares what comes
out: metric snapshots, quantiles and Prometheus text equal; span trees and
Chrome-trace documents equal with their times masked; flight-recorder
rings, correlation ids (the process id and sequence masked), post-mortem
bundle layouts and the dump rate limit the same; windowed rates and
burn-rate alerts firing and clearing at the same samples; compile-ledger
records (times and correlation masked) and ``fingerprint_diff`` equal. The
port's ``devicemem.memory_stats()`` is None on the CPU, as the JAX
package's is on a device without stats. Every comparison is exact: the
two packages run the same float64 host arithmetic.
"""
from __future__ import annotations

import json
import os
import re
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import jax  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import transmogrifai_tpu.observability as jax_obs  # noqa: E402
import transmogrifai_tpu.robustness.policy as jax_policy  # noqa: E402
import transmogrifai_tpu_torch.observability as port_obs  # noqa: E402
import transmogrifai_tpu_torch.robustness.policy as port_policy  # noqa: E402
from transmogrifai_tpu_torch.testing import close_serving_state  # noqa: E402

pytestmark = [pytest.mark.ledger, pytest.mark.slo, pytest.mark.blackbox]

PACKAGES = {"jax": (jax_obs, jax_policy), "port": (port_obs, port_policy)}


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    monkeypatch.setenv("TG_POSTMORTEM_DIR", str(tmp_path / "postmortems"))
    for obs, _ in PACKAGES.values():
        obs.reset()
    yield
    for obs, _ in PACKAGES.values():
        obs.metrics.enable_metrics(None)
        obs.trace.enable_tracing(None)
        obs.blackbox.enable_blackbox(None)
        obs.ledger.enable_ledger(None)
        obs.timeseries.enable_sampler(None)
        obs.reset()
    leaks = close_serving_state()
    assert not leaks, f"the test leaked serving state: {leaks}"


class _Clock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t


def _masked(obj, keys=("tsNs", "durNs", "ts", "dur", "unixTime", "epochUnix",
                       "tid", "seconds", "secondsTotal", "pid", "path")):
    """``obj`` with every time, thread, process and path field zeroed."""
    if isinstance(obj, dict):
        return {k: (0 if k in keys else _masked(v, keys))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_masked(v, keys) for v in obj]
    if isinstance(obj, str):
        # correlation ids, <prefix>-<pid hex>-<sequence hex>: the sequence
        # is process-wide, so earlier tests move it
        return re.sub(r"^(\w+)-[0-9a-f]+-[0-9a-f]{6}$", r"\1-id", obj)
    return obj


def _both(drive):
    out = {name: drive(obs, policy)
           for name, (obs, policy) in PACKAGES.items()}
    assert out["port"] == out["jax"]
    return out["port"]


# -- metrics -----------------------------------------------------------------

def _drive_metrics(obs, policy):
    om = obs.metrics
    reg = om.MetricsRegistry(max_labels=3)
    rng = np.random.RandomState(0)
    vals = rng.lognormal(0.0, 0.5, 4000)
    h = reg.histogram("tg_lat_seconds", help="latency", model="m")
    for i, v in enumerate(vals):
        h.observe(float(v), exemplar=f"req-{i}")
    reg.counter("tg_things_total", help="things", kind="a").inc(3)
    reg.counter("tg_things_total", kind="b").inc()
    reg.gauge("tg_level", help="a level").set(0.25)
    for i in range(10):                  # past the label-cardinality bound
        reg.gauge("g", feature=f"f{i}").set(float(i))
    errors = []
    for bad in (lambda: reg.gauge("tg_things_total"),
                lambda: reg.counter("tg_things_total").inc(-1)):
        try:
            bad()
        except ValueError as e:
            errors.append(type(e).__name__)
    om.enable_metrics(True)
    om.inc_counter("tg_global_total", 2.0, help="x", site="s")
    om.observe("tg_global_seconds", 0.5)
    om.set_gauge("tg_global_gauge", 7.0, model="m")
    return {"snapshot": reg.snapshot(),
            "quantiles": [h.quantile(q) for q in (0.5, 0.95, 0.99)],
            "overflowed": dict(reg.overflowed),
            "prometheus": reg.to_prometheus(),
            "compat": reg.to_prometheus(compat=True),
            "errors": errors, "global": om.registry().snapshot()}


def test_metrics_snapshots_quantiles_and_prometheus_text_are_equal():
    out = _both(_drive_metrics)
    snap = out["snapshot"]
    assert snap["tg_things_total"] == {"": 0.0, "kind=a": 3.0, "kind=b": 1.0}
    assert snap["g"]["feature=__other__"] == 9.0
    assert out["overflowed"] == {"g": 7}
    assert 'tg_lat_seconds_bucket{model="m",le="+Inf"} 4000' in \
        out["prometheus"]
    assert out["errors"] == ["ValueError", "ValueError"]


def test_env_switches(monkeypatch):
    for obs, _ in PACKAGES.values():
        ot, om = obs.trace, obs.metrics
        assert not ot.tracing_enabled() and not om.metrics_enabled()
        monkeypatch.setenv("TG_TRACE", "1")
        assert ot.tracing_enabled() and om.metrics_enabled()
        monkeypatch.setenv("TG_METRICS", "0")
        assert not om.metrics_enabled()
        monkeypatch.delenv("TG_TRACE")
        monkeypatch.setenv("TG_METRICS", "1")
        assert om.metrics_enabled() and not ot.tracing_enabled()
        monkeypatch.delenv("TG_METRICS")


# -- spans and exporters -----------------------------------------------------

def _drive_trace(obs, policy, tmp_dir):
    ot, oe = obs.trace, obs.export
    with ot.span("off", k=1) as s:
        s.set_attr(a=2).add_event("e")
    disabled = s is ot.NULL_SPAN and ot.tracer().finished() == []
    ot.enable_tracing(True)
    obs.metrics.enable_metrics(True)
    with ot.span("outer", cat="train", uid="u1", k=1):
        with ot.span("inner") as si:
            si.add_event("evt", n=2)
        ot.add_event("marker", x=1)
        with ot.span("inner2"):
            policy.FaultLog.record(policy.FaultReport(site="s",
                                                      kind="retry"))
    ot.add_event("standalone", reason="r")
    bounded = ot.Tracer(max_spans=4)
    for i in range(7):
        bounded.end(bounded.start(f"s{i}"))
    tmp_dir = os.path.join(tmp_dir, obs.__name__)
    os.makedirs(tmp_dir)
    oe.write_chrome_trace(os.path.join(tmp_dir, "trace.json"))
    oe.write_jsonl(os.path.join(tmp_dir, "spans.jsonl"))
    spans = ot.tracer().finished()
    summary = obs.summarize()
    return {"disabled": disabled,
            "spans": _masked([sp.to_json() for sp in spans]),
            "chrome": _masked(json.load(open(os.path.join(
                tmp_dir, "trace.json")))),
            "jsonl": _masked([json.loads(line) for line in open(
                os.path.join(tmp_dir, "spans.jsonl")) if line.strip()]),
            "bounded": ([s.name for s in bounded.finished()],
                        bounded.dropped),
            "byName": sorted(summary["byName"]),
            "keys": sorted(summary),
            "counters": summary["counters"]}


def test_span_trees_and_chrome_trace_are_equal(tmp_path):
    out = _both(lambda obs, policy: _drive_trace(obs, policy,
                                                 str(tmp_path)))
    assert out["disabled"]
    names = [s["name"] for s in out["spans"]]
    assert names == ["inner", "inner2", "outer", "standalone"]
    assert out["bounded"] == (["s3", "s4", "s5", "s6"], 3)
    assert {e["ph"] for e in out["chrome"]["traceEvents"]} == {"X", "i"}
    assert out["counters"]["tg_faults_total"] == {"kind=retry": 1.0}


# -- the flight recorder, correlation, post-mortems --------------------------

def _drive_blackbox(obs, policy):
    bb = obs.blackbox
    rec = bb.FlightRecorder(max_events=8)
    for i in range(12):
        rec.record("e", i=i)
    corr = bb.new_correlation_id("run")
    with bb.correlated(corr):
        bb.record("inside")
        inner = bb.current_correlation()
    bb.record("outside")
    bb.enable_blackbox(False)
    bb.record("should.not.appear", x=1)
    off = obs.postmortem.trigger("breaker_open", detail={})
    bb.enable_blackbox(None)
    events = bb.recorder().events()
    return {"ring": [e.attrs["i"] for e in rec.events()],
            "snapshot": _masked({k: v for k, v in rec.snapshot().items()
                                 if k != "epochUnix"}),
            "corr": _masked(corr), "inner": _masked(inner),
            "kinds": [(e.kind, _masked(e.corr)) for e in events],
            "slice": [e.kind for e in bb.recorder().slice_for(corr)],
            "off": off}


def test_flight_recorder_ring_and_correlation_are_equal():
    out = _both(_drive_blackbox)
    assert out["ring"] == list(range(4, 12))
    assert out["corr"] == out["inner"] == "run-id"
    assert out["kinds"] == [("inside", "run-id"), ("outside", None)]
    assert out["slice"] == ["inside"] and out["off"] is None


def _drive_postmortem(obs, policy, monkeypatch, tmp_dir):
    bb, pm = obs.blackbox, obs.postmortem
    monkeypatch.setenv("TG_POSTMORTEM_DIR", os.path.join(tmp_dir,
                                                         obs.__name__))
    monkeypatch.setenv("TG_POSTMORTEM_MAX", "2")
    corr = bb.new_correlation_id("req")
    bb.record("serve.enqueue", corr=corr, model="m")
    bb.record("serve.resolve", corr=corr, model="m", seconds=0.01)
    log = policy.FaultLog()
    log.add(policy.FaultReport(site="s", kind="oom_downshift",
                               detail={"a": 1}))
    reg = obs.metrics.MetricsRegistry()
    reg.counter("tg_x_total").inc(3)
    first = pm.trigger("oom_downshift", corr=corr, detail={"site": "s"},
                       fault_log=log, metrics=reg,
                       state={"extra": {"k": "v"}})
    rest = [pm.trigger("breaker_open", detail={"n": i}) for i in range(3)]
    doc = json.load(open(first))
    kinds = [e.kind for e in bb.recorder().events()]
    return {"written": [p is not None for p in [first] + rest],
            "bundles": len(pm.list_bundles()),
            "counts": pm.dump_counts(),
            "problems": pm.validate_bundle(doc),
            "layout": sorted(doc),
            "trigger": _masked(doc["trigger"]),
            "correlated": [e["kind"] for e in doc["correlated"]],
            "metrics": doc["metrics"], "faults": doc["faults"],
            "state": doc["state"],
            "environment": sorted(doc["environment"]),
            "ring": [kinds.count("postmortem"),
                     kinds.count("postmortem.suppressed")]}


def test_postmortem_bundles_and_rate_limit_are_equal(tmp_path, monkeypatch):
    out = {name: _drive_postmortem(obs, policy, monkeypatch, str(tmp_path))
           for name, (obs, policy) in PACKAGES.items()}
    port, jax_ = out["port"], out["jax"]
    # the environment block names the port's stack, the JAX package's its
    assert port.pop("environment") == ["backend", "cuda", "devices",
                                       "platform", "python", "torch"]
    assert "jax" in jax_.pop("environment")
    assert port == jax_
    assert port["written"] == [True, True, False, False]
    assert port["counts"] == {"dumped": 2, "suppressed": 2}
    assert port["problems"] == [] and port["ring"] == [2, 2]


# -- windowed time series and SLO burn rates ---------------------------------

def _drive_slo(obs, policy):
    ts, slo, om = obs.timeseries, obs.slo, obs.metrics
    reg = om.MetricsRegistry()
    clock = _Clock()
    s = ts.MetricsSampler(reg, name="unit", clock=clock, every_s=1.0,
                          max_samples_=500)
    rows = reg.counter("tg_serve_rows_total", model="m")
    shed = reg.counter("tg_serve_shed_total", model="m", reason="overload")
    lat = reg.histogram("tg_serve_request_seconds", model="m")
    tracker = slo.SLOTracker(slo.SLOSpec(model="m", availability=0.99,
                                         window_s=100.0), s, reg,
                             clock=s.clock)
    rng = np.random.RandomState(1)
    # (good, bad) a tick: clean, a burst, the hysteresis band, cooling
    schedule = ([(100, 0)] * 4 + [(50, 50)] * 3 + [(87, 13), (86, 14)]
                + [(95, 5)] * 3 + [(100, 0)] * 3)
    trail = []
    for i, (good, bad) in enumerate(schedule):
        clock.t = float(i + 1)
        rows.inc(good + bad)
        if bad:
            shed.inc(bad)
        for v in rng.lognormal(-4.0, 0.5, 8):
            lat.observe(float(v))
        s.tick()
        a = tracker.evaluate()["objectives"]["availability"]
        trail.append((a["verdict"], a["alerts"]["page"],
                      a["alerts"]["ticket"],
                      round(a["burn"]["page"]["long"], 9),
                      round(a["budgetRemaining"], 9)))
    return {"trail": trail, "fired": dict(tracker.fired),
            "increase": [s.increase("tg_serve_rows_total", w, model="m")
                         for w in (1.0, 3.0, 5.0, 1000.0)],
            "rate": s.rate("tg_serve_shed_total", 5.0, model="m"),
            "quantile": s.quantile("tg_serve_request_seconds", 0.99, 5.0,
                                   model="m"),
            "gauge": s.gauge_window("tg_serve_rows_total", 5.0, model="m")
            if hasattr(s, "gauge_window") else None,
            "snapshot": _masked(s.snapshot()),
            "alerts": tracker.active_alerts()}


def test_windows_and_burn_rate_alerts_fire_and_clear_at_the_same_samples():
    out = _both(_drive_slo)
    pages = [t[1] for t in out["trail"]]
    assert any(pages) and not pages[-1]      # fired, then cleared
    assert out["fired"]["page"] >= 1


def test_sampler_disabled_and_specs(monkeypatch):
    for obs, _ in PACKAGES.values():
        monkeypatch.setenv("TG_SAMPLER", "0")
        assert obs.timeseries.attach(obs.metrics.MetricsRegistry()) is None
        monkeypatch.delenv("TG_SAMPLER")
        spec = obs.slo.register(obs.slo.SLOSpec(model="m",
                                                availability=0.999))
        assert [s.key for s in obs.slo.specs_for("m")] == ["m"]
        assert obs.slo.specs_for("other")[0].availability == \
            obs.slo.SLOSpec(model="other").availability
        assert spec.to_json()["availability"] == 0.999


# -- the compile ledger and device memory ------------------------------------

def _drive_ledger(obs, policy):
    lg = obs.ledger
    led = lg.CompileLedger(max_records=4)
    fp_a = [["x", "float32", [], False], ["y", "float32", [3], True]]
    fp_b = [["x", "float64", [], False], ["y", "float32", [4], False],
            ["z", "int64", [], True]]
    recs = [led.record_build("serve", "ident", "k1", fingerprint=fp_a,
                             bucket=256),
            led.record_build("serve", "ident", "k2", fingerprint=fp_b,
                             bucket=256),
            led.record_build("serve", "ident", "k3", fingerprint=fp_b,
                             bucket=512),
            led.record_build("serve", "ident", "k3", fingerprint=fp_b,
                             bucket=512, donation=("a",))]
    led.record_eviction("k3")
    recs.append(led.record_build("serve", "ident", "k3", fingerprint=fp_b,
                                 bucket=512, donation=("a",)))
    led.note_aot_miss("k9", "no entry")
    recs.append(led.record_build("plan", "other", "k9"))
    with lg.subsystem_scope("stream"):
        scoped = lg.current_subsystem()
    lg.enable_ledger(False)
    off = led.record_build("serve", "ident", "k1")
    lg.enable_ledger(None)
    return {"records": [_masked(r.to_json()) for r in recs],
            "causes": led.counts_by_cause(), "counts": led.counts(),
            "snapshot": _masked(led.snapshot()), "scoped": scoped,
            "off": off, "total": led.total,
            "diffs": [lg.fingerprint_diff(fp_a, fp_b),
                      lg.fingerprint_diff({"a": 1, "b": 2}, {"a": 1, "b": 3}),
                      lg.fingerprint_diff("old", "new")],
            "hash": lg.cache_key_hash(("a", 1, (2, 3)))}


def test_ledger_records_and_fingerprint_diffs_are_equal():
    out = _both(_drive_ledger)
    assert [r["cause"] for r in out["records"]] == [
        "cold", "schema-change", "bucket-change", "donation-mismatch",
        "cache-eviction", "aot-miss"]
    assert out["snapshot"]["dropped"] == 2 and out["off"] is None
    assert "column 'x': dtype float32 -> float64" in out["diffs"][0]


def test_the_ports_kernel_builds_are_ledger_records(monkeypatch, tmp_path):
    """A kernel library's ``ctypes`` load is a ledger build under the
    ambient subsystem (the load itself is faked: no CUDA library here)."""
    from transmogrifai_tpu_torch.ops import cuda_build

    class _Lib:
        class _Fn:
            argtypes = restype = None
        tg_cuda_error_string = _Fn()

    lib_path = tmp_path / "libfake.so"
    lib_path.write_bytes(b"")
    monkeypatch.setattr(cuda_build, "library_path", lambda src: lib_path)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda p: _Lib())
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    led = port_obs.ledger.ledger()
    mark = led.mark()
    with port_obs.ledger.subsystem_scope("serve"):
        cuda_build.load("fake.cu")
        cuda_build.load("fake.cu")       # cached: no second build
    (rec,) = led.since(mark)
    assert (rec.subsystem, rec.identity, rec.cause) == (
        "serve", "cuda:fake.cu:load", "cold")


def test_device_memory_on_the_cpu():
    dm = port_obs.devicemem
    assert dm.memory_stats() is None
    dm.record_dispatch("serve", 1024, bucket=256, rows=10)
    assert dm.sample_measured("serve") is None
    jdm = jax_obs.devicemem
    jdm.record_dispatch("serve", 1024, bucket=256, rows=10)
    assert dm.observatory().snapshot() == jdm.observatory().snapshot()
    assert dm.observatory().peaks() == {"predicted": 1024, "measured": None}


def test_summarize_keys_are_the_jax_packages():
    assert sorted(port_obs.summarize()) == sorted(jax_obs.summarize())
    assert port_obs.summarize()["compileCache"] == {"hits": 0, "misses": 0}
