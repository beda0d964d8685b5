"""Automatic post-mortem bundles: the flight recorder's crash dump.

When a recovery event fires in production — a breaker opens, the watchdog
catches a stalled thread, a resource-exhaustion downshift, a drift
verdict degrades, a resume finds a previous owner's dying breath, a
campaign schedule violates an oracle — the black box
(``observability/blackbox.py``) holds the last few thousand events of
context, but only until the ring wraps. :func:`trigger` freezes that
context the moment it matters: one atomic, self-contained JSON bundle
(``manifest.atomic_write_bytes`` — a kill mid-dump leaves debris, never a
torn bundle) written to ``TG_POSTMORTEM_DIR`` and rate-limited to
``TG_POSTMORTEM_MAX`` dumps per process (suppressed dumps are counted and
land in the ring as ``postmortem.suppressed`` events — a storm of
triggers cannot turn the incident into a disk-filling incident).

Bundle schema (``schemaVersion`` 3; validated by :func:`validate_bundle`
— which still accepts version-1 bundles from pre-ledger processes and
version-2 bundles from pre-SLO processes — and rendered by ``cli.py
doctor``)::

    {
      "schemaVersion": 3,
      "trigger":     {"kind", "tsNs", "unixTime", "corr", "detail"},
      "pid":         <int>,
      "recorder":    {"events": [...], "dropped", "maxEvents",
                      "epochUnix"},              // recent ring slice
      "correlated":  [...],   // the trigger correlation id's timeline
      "metrics":     {...},   // caller registry snapshot (serve-local)
      "globalMetrics": {...}, // process registry snapshot (TG_METRICS)
      "faults":      {...},   // FaultLog.to_json() when a log was given
      "state":       {...},   // trigger-site state (breaker, drift, ...)
      "ledger":      {"counts", "tail"},  // compile-ledger tail (v2;
                                          // observability/ledger.py)
      "deviceMemory": {...},  // devicemem observatory snapshot (v2)
      "slo":         {...},   // per-model SLO tracker snapshots (v3;
                              // observability/slo.py)
      "samples":     [...],   // recent windowed-sampler samples (v3;
                              // observability/timeseries.py)
      "aot":         {...},   // AOT program-store snapshot: sessions,
                              // hit/miss/export accounting (v4;
                              // transmogrifai_tpu/programstore/)
      "placement":   {...},   // per-fleet placer snapshots: residency,
                              // page-in/eviction accounting, refusals
                              // (v5; serving/placement.py)
      "environment": {"torch", "cuda", "backend", "devices", "python"}
    }

Trigger kinds (docs/observability.md "Flight recorder & post-mortems"
carries the full table): ``breaker_open``, ``thread_stalled``,
``oom_downshift``, ``drift_degraded``, ``unclean_exit``,
``campaign_violation``, ``campaign_escape``, ``slo_budget_exhausted``.
"""
from __future__ import annotations

import itertools
import json
import os
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

from . import blackbox as _blackbox

#: the top-level package (the serving modules are looked up under it)
_PKG = __name__.split(".")[0]

#: current bundle schema. v2 added the compile-ledger tail and the
#: device-memory snapshot; v3 the SLO tracker snapshots and the recent
#: windowed-sampler samples; v4 the AOT program-store snapshot; v5 adds the fleet placement
#: snapshots (serving/placement.py); older bundles (no such sections)
#: must stay readable — validate_bundle accepts every
#: SUPPORTED_SCHEMA_VERSIONS
SCHEMA_VERSION = 5
SUPPORTED_SCHEMA_VERSIONS = (1, 2, 3, 4, 5)
#: how many ledger records a bundle carries (most recent builds)
LEDGER_TAIL = 32

#: where bundles land; default is a per-process tempdir subdirectory so
#: concurrent processes (and test sessions) never interleave bundles
POSTMORTEM_DIR_ENV = "TG_POSTMORTEM_DIR"
#: process-wide dump budget; past it triggers are counted, not dumped
POSTMORTEM_MAX_ENV = "TG_POSTMORTEM_MAX"
DEFAULT_MAX_DUMPS = 16
#: how much of the ring a bundle carries (most recent events)
POSTMORTEM_EVENTS_ENV = "TG_POSTMORTEM_EVENTS"
DEFAULT_BUNDLE_EVENTS = 512

BUNDLE_PREFIX = "postmortem_"

#: the registered trigger classes (docs/observability.md trigger table);
#: validate_bundle flags unknown kinds so the inventory cannot silently rot
TRIGGER_KINDS = (
    "breaker_open",        # circuit breaker transitioned to open
    "thread_stalled",      # watchdog stall / join-timeout thread leak
    "oom_downshift",       # ResourceExhaustedError adaptive downshift
    "drift_degraded",      # drift verdict crossed into degraded
    "unclean_exit",        # resume found a different-pid run sentinel
    "campaign_violation",  # a chaos schedule violated an invariant oracle
    "campaign_escape",     # a typed error escaped a campaign scenario
    "slo_budget_exhausted",  # an SLO error budget fully burned (slo.py)
    "replica_lost",        # a fleet replica died mid-flight (frontdoor.py)
)

_LOCK = threading.Lock()
_SEQ = itertools.count(1)
_DUMPED = 0
_SUPPRESSED = 0
_ENV_CACHE: Optional[Dict[str, Any]] = None


def default_dir() -> str:
    """The env-less bundle directory (per-process, under the tempdir)."""
    return os.path.join(tempfile.gettempdir(),
                        f"tg_postmortems_{os.getpid()}")


def postmortem_dir() -> str:
    return os.environ.get(POSTMORTEM_DIR_ENV) or default_dir()


def max_dumps() -> int:
    try:
        return max(0, int(os.environ.get(POSTMORTEM_MAX_ENV, "")
                          or DEFAULT_MAX_DUMPS))
    except ValueError:
        return DEFAULT_MAX_DUMPS


def bundle_events() -> int:
    try:
        return max(1, int(os.environ.get(POSTMORTEM_EVENTS_ENV, "")
                          or DEFAULT_BUNDLE_EVENTS))
    except ValueError:
        return DEFAULT_BUNDLE_EVENTS


def dump_counts() -> Dict[str, int]:
    """Process accounting: bundles written vs triggers suppressed by the
    rate limit."""
    with _LOCK:
        return {"dumped": _DUMPED, "suppressed": _SUPPRESSED}


def reset() -> None:
    """Reset the rate-limit counters (test isolation; bundles already on
    disk are the test's to clean — see conftest ``_no_blackbox_leak``)."""
    global _DUMPED, _SUPPRESSED
    with _LOCK:
        _DUMPED = 0
        _SUPPRESSED = 0


def _environment() -> Dict[str, Any]:
    """torch / CUDA / device / interpreter provenance, computed once per process —
    the part of an incident report you can never reconstruct later."""
    global _ENV_CACHE
    if _ENV_CACHE is not None:
        return dict(_ENV_CACHE)
    env: Dict[str, Any] = {
        "python": sys.version.split()[0],
        "platform": sys.platform,
    }
    try:
        import torch
        env["torch"] = getattr(torch, "__version__", None)
        env["cuda"] = torch.version.cuda
        if torch.cuda.is_available():
            env["backend"] = "cuda"
            env["devices"] = [
                {"id": i, "kind": torch.cuda.get_device_name(i)}
                for i in range(torch.cuda.device_count())]
        else:
            env["backend"] = "cpu"
            env["devices"] = [{"id": 0, "kind": "cpu"}]
    except Exception as e:  # pragma: no cover - never fail a dump
        env["torchError"] = f"{type(e).__name__}: {e}"[:200]
    _ENV_CACHE = env
    return dict(env)


def trigger(kind: str, corr: Optional[str] = None,
            detail: Optional[Dict[str, Any]] = None,
            fault_log: Optional[Any] = None,
            metrics: Optional[Any] = None,
            state: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Dump one post-mortem bundle for a trigger event; returns the bundle
    path, or None (recorder disabled / rate limit hit / write failed — a
    post-mortem must NEVER take down the path it is documenting).

    ``corr`` filters a correlated timeline into the bundle; ``fault_log``
    / ``metrics`` / ``state`` are the trigger site's context (its
    FaultLog, its serve-local MetricsRegistry, and any extra state dict —
    a breaker snapshot, a drift report)."""
    global _DUMPED, _SUPPRESSED
    if not _blackbox.blackbox_enabled():
        return None
    if corr is None:
        corr = _blackbox.current_correlation()
    with _LOCK:
        if _DUMPED >= max_dumps():
            _SUPPRESSED += 1
            suppressed = _SUPPRESSED
            seq = None
        else:
            _DUMPED += 1
            seq = next(_SEQ)
    rec = _blackbox.recorder()
    if seq is None:
        rec.record("postmortem.suppressed", corr=corr, trigger=kind,
                   suppressed=suppressed)
        return None
    now_ns = time.perf_counter_ns() - rec.epoch_ns
    doc: Dict[str, Any] = {
        "schemaVersion": SCHEMA_VERSION,
        "trigger": {"kind": kind, "tsNs": now_ns, "unixTime": time.time(),
                    "corr": corr, "detail": dict(detail or {})},
        "pid": os.getpid(),
        "recorder": {**rec.snapshot(),
                     "events": [e.to_json()
                                for e in rec.tail(bundle_events())]},
        "correlated": ([e.to_json() for e in rec.slice_for(corr)]
                       if corr else []),
        "environment": _environment(),
    }
    try:
        if metrics is not None:
            doc["metrics"] = metrics.snapshot()
        from . import metrics as _obs_metrics
        doc["globalMetrics"] = _obs_metrics.registry().snapshot()
        if fault_log is not None:
            doc["faults"] = fault_log.to_json()
        if state:
            doc["state"] = dict(state)
        # compiles & memory (schema v2): the recent build tail with
        # classified causes, and the predicted/measured byte peaks — the
        # "was a retrace storm / allocation spike part of this incident?"
        # context (observability/ledger.py, observability/devicemem.py)
        from . import devicemem as _devicemem
        from . import ledger as _ledger
        led = _ledger.ledger()
        doc["ledger"] = {
            "counts": led.counts(),
            "builds": led.total,
            "tail": [r.to_json() for r in led.tail(LEDGER_TAIL)],
        }
        doc["deviceMemory"] = _devicemem.observatory().snapshot()
        # SLO & sampler context (schema v3): per-model budget/alert
        # snapshots and the recent windowed samples — the "was the SLO
        # already burning before this incident?" context. The serving
        # module is only consulted when already loaded (a train-side
        # trigger must not drag the serving stack in).
        import sys as _sys
        slo_doc: Dict[str, Any] = {}
        rt_mod = _sys.modules.get(f"{_PKG}.serving.runtime")
        if rt_mod is not None:
            for rt in rt_mod.live_runtimes():
                snap = rt.slo_snapshot()
                if snap is not None:
                    slo_doc[rt.name] = snap
        doc["slo"] = slo_doc
        from . import timeseries as _timeseries
        doc["samples"] = [{"source": s.name, **s.snapshot(),
                           "recent": s.recent(8)}
                          for s in _timeseries.attached()]
        # AOT program-store context (schema v4): the port has no program
        # store yet (ROADMAP Queue 1 item 10), so the section says so in
        # the JAX package's shape
        doc["aot"] = {"enabled": False, "supported": False,
                      "sessions": [], "captures": 0,
                      "stats": {"hits": {}, "misses": {}, "exports": 0,
                                "exportErrors": 0, "hitsTotal": 0,
                                "missesTotal": 0}}
        # placement context (schema v5): which models were resident
        # where, what paged in/evicted, and what the budget refused —
        # the "did the incident's replica hold the only warm copy?"
        # context. Consulted only when the placement module is already
        # loaded (train-side triggers must not drag serving in).
        place_doc: Dict[str, Any] = {}
        pl_mod = _sys.modules.get(f"{_PKG}.serving.placement")
        if pl_mod is not None:
            for p in pl_mod.live_placers():
                place_doc[p.name] = p.snapshot()
        doc["placement"] = place_doc
    except Exception as e:  # context gathering must not kill the dump
        doc["contextError"] = f"{type(e).__name__}: {e}"[:300]
    path = os.path.join(postmortem_dir(),
                        f"{BUNDLE_PREFIX}{seq:04d}_{kind}.json")
    try:
        from ..manifest import atomic_write_bytes
        os.makedirs(postmortem_dir(), exist_ok=True)
        atomic_write_bytes(path, json.dumps(
            doc, default=str, separators=(",", ":")).encode("utf-8"))
    except OSError:
        return None
    rec.record("postmortem", corr=corr, trigger=kind, path=path)
    return path


# -- reading + validation (cli.py doctor, tests, the campaign engine) --------

def list_bundles(dirpath: Optional[str] = None) -> List[str]:
    """Bundle paths in ``dirpath`` (default the active TG_POSTMORTEM_DIR),
    oldest first."""
    d = dirpath or postmortem_dir()
    if not os.path.isdir(d):
        return []
    return [os.path.join(d, f) for f in sorted(os.listdir(d))
            if f.startswith(BUNDLE_PREFIX) and f.endswith(".json")]


def read_bundle(path: str) -> Dict[str, Any]:
    with open(path) as fh:
        return json.load(fh)


def validate_bundle(doc: Dict[str, Any]) -> List[str]:
    """Schema check → list of problems (empty = valid). The acceptance
    gate every trigger-class test and the serve bench run bundles
    through."""
    problems: List[str] = []
    version = doc.get("schemaVersion")
    if version not in SUPPORTED_SCHEMA_VERSIONS:
        problems.append(
            f"schemaVersion {version!r} not in {SUPPORTED_SCHEMA_VERSIONS}")
    trig = doc.get("trigger")
    if not isinstance(trig, dict):
        problems.append("missing trigger section")
    else:
        if trig.get("kind") not in TRIGGER_KINDS:
            problems.append(f"unknown trigger kind {trig.get('kind')!r}")
        for k in ("tsNs", "unixTime", "detail"):
            if k not in trig:
                problems.append(f"trigger missing {k!r}")
    recd = doc.get("recorder")
    if not isinstance(recd, dict) or not isinstance(
            recd.get("events"), list):
        problems.append("missing recorder.events ring slice")
    else:
        for e in recd["events"][:8]:
            if not {"kind", "tsNs", "attrs"} <= set(e):
                problems.append(f"malformed ring event: {e!r}")
                break
        # the triggering event must be visible in the ring slice: the
        # trigger sites record their event (fault choke point / breaker /
        # verdict) BEFORE dumping
        if not recd["events"]:
            problems.append("empty ring slice — the trigger left no events")
    if not isinstance(doc.get("correlated"), list):
        problems.append("missing correlated timeline list")
    if not isinstance(doc.get("environment"), dict):
        problems.append("missing environment section")
    if not isinstance(doc.get("pid"), int):
        problems.append("missing pid")
    if isinstance(version, int) and version >= 2:
        # v2+ sections; v1 bundles predate the ledger and stay valid
        led = doc.get("ledger")
        if not isinstance(led, dict) or not isinstance(
                led.get("tail"), list):
            problems.append("missing ledger section (schema v2)")
        if not isinstance(doc.get("deviceMemory"), dict):
            problems.append("missing deviceMemory section (schema v2)")
    if isinstance(version, int) and version >= 3:
        # v3 sections; v2 bundles predate the SLO engine and stay valid
        if not isinstance(doc.get("slo"), dict):
            problems.append("missing slo section (schema v3)")
        if not isinstance(doc.get("samples"), list):
            problems.append("missing samples section (schema v3)")
    if isinstance(version, int) and version >= 4:
        # v4 section; v3 bundles predate the AOT store and stay valid
        if not isinstance(doc.get("aot"), dict):
            problems.append("missing aot section (schema v4)")
    if isinstance(version, int) and version >= 5:
        # v5 section; v4 bundles predate the placement layer
        if not isinstance(doc.get("placement"), dict):
            problems.append("missing placement section (schema v5)")
    return problems
