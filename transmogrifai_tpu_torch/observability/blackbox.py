"""Always-on flight recorder: request-correlated black-box telemetry.

TG_TRACE/TG_METRICS are *opt-in* — off in production by default — so when
a real incident fires (a breaker opens, the watchdog catches a wedge, an
OOM downshift cascades) there is no record of what the process was doing
in the seconds before. This module is the aviation-style black box the
resilience layer (PRs 6–10) was missing: a process-wide, **always-on**
(``TG_BLACKBOX=0`` opts out), fixed-size, lock-cheap ring of compact
events that is cheap enough to leave running under full serving load
(≤2% on the BENCH_MODE=serve clean line — asserted) and that
``observability/postmortem.py`` snapshots into a self-contained bundle
the moment a trigger event fires.

Event sources (each stamped with a monotonic ``ts_ns`` and, when one is
active, a **correlation id**):

* span open/close summaries (``trace.Tracer`` forwards finished spans
  here when tracing is on — the black box sees the traced world too);
* every FaultLog record (``robustness/policy.py`` choke point: retries,
  quarantines, breaker degradations, OOM downshifts, thread stalls,
  unclean exits, drift events — one hook covers them all);
* circuit-breaker state transitions (``serving/breaker.py``);
* serve request lifecycle: enqueue / shed / flush / dispatch / resolve
  (``serving/runtime.py``), each enqueue+resolve carrying the request's
  correlation id;
* drift verdict transitions (``serving/drift.py``);
* chaos injections actually applied (``robustness/faults.py``);
* stream passes and sweep family dispatches (``streaming/trainer.py``,
  ``impl/tuning/validators.py``), stamped with the owning run's id.

Correlation ids (Dapper-style, but in-process): minted per serving
request at enqueue (``ServingRuntime.submit`` → ``Future.tg_corr``) and
per run for train/stream/sweep (``OpWorkflow.train`` sets the ambient id
via :func:`correlated`), so :meth:`FlightRecorder.slice_for` reconstructs
one request's or one run's full timeline out of the shared ring. The
serve-local latency histograms keep the ids of their slowest requests as
**exemplars** (``observability/metrics.py``), so a p99 outlier links
straight back to its recorder slice.

Cost model: disabled (``TG_BLACKBOX=0``) every touch point is one flag
check — no objects, no lock. Enabled, :func:`record` is one lock-guarded
deque append of a small ``__slots__`` object; the ring is bounded by
``TG_BLACKBOX_MAX`` (default 4096) and drops are counted, never silent.

State is process-global by design (one black box per aircraft);
:func:`reset` gives tests a clean slate (tests/conftest.py
``_no_blackbox_leak``).
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

#: env switch: "0"/falsy DISABLES the recorder (on by default — the whole
#: point of a black box is that it is recording when the incident happens)
BLACKBOX_ENV = "TG_BLACKBOX"
#: ring bound (events); drops are counted in FlightRecorder.dropped
BLACKBOX_MAX_ENV = "TG_BLACKBOX_MAX"
DEFAULT_MAX_EVENTS = 4096

_FALSY = ("0", "false", "False", "no", "off")

_enabled_override: Optional[bool] = None


def blackbox_enabled() -> bool:
    """True when the flight recorder is recording (default on; TG_BLACKBOX=0
    disables, :func:`enable_blackbox` overrides)."""
    if _enabled_override is not None:
        return _enabled_override
    return os.environ.get(BLACKBOX_ENV, "1") not in _FALSY


def enable_blackbox(on: Optional[bool]) -> None:
    """Force the recorder on/off from code (benches, tests); ``None`` hands
    control back to the ``TG_BLACKBOX`` environment switch."""
    global _enabled_override
    _enabled_override = None if on is None else bool(on)


# -- correlation ids ---------------------------------------------------------

#: process-wide monotone id sequence: ids are bit-stable within a process
#: (same submission order → same ids) and globally unique across processes
#: via the pid component
_IDS = itertools.count(1)

_CORR: "contextvars.ContextVar[Optional[str]]" = contextvars.ContextVar(
    "tg_blackbox_corr", default=None)


def new_correlation_id(prefix: str = "req") -> str:
    """Mint a correlation id: ``<prefix>-<pid hex>-<seq hex>``. The serve
    path mints one per request at enqueue; ``OpWorkflow.train`` mints one
    per run (``prefix="run"``)."""
    return f"{prefix}-{os.getpid():x}-{next(_IDS):06x}"


def current_correlation() -> Optional[str]:
    """The ambient correlation id (a train/stream/sweep run id set by
    :func:`correlated`), or None outside any correlated scope."""
    return _CORR.get()


@contextlib.contextmanager
def correlated(corr: Optional[str]):
    """Make ``corr`` the ambient correlation id for the block: every
    :func:`record` without an explicit ``corr`` inside it (same thread /
    context) is stamped with it. No-op context when ``corr`` is None."""
    if corr is None:
        yield None
        return
    token = _CORR.set(corr)
    try:
        yield corr
    finally:
        _CORR.reset(token)


# -- events + recorder -------------------------------------------------------

class BlackboxEvent:
    """One compact recorder entry. ``ts_ns`` is monotonic nanoseconds
    relative to the owning recorder's epoch (``epoch_unix`` anchors it to
    wall clock for reports); ``corr`` is the correlation id or None."""

    __slots__ = ("kind", "ts_ns", "corr", "attrs")

    def __init__(self, kind: str, ts_ns: int, corr: Optional[str],
                 attrs: Dict[str, Any]):
        self.kind = kind
        self.ts_ns = ts_ns
        self.corr = corr
        self.attrs = attrs

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.kind, "tsNs": self.ts_ns, "corr": self.corr,
                "attrs": dict(self.attrs)}


class FlightRecorder:
    """The bounded event ring. One module-level singleton records the
    process (:func:`recorder`); tests build their own instances."""

    def __init__(self, max_events: Optional[int] = None):
        if max_events is None:
            try:
                max_events = int(os.environ.get(BLACKBOX_MAX_ENV, "")
                                 or DEFAULT_MAX_EVENTS)
            except ValueError:
                max_events = DEFAULT_MAX_EVENTS
        self.max_events = max(1, int(max_events))
        self._events: deque = deque(maxlen=self.max_events)
        self.dropped = 0
        #: wall-clock anchor for the monotonic epoch (bundle metadata)
        self.epoch_unix = time.time()
        self.epoch_ns = time.perf_counter_ns()
        self._lock = threading.Lock()

    # -- recording (the hot path) -------------------------------------------
    def record(self, kind: str, corr: Optional[str] = None,
               **attrs: Any) -> None:
        """Append one event. ``corr=None`` picks up the ambient correlation
        id (a train run inside :func:`correlated`); pass an explicit id on
        the serve path where each request carries its own."""
        if corr is None:
            corr = _CORR.get()
        ev = BlackboxEvent(kind, time.perf_counter_ns() - self.epoch_ns,
                           corr, attrs)
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    # -- queries -------------------------------------------------------------
    def events(self) -> List[BlackboxEvent]:
        with self._lock:
            return list(self._events)

    def tail(self, n: int) -> List[BlackboxEvent]:
        """The most recent ``n`` events (oldest first) — the post-mortem
        bundle's "recent ring slice"."""
        with self._lock:
            if n >= len(self._events):
                return list(self._events)
            return list(self._events)[-n:]

    def slice_for(self, corr: str) -> List[BlackboxEvent]:
        """Every ring event stamped with ``corr`` — one request's (or one
        run's) timeline, oldest first."""
        with self._lock:
            return [e for e in self._events if e.corr == corr]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def snapshot(self) -> Dict[str, Any]:
        """Ring accounting (no events): size / bound / drops."""
        with self._lock:
            return {"events": len(self._events),
                    "maxEvents": self.max_events,
                    "dropped": self.dropped,
                    "epochUnix": self.epoch_unix}


_RECORDER = FlightRecorder()


def recorder() -> FlightRecorder:
    return _RECORDER


def set_recorder(r: FlightRecorder) -> FlightRecorder:
    global _RECORDER
    _RECORDER = r
    return r


def reset() -> None:
    """Fresh recorder + env-driven enablement (test isolation; the
    correlation-id sequence is NOT reset — ids stay unique per process)."""
    global _RECORDER, _enabled_override
    _RECORDER = FlightRecorder()
    _enabled_override = None


# -- the instrumentation entry point (one enabled check, zero writes off) ----

def record(kind: str, corr: Optional[str] = None, **attrs: Any) -> None:
    """Record one event on the process flight recorder; inert (one flag
    check) when ``TG_BLACKBOX=0``. This is the call compiled into every
    instrumented site — the black-box analog of ``faults.inject``."""
    if not blackbox_enabled():
        return
    _RECORDER.record(kind, corr, **attrs)
