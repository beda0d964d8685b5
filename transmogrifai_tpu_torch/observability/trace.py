"""Hierarchical tracing: spans with monotonic timestamps and a bounded buffer.

The reference observes its runs through a Spark listener (reference:
utils/.../spark/OpSparkListener.scala:55-110 — per-stage task metrics pushed
by the cluster scheduler); a JAX process has no cluster scheduler to listen
to, so the spans are emitted by the framework itself at every interesting
boundary: ``workflow.train`` → ``stage.fit``/``stage.transform`` (per layer),
``sweep.family`` (per ModelSelector candidate family), ``score.micro_batch``
(per serving batch). Fault recoveries (robustness/) land as span *events* on
whatever span is open, so a trace shows retries and quarantines in line with
the work they interrupted.

Cost model: a disabled tracer is one env/flag check per ``span()`` call —
no Span objects, no buffer writes — so the always-compiled call sites add
nothing measurable to the hot paths (the same discipline as
``robustness/faults.py`` sites). Enabled, finished spans go into a bounded
ring (``TG_TRACE_MAX_SPANS``, default 65536) so a long-lived scorer cannot
grow without bound; drops are counted, never silent.

Switches: ``TG_TRACE=1`` enables tracing process-wide;
:func:`enable_tracing` overrides programmatically (``None`` returns control
to the env). State is process-global by design — like the reference's one
listener per SparkContext — and :func:`reset` gives tests a clean slate.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

#: env switch: truthy value enables tracing process-wide
TRACE_ENV = "TG_TRACE"

_FALSY = ("", "0", "false", "False", "no")

_enabled_override: Optional[bool] = None


def tracing_enabled() -> bool:
    """True when spans are being recorded (TG_TRACE, unless overridden)."""
    if _enabled_override is not None:
        return _enabled_override
    return os.environ.get(TRACE_ENV, "") not in _FALSY


def enable_tracing(on: Optional[bool]) -> None:
    """Force tracing on/off from code (the CLI and tests); ``None`` hands
    control back to the ``TG_TRACE`` environment switch."""
    global _enabled_override
    _enabled_override = None if on is None else bool(on)


class Span:
    """One timed operation. ``ts_ns``/``dur_ns`` are monotonic-clock
    nanoseconds relative to the owning tracer's epoch; ``dur_ns`` is None
    while open (and stays None for instant events). ``events`` are
    point-in-time annotations: ``(name, ts_ns, attrs)``."""

    __slots__ = ("name", "cat", "span_id", "parent_id", "ts_ns", "dur_ns",
                 "attrs", "events", "tid")

    def __init__(self, name: str, cat: str, span_id: int,
                 parent_id: Optional[int], ts_ns: int, tid: int,
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.cat = cat
        self.span_id = span_id
        self.parent_id = parent_id
        self.ts_ns = ts_ns
        self.dur_ns: Optional[int] = None
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.events: List[Tuple[str, int, Dict[str, Any]]] = []
        self.tid = tid

    def set_attr(self, **kv: Any) -> "Span":
        self.attrs.update(kv)
        return self

    def add_event(self, name: str, **attrs: Any) -> "Span":
        self.events.append((name, _now_rel_ns(), attrs))
        return self

    @property
    def seconds(self) -> float:
        return (self.dur_ns or 0) / 1e9

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name, "cat": self.cat, "id": self.span_id,
            "parent": self.parent_id, "tsNs": self.ts_ns,
            "durNs": self.dur_ns, "tid": self.tid, "attrs": dict(self.attrs),
            "events": [{"name": n, "tsNs": t, "attrs": dict(a)}
                       for n, t, a in self.events],
        }


class _NullSpan:
    """Yielded by :func:`span` when tracing is off: every method is a no-op
    so call sites never need an enabled check around attribute writes."""

    __slots__ = ()

    def set_attr(self, **kv: Any) -> "_NullSpan":
        return self

    def add_event(self, name: str, **attrs: Any) -> "_NullSpan":
        return self

    seconds = 0.0


NULL_SPAN = _NullSpan()


class Tracer:
    """Span collector: per-thread open-span stacks (spans nest within a
    thread), one shared bounded ring of finished spans."""

    def __init__(self, max_spans: Optional[int] = None):
        if max_spans is None:
            max_spans = int(os.environ.get("TG_TRACE_MAX_SPANS", "65536"))
        self.max_spans = max(1, int(max_spans))
        self.spans: deque = deque(maxlen=self.max_spans)
        self.dropped = 0
        #: wall-clock anchor for the monotonic epoch (export metadata)
        self.epoch_unix = time.time()
        self.epoch_ns = time.perf_counter_ns()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    # -- span lifecycle ------------------------------------------------------
    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def start(self, name: str, cat: str = "",
              attrs: Optional[Dict[str, Any]] = None) -> Span:
        st = self._stack()
        s = Span(name, cat, next(self._ids),
                 st[-1].span_id if st else None,
                 time.perf_counter_ns() - self.epoch_ns,
                 threading.get_ident(), attrs)
        st.append(s)
        return s

    def end(self, s: Span) -> None:
        s.dur_ns = (time.perf_counter_ns() - self.epoch_ns) - s.ts_ns
        st = self._stack()
        if s in st:          # tolerate out-of-order ends (generator exits)
            st.remove(s)
        self._append(s)

    def instant(self, name: str, attrs: Optional[Dict[str, Any]] = None
                ) -> Span:
        """A free-standing point event (no open span to attach to)."""
        s = Span(name, "event", next(self._ids), None,
                 time.perf_counter_ns() - self.epoch_ns,
                 threading.get_ident(), attrs)
        self._append(s)
        return s

    def _append(self, s: Span) -> None:
        with self._lock:
            if len(self.spans) == self.spans.maxlen:
                self.dropped += 1
            self.spans.append(s)
        # span close summary into the always-on flight recorder: when a
        # run is traced, the black box sees the traced world too — a
        # post-mortem bundle then carries the span names/durations of the
        # seconds before the trigger (observability/blackbox.py)
        from . import blackbox as _blackbox
        if _blackbox.blackbox_enabled():
            _blackbox.record("span", name=s.name, cat=s.cat,
                             durNs=s.dur_ns)

    # -- queries -------------------------------------------------------------
    def current(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    def finished(self) -> List[Span]:
        with self._lock:
            return list(self.spans)

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()
            self.dropped = 0


_TRACER = Tracer()


def tracer() -> Tracer:
    return _TRACER


def set_tracer(t: Tracer) -> Tracer:
    global _TRACER
    _TRACER = t
    return t


def reset() -> None:
    """Fresh tracer + env-driven enablement (test isolation; see
    tests/conftest.py)."""
    global _TRACER, _enabled_override
    _TRACER = Tracer()
    _enabled_override = None


def _now_rel_ns() -> int:
    return time.perf_counter_ns() - _TRACER.epoch_ns


@contextmanager
def span(name: str, cat: str = "", **attrs: Any):
    """``with span("stage.fit", uid=...) as s:`` — records one Span when
    tracing is enabled; otherwise yields the inert :data:`NULL_SPAN`."""
    if not tracing_enabled():
        yield NULL_SPAN
        return
    t = _TRACER
    s = t.start(name, cat, attrs)
    try:
        yield s
    finally:
        t.end(s)


def add_event(name: str, **attrs: Any) -> None:
    """Annotate the current thread's open span (or record a free-standing
    instant event when none is open). No-op when tracing is disabled —
    the robustness choke points call this unconditionally."""
    if not tracing_enabled():
        return
    s = _TRACER.current()
    if s is not None:
        s.add_event(name, **attrs)
    else:
        _TRACER.instant(name, attrs)
