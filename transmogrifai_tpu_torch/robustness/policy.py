"""Retry policies and fault accounting (counterpart of
``transmogrifai_tpu.robustness.policy``).

``RetryPolicy`` re-runs a named operation on *transient* failures with
exponential backoff and deterministic jitter; every recovery (a retry, a
skipped checkpoint, a restored stage or fold state, a downshift, a stalled
thread) is a ``FaultReport`` in the train-scoped ``FaultLog`` that
``OpWorkflowModel.summary()["faults"]`` shows, in the JAX package's
schema.
"""
from __future__ import annotations

import contextlib
import contextvars
import hashlib
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional

from ..observability import blackbox as _blackbox
from ..observability import metrics as _obs_metrics
from ..observability import trace as _obs_trace

from .faults import InjectedFaultError, TransientFaultError
from .resources import is_resource_exhausted

#: substrings (lowercased) marking an error transient: transport status
#: codes and socket-level resets
TRANSIENT_PATTERNS = (
    "unavailable", "deadline exceeded", "deadline_exceeded", "data_loss",
    "connection reset", "connection refused", "broken pipe", "socket",
    "temporarily", "transfer failed", "resource temporarily",
)


def is_transient_error(exc: BaseException) -> bool:
    """Default transient-vs-fatal classification: explicit transient marker
    types, OS-level I/O interruptions, and runtime errors whose message
    carries a retryable transport status. Everything else — ValueError,
    shape/trace errors, injected fatal faults — is fatal: retrying a
    deterministic program on the same inputs cannot fix those.

    Resource exhaustion is checked first and is never transient: a CUDA
    out-of-memory error, a host ``MemoryError`` or ``ENOMEM`` recurs at
    the same allocation size, so the downshift paths
    (``resources.py``) split the work instead."""
    if is_resource_exhausted(exc):
        return False
    if isinstance(exc, InjectedFaultError):
        return False
    if isinstance(exc, (TransientFaultError, ConnectionError, TimeoutError,
                        BrokenPipeError, InterruptedError)):
        return True
    if isinstance(exc, OSError):
        return True
    if isinstance(exc, RuntimeError):
        msg = str(exc).lower()
        return any(p in msg for p in TRANSIENT_PATTERNS)
    return False


@dataclass
class FaultReport:
    """One recovery event. ``kind``: ``retry`` (the operation succeeded
    after ``attempts - 1`` retries), ``checkpoint_skipped`` (a corrupt or
    incomplete checkpoint found and not used), ``restored`` (a fitted
    stage or a fold state taken from a verified checkpoint),
    ``oom_downshift``, ``thread_stalled``, ``unclean_exit``,
    ``stream_cache_fallback`` or ``fatal`` (retries exhausted or an error
    that is not transient)."""
    site: str
    kind: str
    detail: Dict[str, Any] = field(default_factory=dict)
    attempts: int = 1

    @property
    def retries(self) -> int:
        return max(0, self.attempts - 1)

    def to_json(self) -> Dict[str, Any]:
        return {"site": self.site, "kind": self.kind,
                "attempts": self.attempts, "retries": self.retries,
                "detail": dict(self.detail)}


_CURRENT_LOG: "contextvars.ContextVar[Optional[FaultLog]]" = \
    contextvars.ContextVar("tg_fault_log", default=None)


#: ring bound of FaultLog.reports: the oldest reports drop, counted
FAULTS_MAX_ENV = "TG_FAULTS_MAX"
DEFAULT_FAULTS_MAX = 1024


def _faults_max() -> int:
    try:
        return max(1, int(os.environ.get(FAULTS_MAX_ENV, "")
                          or DEFAULT_FAULTS_MAX))
    except ValueError:
        return DEFAULT_FAULTS_MAX


class FaultLog:
    """Accumulator of :class:`FaultReport` records, activated around a
    whole ``OpWorkflow.train``.

    Code deep in the stack (the checkpoint loaders, the stream trainer)
    records through the ambient :meth:`record`; without an active log that
    is a no-op. ``reports`` is a ring bounded by ``TG_FAULTS_MAX``
    (default 1024): the newest reports win and the drops are counted in
    :attr:`dropped`."""

    def __init__(self, max_reports: Optional[int] = None):
        self.max_reports = (max(1, int(max_reports))
                            if max_reports is not None else _faults_max())
        self.reports: Deque[FaultReport] = deque()
        self.dropped = 0

    @contextlib.contextmanager
    def activate(self):
        token = _CURRENT_LOG.set(self)
        try:
            yield self
        finally:
            _CURRENT_LOG.reset(token)

    def add(self, report: FaultReport) -> None:
        """Append with the ring bound applied (for threads that have no
        ambient log)."""
        while len(self.reports) >= self.max_reports:
            self.reports.popleft()
            self.dropped += 1
            _obs_metrics.inc_counter(
                "tg_faults_dropped_total",
                help="fault reports dropped by the TG_FAULTS_MAX ring "
                "(docs/robustness.md)")
        self.reports.append(report)
        _emit_fault_observability(report)

    @staticmethod
    def current() -> Optional["FaultLog"]:
        """The ambient (activated) log of this thread, or None. Worker
        threads do not see the consumer's log (context variables are per
        thread): code that records from its own threads takes the log on
        the owning thread and ``add()``s to it (the chunk cache)."""
        return _CURRENT_LOG.get()

    @staticmethod
    def record(report: FaultReport) -> None:
        log = _CURRENT_LOG.get()
        if log is not None:
            log.add(report)
        else:
            _emit_fault_observability(report)

    def of_kind(self, kind: str) -> List[FaultReport]:
        return [r for r in self.reports if r.kind == kind]

    def to_json(self) -> Dict[str, Any]:
        """The ``summary()["faults"]`` section, in the JAX package's
        schema (the port records no quarantine or plan events yet: those
        lists stay empty)."""
        return {
            "quarantined": [r.to_json() for r in self.of_kind("quarantine")],
            "retries": [r.to_json() for r in self.of_kind("retry")],
            "checkpointsSkipped": [r.to_json()
                                   for r in self.of_kind("checkpoint_skipped")],
            "restored": [r.to_json() for r in self.of_kind("restored")],
            "planFallbacks": [r.to_json()
                              for r in self.of_kind("plan_fallback")],
            "breakerDegraded": [r.to_json()
                                for r in self.of_kind("breaker_degraded")],
            "drift": [r.to_json() for r in self.reports
                      if r.kind.startswith("drift_")],
            # adaptive degradation after resource exhaustion: serving
            # flush splits, chunk-budget halvings
            "oomDownshifts": [r.to_json()
                              for r in self.of_kind("oom_downshift")],
            # threads the watchdog caught wedged, or left alive past a
            # join timeout at close
            "threadStalls": [r.to_json()
                             for r in self.of_kind("thread_stalled")],
            # run sentinels of an earlier process that died in this
            # checkpoint directory
            "uncleanExits": [r.to_json()
                             for r in self.of_kind("unclean_exit")],
            "fatal": [r.to_json() for r in self.of_kind("fatal")],
            "droppedReports": self.dropped,
        }


def _emit_fault_observability(report: FaultReport) -> None:
    # the choke point: every recovery becomes a flight-recorder event, a
    # span event on whatever span is open and a counter by kind (the last
    # two are no-ops when observability is off), as in the JAX package
    _blackbox.record("fault." + report.kind, site=report.site,
                     attempts=report.attempts)
    _obs_trace.add_event("fault." + report.kind, site=report.site,
                         attempts=report.attempts)
    _obs_metrics.inc_counter(
        "tg_faults_total", help="fault recoveries by kind "
        "(docs/robustness.md)", kind=report.kind)


@dataclass
class RetryPolicy:
    """Exponential backoff + deterministic jitter over transient failures.

    ``attempt_deadline``: an attempt whose wall-clock exceeds it is not
    retried even on a transient error — a stuck link that ate the whole
    budget should fail loud, not double the hang. ``classify`` overrides
    the default :func:`is_transient_error`."""
    max_retries: int = 2
    base_delay: float = 0.05
    max_delay: float = 2.0
    jitter: float = 0.25
    attempt_deadline: Optional[float] = None
    classify: Optional[Callable[[BaseException], bool]] = None

    def is_transient(self, exc: BaseException) -> bool:
        return (self.classify or is_transient_error)(exc)

    def delay_for(self, attempt: int, site: str) -> float:
        """Deterministic backoff: exponential in the attempt number, jittered
        by a hash of (site, attempt) — reproducible across runs, while
        distinct sites still decorrelate (no thundering herd on a shared
        coordinator)."""
        d = min(self.max_delay, self.base_delay * (2.0 ** attempt))
        if self.jitter:
            h = hashlib.md5(f"{site}:{attempt}".encode()).digest()
            frac = h[0] / 255.0
            d *= 1.0 + self.jitter * frac
        return d

    def execute(self, fn: Callable[[], Any], site: str) -> Any:
        """Run ``fn``; on transient failure back off and retry up to
        ``max_retries`` times. Success after >=1 retry records a ``retry``
        FaultReport; exhaustion or a fatal error records ``fatal`` and
        re-raises the last exception."""
        errors: List[str] = []
        attempt = 0
        while True:
            t0 = time.monotonic()
            try:
                out = fn()
            except Exception as e:
                elapsed = time.monotonic() - t0
                errors.append(f"{type(e).__name__}: {e}")
                over_deadline = (self.attempt_deadline is not None
                                 and elapsed > self.attempt_deadline)
                if (not self.is_transient(e) or attempt >= self.max_retries
                        or over_deadline):
                    FaultLog.record(FaultReport(
                        site=site, kind="fatal", attempts=attempt + 1,
                        detail={"errors": errors,
                                "overDeadline": over_deadline}))
                    raise
                time.sleep(self.delay_for(attempt, site))
                attempt += 1
                continue
            if attempt:
                FaultLog.record(FaultReport(
                    site=site, kind="retry", attempts=attempt + 1,
                    detail={"errors": errors}))
            return out
