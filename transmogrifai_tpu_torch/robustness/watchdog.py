"""Heartbeat watchdog: hang detection for worker threads (counterpart of
``transmogrifai_tpu.robustness.watchdog``).

A wedged thread (a chunk-feed worker stuck in a dead reader, a hung
transform, a stuck upload) raises nothing. Monitored threads register a
:class:`Heart` and ``beat()`` it every loop iteration; one shared scanner
thread (``tg-watchdog``, started with the first heart and ending with the
last) checks every heart against its stall budget (``TG_WATCHDOG_S``,
default 30 s; 0 disables). A stall fires once per episode (it re-arms when
the beats resume): a ``thread_stalled`` FaultLog report, then the heart's
``on_stall`` callback, with which the streaming feed aborts its consumer
with a typed :class:`WatchdogStallError` instead of leaving it waiting.

The same report backs the join-timeout checks: ``DeviceFeed.close``
calls :func:`report_thread_stalled` when a ``join(timeout=...)`` leaves a
thread alive. The clock is injectable and :meth:`Watchdog.check_now`
scans at once, so stall detection is testable without sleeping.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable, List, Optional

logger = logging.getLogger(__name__)

WATCHDOG_ENV = "TG_WATCHDOG_S"
DEFAULT_STALL_S = 30.0


def env_stall_seconds() -> float:
    """The default stall budget (seconds). 0 disables the watchdog —
    hearts become inert no-ops."""
    try:
        raw = os.environ.get(WATCHDOG_ENV, "")
        return float(raw) if raw else DEFAULT_STALL_S
    except ValueError:
        return DEFAULT_STALL_S


class WatchdogStallError(RuntimeError):
    """A monitored thread stopped beating past its stall budget. Raised to
    abort work that would otherwise wait on the wedged thread forever (the
    streaming feed's consumer)."""


class Heart:
    """One monitored thread's heartbeat handle. ``beat()`` on every loop
    iteration; ``close()`` when the thread exits (idempotent)."""

    __slots__ = ("name", "kind", "stall_after", "on_stall", "fault_log",
                 "last_beat", "stalled", "stalls", "closed", "_wd")

    def __init__(self, wd: "Watchdog", name: str, kind: str,
                 stall_after: float,
                 on_stall: Optional[Callable[["Heart", float], None]],
                 fault_log: Optional[Any]):
        self._wd = wd
        self.name = name
        self.kind = kind
        self.stall_after = stall_after
        self.on_stall = on_stall
        self.fault_log = fault_log
        self.last_beat = wd.clock()
        self.stalled = False
        self.stalls = 0
        self.closed = False

    def beat(self) -> None:
        self.last_beat = self._wd.clock()

    def close(self) -> None:
        self._wd.unregister(self)


class _NullHeart:
    """Inert heart returned when the watchdog is disabled (TG_WATCHDOG_S=0)
    — every touch point stays a no-op method call."""

    name = kind = "disabled"
    stalled = closed = False
    stalls = 0

    def beat(self) -> None:
        pass

    def close(self) -> None:
        pass


NULL_HEART = _NullHeart()


class Watchdog:
    """Heart registry and one scanner thread. The process-wide instance
    (:func:`watchdog`) monitors the feed's threads; tests build their own
    with an injectable ``clock`` and drive :meth:`check_now`."""

    def __init__(self, stall_after: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 start_thread: bool = True):
        self.stall_after = (env_stall_seconds() if stall_after is None
                            else float(stall_after))
        self.clock = clock
        self._start_thread = start_thread
        self._lock = threading.Lock()
        self._hearts: List[Heart] = []
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: the last scanner started, kept for ``idle_join`` after it ends
        self._last_thread: Optional[threading.Thread] = None

    @property
    def enabled(self) -> bool:
        return self.stall_after > 0

    def register(self, name: str, kind: str = "thread",
                 stall_after: Optional[float] = None,
                 on_stall: Optional[Callable[[Heart, float], None]] = None,
                 fault_log: Optional[Any] = None):
        """Start monitoring a thread; returns its :class:`Heart` (the
        inert :data:`NULL_HEART` when disabled)."""
        budget = self.stall_after if stall_after is None else float(stall_after)
        if budget <= 0:
            return NULL_HEART
        heart = Heart(self, name, kind, budget, on_stall, fault_log)
        with self._lock:
            self._hearts.append(heart)
            if self._start_thread and (
                    self._thread is None or not self._thread.is_alive()):
                self._thread = self._last_thread = threading.Thread(
                    target=self._run, name="tg-watchdog", daemon=True)
                self._thread.start()
        return heart

    def unregister(self, heart: Heart) -> None:
        with self._lock:
            heart.closed = True
            if heart in self._hearts:
                self._hearts.remove(heart)
            self._wake.set()  # let an idle scanner notice and exit

    def hearts(self) -> List[Heart]:
        with self._lock:
            return list(self._hearts)

    def check_now(self, now: Optional[float] = None) -> List[Heart]:
        """Scan every heart once; fire stalls; return the hearts newly
        stalled by this scan (the synchronous test entry point)."""
        now = self.clock() if now is None else now
        fired: List[Heart] = []
        for h in self.hearts():
            if h.closed:
                continue
            waited = now - h.last_beat
            if waited >= h.stall_after:
                if not h.stalled:
                    h.stalled = True
                    h.stalls += 1
                    fired.append(h)
                    self._fire(h, waited)
            else:
                h.stalled = False  # beats resumed: re-arm the episode
        return fired

    def _fire(self, heart: Heart, waited: float) -> None:
        report_thread_stalled(
            site=f"watchdog.{heart.kind}", thread_name=heart.name,
            waited_s=waited, fault_log=heart.fault_log,
            stallAfterS=heart.stall_after)
        cb = heart.on_stall
        if cb is not None:
            try:
                cb(heart, waited)
            except Exception:  # a stall handler must never kill the scanner
                logger.exception("watchdog on_stall handler for %s raised",
                                 heart.name)

    def _run(self) -> None:
        while True:
            with self._lock:
                if not self._hearts:
                    self._thread = None
                    return
                budget = min(h.stall_after for h in self._hearts)
            interval = min(max(budget / 4.0, 0.05), 5.0)
            self._wake.wait(interval)
            self._wake.clear()
            try:
                self.check_now()
            except Exception:  # pragma: no cover - defensive
                logger.exception("watchdog scan failed")

    def idle_join(self, timeout: float = 5.0) -> None:
        """Join the scanner thread once no hearts remain (test teardown)."""
        with self._lock:
            t = self._last_thread
            if self._hearts or t is None:
                return
        self._wake.set()
        t.join(timeout)


_GLOBAL_LOCK = threading.Lock()
_GLOBAL: Optional[Watchdog] = None


def watchdog() -> Watchdog:
    """The process-global watchdog (env-driven stall budget, real clock)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = Watchdog()
        return _GLOBAL


def register(name: str, kind: str = "thread",
             stall_after: Optional[float] = None,
             on_stall: Optional[Callable[[Heart, float], None]] = None,
             fault_log: Optional[Any] = None):
    """Register a heart on the global watchdog. Re-reads ``TG_WATCHDOG_S``
    per call so tests/benches can flip the budget per runtime."""
    wd = watchdog()
    budget = env_stall_seconds() if stall_after is None else stall_after
    return wd.register(name, kind=kind, stall_after=budget,
                       on_stall=on_stall, fault_log=fault_log)


def live_hearts() -> List[Heart]:
    """Open hearts on the global watchdog (conftest no-leak probe)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        wd = _GLOBAL
    return wd.hearts() if wd is not None else []


def idle_join(timeout: float = 5.0) -> None:
    global _GLOBAL
    with _GLOBAL_LOCK:
        wd = _GLOBAL
    if wd is not None:
        wd.idle_join(timeout)


def report_thread_stalled(site: str, thread_name: str, waited_s: float,
                          fault_log: Optional[Any] = None,
                          **detail: Any) -> None:
    """Account one stalled or leaked thread: a ``thread_stalled`` report
    on ``fault_log``, or on the ambient log. Shared by the scanner and the
    join-timeout checks of ``DeviceFeed.close``."""
    from .policy import FaultLog, FaultReport
    report = FaultReport(
        site=site, kind="thread_stalled",
        detail={"thread": thread_name, "waitedS": round(waited_s, 3),
                **detail})
    if fault_log is not None:
        fault_log.add(report)
    else:
        FaultLog.record(report)
    logger.warning("thread '%s' stalled for %.1fs (site %s)",
                   thread_name, waited_s, site)
