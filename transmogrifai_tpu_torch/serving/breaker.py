"""Per-model circuit breaker for the serving runtime.

The reference rides Spark's blacklisting + task retry to keep a failing
executor from taking the job down; the serving tier has one failure
domain that matters instead — the micro-batch dispatch on the device (a
wedged launch, a poisoned model, a device that stopped answering). The
PyTorch port keeps the JAX package's breaker as it is. The
breaker isolates it with the classic three-state machine:

* **closed** — dispatches flow to the device path; consecutive failures
  are counted (any success resets the count).
* **open** — after ``failure_threshold`` consecutive dispatch failures the
  breaker opens: the runtime stops offering batches to the device path and
  serves them through the eager per-row scorer instead (bit-equal results,
  no device time wasted on a failing program). Requests never fail because
  the breaker is open — they degrade.
* **half-open** — after ``reset_after`` seconds the next batch is let
  through as a *probe*. Success closes the breaker; failure re-opens it
  and restarts the clock.

Transitions call ``on_transition(state)`` (the runtime wires a
``tg_breaker_state`` gauge + span event there) and are all O(1) under one
lock. The clock is injectable so the open→half-open edge is
deterministically testable without sleeping.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from ..observability import blackbox as _blackbox

#: state → ``tg_breaker_state`` gauge value (0 is the healthy steady state
#: so dashboards can alert on anything non-zero)
CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
BREAKER_GAUGE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}


class CircuitBreaker:
    """Consecutive-failure breaker with a timed half-open probe."""

    def __init__(self, name: str = "model", failure_threshold: int = 3,
                 reset_after: float = 0.5,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[Callable[[str], None]] = None):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        self.name = name
        self.failure_threshold = int(failure_threshold)
        self.reset_after = float(reset_after)
        self.clock = clock
        self.on_transition = on_transition
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at: Optional[float] = None
        self._opens = 0
        self._probes = 0
        self._last_error: Optional[str] = None

    # -- state ---------------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, state: str) -> None:
        # lock held by caller
        if state == self._state:
            return
        prev, self._state = self._state, state
        # every breaker transition lands in the always-on flight recorder
        # (observability/blackbox.py) — the open→half_open→close dance is
        # the heart of any serving post-mortem. NOTE: the breaker lock is
        # held; on_transition callbacks must not call back into snapshot().
        _blackbox.record("breaker", name=self.name, state=state,
                         previous=prev,
                         consecutiveFailures=self._consecutive_failures,
                         error=self._last_error)
        cb = self.on_transition
        if cb is not None:
            cb(state)

    # -- runtime protocol ----------------------------------------------------
    def allow_device(self) -> bool:
        """May the next batch go to the compiled device path?  ``closed`` —
        yes; ``open`` — no until ``reset_after`` has elapsed, at which point
        this call itself moves to ``half_open`` and grants ONE probe;
        ``half_open`` — no (a probe is already in flight; extra batches stay
        on the degraded path until it resolves)."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if (self.clock() - (self._opened_at or 0.0)
                        >= self.reset_after):
                    self._probes += 1
                    self._transition(HALF_OPEN)
                    return True
                return False
            return False  # half-open: probe outstanding

    def record_success(self) -> None:
        """A device dispatch completed: close (from any state) and reset the
        failure count."""
        with self._lock:
            self._consecutive_failures = 0
            self._last_error = None
            self._transition(CLOSED)

    def record_failure(self, error: Optional[BaseException] = None) -> None:
        """A device dispatch raised. A failed half-open probe re-opens
        immediately; in closed state the breaker opens once
        ``failure_threshold`` consecutive failures accumulate."""
        with self._lock:
            self._consecutive_failures += 1
            if error is not None:
                self._last_error = f"{type(error).__name__}: {error}"[:300]
            if self._state == HALF_OPEN or (
                    self._state == CLOSED
                    and self._consecutive_failures >= self.failure_threshold):
                self._opened_at = self.clock()
                self._opens += 1
                self._transition(OPEN)

    def trip(self, error: Optional[BaseException] = None) -> None:
        """Force the breaker open immediately, bypassing the consecutive-
        failure count — the watchdog's stall response: a batcher that
        stopped beating is wedged *now*, and new batches must route to the
        degraded path instead of queueing behind it. Heals normally
        (timed half-open probe → close on success)."""
        with self._lock:
            if error is not None:
                self._last_error = f"{type(error).__name__}: {error}"[:300]
            if self._state != OPEN:
                self._opened_at = self.clock()
                self._opens += 1
                self._transition(OPEN)

    # -- introspection -------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Health/summary view (docs/serving.md "Breaker semantics")."""
        with self._lock:
            return {
                "state": self._state,
                "consecutiveFailures": self._consecutive_failures,
                "opens": self._opens,
                "probes": self._probes,
                "lastError": self._last_error,
            }
