"""Resilient serving runtime: continuous batching with backpressure,
deadlines, and per-model circuit breaking (docs/serving.md).

The PyTorch port's copy of the JAX package's ``serving/runtime.py``: the
same names, ``TG_SERVE_*`` knobs, chaos sites, metrics and summary shapes.
``micro_batch_score_function`` (local/scoring.py) is the throughput path —
one schema-guarded columnar pass per flush on the model's device — and this
runtime drives it under concurrent load, treating serving as a robustness
problem first:

* **bounded queue + admission control** — ``submit`` enqueues up to
  ``max_queue`` requests; beyond that the request is *shed* with a typed
  :class:`OverloadError` instead of growing memory without bound. Shedding
  at the door is what keeps p99 bounded under a 2× overload.
* **continuous batching** — a single batcher thread coalesces queued
  requests into micro-batches and flushes on size-or-deadline: a full
  ``max_batch`` or the oldest request aging past ``max_wait_ms``. While
  a batch is on the device the queue keeps accepting — the next batch is
  already forming.
* **per-request deadlines** — an expired request is shed *before*
  dispatch (:class:`DeadlineExceededError` on its future), so a slow
  batch never spends device time on work nobody is waiting for.
* **per-model circuit breaker** — dispatch failures feed a
  :class:`~.breaker.CircuitBreaker`; while open, batches degrade to the
  eager per-row ``score_function`` path (bit-equal results) instead of
  failing requests, recorded via FaultLog (``breaker_degraded``) and the
  ``tg_breaker_state`` gauge. A half-open probe re-tries the device path
  and closes on success.
* **adaptive degradation under memory pressure** — a flush whose compiled
  dispatch exhausts device/host memory (``torch.cuda.OutOfMemoryError``,
  host ``MemoryError`` — robustness/resources.py) splits in half and retries,
  recursively down to singleton requests: latency degrades, requests
  never fail, and each split is an ``oom_downshift`` FaultLog report +
  ``tg_oom_total{site="oom.serve"}``. Resource faults NEVER feed the
  breaker — exhaustion says the *batch* was too big, not that the device
  path is broken, and opening the breaker would needlessly route healthy
  traffic to the slow eager path. Only if even singletons exhaust does
  the batch degrade to the eager per-row scorer (still zero failures).
* **hang watchdog** — the batcher thread beats a
  :mod:`~..robustness.watchdog` heart every loop iteration
  (``TG_WATCHDOG_S``); a wedged dispatch stops the beats, which records
  ``thread_stalled`` + ``tg_watchdog_stalls_total`` and trips the
  breaker so the *next* batches degrade instead of queueing behind the
  wedge. ``close()`` likewise refuses to silently discard a batcher that
  outlives its join timeout — the leak is recorded the same way.
* **pipelined dataplane** — with ``TG_SERVE_PIPELINE`` > 1 (default 2)
  the per-model loop splits into three overlapped stages: the batcher
  *gathers* (take-batch, deadline shed, one pooled columnar gather per
  flush packed into pooled pinned host blocks and copied with
  ``non_blocking=True`` — local/scoring.ServeStages) and *dispatches*
  (runs the model's stages and enqueues the result copies into pinned
  host blocks, all on the runtime's own ``torch.cuda.Stream``, then
  records a ``torch.cuda.Event``; nothing waits), then hands the flush to
  a ``tg-serve-completer[<name>]`` thread that *completes* flushes
  strictly in flush order: wait on the flush's event, vectorized record
  flattening from the pinned blocks, ``_finish`` accounting + future
  resolution, drift fold — all off the batcher's critical path. A pinned
  block is reused only after the event of the flush that last used it
  has completed, and every tensor of a flush lives on the runtime's
  stream, so the caching allocator never hands a flush's memory to the
  next one early. Depth 1 is the serial loop (selectable for A/B);
  records are bit-equal across depths because per-row results are
  independent of batching (the forest kernels sum each row's trees in
  tree order). Failures surface at completion but count against the
  dispatching flush; breaker-open and ``oom.serve`` downshift ladders
  drain the pipeline and run serially. Per-stage
  ``tg_serve_stage_seconds{stage}`` histograms attribute which stage
  bounds throughput (docs/serving.md "Pipelined dataplane").

Failure injection: the ``serve.enqueue`` / ``serve.flush`` /
``serve.dispatch`` / ``serve.complete`` / ``oom.serve`` chaos sites
(robustness/faults.py) make every one of those paths deterministically
testable.

Metrics: every instrument is kept in a **serve-local**
``MetricsRegistry`` (always on — health/SLO snapshots must work with
observability disabled) and mirrored into the process-global registry
through the gated helpers when ``TG_METRICS``/``TG_TRACE`` is enabled, so
``summary()["observability"]["serving"]`` and ``metrics.prom`` pick the
series up. Per-model p50/p95/p99 comes straight from the streaming
histogram in ``observability/metrics.py``.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional, Sequence

from ..local.scoring import (
    SCORE_ERROR_KEY, ScoreSchemaError, ServeStages,
    micro_batch_score_function, score_function,
)
from ..observability import blackbox as _blackbox
from ..observability import ledger as _obs_ledger
from ..observability import metrics as _obs_metrics
from ..observability import postmortem as _postmortem
from ..observability import slo as _slo
from ..observability import timeseries as _timeseries
from ..observability.trace import add_event as _obs_event
from ..observability.trace import span as _obs_span
from ..robustness import faults, resources
from ..robustness import watchdog as _watchdog
from ..robustness.policy import FaultLog, FaultReport
from ..robustness.watchdog import WatchdogStallError
from .breaker import BREAKER_GAUGE, CLOSED, CircuitBreaker, OPEN


class ServingError(RuntimeError):
    """Base of the typed serving-runtime failures."""


class OverloadError(ServingError):
    """The bounded request queue is full — the request was shed at
    admission (backpressure). Retry with backoff or route elsewhere."""


class DeadlineExceededError(ServingError):
    """The request's deadline expired while it was queued; it was shed
    before any device work was spent on it."""


class RuntimeStoppedError(ServingError):
    """The runtime is not accepting requests (stopped or never started)."""


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: Optional[float]) -> Optional[float]:
    raw = os.environ.get(name)
    if raw in (None, ""):
        return default
    try:
        return float(raw)
    except ValueError:
        return default


@dataclass
class ServeConfig:
    """Runtime knobs; every field has a ``TG_SERVE_*`` environment default
    (documented in docs/serving.md "Env knobs").

    ``max_batch`` defaults to the JAX package's minimum padding bucket
    (256), so a flush has the same rows in either package.

    ``pipeline_depth`` bounds how many flushes may be in flight at once
    (``TG_SERVE_PIPELINE``): 1 runs today's serial loop; >= 2 enables the
    gather/dispatch/complete pipeline with a completer thread."""
    max_batch: int = 256
    max_queue: int = 1024
    max_wait_ms: float = 2.0
    default_deadline_ms: Optional[float] = None
    breaker_failures: int = 3
    breaker_reset_ms: float = 500.0
    drain_on_close: bool = True
    pipeline_depth: int = 2

    @classmethod
    def from_env(cls) -> "ServeConfig":
        return cls(
            max_batch=_env_int("TG_SERVE_MAX_BATCH", 256),
            max_queue=_env_int("TG_SERVE_QUEUE_MAX", 1024),
            max_wait_ms=_env_float("TG_SERVE_MAX_WAIT_MS", 2.0) or 2.0,
            default_deadline_ms=_env_float("TG_SERVE_DEADLINE_MS", None),
            breaker_failures=_env_int("TG_SERVE_BREAKER_FAILURES", 3),
            breaker_reset_ms=_env_float(
                "TG_SERVE_BREAKER_RESET_MS", 500.0) or 500.0,
            pipeline_depth=max(1, _env_int("TG_SERVE_PIPELINE", 2)),
        )


@dataclass
class _Request:
    row: Dict[str, Any]
    future: Future
    enqueued: float
    deadline: Optional[float]  # absolute monotonic, None = no deadline
    #: flight-recorder correlation id, minted at enqueue and carried
    #: through flush → dispatch → resolve (None when TG_BLACKBOX=0);
    #: also exposed on the Future as ``tg_corr`` so callers (loadgen,
    #: the exemplar reports) can name their requests
    corr: Optional[str] = None
    #: optional tenant label: per-tenant twin series (tg_serve_tenant_*)
    #: feed per-tenant SLO budgets (observability/slo.py); flows through
    #: the TG_METRICS_MAX_LABELS cardinality bound like any label
    tenant: Optional[str] = None


@dataclass
class _Flush:
    """One in-flight flush handed from the batcher to the completer.

    ``kind`` names which completion path applies:

    * ``device`` — the flush's stages were launched on the runtime's
      stream; ``scored`` holds the in-flight handle whose event the
      completer waits on.
    * ``eager`` — the flush already degraded in the batcher
      (``serve.flush`` fault); the completer scores it per-row.
    * ``quarantine`` — gather/dispatch raised the micro-batch quarantine
      family (ScoreSchemaError/TypeError/ValueError); the completer
      re-scores through the monolithic scorer so quarantined records are
      bit-equal to the serial path's.
    * ``oom`` — the launch exhausted memory; the completer runs the
      adaptive downshift ladder (splits re-fire ``oom.serve`` exactly
      like the serial recursion).
    * ``error`` — a non-resource dispatch failure; the completer counts
      it against the breaker (the dispatching flush) and degrades.
    """
    reqs: List[_Request]
    kind: str
    scored: Any = None
    rows: Optional[List[Dict[str, Any]]] = None
    err: Optional[BaseException] = None
    site: str = "serve.dispatch"


#: live (started, not yet closed) runtimes — the conftest no-leak fixture
#: asserts this is empty around every test
_LIVE_LOCK = threading.Lock()
_LIVE: List["ServingRuntime"] = []


def live_runtimes() -> List["ServingRuntime"]:
    with _LIVE_LOCK:
        return list(_LIVE)


class ServingRuntime:
    """One model's serving loop. Use as a context manager::

        with ServingRuntime(model, name="churn") as rt:
            fut = rt.submit({"x1": 0.2, "x2": -1.0}, deadline_ms=50)
            record = fut.result(timeout=5)

    or synchronously: ``rt.score(row, timeout=5)``. ``close()`` drains the
    queue (by default) and joins the batcher thread.
    """

    def __init__(self, model, name: str = "model",
                 config: Optional[ServeConfig] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 fault_log: Optional[FaultLog] = None,
                 metrics_registry: Optional[_obs_metrics.MetricsRegistry] = None,
                 drift_monitor=None,
                 auto_start: bool = True):
        self.model = model
        self.name = name
        self.config = config or ServeConfig.from_env()
        #: serve-local instruments — always on (see module docstring)
        self.metrics = metrics_registry or _obs_metrics.MetricsRegistry()
        #: memoized (serve-local, global-mirror) instrument handles — the
        #: hot-path counters/histograms skip the registry's per-call
        #: lock + dict resolution (keyed (kind, name, labels); entries
        #: revalidate against the live global registry so metrics.reset()
        #: or set_registry() can never leave a stale mirror bound)
        self._metric_cache: Dict[Any, Any] = {}
        #: serve-scoped fault accounting (ring-bounded; TG_FAULTS_MAX)
        self.fault_log = fault_log or FaultLog()
        #: online distribution monitor (serving/drift.py); every scored
        #: micro-batch folds into it on the batcher thread, behind a
        #: crash-isolation fence — a drift failure can never fail a request
        self.drift_monitor = drift_monitor
        if drift_monitor is not None:
            drift_monitor.bind(name, self.metrics, self.fault_log)
        self.warm_info: Optional[Dict[str, Any]] = None
        self._scorer = micro_batch_score_function(model)
        self._eager_row = score_function(model)
        self._result_names = [f.name for f in model.result_features]
        self._cond = threading.Condition()
        self._queue: Deque[_Request] = deque()
        self._running = False    # batcher thread live
        self._accepting = True   # submit() admits (True before start too,
        #                          so tests can stage a queue deterministically)
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._heart = None  # watchdog heartbeat (set in start())
        #: pipelined dataplane state (module docstring "pipelined
        #: dataplane"); depth 1 = serial, no completer thread
        self.pipeline_depth = max(1, int(self.config.pipeline_depth))
        self._stages = ServeStages(model)
        self._pipe: Deque[_Flush] = deque()
        self._pipe_cond = threading.Condition()
        self._pipe_busy = 0          # flushes popped but still completing
        self._producer_done = False  # batcher exited; completer may drain
        self._completer: Optional[threading.Thread] = None
        self._completer_heart = None
        #: memory-pressure backoff: after any resource exhaustion the next
        #: flush drains the pipeline and runs serially (one clean serial
        #: flush clears it — the pipelined analog of a half-open probe)
        self._oom_serial = False
        #: windowed time-series source over the serve-local registry
        #: (None when TG_SAMPLER=0; set in start(), detached in close())
        self.sampler: Optional[_timeseries.MetricsSampler] = None
        #: one SLO tracker per registered spec for this model (default
        #: env-driven spec when none registered; observability/slo.py)
        self.slo_trackers: List[_slo.SLOTracker] = []
        self.breaker = breaker or CircuitBreaker(
            name=name,
            failure_threshold=self.config.breaker_failures,
            reset_after=self.config.breaker_reset_ms / 1000.0)
        self.breaker.on_transition = self._on_breaker_transition
        self._set_gauge("tg_breaker_state", BREAKER_GAUGE[CLOSED],
                        help="per-model circuit breaker state "
                        "(0=closed, 1=half_open, 2=open; docs/serving.md)")
        if auto_start:
            self.start()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ServingRuntime":
        with self._cond:
            if self._closed:
                raise RuntimeStoppedError(
                    f"runtime '{self.name}' is closed")
            if self._running:
                return self
            self._running = True
        # hang watchdog: the batcher beats this heart every loop
        # iteration; a wedged dispatch stops the beats → thread_stalled
        # is recorded and the breaker trips (docs/robustness.md)
        self._heart = _watchdog.register(
            f"tg-serve[{self.name}]", kind="serve.batcher",
            on_stall=self._on_watchdog_stall, fault_log=self.fault_log)
        # windowed telemetry + SLO budgets: attach the serve-local
        # registry to the shared tg-sampler thread and evaluate every
        # registered SLO spec on its tick cadence (TG_SAMPLER=0 opts the
        # whole plane out — no thread, no trackers, zero writes)
        if self.sampler is None:
            self.sampler = _timeseries.attach(self.metrics, name=self.name)
        if self.sampler is not None and not self.slo_trackers:
            self.slo_trackers = [
                _slo.SLOTracker(spec, self.sampler, self.metrics,
                                runtime=self)
                for spec in _slo.specs_for(self.name)]
            self.sampler.on_sample.append(self._evaluate_slo)
        if self.pipeline_depth > 1 and self._completer is None:
            # the completer gets its own heart: a wedged device wait
            # (stage complete blocks on results) must surface exactly
            # like a wedged batcher dispatch
            self._completer_heart = _watchdog.register(
                f"tg-serve-completer[{self.name}]", kind="serve.completer",
                on_stall=self._on_watchdog_stall, fault_log=self.fault_log)
            self._completer = threading.Thread(
                target=self._completer_loop,
                name=f"tg-serve-completer[{self.name}]", daemon=True)
            self._completer.start()
        self._thread = threading.Thread(
            target=self._loop, name=f"tg-serve[{self.name}]", daemon=True)
        self._thread.start()
        with _LIVE_LOCK:
            _LIVE.append(self)
        return self

    def close(self, drain: Optional[bool] = None) -> None:
        """Stop accepting requests. ``drain=True`` (the config default)
        scores everything already queued before returning; ``drain=False``
        fails queued requests with :class:`RuntimeStoppedError`."""
        drain = self.config.drain_on_close if drain is None else drain
        with self._cond:
            if self._closed:
                return
            self._running = False
            self._accepting = False
            if not drain:
                while self._queue:
                    r = self._queue.popleft()
                    self._fail_future(r.future, RuntimeStoppedError(
                        f"runtime '{self.name}' closed before dispatch"))
                self._set_gauge("tg_serve_queue_depth", 0.0)
            self._cond.notify_all()
        for t in (self._thread, self._completer):
            if t is None:
                continue
            # the batcher joins first: its exit marks the pipe done, which
            # is what lets the completer drain every in-flight flush
            # (zero lost futures) and retire
            t.join(timeout=30)
            if t.is_alive():
                # never discard a still-alive worker silently: record the
                # stall (serve-local counter + FaultLog + global series)
                self.metrics.counter(
                    "tg_watchdog_stalls_total",
                    "thread stalls (docs/robustness.md)",
                    model=self.name, site="serve.close").inc()
                _watchdog.report_thread_stalled(
                    site="serve.close", thread_name=t.name,
                    waited_s=30.0, fault_log=self.fault_log,
                    model=self.name)
        if self._heart is not None:
            self._heart.close()
        if self._completer_heart is not None:
            self._completer_heart.close()
        if self._stages.stream is not None:
            # the model may be released after close (a hot swap): its
            # tensors must outlive every launch queued on this stream
            self._stages.stream.synchronize()
        _timeseries.detach(self.sampler)
        self.sampler = None
        with self._cond:
            self._closed = True
        with _LIVE_LOCK:
            if self in _LIVE:
                _LIVE.remove(self)

    def __enter__(self) -> "ServingRuntime":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def running(self) -> bool:
        with self._cond:
            return self._running

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    # -- request API ---------------------------------------------------------
    def submit(self, row: Dict[str, Any],
               deadline_ms: Optional[float] = None,
               tenant: Optional[str] = None) -> Future:
        """Enqueue one request; returns a Future resolving to the result
        record (``{feature name: value}``; quarantined rows carry
        ``__score_error__``). Raises :class:`OverloadError` when the queue
        is full and :class:`RuntimeStoppedError` when not running.

        ``tenant`` labels the request for per-tenant SLO budgets: its
        outcome is additionally counted on the ``tg_serve_tenant_*``
        twin series (rows / shed / quarantined / latency), bounded by
        the registry's TG_METRICS_MAX_LABELS cardinality guard."""
        # deterministic chaos entry: an injected fault here models an
        # admission-layer failure (e.g. the listener thread dying)
        faults.inject("serve.enqueue", key=self.name)
        dl_ms = (deadline_ms if deadline_ms is not None
                 else self.config.default_deadline_ms)
        now = time.monotonic()
        deadline = now + dl_ms / 1000.0 if dl_ms else None
        fut: Future = Future()
        # flight-recorder correlation: one id per request, minted here,
        # resolved in _finish — the black box can replay any request's
        # enqueue→resolve timeline (observability/blackbox.py)
        boxed = _blackbox.blackbox_enabled()
        corr = _blackbox.new_correlation_id() if boxed else None
        fut.tg_corr = corr
        with self._cond:
            if not self._accepting:
                raise RuntimeStoppedError(
                    f"runtime '{self.name}' is not accepting requests")
            if len(self._queue) >= self.config.max_queue:
                self._count("tg_serve_shed_total", reason="overload",
                            help="requests shed (docs/serving.md)")
                if tenant is not None:
                    self._count_tenant("tg_serve_tenant_shed_total", tenant)
                if boxed:
                    _blackbox.record("serve.shed", corr=corr,
                                     model=self.name, reason="overload",
                                     queueDepth=len(self._queue))
                raise OverloadError(
                    f"serve queue for model '{self.name}' is full "
                    f"({self.config.max_queue} pending); request shed")
            self._queue.append(_Request(row, fut, now, deadline, corr,
                                        tenant))
            depth = len(self._queue)
            self._set_gauge("tg_serve_queue_depth", float(depth),
                            help="requests waiting for a flush")
            self._cond.notify()
        if boxed:
            _blackbox.record("serve.enqueue", corr=corr, model=self.name,
                             queueDepth=depth)
        return fut

    def score(self, row: Dict[str, Any], timeout: Optional[float] = None,
              deadline_ms: Optional[float] = None) -> Dict[str, Any]:
        """Synchronous convenience: submit + wait."""
        return self.submit(row, deadline_ms=deadline_ms).result(timeout)

    def warm(self, rows: int = 8) -> List[Dict[str, Any]]:
        """Drive the serve path once with synthetic all-missing rows:
        builds and loads every kernel library the model's flushes launch
        (serving/warmup.py), through the serial scorer and, at depth >= 2,
        once more through the pipelined stages (their stream and pinned
        blocks). Builds are ledger-attributed to subsystem ``serve``
        (cause ``cold``)."""
        probe = [{} for _ in range(max(1, rows))]
        with _obs_ledger.subsystem_scope("serve"):
            recs = self._scorer(probe)
            if self.pipeline_depth > 1:
                st = self._stages
                st.flatten(st.dispatch(st.gather(probe)), len(probe))
            return recs

    # -- batcher -------------------------------------------------------------
    def _beat(self) -> None:
        h = self._heart
        if h is not None:
            h.beat()

    def _on_watchdog_stall(self, heart, waited: float) -> None:
        """Watchdog stall response (scanner thread): the batcher stopped
        beating — most likely a wedged dispatch. Trip the breaker so
        batches after the wedge clears (and probes) prefer the degraded
        path, and count the stall on the serve-local registry (the
        FaultLog report + global counter come from the watchdog)."""
        self.breaker.trip(error=WatchdogStallError(
            f"serve batcher for model '{self.name}' stalled "
            f"{waited:.1f}s (> TG_WATCHDOG_S)"))
        self.metrics.counter(
            "tg_watchdog_stalls_total",
            "thread stalls (docs/robustness.md)",
            model=self.name, site="serve.batcher").inc()

    def _loop(self) -> None:
        try:
            while True:
                self._beat()
                batch = self._take_batch()
                if batch is None:
                    return
                if not batch:
                    continue
                try:
                    if (self.pipeline_depth > 1 and not self._oom_serial
                            and self.breaker.state == CLOSED):
                        self._flush_pipelined(batch)
                    else:
                        # breaker not closed (open / half-open probe) or
                        # memory-pressure backoff: drain the in-flight
                        # pipeline, then run this flush serially — the
                        # degraded ladders keep their exact serial shape
                        was_backoff = self._oom_serial
                        self._drain_pipe()
                        self._flush(batch)
                        if was_backoff:
                            self._oom_serial = False
                except Exception as e:  # belt-and-braces: never kill the loop
                    for r in batch:
                        self._fail_future(r.future, e)
        finally:
            # unblock the completer: it drains whatever is still in the
            # pipe (in flush order) and retires — no future is ever
            # dropped by shutdown
            with self._pipe_cond:
                self._producer_done = True
                self._pipe_cond.notify_all()

    def _take_batch(self) -> Optional[List[_Request]]:
        """Block until a batch is ready: a full ``max_batch``, the oldest
        request aging past ``max_wait_ms``, or shutdown (drain). Returns
        None when stopped and drained."""
        cfg = self.config
        with self._cond:
            while not self._queue and self._running:
                self._beat()
                self._cond.wait(0.05)
            if not self._queue:
                return None  # stopped and drained
            flush_at = self._queue[0].enqueued + cfg.max_wait_ms / 1000.0
            while (len(self._queue) < cfg.max_batch and self._running):
                self._beat()
                remaining = flush_at - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(min(remaining, 0.05))
            k = min(len(self._queue), cfg.max_batch)
            batch = [self._queue.popleft() for _ in range(k)]
            self._set_gauge("tg_serve_queue_depth", float(len(self._queue)))
            return batch

    def _flush(self, batch: List[_Request]) -> None:
        # stage attribution twin of the pipelined histograms: one serial
        # flush is gather+dispatch+complete fused, recorded as
        # stage="serial" so the bench A/B can compare like with like
        t0 = time.perf_counter()
        try:
            with _obs_span("serve.flush", cat="serve", model=self.name,
                           rows=len(batch)):
                _blackbox.record("serve.flush", model=self.name,
                                 rows=len(batch),
                                 queueDepth=self.queue_depth())
                alive = self._shed_expired(batch)
                if not alive:
                    return
                try:
                    # chaos: a fault assembling the batch (the batching
                    # layer itself failing) — requests degrade, they do
                    # not fail
                    faults.inject("serve.flush", key=self.name)
                except Exception as e:
                    self._record_degraded("serve.flush", len(alive),
                                          error=e)
                    self._finish(alive, self._eager_records(alive),
                                 degraded=True)
                    return
                self._dispatch(alive)
        finally:
            self._observe_stage("serial", time.perf_counter() - t0)

    # -- pipelined dataplane --------------------------------------------------
    def _observe_stage(self, stage: str, seconds: float) -> None:
        self._observe("tg_serve_stage_seconds", seconds,
                      help="per-pipeline-stage wall time (gather / "
                      "dispatch / complete; stage=serial is one whole "
                      "serial flush — docs/observability.md)", stage=stage)

    def _flush_pipelined(self, batch: List[_Request]) -> None:
        """Stages gather + dispatch on the batcher thread and hands the
        in-flight flush to the completer. Mirrors ``_flush``/``_dispatch``
        step for step — spans, blackbox records, chaos sites, exception
        classification — except nothing here blocks on device results:
        CUDA launches are asynchronous, so the batcher turns around
        and forms the next flush while the device computes this one."""
        # bound the in-flight depth: slots count queued + still-completing
        with self._pipe_cond:
            while len(self._pipe) + self._pipe_busy >= self.pipeline_depth:
                self._beat()
                self._pipe_cond.wait(0.05)
        with _obs_span("serve.flush", cat="serve", model=self.name,
                       rows=len(batch)):
            _blackbox.record("serve.flush", model=self.name,
                             rows=len(batch),
                             queueDepth=self.queue_depth())
            alive = self._shed_expired(batch)
            if not alive:
                return
            try:
                faults.inject("serve.flush", key=self.name)
            except Exception as e:
                # same meaning as serial: the batching layer failed, the
                # requests degrade (counted here, against this flush) —
                # the completer only scores them eagerly, in flush order
                self._record_degraded("serve.flush", len(alive), error=e)
                self._pipe_push(_Flush(alive, "eager", err=e,
                                       site="serve.flush"))
                return
            rows = [r.row for r in alive]
            with _obs_span("serve.dispatch", cat="serve",
                           model=self.name, rows=len(rows)), \
                    _obs_ledger.subsystem_scope("serve"), \
                    _blackbox.correlated(alive[0].corr):
                _blackbox.record("serve.dispatch", model=self.name,
                                 rows=len(rows))
                try:
                    # chaos order matches the serial path exactly:
                    # serve.dispatch, then oom.serve (which the serial
                    # _score_adaptive fires before its scorer call; the
                    # downshift halves re-fire it in the completer's
                    # ladder, so injection call counts are identical)
                    faults.inject("serve.dispatch", key=self.name)
                    faults.inject("oom.serve", key=self.name)
                except Exception as e:
                    if resources.classify_exhaustion(e) is not None:
                        # memory pressure: flushes after this one run
                        # serially until a clean serial flush clears the
                        # backoff (the pipelined half-open analog)
                        self._oom_serial = True
                        self._pipe_push(_Flush(alive, "oom", rows=rows,
                                               err=e))
                    else:
                        self._pipe_push(_Flush(alive, "error", rows=rows,
                                               err=e,
                                               site="serve.dispatch"))
                    return
                try:
                    t0 = time.perf_counter()
                    table = self._stages.gather(rows)
                    t1 = time.perf_counter()
                    scored = self._stages.dispatch(table)
                    t2 = time.perf_counter()
                except (ScoreSchemaError, TypeError, ValueError) as e:
                    # the monolithic scorer's quarantine family: the
                    # completer re-scores through it so quarantined
                    # records stay bit-equal to serial
                    self._pipe_push(_Flush(alive, "quarantine",
                                           rows=rows, err=e))
                    return
                except Exception as e:
                    if resources.classify_exhaustion(e) is not None:
                        self._oom_serial = True
                        self._pipe_push(_Flush(alive, "oom", rows=rows,
                                               err=e))
                    else:
                        self._pipe_push(_Flush(alive, "error", rows=rows,
                                               err=e,
                                               site="serve.dispatch"))
                    return
            self._observe_stage("gather", t1 - t0)
            self._observe_stage("dispatch", t2 - t1)
            self._pipe_push(_Flush(alive, "device", scored=scored,
                                   rows=rows))

    def _pipe_push(self, fl: _Flush) -> None:
        with self._pipe_cond:
            self._pipe.append(fl)
            self._pipe_cond.notify_all()

    def _pipe_pop(self) -> Optional[_Flush]:
        """Completer side: next flush in flush order, or None when the
        batcher has retired and the pipe is fully drained."""
        with self._pipe_cond:
            while not self._pipe and not self._producer_done:
                h = self._completer_heart
                if h is not None:
                    h.beat()
                self._pipe_cond.wait(0.05)
            if not self._pipe:
                return None
            fl = self._pipe.popleft()
            self._pipe_busy += 1
            self._pipe_cond.notify_all()
            return fl

    def _drain_pipe(self) -> None:
        """Batcher side: block until every in-flight flush has fully
        completed. The serial fallbacks (breaker open / half-open probe,
        memory backoff, belt-and-braces) must observe a quiet pipe so
        flush-order resolution and the breaker's single-probe discipline
        hold; with depth 1 the pipe is always empty and this is a no-op."""
        with self._pipe_cond:
            while self._pipe or self._pipe_busy:
                self._beat()
                self._pipe_cond.wait(0.05)

    def _completer_loop(self) -> None:
        while True:
            h = self._completer_heart
            if h is not None:
                h.beat()
            fl = self._pipe_pop()
            if fl is None:
                return
            try:
                self._complete(fl)
            except Exception as e:  # belt-and-braces: never drop futures
                for r in fl.reqs:
                    self._fail_future(r.future, e)
            finally:
                with self._pipe_cond:
                    self._pipe_busy -= 1
                    self._pipe_cond.notify_all()

    def _complete(self, fl: _Flush) -> None:
        """Stage complete (completer thread): resolve one flush exactly
        as the serial path would — breaker accounting charged to the
        dispatching flush, ``_finish`` counting before resolving, drift
        fold — all off the batcher's critical path."""
        reqs = fl.reqs
        rows = fl.rows if fl.rows is not None else [r.row for r in reqs]
        if fl.kind == "eager":
            # _record_degraded already ran in the batcher (serve.flush)
            self._finish(reqs, self._eager_records(reqs), degraded=True)
            return
        if fl.kind == "error":
            # a non-resource dispatch failure surfaces here but counts
            # against the dispatching flush — same breaker arithmetic,
            # same degraded accounting, as the serial _dispatch handler
            self.breaker.record_failure(error=fl.err)
            self._record_degraded(fl.site, len(reqs), error=fl.err)
            self._finish(reqs, self._eager_records(reqs), degraded=True)
            return
        if fl.kind == "oom":
            self._complete_oom(reqs, rows, fl.err)
            return
        if fl.kind == "quarantine":
            self._complete_quarantine(reqs, rows)
            return
        # kind == "device": block on the async result and flatten
        t0 = time.perf_counter()
        try:
            # chaos: a fault here models completion-side failure (a
            # poisoned device result, a transfer error while blocking)
            faults.inject("serve.complete", key=self.name)
        except Exception as e:
            if resources.classify_exhaustion(e) is not None:
                self._oom_serial = True
                self._complete_oom(reqs, rows, e)
                return
            self.breaker.record_failure(error=e)
            self._record_degraded("serve.complete", len(reqs), error=e)
            self._finish(reqs, self._eager_records(reqs), degraded=True)
            return
        try:
            with _obs_ledger.subsystem_scope("serve"), \
                    _blackbox.correlated(reqs[0].corr):
                recs = self._stages.flatten(fl.scored, len(reqs))
        except (ScoreSchemaError, TypeError, ValueError):
            self._complete_quarantine(reqs, rows)
            return
        except Exception as e:
            if resources.classify_exhaustion(e) is not None:
                self._oom_serial = True
                self._complete_oom(reqs, rows, e)
                return
            self.breaker.record_failure(error=e)
            self._record_degraded("serve.complete", len(reqs), error=e)
            self._finish(reqs, self._eager_records(reqs), degraded=True)
            return
        self._observe_stage("complete", time.perf_counter() - t0)
        self.breaker.record_success()
        self._finish(reqs, recs, degraded=False)

    def _complete_quarantine(self, reqs: List[_Request],
                             rows: List[Dict[str, Any]]) -> None:
        """A pipelined flush hit the quarantine family
        (ScoreSchemaError/TypeError/ValueError): re-score through the
        monolithic micro-batch scorer, whose per-row isolation produces
        exactly the records the serial path would have — valid rows score,
        offenders come back quarantined under ``__score_error__``."""
        try:
            with _obs_ledger.subsystem_scope("serve"), \
                    _blackbox.correlated(reqs[0].corr):
                recs = self._scorer(rows)
        except Exception as e:
            # terminal fallback, mirroring _dispatch's handlers
            if resources.classify_exhaustion(e) is not None:
                self._record_degraded("oom.serve", len(rows), error=e)
            else:
                self.breaker.record_failure(error=e)
                self._record_degraded("serve.dispatch", len(rows),
                                      error=e)
            self._finish(reqs, self._eager_records(reqs), degraded=True)
            return
        self.breaker.record_success()
        self._finish(reqs, recs, degraded=False)

    def _complete_oom(self, reqs: List[_Request],
                      rows: List[Dict[str, Any]],
                      err: Optional[BaseException]) -> None:
        """The adaptive downshift ladder for a pipelined flush whose
        launch (or completion) exhausted memory: identical reports,
        counters, and split shape to the serial ``_score_adaptive``
        recursion — the halves go back through ``_score_adaptive``
        itself, so they re-fire ``oom.serve`` exactly like serial
        retries, and resource faults still never feed the breaker."""
        n = len(rows)
        try:
            with _obs_ledger.subsystem_scope("serve"), \
                    _blackbox.correlated(reqs[0].corr):
                if n <= 1:
                    raise err  # a singleton still exhausts → eager
                mid = n // 2
                self.fault_log.add(FaultReport(
                    site="oom.serve", kind="oom_downshift",
                    detail={"model": self.name, "rows": n,
                            "splitRows": [mid, n - mid],
                            "error": f"{type(err).__name__}: {err}"[:200]}))
                self._count("tg_oom_total", site="oom.serve",
                            help="resource-exhaustion events by site "
                            "(docs/robustness.md)")
                self._count("tg_oom_downshift_total",
                            help="adaptive downshifts after resource "
                            "exhaustion (docs/robustness.md)")
                _postmortem.trigger(
                    "oom_downshift", fault_log=self.fault_log,
                    metrics=self.metrics,
                    detail={"site": "oom.serve", "model": self.name,
                            "rows": n,
                            "error": f"{type(err).__name__}: {err}"[:200]})
                recs = (self._score_adaptive(rows[:mid])
                        + self._score_adaptive(rows[mid:]))
        except Exception as e:
            if resources.classify_exhaustion(e) is not None:
                self._record_degraded("oom.serve", n, error=e)
                self._finish(reqs, self._eager_records(reqs),
                             degraded=True)
                return
            self.breaker.record_failure(error=e)
            self._record_degraded("serve.dispatch", n, error=e)
            self._finish(reqs, self._eager_records(reqs), degraded=True)
            return
        self.breaker.record_success()
        self._finish(reqs, recs, degraded=False)

    def _shed_expired(self, batch: List[_Request]) -> List[_Request]:
        """Deadline enforcement happens HERE, after dequeue and before any
        device work — dead requests never reach the device."""
        now = time.monotonic()
        alive: List[_Request] = []
        for r in batch:
            if r.deadline is not None and now >= r.deadline:
                self._count("tg_serve_shed_total", reason="deadline",
                            help="requests shed (docs/serving.md)")
                if r.tenant is not None:
                    self._count_tenant("tg_serve_tenant_shed_total",
                                       r.tenant)
                _blackbox.record("serve.shed", corr=r.corr,
                                 model=self.name, reason="deadline")
                self._fail_future(r.future, DeadlineExceededError(
                    f"deadline expired after "
                    f"{(now - r.enqueued) * 1000:.1f}ms in queue "
                    f"(model '{self.name}'); shed before dispatch"))
            elif r.future.cancelled():
                # a caller cancelled after enqueue: without a typed
                # bucket the request would silently vanish from
                # submitted = completed + typed sheds
                self._count("tg_serve_shed_total", reason="cancelled",
                            help="requests shed (docs/serving.md)")
                if r.tenant is not None:
                    self._count_tenant("tg_serve_tenant_shed_total",
                                       r.tenant)
                _blackbox.record("serve.shed", corr=r.corr,
                                 model=self.name, reason="cancelled")
                continue
            else:
                alive.append(r)
        return alive

    def _score_adaptive(self, rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Compiled micro-batch scoring with adaptive degradation: a flush
        whose dispatch exhausts memory splits in half and retries, down to
        singletons — per-row results are independent of the batching, so
        the concatenated halves are bit-equal to the unsplit flush. Each
        split is an ``oom_downshift`` report + ``tg_oom_total``; anything
        non-resource (or a singleton that still exhausts) re-raises to
        ``_dispatch``'s breaker/eager handling."""
        try:
            # chaos: a RESOURCE_EXHAUSTED here models the padded flush not
            # fitting on the device (call-counted, so halves can succeed)
            faults.inject("oom.serve", key=self.name)
            return self._scorer(rows)
        except Exception as e:
            if resources.classify_exhaustion(e) is None or len(rows) <= 1:
                raise
            mid = len(rows) // 2
            self.fault_log.add(FaultReport(
                site="oom.serve", kind="oom_downshift",
                detail={"model": self.name, "rows": len(rows),
                        "splitRows": [mid, len(rows) - mid],
                        "error": f"{type(e).__name__}: {e}"[:200]}))
            self._count("tg_oom_total", site="oom.serve",
                        help="resource-exhaustion events by site "
                        "(docs/robustness.md)")
            self._count("tg_oom_downshift_total",
                        help="adaptive downshifts after resource "
                        "exhaustion (docs/robustness.md)")
            # trigger event: freeze the flight-recorder context for the
            # exhaustion (rate-limited; observability/postmortem.py)
            _postmortem.trigger(
                "oom_downshift", fault_log=self.fault_log,
                metrics=self.metrics,
                detail={"site": "oom.serve", "model": self.name,
                        "rows": len(rows),
                        "error": f"{type(e).__name__}: {e}"[:200]})
            return (self._score_adaptive(rows[:mid])
                    + self._score_adaptive(rows[mid:]))

    def _dispatch(self, alive: List[_Request]) -> None:
        rows = [r.row for r in alive]
        if self.breaker.allow_device():
            try:
                # ledger attribution: any build this flush pays (a kernel
                # library built or loaded on a cold path) lands as
                # subsystem "serve", correlated to the flush's oldest
                # request, so a timeline shows which request paid it
                with _obs_span("serve.dispatch", cat="serve",
                               model=self.name, rows=len(rows)), \
                        _obs_ledger.subsystem_scope("serve"), \
                        _blackbox.correlated(alive[0].corr):
                    _blackbox.record("serve.dispatch", model=self.name,
                                     rows=len(rows))
                    # chaos: a fault here models the compiled micro-batch
                    # path failing (a wedged launch, a poisoned model)
                    faults.inject("serve.dispatch", key=self.name)
                    recs = self._score_adaptive(rows)
            except Exception as e:
                if resources.classify_exhaustion(e) is not None:
                    # even singleton dispatches exhaust: final fallback is
                    # the eager per-row path — requests still never fail.
                    # The breaker counts only NON-resource faults: the
                    # device path is healthy, the allocations were not.
                    self._record_degraded("oom.serve", len(rows), error=e)
                    self._finish(alive, self._eager_records(alive),
                                 degraded=True)
                    return
                self.breaker.record_failure(error=e)
                self._record_degraded("serve.dispatch", len(rows), error=e)
                self._finish(alive, self._eager_records(alive),
                             degraded=True)
                return
            self.breaker.record_success()
            self._finish(alive, recs, degraded=False)
        else:
            # breaker open: the device path is failing — serve the batch
            # through the eager per-row scorer (bit-equal) instead of
            # failing requests
            self._record_degraded("serve.dispatch", len(rows))
            self._finish(alive, self._eager_records(alive), degraded=True)

    def _eager_records(self, reqs: Sequence[_Request]) -> List[Dict[str, Any]]:
        """The degraded path: eager per-row ``score_function``. Rows the
        eager path cannot score are quarantined under ``__score_error__``
        exactly like the micro-batch path does."""
        out: List[Dict[str, Any]] = []
        for r in reqs:
            try:
                out.append(self._eager_row(r.row))
            except Exception as e:
                rec: Dict[str, Any] = {nm: None for nm in self._result_names}
                rec[SCORE_ERROR_KEY] = f"{type(e).__name__}: {e}"
                out.append(rec)
        return out

    def _finish(self, reqs: Sequence[_Request],
                recs: Sequence[Dict[str, Any]], degraded: bool) -> None:
        # account the flush BEFORE resolving futures: a caller that takes
        # its result and immediately reads summary() must see this flush
        # already counted — resolving first let the woken waiter race
        # ahead of the batcher's counter writes (latencies use one `now`,
        # so the ordering changes no measured value)
        now = time.monotonic()
        boxed = _blackbox.blackbox_enabled()
        quarantined = 0
        for r, rec in zip(reqs, recs):
            if SCORE_ERROR_KEY in rec:
                quarantined += 1
                if r.tenant is not None:
                    self._count_tenant("tg_serve_tenant_quarantined_total",
                                       r.tenant)
            if r.future.cancelled():
                continue
            seconds = now - r.enqueued
            if r.tenant is not None:
                # per-tenant twin series: the tenant-budget SLO trackers'
                # SLI inputs (observability/slo.py)
                self._count_tenant("tg_serve_tenant_rows_total", r.tenant)
                self.metrics.histogram(
                    "tg_serve_tenant_request_seconds",
                    "per-tenant enqueue-to-result latency",
                    model=self.name, tenant=r.tenant).observe(seconds)
            # the request's latency histogram keeps the correlation ids
            # of its slowest observations as exemplars — a p99 outlier
            # links straight to its recorder timeline
            self._observe("tg_serve_request_seconds", seconds,
                          help="enqueue-to-result latency per request "
                          "(p50/p95/p99; docs/serving.md)",
                          exemplar=r.corr)
            if boxed:
                _blackbox.record("serve.resolve", corr=r.corr,
                                 model=self.name,
                                 seconds=round(seconds, 6),
                                 degraded=degraded)
        n = len(reqs)
        self._count("tg_serve_rows_total", float(n),
                    help="requests scored by the serving runtime")
        self._observe("tg_serve_batch_rows", float(n),
                      help="coalesced flush sizes (continuous batching)")
        if degraded:
            self._count("tg_serve_degraded_total", float(n),
                        help="requests served via the eager per-row "
                        "fallback (breaker open or dispatch failure)")
        if quarantined:
            self._count("tg_serve_quarantined_total", float(quarantined),
                        help="requests quarantined under __score_error__")
        for r, rec in zip(reqs, recs):
            try:
                r.future.set_result(rec)
            except InvalidStateError:
                continue  # cancelled while in flight
        # drift fold AFTER every future resolved: still off the request
        # hot path (the batcher thread when serial, the completer when
        # pipelined), post-quarantine, and fenced — nothing past this
        # line can affect a response
        self._drift_observe(reqs, recs)

    def _drift_observe(self, reqs: Sequence[_Request],
                       recs: Sequence[Dict[str, Any]]) -> None:
        """The drift crash-isolation fence: fold the batch's clean rows
        into the monitor; ANY exception (a ``drift.fold`` chaos raise, a
        poisoned fold, a monitor bug) is typed ``drift_fold_failed`` in
        the FaultLog + ``tg_drift_errors_total`` and swallowed."""
        mon = self.drift_monitor
        if mon is None:
            return
        rows = [r.row for r, rec in zip(reqs, recs)
                if SCORE_ERROR_KEY not in rec]
        if not rows:
            return
        try:
            mon.observe(rows)
        except Exception as e:
            mon.fold_errors += 1
            self._count("tg_drift_errors_total", reason="fold",
                        help="drift-monitor failures contained by the "
                        "crash-isolation fence (docs/serving.md)")
            self.fault_log.add(FaultReport(
                site="drift.fold", kind="drift_fold_failed",
                detail={"model": self.name, "rows": len(rows),
                        "error": f"{type(e).__name__}: {e}"[:300]}))

    # -- accounting ----------------------------------------------------------
    def _record_degraded(self, site: str, rows: int,
                         error: Optional[BaseException] = None) -> None:
        detail: Dict[str, Any] = {"model": self.name, "rows": rows,
                                  "breakerState": self.breaker.state}
        if error is not None:
            detail["error"] = f"{type(error).__name__}: {error}"[:300]
        self.fault_log.add(FaultReport(site=site, kind="breaker_degraded",
                                       detail=detail))

    def _on_breaker_transition(self, state: str) -> None:
        self._set_gauge("tg_breaker_state", BREAKER_GAUGE[state],
                        help="per-model circuit breaker state "
                        "(0=closed, 1=half_open, 2=open; docs/serving.md)")
        _obs_event("serve.breaker", model=self.name, state=state)
        if state == OPEN:
            # trigger event: the breaker opening is the canonical serving
            # incident — dump the post-mortem while the recorder still
            # holds the dispatches that opened it. NOTE: this runs under
            # the breaker's lock (on_transition contract), so the detail
            # must not call back into breaker.snapshot().
            _postmortem.trigger(
                "breaker_open", fault_log=self.fault_log,
                metrics=self.metrics,
                detail={"model": self.name, "state": state,
                        "queueDepth": self.queue_depth()})

    def _instruments(self, kind: str, name: str, help: str,
                     labels: Dict[str, str]):
        """Memoized ``(serve-local, global-mirror)`` instrument pair for
        the hot-path helpers below: the registry's per-call lock + label
        resolution runs once per (kind, name, labels) instead of once per
        request. Entries revalidate against the *live* global registry
        (and the enabled switch) by identity, so ``metrics.reset()`` /
        ``set_registry()`` / ``enable_metrics()`` can never leave a stale
        mirror bound — disabled metrics still mean zero global writes."""
        key = (kind, name, tuple(sorted(labels.items())))
        greg = (_obs_metrics.registry()
                if _obs_metrics.metrics_enabled() else None)
        ent = self._metric_cache.get(key)
        if ent is not None and ent[1] is greg:
            return ent[0], ent[2]
        if len(self._metric_cache) > 4096:
            # the registries already bound label cardinality
            # (TG_METRICS_MAX_LABELS → __other__); this is only a backstop
            # against unbounded memoization across registry swaps
            self._metric_cache.clear()
        local = getattr(self.metrics, kind)(
            name, help, model=self.name, **labels)
        mirror = (None if greg is None else
                  getattr(greg, kind)(name, help, model=self.name,
                                      **labels))
        self._metric_cache[key] = (local, greg, mirror)
        return local, mirror

    def _count(self, name: str, n: float = 1.0, help: str = "",
               **labels: str) -> None:
        local, mirror = self._instruments("counter", name, help, labels)
        local.inc(n)
        if mirror is not None:
            mirror.inc(n)

    def _count_tenant(self, name: str, tenant: str, n: float = 1.0) -> None:
        """Per-tenant twin counter (serve-local + gated global mirror);
        the label flows through TG_METRICS_MAX_LABELS like any other."""
        self._count(name, n, help="per-tenant serve accounting "
                    "(docs/serving.md)", tenant=tenant)

    def _evaluate_slo(self, _sampler, now: float) -> None:
        """Sampler tick hook: run every tracker's evaluation pass. Fenced
        per tracker — a broken SLO evaluation must never stop the others
        (the hook runner in timeseries.py fences the whole call too)."""
        for t in self.slo_trackers:
            try:
                t.evaluate(now)
            except Exception:  # pragma: no cover - defensive
                pass

    def slo_snapshot(self) -> Optional[Dict[str, Any]]:
        """Per-spec SLO snapshots keyed by spec key (``model`` or
        ``model/tenant``); None when the sampler is disabled (no windowed
        telemetry → no budgets)."""
        if not self.slo_trackers:
            return None
        return {t.key: t.snapshot() for t in self.slo_trackers}

    def _tenant_breakdown(self, snap: Dict[str, Dict[str, Any]]
                          ) -> Optional[Dict[str, Dict[str, Any]]]:
        """Per-tenant accounting from the twin series; None when no
        request ever carried a tenant label."""
        tenants: Dict[str, Dict[str, Any]] = {}
        for name, field in (("tg_serve_tenant_rows_total", "rows"),
                            ("tg_serve_tenant_shed_total", "shed"),
                            ("tg_serve_tenant_quarantined_total",
                             "quarantined")):
            for key, v in snap.get(name, {}).items():
                kv = dict(p.split("=", 1) for p in key.split(",")
                          if "=" in p)
                if kv.get("model") != self.name or "tenant" not in kv:
                    continue
                tenants.setdefault(kv["tenant"], {})[field] = v
        for key, v in snap.get("tg_serve_tenant_request_seconds",
                               {}).items():
            kv = dict(p.split("=", 1) for p in key.split(",") if "=" in p)
            if kv.get("model") == self.name and "tenant" in kv:
                tenants.setdefault(kv["tenant"], {})["latency"] = v
        return tenants or None

    def _observe(self, name: str, v: float, help: str = "",
                 exemplar: Any = None, **labels: str) -> None:
        local, mirror = self._instruments("histogram", name, help, labels)
        # exemplars live on the serve-local series only (as before)
        local.observe(v, exemplar=exemplar)
        if mirror is not None:
            mirror.observe(v)

    def _set_gauge(self, name: str, v: float, help: str = "",
                   **labels: str) -> None:
        local, mirror = self._instruments("gauge", name, help, labels)
        local.set(v)
        if mirror is not None:
            mirror.set(v)

    @staticmethod
    def _fail_future(fut: Future, exc: BaseException) -> None:
        try:
            fut.set_exception(exc)
        except InvalidStateError:
            pass

    # -- introspection -------------------------------------------------------
    def _series(self, snap: Dict[str, Dict[str, Any]], name: str,
                **match: str) -> float:
        total = 0.0
        for key, v in snap.get(name, {}).items():
            kv = dict(p.split("=", 1) for p in key.split(",") if "=" in p)
            if all(kv.get(k) == val for k, val in match.items()):
                total += float(v)
        return total

    def summary(self) -> Dict[str, Any]:
        """The serve-side ``summary()`` section: SLO quantiles, shed /
        degraded / quarantine counts, breaker + queue state, fault-log
        tail size (docs/serving.md "SLO metrics")."""
        snap = self.metrics.snapshot()
        latency = snap.get("tg_serve_request_seconds", {}).get(
            f"model={self.name}", {})
        return {
            "model": self.name,
            "state": self.health_state(),
            "breaker": self.breaker.snapshot(),
            "queueDepth": self.queue_depth(),
            "latency": latency,
            "batchRows": snap.get("tg_serve_batch_rows", {}).get(
                f"model={self.name}", {}),
            "rowsScored": self._series(snap, "tg_serve_rows_total"),
            "degradedRows": self._series(snap, "tg_serve_degraded_total"),
            "quarantinedRows": self._series(
                snap, "tg_serve_quarantined_total"),
            "shed": {
                "overload": self._series(snap, "tg_serve_shed_total",
                                         reason="overload"),
                "deadline": self._series(snap, "tg_serve_shed_total",
                                         reason="deadline"),
                "cancelled": self._series(snap, "tg_serve_shed_total",
                                          reason="cancelled"),
            },
            # pipelined dataplane state: configured depth and the flushes
            # currently between dispatch and completion (0 when serial)
            "pipeline": {"depth": self.pipeline_depth,
                         "inFlight": len(self._pipe) + self._pipe_busy},
            "faults": {"reports": len(self.fault_log.reports),
                       "dropped": self.fault_log.dropped,
                       # adaptive flush splits under memory pressure and
                       # watchdog/join-leak stall detections
                       # (docs/robustness.md)
                       "oomDownshifts": len(
                           self.fault_log.of_kind("oom_downshift")),
                       "threadStalls": len(
                           self.fault_log.of_kind("thread_stalled"))},
            "warm": self.warm_info,
            # per-model drift verdict + per-feature JS/fill deltas
            # (serving/drift.py); None when no monitor is attached
            "drift": (self.drift_monitor.snapshot()
                      if self.drift_monitor is not None else None),
            # per-spec SLO verdicts/budgets (None when TG_SAMPLER=0) and
            # the derived autoscaling signal — the readiness artifact
            # ROADMAP item 2 consumes (observability/slo.py)
            "slo": self.slo_snapshot(),
            "scaleHint": _slo.scale_hint(self, self.slo_snapshot()),
            # per-tenant accounting breakdown (None without tenants)
            "tenants": self._tenant_breakdown(snap),
        }

    def health_state(self) -> str:
        """``ready`` (running, device path live), ``degraded`` (running but
        the breaker is open — eager fallback serving), or ``stopped``."""
        if not self.running:
            return "stopped"
        return "degraded" if self.breaker.state == OPEN else "ready"
