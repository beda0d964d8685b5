"""Fleet front door: load-aware routing, health-probe ejection,
mid-flight failover, pre-flight admission control, rolling deploys and
autoscaling over a shared-nothing replica fleet (docs/serving.md
"Replica fleet & front door").

The PyTorch port's copy of the JAX package's ``serving/frontdoor.py``:
the same routing score, probe ladder, chaos sites, FaultLog kinds,
metric series and ``fleet_snapshot`` / ``summary`` / ``health``
shapes, over the port's runtimes. Replicas serve on the fleet's
device (``FleetConfig.device``): the CUDA device unless the caller
names another one.

The contract callers get is ONE invariant stronger than a single
runtime's: **zero lost futures even when a replica dies mid-flight**.
Every request the front door accepts resolves exactly once — a result
record, or a *typed* shed (:class:`~.runtime.OverloadError` /
:class:`~.runtime.DeadlineExceededError`) — so the accounting identity
``submitted = completed + typed sheds`` holds across replica kills,
ejections, rolling deploys and autoscale events. The chaos-campaign
``fleet`` scenario asserts exactly that.

* **load-aware routing** — each request goes to the replica minimizing
  ``queue_depth + TG_FLEET_P99_WEIGHT × windowed_p99_ms`` (live queue
  depth; p99 cached from the last health probe), ties broken by replica
  id. Not round-robin: a replica with a deep queue or a fat tail sheds
  load to its peers automatically.
* **health probing + ejection** — a ``tg-fleet`` probe thread (cadence
  ``TG_FLEET_PROBE_MS``; tests call :meth:`FrontDoor.probe_now`
  synchronously) reads each replica's ``registry.health()``. A replica
  that reports un-ready (breaker open, watchdog stall → breaker trip,
  degraded readiness) is **ejected** immediately; ``TG_FLEET_PROBE_FAILURES``
  consecutive probe *failures* (raise/timeout — the ``fleet.probe``
  chaos site) eject it too. Ejected replicas take no new traffic but
  stay probed: ``TG_FLEET_READMIT_PROBES`` consecutive healthy probes
  readmit them.
* **mid-flight failover** — a request whose replica dies (future fails
  with :class:`~.fleet.ReplicaLostError` / ``RuntimeStoppedError``, or
  the ``fleet.route`` chaos site raises) is re-dispatched to a survivor
  with a bounded retry budget (``TG_FLEET_MAX_FAILOVERS``) inside the
  request's remaining deadline. Budget exhausted or no survivor →
  typed ``OverloadError`` shed, never a hang.
* **pre-flight admission control** — the predicted
  bytes of one padded flush, extrapolated from the measured MANIFEST
  ``costs`` table rows (``bytes(bucket) = base_bytes × bucket /
  base_bucket``; observability/devicemem.py), are compared against
  ``TG_DEVICE_BUDGET`` **before** dispatch. Over budget at the target
  bucket → the flush is *split*: every replica's ``max_batch`` drops to
  the largest admitted bucket. Over budget even at the 256-row minimum
  bucket → requests are *refused* with the typed
  :class:`~.fleet.AdmissionRefusedError` at the door — the scorer is
  never invoked (catch-and-bisect becomes refuse-or-split).
* **rolling deploy** — :meth:`FrontDoor.deploy` generalizes the
  zero-loss ``registry.swap`` across replicas: drain (router skips the
  replica while peers exist) → swap (new runtime warmed + started
  before the entry flips) → readmit, one replica at a time.
* **autoscaling** — on the probe cadence the fleet aggregates each
  replica's ``scale_hint`` (observability/slo.py, via ``health()``):
  any ``up`` spawns a replica below ``TG_FLEET_MAX``; unanimous
  ``down`` retires (drains) one above ``TG_FLEET_MIN``.
* **multi-model placement & paging** (``placement=``)
  — a :class:`~.placement.Placer` bin-packs the model set onto replicas
  against per-replica capacity (``TG_PLACE_MAX_WARM`` count cap /
  ``TG_PLACE_BUDGET`` predicted bytes from MANIFEST ``costs``), routes
  each request to a replica holding its model *warm* (falling back to
  the best page-in candidate and steering around replicas that are
  mid-page-in), demand-pages cold models under a single-flight guard
  (a manifest-verified load and warm pass), and LRU-
  evicts idle models — exempting any with active SLO page alerts.
  Requests for a model this fleet does not serve raise the typed
  :class:`~.placement.UnknownModelError` (the network edge's 404).
  Off (``placement=None``) the front door behaves exactly as before;
  subprocess fleets ignore placement (replicas hold the full set —
  typed ``placement_unsupported`` warning).

Front-door sheds (admission refusal, no healthy replica, deadline)
count on the SAME ``tg_serve_shed_total`` / ``tg_serve_tenant_shed_total``
series the runtime uses — so fleet-level sheds burn the same SLO error
budgets and fire the same burn-rate alerts (observability/slo.py); the
front door attaches its own sampler + SLO trackers on start. Replica
loss dumps a ``replica_lost`` post-mortem bundle
(observability/postmortem.py).

Chaos sites: ``fleet.route`` (routing/dispatch failure → failover),
``fleet.replica_kill`` (replica crash mid-flight → failover + bundle),
``fleet.probe`` (probe transport failure → ejection ladder); the
placement layer adds ``place.assign`` / ``place.evict`` /
``place.pagein`` (serving/placement.py).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Dict, List, Optional

from ..local.scoring import SCORE_ERROR_KEY
from ..observability import blackbox as _blackbox
from ..observability import metrics as _obs_metrics
from ..observability import postmortem as _postmortem
from ..observability import slo as _slo
from ..observability import timeseries as _timeseries
from ..robustness import faults
from ..robustness import watchdog as _watchdog
from ..robustness.policy import FaultLog, FaultReport
from .fleet import (
    ACTIVE, DEAD, DRAINING, EJECTED, RETIRED, AdmissionRefusedError,
    FleetConfig, ReplicaLostError, build_replica,
)
from .placement import PlaceConfig, Placer, UnknownModelError
from .runtime import (
    DeadlineExceededError, OverloadError, RuntimeStoppedError, ServeConfig,
    ServingError,
)

#: live (started, unclosed) front doors — the conftest/campaign no-leak
#: oracle asserts this is empty around every test/schedule
_LIVE_LOCK = threading.Lock()
_LIVE: List["FrontDoor"] = []


def live_fleets() -> List["FrontDoor"]:
    with _LIVE_LOCK:
        return list(_LIVE)


class _FrontRequest:
    """One accepted request's failover state (owned by the front door;
    the caller only ever sees ``future``)."""

    __slots__ = ("row", "future", "enqueued", "deadline", "tenant",
                 "model", "attempts", "corr", "tried", "replica",
                 "overloaded")

    def __init__(self, row, future, enqueued, deadline, tenant, model,
                 corr):
        self.row = row
        self.future = future
        self.enqueued = enqueued
        self.deadline = deadline  # absolute monotonic, None = none
        self.tenant = tenant
        self.model = model
        self.corr = corr
        self.attempts = 0          # failover re-dispatches so far
        self.tried: set = set()    # replica ids that already failed it
        self.replica: Optional[str] = None
        self.overloaded = False    # some candidate's queue was full


class FrontDoor:
    """The fleet's single submission surface. Duck-types enough of
    :class:`~.runtime.ServingRuntime` (``submit`` / ``summary`` /
    ``queue_depth`` / ``config`` / ``metrics`` / ``sampler``) that the
    open-loop load generator and the SLO/scale-hint machinery drive it
    unchanged. Use as a context manager::

        with FrontDoor({"churn": "/path/to/model"}, replicas=2) as fd:
            rec = fd.submit({"x1": 0.2}).result(timeout=5)
    """

    def __init__(self, models: Dict[str, Any],
                 replicas: Optional[int] = None,
                 name: Optional[str] = None,
                 config: Optional[ServeConfig] = None,
                 fleet_config: Optional[FleetConfig] = None,
                 fault_log: Optional[FaultLog] = None,
                 warm: Optional[bool] = None,
                 placement: Any = None,
                 auto_start: bool = True):
        if not models:
            raise ValueError("a fleet needs at least one model")
        self.models = dict(models)
        self.default_model = next(iter(self.models))
        #: the fleet answers SLO/scale queries under the default model's
        #: name so single-model fleets (the common case) share labels
        #: with the per-replica series
        self.name = name or self.default_model
        self.config = config or ServeConfig.from_env()
        self.fleet_config = fleet_config or FleetConfig.from_env()
        self.fault_log = fault_log or FaultLog()
        #: serve-local instruments, always on (mirrored to the global
        #: registry when TG_METRICS — same contract as the runtime)
        self.metrics = _obs_metrics.MetricsRegistry()
        self.sampler: Optional[_timeseries.MetricsSampler] = None
        self.slo_trackers: List[_slo.SLOTracker] = []
        self._warm = warm
        self._lock = threading.Lock()
        self._replicas: Dict[str, Any] = {}
        self._seq = 0
        self._accepting = False
        self._closed = False
        self._started = False
        self._probing = False
        self._probe_wake = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        self._heart = None
        self._failovers = 0
        self._ejections = 0
        self._readmissions = 0
        self._kills = 0
        self._submitted = 0
        self.scale_events: List[Dict[str, Any]] = []
        self.deploy_history: List[Dict[str, Any]] = []
        self._admission: Dict[str, Any] = {"enabled": False}
        #: multi-model placement (None = off, legacy every-model-on-
        #: every-replica behavior; True = PlaceConfig.from_env())
        self._placement = placement
        self.placer: Optional[Placer] = None
        self._planned: Dict[str, List[str]] = {}
        n = replicas if replicas is not None else max(
            1, self.fleet_config.min_replicas)
        self._initial_replicas = n
        if auto_start:
            self.start()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FrontDoor":
        with self._lock:
            if self._closed:
                raise RuntimeStoppedError(f"fleet '{self.name}' is closed")
            if self._started:
                return self
            self._started = True
            self._accepting = True
        if self._placement:
            if self.fleet_config.subprocess:
                # subprocess replicas hold their full model set over the
                # worker protocol; paging needs in-proc registries —
                # degrade typed rather than half-work
                self.fault_log.add(FaultReport(
                    site="place.assign", kind="placement_unsupported",
                    detail={"fleet": self.name,
                            "reason": "subprocess fleet: replicas hold "
                            "the full model set, placement disabled"}))
            else:
                pc = (self._placement
                      if isinstance(self._placement, PlaceConfig)
                      else PlaceConfig.from_env())
                self.placer = Placer(
                    self.models, pc, name=self.name,
                    fault_log=self.fault_log, metrics=self.metrics,
                    protect=self._slo_protected)
                with self._lock:
                    rids = [f"r{self._seq + i}"
                            for i in range(self._initial_replicas)]
                self._planned = self.placer.plan(rids)
        for _ in range(self._initial_replicas):
            self.spawn_replica(count_event=False)
        self.admission_check()
        self.sampler = _timeseries.attach(self.metrics,
                                          name=f"fleet[{self.name}]")
        if self.sampler is not None and not self.slo_trackers:
            self.slo_trackers = [
                _slo.SLOTracker(spec, self.sampler, self.metrics,
                                runtime=self)
                for m in self.models for spec in _slo.specs_for(m)]
            self.sampler.on_sample.append(self._evaluate_slo)
        if self.fleet_config.probe_interval_ms > 0:
            self._probing = True
            self._heart = _watchdog.register(
                f"tg-fleet[{self.name}]", kind="fleet.probe",
                fault_log=self.fault_log)
            self._probe_thread = threading.Thread(
                target=self._probe_loop, name=f"tg-fleet[{self.name}]",
                daemon=True)
            self._probe_thread.start()
        with _LIVE_LOCK:
            _LIVE.append(self)
        return self

    def close(self, drain: bool = True) -> None:
        with self._lock:
            if self._closed:
                return
            self._accepting = False
            self._probing = False
        self._probe_wake.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=10)
            if self._probe_thread.is_alive():
                _watchdog.report_thread_stalled(
                    site="fleet.close", thread_name=self._probe_thread.name,
                    waited_s=10.0, fault_log=self.fault_log)
        if self._heart is not None:
            self._heart.close()
            self._heart = None
        with self._lock:
            reps = list(self._replicas.values())
        for rep in reps:
            if rep.state not in (DEAD, RETIRED):
                try:
                    rep.close(drain=drain)
                except Exception:  # pragma: no cover - defensive
                    pass
                rep.state = RETIRED
        _timeseries.detach(self.sampler)
        self.sampler = None
        if self.placer is not None:
            self.placer.close()
        with self._lock:
            self._closed = True
        with _LIVE_LOCK:
            if self in _LIVE:
                _LIVE.remove(self)

    def __enter__(self) -> "FrontDoor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- replica lifecycle ---------------------------------------------------
    def spawn_replica(self, count_event: bool = True):
        """Build + admit one replica (in-process, or subprocess under
        the fleet flag). Slow work happens outside the fleet lock."""
        with self._lock:
            rid = f"r{self._seq}"
            self._seq += 1
        cfg = dataclasses.replace(self.config)
        admitted = self._admission.get("admittedRows")
        if admitted and admitted < cfg.max_batch:
            cfg.max_batch = int(admitted)
        models = self.models
        if self.placer is not None:
            assigned = self._planned.pop(rid, None)
            if assigned is None:
                assigned = self.placer.assign_new(rid)
            if not assigned:
                # an empty replica never reports ready — seed it with a
                # warm copy of the default model (warm-copy redundancy)
                assigned = [self.default_model]
                self.placer.note_resident(rid, self.default_model)
            models = {m: self.models[m] for m in assigned}
        rep = build_replica(rid, models, config=cfg,
                            fleet_config=self.fleet_config,
                            warm=self._warm)
        with self._lock:
            self._replicas[rid] = rep
        if count_event:
            self._count("tg_fleet_scale_events_total", direction="up")
        _blackbox.record("fleet.spawn", fleet=self.name, replica=rid,
                         replicaKind=rep.kind)
        self._set_replica_gauges()
        return rep

    def retire_replica(self, rid: str) -> None:
        """Graceful scale-down: drain (queued requests score), then
        retire — never routed or probed again."""
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None or rep.state in (DEAD, RETIRED):
                return
            rep.state = DRAINING
        rep.close(drain=True)
        rep.state = RETIRED
        if self.placer is not None:
            self.placer.drop_replica(rid)
        self._count("tg_fleet_scale_events_total", direction="down")
        _blackbox.record("fleet.retire", fleet=self.name, replica=rid)
        self._set_replica_gauges()

    def kill_replica(self, rid: str,
                     error: Optional[BaseException] = None) -> None:
        """A replica crashed (or the ``fleet.replica_kill`` chaos site
        says it did): mark it dead FIRST (callbacks classify against the
        state), fail its queued futures over, dump the post-mortem."""
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None or rep.state == DEAD:
                return
            rep.state = DEAD
            self._kills += 1
        inflight = 0
        try:
            inflight = rep.queue_depth(self.default_model)
        except Exception:
            pass
        orphaned: List[str] = []
        if self.placer is not None:
            # models whose ONLY warm copy died page in on a survivor on
            # next demand — the density scenario's recovery contract
            orphaned = self.placer.drop_replica(rid)
        self._count("tg_fleet_replica_lost_total", replica=rid)
        self.fault_log.add(FaultReport(
            site="fleet.replica_kill", kind="replica_lost",
            detail={"fleet": self.name, "replica": rid,
                    "inflight": inflight,
                    "orphanedModels": orphaned or None,
                    "error": (f"{type(error).__name__}: {error}"[:200]
                              if error else None)}))
        _blackbox.record("fleet.replica_lost", fleet=self.name,
                         replica=rid, inflight=inflight)
        # trigger event: losing a replica is the fleet's canonical
        # incident — freeze the recorder context before the failover
        # storm scrolls it away (rate-limited; postmortem.py)
        _postmortem.trigger(
            "replica_lost", fault_log=self.fault_log, metrics=self.metrics,
            detail={"fleet": self.name, "replica": rid,
                    "inflight": inflight,
                    "orphanedModels": orphaned or None,
                    "error": (f"{type(error).__name__}: {error}"[:200]
                              if error else None)})
        # closing without drain fails every queued future — each failure
        # re-enters _on_inner_done and fails over to a survivor; flushes
        # already in the dead replica's pipelined dataplane complete with
        # real records during the close (completer drain), so depth > 1
        # adds no lost futures
        rep.kill()
        self._set_replica_gauges()

    # -- admission control ---------------------------------------------------
    def admission_check(self) -> Dict[str, Any]:
        """Recompute the pre-flight admission plan from the measured
        cost table (docs/serving.md: ``bytes(bucket) = base_bytes ×
        bucket / base_bucket`` — flush bytes scale linearly in padded
        rows). Called at start, after spawns, and on demand."""
        budget = int(self.fleet_config.device_budget or 0)
        plan: Dict[str, Any] = {
            "enabled": bool(budget), "budgetBytes": budget or None,
            "refused": False, "split": False, "admittedRows": None,
            "estBytes": None, "basis": None}
        if not budget:
            self._admission = plan
            return plan
        from ..observability import devicemem as _devicemem
        from ..utils.padding import row_bucket
        by_bucket: Dict[int, int] = {}
        for row in _devicemem.observatory().cost_table().values():
            b, v = int(row.get("bucket", 0)), int(row.get("bytes", 0))
            if b > 0 and v > 0:
                by_bucket[b] = by_bucket.get(b, 0) + v
        if not by_bucket:
            # nothing measured yet (no warm, no MANIFEST costs): admit —
            # admission control is a consumer of telemetry, not a guess
            plan["basis"] = "no-cost-rows"
            self._admission = plan
            return plan
        base_bucket = min(by_bucket)
        base_bytes = by_bucket[base_bucket]
        plan["basis"] = f"{base_bytes}B@{base_bucket}"

        def est(b: int) -> int:
            return int(base_bytes * b / base_bucket)

        target = row_bucket(self.config.max_batch)
        b = target
        while est(b) > budget and b > 256:
            nb = row_bucket(b // 2)
            b = nb if nb < b else 256
        plan["estBytes"] = est(b)
        if est(b) > budget:
            plan["refused"] = True
        else:
            plan["admittedRows"] = b
            if b < target:
                plan["split"] = True
                self._apply_split(b)
                self._count("tg_fleet_admission_splits_total")
                self.fault_log.add(FaultReport(
                    site="fleet.admission", kind="admission_split",
                    detail={"fleet": self.name, "targetRows": target,
                            "admittedRows": b, "estBytes": plan["estBytes"],
                            "budgetBytes": budget}))
        self._admission = plan
        return plan

    def _apply_split(self, rows: int) -> None:
        """Lower every in-process replica's flush bucket to the admitted
        size (subprocess replicas get it at spawn via their config)."""
        with self._lock:
            reps = list(self._replicas.values())
        for rep in reps:
            reg = getattr(rep, "registry", None)
            if reg is None:
                continue
            for m in reg.names():
                try:
                    rt = reg.runtime(m)
                    rt.config.max_batch = min(rt.config.max_batch, rows)
                except Exception:  # pragma: no cover - defensive
                    pass

    def _admit(self, model: str, tenant: Optional[str]) -> None:
        if self.placer is not None and model in self.placer.refused:
            # per-model admission: the model's predicted resident bytes
            # fit on NO replica — typed refusal, never a lost future
            self._shed(model, "placement", tenant)
            self.placer.check_admitted(model)  # raises typed
        plan = self._admission
        if plan.get("refused"):
            self._shed(model, "admission", tenant)
            raise AdmissionRefusedError(
                f"admission refused pre-dispatch: predicted flush bytes "
                f"exceed TG_DEVICE_BUDGET={plan['budgetBytes']} even at "
                f"the 256-row minimum bucket (estimate "
                f"{plan['estBytes']}B from {plan['basis']})")

    # -- request path --------------------------------------------------------
    def submit(self, row: Dict[str, Any],
               deadline_ms: Optional[float] = None,
               tenant: Optional[str] = None,
               model: Optional[str] = None) -> Future:
        """Route one request; returns a Future that resolves exactly
        once — a record, or a typed shed — regardless of replica loss
        (the zero-lost-futures contract)."""
        model = model or self.default_model
        if model not in self.models:
            # a wrong model id is a *client* error (the network edge's
            # 404), typed before the request is counted as accepted
            self._shed(model, "unknown_model", tenant)
            raise UnknownModelError(
                f"fleet '{self.name}' serves no model '{model}' "
                f"(have: {sorted(self.models)})")
        with self._lock:
            if not self._accepting:
                raise RuntimeStoppedError(
                    f"fleet '{self.name}' is not accepting requests")
            self._submitted += 1
        self._admit(model, tenant)
        if self.placer is not None:
            self.placer.touch(model)
        dl_ms = (deadline_ms if deadline_ms is not None
                 else self.config.default_deadline_ms)
        now = time.monotonic()
        deadline = now + dl_ms / 1000.0 if dl_ms else None
        fut: Future = Future()
        corr = (_blackbox.new_correlation_id()
                if _blackbox.blackbox_enabled() else None)
        fut.tg_corr = corr
        st = _FrontRequest(row, fut, now, deadline, tenant, model, corr)
        self._dispatch(st, raise_to_caller=True)
        return fut

    def score(self, row: Dict[str, Any], timeout: Optional[float] = None,
              **kw) -> Dict[str, Any]:
        return self.submit(row, **kw).result(timeout)

    def _pick(self, model: str, exclude: set):
        """Load-aware replica selection: min(queue_depth + p99 penalty),
        ties by replica id. Draining replicas only when nothing else is
        active (a single-replica rolling deploy keeps serving —
        ``registry.swap`` is zero-loss). Under placement the pick is
        model-aware: replicas holding ``model`` warm win, replicas
        mid-page-in are steered around, and when every warm copy is
        gone the least-loaded survivor becomes the page-in candidate."""
        with self._lock:
            cands = [r for r in self._replicas.values()
                     if r.state == ACTIVE and r.rid not in exclude]
            if not cands:
                cands = [r for r in self._replicas.values()
                         if r.state == DRAINING and r.rid not in exclude]
        if not cands:
            return None
        w = self.fleet_config.p99_weight

        def score(r):
            try:
                depth = float(r.queue_depth(model))
            except Exception:
                return (float("inf"), r.rid)
            return (depth + w * r.probe.p99_ms.get(model, 0.0), r.rid)

        if self.placer is None:
            return min(cands, key=score)
        pl = self.placer
        warm = [r for r in cands if pl.is_resident(r.rid, model)]
        if warm:
            # route AROUND replicas busy paging in another model —
            # unless they hold the only warm copies
            quiet = [r for r in warm if not pl.paging(r.rid)]
            return min(quiet or warm, key=score)
        # model is cold fleet-wide: best page-in candidate by total
        # resident queue depth (again preferring non-paging replicas)
        calm = [r for r in cands if not pl.paging(r.rid)]

        def total_depth(r):
            d = 0
            for m in pl.residents(r.rid):
                try:
                    d += r.queue_depth(m)
                except Exception:
                    pass
            return (d, r.rid)

        return min(calm or cands, key=total_depth)

    def _dispatch(self, st: _FrontRequest,
                  raise_to_caller: bool = False) -> None:
        try:
            self._dispatch_inner(st)
        except ServingError as e:
            if raise_to_caller:
                raise
            self._fail(st.future, e)

    def _dispatch_inner(self, st: _FrontRequest) -> None:
        """Route until an accepting replica takes the request; every
        exit is a routed request or a typed raise (counted shed)."""
        while True:
            now = time.monotonic()
            if st.deadline is not None and now >= st.deadline:
                self._shed(st.model, "deadline", st.tenant, corr=st.corr)
                raise DeadlineExceededError(
                    f"deadline expired after "
                    f"{(now - st.enqueued) * 1000:.1f}ms at the front "
                    f"door (fleet '{self.name}')")
            rep = self._pick(st.model, st.tried)
            if rep is None:
                # every candidate is either gone or full: a full fleet
                # is plain overload backpressure; a replica-less fleet
                # is the no_replica shed (both typed OverloadError)
                reason = "overload" if st.overloaded else "no_replica"
                self._shed(st.model, reason, st.tenant, corr=st.corr)
                raise OverloadError(
                    f"fleet '{self.name}' has no "
                    f"{'un-saturated' if st.overloaded else 'healthy'} "
                    f"replica for model '{st.model}' "
                    f"(attempt {st.attempts + 1}); request shed")
            # chaos: the selected replica crashes as we route to it —
            # the canonical mid-flight kill (its queued requests fail
            # over right here, through kill_replica → _on_inner_done)
            try:
                faults.inject("fleet.replica_kill", key=rep.rid)
            except Exception as e:
                self.kill_replica(rep.rid, error=e)
                st.tried.add(rep.rid)
                continue
            if (self.placer is not None
                    and not self.placer.is_resident(rep.rid, st.model)):
                # cold model: demand page-in (single-flight — concurrent
                # requests for it ride ONE load). A failed
                # page-in burns a failover attempt, bounded as ever.
                if not self._page_in(rep, st.model):
                    st.attempts += 1
                    self._record_failover(st, rep.rid, RuntimeError(
                        f"page-in of model '{st.model}' on replica "
                        f"'{rep.rid}' failed"))
                    if st.attempts > self.fleet_config.max_failovers:
                        self._shed(st.model, "no_replica", st.tenant,
                                   corr=st.corr)
                        raise OverloadError(
                            f"request shed after {st.attempts} attempts: "
                            f"model '{st.model}' could not page in "
                            f"(fleet '{self.name}')")
                    continue
            try:
                # chaos: the routing/dispatch hop itself fails (listener
                # death, connection reset) — failover, bounded
                faults.inject("fleet.route", key=rep.rid)
                remaining_ms = ((st.deadline - now) * 1000.0
                                if st.deadline is not None else None)
                inner = rep.submit(st.model, st.row,
                                   deadline_ms=remaining_ms,
                                   tenant=st.tenant)
            except OverloadError:
                # this replica's queue is full — plain backpressure, not
                # a failure: route around it without burning the
                # failover budget (every-candidate-full sheds above)
                st.tried.add(rep.rid)
                st.overloaded = True
                continue
            except Exception as e:
                # a dead/stopped replica is excluded from this request's
                # retries; a transient hop failure is not — the bounded
                # attempt budget is what terminates
                if (isinstance(e, (ReplicaLostError,
                                   RuntimeStoppedError)) or rep.dead):
                    st.tried.add(rep.rid)
                st.attempts += 1
                self._record_failover(st, rep.rid, e)
                if st.attempts > self.fleet_config.max_failovers:
                    self._shed(st.model, "no_replica", st.tenant,
                               corr=st.corr)
                    raise OverloadError(
                        f"request shed after {st.attempts} failed "
                        f"dispatch attempts across the fleet "
                        f"'{self.name}' (last: {type(e).__name__}: "
                        f"{e})") from e
                continue
            st.replica = rep.rid
            rep.routed += 1
            self._count("tg_fleet_routed_total", replica=rep.rid)
            inner.add_done_callback(
                lambda f, _st=st: self._on_inner_done(_st, f))
            return

    def _on_inner_done(self, st: _FrontRequest, inner: Future) -> None:
        exc = inner.exception()
        if exc is None:
            self._complete(st, inner.result())
            return
        if isinstance(exc, DeadlineExceededError):
            # the replica shed it pre-dispatch; mirror the shed on the
            # fleet series so fleet SLOs see it, and propagate typed
            self._shed(st.model, "deadline", st.tenant, corr=st.corr)
            self._fail(st.future, exc)
            return
        # replica-side loss (kill, stop, pipe close) or an untyped
        # surprise: fail over within the budget + deadline
        st.tried.add(st.replica)
        st.attempts += 1
        self._record_failover(st, st.replica, exc)
        if st.attempts > self.fleet_config.max_failovers:
            self._shed(st.model, "no_replica", st.tenant, corr=st.corr)
            self._fail(st.future, OverloadError(
                f"request shed after {st.attempts} failovers (fleet "
                f"'{self.name}'; last replica '{st.replica}' failed "
                f"with {type(exc).__name__})"))
            return
        self._dispatch(st, raise_to_caller=False)

    def _page_in(self, rep, model: str) -> bool:
        """Make ``model`` warm on ``rep`` through the placer's
        single-flight guard (a manifest-verified load and warm pass of
        the saved model). False → the caller burns a failover
        attempt; the placer already typed the failure."""
        reg = getattr(rep, "registry", None)
        if reg is None:  # pragma: no cover - placement gates subprocess
            return False

        def _load(m: str) -> None:
            # onto the replica's device (Replica.load keeps the warm
            # default: a saved directory warms unless told otherwise)
            rep.load(m, self.models[m], warm=self._warm)

        def _unload(m: str) -> None:
            reg.unregister(m, drain=True)

        return self.placer.page_in(rep.rid, model, _load, _unload)

    def _slo_protected(self, model: str) -> bool:
        """The placer's eviction-protection hook: a model with an active
        SLO alert (page/ticket burning now) must not be paged out —
        eviction latency would deepen the very burn it is alerted on."""
        for t in self.slo_trackers:
            spec = getattr(t, "spec", None)
            if spec is None or getattr(spec, "model", None) != model:
                continue
            try:
                if t.active_alerts():
                    return True
            except Exception:  # pragma: no cover - defensive
                pass
        return False

    def _record_failover(self, st: _FrontRequest, rid: Optional[str],
                         error: BaseException) -> None:
        with self._lock:
            self._failovers += 1
        self._count("tg_fleet_failover_total")
        self.fault_log.add(FaultReport(
            site="fleet.route", kind="fleet_failover",
            detail={"fleet": self.name, "model": st.model,
                    "replica": rid, "attempt": st.attempts,
                    "error": f"{type(error).__name__}: {error}"[:200]}))
        _blackbox.record("fleet.failover", corr=st.corr, fleet=self.name,
                         replica=rid, attempt=st.attempts)

    def _complete(self, st: _FrontRequest, rec: Dict[str, Any]) -> None:
        # account BEFORE resolving (same ordering contract as the
        # runtime's _finish: a woken waiter must see the counters)
        seconds = time.monotonic() - st.enqueued
        self._count("tg_serve_rows_total", model=st.model)
        if SCORE_ERROR_KEY in rec:
            self._count("tg_serve_quarantined_total", model=st.model)
        self.metrics.histogram(
            "tg_serve_request_seconds",
            "front-door enqueue-to-result latency (failovers included)",
            model=st.model).observe(seconds, exemplar=st.corr)
        _obs_metrics.observe("tg_serve_request_seconds", seconds,
                             model=st.model)
        if st.tenant is not None:
            self._count("tg_serve_tenant_rows_total", model=st.model,
                        tenant=st.tenant)
            self.metrics.histogram(
                "tg_serve_tenant_request_seconds",
                "per-tenant front-door latency", model=st.model,
                tenant=st.tenant).observe(seconds)
        if _blackbox.blackbox_enabled():
            _blackbox.record("fleet.resolve", corr=st.corr,
                             fleet=self.name, replica=st.replica,
                             attempts=st.attempts,
                             seconds=round(seconds, 6))
        try:
            st.future.set_result(rec)
        except InvalidStateError:
            pass

    def _shed(self, model: str, reason: str, tenant: Optional[str],
              corr: Optional[str] = None) -> None:
        """Front-door sheds land on the SAME series the runtime sheds
        use — SLO availability and burn-rate alerts must see fleet-level
        sheds (docs/serving.md)."""
        self._count("tg_serve_shed_total", model=model, reason=reason)
        if tenant is not None:
            self._count("tg_serve_tenant_shed_total", model=model,
                        tenant=tenant)
        _blackbox.record("serve.shed", corr=corr, model=model,
                         reason=reason, fleet=self.name)

    @staticmethod
    def _fail(fut: Future, exc: BaseException) -> None:
        try:
            fut.set_exception(exc)
        except InvalidStateError:
            pass

    def _count(self, name: str, n: float = 1.0, help: str = "",
               **labels: str) -> None:
        """Serve-local counter + gated global mirror; ``tg_fleet_*``
        series carry a ``fleet`` label (replica-labelled where noted)."""
        lbls = dict(labels)
        if name.startswith("tg_fleet_"):
            lbls.setdefault("fleet", self.name)
        self.metrics.counter(name, help, **lbls).inc(n)
        _obs_metrics.inc_counter(name, n, help, **lbls)

    # -- probing / ejection / autoscale --------------------------------------
    def _probe_loop(self) -> None:
        interval = self.fleet_config.probe_interval_ms / 1000.0
        while self._probing:
            if self._heart is not None:
                self._heart.beat()
            try:
                self.probe_now()
            except Exception:  # pragma: no cover - the probe must survive
                pass
            self._probe_wake.wait(interval)
            self._probe_wake.clear()

    def probe_now(self) -> None:
        """One synchronous probe pass over every probed replica (the
        deterministic entry the tests and the campaign scenario use),
        followed by the autoscale step when enabled."""
        cfg = self.fleet_config
        with self._lock:
            reps = [r for r in self._replicas.values()
                    if r.state in (ACTIVE, EJECTED, DRAINING)]
        for rep in reps:
            try:
                # chaos: the probe transport fails (timeout, reset) —
                # consecutive failures walk the ejection ladder
                faults.inject("fleet.probe", key=rep.rid)
                h = rep.health()
            except Exception as e:
                rep.probe.healthy = 0
                rep.probe.failures += 1
                self._count("tg_fleet_probe_failures_total",
                            replica=rep.rid)
                self.fault_log.add(FaultReport(
                    site="fleet.probe", kind="fleet_probe_failed",
                    detail={"fleet": self.name, "replica": rep.rid,
                            "failures": rep.probe.failures,
                            "error": f"{type(e).__name__}: {e}"[:200]}))
                if rep.dead:
                    # the replica vanished between probes (a real
                    # process death no one killed through the fleet)
                    self.kill_replica(rep.rid, error=e)
                elif (rep.state == ACTIVE
                        and rep.probe.failures >= cfg.probe_failures):
                    self._eject(rep, reason=f"{rep.probe.failures} "
                                f"consecutive probe failures")
                continue
            rep.probe.failures = 0
            models = h.get("models", {})
            for m, ms in models.items():
                p99 = (ms.get("latency") or {}).get("p99")
                if p99 is not None:
                    rep.probe.p99_ms[m] = float(p99) * 1000.0
            rep.probe.scale_hints = dict(h.get("scaleHints") or {})
            if not h.get("ready"):
                rep.probe.healthy = 0
                if rep.state == ACTIVE:
                    states = {m: ms.get("state")
                              for m, ms in models.items()}
                    self._eject(rep,
                                reason=f"degraded readiness: {states}")
            else:
                rep.probe.healthy += 1
                if (rep.state == EJECTED
                        and rep.probe.healthy >= cfg.readmit_probes):
                    self._readmit(rep)
        self._set_replica_gauges()
        if cfg.autoscale:
            self.autoscale_now()

    def _eject(self, rep, reason: str) -> None:
        rep.state = EJECTED
        rep.probe.healthy = 0
        with self._lock:
            self._ejections += 1
        self._count("tg_fleet_ejections_total", replica=rep.rid)
        self.fault_log.add(FaultReport(
            site="fleet.probe", kind="fleet_ejected",
            detail={"fleet": self.name, "replica": rep.rid,
                    "reason": reason[:200]}))
        _blackbox.record("fleet.eject", fleet=self.name, replica=rep.rid,
                         reason=reason[:120])

    def _readmit(self, rep) -> None:
        rep.state = ACTIVE
        rep.probe.failures = 0
        with self._lock:
            self._readmissions += 1
        self._count("tg_fleet_readmissions_total", replica=rep.rid)
        self.fault_log.add(FaultReport(
            site="fleet.probe", kind="fleet_readmitted",
            detail={"fleet": self.name, "replica": rep.rid,
                    "healthyProbes": rep.probe.healthy}))
        _blackbox.record("fleet.readmit", fleet=self.name,
                         replica=rep.rid)

    def autoscale_now(self, hints: Optional[List[str]] = None) -> str:
        """One autoscale step from the replicas' cached scale hints
        (``registry.health()["scaleHints"]``; observability/slo.py):
        any ``up`` → spawn below TG_FLEET_MAX; unanimous ``down`` →
        retire (drain) above TG_FLEET_MIN. Returns the decision."""
        cfg = self.fleet_config
        with self._lock:
            active = [r for r in self._replicas.values()
                      if r.state == ACTIVE]
            present = [r for r in self._replicas.values()
                       if r.state in (ACTIVE, DRAINING, EJECTED)]
        if hints is None:
            hints = [h for r in active
                     for h in r.probe.scale_hints.values()]
        if any(h == "up" for h in hints):
            decision = "up"
        elif hints and all(h == "down" for h in hints):
            decision = "down"
        else:
            decision = "hold"
        if decision == "up" and len(present) < cfg.max_replicas:
            rep = self.spawn_replica(count_event=False)
            self._count("tg_fleet_scale_events_total", direction="up")
            self.scale_events.append(
                {"direction": "up", "replica": rep.rid,
                 "hints": list(hints),
                 "replicas": len(present) + 1})
            _blackbox.record("fleet.scale", fleet=self.name,
                             direction="up", replica=rep.rid)
        elif decision == "down" and len(active) > cfg.min_replicas:
            # retire the youngest active replica (deterministic; it has
            # the least cache warmth to lose)
            rep = max(active, key=lambda r: int(r.rid[1:]))
            self.retire_replica(rep.rid)
            self.scale_events.append(
                {"direction": "down", "replica": rep.rid,
                 "hints": list(hints),
                 "replicas": len(present) - 1})
            _blackbox.record("fleet.scale", fleet=self.name,
                             direction="down", replica=rep.rid)
        return decision

    # -- rolling deploy ------------------------------------------------------
    def deploy(self, model_or_path: Any,
               model: Optional[str] = None) -> List[Dict[str, Any]]:
        """Rolling model deploy with zero request loss: one replica at a
        time, drain (router prefers its peers) → ``registry.swap`` (new
        runtime warmed + started before the entry flips; the old drains
        after) → readmit. A failed swap leaves that replica on the old
        model, typed ``fleet_deploy_failed``, and the rollout continues."""
        model = model or self.default_model
        report: List[Dict[str, Any]] = []
        with self._lock:
            reps = [r for r in self._replicas.values()
                    if r.state in (ACTIVE, EJECTED)]
        for rep in reps:
            prev = rep.state
            rep.state = DRAINING
            try:
                rep.swap(model, model_or_path)
                rep.state = prev
                report.append({"replica": rep.rid, "ok": True})
            except Exception as e:
                rep.state = prev
                self.fault_log.add(FaultReport(
                    site="fleet.deploy", kind="fleet_deploy_failed",
                    detail={"fleet": self.name, "replica": rep.rid,
                            "error": f"{type(e).__name__}: {e}"[:300]}))
                report.append({"replica": rep.rid, "ok": False,
                               "error": f"{type(e).__name__}: {e}"[:300]})
        if isinstance(model_or_path, str) or all(
                r["ok"] for r in report):
            # future spawns (autoscale) must come up on the new artifact
            self.models[model] = model_or_path
        self.deploy_history.append(
            {"model": model, "replicas": report,
             "ok": all(r["ok"] for r in report)})
        _blackbox.record("fleet.deploy", fleet=self.name, model=model,
                         ok=all(r["ok"] for r in report))
        return report

    # -- introspection -------------------------------------------------------
    def queue_depth(self) -> int:
        with self._lock:
            reps = [r for r in self._replicas.values()
                    if r.state in (ACTIVE, DRAINING)]
        total = 0
        for rep in reps:
            for m in self.models:
                try:
                    total += rep.queue_depth(m)
                except Exception:
                    pass
        return total

    def replica_distribution(self) -> Dict[str, int]:
        """{replica id: requests routed} — the loadgen report's routing
        distribution."""
        with self._lock:
            return {rid: rep.routed
                    for rid, rep in sorted(self._replicas.items())}

    def _series(self, snap, name: str, **match: str) -> float:
        total = 0.0
        for key, v in snap.get(name, {}).items():
            kv = dict(p.split("=", 1) for p in key.split(",") if "=" in p)
            if all(kv.get(k) == val for k, val in match.items()):
                total += float(v)
        return total

    def fleet_snapshot(self) -> Dict[str, Any]:
        """The ``fleet`` block of ``health()``/``summary()``/doctor:
        replica states + routing distribution + failover/ejection/scale
        accounting + the admission plan."""
        snap = self.metrics.snapshot()
        with self._lock:
            reps = dict(self._replicas)
            counts: Dict[str, int] = {}
            for rep in reps.values():
                counts[rep.state] = counts.get(rep.state, 0) + 1
            out = {
                "name": self.name,
                "replicas": {},
                "counts": counts,
                "submitted": self._submitted,
                "failovers": self._failovers,
                "ejections": self._ejections,
                "readmissions": self._readmissions,
                "kills": self._kills,
                "scaleEvents": list(self.scale_events),
                "deploys": len(self.deploy_history),
                "admission": dict(self._admission),
            }
        for rid, rep in sorted(reps.items()):
            depth = None
            if rep.state in (ACTIVE, DRAINING):
                # per-model tolerant: under placement a replica holds a
                # subset, so a non-resident model must not zero the sum
                models = (self.placer.residents(rid)
                          if self.placer is not None else self.models)
                depth = 0
                for m in models:
                    try:
                        depth += rep.queue_depth(m)
                    except Exception:
                        pass
            out["replicas"][rid] = {
                "state": rep.state, "kind": rep.kind,
                "routed": rep.routed, "queueDepth": depth,
                "p99Ms": {m: round(v, 3)
                          for m, v in rep.probe.p99_ms.items()},
                "probeFailures": rep.probe.failures,
            }
            if self.placer is not None:
                out["replicas"][rid]["resident"] = \
                    self.placer.residents(rid)
        out["sheds"] = {
            reason: self._series(snap, "tg_serve_shed_total",
                                 reason=reason)
            for reason in ("overload", "deadline", "admission",
                           "no_replica", "placement", "unknown_model")}
        if self.placer is not None:
            out["placement"] = self.placer.snapshot()
        return out

    def _set_replica_gauges(self) -> None:
        with self._lock:
            counts: Dict[str, int] = {s: 0 for s in (
                ACTIVE, DRAINING, EJECTED, DEAD, RETIRED)}
            for rep in self._replicas.values():
                counts[rep.state] = counts.get(rep.state, 0) + 1
        for state, n in counts.items():
            self.metrics.gauge("tg_fleet_replicas",
                               "replica count by state (docs/serving.md)",
                               state=state).set(float(n))
            _obs_metrics.set_gauge("tg_fleet_replicas", float(n),
                                   state=state)

    def _evaluate_slo(self, _sampler, now: float) -> None:
        for t in self.slo_trackers:
            try:
                t.evaluate(now)
            except Exception:  # pragma: no cover - defensive
                pass

    def slo_snapshot(self) -> Optional[Dict[str, Any]]:
        if not self.slo_trackers:
            return None
        return {t.key: t.snapshot() for t in self.slo_trackers}

    def summary(self) -> Dict[str, Any]:
        """Duck-types the runtime ``summary()`` for the load generator
        and humans, plus the ``fleet`` block."""
        snap = self.metrics.snapshot()
        latency = snap.get("tg_serve_request_seconds", {}).get(
            f"model={self.default_model}", {})
        degraded = 0.0
        with self._lock:
            reps = [r for r in self._replicas.values()
                    if r.state in (ACTIVE, DRAINING, EJECTED)]
            any_active = any(r.state == ACTIVE for r in reps)
        for rep in reps:
            reg = getattr(rep, "registry", None)
            if reg is None:
                continue
            for m in reg.names():
                try:
                    degraded += reg.runtime(m).summary()["degradedRows"]
                except Exception:
                    pass
        slo = self.slo_snapshot()
        return {
            "model": self.name,
            "state": "ready" if any_active else "stopped",
            "latency": latency,
            "rowsScored": self._series(snap, "tg_serve_rows_total"),
            "quarantinedRows": self._series(
                snap, "tg_serve_quarantined_total"),
            "degradedRows": degraded,
            "shed": {reason: self._series(snap, "tg_serve_shed_total",
                                          reason=reason)
                     for reason in ("overload", "deadline", "admission",
                                    "no_replica", "placement",
                                    "unknown_model")},
            "breaker": {},
            "queueDepth": self.queue_depth(),
            "faults": {"reports": len(self.fault_log.reports),
                       "dropped": self.fault_log.dropped},
            "fleet": self.fleet_snapshot(),
            "slo": slo,
            "scaleHint": _slo.scale_hint(self, slo),
        }

    def health(self) -> Dict[str, Any]:
        """The fleet readiness payload: per-replica health + the fleet
        block. ``ready`` = at least one active replica and admission not
        refusing everything."""
        with self._lock:
            reps = dict(self._replicas)
        replicas: Dict[str, Any] = {}
        hints: Dict[str, Dict[str, str]] = {}
        for rid, rep in sorted(reps.items()):
            if rep.state in (DEAD, RETIRED):
                replicas[rid] = {"state": rep.state, "ready": False}
                continue
            try:
                h = rep.health()
                replicas[rid] = {"state": rep.state,
                                 "ready": bool(h.get("ready")),
                                 "health": h}
                hints[rid] = dict(h.get("scaleHints") or {})
            except Exception as e:
                replicas[rid] = {"state": rep.state, "ready": False,
                                 "error": f"{type(e).__name__}: {e}"[:200]}
        any_active = any(
            r.state == ACTIVE for r in reps.values())
        return {
            "ready": any_active and not self._admission.get("refused"),
            "replicas": replicas,
            "scaleHints": hints,
            "fleet": self.fleet_snapshot(),
        }
