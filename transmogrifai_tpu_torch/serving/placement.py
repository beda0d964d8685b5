"""Multi-model fleet density: cost-driven placement, LRU cold-model
paging, and warm-copy failover bookkeeping.

The paper's AutoML setting produces one pipeline per customer, so a
production fleet holds *thousands of models*, not one hot one. The
:class:`Placer` is the fleet-level generalization of the per-request
admission control (docs/serving.md "Admission control"): it bin-packs
models onto replicas against a per-replica budget using predicted
resident bytes from each saved model's MANIFEST ``costs`` table
(observability/devicemem.py), keeps a deterministic LRU over warm
copies, and pages cold models in on demand — a manifest-verified load
and warm pass of the saved model — under a single-flight guard so N
concurrent requests for a cold model trigger one page-in, not N.

The PyTorch port's copy of the JAX package's ``serving/placement.py``:
the same names, chaos sites, FaultLog kinds, series and snapshot. The
byte axis reads the ``costs`` rows of a saved model's MANIFEST. The JAX
package writes them (measured by XLA, not on the card); the port writes
its own: a planned segment's dispatches record one row per (segment,
bucket) (the graph pool's growth at a capture on the card, the predicted
bytes on the CPU; ``plan.py``), and ``save_model`` after a warm pass, or
a registry load's ``persist_costs``, puts them in the manifest. A model
saved with none (no planned dispatch in its process) is blind-admitted
(``placement_blind_admit``), as the JAX package admits a model without
costs.

Capacity is two-dimensional and both axes are optional:

* ``max_warm`` — per-replica warm-model **count** cap (deterministic,
  works for in-memory models with no manifest);
* ``device_budget`` — per-replica predicted-**bytes** cap
  (``TG_PLACE_BUDGET``, falling back to ``TG_DEVICE_BUDGET``). A model
  whose predicted bytes exceed the budget even alone on an empty
  replica fits *nowhere* and every submit for it raises the typed
  :class:`PlacementRefusedError` (an :class:`~.runtime.OverloadError`,
  so it buckets as a shed — never a lost future).

A model whose MANIFEST ``costs`` section is absent or corrupt is
**blind-admitted**: placement degrades to counting it as zero bytes and
records a typed ``placement_blind_admit`` FaultLog warning (plus
``tg_place_blind_admits_total``) instead of refusing or crashing —
admission is a consumer of telemetry, not a guess.

Chaos sites (deterministic, counter-driven — robustness/faults.py):

* ``place.assign`` — per model, as the bin-pack assigns it to a
  replica; a raise leaves the model cold (typed ``place_assign_failed``)
  and it pages in on first demand — zero request impact.
* ``place.evict`` — before an LRU victim's runtime unloads; a raise
  skips the eviction (capacity prediction is advisory) with a typed
  ``place_evict_failed`` and the page-in proceeds anyway.
* ``place.pagein`` — in the single-flight leader, before the cold
  model's runtime loads; a raise fails the page-in typed
  (``place_pagein_failed``) and the front door retries within its
  bounded failover budget — typed shed when exhausted, never lost.

Eviction protection: a ``protect`` hook (the front door wires it to
per-model SLO page-alert state) exempts models with active SLO burn
from victim selection, so one noisy neighbor cannot page out a model
that is already missing its objectives.

Gated series (zero-write when TG_METRICS is off): ``tg_place_resident``
(gauge, per replica), ``tg_place_pageins_total``,
``tg_place_evictions_total``, ``tg_place_blind_admits_total``,
``tg_place_refused_total``, ``tg_place_pagein_seconds`` (histogram).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ..observability import blackbox as _blackbox
from ..observability import metrics as _obs_metrics
from ..robustness import faults
from ..robustness.policy import FaultLog, FaultReport
from .runtime import OverloadError, ServingError

_ENV_PREFIX = "TG_PLACE_"

#: live placers, for the leak oracle (robustness/oracles.py) and the
#: post-mortem ``placement`` section (observability/postmortem.py)
_LIVE: List["Placer"] = []
_LIVE_LOCK = threading.Lock()


def live_placers() -> List["Placer"]:
    with _LIVE_LOCK:
        return list(_LIVE)


class PlacementRefusedError(OverloadError):
    """Per-model admission refused: the model's predicted resident bytes
    exceed the per-replica budget even alone on an empty replica, so no
    amount of eviction can page it in. An :class:`OverloadError` so the
    front door sheds it typed (``placement`` reason) — the caller sees a
    clean refusal, never a lost future. The fix is capacity (raise
    ``TG_PLACE_BUDGET`` / add device memory), not a retry."""


class UnknownModelError(ServingError):
    """The request names a model this fleet does not serve. Typed so the
    network edge maps it to a 404 shed (serving/netedge.py) — a wrong
    model id is a *client* error and must never look like capacity."""


def model_cost_bytes(src: Any) -> Optional[int]:
    """Predicted resident device bytes for a model source, from its
    MANIFEST ``costs`` table: the sum over segment fingerprints of each
    segment's largest-bucket measured bytes. ``None`` (→ blind admit)
    for in-memory models, absent manifests, or corrupt cost sections —
    a garbled cost table must never block placement."""
    if not isinstance(src, str):
        return None
    try:
        from ..manifest import CheckpointManifest
        from ..persistence import FORMAT_VERSION
        manifest, err = CheckpointManifest.load(src, FORMAT_VERSION)
        if err is not None:
            return None
        table = manifest.costs.get("table")
        if not isinstance(table, dict) or not table:
            return None
        by_fp: Dict[str, int] = {}
        for row in table.values():
            if not isinstance(row, dict):
                continue
            fp = str(row.get("fingerprint", ""))
            b = int(row.get("bytes", 0))
            if fp and b > 0:
                by_fp[fp] = max(by_fp.get(fp, 0), b)
        if not by_fp:
            return None
        return sum(by_fp.values())
    except Exception:
        return None


class PlaceConfig:
    """Placement knobs (``TG_PLACE_*`` env — docs/serving.md
    "Multi-model placement & paging").

    ``max_warm``: per-replica warm-model count cap (0 = unlimited).
    ``device_budget``: per-replica predicted-bytes cap (0 = off;
    ``TG_PLACE_BUDGET`` falls back to ``TG_DEVICE_BUDGET`` so one knob
    governs both per-request and per-model admission).
    ``pagein_timeout_s``: how long a waiter blocks on another thread's
    in-flight page-in before giving up typed.
    ``protect_slo``: exempt models with active SLO page alerts from
    LRU victim selection."""

    def __init__(self, max_warm: int = 0, device_budget: int = 0,
                 pagein_timeout_s: float = 30.0,
                 protect_slo: bool = True):
        self.max_warm = int(max_warm)
        self.device_budget = int(device_budget)
        self.pagein_timeout_s = float(pagein_timeout_s)
        self.protect_slo = bool(protect_slo)

    @classmethod
    def from_env(cls) -> "PlaceConfig":
        import os

        def _i(name: str, default: int) -> int:
            try:
                return int(os.environ.get(name, default))
            except (TypeError, ValueError):
                return default

        budget = _i(_ENV_PREFIX + "BUDGET", 0) or _i("TG_DEVICE_BUDGET", 0)
        try:
            timeout = float(os.environ.get(
                _ENV_PREFIX + "PAGEIN_TIMEOUT_S", 30.0))
        except (TypeError, ValueError):
            timeout = 30.0
        return cls(max_warm=_i(_ENV_PREFIX + "MAX_WARM", 0),
                   device_budget=budget,
                   pagein_timeout_s=timeout,
                   protect_slo=os.environ.get(
                       _ENV_PREFIX + "PROTECT_SLO", "1") != "0")


class Placer:
    """Fleet-level model→replica placement: bin-packing, deterministic
    LRU paging, single-flight page-in, and warm-copy bookkeeping.

    The placer owns *policy and accounting* only — the front door owns
    the replicas and passes ``load``/``unload`` callables into
    :meth:`page_in`, so the placer is directly testable with fakes.

    LRU is a logical sequence counter (no clocks): every routed request
    bumps its model's ``last_used`` sequence; the victim on a replica is
    the resident model with the smallest ``(last_used, name)`` — the
    name tie-break makes eviction order deterministic for models that
    have never been touched."""

    def __init__(self, models: Dict[str, Any],
                 config: Optional[PlaceConfig] = None,
                 name: str = "fleet",
                 fault_log: Optional[FaultLog] = None,
                 metrics: Optional[_obs_metrics.MetricsRegistry] = None,
                 protect: Optional[Callable[[str], bool]] = None):
        self.models = dict(models)
        self.config = config or PlaceConfig()
        self.name = name
        self.fault_log = fault_log if fault_log is not None else FaultLog()
        self.metrics = metrics if metrics is not None \
            else _obs_metrics.MetricsRegistry()
        #: hook: model → True when eviction must be refused (the front
        #: door wires active SLO page-alert state in here)
        self.protect = protect
        self._lock = threading.Lock()
        #: rid → set of models resident (warm) on that replica
        self._resident: Dict[str, Set[str]] = {}
        #: model → logical last-used sequence (insertion order seeds it
        #: so never-touched models evict deterministically, oldest name
        #: first among ties via the (seq, name) sort key)
        self._last_used: Dict[str, int] = {}
        self._seq = 0
        #: (rid, model) → Event: in-flight single-flight page-ins
        self._inflight: Dict[Tuple[str, str], threading.Event] = {}
        self._pagein_ms: List[float] = []
        self._evictions = 0
        self._pageins = 0
        self._closed = False
        #: predicted resident bytes per model (None = blind admit)
        self.bytes: Dict[str, Optional[int]] = {}
        #: models refused outright: predicted bytes exceed the budget
        #: even alone on an empty replica
        self.refused: Set[str] = set()
        self.blind: Set[str] = set()
        budget = self.config.device_budget
        for m in sorted(self.models):
            self._last_used[m] = self._next_seq()
            b = model_cost_bytes(self.models[m])
            self.bytes[m] = b
            if budget and b is None:
                # degraded, not refused: admit blind with a typed warning
                self.blind.add(m)
                self.fault_log.add(FaultReport(
                    site="place.assign", kind="placement_blind_admit",
                    detail={"fleet": self.name, "model": m,
                            "reason": "no usable MANIFEST costs table"}))
                self._count("tg_place_blind_admits_total", model=m)
            elif budget and b is not None and b > budget:
                self.refused.add(m)
                self.fault_log.add(FaultReport(
                    site="place.assign", kind="placement_refused",
                    detail={"fleet": self.name, "model": m,
                            "predictedBytes": b, "budgetBytes": budget}))
                self._count("tg_place_refused_total", model=m)
        with _LIVE_LOCK:
            _LIVE.append(self)

    # -- helpers -------------------------------------------------------------
    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _count(self, name: str, n: float = 1.0, **labels: str) -> None:
        labels.setdefault("fleet", self.name)
        self.metrics.counter(
            name, "multi-model placement accounting "
            "(docs/serving.md 'Multi-model placement & paging')",
            **labels).inc(n)
        _obs_metrics.inc_counter(name, n, **labels)

    def check_admitted(self, model: str) -> None:
        """Raise the typed refusal for a model that fits nowhere."""
        if model in self.refused:
            raise PlacementRefusedError(
                f"placement refused for model '{model}': predicted "
                f"resident bytes {self.bytes[model]} exceed the "
                f"per-replica budget {self.config.device_budget} even on "
                f"an empty replica — raise TG_PLACE_BUDGET or shrink the "
                f"model")

    def _fits(self, resident: Set[str], model: str) -> bool:
        cfg = self.config
        if cfg.max_warm and len(resident) >= cfg.max_warm:
            return False
        if cfg.device_budget:
            used = sum(self.bytes.get(m) or 0 for m in resident)
            need = self.bytes.get(model) or 0
            if used + need > cfg.device_budget:
                return False
        return True

    # -- bin-packing ---------------------------------------------------------
    def plan(self, rids: List[str]) -> Dict[str, List[str]]:
        """First-fit-decreasing bin-pack of every admitted model onto
        ``rids``: models sorted by predicted bytes (descending, name
        tie-break), each placed on the least-loaded replica it fits on.
        Models that fit nowhere *because warm capacity is exhausted*
        stay cold and page in on demand; only a model too big for an
        empty replica lands in :attr:`refused`. Chaos: ``place.assign``
        fires per assignment — a raise leaves that model cold, typed
        ``place_assign_failed``."""
        with self._lock:
            for rid in rids:
                self._resident.setdefault(rid, set())
        order = sorted(
            (m for m in self.models
             if m not in self.refused),
            key=lambda m: (-(self.bytes.get(m) or 0), m))
        for m in order:
            with self._lock:
                # least-loaded replica (resident count, then rid) the
                # model fits on
                cands = sorted(
                    ((len(self._resident[r]), r) for r in rids
                     if self._fits(self._resident[r], m)),
                )
            if not cands:
                continue  # cold: pages in on demand
            rid = cands[0][1]
            try:
                faults.inject("place.assign", key=m)
            except Exception as e:
                self.fault_log.add(FaultReport(
                    site="place.assign", kind="place_assign_failed",
                    detail={"fleet": self.name, "model": m,
                            "replica": rid,
                            "error": f"{type(e).__name__}: {e}"[:200]}))
                continue  # left cold — demand paging recovers
            with self._lock:
                self._resident[rid].add(m)
            _blackbox.record("place.assign", fleet=self.name,
                             model=m, replica=rid)
        self._set_gauges()
        with self._lock:
            return {r: sorted(self._resident.get(r, ()))
                    for r in rids}

    def assign_new(self, rid: str) -> List[str]:
        """Assign cold models to a freshly spawned replica (autoscale /
        respawn path) up to its capacity — same ``place.assign``
        semantics as :meth:`plan`."""
        with self._lock:
            self._resident.setdefault(rid, set())
            warm = set().union(*self._resident.values()) \
                if self._resident else set()
        cold = sorted(m for m in self.models
                      if m not in warm and m not in self.refused)
        out: List[str] = []
        for m in cold:
            with self._lock:
                if not self._fits(self._resident[rid], m):
                    continue
            try:
                faults.inject("place.assign", key=m)
            except Exception as e:
                self.fault_log.add(FaultReport(
                    site="place.assign", kind="place_assign_failed",
                    detail={"fleet": self.name, "model": m,
                            "replica": rid,
                            "error": f"{type(e).__name__}: {e}"[:200]}))
                continue
            with self._lock:
                self._resident[rid].add(m)
            out.append(m)
            _blackbox.record("place.assign", fleet=self.name,
                             model=m, replica=rid)
        self._set_gauges()
        return out

    # -- residency / LRU -----------------------------------------------------
    def residents(self, rid: str) -> List[str]:
        with self._lock:
            return sorted(self._resident.get(rid, ()))

    def holders(self, model: str) -> List[str]:
        with self._lock:
            return sorted(r for r, ms in self._resident.items()
                          if model in ms)

    def is_resident(self, rid: str, model: str) -> bool:
        with self._lock:
            return model in self._resident.get(rid, ())

    def note_resident(self, rid: str, model: str) -> None:
        """Record a warm copy placed outside the planner (e.g. the
        front door seeding a fresh replica with the default model)."""
        with self._lock:
            self._resident.setdefault(rid, set()).add(model)
        self._set_gauges()

    def touch(self, model: str) -> None:
        """Bump the model's logical LRU sequence (one per routed
        request)."""
        with self._lock:
            if model in self._last_used:
                self._last_used[model] = self._next_seq()

    def paging(self, rid: str, model: Optional[str] = None) -> bool:
        """True when ``rid`` has an in-flight page-in (for ``model``,
        or any model when None) — the router steers traffic around a
        replica that is busy paging a model in."""
        with self._lock:
            if model is not None:
                return (rid, model) in self._inflight
            return any(r == rid for r, _ in self._inflight)

    def _protected(self, model: str) -> bool:
        if not self.config.protect_slo or self.protect is None:
            return False
        try:
            return bool(self.protect(model))
        except Exception:  # pragma: no cover - defensive
            return False

    def victim(self, rid: str,
               exclude: Optional[Set[str]] = None) -> Optional[str]:
        """Deterministic LRU victim on ``rid``: smallest ``(last_used,
        name)`` among residents, skipping ``exclude``, models mid-page-in
        (their runtime is still materializing — evicting would orphan
        the load), and SLO-protected models."""
        with self._lock:
            cands = [m for m in self._resident.get(rid, ())
                     if m not in (exclude or ())
                     and (rid, m) not in self._inflight]
        cands = [m for m in cands if not self._protected(m)]
        if not cands:
            return None
        with self._lock:
            return min(cands, key=lambda m: (self._last_used.get(m, 0), m))

    # -- eviction ------------------------------------------------------------
    def evict(self, rid: str, model: str,
              unload: Callable[[str], None]) -> None:
        """Evict ``model``'s runtime from ``rid`` (store entry kept — a
        later page-in loads it again from the saved directory). Refused typed
        when the model is itself mid-page-in on that replica. Chaos:
        ``place.evict`` — a raise skips the eviction (capacity is
        advisory), typed ``place_evict_failed``."""
        with self._lock:
            if (rid, model) in self._inflight:
                raise PlacementRefusedError(
                    f"eviction refused: model '{model}' is mid-page-in "
                    f"on replica {rid}")
        faults.inject("place.evict", key=model)
        unload(model)
        with self._lock:
            self._resident.get(rid, set()).discard(model)
            self._evictions += 1
        self._count("tg_place_evictions_total", model=model)
        self.fault_log.add(FaultReport(
            site="place.evict", kind="placement_evicted",
            detail={"fleet": self.name, "model": model, "replica": rid}))
        _blackbox.record("place.evict", fleet=self.name, model=model,
                         replica=rid)
        self._set_gauges()

    def _make_room(self, rid: str, model: str,
                   unload: Callable[[str], None]) -> None:
        """Evict LRU victims until ``model`` fits on ``rid``. A faulted
        or refused eviction is typed and *skipped* — the predicted
        budget is advisory, so the page-in proceeds over-budget rather
        than failing the request."""
        tried: Set[str] = {model}
        for _ in range(len(self.models) + 1):
            with self._lock:
                resident = set(self._resident.get(rid, ()))
            if self._fits(resident, model):
                return
            v = self.victim(rid, exclude=tried)
            if v is None:
                return  # everything protected/inflight: proceed blind
            tried.add(v)
            try:
                self.evict(rid, v, unload)
            except Exception as e:
                self.fault_log.add(FaultReport(
                    site="place.evict", kind="place_evict_failed",
                    detail={"fleet": self.name, "model": v,
                            "replica": rid,
                            "error": f"{type(e).__name__}: {e}"[:200]}))

    # -- demand paging -------------------------------------------------------
    def page_in(self, rid: str, model: str,
                load: Callable[[str], None],
                unload: Callable[[str], None]) -> bool:
        """Make ``model`` warm on ``rid``; returns True when it is.
        Single-flight: the first caller for a cold ``(rid, model)``
        becomes the leader and loads inline; concurrent callers block on
        the leader's Event (bounded by ``pagein_timeout_s``) — N
        concurrent requests for a cold model trigger ONE load.
        Chaos: ``place.pagein`` fires in the leader before the load — a
        raise fails every waiter typed (``place_pagein_failed``) and the
        front door retries within its failover budget."""
        self.check_admitted(model)
        with self._lock:
            if model in self._resident.get(rid, ()):
                return True
            ev = self._inflight.get((rid, model))
            if ev is None:
                ev = threading.Event()
                self._inflight[(rid, model)] = ev
                leader = True
            else:
                leader = False
        if not leader:
            ev.wait(self.config.pagein_timeout_s)
            return self.is_resident(rid, model)
        t0 = time.monotonic()
        try:
            self._make_room(rid, model, unload)
            faults.inject("place.pagein", key=model)
            load(model)
            # residency must be recorded BEFORE the finally releases
            # waiters — a waiter wakes on the Event and immediately
            # checks is_resident
            ms = (time.monotonic() - t0) * 1000.0
            with self._lock:
                self._resident.setdefault(rid, set()).add(model)
                self._pagein_ms.append(ms)
                self._pageins += 1
                self._last_used[model] = self._next_seq()
        except Exception as e:
            self.fault_log.add(FaultReport(
                site="place.pagein", kind="place_pagein_failed",
                detail={"fleet": self.name, "model": model,
                        "replica": rid,
                        "error": f"{type(e).__name__}: {e}"[:200]}))
            return False
        finally:
            with self._lock:
                self._inflight.pop((rid, model), None)
            ev.set()
        self._count("tg_place_pageins_total", model=model)
        self.metrics.histogram(
            "tg_place_pagein_seconds",
            "cold-model demand page-in latency (manifest-verified load "
            "plus warm pass)", fleet=self.name,
            model=model).observe(ms / 1000.0)
        _obs_metrics.observe("tg_place_pagein_seconds", ms / 1000.0,
                             fleet=self.name, model=model)
        self.fault_log.add(FaultReport(
            site="place.pagein", kind="placement_paged_in",
            detail={"fleet": self.name, "model": model, "replica": rid,
                    "ms": round(ms, 3)}))
        _blackbox.record("place.pagein", fleet=self.name, model=model,
                         replica=rid, ms=round(ms, 3))
        self._set_gauges()
        return True

    # -- replica lifecycle ---------------------------------------------------
    def drop_replica(self, rid: str) -> List[str]:
        """A replica died/retired: forget its residents and any page-in
        in flight there (waiters are released — they re-route). Returns
        the models whose ONLY warm copy was on it (now cold fleet-wide;
        they page in on a survivor on next demand)."""
        with self._lock:
            gone = self._resident.pop(rid, set())
            for key in [k for k in self._inflight if k[0] == rid]:
                self._inflight.pop(key).set()
            still_warm = set().union(*self._resident.values()) \
                if self._resident else set()
        orphaned = sorted(gone - still_warm)
        if orphaned:
            _blackbox.record("place.orphaned", fleet=self.name,
                             replica=rid, models=orphaned)
        self._set_gauges()
        return orphaned

    # -- introspection -------------------------------------------------------
    def pagein_p99_ms(self) -> Optional[float]:
        with self._lock:
            if not self._pagein_ms:
                return None
            xs = sorted(self._pagein_ms)
        return xs[min(len(xs) - 1, int(0.99 * len(xs)))]

    def inflight(self) -> List[Tuple[str, str]]:
        with self._lock:
            return sorted(self._inflight)

    def _set_gauges(self) -> None:
        with self._lock:
            counts = {r: len(ms) for r, ms in self._resident.items()}
        for rid, n in counts.items():
            self.metrics.gauge(
                "tg_place_resident",
                "warm models resident per replica", fleet=self.name,
                replica=rid).set(float(n))
            _obs_metrics.set_gauge("tg_place_resident", float(n),
                                   fleet=self.name, replica=rid)

    def snapshot(self) -> Dict[str, Any]:
        """Post-mortem / doctor payload: per-replica resident sets,
        cold set, refusals, blind admits, eviction/page-in counters and
        page-in p99 (the bundle's ``placement`` section, schema v5)."""
        with self._lock:
            resident = {r: sorted(ms)
                        for r, ms in sorted(self._resident.items())}
            warm = set().union(*self._resident.values()) \
                if self._resident else set()
            inflight = sorted(f"{r}:{m}" for r, m in self._inflight)
            evictions, pageins = self._evictions, self._pageins
        return {
            "fleet": self.name,
            "models": sorted(self.models),
            "resident": resident,
            "cold": sorted(m for m in self.models
                           if m not in warm and m not in self.refused),
            "refused": sorted(self.refused),
            "blindAdmits": sorted(self.blind),
            "inflightPageIns": inflight,
            "evictions": evictions,
            "pageIns": pageins,
            "pageInP99Ms": self.pagein_p99_ms(),
            "predictedBytes": {m: self.bytes.get(m)
                               for m in sorted(self.models)},
            "config": {"maxWarm": self.config.max_warm,
                       "deviceBudget": self.config.device_budget or None},
        }

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for ev in self._inflight.values():
                ev.set()
            self._inflight.clear()
        with _LIVE_LOCK:
            try:
                _LIVE.remove(self)
            except ValueError:
                pass

    def __enter__(self) -> "Placer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
