"""SLO engine: declarative per-model/per-tenant objectives, error
budgets, and multi-window multi-burn-rate alerts
(docs/observability.md "SLOs, budgets & burn rates").

The methodology is the Google SRE Workbook's: an :class:`SLOSpec`
declares targets (availability, latency, freshness), the error budget
is the allowed bad fraction over a 30-day-style window
(``TG_SLO_WINDOW_S`` scales it — tests run the whole machinery in
milliseconds on an injectable clock), and alerts fire on **burn rate**
— how many times faster than "exactly exhausting the budget at the
window's end" the service is currently burning — measured over *two*
windows per rule so a short spike cannot page (the long window filters
it) and a real incident pages fast (the short window catches it):

    ========  ==========================  =========  ===========
    severity  long window                 short       burn ≥
    ========  ==========================  =========  ===========
    page      1h   (1/720 of the window)  5m  (1/12)  14.4
    ticket    6h   (1/120 of the window)  30m (1/12)  6.0
    ========  ==========================  =========  ===========

An active alert clears only when both windows drop below
``HYSTERESIS × threshold`` — boundary traffic cannot flap it.

Objectives per :class:`SLOSpec`:

* **availability** — SLI ``1 − (sheds + quarantined) / submitted`` from
  the serve counters, windowed through the sampler
  (``observability/timeseries.py``); budget ``1 − availability_target``.
* **latency** — bad events are requests over ``latency_p99_ms``
  (estimated from windowed sketch subtraction:
  ``window_count − cdf_increase(target)``); budget: 1% of requests may
  exceed a p99 target (``1 − 0.99``), so the same burn-rate algebra
  applies unchanged.
* **freshness** — binary: the model's drift verdict
  (serving/drift.py) must not be ``degraded``; reported as a verdict
  (no burn — drift heals by refit, not by budget).

Emissions on every evaluation (sampler tick cadence): the
``tg_slo_burn_rate{model,slo}`` / ``tg_slo_budget_remaining{model,slo}``
/ ``tg_slo_alert{model,slo,severity}`` series (serve-local, mirrored to
the global registry when TG_METRICS), ``slo.alert`` flight-recorder
events on every alert transition, and — when an objective's budget is
fully exhausted — ONE ``slo_budget_exhausted`` post-mortem bundle per
exhaustion episode (observability/postmortem.py, bundle schema v3).

:func:`scale_hint` is the autoscaling artifact ROADMAP item 2 consumes:
``up`` / ``hold`` / ``down`` derived from five signal families — queue
depth, windowed shed rate, breaker state, burn rate/alerts, and the
drift verdict — with machine-readable reasons (a breaker-open model
holds: replicas of a failing device path don't help; a drift-degraded
model holds: the *data* is wrong, not the capacity).
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import blackbox as _blackbox
from . import metrics as _obs_metrics
from . import timeseries as _timeseries

#: budget window (seconds); the canonical 30 days, env-scalable so tests
#: and the CLI can run the full alert ladder in milliseconds/seconds
SLO_WINDOW_ENV = "TG_SLO_WINDOW_S"
DEFAULT_WINDOW_S = 30 * 86400.0
#: default availability target for models without a registered spec
SLO_AVAILABILITY_ENV = "TG_SLO_AVAILABILITY"
DEFAULT_AVAILABILITY = 0.999
#: default latency target (ms) for default specs; unset disables the
#: latency objective unless a spec declares one
SLO_P99_ENV = "TG_SLO_P99_MS"

#: multi-window multi-burn-rate rules: (severity, long-window fraction
#: of the SLO window, short-window fraction, burn-rate threshold) — the
#: SRE Workbook's 1h/5m page + 6h/30m ticket pair
ALERT_RULES: Tuple[Tuple[str, float, float, float], ...] = (
    ("page", 1.0 / 720.0, 1.0 / 8640.0, 14.4),
    ("ticket", 1.0 / 120.0, 1.0 / 1440.0, 6.0),
)
#: an active alert clears only below HYSTERESIS × threshold (no flap)
HYSTERESIS = 0.8

#: alert severities, most severe first
SEVERITIES = ("page", "ticket")


def slo_window_s() -> float:
    try:
        v = float(os.environ.get(SLO_WINDOW_ENV, "") or DEFAULT_WINDOW_S)
        return v if v > 0 else DEFAULT_WINDOW_S
    except ValueError:
        return DEFAULT_WINDOW_S


def _default_availability() -> float:
    try:
        v = float(os.environ.get(SLO_AVAILABILITY_ENV, "")
                  or DEFAULT_AVAILABILITY)
        return v if 0.0 < v < 1.0 else DEFAULT_AVAILABILITY
    except ValueError:
        return DEFAULT_AVAILABILITY


def _default_p99_ms() -> Optional[float]:
    raw = os.environ.get(SLO_P99_ENV)
    if not raw:
        return None
    try:
        v = float(raw)
        return v if v > 0 else None
    except ValueError:
        return None


@dataclass
class SLOSpec:
    """One model's (or one tenant-within-a-model's) objectives."""
    model: str
    #: availability target (fraction of submitted requests that must be
    #: neither shed nor quarantined)
    availability: float = field(default_factory=_default_availability)
    #: p99 latency target in ms; None disables the latency objective
    latency_p99_ms: Optional[float] = field(default_factory=_default_p99_ms)
    #: include the freshness (drift-verdict) objective
    freshness: bool = True
    #: budget window; None defers to TG_SLO_WINDOW_S at evaluation time
    window_s: Optional[float] = None
    #: per-tenant budget: SLIs read the tenant-labelled serve series
    tenant: Optional[str] = None

    @property
    def key(self) -> str:
        return self.model if self.tenant is None else (
            f"{self.model}/{self.tenant}")

    def to_json(self) -> Dict[str, Any]:
        return {"model": self.model, "tenant": self.tenant,
                "availability": self.availability,
                "latencyP99Ms": self.latency_p99_ms,
                "freshness": self.freshness, "windowS": self.window_s}


# -- spec registry (declarative; conftest asserts no leak) -------------------

_SPEC_LOCK = threading.Lock()
_SPECS: List[SLOSpec] = []


def register(spec: SLOSpec) -> SLOSpec:
    """Register a spec; runtimes started afterwards pick it up (one
    tracker per spec matching the model's name)."""
    with _SPEC_LOCK:
        _SPECS[:] = [s for s in _SPECS if s.key != spec.key]
        _SPECS.append(spec)
    return spec


def unregister(key: str) -> None:
    with _SPEC_LOCK:
        _SPECS[:] = [s for s in _SPECS if s.key != key]


def registered_specs() -> List[SLOSpec]:
    with _SPEC_LOCK:
        return list(_SPECS)


def specs_for(model: str) -> List[SLOSpec]:
    """The specs a runtime named ``model`` tracks: every registered spec
    for that model, else one default (env-driven) model-level spec."""
    with _SPEC_LOCK:
        mine = [s for s in _SPECS if s.model == model]
    return mine if mine else [SLOSpec(model=model)]


def reset() -> None:
    """Drop every registered spec (test isolation)."""
    with _SPEC_LOCK:
        _SPECS.clear()


# -- the tracker -------------------------------------------------------------

class SLOTracker:
    """Evaluates ONE spec against a model's windowed serve telemetry.

    ``runtime`` is duck-typed (needs ``breaker.state``, ``drift_monitor``,
    ``fault_log``) and optional — unit tests drive a tracker from a bare
    registry + sampler. Evaluation normally runs on the sampler's tick
    hook; ``evaluate`` is also safe to call on demand (``health()``,
    ``cli slo``)."""

    def __init__(self, spec: SLOSpec, sampler: _timeseries.MetricsSampler,
                 metrics: _obs_metrics.MetricsRegistry,
                 runtime: Any = None,
                 clock: Optional[Callable[[], float]] = None):
        self.spec = spec
        self.sampler = sampler
        self.metrics = metrics
        self.runtime = runtime
        self.clock = clock or sampler.clock
        self._lock = threading.Lock()
        #: (objective, severity) → alert currently active
        self._active: Dict[Tuple[str, str], bool] = {}
        #: cumulative alert activations by severity (asserted by the
        #: bench chaos line — a fired-then-cleared page still counts)
        self.fired: Dict[str, int] = {s: 0 for s in SEVERITIES}
        #: objectives currently inside a budget-exhaustion episode (one
        #: post-mortem per episode, re-armed when the budget recovers)
        self._exhausted: Dict[str, bool] = {}
        self._snapshot: Dict[str, Any] = {"enabled": True,
                                          "spec": spec.to_json(),
                                          "objectives": {},
                                          "fired": dict(self.fired)}

    @property
    def key(self) -> str:
        return self.spec.key

    # -- SLI plumbing --------------------------------------------------------
    def _serve_labels(self) -> Dict[str, str]:
        lbls = {"model": self.spec.model}
        if self.spec.tenant is not None:
            lbls["tenant"] = self.spec.tenant
        return lbls

    def _series(self, base: str) -> str:
        """Tenant specs read the tenant-labelled twin series the runtime
        counts next to the model-level ones (serving/runtime.py)."""
        if self.spec.tenant is None:
            return base
        return base.replace("tg_serve_", "tg_serve_tenant_", 1)

    def _availability_bad_fraction(self, window_s: float, now: float
                                   ) -> Tuple[float, float]:
        """→ (bad fraction, submitted) over the window."""
        lbls = self._serve_labels()
        shed = self.sampler.increase(
            self._series("tg_serve_shed_total"), window_s, now=now, **lbls)
        quar = self.sampler.increase(
            self._series("tg_serve_quarantined_total"), window_s, now=now,
            **lbls)
        rows = self.sampler.increase(
            self._series("tg_serve_rows_total"), window_s, now=now, **lbls)
        submitted = rows + shed
        if submitted <= 0:
            return 0.0, 0.0
        return min(1.0, (shed + quar) / submitted), submitted

    def _latency_bad_fraction(self, window_s: float, now: float
                              ) -> Tuple[float, float]:
        lbls = self._serve_labels()
        name = self._series("tg_serve_request_seconds")
        target_s = (self.spec.latency_p99_ms or 0.0) / 1000.0
        cnt = self.sampler.window_count(name, window_s, now=now, **lbls)
        if cnt <= 0:
            return 0.0, 0.0
        below = self.sampler.cdf_increase(name, target_s, window_s,
                                          now=now, **lbls)
        over = max(0.0, cnt - below)
        return min(1.0, over / cnt), cnt

    # -- evaluation ----------------------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One full evaluation pass: SLIs → burn rates → alert state
        machines → budget accounting → gauges/events/triggers. Returns
        (and caches) the snapshot dict."""
        now = self.clock() if now is None else now
        window = self.spec.window_s or slo_window_s()
        objectives: Dict[str, Any] = {}
        objectives["availability"] = self._burn_objective(
            "availability", 1.0 - self.spec.availability,
            self._availability_bad_fraction, window, now)
        if self.spec.latency_p99_ms:
            objectives["latency"] = self._burn_objective(
                "latency", 1.0 - 0.99, self._latency_bad_fraction,
                window, now)
        if self.spec.freshness:
            objectives["freshness"] = self._freshness_objective()
        snap = {"enabled": True, "spec": self.spec.to_json(),
                "evaluatedAt": now, "windowS": window,
                "objectives": objectives, "fired": dict(self.fired),
                "worst": _worst_verdict(objectives)}
        with self._lock:
            self._snapshot = snap
        return snap

    def _burn_objective(self, obj: str, allowed: float,
                        bad_fraction, window: float, now: float
                        ) -> Dict[str, Any]:
        allowed = max(allowed, 1e-12)
        burns: Dict[str, Dict[str, float]] = {}
        alerts: Dict[str, bool] = {}
        for sev, long_f, short_f, thr in ALERT_RULES:
            b_long = bad_fraction(long_f * window, now)[0] / allowed
            b_short = bad_fraction(short_f * window, now)[0] / allowed
            burns[sev] = {"long": b_long, "short": b_short,
                          "threshold": thr}
            alerts[sev] = self._alert_state(obj, sev, b_long, b_short, thr)
        bad_w, submitted_w = bad_fraction(window, now)
        allowed_bad = allowed * submitted_w
        spent = (bad_w * submitted_w) / allowed_bad if allowed_bad else 0.0
        remaining = 1.0 - spent
        exhausted = bool(submitted_w and remaining <= 0.0)
        self._budget_episode(obj, exhausted, remaining, burns)
        verdict = ("exhausted" if exhausted
                   else "breach" if any(alerts.values()) else "ok")
        self._emit_gauges(obj, burns, remaining, alerts)
        return {"sli": 1.0 - bad_w, "badFraction": bad_w,
                "submitted": submitted_w, "allowedBadFraction": allowed,
                "burn": burns, "budgetRemaining": remaining,
                "alerts": alerts, "verdict": verdict}

    def _freshness_objective(self) -> Dict[str, Any]:
        verdict = "ok"
        drift = None
        mon = getattr(self.runtime, "drift_monitor", None)
        if mon is not None:
            try:
                drift = mon.verdict()
            except Exception:
                drift = None
            if drift == "degraded":
                verdict = "breach"
        self._gauge("tg_slo_burn_rate", 1.0 if verdict == "breach" else 0.0,
                    slo="freshness")
        return {"drift": drift, "verdict": verdict}

    # -- alert + budget state machines ---------------------------------------
    def _alert_state(self, obj: str, sev: str, b_long: float,
                     b_short: float, thr: float) -> bool:
        key = (obj, sev)
        with self._lock:
            active = self._active.get(key, False)
        if not active:
            fire = b_long >= thr and b_short >= thr
            if fire:
                with self._lock:
                    self._active[key] = True
                    self.fired[sev] = self.fired.get(sev, 0) + 1
                _blackbox.record("slo.alert", model=self.spec.model,
                                 tenant=self.spec.tenant, slo=obj,
                                 severity=sev, state="firing",
                                 burnLong=round(b_long, 3),
                                 burnShort=round(b_short, 3),
                                 threshold=thr)
            return fire
        # hysteresis: stay active until BOTH windows cool below 0.8×thr
        clear = b_long < thr * HYSTERESIS and b_short < thr * HYSTERESIS
        if clear:
            with self._lock:
                self._active[key] = False
            _blackbox.record("slo.alert", model=self.spec.model,
                             tenant=self.spec.tenant, slo=obj,
                             severity=sev, state="resolved",
                             burnLong=round(b_long, 3),
                             burnShort=round(b_short, 3))
            return False
        return True

    def _budget_episode(self, obj: str, exhausted: bool, remaining: float,
                        burns: Dict[str, Dict[str, float]]) -> None:
        with self._lock:
            was = self._exhausted.get(obj, False)
            self._exhausted[obj] = exhausted
        if exhausted and not was:
            # one post-mortem per exhaustion episode: the budget is gone —
            # every further bad event is un-budgeted SLO damage
            from . import postmortem as _postmortem
            _postmortem.trigger(
                "slo_budget_exhausted",
                fault_log=getattr(self.runtime, "fault_log", None),
                metrics=self.metrics,
                detail={"model": self.spec.model,
                        "tenant": self.spec.tenant, "objective": obj,
                        "budgetRemaining": round(remaining, 6),
                        "burn": {s: round(b["long"], 3)
                                 for s, b in burns.items()}},
                state={"slo": self.snapshot()})

    # -- emission ------------------------------------------------------------
    def _gauge(self, name: str, v: float, **labels: str) -> None:
        lbls = {"model": self.spec.model, **labels}
        if self.spec.tenant is not None:
            lbls["tenant"] = self.spec.tenant
        self.metrics.gauge(name, "", **lbls).set(v)
        _obs_metrics.set_gauge(name, v, "", **lbls)

    def _emit_gauges(self, obj: str, burns: Dict[str, Dict[str, float]],
                     remaining: float, alerts: Dict[str, bool]) -> None:
        self._gauge("tg_slo_burn_rate", burns["page"]["long"], slo=obj)
        self._gauge("tg_slo_budget_remaining", remaining, slo=obj)
        for sev, active in alerts.items():
            self._gauge("tg_slo_alert", 1.0 if active else 0.0,
                        slo=obj, severity=sev)

    # -- introspection -------------------------------------------------------
    def active_alerts(self) -> List[Dict[str, str]]:
        with self._lock:
            return [{"objective": obj, "severity": sev}
                    for (obj, sev), on in sorted(self._active.items()) if on]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            snap = dict(self._snapshot)
        snap["fired"] = dict(self.fired)
        snap["activeAlerts"] = self.active_alerts()
        return snap


def _worst_verdict(objectives: Dict[str, Any]) -> str:
    order = {"ok": 0, "breach": 1, "exhausted": 2}
    worst = "ok"
    for o in objectives.values():
        v = o.get("verdict", "ok")
        if order.get(v, 0) > order.get(worst, 0):
            worst = v
    return worst


# -- autoscaling signal ------------------------------------------------------

#: queue occupancy past this fraction of max_queue reads as overload
QUEUE_UP_FRACTION = 0.5
#: the shed-rate / request-rate lookback (seconds, scaled off the page
#: long window so TG_SLO_WINDOW_S shrinks it for tests)
def _hint_window_s() -> float:
    return max(ALERT_RULES[0][1] * slo_window_s(), 1e-6)


def scale_hint(runtime: Any,
               slo_snapshot: Optional[Dict[str, Any]] = None
               ) -> Dict[str, Any]:
    """``{"hint": "up"|"hold"|"down", "reasons": [...]}`` — the
    machine-readable autoscaling artifact (ROADMAP item 2), derived from
    five signal families: breaker state, queue depth, windowed shed
    rate, SLO burn/alerts, and the drift verdict.

    Ladder (first match wins):

    1. breaker open/half-open → **hold** — more replicas of a failing
       device path fail identically; heal first.
    2. overload — queue past ``QUEUE_UP_FRACTION`` of ``max_queue``, a
       nonzero windowed shed rate, or an active page alert → **up**.
    3. drift verdict degraded → **hold** — the data is wrong, not the
       capacity; a refit is (or should be) healing it.
    4. idle — empty queue and ~zero windowed request rate with no
       active alerts → **down**.
    5. otherwise → **hold** (steady state).
    """
    reasons: List[str] = []
    breaker = getattr(getattr(runtime, "breaker", None), "state", "closed")
    if breaker != "closed":
        return {"hint": "hold",
                "reasons": [f"breaker-{breaker}: device path unhealthy — "
                            "scaling adds replicas of a failing path"]}
    depth = float(runtime.queue_depth())
    max_queue = float(getattr(runtime.config, "max_queue", 0) or 1)
    queue_frac = depth / max_queue
    w = _hint_window_s()
    sampler = getattr(runtime, "sampler", None)
    shed_rate = req_rate = 0.0
    if sampler is not None:
        shed_rate = sampler.rate("tg_serve_shed_total", w,
                                 model=runtime.name)
        req_rate = (sampler.rate("tg_serve_rows_total", w,
                                 model=runtime.name) + shed_rate)
    page_active = False
    if slo_snapshot:
        for snap in slo_snapshot.values():
            for a in snap.get("activeAlerts", []):
                if a.get("severity") == "page":
                    page_active = True
    if queue_frac >= QUEUE_UP_FRACTION:
        reasons.append(f"queue-depth {depth:.0f}/{max_queue:.0f}")
    if shed_rate > 0:
        reasons.append(f"shed-rate {shed_rate:.2f}/s over {w:.3g}s")
    if page_active:
        reasons.append("page-severity burn-rate alert active")
    if reasons:
        return {"hint": "up", "reasons": reasons}
    drift = None
    mon = getattr(runtime, "drift_monitor", None)
    if mon is not None:
        try:
            drift = mon.verdict()
        except Exception:
            drift = None
    if drift == "degraded":
        return {"hint": "hold",
                "reasons": ["drift-degraded: data drifted, not capacity — "
                            "refit heals this, replicas do not"]}
    if depth == 0 and req_rate <= 0.0:
        return {"hint": "down", "reasons": ["idle: empty queue, ~zero "
                                            f"request rate over {w:.3g}s"]}
    return {"hint": "hold", "reasons": ["steady: within SLO at current "
                                        "capacity"]}


def summarize() -> Dict[str, Any]:
    """The ``summary()["observability"]["slo"]`` section: registered
    specs, attached sampler accounting, and — when the serving runtime
    module is loaded — per-model tracker snapshots + scale hints."""
    import sys
    out: Dict[str, Any] = {
        "enabled": _timeseries.sampler_enabled(),
        "specs": [s.to_json() for s in registered_specs()],
        "samplers": [s.snapshot() for s in _timeseries.attached()],
    }
    rt_mod = sys.modules.get(f"{__name__.split('.')[0]}.serving.runtime")
    if rt_mod is not None:
        models: Dict[str, Any] = {}
        for rt in rt_mod.live_runtimes():
            try:
                models[rt.name] = {"slo": rt.slo_snapshot(),
                                   "scaleHint": scale_hint(
                                       rt, rt.slo_snapshot())}
            except Exception:  # pragma: no cover - defensive
                pass
        out["models"] = models
    return out
