"""Multi-model registry: named runtimes, warm starts, health/SLO,
drift-aware self-healing.

The PyTorch port's copy of the JAX package's ``serving/registry.py``, with
its names and health shapes. Models load onto the card unless the caller
names a ``device`` (``device.resolve_device``); a hot swap of a saved
directory loads onto the device of the model it replaces.

The serving analog of the reference's one-model-per-MLeap-bundle local
scorer, grown to the multi-model process ROADMAP item 1 asks for: each
registered model gets its own :class:`~.runtime.ServingRuntime` (own
bounded queue, batcher thread, circuit breaker, serve-local metrics), so
one failing model degrades *itself* while its neighbors keep their SLOs.

``load()`` goes through ``persistence.load_model`` (manifest-verified)
and, by default, warm-starts the serve path from the ``serving`` section
``save_model`` recorded in ``MANIFEST.json`` (serving/warmup.py) — a
fresh process serves its first request without building a kernel. When the
manifest also carries a ``drift`` baseline (and ``TG_DRIFT`` is not
``0``), a :class:`~.drift.DriftMonitor` is attached so the model's
scoring distribution is compared online against its training
distribution (docs/serving.md "Drift monitoring & self-healing").

Self-healing: a configured ``refit_hook`` — ``(name, runtime, drift
report) -> saved-model path or OpWorkflowModel`` — fires in a background
thread the first time a model's drift verdict degrades. The refreshed
model then hot-swaps through :meth:`ModelRegistry.swap`: built + warmed
*before* the entry flips, old runtime drained *after*, so requests keep
flowing (on the old model) throughout and not one is shed by the swap. A
failed refit is typed ``drift_refit_failed`` in the runtime's FaultLog
and the old model keeps serving — the breaker is untouched (the device
path is healthy; the *data* is what drifted).

``health()`` is the readiness endpoint payload: per-model state
(ready / degraded / stopped), breaker snapshot, queue depth, p50/p95/p99
latency, shed + degraded + quarantine counts, the warm report, and the
drift verdict.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from ..observability import blackbox as _blackbox
from ..observability.trace import add_event as _obs_event
from ..robustness import faults
from ..robustness import watchdog as _watchdog
from ..robustness.policy import FaultReport
from . import drift as _drift
from . import warmup as _warmup
from .breaker import CircuitBreaker
from .runtime import RuntimeStoppedError, ServeConfig, ServingRuntime

#: refit hook signature: (model name, live runtime, drift report) → a
#: saved-model directory path (manifest-verified load) or a fitted
#: OpWorkflowModel. ``OpWorkflow.drift_refit_hook`` builds one.
RefitHook = Callable[[str, ServingRuntime, Dict[str, Any]], Any]


class ModelRegistry:
    """Name → :class:`ServingRuntime` map with lifecycle management."""

    def __init__(self, config: Optional[ServeConfig] = None,
                 refit_hook: Optional[RefitHook] = None):
        self._default_config = config
        self._lock = threading.Lock()
        self._runtimes: Dict[str, ServingRuntime] = {}
        self._refit_hook = refit_hook
        self._refit_lock = threading.Lock()
        self._refits_inflight: set = set()
        #: completed refit attempts, oldest first (success and failure)
        self.refit_history: List[Dict[str, Any]] = []

    # -- registration --------------------------------------------------------
    def register(self, name: str, model,
                 config: Optional[ServeConfig] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 warm: bool = False,
                 warm_entry: Optional[Dict[str, Any]] = None,
                 drift_monitor: Optional["_drift.DriftMonitor"] = None,
                 ) -> ServingRuntime:
        """Start a runtime for ``model`` under ``name``. ``warm=True``
        pre-warms the serve path before the runtime takes traffic (the
        JAX package's ``store_path``, its AOT program store, waits for
        ROADMAP Queue 1 item 10); ``drift_monitor`` attaches online
        distribution monitoring."""
        with self._lock:
            if name in self._runtimes:
                raise ValueError(
                    f"model '{name}' is already registered; "
                    f"unregister() it first")
            rt = ServingRuntime(
                model, name=name,
                config=config or self._default_config,
                breaker=breaker, drift_monitor=drift_monitor,
                auto_start=False)
            self._runtimes[name] = rt
        self._wire_drift(name, rt)
        if warm:
            _warmup.warm_runtime(rt, warm_entry)
        rt.start()
        return rt

    def load(self, name: str, path: str, workflow=None,
             config: Optional[ServeConfig] = None,
             warm: bool = True, device=None) -> ServingRuntime:
        """Load a saved model (manifest-verified) onto ``device`` (default:
        the CUDA device) and register it; by default warms the serve path
        and checks the fingerprint recorded in its ``MANIFEST.json``
        ``serving`` section so the first request is served warm, and
        attaches a DriftMonitor when the manifest carries a ``drift``
        baseline (``TG_DRIFT=0`` opts out)."""
        model, entry, monitor = self._load_parts(path, workflow, device)
        rt = self.register(name, model, config=config, warm=warm,
                           warm_entry=entry or None,
                           drift_monitor=monitor)
        if warm:
            # warmup-time cost persistence, as in the JAX package: merge
            # the process's measured cost rows into the model's MANIFEST
            # `costs` section (the port records none yet, so nothing is
            # written). Best-effort by contract: a read-only model dir
            # must not fail the load.
            from ..observability import devicemem as _devicemem
            _devicemem.persist_costs(path)
        return rt

    @staticmethod
    def _load_parts(path: str, workflow=None, device=None):
        from ..manifest import CheckpointManifest
        from ..persistence import FORMAT_VERSION, load_model
        model = load_model(path, device=device, workflow=workflow)
        manifest, err = CheckpointManifest.load(path, FORMAT_VERSION)
        entry = dict(manifest.serving) if err is None else {}
        monitor = None
        if err is None and manifest.drift and _drift.drift_enabled():
            monitor = _drift.DriftMonitor(
                _drift.DriftBaseline.from_json(manifest.drift))
        return model, entry, monitor

    def unregister(self, name: str, drain: bool = True) -> None:
        with self._lock:
            rt = self._runtimes.pop(name, None)
        if rt is not None:
            rt.close(drain=drain)

    # -- access --------------------------------------------------------------
    def runtime(self, name: str) -> ServingRuntime:
        with self._lock:
            try:
                return self._runtimes[name]
            except KeyError:
                raise KeyError(
                    f"no model '{name}' registered "
                    f"(have: {sorted(self._runtimes)})") from None

    __getitem__ = runtime

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._runtimes)

    def _routed(self, name: str, call):
        rt = self.runtime(name)
        while True:
            try:
                return call(rt)
            except RuntimeStoppedError:
                # a hot swap closes the old runtime after the entry flips:
                # a request that looked it up just before goes on to the
                # replacement
                with self._lock:
                    current = self._runtimes.get(name)
                if current is None or current is rt:
                    raise
                rt = current

    def submit(self, name: str, row: Dict[str, Any], **kw):
        return self._routed(name, lambda rt: rt.submit(row, **kw))

    def score(self, name: str, row: Dict[str, Any], **kw) -> Dict[str, Any]:
        return self._routed(name, lambda rt: rt.score(row, **kw))

    # -- drift-triggered refit + hot swap ------------------------------------
    def set_refit_hook(self, hook: Optional[RefitHook]) -> "ModelRegistry":
        self._refit_hook = hook
        return self

    def _wire_drift(self, name: str, rt: ServingRuntime) -> None:
        mon = rt.drift_monitor
        if mon is not None:
            mon.on_degraded = (
                lambda report, _n=name: self._on_degraded(_n, report))

    def _on_degraded(self, name: str, report: Dict[str, Any]) -> None:
        """Fired (once per transition into ``degraded``) from the model's
        batcher thread — must never block it: the refit runs in its own
        daemon thread, at most one per model."""
        _obs_event("drift.degraded", model=name)
        _blackbox.record("drift.degraded", model=name,
                         refitHook=self._refit_hook is not None)
        if self._refit_hook is None:
            return
        with self._refit_lock:
            if name in self._refits_inflight:
                return
            self._refits_inflight.add(name)
        t = threading.Thread(target=self._run_refit, args=(name, report),
                             name=f"tg-drift-refit[{name}]", daemon=True)
        _drift.track_refit(t)
        t.start()

    def _run_refit(self, name: str, report: Dict[str, Any]) -> None:
        entry: Dict[str, Any] = {"model": name, "ok": False}
        try:
            rt = self.runtime(name)
        except KeyError:
            with self._refit_lock:
                self._refits_inflight.discard(name)
            _drift.untrack_refit(threading.current_thread())
            return
        # hang watchdog: a refit is one long hook call with no heartbeat
        # cadence, so a heart that never beats past TG_WATCHDOG_S records
        # the wedge (thread_stalled + tg_watchdog_stalls_total) — the
        # model keeps serving either way, but the hang is never silent
        heart = _watchdog.register(
            f"tg-drift-refit[{name}]", kind="drift.refit",
            fault_log=rt.fault_log)
        try:
            # deterministic chaos entry: a fault anywhere in the refit
            # path (hook crash, corrupt save, load failure) — the old
            # model keeps serving, the breaker is untouched
            faults.inject("drift.refit", key=name)
            result = self._refit_hook(name, rt, report)
            new_rt = self.swap(name, result)
            entry.update(ok=True, swapped=True,
                         path=result if isinstance(result, str) else None)
            new_rt.fault_log.add(FaultReport(
                site="drift.refit", kind="drift_refit",
                detail={"model": name,
                        "path": entry.get("path"),
                        "triggerVerdict": report.get("verdict")}))
            _obs_event("drift.refit", model=name, ok=True)
        except Exception as e:
            entry["error"] = f"{type(e).__name__}: {e}"[:300]
            rt.fault_log.add(FaultReport(
                site="drift.refit", kind="drift_refit_failed",
                detail={"model": name, "error": entry["error"]}))
            _obs_event("drift.refit", model=name, ok=False)
        finally:
            heart.close()
            self.refit_history.append(entry)
            with self._refit_lock:
                self._refits_inflight.discard(name)
            _drift.untrack_refit(threading.current_thread())

    def swap(self, name: str, model_or_path, warm: bool = True,
             workflow=None, device=None) -> ServingRuntime:
        """Hot-swap ``name`` to a new model with zero request loss: the
        replacement runtime is built, (optionally) warmed, and
        *started* before the registry entry flips; the old runtime then
        closes with ``drain=True``, scoring everything already queued on
        the old model. ``model_or_path``: a saved-model directory
        (manifest-verified load + warm fingerprint + drift baseline) or a
        fitted ``OpWorkflowModel`` (baseline rebuilt from its train
        table when possible). A directory loads onto ``device``, by
        default the device of the model it replaces."""
        old = self.runtime(name)
        entry: Optional[Dict[str, Any]] = None
        if isinstance(model_or_path, str):
            if device is None:
                device = getattr(old.model, "device", None)
            model, entry, monitor = self._load_parts(model_or_path, workflow,
                                                     device)
        else:
            model = model_or_path
            monitor = None
            if _drift.drift_enabled():
                try:
                    monitor = _drift.DriftMonitor(
                        _drift.DriftBaseline.from_model(model))
                except Exception:
                    monitor = None  # no baseline → serve unmonitored
        new_rt = ServingRuntime(model, name=name,
                                config=old.config,
                                drift_monitor=monitor, auto_start=False)
        self._wire_drift(name, new_rt)
        if warm:
            _warmup.warm_runtime(new_rt, entry or None)
        new_rt.start()
        with self._lock:
            if self._runtimes.get(name) is not old:
                current = self._runtimes.get(name)
                raise RuntimeError(
                    f"model '{name}' changed during swap "
                    f"({'unregistered' if current is None else 'replaced'})")
            self._runtimes[name] = new_rt
        old.close(drain=True)
        _obs_event("serve.swap", model=name)
        _blackbox.record("serve.swap", model=name)
        return new_rt

    # -- health --------------------------------------------------------------
    def health(self) -> Dict[str, Any]:
        """Readiness snapshot: ``ready`` is True only when every registered
        model is serving with its device path live (breaker not open).
        Each model's entry carries its drift verdict (``summary()["drift"]``)
        — a drift-degraded model still serves, so it does not flip
        ``ready``; it flags that its *data* needs attention (or a refit is
        already healing it)."""
        with self._lock:
            rts = dict(self._runtimes)
        models = {name: rt.summary() for name, rt in sorted(rts.items())}
        with self._refit_lock:
            inflight = sorted(self._refits_inflight)
        return {
            "ready": bool(models) and all(
                m["state"] == "ready" for m in models.values()),
            "models": models,
            # the fleet's autoscaling view in one map: each model's
            # up/hold/down hint (derived from queue depth, shed rate,
            # breaker state, SLO burn and drift verdict — each entry's
            # full reasons live in models[name]["scaleHint"]); the
            # artifact ROADMAP item 2's replica controller consumes
            "scaleHints": {name: m["scaleHint"]["hint"]
                           for name, m in models.items()},
            "refitsInFlight": inflight,
            "refits": list(self.refit_history),
        }

    # -- lifecycle -----------------------------------------------------------
    def close(self, drain: bool = True) -> None:
        # runtime.close drains the pipelined dataplane too: the batcher
        # retires first (failing still-queued futures typed when
        # drain=False), then the completer resolves every in-flight
        # flush before its join — zero lost futures at any depth
        with self._lock:
            rts = list(self._runtimes.values())
            self._runtimes.clear()
        for rt in rts:
            rt.close(drain=drain)
        # a refit racing close() targets an unregistered name and exits;
        # wait briefly so no tg-drift-refit thread outlives the registry —
        # and never discard one that does silently: the leak is recorded
        # as thread_stalled + tg_watchdog_stalls_total (docs/robustness.md)
        for t in _drift.live_refits():
            t.join(timeout=30)
            if t.is_alive():
                _watchdog.report_thread_stalled(
                    site="registry.close", thread_name=t.name,
                    waited_s=30.0)

    def __enter__(self) -> "ModelRegistry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
