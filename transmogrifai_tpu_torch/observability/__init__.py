"""Observability: structured tracing + metrics + exporters (docs/observability.md).

The PyTorch port's copy of the JAX package's observability package, with
the same public names, env knobs (``TG_TRACE``, ``TG_METRICS``,
``TG_BLACKBOX``, ``TG_POSTMORTEM_DIR``, ``TG_SLO_*``) and JSON shapes, so
a summary, a health snapshot or an incident bundle reads the same from
either package. It replaces the reference's Spark-listener telemetry
(reference utils/.../spark/OpSparkListener.scala → AppMetrics): spans for
every train/score unit of work (``trace``), a registry of counters, gauges
and streaming-quantile latency histograms (``metrics``), and pure-stdlib
exporters — Chrome trace-event JSON for ``chrome://tracing``/Perfetto,
Prometheus text exposition, JSONL (``export``).

Enable with ``TG_TRACE=1`` (spans + metrics) or ``TG_METRICS=1`` (metrics
only); disabled, every instrumentation point is a single flag check.
``OpWorkflowModel.summary()["observability"]`` returns :func:`summarize` —
the aggregated per-stage / per-family timings, fault counters and scoring
latency quantiles of the current process.

Independently of both switches, the **flight recorder** (``blackbox``)
runs always-on (``TG_BLACKBOX=0`` opts out): a bounded ring of compact
request-correlated events that ``postmortem`` snapshots into atomic
incident bundles on trigger events (breaker open, watchdog stall, OOM
downshift, drift degradation, unclean exit, campaign violations) —
docs/observability.md "Flight recorder & post-mortems".
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from . import blackbox, devicemem, export, ledger, metrics  # noqa: F401
from . import postmortem, slo, timeseries, trace  # noqa: F401
from .blackbox import (  # noqa: F401
    FlightRecorder, blackbox_enabled, correlated, current_correlation,
    enable_blackbox, new_correlation_id, recorder,
)
from .ledger import (  # noqa: F401
    CompileLedger, enable_ledger, fingerprint_diff, ledger_enabled,
    subsystem_scope,
)
from .ledger import ledger as compile_ledger  # noqa: F401
from .metrics import (  # noqa: F401
    MetricsRegistry, enable_metrics, inc_counter, metrics_enabled, observe,
    registry, set_gauge,
)
from .slo import SLOSpec, SLOTracker, scale_hint  # noqa: F401
from .timeseries import (  # noqa: F401
    MetricsSampler, enable_sampler, sampler_enabled, sketch_delta,
)
from .trace import (  # noqa: F401
    Span, Tracer, add_event, enable_tracing, span, tracer, tracing_enabled,
)


def reset() -> None:
    """Fresh tracer + registry + flight recorder + env-driven enablement —
    the per-test isolation hook (tests/conftest.py); production never
    needs it."""
    trace.reset()
    metrics.reset()
    blackbox.reset()
    postmortem.reset()
    ledger.reset()
    devicemem.reset()
    timeseries.reset()
    slo.reset()


def _plan_cache_stats() -> Dict[str, int]:
    """The transform-plan LRU's {"entries", "max"} (``plan.cache_stats``)."""
    from .. import plan as _plan
    return _plan.cache_stats()


def summarize(tr: Optional[trace.Tracer] = None,
              reg: Optional[metrics.MetricsRegistry] = None
              ) -> Dict[str, Any]:
    """Aggregate the span buffer + registry into the
    ``summary()["observability"]`` section: per-stage and per-model-family
    wall-clock (from spans), fault/retry/quarantine counters, scoring
    latency quantiles, and the process compile-cache hit/miss counts."""
    t = tr or trace.tracer()
    r = reg or metrics.registry()
    spans = t.finished()

    by_name: Dict[str, Dict[str, Any]] = {}
    stages: Dict[str, Dict[str, Any]] = {}
    families: Dict[str, Dict[str, Any]] = {}
    for s in spans:
        if s.dur_ns is None:
            continue
        secs = s.dur_ns / 1e9
        agg = by_name.setdefault(s.name, {"seconds": 0.0, "count": 0})
        agg["seconds"] += secs
        agg["count"] += 1
        if s.name in ("stage.fit", "stage.transform"):
            key = str(s.attrs.get("stage", "?"))
            st = stages.setdefault(key, {"seconds": 0.0, "count": 0,
                                         "fitSeconds": 0.0,
                                         "transformSeconds": 0.0})
            st["seconds"] += secs
            st["count"] += 1
            op = ("fitSeconds" if s.name == "stage.fit"
                  else "transformSeconds")
            st[op] += secs
        elif s.name == "sweep.family":
            key = str(s.attrs.get("family", "?"))
            fam = families.setdefault(key, {"seconds": 0.0, "count": 0,
                                            "configs": 0})
            fam["seconds"] += secs
            fam["count"] += 1
            fam["configs"] += int(s.attrs.get("configs", 0) or 0)

    snap = r.snapshot()
    # serving series (tg_serve_* + the breaker gauge + the drift gauges,
    # labelled per model) get their own section — mirrored there from each
    # runtime's serve-local registry when metrics are enabled
    # (docs/serving.md); tg_drift_verdict mirrors each model's drift
    # verdict (0=ok, 1=drifting, 2=degraded)
    serving = {name: series for name, series in snap.items()
               if name.startswith(("tg_serve_", "tg_drift_"))
               or name == "tg_breaker_state"}
    counters = {name: series for name, series in snap.items()
                if not name.startswith("tg_score_") and name not in serving}
    scoring: Dict[str, Any] = {}
    for name, key in (("tg_score_request_seconds", "request"),
                      ("tg_score_microbatch_seconds", "microBatch")):
        series = snap.get(name)
        if series:
            # unlabelled single series — take it directly
            scoring[key] = next(iter(series.values()))
    for name, key in (("tg_score_rows_total", "rowsScored"),
                      ("tg_score_quarantined_total", "rowsQuarantined")):
        series = snap.get(name)
        if series:
            scoring[key] = sum(series.values())

    return {
        "enabled": {"tracing": trace.tracing_enabled(),
                    "metrics": metrics.metrics_enabled()},
        "spanCount": len(spans),
        "droppedSpans": t.dropped,
        "byName": dict(sorted(by_name.items(),
                              key=lambda kv: -kv[1]["seconds"])),
        "stages": dict(sorted(stages.items(),
                              key=lambda kv: -kv[1]["seconds"])),
        "families": dict(sorted(families.items(),
                                key=lambda kv: -kv[1]["seconds"])),
        "counters": counters,
        "scoring": scoring,
        "serving": serving,
        # the port has no persistent program cache yet (ROADMAP Queue 1
        # item 10): its key stays, at zero
        "compileCache": {"hits": 0, "misses": 0},
        "planCache": _plan_cache_stats(),
        # cause-classified program builds + predicted/measured device
        # bytes (docs/observability.md "Compile & memory ledger")
        "compileLedger": ledger.ledger().snapshot(),
        "deviceMemory": devicemem.observatory().snapshot(),
        # windowed-sampler + SLO-budget state: registered specs, attached
        # sampler accounting, per-model verdicts + scale hints
        # (docs/observability.md "SLOs, budgets & burn rates")
        "slo": slo.summarize(),
    }
