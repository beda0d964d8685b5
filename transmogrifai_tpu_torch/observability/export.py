"""Exporters: Chrome trace-event JSON, Prometheus text, JSONL event log.

All pure-stdlib and written atomically through the checkpoint machinery's
tmp+fsync+rename helper (``manifest.atomic_write_bytes``): a preempted
export leaves either the previous file or the new one, never a torn JSON —
the same discipline as every other artifact this framework writes.

* :func:`chrome_trace` / :func:`write_chrome_trace` — the trace-event
  format (``{"traceEvents": [{"name","ph","ts","pid","tid",...}]}``)
  loadable in ``chrome://tracing`` or https://ui.perfetto.dev. Spans export
  as complete events (``ph: "X"``, microsecond ``ts``/``dur``); span events
  and free-standing instants as ``ph: "i"``.
* :func:`prometheus_text` / :func:`write_prometheus` — the registry's
  text exposition format (``metrics.prom``), scrape-able or pushable
  as-is. Histograms export as REAL cumulative ``_bucket``/``_sum``/
  ``_count`` series (the bucket boundaries are the streaming sketch's
  bin centroids, the cumulative counts its ``Sum`` estimates — monotone
  by construction, ``+Inf`` exact), so Prometheus can aggregate and
  ``histogram_quantile`` across instances — the one thing the old
  quantile-summary exposition could never do. ``TG_PROM_SUMMARY_COMPAT=1``
  (or ``compat=True``) restores the pre-round-11 summary lines for
  scrapers built against them.
* :func:`write_jsonl` — one JSON object per finished span, for ad-hoc
  ``jq``/pandas analysis of long runs.

When the rendered registry is attached to the windowed time-series
sampler (``observability/timeseries.py``), the exposition additionally
carries the **windowed series as gauges with a ``window`` label**
(``TG_SAMPLE_WINDOWS``, default ``60,300`` seconds): every counter gets
a ``<name>_rate{...,window="60"}`` per-second rate and every histogram
gets ``<name>_p50/_p95/_p99{...,window="60"}`` windowed quantiles (SPDT
sketch subtraction) — the scrape-side view of the same numbers the SLO
engine (``observability/slo.py``) burns budgets on.
"""
from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Optional

from ..manifest import atomic_write_bytes
from . import metrics as _metrics
from . import trace as _trace


def chrome_trace(tracer: Optional[_trace.Tracer] = None) -> Dict[str, Any]:
    """Render the tracer's finished spans as a Chrome trace-event document."""
    t = tracer or _trace.tracer()
    pid = os.getpid()
    events: List[Dict[str, Any]] = []
    for s in t.finished():
        base = {"name": s.name, "cat": s.cat or "span", "pid": pid,
                "tid": s.tid, "ts": s.ts_ns / 1e3}
        if s.dur_ns is None:       # instant event
            events.append({**base, "ph": "i", "s": "t",
                           "args": dict(s.attrs)})
        else:
            events.append({**base, "ph": "X", "dur": s.dur_ns / 1e3,
                           "args": dict(s.attrs)})
        for name, ts_ns, attrs in s.events:
            events.append({"name": name, "cat": "event", "ph": "i",
                           "s": "t", "pid": pid, "tid": s.tid,
                           "ts": ts_ns / 1e3, "args": dict(attrs)})
    events.sort(key=lambda e: e["ts"])
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "epochUnix": t.epoch_unix,
            "droppedSpans": t.dropped,
            "maxSpans": t.max_spans,
        },
    }


def write_chrome_trace(path: str,
                       tracer: Optional[_trace.Tracer] = None) -> str:
    doc = chrome_trace(tracer)
    atomic_write_bytes(path, json.dumps(doc).encode("utf-8"))
    return path


#: compat switch: truthy restores the quantile-summary exposition
PROM_COMPAT_ENV = "TG_PROM_SUMMARY_COMPAT"
_FALSY = ("", "0", "false", "False", "no")

#: comma-separated window lengths (seconds) for the windowed exposition
SAMPLE_WINDOWS_ENV = "TG_SAMPLE_WINDOWS"
DEFAULT_SAMPLE_WINDOWS = (60.0, 300.0)


def _prom_compat() -> bool:
    return os.environ.get(PROM_COMPAT_ENV, "") not in _FALSY


def export_windows() -> List[float]:
    raw = os.environ.get(SAMPLE_WINDOWS_ENV, "")
    if not raw:
        return list(DEFAULT_SAMPLE_WINDOWS)
    out: List[float] = []
    for part in raw.split(","):
        try:
            v = float(part.strip())
            if v > 0:
                out.append(v)
        except ValueError:
            continue
    return out or list(DEFAULT_SAMPLE_WINDOWS)


def windowed_prometheus_lines(sampler, windows: Optional[List[float]] = None
                              ) -> List[str]:
    """The windowed exposition block (module docstring): counter rates
    and histogram quantiles over each window as gauges carrying a
    ``window`` label. Empty when the sampler holds fewer than two
    samples (no window to subtract yet)."""
    if sampler is None or sampler.snapshot()["samples"] < 2:
        return []
    labels_of = _metrics._labels
    num = _metrics._num
    windows = windows if windows is not None else export_windows()
    lines: List[str] = []
    for name in sampler.counter_names():
        series_name = f"{name}_rate"
        emitted_type = False
        for lbls in sampler.series_labels(name):
            for w in windows:
                v = sampler.rate(name, w, **lbls)
                if not emitted_type:
                    lines.append(f"# TYPE {series_name} gauge")
                    emitted_type = True
                lines.append(
                    f"{series_name}"
                    f"{labels_of({**lbls, 'window': f'{w:g}'})} {num(v)}")
    for name in sampler.histogram_names():
        for q in _metrics.QUANTILES:
            series_name = f"{name}_p{int(q * 100)}"
            emitted_type = False
            for lbls in sampler.series_labels(name):
                for w in windows:
                    v = sampler.quantile(name, q, w, **lbls)
                    if not math.isfinite(v):
                        continue
                    if not emitted_type:
                        lines.append(f"# TYPE {series_name} gauge")
                        emitted_type = True
                    lines.append(
                        f"{series_name}"
                        f"{labels_of({**lbls, 'window': f'{w:g}'})} "
                        f"{num(v)}")
    return lines


def prometheus_text(registry: Optional[_metrics.MetricsRegistry] = None,
                    compat: Optional[bool] = None,
                    sampler: Optional[Any] = None) -> str:
    """Render a registry in the Prometheus text exposition format
    (validated against the format grammar in tests/test_blackbox.py).

    Histograms (default): ``# TYPE <name> histogram`` with cumulative
    ``<name>_bucket{le="..."}`` series from
    :meth:`~.metrics.Histogram.cumulative_buckets` plus the exact
    ``le="+Inf"``/``_sum``/``_count`` triple. ``compat=True`` (or the
    ``TG_PROM_SUMMARY_COMPAT`` env): the pre-round-11 summary exposition
    — ``# TYPE <name> summary`` with p50/p95/p99 ``quantile`` series."""
    reg = registry or _metrics.registry()
    if compat is None:
        compat = _prom_compat()
    labels_of = _metrics._labels
    num = _metrics._num
    lines: List[str] = []
    for name, kind, help, ms in reg.collect():
        if help:
            lines.append(f"# HELP {name} {_metrics._escape_help(help)}")
        is_hist = kind in ("histogram", "summary")
        lines.append(f"# TYPE {name} "
                     f"{('summary' if compat else 'histogram') if is_hist else kind}")
        for m in ms:
            if isinstance(m, _metrics.Histogram):
                if compat:
                    if m.count:
                        for q in _metrics.QUANTILES:
                            v = m.quantile(q)
                            if math.isfinite(v):
                                lines.append(
                                    f"{name}{labels_of(m.labels, quantile=q)}"
                                    f" {num(v)}")
                else:
                    for le, cum in m.cumulative_buckets():
                        lines.append(
                            f"{name}_bucket{labels_of(m.labels, le=num(le))}"
                            f" {num(cum)}")
                    lines.append(
                        f"{name}_bucket{labels_of(m.labels, le='+Inf')} "
                        f"{m.count}")
                lines.append(f"{name}_sum{labels_of(m.labels)} "
                             f"{num(m.sum)}")
                lines.append(f"{name}_count{labels_of(m.labels)} "
                             f"{m.count}")
            else:
                lines.append(f"{name}{labels_of(m.labels)} {num(m.value)}")
    # windowed exposition: when the registry is sampled, append its
    # counter rates + histogram quantiles as window-labelled gauges
    if sampler is None:
        from . import timeseries as _timeseries
        sampler = _timeseries.sampler_for(reg)
    lines.extend(windowed_prometheus_lines(sampler))
    return "\n".join(lines) + ("\n" if lines else "")


def write_prometheus(path: str,
                     registry: Optional[_metrics.MetricsRegistry] = None,
                     compat: Optional[bool] = None) -> str:
    atomic_write_bytes(
        path, prometheus_text(registry, compat=compat).encode("utf-8"))
    return path


def write_jsonl(path: str, tracer: Optional[_trace.Tracer] = None) -> str:
    t = tracer or _trace.tracer()
    lines = [json.dumps(s.to_json()) for s in t.finished()]
    atomic_write_bytes(path, ("\n".join(lines) + ("\n" if lines else ""))
                       .encode("utf-8"))
    return path
