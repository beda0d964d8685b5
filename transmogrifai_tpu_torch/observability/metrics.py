"""Metrics registry: counters, gauges, and streaming-quantile histograms.

The reference aggregates its listener's task metrics into ``AppMetrics``
(reference utils/.../spark/AppMetrics.scala) — a one-shot summary at app
end. A serving system needs *live* aggregates, so this registry keeps
O(1)-memory instruments updated in place: counters/gauges are plain floats,
and latency histograms reuse the SPDT streaming sketch
(``utils/streaming_histogram.py`` — the same algorithm the reference ships
as ``StreamingHistogram.java``) so p50/p95/p99 on the scoring path cost a
fixed ~64 bins per series no matter how many requests flow through.

Instruments are keyed by ``(name, sorted(labels))`` — the Prometheus data
model — and export through ``observability/export.py`` (text exposition
format) or :meth:`MetricsRegistry.snapshot` (plain dicts for
``summary()``).

Switches: ``TG_METRICS=1`` enables recording; unset, it follows
``TG_TRACE`` (a traced run wants its counters too). The instrumentation
helpers (:func:`inc_counter` / :func:`set_gauge` / :func:`observe`) are the
hot-path entry points: one enabled check, zero writes when off — the
overhead guard in tests/test_observability.py holds the registry to exactly
zero writes with observability disabled.

Label cardinality is bounded: a metric name may hold at most
``TG_METRICS_MAX_LABELS`` distinct label sets (default 64). The first
series past the bound collapses into one ``__other__`` overflow series per
name (same label keys, every value ``__other__``) instead of growing the
registry without bound — the guard the per-feature ``tg_drift_*{feature}``
gauges need, and a safety net for any future labelled series (an
unbounded user-supplied label value would otherwise leak one instrument
per distinct value for the life of the process).
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from ..utils.streaming_histogram import StreamingHistogram

#: env switch; unset defers to TG_TRACE (tracing implies metrics)
METRICS_ENV = "TG_METRICS"
#: per-name label-set cardinality bound (docstring above)
MAX_LABELS_ENV = "TG_METRICS_MAX_LABELS"
DEFAULT_MAX_LABELS = 64
#: the label value every over-bound series collapses to
OVERFLOW_LABEL = "__other__"

_FALSY = ("", "0", "false", "False", "no")


def _max_labels() -> int:
    try:
        return max(1, int(os.environ.get(MAX_LABELS_ENV, "")
                          or DEFAULT_MAX_LABELS))
    except ValueError:
        return DEFAULT_MAX_LABELS

_enabled_override: Optional[bool] = None


def metrics_enabled() -> bool:
    if _enabled_override is not None:
        return _enabled_override
    env = os.environ.get(METRICS_ENV)
    if env is not None:
        return env not in _FALSY
    from .trace import tracing_enabled
    return tracing_enabled()


def enable_metrics(on: Optional[bool]) -> None:
    """Force metrics on/off from code; ``None`` hands control back to the
    ``TG_METRICS`` (or ``TG_TRACE``) environment switches."""
    global _enabled_override
    _enabled_override = None if on is None else bool(on)


LabelKey = Tuple[Tuple[str, str], ...]


class Counter:
    """Monotonic accumulator (Prometheus counter; name by convention ends
    in ``_total`` or a unit suffix)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        self.value += n


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n


#: quantiles exported for every histogram (Prometheus summary convention)
QUANTILES = (0.5, 0.95, 0.99)

#: how many slowest-observation exemplars a histogram keeps
EXEMPLARS_ENV = "TG_EXEMPLARS_K"
DEFAULT_EXEMPLARS_K = 5


def _exemplars_k() -> int:
    try:
        return max(0, int(os.environ.get(EXEMPLARS_ENV, "")
                          or DEFAULT_EXEMPLARS_K))
    except ValueError:
        return DEFAULT_EXEMPLARS_K


class Histogram:
    """Streaming-quantile distribution: fixed-size SPDT sketch + exact
    count/sum. ``observe`` is O(1); quantiles are approximations whose
    error shrinks with bin count (64 bins ≈ sub-percent on unimodal
    latency distributions — validated against numpy in the tests).

    **Exemplars**: observations may carry an exemplar tag (the serving
    runtime passes the request's flight-recorder correlation id —
    observability/blackbox.py); the histogram keeps the tags of its K
    largest observations (``TG_EXEMPLARS_K``, default 5), so a p99
    latency outlier links directly to the recorder timeline of the
    request that caused it."""

    __slots__ = ("name", "labels", "count", "sum", "_sketch", "_exemplars")

    def __init__(self, name: str, labels: Dict[str, str], max_bins: int = 64):
        self.name = name
        self.labels = labels
        self.count = 0
        self.sum = 0.0
        self._sketch = StreamingHistogram(max_bins=max_bins)
        #: (value, exemplar) of the K largest tagged observations, desc
        self._exemplars: List[Tuple[float, Any]] = []

    def observe(self, v: float, exemplar: Any = None) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self._sketch.update([v])
        if exemplar is not None:
            xs = self._exemplars
            k = _exemplars_k()
            if k and (len(xs) < k or v > xs[-1][0]):
                xs.append((v, exemplar))
                xs.sort(key=lambda t: -t[0])
                del xs[k:]

    def quantile(self, q: float) -> float:
        if self.count == 0:
            return float("nan")
        return float(self._sketch.quantile(q))

    def sketch_state(self) -> Dict[str, Any]:
        """Checkpointable sketch state (plain arrays) — the windowed
        time-series sampler (observability/timeseries.py) snapshots this
        each tick so window-start-vs-now sketch subtraction can compute
        windowed quantiles."""
        return self._sketch.to_state()

    def exemplars(self) -> List[Dict[str, Any]]:
        """The slowest-K tagged observations, largest first:
        ``[{"value": seconds, "exemplar": corr-id}]``."""
        return [{"value": v, "exemplar": e} for v, e in self._exemplars]

    def cumulative_buckets(self) -> List[Tuple[float, float]]:
        """``[(le, cumulative count)]`` derived from the streaming
        sketch's bin centroids — monotone non-decreasing and capped at
        ``count``, ready for Prometheus ``_bucket`` exposition (the
        exporter appends the ``+Inf`` bucket; observability/export.py)."""
        if not self.count:
            return []
        out: List[Tuple[float, float]] = []
        prev = 0.0
        for center, _mass in self._sketch.bins():
            cum = min(float(self._sketch.sum(center)), float(self.count))
            cum = max(cum, prev)
            prev = cum
            out.append((float(center), cum))
        return out

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"count": self.count, "sum": self.sum}
        if self.count:
            out["min"] = float(self._sketch.min)
            out["max"] = float(self._sketch.max)
            for q in QUANTILES:
                out[f"p{int(q * 100)}"] = self.quantile(q)
        if self._exemplars:
            out["exemplars"] = self.exemplars()
        return out


class MetricsRegistry:
    """Get-or-create instrument store. A name is permanently bound to one
    instrument kind; re-requesting with another kind raises (the same
    collision Prometheus clients reject)."""

    def __init__(self, max_labels: Optional[int] = None):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, LabelKey], Any] = {}
        self._kinds: Dict[str, str] = {}
        self._help: Dict[str, str] = {}
        self._max_labels = (max(1, int(max_labels))
                            if max_labels is not None else _max_labels())
        self._series_count: Dict[str, int] = {}
        #: label sets collapsed into the __other__ series, per name
        self.overflowed: Dict[str, int] = {}

    # -- get-or-create -------------------------------------------------------
    def _get(self, cls, kind: str, name: str, help: str,
             labels: Dict[str, str], **kw):
        lk: LabelKey = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            prev = self._kinds.get(name)
            if prev is not None and prev != kind:
                raise ValueError(
                    f"metric '{name}' already registered as {prev}, "
                    f"requested as {kind}")
            self._kinds[name] = kind
            if help:
                self._help.setdefault(name, help)
            m = self._metrics.get((name, lk))
            if m is None:
                # cardinality bound: a NEW labelled series past the bound
                # collapses into the name's single __other__ series instead
                # of registering (last-write-wins for gauges there — an
                # overflow series is a "something beyond the bound exists"
                # signal, not a faithful per-label value)
                if lk and self._series_count.get(name, 0) >= self._max_labels:
                    self.overflowed[name] = self.overflowed.get(name, 0) + 1
                    lk = tuple((k, OVERFLOW_LABEL) for k, _ in lk)
                    m = self._metrics.get((name, lk))
                    if m is not None:
                        return m
                m = self._metrics[(name, lk)] = cls(
                    name, dict(lk), **kw)
                self._series_count[name] = self._series_count.get(name, 0) + 1
            return m

    def counter(self, name: str, help: str = "", **labels: str) -> Counter:
        return self._get(Counter, "counter", name, help, labels)

    def gauge(self, name: str, help: str = "", **labels: str) -> Gauge:
        return self._get(Gauge, "gauge", name, help, labels)

    def histogram(self, name: str, help: str = "", max_bins: int = 64,
                  **labels: str) -> Histogram:
        return self._get(Histogram, "histogram", name, help, labels,
                         max_bins=max_bins)

    # -- introspection -------------------------------------------------------
    def collect(self) -> List[Tuple[str, str, str, List[Any]]]:
        """→ [(name, kind, help, [instruments])], names sorted, instruments
        in stable label order — the exporter's iteration order."""
        with self._lock:
            by_name: Dict[str, List[Any]] = {}
            for (name, lk), m in sorted(self._metrics.items()):
                by_name.setdefault(name, []).append(m)
            return [(name, self._kinds[name], self._help.get(name, ""), ms)
                    for name, ms in by_name.items()]

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Plain-dict view for ``summary()``: {name: {label-string: value
        or histogram snapshot}} (label-string "" for unlabelled series)."""
        out: Dict[str, Dict[str, Any]] = {}
        for name, kind, _help, ms in self.collect():
            series: Dict[str, Any] = {}
            for m in ms:
                key = ",".join(f"{k}={v}" for k, v in sorted(m.labels.items()))
                series[key] = (m.snapshot() if isinstance(m, Histogram)
                               else m.value)
            out[name] = series
        return out

    def to_prometheus(self, compat: Optional[bool] = None) -> str:
        """Text exposition format: counters/gauges as-is, histograms as
        real cumulative ``_bucket``/``_sum``/``_count`` series derived
        from the streaming sketch (observability/export.py owns the
        grammar). ``compat=True`` — or ``TG_PROM_SUMMARY_COMPAT=1`` —
        restores the pre-round-11 summary exposition (p50/p95/p99
        quantile series) for scrapers built against it."""
        from .export import prometheus_text
        return prometheus_text(self, compat=compat)


def _labels(labels: Dict[str, str], quantile: Optional[float] = None,
            le: Optional[str] = None) -> str:
    items = sorted(labels.items())
    if quantile is not None:
        items.append(("quantile", f"{quantile:g}"))
    if le is not None:
        # the bucket boundary label goes LAST (Prometheus convention)
        items.append(("le", str(le)))
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in items)
    return "{" + body + "}"


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _num(v: float) -> str:
    return repr(float(v))


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


def set_registry(r: MetricsRegistry) -> MetricsRegistry:
    global _REGISTRY
    _REGISTRY = r
    return r


def reset() -> None:
    """Fresh registry + env-driven enablement (test isolation)."""
    global _REGISTRY, _enabled_override
    _REGISTRY = MetricsRegistry()
    _enabled_override = None


# -- hot-path instrumentation helpers (one enabled check, zero writes off) --
def inc_counter(name: str, n: float = 1.0, help: str = "",
                **labels: str) -> None:
    if metrics_enabled():
        _REGISTRY.counter(name, help, **labels).inc(n)


def set_gauge(name: str, v: float, help: str = "", **labels: str) -> None:
    if metrics_enabled():
        _REGISTRY.gauge(name, help, **labels).set(v)


def observe(name: str, v: float, help: str = "", **labels: str) -> None:
    if metrics_enabled():
        _REGISTRY.histogram(name, help, **labels).observe(v)
