"""Windowed time series over the metrics registry: the forward-looking
telemetry plane (docs/observability.md "SLOs, budgets & burn rates").

Every instrument in ``observability/metrics.py`` is a *lifetime*
aggregate: counters only grow, histogram quantiles cover every
observation since process start. That is the right shape for "how much
work has this process done" and useless for "is this model unhealthy
*right now*" — the question SLO budgets, burn-rate alerts
(``observability/slo.py``) and autoscaling signals (ROADMAP item 2) all
ask. This module adds the missing dimension:

* :class:`MetricsSampler` — a bounded ring of periodic registry
  snapshots on an **injectable clock**. Each sample stores only the
  series that *changed* since the previous tick (compact deltas), so an
  idle registry costs near nothing and a busy one costs O(active
  series) per tick.
* **windowed queries** — :meth:`~MetricsSampler.rate` /
  :meth:`~MetricsSampler.increase` turn cumulative counters into
  per-window rates, :meth:`~MetricsSampler.gauge_window` turns gauges
  into last/min/max-over-window, and :meth:`~MetricsSampler.quantile`
  turns lifetime histograms into **windowed quantiles** via SPDT sketch
  subtraction (:func:`sketch_delta`).
* **one shared ``tg-sampler`` daemon thread** (the watchdog-scanner
  pattern — robustness/watchdog.py): sources attach/detach
  (:func:`attach` / :func:`detach`), the thread lives exactly while
  sources exist, and ``TG_SAMPLER=0`` opts the whole subsystem out
  (attach returns None, zero threads, zero writes).

Sketch subtraction: SPDT sketches merge (utils/streaming_histogram.py)
but are **not** exactly subtractable — compaction merges bins, so
``now - start`` has no unique bin-level answer. :func:`sketch_delta`
instead subtracts the two sketches' cumulative distribution estimates
(``Sum``) on the union of their bin centroids, clamps the difference
monotone non-negative and caps it at the count delta, then rebuilds a
sketch from the interval masses. Mass is conserved exactly (the delta
sketch's total equals ``now.total - start.total``); quantile accuracy
is approximate with the same error character as the underlying sketch
(validated against exact numpy quantiles within documented tolerance in
tests/test_slo.py).

Window semantics: a series' value before its first sample is taken as 0
(a counter is born at zero), so a window opening before the first sample
counts everything ever recorded; ``rate``'s elapsed-time denominator is
clipped to the sampled history so such a window doesn't divide by time
nobody observed. Both are the honest choices for rates on a bounded ring
and are documented here rather than silently approximated.

Env knobs: ``TG_SAMPLER`` (default on; ``0`` opts out),
``TG_SAMPLE_EVERY_S`` (cadence, default 5), ``TG_SAMPLE_MAX`` (ring
bound in samples, default 720 — one hour at the default cadence).
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..utils.streaming_histogram import StreamingHistogram, _compress_bins
from . import metrics as _metrics

#: env switch: "0"/falsy disables the sampler subsystem entirely
SAMPLER_ENV = "TG_SAMPLER"
#: sampling cadence (seconds) for the shared tg-sampler thread
SAMPLE_EVERY_ENV = "TG_SAMPLE_EVERY_S"
DEFAULT_EVERY_S = 5.0
#: ring bound, in samples
SAMPLE_MAX_ENV = "TG_SAMPLE_MAX"
DEFAULT_MAX_SAMPLES = 720

_FALSY = ("0", "false", "False", "no", "off")

_enabled_override: Optional[bool] = None


def sampler_enabled() -> bool:
    """True when sampling is on (default; ``TG_SAMPLER=0`` opts out,
    :func:`enable_sampler` overrides)."""
    if _enabled_override is not None:
        return _enabled_override
    return os.environ.get(SAMPLER_ENV, "1") not in _FALSY


def enable_sampler(on: Optional[bool]) -> None:
    """Force sampling on/off from code (benches, tests); ``None`` hands
    control back to the ``TG_SAMPLER`` environment switch."""
    global _enabled_override
    _enabled_override = None if on is None else bool(on)


def sample_every_s() -> float:
    try:
        v = float(os.environ.get(SAMPLE_EVERY_ENV, "") or DEFAULT_EVERY_S)
        return v if v > 0 else DEFAULT_EVERY_S
    except ValueError:
        return DEFAULT_EVERY_S


def max_samples() -> int:
    try:
        return max(2, int(os.environ.get(SAMPLE_MAX_ENV, "")
                          or DEFAULT_MAX_SAMPLES))
    except ValueError:
        return DEFAULT_MAX_SAMPLES


# -- sketch subtraction ------------------------------------------------------

def sketch_delta(now: StreamingHistogram,
                 start: Optional[StreamingHistogram]) -> StreamingHistogram:
    """The window's sub-sketch: observations in ``now`` but not in
    ``start`` (a snapshot of the same stream at the window's open).

    Subtracts the cumulative ``Sum`` estimates on the union of both
    sketches' centroids, clamped monotone non-negative and capped at the
    count delta, and rebuilds a sketch from the interval masses. The
    result conserves mass exactly (``total == now.total - start.total``);
    its quantiles are approximations (see module docstring)."""
    out = StreamingHistogram(now.max_bins)
    if start is None or start.total <= 0:
        bins = now.bins()
        if bins:
            out._load_state(bins, now.total, now.min, now.max)
        return out
    dtotal = now.total - start.total
    if dtotal <= 0:
        return out
    bs = sorted({c for c, _ in now.bins()} | {c for c, _ in start.bins()})
    cum: List[float] = []
    prev = 0.0
    for b in bs:
        d = now.sum(b) - start.sum(b)
        d = min(max(d, prev), dtotal)
        cum.append(d)
        prev = d
    masses = [cum[0]] + list(np.diff(np.asarray(cum, dtype=np.float64)))
    bins = [(b, m) for b, m in zip(bs, masses) if m > 0.0]
    tail = dtotal - cum[-1]
    if tail > 0.0:
        hi = max(float(now.max), bs[-1])
        if bins and bins[-1][0] == hi:
            bins[-1] = (hi, bins[-1][1] + tail)
        else:
            bins.append((hi, tail))
    if not bins:  # numerically everything clamped away: one lump bin
        bins = [(float(now.max), dtotal)]
    lo = bins[0][0]
    hi = bins[-1][0]
    out._load_state(_compress_bins(bins, now.max_bins), dtotal, lo, hi)
    return out


# -- the sampler -------------------------------------------------------------

#: one recorded histogram point: cumulative count/sum + the sketch state
#: (plain arrays — utils/streaming_histogram.to_state, impl-independent)
_HistPoint = Dict[str, Any]

SeriesKey = Tuple[str, str]  # (metric name, sorted "k=v,..." label string)


def _label_str(labels: Dict[str, str]) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


class MetricsSampler:
    """Bounded ring of periodic snapshots of ONE
    :class:`~.metrics.MetricsRegistry`, with windowed queries.

    Thread-safe: the shared ``tg-sampler`` thread ticks it while query
    callers (SLO trackers, ``health()``, exporters) read. Tests build
    their own instance with an injectable ``clock`` and drive
    :meth:`tick` manually."""

    def __init__(self, registry: _metrics.MetricsRegistry,
                 name: str = "metrics",
                 clock: Callable[[], float] = time.monotonic,
                 every_s: Optional[float] = None,
                 max_samples_: Optional[int] = None):
        self.registry = registry
        self.name = name
        self.clock = clock
        self.every_s = float(every_s) if every_s else sample_every_s()
        self.max_samples = (int(max_samples_) if max_samples_
                            else max_samples())
        self._lock = threading.Lock()
        #: ring of (ts, {key: value}) — only series that changed that tick
        self._samples: "deque[Tuple[float, Dict[SeriesKey, Any]]]" = deque(
            maxlen=self.max_samples)
        #: latest cumulative value per series (query fast path)
        self._last: Dict[SeriesKey, Any] = {}
        self._kinds: Dict[SeriesKey, str] = {}
        self._labels: Dict[SeriesKey, Dict[str, str]] = {}
        self._last_tick: Optional[float] = None
        self.ticks = 0
        #: called after every tick as ``hook(sampler, ts)`` — the SLO
        #: trackers' evaluation cadence; exceptions are contained (a bad
        #: hook must never kill the shared sampler thread)
        self.on_sample: List[Callable[["MetricsSampler", float], None]] = []

    # -- sampling ------------------------------------------------------------
    def due(self, now: Optional[float] = None) -> bool:
        now = self.clock() if now is None else now
        return (self._last_tick is None
                or now - self._last_tick >= self.every_s * 0.95)

    def tick(self, now: Optional[float] = None) -> int:
        """Snapshot the registry; returns how many series changed."""
        now = self.clock() if now is None else now
        changed: Dict[SeriesKey, Any] = {}
        for name, kind, _help, ms in self.registry.collect():
            for m in ms:
                key = (name, _label_str(m.labels))
                if kind == "histogram":
                    prev = self._last.get(key)
                    if prev is not None and prev["count"] == m.count:
                        continue
                    entry: Any = {"count": m.count, "sum": m.sum,
                                  "state": m.sketch_state()}
                else:
                    entry = float(m.value)
                    if self._last.get(key) == entry:
                        continue
                changed[key] = entry
                with self._lock:
                    self._last[key] = entry
                    self._kinds[key] = kind
                    self._labels[key] = dict(m.labels)
        with self._lock:
            self._samples.append((now, changed))
            self._last_tick = now
            self.ticks += 1
        for hook in list(self.on_sample):
            try:
                hook(self, now)
            except Exception:  # a hook must never kill the sampler
                pass
        return len(changed)

    # -- series reconstruction -----------------------------------------------
    def _matching(self, name: str, labels: Dict[str, str]
                  ) -> List[SeriesKey]:
        """Every sampled series of ``name`` whose labels are a superset
        of ``labels`` (Prometheus-style aggregation across the rest)."""
        with self._lock:
            out = []
            for key, lbls in self._labels.items():
                if key[0] != name:
                    continue
                if all(lbls.get(k) == str(v) for k, v in labels.items()):
                    out.append(key)
            return out

    def _value_at(self, key: SeriesKey, t: float) -> Optional[Any]:
        """The series' cumulative value at time ``t`` (value of the last
        sample at or before ``t``, carried or inherited); None when the
        series first appears after ``t`` (→ born-at-zero convention)."""
        val: Optional[Any] = None
        with self._lock:
            for ts, changed in self._samples:
                if ts > t:
                    break
                if key in changed:
                    val = changed[key]
            return val

    def _history_start(self, now: float, window_s: float) -> float:
        """Window start clipped to the retained sample history — ONLY
        for elapsed-time denominators (:meth:`rate`). Baseline lookups
        use the raw window start: a start before the first sample means
        "no baseline" (:meth:`_value_at` returns None → born-at-zero),
        so the first sample's recorded values count INSIDE the window
        rather than becoming its baseline."""
        start = now - window_s
        with self._lock:
            if self._samples:
                start = max(start, self._samples[0][0])
        return start

    # -- windowed queries ----------------------------------------------------
    def increase(self, name: str, window_s: float,
                 now: Optional[float] = None, **labels: str) -> float:
        """Counter delta over the window, summed across matching series
        (``increase("tg_serve_shed_total", 60, model="m")`` aggregates
        every ``reason``)."""
        now = self.clock() if now is None else now
        start = now - window_s
        total = 0.0
        for key in self._matching(name, labels):
            with self._lock:
                v_now = self._last.get(key)
            if v_now is None:
                continue
            if isinstance(v_now, dict):  # histogram: count delta
                v0 = self._value_at(key, start)
                total += v_now["count"] - (v0["count"] if v0 else 0)
            else:
                v0 = self._value_at(key, start)
                total += v_now - (float(v0) if v0 is not None else 0.0)
        return total

    def rate(self, name: str, window_s: float,
             now: Optional[float] = None, **labels: str) -> float:
        """Per-second rate over the window (counter increase / elapsed,
        elapsed clipped to the sampled history)."""
        now = self.clock() if now is None else now
        start = self._history_start(now, window_s)
        elapsed = now - start
        if elapsed <= 0:
            return 0.0
        return self.increase(name, window_s, now=now, **labels) / elapsed

    def window_count(self, name: str, window_s: float,
                     now: Optional[float] = None, **labels: str) -> float:
        """Histogram observation count over the window."""
        return self.increase(name, window_s, now=now, **labels)

    def _delta_sketches(self, name: str, window_s: float, now: float,
                        labels: Dict[str, str]
                        ) -> List[Tuple[StreamingHistogram, float]]:
        start = now - window_s
        out: List[Tuple[StreamingHistogram, float]] = []
        for key in self._matching(name, labels):
            with self._lock:
                v_now = self._last.get(key)
            if not isinstance(v_now, dict):
                continue
            v0 = self._value_at(key, start)
            now_sk = StreamingHistogram.from_state(v_now["state"])
            start_sk = (StreamingHistogram.from_state(v0["state"])
                        if isinstance(v0, dict) else None)
            delta = sketch_delta(now_sk, start_sk)
            out.append((delta, v_now["count"] - (v0["count"] if v0 else 0)))
        return out

    def quantile(self, name: str, q: float, window_s: float,
                 now: Optional[float] = None, **labels: str) -> float:
        """Windowed quantile via SPDT sketch subtraction, merged across
        matching series; NaN when the window holds no observations."""
        now = self.clock() if now is None else now
        deltas = [d for d, _n in
                  self._delta_sketches(name, window_s, now, labels)]
        deltas = [d for d in deltas if d.total > 0]
        if not deltas:
            return float("nan")
        merged = (deltas[0] if len(deltas) == 1
                  else StreamingHistogram.merged(deltas))
        return float(merged.quantile(q))

    def cdf_increase(self, name: str, threshold: float, window_s: float,
                     now: Optional[float] = None, **labels: str) -> float:
        """Estimated number of window observations ≤ ``threshold``
        (cumulative-``Sum`` subtraction, clamped into [0, count delta]) —
        the latency-SLO primitive: observations *over* a target are
        ``window_count - cdf_increase``."""
        now = self.clock() if now is None else now
        start = now - window_s
        total = 0.0
        for key in self._matching(name, labels):
            with self._lock:
                v_now = self._last.get(key)
            if not isinstance(v_now, dict):
                continue
            v0 = self._value_at(key, start)
            now_sk = StreamingHistogram.from_state(v_now["state"])
            below = now_sk.sum(threshold)
            if isinstance(v0, dict):
                below -= StreamingHistogram.from_state(
                    v0["state"]).sum(threshold)
            dcount = v_now["count"] - (v0["count"] if v0 else 0)
            total += min(max(below, 0.0), float(dcount))
        return total

    def gauge_window(self, name: str, window_s: float,
                     now: Optional[float] = None, **labels: str
                     ) -> Dict[str, float]:
        """Gauge over the window: ``{"last", "min", "max"}`` across the
        carried sample points plus the inherited value at window start;
        empty dict when the gauge was never sampled."""
        now = self.clock() if now is None else now
        start = now - window_s
        vals: List[float] = []
        last: Optional[float] = None
        for key in self._matching(name, labels):
            v0 = self._value_at(key, start)
            if v0 is not None and not isinstance(v0, dict):
                vals.append(float(v0))
            with self._lock:
                for ts, changed in self._samples:
                    if start < ts <= now and key in changed:
                        v = changed[key]
                        if not isinstance(v, dict):
                            vals.append(float(v))
                v_last = self._last.get(key)
            if v_last is not None and not isinstance(v_last, dict):
                last = float(v_last)
        if not vals and last is None:
            return {}
        if not vals:
            vals = [last]
        return {"last": last if last is not None else vals[-1],
                "min": min(vals), "max": max(vals)}

    # -- introspection -------------------------------------------------------
    def counter_names(self) -> List[str]:
        with self._lock:
            return sorted({k[0] for k, kind in self._kinds.items()
                           if kind == "counter"})

    def histogram_names(self) -> List[str]:
        with self._lock:
            return sorted({k[0] for k, kind in self._kinds.items()
                           if kind == "histogram"})

    def series_labels(self, name: str) -> List[Dict[str, str]]:
        with self._lock:
            return [dict(lbls) for key, lbls in sorted(self._labels.items())
                    if key[0] == name]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"name": self.name, "samples": len(self._samples),
                    "maxSamples": self.max_samples, "ticks": self.ticks,
                    "everyS": self.every_s, "series": len(self._last),
                    "lastTick": self._last_tick}

    def recent(self, n: int = 16) -> List[Dict[str, Any]]:
        """The last ``n`` samples with their scalar (counter/gauge)
        changes — the compact form post-mortem bundles carry (sketch
        states stay out of bundles; the SLO snapshot already summarizes
        them)."""
        with self._lock:
            tail = list(self._samples)[-n:]
        out = []
        for ts, changed in tail:
            scalars = {f"{k[0]}{{{k[1]}}}": v for k, v in changed.items()
                       if not isinstance(v, dict)}
            hists = {f"{k[0]}{{{k[1]}}}": {"count": v["count"],
                                           "sum": round(v["sum"], 6)}
                     for k, v in changed.items() if isinstance(v, dict)}
            out.append({"ts": ts, "scalars": scalars, "histograms": hists})
        return out


# -- the shared tg-sampler thread (watchdog-scanner lifecycle) ---------------

_LOCK = threading.Lock()
_SOURCES: List[MetricsSampler] = []
_THREAD: Optional[threading.Thread] = None
_WAKE = threading.Event()


def attach(registry: _metrics.MetricsRegistry, name: str = "metrics",
           every_s: Optional[float] = None,
           max_samples_: Optional[int] = None) -> Optional[MetricsSampler]:
    """Register ``registry`` with the shared sampler thread; returns the
    source's :class:`MetricsSampler` (None when ``TG_SAMPLER=0`` — the
    caller must treat a None sampler as "no windowed telemetry"). A
    baseline tick runs immediately so the first window has an anchor."""
    global _THREAD
    if not sampler_enabled():
        return None
    s = MetricsSampler(registry, name=name, every_s=every_s,
                       max_samples_=max_samples_)
    s.tick()
    with _LOCK:
        _SOURCES.append(s)
        if _THREAD is None or not _THREAD.is_alive():
            _THREAD = threading.Thread(target=_run, name="tg-sampler",
                                       daemon=True)
            _THREAD.start()
    return s


def detach(sampler: Optional[MetricsSampler]) -> None:
    """Unregister a source (idempotent); the thread retires when no
    sources remain."""
    if sampler is None:
        return
    with _LOCK:
        if sampler in _SOURCES:
            _SOURCES.remove(sampler)
        _WAKE.set()


def attached() -> List[MetricsSampler]:
    with _LOCK:
        return list(_SOURCES)


def sampler_for(registry: _metrics.MetricsRegistry
                ) -> Optional[MetricsSampler]:
    """The attached sampler snapshotting ``registry`` (exporters use
    this to find windowed series for the registry they render)."""
    with _LOCK:
        for s in _SOURCES:
            if s.registry is registry:
                return s
    return None


def _run() -> None:
    global _THREAD
    while True:
        with _LOCK:
            if not _SOURCES:
                _THREAD = None
                return
            interval = min(s.every_s for s in _SOURCES)
        _WAKE.wait(min(max(interval, 0.02), 5.0))
        _WAKE.clear()
        for s in attached():
            try:
                if s.due():
                    s.tick()
            except Exception:  # pragma: no cover - defensive
                pass


def idle_join(timeout: float = 5.0) -> None:
    """Join the sampler thread once no sources remain (test teardown)."""
    with _LOCK:
        t = _THREAD
        if _SOURCES or t is None:
            return
    _WAKE.set()
    t.join(timeout)


def reset() -> None:
    """Detach every source, retire the thread, and hand enablement back
    to the env (test isolation)."""
    global _enabled_override
    with _LOCK:
        _SOURCES.clear()
        _WAKE.set()
    idle_join()
    _enabled_override = None
