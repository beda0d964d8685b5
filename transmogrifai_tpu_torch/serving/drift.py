"""Drift-aware self-healing serving (docs/serving.md "Drift monitoring").

The PyTorch port's copy of the JAX package's ``serving/drift.py``: the same
names, ``TG_DRIFT_*`` knobs, manifest ``drift`` section and verdicts, on the
port's ``filters/distribution``, ``streaming/folds.HistogramFold`` and SPDT
sketch (all host-side numpy; the monitor touches no device).

The RawFeatureFilter already knows how to compare a training distribution
against a scoring distribution — fill rates + JS divergence over streaming
histogram sketches (filters/distribution.py, reference RawFeatureFilter).
But that knowledge is train-time-only: a model served under the runtime
can silently rot as traffic drifts. This module moves the same math
online (ROADMAP item 5; Breck et al., "Data Validation for Machine
Learning"; TFX-style continuous training loops):

* **save time** — :func:`manifest_drift_entry` persists a per-feature
  training baseline under a ``drift`` section in the model's
  ``MANIFEST.json``: one streaming-histogram sketch state + fill rate per
  numeric raw feature (the streaming ``HistogramFold`` monoid state —
  the same fold the out-of-core trainer runs), hash-bin counts per
  text-ish feature.
* **serve time** — a :class:`DriftMonitor`, owned by each registry entry,
  folds every scored micro-batch into the same fold on the batcher
  thread (off the request hot path, post-quarantine), and on a row
  cadence compares against the baseline through the ONE shared
  implementation (``filters.distribution.compare_distributions``):
  ``tg_drift_js_divergence{feature}`` / ``tg_drift_fill_delta{feature}``
  gauges, span events past ``TG_DRIFT_WARN``, and a per-model verdict
  ``ok → drifting → degraded`` surfaced in ``registry.health()``.
* **self-healing** — when the verdict crosses ``TG_DRIFT_REFIT`` the
  registry (when a refit hook is configured) launches a background refit
  (``OpWorkflow.drift_refit_hook`` wraps ``train(resume=...)`` + save),
  then hot-swaps through the existing manifest-verified load + warm
  warm load path. Requests keep flowing on the old model throughout; a
  failed refit degrades gracefully (FaultLog kind ``drift_refit_failed``,
  breaker untouched).

Crash isolation: a drift-path exception can NEVER fail a scoring request
— the runtime fences every monitor call (FaultLog kinds
``drift_fold_failed`` / ``drift_verdict_failed``), and the deterministic
chaos sites ``drift.fold`` / ``drift.verdict`` / ``drift.refit``
(robustness/faults.py) make each failure path testable.

Env knobs (docs/serving.md "Drift monitoring & self-healing"):

==========================  =================================================
``TG_DRIFT``                ``0`` disables monitor auto-attach at
                            ``registry.load`` (default on when the manifest
                            carries a baseline)
``TG_DRIFT_BINS``           histogram bins per numeric feature (64)
``TG_DRIFT_TEXT_BINS``      hash bins per text feature (64)
``TG_DRIFT_WARN``           per-feature JS/fill-delta warn threshold (0.10)
                            — past it the feature counts as *drifting*
``TG_DRIFT_REFIT``          degradation threshold (0.25) — past it the model
                            verdict is *degraded* and the refit hook fires
``TG_DRIFT_EVERY_ROWS``     verdict cadence in folded rows (512)
``TG_DRIFT_MIN_ROWS``       rows folded before the first verdict (256 —
                            below ~256 rows a 64-bin sketch's sampling
                            noise alone reads JS ≈ 0.1, the warn line)
``TG_DRIFT_HISTORY``        verdict history ring size (64)
==========================  =================================================
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..filters.distribution import (
    FeatureDistribution, Summary, _hash_bin, column_distributions,
    compare_distributions, fold_distribution,
)
from ..observability import blackbox as _blackbox
from ..observability import metrics as _obs_metrics
from ..observability import postmortem as _postmortem
from ..observability.trace import add_event as _obs_event
from ..robustness import faults
from ..robustness.policy import FaultLog, FaultReport
from ..streaming.folds import HistogramFold
from ..utils.streaming_histogram import StreamingHistogram

#: per-model drift verdicts, in degradation order
OK, DRIFTING, DEGRADED = "ok", "drifting", "degraded"
#: verdict → ``tg_drift_verdict`` gauge value (0 is healthy, dashboards
#: alert on non-zero — same convention as ``tg_breaker_state``)
VERDICT_GAUGE = {OK: 0.0, DRIFTING: 1.0, DEGRADED: 2.0}
_ORDER = {OK: 0, DRIFTING: 1, DEGRADED: 2}

_FALSY = ("", "0", "false", "False", "no")


def drift_enabled() -> bool:
    """The ``registry.load`` auto-attach gate (``TG_DRIFT``; default on)."""
    return os.environ.get("TG_DRIFT", "1") not in _FALSY


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


@dataclass
class DriftConfig:
    """Monitor knobs; every field has a ``TG_DRIFT_*`` environment
    default (module docstring table)."""
    bins: int = 64
    text_bins: int = 64
    warn: float = 0.10
    refit: float = 0.25
    every_rows: int = 512
    min_rows: int = 256
    history: int = 64

    @classmethod
    def from_env(cls) -> "DriftConfig":
        return cls(
            bins=_env_int("TG_DRIFT_BINS", 64),
            text_bins=_env_int("TG_DRIFT_TEXT_BINS", 64),
            warn=_env_float("TG_DRIFT_WARN", 0.10),
            refit=_env_float("TG_DRIFT_REFIT", 0.25),
            every_rows=_env_int("TG_DRIFT_EVERY_ROWS", 512),
            min_rows=_env_int("TG_DRIFT_MIN_ROWS", 256),
            history=_env_int("TG_DRIFT_HISTORY", 64),
        )


# ---------------------------------------------------------------------------
# Training baseline (save-time)
# ---------------------------------------------------------------------------

class DriftBaseline:
    """Per-feature training distribution snapshot.

    ``features`` maps the feature's full name to a JSON-able entry::

        numeric: {"kind": "numeric", "key": None, "count", "nulls",
                  "sketch": {"maxBins", "centers", "masses",
                             "total", "min", "max"}}
        text:    {"kind": "text", "key": None, "count", "nulls",
                  "counts": [hash-bin counts]}

    Map sub-features round-trip (``key`` set) but are not folded online —
    the monitor compares scalar features only (documented host boundary).
    """

    def __init__(self, features: Dict[str, Dict[str, Any]], rows: int,
                 bins: int, text_bins: int):
        self.features = features
        self.rows = int(rows)
        self.bins = int(bins)
        self.text_bins = int(text_bins)

    # -- construction --------------------------------------------------------
    @classmethod
    def from_model(cls, model, bins: Optional[int] = None,
                   text_bins: Optional[int] = None) -> "DriftBaseline":
        """Sketch the model's training table (the streamed-train probe for
        out-of-core models) over its non-response raw features."""
        table = getattr(model, "train_table", None)
        if table is None:
            raise ValueError(
                "model has no train_table to build a drift baseline from "
                "(models loaded from disk carry their baseline in "
                "MANIFEST.json instead)")
        cfg = DriftConfig.from_env()
        bins = bins or cfg.bins
        text_bins = text_bins or cfg.text_bins
        features: Dict[str, Dict[str, Any]] = {}
        for f in model.raw_features:
            if f.is_response or f.name not in table.column_names:
                continue
            for d in column_distributions(f.name, table[f.name],
                                          bins, text_bins):
                features[d.full_name] = _dist_entry(d)
        return cls(features, table.num_rows, bins, text_bins)

    # -- (de)serialization (the MANIFEST.json ``drift`` section) -------------
    def to_json(self) -> Dict[str, Any]:
        return {"rows": self.rows, "bins": self.bins,
                "textBins": self.text_bins, "features": self.features}

    @classmethod
    def from_json(cls, doc: Dict[str, Any]) -> "DriftBaseline":
        return cls(dict(doc.get("features", {})), doc.get("rows", 0),
                   doc.get("bins", 64), doc.get("textBins", 64))

    # -- distribution views --------------------------------------------------
    def distribution(self, name: str) -> Optional[FeatureDistribution]:
        """The baseline side of a train-vs-score comparison, rebuilt as a
        :class:`FeatureDistribution` (sketch-backed for numeric features),
        so the shared ``compare_distributions`` math applies unchanged."""
        e = self.features.get(name)
        if e is None:
            return None
        if e["kind"] == "numeric":
            sk = e["sketch"]
            sketch = StreamingHistogram.from_state({
                "max_bins": int(sk["maxBins"]),
                "centers": np.asarray(sk["centers"], np.float64),
                "masses": np.asarray(sk["masses"], np.float64),
                "total": float(sk["total"]),
                "min": float(sk["min"]), "max": float(sk["max"])})
            filled = float(e["count"]) - float(e["nulls"])
            return FeatureDistribution(
                name=name, key=e.get("key"), count=float(e["count"]),
                nulls=float(e["nulls"]),
                summary=Summary(sketch.min if filled else np.inf,
                                sketch.max if filled else -np.inf,
                                0.0, filled),
                is_numeric=True, sketch=sketch)
        return FeatureDistribution(
            name=name, key=e.get("key"), count=float(e["count"]),
            nulls=float(e["nulls"]),
            distribution=np.asarray(e["counts"], np.float64),
            is_numeric=False)

    def monitored(self) -> Dict[str, str]:
        """{feature name: kind} for the scalar (non-map-key) features the
        online monitor folds."""
        return {n: e["kind"] for n, e in sorted(self.features.items())
                if e.get("key") is None}


def _dist_entry(d: FeatureDistribution) -> Dict[str, Any]:
    if d.is_numeric and d.sketch is not None:
        st = d.sketch.to_state()
        return {"kind": "numeric", "key": d.key, "count": d.count,
                "nulls": d.nulls,
                "sketch": {"maxBins": int(st["max_bins"]),
                           "centers": np.asarray(st["centers"]).tolist(),
                           "masses": np.asarray(st["masses"]).tolist(),
                           "total": float(st["total"]),
                           "min": float(st["min"]),
                           "max": float(st["max"])}}
    return {"kind": "text", "key": d.key, "count": d.count,
            "nulls": d.nulls,
            "counts": np.asarray(d.distribution).tolist()}


def manifest_drift_entry(model) -> Dict[str, Any]:
    """The ``drift`` section written into the model's ``MANIFEST.json`` at
    save time (persistence.save_model; never fails a save — the caller
    try/excepts exactly like the ``serving`` warm-start entry)."""
    return DriftBaseline.from_model(model).to_json()


# ---------------------------------------------------------------------------
# Online monitor (serve-time)
# ---------------------------------------------------------------------------

class DriftMonitor:
    """Folds scored request rows into per-feature streaming sketches and
    periodically compares them against the training baseline.

    Called exclusively from the runtime's batcher thread (``observe``);
    ``snapshot``/``report`` may run from any thread (one lock). The
    runtime fences every ``observe`` call — an exception here is recorded
    (``drift_fold_failed``) and the batch's requests are entirely
    unaffected; see ``ServingRuntime._drift_observe``.
    """

    def __init__(self, baseline: DriftBaseline,
                 config: Optional[DriftConfig] = None,
                 model_name: str = "model",
                 on_degraded: Optional[Callable[[Dict[str, Any]], None]]
                 = None):
        self.baseline = baseline
        self.config = config or DriftConfig.from_env()
        self.model_name = model_name
        #: fired once per ok/drifting → degraded transition (the registry
        #: wires its refit launcher here)
        self.on_degraded = on_degraded
        self._lock = threading.Lock()
        kinds = baseline.monitored()
        self._numeric = [n for n, k in kinds.items() if k == "numeric"]
        self._text = [n for n, k in kinds.items() if k == "text"]
        self._fold = HistogramFold(len(self._numeric),
                                   max_bins=self.config.bins)
        self._state = self._fold.zero()
        #: raw (values, mask) blocks awaiting a sketch fold — the hot
        #: path only gathers request values into numpy blocks (cheap);
        #: the per-column sketch update + compaction amortizes over
        #: ``every_rows``-sized batches instead of running per flush
        #: (the ≤5% serve-overhead budget, docs/benchmarks.md)
        self._pending: List[Any] = []
        self._pending_rows = 0
        self._text_counts = {
            n: np.zeros(len(baseline.features[n]["counts"]), np.float64)
            for n in self._text}
        self._text_nulls = {n: 0 for n in self._text}
        self._text_rows = 0
        self._rows = 0
        self._rows_at_verdict = 0
        self._verdict = OK
        self._features: Dict[str, Dict[str, float]] = {}
        self._history: deque = deque(maxlen=self.config.history)
        self._verdict_errors = 0
        self.fold_errors = 0      # incremented by the runtime's fence
        #: bound by the owning runtime (serve-local instruments + log)
        self._metrics: Optional[_obs_metrics.MetricsRegistry] = None
        self._fault_log: Optional[FaultLog] = None

    # -- runtime wiring ------------------------------------------------------
    def bind(self, model_name: str, metrics: _obs_metrics.MetricsRegistry,
             fault_log: FaultLog) -> None:
        self.model_name = model_name
        self._metrics = metrics
        self._fault_log = fault_log

    # -- folding (batcher thread) --------------------------------------------
    def observe(self, rows: Sequence[Dict[str, Any]]) -> None:
        """Fold one scored micro-batch (post-quarantine rows only — the
        runtime filters). Raises propagate to the runtime's fence, which
        types them ``drift_fold_failed``; a verdict-pass failure is
        contained here and typed ``drift_verdict_failed`` (the fold state
        stays intact either way)."""
        if not rows:
            return
        # deterministic chaos entry: a fault folding the batch
        faults.inject("drift.fold", key=self.model_name)
        with self._lock:
            self._fold_rows(rows)
            due = (self._rows - self._rows_at_verdict
                   >= self.config.every_rows
                   and self._rows >= self.config.min_rows)
        if due:
            try:
                self.run_verdict()
            except Exception as e:
                self._verdict_errors += 1
                self._record_fault("drift.verdict", "drift_verdict_failed", e)

    def _fold_rows(self, rows: Sequence[Dict[str, Any]]) -> None:
        n = len(rows)
        self._rows += n
        if self._numeric:
            d = len(self._numeric)
            V = np.zeros((n, d), np.float64)
            M = np.zeros((n, d), bool)
            for j, name in enumerate(self._numeric):
                vals = [r.get(name) if isinstance(r, dict) else None
                        for r in rows]
                try:
                    # homogeneous numeric fast path (one numpy sweep)
                    col = np.asarray(vals, np.float64)
                    V[:, j] = np.nan_to_num(col)
                    M[:, j] = np.isfinite(col)
                except (TypeError, ValueError):
                    for i, v in enumerate(vals):
                        if v is None or isinstance(v, str):
                            continue
                        try:
                            fv = float(v)
                        except (TypeError, ValueError):
                            continue
                        if np.isfinite(fv):
                            V[i, j] = fv
                            M[i, j] = True
            self._pending.append((V, M))
            self._pending_rows += n
            if self._pending_rows >= self.config.every_rows:
                self._flush_pending()
        for name in self._text:
            counts = self._text_counts[name]
            bins = counts.size
            for r in rows:
                v = r.get(name) if isinstance(r, dict) else None
                if v is None:
                    self._text_nulls[name] += 1
                elif isinstance(v, (list, tuple, set)):
                    for t in v:
                        counts[_hash_bin(str(t), bins)] += 1.0
                else:
                    counts[_hash_bin(str(v), bins)] += 1.0
        self._text_rows += n

    def _flush_pending(self) -> None:
        # lock held by caller
        if not self._pending:
            return
        blocks = self._pending
        self._pending = []
        self._pending_rows = 0
        V = blocks[0][0] if len(blocks) == 1 else np.vstack(
            [b[0] for b in blocks])
        M = blocks[0][1] if len(blocks) == 1 else np.vstack(
            [b[1] for b in blocks])
        self._state = self._fold.accumulate(self._state, V, M)

    # -- verdicts ------------------------------------------------------------
    def run_verdict(self) -> str:
        """Compare the folded scoring distributions against the baseline
        and update the per-model verdict (normally cadence-driven from
        ``observe``; public so tests and the CLI can force a pass)."""
        faults.inject("drift.verdict", key=self.model_name)
        cfg = self.config
        with self._lock:
            self._flush_pending()
            self._rows_at_verdict = self._rows
            per_feature: Dict[str, Dict[str, float]] = {}
            worst = OK
            worst_feature = None
            for j, name in enumerate(self._numeric):
                if not self._rows:
                    continue
                score = fold_distribution(self._fold, self._state, j, name)
                per_feature[name] = self._compare(name, score)
            for name in self._text:
                if not self._text_rows:
                    continue
                score = FeatureDistribution(
                    name=name, count=float(self._text_rows),
                    nulls=float(self._text_nulls[name]),
                    distribution=self._text_counts[name].copy(),
                    is_numeric=False)
                per_feature[name] = self._compare(name, score)
            for name, m in per_feature.items():
                level = max(m["jsDivergence"], m["fillDelta"])
                fv = (DEGRADED if level > cfg.refit
                      else DRIFTING if level > cfg.warn else OK)
                m["verdict"] = fv
                if _ORDER[fv] > _ORDER[worst]:
                    worst, worst_feature = fv, name
                elif worst_feature is None:
                    worst_feature = name
            prev = self._verdict
            self._verdict = worst
            self._features = per_feature
            self._history.append({
                "rows": self._rows, "at": time.time(), "verdict": worst,
                "worstFeature": worst_feature,
                "worst": (max(per_feature[worst_feature]["jsDivergence"],
                              per_feature[worst_feature]["fillDelta"])
                          if worst_feature else 0.0)})
        # instruments outside the lock (snapshot() takes it)
        for name, m in per_feature.items():
            self._gauge("tg_drift_js_divergence", m["jsDivergence"], name,
                        help="per-feature JS divergence of the live "
                        "scoring distribution vs the training baseline "
                        "(docs/serving.md)")
            self._gauge("tg_drift_fill_delta", m["fillDelta"], name,
                        help="per-feature |train fill − score fill| "
                        "(docs/serving.md)")
            if m["verdict"] != OK:
                _obs_event("drift.warn", model=self.model_name,
                           feature=name, js=m["jsDivergence"],
                           fillDelta=m["fillDelta"], verdict=m["verdict"])
        self._gauge("tg_drift_verdict", VERDICT_GAUGE[worst], None,
                    help="per-model drift verdict (0=ok, 1=drifting, "
                    "2=degraded; docs/serving.md)")
        if worst != prev:
            _obs_event("drift.verdict", model=self.model_name,
                       verdict=worst, previous=prev)
            # verdict transitions are flight-recorder events (always on):
            # the drift story must be readable next to the serve events
            # it interleaves with (observability/blackbox.py)
            _blackbox.record("drift.verdict", model=self.model_name,
                             verdict=worst, previous=prev,
                             worstFeature=worst_feature,
                             rows=self._rows)
        if worst == DEGRADED and prev != DEGRADED:
            # trigger event: the model's data went bad — freeze the
            # recorder context + the per-feature comparison while the
            # offending traffic is still in the ring (rate-limited;
            # observability/postmortem.py)
            _postmortem.trigger(
                "drift_degraded", fault_log=self._fault_log,
                metrics=self._metrics,
                detail={"model": self.model_name,
                        "worstFeature": worst_feature, "rows": self._rows},
                state={"drift": {"verdict": worst, "previous": prev,
                                 "features": {n: dict(m) for n, m
                                              in per_feature.items()}}})
            if self.on_degraded is not None:
                try:
                    self.on_degraded(self.report())
                except Exception as e:
                    self._record_fault("drift.refit",
                                       "drift_refit_failed", e)
        return worst

    def _compare(self, name: str, score: FeatureDistribution
                 ) -> Dict[str, float]:
        train = self.baseline.distribution(name)
        if train is None:
            return {"jsDivergence": 0.0, "fillDelta": 0.0,
                    "trainFill": 0.0, "scoreFill": score.fill_fraction()}
        cmp = compare_distributions(train, score, self.baseline.bins)
        return {"jsDivergence": cmp["jsDivergence"],
                "fillDelta": cmp["fillDelta"],
                "trainFill": cmp["trainFill"],
                "scoreFill": cmp["scoreFill"]}

    # -- accounting ----------------------------------------------------------
    def _gauge(self, name: str, v: float, feature: Optional[str],
               help: str = "") -> None:
        labels = {"model": self.model_name}
        if feature is not None:
            labels["feature"] = feature
        if self._metrics is not None:
            self._metrics.gauge(name, help, **labels).set(v)
        _obs_metrics.set_gauge(name, v, help, **labels)

    def _record_fault(self, site: str, kind: str, e: BaseException) -> None:
        report = FaultReport(site=site, kind=kind, detail={
            "model": self.model_name,
            "error": f"{type(e).__name__}: {e}"[:300]})
        if self._fault_log is not None:
            self._fault_log.add(report)
        else:
            FaultLog.record(report)

    # -- introspection -------------------------------------------------------
    def verdict(self) -> str:
        with self._lock:
            return self._verdict

    def snapshot(self) -> Dict[str, Any]:
        """The ``drift`` section of ``runtime.summary()`` /
        ``registry.health()``."""
        with self._lock:
            return {
                "verdict": self._verdict,
                "rows": self._rows,
                "rowsAtVerdict": self._rows_at_verdict,
                "features": {n: dict(m) for n, m in self._features.items()},
                "foldErrors": self.fold_errors,
                "verdictErrors": self._verdict_errors,
            }

    def report(self) -> Dict[str, Any]:
        """Snapshot + verdict history + baseline shape — the refit hook's
        input and the ``op serve`` bundle's drift report."""
        out = self.snapshot()
        with self._lock:
            out["history"] = list(self._history)
        out["baseline"] = {"rows": self.baseline.rows,
                           "bins": self.baseline.bins,
                           "features": sorted(self.baseline.features)}
        out["model"] = self.model_name
        return out


# ---------------------------------------------------------------------------
# Background refit bookkeeping (conftest _no_drift_leak asserts on this)
# ---------------------------------------------------------------------------

_REFIT_LOCK = threading.Lock()
_LIVE_REFITS: List[threading.Thread] = []


def track_refit(thread: threading.Thread) -> None:
    with _REFIT_LOCK:
        _LIVE_REFITS.append(thread)


def untrack_refit(thread: threading.Thread) -> None:
    with _REFIT_LOCK:
        if thread in _LIVE_REFITS:
            _LIVE_REFITS.remove(thread)


def live_refits() -> List[threading.Thread]:
    """Refit threads still running — the conftest no-leak fixture asserts
    this is empty around every test."""
    with _REFIT_LOCK:
        _LIVE_REFITS[:] = [t for t in _LIVE_REFITS if t.is_alive()]
        return list(_LIVE_REFITS)
