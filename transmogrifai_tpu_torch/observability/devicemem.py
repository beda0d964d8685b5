"""Device-memory observatory: predicted vs measured bytes per dispatch.

Device memory is the other scarce serving-path resource (with compiles —
``observability/ledger.py``): a flush that allocates past the device
limit dies as a ``RESOURCE_EXHAUSTED`` mid-dispatch, and until this
module nothing could answer *how many bytes will this flush allocate
before it OOMs?*. The observatory keeps both sides of that question:

* **predicted** — every dispatch site computes the bytes its padded
  program will stage (plan segment shapes × padding bucket —
  ``utils/padding.py`` :func:`~..utils.padding.padded_bytes`; the
  sweep's packed argument blocks; a streaming chunk's packed upload)
  and reports them via :func:`record_dispatch`. Prediction is pure
  shape arithmetic — it works on every backend, CPU included.
* **measured** — where there is a card (``torch.cuda.memory_stats()``;
  the CPU returns nothing), :func:`sample_measured` folds the
  live ``bytes_in_use`` / ``peak_bytes_in_use`` into per-subsystem
  peaks. Graceful no-op when unsupported: predicted stands alone and
  ``measuredSupported`` says so.

The **cost table** is the artifact ROADMAP items 1 (AOT compile store)
and 2 (pre-flight admission control) consume: measured
``(segment fingerprint × padding bucket) → {bytes, compileSeconds,
executeSeconds}``, accumulated by the plan executor per dispatch and
persisted into a ``costs`` section of the model's ``MANIFEST.json`` at
save and warmup time (``persistence.save_model``,
``serving/registry.load`` → :func:`persist_costs`). ``bytes`` is the
measured allocation delta where memory_stats exists, the shape-predicted
bytes otherwise — either way a number admission control can subtract
from the device budget *before* dispatch instead of catch-and-bisect.

Gated series: ``tg_device_mem_predicted_bytes{subsystem}`` (gauge, last
dispatch), ``tg_device_mem_predicted_peak_bytes{subsystem}`` and
``tg_device_mem_measured_peak_bytes{subsystem}`` (gauges). All zero-write
when observability is off. State is process-global (:func:`observatory`);
:func:`reset` gives tests a clean slate.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from . import metrics as _obs_metrics

#: manifest ``costs`` section format (bumped on incompatible change;
#: loaders tolerate unknown versions by ignoring the section)
COSTS_VERSION = 1

_stats_supported: Optional[bool] = None


def memory_stats() -> Optional[Dict[str, int]]:
    """The CUDA device's memory stats under the JAX package's keys
    (bytes_in_use / peak_bytes_in_use / bytes_limit / num_allocs), or
    None where there is no card (CPU) — the graceful-no-op contract every
    caller leans on. ``bytes_in_use`` and ``peak_bytes_in_use`` are the
    caching allocator's ``allocated_bytes.all.current`` and ``.peak``,
    ``bytes_limit`` the card's total from ``torch.cuda.mem_get_info()``.
    The support probe is cached: once a process says no, later
    dispatches pay one flag check."""
    global _stats_supported
    if _stats_supported is False:
        return None
    try:
        import torch
        if not torch.cuda.is_available():
            stats = None
        else:
            raw = torch.cuda.memory_stats()
            _free, total = torch.cuda.mem_get_info()
            stats = {
                "bytes_in_use": raw.get("allocated_bytes.all.current", 0),
                "peak_bytes_in_use": raw.get("allocated_bytes.all.peak", 0),
                "bytes_limit": total,
                "num_allocs": raw.get("allocation.all.current", 0),
            }
    except Exception:
        stats = None
    if not stats:
        _stats_supported = False
        return None
    _stats_supported = True
    return {k: int(v) for k, v in stats.items()}


class DeviceMemObservatory:
    """Per-subsystem predicted/measured peaks + the measured cost table."""

    def __init__(self):
        self._lock = threading.Lock()
        #: subsystem → {"dispatches", "predictedBytes" (last),
        #: "predictedPeakBytes", "measuredPeakBytes" | None}
        self._subsystems: Dict[str, Dict[str, Any]] = {}
        #: "<segment fingerprint>@<bucket>" → cost row
        self._costs: Dict[str, Dict[str, Any]] = {}

    # -- predicted ------------------------------------------------------------
    def record_dispatch(self, subsystem: str, predicted_bytes: int,
                        bucket: Optional[int] = None,
                        rows: Optional[int] = None) -> None:
        predicted_bytes = int(predicted_bytes)
        with self._lock:
            s = self._subsystems.setdefault(
                subsystem, {"dispatches": 0, "predictedBytes": 0,
                            "predictedPeakBytes": 0,
                            "measuredPeakBytes": None})
            s["dispatches"] += 1
            s["predictedBytes"] = predicted_bytes
            s["predictedPeakBytes"] = max(s["predictedPeakBytes"],
                                          predicted_bytes)
        _obs_metrics.set_gauge(
            "tg_device_mem_predicted_bytes", float(predicted_bytes),
            help="shape-predicted device bytes of the last dispatch "
            "(docs/observability.md)", subsystem=subsystem)
        _obs_metrics.set_gauge(
            "tg_device_mem_predicted_peak_bytes",
            float(self._subsystems[subsystem]["predictedPeakBytes"]),
            help="peak shape-predicted device bytes per dispatch",
            subsystem=subsystem)

    # -- measured -------------------------------------------------------------
    def sample_measured(self, subsystem: str) -> Optional[Dict[str, int]]:
        """Fold the backend's live-buffer stats into the subsystem's
        measured peak; None (and no state change) where unsupported."""
        stats = memory_stats()
        if stats is None:
            return None
        peak = stats.get("peak_bytes_in_use", stats.get("bytes_in_use", 0))
        with self._lock:
            s = self._subsystems.setdefault(
                subsystem, {"dispatches": 0, "predictedBytes": 0,
                            "predictedPeakBytes": 0,
                            "measuredPeakBytes": None})
            prev = s["measuredPeakBytes"] or 0
            s["measuredPeakBytes"] = max(prev, int(peak))
        _obs_metrics.set_gauge(
            "tg_device_mem_measured_peak_bytes",
            float(self._subsystems[subsystem]["measuredPeakBytes"]),
            help="peak measured live device bytes (device.memory_stats; "
            "absent on CPU)", subsystem=subsystem)
        return stats

    # -- cost table -----------------------------------------------------------
    @staticmethod
    def cost_key(fingerprint: str, bucket: int) -> str:
        return f"{fingerprint}@{int(bucket)}"

    def record_cost(self, fingerprint: str, bucket: int, bytes_: int,
                    compile_s: Optional[float] = None,
                    execute_s: Optional[float] = None) -> Dict[str, Any]:
        """Accumulate one dispatch into the (fingerprint × bucket) row:
        bytes last-write-wins (shapes are deterministic per bucket),
        compileSeconds records the first (compile-bearing) dispatch,
        executeSeconds keeps the minimum warm wall (the steady-state
        number admission control should budget with)."""
        key = self.cost_key(fingerprint, bucket)
        with self._lock:
            row = self._costs.setdefault(
                key, {"fingerprint": fingerprint, "bucket": int(bucket),
                      "bytes": 0, "compileSeconds": None,
                      "executeSeconds": None, "dispatches": 0})
            row["dispatches"] += 1
            row["bytes"] = int(bytes_)
            if compile_s is not None and row["compileSeconds"] is None:
                row["compileSeconds"] = round(float(compile_s), 6)
            if execute_s is not None:
                prev = row["executeSeconds"]
                row["executeSeconds"] = (
                    round(float(execute_s), 6) if prev is None
                    else min(prev, round(float(execute_s), 6)))
            return dict(row)

    def cost_table(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {k: dict(v) for k, v in self._costs.items()}

    def load_costs(self, doc: Any) -> int:
        """Merge a manifest ``costs`` section back in (warm start for the
        table). Tolerant by contract: a corrupt/foreign section loads
        zero rows, never raises — an unreadable cost table must not fail
        a model load."""
        try:
            if not isinstance(doc, dict):
                return 0
            table = doc.get("table")
            if not isinstance(table, dict):
                return 0
            loaded = 0
            with self._lock:
                for key, row in table.items():
                    if not isinstance(row, dict) or "bytes" not in row:
                        continue
                    self._costs.setdefault(str(key), dict(row))
                    loaded += 1
            return loaded
        except Exception:
            return 0

    # -- introspection --------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "measuredSupported": bool(_stats_supported),
                "subsystems": {k: dict(v)
                               for k, v in sorted(self._subsystems.items())},
                "costRows": len(self._costs),
            }

    def peaks(self) -> Dict[str, Any]:
        """``{"predicted": max over subsystems, "measured": ... | None}``
        — the two numbers every bench line reports."""
        with self._lock:
            pred = max((s["predictedPeakBytes"]
                        for s in self._subsystems.values()), default=0)
            meas = [s["measuredPeakBytes"] for s in self._subsystems.values()
                    if s["measuredPeakBytes"] is not None]
            return {"predicted": int(pred),
                    "measured": max(meas) if meas else None}

    def clear(self) -> None:
        with self._lock:
            self._subsystems.clear()
            self._costs.clear()


_OBSERVATORY = DeviceMemObservatory()


def observatory() -> DeviceMemObservatory:
    return _OBSERVATORY


def reset() -> None:
    global _OBSERVATORY
    _OBSERVATORY = DeviceMemObservatory()


# -- hot-path helpers --------------------------------------------------------

def record_dispatch(subsystem: str, predicted_bytes: int,
                    bucket: Optional[int] = None,
                    rows: Optional[int] = None) -> None:
    _OBSERVATORY.record_dispatch(subsystem, predicted_bytes,
                                 bucket=bucket, rows=rows)


def sample_measured(subsystem: str) -> Optional[Dict[str, int]]:
    return _OBSERVATORY.sample_measured(subsystem)


def record_cost(fingerprint: str, bucket: int, bytes_: int,
                compile_s: Optional[float] = None,
                execute_s: Optional[float] = None) -> None:
    _OBSERVATORY.record_cost(fingerprint, bucket, bytes_,
                             compile_s=compile_s, execute_s=execute_s)


# -- manifest persistence ----------------------------------------------------

def costs_manifest_entry() -> Dict[str, Any]:
    """The ``costs`` section written into ``MANIFEST.json``: the process's
    measured cost table (empty table → empty section, the caller skips
    it)."""
    return {"version": COSTS_VERSION, "table": _OBSERVATORY.cost_table()}


def persist_costs(dirpath: str) -> int:
    """Merge the live cost table into ``dirpath``'s manifest ``costs``
    section (warmup-time persistence: ``serving/registry.load`` calls
    this after the warm pass so the warm process's measured costs
    land next to the model). Returns rows persisted; never raises."""
    try:
        from ..manifest import CheckpointManifest
        from ..persistence import FORMAT_VERSION
        table = _OBSERVATORY.cost_table()
        if not table:
            return 0
        manifest, err = CheckpointManifest.load(dirpath, FORMAT_VERSION)
        if err is not None:
            return 0
        merged = dict(manifest.costs.get("table", {})
                      if isinstance(manifest.costs.get("table"), dict)
                      else {})
        merged.update(table)
        manifest.costs = {"version": COSTS_VERSION, "table": merged}
        manifest.save()
        return len(table)
    except Exception:
        return 0
