"""Per-stage wall-clock profiling (counterpart of
``transmogrifai_tpu.utils.profiler``): the scheduler times every fit and
transform (``dag.fit_and_transform_dag``), and ``app_metrics`` aggregates
them with the JAX package's keys (the reference's AppMetrics).

``compileCache`` reads the port's compile ledger
(``observability.ledger``: the ``nvcc`` builds and ``ctypes`` loads of the
hand-written kernels, with their causes and subsystems). Its ``hits`` and
``misses`` read 0: they are the JAX package's persistent XLA compile-cache
listener, and PyTorch runs eagerly with no compile cache to listen to; the
keys stay so one reader reads both packages. ``deviceMemory`` is
``observability.devicemem.memory_stats()`` (the card's allocator; absent
on the CPU), ``deviceMemoryPredicted`` the observatory's per-subsystem
predictions.
"""
from __future__ import annotations

import os
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List


def cache_stats() -> Dict[str, int]:
    """The JAX package's compile-cache listener counts: 0 here (module
    docstring)."""
    return {"hits": 0, "misses": 0}


class StageProfiler:
    """Per-stage timings of a fit or a score. The aggregates grow with the
    number of stage classes only; the raw per-op records are a bounded
    ring."""

    def __init__(self, max_records: int = 10_000):
        self.records: deque = deque(maxlen=max_records)
        self.app_start = time.time()
        #: the epoch of the records' span timestamps
        self._epoch = time.perf_counter()
        self._total = 0.0
        self._count = 0
        self._by_stage: Dict[str, float] = {}
        self._by_layer: Dict[str, float] = {}
        self._by_op: Dict[str, float] = {}

    @contextmanager
    def track(self, stage: Any, op: str, layer: int = -1):
        """Time the block as ``op`` ("fit" or "transform") of ``stage``.
        The host clock: a stage's device work is in it where the stage
        waits for its results (every fit does)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            secs = time.perf_counter() - t0
            name = type(stage).__name__
            self.records.append({
                "stage": name, "uid": getattr(stage, "uid", "?"),
                "op": op, "layer": layer, "seconds": secs,
                # microseconds since the profiler was made
                "ts": (t0 - self._epoch) * 1e6})
            self._total += secs
            self._count += 1
            self._by_stage[name] = self._by_stage.get(name, 0.0) + secs
            self._by_op[op] = self._by_op.get(op, 0.0) + secs
            lk = f"layer_{layer}" if layer >= 0 else "unlayered"
            self._by_layer[lk] = self._by_layer.get(lk, 0.0) + secs

    def spans(self) -> List[Dict[str, Any]]:
        """The record ring as Chrome-trace complete events (``ph: "X"``,
        microsecond ``ts`` and ``dur``)."""
        pid = os.getpid()
        return [{"name": f"{r['stage']}.{r['op']}", "ph": "X",
                 "ts": r.get("ts", 0.0), "dur": r["seconds"] * 1e6,
                 "pid": pid, "tid": 0,
                 "args": {"uid": r["uid"], "op": r["op"],
                          "layer": r["layer"]}} for r in self.records]

    def app_metrics(self) -> Dict[str, Any]:
        """The aggregates (from ``track``, not the bounded ring), the
        spans, the compile ledger's counts and the device memory."""
        from ..observability import devicemem as _devicemem
        from ..observability import ledger as _ledger
        led = _ledger.ledger()
        out = {
            "appDurationSecs": time.time() - self.app_start,
            "stageSecondsTotal": self._total,
            "byStage": dict(sorted(self._by_stage.items(),
                                   key=lambda kv: -kv[1])),
            "byOp": dict(self._by_op),
            "byLayer": dict(sorted(self._by_layer.items())),
            "numRecords": self._count,
            "spans": self.spans(),
            "compileCache": {**cache_stats(), "builds": led.total,
                             "byCause": led.counts_by_cause(),
                             "bySubsystem": led.counts()},
        }
        stats = _devicemem.memory_stats()
        if stats:
            out["deviceMemory"] = stats
        out["deviceMemoryPredicted"] = _devicemem.observatory().snapshot()
        return out

    def pretty(self, top_k: int = 15) -> str:
        m = self.app_metrics()
        lines = [f"Stage timings ({m['numRecords']} ops, "
                 f"{m['stageSecondsTotal']:.2f}s total):"]
        for name, secs in list(m["byStage"].items())[:top_k]:
            lines.append(f"  {secs:8.3f}s  {name}")
        return "\n".join(lines)
