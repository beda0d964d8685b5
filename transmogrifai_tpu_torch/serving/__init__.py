"""Resilient serving runtime of the PyTorch port (the JAX package's
``transmogrifai_tpu/serving``, with its names and JSON shapes).

Continuous batching over the micro-batch scorer with backpressure (bounded
queue + typed :class:`OverloadError` shedding), per-request deadlines
(shed before dispatch), a per-model circuit breaker that degrades to the
bit-equal eager path instead of failing requests, a memory-pressure
downshift, a hang watchdog, a pipelined gather / dispatch / complete
dataplane on CUDA streams and events, a multi-model registry with warm
starts, per-model p50/p95/p99 SLO reporting from
``observability/metrics.py``, and drift-aware self-healing (``drift.py``):
online train-vs-score distribution monitoring with a background refit and
hot swap. The fleet tier (replicas, placement, the front door and the
network edge) is not ported yet (ROADMAP Queue 1 item 8b).
"""
from .breaker import BREAKER_GAUGE, CircuitBreaker  # noqa: F401
from .drift import (  # noqa: F401
    DEGRADED, DRIFTING, OK, DriftBaseline, DriftConfig, DriftMonitor,
    drift_enabled, live_refits, manifest_drift_entry,
)
from .loadgen import (  # noqa: F401
    run_open_loop, run_wire_open_loop, synthetic_rows,
)
from .registry import ModelRegistry  # noqa: F401
from .runtime import (  # noqa: F401
    DeadlineExceededError, OverloadError, RuntimeStoppedError, ServeConfig,
    ServingError, ServingRuntime, live_runtimes,
)
from .warmup import (  # noqa: F401
    manifest_serving_entry, serve_plan_fingerprint, warm_runtime,
)
