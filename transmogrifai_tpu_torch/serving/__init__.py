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
hot swap.

The fleet tier: a shared-nothing replica fleet (``fleet.py``: in-process
replicas, and subprocess replicas behind ``TG_FLEET_SUBPROCESS``, each on
the fleet's device, the CUDA device unless the caller names another) behind
a :class:`~.frontdoor.FrontDoor` that routes load-aware, ejects sick
replicas, fails requests over on replica loss with zero lost futures,
refuses or splits flushes against ``TG_DEVICE_BUDGET``, rolls deploys and
autoscales; ``placement.py`` bin-packs many models onto few replicas and
pages them in and out; ``netedge.py`` and ``netproto.py`` answer requests
over TCP in HTTP/JSON and the ``TGB1`` binary columnar framing, with the
JAX package's statuses and frames.
"""
from .breaker import BREAKER_GAUGE, CircuitBreaker  # noqa: F401
from .drift import (  # noqa: F401
    DEGRADED, DRIFTING, OK, DriftBaseline, DriftConfig, DriftMonitor,
    drift_enabled, live_refits, manifest_drift_entry,
)
from .fleet import (  # noqa: F401
    AdmissionRefusedError, FleetConfig, Replica, ReplicaLostError,
    ReplicaSpawnError, SubprocessReplica,
)
from .frontdoor import FrontDoor, live_fleets  # noqa: F401
from .loadgen import (  # noqa: F401
    run_open_loop, run_wire_open_loop, synthetic_rows,
)
from .netedge import (  # noqa: F401
    SHED_STATUS, NetEdge, NetEdgeConfig, derive_retry_after, live_edges,
)
from .netproto import (  # noqa: F401
    FrameError, WireClient, WireDisconnect, WireResult,
)
from .placement import (  # noqa: F401
    PlaceConfig, Placer, PlacementRefusedError, UnknownModelError,
    live_placers, model_cost_bytes,
)
from .registry import ModelRegistry  # noqa: F401
from .runtime import (  # noqa: F401
    DeadlineExceededError, OverloadError, RuntimeStoppedError, ServeConfig,
    ServingError, ServingRuntime, live_runtimes,
)
from .warmup import (  # noqa: F401
    manifest_serving_entry, serve_plan_fingerprint, warm_runtime,
)
