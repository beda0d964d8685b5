"""Fault isolation for the streamed train (counterpart of the parts of
``transmogrifai_tpu.robustness`` that ``OpWorkflow.train(stream=...)``
stands on):

* ``faults`` — deterministic fault injection at named sites (the JAX
  package's ``ALL_SITES`` registry, so a schedule written for either
  package means the same in both), and ``SimulatedPreemption``;
* ``policy`` — ``FaultReport``, the train-scoped ``FaultLog`` behind
  ``summary()["faults"]`` and ``RetryPolicy``;
* ``resources`` — ``classify_exhaustion`` (a CUDA out-of-memory error or
  a host ``MemoryError`` as a typed ``ResourceExhaustedError``) and the
  downshift accounting;
* ``watchdog`` — heartbeat hang detection for the feed's threads;
* ``oracles`` — the no-leak and invariant checks as library functions
  (runtimes, fleets, edges, placers, feeds, hearts, refits, fault sites,
  post-mortem bundles, the flight recorder, the ledger, SLO state and the
  histogram engine).

The JAX package's guards and chaos campaign are not ported (ROADMAP Queue
1 item 9).
"""
from . import faults  # noqa: F401
from .faults import ALL_SITES, SimulatedPreemption, SiteSpec  # noqa: F401
from .policy import (  # noqa: F401
    FaultLog, FaultReport, RetryPolicy, is_transient_error,
)
from .resources import (  # noqa: F401
    ResourceExhaustedError, classify_exhaustion, is_resource_exhausted,
)
from .watchdog import Watchdog, WatchdogStallError  # noqa: F401
