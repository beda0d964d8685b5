"""Fault isolation (counterpart of ``transmogrifai_tpu.robustness``):

* ``faults`` — deterministic fault injection at named sites (the JAX
  package's ``ALL_SITES`` registry, so a schedule written for either
  package means the same in both), and ``SimulatedPreemption``;
* ``policy`` — ``FaultReport``, the train-scoped ``FaultLog`` behind
  ``summary()["faults"]`` and ``RetryPolicy``;
* ``guards`` — the sweep's quarantine of non-finite candidates, the
  refit's finite-params check and ``AllCandidatesFailedError``;
* ``resources`` — ``classify_exhaustion`` (a CUDA out-of-memory error or
  a host ``MemoryError`` as a typed ``ResourceExhaustedError``) and the
  downshift accounting;
* ``watchdog`` — heartbeat hang detection for the feed's threads;
* ``oracles`` — the no-leak and invariant checks as library functions
  (runtimes, fleets, edges, placers, feeds, hearts, refits, fault sites,
  post-mortem bundles, the flight recorder, the ledger, SLO state and the
  histogram engine);
* ``campaign`` — the chaos campaign: seeded multi-fault schedules over
  nine scenario harnesses, the oracles, schedule minimization.
"""
from . import faults  # noqa: F401
from .faults import ALL_SITES, SimulatedPreemption, SiteSpec  # noqa: F401
from .guards import (  # noqa: F401
    AllCandidatesFailedError, params_finite, quarantine_non_finite,
)
from .policy import (  # noqa: F401
    FaultLog, FaultReport, RetryPolicy, is_transient_error,
)
from .resources import (  # noqa: F401
    ResourceExhaustedError, classify_exhaustion, is_resource_exhausted,
)
from .watchdog import Watchdog, WatchdogStallError  # noqa: F401
