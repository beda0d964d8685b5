"""Deterministic fault injection (counterpart of
``transmogrifai_tpu.robustness.faults``).

Recovery paths are exercised through *named sites* compiled into the
production code (``inject`` / ``poison`` calls). A site is inert unless a
``FaultSpec`` is armed for it, programmatically (``configure`` or the
``injected`` context manager) or through the environment::

    TG_CHAOS=1 TG_FAULTS='{"stream.fold": {"mode": "preempt", "nth": 5}}'

The environment's schedule is read only when ``TG_CHAOS`` is set, so a
stray ``TG_FAULTS`` never arms a site in production. Sites fire on call
counters alone (the Nth..Nth+count-1 matching calls): no clock, no
randomness, so a schedule replays the same faults on every run.

``ALL_SITES`` is the JAX package's registry, name for name, mode for mode
(its ``module`` field names the JAX package's file), so a schedule means
the same in both packages. The port fires every site but one whose module
is not ported yet: ``aot.load`` (the AOT program store, ROADMAP Queue 1
item 10); ``campaign.WAITING_SITES`` names it.
``sites_for_scenario`` lists the sites a campaign scenario exercises.

Modes: ``raise`` (``TransientFaultError``, or ``InjectedFaultError`` with
``transient=False``), ``nan`` (``poison``), ``oom`` (a typed
``ResourceExhaustedError``) and ``preempt`` (``SimulatedPreemption``, a
``BaseException`` that models the process being killed: no ``except
Exception`` recovery path may swallow it).
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

#: chaos gate: the env-driven spec (TG_FAULTS) is honored only when this is
#: set, so fault hooks can never arm themselves in a production process
CHAOS_ENV = "TG_CHAOS"
#: JSON dict {site: spec-dict} (see FaultSpec fields)
SPEC_ENV = "TG_FAULTS"


class TransientFaultError(RuntimeError):
    """Injected error classified transient by RetryPolicy (a stand-in for
    device-transfer hiccups: UNAVAILABLE / DEADLINE_EXCEEDED / link resets)."""


class InjectedFaultError(RuntimeError):
    """Injected error classified fatal (never retried)."""


class SimulatedPreemption(BaseException):
    """A deterministic stand-in for the process being killed (preemption,
    SIGTERM, the OOM killer). Derives from ``BaseException``, like
    ``KeyboardInterrupt``, so no ``except Exception`` handler absorbs it:
    the only recovery is a later ``train(resume=True)``."""


@dataclass
class FaultSpec:
    """One armed site.

    ``mode``: ``"raise"`` (throw from :func:`inject`), ``"nan"`` (poison
    the array passed to :func:`poison`), ``"preempt"`` (throw
    :class:`SimulatedPreemption` — a simulated process kill), or
    ``"oom"`` (throw :class:`~.resources.ResourceExhaustedError` — a
    simulated device/host allocation failure the adaptive downshift
    paths recover from).
    ``nth``/``count``: fire on matching calls nth..nth+count-1 (1-based).
    ``key``: only fire when the call's ``key`` matches (None = any).
    ``index``: nan mode — flat index to poison; None poisons the whole
    array. ``transient``: raise mode — throw :class:`TransientFaultError`
    (retryable) vs :class:`InjectedFaultError`.
    """
    site: str
    mode: str = "raise"
    nth: int = 1
    count: int = 1
    key: Optional[str] = None
    index: Optional[int] = 0
    transient: bool = True


@dataclass(frozen=True)
class SiteSpec:
    """One registered site, as the JAX package registers it.

    ``modes``: the injection modes the site supports. ``module``: the JAX
    package's file that fires it. ``scenarios``: the JAX package's chaos
    campaign scenarios that exercise it. ``recovery``: the promised
    recovery, in prose. ``bit_equal``: whether a run that recovers from
    the fault gives the fault-free run's results bit for bit."""
    name: str
    modes: Tuple[str, ...]
    module: str
    scenarios: Tuple[str, ...]
    recovery: str
    bit_equal: bool = True


def _site(name, modes, module, scenarios, recovery, bit_equal=True):
    return SiteSpec(name, tuple(modes.split("|")), module,
                    tuple(scenarios.split("|")), recovery, bit_equal)


#: the site inventory, the JAX package's entry for entry
ALL_SITES: Dict[str, SiteSpec] = {s.name: s for s in (
    _site("validator.family_fit", "raise", "impl/tuning/validators.py",
          "sweep|train",
          "family quarantined; the other families still race",
          bit_equal=False),
    _site("hist.build", "raise", "histeng/engine.py", "sweep|train",
          "tree family quarantined before its histogram programs "
          "dispatch; the other families still race",
          bit_equal=False),
    _site("validator.fold_metrics", "nan", "impl/tuning/validators.py",
          "sweep|train",
          "poisoned candidates quarantined, sweep continues",
          bit_equal=False),
    _site("selector.refit", "raise", "impl/selector/model_selector.py",
          "train",
          "winner quarantined; next-ranked finite candidate refits",
          bit_equal=False),
    _site("dag.stage_fit", "raise", "dag.py", "train",
          "stage fit retried under the fault policy (transient), else "
          "typed failure"),
    _site("distributed.to_host", "raise", "parallel/distributed.py",
          "sweep|transfer|train",
          "device->host transfer retried (transient); a fatal transfer "
          "fault quarantines the consuming family", bit_equal=False),
    _site("distributed.device_put", "raise", "parallel/distributed.py",
          "transfer|mesh_sweep",
          "host->device placement retried (transient); a fatal placement "
          "fault quarantines the consuming family", bit_equal=False),
    _site("plan.segment_execute", "raise", "plan.py", "train|serve",
          "planned run falls back to eager per-stage dispatch, bit-equal"),
    _site("serve.enqueue", "raise", "serving/runtime.py", "serve",
          "typed error to the one caller; the runtime stays up"),
    _site("serve.flush", "raise", "serving/runtime.py", "serve",
          "batch degrades to the eager per-row path, bit-equal"),
    _site("serve.dispatch", "raise", "serving/runtime.py", "serve",
          "breaker counts the failure; batch degrades eager, bit-equal"),
    _site("serve.complete", "raise", "serving/runtime.py", "serve",
          "pipelined completion-side failure: the breaker counts it "
          "against the dispatching flush; batch degrades eager, "
          "bit-equal (fires only with TG_SERVE_PIPELINE > 1)"),
    _site("stream.read", "raise|preempt", "streaming/feed.py", "stream",
          "error forwards through the queue; preemption resumes "
          "bit-exactly from the last committed chunk"),
    _site("stream.upload", "raise|preempt", "streaming/feed.py", "stream",
          "error forwards through the queue; resume bit-exact"),
    _site("stream.cache", "raise|preempt", "streaming/cache.py", "stream",
          "corrupt/evicted entry falls back to a typed bit-equal "
          "recompute from source; preemption resumes bit-exactly"),
    _site("stream.fold", "raise|preempt", "streaming/trainer.py", "stream",
          "fold retried/resumed from the committed state, bit-exact"),
    _site("drift.fold", "raise", "serving/drift.py", "serve|serve_heal",
          "contained by the runtime fence; zero request impact"),
    _site("drift.verdict", "raise", "serving/drift.py", "serve|serve_heal",
          "contained in the monitor; fold state intact"),
    _site("drift.refit", "raise", "serving/registry.py", "serve_heal",
          "no swap; the old model keeps serving, breaker untouched"),
    _site("oom.plan", "oom", "plan.py", "train|serve",
          "row batch bisects to smaller padding buckets, bit-equal"),
    _site("oom.serve", "oom", "serving/runtime.py", "serve|serve_heal",
          "flush splits down to singletons; zero failed requests, "
          "bit-equal records"),
    _site("oom.stream", "oom", "streaming/feed.py", "stream",
          "chunk row budget halves from the committed-row prefix; prep "
          "folds bit-equal, tree edges within documented tolerance",
          bit_equal=False),
    _site("oom.sweep", "oom", "impl/tuning/validators.py", "sweep|train",
          "packed grid splits and fold metrics merge (identical winner); "
          "exhaustion persisting to a single config quarantines the "
          "family", bit_equal=False),
    _site("fleet.route", "raise", "serving/frontdoor.py", "fleet|density",
          "request fails over to another replica (bounded budget); "
          "typed shed when exhausted — never a lost future"),
    _site("fleet.replica_kill", "raise", "serving/frontdoor.py",
          "fleet|density",
          "replica killed mid-flight; queued requests fail over to "
          "survivors, replica_lost post-mortem dumped, zero lost — "
          "under placement, models whose only warm copy died page in "
          "on a survivor"),
    _site("fleet.probe", "raise", "serving/frontdoor.py", "fleet|density",
          "probe failure counted; consecutive failures eject the "
          "replica, healthy probes readmit it — requests unaffected"),
    _site("aot.load", "raise", "programstore/store.py", "serve_heal",
          "bad AOT artifact falls back to the trace path bit-equally; "
          "typed aot_fallback recorded, ledger build classified "
          "aot-miss — never a request error"),
    _site("net.accept", "raise", "serving/netedge.py", "net",
          "connection dropped at accept as a typed accept_fault shed; "
          "net_accept_refused recorded, nothing submitted, zero lost"),
    _site("net.read", "raise", "serving/netedge.py", "net",
          "read path dies mid-request; peer sees a disconnect, edge "
          "accounts a typed read_fault shed (net_read_shed)"),
    _site("net.write", "raise", "serving/netedge.py", "net",
          "write path dies mid-response after every future resolved; "
          "typed write_fault shed (net_write_shed), never a lost future"),
    _site("place.assign", "raise", "serving/placement.py", "density",
          "model left cold by the bin-pack (place_assign_failed); it "
          "pages in on first demand — zero request impact"),
    _site("place.evict", "raise", "serving/placement.py", "density",
          "eviction skipped (capacity prediction is advisory) with a "
          "typed place_evict_failed; the page-in proceeds anyway"),
    _site("place.pagein", "raise", "serving/placement.py", "density",
          "page-in fails typed (place_pagein_failed); the front door "
          "retries within the bounded failover budget — typed shed "
          "when exhausted, never a lost future"),
    _site("preempt.stage_fit", "preempt", "dag.py", "train|stream",
          "train(resume=True) restores verified stages, bit-exact"),
    _site("preempt.checkpoint_write", "preempt", "persistence.py",
          "train|stream",
          "torn checkpoint detected by manifest; resume refits it"),
    _site("preempt.sweep", "preempt", "impl/tuning/validators.py", "train",
          "persisted sweep state replays bit-exactly on resume"),
    _site("preempt.refit", "preempt", "impl/selector/model_selector.py",
          "train",
          "resume replays the sweep from disk and goes straight to refit"),
)}


def sites_for_scenario(scenario: str) -> List[str]:
    """Registered sites a campaign scenario can exercise (sorted)."""
    return sorted(n for n, s in ALL_SITES.items()
                  if scenario in s.scenarios)


_LOCK = threading.Lock()
_SPECS: Dict[str, FaultSpec] = {}
_CALLS: Dict[str, int] = {}
#: (site, mode) -> times an armed spec applied its fault (raised or
#: poisoned); reset by clear() and configure()
_FIRED: Dict[Tuple[str, str], int] = {}
_ENV_LOADED = False


def _load_env() -> None:
    global _ENV_LOADED
    if _ENV_LOADED:
        return
    _ENV_LOADED = True
    raw = os.environ.get(SPEC_ENV)
    if not raw:
        return
    if not os.environ.get(CHAOS_ENV):
        logger.warning(
            "%s is set but %s is not: ignoring fault-injection spec (sites "
            "stay inert outside chaos runs)", SPEC_ENV, CHAOS_ENV)
        return
    configure(json.loads(raw))


def configure(specs: Dict[str, Dict[str, Any]]) -> None:
    """Arm sites from {site: spec-dict}; resets all call counters."""
    with _LOCK:
        for site, kv in specs.items():
            _SPECS[site] = FaultSpec(site=site, **kv)
        _CALLS.clear()
        _FIRED.clear()


def clear() -> None:
    """Disarm every site and reset counters."""
    with _LOCK:
        _SPECS.clear()
        _CALLS.clear()
        _FIRED.clear()


def fired_counts() -> Dict[str, Dict[str, int]]:
    """{site: {mode: n}} faults applied since the last configure() or
    clear() (a site armed but never fired is absent)."""
    with _LOCK:
        out: Dict[str, Dict[str, int]] = {}
        for (site, mode), n in _FIRED.items():
            out.setdefault(site, {})[mode] = n
        return out


def _record_fired(site: str, mode: str) -> None:
    with _LOCK:
        _FIRED[(site, mode)] = _FIRED.get((site, mode), 0) + 1
    # an applied fault belongs to the incident's timeline: the flight
    # recorder shows it next to the recovery it provoked
    from ..observability import blackbox as _blackbox
    from ..observability import metrics as _obs_metrics
    _blackbox.record("chaos.injection", site=site, mode=mode)
    _obs_metrics.inc_counter(
        "tg_chaos_injections_total",
        help="chaos faults actually applied, by site and mode",
        site=site, mode=mode)


def active_sites() -> List[str]:
    """Names of currently-armed sites (empty in production)."""
    _load_env()
    return sorted(_SPECS)


@contextlib.contextmanager
def injected(specs: Dict[str, Dict[str, Any]]):
    """Arm ``specs`` for the duration of the block, then disarm everything
    (the chaos tests' entry point)."""
    configure(specs)
    try:
        yield
    finally:
        clear()


def _fires(site: str, key: Optional[str]) -> Optional[FaultSpec]:
    spec = _SPECS.get(site)
    if spec is None:
        return None
    if spec.key is not None and key != spec.key:
        return None
    with _LOCK:
        n = _CALLS.get(site, 0) + 1
        _CALLS[site] = n
    if spec.nth <= n < spec.nth + spec.count:
        return spec
    return None


def inject(site: str, key: Optional[str] = None) -> None:
    """Raise the armed fault for ``site`` if its spec fires on this call.
    Inert (one falsy dict check) when nothing is armed."""
    if not _SPECS and _ENV_LOADED:
        return
    _load_env()
    spec = _fires(site, key)
    if spec is None or spec.mode not in ("raise", "preempt", "oom"):
        return
    _record_fired(site, spec.mode)
    if spec.mode == "preempt":
        raise SimulatedPreemption(
            f"simulated preemption at site '{site}'"
            + (f" (key={key})" if key else ""))
    if spec.mode == "oom":
        from .resources import ResourceExhaustedError
        raise ResourceExhaustedError(
            f"injected resource exhaustion at site '{site}'"
            + (f" (key={key})" if key else ""), site=site)
    exc = TransientFaultError if spec.transient else InjectedFaultError
    raise exc(f"injected fault at site '{site}'"
              + (f" (key={key})" if key else ""))


def poison(site: str, arr: np.ndarray, key: Optional[str] = None) -> np.ndarray:
    """Return ``arr`` with NaN poisoning applied if the armed ``nan`` spec
    for ``site`` fires on this call; otherwise return ``arr`` untouched."""
    if not _SPECS and _ENV_LOADED:
        return arr
    _load_env()
    spec = _fires(site, key)
    if spec is None or spec.mode != "nan":
        return arr
    _record_fired(site, spec.mode)
    out = np.array(arr, dtype=np.float64 if arr.dtype.kind != "f"
                   else arr.dtype, copy=True)
    if spec.index is None:
        out[...] = np.nan
    else:
        out.reshape(-1)[spec.index] = np.nan
    return out
