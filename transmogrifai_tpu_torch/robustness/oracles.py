"""Callable invariant oracles: the no-leak checks as library functions.

The PyTorch port's copy of the JAX package's ``robustness/oracles.py``:
the same probe names, messages and :data:`THREAD_PREFIXES` (the port's
worker threads carry the JAX package's names), over the port's runtimes,
fleets, network edges, placers, device feeds, watchdog hearts, drift
refits, fault sites, post-mortem bundles, flight recorder, compile ledger,
SLO state and histogram engine. The JAX package's ``programstore`` and
``plan`` cache probes wait for those subsystems (ROADMAP Queue 1 items 10
and 3): :func:`campaign_violations` calls only the probes that exist.

The test fixtures and the chaos-campaign engine need the SAME checks —
"no serving runtime survived", "no feed/watchdog/refit thread is alive",
"no chaos site is still armed" — but a fixture can
only guard one test, while a campaign must run the checks after every one
of hundreds of randomized schedules. So the checks live here once, as
plain functions returning *violation strings* (empty list = clean), and
both consumers call them:

* each ``leaked_*`` probe reports what is live **without touching it**;
* each ``close_leaked_*`` helper force-closes the leftovers and returns
  what it closed — the fixtures use these on exit so one leaky test
  cannot poison the rest of the session, and the campaign uses them so
  one leaky schedule cannot poison the next;
* :func:`campaign_violations` is the aggregate the engine runs after
  every schedule (leaks are *violations*, then cleaned).

Nothing here imports heavyweight modules at import time — each probe
imports its subsystem lazily, so importing the oracles costs nothing.
"""
from __future__ import annotations

import os
import threading
from typing import Iterable, List, Optional

#: thread-name prefixes owned by framework worker threads; anything alive
#: with one of these names after a close/teardown is a leak. ``tg-serve``
#: prefix-matches both the batcher (``tg-serve[<model>]``) and the
#: pipelined completer (``tg-serve-completer[<model>]``), so the no-leak
#: sweep covers the whole serving dataplane automatically. ``tg-stream``
#: prefix-matches the input engine's ordered committer
#: (``tg-stream-feed``) and every producer worker (``tg-stream-w<i>``) —
#: a feed that fails to drain its pool on close shows up here.
THREAD_PREFIXES = ("tg-serve", "tg-stream", "tg-drift-refit", "tg-watchdog",
                   "tg-sampler", "tg-fleet", "tg-net")


# -- probes (read-only) ------------------------------------------------------

def leaked_serving_runtimes() -> List[str]:
    """Names of live (started, unclosed) serving runtimes."""
    from ..serving import runtime as _srt
    return [rt.name for rt in _srt.live_runtimes()]


def leaked_fleets() -> List[str]:
    """Names of live (started, unclosed) fleet front doors — each owns a
    probe thread plus N replica registries' worth of batcher threads."""
    from ..serving import frontdoor as _fd
    return [fd.name for fd in _fd.live_fleets()]


def leaked_net_edges() -> List[str]:
    """Names of live (started, unclosed) network edges — each owns a
    listening socket plus a ``tg-net`` event-loop thread."""
    from ..serving import netedge as _ne
    return [e.name for e in _ne.live_edges()]


def net_violations() -> List[str]:
    """The network-edge no-leak oracle: no listening socket, no
    ``tg-net`` thread, no pending connection task may survive (wired
    into :func:`campaign_violations` and the conftest ``_no_net_leak``
    fixture)."""
    from ..serving import netedge as _ne
    out: List[str] = []
    for e in _ne.live_edges():
        pending = e.pending_tasks()
        out.append(f"network edge '{e.name}' leaked (port "
                   f"{e.bound_port}, {pending} pending connection "
                   f"task(s))")
    return out


def leaked_placers() -> List[str]:
    """Names of live (unclosed) fleet placers — each holds residency
    state plus single-flight page-in events that block waiters."""
    from ..serving import placement as _pl
    return [p.name for p in _pl.live_placers()]


def placement_violations() -> List[str]:
    """The placement no-leak oracle: no placer may outlive its front
    door, and no single-flight page-in may still be in flight (a stuck
    page-in would block every later waiter for that model). Wired into
    :func:`campaign_violations` and the conftest ``_no_placement_leak``
    fixture."""
    from ..serving import placement as _pl
    out: List[str] = []
    for p in _pl.live_placers():
        inflight = p.inflight()
        out.append(f"placer '{p.name}' leaked"
                   + (f" ({len(inflight)} page-in(s) in flight: "
                      f"{sorted(inflight)})" if inflight else ""))
    return out


def leaked_stream_feeds() -> List[str]:
    """repr of open DeviceFeeds."""
    from ..streaming import feed as _feed
    return [f"DeviceFeed#{i}" for i, _ in enumerate(_feed.live_feeds())]


def leaked_watchdog_hearts() -> List[str]:
    """Names of registered (unclosed) watchdog hearts."""
    from . import watchdog as _wd
    return [h.name for h in _wd.live_hearts()]


def leaked_drift_refits() -> List[str]:
    """Names of live background drift-refit threads."""
    from ..serving import drift as _sdrift
    return [t.name for t in _sdrift.live_refits()]


def leaked_threads(prefixes: Iterable[str] = THREAD_PREFIXES) -> List[str]:
    """Live threads whose names carry a framework worker prefix."""
    pfx = tuple(prefixes)
    return [t.name for t in threading.enumerate()
            if t.name.startswith(pfx) and t.is_alive()]


def armed_fault_sites() -> List[str]:
    """Chaos sites still armed (must be empty outside an injection
    context)."""
    from . import faults
    return faults.active_sites()


def stray_postmortem_bundles() -> List[str]:
    """Post-mortem bundle files sitting in the *default* (env-less)
    ``TG_POSTMORTEM_DIR`` — between tests that directory must be empty
    (a test that expects bundles points the env at its own tmp dir, or
    its leftovers are swept by ``clean_postmortem_bundles``). The
    conftest ``_no_blackbox_leak`` fixture's probe."""
    from ..observability import postmortem as _postmortem
    return _postmortem.list_bundles(_postmortem.default_dir())


def clean_postmortem_bundles() -> List[str]:
    """Remove (and return) bundles from the default post-mortem dir —
    trigger events fired by a test are *expected* behavior, but their
    bundles must not accumulate across the session."""
    from ..observability import postmortem as _postmortem
    removed: List[str] = []
    for path in _postmortem.list_bundles(_postmortem.default_dir()):
        try:
            os.remove(path)
            removed.append(path)
        except OSError:
            pass
    return removed


def blackbox_violations() -> List[str]:
    """The flight recorder must stay bounded and no forced enable/disable
    override may linger."""
    from ..observability import blackbox as _blackbox
    out: List[str] = []
    rec = _blackbox.recorder()
    snap = rec.snapshot()
    if snap["events"] > snap["maxEvents"]:
        out.append(f"flight recorder exceeded its ring bound: "
                   f"{snap['events']} > {snap['maxEvents']}")
    if _blackbox._enabled_override is not None:
        out.append("a forced blackbox enable/disable override is active")
    return out


def ledger_violations() -> List[str]:
    """The compile ledger must stay bounded and no forced enable/disable
    override may linger (mirrors ``blackbox_violations``)."""
    from ..observability import ledger as _ledger
    out: List[str] = []
    led = _ledger.ledger()
    snap = led.snapshot()
    if snap["records"] > snap["maxRecords"]:
        out.append(f"compile ledger exceeded its ring bound: "
                   f"{snap['records']} > {snap['maxRecords']}")
    if _ledger._enabled_override is not None:
        out.append("a forced ledger enable/disable override is active")
    return out


def leaked_sampler_sources() -> List[str]:
    """Names of registries still attached to the shared windowed-sampler
    thread (observability/timeseries.py) — every attached source keeps
    the ``tg-sampler`` thread alive and snapshots its registry forever."""
    from ..observability import timeseries as _ts
    return [s.name for s in _ts.attached()]


def registered_slo_specs() -> List[str]:
    """Keys of SLO specs still registered (observability/slo.py) — a spec
    leaked by a test silently changes every later runtime's budgets."""
    from ..observability import slo as _slo
    return [s.key for s in _slo.registered_specs()]


def slo_violations() -> List[str]:
    """Sampler/SLO state that must not outlive a test or a campaign
    schedule: attached sampler sources, registered specs, and a lingering
    forced TG_SAMPLER override (mirrors ``blackbox_violations``)."""
    from ..observability import timeseries as _ts
    out: List[str] = []
    srcs = leaked_sampler_sources()
    if srcs:
        out.append(f"sampler source(s) still attached: {srcs}")
    specs = registered_slo_specs()
    if specs:
        out.append(f"SLO spec(s) still registered: {specs}")
    if _ts._enabled_override is not None:
        out.append("a forced sampler enable/disable override is active")
    return out


def clean_slo_state() -> List[str]:
    """Force-detach sampler sources, drop registered specs, retire the
    tg-sampler thread; returns what was cleaned."""
    from ..observability import slo as _slo
    from ..observability import timeseries as _ts
    cleaned = leaked_sampler_sources() + registered_slo_specs()
    _ts.reset()
    _slo.reset()
    return cleaned


def histeng_violations() -> List[str]:
    """Histogram-engine state that must not outlive a test or campaign
    schedule. The port's engine keeps no mesh context and no factory
    cache (it dispatches straight to its kernels); its one process-wide
    state is the TF32 switch that a full-f32 block turns off and restores
    (``histeng/kernels._tf32_off``). A block still open would leave every
    later matmul of the process at its setting."""
    from .. import histeng
    out: List[str] = []
    probe = histeng.engine_probe()
    if probe["tf32_blocks"]:
        out.append(f"{probe['tf32_blocks']} full-f32 block(s) of the "
                   f"histogram engine still open")
    return out


# -- force-clean helpers (used on exit so one leak cannot cascade) ----------

def close_leaked_serving() -> List[str]:
    from ..serving import runtime as _srt
    leaked = _srt.live_runtimes()
    for rt in leaked:
        rt.close(drain=False)
    return [rt.name for rt in leaked]


def close_leaked_net_edges() -> List[str]:
    """Force-close leftover network edges — closed BEFORE the fleets
    and runtimes they front, so their connection handlers resolve
    (typed ``server_close`` sheds) while the targets still accept."""
    from ..serving import netedge as _ne
    leaked = _ne.live_edges()
    for e in leaked:
        e.close()
    return [e.name for e in leaked]


def close_leaked_fleets() -> List[str]:
    """Force-close leftover front doors (replicas included) — closed
    BEFORE the runtime sweep so a fleet's runtimes are not reported
    twice."""
    from ..serving import frontdoor as _fd
    leaked = _fd.live_fleets()
    for fd in leaked:
        fd.close(drain=False)
    return [fd.name for fd in leaked]


def close_leaked_placers() -> List[str]:
    """Force-close leftover placers (releases any blocked page-in
    waiters) — normally a placer closes with its front door, so anything
    here was detached from a fleet that already leaked."""
    from ..serving import placement as _pl
    leaked = _pl.live_placers()
    for p in leaked:
        p.close()
    return [p.name for p in leaked]


def close_leaked_feeds() -> List[str]:
    from ..streaming import feed as _feed
    leaked = _feed.live_feeds()
    for f in leaked:
        f.close()
    return [f"DeviceFeed#{i}" for i, _ in enumerate(leaked)]


def close_leaked_hearts() -> List[str]:
    """Close leftover hearts and let the shared scanner thread retire."""
    from . import watchdog as _wd
    leaked = _wd.live_hearts()
    for h in leaked:
        h.close()
    _wd.idle_join()
    return [h.name for h in leaked]


def join_drift_refits(timeout: float = 30.0) -> List[str]:
    """Join outstanding refit threads; returns any still alive after."""
    from ..serving import drift as _sdrift
    for t in _sdrift.live_refits():
        t.join(timeout=timeout)
    return [t.name for t in _sdrift.live_refits()]


# -- aggregates --------------------------------------------------------------

def campaign_violations(clean: bool = True,
                        refit_join_timeout: float = 30.0) -> List[str]:
    """The engine's post-schedule invariant sweep: every leak is a
    violation, and (with ``clean=True``, the default) the leftovers are
    force-closed so the NEXT schedule starts from a clean process — a
    campaign reports the first schedule that leaks instead of cascading
    false failures."""
    out: List[str] = []
    still = join_drift_refits(timeout=refit_join_timeout)
    if still:
        out.append(f"drift refit thread(s) outlived the schedule: {still}")
    out.extend(net_violations())
    fds = leaked_fleets()
    if fds:
        out.append(f"fleet front door(s) leaked: {fds}")
    out.extend(placement_violations())
    rts = leaked_serving_runtimes()
    if rts:
        out.append(f"serving runtime(s) leaked: {rts}")
    feeds = leaked_stream_feeds()
    if feeds:
        out.append(f"device feed(s) leaked: {feeds}")
    hearts = leaked_watchdog_hearts()
    if hearts:
        out.append(f"watchdog heart(s) leaked: {hearts}")
    out.extend(slo_violations())
    if clean:
        close_leaked_net_edges()
        close_leaked_fleets()
        close_leaked_placers()
        close_leaked_serving()
        close_leaked_feeds()
        close_leaked_hearts()
        clean_slo_state()
    else:
        from . import watchdog as _wd
        from ..observability import timeseries as _ts
        _wd.idle_join()
        _ts.idle_join()
    threads = leaked_threads()
    if threads:
        out.append(f"worker thread(s) survived: {threads}")
    out.extend(histeng_violations())
    out.extend(blackbox_violations())
    out.extend(ledger_violations())
    return out
