"""Open-loop synthetic load generator (the JAX package's
``BENCH_MODE=serve`` and ``op serve`` driver), the PyTorch port's copy.

Open-loop means arrivals follow a fixed schedule regardless of how fast
the server answers — the honest way to measure a serving tier, because a
closed-loop driver (wait-for-response-then-send) self-throttles exactly
when the system is overloaded and hides the tail (coordinated omission).
At 2× capacity an open-loop driver keeps offering load, and the runtime
must *shed* — which is precisely the behavior under test.

The generator drives ``ServingRuntime.submit`` at ``rps`` for
``seconds``, then drains, and reports sustained rows/sec, SLO quantiles
(from the runtime's serve-local histograms — enqueue→result, so queueing
delay is included), shed/degraded/quarantine counts, and the breaker
snapshot, with the accounting identity offered = completed + sheds +
submit errors + failed + lost (``accountingOk``). Submit-side failures
(``OverloadError``, injected ``serve.enqueue`` chaos) are counted, never
raised — a load generator that dies on the first shed cannot measure
shedding. The same loop drives any target with the runtime's duck-typed
``submit``/``summary``; the wire driver of the fleet tier waits for
ROADMAP Queue 1 item 8b.
"""
from __future__ import annotations

import time
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Any, Dict, List, Optional

import numpy as np

from ..local.scoring import SCORE_ERROR_KEY
from .runtime import DeadlineExceededError, OverloadError, ServingRuntime

#: how many tail outliers the load report names (per-request correlation
#: ids from the flight recorder; docs/observability.md "Exemplars")
SLOWEST_K = 5


def synthetic_rows(model, n: int, seed: int = 0) -> List[Dict[str, Any]]:
    """``n`` synthetic request rows shaped by the model's raw-feature
    types (the serve-side analog of testkit/random_data.py): numeric kinds
    get gaussians/ints, host kinds get small-vocabulary tokens, ~3% of
    values are missing so the masked paths stay exercised."""
    rng = np.random.RandomState(seed)
    rows: List[Dict[str, Any]] = []
    feats = [(f.name, f.feature_type.column_kind) for f in model.raw_features]
    for _ in range(n):
        row: Dict[str, Any] = {}
        for name, kind in feats:
            if rng.rand() < 0.03:
                row[name] = None
            elif kind == "real":
                row[name] = float(rng.randn())
            elif kind == "binary":
                row[name] = bool(rng.randint(0, 2))
            elif kind in ("integral", "date"):
                row[name] = int(rng.randint(0, 100))
            else:  # text / picklist / map kinds: small shared vocabulary
                row[name] = f"tok{rng.randint(0, 8)}"
        rows.append(row)
    return rows


def _weighted_mix(items: List[Any], seed: int):
    """(names, probabilities, rng) for a weighted ``(name, weight)``
    list (bare names = equal weights) — the shared tenant/model mix
    machinery."""
    pairs = [(t, 1.0) if isinstance(t, str) else (str(t[0]), float(t[1]))
             for t in items]
    total_w = sum(w for _, w in pairs) or 1.0
    names = [t for t, _ in pairs]
    probs = np.asarray([w / total_w for _, w in pairs])
    return names, probs, np.random.RandomState(seed)


def run_open_loop(runtime: ServingRuntime, rows: List[Dict[str, Any]],
                  seconds: float, rps: float,
                  deadline_ms: Optional[float] = None,
                  drain_timeout: float = 30.0,
                  tenants: Optional[List[Any]] = None,
                  tenant_seed: int = 0,
                  models: Optional[List[Any]] = None,
                  model_seed: int = 0) -> Dict[str, Any]:
    """Offer ``rps`` requests/sec for ``seconds`` (cycling through
    ``rows``), drain, and return the load report.

    ``tenants`` turns on the multi-tenant traffic mix: a weighted list
    of ``(tenant name, weight)`` pairs (or bare names, equal weights).
    Each arrival draws its tenant from the mix (deterministic under
    ``tenant_seed``), submits with ``tenant=...`` so the runtime counts
    the per-tenant twin series the SLO budgets read
    (observability/slo.py), and the report grows a per-tenant
    ``tenants`` breakdown with the same accounting buckets.

    ``models`` is the multi-model twin (fleet front doors under
    placement — serving/placement.py): a weighted list of ``(model
    name, weight)`` pairs (or bare names). Each arrival draws its model
    (deterministic under ``model_seed``) and submits with ``model=...``
    so routing/paging is exercised per request; the report grows a
    per-model ``models`` breakdown whose buckets sum to the totals —
    the per-model accounting identity the density bench line and the
    campaign ``density`` scenario assert."""
    if rps <= 0:
        raise ValueError(f"rps must be > 0, got {rps}")
    tenant_names: List[str] = []
    tenant_probs = tenant_rng = None
    if tenants:
        tenant_names, tenant_probs, tenant_rng = _weighted_mix(
            tenants, tenant_seed)
    model_names: List[str] = []
    model_probs = model_rng = None
    if models:
        model_names, model_probs, model_rng = _weighted_mix(
            models, model_seed)

    _BUCKET_KEYS = ("offered", "completed", "quarantined", "shedOverload",
                    "shedDeadline", "shedDisconnect", "submitErrors",
                    "failed", "lost")

    def _tenant_bucket(t):
        return per_tenant.setdefault(t, {k: 0 for k in _BUCKET_KEYS})

    def _model_bucket(m):
        return per_model.setdefault(m, {k: 0 for k in _BUCKET_KEYS})

    per_tenant: Dict[str, Dict[str, int]] = {}
    per_model: Dict[str, Dict[str, int]] = {}
    interval = 1.0 / rps
    start = time.monotonic()
    t_end = start + seconds
    next_at = start
    futures = []
    _done_at: Dict[Any, float] = {}
    offered = shed_submit = submit_errors = 0
    i = 0
    while True:
        now = time.monotonic()
        if now >= t_end:
            break
        # submit every arrival whose schedule time has passed (bursts when
        # the process fell behind — open-loop arrivals do not wait)
        while next_at <= now and next_at < t_end:
            tenant = None
            if tenant_names:
                tenant = tenant_names[int(tenant_rng.choice(
                    len(tenant_names), p=tenant_probs))]
                _tenant_bucket(tenant)["offered"] += 1
            model = None
            if model_names:
                model = model_names[int(model_rng.choice(
                    len(model_names), p=model_probs))]
                _model_bucket(model)["offered"] += 1
            kwargs = {"model": model} if model is not None else {}
            try:
                fut = runtime.submit(rows[i % len(rows)],
                                     deadline_ms=deadline_ms,
                                     tenant=tenant, **kwargs)
                # the runtime stamps each accepted request's
                # flight-recorder correlation id on its future
                # (observability/blackbox.py) — remember it with the
                # submit time, and stamp the RESOLVE time from the
                # future's done callback (drain-side clocks would read
                # the drain walk, not the request), so the tail report
                # can NAME its outliers with honest latencies
                fut.add_done_callback(
                    lambda f: _done_at.setdefault(f, time.monotonic()))
                futures.append((fut, getattr(fut, "tg_corr", None),
                                time.monotonic(), tenant, model))
            except OverloadError:
                # placement refusals subclass OverloadError — a model
                # too big for every replica sheds here, typed
                shed_submit += 1
                if tenant is not None:
                    _tenant_bucket(tenant)["shedOverload"] += 1
                if model is not None:
                    _model_bucket(model)["shedOverload"] += 1
            except Exception:
                # injected serve.enqueue chaos / runtime stopping /
                # unknown model: counted, the generator keeps offering
                submit_errors += 1
                if tenant is not None:
                    _tenant_bucket(tenant)["submitErrors"] += 1
                if model is not None:
                    _model_bucket(model)["submitErrors"] += 1
            offered += 1
            i += 1
            next_at += interval
        time.sleep(min(0.001, max(0.0, next_at - time.monotonic())))
    # drain: every accepted request must resolve (result or typed shed).
    # A future that never resolves inside the drain budget is LOST — the
    # one outcome a serving tier may never produce; the campaign engine
    # and BENCH_MODE=campaign assert lost == 0
    completed = quarantined = shed_deadline = failed = lost = 0
    shed_noreplica = 0
    slowest: List[Dict[str, Any]] = []
    drain_deadline = time.monotonic() + drain_timeout
    for fut, corr, submitted_at, tenant, model in futures:
        buckets = [b for b in (
            _tenant_bucket(tenant) if tenant is not None else None,
            _model_bucket(model) if model is not None else None)
            if b is not None]
        try:
            rec = fut.result(timeout=max(0.1, drain_deadline
                                         - time.monotonic()))
            if SCORE_ERROR_KEY in rec:
                quarantined += 1
                for b in buckets:
                    b["quarantined"] += 1
            completed += 1
            for b in buckets:
                b["completed"] += 1
            slowest.append({"corr": corr, "ms": round(
                (_done_at.get(fut, time.monotonic())
                 - submitted_at) * 1e3, 3)})
        except DeadlineExceededError:
            shed_deadline += 1
            for b in buckets:
                b["shedDeadline"] += 1
        except OverloadError:
            # a fleet front door sheds typed AFTER accept when the
            # failover budget exhausts (replica loss with no survivor)
            # — an accounted shed, distinct from a lost future
            shed_noreplica += 1
            for b in buckets:
                b["shedOverload"] += 1
        except FuturesTimeoutError:
            lost += 1
            for b in buckets:
                b["lost"] += 1
        except Exception:
            failed += 1
            for b in buckets:
                b["failed"] += 1
    # the slowest-K completed requests BY ID: drain-side wall times are
    # an upper bound on the serve latency (the drain loop walks futures in
    # submit order), but the ids are exact — each links to its recorder
    # timeline (blackbox.slice_for) and to the runtime histogram's
    # exemplars, so a bench/chaos soak can name its tail outliers
    slowest.sort(key=lambda d: -d["ms"])
    del slowest[SLOWEST_K:]
    wall = time.monotonic() - start
    summary = runtime.summary()
    lat = summary.get("latency", {}) or {}
    report = {
        "seconds": round(wall, 3),
        "offered": offered,
        "offeredRps": round(offered / wall, 1) if wall else 0.0,
        "completed": completed,
        "rowsPerSec": round(completed / wall, 1) if wall else 0.0,
        "quarantined": quarantined,
        "shedOverload": shed_submit,
        "shedDeadline": shed_deadline,
        "shedNoReplica": shed_noreplica,
        # a connection dropped mid-request over the network edge; the
        # in-process driver has no socket to drop, so always 0 here
        # (the socket driver run_wire_open_loop fills it)
        "shedDisconnect": 0,
        "submitErrors": submit_errors,
        "failed": failed,
        "lost": lost,
        # every offered arrival must land in exactly one bucket — the
        # full-request-accounting invariant, precomputed so callers can
        # assert it without re-deriving the sum (failover retries inside
        # a front door resolve ONE future once, so they cannot inflate
        # `completed`; a post-accept typed shed lands in shedNoReplica)
        "accountingOk": (offered == completed + shed_submit + shed_deadline
                         + shed_noreplica + submit_errors + failed + lost),
        "p50Ms": round(lat.get("p50", float("nan")) * 1e3, 3),
        "p95Ms": round(lat.get("p95", float("nan")) * 1e3, 3),
        "p99Ms": round(lat.get("p99", float("nan")) * 1e3, 3),
        # the slowest-K completed requests, named by correlation id —
        # feed one to blackbox.recorder().slice_for() (or `op doctor`)
        # to replay that request's enqueue→resolve timeline
        "slowestRequests": slowest,
        "degradedRows": summary.get("degradedRows", 0.0),
        "breaker": summary.get("breaker", {}),
        # per-tenant accounting (same buckets as the totals; None
        # without a tenant mix) — the per-tenant-budget tests and the
        # BENCH_MODE=serve tenant line read this
        "tenants": per_tenant or None,
        # per-model accounting twin (None without a model mix) — buckets
        # sum to the totals; the density bench line reads this
        "models": per_model or None,
    }
    # fleet targets: per-replica routing distribution + failover /
    # ejection / kill / scale accounting (docs/serving.md "Replica
    # fleet & front door")
    if hasattr(runtime, "replica_distribution"):
        report["replicas"] = runtime.replica_distribution()
    if hasattr(runtime, "fleet_snapshot"):
        report["fleet"] = runtime.fleet_snapshot()
    return report


def run_wire_open_loop(host: str, port: int, rows: List[Dict[str, Any]],
                       seconds: float, rps: float, **kw: Any
                       ) -> Dict[str, Any]:
    """The real-socket twin of :func:`run_open_loop` in the JAX package,
    against a network edge. The port's fleet tier (``fleet``,
    ``placement``, ``frontdoor``, ``netproto``, ``netedge``,
    ``replica_worker`` and this wire driver) is not ported yet (ROADMAP
    Queue 1 item 8b)."""
    raise NotImplementedError(
        "run_wire_open_loop drives the network edge of the fleet tier, "
        "which the PyTorch port does not have yet (ROADMAP Queue 1 item "
        "8b); drive a ServingRuntime in process with run_open_loop")
