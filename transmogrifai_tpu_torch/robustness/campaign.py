"""The chaos campaign (counterpart of ``transmogrifai_tpu.robustness.campaign``):
randomized multi-fault schedules over the site registry, invariant oracles
after every run, and minimization of a failing schedule to a one-command
reproducer.

* **schedules**: a seeded RNG draws fault schedules from
  ``faults.ALL_SITES``: which sites, which modes (``raise``/``nan``/
  ``preempt``/``oom``), which Nth-call triggers. Sites fire on call
  counters, so one seed gives the same fault sequence on every run.
* **scenarios**: each schedule runs against a real harness on the
  campaign's device (the card unless the caller asks for the CPU):
  ``train`` (a checkpointed in-core train, resumed after each
  preemption), ``sweep`` (the CV validator over two linear families and a
  small RF), ``serve`` (a staged serving flush), ``serve_heal`` (registry,
  drift monitor and background refit under shifted traffic), ``stream``
  (an out-of-core train, resumed), ``fleet`` (a two-replica front door),
  ``density`` (three models on two one-warm-slot replicas), ``net`` (the
  network edge over real localhost sockets) and ``transfer`` (the guarded
  host<->device helpers). The served model is a small RF: its records do
  not depend on the flush they ride in, on the CPU as on the card, so
  every completed record can be held to the fault-free run bit for bit.
* **oracles**: bit-equality with the fault-free run wherever the registry
  promises it; request accounting (submitted = completed + shed, no lost
  future); no leaked threads, runtimes, feeds or hearts
  (``oracles.campaign_violations``); checkpoint-manifest integrity;
  typed-error discipline; and no silent divergence (a result may differ
  only when a fired site may alter results and the recovery was
  accounted).
* **minimization**: a violating schedule is delta-debugged to a minimal
  failing fault set and emitted as a reproducer: the ``TG_FAULTS`` JSON
  and the command ``python -m transmogrifai_tpu_torch.cli campaign
  --scenario <s>`` under ``TG_CHAOS=1 TG_FAULTS=...``.

``WAITING_SITES`` are the registered sites whose modules are not ported
yet; the campaign draws no schedule for them, and its coverage is over
every other site.

Env knobs: ``TG_CAMPAIGN_SCHEDULES`` (default budget, 40),
``TG_CAMPAIGN_SEED`` (0), ``TG_CAMPAIGN_COLLECT_TIMEOUT_S`` (serve future
collection budget, 15), ``TG_CAMPAIGN_WORKDIR`` (scratch root; a temporary
directory otherwise).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from concurrent.futures import TimeoutError as _FutureTimeout
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..observability import postmortem as _postmortem
from . import faults, oracles
from .faults import ALL_SITES, SimulatedPreemption, sites_for_scenario
from .policy import FaultLog, RetryPolicy

#: one schedule: {"scenario": <name>, "faults": {site: FaultSpec kwargs}}
Schedule = Dict[str, Any]

#: registered sites whose modules are not ported yet: the AOT program
#: store (``aot.load``, ROADMAP Queue 1 item 10) and the transform-plan
#: compiler (``plan.segment_execute``, ``oom.plan``, item 3)
WAITING_SITES = frozenset({"aot.load", "plan.segment_execute", "oom.plan"})


def campaign_sites() -> List[str]:
    """The registered sites a campaign covers: all but ``WAITING_SITES``."""
    return sorted(s for s in ALL_SITES if s not in WAITING_SITES)


def _host(x) -> np.ndarray:
    """A tensor or array-like as a host numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)

#: fired site -> the FaultLog kind its recovery must record (the
#: accounting half of the no-silent-recovery oracle; checked only where
#: the record reliably lands on the log the scenario observes)
ACCOUNT_KINDS = {
    "serve.flush": "breaker_degraded",
    "serve.dispatch": "breaker_degraded",
    "serve.complete": "breaker_degraded",
    "oom.serve": "oom_downshift",
    "drift.fold": "drift_fold_failed",
    "drift.verdict": "drift_verdict_failed",
    "drift.refit": "drift_refit_failed",
    "fleet.route": "fleet_failover",
    "fleet.replica_kill": "replica_lost",
    "fleet.probe": "fleet_probe_failed",
    "aot.load": "aot_fallback",
    "net.accept": "net_accept_refused",
    "net.read": "net_read_shed",
    "net.write": "net_write_shed",
    "place.assign": "place_assign_failed",
    "place.evict": "place_evict_failed",
    "place.pagein": "place_pagein_failed",
}


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


def _divergence_violations(name: str, equal: bool, fired: Set[str],
                           records: int) -> List[str]:
    """The no-silent-divergence oracle: a completed run's result may
    differ from the fault-free baseline only when (a) some fired site
    legitimately alters results (``bit_equal=False`` in the registry —
    e.g. a quarantine changes selection) and (b) the recovery left fault
    accounting behind. Divergence with only bit-equal-promising sites
    fired — or with empty accounting — is a broken recovery path."""
    if equal:
        return []
    if not fired:
        return [f"{name}: result diverged from the fault-free baseline "
                f"with no fault fired (scenario nondeterminism)"]
    altering = [s for s in fired
                if s in ALL_SITES and not ALL_SITES[s].bit_equal]
    if not altering:
        return [f"{name}: result diverged though every fired site "
                f"({sorted(fired)}) promises bit-equal recovery"]
    if not records:
        return [f"{name}: result diverged with empty fault accounting "
                f"(silent divergence)"]
    return []


class _Scenario:
    """Base scenario: lazy setup (fixtures + fault-free baseline), one
    ``run`` per schedule, and post-run invariant checks."""

    name = "?"

    def __init__(self, engine: "ChaosCampaign"):
        self.engine = engine
        self._ready = False
        self.baseline: Any = None

    def ensure_setup(self) -> None:
        if not self._ready:
            self.setup()
            self._ready = True

    def sites(self) -> List[str]:
        return sites_for_scenario(self.name)

    def setup(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def run(self, log: FaultLog) -> Dict[str, Any]:  # pragma: no cover
        raise NotImplementedError

    def violations(self, result: Dict[str, Any],
                   fired: Dict[str, Dict[str, int]],
                   log: FaultLog) -> List[str]:  # pragma: no cover
        """``fired`` is faults.fired_counts() for the run: {site: {mode:
        n}} of faults actually applied — oracles condition on it (a site
        armed past its call window never fired and promises nothing)."""
        raise NotImplementedError


class _TrainScenario(_Scenario):
    """Checkpointed in-core train (2-family selector sweep + refit) with
    resume-on-preemption; result = the fitted model's scored probe
    records + checkpoint-manifest integrity."""

    name = "train"

    def setup(self) -> None:
        rng = np.random.RandomState(100)
        n = 240
        x1, x2, x3 = rng.randn(n), rng.randn(n), rng.randn(n)
        y = ((x1 + 0.5 * x2 - 0.25 * x3) > 0).astype(float)
        self.data = {"x1": x1, "x2": x2, "x3": x3, "y": y}
        self.probe = [{"x1": float(a), "x2": float(b), "x3": float(c)}
                      for a, b, c in zip(x1[:16], x2[:16], x3[:16])]
        self.baseline = self.run(FaultLog())

    def _build(self):
        from ..dsl import transmogrify
        from ..features import FeatureBuilder
        from ..impl.selector.factories import (
            BinaryClassificationModelSelector)
        from ..workflow import OpWorkflow
        label = FeatureBuilder.RealNN("y").extract_field().as_response()
        feats = [FeatureBuilder.Real(c).extract_field().as_predictor()
                 for c in ("x1", "x2", "x3")]
        checked = transmogrify(feats).sanity_check(label)
        pred = (BinaryClassificationModelSelector.with_cross_validation(
            seed=11,
            models=[("OpLogisticRegression",
                     [{"regParam": 0.01, "elasticNetParam": 0.0},
                      {"regParam": 0.3, "elasticNetParam": 0.5}]),
                    ("OpLinearSVC", [{"regParam": 0.01}])])
            .set_input(label, checked).get_output())
        return (OpWorkflow(device=self.engine.device)
                .set_input_dataset(self.data).set_result_features(pred))

    def run(self, log: FaultLog) -> Dict[str, Any]:
        from ..local.scoring import micro_batch_score_function
        ckpt = tempfile.mkdtemp(dir=self.engine.workdir, prefix="train_")
        try:
            model = None
            # ONE workflow across kill + resume: a real resume re-runs
            # the same script (same stage uids regenerate in the fresh
            # process); in-process that means reusing the wf object, so
            # checkpoint restores actually engage
            wf = (self._build().with_checkpoint_dir(ckpt)
                  .with_fault_policy(self.engine.retry_policy()))
            for attempt in range(4):
                try:
                    model = wf.train(resume=attempt > 0)
                    break
                except SimulatedPreemption:
                    continue  # the kill; "fresh process" resumes
            if model is None:
                raise SimulatedPreemption(
                    "train still preempted after 3 resumes")
            # compare prediction PAYLOADS: stage uids (hence result
            # feature names) regenerate per workflow build, but the
            # fitted numbers must not
            pred = model.result_features[0].name
            records = [rec[pred]
                       for rec in micro_batch_score_function(model)(
                           self.probe)]
            model_log = getattr(model, "_fault_log", None)
            return {"records": records,
                    "faultReports": len(model_log.reports)
                    if model_log else 0,
                    "manifest": self.engine.manifest_problems(ckpt)}
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)

    def violations(self, result, fired, log) -> List[str]:
        out = [f"train: checkpoint manifest: {p}"
               for p in result["manifest"]]
        equal = result["records"] == self.baseline["records"]
        # train() activates the model's own FaultLog, so recovery
        # accounting lands there, not on the engine's ambient log
        out += _divergence_violations("train", equal, set(fired),
                                      result["faultReports"]
                                      + len(log.reports))
        return out


class _SweepScenario(_Scenario):
    """The CV validator alone (3 families — two linear plus a small RF so
    the histogram-engine ``hist.build`` gate is exercised): winner +
    per-family fold metrics compared bit-exactly; quarantines must be
    accounted."""

    name = "sweep"

    def setup(self) -> None:
        import torch

        from ..models import linear, trees  # noqa: F401 - registry
        from ..models.api import MODEL_REGISTRY
        rng = np.random.RandomState(101)
        X = rng.randn(512, 6).astype(np.float32)
        y = (X @ rng.randn(6).astype(np.float32) > 0).astype(np.float32)
        dev = self.engine.device
        self.Xd = torch.as_tensor(X, device=dev)
        self.yd = torch.as_tensor(y, device=dev)
        lr = [{"regParam": r, "elasticNetParam": e}
              for r in (0.01, 0.1) for e in (0.0, 0.5)]
        svc = [{"regParam": 0.01}, {"regParam": 0.1}]
        rf = [{"maxDepth": 2, "minInstancesPerNode": 5,
               "minInfoGain": 0.001, "numTrees": 3,
               "subsamplingRate": 1.0}]
        self.models = [(MODEL_REGISTRY["OpLogisticRegression"], lr),
                       (MODEL_REGISTRY["OpLinearSVC"], svc),
                       (MODEL_REGISTRY["OpRandomForestClassifier"], rf)]
        self.baseline = self.run(FaultLog())

    def run(self, log: FaultLog) -> Dict[str, Any]:
        from ..impl.tuning.validators import OpCrossValidation
        cv = OpCrossValidation(num_folds=2, seed=0)
        best = cv.validate(self.models, self.Xd, self.yd, "binary",
                           "AuROC", True, 2)
        return {
            "winner": (best.family_name,
                       repr(sorted(best.hyper.items())),
                       float(best.metric_value)),
            "folds": [(r.family, _host(r.fold_metrics).tobytes())
                      for r in best.results],
            "quarantined": len(best.quarantined),
        }

    def violations(self, result, fired, log) -> List[str]:
        equal = (result["winner"] == self.baseline["winner"]
                 and result["folds"] == self.baseline["folds"])
        return _divergence_violations("sweep", equal, set(fired),
                                      len(log.reports))


class _ServeScenario(_Scenario):
    """Deterministic staged serving flush: all requests queued before the
    batcher starts, so one flush carries them and every armed serve-side
    fault fires at a reproducible point. Oracles: zero lost futures, full
    accounting, per-row bit-equality for every completed request (every
    serve-pool site promises it), recovery kinds on the serve log."""

    name = "serve"

    def setup(self) -> None:
        from ..local.scoring import micro_batch_score_function
        from ..serving.loadgen import synthetic_rows
        self.model = self.engine.small_model()
        self.rows = synthetic_rows(self.model, 12, seed=55)
        self.baseline = micro_batch_score_function(self.model)(
            list(self.rows))

    def run(self, log: FaultLog) -> Dict[str, Any]:
        from ..serving.drift import (
            DriftBaseline, DriftConfig, DriftMonitor)
        from ..serving.runtime import ServeConfig, ServingRuntime
        monitor = DriftMonitor(DriftBaseline.from_model(self.model),
                               DriftConfig(min_rows=4, every_rows=4))
        # default pipeline_depth (2) so the staged gather/dispatch/
        # complete path is what the campaign hammers (and serve.complete
        # is coverable); depth 1 re-runs are one env knob away
        cfg = ServeConfig(max_batch=16, max_queue=16, max_wait_ms=10.0)
        rt = ServingRuntime(self.model, "campaign", cfg, fault_log=log,
                            drift_monitor=monitor, auto_start=False)
        completed: Dict[int, Dict[str, Any]] = {}
        shed: Dict[int, str] = {}
        failed: Dict[int, str] = {}
        lost: List[int] = []
        cancelled: List[int] = []
        shed_counters: Dict[str, float] = {}
        try:
            pending = []
            for i, row in enumerate(self.rows):
                try:
                    pending.append((i, rt.submit(row)))
                except Exception as e:
                    if isinstance(e, self.engine.typed_escapes()):
                        shed[i] = type(e).__name__
                    else:
                        raise  # untyped submit failure = discipline breach
            if pending:
                # one caller walks away before the batcher starts: the
                # runtime must shed the cancelled future TYPED
                # (reason="cancelled"), never silently vanish it
                ci, cfut = pending[-1]
                if cfut.cancel():
                    cancelled.append(ci)
            rt.start()
            deadline = time.monotonic() + self.engine.collect_timeout
            for i, fut in pending:
                if fut.cancelled():
                    continue  # accounted in the cancelled bucket
                try:
                    completed[i] = fut.result(
                        timeout=max(0.05, deadline - time.monotonic()))
                except _FutureTimeout:
                    lost.append(i)
                except Exception as e:
                    failed[i] = f"{type(e).__name__}: {e}"
            if cancelled:
                # the cancelled request is counted when its flush runs
                # (_shed_expired), which can trail the other futures'
                # resolution by one batcher iteration
                until = time.monotonic() + 2.0
                while (rt.summary()["shed"].get("cancelled", 0.0)
                       < len(cancelled) and time.monotonic() < until):
                    time.sleep(0.01)
            shed_counters = rt.summary()["shed"]
        finally:
            rt.close(drain=False)
        return {"completed": completed, "shed": shed, "failed": failed,
                "lost": lost, "cancelled": cancelled,
                "shedCounters": shed_counters,
                "accounting": {"submitted": len(self.rows),
                               "completed": len(completed),
                               "shed": len(shed), "failed": len(failed),
                               "lost": len(lost),
                               "cancelled": len(cancelled)}}

    def violations(self, result, fired, log) -> List[str]:
        out: List[str] = []
        n = len(self.rows)
        if result["lost"]:
            out.append(f"serve: {len(result['lost'])} request future(s) "
                       f"never resolved (lost): {result['lost']}")
        if result["failed"]:
            out.append(f"serve: request future(s) failed (requests must "
                       f"degrade, never fail): {result['failed']}")
        total = (len(result["completed"]) + len(result["shed"])
                 + len(result["failed"]) + len(result["lost"])
                 + len(result["cancelled"]))
        if total != n:
            out.append(f"serve: request accounting broken: "
                       f"{total} accounted of {n} submitted")
        if result["cancelled"]:
            got = result["shedCounters"].get("cancelled", 0.0)
            if got < len(result["cancelled"]):
                out.append(
                    f"serve: {len(result['cancelled'])} caller-cancelled "
                    f"request(s) but the runtime shed counter saw only "
                    f"{got} (silent cancelled-future drop)")
        mismatched = [i for i, rec in result["completed"].items()
                      if rec != self.baseline[i]]
        if mismatched:
            out.append(f"serve: completed record(s) not bit-equal to the "
                       f"fault-free run: rows {sorted(mismatched)}")
        kinds = {r.kind for r in log.reports}
        for site in fired:
            want = ACCOUNT_KINDS.get(site)
            if want and want not in kinds:
                out.append(f"serve: site {site} fired but recovery kind "
                           f"'{want}' was never recorded")
        if "serve.enqueue" in fired and not result["shed"]:
            out.append("serve: serve.enqueue fired but no submit was "
                       "shed with a typed error")
        return out


class _ServeHealScenario(_Scenario):
    """Registry + drift monitor + background refit under shifted traffic:
    the self-healing loop. With ``drift.refit`` armed the refit must fail
    typed, the OLD model must keep serving, and the breaker must stay
    untouched — even while ``oom.serve`` splits flushes underneath.
    (The JAX package's ``aot.load`` also belongs here; it waits with the
    AOT program store, ``WAITING_SITES``.)"""

    name = "serve_heal"

    def setup(self) -> None:
        from ..local.scoring import micro_batch_score_function
        model = self.engine.small_model()
        # always save fresh: these dirs must be THIS engine's models,
        # even when two engines share a workdir
        self.saved = tempfile.mkdtemp(
            dir=self.engine.workdir, prefix="heal_") + "/model"
        self.refit_path = self.saved + "_refit"
        model.save(self.saved)
        self.engine.small_model(seed=8).save(self.refit_path)
        rng = np.random.RandomState(56)
        names = [f.name for f in model.raw_features]
        self.shifted = [{nm: float(rng.randn() + 6.0) for nm in names}
                        for _ in range(128)]
        self.baseline = micro_batch_score_function(model)(self.shifted)

    def run(self, log: FaultLog) -> Dict[str, Any]:
        from ..serving import ModelRegistry, ServeConfig
        from ..serving.drift import DriftConfig, live_refits
        cfg = ServeConfig(max_batch=32, max_queue=512, max_wait_ms=1.0)
        hook = lambda name, rt, report: self.refit_path  # noqa: E731
        completed: Dict[int, Dict[str, Any]] = {}
        failed: Dict[int, str] = {}
        lost: List[int] = []
        with ModelRegistry(cfg, refit_hook=hook) as reg:
            rt = reg.load("m", self.saved, device=self.engine.device)
            if rt.drift_monitor is not None:
                # tighten the verdict cadence so 128 shifted rows are
                # enough to cross degraded and fire the refit hook
                rt.drift_monitor.config = DriftConfig(min_rows=32,
                                                      every_rows=32)
            pending = [(i, rt.submit(r))
                       for i, r in enumerate(self.shifted)]
            deadline = time.monotonic() + self.engine.collect_timeout
            for i, fut in pending:
                try:
                    completed[i] = fut.result(
                        timeout=max(0.05, deadline - time.monotonic()))
                except _FutureTimeout:
                    lost.append(i)
                except Exception as e:
                    failed[i] = f"{type(e).__name__}: {e}"
            t0 = time.monotonic()
            while live_refits() and time.monotonic() - t0 < 60:
                time.sleep(0.05)
            health = reg.health()
            swapped = reg.runtime("m") is not rt
            kinds = {r.kind for r in rt.fault_log.reports}
            breaker_opens = rt.breaker.snapshot()["opens"]
        return {"completed": completed, "failed": failed, "lost": lost,
                "swapped": swapped, "refits": health["refits"],
                "kinds": kinds, "breakerOpens": breaker_opens,
                "accounting": {"submitted": len(self.shifted),
                               "completed": len(completed), "shed": 0,
                               "failed": len(failed),
                               "lost": len(lost)}}

    def violations(self, result, fired, log) -> List[str]:
        out: List[str] = []
        if result["lost"]:
            out.append(f"serve_heal: {len(result['lost'])} lost "
                       f"request(s)")
        if result["failed"]:
            out.append(f"serve_heal: failed request(s): "
                       f"{result['failed']}")
        mismatched = [i for i, rec in result["completed"].items()
                      if rec != self.baseline[i]]
        if mismatched:
            out.append(f"serve_heal: record(s) not bit-equal to the "
                       f"fault-free run: rows {sorted(mismatched)[:8]}")
        for site in fired:
            want = ACCOUNT_KINDS.get(site)
            if want and want not in result["kinds"]:
                out.append(f"serve_heal: site {site} fired but recovery "
                           f"kind '{want}' was never recorded")
        if "drift.refit" in fired:
            if result["swapped"]:
                out.append("serve_heal: a failed refit must not swap the "
                           "serving model")
            if not any(not r.get("ok") for r in result["refits"]):
                out.append("serve_heal: failed refit missing from "
                           "registry refit history")
            if result["breakerOpens"]:
                out.append("serve_heal: a drift failure must leave the "
                           "breaker untouched")
        elif not result["swapped"]:
            out.append("serve_heal: degraded verdict did not refit + "
                       "hot-swap (self-healing loop broken)")
        return out


class _StreamScenario(_Scenario):
    """Out-of-core train (vectorize → sanity-check → StreamingGBT) with
    per-chunk checkpoints and resume-on-preemption. Prep-fold stats must
    be bit-equal on ANY schedule (monoid invariance); predictions are
    bit-equal except across an ``oom.stream`` downshift (tree quantile
    edges may shift within the documented tolerance)."""

    name = "stream"

    def setup(self) -> None:
        from ..table import Column, FeatureTable
        from ..types import Real, RealNN
        rng = np.random.RandomState(200)
        n, d = 1024, 4
        X = rng.randn(n, d).astype(np.float32)
        mask = rng.rand(n, d) >= 0.05
        y = (np.where(mask, X, 0.0)[:, 0] > 0.3).astype(np.float32)
        cols = {f"x{i}": Column(Real, X[:, i], mask[:, i])
                for i in range(d)}
        cols["y"] = Column(RealNN, y, None)
        self.table = FeatureTable(cols, n)
        self.probe_table = self.table.take(np.arange(64)).drop(["y"])
        self.d = d
        self.baseline = self.run(FaultLog())

    def _pipeline(self):
        from ..dsl import transmogrify
        from ..features import FeatureBuilder
        from ..impl.preparators.sanity_checker import SanityChecker
        from ..streaming import StreamingGBT
        label = FeatureBuilder.RealNN("y").extract_field().as_response()
        feats = [FeatureBuilder.Real(f"x{i}").extract_field()
                 .as_predictor() for i in range(self.d)]
        checked = label.transform_with(SanityChecker(seed=1),
                                       transmogrify(feats))
        return (StreamingGBT(problem="binary", num_trees=1, max_depth=2,
                             n_bins=8, learning_rate=1.0)
                .set_input(label, checked).get_output())

    def run(self, log: FaultLog) -> Dict[str, Any]:
        from ..streaming import TableChunkSource
        from ..workflow import OpWorkflow
        ckpt = tempfile.mkdtemp(dir=self.engine.workdir, prefix="stream_")
        try:
            model = None
            # one wf across kill + resume (see _TrainScenario.run)
            wf = (OpWorkflow(device=self.engine.device)
                  .set_result_features(self._pipeline())
                  .with_checkpoint_dir(ckpt)
                  .with_fault_policy(self.engine.retry_policy()))
            for attempt in range(4):
                try:
                    model = wf.train(
                        stream=TableChunkSource(self.table,
                                                chunk_rows=256),
                        resume=attempt > 0)
                    break
                except SimulatedPreemption:
                    continue
            if model is None:
                raise SimulatedPreemption(
                    "stream train still preempted after 3 resumes")
            rv = [s for s in model.stages
                  if type(s).__name__ == "RealVectorizerModel"][0]
            scored = model.score(table=self.probe_table)
            pred = model.result_features[0].name
            model_log = getattr(model, "_fault_log", None)
            kinds = ({r.kind for r in model_log.reports}
                     if model_log else set())
            return {"fills": _host(rv.fills).tobytes(),
                    "preds": _host(scored[pred].values).astype(np.float64),
                    "faultKinds": kinds,
                    "faultReports": len(model_log.reports)
                    if model_log else 0,
                    "manifest": self.engine.manifest_problems(ckpt)}
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)

    def violations(self, result, fired, log) -> List[str]:
        out = [f"stream: checkpoint manifest: {p}"
               for p in result["manifest"]]
        if result["fills"] != self.baseline["fills"]:
            out.append("stream: prep-fold stats not bit-equal (monoid "
                       "folds must be schedule-invariant)")
        exact = np.array_equal(result["preds"], self.baseline["preds"])
        preempted = any("preempt" in modes for modes in fired.values())
        if "oom.stream" in fired:
            if not np.allclose(result["preds"], self.baseline["preds"],
                               atol=5e-2):
                out.append("stream: downshifted predictions outside the "
                           "documented tolerance")
            # train() activates the model's own FaultLog — the downshift
            # record lands there. When a preemption interleaved, the
            # exhaustion may have hit a run that was killed before (or
            # just after) downshifting: its accounting legitimately died
            # with that run's log, so the check applies only to
            # uninterrupted trains.
            if (not preempted
                    and "oom_downshift" not in result["faultKinds"]):
                out.append("stream: oom.stream fired but no "
                           "oom_downshift was recorded")
        else:
            out += _divergence_violations(
                "stream", exact, set(fired),
                result["faultReports"] + len(log.reports))
        return out


class _FleetScenario(_Scenario):
    """Two-replica front door over one model: every request submitted
    through the fleet, one probe pass (so ``fleet.probe`` can fire), then
    collect. Oracles: the fleet accounting identity — submitted =
    completed + *typed* sheds, zero failed, zero lost futures — holds
    even when ``fleet.replica_kill`` murders a replica mid-schedule; every
    completed record is bit-equal to the fault-free single-process run;
    fired fleet sites leave their recovery kinds on the front door's
    FaultLog (replica_lost / fleet_failover / fleet_probe_failed)."""

    name = "fleet"

    def setup(self) -> None:
        from ..local.scoring import micro_batch_score_function
        from ..serving.loadgen import synthetic_rows
        self.model = self.engine.small_model()
        self.rows = synthetic_rows(self.model, 24, seed=57)
        self.baseline = micro_batch_score_function(self.model)(
            list(self.rows))

    def run(self, log: FaultLog) -> Dict[str, Any]:
        from ..serving.fleet import FleetConfig
        from ..serving.frontdoor import FrontDoor
        from ..serving.runtime import ServeConfig
        cfg = ServeConfig(max_batch=16, max_queue=64, max_wait_ms=10.0)
        fc = FleetConfig(min_replicas=2, max_replicas=2,
                         probe_interval_ms=0.0, probe_failures=1,
                         readmit_probes=1, max_failovers=2,
                         autoscale=False, device=self.engine.device)
        completed: Dict[int, Dict[str, Any]] = {}
        shed: Dict[int, str] = {}
        failed: Dict[int, str] = {}
        lost: List[int] = []
        fd = FrontDoor({"m": self.model}, replicas=2, config=cfg,
                       fleet_config=fc, fault_log=log)
        try:
            pending = []
            for i, row in enumerate(self.rows):
                try:
                    pending.append((i, fd.submit(row)))
                except Exception as e:
                    if isinstance(e, self.engine.typed_escapes()):
                        shed[i] = type(e).__name__
                    else:
                        raise  # untyped submit failure = discipline breach
            # one deterministic probe pass: the ejection ladder (and the
            # fleet.probe site) run exactly once per schedule
            fd.probe_now()
            deadline = time.monotonic() + self.engine.collect_timeout
            for i, fut in pending:
                try:
                    completed[i] = fut.result(
                        timeout=max(0.05, deadline - time.monotonic()))
                except _FutureTimeout:
                    lost.append(i)
                except Exception as e:
                    if isinstance(e, self.engine.typed_escapes()):
                        shed[i] = type(e).__name__
                    else:
                        failed[i] = f"{type(e).__name__}: {e}"
            snapshot = fd.fleet_snapshot()
        finally:
            fd.close(drain=False)
        return {"completed": completed, "shed": shed, "failed": failed,
                "lost": lost, "fleet": snapshot,
                "accounting": {"submitted": len(self.rows),
                               "completed": len(completed),
                               "shed": len(shed), "failed": len(failed),
                               "lost": len(lost)}}

    def violations(self, result, fired, log) -> List[str]:
        out: List[str] = []
        n = len(self.rows)
        if result["lost"]:
            out.append(f"fleet: {len(result['lost'])} request future(s) "
                       f"never resolved (lost): {result['lost']}")
        if result["failed"]:
            out.append(f"fleet: request future(s) failed untyped "
                       f"(requests must complete or shed typed): "
                       f"{result['failed']}")
        total = (len(result["completed"]) + len(result["shed"])
                 + len(result["failed"]) + len(result["lost"]))
        if total != n:
            out.append(f"fleet: request accounting broken: "
                       f"{total} accounted of {n} submitted")
        mismatched = [i for i, rec in result["completed"].items()
                      if rec != self.baseline[i]]
        if mismatched:
            out.append(f"fleet: completed record(s) not bit-equal to the "
                       f"fault-free run: rows {sorted(mismatched)[:8]}")
        kinds = {r.kind for r in log.reports}
        for site in fired:
            want = ACCOUNT_KINDS.get(site)
            if want and want not in kinds:
                out.append(f"fleet: site {site} fired but recovery kind "
                           f"'{want}' was never recorded")
        if ("fleet.replica_kill" in fired
                and not result["fleet"]["kills"]):
            out.append("fleet: fleet.replica_kill fired but the fleet "
                       "snapshot shows no kill")
        return out


class _DensityScenario(_Scenario):
    """Multi-model fleet density: three models packed onto two replicas
    with ONE warm slot each (``PlaceConfig(max_warm=1)``), requests
    round-robined across the models — so every schedule exercises LRU
    eviction, single-flight demand paging, and (when
    ``fleet.replica_kill`` draws in) warm-copy loss with page-in
    recovery on the survivor. Oracles: the fleet accounting identity —
    submitted = completed + *typed* sheds, zero failed, zero lost
    futures — through model mobility; every completed record bit-equal
    to its model's fault-free run; fired ``place.*``/``fleet.*`` sites
    leave their recovery kinds on the front door's FaultLog."""

    name = "density"

    def setup(self) -> None:
        from ..local.scoring import micro_batch_score_function
        from ..serving.loadgen import synthetic_rows
        self.model_names = ("m7", "m8", "m9")
        self.models = {"m7": self.engine.small_model(7),
                       "m8": self.engine.small_model(8),
                       "m9": self.engine.small_model(9)}
        self.rows = {m: synthetic_rows(self.models[m], 6, seed=71 + i)
                     for i, m in enumerate(self.model_names)}
        self.baseline = {
            m: micro_batch_score_function(self.models[m])(
                list(self.rows[m]))
            for m in self.model_names}
        #: interleaved (model, row-index) submit order — maximal paging
        self.order = [(m, j) for j in range(6) for m in self.model_names]

    def run(self, log: FaultLog) -> Dict[str, Any]:
        from ..serving.fleet import FleetConfig
        from ..serving.frontdoor import FrontDoor
        from ..serving.placement import PlaceConfig
        from ..serving.runtime import ServeConfig
        cfg = ServeConfig(max_batch=16, max_queue=64, max_wait_ms=10.0)
        fc = FleetConfig(min_replicas=2, max_replicas=2,
                         probe_interval_ms=0.0, probe_failures=1,
                         readmit_probes=1, max_failovers=2,
                         autoscale=False, device=self.engine.device)
        completed: Dict[Tuple[str, int], Dict[str, Any]] = {}
        shed: Dict[Tuple[str, int], str] = {}
        failed: Dict[Tuple[str, int], str] = {}
        lost: List[Tuple[str, int]] = []
        fd = FrontDoor(dict(self.models), replicas=2, config=cfg,
                       fleet_config=fc, fault_log=log,
                       placement=PlaceConfig(max_warm=1))
        try:
            pending = []
            for m, j in self.order:
                try:
                    pending.append(
                        ((m, j), fd.submit(self.rows[m][j], model=m)))
                except Exception as e:
                    if isinstance(e, self.engine.typed_escapes()):
                        shed[(m, j)] = type(e).__name__
                    else:
                        raise  # untyped submit failure = discipline breach
            fd.probe_now()
            deadline = time.monotonic() + self.engine.collect_timeout
            for key, fut in pending:
                try:
                    completed[key] = fut.result(
                        timeout=max(0.05, deadline - time.monotonic()))
                except _FutureTimeout:
                    lost.append(key)
                except Exception as e:
                    if isinstance(e, self.engine.typed_escapes()):
                        shed[key] = type(e).__name__
                    else:
                        failed[key] = f"{type(e).__name__}: {e}"
            snapshot = fd.fleet_snapshot()
        finally:
            fd.close(drain=False)
        return {"completed": completed, "shed": shed, "failed": failed,
                "lost": lost, "fleet": snapshot,
                "placement": snapshot.get("placement"),
                "accounting": {"submitted": len(self.order),
                               "completed": len(completed),
                               "shed": len(shed), "failed": len(failed),
                               "lost": len(lost)}}

    def violations(self, result, fired, log) -> List[str]:
        out: List[str] = []
        n = len(self.order)
        if result["lost"]:
            out.append(f"density: {len(result['lost'])} request "
                       f"future(s) never resolved (lost): "
                       f"{sorted(result['lost'])[:8]}")
        if result["failed"]:
            out.append(f"density: request future(s) failed untyped "
                       f"(requests must complete or shed typed): "
                       f"{result['failed']}")
        total = (len(result["completed"]) + len(result["shed"])
                 + len(result["failed"]) + len(result["lost"]))
        if total != n:
            out.append(f"density: request accounting broken: "
                       f"{total} accounted of {n} submitted")
        mismatched = [k for k, rec in result["completed"].items()
                      if rec != self.baseline[k[0]][k[1]]]
        if mismatched:
            out.append(f"density: completed record(s) not bit-equal to "
                       f"the fault-free run: {sorted(mismatched)[:8]}")
        kinds = {r.kind for r in log.reports}
        for site in fired:
            want = ACCOUNT_KINDS.get(site)
            if want and want not in kinds:
                out.append(f"density: site {site} fired but recovery "
                           f"kind '{want}' was never recorded")
        pl = result.get("placement") or {}
        if pl.get("inflightPageIns"):
            out.append(f"density: page-in(s) still in flight at "
                       f"snapshot: {pl['inflightPageIns']}")
        if ("fleet.replica_kill" in fired
                and not result["fleet"]["kills"]):
            out.append("density: fleet.replica_kill fired but the fleet "
                       "snapshot shows no kill")
        return out


class _NetScenario(_Scenario):
    """The network edge over one serving runtime: every request crosses
    a real localhost socket (alternating HTTP/JSON and binary framing)
    while ``net.accept``/``net.read``/``net.write`` chaos drops
    connections at each lifecycle stage. Oracles: the wire accounting
    identity — submitted = completed + *typed* sheds (an error status or
    a mid-request disconnect), zero failed (untyped 500s), zero lost
    futures — plus bit-equal completed records vs the fault-free
    in-process run, and fired net sites leaving their recovery kinds on
    the edge's FaultLog (net_accept_refused / net_read_shed /
    net_write_shed)."""

    name = "net"

    def setup(self) -> None:
        from ..local.scoring import micro_batch_score_function
        from ..serving.loadgen import synthetic_rows
        self.model = self.engine.small_model()
        self.rows = synthetic_rows(self.model, 16, seed=61)
        self.baseline = micro_batch_score_function(self.model)(
            list(self.rows))

    def run(self, log: FaultLog) -> Dict[str, Any]:
        import socket as _socket

        from ..serving.netedge import NetEdge
        from ..serving.netproto import WireClient, WireDisconnect
        from ..serving.runtime import ServeConfig, ServingRuntime
        cfg = ServeConfig(max_batch=16, max_queue=64, max_wait_ms=5.0)
        completed: Dict[int, Dict[str, Any]] = {}
        shed: Dict[int, str] = {}
        failed: Dict[int, str] = {}
        lost: List[int] = []
        rt = ServingRuntime(self.model, name="m", config=cfg)
        try:
            with NetEdge(rt, name="net", fault_log=log) as edge:
                host, port = edge.address
                clients = {p: WireClient(
                    host, port, protocol=p,
                    timeout=self.engine.collect_timeout)
                    for p in ("http", "binary")}
                try:
                    for i, row in enumerate(self.rows):
                        cli = clients["binary" if i % 2 else "http"]
                        try:
                            res = cli.request([row])
                        except WireDisconnect:
                            # mid-request disconnect: the typed wire shed
                            # (the future, if submitted, still resolves
                            # inside the runtime — proven by lost == 0)
                            shed[i] = "WireDisconnect"
                            continue
                        except _socket.timeout:
                            lost.append(i)
                            continue
                        if res.status == 200 and res.records:
                            completed[i] = res.records[0]
                        elif res.status >= 500 and res.error == "lost":
                            lost.append(i)
                        elif res.status == 500:
                            failed[i] = f"status 500: {res.error}"
                        else:
                            shed[i] = f"{res.status}:{res.error}"
                finally:
                    for c in clients.values():
                        c.close()
        finally:
            rt.close(drain=False)
        return {"completed": completed, "shed": shed, "failed": failed,
                "lost": lost,
                "accounting": {"submitted": len(self.rows),
                               "completed": len(completed),
                               "shed": len(shed), "failed": len(failed),
                               "lost": len(lost)}}

    def violations(self, result, fired, log) -> List[str]:
        out: List[str] = []
        n = len(self.rows)
        if result["lost"]:
            out.append(f"net: {len(result['lost'])} request(s) never got "
                       f"a response nor a typed shed (lost): "
                       f"{result['lost']}")
        if result["failed"]:
            out.append(f"net: request(s) failed untyped (requests must "
                       f"complete or shed typed): {result['failed']}")
        total = (len(result["completed"]) + len(result["shed"])
                 + len(result["failed"]) + len(result["lost"]))
        if total != n:
            out.append(f"net: request accounting broken: "
                       f"{total} accounted of {n} submitted")
        mismatched = [i for i, rec in result["completed"].items()
                      if rec != self.baseline[i]]
        if mismatched:
            out.append(f"net: completed record(s) not bit-equal to the "
                       f"fault-free run: rows {sorted(mismatched)[:8]}")
        kinds = {r.kind for r in log.reports}
        for site in fired:
            want = ACCOUNT_KINDS.get(site)
            if want and want not in kinds:
                out.append(f"net: site {site} fired but recovery kind "
                           f"'{want}' was never recorded")
        return out


class _TransferScenario(_Scenario):
    """The guarded host<->device transfer helpers alone: a placement and
    a readback through the always-on retry policies must round-trip
    bit-exactly or fail typed."""

    name = "transfer"

    def setup(self) -> None:
        self.x = (np.arange(2048, dtype=np.float32) * 0.5) - 311.0
        self.baseline = self.run(FaultLog())

    def run(self, log: FaultLog) -> Dict[str, Any]:
        from ..parallel.distributed import fetch_to_host, retrying_device_put
        dev = retrying_device_put(self.x, self.engine.device)
        back = fetch_to_host(dev)
        return {"bytes": np.asarray(back, dtype=np.float32).tobytes()}

    def violations(self, result, fired, log) -> List[str]:
        equal = result["bytes"] == self.baseline["bytes"]
        return _divergence_violations("transfer", equal, set(fired),
                                      len(log.reports))


@dataclass
class CampaignReport:
    """One campaign's verdict: per-schedule results (faults armed, faults
    fired, outcome, violations), whole-campaign site coverage, the
    aggregated serve request accounting, and — for any violation — the
    minimized reproducer."""

    seed: int
    results: List[Dict[str, Any]] = field(default_factory=list)
    coverage: Dict[str, int] = field(default_factory=dict)
    uncovered: List[str] = field(default_factory=list)
    violations: List[Dict[str, Any]] = field(default_factory=list)
    minimized: List[Dict[str, Any]] = field(default_factory=list)
    accounting: Dict[str, int] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_json(self) -> Dict[str, Any]:
        covered = sum(1 for n in self.coverage.values() if n)
        return {
            "seed": self.seed,
            "schedules": len(self.results),
            "sites": len(self.coverage),
            "sitesCovered": covered,
            "coveragePct": round(100.0 * covered
                                 / max(1, len(self.coverage)), 1),
            "uncovered": list(self.uncovered),
            "firedBySite": dict(self.coverage),
            "violations": list(self.violations),
            "minimized": list(self.minimized),
            "accounting": dict(self.accounting),
            "results": list(self.results),
        }


class ChaosCampaign:
    """The engine. Typical use::

        eng = ChaosCampaign(seed=7)
        try:
            report = eng.run(count=40)
            assert report.ok and not report.uncovered
        finally:
            eng.close()
    """

    #: scenario draw weights for the randomized (post-coverage) schedules
    SCENARIO_WEIGHTS = (("serve", 0.24), ("train", 0.20), ("sweep", 0.15),
                        ("stream", 0.12), ("fleet", 0.08), ("density", 0.06),
                        ("net", 0.05), ("serve_heal", 0.05),
                        ("transfer", 0.05))
    _SCENARIOS = (_TrainScenario, _SweepScenario, _ServeScenario,
                  _ServeHealScenario, _StreamScenario, _FleetScenario,
                  _DensityScenario, _NetScenario, _TransferScenario)

    def __init__(self, seed: Optional[int] = None,
                 workdir: Optional[str] = None,
                 collect_timeout: Optional[float] = None,
                 scenarios: Optional[Sequence[str]] = None,
                 device=None):
        from ..device import resolve_device
        #: where every scenario trains, serves and transfers (default: the
        #: CUDA device; raises when there is none)
        self.device = resolve_device(device)
        self.seed = (seed if seed is not None
                     else _env_int("TG_CAMPAIGN_SEED", 0))
        self.collect_timeout = (
            collect_timeout if collect_timeout is not None
            else _env_float("TG_CAMPAIGN_COLLECT_TIMEOUT_S", 15.0))
        env_dir = os.environ.get("TG_CAMPAIGN_WORKDIR")
        self._own_workdir = workdir is None and not env_dir
        self.workdir = workdir or env_dir or tempfile.mkdtemp(
            prefix="tg_campaign_")
        os.makedirs(self.workdir, exist_ok=True)
        self.scenarios: Dict[str, _Scenario] = {
            cls.name: cls(self) for cls in self._SCENARIOS
            if scenarios is None or cls.name in scenarios}
        self._models: Dict[int, Any] = {}
        self._typed: Optional[Tuple[type, ...]] = None

    # -- shared fixtures -----------------------------------------------------
    def retry_policy(self) -> RetryPolicy:
        """Fast deterministic retries for the scenario harnesses (the
        chaos itself is counter-driven; backoff sleeps just slow runs)."""
        return RetryPolicy(max_retries=2, base_delay=0.001,
                           max_delay=0.002, jitter=0.0)

    def small_model(self, seed: int = 7):
        """A small fitted binary model shared by the serve scenarios: a
        three-tree RF, whose records do not depend on the flush they ride
        in (module docstring)."""
        if seed not in self._models:
            from ..dsl import transmogrify
            from ..features import FeatureBuilder
            from ..impl.selector.factories import (
                BinaryClassificationModelSelector)
            from ..workflow import OpWorkflow
            rng = np.random.RandomState(seed)
            n, d = 260, 3
            cols = {f"x{i}": rng.randn(n) for i in range(d)}
            y = (sum(cols.values()) > 0).astype(float)
            label = FeatureBuilder.RealNN("y").extract_field().as_response()
            feats = [FeatureBuilder.Real(f"x{i}").extract_field()
                     .as_predictor() for i in range(d)]
            checked = transmogrify(feats).sanity_check(label)
            pred = (BinaryClassificationModelSelector.with_cross_validation(
                seed=seed,
                models=[("OpRandomForestClassifier",
                         [{"maxDepth": 3, "numTrees": 3,
                           "minInstancesPerNode": 1, "minInfoGain": 0.0,
                           "subsamplingRate": 1.0}])])
                .set_input(label, checked).get_output())
            self._models[seed] = (
                OpWorkflow(device=self.device)
                .set_input_dataset({**cols, "y": y})
                .set_result_features(pred).train())
        return self._models[seed]

    def typed_escapes(self) -> Tuple[type, ...]:
        """The documented typed errors allowed to escape a scenario —
        anything else escaping a fenced region is an invariant
        violation (typed-error discipline)."""
        if self._typed is None:
            from ..local.scoring import ScoreSchemaError
            from ..persistence import CorruptModelError
            from ..serving.runtime import ServingError
            from ..streaming.trainer import StreamingNotSupportedError
            from .faults import InjectedFaultError, TransientFaultError
            from .guards import AllCandidatesFailedError
            from .resources import ResourceExhaustedError
            from .watchdog import WatchdogStallError
            self._typed = (TransientFaultError, InjectedFaultError,
                           ResourceExhaustedError, ServingError,
                           AllCandidatesFailedError, WatchdogStallError,
                           StreamingNotSupportedError, CorruptModelError,
                           ScoreSchemaError)
        return self._typed

    def manifest_problems(self, ckpt_dir: str) -> List[str]:
        """Checkpoint-integrity oracle: the manifest must load and every
        completion-recorded file must verify."""
        from ..persistence import FORMAT_VERSION
        from ..manifest import CheckpointManifest
        manifest, err = CheckpointManifest.load(ckpt_dir, FORMAT_VERSION)
        if err is not None and err != "missing":
            return [f"manifest unreadable: {err}"]
        return manifest.verify_recorded()

    # -- schedule generation -------------------------------------------------
    def _spec_for(self, site: str, mode: str, rng,
                  force_first: bool) -> Dict[str, Any]:
        spec: Dict[str, Any] = {
            "mode": mode,
            "nth": 1 if force_first else int(rng.randint(1, 3)),
            "count": 1}
        if mode == "raise":
            spec["transient"] = bool(rng.rand() < 0.7)
            if not force_first:
                spec["count"] = int(rng.randint(1, 3))
        elif mode == "oom":
            # oom.stream halves a 256-row chunk budget; one halving keeps
            # the schedule clear of the TG_OOM_MIN_CHUNK_ROWS floor
            spec["count"] = (1 if site == "oom.stream" or force_first
                             else int(rng.randint(1, 3)))
        elif mode == "nan":
            spec["index"] = 0 if rng.rand() < 0.7 else None
        elif mode == "preempt":
            spec["nth"] = 1 if force_first else int(rng.randint(1, 3))
            spec["count"] = 1  # one kill per armed site; resume recovers
        return spec

    def generate(self, count: int,
                 ensure_coverage: bool = True) -> List[Schedule]:
        """Deterministic schedule list for this engine's seed. With
        ``ensure_coverage`` (default) the list opens with one singleton
        schedule per covered site (every registered site but
        ``WAITING_SITES``), nth=1 so the site fires: 100% coverage by
        construction; randomized multi-site schedules fill the rest of the
        budget."""
        rng = np.random.RandomState(self.seed)
        out: List[Schedule] = []
        available = set(self.scenarios)
        if ensure_coverage:
            for site in campaign_sites():
                spec = ALL_SITES[site]
                scn = next((s for s in spec.scenarios if s in available),
                           None)
                if scn is None:
                    continue
                out.append({"scenario": scn, "faults": {
                    site: self._spec_for(site, spec.modes[0], rng,
                                         force_first=True)}})
        names = [n for n, _ in self.SCENARIO_WEIGHTS if n in available]
        weights = np.array([w for n, w in self.SCENARIO_WEIGHTS
                            if n in available])
        weights = weights / weights.sum()
        while len(out) < count:
            scn = str(names[int(rng.choice(len(names), p=weights))])
            pool = [s for s in sites_for_scenario(scn)
                    if s not in WAITING_SITES]
            if not pool:
                continue
            k = 1 + int(rng.randint(0, min(3, len(pool))))
            sites = [str(s) for s in rng.choice(pool, size=k,
                                                replace=False)]
            # serve-side flushes coalesce (and fleet routing reacts to
            # live queue depths), so only first-call triggers are
            # schedule-deterministic there
            force = scn in ("serve", "serve_heal", "fleet", "net",
                            "density")
            fault_specs = {}
            for s in sorted(sites):
                mode = str(rng.choice(ALL_SITES[s].modes))
                fault_specs[s] = self._spec_for(s, mode, rng,
                                                force_first=force)
            out.append({"scenario": scn, "faults": fault_specs})
        return out

    # -- execution -----------------------------------------------------------
    def run_schedule(self, schedule: Schedule) -> Dict[str, Any]:
        """Arm the schedule, run its scenario, disarm, check every
        invariant oracle. Returns the schedule result record."""
        scn = self.scenarios[schedule["scenario"]]
        scn.ensure_setup()
        log = FaultLog()
        violations: List[str] = []
        outcome = "completed"
        result: Optional[Dict[str, Any]] = None
        fired_raw: Dict[str, Dict[str, int]] = {}
        with faults.injected({k: dict(v)
                              for k, v in schedule["faults"].items()}):
            try:
                with log.activate():
                    result = scn.run(log)
            except SimulatedPreemption as e:
                outcome = "preempted"
                violations.append(
                    f"{scn.name}: preemption escaped unrecovered: {e}")
            except Exception as e:
                outcome = f"raised:{type(e).__name__}"
                if not isinstance(e, self.typed_escapes()):
                    violations.append(
                        f"{scn.name}: untyped {type(e).__name__} escaped "
                        f"a fenced region: {e}")
                # trigger event: an error — typed or not — escaped a
                # campaign scenario; freeze the fault sequence that led
                # to it (rate-limited; observability/postmortem.py)
                _postmortem.trigger(
                    "campaign_escape", fault_log=log,
                    detail={"scenario": scn.name,
                            "error": f"{type(e).__name__}: {e}"[:300],
                            "typed": isinstance(e, self.typed_escapes()),
                            "faults": {k: dict(v) for k, v
                                       in schedule["faults"].items()}})
            finally:
                fired_raw = faults.fired_counts()
        if faults.active_sites():
            violations.append(
                f"sites left armed after clear: {faults.active_sites()}")
            faults.clear()
        violations.extend(oracles.campaign_violations())
        if outcome == "completed" and result is not None:
            violations.extend(scn.violations(result, fired_raw, log))
        return {"scenario": scn.name,
                "faults": {k: dict(v)
                           for k, v in schedule["faults"].items()},
                "fired": fired_raw, "outcome": outcome,
                "violations": violations,
                "accounting": (result or {}).get("accounting")}

    def run(self, count: Optional[int] = None,
            schedules: Optional[List[Schedule]] = None,
            minimize: bool = True) -> CampaignReport:
        """Run a campaign: ``count`` generated schedules (default
        ``TG_CAMPAIGN_SCHEDULES``/40; coverage singletons first), or an
        explicit ``schedules`` list. Violating schedules are delta-debug
        minimized into one-command reproducers when ``minimize``."""
        if schedules is None:
            budget = (count if count is not None
                      else _env_int("TG_CAMPAIGN_SCHEDULES", 40))
            schedules = self.generate(max(budget, 1))
        report = CampaignReport(
            seed=self.seed, coverage={s: 0 for s in campaign_sites()})
        acct = {"submitted": 0, "completed": 0, "shed": 0, "failed": 0,
                "lost": 0, "cancelled": 0}
        for idx, sch in enumerate(schedules):
            res = self.run_schedule(sch)
            res["index"] = idx
            for site, modes in res["fired"].items():
                if site in report.coverage:
                    report.coverage[site] += sum(modes.values())
            if res["accounting"]:
                for k in acct:
                    acct[k] += int(res["accounting"].get(k, 0))
            if res["violations"]:
                entry = {"index": idx, "scenario": res["scenario"],
                         "faults": res["faults"],
                         "violations": res["violations"]}
                if minimize:
                    mini = self.minimize(sch)
                    repro = self.reproducer(sch["scenario"], mini)
                    entry["minimized"] = mini
                    entry["repro"] = repro
                    report.minimized.append(repro)
                # trigger event: an invariant oracle fired — dump the
                # post-mortem bundle AFTER minimization (the probe re-runs
                # would shuffle the ring) and attach its path to the
                # one-command reproducer, so the repro ships with the
                # black-box context of the schedule that found it
                bundle = _postmortem.trigger(
                    "campaign_violation",
                    detail={"scenario": res["scenario"], "index": idx,
                            "violations": res["violations"],
                            "faults": res["faults"],
                            "minimized": entry.get("minimized"),
                            "cmd": (entry.get("repro") or {}).get("cmd")})
                if bundle is not None:
                    entry["postmortem"] = bundle
                    if "repro" in entry:
                        entry["repro"]["postmortem"] = bundle
                report.violations.append(entry)
            res.pop("accounting", None)
            report.results.append(res)
        report.uncovered = sorted(
            s for s, n in report.coverage.items() if n == 0)
        report.accounting = acct
        return report

    # -- minimization + reproducers ------------------------------------------
    def minimize(self, schedule: Schedule) -> Dict[str, Any]:
        """Delta-debug the schedule's fault set to a minimal failing
        subset: greedily drop one site at a time, keeping a drop only
        when the remaining set still violates, until a fixed point. The
        scenarios are deterministic, so every probe re-run replays the
        exact fault sequence — minimization converges instead of
        flaking."""
        fault_specs = dict(schedule["faults"])
        sites = sorted(fault_specs)

        def violates(subset: List[str]) -> bool:
            if not subset:
                return False
            sub = {"scenario": schedule["scenario"],
                   "faults": {s: fault_specs[s] for s in subset}}
            return bool(self.run_schedule(sub)["violations"])

        changed = True
        while changed and len(sites) > 1:
            changed = False
            for s in list(sites):
                rest = [k for k in sites if k != s]
                if violates(rest):
                    sites = rest
                    changed = True
        return {s: fault_specs[s] for s in sites}

    def reproducer(self, scenario: str,
                   fault_specs: Dict[str, Any]) -> Dict[str, Any]:
        """The one-command repro for a (minimized) failing fault set:
        the exact ``TG_FAULTS`` JSON plus the CLI invocation that
        re-runs the single schedule and exits non-zero on violation."""
        blob = json.dumps(fault_specs, sort_keys=True,
                          separators=(",", ":"))
        return {
            "scenario": scenario, "seed": self.seed,
            "faults": fault_specs,
            "env": {"TG_CHAOS": "1", "TG_FAULTS": blob},
            "cmd": (f"TG_CHAOS=1 TG_FAULTS='{blob}' python -m "
                    f"transmogrifai_tpu_torch.cli campaign "
                    f"--scenario {scenario} --seed {self.seed}"),
        }

    def run_repro(self, repro: Dict[str, Any]) -> Dict[str, Any]:
        """Re-run a reproducer emitted by :meth:`reproducer`."""
        return self.run_schedule({"scenario": repro["scenario"],
                                  "faults": repro["faults"]})

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Drop scratch state (scenario checkpoint dirs, saved models)."""
        self._models.clear()
        if self._own_workdir:
            shutil.rmtree(self.workdir, ignore_errors=True)
