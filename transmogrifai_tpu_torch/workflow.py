"""Workflows (counterpart of ``transmogrifai_tpu.workflow``): ``OpWorkflow``
trains a feature DAG on a device and returns an ``OpWorkflowModel``, the
fitted workflow that scores on that device (a model also comes from
``persistence.load_model``).

The in-core path: the raw table is built by a reader (``readers``: a CSV
file, or a mapping of columns or list of records given to
``set_input_dataset``), by the JAX package's rules for each feature type,
screened by the raw feature filter when one is attached
(``with_raw_feature_filter``: the excluded raw features leave the DAG),
moved to the device, and every estimator fits layer by layer, or, with
``with_workflow_cv``, the label-dependent stages refit inside every fold of
the selector's cross-validation.

The out-of-core path, ``train(stream=source)`` with a
``streaming.ChunkSource``: the raw table is never materialized; every
estimator fits as chunked float64 folds over a feed that uploads each
chunk to the card and transforms it there (``streaming``). With
``with_checkpoint_dir`` each fitted stage is checkpointed (the JAX
package's format) and each pass's fold state per chunk, so
``train(resume=True, stream=source)`` after a kill at any ``stream.*``
site gives the uninterrupted train's model bit for bit, also from a
directory the JAX package wrote. The raw feature filter, workflow CV and a
mesh are refused there, as in the JAX package.

The in-core train checkpoints too: with ``with_checkpoint_dir`` each
fitted stage is checkpointed as it completes and every selector commits
each family's sweep metrics (``impl.tuning.sweep_checkpoint``), so
``train(resume=True)`` after a kill restores the verified stages, replays
the committed sweep families and fits the rest, to the uninterrupted
train's model bit for bit, also from a directory the JAX package wrote.
``with_fault_policy`` retries a stage fit that fails with a transient
error, and ``with_profiler`` times every stage (``utils.profiler``): both
keep each layer's transforms eager, stage by stage, where a train
otherwise runs them as a plan (``plan.py``); a planned run that fell back
to eager is in ``summary()["faults"]["planFallbacks"]``. Mesh training is
not ported (ROADMAP Queue 1 item 10); it raises.

A fitted model saves and loads in the JAX package's format
(``OpWorkflowModel.save`` / ``load``, ``persistence``). ``summary()`` gives
each stage's summary and, for a model this process trained, the JAX
package's ``faults``, ``resume`` and ``observability`` sections (and
``streaming``, with the feed's and the cache's accounting, for a streamed
train).
"""
from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .dag import apply_transformations_dag, compute_dag, fit_and_transform_dag
from .device import resolve_device, synced_clock
from .features import Feature
from .readers.readers import Frame, FrameReader, Reader, frame_to_table
from .stages.base import AllowLabelAsInput, Estimator
from .table import FeatureTable


def _open_run_sentinel(ckpt_dir: Optional[str], resume: bool):
    """This run's sentinel in the checkpoint directory (None without one).
    On ``resume=True`` a sentinel left by another process records that
    process's ``unclean_exit`` (``oomKillSuspected`` when its last phase
    was device work) before this run takes over."""
    if ckpt_dir is None:
        return None
    from .manifest import RunSentinel
    from .robustness.policy import FaultLog, FaultReport
    sentinel = RunSentinel(ckpt_dir)
    if resume:
        stale = sentinel.read_stale()
        if stale is not None:
            detail = {"pid": stale.get("pid"), "phase": stale.get("phase"),
                      "dir": ckpt_dir,
                      "oomKillSuspected": RunSentinel.suspects_oom_kill(stale)}
            FaultLog.record(FaultReport(
                site="manifest.sentinel", kind="unclean_exit",
                detail=dict(detail)))
            # the earlier owner died mid-run: dump what this process knows
            # before the resume trains over the evidence
            from .observability import postmortem as _postmortem
            _postmortem.trigger("unclean_exit", detail=detail)
    sentinel.start("dag_fit")
    return sentinel


def raw_table(raw_features, data, require_response: bool) -> FeatureTable:
    """A host table of ``raw_features`` from a mapping of columns (numpy
    arrays or python sequences, NaN or None missing) or a list of records,
    by the readers' rules; response columns only when
    ``require_response``."""
    return frame_to_table(Frame.of(data), raw_features,
                          require_response=require_response)


class OpWorkflow:
    """A feature DAG to train: ``OpWorkflow().set_input_dataset(data)
    .set_result_features(pred).train()`` fits every stage on ``device``
    (default: the CUDA device; raises when there is none)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.result_features: Tuple[Feature, ...] = ()
        self.raw_features: Tuple[Feature, ...] = ()
        self.reader: Optional[Reader] = None
        self._layers = None
        self.parameters: Dict[str, Any] = {}
        self._raw_feature_filter = None
        self._workflow_cv = False
        self._checkpoint_dir: Optional[str] = None
        self._fault_policy = None
        self._mesh = None
        self.profiler = None
        #: {phase: seconds} of the last train: "filter", "fit" or, under
        #: workflow CV, "before", "fold_prep", "sweep" and "rest"
        self.phase_seconds: Dict[str, float] = {}

    def with_raw_feature_filter(self, rff) -> "OpWorkflow":
        """Screen the raw features with ``rff`` (a
        ``filters.RawFeatureFilter``) before fitting; the features it
        excludes leave the DAG (``_apply_blacklist``)."""
        self._raw_feature_filter = rff
        return self

    def with_workflow_cv(self) -> "OpWorkflow":
        """Workflow-level cross-validation: the label-dependent stages
        that feed the selector (the SanityChecker) refit inside every fold
        on that fold's training rows, instead of once before the sweep."""
        self._workflow_cv = True
        return self

    def with_checkpoint_dir(self, path: str) -> "OpWorkflow":
        """Crash-resumable training: each fitted estimator is
        checkpointed to ``path`` as it completes (atomic writes committed
        through a manifest with each file's sha256), every selector
        commits each family's sweep metrics, and a streamed train each
        pass's fold state after every chunk; ``train(resume=True)``
        restores the verified stages, sweep families and fold states and
        fits the rest. A corrupt or torn file is reported in
        ``summary()["faults"]`` and refit, never used."""
        self._checkpoint_dir = path
        return self

    def with_profiler(self, profiler=None) -> "OpWorkflow":
        """Time every stage's fit and transform during train
        (``utils.profiler.StageProfiler``; a new one when None): the
        runner's ``log_stage_metrics``."""
        from .utils.profiler import StageProfiler
        self.profiler = profiler or StageProfiler()
        return self

    def with_fault_policy(self, policy=None) -> "OpWorkflow":
        """Retry each stage fit on transient errors under ``policy`` (a
        ``robustness.RetryPolicy``; the default one when None), in-core
        and streamed; retries show in ``summary()["faults"]``."""
        from .robustness.policy import RetryPolicy
        self._fault_policy = policy or RetryPolicy()
        return self

    def with_mesh(self, mesh) -> "OpWorkflow":
        """Train over a device mesh: not ported (ROADMAP Queue 1 item 10);
        a train with one raises."""
        self._mesh = mesh
        return self

    def set_reader(self, reader: Reader) -> "OpWorkflow":
        """The training data's reader (``readers.DataReaders``)."""
        self.reader = reader
        return self

    def set_parameters(self, params: Dict[str, Any]) -> "OpWorkflow":
        """Workflow parameters; ``params["stageParams"]`` maps a stage's
        uid or class name to attributes set on it before a train
        (``OpPipelineStage.set_params``). The model keeps them."""
        self.parameters = dict(params)
        return self

    def set_input_dataset(self, data, key_field: Optional[str] = None
                          ) -> "OpWorkflow":
        """The training data in memory: a mapping of field name to column
        values, or a list of records."""
        self.reader = FrameReader(data, key_field=key_field)
        return self

    @property
    def stages(self) -> List[Any]:
        return [s for layer in (self._layers or []) for s, _ in layer]

    def set_result_features(self, *features: Feature) -> "OpWorkflow":
        """The features to produce; the stage DAG is their lineage."""
        if not features:
            raise ValueError("result features cannot be empty")
        self.result_features = tuple(features)
        raw: Dict[str, Feature] = {}
        for f in features:
            for r in f.raw_features():
                raw[r.uid] = r
        self.raw_features = tuple(sorted(raw.values(), key=lambda f: f.name))
        self._layers = compute_dag(self.result_features)
        return self

    def _set_stage_params(self) -> None:
        per_stage = self.parameters.get("stageParams", {})
        for stage in self.stages:
            for key in (stage.uid, type(stage).__name__):
                if key in per_stage:
                    stage.set_params(**per_stage[key])

    def train(self, resume: bool = False, stream=None) -> "OpWorkflowModel":
        """Fit the DAG on the device; returns the fitted model. The fit
        runs under an activated ``FaultLog``: what is recovered anywhere
        below (restored or skipped checkpoints, downshifts, retries) is in
        ``summary()["faults"]``.

        ``stream=<streaming.ChunkSource>``: the out-of-core train (module
        docstring); ``summary()["streaming"]`` carries the feed's
        accounting. ``resume=True`` needs ``with_checkpoint_dir``; it
        restores the verified stages, sweep families and fold states and
        fits the rest, and ``summary()["resume"]`` says which.

        The train runs under a ``workflow.train`` span, with the flight
        recorder's ``workflow.train`` and ``workflow.train_done`` events
        stamped with one correlation id for the run."""
        from .observability import blackbox as _blackbox
        from .observability.trace import span as _obs_span
        from .robustness.policy import FaultLog
        fault_log = FaultLog()
        # one correlation id per run: every recorder event inside this
        # train (stream passes, sweep families, fault recoveries) carries
        # it, so the recorder's slice for it is this run's timeline
        corr = (_blackbox.new_correlation_id("run")
                if _blackbox.blackbox_enabled() else None)
        with fault_log.activate(), _blackbox.correlated(corr), \
                _obs_span("workflow.train", cat="train", resume=resume,
                          stream=stream is not None):
            _blackbox.record("workflow.train", resume=resume,
                             stream=stream is not None)
            if stream is not None:
                model = self._train_streaming(stream, resume=resume)
            else:
                model = self._train_in_core(resume=resume)
            _blackbox.record("workflow.train_done")
        model._fault_log = fault_log
        model._correlation = corr
        model._resume_requested = resume
        return model

    def drift_refit_hook(self, save_dir: str,
                         resume: Optional[bool] = None):
        """A serving-registry refit hook bound to this workflow
        (``ModelRegistry(refit_hook=...)`` / ``set_refit_hook``): when a
        served model's drift verdict degrades, the registry calls the hook
        on a background thread; it retrains this workflow on whatever its
        reader or input currently yields, saves the result under
        ``save_dir`` (``refit_000001``, ``refit_000002``, ... so the model
        directory in service is never written over), and returns the
        saved path for the registry's verified load and warm hot swap.

        ``resume`` defaults to whether a checkpoint dir is attached: with
        one the refit itself survives a kill (``train(resume=True)``
        restores the verified stages and replays the sweep)."""
        counter = {"n": 0}
        if resume is None:
            resume = self._checkpoint_dir is not None

        def hook(name: str, runtime, report) -> str:
            counter["n"] += 1
            model = self.train(resume=resume)
            path = os.path.join(save_dir, f"refit_{counter['n']:06d}")
            model.save(path)
            return path

        return hook

    def _train_in_core(self, resume: bool = False) -> "OpWorkflowModel":
        if not self.result_features:
            raise ValueError("call set_result_features before train")
        if self.reader is None:
            raise ValueError("no data: call set_reader or "
                             "set_input_dataset first")
        if self._mesh is not None:
            raise NotImplementedError(
                "training over a mesh is not ported yet (ROADMAP Queue 1 "
                "item 10)")
        ckpt_dir = self._checkpoint_dir
        if resume and ckpt_dir is None:
            raise ValueError(
                "train(resume=True) requires with_checkpoint_dir(...): "
                "there is no checkpoint state to resume from")
        self.phase_seconds = {}
        self._set_stage_params()
        table = self.reader.generate_table(self.raw_features)
        layers, result_features = self._layers, self.result_features
        blacklisted: Tuple[Feature, ...] = ()
        rff_results = None
        if self._raw_feature_filter is not None:
            t0 = synced_clock(self.device)
            rff = self._raw_feature_filter
            rff.device = self.device
            table, blacklist, rff_results = rff.filter_raw(table,
                                                           self.raw_features)
            if blacklist:
                result_features, layers = self._apply_blacklist(blacklist)
                blacklisted = tuple(blacklist)
            self.phase_seconds["filter"] = synced_clock(self.device) - t0
        table = table.to_device(self.device)
        checkpoint = preloaded = None
        if ckpt_dir is not None:
            from .impl.tuning.sweep_checkpoint import SweepCheckpoint
            from .persistence import (load_stage_checkpoints,
                                      open_checkpoint_manifest,
                                      save_stage_checkpoint)
            # verified stages only: a failure is reported and refits
            preloaded = load_stage_checkpoints(ckpt_dir, device=self.device)
            # one manifest for the stage checkpoints and the sweep state,
            # so their commits never overwrite each other
            manifest = open_checkpoint_manifest(ckpt_dir)
            checkpoint = lambda model: save_stage_checkpoint(  # noqa: E731
                model, ckpt_dir, manifest)
            for layer in layers:
                for s, _ in layer:
                    if hasattr(s, "set_sweep_checkpoint"):
                        s.set_sweep_checkpoint(
                            SweepCheckpoint(ckpt_dir, s.uid, manifest))
        from .manifest import active_sentinel
        sentinel = _open_run_sentinel(ckpt_dir, resume)
        with active_sentinel(sentinel):
            if self._workflow_cv:
                table, fitted = self._fit_with_workflow_cv(table, layers)
            else:
                t0 = synced_clock(self.device)
                table, fitted = fit_and_transform_dag(
                    table, layers, profiler=self.profiler,
                    checkpoint=checkpoint, preloaded=preloaded,
                    retry_policy=self._fault_policy)
                self.phase_seconds["fit"] = synced_clock(self.device) - t0
        if sentinel is not None:
            # a clean exit; a kill above leaves it for the next resume
            sentinel.clear()
        model = OpWorkflowModel(self.device)
        model.reader = self.reader
        model.parameters = self.parameters
        model.result_features = tuple(
            f.copy_with_new_stages(fitted) for f in result_features)
        model.raw_features = self.raw_features
        model.blacklisted_features = blacklisted
        model.rff_results = rff_results
        model.train_table = table
        model._fitted_stage_uids = sorted(fitted)
        if self.profiler is not None:
            # scoring gets its own profiler: fit and score costs apart
            from .utils.profiler import StageProfiler
            model.profiler = StageProfiler()
        model._layers = compute_dag(model.result_features)
        return model

    def _train_streaming(self, source, resume: bool = False
                         ) -> "OpWorkflowModel":
        """The streamed train (``streaming.fit_dag_streaming``), with the
        JAX package's refusals of the in-core-only modes."""
        if not self.result_features:
            raise ValueError("call set_result_features before train")
        if self._raw_feature_filter is not None:
            raise ValueError(
                "RawFeatureFilter is not supported with train(stream=...): "
                "its fill-rate/histogram stats are available as streaming "
                "folds (streaming.folds.HistogramFold) but score-vs-train "
                "comparison needs a second stream — train in-core or drop "
                "the filter")
        if self._workflow_cv:
            raise ValueError(
                "with_workflow_cv() is not supported with train(stream=...):"
                " per-fold DAG refits need fold-sliced tables")
        if self._mesh is not None:
            raise ValueError(
                "with_mesh() is not supported with train(stream=...) yet: "
                "chunk folds are host monoids")
        from .manifest import active_sentinel
        from .streaming.cache import ChunkCache
        from .streaming.checkpoint import StreamCheckpoint
        from .streaming.trainer import fit_dag_streaming
        self.phase_seconds = {}
        layers = self._layers
        source.bind(self.raw_features)
        self._set_stage_params()
        ckpt_dir = self._checkpoint_dir
        if resume and ckpt_dir is None:
            raise ValueError(
                "train(resume=True) requires with_checkpoint_dir(...): "
                "there is no checkpoint state to resume from")
        checkpoint = preloaded = stream_ckpt = None
        if ckpt_dir is not None:
            from .persistence import (load_stage_checkpoints,
                                      open_checkpoint_manifest,
                                      save_stage_checkpoint)
            preloaded = load_stage_checkpoints(ckpt_dir, device=self.device)
            manifest = open_checkpoint_manifest(ckpt_dir)
            checkpoint = lambda model: save_stage_checkpoint(  # noqa: E731
                model, ckpt_dir, manifest)
            stream_ckpt = StreamCheckpoint(ckpt_dir, manifest,
                                           source.fingerprint())
        # one cache for the whole train, shared by every stage and pass
        stream_cache = ChunkCache.from_env()
        sentinel = _open_run_sentinel(ckpt_dir, resume)
        t0 = synced_clock(self.device)
        with active_sentinel(sentinel):
            fitted, transformers, stats = fit_dag_streaming(
                source, layers, checkpoint=checkpoint,
                stream_checkpoint=stream_ckpt, preloaded=preloaded,
                retry_policy=self._fault_policy, cache=stream_cache,
                device=self.device)
        self.phase_seconds["fit"] = synced_clock(self.device) - t0
        if sentinel is not None:
            sentinel.clear()
        model = OpWorkflowModel(self.device)
        model.reader = self.reader
        model.parameters = self.parameters
        model.result_features = tuple(
            f.copy_with_new_stages(fitted) for f in self.result_features)
        model.raw_features = self.raw_features
        model.rff_results = None
        # a small transformed head of the stream stands in for the train
        # table: the fitted schema, never the dataset
        probe = next(iter(source.chunks(0))).table
        if probe.num_rows > 256:
            probe = probe.take(np.arange(256))
        probe = probe.to_device(self.device)
        for m in transformers:
            probe = m.transform(probe)
        model.train_table = probe
        model._stream_stats = stats
        model._stream_cache_stats = (stream_cache.stats
                                     if stream_cache is not None else None)
        model._fitted_stage_uids = sorted(fitted)
        model._layers = compute_dag(model.result_features)
        return model

    def _fit_with_workflow_cv(self, table: FeatureTable, layers):
        """Fit the label-independent stages once; run the selector's
        ``find_best_estimator`` with fold copies of the label-dependent
        stages that feed it; then fit the rest (those stages on all rows,
        and the selector, which refits the winner it recorded)."""
        from .impl.selector.model_selector import ModelSelector

        all_stages = [s for layer in layers for s, _ in layer]
        selectors = [s for s in all_stages if isinstance(s, ModelSelector)]
        if len(selectors) != 1:
            raise ValueError(
                f"workflow-level CV requires exactly one ModelSelector, "
                f"found {len(selectors)} (reference FitStagesUtil.cutDAG:313)")
        sel = selectors[0]
        _, vec_f = sel.input_features

        # a feature is label-dependent when its stage is an estimator that
        # reads the label (AllowLabelAsInput) or the selector, or when any
        # parent is; those stages and everything after them fit last
        tainted: Dict[str, bool] = {}
        ordered: List[Feature] = []
        for rf in self.result_features:
            for feat in rf.all_features():      # parents first
                if feat.uid in tainted:
                    continue
                ordered.append(feat)
                st = feat.origin_stage
                own = ((isinstance(st, Estimator)
                        and isinstance(st, AllowLabelAsInput))
                       or st is sel)
                tainted[feat.uid] = own or any(tainted.get(p.uid, False)
                                               for p in feat.parents)
        tainted_stages = {f.origin_stage.uid for f in ordered
                          if tainted[f.uid] and not f.is_raw}

        t0 = synced_clock(self.device)
        before = [[(s, d) for s, d in layer if s.uid not in tainted_stages]
                  for layer in layers]
        table1, fitted_before = fit_and_transform_dag(
            table, before, profiler=self.profiler,
            retry_policy=self._fault_policy)
        self.phase_seconds["before"] = synced_clock(self.device) - t0
        # the stages refit in every fold: label-dependent ones on the
        # selector's input ancestry, the selector excluded
        vec_anc = {f.origin_stage.uid for f in vec_f.all_features()
                   if not f.is_raw}
        during = [[(s, d) for s, d in layer
                   if s.uid in tainted_stages and s.uid in vec_anc
                   and s is not sel] for layer in layers]
        rest = [[(s, d) for s, d in layer if s.uid in tainted_stages]
                for layer in layers]
        try:
            sel.find_best_estimator(table1, [l for l in during if l])
            self.phase_seconds.update(sel.phase_seconds)
            t0 = synced_clock(self.device)
            table2, fitted_rest = fit_and_transform_dag(
                table1, [l for l in rest if l], profiler=self.profiler,
                retry_policy=self._fault_policy)
            self.phase_seconds["rest"] = synced_clock(self.device) - t0
        except Exception:
            # no recorded winner outlives a failed run
            sel._preset_best = None
            raise
        return table2, {**fitted_before, **fitted_rest}

    def _apply_blacklist(self, blacklist: Sequence[Feature]):
        """The result features and layers without the excluded raw
        features: a stage that loses every input goes, a stage that loses
        some is copied with the rest (its output keeps its name and uid)."""
        gone = {f.uid for f in blacklist}
        cache: Dict[str, Optional[Feature]] = {}

        def rebuild(f: Feature) -> Optional[Feature]:
            if f.uid in cache:
                return cache[f.uid]
            if f.is_raw:
                cache[f.uid] = None if f.uid in gone else f
                return cache[f.uid]
            kept = [np_ for np_ in (rebuild(p) for p in f.parents)
                    if np_ is not None]
            if not kept:
                cache[f.uid] = None
                return None
            stage = f.origin_stage
            if len(kept) != len(f.parents):
                stage = copy.copy(stage)
                stage.input_features = tuple(kept)
                stage._output_feature = None
                out = stage.get_output()
                out.name, out.uid = f.name, f.uid
                stage._output_feature = out
            else:
                stage.input_features = tuple(kept)
                out = Feature(f.name, f.feature_type, f.is_response, stage,
                              kept, uid=f.uid)
                stage._output_feature = out
            cache[f.uid] = out
            return out

        new_results = []
        for f in self.result_features:
            nf = rebuild(f)
            if nf is None:
                raise ValueError(f"result feature '{f.name}' lost all inputs "
                                 f"to the raw feature filter")
            new_results.append(nf)
        return tuple(new_results), compute_dag(new_results)


class OpWorkflowModel:
    """Fitted workflow: raw features in, result features out, every stage
    on ``device``."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.result_features: Tuple[Feature, ...] = ()
        self.raw_features: Tuple[Feature, ...] = ()
        self.blacklisted_features: Tuple[Feature, ...] = ()
        #: the raw feature filter's ``RawFeatureFilterResults``, if any
        self.rff_results = None
        #: the transformed training table (a trained model only)
        self.train_table: Optional[FeatureTable] = None
        self.parameters: Dict[str, Any] = {}
        self.reader: Optional[Reader] = None
        #: a ``StageProfiler`` timing scores (a model trained with one)
        self.profiler = None
        self._layers = None

    @property
    def stages(self) -> List[Any]:
        return [s for layer in (self._layers or []) for s, _ in layer]

    def get_stage(self, uid: str) -> Any:
        for s in self.stages:
            if s.uid == uid:
                return s
        raise KeyError(uid)

    def raw_table(self, data) -> FeatureTable:
        """A host table of the raw predictors from a mapping of columns or
        a list of records (``raw_table``). Response columns are not
        needed."""
        return raw_table(self.raw_features, data, require_response=False)

    def save(self, path: str) -> None:
        """Save to the directory ``path`` in the JAX package's format
        (``persistence.save_model``)."""
        from .persistence import save_model
        save_model(self, path)

    @staticmethod
    def load(path: str, device=None, workflow: Optional["OpWorkflow"] = None
             ) -> "OpWorkflowModel":
        """A saved model on ``device`` (``persistence.load_model``)."""
        from .persistence import load_model
        return load_model(path, device=device, workflow=workflow)

    def summary(self) -> Dict[str, Any]:
        """{stage uid: its summary metadata} of every fitted stage that
        has one, as the JAX package's per-stage sections; for a model this
        process trained also ``faults`` (the train's fault log),
        ``resume`` (what was restored and what refit), ``observability``
        (``observability.summarize()``) and, for a streamed
        train, ``streaming`` (the feed's accounting and the cache's)."""
        out: Dict[str, Any] = {s.uid: s.summary_metadata for s in self.stages
                               if getattr(s, "summary_metadata", None)}
        log = getattr(self, "_fault_log", None)
        if log is None:
            return out
        out["faults"] = log.to_json()
        restored = sorted(
            r.detail.get("uid") for r in log.reports
            if r.kind == "restored" and r.site == "dag.stage_fit")
        out["resume"] = {
            "requested": bool(getattr(self, "_resume_requested", False)),
            "restoredStages": restored,
            "refitStages": [uid for uid in getattr(self, "_fitted_stage_uids",
                                                   [])
                            if uid not in set(restored)],
            "restoredSweepCandidates": [
                dict(r.detail) for r in log.reports
                if r.kind == "restored" and r.site == "sweep.candidate"],
        }
        # the process's telemetry aggregates (per-stage and per-family
        # span timings, fault counters, scoring latency quantiles, the
        # compile ledger; ``observability.summarize``), as the JAX package
        # adds them
        from .observability import summarize
        out["observability"] = summarize()
        stats = getattr(self, "_stream_stats", None)
        if stats is not None:
            out["streaming"] = stats.to_json()
            cache_stats = getattr(self, "_stream_cache_stats", None)
            if cache_stats is not None:
                out["streaming"]["cache"] = cache_stats.to_json()
        return out

    def summary_json(self) -> str:
        return json.dumps(self.summary(), indent=2, default=_json_default)

    def summary_pretty(self) -> str:
        """Each fitted stage's text summary (the SanityChecker's and the
        ModelSelector's), as the JAX package prints it."""
        lines: List[str] = ["Workflow summary:"]
        for stage in self.stages:
            pretty = getattr(stage, "summary_pretty", None)
            if callable(pretty):
                lines.append(pretty())
            elif getattr(stage, "summary_metadata", None):
                lines.append(f"-- {type(stage).__name__} ({stage.uid})")
        return "\n".join(lines)

    def model_insights(self, feature=None):
        """The model's report (``insights.ModelInsights``); ``feature`` is
        accepted as in the JAX package and not used."""
        from .insights import ModelInsights
        return ModelInsights.extract(self)

    def score(self, table: Optional[FeatureTable] = None, data=None,
              reader: Optional[Reader] = None) -> FeatureTable:
        """Score a raw table, in-memory data (``raw_table``) or a reader's
        data on the model's device (with none of them: the reader the model
        was trained with): the raw, intermediate and result columns, as
        tensors on that device; a reader's key is the table's ``key``."""
        if sum(x is not None for x in (table, data, reader)) > 1:
            raise ValueError("pass at most one of table=, data= or reader=")
        if data is not None:
            table = self.raw_table(data)
        elif table is None:
            reader = reader or self.reader
            if reader is None:
                raise ValueError("no data: pass table=, data= or reader=")
            table = reader.generate_table(self.raw_features,
                                          require_response=False)
        from .observability.trace import span as _obs_span
        with _obs_span("workflow.score", cat="score", rows=table.num_rows):
            return apply_transformations_dag(table.to_device(self.device),
                                             self._layers,
                                             profiler=self.profiler)

    def score_function(self):
        """Row-at-a-time scorer: ``fn(row) -> {result name: value}``."""
        from .local.scoring import score_function
        return score_function(self)


def _json_default(o):
    """JSON of the values a summary may hold beyond JSON's own."""
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    if hasattr(o, "to_json"):
        return o.to_json()
    if hasattr(o, "__dict__"):
        return {k: v for k, v in vars(o).items() if not k.startswith("_")}
    return str(o)
