"""DAG layering, the layer-wise fit and the score-time pass (counterpart of
``transmogrifai_tpu.dag``). PyTorch runs eagerly, so each pass applies one
stage after another; there is no plan compiler.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .features import Feature
from .observability.trace import span as _obs_span
from .stages.base import Estimator, FeatureGeneratorStage, Transformer
from .table import FeatureTable

#: a DAG is a list of layers; each layer is a list of (stage, distance)
StageLayer = List[Tuple[Any, int]]


def compute_dag(result_features: Sequence[Feature]) -> List[StageLayer]:
    """Group all non-generator ancestor stages into layers by their longest
    distance to any result feature, farthest first."""
    dist: Dict[str, int] = {}
    stages: Dict[str, Any] = {}
    for f in result_features:
        for stage, d in f.parent_stages().items():
            if isinstance(stage, FeatureGeneratorStage):
                continue
            if stage.uid not in dist or d > dist[stage.uid]:
                dist[stage.uid] = d
                stages[stage.uid] = stage
    by_layer: Dict[int, StageLayer] = {}
    for uid, d in dist.items():
        by_layer.setdefault(d, []).append((stages[uid], d))
    return [sorted(by_layer[d], key=lambda sd: sd[0].uid)
            for d in sorted(by_layer, reverse=True)]


class _NullProfiler:
    def track(self, stage, op, layer=-1):
        return contextlib.nullcontext()


_NULL_PROFILER = _NullProfiler()


def fit_and_transform_dag(table: FeatureTable, layers: List[StageLayer],
                          profiler: Optional[Any] = None,
                          checkpoint: Optional[Any] = None,
                          preloaded: Optional[Dict[str, Any]] = None,
                          retry_policy: Optional[Any] = None,
                          ) -> Tuple[FeatureTable, Dict[str, Any]]:
    """Fit the estimators layer by layer, farthest first, transforming the
    table as it goes. Returns (transformed table, {estimator uid: fitted
    model}).

    ``checkpoint(model)`` runs after each estimator fit, and ``preloaded``
    {uid: fitted model} restores a stage instead of fitting it (rewired
    onto this DAG's features and recorded as ``dag.stage_fit``/
    ``restored``): together they give a resumable train. ``retry_policy``
    (a ``robustness.RetryPolicy``, ``OpWorkflow.with_fault_policy``)
    re-runs a stage fit that fails with a transient error; other errors
    are raised. ``profiler`` (``utils.profiler.StageProfiler``) times each
    fit and transform. Sites: ``preempt.stage_fit`` and ``dag.stage_fit``
    before each fit; spans ``stage.fit`` and ``stage.transform``."""
    from .robustness import faults
    from .robustness.policy import FaultLog, FaultReport
    prof = profiler or _NULL_PROFILER
    pre = preloaded or {}
    fitted: Dict[str, Any] = {}
    for li, layer in enumerate(layers):
        models = []
        for stage, _ in layer:
            if isinstance(stage, Estimator):
                if stage.uid in pre:
                    model = pre[stage.uid]
                    model.input_features = stage.input_features
                    model._output_feature = stage.get_output()
                    FaultLog.record(FaultReport(
                        site="dag.stage_fit", kind="restored",
                        detail={"uid": stage.uid,
                                "stage": type(stage).__name__}))
                else:
                    def _fit(stage=stage, li=li):
                        # a kill here leaves the earlier stages
                        # checkpointed
                        faults.inject("preempt.stage_fit", key=stage.uid)
                        faults.inject("dag.stage_fit", key=stage.uid)
                        with _obs_span("stage.fit", cat="train",
                                       uid=stage.uid,
                                       stage=type(stage).__name__,
                                       layer=li), \
                                prof.track(stage, "fit", li):
                            return stage.fit(table)
                    if retry_policy is not None:
                        model = retry_policy.execute(
                            _fit, site=f"dag.stage_fit[{stage.uid}]")
                    else:
                        model = _fit()
                    if checkpoint is not None:
                        checkpoint(model)
                fitted[stage.uid] = model
            elif isinstance(stage, Transformer):
                model = stage
            else:
                raise TypeError(f"unexpected stage kind "
                                f"{type(stage).__name__}")
            models.append(model)
        table = _transform_stages(table, models, cat="train", layer=li,
                                  profiler=profiler)
    return table, fitted


def _transform_stages(table: FeatureTable, models: Sequence[Any], *,
                      cat: str, layer: int = -1,
                      profiler: Optional[Any] = None) -> FeatureTable:
    """Apply the transformers in order, each under a ``stage.transform``
    span and the profiler's timer."""
    prof = profiler or _NULL_PROFILER
    for model in models:
        with _obs_span("stage.transform", cat=cat,
                       uid=getattr(model, "uid", "?"),
                       stage=type(model).__name__, layer=layer), \
                prof.track(model, "transform", layer):
            table = model.transform(table)
    return table


def apply_transformations_dag(table: FeatureTable,
                              layers: List[StageLayer],
                              profiler: Optional[Any] = None
                              ) -> FeatureTable:
    """Run every fitted stage, farthest layer first (a topological order)."""
    for layer in layers:
        for stage, _ in layer:
            if not isinstance(stage, Transformer):
                raise ValueError(
                    f"stage {stage.uid} ({type(stage).__name__}) is not a "
                    f"fitted transformer")
    flat = [stage for layer in layers for stage, _ in layer]
    return _transform_stages(table, flat, cat="score", profiler=profiler)
