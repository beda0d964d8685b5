"""DAG layering, the layer-wise fit and the score-time pass (counterpart of
``transmogrifai_tpu.dag``). PyTorch runs eagerly, so each pass applies one
stage after another; there is no plan compiler.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

from .features import Feature
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


def fit_and_transform_dag(table: FeatureTable, layers: List[StageLayer]
                          ) -> Tuple[FeatureTable, Dict[str, Any]]:
    """Fit the estimators layer by layer, farthest first, transforming the
    table as it goes. Returns (transformed table, {estimator uid: fitted
    model})."""
    fitted: Dict[str, Any] = {}
    for layer in layers:
        models = []
        for stage, _ in layer:
            if isinstance(stage, Estimator):
                model = fitted[stage.uid] = stage.fit(table)
            elif isinstance(stage, Transformer):
                model = stage
            else:
                raise TypeError(f"unexpected stage kind "
                                f"{type(stage).__name__}")
            models.append(model)
        for model in models:
            table = model.transform(table)
    return table, fitted


def apply_transformations_dag(table: FeatureTable,
                              layers: List[StageLayer]) -> FeatureTable:
    """Run every fitted stage, farthest layer first (a topological order)."""
    for layer in layers:
        for stage, _ in layer:
            if not isinstance(stage, Transformer):
                raise ValueError(
                    f"stage {stage.uid} ({type(stage).__name__}) is not a "
                    f"fitted transformer")
            table = stage.transform(table)
    return table
