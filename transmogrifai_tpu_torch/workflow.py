"""Workflows (counterpart of ``transmogrifai_tpu.workflow``): ``OpWorkflow``
trains a feature DAG on a device and returns an ``OpWorkflowModel``, the
fitted workflow that scores on that device (a model also comes from
``persistence.load_model``).

Training is the in-core path: the raw table is built from a mapping of
column name to numpy array, moved to the device, and every estimator fits
layer by layer. The JAX package's raw-feature filter, stage checkpoints and
resume, workflow-level CV, mesh sharding and streaming are not ported.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .dag import apply_transformations_dag, compute_dag, fit_and_transform_dag
from .device import resolve_device
from .features import Feature
from .table import Column, FeatureTable, column_of_scalars


def raw_table(raw_features, data: Mapping[str, Any],
              require_response: bool) -> FeatureTable:
    """A host table of ``raw_features`` from ``{name: values}`` (NaN or None
    = missing); response columns only when ``require_response``."""
    cols: Dict[str, Column] = {}
    for f in raw_features:
        if f.is_response and not require_response:
            continue
        if f.name not in data:
            raise ValueError(
                f"input is missing raw feature '{f.name}'; it has "
                f"{sorted(data)}")
        v = data[f.name]
        if not isinstance(v, np.ndarray):
            v = [np.nan if x is None else x for x in v]
        cols[f.name] = column_of_scalars(f.feature_type, v)
    n = {len(c) for c in cols.values()}
    if len(n) > 1:
        raise ValueError(f"raw columns differ in length: {sorted(n)}")
    return FeatureTable(cols, n.pop() if n else 0)


class OpWorkflow:
    """A feature DAG to train: ``OpWorkflow().set_input_dataset(data)
    .set_result_features(pred).train()`` fits every stage on ``device``
    (default: the CUDA device; raises when there is none)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.result_features: Tuple[Feature, ...] = ()
        self.raw_features: Tuple[Feature, ...] = ()
        self._data: Optional[Mapping[str, Any]] = None
        self._layers = None

    def set_input_dataset(self, data: Mapping[str, Any]) -> "OpWorkflow":
        """The training data: ``{raw feature name: column values}``."""
        self._data = data
        return self

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

    def train(self) -> "OpWorkflowModel":
        """Fit the DAG on the device; returns the fitted model."""
        if not self.result_features:
            raise ValueError("call set_result_features before train")
        if self._data is None:
            raise ValueError("no data: call set_input_dataset first")
        table = raw_table(self.raw_features, self._data,
                          require_response=True).to_device(self.device)
        _, fitted = fit_and_transform_dag(table, self._layers)
        model = OpWorkflowModel(self.device)
        model.result_features = tuple(
            f.copy_with_new_stages(fitted) for f in self.result_features)
        model.raw_features = self.raw_features
        model._layers = compute_dag(model.result_features)
        return model


class OpWorkflowModel:
    """Fitted workflow: raw features in, result features out, every stage
    on ``device``."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.result_features: Tuple[Feature, ...] = ()
        self.raw_features: Tuple[Feature, ...] = ()
        self.blacklisted_features: Tuple[Feature, ...] = ()
        self.parameters: Dict[str, Any] = {}
        self._layers = None

    @property
    def stages(self) -> List[Any]:
        return [s for layer in (self._layers or []) for s, _ in layer]

    def raw_table(self, data: Mapping[str, Any]) -> FeatureTable:
        """A host table of the raw predictors from ``{name: values}``
        (NaN or None = missing). Response columns are not needed."""
        return raw_table(self.raw_features, data, require_response=False)

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

    def score(self, table: Optional[FeatureTable] = None,
              data: Optional[Mapping[str, Any]] = None) -> FeatureTable:
        """Score a table (or ``{name: values}``) on the model's device: the
        raw, intermediate and result columns, as tensors on that device."""
        if (table is None) == (data is None):
            raise ValueError("pass exactly one of table= or data=")
        if table is None:
            table = self.raw_table(data)
        return apply_transformations_dag(table.to_device(self.device),
                                         self._layers)

    def score_function(self):
        """Row-at-a-time scorer: ``fn(row) -> {result name: value}``."""
        from .local.scoring import score_function
        return score_function(self)
