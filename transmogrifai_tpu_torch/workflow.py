"""Workflows (counterpart of ``transmogrifai_tpu.workflow``): ``OpWorkflow``
trains a feature DAG on a device and returns an ``OpWorkflowModel``, the
fitted workflow that scores on that device (a model also comes from
``persistence.load_model``).

Training is the in-core path: the raw table is built by a reader
(``readers``: a CSV file, or a mapping of columns or list of records given
to ``set_input_dataset``), by the JAX package's rules for each feature type,
moved to the device, and every estimator fits layer by layer. The JAX
package's raw-feature filter, stage checkpoints and resume, workflow-level
CV, mesh sharding and streaming are not ported.

A fitted model saves and loads in the JAX package's format
(``OpWorkflowModel.save`` / ``load``, ``persistence``). ``summary()`` gives
each stage's summary; the JAX package's ``faults``, ``resume``,
``observability`` and ``streaming`` sections wait for the robustness,
observability and streaming modules.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .dag import apply_transformations_dag, compute_dag, fit_and_transform_dag
from .device import resolve_device
from .features import Feature
from .readers.readers import Frame, FrameReader, Reader, frame_to_table
from .table import FeatureTable


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

    def set_reader(self, reader: Reader) -> "OpWorkflow":
        """The training data's reader (``readers.DataReaders``)."""
        self.reader = reader
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

    def train(self) -> "OpWorkflowModel":
        """Fit the DAG on the device; returns the fitted model."""
        if not self.result_features:
            raise ValueError("call set_result_features before train")
        if self.reader is None:
            raise ValueError("no data: call set_reader or "
                             "set_input_dataset first")
        table = self.reader.generate_table(self.raw_features).to_device(
            self.device)
        _, fitted = fit_and_transform_dag(table, self._layers)
        model = OpWorkflowModel(self.device)
        model.reader = self.reader
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
        self.reader: Optional[Reader] = None
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
        has one, as the JAX package's per-stage sections."""
        return {s.uid: s.summary_metadata for s in self.stages
                if getattr(s, "summary_metadata", None)}

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
        return apply_transformations_dag(table.to_device(self.device),
                                         self._layers)

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
