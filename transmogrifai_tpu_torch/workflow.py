"""OpWorkflowModel: a fitted workflow that scores on a device (counterpart
of the scoring half of ``transmogrifai_tpu.workflow``). Training waits for
the training slice; a model comes from ``persistence.load_model``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .dag import apply_transformations_dag
from .features import Feature
from .table import Column, FeatureTable, column_of_scalars


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
        cols: Dict[str, Column] = {}
        for f in self.raw_features:
            if f.is_response:
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
