"""ModelSelector, fitted half (counterpart of
``transmogrifai_tpu.impl.selector.model_selector``): the winning model emits
a Prediction column on the device. The selection sweep waits for the
training slice; its summary is carried as decoded from a saved model.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...models.api import MODEL_REGISTRY
from ...stages.base import AllowLabelAsInput, Transformer
from ...table import Column, FeatureTable
from ...types import Prediction


@dataclass
class ValidationResult:
    """Per-(family, grid point) validation metrics of the sweep."""
    family: str
    grid: List[Dict[str, Any]]
    metric_name: str
    fold_metrics: Any        # (F, G)
    mean_metrics: Any        # (G,)


@dataclass
class ModelSelectorSummary:
    """What the selection sweep found, as saved with the model."""
    validation_type: str
    validation_metric: str
    problem: str
    best_model_type: str
    best_hyper: Dict[str, Any]
    best_metric_value: float
    larger_better: bool = True
    validation_results: List[Any] = field(default_factory=list)
    train_evaluation: Dict[str, Any] = field(default_factory=dict)
    holdout_evaluation: Dict[str, Any] = field(default_factory=dict)
    splitter_summary: Dict[str, Any] = field(default_factory=dict)
    validation_eval_row_cap: Optional[int] = None
    quarantined: List[Dict[str, Any]] = field(default_factory=list)


class SelectedModel(AllowLabelAsInput, Transformer):
    """The fitted winner: inputs are (label, feature vector); emits an
    (n, k) Prediction column with keys prediction / rawPrediction_i /
    probability_i. Exactly n rows: no padding to row buckets."""

    output_type = Prediction

    def _unmap_prediction(self, pred: torch.Tensor) -> torch.Tensor:
        """Map dense class indices back to the original labels that the
        label mapping (DataCutter) remapped; other values pass through."""
        if not self.label_mapping or pred.numel() == 0:
            return pred
        inverse = {int(dense): float(orig)
                   for orig, dense in self.label_mapping.items()}
        size = max(inverse) + 1
        inv = np.arange(size, dtype=np.float32)
        for dense, orig in inverse.items():
            inv[dense] = orig
        table = self.device_constant("label_inverse", inv, torch.float32,
                                     pred.device)
        idx = pred.to(torch.long)
        inside = (idx >= 0) & (idx < size)
        return torch.where(inside, table[idx.clamp(0, size - 1)], pred)

    def transform_column(self, table: FeatureTable) -> Column:
        _, vec_f = self.input_features
        X = table[vec_f.name].values.to(torch.float32)
        family = MODEL_REGISTRY[self.fitted.family]
        parts = family.predict_parts(self.fitted, X)
        parts = dict(parts,
                     prediction=self._unmap_prediction(parts["prediction"]))
        return prediction_column(parts)


def prediction_column(parts: Dict[str, torch.Tensor]) -> Column:
    """Pack prediction parts into a Prediction column on their device."""
    keys: List[str] = [Prediction.PredictionName]
    cols: List[torch.Tensor] = [
        parts["prediction"].to(torch.float32).reshape(-1)]
    for name in (Prediction.RawPredictionName, Prediction.ProbabilityName):
        if name in parts:
            arr = parts[name].to(torch.float32)
            if arr.dim() == 1:
                arr = arr[:, None]
            for i in range(arr.shape[1]):
                keys.append(f"{name}_{i}")
                cols.append(arr[:, i])
    return Column(Prediction, torch.stack(cols, dim=1), None,
                  {"keys": tuple(keys)})
