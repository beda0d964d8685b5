"""Evaluator base (counterpart of ``transmogrifai_tpu.evaluators.base``):
an evaluator reads a fitted Prediction column, stored as an (n, k) matrix
with a ``keys`` tuple, and the label column."""
from __future__ import annotations

import abc
from typing import Dict, Optional, Tuple

import torch

from ..table import Column, FeatureTable
from ..types import Prediction


def prediction_parts(col: Column) -> Dict[str, torch.Tensor]:
    """Split a Prediction column into prediction / probability /
    rawPrediction tensors (probability and rawPrediction (n, C), class
    order)."""
    keys = tuple(col.metadata.get("keys", ()))
    vals = torch.as_tensor(col.values)
    if not keys:
        return {"prediction": vals.reshape(len(col))}
    key_idx = {k: i for i, k in enumerate(keys)}
    out: Dict[str, torch.Tensor] = {}
    if Prediction.PredictionName in key_idx:
        out["prediction"] = vals[:, key_idx[Prediction.PredictionName]]
    for prefix in (Prediction.ProbabilityName, Prediction.RawPredictionName):
        idxs = sorted((int(k.rsplit("_", 1)[1]), i) for k, i in key_idx.items()
                      if k.startswith(prefix + "_"))
        if idxs:
            out[prefix] = vals[:, [i for _, i in idxs]]
    return out


class OpEvaluatorBase(abc.ABC):
    """Binds the label and prediction column names."""

    #: the metric model selection optimizes, and its direction
    default_metric: str = ""
    larger_better: bool = True

    def __init__(self, label_col: Optional[str] = None,
                 prediction_col: Optional[str] = None):
        self.label_col = label_col
        self.prediction_col = prediction_col

    def set_label_col(self, feature_or_name) -> "OpEvaluatorBase":
        self.label_col = getattr(feature_or_name, "name", feature_or_name)
        return self

    def set_prediction_col(self, feature_or_name) -> "OpEvaluatorBase":
        self.prediction_col = getattr(feature_or_name, "name",
                                      feature_or_name)
        return self

    def _extract(self, table: FeatureTable
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if self.label_col is None or self.prediction_col is None:
            raise ValueError("evaluator needs label_col and prediction_col")
        label = torch.as_tensor(table[self.label_col].values).to(
            torch.float32).reshape(-1)
        return label, prediction_parts(table[self.prediction_col])

    @abc.abstractmethod
    def evaluate_all(self, table: FeatureTable) -> Dict[str, object]:
        """Every metric of this evaluator."""

    def evaluate(self, table: FeatureTable) -> float:
        """The default metric alone."""
        return float(self.evaluate_all(table)[self.default_metric])
