"""Regression evaluator (counterpart of
``transmogrifai_tpu.evaluators.regression``)."""
from __future__ import annotations

from typing import Dict

import torch

from ..ops.metrics import regression_metrics
from ..table import FeatureTable
from .base import OpEvaluatorBase


class OpRegressionEvaluator(OpEvaluatorBase):
    """RMSE/MSE/MAE/R2; model selection minimizes the RMSE."""

    default_metric = "RootMeanSquaredError"
    larger_better = False

    def evaluate_all(self, table: FeatureTable) -> Dict[str, float]:
        label, parts = self._extract(table)
        pred = parts["prediction"].to(torch.float32)
        # keys in sorted order, as the JAX package's jitted metrics return
        return {k: float(v) for k, v in sorted(regression_metrics(
            pred, label.to(pred.device)).items())}
