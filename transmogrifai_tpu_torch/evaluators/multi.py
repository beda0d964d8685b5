"""Multiclass evaluator (counterpart of
``transmogrifai_tpu.evaluators.multi``)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops.metrics import multiclass_log_loss, multiclass_metrics
from ..table import FeatureTable
from .base import OpEvaluatorBase


class OpMultiClassificationEvaluator(OpEvaluatorBase):
    """Error and weighted Precision/Recall/F1 (model selection maximizes
    F1), log loss, top-N accuracies and per-threshold top-N counts."""

    default_metric = "F1"
    larger_better = True

    def __init__(self, top_ns=(1, 3), thresholds=None, **kw):
        super().__init__(**kw)
        self.top_ns = tuple(top_ns)
        #: the reference's default: 0.0 to 1.0 by 0.1
        self.thresholds = tuple(
            thresholds if thresholds is not None
            else np.round(np.arange(0.0, 1.0001, 0.1), 2).tolist())

    def evaluate_all(self, table: FeatureTable) -> Dict[str, object]:
        label, parts = self._extract(table)
        pred = parts["prediction"].to(torch.int32)
        label_idx = label.to(pred.device).to(torch.int32)
        num_classes = int(max(int(pred.max()) if pred.numel() else 0,
                              int(label_idx.max()) if label_idx.numel()
                              else 0)) + 1
        out: Dict[str, object] = {k: float(v) for k, v in multiclass_metrics(
            pred, label_idx, num_classes).items()}
        prob = parts.get("probability")
        if prob is not None:
            out["LogLoss"] = float(multiclass_log_loss(
                prob.to(torch.float32), label_idx))
            prob_np = prob.cpu().numpy()
            lab_np = label_idx.cpu().numpy()
            order = np.argsort(-prob_np, axis=1)
            for n in self.top_ns:
                hit = (order[:, :n] == lab_np[:, None]).any(axis=1)
                out[f"TopN_{n}_Accuracy"] = float(hit.mean())
            out["ThresholdMetrics"] = self.threshold_metrics(prob_np, lab_np)
        return out

    def threshold_metrics(self, prob: np.ndarray,
                          label_idx: np.ndarray) -> Dict[str, object]:
        """Per-threshold top-N correct / incorrect / no-prediction counts:
        a prediction is made at threshold t when the top probability is at
        least t; a made prediction is correct for top-N when the label
        ranks among the N highest scores."""
        prob = np.asarray(prob, dtype=np.float64)
        label_idx = np.asarray(label_idx, dtype=np.int64)
        thr = np.asarray(self.thresholds, dtype=np.float64)
        made = prob.max(axis=1)[:, None] >= thr[None, :]      # (n, T)
        order = np.argsort(-prob, axis=1)
        correct, incorrect, no_pred = {}, {}, {}
        n_rows = prob.shape[0]
        for n in self.top_ns:
            hit = (order[:, :n] == label_idx[:, None]).any(axis=1)[:, None]
            correct[n] = (hit & made).sum(axis=0).tolist()
            incorrect[n] = (~hit & made).sum(axis=0).tolist()
            no_pred[n] = (n_rows - made.sum(axis=0)).tolist()
        return {"topNs": list(self.top_ns), "thresholds": thr.tolist(),
                "correctCounts": correct, "incorrectCounts": incorrect,
                "noPredictionCounts": no_pred}
