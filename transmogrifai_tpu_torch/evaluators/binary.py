"""Binary classification evaluators (counterpart of
``transmogrifai_tpu.evaluators.binary``): the thresholded and ranking
metrics on the scores' device, and the calibration bins with the Brier
score in float64 on the host."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops.metrics import (
    aupr_masked, auroc_masked, log_loss_masked, threshold_metrics,
)
from ..table import FeatureTable
from ..utils.padding import bucket_for
from .base import OpEvaluatorBase


class OpBinaryClassificationEvaluator(OpEvaluatorBase):
    """Precision/Recall/F1/AuROC/AuPR/Error, the confusion counts, log loss
    and threshold curves."""

    default_metric = "AuPR"
    larger_better = True

    def __init__(self, num_threshold_bins: int = 100, **kw):
        super().__init__(**kw)
        self.num_threshold_bins = num_threshold_bins

    def evaluate_all(self, table: FeatureTable) -> Dict[str, object]:
        label, parts = self._extract(table)
        prob = parts.get("probability")
        scores = (prob[:, 1] if prob is not None and prob.shape[1] > 1
                  else parts["prediction"]).to(torch.float32)
        # rows padded to the JAX package's bucket: mask False, score -1
        # (below every threshold), so the metrics see the same arrays
        n = label.shape[0]
        n_pad = bucket_for(n)
        dev = scores.device
        lab = torch.zeros(n_pad, dtype=torch.float32, device=dev)
        lab[:n] = label.to(dev)
        sc = torch.full((n_pad,), -1.0, dtype=torch.float32, device=dev)
        sc[:n] = scores
        mask = torch.zeros(n_pad, dtype=torch.bool, device=dev)
        mask[:n] = True
        return self._metrics(lab, sc, mask)

    def _metrics(self, label, scores, mask) -> Dict[str, object]:
        w = mask.to(scores.dtype)
        pred = (scores >= 0.5).to(scores.dtype) * w
        pos = (label > 0.5).to(scores.dtype) * w
        tp = float((pred * pos).sum())
        fp = float((pred * (w - pos)).sum())
        fn = float(((w - pred) * pos).sum())
        tn = float(w.sum()) - tp - fp - fn
        precision = tp / (tp + fp) if tp + fp > 0 else 0.0
        recall = tp / (tp + fn) if tp + fn > 0 else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if precision + recall > 0 else 0.0)
        n = tp + tn + fp + fn
        thr, p_curve, r_curve, f1_curve = threshold_metrics(
            scores, label, num_bins=self.num_threshold_bins)
        return {
            "Precision": precision, "Recall": recall, "F1": f1,
            "AuROC": float(auroc_masked(scores, label, mask)),
            "AuPR": float(aupr_masked(scores, label, mask)),
            "Error": (fp + fn) / n if n > 0 else 0.0,
            "TP": tp, "TN": tn, "FP": fp, "FN": fn,
            "LogLoss": float(log_loss_masked(scores, label, mask)),
            "thresholds": thr.tolist(),
            "precisionByThreshold": p_curve.tolist(),
            "recallByThreshold": r_curve.tolist(),
            "f1ByThreshold": f1_curve.tolist(),
        }


class OpBinScoreEvaluator(OpEvaluatorBase):
    """Calibration bins and the Brier score: scores cut into ``num_bins``
    equal bins of [0, 1] (a score of exactly 1 in the last), each bin's
    count, average score and conversion rate, in float64 on the host as in
    the JAX package."""

    default_metric = "BrierScore"
    larger_better = False

    def __init__(self, num_bins: int = 100, **kw):
        super().__init__(**kw)
        self.num_bins = num_bins

    def evaluate_all(self, table: FeatureTable) -> Dict[str, object]:
        label, parts = self._extract(table)
        prob = parts.get("probability")
        scores = (prob[:, 1] if prob is not None and prob.shape[1] > 1
                  else parts["prediction"])
        scores = scores.cpu().numpy().astype(np.float64)
        label = label.cpu().numpy().astype(np.float64)
        bins = np.clip((scores * self.num_bins).astype(int), 0,
                       self.num_bins - 1)
        counts = np.bincount(bins, minlength=self.num_bins).astype(
            np.float64)
        score_sum = np.bincount(bins, weights=scores,
                                minlength=self.num_bins)
        label_sum = np.bincount(bins, weights=label, minlength=self.num_bins)
        nz = np.maximum(counts, 1.0)
        return {
            "BrierScore": float(((scores - label) ** 2).mean()),
            "binCenters": ((np.arange(self.num_bins) + 0.5)
                           / self.num_bins).tolist(),
            "numberOfDataPoints": counts.tolist(),
            "averageScore": (score_sum / nz).tolist(),
            "averageConversionRate": (label_sum / nz).tolist(),
        }
