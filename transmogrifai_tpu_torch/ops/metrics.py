"""Evaluation metrics (counterpart of ``transmogrifai_tpu.ops.metrics``), in
f32 on the scores' device: exact AuROC (Mann-Whitney with average-tie
ranks) and AuPR (linear interpolation over tie-group boundaries), their
masked forms, the binned threshold curves used from ``_BINNED_MIN_N`` rows
on, threshold metrics and log loss; the multiclass metrics (weighted by
class support, from a confusion matrix of one-hot counts) and the
regression metrics."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .stats import _rank

#: from this many rows on, AuROC/AuPR use binned threshold curves
_BINNED_MIN_N = 100_000
_NUM_BINS = 4096


def _binned_hists(scores: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(positive counts, total counts) per score bin, (_NUM_BINS,) each,
    over the masked rows; bins span the masked score range."""
    inf = torch.tensor(float("inf"), dtype=scores.dtype, device=scores.device)
    smin = torch.where(mask, scores, inf).min()
    smax = torch.where(mask, scores, -inf).max()
    width = torch.clamp(smax - smin, min=1e-12)
    idx = torch.clamp(((scores - smin) / width * _NUM_BINS).to(torch.int32),
                      0, _NUM_BINS - 1).long()
    pos = mask & (labels > 0.5)
    hp = torch.bincount(idx[pos], minlength=_NUM_BINS)
    ha = torch.bincount(idx[mask], minlength=_NUM_BINS)
    return hp.to(torch.float32), ha.to(torch.float32)


def _shift(x: torch.Tensor, first: float) -> torch.Tensor:
    """[first, x[0], ..., x[-2]]."""
    return torch.cat([x.new_full((1,), first), x[:-1]])


def _auroc_from_hists(hp: torch.Tensor, ha: torch.Tensor) -> torch.Tensor:
    """Trapezoid over the binned ROC curve (each bin one tie group)."""
    hp, ha = hp.flip(0), ha.flip(0)
    ctp, cfp = torch.cumsum(hp, 0), torch.cumsum(ha - hp, 0)
    n_pos, n_neg = ctp[-1], cfp[-1]
    tpr = ctp / torch.clamp(n_pos, min=1.0)
    fpr = cfp / torch.clamp(n_neg, min=1.0)
    area = ((fpr - _shift(fpr, 0.0)) * (tpr + _shift(tpr, 0.0)) / 2).sum()
    return torch.where((n_pos > 0) & (n_neg > 0), area,
                       torch.zeros_like(area))


def _aupr_from_hists(hp: torch.Tensor, ha: torch.Tensor) -> torch.Tensor:
    """Binned precision-recall curve, first point (recall 0, precision 1)."""
    hp, ha = hp.flip(0), ha.flip(0)
    ctp, cfp = torch.cumsum(hp, 0), torch.cumsum(ha - hp, 0)
    rec = ctp / torch.clamp(ctp[-1], min=1.0)
    prec = ctp / torch.clamp(ctp + cfp, min=1.0)
    return ((rec - _shift(rec, 0.0)) * (prec + _shift(prec, 1.0)) / 2).sum()


def _use_binned(n: int, binned: Optional[bool]) -> bool:
    return binned if binned is not None else n >= _BINNED_MIN_N


def auroc_masked(scores: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor, binned: Optional[bool] = None
                 ) -> torch.Tensor:
    """AuROC over the masked rows. Masked rows get +inf scores (ranked
    above every valid row, so valid ranks stay 1..n_valid) and leave the
    positive/negative counts. ``binned`` pins the algorithm; by default it
    follows the row count."""
    if _use_binned(scores.shape[0], binned):
        return _auroc_from_hists(*_binned_hists(scores, labels, mask))
    s = torch.where(mask, scores, torch.full_like(scores, float("inf")))
    pos = (labels > 0.5) & mask
    n_pos = pos.sum().to(scores.dtype)
    n_neg = mask.sum().to(scores.dtype) - n_pos
    u = (_rank(s) * pos.to(scores.dtype)).sum() - n_pos * (n_pos + 1) / 2.0
    auc = u / torch.clamp(n_pos * n_neg, min=1.0)
    return torch.where((n_pos > 0) & (n_neg > 0), auc, torch.zeros_like(auc))


def aupr_masked(scores: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor, binned: Optional[bool] = None
                ) -> torch.Tensor:
    """AuPR over the masked rows (masked rows sink to -inf and add nothing
    to the cumulative counts). Points sit at the last row of each tie
    group; the first point is (recall 0, precision 1)."""
    if _use_binned(scores.shape[0], binned):
        return _aupr_from_hists(*_binned_hists(scores, labels, mask))
    n = scores.shape[0]
    s_in = torch.where(mask, scores, torch.full_like(scores, -float("inf")))
    order = torch.argsort(-s_in, stable=True)
    s = s_in[order]
    valid = mask[order].to(scores.dtype)
    y = (labels[order] > 0.5).to(scores.dtype) * valid
    cum_tp = torch.cumsum(y, 0)
    cum_fp = torch.cumsum(valid - y, 0)
    boundary = torch.ones(n, dtype=torch.bool, device=scores.device)
    boundary[:-1] = s[1:] != s[:-1]
    recall = cum_tp / torch.clamp(cum_tp[-1], min=1.0)
    precision = cum_tp / torch.clamp(cum_tp + cum_fp, min=1.0)
    # each boundary's previous boundary (or the curve's first point)
    idx = torch.arange(n, device=scores.device)
    b_idx = torch.where(boundary, idx, torch.full_like(idx, -1))
    prev_b = _shift(torch.cummax(b_idx, 0).values, -1)
    has = prev_b >= 0
    at = torch.clamp(prev_b, min=0)
    r_prev = torch.where(has, recall[at], torch.zeros_like(recall))
    p_prev = torch.where(has, precision[at], torch.ones_like(precision))
    seg = (recall - r_prev) * (precision + p_prev) / 2.0
    return torch.where(boundary, seg, torch.zeros_like(seg)).sum()


def auroc(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """AuROC over every row."""
    return auroc_masked(scores, labels, torch.ones_like(scores,
                                                         dtype=torch.bool))


def aupr(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """AuPR over every row."""
    return aupr_masked(scores, labels, torch.ones_like(scores,
                                                       dtype=torch.bool))


def binary_threshold_metrics_masked(scores: torch.Tensor,
                                    labels: torch.Tensor, mask: torch.Tensor,
                                    threshold: float = 0.5
                                    ) -> Dict[str, torch.Tensor]:
    """Precision/Recall/F1/Error at a probability threshold, masked."""
    w = mask.to(scores.dtype)
    pred = (scores >= threshold).to(scores.dtype) * w
    pos = (labels > 0.5).to(scores.dtype) * w
    tp = (pred * pos).sum()
    fp = (pred * (w - pos)).sum()
    fn = ((w - pred) * pos).sum()
    prec = tp / torch.clamp(tp + fp, min=1.0)
    rec = tp / torch.clamp(pos.sum(), min=1.0)
    f1 = torch.where(prec + rec > 0,
                     2 * prec * rec / torch.clamp(prec + rec, min=1e-30),
                     torch.zeros_like(prec))
    err = (fp + fn) / torch.clamp(w.sum(), min=1.0)
    return {"Precision": prec, "Recall": rec, "F1": f1, "Error": err}


def log_loss_masked(scores: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Binary log loss over the masked rows."""
    p = torch.clamp(scores, 1e-15, 1 - 1e-15)
    y = (labels > 0.5).to(scores.dtype)
    w = mask.to(scores.dtype)
    ll = -(y * torch.log(p) + (1 - y) * torch.log(1 - p)) * w
    return ll.sum() / torch.clamp(w.sum(), min=1.0)


def threshold_metrics(scores: torch.Tensor, labels: torch.Tensor,
                      num_bins: int = 100):
    """(thresholds, precision, recall, F1) at ``num_bins`` evenly spaced
    thresholds in [0, 1]."""
    thresholds = (torch.arange(num_bins, dtype=torch.float32,
                               device=scores.device)
                  / float(max(num_bins - 1, 1)))
    pos = (labels > 0.5).to(scores.dtype)
    pred = (scores[None, :] >= thresholds[:, None]).to(scores.dtype)
    tp = (pred * pos[None, :]).sum(1)
    fp = (pred * (1 - pos)[None, :]).sum(1)
    prec = tp / torch.clamp(tp + fp, min=1.0)
    rec = tp / torch.clamp(pos.sum(), min=1.0)
    f1 = torch.where(prec + rec > 0,
                     2 * prec * rec / torch.clamp(prec + rec, min=1e-30),
                     torch.zeros_like(prec))
    return thresholds, prec, rec, f1


def _weighted_class_metrics(cm: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Error and support-weighted Precision/Recall/F1 of a (C, C)
    confusion matrix (rows the label, columns the prediction)."""
    n = torch.clamp(cm.sum(), min=1.0)
    support = cm.sum(1)
    pred_cnt = cm.sum(0)
    tp = torch.diagonal(cm)
    prec_c = tp / torch.clamp(pred_cnt, min=1.0)
    rec_c = tp / torch.clamp(support, min=1.0)
    f1_c = torch.where(prec_c + rec_c > 0,
                       2 * prec_c * rec_c
                       / torch.clamp(prec_c + rec_c, min=1e-30),
                       torch.zeros_like(prec_c))
    wgt = support / n
    return {"Error": 1.0 - torch.trace(cm) / n,
            "Precision": (prec_c * wgt).sum(),
            "Recall": (rec_c * wgt).sum(),
            "F1": (f1_c * wgt).sum()}


def _one_hot_f32(idx: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Float32 one-hot rows; an index outside [0, num_classes) is all
    zero, as ``jax.nn.one_hot`` makes it."""
    cls = torch.arange(num_classes, device=idx.device)
    return (idx.long()[:, None] == cls[None, :]).to(torch.float32)


def multiclass_confusion(pred_idx: torch.Tensor, label_idx: torch.Tensor,
                         num_classes: int) -> torch.Tensor:
    """(C, C) confusion counts, rows the label, columns the prediction."""
    return (_one_hot_f32(label_idx, num_classes)[:, :, None]
            * _one_hot_f32(pred_idx, num_classes)[:, None, :]).sum(0)


def multiclass_metrics_masked(pred_idx: torch.Tensor, label_idx: torch.Tensor,
                              mask: torch.Tensor, num_classes: int
                              ) -> Dict[str, torch.Tensor]:
    """Error and weighted Precision/Recall/F1 over the masked rows."""
    w = mask.to(torch.float32)[:, None]
    cm = ((_one_hot_f32(label_idx, num_classes) * w)[:, :, None]
          * (_one_hot_f32(pred_idx, num_classes) * w)[:, None, :]).sum(0)
    return _weighted_class_metrics(cm)


def multiclass_metrics(pred_idx: torch.Tensor, label_idx: torch.Tensor,
                       num_classes: int) -> Dict[str, torch.Tensor]:
    """Error and weighted Precision/Recall/F1 over every row (the
    reference's OpMultiClassificationEvaluator defaults)."""
    return _weighted_class_metrics(
        multiclass_confusion(pred_idx, label_idx, num_classes))


def regression_metrics_masked(pred: torch.Tensor, label: torch.Tensor,
                              mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """RMSE/MSE/MAE/R2 over the masked rows."""
    w = mask.to(pred.dtype)
    cnt = torch.clamp(w.sum(), min=1.0)
    err = (pred - label) * w
    sse = (err * err).sum()
    mse = sse / cnt
    label_mean = (label * w).sum() / cnt
    dev = (label - label_mean) * w
    ss_tot = (dev * dev).sum()
    r2 = torch.where(ss_tot > 0,
                     1.0 - sse / torch.clamp(ss_tot, min=1e-30),
                     torch.zeros_like(ss_tot))
    return {"RootMeanSquaredError": torch.sqrt(mse), "MeanSquaredError": mse,
            "MeanAbsoluteError": err.abs().sum() / cnt, "R2": r2}


def regression_metrics(pred: torch.Tensor, label: torch.Tensor
                       ) -> Dict[str, torch.Tensor]:
    """RMSE/MSE/MAE/R2 over every row (the reference's
    OpRegressionEvaluator)."""
    err = pred - label
    sse = (err * err).sum()
    mse = sse / err.shape[0]
    dev = label - label.mean()
    ss_tot = (dev * dev).sum()
    r2 = torch.where(ss_tot > 0,
                     1.0 - sse / torch.clamp(ss_tot, min=1e-30),
                     torch.zeros_like(ss_tot))
    return {"RootMeanSquaredError": torch.sqrt(mse), "MeanSquaredError": mse,
            "MeanAbsoluteError": err.abs().mean(), "R2": r2}


def multiclass_log_loss(probs: torch.Tensor,
                        label_idx: torch.Tensor) -> torch.Tensor:
    """Mean negative log probability of each row's label."""
    p = torch.clamp(probs, 1e-15, 1.0)
    picked = p.gather(1, label_idx.long()[:, None])[:, 0]
    return -torch.log(picked).mean()
