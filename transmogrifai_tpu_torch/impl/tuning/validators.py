"""Validators (counterpart of ``transmogrifai_tpu.impl.tuning.validators``):
k-fold cross-validation and a single train/validation split, over a
family's whole grid at once.

Folds are 0/1 row weights, so the |folds| x |grid| sweep of a family is one
``sweep_fit_batch`` call. Each configuration is then scored on its own
fold's validation rows (at most ``max_eval_rows`` of them, a strided
subsample) and the validation metric is computed per configuration.

``validate(..., val_masks=...)`` takes explicit (F, n) validation masks:
workflow-level CV validates one externally prepared fold at a time.

This is the single-device path. The JAX package's sweep checkpoints and
memory-pressure grid splitting (ROADMAP Queue 1 item 9), mesh sharding
(item 10), fused program cache, AOT program store and chaos sites are not
ported.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...models.api import ModelFamily
from ...ops.metrics import (
    _BINNED_MIN_N, aupr_masked, auroc_masked, binary_threshold_metrics_masked,
    log_loss_masked, multiclass_metrics_masked, regression_metrics_masked,
)
from ...utils.padding import bucket_for


@dataclass
class ValidationResult:
    """Per-(family, grid point) validation metrics of the sweep."""
    family: str
    grid: List[Dict[str, Any]]
    metric_name: str
    fold_metrics: Any        # (F, G)
    mean_metrics: Any        # (G,)

    def to_json(self) -> Dict[str, Any]:
        def host(m):
            return (m.cpu().numpy() if isinstance(m, torch.Tensor)
                    else np.asarray(m)).tolist()
        return {"modelType": self.family, "metricName": self.metric_name,
                "grid": self.grid, "foldMetrics": host(self.fold_metrics),
                "meanMetrics": host(self.mean_metrics)}


@dataclass
class BestEstimator:
    """Winner of validation, with every family's results and the
    candidates quarantined for non-finite metrics."""
    family_name: str
    hyper: Dict[str, Any]
    metric_value: float
    results: List[ValidationResult] = field(default_factory=list)
    quarantined: List[Dict[str, Any]] = field(default_factory=list)


class AllCandidatesFailedError(RuntimeError):
    """Every candidate of the sweep was quarantined."""

    def __init__(self, records: List[Dict[str, Any]]):
        self.records = list(records)
        lines = [f"  - {r.get('family')}[{r.get('gridIndex')}] "
                 f"{r.get('hyper')}: {r.get('reason')}" for r in self.records]
        super().__init__("all %d sweep candidate(s) were quarantined:\n%s"
                         % (len(self.records), "\n".join(lines)))


def quarantine_non_finite(family: str, grid: List[Dict[str, Any]],
                          fold_metrics: np.ndarray, metric_name: str,
                          larger_better: bool
                          ) -> Tuple[np.ndarray, np.ndarray,
                                     List[Dict[str, Any]]]:
    """(mean metrics, means with non-finite entries made the worst value,
    one record per non-finite config) of an (F, G) metric matrix."""
    mean_metrics = fold_metrics.mean(axis=0)
    finite = np.isfinite(mean_metrics)
    records = [{"family": family, "gridIndex": int(g),
                "hyper": dict(grid[g]) if g < len(grid) else {},
                "metricName": metric_name,
                "foldMetrics": [float(v) for v in fold_metrics[:, g]],
                "reason": ("non-finite validation metric "
                           f"({mean_metrics[g]!r})")}
               for g in np.nonzero(~finite)[0]]
    if finite.all():
        return mean_metrics, mean_metrics, records
    worst = -np.inf if larger_better else np.inf
    return mean_metrics, np.where(finite, mean_metrics, worst), records


def _metric_fn(problem: str, metric: str, binned: Optional[bool] = None,
               num_classes: int = 2
               ) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                             torch.Tensor]:
    """Per-configuration metric over scores, labels and validation masks
    -> (B,) f32: binary (B, n) probabilities of class 1, multiclass
    (B, n, C) probabilities (scored by their argmax), regression (B, n)
    predictions."""
    if problem == "binary":
        if metric in ("AuPR", "AuROC"):
            base = {"AuPR": aupr_masked, "AuROC": auroc_masked}[metric]

            def one(s, y, m):
                return base(s, y, m, binned=binned)
        elif metric in ("Precision", "Recall", "F1", "Error"):
            def one(s, y, m):
                return binary_threshold_metrics_masked(s, y, m)[metric]
        elif metric == "LogLoss":
            one = log_loss_masked
        else:
            raise ValueError(f"unknown binary validation metric '{metric}'")
    elif problem == "multiclass":
        if metric not in ("F1", "Precision", "Recall", "Error"):
            raise ValueError(f"unknown multiclass validation metric "
                             f"'{metric}'")

        def one(probs, y, m):
            return multiclass_metrics_masked(
                probs.argmax(dim=-1), y.to(torch.int32), m,
                num_classes)[metric]
    elif problem == "regression":
        if metric not in ("RootMeanSquaredError", "MeanSquaredError",
                          "MeanAbsoluteError", "R2"):
            raise ValueError(f"unknown regression validation metric "
                             f"'{metric}'")

        def one(pred, y, m):
            return regression_metrics_masked(pred, y, m)[metric]
    else:
        raise ValueError(f"unknown problem kind '{problem}'")

    def batched(scores, Y, VM):
        return torch.stack([one(scores[b], Y[b], VM[b])
                            for b in range(scores.shape[0])])
    return batched


class OpValidator:
    """Shared validation machinery.

    ``max_eval_rows``: each configuration is scored on at most this many of
    its fold's validation rows (a deterministic strided subsample; None =
    every row). CV candidates fit through ``sweep_fit_batch``, or through
    ``fit_batch`` (full precision, the refit's schedule) with
    ``exact_sweep_fits``."""

    def __init__(self, seed: int = 42, stratify: bool = False,
                 max_eval_rows: Optional[int] = 32768,
                 exact_sweep_fits: bool = False):
        self.seed = seed
        self.stratify = stratify
        self.max_eval_rows = max_eval_rows
        self.exact_sweep_fits = exact_sweep_fits

    def make_splits(self, y: np.ndarray) -> np.ndarray:
        """(F, n) boolean validation masks; train mask = ~val."""
        raise NotImplementedError

    def _kfold_masks(self, y: np.ndarray, k: int) -> np.ndarray:
        n = len(y)
        rng = np.random.RandomState(self.seed)
        masks = np.zeros((k, n), dtype=bool)
        if self.stratify:
            # per-class round-robin folds
            for lab in np.unique(y):
                idx = rng.permutation(np.nonzero(y == lab)[0])
                for f in range(k):
                    masks[f, idx[f::k]] = True
        else:
            perm = rng.permutation(n)
            for f in range(k):
                masks[f, perm[f::k]] = True
        return masks

    def _fold_data(self, X, y, vm_np: np.ndarray):
        """Each fold's validation rows (capped at ``max_eval_rows``),
        gathered into (F, nf_b, ...) with validity masks; nf_b is the row
        bucket of the largest fold."""
        F = vm_np.shape[0]
        cap = self.max_eval_rows
        nf = int(vm_np.sum(axis=1).max()) if F > 0 else 0
        if cap is not None and nf > cap:
            nf = cap
        nf_b = bucket_for(max(nf, 1))
        fidx = np.zeros((F, nf_b), np.int64)
        fvalid = np.zeros((F, nf_b), bool)
        for f in range(F):
            rows = np.nonzero(vm_np[f])[0]
            if cap is not None and len(rows) > cap:
                rows = rows[np.linspace(0, len(rows) - 1, cap)
                            .astype(np.int64)]
            fidx[f, :len(rows)] = rows
            fvalid[f, :len(rows)] = True
        fidx_d = torch.as_tensor(fidx.reshape(-1), device=X.device)
        return (X[fidx_d].reshape((F, nf_b) + tuple(X.shape[1:])),
                y[fidx_d].reshape(F, nf_b),
                torch.as_tensor(fvalid, device=X.device))

    def validate(self, models: Sequence[Tuple[ModelFamily,
                                              List[Dict[str, Any]]]],
                 X: torch.Tensor, y: torch.Tensor, problem: str,
                 metric_name: str, larger_better: bool, num_classes: int,
                 val_masks: Optional[np.ndarray] = None) -> BestEstimator:
        """The |families| x |grid| x |folds| sweep on X's device."""
        if val_masks is None:
            val_masks = self.make_splits(y.cpu().numpy())
        vm_np = np.asarray(val_masks)
        F, n = vm_np.shape
        if F > 1 and int(vm_np.sum(axis=0).max()) > 1:
            raise ValueError("validation masks must be disjoint (each row in "
                             "at most one fold)")
        # rows padded to the JAX package's bucket: the tree fits sample and
        # bin the padded matrix, so the bucket shapes the fitted trees. Pad
        # rows carry zero weight and are never validated.
        n_pad = bucket_for(n)
        if n_pad != n:
            X = torch.nn.functional.pad(X, (0, 0, 0, n_pad - n))
            y = torch.nn.functional.pad(y, (0, n_pad - n))
        fold_ids = np.full(n_pad, F + 1, np.int64)       # F + 1: padding
        fold_ids[:n] = np.where(vm_np.any(axis=0), vm_np.argmax(axis=0), F)
        ids = torch.as_tensor(fold_ids, device=X.device)
        train_w = ((ids[None, :] != torch.arange(F, device=X.device)[:, None])
                   & (ids[None, :] != F + 1)).to(torch.float32)  # (F, n_pad)
        Xf, yf, fvalid = self._fold_data(X, y, vm_np)
        # AuROC/AuPR algorithm pinned by the padded row count, as in the
        # JAX package's fold-sliced scoring
        binned = n_pad >= _BINNED_MIN_N
        metric = _metric_fn(problem, metric_name, binned=binned,
                            num_classes=num_classes)
        results: List[ValidationResult] = []
        quarantined: List[Dict[str, Any]] = []
        best: Optional[BestEstimator] = None
        for family, grid in models:
            G = len(grid)
            garr = family.grid_to_arrays(grid)
            tiled = {k: np.tile(v, F) for k, v in garr.items()}
            W = train_w.repeat_interleave(G, dim=0)          # (F * G, n_pad)
            fit = (family.fit_batch if self.exact_sweep_fits
                   else family.sweep_fit_batch)
            params = fit(X, y, W, tiled, num_classes)
            scores = torch.cat([
                family.predict_batch(
                    family.slice_params(params, f * G, (f + 1) * G),
                    Xf[f], num_classes) for f in range(F)])  # (F*G, nf_b[, C])
            m = metric(scores, yf.repeat_interleave(G, dim=0),
                       fvalid.repeat_interleave(G, dim=0))
            fold_metrics = m.cpu().numpy().reshape(F, G)      # f32
            mean_metrics, masked, records = quarantine_non_finite(
                family.name, list(grid), fold_metrics, metric_name,
                larger_better)
            quarantined.extend(records)
            results.append(ValidationResult(
                family=family.name, grid=list(grid), metric_name=metric_name,
                fold_metrics=fold_metrics, mean_metrics=mean_metrics))
            if not np.isfinite(mean_metrics).any():
                continue
            g_best = int(np.argmax(masked) if larger_better
                         else np.argmin(masked))
            value = float(mean_metrics[g_best])
            if best is None or ((value > best.metric_value) if larger_better
                                else (value < best.metric_value)):
                best = BestEstimator(family.name, dict(grid[g_best]), value)
        if best is None:
            raise AllCandidatesFailedError(quarantined)
        best.results = results
        best.quarantined = quarantined
        return best


class OpCrossValidation(OpValidator):
    """k-fold CV (default 3 folds)."""

    def __init__(self, num_folds: int = 3, **kw):
        super().__init__(**kw)
        if num_folds < 2:
            raise ValueError("num_folds must be >= 2")
        self.num_folds = num_folds

    def make_splits(self, y: np.ndarray) -> np.ndarray:
        return self._kfold_masks(y, self.num_folds)


class OpTrainValidationSplit(OpValidator):
    """One train/validation split (default train ratio 0.75): a fold axis
    of 1, rows outside the validation mask train only."""

    def __init__(self, train_ratio: float = 0.75, **kw):
        super().__init__(**kw)
        if not 0.0 < train_ratio < 1.0:
            raise ValueError("train_ratio must be in (0, 1)")
        self.train_ratio = train_ratio

    def make_splits(self, y: np.ndarray) -> np.ndarray:
        n = len(y)
        rng = np.random.RandomState(self.seed)
        val = np.zeros((1, n), dtype=bool)
        if self.stratify:
            for lab in np.unique(y):
                idx = rng.permutation(np.nonzero(y == lab)[0])
                n_val = int(round(len(idx) * (1.0 - self.train_ratio)))
                val[0, idx[:n_val]] = True
        else:
            perm = rng.permutation(n)
            val[0, perm[: int(round(n * (1.0 - self.train_ratio)))]] = True
        return val
