"""Validators (counterpart of ``transmogrifai_tpu.impl.tuning.validators``):
k-fold cross-validation and a single train/validation split, over a
family's whole grid at once.

Folds are 0/1 row weights, so the |folds| x |grid| sweep of a family is one
``sweep_fit_batch`` call. Each configuration is then scored on its own
fold's validation rows (at most ``max_eval_rows`` of them, a strided
subsample) and the validation metric is computed per configuration.

``validate(..., val_masks=...)`` takes explicit (F, n) validation masks:
workflow-level CV validates one externally prepared fold at a time.

Robustness, as in the JAX package: a family whose sweep raises is
quarantined (a NaN placeholder and its reason) and the other families go
on; only "every candidate failed" raises ``AllCandidatesFailedError``. A
family that runs out of memory (``torch.cuda.OutOfMemoryError``, a host
``MemoryError`` or the ``oom.sweep`` site) sweeps its grid in halves,
down to single configurations, and the halves' (F, G) metrics are
concatenated: each configuration's metric does not depend on its
batch-mates (a family that seeds per configuration seeds from the
configuration's place in the whole batch, ``models.api.BATCH_INDEX``), so
the merged matrix is the unsplit one bit for bit. Each family's
metrics reach the host as the family finishes (``fetch_to_host``); with a
sweep checkpoint (``ModelSelector.set_sweep_checkpoint``) they are
committed then, and a resumed sweep replays the committed families
(``sweep_checkpoint``). Sites: ``preempt.sweep``,
``validator.family_fit``, ``oom.sweep``, ``hist.build`` (tree families)
and ``validator.fold_metrics``; span ``sweep.family`` and the flight
recorder's ``sweep.family`` event.

This is the single-device path: mesh sharding (ROADMAP Queue 1 item 10)
and the JAX package's fused program cache and AOT program store are not
ported.
"""
from __future__ import annotations

import hashlib
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...models.api import BATCH_INDEX, ModelFamily
from ...observability import blackbox as _blackbox
from ...observability import devicemem as _devicemem
from ...observability import metrics as _obs_metrics
from ...observability import trace as _obs_trace
from ...observability.trace import span as _obs_span
from ...ops.metrics import (
    _BINNED_MIN_N, aupr_masked, auroc_masked, binary_threshold_metrics_masked,
    log_loss_masked, multiclass_metrics_masked, regression_metrics_masked,
)
from ...parallel.distributed import fetch_to_host
from ...robustness import faults
from ...robustness.guards import (  # noqa: F401 (the old names resolve)
    AllCandidatesFailedError, quarantine_non_finite,
)
from ...robustness.policy import FaultLog, FaultReport
from ...utils.fidelity import ROUND4_MAX_EVAL_ROWS, round4_defaults
from ...utils.padding import bucket_for

logger = logging.getLogger(__name__)


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
    every row); left unset it is 32768, or 65536 under
    ``TG_SWEEP_FIDELITY=round4`` (``utils.fidelity``). CV candidates fit through ``sweep_fit_batch``, or through
    ``fit_batch`` (full precision, the refit's schedule) with
    ``exact_sweep_fits``."""

    #: "the caller did not choose": the constructor reads the switch
    _EVAL_ROWS_DEFAULT = -1

    def __init__(self, seed: int = 42, stratify: bool = False,
                 max_eval_rows: Optional[int] = _EVAL_ROWS_DEFAULT,
                 exact_sweep_fits: bool = False):
        if max_eval_rows == self._EVAL_ROWS_DEFAULT:
            max_eval_rows = (ROUND4_MAX_EVAL_ROWS if round4_defaults()
                             else 32768)
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
        # the sweep checkpoint's run fingerprint, before padding, as the
        # JAX package takes it (its labels are float32): a record replays
        # only onto the same data, folds and sweep settings
        sweep_ckpt = getattr(self, "_sweep_ckpt", None)
        fingerprint = None
        if sweep_ckpt is not None:
            y_host = np.asarray(y.detach().cpu().numpy()[:n], np.float32)
            fingerprint = {
                "n": int(n), "F": int(F), "problem": problem,
                "d": int(X.shape[-1]) if X.dim() > 1 else 1,
                "metric": metric_name, "numClasses": int(num_classes),
                "largerBetter": bool(larger_better),
                "exact": bool(self.exact_sweep_fits),
                "maxEvalRows": self.max_eval_rows,
                "yhash": hashlib.sha256(
                    np.ascontiguousarray(y_host).tobytes()).hexdigest(),
                "foldHash": hashlib.sha256(
                    np.ascontiguousarray(vm_np).tobytes()).hexdigest(),
            }
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

        def dispatch_once(family, grid, first: int, G_all: int
                          ) -> torch.Tensor:
            """One family's sweep over ``grid``, configurations ``first``
            onward of its ``G_all``: (F, G) metrics on the device."""
            from ...manifest import sentinel_phase
            # a kill past here happened inside device work
            sentinel_phase("device_sweep")
            if getattr(family, "uses_hist_engine", False):
                from ...histeng import chaos_gate
                chaos_gate(family.name)
            G = len(grid)
            garr = family.grid_to_arrays(grid)
            tiled = {k: np.tile(v, F) for k, v in garr.items()}
            # each configuration's place in the whole family's batch, so a
            # part of a split grid seeds as in the whole one
            tiled[BATCH_INDEX] = (
                np.arange(F)[:, None] * G_all + first
                + np.arange(G)[None, :]).reshape(-1).astype(np.float32)
            W = train_w.repeat_interleave(G, dim=0)          # (F * G, n_pad)
            _devicemem.record_dispatch(
                "sweep", X.numel() * X.element_size()
                + y.numel() * y.element_size() + W.numel() * 4,
                bucket=int(n_pad))
            fit = (family.fit_batch if self.exact_sweep_fits
                   else family.sweep_fit_batch)
            params = fit(X, y, W, tiled, num_classes)
            scores = torch.cat([
                family.predict_batch(
                    family.slice_params(params, f * G, (f + 1) * G),
                    Xf[f], num_classes) for f in range(F)])  # (F*G, nf_b[, C])
            m = metric(scores, yf.repeat_interleave(G, dim=0),
                       fvalid.repeat_interleave(G, dim=0))
            _devicemem.sample_measured("sweep")
            return m.reshape(F, G)

        def dispatch(family, grid, first: int = 0,
                     G_all: Optional[int] = None) -> torch.Tensor:
            """``dispatch_once``, with the grid split in halves (down to
            single configurations) while it runs out of memory; the
            halves' metrics concatenate along the configuration axis.
            Other errors, and a single configuration that still runs out,
            are raised to the family's quarantine."""
            G_all = len(grid) if G_all is None else G_all
            try:
                faults.inject("oom.sweep", key=family.name)
                return dispatch_once(family, grid, first, G_all)
            except Exception as e:
                from ...robustness import resources
                if resources.classify_exhaustion(e) is None or len(grid) < 2:
                    raise
                mid = len(grid) // 2
                resources.record_downshift(
                    "oom.sweep", family=family.name, configs=len(grid),
                    splitConfigs=[mid, len(grid) - mid],
                    error=f"{type(e).__name__}: {e}"[:200])
                logger.warning(
                    "sweep of %s ran out of memory at %d configs; splitting "
                    "the grid into %d + %d", family.name, len(grid), mid,
                    len(grid) - mid)
                del e
                if X.device.type == "cuda":
                    torch.cuda.empty_cache()
                return torch.cat(
                    [dispatch(family, grid[:mid], first, G_all),
                     dispatch(family, grid[mid:], first + mid, G_all)],
                    dim=1)

        #: (F, G) host metrics by family index: restored, or fetched as
        #: each family finishes
        host_metrics: Dict[int, np.ndarray] = {}
        fit_failures: Dict[int, str] = {}
        for fi, (family, grid) in enumerate(models):
            grid = list(grid)
            ckey = None
            if sweep_ckpt is not None:
                from .sweep_checkpoint import SweepCheckpoint, candidate_key
                ckey = candidate_key(family.name, grid, fingerprint)
                rec = sweep_ckpt.get(ckey)
                if rec is not None:
                    fm = SweepCheckpoint.decode_metrics(rec)
                    if fm.shape == (F, len(grid)):
                        host_metrics[fi] = fm
                        if rec.get("quarantined"):
                            fit_failures[fi] = (rec.get("reason")
                                                or "restored quarantined "
                                                   "candidate")
                        FaultLog.record(FaultReport(
                            site="sweep.candidate", kind="restored",
                            detail={"family": family.name,
                                    "configs": len(grid),
                                    "candidateKey": ckey[:16],
                                    "quarantined": bool(
                                        rec.get("quarantined"))}))
                        logger.info("sweep resume: restored %d %s "
                                    "candidate(s) from checkpoint",
                                    len(grid), family.name)
                        continue
            with _obs_span("sweep.family", cat="sweep", family=family.name,
                           configs=len(grid), folds=F,
                           metric=metric_name) as sweep_span:
                _blackbox.record("sweep.family", family=family.name,
                                 configs=len(grid), folds=F)
                try:
                    # a kill here keeps the families already committed
                    faults.inject("preempt.sweep", key=family.name)
                    faults.inject("validator.family_fit", key=family.name)
                    m = dispatch(family, grid)
                    t0 = time.perf_counter()
                    host_metrics[fi] = fetch_to_host(m)       # f32 (F, G)
                    _obs_metrics.observe(
                        "tg_sweep_transfer_seconds",
                        time.perf_counter() - t0,
                        help="device->host validation-metric fetch per "
                             "family")
                except Exception as e:
                    reason = f"fit raised {type(e).__name__}: {e}"
                    logger.warning("quarantining model family %s: %s",
                                   family.name, reason)
                    fit_failures[fi] = reason
                    sweep_span.add_event("sweep.family_quarantined",
                                         family=family.name, reason=reason)
            if sweep_ckpt is not None:
                from .sweep_checkpoint import SweepCheckpoint, params_hash
                fm_host = host_metrics.get(
                    fi, np.full((F, len(grid)), np.nan))
                sweep_ckpt.put(ckey, {
                    "family": family.name,
                    "grid": [dict(g) for g in grid],
                    "paramsHashes": [params_hash(g) for g in grid],
                    "metricName": metric_name,
                    **SweepCheckpoint.encode_metrics(fm_host),
                    "quarantined": fi in fit_failures,
                    "reason": fit_failures.get(fi),
                })

        results: List[ValidationResult] = []
        quarantined: List[Dict[str, Any]] = []
        best: Optional[BestEstimator] = None
        for fi, (family, grid) in enumerate(models):
            grid = list(grid)
            fold_metrics = host_metrics.get(fi)
            if fold_metrics is None:         # the family's sweep raised
                fold_metrics = np.full((F, len(grid)), np.nan)
            fold_metrics = faults.poison("validator.fold_metrics",
                                         fold_metrics, key=family.name)
            mean_metrics, masked, records = quarantine_non_finite(
                family.name, grid, fold_metrics, metric_name,
                larger_better, reason=fit_failures.get(fi))
            quarantined.extend(records)
            results.append(ValidationResult(
                family=family.name, grid=grid, metric_name=metric_name,
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
        _obs_trace.add_event("sweep.winner", family=best.family_name,
                             metricValue=float(best.metric_value))
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
