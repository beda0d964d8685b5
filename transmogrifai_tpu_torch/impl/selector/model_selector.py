"""ModelSelector (counterpart of
``transmogrifai_tpu.impl.selector.model_selector``): the splitter reserves
a holdout and balances the train rows, the validator sweeps families x
grids x folds, the winner refits on the full prepared train rows, and the
fitted ``SelectedModel`` emits a Prediction column on the device. Binary,
multiclass (labels re-indexed by a ``DataCutter``, predictions mapped back)
and regression problems.

Without ``models=`` a selector sweeps the reference's default model list
of its problem kind. A winner whose refit throws or yields non-finite
parameters yields to the next-ranked candidate (at most
``_MAX_REFIT_ATTEMPTS`` are tried), as in the JAX package.

Workflow-level CV (``find_best_estimator``) validates with fold copies of
the label-dependent stages that feed the selector and records the winner,
which the next ``fit`` refits without a sweep of its own.

``set_sweep_checkpoint`` (wired by ``OpWorkflow.with_checkpoint_dir``)
makes the sweep resumable (``impl.tuning.sweep_checkpoint``). Sites:
``preempt.refit`` between the sweep and the refit, and ``selector.refit``
before each refit attempt (a raise there refits the next-ranked
candidate, recorded as ``selector.refit``/``quarantine``). Mesh sharding
is not ported (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...device import synced_clock
from ...models.api import MODEL_REGISTRY, FittedParams, ModelFamily
from ...robustness import faults
from ...robustness.guards import (
    AllCandidatesFailedError, params_finite, quarantine_non_finite,
)
from ...robustness.policy import FaultLog, FaultReport
from ...stages.base import AllowLabelAsInput, Estimator, Transformer
from ...table import Column, FeatureTable
from ...types import OPVector, Prediction, RealNN
from ...utils.padding import bucket_for
from ..tuning.splitters import DataSplitter, PreparedData, Splitter
from ..tuning.validators import BestEstimator, OpCrossValidation, OpValidator

#: refit-fallback depth: how many ranked candidates may be tried when the
#: winner's full-data refit diverges before the train aborts
_MAX_REFIT_ATTEMPTS = 3

#: the reference's default model types per problem kind (NB, DT, XGBoost
#: and MLP are off by default)
DEFAULT_MODELS = {
    "binary": ["OpLogisticRegression", "OpRandomForestClassifier",
               "OpGBTClassifier", "OpLinearSVC"],
    "multiclass": ["OpLogisticRegression", "OpRandomForestClassifier"],
    "regression": ["OpLinearRegression", "OpRandomForestRegressor",
                   "OpGBTRegressor", "OpGeneralizedLinearRegression"],
}

#: each problem kind's default validation metric and its direction
_PROBLEM_METRICS = {"binary": ("AuPR", True), "multiclass": ("F1", True),
                    "regression": ("RootMeanSquaredError", False)}


@dataclass
class ModelSelectorSummary:
    """What the selection sweep found."""
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

    def to_json(self) -> Dict[str, Any]:
        """The JAX package's summary JSON (the fitted model's
        ``summary_metadata``)."""
        return {
            "validationType": self.validation_type,
            "validationMetric": self.validation_metric,
            "problem": self.problem,
            "bestModelType": self.best_model_type,
            "bestHyperparameters": self.best_hyper,
            "bestMetricValue": self.best_metric_value,
            "largerBetter": self.larger_better,
            "validationResults": [r.to_json()
                                  for r in self.validation_results],
            "trainEvaluation": self.train_evaluation,
            "holdoutEvaluation": self.holdout_evaluation,
            "splitterSummary": self.splitter_summary,
            "validationEvalRowCap": self.validation_eval_row_cap,
            "quarantinedCandidates": [dict(r) for r in self.quarantined],
        }


#: the old name of ``robustness.guards.params_finite``
_params_finite = params_finite


class ModelSelector(AllowLabelAsInput, Estimator):
    """Estimator[(RealNN label, OPVector features)] -> Prediction."""

    input_types = (RealNN, OPVector)
    output_type = Prediction

    #: fitted-param keys where +inf is a sentinel, not divergence
    _INF_OK_PARAMS = ("thresh", "thresh_lv")

    def __init__(self, problem: str, validator: Optional[OpValidator] = None,
                 splitter: Optional[Splitter] = None,
                 models: Optional[Sequence[Tuple[Any, Optional[List[Dict]]]]]
                 = None, evaluator=None, uid: Optional[str] = None):
        super().__init__("modelSelector", uid)
        if problem not in _PROBLEM_METRICS:
            raise ValueError(f"unknown problem kind '{problem}'")
        self.problem = problem
        self.validator = validator or OpCrossValidation()
        self.splitter = splitter if splitter is not None else DataSplitter()
        self.evaluator = evaluator
        self.models = self._resolve_models(models)

    def set_sweep_checkpoint(self, ckpt) -> "ModelSelector":
        """Resumable sweeps (wired by ``OpWorkflow.with_checkpoint_dir``):
        each family's fold metrics are committed to ``ckpt`` (a
        ``SweepCheckpoint``) as the family finishes, and a resumed train
        replays the committed families that match its data, folds and
        sweep settings. Train-time wiring only; never saved with the
        model."""
        self.validator._sweep_ckpt = ckpt
        return self

    def _resolve_models(self, models):
        from ...models import glm, linear, mlp, trees  # noqa: F401
        if models is None:
            models = [(name, None) for name in DEFAULT_MODELS[self.problem]]
        resolved: List[Tuple[ModelFamily, List[Dict[str, Any]]]] = []
        for fam, grid in models:
            if isinstance(fam, str):
                fam = MODEL_REGISTRY[fam]
            if self.problem not in fam.supports:
                raise ValueError(f"{fam.name} does not support problem kind "
                                 f"'{self.problem}'")
            if grid is None:
                grid = fam.default_grid(self.problem)
                # test-time knob, as in the JAX package: shrink DEFAULT grids
                # so CPU suites stay fast; passed grids are never touched
                if os.environ.get("TG_FAST_GRIDS", "").lower() in ("1",
                                                                   "true"):
                    logging.getLogger(__name__).warning(
                        "TG_FAST_GRIDS is set: default %s grid truncated "
                        "%d -> 2 configs (test mode)", fam.name, len(grid))
                    grid = grid[:2]
            resolved.append((fam, list(grid)))
        return resolved

    @property
    def validation_metric(self) -> Tuple[str, bool]:
        if self.evaluator is not None:
            return self.evaluator.default_metric, self.evaluator.larger_better
        return _PROBLEM_METRICS[self.problem]

    def _prepared_rows(self, y_all: np.ndarray):
        """(train rows, holdout rows, prepared train rows, label mapping):
        the splitter's holdout, then its balancing or cutting of the
        rest."""
        n = len(y_all)
        if self.splitter is not None and self.splitter.reserve_test_fraction:
            train_idx, test_idx = self.splitter.split(n)
        else:
            train_idx, test_idx = np.arange(n), np.array([], dtype=np.int64)
        prep = (self.splitter.pre_validation_prepare(y_all[train_idx])
                if self.splitter is not None
                else PreparedData(indices=np.arange(len(train_idx))))
        return train_idx, test_idx, train_idx[prep.indices], prep

    def _num_classes(self, y: np.ndarray) -> int:
        return (1 if self.problem == "regression"
                else 2 if self.problem == "binary" else int(y.max()) + 1)

    def find_best_estimator(self, table: FeatureTable,
                            during_layers: Sequence[Sequence[Tuple[Any, int]]]
                            ) -> BestEstimator:
        """Leakage-free validation: for each fold, fit fresh copies of the
        label-dependent stages (``during_layers``) on the fold's training
        rows only, transform the selection rows with them, and validate
        every candidate on that fold's matrix; each candidate's metric is
        its mean over the folds. The winner is recorded for the next
        ``fit``, which skips its sweep and refits it.

        The selection rows are those ``fit`` validates on (the same holdout
        reserved, the splitter's preparation and label mapping). Each fold's
        matrix is padded with zero columns to the widest fold's, as in the
        JAX package, so every fold's sweep sees one width. ``fold_models``
        keeps each fold's fitted copies; ``phase_seconds`` records the fold
        preparation's and the sweep's seconds."""
        label_f, vec_f = self.input_features
        dev = table.device or torch.device("cpu")
        t0 = synced_clock(dev)
        y_all = np.asarray(torch.as_tensor(table[label_f.name].values)
                           .cpu().numpy(), np.float32).reshape(-1)
        _, _, sel_rows, prep = self._prepared_rows(y_all)
        sub = table.take(sel_rows)
        y = y_all[sel_rows]
        if prep.label_mapping:
            y = np.array([prep.label_mapping.get(int(v), -1) for v in y],
                         dtype=np.float32)
        num_classes = self._num_classes(y)
        metric_name, larger_better = self.validation_metric
        val_masks = self.validator.make_splits(y)            # (F, n)
        F = val_masks.shape[0]
        fold_tbls = [sub] * F
        #: each fold's fitted copies of the label-dependent estimators
        self.fold_models: List[List[Transformer]] = [[] for _ in range(F)]
        for layer in during_layers:
            for stage, _ in layer:
                for f in range(F):
                    model = stage
                    if isinstance(stage, Estimator):
                        model = stage.fit(fold_tbls[f].take(
                            np.nonzero(~val_masks[f])[0]))
                        self.fold_models[f].append(model)
                    fold_tbls[f] = model.transform(fold_tbls[f])
        fold_X = []
        for f in range(F):
            if vec_f.name not in fold_tbls[f]:
                raise ValueError(f"in-CV DAG did not produce feature "
                                 f"'{vec_f.name}'")
            fold_X.append(torch.as_tensor(fold_tbls[f][vec_f.name].values)
                          .to(torch.float32))
        del fold_tbls
        d_max = max(x.shape[1] for x in fold_X)
        fold_X = [torch.nn.functional.pad(x, (0, d_max - x.shape[1]))
                  for x in fold_X]
        yd = torch.as_tensor(y, device=dev)
        t1 = synced_clock(dev)
        fold_results = [self.validator.validate(
            self.models, fold_X[f], yd, self.problem, metric_name,
            larger_better, num_classes, val_masks=val_masks[f][None, :])
            for f in range(F)]

        # each candidate's mean over the folds; a candidate non-finite in
        # any fold is quarantined
        best: Optional[BestEstimator] = None
        merged, quarantined = [], []
        for i, (family, grid) in enumerate(self.models):
            folds = np.stack([fr.results[i].fold_metrics[0]
                              for fr in fold_results])        # (F, G)
            r = fold_results[0].results[i]
            mean, masked, records = quarantine_non_finite(
                family.name, list(grid), folds, metric_name, larger_better)
            quarantined.extend(records)
            r.fold_metrics, r.mean_metrics = folds, mean
            merged.append(r)
            if not np.isfinite(mean).any():
                continue
            g_best = int(np.argmax(masked) if larger_better
                         else np.argmin(masked))
            value = float(mean[g_best])
            if best is None or ((value > best.metric_value) if larger_better
                                else (value < best.metric_value)):
                best = BestEstimator(family.name, dict(grid[g_best]), value)
        if best is None:
            raise AllCandidatesFailedError(quarantined)
        best.results = merged
        best.quarantined = quarantined
        self._preset_best = best
        self.phase_seconds = {"fold_prep": t1 - t0,
                              "sweep": synced_clock(dev) - t1}
        return best

    def fit(self, table: FeatureTable) -> Transformer:
        label_f, vec_f = self.input_features
        y_all_d = torch.as_tensor(table[label_f.name].values).to(
            torch.float32).reshape(-1)
        y_all = y_all_d.cpu().numpy()
        Xd_all = torch.as_tensor(table[vec_f.name].values).to(torch.float32)
        dev = Xd_all.device
        train_idx, test_idx, sel_np, prep = self._prepared_rows(y_all)
        sel = torch.as_tensor(sel_np, device=dev)
        Xd, yd = Xd_all[sel], y_all_d[sel]
        y = y_all[sel_np]
        if prep.label_mapping:
            # dense class indices; a label the cutter did not keep is -1
            y = np.array([prep.label_mapping.get(int(v), -1) for v in y],
                         dtype=np.float32)
            yd = torch.as_tensor(y, device=dev)
        num_classes = self._num_classes(y)
        metric_name, larger_better = self.validation_metric
        best = getattr(self, "_preset_best", None)
        if best is not None:
            # workflow-level CV chose the winner: no sweep here, and the
            # record is consumed so that a later fit validates anew
            self._preset_best = None
        else:
            best = self.validator.validate(self.models, Xd, yd, self.problem,
                                           metric_name, larger_better,
                                           num_classes)

        # a kill here has the sweep committed (with a checkpoint dir) and
        # no refit: a resume replays the sweep and goes straight to it
        faults.inject("preempt.refit")

        # refit the winner on the full prepared train rows, bucket-padded
        # with zero weights as in the JAX package
        n_fit = yd.shape[0]
        n_pad = bucket_for(n_fit)
        Xf = torch.nn.functional.pad(Xd, (0, 0, 0, n_pad - n_fit))
        yf = torch.nn.functional.pad(yd, (0, n_pad - n_fit))
        W = torch.zeros((1, n_pad), dtype=torch.float32, device=dev)
        W[:, :n_fit] = 1.0
        # the winner refits with a non-finite guard; a refit that fails
        # numerically (non-finite params, a singular solve) yields to the
        # next-ranked candidate (with no fault the first candidate is the
        # sweep winner), as does a fault injected at ``selector.refit``.
        # Any other error, a kernel's launch or build among them, is
        # raised: the JAX package catches every exception here, which on
        # the card would turn a kernel fault into another model
        fitted, used = None, None
        refit_quarantine: List[Dict[str, Any]] = []
        for fam_name, hyper, value in _ranked_candidates(
                best, larger_better)[:_MAX_REFIT_ATTEMPTS]:
            family = MODEL_REGISTRY[fam_name]
            try:
                faults.inject("selector.refit", key=fam_name)
                params = family.select_params(family.fit_batch(
                    Xf, yf, W, family.grid_to_arrays([hyper]), num_classes),
                    0)
                if not params_finite(params, self._INF_OK_PARAMS):
                    raise ArithmeticError(
                        "refit produced non-finite fitted params")
            except (ArithmeticError, torch.linalg.LinAlgError,
                    faults.InjectedFaultError,
                    faults.TransientFaultError) as e:
                reason = f"refit failed: {type(e).__name__}: {e}"
                logging.getLogger(__name__).warning(
                    "%s %s: %s; refitting the next-ranked candidate",
                    fam_name, dict(hyper), reason)
                rec = {"family": fam_name, "hyper": dict(hyper),
                       "reason": reason}
                refit_quarantine.append(rec)
                FaultLog.record(FaultReport(site="selector.refit",
                                            kind="quarantine", detail=rec))
                continue
            fitted = FittedParams(family=fam_name, params=params,
                                  hyper=dict(hyper), num_classes=num_classes)
            used = (fam_name, dict(hyper), value)
            break
        if fitted is None:
            raise AllCandidatesFailedError(list(best.quarantined)
                                           + refit_quarantine)
        summary = ModelSelectorSummary(
            validation_type=type(self.validator).__name__,
            validation_metric=metric_name, problem=self.problem,
            best_model_type=used[0], best_hyper=used[1],
            best_metric_value=used[2], larger_better=larger_better,
            validation_results=best.results,
            splitter_summary=dict(getattr(self.splitter, "summary", {})
                                  or {}),
            validation_eval_row_cap=self.validator.max_eval_rows,
            quarantined=list(best.quarantined) + refit_quarantine)
        model = self._finalize_model(SelectedModel(
            fitted=fitted, summary=summary,
            label_mapping=prep.label_mapping))

        ev = self._default_evaluator()
        ev.set_label_col(label_f.name)
        ev.set_prediction_col(model.get_output().name)
        summary.train_evaluation = _scalar_metrics(
            ev.evaluate_all(model.transform(table.take(train_idx))))
        if len(test_idx):
            summary.holdout_evaluation = _scalar_metrics(
                ev.evaluate_all(model.transform(table.take(test_idx))))
        model.summary_metadata = summary.to_json()
        return model

    def _default_evaluator(self):
        if self.evaluator is not None:
            return self.evaluator
        from ...evaluators import (
            OpBinaryClassificationEvaluator, OpMultiClassificationEvaluator,
            OpRegressionEvaluator,
        )
        return {"binary": OpBinaryClassificationEvaluator,
                "multiclass": OpMultiClassificationEvaluator,
                "regression": OpRegressionEvaluator}[self.problem]()


def _scalar_metrics(metrics: Dict[str, Any]) -> Dict[str, float]:
    return {k: v for k, v in metrics.items() if isinstance(v, (int, float))}


def _ranked_candidates(best, larger_better: bool
                       ) -> List[Tuple[str, Dict[str, Any], float]]:
    """Winner first, then every other finite-metric candidate by mean
    validation metric: the refit fallback order."""
    first = (best.family_name, dict(best.hyper), best.metric_value)
    pool = []
    for r in best.results or []:
        for g, hyper in enumerate(r.grid):
            v = float(r.mean_metrics[g])
            if not np.isfinite(v) or (r.family == first[0]
                                      and dict(hyper) == first[1]):
                continue
            pool.append((r.family, dict(hyper), v))
    pool.sort(key=(lambda t: -t[2]) if larger_better else (lambda t: t[2]))
    return [first] + pool


class SelectedModel(AllowLabelAsInput, Transformer):
    """The fitted winner: inputs are (label, feature vector); emits an
    (n, k) Prediction column with keys prediction / rawPrediction_i /
    probability_i. Exactly n rows: no padding to row buckets."""

    output_type = Prediction

    def __init__(self, fitted: FittedParams, summary: ModelSelectorSummary,
                 label_mapping: Optional[Dict[int, int]] = None,
                 uid: Optional[str] = None):
        super().__init__("modelSelector", uid)
        self.fitted = fitted
        self.summary = summary
        self.label_mapping = label_mapping

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

    def summary_pretty(self) -> str:
        """The JAX package's text summary of the selection."""
        s = self.summary
        lines = [f"-- ModelSelector ({self.uid}) --",
                 f"Evaluated {len(s.validation_results)} model type(s) with "
                 f"{s.validation_type} on metric {s.validation_metric}",
                 f"Best model: {s.best_model_type} "
                 f"{s.best_hyper} → {s.validation_metric}="
                 f"{s.best_metric_value:.4f}"]
        for r in s.validation_results:
            mean = torch.as_tensor(r.mean_metrics).cpu().numpy()
            hi, lo = np.max(mean), np.min(mean)
            b, w = (hi, lo) if s.larger_better else (lo, hi)
            lines.append(f"  {r.family}: best {b:.4f} "
                         f"worst {w:.4f} over {len(r.grid)} configs")
        if s.holdout_evaluation:
            keys = ("AuPR", "AuROC", "F1", "Error", "RootMeanSquaredError",
                    "R2")
            show = {k: round(v, 4) for k, v in s.holdout_evaluation.items()
                    if k in keys}
            lines.append(f"Holdout: {show}")
        if s.splitter_summary:
            lines.append(f"Splitter: {s.splitter_summary}")
        return "\n".join(lines)


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
