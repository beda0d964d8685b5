"""Model-family API (counterpart of ``transmogrifai_tpu.models.api``): a
family fits a batch of configurations at once and turns fitted parameters
into predictions on a device.

The fit contract is the JAX package's: ``fit_batch(X, y, weights, grid,
num_classes)`` takes X (n, d), y (n,), per-configuration row weights
(B, n) (0 = row excluded) and a grid of (B,) hyperparameter arrays, and
returns stacked parameters with a leading config axis B. Grids stay host
numpy arrays: tree families derive static structure (depth, rounds) from
them.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch


@dataclass
class FittedParams:
    """One fitted configuration's parameters plus the hyperparameters that
    produced it."""
    family: str
    params: Any
    hyper: Dict[str, Any]
    num_classes: int = 2


class ModelFamily(abc.ABC):
    """A model family: its batched fit and its predict contract."""

    #: family name, e.g. "OpRandomForestClassifier"
    name: str = ""
    #: problem kinds: subset of {"binary", "multiclass", "regression"}
    supports: frozenset = frozenset()

    def default_grid(self, problem: str) -> List[Dict[str, Any]]:
        """The reference's default hyperparameter grid for ``problem``."""
        raise NotImplementedError(
            f"{self.name}'s default grid is not ported yet; pass a grid")

    def fit_batch(self, X: torch.Tensor, y: torch.Tensor,
                  weights: torch.Tensor, grid: Dict[str, np.ndarray],
                  num_classes: int) -> Dict[str, torch.Tensor]:
        """Fit B configurations at once (see the module notes)."""
        raise NotImplementedError(f"fitting {self.name} is not ported yet")

    def sweep_fit_batch(self, X: torch.Tensor, y: torch.Tensor,
                        weights: torch.Tensor, grid: Dict[str, np.ndarray],
                        num_classes: int) -> Dict[str, torch.Tensor]:
        """``fit_batch`` for CV-sweep candidates; a family may trade exact
        fitted state for sweep speed here (the selector refits the winner
        through ``fit_batch``). Default: ``fit_batch``."""
        return self.fit_batch(X, y, weights, grid, num_classes)

    def grid_to_arrays(self, grid: Sequence[Dict[str, Any]]
                       ) -> Dict[str, np.ndarray]:
        """A list of hyperparameter dicts -> {key: (B,) float32 array}."""
        keys = sorted({k for g in grid for k in g})
        return {k: np.asarray([g[k] for g in grid], dtype=np.float32)
                for k in keys}

    def feature_importances(self, fitted: "FittedParams"
                            ) -> Optional[np.ndarray]:
        """Per-input-dimension contributions for the model insights, on
        the host: |coefficients| of a linear family, the share of real
        splits on each feature of a tree family; None otherwise."""
        p = fitted.params
        if not isinstance(p, dict):
            return None
        if "coef" in p:
            return np.abs(to_numpy(p["coef"])).reshape(-1)
        if "W" in p:
            return np.abs(to_numpy(p["W"])).mean(axis=-1).reshape(-1)
        if "feat" in p or "feat_lv" in p:
            # sentinel-binned entries are stopped or padded nodes, not
            # splits, and must not count toward feature 0
            fk, bk = ("feat", "bins") if "feat" in p else ("feat_lv",
                                                           "bins_lv")
            feats = to_numpy(p[fk]).reshape(-1).astype(np.int64)
            if bk in p and "edges" in p:
                nb = to_numpy(p["edges"]).shape[-1] + 1
                feats = feats[to_numpy(p[bk]).reshape(-1) < nb]
            feats = feats[feats >= 0]
            d = int(np.asarray(to_numpy(p["num_features"])) if
                    "num_features" in p else
                    (feats.max() + 1 if feats.size else 1))
            counts = np.bincount(feats, minlength=d).astype(np.float64)
            return counts / max(counts.sum(), 1.0)
        return None

    def select_params(self, batched: Dict[str, torch.Tensor],
                      idx: int) -> Dict[str, torch.Tensor]:
        """Configuration ``idx`` of stacked params, as contiguous tensors."""
        return {k: v[idx].contiguous() for k, v in batched.items()}

    def slice_params(self, batched: Dict[str, torch.Tensor], lo: int,
                     hi: int) -> Dict[str, torch.Tensor]:
        """Configurations [lo, hi) of stacked params."""
        return {k: v[lo:hi] for k, v in batched.items()}

    @abc.abstractmethod
    def params_from_numpy(self, params: Dict[str, np.ndarray],
                          device) -> Dict[str, torch.Tensor]:
        """Saved numpy parameters -> tensors on ``device``."""

    def params_to_numpy(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """The inverse of ``params_from_numpy``: the dict the JAX family
        saves, every tensor a numpy array of its dtype (host arrays and
        python scalars pass through, tuples stay tuples)."""
        return to_numpy(params)

    def predict_batch(self, params: Dict[str, torch.Tensor], X: torch.Tensor,
                      num_classes: int) -> torch.Tensor:
        """Scores of stacked params: (B, n) for binary and regression."""
        raise NotImplementedError(f"{self.name} has no batched predict")

    @abc.abstractmethod
    def predict_parts(self, fitted: FittedParams,
                      X: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Prediction parts on X's device: {'prediction', 'probability'?,
        'rawPrediction'?}."""

    def predict_one(self, fitted: FittedParams,
                    X: torch.Tensor) -> Dict[str, np.ndarray]:
        """``predict_parts`` brought to the host as numpy arrays."""
        return {k: v.cpu().numpy()
                for k, v in self.predict_parts(fitted, X).items()}


def to_numpy(v: Any) -> Any:
    """Every tensor inside dicts, lists and tuples -> a numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, dict):
        return {k: to_numpy(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(to_numpy(x) for x in v)
    return v


MODEL_REGISTRY: Dict[str, ModelFamily] = {}


def register_family(family: ModelFamily) -> ModelFamily:
    MODEL_REGISTRY[family.name] = family
    return family
