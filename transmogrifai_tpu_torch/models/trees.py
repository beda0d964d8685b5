"""Tree model families, predict half (counterpart of
``transmogrifai_tpu.models.trees``): the random-forest and gradient-boosted
tree classifiers score on a device through the forest descent of
``ops/forest.py``. Growth and fitting wait for the training slice.

Features are binned as the JAX package bins them, ``bin(x) = #{edges < x}``
with ``n_bins = edges.shape[-1] + 1``, and routed by bin code. A fitted
forest comes in one of two layouts: complete heaps (``feat``/``bins``,
depth <= 8) or slot chains (``feat_lv``/``bins_lv``/``base_lv``, the
depth-12 refits).

Unlike the JAX package's ``predict_batch``, which scores a stacked batch of
configurations, the port scores one configuration: the params carry no
leading config axis.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops.forest import forest_predict, forest_predict_chain
from .api import FittedParams, ModelFamily, register_family

#: saved parameter keys the predict path reads, with their dtypes
_INT_KEYS = ("feat", "bins", "feat_lv", "bins_lv", "base_lv")
_FLOAT_KEYS = ("leaf", "tree_mask", "edges", "f0", "eta")


def _bin_features(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """bin(x) = #{edges < x} in [0, n_bins - 1], shape (n, d) int32: one
    elementwise comparison pass."""
    return (X.unsqueeze(2) > edges.unsqueeze(0)).sum(2, dtype=torch.int32)


def params_from_numpy(params: Dict[str, np.ndarray],
                      device) -> Dict[str, torch.Tensor]:
    """A saved tree ``FittedParams.params`` dict -> contiguous tensors on
    ``device``: int32 split tables, float32 leaves, mask, edges and boosting
    constants. Keys the predict path does not read (thresholds) are left
    out."""
    chain = "base_lv" in params
    need = (("feat_lv", "bins_lv", "base_lv") if chain
            else ("feat", "bins")) + ("leaf", "edges")
    missing = [k for k in need if k not in params]
    if missing:
        raise KeyError(f"tree params lack {missing}; have {sorted(params)}")
    out = {}
    for k, v in params.items():
        if k in _INT_KEYS:
            dtype = torch.int32
        elif k in _FLOAT_KEYS:
            dtype = torch.float32
        else:
            continue
        out[k] = torch.as_tensor(np.ascontiguousarray(v), dtype=dtype,
                                 device=device)
    return out


def _edges_of(params) -> torch.Tensor:
    """The shared (d, n_bins - 1) edge table, with or without a leading
    config axis."""
    e = params["edges"]
    return e[0] if e.dim() == 3 else e


def _depth_of(n_leaves: int) -> int:
    return int(np.log2(n_leaves))


def _shape_scores(out: torch.Tensor, num_classes: int, task: str):
    """(n, k) leaf outputs -> family score convention: binary (n,) p1,
    multiclass (n, C), regression (n,)."""
    if task == "regression":
        return out[:, 0]
    if num_classes <= 2:
        return out[:, 1]
    return out[:, :num_classes]


def _parts_j(out: torch.Tensor, num_classes: int, task: str):
    """Prediction parts from family-convention scores."""
    if task == "regression":
        return {"prediction": out}
    prob = torch.stack([1 - out, out], dim=1) if out.dim() == 1 else out
    pred = prob.argmax(dim=1).to(torch.float32)
    return {"prediction": pred, "probability": prob,
            "rawPrediction": torch.log(torch.clamp(prob, min=1e-12))}


def _forest_values(params, codes: torch.Tensor, leaf: torch.Tensor,
                   n_bins: int, lead: int = 0) -> torch.Tensor:
    """Sum of leaf values over the trees, in whichever layout the params
    hold. ``lead`` > 0 flattens that many axes after the tree axis into it
    (GBT's per-class trees)."""
    if "base_lv" in params:
        f, b, a = params["feat_lv"], params["bins_lv"], params["base_lv"]
        if lead:
            f, b, a = (x.reshape((-1,) + x.shape[-2:]) for x in (f, b, a))
        return forest_predict_chain(codes, f, b, a, leaf, n_bins=n_bins)
    f, b = params["feat"], params["bins"]
    if lead:
        f, b = (x.reshape(-1, x.shape[-1]) for x in (f, b))
    return forest_predict(codes, f, b, leaf, depth=_depth_of(leaf.shape[1]),
                          n_bins=n_bins)


class _TreeFamilyBase(ModelFamily):

    def params_from_numpy(self, params, device):
        return params_from_numpy(params, device)

    def _task(self, num_classes: int) -> str:
        if "regression" in self.supports and len(self.supports) == 1:
            return "regression"
        return "classification"


class RandomForestFamilyBase(_TreeFamilyBase):
    """Random forest: the mean of the unmasked trees' leaf values."""

    def predict_batch(self, params, X: torch.Tensor, num_classes: int):
        edges = _edges_of(params)
        task = self._task(num_classes)
        leaf = params["leaf"]                              # (T, L, k)
        binary = task == "classification" and num_classes <= 2
        if binary:
            # p0 = 1 - p1, so only the class-1 column is routed
            leaf = leaf[..., 1:]
        mask = params["tree_mask"]
        lw = (leaf * mask[:, None, None]).contiguous()
        out = _forest_values(params, _bin_features(X, edges), lw,
                             n_bins=edges.shape[-1] + 1)
        out = out / torch.clamp(mask.sum(), min=1.0)
        if binary:
            return out[:, 0]
        return _shape_scores(out, num_classes, task)

    def predict_parts(self, fitted: FittedParams, X: torch.Tensor):
        out = self.predict_batch(fitted.params, X, fitted.num_classes)
        return _parts_j(out, fitted.num_classes,
                        self._task(fitted.num_classes))


class GBTFamilyBase(_TreeFamilyBase):
    """Gradient-boosted trees: ``f0 + eta * sum of leaf values`` per class,
    then a sigmoid (binary) or softmax (multiclass)."""

    def _gbt_task(self, num_classes: int) -> str:
        if "regression" in self.supports and len(self.supports) == 1:
            return "regression"
        return "multiclass" if num_classes > 2 else "binary"

    def predict_batch(self, params, X: torch.Tensor, num_classes: int):
        edges = _edges_of(params)
        leaf = params["leaf"]                              # (T, C, L)
        T, C, L = leaf.shape
        lv = leaf * params["tree_mask"][:, None, None]
        # class-routing leaf table: value * one-hot(class) per (tree·class,
        # leaf), so one descent over T·C trees yields per-class margins
        cls_oh = torch.eye(C, dtype=lv.dtype, device=lv.device)
        M = (lv[:, :, :, None] * cls_oh[None, :, None, :]).reshape(
            T * C, L, C)
        contrib = _forest_values(params, _bin_features(X, edges), M,
                                 n_bins=edges.shape[-1] + 1, lead=1)
        margins = params["f0"][None, :] + params["eta"] * contrib  # (n, C)
        task = self._gbt_task(num_classes)
        if task == "regression":
            return margins[:, 0]
        if task == "binary":
            return torch.sigmoid(margins[:, 0])
        return torch.softmax(margins, dim=-1)

    def predict_parts(self, fitted: FittedParams, X: torch.Tensor):
        task = self._gbt_task(fitted.num_classes)
        out = self.predict_batch(fitted.params, X, fitted.num_classes)
        if task == "regression":
            return {"prediction": out}
        if task == "binary":
            prob = torch.stack([1 - out, out], dim=1)
            pred = (out > 0.5).to(torch.float32)
        else:
            prob = out
            pred = out.argmax(dim=1).to(torch.float32)
        return {"prediction": pred, "probability": prob,
                "rawPrediction": torch.log(torch.clamp(prob, min=1e-12))}


class RandomForestClassifierFamily(RandomForestFamilyBase):
    name = "OpRandomForestClassifier"
    supports = frozenset({"binary", "multiclass"})


class GBTClassifierFamily(GBTFamilyBase):
    name = "OpGBTClassifier"
    supports = frozenset({"binary"})


register_family(RandomForestClassifierFamily())
register_family(GBTClassifierFamily())
