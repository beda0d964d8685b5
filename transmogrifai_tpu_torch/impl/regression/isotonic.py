"""Isotonic regression calibrator (counterpart of
``transmogrifai_tpu.impl.regression.isotonic``).

The fit is pool-adjacent-violators on the host in float64, a copy of the
JAX package's ``pav_fit``, so the boundaries and values are its bits. The
fitted model interpolates between them on the scores' device with
``jnp.interp``'s formula written out: the right-sided ``searchsorted``
clipped to [1, len - 1], ``fp[i-1] + (delta / dx) * df`` with the product
and the add fused into one rounding (XLA contracts them on the CPU),
``fp[i-1]`` where ``|dx|`` is below float32's spacing at its epsilon, and
the end values outside the boundaries. float32 throughout, so the card
gives the CPU's bits.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ...ops.xla_cpu import fma32
from ...stages.base import AllowLabelAsInput, Estimator, Transformer
from ...table import Column, FeatureTable
from ...types import RealNN

#: ``jnp.interp``'s zero-width guard for float32 breakpoints
_DX_EPS = float(np.spacing(np.finfo(np.float32).eps))


def pav_fit(scores: np.ndarray, labels: np.ndarray,
            weights: Optional[np.ndarray] = None):
    """Pool-adjacent-violators: (boundaries, values) float32, both
    increasing; identical scores merge into one boundary."""
    order = np.argsort(scores, kind="stable")
    x = np.asarray(scores, np.float64)[order]
    y = np.asarray(labels, np.float64)[order]
    w = np.ones_like(y) if weights is None else \
        np.asarray(weights, np.float64)[order]
    blocks: list = []      # [sum of w * y, sum of w, x min, x max]
    for xi, yi, wi in zip(x, y, w):
        blocks.append([yi * wi, wi, xi, xi])
        while len(blocks) >= 2 and (blocks[-2][0] * blocks[-1][1]
                                    >= blocks[-1][0] * blocks[-2][1]):
            b = blocks.pop()
            blocks[-1][0] += b[0]
            blocks[-1][1] += b[1]
            blocks[-1][3] = b[3]
    bounds, vals = [], []
    for swy, sw, x0, x1 in blocks:
        v = swy / max(sw, 1e-12)
        if bounds and x0 <= bounds[-1]:
            vals[-1] = (vals[-1] + v) / 2.0
            continue
        if x0 == x1:
            bounds.append(x0)
            vals.append(v)
        else:
            bounds.extend([x0, x1])
            vals.extend([v, v])
    return np.asarray(bounds, np.float32), np.asarray(vals, np.float32)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
           ) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` of float32 tensors (module docstring)."""
    if xp.numel() == 0:
        return torch.zeros_like(x)
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1,
                    xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= _DX_EPS
    slope = delta / torch.where(dx0, torch.ones_like(dx), dx)
    f = torch.where(dx0, fp[i - 1], fma32(slope, df, fp[i - 1]))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class IsotonicCalibratorModel(AllowLabelAsInput, Transformer):
    """(label, score) -> the calibrated score (RealNN)."""

    output_type = RealNN

    def __init__(self, boundaries: np.ndarray, values: np.ndarray,
                 uid: Optional[str] = None):
        super().__init__("calibrate", uid)
        self.boundaries = boundaries
        self.values = values
        self.summary_metadata: Dict[str, Any] = {
            "boundaries": np.asarray(boundaries).tolist(),
            "predictions": np.asarray(values).tolist()}

    def _interp(self, s: torch.Tensor) -> torch.Tensor:
        xp = self.device_constant("boundaries", self.boundaries,
                                  torch.float32, s.device)
        fp = self.device_constant("values", self.values, torch.float32,
                                  s.device)
        return interp(s.to(torch.float32).contiguous(), xp, fp)

    def transform_column(self, table: FeatureTable) -> Column:
        _, score_f = self.input_features
        s = table.on_device(table[score_f.name].values)
        return Column(RealNN, self._interp(s.reshape(-1)), None)

    def transform_row(self, row: Dict[str, Any]) -> Any:
        _, score_f = self.input_features
        v = row.get(score_f.name)
        if v is None:
            return None
        return float(self._interp(torch.tensor([float(v)],
                                               dtype=torch.float32))[0])


class IsotonicRegressionCalibrator(AllowLabelAsInput, Estimator):
    """Estimator[(RealNN label, RealNN score)] -> RealNN calibrated score;
    ``isotonic=False`` fits a decreasing map (on the negated scores,
    mirrored back so the boundaries stay increasing)."""

    input_types = (RealNN, RealNN)
    output_type = RealNN

    def __init__(self, isotonic: bool = True, uid: Optional[str] = None):
        super().__init__("calibrate", uid)
        self.isotonic = isotonic

    def fit(self, table: FeatureTable) -> Transformer:
        label_f, score_f = self.input_features
        lc, sc = table[label_f.name], table[score_f.name]
        y = lc.host_values().astype(np.float64).reshape(-1)
        s = sc.host_values().astype(np.float64).reshape(-1)
        m = lc.valid_mask() & sc.valid_mask()
        if self.isotonic:
            b, v = pav_fit(s[m], y[m])
        else:
            b, v = pav_fit(-s[m], y[m])
            b, v = -b[::-1], v[::-1]
        return self._finalize_model(IsotonicCalibratorModel(
            np.ascontiguousarray(b), np.ascontiguousarray(v)))
