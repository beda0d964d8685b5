"""Scalers with the metadata a descaler reads (counterpart of
``transmogrifai_tpu.impl.feature.scalers``).

``ScalerTransformer`` scales a Real linearly or by its log and records
how in the output column's metadata (``SCALER_META``);
``DescalerTransformer`` reads that metadata off its second input and
inverts it. ``OpScalarStandardScaler`` fits a z-score and
``FillMissingWithMean`` a mean. As in the JAX package these are host
stages: the fits are float64 numpy (``std`` with ddof 0), the transforms
float32 numpy, and a result column goes to the table's device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ...stages.base import (
    BinaryTransformer, Estimator, Transformer, UnaryTransformer, _placed,
)
from ...table import Column, FeatureTable
from ...types import Real, RealNN

#: metadata key of the scaling arguments
SCALER_META = "scaler"


def _host_f64(col: Column) -> np.ndarray:
    return np.asarray(col.host_values(), dtype=np.float64).reshape(-1)


def _host_mask(col: Column) -> Optional[np.ndarray]:
    return None if col.mask is None else col.valid_mask()


class ScalerTransformer(UnaryTransformer):
    """Real -> Real, ``slope * x + intercept`` or ``log(x)``, in float64
    then rounded to float32; the arguments ride the column's metadata."""

    def __init__(self, scaling_type: str = "linear", slope: float = 1.0,
                 intercept: float = 0.0, uid=None):
        if scaling_type not in ("linear", "log"):
            raise ValueError("scaling_type must be 'linear' or 'log'")
        super().__init__(f"scale_{scaling_type}", transform_fn=None,
                         output_type=Real, input_type=Real, uid=uid)
        self.scaling_type = scaling_type
        self.slope = slope
        self.intercept = intercept

    def _apply(self, vals: np.ndarray) -> np.ndarray:
        if self.scaling_type == "linear":
            return self.slope * vals + self.intercept
        return np.log(vals)

    def transform_column(self, table: FeatureTable) -> Column:
        col = table[self.input_features[0].name]
        with np.errstate(divide="ignore", invalid="ignore"):
            out = self._apply(_host_f64(col))
        meta = {SCALER_META: {"type": self.scaling_type, "slope": self.slope,
                              "intercept": self.intercept}}
        return _placed(table, Column(Real, out.astype(np.float32),
                                     _host_mask(col), meta))

    def transform_row(self, row: Dict[str, Any]) -> Any:
        v = row.get(self.input_features[0].name)
        if v is None:
            return None
        return float(self._apply(np.array([float(v)]))[0])


class DescalerTransformer(BinaryTransformer):
    """(scaled value, a feature carrying scaler metadata) -> the value
    with that scaling inverted."""

    def __init__(self, uid=None):
        super().__init__("descale", transform_fn=None, output_type=Real,
                         input_types=(Real, Real), uid=uid)
        self._scaler_args: Optional[Dict[str, Any]] = None

    def _invert(self, vals: np.ndarray, args: Dict[str, Any]) -> np.ndarray:
        if args["type"] == "linear":
            slope = args["slope"]
            if slope == 0:
                raise ValueError("cannot descale: slope is 0")
            return (vals - args["intercept"]) / slope
        return np.exp(vals)

    def transform_column(self, table: FeatureTable) -> Column:
        val_f, scaled_f = self.input_features
        col = table[val_f.name]
        args = table[scaled_f.name].metadata.get(SCALER_META)
        if args is None:
            raise ValueError(
                f"feature '{scaled_f.name}' carries no scaler metadata")
        self._scaler_args = dict(args)
        out = self._invert(_host_f64(col), args)
        return _placed(table, Column(Real, out.astype(np.float32),
                                     _host_mask(col)))

    def transform_row(self, row: Dict[str, Any]) -> Any:
        v = row.get(self.input_features[0].name)
        if v is None or self._scaler_args is None:
            return None
        return float(self._invert(np.array([float(v)]),
                                  self._scaler_args)[0])


class OpScalarStandardScaler(Estimator):
    """RealNN -> RealNN z-score: the mean and the standard deviation (ddof
    0) of the column in float64; a zero deviation divides by 1."""

    input_types = (RealNN,)
    output_type = RealNN

    def __init__(self, with_mean: bool = True, with_std: bool = True,
                 uid=None):
        super().__init__("stdScaler", uid)
        self.with_mean = with_mean
        self.with_std = with_std

    def fit(self, table: FeatureTable) -> Transformer:
        vals = _host_f64(table[self.input_features[0].name])
        mean = float(vals.mean()) if self.with_mean else 0.0
        std = float(vals.std()) if self.with_std else 1.0
        model = OpScalarStandardScalerModel(mean=mean,
                                            std=std if std > 0 else 1.0)
        model.summary_metadata = {"mean": mean, "std": std}
        return self._finalize_model(model)


class OpScalarStandardScalerModel(Transformer):
    output_type = RealNN

    def __init__(self, mean: float, std: float, uid=None):
        super().__init__("stdScaler", uid)
        self.mean = mean
        self.std = std

    def transform_column(self, table: FeatureTable) -> Column:
        col = table[self.input_features[0].name]
        vals = np.asarray(col.host_values(), dtype=np.float32).reshape(-1)
        out = (vals - np.float32(self.mean)) / np.float32(self.std)
        return _placed(table, Column(RealNN, out, None))

    def transform_row(self, row: Dict[str, Any]) -> Any:
        v = row.get(self.input_features[0].name)
        return (float(v) - self.mean) / self.std if v is not None else None


class FillMissingWithMean(Estimator):
    """Real -> RealNN: missing values take the mean of the present ones
    (``default_value`` when none is present)."""

    input_types = (Real,)
    output_type = RealNN

    def __init__(self, default_value: float = 0.0, uid=None):
        super().__init__("fillWithMean", uid)
        self.default_value = default_value

    def fit(self, table: FeatureTable) -> Transformer:
        col = table[self.input_features[0].name]
        vals, m = _host_f64(col), col.valid_mask()
        mean = float(vals[m].mean()) if m.any() else self.default_value
        return self._finalize_model(FillMissingWithMeanModel(mean=mean))


class FillMissingWithMeanModel(Transformer):
    output_type = RealNN

    def __init__(self, mean: float, uid=None):
        super().__init__("fillWithMean", uid)
        self.mean = mean

    def transform_column(self, table: FeatureTable) -> Column:
        col = table[self.input_features[0].name]
        vals = np.asarray(col.host_values(), dtype=np.float32).reshape(-1)
        out = np.where(col.valid_mask(), vals, np.float32(self.mean))
        return _placed(table, Column(RealNN, out, None))

    def transform_row(self, row: Dict[str, Any]) -> Any:
        v = row.get(self.input_features[0].name)
        return float(v) if v is not None else self.mean
