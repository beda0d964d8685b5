"""Numeric arithmetic stages (counterpart of the arithmetic and alias
stages of ``transmogrifai_tpu.impl.feature.math``): ``Real op Real`` and
``Real op scalar`` for ``+ - * /``, computed in float64 on the table's
device and rounded once to float32, as the JAX package computes them in
numpy; a missing input or a result that is not finite is missing."""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from ...stages.base import BinaryTransformer, UnaryTransformer
from ...table import Column, FeatureTable
from ...types import OPMap, Real

_OPS = {"+": torch.add, "-": torch.sub, "*": torch.mul, "/": torch.div}
_PY_OPS = {"+": lambda a, b: a + b, "-": lambda a, b: a - b,
           "*": lambda a, b: a * b, "/": lambda a, b: a / b}


def _f64(table: FeatureTable, col: Column):
    vals = col.values if isinstance(col.values, torch.Tensor) \
        else table.on_device(col.host_values())
    valid = (torch.ones(vals.shape[0], dtype=torch.bool, device=vals.device)
             if col.mask is None else
             col.mask if isinstance(col.mask, torch.Tensor)
             else table.on_device(col.valid_mask()))
    return vals.reshape(-1).to(torch.float64), valid


def _real(out64: torch.Tensor, valid: torch.Tensor) -> Column:
    out = out64.to(torch.float32)
    mask = valid & torch.isfinite(out)
    return Column(Real, torch.where(mask, out, torch.zeros_like(out)), mask)


def _row_result(x: float) -> Optional[float]:
    return x if abs(x) != float("inf") and x == x else None


class ScalarOp(UnaryTransformer):
    """Real (op) scalar -> Real."""

    def __init__(self, op: str, scalar: float, uid: Optional[str] = None):
        super().__init__(f"scalar{op}", transform_fn=None, output_type=Real,
                         input_type=Real, uid=uid)
        self.op = op
        self.scalar = float(scalar)

    def transform_column(self, table: FeatureTable) -> Column:
        v, valid = _f64(table, table[self.input_features[0].name])
        return _real(_OPS[self.op](v, self.scalar), valid)

    def transform_row(self, row: Dict[str, Any]) -> Any:
        v = row.get(self.input_features[0].name)
        if v is None:
            return None
        try:
            return _row_result(_PY_OPS[self.op](float(v), self.scalar))
        except ZeroDivisionError:
            return None


class BinaryMathOp(BinaryTransformer):
    """(Real, Real) -> Real elementwise."""

    def __init__(self, op: str, uid: Optional[str] = None):
        if op not in _OPS:
            raise ValueError(f"unknown op {op}")
        super().__init__(f"binop{op}", transform_fn=None, output_type=Real,
                         input_types=(Real, Real), uid=uid)
        self.op = op

    def transform_column(self, table: FeatureTable) -> Column:
        a, va = _f64(table, table[self.input_features[0].name])
        b, vb = _f64(table, table[self.input_features[1].name])
        return _real(_OPS[self.op](a, b), va & vb)

    def transform_row(self, row: Dict[str, Any]) -> Any:
        a = row.get(self.input_features[0].name)
        b = row.get(self.input_features[1].name)
        if a is None or b is None:
            return None
        try:
            return _row_result(_PY_OPS[self.op](float(a), float(b)))
        except ZeroDivisionError:
            return None


class AliasTransformer(UnaryTransformer):
    """The input feature under another name."""

    def __init__(self, name: str, uid: Optional[str] = None):
        super().__init__("alias", transform_fn=None, output_type=Real,
                         uid=uid)
        self.alias = name

    def set_input(self, *features):
        out = super().set_input(*features)
        self.output_type = features[0].feature_type
        return out

    def output_name(self) -> str:
        return self.alias

    def transform_column(self, table: FeatureTable) -> Column:
        return table[self.input_features[0].name]

    def transform_row(self, row: Dict[str, Any]) -> Any:
        return row.get(self.input_features[0].name)


class FilterMap(UnaryTransformer):
    """OPMap -> the same map type, holding only the keys in
    ``white_list_keys`` (when given) and outside ``black_list_keys``; a
    map left empty is missing."""

    def __init__(self, white_list_keys: Sequence[str] = (),
                 black_list_keys: Sequence[str] = (), uid=None):
        white = set(white_list_keys)
        black = set(black_list_keys)

        def fn(v):
            if v is None:
                return None
            out = {k: x for k, x in v.items()
                   if (not white or str(k) in white) and str(k) not in black}
            return out or None

        super().__init__("filterMap", transform_fn=fn, output_type=OPMap,
                         uid=uid)
        self.white_list_keys = tuple(white_list_keys)
        self.black_list_keys = tuple(black_list_keys)

    def set_input(self, *features):
        out = super().set_input(*features)
        self.output_type = features[0].feature_type
        return out
