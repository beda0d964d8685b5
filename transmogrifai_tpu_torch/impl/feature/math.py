"""Row-level math and miscellaneous stages (counterpart of
``transmogrifai_tpu.impl.feature.math``).

``Real op Real`` and ``Real op scalar`` for ``+ - * /`` are computed in
float64 on the table's device and rounded once to float32, as the JAX
package computes them in numpy; a missing input or a result that is not
finite is missing. The numeric unaries (abs, ceil, floor, round, exp,
sqrt, log, power) apply the JAX package's numpy functions on the host in
float64 and round once. The text, list and similarity stages are host
string work; the null indicators of text lists and the slot filter of a
vector (``DropIndicesByTransformer``) produce vector blocks on the table's
device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Type

import numpy as np
import torch

from ...stages.base import (
    BinaryTransformer, SequenceTransformer, UnaryTransformer, _placed,
)
from ...table import Column, FeatureTable
from ...types import (
    Binary, FeatureType, Integral, MultiPickList, OPMap, OPVector, Real,
    RealNN, Text, TextList,
)
from ...vector_metadata import (
    NULL_INDICATOR, VectorColumnMetadata, VectorMetadata,
)

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


# ---------------------------------------------------------------------------
# Numeric unaries (numpy on the host, float64, rounded once)
# ---------------------------------------------------------------------------

class _NumericUnary(UnaryTransformer):
    """Real -> Real: ``np_fn`` of the float64 values, rounded to float32;
    a missing input or a result that is not finite is missing."""

    def __init__(self, name: str, np_fn: Callable[[np.ndarray], np.ndarray],
                 uid=None):
        super().__init__(name, transform_fn=None, output_type=Real,
                         input_type=Real, uid=uid)
        self.np_fn = np_fn

    def transform_column(self, table: FeatureTable) -> Column:
        col = table[self.input_features[0].name]
        vals = np.asarray(col.host_values(), dtype=np.float64).reshape(-1)
        with np.errstate(all="ignore"):
            out = self.np_fn(vals).astype(np.float32)
        mask = col.valid_mask() & np.isfinite(out)
        out = np.where(mask, out, 0.0).astype(np.float32)
        return _placed(table, Column(Real, out, mask))

    def transform_row(self, row: Dict[str, Any]) -> Any:
        v = row.get(self.input_features[0].name)
        if v is None:
            return None
        with np.errstate(all="ignore"):
            out = float(self.np_fn(np.array([float(v)]))[0])
        return out if np.isfinite(out) else None


def AbsoluteValue(uid=None):
    return _NumericUnary("abs", np.abs, uid=uid)


def Ceil(uid=None):
    return _NumericUnary("ceil", np.ceil, uid=uid)


def Floor(uid=None):
    return _NumericUnary("floor", np.floor, uid=uid)


def RoundTransformer(uid=None):
    return _NumericUnary("round", np.round, uid=uid)


def Exp(uid=None):
    return _NumericUnary("exp", np.exp, uid=uid)


def Sqrt(uid=None):
    return _NumericUnary("sqrt", np.sqrt, uid=uid)


def Log(base: float = np.e, uid=None):
    return _NumericUnary("log", lambda v: np.log(v) / np.log(base), uid=uid)


def Power(p: float, uid=None):
    return _NumericUnary("power", lambda v: np.power(v, p), uid=uid)


def SquareRoot(uid=None):
    return Sqrt(uid=uid)


# ---------------------------------------------------------------------------
# Text, list and vector stages
# ---------------------------------------------------------------------------

class SubstringTransformer(BinaryTransformer):
    """(Text, Text) -> Binary: the second input, lower-cased, occurs in the
    first."""

    def __init__(self, uid=None):
        super().__init__(
            "substring",
            transform_fn=lambda a, b: (None if a is None or b is None
                                       else str(b).lower() in str(a).lower()),
            output_type=Binary, input_types=(Text, Text), uid=uid)


class ToOccurTransformer(UnaryTransformer):
    """Any -> RealNN 1.0 where ``matches`` holds (default: a positive
    number, true, or a non-empty value), else 0.0."""

    def __init__(self, matches: Optional[Callable[[Any], bool]] = None,
                 uid=None):
        def default_match(v: Any) -> bool:
            if v is None:
                return False
            if isinstance(v, bool):
                return v
            if isinstance(v, (int, float)):
                return float(v) > 0
            return bool(v)
        fn = matches or default_match
        super().__init__("toOccur",
                         transform_fn=lambda v: 1.0 if fn(v) else 0.0,
                         output_type=RealNN, uid=uid)


class TextLenTransformer(UnaryTransformer):
    """Text -> Integral length in characters (0 when missing)."""

    def __init__(self, uid=None):
        super().__init__(
            "textLen", transform_fn=lambda v: 0 if v is None else len(str(v)),
            output_type=Integral, input_type=Text, uid=uid)


class TextListNullTransformer(SequenceTransformer):
    """Seq[TextList] -> OPVector of one null indicator a list."""

    output_type = OPVector

    def __init__(self, uid=None):
        super().__init__("textListNull", transform_fn=None,
                         output_type=OPVector, uid=uid)

    def transform_column(self, table: FeatureTable) -> Column:
        blocks, meta = [], []
        for f in self.input_features:
            blocks.append((~table[f.name].valid_mask()).astype(np.float32))
            meta.append(VectorColumnMetadata(f.name, f.type_name, f.name,
                                             NULL_INDICATOR))
        vm = VectorMetadata.of(self.get_output().name, meta)
        return Column(OPVector, table.on_device(np.stack(blocks, axis=1)),
                      None, {"vector_meta": vm})

    def transform_row(self, row: Dict[str, Any]) -> Any:
        return [0.0 if row.get(f.name) else 1.0 for f in self.input_features]


class DropIndicesByTransformer(UnaryTransformer):
    """OPVector -> OPVector without the slots whose column metadata
    ``predicate`` holds for; the columns are selected where the vector
    lies."""

    def __init__(self, predicate: Callable[[Any], bool], uid=None):
        super().__init__("dropIndicesBy", transform_fn=None,
                         output_type=OPVector, input_type=OPVector, uid=uid)
        self.predicate = predicate

    def transform_column(self, table: FeatureTable) -> Column:
        col = table[self.input_features[0].name]
        vm = col.metadata.get("vector_meta")
        if vm is None:
            raise ValueError("input vector carries no metadata")
        keep = [i for i, c in enumerate(vm.columns) if not self.predicate(c)]
        vals = col.values if isinstance(col.values, torch.Tensor) \
            else table.on_device(np.asarray(col.values, np.float32))
        idx = torch.as_tensor(keep, dtype=torch.int64, device=vals.device)
        return Column(OPVector, vals.index_select(1, idx), None,
                      {"vector_meta": vm.select(keep)})

    def transform_row(self, row: Dict[str, Any]) -> Any:
        raise ValueError(
            "DropIndicesByTransformer needs the vector metadata attached to "
            "columnar inputs; score via the batch/micro-batch path")


def jaccard_similarity(a: Optional[Sequence[str]], b: Optional[Sequence[str]]
                       ) -> Optional[float]:
    """|A & B| / |A | B| of the two sets; 1.0 when both are empty."""
    sa = set(a or ())
    sb = set(b or ())
    if not sa and not sb:
        return 1.0
    return len(sa & sb) / len(sa | sb)


class JaccardSimilarity(BinaryTransformer):
    """(set, set) -> RealNN ``jaccard_similarity``."""

    def __init__(self, uid=None):
        super().__init__("jaccardSim", transform_fn=jaccard_similarity,
                         output_type=RealNN, uid=uid)


def _ngrams(s: str, n: int) -> set:
    s = f" {s.lower()} "
    return {s[i:i + n] for i in range(max(len(s) - n + 1, 1))}


class NGramSimilarity(BinaryTransformer):
    """(Text, Text) -> RealNN Jaccard similarity of the two texts'
    character n-grams (lower-cased, padded by a space); 0 when either is
    missing or empty."""

    def __init__(self, n: int = 3, uid=None):
        def fn(a, b):
            if not a or not b:
                return 0.0
            ga, gb = _ngrams(str(a), n), _ngrams(str(b), n)
            if not ga or not gb:
                return 0.0
            return len(ga & gb) / len(ga | gb)
        super().__init__("ngramSim", transform_fn=fn, output_type=RealNN,
                         input_types=(None, None), uid=uid)
        self.n = n


# ---------------------------------------------------------------------------
# Collection-lifted transformers
# ---------------------------------------------------------------------------

class OPCollectionTransformer(UnaryTransformer):
    """A value function lifted over a collection: ``element_fn`` of each
    list element, set member or map value (keys kept); a missing
    collection stays missing, and a scalar is mapped itself."""

    def __init__(self, element_fn: Callable[[Any], Any],
                 output_type: Type[FeatureType],
                 input_type: Optional[Type[FeatureType]] = None,
                 operation_name: str = "collectionApply", uid=None):
        super().__init__(operation_name, transform_fn=self._lift,
                         output_type=output_type, input_type=input_type,
                         uid=uid)
        self.element_fn = element_fn

    def _lift(self, v):
        if v is None:
            return None
        if isinstance(v, dict):
            return {k: self.element_fn(x) for k, x in v.items()}
        if isinstance(v, (set, frozenset)):
            return {self.element_fn(x) for x in v}
        if isinstance(v, (list, tuple, np.ndarray)):
            return [self.element_fn(x) for x in v]
        return self.element_fn(v)


class OPListTransformer(OPCollectionTransformer):
    """A list's elements mapped (TextList by default)."""

    def __init__(self, element_fn, output_type=TextList, input_type=TextList,
                 uid=None):
        super().__init__(element_fn, output_type, input_type,
                         operation_name="listApply", uid=uid)


class OPSetTransformer(OPCollectionTransformer):
    """A MultiPickList's members mapped."""

    def __init__(self, element_fn, output_type=MultiPickList,
                 input_type=MultiPickList, uid=None):
        super().__init__(element_fn, output_type, input_type,
                         operation_name="setApply", uid=uid)


class OPMapTransformer(OPCollectionTransformer):
    """A map's values mapped, its keys kept."""

    def __init__(self, element_fn, output_type, input_type=None, uid=None):
        super().__init__(element_fn, output_type, input_type,
                         operation_name="mapApply", uid=uid)
