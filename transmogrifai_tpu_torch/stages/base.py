"""Pipeline stage base classes (counterpart of
``transmogrifai_tpu.stages.base``).

A stage has typed inputs and one typed output feature. A ``Transformer``
maps a table to one new column; its columnar path runs on whatever device
the table's tensors are on. An ``Estimator`` fits on a table and returns a
fitted ``Transformer`` that keeps its uid and output feature. Row scoring
(``local/scoring.py``) runs the same columnar path on a one-row table;
``transform_row`` is the JAX package's row dual, kept for parity.

The lambda transformers (``UnaryTransformer``, ``BinaryTransformer``,
``SequenceTransformer``, ``BinarySequenceTransformer``) run a user's
value-level function on the host, as the JAX package does: in one numpy
sweep when every input is numeric and fully valid, else row by row with
python values (None missing); a numeric result goes back to the table's
device.

Stages are built by user code (``set_input(...).get_output()``) or rebuilt
from a saved model (``persistence.stage_from_json``, which sets ``uid``,
the saved state and the feature wiring without calling ``__init__``).
"""
from __future__ import annotations

import abc
import hashlib
from typing import (
    Any, Callable, Dict, Iterator, Optional, Sequence, Tuple, Type,
)

import numpy as np
import torch

from ..features import Feature, make_uid
from ..table import DEVICE_KINDS, Column, FeatureTable
from ..types import FeatureType, OPVector


class OpPipelineStage(abc.ABC):
    """Base of every stage: typed inputs, one typed output."""

    #: input feature types; empty means any number of any type
    input_types: Tuple[Optional[Type[FeatureType]], ...] = ()
    output_type: Type[FeatureType] = OPVector
    input_features: Tuple[Feature, ...] = ()
    _output_feature: Optional[Feature] = None

    def __init__(self, operation_name: str, uid: Optional[str] = None):
        self.operation_name = operation_name
        self.uid = uid or make_uid(type(self).__name__)
        self.input_features = ()
        self._output_feature = None

    def set_input(self, *features: Feature) -> "OpPipelineStage":
        self._check_input_length(features)
        expected = self.input_types or (None,) * len(features)
        for i, (f, want) in enumerate(zip(features, expected)):
            if want is not None and not issubclass(f.feature_type, want):
                raise TypeError(
                    f"{type(self).__name__} input {i} must be "
                    f"{want.__name__}, got {f.type_name} (feature "
                    f"'{f.name}')")
        self.input_features = tuple(features)
        self._output_feature = None
        return self

    def _check_input_length(self, features: Sequence[Feature]) -> None:
        if self.input_types and len(features) != len(self.input_types):
            raise ValueError(f"{type(self).__name__} takes "
                             f"{len(self.input_types)} inputs, got "
                             f"{len(features)}")

    def output_name(self) -> str:
        base = ("-".join(f.name for f in self.input_features)
                if self.input_features else self.operation_name)
        if len(base) > 64:
            base = base[:48] + "-" + hashlib.md5(base.encode()).hexdigest()[:8]
        return f"{base}_{self.operation_name}_{self.uid.rsplit('_', 1)[-1]}"

    def output_is_response(self) -> bool:
        """A response iff any input is (stages that read the label mix in
        ``AllowLabelAsInput``)."""
        return any(f.is_response for f in self.input_features)

    def get_output(self) -> Feature:
        if self._output_feature is None:
            self._output_feature = Feature(
                self.output_name(), self.output_type,
                self.output_is_response(), self, self.input_features)
        return self._output_feature

    def __repr__(self) -> str:
        return f"{type(self).__name__}(uid={self.uid!r})"


class AllowLabelAsInput:
    """Marker: the stage reads the label without making its output a
    response (SanityChecker, ModelSelector)."""

    def output_is_response(self) -> bool:
        return False


class Transformer(OpPipelineStage):
    """A fitted stage that maps a table to one new column."""

    @abc.abstractmethod
    def transform_column(self, table: FeatureTable) -> Column:
        """Compute the whole output column on the table's device."""

    def transform(self, table: FeatureTable) -> FeatureTable:
        return table.with_column(self.get_output().name,
                                 self.transform_column(table))

    def transform_row(self, row: Dict[str, Any]) -> Any:
        """The output for one row of python values (None missing): the
        columnar path on a one-row host table."""
        one = FeatureTable(
            {f.name: Column.of_values(f.feature_type, [row.get(f.name)])
             for f in self.input_features}, 1)
        out = self.transform_column(one)
        if out.mask is not None and not bool(out.valid_mask()[0]):
            return None
        v = out.host_values()[0]
        return v.tolist() if isinstance(v, np.ndarray) else (
            v.item() if isinstance(v, np.generic) else v)

    def device_constant(self, name: str, values, dtype: torch.dtype,
                        device: torch.device) -> torch.Tensor:
        """``values`` as a tensor on ``device``, copied there once per
        stage and device rather than on every call."""
        cache = self.__dict__.setdefault("_device_constants", {})
        key = (name, str(device))
        t = cache.get(key)
        if t is None:
            t = cache[key] = torch.as_tensor(values, dtype=dtype,
                                             device=device)
        return t


class Estimator(OpPipelineStage):
    """A stage fitted on data into a ``Transformer``."""

    @abc.abstractmethod
    def fit(self, table: FeatureTable) -> Transformer:
        """Fit on the table; the model keeps this stage's uid and output
        feature (``_finalize_model``)."""

    def _finalize_model(self, model: Transformer) -> Transformer:
        model.uid = self.uid
        model.input_features = self.input_features
        model.operation_name = self.operation_name
        model.output_type = self.output_type
        model._output_feature = self.get_output()
        return model


class FeatureGeneratorStage(OpPipelineStage):
    """Origin stage of a raw feature: holds its record-level extract
    function."""

    def __init__(self, extract_fn: Callable[[Any], Any], output_name: str,
                 output_type: Type[FeatureType], is_response: bool,
                 uid: Optional[str] = None):
        super().__init__(f"generate_{output_name}", uid)
        self.extract_fn = extract_fn
        self.output_type = output_type
        self.is_response = is_response
        self._raw_name = output_name

    def output_name(self) -> str:
        return self._raw_name

    def output_is_response(self) -> bool:
        return self.is_response

    def extract(self, record: Any) -> Any:
        v = self.extract_fn(record)
        return v.value if isinstance(v, FeatureType) else v



def _iter_cell_values(cols: Sequence[Column]) -> Iterator[Tuple[Any, ...]]:
    """The rows of ``cols`` as tuples of python values (None missing), as
    the JAX package's row map hands them to a lambda: numpy scalars
    through ``.item()``."""
    n = len(cols[0]) if cols else 0
    arrs = [c.host_values() for c in cols]
    masks = [c.valid_mask() for c in cols]
    for i in range(n):
        out = []
        for a, m in zip(arrs, masks):
            if not m[i]:
                out.append(None)
            else:
                v = a[i]
                out.append(v.tolist() if isinstance(v, np.ndarray) else (
                    v.item() if isinstance(v, np.generic) else v))
        yield tuple(out)


def _vectorized_value_transform(transform_fn: Callable[..., Any],
                                output_type: Type[FeatureType],
                                cols: Sequence[Column]) -> Optional[Column]:
    """The whole-column route of a value-level lambda: when every input is
    a fully valid numeric column, apply ``transform_fn`` to the arrays in
    float64 (floats and booleans) or int64 (integers), the types the row
    map's ``.item()`` values have. None (take the row map) when an input is
    masked or not numeric, the function rejects arrays, or the result is
    not one number a row. NaN results are missing, as ``of_values`` makes
    them."""
    kind = output_type.column_kind
    if kind not in ("real", "binary", "integral") or not cols:
        return None
    n = len(cols[0])
    if n == 0:
        return None
    arrs = []
    for c in cols:
        a = c.host_values()
        if a.dtype.kind not in "fiub" or a.ndim != 1:
            return None
        if c.mask is not None and not c.valid_mask().all():
            return None
        arrs.append(a.astype(np.float64) if a.dtype.kind in "fb"
                    else a.astype(np.int64))
    try:
        out = transform_fn(*arrs)
    except Exception:
        return None
    if not isinstance(out, np.ndarray) or out.shape != (n,) \
            or out.dtype.kind not in "fiub":
        return None
    missing = np.isnan(out) if out.dtype.kind == "f" else np.zeros(n, bool)
    if kind == "real":
        vals = np.where(missing, 0.0, out).astype(np.float32)
    elif kind == "binary":
        vals = np.where(missing, False, out != 0).astype(np.float32)
    else:
        vals = np.where(missing, 0, out).astype(np.int64)
    return Column(output_type, vals, ~missing)


def _placed(table: FeatureTable, col: Column) -> Column:
    """A host column of a numeric kind moved to the table's device."""
    if table.device is None or col.kind not in DEVICE_KINDS:
        return col
    mask = None if col.mask is None else table.on_device(col.mask)
    return Column(col.feature_type, table.on_device(col.values), mask,
                  col.metadata)


class _LambdaTransformer(Transformer):
    """A value-level ``transform_fn`` over python values (None missing), or
    a ``columnar_fn`` over whole host columns; see the module docstring."""

    def __init__(self, operation_name: str,
                 transform_fn: Optional[Callable[..., Any]],
                 output_type: Type[FeatureType],
                 columnar_fn: Optional[Callable[..., Column]] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name, uid)
        self.transform_fn = transform_fn
        self.output_type = output_type
        self.columnar_fn = columnar_fn

    def _apply(self, cols):
        return self.transform_fn(*cols)

    def transform_column(self, table: FeatureTable) -> Column:
        cols = [table[f.name].to_host() for f in self.input_features]
        if self.columnar_fn is not None:
            return _placed(table, self._columnar(cols))
        out = None
        if not isinstance(self, SequenceTransformer):
            out = _vectorized_value_transform(self.transform_fn,
                                              self.output_type, cols)
        if out is None:
            out = Column.of_values(self.output_type, [
                self._apply(args) for args in _iter_cell_values(cols)])
        return _placed(table, out)

    def _columnar(self, cols):
        return self.columnar_fn(*cols)

    def transform_row(self, row: Dict[str, Any]) -> Any:
        if self.transform_fn is None:
            return super().transform_row(row)
        return self._apply([row.get(f.name) for f in self.input_features])


class UnaryTransformer(_LambdaTransformer):
    """fn: I -> O."""

    def __init__(self, operation_name, transform_fn, output_type,
                 input_type: Optional[Type[FeatureType]] = None, **kw):
        super().__init__(operation_name, transform_fn, output_type, **kw)
        self.input_types = (input_type,)


class BinaryTransformer(_LambdaTransformer):
    """fn: (I1, I2) -> O."""

    def __init__(self, operation_name, transform_fn, output_type,
                 input_types: Tuple = (None, None), **kw):
        super().__init__(operation_name, transform_fn, output_type, **kw)
        self.input_types = tuple(input_types)


class SequenceTransformer(_LambdaTransformer):
    """Any number (at least one) of inputs -> one output: ``transform_fn``
    takes the list of values, ``columnar_fn`` the list of columns."""

    def _check_input_length(self, features):
        if len(features) < 1:
            raise ValueError(f"{type(self).__name__} needs at least one "
                             f"input")

    def _apply(self, cols):
        return self.transform_fn(list(cols))

    def _columnar(self, cols):
        return self.columnar_fn(cols)


class BinarySequenceTransformer(SequenceTransformer):
    """One distinguished input and at least one more, as
    ``SequenceTransformer``."""

    def _check_input_length(self, features):
        if len(features) < 2:
            raise ValueError(
                f"{type(self).__name__} needs a head input plus at least one "
                f"sequence input")
