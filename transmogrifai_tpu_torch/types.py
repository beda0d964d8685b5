"""Typed feature values: the subset of ``transmogrifai_tpu.types`` that the
serve slice loads (``Real``, ``RealNN``, ``OPVector``, ``Prediction``).

Each class carries ``column_kind``, which decides how a column of the type
is stored in a ``FeatureTable``. The value classes exist for row-level
scoring; whole columns are numpy arrays on the host and tensors on the
device (``table.py``).
"""
from __future__ import annotations

import math
import numbers
from typing import Any, ClassVar, Dict, Type

import numpy as np

__all__ = ["FeatureType", "OPNumeric", "Real", "RealNN", "OPVector", "OPMap",
           "Prediction", "FEATURE_TYPES", "feature_type_by_name"]


class FeatureType:
    """Base value container: an optional value that may be empty."""

    is_nullable: ClassVar[bool] = True
    #: columnar storage kind: 'real', 'vector' or 'prediction' in this slice
    column_kind: ClassVar[str] = "text"
    is_abstract: ClassVar[bool] = True

    __slots__ = ("value",)

    def __init__(self, value: Any = None):
        self.value = self._convert(value)
        if not self.is_nullable and self.is_empty:
            raise ValueError(f"{type(self).__name__} cannot be empty")

    @classmethod
    def _convert(cls, value: Any) -> Any:
        return value

    @property
    def is_empty(self) -> bool:
        return self.value is None

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.value!r})"


class NonNullable:
    """Marker mixin: the type cannot hold an empty value."""
    is_nullable = False


class OPNumeric(FeatureType):
    is_abstract = True


class Real(OPNumeric):
    """Optional real number; NaN is missing."""
    is_abstract = False
    column_kind = "real"

    @classmethod
    def _convert(cls, value):
        if value is None:
            return None
        if isinstance(value, bool):
            return 1.0 if value else 0.0
        if isinstance(value, numbers.Number):
            v = float(value)
            return None if math.isnan(v) else v
        raise TypeError(
            f"cannot make {cls.__name__} from {type(value).__name__}")


class RealNN(NonNullable, Real):
    """Non-nullable real: the label type."""
    is_abstract = False


class OPVector(NonNullable, FeatureType):
    """Dense float vector; a column of them is one (n, d) array."""
    is_abstract = False
    column_kind = "vector"

    @classmethod
    def _convert(cls, value):
        if value is None:
            return np.zeros((0,), dtype=np.float32)
        return np.asarray(value, dtype=np.float32)

    @property
    def is_empty(self) -> bool:
        return False


class OPMap(FeatureType):
    is_abstract = True
    column_kind = "map"


class Prediction(NonNullable, OPMap):
    """Model output map with the reserved keys ``prediction``,
    ``rawPrediction_i`` and ``probability_i``."""
    is_abstract = False
    column_kind = "prediction"

    PredictionName = "prediction"
    RawPredictionName = "rawPrediction"
    ProbabilityName = "probability"

    @classmethod
    def _convert(cls, value):
        if value is None:
            raise ValueError("Prediction cannot be empty")
        d = dict(value)
        if cls.PredictionName not in d:
            raise ValueError(
                f"Prediction must contain '{cls.PredictionName}' key")
        return d

    @property
    def is_empty(self) -> bool:
        return False


#: name -> concrete feature type of this slice
FEATURE_TYPES: Dict[str, Type[FeatureType]] = {
    t.__name__: t for t in (Real, RealNN, OPVector, Prediction)}


def feature_type_by_name(name: str) -> Type[FeatureType]:
    try:
        return FEATURE_TYPES[name]
    except KeyError:
        raise ValueError(
            f"feature type '{name}' is not ported yet; the port knows "
            f"{sorted(FEATURE_TYPES)}") from None
