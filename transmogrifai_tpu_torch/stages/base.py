"""Pipeline stage base classes (counterpart of
``transmogrifai_tpu.stages.base``).

A stage has typed inputs and one typed output feature. A ``Transformer``
maps a table to one new column; its columnar path runs on whatever device
the table's tensors are on. An ``Estimator`` fits on a table and returns a
fitted ``Transformer`` that keeps its uid and output feature. The port has
no row-level dual: row scoring goes through the same columnar path on a
one-row table (``local/scoring.py``).

Stages are built by user code (``set_input(...).get_output()``) or rebuilt
from a saved model (``persistence.stage_from_json``, which sets ``uid``,
the saved state and the feature wiring without calling ``__init__``).
"""
from __future__ import annotations

import abc
import hashlib
from typing import Any, Callable, Optional, Tuple, Type

import torch

from ..features import Feature, make_uid
from ..table import Column, FeatureTable
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
        if self.input_types and len(features) != len(self.input_types):
            raise ValueError(f"{type(self).__name__} takes "
                             f"{len(self.input_types)} inputs, got "
                             f"{len(features)}")
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

