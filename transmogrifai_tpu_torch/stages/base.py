"""Pipeline stage base classes (counterpart of
``transmogrifai_tpu.stages.base``).

A ``Transformer`` maps a table to one new column. Its columnar path runs on
whatever device the table's tensors are on; the port has no row-level dual
because row scoring goes through the same columnar path on a one-row table
(``local/scoring.py``).
"""
from __future__ import annotations

import abc
from typing import Any, Optional, Tuple, Type

import torch

from ..features import Feature
from ..table import Column, FeatureTable
from ..types import FeatureType, OPVector


class OpPipelineStage(abc.ABC):
    """Base of every stage: typed inputs, one typed output. Stages are
    rebuilt from a saved model (``persistence.stage_from_json``), which
    sets ``uid``, the saved state and the feature wiring
    (``input_features``, ``_output_feature``)."""

    output_type: Type[FeatureType] = OPVector
    input_features: Tuple[Feature, ...] = ()
    _output_feature: Optional[Feature] = None

    def get_output(self) -> Feature:
        if self._output_feature is None:
            raise ValueError(f"stage {self.uid} has no output feature wired")
        return self._output_feature

    def __repr__(self) -> str:
        return f"{type(self).__name__}(uid={self.uid!r})"


class AllowLabelAsInput:
    """Marker: the stage reads the label without making its output a
    response (SanityChecker, ModelSelector)."""


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


class FeatureGeneratorStage(OpPipelineStage):
    """Origin stage of a raw feature: holds its record-level extract
    function."""

    def extract(self, record: Any) -> Any:
        v = self.extract_fn(record)
        return v.value if isinstance(v, FeatureType) else v
