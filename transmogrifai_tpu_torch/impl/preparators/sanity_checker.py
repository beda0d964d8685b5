"""SanityChecker, fitted half (counterpart of
``transmogrifai_tpu.impl.preparators.sanity_checker``): the fitted model
keeps the feature-vector slots that the fit did not drop.

The fit's summary is carried as decoded from a saved model, in plain data
holders with the fields of the JAX package's summary classes
(``sanity_checker_metadata.py`` there).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from ...stages.base import AllowLabelAsInput, Transformer
from ...table import Column, FeatureTable
from ...types import OPVector
from ...vector_metadata import VectorMetadata


@dataclass
class ColumnStatistics:
    names: List[str] = field(default_factory=list)
    count: List[float] = field(default_factory=list)
    mean: List[float] = field(default_factory=list)
    variance: List[float] = field(default_factory=list)
    min: List[float] = field(default_factory=list)
    max: List[float] = field(default_factory=list)


@dataclass
class CategoricalGroupStats:
    cramers_v: Dict[str, float] = field(default_factory=dict)
    mutual_info: Dict[str, float] = field(default_factory=dict)
    pointwise_mutual_info: Dict[str, List[List[float]]] = field(
        default_factory=dict)


@dataclass
class SanityCheckerSummary:
    stats: ColumnStatistics = field(default_factory=ColumnStatistics)
    categorical: CategoricalGroupStats = field(
        default_factory=CategoricalGroupStats)
    correlations_with_label: List[Optional[float]] = field(
        default_factory=list)
    correlation_type: str = "pearson"
    dropped: List[str] = field(default_factory=list)
    reasons: Dict[str, List[str]] = field(default_factory=dict)
    sample_size: int = 0
    feature_correlations: Optional[Any] = None
    schema_version: int = 3


class SanityCheckerModel(AllowLabelAsInput, Transformer):
    """Index-keep filter: inputs are (label, feature vector); the output is
    the vector's ``keep_indices`` slots."""

    output_type = OPVector

    def transform_column(self, table: FeatureTable) -> Column:
        _, vec_f = self.input_features
        col = table[vec_f.name]
        vals = col.values
        keep = self.device_constant("keep", self.keep_indices, torch.long,
                                    vals.device)
        vm: Optional[VectorMetadata] = col.metadata.get("vector_meta")
        meta: Dict[str, Any] = {}
        if vm is not None:
            meta["vector_meta"] = VectorMetadata(
                self.get_output().name, vm.select(self.keep_indices).columns)
        return Column(OPVector, vals.index_select(1, keep), None, meta)
