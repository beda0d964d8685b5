"""Numeric vectorizers (counterpart of
``transmogrifai_tpu.impl.feature.vectorizers``): typed columns -> one
OPVector column with per-slot provenance. They compute on the device the
table's tensors are on; the mean fills are fitted on the host in float64,
as the JAX package fits them.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ...stages.base import Estimator, Transformer
from ...table import Column, FeatureTable
from ...types import OPVector
from ...vector_metadata import (
    NULL_INDICATOR, VectorColumnMetadata, VectorMetadata,
)


def _meta(feature, indicator=None) -> VectorColumnMetadata:
    return VectorColumnMetadata(parent_feature_name=feature.name,
                                parent_feature_type=feature.type_name,
                                grouping=feature.name,
                                indicator_value=indicator)


def _valid(col: Column) -> torch.Tensor:
    if col.mask is None:
        return torch.ones(col.values.shape[0], dtype=torch.bool,
                          device=col.values.device)
    return col.mask


class RealVectorizer(Estimator):
    """Seq[Real] -> OPVector: fits one fill per column (the mean of its
    valid values, or ``fill_value``)."""

    output_type = OPVector

    def __init__(self, fill_with_mean: bool = True, fill_value: float = 0.0,
                 track_nulls: bool = True, uid: Optional[str] = None):
        super().__init__("vecReal", uid)
        self.fill_with_mean = fill_with_mean
        self.fill_value = fill_value
        self.track_nulls = track_nulls

    def fit(self, table: FeatureTable) -> Transformer:
        fills = []
        for f in self.input_features:
            col = table[f.name]
            vals = torch.as_tensor(col.values).cpu().numpy().astype(
                np.float64).reshape(-1)
            m = (np.ones(vals.shape[0], bool) if col.mask is None
                 else torch.as_tensor(col.mask).cpu().numpy())
            fills.append(float(vals[m].mean())
                         if self.fill_with_mean and m.any()
                         else self.fill_value)
        return self._finalize_model(
            RealVectorizerModel(fills=fills, track_nulls=self.track_nulls))


class RealVectorizerModel(Transformer):
    """Seq[Real] -> OPVector: each missing value takes its column's fill,
    and with ``track_nulls`` a null-indicator slot follows each column."""

    output_type = OPVector

    def __init__(self, fills: List[float], track_nulls: bool,
                 uid: Optional[str] = None):
        super().__init__("vecReal", uid)
        self.fills = fills
        self.track_nulls = track_nulls

    def transform_column(self, table: FeatureTable) -> Column:
        cols = [table[f.name] for f in self.input_features]
        vals = torch.stack([c.values.reshape(-1).to(torch.float32)
                            for c in cols], dim=1)            # (n, c)
        m = torch.stack([_valid(c) for c in cols], dim=1)
        fills = self.device_constant("fills", self.fills, torch.float32,
                                     vals.device)
        out = torch.where(m, vals, fills[None, :])
        meta: List[VectorColumnMetadata] = []
        for f in self.input_features:
            meta.append(_meta(f))
            if self.track_nulls:
                meta.append(_meta(f, NULL_INDICATOR))
        if self.track_nulls:
            # each column's null indicator right after it
            out = torch.stack([out, (~m).to(torch.float32)],
                              dim=2).reshape(out.shape[0], -1)
        vm = VectorMetadata.of(self.get_output().name, meta)
        return Column(OPVector, out, None, {"vector_meta": vm})


class RealNNVectorizer(Transformer):
    """Seq[RealNN] -> OPVector: the columns side by side."""

    output_type = OPVector

    def __init__(self, uid: Optional[str] = None):
        super().__init__("vecRealNN", uid)

    def transform_column(self, table: FeatureTable) -> Column:
        blocks = [table[f.name].values.reshape(-1).to(torch.float32)
                  for f in self.input_features]
        vm = VectorMetadata.of(self.get_output().name,
                               [_meta(f) for f in self.input_features])
        return Column(OPVector, torch.stack(blocks, dim=1), None,
                      {"vector_meta": vm})


class VectorsCombiner(Transformer):
    """Seq[OPVector] -> OPVector: concatenation, with the slots' metadata
    flattened in the same order."""

    output_type = OPVector

    def __init__(self, uid: Optional[str] = None):
        super().__init__("combined", uid)

    def transform_column(self, table: FeatureTable) -> Column:
        blocks, metas = [], []
        for f in self.input_features:
            col = table[f.name]
            arr = col.values.to(torch.float32)
            if arr.dim() == 1:
                arr = arr[:, None]
            blocks.append(arr)
            vm = col.metadata.get("vector_meta")
            if vm is None:
                vm = VectorMetadata.of(f.name, [
                    VectorColumnMetadata(f.name, f.type_name, None, None,
                                         descriptor_value=f"col_{j}")
                    for j in range(arr.shape[1])])
            metas.append(vm)
        vm = VectorMetadata.flatten(self.get_output().name, metas)
        mat = torch.cat(blocks, dim=1)
        if vm.size != mat.shape[1]:
            raise ValueError(f"combined metadata has {vm.size} slots, the "
                             f"matrix {mat.shape[1]}")
        return Column(OPVector, mat, None, {"vector_meta": vm})
