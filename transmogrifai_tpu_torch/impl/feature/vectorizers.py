"""Numeric vectorizers, fitted half (counterpart of
``transmogrifai_tpu.impl.feature.vectorizers``): typed columns -> one
OPVector column with per-slot provenance. They compute on the device the
table's tensors are on.
"""
from __future__ import annotations

from typing import List

import torch

from ...stages.base import Transformer
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


class RealVectorizerModel(Transformer):
    """Seq[Real] -> OPVector: each missing value takes its column's fill,
    and with ``track_nulls`` a null-indicator slot follows each column."""

    output_type = OPVector

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
