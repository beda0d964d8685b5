"""Vectorizers (counterpart of
``transmogrifai_tpu.impl.feature.vectorizers``): typed columns -> one
OPVector column with per-slot provenance.

The numeric ones (real, integral, binary) fill and track nulls on the
device the table's tensors are on; their fills are fitted on the host in
float64, as the JAX package fits them. The string work (counting pivot
values, tokenizing, hashing) stays on the host, as there: a pivot sends its
integer codes to the device and builds its one-hot block there, a hashing
block is counted on the host and copied over. Every block is bit-equal to
the JAX package's. The tokenizer and the crc32 hash are the JAX package's
Python definitions (its C++ text kernel gives the same results by
construction and is not ported).
"""
from __future__ import annotations

import re
import zlib
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ...stages.base import Estimator, Transformer, UnaryTransformer
from ...table import Column, FeatureTable
from ...types import OPVector, Text, TextList
from ...vector_metadata import (
    NULL_INDICATOR, OTHER_INDICATOR, VectorColumnMetadata, VectorMetadata,
)


class TransmogrifierDefaults:
    """The JAX package's default knobs."""
    TopK = 20
    MinSupport = 10
    FillValue = 0.0
    BinaryFillValue = False
    NumHashes = 512
    MaxCardinality = 30
    MinTokenLength = 1
    TrackNulls = True
    FillWithMean = True
    FillWithMode = True


D = TransmogrifierDefaults


def _meta(feature, indicator=None) -> VectorColumnMetadata:
    return VectorColumnMetadata(parent_feature_name=feature.name,
                                parent_feature_type=feature.type_name,
                                grouping=feature.name,
                                indicator_value=indicator)


def _hash_meta(feature, num_hashes: int) -> List[VectorColumnMetadata]:
    return [VectorColumnMetadata(feature.name, feature.type_name,
                                 feature.name, None,
                                 descriptor_value=f"hash_{j}")
            for j in range(num_hashes)]


def _tensor(table: FeatureTable, a) -> torch.Tensor:
    """``a`` as a tensor on the table's device."""
    return a if isinstance(a, torch.Tensor) else table.on_device(
        np.asarray(a))


def _f32(table: FeatureTable, col: Column) -> torch.Tensor:
    """A scalar column's values as float32 (n,) on the table's device (an
    int64 host column converted on the host, as numpy converts it)."""
    if isinstance(col.values, torch.Tensor):
        return col.values.reshape(-1).to(torch.float32)
    return table.on_device(np.asarray(col.values, dtype=np.float32)
                           .reshape(-1))


def _valid(table: FeatureTable, col: Column) -> torch.Tensor:
    if col.mask is None:
        return torch.ones(len(col), dtype=torch.bool,
                          device=table.device or "cpu")
    return _tensor(table, col.mask)


def _emit(stage: Transformer, mat: torch.Tensor,
          meta: List[VectorColumnMetadata]) -> Column:
    vm = VectorMetadata.of(stage.get_output().name, meta)
    if vm.size != mat.shape[1]:
        raise ValueError(f"{type(stage).__name__}: metadata has {vm.size} "
                         f"slots, the matrix {mat.shape[1]}")
    return Column(OPVector, mat, None, {"vector_meta": vm})


def _emit_host(stage: Transformer, table: FeatureTable, mat: np.ndarray,
               meta: List[VectorColumnMetadata]) -> Column:
    """``_emit`` of a block built on the host, copied to the table's
    device once."""
    return _emit(stage, table.on_device(
        np.ascontiguousarray(mat, dtype=np.float32)), meta)


def _map_rows(col: Column) -> List[Optional[Dict[str, Any]]]:
    """Each row's python value (a map, a list), None where the row is
    missing."""
    vals, valid = col.host_values(), col.valid_mask()
    return [vals[i] if valid[i] and vals[i] is not None else None
            for i in range(len(col))]


def _fill_blocks(stage: Transformer, table: FeatureTable,
                 fills: Sequence[float], track_nulls: bool) -> Column:
    """Each input's values with its missing slots filled, and with
    ``track_nulls`` a null-indicator slot after each."""
    cols = [table[f.name] for f in stage.input_features]
    vals = torch.stack([_f32(table, c) for c in cols], dim=1)   # (n, c)
    m = torch.stack([_valid(table, c) for c in cols], dim=1)
    fill = stage.device_constant("fills", list(fills), torch.float32,
                                 vals.device)
    out = torch.where(m, vals, fill[None, :])
    meta: List[VectorColumnMetadata] = []
    for f in stage.input_features:
        meta.append(_meta(f))
        if track_nulls:
            meta.append(_meta(f, NULL_INDICATOR))
    if track_nulls:
        out = torch.stack([out, (~m).to(torch.float32)],
                          dim=2).reshape(out.shape[0], -1)
    return _emit(stage, out, meta)


class RealVectorizer(Estimator):
    """Seq[Real] -> OPVector: fits one fill per column (the mean of its
    valid values, or ``fill_value``)."""

    output_type = OPVector

    def __init__(self, fill_with_mean: bool = D.FillWithMean,
                 fill_value: float = D.FillValue,
                 track_nulls: bool = D.TrackNulls,
                 uid: Optional[str] = None):
        super().__init__("vecReal", uid)
        self.fill_with_mean = fill_with_mean
        self.fill_value = fill_value
        self.track_nulls = track_nulls

    def fit(self, table: FeatureTable) -> Transformer:
        fills = []
        for f in self.input_features:
            col = table[f.name]
            vals = col.host_values().astype(np.float64).reshape(-1)
            m = col.valid_mask()
            fills.append(float(vals[m].mean())
                         if self.fill_with_mean and m.any()
                         else self.fill_value)
        return self._finalize_model(
            RealVectorizerModel(fills=fills, track_nulls=self.track_nulls))


class RealVectorizerModel(Transformer):
    """Seq[Real] or Seq[Integral] -> OPVector: each missing value takes its
    column's fill, and with ``track_nulls`` a null-indicator slot follows
    each column."""

    output_type = OPVector

    def __init__(self, fills: List[float], track_nulls: bool,
                 uid: Optional[str] = None):
        super().__init__("vecReal", uid)
        self.fills = fills
        self.track_nulls = track_nulls

    def transform_column(self, table: FeatureTable) -> Column:
        return _fill_blocks(self, table, self.fills, self.track_nulls)


class IntegralVectorizer(Estimator):
    """Seq[Integral] -> OPVector: fills each column with its mode (ties to
    the smallest value) or ``fill_value``; the model is a
    ``RealVectorizerModel``."""

    output_type = OPVector

    def __init__(self, fill_with_mode: bool = D.FillWithMode,
                 fill_value: int = 0,
                 track_nulls: bool = D.TrackNulls,
                 uid: Optional[str] = None):
        super().__init__("vecIntegral", uid)
        self.fill_with_mode = fill_with_mode
        self.fill_value = fill_value
        self.track_nulls = track_nulls

    def fit(self, table: FeatureTable) -> Transformer:
        fills = []
        for f in self.input_features:
            col = table[f.name]
            vals = col.host_values().reshape(-1)
            m = col.valid_mask()
            if self.fill_with_mode and m.any():
                vv, cc = np.unique(vals[m], return_counts=True)
                fills.append(float(vv[np.argmax(cc)]))
            else:
                fills.append(float(self.fill_value))
        return self._finalize_model(
            RealVectorizerModel(fills=fills, track_nulls=self.track_nulls))


class BinaryVectorizer(Transformer):
    """Seq[Binary] -> OPVector: missing values take ``fill_value``, with a
    null indicator after each column when ``track_nulls``."""

    output_type = OPVector

    def __init__(self, fill_value: bool = D.BinaryFillValue,
                 track_nulls: bool = D.TrackNulls,
                 uid: Optional[str] = None):
        super().__init__("vecBinary", uid)
        self.fill_value = fill_value
        self.track_nulls = track_nulls

    def transform_column(self, table: FeatureTable) -> Column:
        return _fill_blocks(self, table,
                            [float(self.fill_value)] * len(
                                self.input_features), self.track_nulls)


class RealNNVectorizer(Transformer):
    """Seq[RealNN] -> OPVector: the columns side by side."""

    output_type = OPVector

    def __init__(self, uid: Optional[str] = None):
        super().__init__("vecRealNN", uid)

    def transform_column(self, table: FeatureTable) -> Column:
        blocks = [_f32(table, table[f.name]) for f in self.input_features]
        return _emit(self, torch.stack(blocks, dim=1),
                     [_meta(f) for f in self.input_features])


def _top_values(cnt: Counter, top_k: int, min_support: int) -> List[Any]:
    """The pivot's values: at least ``min_support`` rows, by count
    descending and then by value, the first ``top_k``."""
    top = [v for v, c in cnt.most_common() if c >= min_support]
    return sorted(top, key=lambda v: (-cnt[v], v))[:top_k]


def _one_hot(table: FeatureTable, slot: np.ndarray,
             width: int) -> torch.Tensor:
    """(n, width) float32 on the table's device: row i has a one in column
    ``slot[i]`` (none where ``slot[i]`` is ``width``)."""
    idx = table.on_device(slot)
    return torch.nn.functional.one_hot(idx, width + 1)[:, :width].to(
        torch.float32)


class OneHotVectorizer(Estimator):
    """Seq[PickList-like or MultiPickList] -> OPVector: a pivot over each
    column's top values (``_top_values``) with an OTHER slot and, with
    ``track_nulls``, a null slot."""

    output_type = OPVector

    def __init__(self, top_k: int = D.TopK,
                 min_support: int = D.MinSupport,
                 track_nulls: bool = D.TrackNulls,
                 uid: Optional[str] = None):
        super().__init__("pivot", uid)
        self.top_k = top_k
        self.min_support = min_support
        self.track_nulls = track_nulls

    def fit(self, table: FeatureTable) -> Transformer:
        vocabs: List[List[Any]] = []
        for f in self.input_features:
            col = table[f.name]
            vals, m = col.host_values(), col.valid_mask()
            if col.kind == "multipicklist":
                cnt = Counter(v for vs, ok in zip(vals, m) if ok
                              for v in (vs or ()))
            else:
                cnt = Counter(str(v) for v, ok in zip(vals, m) if ok)
            vocabs.append(_top_values(cnt, self.top_k, self.min_support))
        return self._finalize_model(
            OneHotVectorizerModel(vocabs=vocabs,
                                  track_nulls=self.track_nulls))


class OneHotVectorizerModel(Transformer):
    """The fitted pivot: per column its values' slots, OTHER, and null."""

    output_type = OPVector

    def __init__(self, vocabs: List[List[Any]], track_nulls: bool,
                 uid: Optional[str] = None):
        super().__init__("pivot", uid)
        self.vocabs = vocabs
        self.track_nulls = track_nulls

    def transform_column(self, table: FeatureTable) -> Column:
        n = table.num_rows
        blocks, meta = [], []
        for f, vocab in zip(self.input_features, self.vocabs):
            col = table[f.name]
            vals, m = col.host_values(), col.valid_mask()
            k = len(vocab)
            width = k + 1 + (1 if self.track_nulls else 0)
            index = {v: i for i, v in enumerate(vocab)}
            if col.kind == "multipicklist":
                block = np.zeros((n, width), dtype=np.float32)
                for i, (vs, ok) in enumerate(zip(vals, m)):
                    if ok:
                        for v in (vs or ()):
                            block[i, index.get(v, k)] = 1.0
                if self.track_nulls:
                    block[~m, k + 1] = 1.0
                blocks.append(table.on_device(block))
            else:
                # the column each row lights: its value's, OTHER (k), null
                # (k + 1), or none (width) for an untracked null
                slot = np.full(n, k + 1 if self.track_nulls else width,
                               dtype=np.int64)
                for i in np.nonzero(m)[0]:
                    slot[i] = index.get(str(vals[i]), k)
                blocks.append(_one_hot(table, slot, width))
            mc = [v for v in vocab] + [OTHER_INDICATOR]
            if self.track_nulls:
                mc.append(NULL_INDICATOR)
            meta.extend(_meta(f, v) for v in mc)
        return _emit(self, torch.cat(blocks, dim=1), meta)


_TOKEN_SPLIT = re.compile(r"[^\w]+", re.UNICODE)


def tokenize_text(s: Optional[str], min_token_length: int = 1) -> List[str]:
    """Lower case, split on runs of non-word characters, keep tokens of at
    least ``min_token_length`` characters."""
    if s is None:
        return []
    return [t for t in _TOKEN_SPLIT.split(s.lower())
            if len(t) >= min_token_length]


def _hash_token(tok: str, num_hashes: int) -> int:
    """A token's bin: crc32 of its UTF-8 bytes modulo ``num_hashes``."""
    return zlib.crc32(tok.encode("utf-8")) % num_hashes


def hash_token_lists(token_lists: Sequence[Sequence[str]], num_hashes: int,
                     binary: bool = False) -> np.ndarray:
    """(n, num_hashes) float32 token counts (ones with ``binary``)."""
    out = np.zeros((len(token_lists), num_hashes), dtype=np.float32)
    for i, toks in enumerate(token_lists):
        for t in toks or ():
            out[i, _hash_token(t, num_hashes)] += 1.0
    if binary:
        np.minimum(out, 1.0, out=out)
    return out


def tokenize_hash_texts(docs: Sequence[Optional[str]], num_hashes: int,
                        min_token_length: int = 1,
                        binary: bool = False) -> np.ndarray:
    """``hash_token_lists`` of each document's ``tokenize_text``."""
    return hash_token_lists([tokenize_text(d, min_token_length)
                             for d in docs], num_hashes, binary)


class TextTokenizer(UnaryTransformer):
    """Text -> TextList: ``tokenize_text`` of each value."""

    def __init__(self, min_token_length: int = D.MinTokenLength,
                 uid: Optional[str] = None):
        super().__init__("tokenize", transform_fn=self._tokens,
                         output_type=TextList, input_type=Text, uid=uid)
        self.min_token_length = min_token_length

    def _tokens(self, v):
        return tokenize_text(v, self.min_token_length)


class HashingVectorizer(Transformer):
    """Seq[TextList] -> OPVector: token counts hashed into ``num_hashes``
    slots, one block a column or one shared block."""

    output_type = OPVector

    def __init__(self, num_hashes: int = D.NumHashes,
                 shared_hash_space: bool = False, binary_freq: bool = False,
                 uid: Optional[str] = None):
        super().__init__("vecHash", uid)
        self.num_hashes = num_hashes
        self.shared_hash_space = shared_hash_space
        self.binary_freq = binary_freq

    def transform_column(self, table: FeatureTable) -> Column:
        counts = [hash_token_lists(table[f.name].host_values(),
                                   self.num_hashes, self.binary_freq)
                  for f in self.input_features]
        if self.shared_hash_space:
            block = np.zeros((table.num_rows, self.num_hashes), np.float32)
            for c in counts:
                block += c
            meta = [VectorColumnMetadata(
                "+".join(f.name for f in self.input_features), "TextList",
                None, None, descriptor_value=f"hash_{j}")
                for j in range(self.num_hashes)]
            counts = [block]
        else:
            meta = [c for f in self.input_features
                    for c in _hash_meta(f, self.num_hashes)]
        return _emit(self, table.on_device(np.concatenate(counts, axis=1)),
                     meta)


class SmartTextVectorizer(Estimator):
    """Seq[Text] -> OPVector: a column of at most ``max_cardinality``
    distinct values is pivoted (as ``OneHotVectorizer``, without its null
    slot), any other is tokenized and hashed into ``num_hashes`` slots;
    with ``track_nulls`` a null slot follows either."""

    output_type = OPVector

    def __init__(self, max_cardinality: int = D.MaxCardinality,
                 top_k: int = D.TopK,
                 min_support: int = D.MinSupport,
                 num_hashes: int = D.NumHashes,
                 track_nulls: bool = D.TrackNulls,
                 uid: Optional[str] = None):
        super().__init__("smartTxtVec", uid)
        self.max_cardinality = max_cardinality
        self.top_k = top_k
        self.min_support = min_support
        self.num_hashes = num_hashes
        self.track_nulls = track_nulls

    def fit(self, table: FeatureTable) -> Transformer:
        plans: List[Dict[str, Any]] = []
        for f in self.input_features:
            col = table[f.name]
            cnt = Counter(str(v) for v, ok in zip(col.host_values(),
                                                  col.valid_mask()) if ok)
            if len(cnt) <= self.max_cardinality:
                plans.append({"kind": "pivot", "vocab": _top_values(
                    cnt, self.top_k, self.min_support)})
            else:
                plans.append({"kind": "hash"})
        return self._finalize_model(SmartTextVectorizerModel(
            plans=plans, num_hashes=self.num_hashes,
            track_nulls=self.track_nulls))


class SmartTextVectorizerModel(Transformer):
    """The fitted smart text vectorizer: a pivot or a hashing block a
    column, each followed by its null slot."""

    output_type = OPVector

    def __init__(self, plans: List[Dict[str, Any]], num_hashes: int,
                 track_nulls: bool, uid: Optional[str] = None):
        super().__init__("smartTxtVec", uid)
        self.plans = plans
        self.num_hashes = num_hashes
        self.track_nulls = track_nulls

    def transform_column(self, table: FeatureTable) -> Column:
        n = table.num_rows
        blocks, meta = [], []
        for f, plan in zip(self.input_features, self.plans):
            col = table[f.name]
            vals, m = col.host_values(), col.valid_mask()
            if plan["kind"] == "pivot":
                vocab = plan["vocab"]
                k = len(vocab)
                index = {v: i for i, v in enumerate(vocab)}
                slot = np.full(n, k + 1, dtype=np.int64)
                for i in np.nonzero(m)[0]:
                    slot[i] = index.get(str(vals[i]), k)
                blocks.append(_one_hot(table, slot, k + 1))
                meta.extend(_meta(f, v) for v in list(vocab)
                            + [OTHER_INDICATOR])
            else:
                blocks.append(table.on_device(tokenize_hash_texts(
                    [v if ok else None for v, ok in zip(vals, m)],
                    self.num_hashes)))
                meta.extend(_hash_meta(f, self.num_hashes))
            if self.track_nulls:
                blocks.append(table.on_device(
                    (~m).astype(np.float32)[:, None]))
                meta.append(_meta(f, NULL_INDICATOR))
        return _emit(self, torch.cat(blocks, dim=1), meta)


class VectorsCombiner(Transformer):
    """Seq[OPVector] -> OPVector: concatenation, with the slots' metadata
    flattened in the same order; blocks made on the host are copied to the
    table's device."""

    output_type = OPVector

    def __init__(self, uid: Optional[str] = None):
        super().__init__("combined", uid)

    def transform_column(self, table: FeatureTable) -> Column:
        blocks, metas = [], []
        for f in self.input_features:
            col = table[f.name]
            arr = _tensor(table, col.values).to(torch.float32)
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
