"""Map vectorizers (counterpart of ``transmogrifai_tpu.impl.feature.maps``):
a map column's key space is found at fit (optionally white- or
black-listed), and the model emits one block whose slots carry
``grouping=key``, so the SanityChecker and the model insights attribute
them to their key.

Map columns are python dicts on the host; the fills are fitted there in
float64 and the blocks built there with the JAX package's calls (the
hashed keys through ``tokenize_hash_texts``), then copied to the table's
device once: bit-equal to the JAX package's.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ...stages.base import Estimator, Transformer
from ...table import FeatureTable
from ...types import OPVector
from ...vector_metadata import (
    NULL_INDICATOR, OTHER_INDICATOR, VectorColumnMetadata,
)
from .vectorizers import TransmogrifierDefaults as D
from .vectorizers import (
    _emit_host, _map_rows, _top_values, tokenize_hash_texts,
)


def _discover_keys(rows: Sequence[Optional[Dict[str, Any]]],
                   white: Sequence[str], black: Sequence[str]) -> List[str]:
    """The sorted keys of the rows' maps, within ``white`` (when given)
    and outside ``black``."""
    keys: set = set()
    for r in rows:
        if r:
            keys.update(str(k) for k in r)
    if white:
        keys &= set(white)
    keys -= set(black)
    return sorted(keys)


def _concat(n: int, blocks: List[np.ndarray]) -> np.ndarray:
    return (np.concatenate(blocks, axis=1) if blocks
            else np.zeros((n, 0), dtype=np.float32))


def _is_missing(v) -> bool:
    return v is None or (isinstance(v, float) and np.isnan(v))


class MapVectorizer(Estimator):
    """Seq[RealMap, IntegralMap, BinaryMap, ...] -> OPVector: per key its
    value, missing ones filled with the key's mean (or ``fill_value``),
    and a null indicator."""

    output_type = OPVector

    def __init__(self, fill_with_mean: bool = D.FillWithMean,
                 fill_value: float = D.FillValue,
                 track_nulls: bool = D.TrackNulls,
                 white_list_keys: Sequence[str] = (),
                 black_list_keys: Sequence[str] = (), uid=None):
        super().__init__("vecMap", uid)
        self.fill_with_mean = fill_with_mean
        self.fill_value = fill_value
        self.track_nulls = track_nulls
        self.white_list_keys = tuple(white_list_keys)
        self.black_list_keys = tuple(black_list_keys)

    def fit(self, table: FeatureTable) -> Transformer:
        all_keys: List[List[str]] = []
        fills: List[List[float]] = []
        for f in self.input_features:
            rows = _map_rows(table[f.name])
            keys = _discover_keys(rows, self.white_list_keys,
                                  self.black_list_keys)
            kf: List[float] = []
            for k in keys:
                vals = ([float(r[k]) for r in rows
                         if r and k in r and not _is_missing(r[k])]
                        if self.fill_with_mean else [])
                kf.append(float(np.mean(vals)) if vals else self.fill_value)
            all_keys.append(keys)
            fills.append(kf)
        return self._finalize_model(MapVectorizerModel(
            keys=all_keys, fills=fills, track_nulls=self.track_nulls))


class MapVectorizerModel(Transformer):
    output_type = OPVector

    def __init__(self, keys: List[List[str]], fills: List[List[float]],
                 track_nulls: bool, uid=None):
        super().__init__("vecMap", uid)
        self.keys = keys
        self.fills = fills
        self.track_nulls = track_nulls

    def transform_column(self, table: FeatureTable):
        n = table.num_rows
        step = 2 if self.track_nulls else 1
        blocks: List[np.ndarray] = []
        meta: List[VectorColumnMetadata] = []
        for f, keys, fills in zip(self.input_features, self.keys, self.fills):
            rows = _map_rows(table[f.name])
            block = np.zeros((n, len(keys) * step), dtype=np.float32)
            for j, (key, fill) in enumerate(zip(keys, fills)):
                for i, r in enumerate(rows):
                    v = r.get(key) if r else None
                    if _is_missing(v):
                        block[i, j * step] = fill
                        if self.track_nulls:
                            block[i, j * step + 1] = 1.0
                    else:
                        block[i, j * step] = float(v)
                meta.append(VectorColumnMetadata(f.name, f.type_name, key,
                                                 None))
                if self.track_nulls:
                    meta.append(VectorColumnMetadata(
                        f.name, f.type_name, key, NULL_INDICATOR))
            blocks.append(block)
        return _emit_host(self, table, _concat(n, blocks), meta)


def _pivot_meta(f, key: str, vocab: Sequence[str]
                ) -> List[VectorColumnMetadata]:
    return [VectorColumnMetadata(f.name, f.type_name, key, v)
            for v in list(vocab) + [OTHER_INDICATOR]]


class TextMapPivotVectorizer(Estimator):
    """Seq[PickListMap, TextMap, MultiPickListMap, ...] -> OPVector: per
    key a pivot over its top values (``_top_values``; a list or set value
    counts each element) with an OTHER slot and a null slot."""

    output_type = OPVector

    def __init__(self, top_k: int = D.TopK, min_support: int = D.MinSupport,
                 track_nulls: bool = D.TrackNulls,
                 white_list_keys: Sequence[str] = (),
                 black_list_keys: Sequence[str] = (), uid=None):
        super().__init__("pivotTextMap", uid)
        self.top_k = top_k
        self.min_support = min_support
        self.track_nulls = track_nulls
        self.white_list_keys = tuple(white_list_keys)
        self.black_list_keys = tuple(black_list_keys)

    def fit(self, table: FeatureTable) -> Transformer:
        vocabs: List[Dict[str, List[str]]] = []
        for f in self.input_features:
            rows = _map_rows(table[f.name])
            per_key: Dict[str, List[str]] = {}
            for k in _discover_keys(rows, self.white_list_keys,
                                    self.black_list_keys):
                cnt: Counter = Counter()
                for r in rows:
                    if r and k in r and r[k] is not None:
                        if isinstance(r[k], (list, tuple, set)):
                            cnt.update(str(v) for v in r[k])
                        else:
                            cnt[str(r[k])] += 1
                per_key[k] = _top_values(cnt, self.top_k, self.min_support)
            vocabs.append(per_key)
        return self._finalize_model(TextMapPivotVectorizerModel(
            vocabs=vocabs, track_nulls=self.track_nulls))


class TextMapPivotVectorizerModel(Transformer):
    output_type = OPVector

    def __init__(self, vocabs: List[Dict[str, List[str]]], track_nulls: bool,
                 uid=None):
        super().__init__("pivotTextMap", uid)
        self.vocabs = vocabs
        self.track_nulls = track_nulls

    def transform_column(self, table: FeatureTable):
        n = table.num_rows
        blocks: List[np.ndarray] = []
        meta: List[VectorColumnMetadata] = []
        for f, per_key in zip(self.input_features, self.vocabs):
            rows = _map_rows(table[f.name])
            for key in sorted(per_key):
                vocab = per_key[key]
                k = len(vocab)
                block = np.zeros((n, k + 1 + (1 if self.track_nulls else 0)),
                                 dtype=np.float32)
                index = {v: i for i, v in enumerate(vocab)}
                for i, r in enumerate(rows):
                    v = r.get(key) if r else None
                    if v is None:
                        if self.track_nulls:
                            block[i, k + 1] = 1.0
                        continue
                    for item in (v if isinstance(v, (list, tuple, set))
                                 else [v]):
                        block[i, index.get(str(item), k)] = 1.0
                blocks.append(block)
                meta.extend(_pivot_meta(f, key, vocab))
                if self.track_nulls:
                    meta.append(VectorColumnMetadata(
                        f.name, f.type_name, key, NULL_INDICATOR))
        return _emit_host(self, table, _concat(n, blocks), meta)


class SmartTextMapVectorizer(Estimator):
    """Seq[TextMap] -> OPVector: per key a pivot (as
    ``TextMapPivotVectorizer``, without its null slot) when it has at most
    ``max_cardinality`` distinct values, else its values tokenized and
    hashed into ``num_hashes`` slots; a null slot follows either."""

    output_type = OPVector

    def __init__(self, max_cardinality: int = D.MaxCardinality,
                 top_k: int = D.TopK, min_support: int = D.MinSupport,
                 num_hashes: int = D.NumHashes,
                 track_nulls: bool = D.TrackNulls, uid=None):
        super().__init__("smartTxtMapVec", uid)
        self.max_cardinality = max_cardinality
        self.top_k = top_k
        self.min_support = min_support
        self.num_hashes = num_hashes
        self.track_nulls = track_nulls

    def fit(self, table: FeatureTable) -> Transformer:
        plans: List[Dict[str, Dict[str, Any]]] = []
        for f in self.input_features:
            rows = _map_rows(table[f.name])
            plan: Dict[str, Dict[str, Any]] = {}
            for k in _discover_keys(rows, (), ()):
                cnt = Counter(str(r[k]) for r in rows
                              if r and k in r and r[k] is not None)
                plan[k] = ({"kind": "pivot", "vocab": _top_values(
                    cnt, self.top_k, self.min_support)}
                    if len(cnt) <= self.max_cardinality else {"kind": "hash"})
            plans.append(plan)
        return self._finalize_model(SmartTextMapVectorizerModel(
            plans=plans, num_hashes=self.num_hashes,
            track_nulls=self.track_nulls))


class SmartTextMapVectorizerModel(Transformer):
    output_type = OPVector

    def __init__(self, plans: List[Dict[str, Dict[str, Any]]],
                 num_hashes: int, track_nulls: bool, uid=None):
        super().__init__("smartTxtMapVec", uid)
        self.plans = plans
        self.num_hashes = num_hashes
        self.track_nulls = track_nulls

    def transform_column(self, table: FeatureTable):
        n = table.num_rows
        blocks: List[np.ndarray] = []
        meta: List[VectorColumnMetadata] = []
        for f, plan in zip(self.input_features, self.plans):
            rows = _map_rows(table[f.name])
            for key in sorted(plan):
                spec = plan[key]
                vals = [r.get(key) if r else None for r in rows]
                if spec["kind"] == "pivot":
                    vocab = spec["vocab"]
                    k = len(vocab)
                    block = np.zeros((n, k + 1), dtype=np.float32)
                    index = {v: i for i, v in enumerate(vocab)}
                    for i, v in enumerate(vals):
                        if v is not None:
                            block[i, index.get(str(v), k)] = 1.0
                    blocks.append(block)
                    meta.extend(_pivot_meta(f, key, vocab))
                else:
                    blocks.append(tokenize_hash_texts(
                        [str(v) if v is not None else None for v in vals],
                        self.num_hashes))
                    meta.extend(VectorColumnMetadata(
                        f.name, f.type_name, key, None,
                        descriptor_value=f"hash_{j}")
                        for j in range(self.num_hashes))
                if self.track_nulls:
                    blocks.append(np.array([[1.0 if v is None else 0.0]
                                            for v in vals],
                                           dtype=np.float32).reshape(n, 1))
                    meta.append(VectorColumnMetadata(
                        f.name, f.type_name, key, NULL_INDICATOR))
        return _emit_host(self, table, _concat(n, blocks), meta)


class TextMapNullEstimator(Estimator):
    """Seq[TextMap] -> OPVector: one null indicator per (feature, key) of
    the key space found at fit (an empty string is null too)."""

    output_type = OPVector

    def __init__(self, white_list_keys: Sequence[str] = (),
                 black_list_keys: Sequence[str] = (), uid=None):
        super().__init__("textMapNull", uid)
        self.white_list_keys = tuple(white_list_keys)
        self.black_list_keys = tuple(black_list_keys)

    def fit(self, table: FeatureTable) -> Transformer:
        keys = [_discover_keys(_map_rows(table[f.name]),
                               self.white_list_keys, self.black_list_keys)
                for f in self.input_features]
        return self._finalize_model(TextMapNullModel(keys=keys))


class TextMapNullModel(Transformer):
    output_type = OPVector

    def __init__(self, keys: List[List[str]], uid=None):
        super().__init__("textMapNull", uid)
        self.keys = keys

    def transform_column(self, table: FeatureTable):
        n = table.num_rows
        blocks: List[np.ndarray] = []
        meta: List[VectorColumnMetadata] = []
        for f, keys in zip(self.input_features, self.keys):
            rows = _map_rows(table[f.name])
            block = np.zeros((n, len(keys)), dtype=np.float32)
            for j, key in enumerate(keys):
                for i, r in enumerate(rows):
                    v = r.get(key) if r else None
                    if v is None or str(v) == "":
                        block[i, j] = 1.0
                meta.append(VectorColumnMetadata(
                    f.name, f.type_name, key, NULL_INDICATOR))
            blocks.append(block)
        return _emit_host(self, table, _concat(n, blocks), meta)
