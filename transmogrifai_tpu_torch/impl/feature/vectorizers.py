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

import functools
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


def _fill_matrix(stage: Transformer, vals: List[torch.Tensor],
                 valid: List[torch.Tensor], fills: Sequence[float],
                 track_nulls: bool) -> torch.Tensor:
    """(n, c) float32 of the inputs' (n,) values with their missing slots
    filled, and with ``track_nulls`` a null-indicator slot after each."""
    v = torch.stack(vals, dim=1)
    m = torch.stack(valid, dim=1)
    fill = stage.device_constant("fills", list(fills), torch.float32,
                                 v.device)
    out = torch.where(m, v, fill[None, :])
    if track_nulls:
        out = torch.stack([out, (~m).to(torch.float32)],
                          dim=2).reshape(out.shape[0], 2 * out.shape[1])
    return out


def _fill_blocks(stage: Transformer, table: FeatureTable,
                 fills: Sequence[float], track_nulls: bool) -> Column:
    """``_fill_matrix`` of the table's input columns, with its metadata."""
    cols = [table[f.name] for f in stage.input_features]
    out = _fill_matrix(stage, [_f32(table, c) for c in cols],
                       [_valid(table, c) for c in cols], fills, track_nulls)
    meta: List[VectorColumnMetadata] = []
    for f in stage.input_features:
        meta.append(_meta(f))
        if track_nulls:
            meta.append(_meta(f, NULL_INDICATOR))
    return _emit(stage, out, meta)


def _device_fill(stage: Transformer, env, fills: Sequence[float],
                 track_nulls: bool):
    """The fill vectorizers' ``device_columnar``: ``env`` maps each input
    to its staged (float32 values, bool mask) (``plan.py``)."""
    ins = [env[f.name] for f in stage.input_features]
    return _fill_matrix(stage, [v.reshape(-1).to(torch.float32)
                                for v, _ in ins],
                        [m for _, m in ins], fills, track_nulls), None


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

    # -- streaming fit (OpWorkflow.train(stream=...)) ------------------------
    def fit_streaming_prep(self, run):
        """The one-pass spec ``(pass_id, fold, extract, finish)`` the
        streaming trainer fuses with its layer's other one-pass fits; None
        when constant fills need no pass."""
        if not self.fill_with_mean:
            return None
        from ...streaming.folds import ColStatsFold
        k = len(self.input_features)
        fold = ColStatsFold(k)

        def extract(table):
            cols = [table[f.name] for f in self.input_features]
            X = np.stack([c.host_values().astype(np.float64).reshape(-1)
                          for c in cols], axis=1)
            mask = np.stack([c.valid_mask() for c in cols], axis=1)
            return X, mask

        def finish(state) -> Transformer:
            res = fold.finalize(state)
            fills = [float(res.mean[i]) if res.count[i] > 0
                     else self.fill_value for i in range(k)]
            return self._finalize_model(RealVectorizerModel(
                fills=fills, track_nulls=self.track_nulls))

        return "fills", fold, extract, finish

    def fit_streaming(self, run) -> Transformer:
        """Mean fills as one column-stats fold over the chunks: the count
        and sum of each column in float64, the JAX package's fills bit for
        bit."""
        spec = self.fit_streaming_prep(run)
        if spec is None:
            return self._finalize_model(RealVectorizerModel(
                fills=[self.fill_value] * len(self.input_features),
                track_nulls=self.track_nulls))
        pass_id, fold, extract, finish = spec
        return finish(run.fold(pass_id, fold, extract))


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

    def device_columnar(self, env):
        return _device_fill(self, env, self.fills, self.track_nulls)

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

    def device_columnar(self, env):
        return _device_fill(self, env, [float(self.fill_value)] * len(
            self.input_features), self.track_nulls)

    def transform_column(self, table: FeatureTable) -> Column:
        return _fill_blocks(self, table,
                            [float(self.fill_value)] * len(
                                self.input_features), self.track_nulls)


class RealNNVectorizer(Transformer):
    """Seq[RealNN] -> OPVector: the columns side by side."""

    output_type = OPVector

    def __init__(self, uid: Optional[str] = None):
        super().__init__("vecRealNN", uid)

    def device_columnar(self, env):
        return torch.stack([env[f.name][0].reshape(-1).to(torch.float32)
                            for f in self.input_features], dim=1), None

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


def porter_stem(w: str) -> str:
    """Compact Porter-style English stemmer (the high-coverage rules of
    steps 1-2: plurals, -ed/-ing, common suffixes — the analog of the
    reference's Lucene per-language analyzers with stemming,
    LuceneTextAnalyzer.scala:203; full Porter fidelity is not the goal,
    stable feature collisions for inflected forms are)."""
    if len(w) <= 3:
        return w
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("s") and not w.endswith("ss") and len(w) > 3:
        w = w[:-1]
    for suf, rep in (("ational", "ate"), ("ization", "ize"),
                     ("fulness", "ful"), ("ousness", "ous"),
                     ("iveness", "ive"), ("tional", "tion"),
                     ("biliti", "ble"), ("entli", "ent"),
                     ("ation", "ate"), ("alism", "al"), ("aliti", "al"),
                     ("ness", ""), ("ment", "")):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: len(w) - len(suf)] + rep
    if w.endswith("ing") and len(w) > 5:
        w = w[:-3]
        if len(w) >= 3 and w[-1] == w[-2] and w[-1] not in "lsz":
            w = w[:-1]  # running -> run
        return w
    if w.endswith("ed") and len(w) > 4:
        w = w[:-2]
        if len(w) >= 3 and w[-1] == w[-2] and w[-1] not in "lsz":
            w = w[:-1]
        return w
    if w.endswith("ly") and len(w) > 4:
        return w[:-2]
    return w


def _strip_suffixes(w: str, suffixes, min_stem: int = 3) -> str:
    """Longest-match suffix strip with a minimum stem length — the shared
    skeleton of the light per-language stemmers below."""
    for suf, rep in suffixes:
        if w.endswith(suf) and len(w) - len(suf) >= min_stem:
            return w[: len(w) - len(suf)] + rep
    return w


#: light Snowball-style suffix strippers (reference: Lucene ships full
#: per-language Snowball analyzers, LuceneTextAnalyzer.scala:203; as with
#: porter_stem the goal is stable feature collisions for inflected forms,
#: not linguistic fidelity). Ordered longest-first so the longest suffix
#: wins.
_FR_SUFFIXES = [
    ("issements", ""), ("issement", ""), ("atrices", "ateur"),
    ("ateurs", "ateur"), ("ations", "ation"), ("logies", "logie"),
    ("ements", ""), ("amment", ""), ("emment", ""), ("ances", "ance"),
    ("ables", "able"), ("istes", "iste"), ("euses", "eux"),
    ("ments", "ment"), ("ation", "ation"), ("ance", "ance"),
    ("able", "able"), ("iste", "iste"), ("euse", "eux"), ("ités", "ité"),
    ("ement", ""), ("ives", "if"), ("ive", "if"), ("eaux", "eau"),
    ("aux", "al"), ("ité", "ité"), ("er", ""), ("es", ""), ("s", ""),
    ("e", ""),
]
_DE_SUFFIXES = [
    ("ungen", "ung"), ("heiten", "heit"), ("keiten", "keit"),
    ("lichen", "lich"), ("ischen", "isch"), ("erinnen", "er"),
    ("ern", ""), ("ung", "ung"), ("heit", "heit"),
    ("keit", "keit"), ("lich", "lich"), ("isch", "isch"), ("en", ""),
    ("er", ""), ("es", ""), ("em", ""), ("e", ""), ("s", ""), ("n", ""),
]
_ES_SUFFIXES = [
    ("amientos", ""), ("imientos", ""), ("aciones", "ación"),
    ("amiento", ""), ("imiento", ""), ("adoras", "ador"),
    ("adores", "ador"), ("ancias", "ancia"), ("idades", "idad"),
    ("encias", "encia"), ("amente", ""), ("mente", ""), ("ación", "ación"),
    ("adora", "ador"), ("ancia", "ancia"), ("encia", "encia"),
    ("idad", "idad"), ("istas", "ista"), ("ista", "ista"),
    ("ables", "able"), ("ibles", "ible"), ("able", "able"),
    ("ible", "ible"), ("osos", "oso"), ("osas", "oso"), ("osa", "oso"),
    ("oso", "oso"), ("es", ""), ("as", "a"), ("os", "o"), ("s", ""),
]


_IT_SUFFIXES = [
    ("azioni", "azione"), ("amenti", ""), ("imenti", ""),
    ("amento", ""), ("imento", ""), ("azione", "azione"),
    ("atrici", "atore"), ("atrice", "atore"), ("atori", "atore"),
    ("atore", "atore"), ("abili", "abile"), ("ibili", "ibile"),
    ("abile", "abile"), ("ibile", "ibile"), ("mente", ""),
    ("ista", "ista"), ("isti", "ista"), ("iste", "ista"),
    ("anza", "anza"), ("anze", "anza"), ("ità", "ità"),
    ("osi", "oso"), ("ose", "oso"), ("osa", "oso"), ("oso", "oso"),
    ("are", ""), ("ere", ""), ("ire", ""), ("ato", ""), ("ata", ""),
    ("ati", ""), ("ate", ""), ("i", ""), ("e", ""), ("a", ""), ("o", ""),
]
_PT_SUFFIXES = [
    ("amentos", ""), ("imentos", ""), ("adoras", "ador"),
    ("adores", "ador"), ("amento", ""), ("imento", ""),
    ("ações", "ação"), ("idades", "idade"), ("amente", ""),
    ("mente", ""), ("adora", "ador"), ("ação", "ação"),
    ("antes", "ante"), ("ância", "ância"), ("idade", "idade"),
    ("ismos", "ismo"), ("istas", "ista"), ("ismo", "ismo"),
    ("ista", "ista"), ("osos", "oso"), ("osas", "oso"), ("osa", "oso"),
    ("oso", "oso"), ("ivas", "ivo"), ("ivos", "ivo"), ("iva", "ivo"),
    ("ivo", "ivo"), ("ões", "ão"), ("ar", ""), ("er", ""), ("ir", ""),
    ("es", ""), ("as", "a"), ("os", "o"), ("s", ""),
]
_NL_SUFFIXES = [
    ("heden", "heid"), ("elijke", "elijk"), ("elijk", "elijk"),
    ("ingen", "ing"), ("aren", "aar"), ("eren", ""), ("ende", ""),
    ("tjes", ""), ("ing", "ing"), ("aar", "aar"), ("end", ""),
    ("ster", ""), ("je", ""), ("en", ""), ("er", ""), ("es", ""),
    ("s", ""), ("e", ""),
]
#: Russian: strip reflexive particle first, then the longest
#: verb/adjective/noun ending (RSLP-style ordering, Cyrillic)
_RU_REFLEXIVE = ("ся", "сь")
_RU_SUFFIXES = [
    ("ировать", ""), ("ованный", ""), ("ейший", ""),
    ("ениями", "ение"), ("ениях", "ение"),
    ("ениям", "ение"), ("ением", "ение"), ("ости", "ость"),
    ("остью", "ость"), ("ение", "ение"), ("ения", "ение"),
    ("ении", "ение"), ("ством", "ство"), ("ство", "ство"),
    ("ывать", ""), ("ивать", ""), ("овать", ""), ("аться", ""),
    ("иться", ""), ("ешься", ""), ("ется", ""), ("ители", "итель"),
    ("итель", "итель"), ("ами", ""), ("ями", ""), ("ого", ""),
    ("его", ""), ("ому", ""), ("ему", ""), ("ыми", ""), ("ими", ""),
    ("ая", ""), ("яя", ""), ("ой", ""), ("ый", ""), ("ий", ""),
    ("ем", ""), ("им", ""), ("ом", ""), ("ах", ""), ("ях", ""),
    ("ует", ""), ("ешь", ""), ("ете", ""), ("ает", ""), ("яет", ""),
    ("ить", ""), ("ать", ""),
    ("ять", ""), ("еть", ""), ("ал", ""), ("ил", ""), ("ыл", ""),
    ("ла", ""), ("ло", ""), ("ли", ""), ("ов", ""), ("ев", ""),
    ("ей", ""), ("ам", ""), ("ям", ""), ("ы", ""), ("и", ""),
    ("а", ""), ("я", ""), ("о", ""), ("е", ""), ("у", ""), ("ю", ""),
    ("ь", ""),
]


def french_stem(w: str) -> str:
    return _strip_suffixes(w, _FR_SUFFIXES) if len(w) > 4 else w


def german_stem(w: str) -> str:
    return _strip_suffixes(w, _DE_SUFFIXES, min_stem=4) if len(w) > 4 else w


def spanish_stem(w: str) -> str:
    return _strip_suffixes(w, _ES_SUFFIXES) if len(w) > 4 else w


def italian_stem(w: str) -> str:
    return _strip_suffixes(w, _IT_SUFFIXES) if len(w) > 4 else w


def portuguese_stem(w: str) -> str:
    return _strip_suffixes(w, _PT_SUFFIXES) if len(w) > 4 else w


def dutch_stem(w: str) -> str:
    return _strip_suffixes(w, _NL_SUFFIXES, min_stem=4) if len(w) > 4 else w


def russian_stem(w: str) -> str:
    if len(w) <= 4:
        return w
    for r in _RU_REFLEXIVE:
        if w.endswith(r) and len(w) - len(r) >= 3:
            w = w[: len(w) - len(r)]
            break
    return _strip_suffixes(w, _RU_SUFFIXES)


#: Scandinavian: sv/no/da share the -en/-et/-er/-ene noun machinery
_SV_SUFFIXES = [
    ("heterna", "het"), ("heten", "het"), ("heter", "het"),
    ("arna", ""), ("erna", ""), ("orna", ""), ("ande", ""), ("ende", ""),
    ("aste", ""), ("arne", ""), ("aren", ""), ("ades", ""), ("are", ""),
    ("ade", ""), ("at", ""), ("ad", ""), ("en", ""), ("ar", ""),
    ("er", ""), ("or", ""), ("et", ""), ("a", ""), ("e", ""), ("s", ""),
]
_NO_DA_SUFFIXES = [
    ("hetene", "het"), ("heten", "het"), ("heter", "het"),
    ("erne", ""), ("ende", ""), ("ene", ""), ("ane", ""), ("else", ""),
    ("ere", ""), ("est", ""), ("et", ""), ("en", ""), ("er", ""),
    ("ar", ""), ("te", ""), ("e", ""), ("s", ""),
]
#: Finnish: strip possessives then the most common case endings (a real
#: Snowball Finnish is far deeper; goal is stable collisions)
_FI_SUFFIXES = [
    ("issaan", ""), ("issään", ""), ("llaan", ""), ("llään", ""),
    ("ssaan", ""), ("ssään", ""), ("iensa", ""), ("iensä", ""),
    ("isiin", ""), ("ista", ""), ("istä", ""), ("ille", ""),
    ("illa", ""), ("illä", ""), ("issa", ""), ("issä", ""),
    ("lla", ""), ("llä", ""), ("ssa", ""), ("ssä", ""), ("sta", ""),
    ("stä", ""), ("lle", ""), ("lta", ""), ("ltä", ""), ("ksi", ""),
    ("tta", ""), ("ttä", ""), ("ien", ""), ("in", ""), ("it", ""),
    ("et", ""), ("at", ""), ("ät", ""), ("na", ""), ("nä", ""),
    ("a", ""), ("ä", ""), ("n", ""), ("t", ""),
]
#: Hungarian: case endings + plural
_HU_SUFFIXES = [
    ("jainak", ""), ("einek", ""), ("oknak", ""), ("eknek", ""),
    ("ságok", "ság"), ("ségek", "ség"), ("ság", "ság"), ("ség", "ség"),
    ("okat", ""), ("eket", ""), ("akat", ""), ("ban", ""), ("ben", ""),
    ("nak", ""), ("nek", ""), ("val", ""), ("vel", ""), ("ból", ""),
    ("ből", ""), ("hoz", ""), ("hez", ""), ("ról", ""), ("ről", ""),
    ("ok", ""), ("ek", ""), ("ak", ""), ("ot", ""), ("et", ""),
    ("at", ""), ("on", ""), ("en", ""), ("án", ""), ("én", ""),
    ("t", ""), ("k", ""),
]
#: Turkish: agglutinative chain simplified to the outermost layers
_TR_SUFFIXES = [
    ("larından", ""), ("lerinden", ""), ("larında", ""), ("lerinde", ""),
    ("larini", ""), ("lerini", ""), ("larına", ""), ("lerine", ""),
    ("ların", ""), ("lerin", ""), ("ları", ""), ("leri", ""),
    ("lardan", ""), ("lerden", ""), ("larda", ""), ("lerde", ""),
    ("lara", ""), ("lere", ""), ("lar", ""), ("ler", ""),
    ("ında", ""), ("inde", ""), ("undan", ""), ("ünden", ""),
    ("dan", ""), ("den", ""), ("tan", ""), ("ten", ""),
    ("da", ""), ("de", ""), ("ta", ""), ("te", ""),
    ("ın", ""), ("in", ""), ("un", ""), ("ün", ""),
    ("ı", ""), ("i", ""), ("u", ""), ("ü", ""), ("a", ""), ("e", ""),
]
#: Polish: declension + common verb endings
_PL_SUFFIXES = [
    ("owaniach", ""), ("owania", ""), ("owanie", ""), ("ościach", "ość"),
    ("ościami", "ość"), ("ości", "ość"), ("ość", "ość"),
    ("owych", "owy"), ("owymi", "owy"), ("owej", "owy"), ("owego", "owy"),
    ("owy", "owy"), ("owa", "owy"), ("owe", "owy"),
    ("ach", ""), ("ami", ""), ("iem", ""), ("em", ""), ("om", ""),
    ("ów", ""), ("ej", ""), ("ego", ""), ("emu", ""), ("ymi", ""),
    ("ych", ""), ("ą", ""), ("ę", ""), ("y", ""), ("i", ""), ("e", ""),
    ("a", ""), ("o", ""), ("u", ""),
]
#: Romanian: articles + plural/case
_RO_SUFFIXES = [
    ("iilor", ""), ("ilor", ""), ("ului", ""), ("elor", ""),
    ("ările", "are"), ("area", "are"), ("erea", "ere"), ("irea", "ire"),
    ("ări", "are"), ("uri", ""), ("ele", ""), ("ea", ""), ("ul", ""),
    ("ii", ""), ("le", ""), ("lui", ""), ("ă", ""), ("a", ""),
    ("e", ""), ("i", ""), ("u", ""),
]
#: Czech: declension
_CS_SUFFIXES = [
    ("ováním", "ování"), ("ování", "ování"), ("ostech", "ost"),
    ("ostem", "ost"), ("ostí", "ost"), ("osti", "ost"), ("ost", "ost"),
    ("ého", ""), ("ému", ""), ("ými", ""), ("ých", ""), ("ami", ""),
    ("emi", ""), ("ech", ""), ("ích", ""), ("ům", ""), ("em", ""),
    ("ou", ""), ("y", ""), ("i", ""), ("e", ""), ("é", ""),
    ("á", ""), ("í", ""), ("ý", ""), ("a", ""), ("o", ""), ("u", ""),
]


def swedish_stem(w: str) -> str:
    return _strip_suffixes(w, _SV_SUFFIXES) if len(w) > 4 else w


def norwegian_stem(w: str) -> str:
    return _strip_suffixes(w, _NO_DA_SUFFIXES) if len(w) > 4 else w


def danish_stem(w: str) -> str:
    return _strip_suffixes(w, _NO_DA_SUFFIXES) if len(w) > 4 else w


def finnish_stem(w: str) -> str:
    return _strip_suffixes(w, _FI_SUFFIXES) if len(w) > 5 else w


def hungarian_stem(w: str) -> str:
    return _strip_suffixes(w, _HU_SUFFIXES) if len(w) > 4 else w


def turkish_stem(w: str) -> str:
    if len(w) <= 4:
        return w
    # peel at most two agglutinated layers
    w1 = _strip_suffixes(w, _TR_SUFFIXES)
    return _strip_suffixes(w1, _TR_SUFFIXES) if len(w1) > 5 else w1


def polish_stem(w: str) -> str:
    return _strip_suffixes(w, _PL_SUFFIXES) if len(w) > 3 else w


def romanian_stem(w: str) -> str:
    return _strip_suffixes(w, _RO_SUFFIXES) if len(w) > 4 else w


def czech_stem(w: str) -> str:
    return _strip_suffixes(w, _CS_SUFFIXES) if len(w) > 4 else w


#: language → stemmer for TextTokenizer(stemming=True, language=...)
#: (reference: Lucene ships ~30 per-language Snowball analyzers,
#: LuceneTextAnalyzer.scala:203 — 17 light analogs here)
STEMMERS = {"en": porter_stem, "fr": french_stem, "de": german_stem,
            "es": spanish_stem, "it": italian_stem, "pt": portuguese_stem,
            "nl": dutch_stem, "ru": russian_stem,
            "sv": swedish_stem, "no": norwegian_stem, "da": danish_stem,
            "fi": finnish_stem, "hu": hungarian_stem, "tr": turkish_stem,
            "pl": polish_stem, "ro": romanian_stem, "cs": czech_stem}



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
    """Text -> TextList: ``tokenize_text`` of each value; with
    ``stemming`` each token goes through ``STEMMERS[language]`` (a
    language without a stemmer keeps its tokens)."""

    def __init__(self, min_token_length: int = D.MinTokenLength,
                 stemming: bool = False, language: str = "en",
                 uid: Optional[str] = None):
        super().__init__("tokenize", transform_fn=self._tokens,
                         output_type=TextList, input_type=Text, uid=uid)
        self.min_token_length = min_token_length
        self.stemming = stemming
        self.language = language

    def _tokens(self, v):
        toks = tokenize_text(v, self.min_token_length)
        # a model saved before stemming was an option has neither key
        if not getattr(self, "stemming", False):
            return toks
        stem = _stemmer(self.language)
        return toks if stem is None else [stem(t) for t in toks]


@functools.lru_cache(maxsize=None)
def _stemmer(language: str):
    """``STEMMERS[language]`` remembering its last 65,536 words (a corpus
    repeats its words), or None."""
    stem = STEMMERS.get(language)
    return None if stem is None else functools.lru_cache(maxsize=1 << 16)(
        stem)


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

    @staticmethod
    def _block(arr: torch.Tensor) -> torch.Tensor:
        arr = arr.to(torch.float32)
        return arr[:, None] if arr.dim() == 1 else arr

    def device_columnar(self, env):
        return torch.cat([self._block(env[f.name][0])
                          for f in self.input_features], dim=1), None

    def transform_column(self, table: FeatureTable) -> Column:
        blocks, metas = [], []
        for f in self.input_features:
            col = table[f.name]
            arr = self._block(_tensor(table, col.values))
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
