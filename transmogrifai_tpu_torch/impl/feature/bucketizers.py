"""Bucketizers and the percentile calibrator (counterpart of
``transmogrifai_tpu.impl.feature.bucketizers``).

``NumericBucketizer`` one-hots a Real into the buckets of given split
points. ``DecisionTreeNumericBucketizer`` (and its map twin, one tree a
key) takes the splits of a depth-limited single-feature decision tree on
the label: the candidate thresholds are quantiles of the streaming
histogram sketch (``utils.streaming_histogram``, the same sketch the JAX
package compiles), each node keeps the candidate of highest entropy gain.
``PercentileCalibrator`` maps a Real onto 0..buckets-1 by the sketch's
quantiles. As in the JAX package these are host stages (float64 numpy);
a vector block goes to the table's device in one copy.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ...stages.base import (
    AllowLabelAsInput, Estimator, Transformer, UnaryTransformer, _placed,
)
from ...table import Column, FeatureTable
from ...types import OPVector, Real, RealNN
from ...utils.streaming_histogram import StreamingHistogram
from ...vector_metadata import NULL_INDICATOR, VectorColumnMetadata
from .scalers import _host_f64
from .vectorizers import TransmogrifierDefaults, _emit_host


def _bucket_block(vals: np.ndarray, mask: np.ndarray, splits: Sequence[float],
                  track_nulls: bool, track_invalid: bool) -> np.ndarray:
    """One-hot bucket membership. splits = [s0, s1, ..., sk] defines k buckets
    [s0,s1), [s1,s2), ..., [s_{k-1}, sk] (reference NumericBucketizer splits
    semantics, right-inclusive last bucket)."""
    n = vals.shape[0]
    k = len(splits) - 1
    width = k + (1 if track_invalid else 0) + (1 if track_nulls else 0)
    block = np.zeros((n, width), dtype=np.float32)
    idx = np.searchsorted(np.asarray(splits, dtype=np.float64), vals,
                          side="right") - 1
    idx = np.where((vals == splits[-1]), k - 1, idx)
    in_range = (idx >= 0) & (idx < k) & mask
    rows = np.arange(n)
    block[rows[in_range], idx[in_range]] = 1.0
    if track_invalid:
        invalid = mask & ~in_range
        block[invalid, k] = 1.0
    if track_nulls:
        block[~mask, width - 1] = 1.0
    return block


class NumericBucketizer(UnaryTransformer):
    """Real → OPVector: explicit-split one-hot buckets (reference
    NumericBucketizer.scala:303)."""

    output_type = OPVector

    def __init__(self, splits: Sequence[float],
                 bucket_labels: Optional[Sequence[str]] = None,
                 track_nulls: bool = TransmogrifierDefaults.TrackNulls,
                 track_invalid: bool = False, uid=None):
        super().__init__("numericBucketizer", transform_fn=None,
                         output_type=OPVector, input_type=Real, uid=uid)
        if len(splits) < 2 or list(splits) != sorted(splits):
            raise ValueError("splits must be ascending with at least 2 points")
        self.splits = [float(s) for s in splits]
        self.bucket_labels = (list(bucket_labels) if bucket_labels is not None
                              else [f"{a}-{b}" for a, b in
                                    zip(self.splits, self.splits[1:])])
        if len(self.bucket_labels) != len(self.splits) - 1:
            raise ValueError("need one label per bucket")
        self.track_nulls = track_nulls
        self.track_invalid = track_invalid

    def transform_column(self, table: FeatureTable) -> Column:
        f = self.input_features[0]
        col = table[f.name]
        block = _bucket_block(_host_f64(col), col.valid_mask(), self.splits,
                              self.track_nulls, self.track_invalid)
        meta = [VectorColumnMetadata(f.name, f.type_name, f.name, lbl)
                for lbl in self.bucket_labels]
        if self.track_invalid:
            meta.append(VectorColumnMetadata(f.name, f.type_name, f.name,
                                             "OutOfBound"))
        if self.track_nulls:
            meta.append(VectorColumnMetadata(f.name, f.type_name, f.name,
                                             NULL_INDICATOR))
        return _emit_host(self, table, block, meta)



# ---------------------------------------------------------------------------
# Supervised (decision-tree) bucketizer
# ---------------------------------------------------------------------------

def _entropy(counts: np.ndarray) -> float:
    tot = counts.sum()
    if tot == 0:
        return 0.0
    p = counts / tot
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(-(np.where(p > 0, p * np.log2(p), 0.0)).sum())


def decision_tree_splits(x: np.ndarray, y: np.ndarray, max_depth: int,
                         min_info_gain: float, num_candidates: int = 64,
                         min_leaf: int = 10) -> List[float]:
    """Split points of a depth-limited single-feature decision tree.

    Candidate thresholds are streaming-histogram quantiles; each node's best
    threshold maximizes label-entropy gain over a vectorized cumulative-count
    scan (the analog of the reference delegating to Spark's
    DecisionTreeClassifier, DecisionTreeNumericBucketizer.scala:300)."""
    classes, y_idx = np.unique(y, return_inverse=True)
    k = classes.size
    if k < 2 or x.size < 2 * min_leaf:
        return []
    sketch = StreamingHistogram(max(num_candidates * 2, 64)).update(x)
    cands = np.unique(sketch.uniform(num_candidates))
    if cands.size == 0:
        return []

    out: List[float] = []

    def recurse(sel: np.ndarray, depth: int) -> None:
        if depth >= max_depth or sel.sum() < 2 * min_leaf:
            return
        xs, ys = x[sel], y_idx[sel]
        # counts[c, j]: label-c rows at/below candidate j (one pass via digitize)
        bin_idx = np.searchsorted(cands, xs, side="right")  # 0..len(cands)
        counts = np.zeros((k, cands.size + 1), dtype=np.float64)
        np.add.at(counts, (ys, bin_idx), 1.0)
        cum = counts.cumsum(axis=1)[:, :-1]          # ≤ candidate j
        total = counts.sum(axis=1)
        n_tot = total.sum()
        left_n = cum.sum(axis=0)
        right_n = n_tot - left_n
        ok = (left_n >= min_leaf) & (right_n >= min_leaf)
        if not ok.any():
            return
        parent = _entropy(total)

        def ent(c: np.ndarray, n: np.ndarray) -> np.ndarray:
            with np.errstate(divide="ignore", invalid="ignore"):
                p = np.where(n > 0, c / np.maximum(n, 1), 0.0)
                return -(np.where(p > 0, p * np.log2(p), 0.0)).sum(axis=0)

        gain = parent - (left_n / n_tot) * ent(cum, left_n) \
                      - (right_n / n_tot) * ent(total[:, None] - cum, right_n)
        gain = np.where(ok, gain, -np.inf)
        j = int(np.argmax(gain))
        if gain[j] < min_info_gain:
            return
        thr = float(cands[j])
        out.append(thr)
        recurse(sel & (x <= thr), depth + 1)
        recurse(sel & (x > thr), depth + 1)

    recurse(np.ones_like(x, dtype=bool), 0)
    return sorted(out)


class DecisionTreeNumericBucketizer(AllowLabelAsInput, Estimator):
    """(RealNN label, Real) → OPVector supervised buckets (reference
    DecisionTreeNumericBucketizer.scala — buckets only kept if the tree finds
    splits with gain ≥ minInfoGain; otherwise the output shrinks to just the
    null-indicator column)."""

    input_types = (RealNN, Real)
    output_type = OPVector

    def __init__(self, max_depth: int = 2, min_info_gain: float = 0.01,
                 track_nulls: bool = TransmogrifierDefaults.TrackNulls,
                 track_invalid: bool = False, uid=None):
        super().__init__("dtBucketizer", uid)
        self.max_depth = max_depth
        self.min_info_gain = min_info_gain
        self.track_nulls = track_nulls
        self.track_invalid = track_invalid

    def fit(self, table: FeatureTable) -> Transformer:
        label_f, feat_f = self.input_features
        ycol, xcol = table[label_f.name], table[feat_f.name]
        x, y = _host_f64(xcol), _host_f64(ycol)
        m = xcol.valid_mask() & ycol.valid_mask()
        thresholds = decision_tree_splits(
            x[m], y[m], self.max_depth, self.min_info_gain)
        splits = ([-np.inf] + thresholds + [np.inf]) if thresholds else []
        model = DecisionTreeNumericBucketizerModel(
            splits=splits, track_nulls=self.track_nulls,
            track_invalid=self.track_invalid)
        model.summary_metadata = {"splits": thresholds,
                                  "bucketed": bool(thresholds)}
        return self._finalize_model(model)


class DecisionTreeNumericBucketizerModel(Transformer):
    output_type = OPVector

    def __init__(self, splits: List[float], track_nulls: bool,
                 track_invalid: bool, uid=None):
        super().__init__("dtBucketizer", uid)
        self.splits = splits
        self.track_nulls = track_nulls
        self.track_invalid = track_invalid

    def transform_column(self, table: FeatureTable) -> Column:
        _, feat_f = self.input_features
        col = table[feat_f.name]
        vals = _host_f64(col)
        m = col.valid_mask()
        meta: List[VectorColumnMetadata] = []
        if self.splits:
            block = _bucket_block(vals, m, self.splits, self.track_nulls,
                                  self.track_invalid)
            labels = [f"{a}-{b}" for a, b in zip(self.splits, self.splits[1:])]
            meta.extend([VectorColumnMetadata(
                feat_f.name, feat_f.type_name, feat_f.name, lbl)
                for lbl in labels])
            if self.track_invalid:
                meta.append(VectorColumnMetadata(
                    feat_f.name, feat_f.type_name, feat_f.name, "OutOfBound"))
            if self.track_nulls:
                meta.append(VectorColumnMetadata(
                    feat_f.name, feat_f.type_name, feat_f.name, NULL_INDICATOR))
        else:
            block = (~m).astype(np.float32)[:, None]
            meta.append(VectorColumnMetadata(
                feat_f.name, feat_f.type_name, feat_f.name, NULL_INDICATOR))
        return _emit_host(self, table, block, meta)



class DecisionTreeNumericMapBucketizer(AllowLabelAsInput, Estimator):
    """(RealNN label, RealMap) → OPVector: a supervised bucketizer per map key
    (reference DecisionTreeNumericMapBucketizer.scala:170)."""

    output_type = OPVector

    def __init__(self, max_depth: int = 2, min_info_gain: float = 0.01,
                 track_nulls: bool = TransmogrifierDefaults.TrackNulls, uid=None):
        super().__init__("dtMapBucketizer", uid)
        self.max_depth = max_depth
        self.min_info_gain = min_info_gain
        self.track_nulls = track_nulls

    def fit(self, table: FeatureTable) -> Transformer:
        label_f, map_f = self.input_features
        ycol, col = table[label_f.name], table[map_f.name]
        y = _host_f64(ycol)
        valid = col.valid_mask()
        rows = col.host_values()
        n = len(col)
        keys = sorted({str(k) for i in range(n) if valid[i] and rows[i]
                       for k in rows[i]})
        per_key: Dict[str, List[float]] = {}
        for key in keys:
            xs, ys = [], []
            for i in range(n):
                r = rows[i] if valid[i] else None
                v = r.get(key) if r else None
                if v is not None and not (isinstance(v, float) and np.isnan(v)):
                    xs.append(float(v))
                    ys.append(y[i])
            thr = decision_tree_splits(
                np.asarray(xs), np.asarray(ys), self.max_depth,
                self.min_info_gain) if xs else []
            per_key[key] = ([-np.inf] + thr + [np.inf]) if thr else []
        model = DecisionTreeNumericMapBucketizerModel(
            keys=keys, splits=per_key, track_nulls=self.track_nulls)
        model.summary_metadata = {
            "splits": {k: [s for s in v if np.isfinite(s)]
                       for k, v in per_key.items()}}
        return self._finalize_model(model)


class DecisionTreeNumericMapBucketizerModel(Transformer):
    output_type = OPVector

    def __init__(self, keys: List[str], splits: Dict[str, List[float]],
                 track_nulls: bool, uid=None):
        super().__init__("dtMapBucketizer", uid)
        self.keys = keys
        self.splits = splits
        self.track_nulls = track_nulls

    def transform_column(self, table: FeatureTable) -> Column:
        _, map_f = self.input_features
        col = table[map_f.name]
        valid = col.valid_mask()
        rows = col.host_values()
        n = len(col)
        blocks, meta = [], []
        for key in self.keys:
            vals = np.zeros(n, dtype=np.float64)
            m = np.zeros(n, dtype=bool)
            for i in range(n):
                r = rows[i] if valid[i] else None
                v = r.get(key) if r else None
                if v is not None and not (isinstance(v, float) and np.isnan(v)):
                    vals[i] = float(v)
                    m[i] = True
            splits = self.splits.get(key, [])
            if splits:
                blocks.append(_bucket_block(vals, m, splits,
                                            self.track_nulls, False))
                labels = [f"{a}-{b}" for a, b in zip(splits, splits[1:])]
                meta.extend([VectorColumnMetadata(
                    map_f.name, map_f.type_name, key, lbl) for lbl in labels])
                if self.track_nulls:
                    meta.append(VectorColumnMetadata(
                        map_f.name, map_f.type_name, key, NULL_INDICATOR))
            else:
                blocks.append((~m).astype(np.float32)[:, None])
                meta.append(VectorColumnMetadata(
                    map_f.name, map_f.type_name, key, NULL_INDICATOR))
        mat = (np.concatenate(blocks, axis=1) if blocks
               else np.zeros((n, 0), dtype=np.float32))
        return _emit_host(self, table, mat, meta)


class PercentileCalibrator(Estimator):
    """Real → RealNN percentile score in [0, buckets-1] (reference
    PercentileCalibrator.scala:131 — QuantileDiscretizer-backed; here the
    quantile boundaries come from the native streaming-histogram sketch)."""

    input_types = (Real,)
    output_type = RealNN

    def __init__(self, buckets: int = 100, uid=None):
        super().__init__("percentileCalibrator", uid)
        self.buckets = buckets

    def fit(self, table: FeatureTable) -> Transformer:
        f = self.input_features[0]
        col = table[f.name]
        vals = _host_f64(col)
        m = col.valid_mask()
        sketch = StreamingHistogram(max(2 * self.buckets, 64)).update(vals[m])
        bounds = np.unique(sketch.uniform(self.buckets))
        model = PercentileCalibratorModel(
            boundaries=bounds.tolist(), buckets=self.buckets)
        model.summary_metadata = {"boundaries": bounds.tolist()}
        return self._finalize_model(model)


class PercentileCalibratorModel(Transformer):
    output_type = RealNN

    def __init__(self, boundaries: List[float], buckets: int, uid=None):
        super().__init__("percentileCalibrator", uid)
        self.boundaries = boundaries
        self.buckets = buckets

    def transform_column(self, table: FeatureTable) -> Column:
        f = self.input_features[0]
        col = table[f.name]
        m = col.valid_mask()
        scaled = self._scale(_host_f64(col))
        scaled[~m] = 0.0
        return _placed(table, Column(RealNN, scaled.astype(np.float32),
                                     None))

    def _scale(self, vals: np.ndarray) -> np.ndarray:
        if not self.boundaries:
            return np.zeros_like(vals)
        idx = np.searchsorted(np.asarray(self.boundaries), vals, side="right")
        # map bucket index onto 0..buckets-1 even when boundaries collapsed
        k = len(self.boundaries) + 1
        return np.floor(idx * (self.buckets - 1) / max(k - 1, 1)).astype(np.float64)

    def transform_row(self, row: Dict[str, Any]) -> Any:
        v = row.get(self.input_features[0].name)
        if v is None:
            return 0.0
        return float(self._scale(np.array([float(v)]))[0])
