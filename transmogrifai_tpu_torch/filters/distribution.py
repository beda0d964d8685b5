"""Feature distributions for the raw feature filter (counterpart of
``transmogrifai_tpu.filters.distribution``).

A numeric column streams through the native SPDT sketch
(``utils.streaming_histogram``) on the host and is binned over edges
shared with the scoring file; a text-like column hashes each token into
``text_bins`` bins with ``zlib.crc32``. JS divergences and fill rates are
float64 on the host, by the JAX package's formulas.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..table import Column
from ..utils.streaming_histogram import StreamingHistogram

#: numeric column kinds sketched with the streaming histogram
_NUMERIC_KINDS = frozenset({"real", "binary", "integral", "date"})


def js_divergence(p, q, bins: int = 100) -> float:
    """Jensen-Shannon divergence in [0, 1] (log base 2) of two mass arrays
    over the same bins, or of two sketches binned over their joint
    range."""
    if isinstance(p, StreamingHistogram) or isinstance(q, StreamingHistogram):
        if not (isinstance(p, StreamingHistogram)
                and isinstance(q, StreamingHistogram)):
            raise TypeError("js_divergence needs two sketches or two arrays, "
                            f"got {type(p).__name__} vs {type(q).__name__}")
        edges = sketch_bin_edges(p, q, bins)
        if edges is None:
            return 0.0
        p, q = p.density(edges), q.density(edges)
    p, q = np.asarray(p, float), np.asarray(q, float)
    if p.size == 0 or q.size == 0 or p.size != q.size:
        return 0.0
    ps, qs = p.sum(), q.sum()
    if ps == 0 or qs == 0:
        return 0.0
    p, q = p / ps, q / qs
    m = (p + q) / 2.0
    with np.errstate(divide="ignore", invalid="ignore"):
        kl_pm = np.where(p > 0, p * np.log2(p / m), 0.0).sum()
        kl_qm = np.where(q > 0, q * np.log2(q / m), 0.0).sum()
    return float((kl_pm + kl_qm) / 2.0)


def _edges(lo: float, hi: float, bins: int) -> Optional[np.ndarray]:
    """``bins`` equal bins over [lo, hi], the outer two open-ended (edges
    one unit beyond the range); None without a finite range."""
    if not np.isfinite(lo) or not np.isfinite(hi):
        return None
    if hi <= lo:
        hi = lo + 1.0
    edges = np.linspace(lo, hi, bins + 1)
    return np.concatenate([[lo - 1.0], edges[1:-1], [hi + 1.0]])


def sketch_bin_edges(a: StreamingHistogram, b: StreamingHistogram,
                     bins: int) -> Optional[np.ndarray]:
    """Bin edges over two sketches' joint [min, max]."""
    return _edges(min(a.min, b.min), max(a.max, b.max), bins)


@dataclass
class Summary:
    """A feature's value summary."""
    min: float = np.inf
    max: float = -np.inf
    sum: float = 0.0
    count: float = 0.0

    @staticmethod
    def of(values: np.ndarray) -> "Summary":
        if values.size == 0:
            return Summary()
        return Summary(float(np.min(values)), float(np.max(values)),
                       float(np.sum(values)), float(values.size))


def _hash_bin(token: str, bins: int) -> int:
    """A token's text bin: crc32 of its UTF-8 bytes (stable across
    processes), modulo ``bins``."""
    return zlib.crc32(token.encode("utf-8", "ignore")) % bins


@dataclass
class FeatureDistribution:
    """The binned distribution of one feature (or one map key): a numeric
    feature's ``sketch`` and its mass over shared edges, or a text-like
    feature's hash-bin counts."""
    name: str
    key: Optional[str] = None
    count: float = 0.0
    nulls: float = 0.0
    distribution: np.ndarray = field(default_factory=lambda: np.zeros(0))
    summary: Summary = field(default_factory=Summary)
    is_numeric: bool = True
    sketch: Optional[StreamingHistogram] = None

    @property
    def full_name(self) -> str:
        return self.name if self.key is None else f"{self.name}[{self.key}]"

    def fill_fraction(self) -> float:
        return 0.0 if self.count == 0 else 1.0 - self.nulls / self.count

    def relative_fill_delta(self, other: "FeatureDistribution") -> float:
        return abs(self.fill_fraction() - other.fill_fraction())

    def relative_fill_ratio(self, other: "FeatureDistribution") -> float:
        a, b = self.fill_fraction(), other.fill_fraction()
        lo, hi = min(a, b), max(a, b)
        return np.inf if lo == 0 else hi / lo

    def js_divergence(self, other: "FeatureDistribution") -> float:
        return js_divergence(self.distribution, other.distribution)

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "key": self.key, "count": self.count,
                "nulls": self.nulls, "fillFraction": self.fill_fraction(),
                "distribution": np.asarray(self.distribution).tolist(),
                "min": self.summary.min, "max": self.summary.max}


def numeric_distribution(name: str, values: np.ndarray, valid: np.ndarray,
                         max_bins: int, key: Optional[str] = None
                         ) -> FeatureDistribution:
    """One numeric column's distribution: its valid values through one
    sketch, then the canonical merge of that sketch's bins (the JAX
    package's one-chunk ``HistogramFold``)."""
    vals = np.asarray(values, np.float64).reshape(-1)
    valid = np.asarray(valid, bool).reshape(-1)
    n = float(vals.shape[0])
    nulls = float(int((~valid).sum()))
    centers = masses = np.zeros(0, np.float64)
    lo, hi = np.inf, -np.inf
    picked = vals[valid]
    if picked.size:
        chunk = StreamingHistogram(max_bins).update(picked).to_state()
        centers, masses = chunk["centers"], chunk["masses"]
        lo, hi = min(lo, float(chunk["min"])), max(hi, float(chunk["max"]))
    sketch = StreamingHistogram.merged([StreamingHistogram.from_state({
        "max_bins": max(max_bins, centers.size), "centers": centers,
        "masses": masses, "total": masses.sum(), "min": lo, "max": hi})],
        max_bins=max_bins)
    filled = n - nulls
    mn = sketch.min if filled else np.inf
    mx = sketch.max if filled else -np.inf
    # the sum from bin centroids: SPDT merges keep the mass-weighted mean
    val_sum = float(sum(p * m for p, m in sketch.bins())) if filled else 0.0
    return FeatureDistribution(
        name=name, key=key, count=n, nulls=nulls,
        summary=Summary(mn, mx, val_sum, sketch.total), is_numeric=True,
        sketch=sketch)


def text_distribution(name: str,
                      tokens_per_row: Sequence[Optional[Sequence[str]]],
                      text_bins: int, key: Optional[str] = None
                      ) -> FeatureDistribution:
    """Hash-bin counts of every token; a row of None is null."""
    counts = np.zeros(text_bins, np.float64)
    nulls = 0
    card = 0.0
    for toks in tokens_per_row:
        if toks is None:
            nulls += 1
            continue
        for t in toks:
            counts[_hash_bin(str(t), text_bins)] += 1.0
            card += 1.0
    return FeatureDistribution(
        name=name, key=key, count=float(len(tokens_per_row)),
        nulls=float(nulls), distribution=counts,
        summary=Summary(0.0, float(text_bins), card, card), is_numeric=False)


def numeric_bin_edges(train: FeatureDistribution,
                      score: Optional[FeatureDistribution],
                      max_bins: int) -> Optional[np.ndarray]:
    """Bin edges shared by the train and score summaries, or None when the
    feature has no finite range."""
    lo, hi = train.summary.min, train.summary.max
    if score is not None and score.summary.count:
        lo, hi = min(lo, score.summary.min), max(hi, score.summary.max)
    return _edges(lo, hi, max_bins)


def fill_numeric_bins(train: FeatureDistribution,
                      score: Optional[FeatureDistribution],
                      max_bins: int) -> None:
    """Bin both distributions over shared edges by each sketch's
    interpolated density."""
    edges = numeric_bin_edges(train, score, max_bins)
    if edges is None:
        return
    for dist in (train, score):
        if dist is not None and dist.sketch is not None:
            dist.distribution = dist.sketch.density(edges)


def compare_distributions(train: FeatureDistribution,
                          score: FeatureDistribution,
                          bins: int) -> Dict[str, float]:
    """Train-vs-score metrics: fill rates, their delta and ratio, and the
    JS divergence (numeric distributions binned over shared edges
    first)."""
    if train.is_numeric:
        fill_numeric_bins(train, score, bins)
    return {"trainFill": train.fill_fraction(),
            "scoreFill": score.fill_fraction(),
            "fillDelta": train.relative_fill_delta(score),
            "fillRatio": float(train.relative_fill_ratio(score)),
            "jsDivergence": train.js_divergence(score)}


def column_distributions(name: str, col: Column, max_bins: int,
                         text_bins: int) -> List[FeatureDistribution]:
    """The distribution(s) of one raw host column; a map gives one per
    key."""
    valid = col.valid_mask()
    vals = col.host_values()
    if col.kind in _NUMERIC_KINDS:
        return [numeric_distribution(name, np.asarray(vals, np.float64),
                                     valid, max_bins)]
    if col.kind == "map":
        by_key: Dict[str, List[Tuple[int, Any]]] = {}
        n = len(col)
        for i in range(n):
            if not valid[i] or vals[i] is None:
                continue
            for k, v in vals[i].items():
                by_key.setdefault(str(k), []).append((i, v))
        out: List[FeatureDistribution] = []
        for k, pairs in sorted(by_key.items()):
            sample = next((v for _, v in pairs if v is not None), None)
            if isinstance(sample, (int, float, bool, np.floating,
                                   np.integer)):
                kv = np.zeros(n, np.float64)
                km = np.zeros(n, bool)
                for i, v in pairs:
                    if v is not None:
                        try:
                            kv[i] = float(v)
                            km[i] = True
                        except (TypeError, ValueError):
                            pass
                out.append(numeric_distribution(name, kv, km, max_bins,
                                                key=k))
            else:
                toks: List[Optional[List[str]]] = [None] * n
                for i, v in pairs:
                    if v is not None:
                        toks[i] = [str(v)]
                out.append(text_distribution(name, toks, text_bins, key=k))
        return out
    toks = []
    for i in range(len(col)):
        if not valid[i] or vals[i] is None:
            toks.append(None)
        elif isinstance(vals[i], (list, tuple, set)):
            toks.append([str(x) for x in vals[i]])
        else:
            toks.append([str(vals[i])])
    return [text_distribution(name, toks, text_bins)]
