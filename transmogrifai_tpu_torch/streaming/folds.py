"""Monoid folds (counterpart of ``transmogrifai_tpu.streaming.folds``):
accumulate / merge / finalize over chunked data.

Every fold exposes

* ``zero()``            — the identity state,
* ``accumulate(s, x)``  — fold one chunk's arrays into the state,
* ``merge(a, b)``       — combine two states (addition everywhere),
* ``finalize(s)``       — the statistic the in-core fit computes,
* ``state_to_arrays`` / ``state_from_arrays`` — the state as plain numpy
  arrays, so a kill mid-pass resumes bit-exactly from the last committed
  chunk (``checkpoint``).

The accumulators are float64 numpy on the host, as in the JAX package,
over the float32 arrays the chunks hold: the partial sums merge closely
enough that the float32 results agree across chunk schedules, and the
counts (column counts, contingency cells, nonzeros) are exact integers.
They stay numpy on purpose: a torch reduction adds in another order.
"""
from __future__ import annotations

import abc
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..utils.streaming_histogram import StreamingHistogram


class MonoidFold(abc.ABC):
    """The accumulate/merge/finalize contract (one fold = one pass)."""

    @abc.abstractmethod
    def zero(self) -> Any:
        ...

    @abc.abstractmethod
    def accumulate(self, state: Any, *chunk_args) -> Any:
        ...

    @abc.abstractmethod
    def merge(self, a: Any, b: Any) -> Any:
        ...

    @abc.abstractmethod
    def finalize(self, state: Any) -> Any:
        ...

    # -- checkpointing: state <-> flat dict of numpy arrays ------------------
    def state_to_arrays(self, state: Any) -> Dict[str, np.ndarray]:
        return {k: np.asarray(v) for k, v in state.items()}

    def state_from_arrays(self, arrays: Dict[str, np.ndarray]) -> Any:
        return dict(arrays)


class StreamedColStats(NamedTuple):
    """Finalized per-column moments, matching ``ops.stats.ColStats``."""
    count: np.ndarray
    mean: np.ndarray
    variance: np.ndarray
    min: np.ndarray
    max: np.ndarray
    num_nonzeros: np.ndarray


class ColStatsFold(MonoidFold):
    """Masked per-column count/mean/var/min/max/nnz over (n, d) chunks: the
    streaming dual of ``ops.stats.col_stats`` (the SanityChecker's moments
    and the mean fills)."""

    def __init__(self, d: int):
        self.d = int(d)

    def zero(self) -> Dict[str, np.ndarray]:
        d = self.d
        return {
            "n": np.zeros(d, np.int64),
            "s1": np.zeros(d, np.float64),
            "s2": np.zeros(d, np.float64),
            "min": np.full(d, np.inf),
            "max": np.full(d, -np.inf),
            "nnz": np.zeros(d, np.int64),
        }

    def accumulate(self, state, X: np.ndarray,
                   mask: Optional[np.ndarray] = None):
        X = np.asarray(X, dtype=np.float64)
        if X.ndim == 1:
            X = X[:, None]
        if mask is None:
            m = np.ones(X.shape, dtype=bool)
        else:
            m = np.asarray(mask, dtype=bool)
            if m.ndim == 1:
                m = m[:, None] & np.ones(X.shape, dtype=bool)
        Xv = np.where(m, X, 0.0)
        state["n"] = state["n"] + m.sum(axis=0)
        state["s1"] = state["s1"] + Xv.sum(axis=0)
        state["s2"] = state["s2"] + (Xv * Xv).sum(axis=0)
        state["min"] = np.minimum(state["min"],
                                  np.where(m, X, np.inf).min(axis=0))
        state["max"] = np.maximum(state["max"],
                                  np.where(m, X, -np.inf).max(axis=0))
        state["nnz"] = state["nnz"] + ((Xv != 0) & m).sum(axis=0)
        return state

    def merge(self, a, b):
        return {
            "n": a["n"] + b["n"], "s1": a["s1"] + b["s1"],
            "s2": a["s2"] + b["s2"],
            "min": np.minimum(a["min"], b["min"]),
            "max": np.maximum(a["max"], b["max"]),
            "nnz": a["nnz"] + b["nnz"],
        }

    def finalize(self, state) -> StreamedColStats:
        n = state["n"].astype(np.float64)
        safe = np.maximum(n, 1.0)
        mean = state["s1"] / safe
        # unbiased (n-1), matching Spark colStats / ops.stats.col_stats
        var = np.maximum(state["s2"] - n * mean * mean, 0.0) \
            / np.maximum(n - 1.0, 1.0)
        return StreamedColStats(
            count=n, mean=mean, variance=var,
            min=np.where(n > 0, state["min"], 0.0),
            max=np.where(n > 0, state["max"], 0.0),
            num_nonzeros=state["nnz"].astype(np.float64))


class CorrelationFold(MonoidFold):
    """Masked Pearson correlation of each column of X against y via exact
    co-moment sums (the streaming dual of ``ops.stats.pearson_correlation``;
    ``full=True`` also accumulates the (d, d) feature co-moment block for
    the full correlation matrix)."""

    def __init__(self, d: int, full: bool = False):
        self.d = int(d)
        self.full = bool(full)

    def zero(self):
        d = self.d
        st = {
            "n": np.zeros((), np.int64),
            "sx": np.zeros(d, np.float64), "sy": np.zeros((), np.float64),
            "sxx": np.zeros(d, np.float64), "syy": np.zeros((), np.float64),
            "sxy": np.zeros(d, np.float64),
        }
        if self.full:
            st["xtx"] = np.zeros((d, d), np.float64)
        return st

    def accumulate(self, state, X: np.ndarray, y: np.ndarray,
                   mask: Optional[np.ndarray] = None):
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64).reshape(-1)
        if mask is not None:
            m = np.asarray(mask, dtype=bool)
            X = np.where(m[:, None], X, 0.0)
            y = np.where(m, y, 0.0)
            state["n"] = state["n"] + m.sum()
        else:
            state["n"] = state["n"] + X.shape[0]
        state["sx"] = state["sx"] + X.sum(axis=0)
        state["sy"] = state["sy"] + y.sum()
        state["sxx"] = state["sxx"] + (X * X).sum(axis=0)
        state["syy"] = state["syy"] + (y * y).sum()
        state["sxy"] = state["sxy"] + (X * y[:, None]).sum(axis=0)
        if self.full:
            state["xtx"] = state["xtx"] + X.T @ X
        return state

    def merge(self, a, b):
        return {k: a[k] + b[k] for k in a}

    def finalize(self, state) -> np.ndarray:
        n = max(float(state["n"]), 1.0)
        cov = state["sxy"] - state["sx"] * state["sy"] / n
        xvar = state["sxx"] - state["sx"] ** 2 / n
        yvar = state["syy"] - state["sy"] ** 2 / n
        denom = np.sqrt(np.maximum(xvar, 0.0) * max(yvar, 0.0))
        with np.errstate(invalid="ignore"):
            return np.where(denom > 0, cov / np.maximum(denom, 1e-30), np.nan)

    def finalize_matrix(self, state) -> np.ndarray:
        """(d, d) feature-feature correlations (``full=True`` states)."""
        n = max(float(state["n"]), 1.0)
        cov = state["xtx"] - np.outer(state["sx"], state["sx"]) / n
        std = np.sqrt(np.maximum(np.diag(cov), 0.0))
        denom = np.outer(std, std)
        with np.errstate(invalid="ignore"):
            return np.where(denom > 0, cov / np.maximum(denom, 1e-30), np.nan)


class ContingencyFold(MonoidFold):
    """(k, L) contingency counts of 0/1 indicator columns against an
    integer-ish label — exact int64 sums, so the fold is bit-equal to
    ``ops.stats.contingency_table`` under any chunk schedule. Labels are
    discovered as they stream; a label set that grows past ``max_labels``
    (or goes non-integer) flips the state invalid, matching the in-core
    checker's "not binary-like → skip contingency" branch."""

    def __init__(self, k: int, max_labels: int = 20):
        self.k = int(k)
        self.max_labels = int(max_labels)

    def zero(self):
        return {"labels": np.zeros(0, np.int64),
                "counts": np.zeros((0, self.k), np.int64),
                "invalid": np.zeros((), np.int64)}

    def accumulate(self, state, indicators: np.ndarray, y: np.ndarray,
                   mask: Optional[np.ndarray] = None):
        if int(state["invalid"]):
            return state
        ind = np.asarray(indicators, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64).reshape(-1)
        valid = np.isfinite(y)
        if mask is not None:
            valid &= np.asarray(mask, dtype=bool)
        yv = y[valid]
        if yv.size and not np.allclose(yv, np.round(yv)):
            state["invalid"] = np.ones((), np.int64)
            return state
        labels = state["labels"]
        counts = state["counts"]
        for lab in np.unique(yv).astype(np.int64):
            rows = valid & (y == lab)
            row_counts = np.round(ind[rows].sum(axis=0)).astype(np.int64)
            at = np.searchsorted(labels, lab)
            if at == labels.size or labels[at] != lab:
                labels = np.insert(labels, at, lab)
                counts = np.insert(counts, at, 0, axis=0)
            counts[at] += row_counts
        if labels.size > self.max_labels:
            state["invalid"] = np.ones((), np.int64)
            return state
        state["labels"], state["counts"] = labels, counts
        return state

    def merge(self, a, b):
        if int(a["invalid"]) or int(b["invalid"]):
            return {"labels": np.zeros(0, np.int64),
                    "counts": np.zeros((0, self.k), np.int64),
                    "invalid": np.ones((), np.int64)}
        labels = np.union1d(a["labels"], b["labels"])
        counts = np.zeros((labels.size, self.k), np.int64)
        for src in (a, b):
            idx = np.searchsorted(labels, src["labels"])
            counts[idx] += src["counts"]
        if labels.size > self.max_labels:
            return {"labels": np.zeros(0, np.int64),
                    "counts": np.zeros((0, self.k), np.int64),
                    "invalid": np.ones((), np.int64)}
        return {"labels": labels, "counts": counts,
                "invalid": np.zeros((), np.int64)}

    def finalize(self, state) -> Optional[np.ndarray]:
        """(k, L) table with L = max label + 1 (dense, like the in-core
        one-hot matmul); None when labels were not binary-like."""
        if int(state["invalid"]) or state["labels"].size == 0:
            return None
        labels = state["labels"]
        if labels.min() < 0:
            return None
        L = int(labels.max()) + 1
        if L > self.max_labels:
            return None
        out = np.zeros((self.k, L), np.int64)
        for i, lab in enumerate(labels.tolist()):
            out[:, lab] = state["counts"][i]
        return out


class HistogramFold(MonoidFold):
    """Per-column SPDT sketches (the Ben-Haim & Tom-Tov monoid,
    ``utils.streaming_histogram``). The state keeps the raw multiset of
    per-chunk bins and compacts only through the canonical
    ``StreamingHistogram.merged`` (at a bounded spill cap and at finalize),
    so results do not depend on the merge grouping (the streamed trees'
    quantile edges). With ``sample_stride`` only every stride-th row by
    global index is sketched."""

    #: spill cap: compact the multiset when it exceeds this many bins/col
    SPILL_FACTOR = 32

    def __init__(self, d: int, max_bins: int = 64, sample_stride: int = 1):
        self.d = int(d)
        self.max_bins = int(max_bins)
        self.sample_stride = max(1, int(sample_stride))

    def zero(self):
        st = {"nulls": np.zeros(self.d, np.int64),
              "rows": np.zeros((), np.int64)}
        for j in range(self.d):
            st[f"c{j}"] = np.zeros(0, np.float64)
            st[f"m{j}"] = np.zeros(0, np.float64)
            st[f"r{j}"] = np.array([np.inf, -np.inf])
        return st

    def accumulate(self, state, X: np.ndarray,
                   mask: Optional[np.ndarray] = None,
                   row_offset: int = 0):
        X = np.asarray(X, dtype=np.float64)
        if X.ndim == 1:
            X = X[:, None]
        n = X.shape[0]
        if mask is None:
            m = np.ones(X.shape, dtype=bool)
        else:
            m = np.asarray(mask, dtype=bool)
            if m.ndim == 1:
                m = m[:, None] & np.ones(X.shape, dtype=bool)
        state["rows"] = state["rows"] + n
        state["nulls"] = state["nulls"] + (~m).sum(axis=0)
        take = (np.arange(row_offset, row_offset + n)
                % self.sample_stride) == 0
        for j in range(self.d):
            vals = X[take & m[:, j], j] if self.sample_stride > 1 \
                else X[m[:, j], j]
            if not vals.size:
                continue
            h = StreamingHistogram(self.max_bins).update(vals)
            st = h.to_state()
            state[f"c{j}"] = np.concatenate([state[f"c{j}"], st["centers"]])
            state[f"m{j}"] = np.concatenate([state[f"m{j}"], st["masses"]])
            state[f"r{j}"] = np.array([min(state[f"r{j}"][0], h.min),
                                       max(state[f"r{j}"][1], h.max)])
            if state[f"c{j}"].size > self.max_bins * self.SPILL_FACTOR:
                self._compact(state, j)
        return state

    def _hist_of(self, state, j) -> StreamingHistogram:
        """The raw bin-multiset carrier for column ``j``. INTERNAL: the
        state concatenates one sorted run per accumulated chunk, so the
        bins are NOT globally sorted — only ``StreamingHistogram.merged``
        (which lexsorts + coalesces) may consume this; ``sum``/``density``
        on it would silently interpolate garbage."""
        return StreamingHistogram.from_state({
            "max_bins": max(self.max_bins, state[f"c{j}"].size),
            "centers": state[f"c{j}"], "masses": state[f"m{j}"],
            "total": state[f"m{j}"].sum(),
            "min": state[f"r{j}"][0], "max": state[f"r{j}"][1]})

    def column_histogram(self, state, j: int) -> StreamingHistogram:
        """Column ``j``'s canonical sketch (at most ``max_bins`` bins)."""
        return StreamingHistogram.merged([self._hist_of(state, j)],
                                         max_bins=self.max_bins)

    def _compact(self, state, j) -> None:
        h = StreamingHistogram.merged([self._hist_of(state, j)],
                                      max_bins=self.max_bins)
        st = h.to_state()
        state[f"c{j}"], state[f"m{j}"] = st["centers"], st["masses"]

    def merge(self, a, b):
        out = {"nulls": a["nulls"] + b["nulls"], "rows": a["rows"] + b["rows"]}
        for j in range(self.d):
            out[f"c{j}"] = np.concatenate([a[f"c{j}"], b[f"c{j}"]])
            out[f"m{j}"] = np.concatenate([a[f"m{j}"], b[f"m{j}"]])
            out[f"r{j}"] = np.array([min(a[f"r{j}"][0], b[f"r{j}"][0]),
                                     max(a[f"r{j}"][1], b[f"r{j}"][1])])
        return out

    def finalize(self, state) -> List[StreamingHistogram]:
        """One canonical sketch per column (≤ max_bins bins each)."""
        return [self.column_histogram(state, j) for j in range(self.d)]

    def fill_rates(self, state) -> np.ndarray:
        """Per-column fill fraction."""
        rows = max(float(state["rows"]), 1.0)
        return 1.0 - state["nulls"].astype(np.float64) / rows


class CompositeFold(MonoidFold):
    """Several folds over the same pass, one shared chunk extraction.
    ``accumulate`` takes ``{name: chunk_args_tuple}``."""

    def __init__(self, folds: Dict[str, MonoidFold]):
        self.folds = dict(folds)

    def zero(self):
        return {k: f.zero() for k, f in self.folds.items()}

    def accumulate(self, state, parts: Dict[str, Tuple]):
        for k, f in self.folds.items():
            if k in parts:
                state[k] = f.accumulate(state[k], *parts[k])
        return state

    def merge(self, a, b):
        return {k: f.merge(a[k], b[k]) for k, f in self.folds.items()}

    def finalize(self, state):
        return {k: f.finalize(state[k]) for k, f in self.folds.items()}

    def state_to_arrays(self, state):
        out: Dict[str, np.ndarray] = {}
        for k, f in self.folds.items():
            for kk, v in f.state_to_arrays(state[k]).items():
                out[f"{k}.{kk}"] = v
        return out

    def state_from_arrays(self, arrays):
        split: Dict[str, Dict[str, np.ndarray]] = {k: {} for k in self.folds}
        for kk, v in arrays.items():
            name, sub = kk.split(".", 1)
            split[name][sub] = v
        return {k: f.state_from_arrays(split[k])
                for k, f in self.folds.items()}


class ArraySumFold(MonoidFold):
    """Plain float64 array addition under fixed keys: the streamed trees'
    level stats (per node x feature x bin count, sum and sum of
    squares)."""

    def __init__(self, shapes: Dict[str, Tuple[int, ...]]):
        self.shapes = dict(shapes)

    def zero(self):
        return {k: np.zeros(s, np.float64) for k, s in self.shapes.items()}

    def accumulate(self, state, parts: Dict[str, np.ndarray]):
        for k, v in parts.items():
            state[k] = state[k] + v
        return state

    def merge(self, a, b):
        return {k: a[k] + b[k] for k in self.shapes}

    def finalize(self, state):
        return state
