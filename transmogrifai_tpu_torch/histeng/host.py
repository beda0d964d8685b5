"""Host (numpy) histogram backend (counterpart of
``transmogrifai_tpu.histeng.host``): StreamingGBT's per-level stat pass.

One flat (node, feature, bin) index per cell, then one ``np.bincount`` per
statistic, in float64. The bits are a contract: the flat index is built
feature-major (d, n) and ravelled in that order, so every weighted
bincount adds its partial sums in the JAX package's sequence. It stays
numpy on purpose: a float32 device histogram (``node_hist``) would change
split choices.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def bin_codes_host(X: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Feature-major (d, n) int64 bin codes for host histogram builds.

    ``edges``: (d, nb-1) split thresholds (np.inf pads unused slots).
    Rows are compared in f64 — bit-consistent with the f64 thresholds the
    streamed descent routes by. Codes lie in [0, nb-1]; the matrix is kept
    feature-major because the host build's bincount traversal order (and
    therefore its f64 sums, bit for bit) depends on it.
    """
    d = edges.shape[0]
    Xt = np.ascontiguousarray(X.T, dtype=np.float64)
    codes = np.empty((d, Xt.shape[1]), dtype=np.int64)
    for j in range(d):
        codes[j] = np.searchsorted(edges[j], Xt[j], side="left")
    return codes


def build_node_hist_host(codes: np.ndarray, node: np.ndarray,
                         stats: Sequence[Optional[np.ndarray]],
                         n_bins: int, n_nodes: int) -> np.ndarray:
    """(k, n_nodes, d, n_bins) f64 sufficient statistics on host.

    ``codes``: (d, n) int64 from `bin_codes_host`; ``node``: (n,) int64
    current node per row; ``stats``: k entries, each ``None`` (unweighted
    count) or an (n,) f64 weight vector (residuals, squared residuals, …).
    One flat index for every (node, feature, bin) cell, then k bincounts
    total — the column-strided per-feature variant costs ~2× (cache-hostile
    reads and k·d small bincounts).
    """
    d, n = codes.shape
    flat = np.empty((d, n), dtype=np.int64)
    base = node * (d * n_bins)
    for j in range(d):
        np.add(base, j * n_bins + codes[j], out=flat[j])
    size = n_nodes * d * n_bins
    fl = flat.ravel()
    shape = (n_nodes, d, n_bins)
    out = np.empty((len(stats),) + shape, dtype=np.float64)
    for i, w in enumerate(stats):
        if w is None:
            out[i] = (np.bincount(fl, minlength=size)
                      .astype(np.float64).reshape(shape))
        else:
            out[i] = np.bincount(fl, weights=np.tile(w, d),
                                 minlength=size).reshape(shape)
    return out


def node_stat_sums(node: np.ndarray,
                   stats: Sequence[Optional[np.ndarray]],
                   n_nodes: int) -> list:
    """Per-node f64 sums without the feature/bin axes — the leaf-value
    pass (n_bins=1, d=1 degenerate histogram). Same ``stats`` convention
    as `build_node_hist_host`: ``None`` → unweighted count."""
    return [np.bincount(node, minlength=n_nodes).astype(np.float64)
            if w is None
            else np.bincount(node, weights=w, minlength=n_nodes)
            for w in stats]
