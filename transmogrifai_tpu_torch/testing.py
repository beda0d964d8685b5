"""Seeded inputs for the tests and ``chip_smoke.py``: random forests for
holding the descent kernels to their plain versions, the descent, the
leaf sums and the one-hot histogram by their definitions, and the serve
bench's pinned models, training frame and workflow.
Everything random is numpy, so the same seed gives the same inputs to the
JAX package and to the port."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

#: the serve bench's pinned winners, as the committed ``serve64`` fixtures
#: were trained: {fixture key: (family, hyperparameters)}
SERVE_MODELS = {
    "rf": ("OpRandomForestClassifier",
           {"maxDepth": 12, "numTrees": 50, "minInstancesPerNode": 10,
            "minInfoGain": 0.001, "subsamplingRate": 1.0}),
    "gbt": ("OpGBTClassifier",
            {"maxDepth": 6, "maxIter": 20, "stepSize": 0.1,
             "minInstancesPerNode": 10, "minInfoGain": 0.001}),
    "dt": ("OpDecisionTreeClassifier",
           {"maxDepth": 6, "minInstancesPerNode": 10, "minInfoGain": 0.001}),
    "gbt12": ("OpGBTClassifier",
              {"maxDepth": 12, "maxIter": 20, "stepSize": 0.1,
               "minInstancesPerNode": 10, "minInfoGain": 0.001}),
}


def random_heap(rng: np.random.RandomState, n: int, d: int, T: int,
                depth: int, k: int, n_bins: int,
                stop: float = 0.2) -> Dict[str, np.ndarray]:
    """codes (n, d), feat/bins (T, 2^depth - 1), leaf (T, 2^depth, k) in
    [0, 1) like a forest's class shares; a ``stop`` share of the nodes
    carries the sentinel bin ``n_bins``."""
    H = 2 ** depth - 1
    bins = rng.randint(0, n_bins - 1, (T, H))
    bins = np.where(rng.rand(T, H) < stop, n_bins, bins)
    return {
        "codes": rng.randint(0, n_bins, (n, d)).astype(np.int32),
        "feat": rng.randint(0, d, (T, H)).astype(np.int32),
        "bins": bins.astype(np.int32),
        "leaf": rng.rand(T, 2 ** depth, k).astype(np.float32),
    }


def random_chain(rng: np.random.RandomState, n: int, d: int, T: int,
                 depth: int, W: int, k: int, n_bins: int,
                 stop: float = 0.3) -> Dict[str, np.ndarray]:
    """codes (n, d), feat/bins/base (T, depth, W), leaf (T, min(2^depth, W),
    k) in [0, 1): a consistent slot chain (every base points inside the
    next level) with a ``stop`` share of finished slots (sentinel bin)."""
    feat = rng.randint(0, d, (T, depth, W)).astype(np.int32)
    bins = rng.randint(0, n_bins - 1, (T, depth, W)).astype(np.int32)
    base = np.zeros((T, depth, W), np.int32)
    for lv in range(depth):
        Wl = min(2 ** lv, W)
        Wn = min(2 ** (lv + 1), W)
        base[:, lv, :Wl] = rng.randint(0, max(Wn - 1, 1), (T, Wl))
        done = rng.rand(T, Wl) < stop
        bins[:, lv, :Wl] = np.where(done, n_bins, bins[:, lv, :Wl])
    return {
        "codes": rng.randint(0, n_bins, (n, d)).astype(np.int32),
        "feat": feat, "bins": bins, "base": base,
        "leaf": rng.rand(T, min(2 ** depth, W), k).astype(np.float32),
    }


def hist_direct(codes: np.ndarray, A: np.ndarray, n_bins: int) -> np.ndarray:
    """The one-hot histogram by its definition, in float64:
    out[a, f * n_bins + b] = sum_s A[s, a] * 1[codes[s, f] == b]; codes
    outside [0, n_bins) add nothing."""
    S, d = codes.shape
    out = np.zeros((A.shape[1], d * n_bins), np.float64)
    A64 = A.astype(np.float64)
    for f in range(d):
        ok = (codes[:, f] >= 0) & (codes[:, f] < n_bins)
        for b in range(n_bins):
            out[:, f * n_bins + b] = A64[ok & (codes[:, f] == b)].sum(0)
    return out


def descend_direct(codes: np.ndarray, feat: np.ndarray, bins: np.ndarray,
                   base: Optional[np.ndarray] = None,
                   depth: Optional[int] = None) -> np.ndarray:
    """(n, T) leaf ids by a row-by-row walk of the definition: heap trees
    (feat/bins (T, 2^depth - 1), node' = 2 node + go) or, with ``base``,
    slot chains ((T, depth, W) tables, slot' = base + go; a slot past its
    level's width min(2^l, W) becomes slot 0); go = codes[s, feat] > bin,
    a feature outside [0, d) reading code 0."""
    n, d = codes.shape
    T = feat.shape[0]
    out = np.zeros((n, T), np.int64)
    for s in range(n):
        for t in range(T):
            def go(f, b):
                return int((codes[s, f] if 0 <= f < d else 0) > b)
            if base is None:
                node = 0
                for lv in range(depth):
                    j = 2 ** lv - 1 + node
                    node = 2 * node + go(feat[t, j], bins[t, j])
            else:
                node = 0
                W = feat.shape[2]
                for lv in range(feat.shape[1]):
                    if 0 <= node < min(2 ** lv, W):
                        node = int(base[t, lv, node]) + go(
                            feat[t, lv, node], bins[t, lv, node])
                    else:
                        node = 0
            out[s, t] = node
    return out


def leaf_sums_direct(ids: np.ndarray, aug: np.ndarray, L: int) -> np.ndarray:
    """sum_s aug[s, :] * 1[ids[s, t] == l] in float64, (T, L, k), as the
    contraction spells it: every row meets every (tree, leaf) cell, so a
    NaN or +-Inf stat times a 0 of the one-hot makes that cell NaN; ids
    outside [0, L) meet every cell with 0."""
    T = ids.shape[1]
    a = aug.astype(np.float64)
    out = np.empty((T, L, aug.shape[1]), np.float64)
    with np.errstate(invalid="ignore"):
        for t in range(T):
            onehot = (ids[:, t, None] == np.arange(L)).astype(np.float64)
            out[t] = (onehot[:, :, None] * a[:, None, :]).sum(0)
    return out


def leaf_sums_chunked(ids, aug, L: int, n_chunks: int, rows_per_chunk: int):
    """The leaf sums in the CUDA kernels' order, on the CPU: (T, L, k)
    float32. Rows [c * rows_per_chunk, +rows_per_chunk) make chunk c; each
    chunk adds its rows in ascending order from +0.0 (``index_add_``), then
    the chunk partials are added in chunk order; non-finite stats spread as
    in ``ops.forest.spread_nonfinite_sums``. ids (n, T) and aug (n, k) are
    torch tensors (ids outside [0, L) add nothing)."""
    import torch
    from .ops.forest import spread_nonfinite_sums
    ids, aug = ids.cpu().long(), aug.cpu().to(torch.float32)
    T, k = ids.shape[1], aug.shape[1]
    ok = (ids >= 0) & (ids < L)
    cell = torch.where(ok, ids + L * torch.arange(T), torch.full_like(
        ids, T * L))
    out = None
    for c in range(n_chunks):
        lo, hi = c * rows_per_chunk, (c + 1) * rows_per_chunk
        part = torch.zeros((T * L + 1, k), dtype=torch.float32)
        part.index_add_(0, cell[lo:hi].reshape(-1),
                        aug[lo:hi].repeat_interleave(T, dim=0))
        out = part if out is None else out + part
    return spread_nonfinite_sums(out[:T * L].reshape(T, L, k), ids, aug)


def serve_bench_data(n: int, d: int, seed: int) -> Dict[str, np.ndarray]:
    """The serve bench's training frame: ``d`` standard-normal predictors
    ``x0..`` and a label ``y`` from a random linear rule, all float32 from
    ``RandomState(seed)`` (the recipe the committed fixtures were trained
    on)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    w = rng.randn(d).astype(np.float32)
    data = {f"x{i}": X[:, i] for i in range(d)}
    data["y"] = (X @ w > 0).astype(np.float32)
    return data


def serve_bench_workflow(family: str, hyper: Dict, d: int, seed: int,
                         realnn: int = 0, device=None):
    """``transmogrify -> sanity_check -> BinaryClassificationModelSelector``
    over ``d`` predictors (the first ``realnn`` RealNN, the rest Real), the
    winner pinned to one family and grid point: an untrained
    ``OpWorkflow`` without data."""
    from .dsl import transmogrify
    from .features import FeatureBuilder
    from .impl.selector.factories import BinaryClassificationModelSelector
    from .workflow import OpWorkflow
    label = FeatureBuilder.RealNN("y").extract_field().as_response()
    feats = [(FeatureBuilder.RealNN if i < realnn else FeatureBuilder.Real)(
        f"x{i}").extract_field().as_predictor() for i in range(d)]
    checked = transmogrify(feats).sanity_check(label)
    pred = (BinaryClassificationModelSelector.with_cross_validation(
        seed=seed, models=[(family, [dict(hyper)])])
        .set_input(label, checked).get_output())
    return OpWorkflow(device=device).set_result_features(pred)
