"""Seeded random forests for holding the descent kernels to their plain
versions (tests and ``chip_smoke.py``). Everything is numpy, so the same
seed gives the same forest to the JAX package and to the port."""
from __future__ import annotations

from typing import Dict

import numpy as np


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
