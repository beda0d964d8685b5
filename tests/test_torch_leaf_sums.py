"""The leaf-sum entry points of the PyTorch port (``ops/forest.py``:
``forest_leaf_sums``, ``forest_leaf_sums_chain``) against the JAX
package's, on the CPU: its XLA path, and its Pallas kernels run in
interpret mode as its own tests run them (``TG_TREE_PALLAS=1``).

Tolerances: rtol 1e-5 / atol 1e-6 on [0, 1) stats (the JAX package sums
with a one-hot matmul, the port row by row); equal on integer-valued
stats.
"""
from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from transmogrifai_tpu.ops import forest as jforest  # noqa: E402
from transmogrifai_tpu_torch.ops import forest as pforest  # noqa: E402
from transmogrifai_tpu_torch.testing import (  # noqa: E402
    random_chain, random_heap,
)

RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _stats(rng, n, k):
    return (rng.rand(n, k).astype(np.float32),
            rng.randint(0, 5, (n, k)).astype(np.float32))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("shape", [(333, 11, 5, 4, 8, 3),
                                   (150, 7, 1, 3, 16, 1),
                                   (257, 9, 9, 6, 32, 4)])
def test_forest_leaf_sums_matches_jax(use_pallas, shape, monkeypatch):
    monkeypatch.setenv("TG_TREE_PALLAS", "1" if use_pallas else "0")
    jax.clear_caches()
    n, d, T, depth, nb, k = shape
    rng = np.random.RandomState(2)
    h = random_heap(rng, n, d, T, depth, 1, nb, stop=0.3)
    for aug in _stats(rng, n, k):
        want = np.asarray(jforest.forest_leaf_sums(
            jnp.asarray(h["codes"]), jnp.asarray(h["feat"]),
            jnp.asarray(h["bins"]), jnp.asarray(aug), depth=depth,
            n_bins=nb))
        got = pforest.forest_leaf_sums(_t(h["codes"]), _t(h["feat"]),
                                       _t(h["bins"]), _t(aug), depth=depth,
                                       n_bins=nb).numpy()
        if aug.max() >= 1:                      # integer-valued stats
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("depth,W,T", [(10, 32, 3), (12, 64, 5), (4, 16, 2)])
def test_forest_leaf_sums_chain_matches_jax(use_pallas, depth, W, T,
                                            monkeypatch):
    monkeypatch.setenv("TG_TREE_PALLAS", "1" if use_pallas else "0")
    jax.clear_caches()
    rng = np.random.RandomState(7)
    c = random_chain(rng, 257, 5, T, depth, W, 1, 16)
    tabs = (c["codes"], c["feat"], c["bins"], c["base"])
    for aug in _stats(rng, 257, 3):
        want = np.asarray(jforest.forest_leaf_sums_chain(
            *map(jnp.asarray, tabs), jnp.asarray(aug), n_bins=16))
        got = pforest.forest_leaf_sums_chain(*map(_t, tabs), _t(aug),
                                             n_bins=16).numpy()
        if aug.max() >= 1:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_leaf_sums_route_by_device():
    rng = np.random.RandomState(3)
    h = {k: _t(v) for k, v in random_heap(rng, 40, 3, 2, 2, 1, 8).items()}
    aug = torch.ones((40, 2))
    before = pforest.FOREST_LEAF_SUMS_HEAP.launches
    out = pforest.forest_leaf_sums(h["codes"], h["feat"], h["bins"], aug,
                                   depth=2, n_bins=8)
    assert pforest.FOREST_LEAF_SUMS_HEAP.launches == before
    assert float(out[..., 0].sum()) == 2 * 40.0
    with pytest.raises(ValueError, match="no forest kernel"):
        pforest.forest_leaf_sums(h["codes"].to("meta"), h["feat"],
                                 h["bins"], aug, depth=2, n_bins=8)
    with pytest.raises(ValueError, match="needs CUDA"):
        pforest.forest_leaf_sums_heap_cuda(h["codes"], h["feat"], h["bins"],
                                           aug, depth=2, n_bins=8)


@pytest.mark.parametrize("n", [1, 127, 128, 300, 19712, 10 ** 6])
def test_row_chunks_cover_the_rows(n):
    c, rpc = pforest.row_chunks(n)
    assert c <= 64 and (c - 1) * rpc < n <= c * rpc
