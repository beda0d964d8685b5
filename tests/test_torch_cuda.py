"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

These tests need a CUDA device and skip without one. They import neither
JAX nor the JAX package, so on a GPU machine without JAX they run alone::

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: leaf ids and slots exactly; sums rtol 1e-5, atol 1e-6 (both
add the trees one at a time in ascending order, so they agree to the bit
unless the compiler reorders the kernel's additions).
"""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from transmogrifai_tpu_torch.ops import forest as F  # noqa: E402
from transmogrifai_tpu_torch.testing import (  # noqa: E402
    random_chain, random_heap,
)

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the forest kernels run only on "
                    "the GPU")
    return torch.device("cuda")


def _on(dev, arrays):
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


@pytest.mark.parametrize("depth", [1, 2, 5, 6, 8])
@pytest.mark.parametrize("T,k", [(1, 1), (37, 3), (130, 6)])
def test_heap_kernel_matches_plain(cuda, depth, T, k):
    rng = np.random.RandomState(depth * 1000 + T)
    h = _on(cuda, random_heap(rng, 1001, 13, T, depth, k, 32))
    args = (h["codes"], h["feat"], h["bins"], h["leaf"])
    before = F.FOREST_PREDICT_HEAP.launches
    got, ids = F.forest_predict_heap_cuda(*args, depth=depth, with_ids=True)
    assert F.FOREST_PREDICT_HEAP.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(ids, F.route_codes(h["codes"], h["feat"], h["bins"],
                                          depth, 32))
    torch.testing.assert_close(
        got, F.forest_predict_plain(*args, depth=depth, n_bins=32),
        rtol=RTOL, atol=ATOL)
    # the public entry routes a CUDA tensor to the kernel
    torch.testing.assert_close(
        F.forest_predict(*args, depth=depth, n_bins=32), got, rtol=0, atol=0)
    assert F.FOREST_PREDICT_HEAP.launches == before + 2


@pytest.mark.parametrize("W", [1, 4, 64, 200, 256])
@pytest.mark.parametrize("k", [1, 5])
def test_chain_kernel_matches_plain(cuda, W, k):
    rng = np.random.RandomState(W * 10 + k)
    c = _on(cuda, random_chain(rng, 777, 9, 33, 12, W, k, 32))
    args = (c["codes"], c["feat"], c["bins"], c["base"], c["leaf"])
    got, ids = F.forest_predict_chain_cuda(*args, with_ids=True)
    torch.cuda.synchronize()
    assert torch.equal(ids, F.route_codes_chain(c["codes"], c["feat"],
                                                c["bins"], c["base"], 32))
    torch.testing.assert_close(
        got, F.forest_predict_chain_plain(*args, n_bins=32),
        rtol=RTOL, atol=ATOL)


def test_deep_chain_opts_into_large_shared_memory(cuda):
    """Depth 40 at W=256 needs ~100 KB of split tables for one tree."""
    rng = np.random.RandomState(5)
    c = _on(cuda, random_chain(rng, 300, 7, 3, 40, 256, 2, 32))
    args = (c["codes"], c["feat"], c["bins"], c["base"], c["leaf"])
    got, _ = F.forest_predict_chain_cuda(*args)
    torch.testing.assert_close(
        got, F.forest_predict_chain_plain(*args, n_bins=32),
        rtol=RTOL, atol=ATOL)


def test_out_of_range_features_read_code_zero(cuda):
    rng = np.random.RandomState(6)
    h = random_heap(rng, 200, 5, 4, 3, 1, 32)
    h["feat"][:, 0] = 99                       # past d: code 0, goes left
    h["feat"][:, 1] = -3
    h = _on(cuda, h)
    args = (h["codes"], h["feat"], h["bins"], h["leaf"])
    got, ids = F.forest_predict_heap_cuda(*args, depth=3, with_ids=True)
    assert torch.equal(ids, F.route_codes(h["codes"], h["feat"], h["bins"],
                                          3, 32))
    torch.testing.assert_close(
        got, F.forest_predict_plain(*args, depth=3, n_bins=32),
        rtol=RTOL, atol=ATOL)


def test_empty_batch_and_bad_inputs(cuda):
    rng = np.random.RandomState(7)
    h = _on(cuda, random_heap(rng, 0, 4, 3, 2, 1, 32))
    out, _ = F.forest_predict_heap_cuda(h["codes"], h["feat"], h["bins"],
                                        h["leaf"], depth=2)
    assert out.shape == (0, 1)
    h = _on(cuda, random_heap(rng, 10, 4, 3, 2, 1, 32))
    with pytest.raises(TypeError):
        F.forest_predict_heap_cuda(h["codes"].long(), h["feat"], h["bins"],
                                   h["leaf"], depth=2)
    with pytest.raises(ValueError):
        F.forest_predict_heap_cuda(h["codes"][:, ::2], h["feat"], h["bins"],
                                   h["leaf"], depth=2)
    with pytest.raises(ValueError):
        F.forest_predict_heap_cuda(h["codes"], h["feat"].cpu(), h["bins"],
                                   h["leaf"], depth=2)


def test_reruns_give_the_same_bits(cuda):
    rng = np.random.RandomState(8)
    c = _on(cuda, random_chain(rng, 4096, 16, 50, 12, 256, 1, 32))
    args = (c["codes"], c["feat"], c["bins"], c["base"], c["leaf"])
    a, _ = F.forest_predict_chain_cuda(*args)
    b, _ = F.forest_predict_chain_cuda(*args)
    assert torch.equal(a, b)
