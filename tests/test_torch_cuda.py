"""The port's CUDA kernels against their plain PyTorch versions, on the GPU,
and a tiny training run on the card.

These tests need a CUDA device and skip without one. They import neither
JAX nor the JAX package, so on a GPU machine without JAX they run alone::

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: leaf ids and slots exactly; forest sums rtol 1e-5, atol 1e-6
(both add the trees one at a time in ascending order, so they agree to the
bit unless the compiler reorders the kernel's additions); histograms rtol
1e-5, atol 1e-6 against the plain version on [0, 1) stats (the plain
version sums each row chunk in cuBLAS's order, the kernel row by row) and
equal on integer-valued stats; the tiny train on the card against the same
train on the CPU: tree tables and kept columns equal, metrics and
probabilities within 1e-5.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from transmogrifai_tpu_torch.histeng import kernels as HK  # noqa: E402
from transmogrifai_tpu_torch.ops import forest as F  # noqa: E402
from transmogrifai_tpu_torch.testing import (  # noqa: E402
    hist_direct, random_chain, random_heap, serve_bench_data,
    serve_bench_workflow,
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


def _hist_inputs(dev, seed, S, d, B, nb, sentinel=0.1):
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, nb, (S, d))
    codes[rng.rand(S, d) < sentinel] = nb
    return (torch.from_numpy(codes.astype(np.int32)).to(dev),
            torch.from_numpy(rng.rand(S, B).astype(np.float32)).to(dev),
            torch.from_numpy(rng.randint(-5, 6, (S, B)).astype(
                np.float32)).to(dev))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("S,d,B,nb", [(1, 1, 1, 1), (7, 3, 5, 2),
                                      (1001, 7, 13, 37), (4099, 64, 130, 32),
                                      (333, 2, 1024, 64), (250, 3, 9, 300),
                                      (120, 2, 3, 500)])
def test_hist_kernel_matches_plain(cuda, exact, S, d, B, nb):
    codes, A, A_int = _hist_inputs(cuda, S * 7 + B, S, d, B, nb)
    before = HK.HIST_MATMUL.launches
    got = HK.hist_matmul_cuda(codes, A, nb, exact)
    assert HK.HIST_MATMUL.launches == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(got, HK.hist_matmul_plain(codes, A, nb, exact),
                               rtol=RTOL, atol=ATOL)
    Ain = A if exact else A.to(torch.bfloat16).to(torch.float32)
    want = hist_direct(codes.cpu().numpy(), Ain.cpu().numpy(), nb)
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=RTOL, atol=ATOL)
    # integer-valued stats sum exactly; reruns give the same bits
    got_i = HK.hist_matmul_cuda(codes, A_int, nb, exact)
    np.testing.assert_array_equal(got_i.cpu().numpy(), hist_direct(
        codes.cpu().numpy(), A_int.cpu().numpy(), nb))
    assert torch.equal(got, HK.hist_matmul_cuda(codes, A, nb, exact))


@pytest.mark.parametrize("B", [1024, 1025])
def test_hist_dispatch_launches_the_kernel_at_any_width(cuda, B):
    # the JAX package leaves its Pallas kernel above 1024 stat columns;
    # on the card every width launches the CUDA kernel
    codes, A, _ = _hist_inputs(cuda, 9, 500, 4, B, 8)
    before = HK.HIST_MATMUL.launches
    got = HK.hist_matmul(codes, A, 8)
    assert HK.HIST_MATMUL.launches == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(got, HK.hist_matmul_plain(codes, A, 8),
                               rtol=RTOL, atol=ATOL)


def test_hist_kernel_empty_and_bad_inputs(cuda):
    codes, A, _ = _hist_inputs(cuda, 10, 0, 3, 4, 8)
    assert torch.equal(HK.hist_matmul_cuda(codes, A, 8),
                       torch.zeros((4, 24), device=cuda))
    codes, A, _ = _hist_inputs(cuda, 11, 10, 3, 4, 8)
    with pytest.raises(TypeError):
        HK.hist_matmul_cuda(codes.long(), A, 8)
    with pytest.raises(ValueError):
        HK.hist_matmul_cuda(codes, A[:, ::2], 8)
    with pytest.raises(ValueError):
        HK.hist_matmul_cuda(codes, A.cpu(), 8)
    with pytest.raises(RuntimeError, match="CUDA error"):
        HK.hist_matmul_cuda(codes, A, 4000)      # bins beyond shared memory


def test_tiny_train_on_the_card_matches_the_cpu(cuda):
    family, hyper = "OpGBTClassifier", {
        "maxDepth": 3, "maxIter": 5, "stepSize": 0.1,
        "minInstancesPerNode": 5, "minInfoGain": 0.001}
    data = serve_bench_data(400, 5, seed=3)
    cpu = serve_bench_workflow(family, hyper, 5, seed=3, realnn=2,
                               device="cpu").set_input_dataset(data).train()
    before = HK.HIST_MATMUL.launches
    gpu = serve_bench_workflow(family, hyper, 5, seed=3, realnn=2,
                               device=cuda).set_input_dataset(data).train()
    assert HK.HIST_MATMUL.launches >= before + hyper["maxIter"]
    cp, gp = cpu.stages[-1].fitted.params, gpu.stages[-1].fitted.params
    for k in ("edges", "feat", "bins"):
        assert torch.equal(gp[k].cpu(), cp[k]), k
    assert gpu.stages[-2].keep_indices == cpu.stages[-2].keep_indices
    np.testing.assert_allclose(
        gpu.stages[-1].summary.validation_results[0].fold_metrics,
        cpu.stages[-1].summary.validation_results[0].fold_metrics,
        rtol=0, atol=1e-5)
    frame = {k: v for k, v in data.items() if k != "y"}
    p_cpu, p_gpu = (m.score(data=frame)[m.result_features[0].name]
                    .values[:, -1].cpu() for m in (cpu, gpu))
    torch.testing.assert_close(p_gpu, p_cpu, rtol=0, atol=1e-5)
