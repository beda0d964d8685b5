"""The port's CUDA kernels against their plain PyTorch versions, on the GPU,
and a tiny training run on the card.

These tests need a CUDA device and skip without one. They import neither
JAX nor the JAX package, so on a GPU machine without JAX they run alone::

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: leaf ids and slots exactly, forest predict sums bit-equal to
their plain versions (both add the trees one at a time in ascending
order); the node histogram bit-equal to
its direct formula (both add the rows in order), rtol 1e-5, atol 1e-6
against its plain version (cuBLAS's order), equal on integer-valued
stats and across launch shapes; histograms and
leaf sums rtol 1e-5, atol 1e-6 against the plain version and the direct
float64 formula on [0, 1) stats (the plain versions sum in another order:
cuBLAS's per row chunk, or one pass over all rows, where the kernels add
row chunks and then the chunk partials) and equal on integer-valued
stats; the tiny trains on the card (binary, regression and 6-class)
against the same trains on the CPU: tree tables and kept columns equal,
metrics and probabilities (a regression's prediction) within 1e-5; the
linear families' fits, sweeps, predicts and tiny trains on the card
against the CPU within the limits stated at ``LINEAR_CASES``, and bit
for bit the same with the caller's global TF32 switch on or off.
"""
from __future__ import annotations

import ctypes
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
    descend_direct, hist_direct, leaf_sums_chunked, leaf_sums_direct,
    random_chain, random_heap, serve_bench_data, serve_bench_workflow,
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
    got, ids = F.forest_predict_heap_cuda(*args, depth=depth, n_bins=32,
                                          with_ids=True)
    assert F.FOREST_PREDICT_HEAP.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(ids, F.route_codes(h["codes"], h["feat"], h["bins"],
                                          depth, 32))
    assert torch.equal(got, F.forest_predict_plain(*args, depth=depth,
                                                   n_bins=32))
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
    got, ids = F.forest_predict_chain_cuda(*args, n_bins=32, with_ids=True)
    torch.cuda.synchronize()
    assert torch.equal(ids, F.route_codes_chain(c["codes"], c["feat"],
                                                c["bins"], c["base"], 32))
    assert torch.equal(got, F.forest_predict_chain_plain(*args, n_bins=32))


def test_deep_chain_opts_into_large_shared_memory(cuda):
    """Depth 40 at W=256 needs ~100 KB of split tables for one tree."""
    rng = np.random.RandomState(5)
    c = _on(cuda, random_chain(rng, 300, 7, 3, 40, 256, 2, 32))
    args = (c["codes"], c["feat"], c["bins"], c["base"], c["leaf"])
    got, _ = F.forest_predict_chain_cuda(*args, n_bins=32)
    assert torch.equal(got, F.forest_predict_chain_plain(*args, n_bins=32))


def test_out_of_range_features_read_code_zero(cuda):
    rng = np.random.RandomState(6)
    h = random_heap(rng, 200, 5, 4, 3, 1, 32)
    h["feat"][:, 0] = 99                       # past d: code 0, goes left
    h["feat"][:, 1] = -3
    h = _on(cuda, h)
    args = (h["codes"], h["feat"], h["bins"], h["leaf"])
    got, ids = F.forest_predict_heap_cuda(*args, depth=3, n_bins=32,
                                          with_ids=True)
    assert torch.equal(ids, F.route_codes(h["codes"], h["feat"], h["bins"],
                                          3, 32))
    assert torch.equal(got, F.forest_predict_plain(*args, depth=3,
                                                   n_bins=32))


def test_empty_batch_and_bad_inputs(cuda):
    rng = np.random.RandomState(7)
    h = _on(cuda, random_heap(rng, 0, 4, 3, 2, 1, 32))
    out, _ = F.forest_predict_heap_cuda(h["codes"], h["feat"], h["bins"],
                                        h["leaf"], depth=2, n_bins=32)
    assert out.shape == (0, 1)
    h = _on(cuda, random_heap(rng, 10, 4, 3, 2, 1, 32))
    with pytest.raises(TypeError):
        F.forest_predict_heap_cuda(h["codes"].long(), h["feat"], h["bins"],
                                   h["leaf"], depth=2, n_bins=32)
    with pytest.raises(ValueError):
        F.forest_predict_heap_cuda(h["codes"][:, ::2], h["feat"], h["bins"],
                                   h["leaf"], depth=2, n_bins=32)
    with pytest.raises(ValueError):
        F.forest_predict_heap_cuda(h["codes"], h["feat"].cpu(), h["bins"],
                                   h["leaf"], depth=2, n_bins=32)


def test_reruns_give_the_same_bits(cuda):
    rng = np.random.RandomState(8)
    c = _on(cuda, random_chain(rng, 4096, 16, 50, 12, 256, 1, 32))
    args = (c["codes"], c["feat"], c["bins"], c["base"], c["leaf"])
    a, _ = F.forest_predict_chain_cuda(*args, n_bins=32)
    b, _ = F.forest_predict_chain_cuda(*args, n_bins=32)
    assert torch.equal(a, b)


def _check_predict(f, depth, W, nb=32, **kw):
    """The kernel of a heap (W None) or chain forest against its plain
    version: sums bit-equal, leaf ids equal, reruns bit-equal."""
    if W is None:
        args = (f["codes"], f["feat"], f["bins"], f["leaf"])
        got, ids = F.forest_predict_heap_cuda(*args, depth=depth, n_bins=nb,
                                              with_ids=True, **kw)
        want = F.forest_predict_plain(*args, depth=depth, n_bins=nb)
        want_ids = F.route_codes(*args[:3], depth, nb)
        again = F.forest_predict_heap_cuda(*args, depth=depth, n_bins=nb,
                                           **kw)[0]
    else:
        args = (f["codes"], f["feat"], f["bins"], f["base"], f["leaf"])
        got, ids = F.forest_predict_chain_cuda(*args, n_bins=nb,
                                               with_ids=True, **kw)
        want = F.forest_predict_chain_plain(*args, n_bins=nb)
        want_ids = F.route_codes_chain(*args[:4], nb)
        again = F.forest_predict_chain_cuda(*args, n_bins=nb, **kw)[0]
    torch.cuda.synchronize()
    assert torch.equal(ids, want_ids)
    assert torch.equal(got, want)
    assert torch.equal(again, got)
    return got


#: (n, T, depth, W): rows not a multiple of a block's (nor of 32), trees
#: past one stage of records (RF: T 50 and 57 at depth 12, W 256 take
#: tiles of trees, double-buffered), trees not a multiple of the four a
#: thread walks, W 1, 3, 64 and 256, depth 1 to 12; 16 codes, so that
#: only the one-tree depth-1 forest reads its codes in place
PREDICT_EDGES = [(1, 1, 1, 1), (33, 5, 3, 3), (1001, 7, 12, 1),
                 (4097, 57, 12, 256), (5003, 50, 12, 256),
                 (777, 33, 9, 64), (2049, 20, 12, 256), (999, 3, 2, 3)]


@pytest.mark.parametrize("case", PREDICT_EDGES)
def test_chain_predict_crosses_every_tile_edge(cuda, case):
    n, T, depth, W = case
    rng = np.random.RandomState(n + T)
    f = _on(cuda, random_chain(rng, n, 16, T, depth, W, 2, 32))
    _check_predict(f, depth, W)


@pytest.mark.parametrize("n,T,depth", [(1, 1, 1), (4097, 20, 6),
                                       (999, 130, 8), (3001, 7, 11),
                                       (129, 2, 0)])
def test_heap_predict_crosses_every_tile_edge(cuda, n, T, depth):
    rng = np.random.RandomState(n + depth)
    f = _on(cuda, random_heap(rng, n, 64, T, depth, 1, 32))
    _check_predict(f, depth, None)


@pytest.mark.parametrize("n", [1, 3001, 20000, 40000, 65536])
def test_predict_bits_do_not_depend_on_the_launch(cuda, n):
    """The rows a block (and so the trees a tile) follow the row count: the
    first n rows of a 65,536-row batch give the bits the whole batch gives
    them, since each row adds its trees in order in one thread."""
    rng = np.random.RandomState(40)
    c = _on(cuda, random_chain(rng, 65536, 64, 51, 12, 256, 1, 32))
    h = _on(cuda, random_heap(rng, 65536, 64, 21, 6, 1, 32))
    for f, depth, W in ((c, 12, 256), (h, 6, None)):
        whole = _check_predict(f, depth, W)
        head = dict(f, codes=f["codes"][:n].contiguous())
        assert torch.equal(_check_predict(head, depth, W), whole[:n])


def test_predict_reads_codes_0_and_255_at_256_bins(cuda):
    """Byte codes: every code and bin boundary of 256 bins, the sentinel
    bin 256 and features outside [0, d) in chains and heaps."""
    rng = np.random.RandomState(41)
    c = random_chain(rng, 3000, 17, 9, 10, 64, 1, 256)
    c["codes"][:, :5] = np.array([0, 255, 254, 1, 128], np.int32)
    c["codes"][::7] = 255
    c["codes"][1::7] = 0
    c["bins"][:, :, ::5] = 254
    c["bins"][:, :, 1::5] = 0
    c["bins"][:, :, 2::5] = 256                  # the sentinel: left
    c["feat"][:, :, ::3] = np.where(rng.rand(9, 10, 1) < 0.5, 17, -1)
    _check_predict(_on(cuda, c), 10, 64, nb=256)
    h = random_heap(rng, 3000, 17, 9, 7, 1, 256)
    h["codes"][::5] = 255
    h["bins"][:, ::4] = 254
    h["bins"][:, 1::4] = 255
    h["feat"][:, ::6] = 40                       # past d: code 0
    _check_predict(_on(cuda, h), 7, None, nb=256)


def test_chain_predict_keeps_last_level_slots_exact(cuda):
    """A last-level base past the packed record's 11 bits is read from the
    int32 table (ids exact, slots past the leaves add nothing); bases past
    a level before the last read as slot 0 one level down."""
    rng = np.random.RandomState(42)
    c = random_chain(rng, 2000, 16, 6, 8, 32, 1, 32)
    c["base"][:, 7, ::3] = 5000
    c["base"][:, 7, 1::3] = 40
    c["base"][:, 3, ::4] = 3000
    c["base"][:, 5, 1::4] = 33
    _check_predict(_on(cuda, c), 8, 32)


@pytest.mark.parametrize("d,nb,T", [(5000, 32, 5), (64, 300, 5),
                                    (64, 32, 1)])
def test_predict_takes_the_wide_path(cuda, d, nb, T):
    """Features past the record's 12-bit field, codes past a byte, or
    forests whose rows read few codes (one tree: T x depth <= d / 4) run
    the int32 path: still bit-equal to the plain version."""
    rng = np.random.RandomState(d + nb + T)
    c = random_chain(rng, 700, d, T, 12, 64, 1, nb)
    h = random_heap(rng, 700, d, T, 6, 1, nb)
    _check_predict(_on(cuda, c), 12, 64, nb=nb)
    _check_predict(_on(cuda, h), 6, None, nb=nb)


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
                                      (120, 2, 3, 500), (1500, 3, 40, 256)])
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


@pytest.mark.parametrize("nb", [64, 256])
def test_hist_kernel_on_the_leaf_layout_with_sentinel_columns(cuda, nb):
    """``_diag_leaf_hist``'s layout: one real tree column of 64, the
    padded ones all sentinel and their stat columns zero; the sentinel
    columns come out +0 everywhere."""
    rng = np.random.RandomState(nb)
    S, d, B = 5003, 64, 128
    codes = np.full((S, d), nb, np.int32)
    codes[:, 0] = rng.randint(0, nb, S)
    A = np.zeros((S, B), np.float32)
    A[:, 0], A[:, 64] = rng.rand(S), rng.rand(S)
    A_int = np.zeros((S, B), np.float32)
    A_int[:, 0], A_int[:, 64] = rng.randint(-5, 6, S), rng.randint(0, 6, S)
    codes, A, A_int = (torch.from_numpy(x).to(cuda) for x in (codes, A,
                                                              A_int))
    got = HK.hist_matmul_cuda(codes, A, nb, True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, HK.hist_matmul_plain(codes, A, nb, True),
                               rtol=RTOL, atol=ATOL)
    rest = got[:, nb:]
    assert torch.equal(rest, torch.zeros_like(rest))
    assert not torch.signbit(rest).any()
    assert torch.equal(HK.hist_matmul_cuda(codes, A_int, nb, True),
                       HK.hist_matmul_plain(codes, A_int, nb, True))


@pytest.mark.parametrize("nb", [37, 256])
@pytest.mark.parametrize("max_cols", [4, 8, 16])
def test_hist_bits_do_not_depend_on_the_launch(cuda, nb, max_cols):
    """The stat tile (the block's width) changes no bit: every sum adds
    its split's rows, the splits and the chunks in one order."""
    codes, A, _ = _hist_inputs(cuda, 31, 9001, 5, 70, nb)
    codes[:, 1] = nb                       # a column without a valid code
    for exact in (True, False):
        assert torch.equal(
            HK.hist_matmul_cuda(codes, A, nb, exact, max_cols=max_cols),
            HK.hist_matmul_cuda(codes, A, nb, exact))


def test_hist_kernel_takes_more_features_than_a_grid_row(cuda):
    """Features share grid.x with the stat tiles: 70,000 features launch,
    past grid.y's 65,535."""
    codes, A, A_int = _hist_inputs(cuda, 32, 40, 70000, 3, 2)
    got = HK.hist_matmul_cuda(codes, A_int, 2, True)
    assert torch.equal(got, HK.hist_matmul_plain(codes, A_int, 2, True))


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


#: non-finite stats: one NaN, one +Inf, one -Inf, a +Inf/-Inf pair, and a
#: finite value that rounds to +Inf in bf16
NONFINITE = {"nan": [float("nan")], "+inf": [float("inf")],
             "-inf": [-float("inf")],
             "+inf/-inf": [float("inf"), -float("inf")],
             "bf16 overflow": [3.4e38]}


def _same_or_nan(got, want):
    """NaN where the other is NaN, the same bits everywhere else."""
    got, want = got.cpu(), want.cpu()
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


def _spoil(x, kind, rng, rows, cols):
    """x with the values of ``kind`` at rows and columns drawn from rng."""
    x = x.clone()
    for v in NONFINITE[kind]:
        x[int(rng.choice(rows)), int(rng.choice(cols))] = v
    return x


def _roadmap_codes():
    """Rows [[0, 1], [1, 0], [2, 2], [0, 3]] four times, three bins."""
    return torch.tensor([[0, 1], [1, 0], [2, 2], [0, 3]] * 4,
                        dtype=torch.int32)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("kind", sorted(NONFINITE))
@pytest.mark.parametrize("shape", ["roadmap", "odd", "dead chunk"])
def test_hist_kernel_spreads_non_finite_stats_as_plain(cuda, shape, kind,
                                                       exact):
    """The contraction's 0 * (+-Inf or NaN) = NaN: the kernel gives the
    plain version's NaN cells and the bits of every other cell, also for
    a column whose codes are all the sentinel and for a row chunk where no
    feature holds a valid code."""
    rng = np.random.RandomState(len(kind) + 7 * len(shape))
    if shape == "roadmap":
        codes, nb = _roadmap_codes(), 3
        A = _spoil(torch.ones(16, 2), kind, rng, [2, 3, 6], [0])
    else:
        S, d, B, nb = (4099, 9, 13, 11) if shape == "odd" else (64, 5, 7, 4)
        codes = torch.from_numpy(rng.randint(0, nb + 1, (S, d)).astype(
            np.int32))
        codes[:, 4] = nb                           # a column all sentinel
        rows = np.arange(S)
        if shape == "dead chunk":                  # chunk 1 of 8: no codes
            codes[8:16] = nb
            rows = np.arange(8, 16)
        A = _spoil(torch.from_numpy(rng.randint(-4, 5, (S, B)).astype(
            np.float32)), kind, rng, rows, [0, 3, B - 1])
    want = HK.hist_matmul_plain(codes, A, nb, exact)
    got = HK.hist_matmul_cuda(codes.to(cuda), A.to(cuda), nb, exact)
    _same_or_nan(got, want)
    _same_or_nan(HK.hist_matmul_cuda(codes.to(cuda), A.to(cuda), nb, exact,
                                     max_cols=4), want)


#: (S, d, T, Wl, stride, nb): the roadmap input, one tree with int32
#: codes, three trees with byte codes, 300 bins (int32 codes over trees)
NODE_NONFINITE = [(16, 2, 1, 2, 1, 3), (509, 9, 1, 7, 1, 11),
                  (4099, 16, 3, 3, 2, 32), (700, 16, 2, 5, 2, 300)]


@pytest.mark.parametrize("kind", sorted(NONFINITE))
@pytest.mark.parametrize("case", NODE_NONFINITE)
def test_node_hist_spreads_non_finite_stats_as_plain(cuda, case, kind):
    """A non-finite stat makes its tree's other slots NaN, and in its own
    slot every bin its row does not hit (the masked-stat contraction's
    0 * Inf); the kernel matches the plain version and the direct formula
    there, and every other cell to the bit."""
    S, d, T, Wl, stride, nb = case
    rng = np.random.RandomState(S + len(kind))
    if S == 16:
        codes = _roadmap_codes()
        node = torch.tensor([[0], [1]] * 8, dtype=torch.int64)
        sw = [_spoil(torch.ones(16, 1), kind, rng, [2, 3, 6], [0]),
              torch.ones(16, 1)]
    else:
        codes = torch.from_numpy(rng.randint(0, nb + 1, (S, d)).astype(
            np.int32))
        codes[:, 3] = nb                           # a column all sentinel
        node = torch.from_numpy(rng.randint(-2, stride * Wl + 2, (S, T)))
        sw = [torch.from_numpy(rng.randint(-4, 5, (S, T)).astype(np.float32))
              for _ in range(3)]
        sw[1] = _spoil(sw[1], kind, rng, np.arange(S), np.arange(T))
    want = HK.node_hist_plain(codes, node, sw, Wl, nb, stride)
    got = _node_hist_kernel(codes.to(cuda), node.to(cuda),
                            [s.to(cuda) for s in sw], Wl, nb, stride)
    _same_or_nan(got, want)
    _same_or_nan(got, HK.node_hist_direct(codes, node, sw, Wl, nb, stride))


def _leaf_case(dev, seed, n, d, T, k, depth, W=None, nb=32):
    """A random heap (W None) or chain forest on the card, [0, 1) stats and
    integer-valued stats, the direct float64 sums of both, and the (n, T)
    leaf ids."""
    rng = np.random.RandomState(seed)
    if W is None:
        f = random_heap(rng, n, d, T, depth, 1, nb)
        f["feat"][:, :1] = np.where(rng.rand(T, 1) < 0.2, d + 3,
                                    f["feat"][:, :1])  # past d: code 0
        ids = descend_direct(f["codes"], f["feat"], f["bins"], depth=depth)
        L = 2 ** depth
    else:
        f = random_chain(rng, n, d, T, depth, W, 1, nb)
        ids = descend_direct(f["codes"], f["feat"], f["bins"], f["base"])
        L = min(2 ** depth, W)
    aug = rng.rand(n, k).astype(np.float32)
    aug_i = rng.randint(0, 4, (n, k)).astype(np.float32)
    f = {key: v for key, v in f.items() if key != "leaf"}
    return (_on(dev, f), torch.from_numpy(aug).to(dev),
            torch.from_numpy(aug_i).to(dev), leaf_sums_direct(ids, aug, L),
            leaf_sums_direct(ids, aug_i, L), torch.from_numpy(ids))


def _chunked(ids, aug, L):
    """The sums in the kernels' order (``testing.leaf_sums_chunked``)."""
    return leaf_sums_chunked(ids, aug, L, *F.row_chunks(ids.shape[0]))


def _check_leaf_sums(kernel, cuda_fn, plain_fn, aug, aug_i, want, want_i,
                     ids=None, L=None):
    """The kernel against its plain version and the direct float64 sums
    (tolerance on [0, 1) stats, bits on integer-valued ones), against the
    kernels' order to the bit (with ids), and on a rerun."""
    before = kernel.launches
    got = cuda_fn(aug)
    assert kernel.launches == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(got, plain_fn(aug), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=RTOL, atol=ATOL)
    got_i = cuda_fn(aug_i)
    assert torch.equal(got_i, plain_fn(aug_i))
    np.testing.assert_array_equal(got_i.cpu().numpy(), want_i)
    assert torch.equal(got, cuda_fn(aug))
    if ids is not None:
        assert torch.equal(got.cpu(), _chunked(ids, aug, L))
        assert torch.equal(got_i.cpu(), _chunked(ids, aug_i, L))


@pytest.mark.parametrize("depth", [0, 1, 3, 6, 8])
@pytest.mark.parametrize("T,k", [(1, 3), (50, 3), (37, 1)])
def test_leaf_sums_heap_kernel_matches_plain(cuda, depth, T, k):
    f, aug, aug_i, want, want_i, ids = _leaf_case(cuda, depth * 100 + T,
                                                  1001, 13, T, k, depth)
    args = (f["codes"], f["feat"], f["bins"])
    _check_leaf_sums(
        F.FOREST_LEAF_SUMS_HEAP,
        lambda a: F.forest_leaf_sums_heap_cuda(*args, a, depth=depth,
                                               n_bins=32),
        lambda a: F.forest_leaf_sums_plain(*args, a, depth=depth, n_bins=32),
        aug, aug_i, want, want_i, ids, 2 ** depth)
    before = F.FOREST_LEAF_SUMS_HEAP.launches
    F.forest_leaf_sums(*args, aug, depth=depth, n_bins=32)
    assert F.FOREST_LEAF_SUMS_HEAP.launches == before + 1


@pytest.mark.parametrize("W,depth", [(1, 5), (4, 12), (64, 12), (256, 12),
                                     (200, 9)])
def test_leaf_sums_chain_kernel_matches_plain(cuda, W, depth):
    f, aug, aug_i, want, want_i, ids = _leaf_case(cuda, W + depth, 777, 9, 20,
                                                  3, depth, W=W)
    args = (f["codes"], f["feat"], f["bins"], f["base"])
    _check_leaf_sums(
        F.FOREST_LEAF_SUMS_CHAIN,
        lambda a: F.forest_leaf_sums_chain_cuda(*args, a, n_bins=32),
        lambda a: F.forest_leaf_sums_chain_plain(*args, a, n_bins=32),
        aug, aug_i, want, want_i, ids, min(2 ** depth, W))
    before = F.FOREST_LEAF_SUMS_CHAIN.launches
    F.forest_leaf_sums_chain(*args, aug, n_bins=32)
    assert F.FOREST_LEAF_SUMS_CHAIN.launches == before + 1


def _sums_cuda(f, aug, depth, W, nb):
    """The leaf-sum kernel of a heap (W None) or chain forest."""
    if W is None:
        return F.forest_leaf_sums_heap_cuda(f["codes"], f["feat"], f["bins"],
                                            aug, depth=depth, n_bins=nb)
    return F.forest_leaf_sums_chain_cuda(f["codes"], f["feat"], f["bins"],
                                         f["base"], aug, n_bins=nb)


def _sums_plain(f, aug, depth, W, nb):
    if W is None:
        return F.forest_leaf_sums_plain(f["codes"], f["feat"], f["bins"],
                                        aug, depth=depth, n_bins=nb)
    return F.forest_leaf_sums_chain_plain(f["codes"], f["feat"], f["bins"],
                                          f["base"], aug, n_bins=nb)


def _ids(f, depth, W, nb):
    if W is None:
        return F.route_codes(f["codes"], f["feat"], f["bins"], depth, nb)
    return F.route_codes_chain(f["codes"], f["feat"], f["bins"], f["base"],
                               nb)


def _check_chunked(f, depth, W, nb, k, seed):
    """The kernel bit-equal to the kernels' order on [0, 1) and on
    integer-valued stats, and on a rerun."""
    n = f["codes"].shape[0]
    L = 2 ** depth if W is None else min(2 ** depth, W)
    ids = _ids(f, depth, W, nb).cpu()
    rng = np.random.RandomState(seed)
    for aug in (rng.rand(n, k), rng.randint(0, 4, (n, k))):
        aug = torch.from_numpy(aug.astype(np.float32)).to(f["codes"].device)
        got = _sums_cuda(f, aug, depth, W, nb)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), _chunked(ids, aug, L))
        assert torch.equal(got, _sums_cuda(f, aug, depth, W, nb))


@pytest.mark.parametrize("T,depth,W", [(50, 12, 256), (1, 6, None)])
def test_leaf_sums_keep_the_chunked_order_at_the_refit_shapes(cuda, T, depth,
                                                              W):
    """The RF refit (19,712 rows x 64 codes, chains T 50 depth 12 W 256)
    and the DT refit (one heap of depth 6), k 3."""
    rng = np.random.RandomState(T + depth)
    f = (random_heap(rng, 19712, 64, T, depth, 1, 32) if W is None
         else random_chain(rng, 19712, 64, T, depth, W, 1, 32))
    _check_chunked(_on(cuda, f), depth, W, 32, 3, T)


#: (n, d, T, depth, W, k, nb): rows not a multiple of a chunk's, trees not
#: a multiple of a tile's (nor of the four a thread walks), k 1 and 5, 257
#: bins (the wide path), more rows a chunk than a block takes at once
ODD_SUMS = [(1001, 13, 7, 6, None, 1, 32), (3001, 9, 23, 12, 64, 5, 32),
            (777, 13, 5, 5, None, 5, 257), (777, 9, 6, 9, 24, 1, 257),
            (70001, 16, 9, 12, 256, 3, 32), (513, 16, 131, 4, None, 2, 32)]


@pytest.mark.parametrize("case", ODD_SUMS)
def test_leaf_sums_keep_the_chunked_order_at_odd_shapes(cuda, case):
    n, d, T, depth, W, k, nb = case
    rng = np.random.RandomState(n + T)
    f = (random_heap(rng, n, d, T, depth, 1, nb) if W is None
         else random_chain(rng, n, d, T, depth, W, 1, nb))
    _check_chunked(_on(cuda, f), depth, W, nb, k, n)


@pytest.mark.parametrize("k", [4, 7])
def test_leaf_sums_keep_the_chunked_order_at_the_task_refit_shapes(cuda, k):
    """The rfreg refit's chains (k 4: [-y, 1, 1] times the weight, and the
    weight) and the rfmc refit's (k 7: six class counts and the weight),
    19,712 rows x 64 codes, T 50, depth 12, W 256."""
    rng = np.random.RandomState(40 + k)
    f = random_chain(rng, 19712, 64, 50, 12, 256, 1, 32)
    _check_chunked(_on(cuda, f), 12, 256, 32, k, 50)


@pytest.mark.parametrize("n,leaf", [(65536, "random"), (20000, "per class")])
def test_heap_predict_at_the_multiclass_boosting_shape(cuda, n, leaf):
    """The xgbmc serve: 600 trees (100 rounds x 6 classes) of depth 6, k 6
    columns (launched four and then two), random leaves or the scorer's
    class-routing table (each tree's values in its class's column only):
    bit-equal to the plain version, ids exact."""
    rng = np.random.RandomState(n)
    h = random_heap(rng, n, 64, 600, 6, 6, 32)
    if leaf == "per class":
        h["leaf"] *= (np.arange(600)[:, None, None] % 6
                      == np.arange(6)[None, None, :])
    h = _on(cuda, h)
    args = (h["codes"], h["feat"], h["bins"], h["leaf"])
    before = F.FOREST_PREDICT_HEAP.launches
    got, ids = F.forest_predict_heap_cuda(*args, depth=6, n_bins=32,
                                          with_ids=True)
    assert F.FOREST_PREDICT_HEAP.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(ids, F.route_codes(*args[:3], 6, 32))
    assert torch.equal(got, F.forest_predict_plain(*args, depth=6,
                                                   n_bins=32))


@pytest.mark.parametrize("W", [None, 256])
def test_leaf_sums_with_every_row_in_one_leaf(cuda, W):
    """Every split the sentinel (route left): all 19,712 rows in leaf 0 of
    every tree, the skew of a real refit at its extreme."""
    rng = np.random.RandomState(14)
    f = (random_heap(rng, 19712, 64, 3, 6, 1, 32) if W is None
         else random_chain(rng, 19712, 64, 50, 12, W, 1, 32))
    f["bins"][:] = 32
    if W is not None:
        f["base"][:] = 0
    f = _on(cuda, f)
    assert bool((_ids(f, 12 if W else 6, W, 32) == 0).all())
    _check_chunked(f, 12 if W else 6, W, 32, 3, 15)


def test_leaf_sums_do_not_depend_on_tree_grouping(cuda):
    """One call over 50 trees gives the bits of 50 one-tree calls: rows
    are chunked by their count alone."""
    rng = np.random.RandomState(12)
    c = _on(cuda, random_chain(rng, 19712, 64, 50, 12, 256, 1, 32))
    aug = torch.from_numpy(rng.rand(19712, 3).astype(np.float32)).to(cuda)
    tabs = (c["feat"], c["bins"], c["base"])
    whole = F.forest_leaf_sums_chain_cuda(c["codes"], *tabs, aug, n_bins=32)
    for t in (0, 17, 49):
        one = F.forest_leaf_sums_chain_cuda(
            c["codes"], *(x[t:t + 1].contiguous() for x in tabs), aug,
            n_bins=32)
        assert torch.equal(one[0], whole[t])
    h = _on(cuda, random_heap(rng, 5000, 16, 40, 6, 1, 32))
    aug = aug[:5000].contiguous()
    whole = F.forest_leaf_sums_heap_cuda(h["codes"], h["feat"], h["bins"],
                                         aug, depth=6, n_bins=32)
    part = F.forest_leaf_sums_heap_cuda(h["codes"], h["feat"][3:21].
                                        contiguous(), h["bins"][3:21].
                                        contiguous(), aug, depth=6,
                                        n_bins=32)
    assert torch.equal(part, whole[3:21])


def test_leaf_sums_empty_and_bad_inputs(cuda):
    rng = np.random.RandomState(13)
    h = _on(cuda, random_heap(rng, 0, 4, 3, 2, 1, 32))
    aug = torch.zeros((0, 2), device=cuda)
    out = F.forest_leaf_sums_heap_cuda(h["codes"], h["feat"], h["bins"], aug,
                                       depth=2, n_bins=32)
    assert torch.equal(out, torch.zeros((3, 4, 2), device=cuda))
    h = _on(cuda, random_heap(rng, 10, 4, 3, 2, 1, 32))
    aug = torch.ones((10, 2), device=cuda)
    with pytest.raises(TypeError):
        F.forest_leaf_sums_heap_cuda(h["codes"], h["feat"], h["bins"],
                                     aug.double(), depth=2, n_bins=32)
    with pytest.raises(ValueError):
        F.forest_leaf_sums_heap_cuda(h["codes"], h["feat"], h["bins"],
                                     aug[:5], depth=2, n_bins=32)
    with pytest.raises(ValueError):
        F.forest_leaf_sums_heap_cuda(h["codes"], h["feat"], h["bins"],
                                     aug.cpu(), depth=2, n_bins=32)
    with pytest.raises(RuntimeError, match="CUDA error"):
        # one tree's partial (4 leaves x 60,000 stats) exceeds shared memory
        F.forest_leaf_sums_heap_cuda(h["codes"], h["feat"], h["bins"],
                                     torch.ones((10, 60000), device=cuda),
                                     depth=2, n_bins=32)


#: forests whose kernels take the byte path and the wide path: (tag, d, T,
#: depth, W, nb); the heap of depth 2 reads its codes in place (predict)
NONFINITE_FORESTS = [("heap", 13, 20, 6, None, 32),
                     ("heap, wide", 13, 1, 2, None, 300),
                     ("chain", 13, 9, 10, 64, 32),
                     ("chain, wide", 13, 9, 10, 64, 300)]


@pytest.mark.parametrize("kind", sorted(NONFINITE))
@pytest.mark.parametrize("forest", NONFINITE_FORESTS,
                         ids=[c[0] for c in NONFINITE_FORESTS])
def test_leaf_sums_spread_non_finite_stats_as_plain(cuda, forest, kind):
    """NaN and +-Inf stats, in one leaf or two, and on a row whose chain
    slot leaves the table: the plain version's NaN cells, every other
    cell's bits (integer-valued stats), and the kernels' order."""
    tag, d, T, depth, W, nb = forest
    rng = np.random.RandomState(len(kind) + d + T)
    f = (random_heap(rng, 3001, d, T, depth, 1, nb) if W is None
         else random_chain(rng, 3001, d, T, depth, W, 1, nb))
    if W is not None:
        f["base"][0, depth - 1, ::2] = W + 5   # slots past the leaves
    f = _on(cuda, f)
    aug = torch.from_numpy(rng.randint(-3, 4, (3001, 3)).astype(np.float32))
    aug = _spoil(aug, kind, rng, np.arange(3001), [1]).to(cuda)
    got = _sums_cuda(f, aug, depth, W, nb)
    want = _sums_plain(f, aug, depth, W, nb)
    L = want.shape[1]
    _same_or_nan(got, want)
    _same_or_nan(got, _chunked(_ids(f, depth, W, nb).cpu(), aug, L))


@pytest.mark.parametrize("kind", ["nan, reached", "nan, reached by no row",
                                  "+inf", "-inf", "+inf/-inf"])
@pytest.mark.parametrize("forest", NONFINITE_FORESTS,
                         ids=[c[0] for c in NONFINITE_FORESTS])
def test_predict_spreads_non_finite_leaves_as_plain(cuda, forest, kind):
    """A NaN leaf that rows reach or that none reaches, +-Inf leaves: the
    plain version's NaN rows, every other row's bits (integer-valued
    leaves), ids exact."""
    tag, d, T, depth, W, nb = forest
    rng = np.random.RandomState(len(kind) + d + T)
    f = (random_heap(rng, 3001, d, T, depth, 2, nb) if W is None
         else random_chain(rng, 3001, d, T, depth, W, 2, nb))
    f["leaf"] = rng.randint(-3, 4, f["leaf"].shape).astype(np.float32)
    t_last = T - 1
    if W is None:                # the last tree's right half: no row
        f["bins"][t_last, 0] = nb
    else:                        # the last tree's last slot: no row
        f["base"][t_last, depth - 1] %= min(2 ** depth, W) - 2
    f = _on(cuda, f)
    ids = _ids(f, depth, W, nb)
    leaf = f["leaf"]
    if kind == "nan, reached by no row":
        leaf[t_last, leaf.shape[1] - 1, 1] = float("nan")
    else:
        r = int(torch.nonzero((ids < leaf.shape[1]).all(1))[0, 0])
        v = {"nan, reached": [float("nan")], "+inf": [float("inf")],
             "-inf": [-float("inf")],
             "+inf/-inf": [float("inf"), -float("inf")]}[kind]
        leaf[0, int(ids[r, 0]), 1] = v[0]
        if len(v) > 1:           # one tree: another leaf of it
            leaf[t_last, (int(ids[r, t_last]) + (T == 1)) % leaf.shape[1],
                 1] = v[1]
    if W is None:
        args = (f["codes"], f["feat"], f["bins"], leaf)
        got, got_ids = F.forest_predict_heap_cuda(*args, depth=depth,
                                                  n_bins=nb, with_ids=True)
        want = F.forest_predict_plain(*args, depth=depth, n_bins=nb)
    else:
        args = (f["codes"], f["feat"], f["bins"], f["base"], leaf)
        got, got_ids = F.forest_predict_chain_cuda(*args, n_bins=nb,
                                                   with_ids=True)
        want = F.forest_predict_chain_plain(*args, n_bins=nb)
    assert torch.equal(got_ids, ids)
    assert bool(torch.isnan(want[:, 1]).any())
    _same_or_nan(got, want)


@pytest.mark.parametrize("M,d,nb,k", [(1, 1, 2, 1), (5, 3, 16, 3),
                                      (64, 64, 32, 3), (7, 5, 37, 2)])
def test_cumsum_bins_on_the_card_adds_in_the_cpu_order(cuda, M, d, nb, k):
    """The grower's bins cumsum takes ``torch.cumsum`` on the card; it must
    give the bits of the float32 adds spelled out on the CPU (XLA's order)
    on fractional stats, where another order would round differently."""
    from transmogrifai_tpu_torch.models import trees as TR
    rng = np.random.RandomState(M * 100 + nb)
    x = torch.from_numpy((rng.randn(M, d, nb, k) * 10).astype(np.float32))
    assert torch.equal(TR._cumsum_bins(x.to(cuda)).cpu(), TR._cumsum_bins(x))


TINY_TRAINS = {
    "rfreg": ("OpRandomForestRegressor",
              {"maxDepth": 12, "numTrees": 4, "minInstancesPerNode": 5,
               "minInfoGain": 0.001, "subsamplingRate": 1.0}),
    "gbtreg": ("OpGBTRegressor",
               {"maxDepth": 3, "maxIter": 5, "stepSize": 0.1,
                "minInstancesPerNode": 5, "minInfoGain": 0.001}),
    "rfmc": ("OpRandomForestClassifier",
             {"maxDepth": 12, "numTrees": 4, "minInstancesPerNode": 5,
              "minInfoGain": 0.001, "subsamplingRate": 1.0}),
    "xgbmc": ("OpXGBoostClassifier",
              {"maxDepth": 3, "maxIter": 5, "stepSize": 0.3,
               "minChildWeight": 1.0, "lambda": 1.0, "minInfoGain": 0.0,
               "minInstancesPerNode": 0.0}),
    "gbt": ("OpGBTClassifier",
            {"maxDepth": 3, "maxIter": 5, "stepSize": 0.1,
             "minInstancesPerNode": 5, "minInfoGain": 0.001}),
    "gbt12": ("OpGBTClassifier",
              {"maxDepth": 12, "maxIter": 4, "stepSize": 0.3,
               "minInstancesPerNode": 5, "minInfoGain": 0.001}),
    "rf": ("OpRandomForestClassifier",
           {"maxDepth": 12, "numTrees": 4, "minInstancesPerNode": 5,
            "minInfoGain": 0.001, "subsamplingRate": 1.0}),
    "dt": ("OpDecisionTreeClassifier",
           {"maxDepth": 6, "minInstancesPerNode": 5, "minInfoGain": 0.001}),
}
#: kernels each tiny train must launch, and table keys compared; the deep
#: GBT grows 12 levels in each of its 4 refit rounds
TINY_KERNELS = {
    "gbt": ((HK.HIST_MATMUL, 5), (HK.NODE_HIST, 5 * 3)),
    "gbt12": ((HK.HIST_MATMUL, 4), (HK.NODE_HIST, 4 * 12),
              (F.FOREST_PREDICT_CHAIN, 1)),
    "rf": ((HK.HIST_MATMUL, 1), (HK.NODE_HIST, 12),
           (F.FOREST_LEAF_SUMS_CHAIN, 1), (F.FOREST_PREDICT_CHAIN, 1)),
    "dt": ((HK.HIST_MATMUL, 1), (HK.NODE_HIST, 6),
           (F.FOREST_LEAF_SUMS_HEAP, 1), (F.FOREST_PREDICT_HEAP, 1)),
    "rfreg": ((HK.HIST_MATMUL, 1), (HK.NODE_HIST, 12),
              (F.FOREST_LEAF_SUMS_CHAIN, 1), (F.FOREST_PREDICT_CHAIN, 1)),
    "gbtreg": ((HK.HIST_MATMUL, 5), (HK.NODE_HIST, 5 * 3),
               (F.FOREST_PREDICT_HEAP, 1)),
    "rfmc": ((HK.HIST_MATMUL, 1), (HK.NODE_HIST, 12),
             (F.FOREST_LEAF_SUMS_CHAIN, 1), (F.FOREST_PREDICT_CHAIN, 1)),
    "xgbmc": ((HK.HIST_MATMUL, 5), (HK.NODE_HIST, 5 * 3),
              (F.FOREST_PREDICT_HEAP, 1)),
}
#: each tiny train's problem kind (its frame's label and selector)
TINY_TASKS = {"rfreg": "regression", "gbtreg": "regression",
              "rfmc": "multiclass", "xgbmc": "multiclass"}
TINY_TABLES = {
    "gbt": ("edges", "feat", "bins"),
    "gbt12": ("edges", "feat_lv", "bins_lv", "base_lv"),
    "rf": ("edges", "feat_lv", "bins_lv", "base_lv"),
    "dt": ("edges", "feat", "bins"),
    "rfreg": ("edges", "feat_lv", "bins_lv", "base_lv"),
    "gbtreg": ("edges", "feat", "bins", "f0"),
    "rfmc": ("edges", "feat_lv", "bins_lv", "base_lv"),
    "xgbmc": ("edges", "feat", "bins"),
}


@pytest.mark.parametrize("key", sorted(TINY_TRAINS))
def test_tiny_train_on_the_card_matches_the_cpu(cuda, key):
    family, hyper = TINY_TRAINS[key]
    task = TINY_TASKS.get(key, "binary")
    data = serve_bench_data(400, 5, seed=3, task=task)
    cpu = serve_bench_workflow(family, hyper, 5, seed=3, realnn=2,
                               device="cpu", problem=task
                               ).set_input_dataset(data).train()
    before = [kern.launches for kern, _ in TINY_KERNELS[key]]
    gpu = serve_bench_workflow(family, hyper, 5, seed=3, realnn=2,
                               device=cuda, problem=task
                               ).set_input_dataset(data).train()
    for (kern, least), b in zip(TINY_KERNELS[key], before):
        assert kern.launches >= b + least, kern.name
    cp, gp = cpu.stages[-1].fitted.params, gpu.stages[-1].fitted.params
    for k in TINY_TABLES[key]:
        assert torch.equal(gp[k].cpu(), cp[k]), k
    torch.testing.assert_close(gp["leaf"].cpu(), cp["leaf"], rtol=0,
                               atol=1e-6)
    assert gpu.stages[-2].keep_indices == cpu.stages[-2].keep_indices
    np.testing.assert_allclose(
        gpu.stages[-1].summary.validation_results[0].fold_metrics,
        cpu.stages[-1].summary.validation_results[0].fold_metrics,
        rtol=0, atol=1e-5)
    frame = {k: v for k, v in data.items() if k != "y"}
    p_cpu, p_gpu = (m.score(data=frame)[m.result_features[0].name]
                    .values[:, -1].cpu() for m in (cpu, gpu))
    torch.testing.assert_close(p_gpu, p_cpu, rtol=0, atol=1e-5)


def _node_case(dev, seed, S, d, T, Wl, stride, nb=32, k=3):
    """Codes with sentinels, node values that add nothing (negative, odd
    under stride 2, past stride * Wl) among the slots, [0, 1) stats and
    integer-valued stats, on the card."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, nb + 1, (S, d)).astype(np.int32)
    node = rng.randint(-2, stride * Wl + 2, (S, T)).astype(np.int64)
    sw = [torch.from_numpy(rng.rand(S, T).astype(np.float32)).to(dev)
          for _ in range(k)]
    sw_i = [torch.from_numpy(rng.randint(-4, 5, (S, T)).astype(
        np.float32)).to(dev) for _ in range(k)]
    return (torch.from_numpy(codes).to(dev), torch.from_numpy(node).to(dev),
            sw, sw_i)


def _node_hist_kernel(codes, node, sw, Wl, nb, stride, **kw):
    out = HK.node_hist_cuda(codes, node, sw, Wl, nb, stride, **kw)
    return out.reshape(len(sw) * Wl * node.shape[1], codes.shape[1] * nb)


#: odd shapes: S prime, d 9, T 1 and 130, stride 1 and 2, the refit
#: shape of a deep GBT level (T 1, Wl 256), slots of many chunks, d not a
#: multiple of 4 (codes staged 4 bytes a thread), five stats (two launch
#: groups over one sort); d 16 over 2 and 3 trees stages the codes as
#: bytes, while one tree (d 64) and 300 bins keep them int32; the rfmc
#: refit's deepest level (T 50, Wl 256, six class counts: two stat
#: groups) on fewer rows, and the xgbmc refit's level 5 (T 6, one tree a
#: class, stride 2)
NODE_CASES = [(509, 9, 1, 1, 1, 11), (509, 9, 1, 6, 2, 11),
              (509, 9, 130, 5, 1, 11), (509, 9, 130, 4, 2, 11),
              (1031, 7, 3, 17, 2, 37), (2003, 64, 1, 256, 1, 32),
              (5003, 9, 2, 1, 1, 11), (4099, 16, 3, 3, 2, 32),
              (1500, 13, 4, 9, 1, 32, 5), (700, 16, 2, 5, 2, 300),
              (2003, 64, 50, 256, 1, 32, 6), (4099, 64, 6, 16, 2, 32)]


@pytest.mark.parametrize("case", NODE_CASES)
def test_node_hist_kernel_matches_plain_and_direct(cuda, case):
    S, d, T, Wl, stride, nb, *k = case
    codes, node, sw, sw_i = _node_case(cuda, S + T + Wl, S, d, T, Wl,
                                       stride, nb, *k)
    before = HK.NODE_HIST.launches
    got = _node_hist_kernel(codes, node, sw, Wl, nb, stride)
    assert HK.NODE_HIST.launches == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, HK.node_hist_plain(codes, node, sw, Wl, nb, stride), rtol=RTOL,
        atol=ATOL)
    # the direct formula adds the rows in the kernel's order: same bits
    direct = HK.node_hist_direct(codes.cpu(), node.cpu(),
                                 [s.cpu() for s in sw], Wl, nb, stride)
    assert torch.equal(got.cpu(), direct)
    # integer-valued stats sum exactly; reruns give the same bits
    got_i = _node_hist_kernel(codes, node, sw_i, Wl, nb, stride)
    assert torch.equal(got_i, HK.node_hist_plain(codes, node, sw_i, Wl, nb,
                                                 stride))
    assert torch.equal(got, _node_hist_kernel(codes, node, sw, Wl, nb,
                                              stride))


#: the Titanic vector's widths (~570 codes: ``transmogrify`` of the
#: Titanic features) and odd widths on both sides of the points where
#: pass B's staged rows R halve to fit its shared memory (front 2 R (d/4 +
#: kg) ints beside nb x threads bins in 48 KB), one tree and many, codes as
#: bytes (two trees or more) and as int32 (one tree)
WIDE_NODE_CASES = [(2003, d, T, Wl, stride) for d in (
    95, 97, 191, 193, 255, 257, 383, 385, 511, 513, 569, 570, 571, 575,
    767, 769, 1023, 1025) for T, Wl, stride in ((1, 16, 2), (3, 64, 1))]


@pytest.mark.parametrize("case", WIDE_NODE_CASES)
def test_node_hist_at_the_titanic_widths(cuda, case):
    """Bit-equal to the direct formula (rows in the kernel's order), close
    to plain, exact on integer-valued stats: at widths where each block
    stages one row or a few."""
    S, d, T, Wl, stride = case
    codes, node, sw, sw_i = _node_case(cuda, S + d + T, S, d, T, Wl, stride)
    got = _node_hist_kernel(codes, node, sw, Wl, 32, stride)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), HK.node_hist_direct(
        codes.cpu(), node.cpu(), [s.cpu() for s in sw], Wl, 32, stride))
    torch.testing.assert_close(
        got, HK.node_hist_plain(codes, node, sw, Wl, 32, stride), rtol=RTOL,
        atol=ATOL)
    assert torch.equal(_node_hist_kernel(codes, node, sw_i, Wl, 32, stride),
                       HK.node_hist_plain(codes, node, sw_i, Wl, 32, stride))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("S,d,B,nb", [(13001, 570, 192, 32),
                                      (4099, 571, 128, 64),
                                      (2003, 1025, 3, 32)])
def test_hist_kernel_at_the_titanic_widths(cuda, exact, S, d, B, nb):
    """The grid flattens the features into grid.x: a ~570-wide call
    launches more blocks, each as at 64 features."""
    codes, A, A_int = _hist_inputs(cuda, S + d, S, d, B, nb)
    got = HK.hist_matmul_cuda(codes, A, nb, exact)
    torch.testing.assert_close(got, HK.hist_matmul_plain(codes, A, nb, exact),
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(HK.hist_matmul_cuda(codes, A_int, nb, exact),
                       HK.hist_matmul_plain(codes, A_int, nb, exact))


def test_chain_predict_at_the_titanic_width(cuda):
    rng = np.random.RandomState(31)
    f = _on(cuda, random_chain(rng, 20000, 571, 50, 12, 256, 1, 32))
    args = (f["codes"], f["feat"], f["bins"], f["base"], f["leaf"])
    got, ids = F.forest_predict_chain_cuda(*args, n_bins=32, with_ids=True)
    assert torch.equal(ids, F.route_codes_chain(*args[:4], 32))
    assert torch.equal(got, F.forest_predict_chain_plain(*args, n_bins=32))


@pytest.mark.parametrize("threads,warps,tile,stage", [
    (32, 1, 1, 1), (64, 3, 100, 7), (96, 32, 4096, 32), (1024, 8, 333, 2)])
def test_node_hist_bits_do_not_depend_on_the_launch(cuda, threads, warps,
                                                    tile, stage):
    """Pass B's block size (pairs beyond it run in further groups) and
    staged sub-tile, and pass A's tile rows and warp count change no
    bit."""
    codes, node, sw, _ = _node_case(cuda, 21, 3001, 40, 7, 64, 2)
    want = _node_hist_kernel(codes, node, sw, 64, 32, 2)
    got = _node_hist_kernel(codes, node, sw, 64, 32, 2, threads=threads,
                            sort_warps=warps, tile_rows=tile,
                            stage_rows=stage)
    assert torch.equal(got, want)


@pytest.mark.parametrize("Wl", [1, 2])
def test_node_hist_one_slot_holds_every_row(cuda, Wl):
    """A single tree's first level: every row in slot 0, a segment of many
    chunks, bit-equal to the direct formula."""
    codes, _, sw, sw_i = _node_case(cuda, 24, 4000, 16, 1, Wl, 1)
    node = torch.zeros((4000, 1), dtype=torch.int64, device=cuda)
    got = _node_hist_kernel(codes, node, sw, Wl, 32, 1)
    assert torch.equal(got.cpu(), HK.node_hist_direct(
        codes.cpu(), node.cpu(), [s.cpu() for s in sw], Wl, 32))
    assert torch.equal(_node_hist_kernel(codes, node, sw_i, Wl, 32, 1),
                       HK.node_hist_plain(codes, node, sw_i, Wl, 32))


def test_node_hist_reads_the_growers_tensors_in_place(cuda, monkeypatch):
    """An int64 node and f32 stats reach the kernel as they are: the
    wrapper copies none of them."""
    codes, node, sw, _ = _node_case(cuda, 25, 900, 8, 3, 16, 2)
    seen = []
    launch = HK.NODE_HIST.launch

    def spy(*args):
        seen.append(args[1])
        launch(*args)

    monkeypatch.setattr(HK.NODE_HIST, "launch", spy)
    got = HK.node_hist_matmul(codes, node, sw, 16, 32, stride=2)
    assert seen == [node.data_ptr()]
    assert torch.equal(got.cpu(), HK.node_hist_direct(
        codes.cpu(), node.cpu(), [s.cpu() for s in sw], 16, 32, 2))


def test_node_hist_on_cuda_never_takes_the_plain_version(cuda, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the plain node histogram ran on the card")

    monkeypatch.setattr(HK, "node_hist_plain", refuse)
    monkeypatch.setattr(HK, "_hist_pinned", refuse)
    codes, node, sw, _ = _node_case(cuda, 22, 700, 5, 4, 8, 1)
    before = HK.NODE_HIST.launches
    got = HK.node_hist_matmul(codes, node, sw, 8, 32)
    assert HK.NODE_HIST.launches == before + 1
    assert torch.equal(got, _node_hist_kernel(codes, node, sw, 8, 32, 1))


def test_node_hist_refuses_a_short_workspace(cuda):
    """The source lays out its workspaces and says their sizes; a launch
    given less is refused, not run past the end."""
    codes, node, sw, _ = _node_case(cuda, 26, 300, 8, 2, 4, 1)
    S, d, T, Wl, tile = 300, 8, 2, 4, 256
    n_int, n_float = HK.node_hist_workspace(S, d, T, 3, Wl, 32, tile)
    iws = torch.empty(n_int, dtype=torch.int32, device=cuda)
    fws = torch.empty(n_float, dtype=torch.float32, device=cuda)
    out = torch.empty((3, Wl, T, d, 32), device=cuda)
    sws = (ctypes.c_void_p * 3)(*(s.data_ptr() for s in sw))
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for ni, nf in ((n_int - 1, n_float), (n_int, n_float - 1)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            HK.NODE_HIST.launch(
                codes.data_ptr(), node.data_ptr(),
                ctypes.cast(sws, ctypes.c_void_p), iws.data_ptr(),
                fws.data_ptr(), out.data_ptr(), ni, nf, S, d, T, 3, Wl, 32, 1,
                HK.NODE_HIST_CHUNK, 256, tile, 8, 32,
                torch.cuda.current_device(), stream)


def test_node_hist_empty_and_bad_inputs(cuda):
    codes, node, sw, _ = _node_case(cuda, 23, 0, 3, 2, 4, 1)
    assert torch.equal(HK.node_hist_cuda(codes, node, sw, 4, 32),
                       torch.zeros((3, 4, 2, 3, 32), device=cuda))
    codes, node, sw, _ = _node_case(cuda, 23, 50, 3, 2, 4, 1)
    with pytest.raises(TypeError):
        HK.node_hist_cuda(codes, node.int(), sw, 4, 32)   # int32 node
    with pytest.raises(ValueError):
        HK.node_hist_cuda(codes, node, [s.T for s in sw], 4, 32)
    with pytest.raises(ValueError):
        HK.node_hist_cuda(codes, node, sw, 4, 32, stride=3)
    with pytest.raises(ValueError):
        HK.node_hist_cuda(codes, node.cpu(), sw, 4, 32)
    with pytest.raises(RuntimeError, match="CUDA error"):
        HK.node_hist_cuda(codes, node, sw, 4, 32,
                          threads=48)                # not a warp multiple


# ---------------------------------------------------------------------------
# the linear families and GLM on the card
# ---------------------------------------------------------------------------

#: (family, problem kind, num_classes) of each linear fit case
LINEAR_CASES = [("OpLogisticRegression", "binary", 2),
                ("OpLogisticRegression", "multiclass", 3),
                ("OpLinearSVC", "binary", 2),
                ("OpNaiveBayes", "multiclass", 3),
                ("OpLinearRegression", "regression", 1),
                ("OpGeneralizedLinearRegression", "regression", 1)]
#: card against CPU: f32 fits' params within this share of the largest
#: param (cuBLAS adds in another order than the CPU; the GLM's log-link
#: configurations within LINEAR_SWEEP_RTOL: their IRLS weights exp(eta)
#: amplify rounding step by step), bf16 sweep fits' within
#: LINEAR_SWEEP_RTOL (a product that rounds to bf16 across a boundary on
#: one device and not the other moves the fit), predictions within
#: LINEAR_PRED_TOL
LINEAR_RTOL = 1e-4
LINEAR_SWEEP_RTOL = 1e-3
LINEAR_PRED_TOL = 1e-5


def _linear_case(family, problem, num_classes, seed=0):
    """X (512, 6) with a x100 and an offset column, the label of
    ``problem``, three folds' 0/1 train weights x the family's default
    grid, as the validator lays them out."""
    from transmogrifai_tpu_torch.models import glm, linear  # noqa: F401
    from transmogrifai_tpu_torch.models.api import MODEL_REGISTRY
    fam = MODEL_REGISTRY[family]
    rng = np.random.RandomState(seed)
    X = rng.randn(512, 6).astype(np.float32)
    if problem == "binary":
        y = (X @ rng.randn(6) + 0.5 * rng.randn(512) > 0)
    elif problem == "multiclass":
        y = np.argmax(X[:, :3] + 0.5 * rng.randn(512, 3), 1)
    else:
        y = X @ rng.randn(6) * 0.3 + 0.1 * rng.randn(512)
        if family == "OpGeneralizedLinearRegression":
            y = np.exp(y)
    if family != "OpGeneralizedLinearRegression":
        X[:, 2] *= 100.0
        X[:, 3] += 5.0
    folds = rng.permutation(512) % 3
    grid = fam.default_grid(problem)
    W = np.repeat(np.stack([folds != f for f in range(3)]), len(grid), 0)
    garr = {k: np.tile(v, 3) for k, v in fam.grid_to_arrays(grid).items()}
    return fam, X, y.astype(np.float32), W.astype(np.float32), garr


def _linear_fits(fam, X, y, W, garr, num_classes, dev):
    """(fit_batch params, sweep_fit_batch params, predict_batch scores) on
    ``dev``, brought to the CPU."""
    args = [torch.from_numpy(a).to(dev) for a in (X, y, W)]
    refit = fam.fit_batch(*args, garr, num_classes)
    sweep = fam.sweep_fit_batch(*args, garr, num_classes)
    scores = fam.predict_batch(refit, args[0], num_classes)
    return ({k: v.cpu() for k, v in refit.items()},
            {k: v.cpu() for k, v in sweep.items()}, scores.cpu())


def _rel_gap(got, want):
    scale = max(float(v.abs().max()) for v in want.values())
    return max(float((got[k] - want[k]).abs().max()) for k in want) / scale


@pytest.mark.parametrize("family,problem,num_classes", LINEAR_CASES)
def test_linear_fits_on_the_card_match_the_cpu(cuda, family, problem,
                                               num_classes):
    fam, X, y, W, garr = _linear_case(family, problem, num_classes)
    before = [k.launches for k in HK.KERNELS + F.KERNELS]
    g_refit, g_sweep, g_scores = _linear_fits(fam, X, y, W, garr,
                                              num_classes, cuda)
    assert [k.launches for k in HK.KERNELS + F.KERNELS] == before
    c_refit, c_sweep, c_scores = _linear_fits(fam, X, y, W, garr,
                                              num_classes, "cpu")
    if "b" in c_refit:              # a softmax's common bias shift is free
        for p in (g_refit, c_refit, g_sweep, c_sweep):
            p["b"] = p["b"] - p["b"].mean(-1, keepdim=True)
    assert _rel_gap(g_refit, c_refit) < (
        LINEAR_SWEEP_RTOL if family == "OpGeneralizedLinearRegression"
        else LINEAR_RTOL)
    assert _rel_gap(g_sweep, c_sweep) < LINEAR_SWEEP_RTOL
    torch.testing.assert_close(g_scores, c_scores, rtol=LINEAR_PRED_TOL,
                               atol=LINEAR_PRED_TOL)


@pytest.mark.parametrize("family,problem,num_classes", LINEAR_CASES)
def test_linear_fits_ignore_the_global_tf32_switch(cuda, family, problem,
                                                   num_classes):
    """The families turn TF32 off around their own products: a caller's
    global ``allow_tf32 = True`` changes no bit of a fit or a predict."""
    fam, X, y, W, garr = _linear_case(family, problem, num_classes, seed=1)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = _linear_fits(fam, X, y, W, garr, num_classes, cuda)
        torch.backends.cuda.matmul.allow_tf32 = True
        on = _linear_fits(fam, X, y, W, garr, num_classes, cuda)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for a, b in zip(on[:2], off[:2]):
        for k in b:
            assert torch.equal(a[k], b[k]), k
    assert torch.equal(on[2], off[2])


@pytest.mark.parametrize("key", ["lr", "svc", "lrmc", "nbmc", "linreg",
                                 "glm"])
def test_tiny_linear_train_on_the_card_matches_the_cpu(cuda, key):
    from transmogrifai_tpu_torch.testing import SERVE_MODELS
    family, hyper, task = SERVE_MODELS[key]
    data = serve_bench_data(400, 5, seed=3, task=task)
    cpu, gpu = (serve_bench_workflow(family, hyper, 5, seed=3, realnn=2,
                                     device=dev, problem=task
                                     ).set_input_dataset(data).train()
                for dev in ("cpu", cuda))
    cs, gs = cpu.stages[-1], gpu.stages[-1]
    assert gs.fitted.family == cs.fitted.family == family
    params = {k: v.cpu() for k, v in gs.fitted.params.items()}
    assert _rel_gap(params, cs.fitted.params) < LINEAR_RTOL
    np.testing.assert_allclose(gs.summary.validation_results[0].fold_metrics,
                               cs.summary.validation_results[0].fold_metrics,
                               rtol=LINEAR_SWEEP_RTOL, atol=2e-4)
    frame = {k: v for k, v in data.items() if k != "y"}
    p_cpu, p_gpu = (m.score(data=frame)[m.result_features[0].name]
                    .values[:, -1].cpu() for m in (cpu, gpu))
    torch.testing.assert_close(p_gpu, p_cpu, rtol=LINEAR_PRED_TOL,
                               atol=LINEAR_PRED_TOL)


# ---------------------------------------------------------------------------
# saving on the card; the MLP family on the card
# ---------------------------------------------------------------------------

#: the MLP on the card against the CPU: weights within MLP_RTOL of each
#: table's largest |weight| and probabilities within MLP_PROB_TOL. cuBLAS
#: adds the float32 products in another order, and Adam's division by
#: sqrt(v) lets rounding-level gradients move weights by a share of the
#: step (the port against the JAX package on the CPU, the same cause:
#: 5.7e-4 and 6.9e-5 on the serve bench's binary frame,
#: ``chip_smoke.MLP_COEF_RTOL``)
MLP_RTOL = 6e-3
MLP_PROB_TOL = 7e-4


@pytest.mark.parametrize("key,family,hyper,task", [
    ("gbt", "OpGBTClassifier", {"maxDepth": 3, "maxIter": 5}, "binary"),
    ("rf", "OpRandomForestClassifier", {"maxDepth": 12, "numTrees": 4},
     "binary"),
    ("lr", "OpLogisticRegression", {"regParam": 0.01}, "binary"),
    ("xgbmc", "OpXGBoostClassifier", {"maxDepth": 3, "maxIter": 5},
     "multiclass"),
    ("mlp", "OpMultilayerPerceptronClassifier",
     {"hiddenLayer1": 8, "hiddenLayer2": 8, "stepSize": 0.05}, "binary"),
])
def test_a_card_train_saves_and_reloads_bit_for_bit(cuda, tmp_path, key,
                                                     family, hyper, task):
    import transmogrifai_tpu_torch as tt
    data = serve_bench_data(400, 5, seed=3, task=task)
    model = serve_bench_workflow(family, hyper, 5, seed=3, device=cuda,
                                 problem=task).set_input_dataset(data).train()
    tt.save_model(model, str(tmp_path / key))
    again = tt.load_model(str(tmp_path / key))
    assert again.device.type == "cuda"
    frame = {k: v for k, v in data.items() if k != "y"}
    a, b = (m.score(data=frame)[m.result_features[0].name].values
            for m in (model, again))
    assert a.device.type == "cuda" and torch.equal(a, b)


@pytest.mark.parametrize("classes,grid", [
    (2, [{"hiddenLayer1": h, "hiddenLayer2": h, "stepSize": 0.05}
         for h in (10, 50, 100)]),
    (3, [{"hiddenLayer1": 16, "hiddenLayer2": 8, "stepSize": 0.05}]),
])
def test_mlp_fit_on_the_card_matches_the_cpu(cuda, classes, grid):
    from transmogrifai_tpu_torch.models import mlp
    from transmogrifai_tpu_torch.models.api import MODEL_REGISTRY
    fam = MODEL_REGISTRY["OpMultilayerPerceptronClassifier"]
    rng = np.random.RandomState(classes)
    centers = rng.randn(classes, 4) * 3
    y = rng.randint(0, classes, 300)
    X = (centers[y] + rng.randn(300, 4)).astype(np.float32)
    W = np.ones((len(grid), 300), np.float32)
    W[:, ::7] = 0.0
    before = [k.launches for k in HK.KERNELS + F.KERNELS]
    fits = {}
    for dev in ("cpu", cuda):
        args = [torch.from_numpy(a).to(dev) for a in (
            X, y.astype(np.float32), W)]
        p = fam.fit_batch(*args, fam.grid_to_arrays(grid), classes)
        fits[str(dev)] = (p, fam.predict_batch(p, args[0], classes).cpu())
    assert [k.launches for k in HK.KERNELS + F.KERNELS] == before
    (cp, cs), (gp, gs) = fits["cpu"], fits[str(cuda)]
    # the initial weights are the same bits on either device
    init = mlp._init(torch.tensor([42], device=cuda, dtype=torch.int32),
                     4, 16, 3)
    for a, b in zip(init, mlp._init(torch.tensor([42], dtype=torch.int32),
                                    4, 16, 3)):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(gp["masks"], cp["masks"]):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(gp["params"], cp["params"]):
        assert float((a.cpu() - b).abs().max()) <= MLP_RTOL * float(
            b.abs().max())
    torch.testing.assert_close(gs, cs, rtol=0, atol=MLP_PROB_TOL)


def _filter_frame(n=20000, seed=3):
    """A table of null patterns (one column nearly the label's) and a
    label, and three numeric columns on a device with their shifts."""
    rng = np.random.RandomState(seed)
    y = (rng.rand(n) < 0.4).astype(np.float32)
    V = (rng.randn(n, 3) * [1.0, 30.0, 1e4]).astype(np.float32)
    M = rng.rand(n, 3) > [0.0, 0.2, 0.7]
    M[:, 2] |= y > 0.5
    return y, V, M, np.array([0.0, 12.5, -3e3])


@pytest.mark.parametrize("correlation_type", ["pearson", "spearman"])
def test_filter_null_label_correlations_on_the_card_match_the_cpu(
        cuda, correlation_type):
    """The raw feature filter's null-label pass on the card against the
    same call on the CPU: float32 sums in another order, within the
    probabilistic bound 2 * 8 sqrt(n) 2^-24 (1.35e-4 at 20,000 rows)."""
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.filters import RawFeatureFilter
    from transmogrifai_tpu_torch.table import Column, FeatureTable
    from transmogrifai_tpu_torch.types import Real, RealNN
    y, V, M, _ = _filter_frame()
    feats = [FeatureBuilder.RealNN("y").extract_field().as_response()] + [
        FeatureBuilder.Real(f"x{j}").extract_field().as_predictor()
        for j in range(3)]
    table = FeatureTable(dict(
        y=Column(RealNN, y, None),
        **{f"x{j}": Column(Real, V[:, j], M[:, j]) for j in range(3)}),
        len(y))
    dists = {f.name: [] for f in feats[1:]}
    out = {}
    for dev in ("cpu", cuda):
        rff = RawFeatureFilter(correlation_type=correlation_type, device=dev)
        out[str(dev)] = rff._null_label_correlations(table, feats,
                                                     table["y"], dists)
    got, want = out[str(cuda)], out["cpu"]
    assert sorted(got) == sorted(want) == ["x0", "x1", "x2"]
    bound = 2 * 8 * np.sqrt(len(y)) * 2.0 ** -24
    # x0 is never null: its indicator is constant, a 0/0 correlation, NaN
    # on the CPU; the card's ranks of it may keep float32 noise instead
    assert np.isnan(want["x0"])
    assert np.isnan(got["x0"]) or abs(got["x0"]) <= bound, got["x0"]
    for k in ("x1", "x2"):
        assert abs(got[k] - want[k]) <= bound, (k, got[k], want[k])
    assert abs(want["x2"]) > 0.5


def test_filter_with_no_device_runs_on_the_card(cuda, monkeypatch):
    """A filter given no device (``resolve_device``) runs its null-label
    pass on the card, and ``filter_raw`` gives the CPU's results within
    the bound above."""
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.filters import RawFeatureFilter
    from transmogrifai_tpu_torch.ops import stats
    from transmogrifai_tpu_torch.table import Column, FeatureTable
    from transmogrifai_tpu_torch.types import Real, RealNN
    y, V, M, _ = _filter_frame()
    feats = [FeatureBuilder.RealNN("y").extract_field().as_response()] + [
        FeatureBuilder.Real(f"x{j}").extract_field().as_predictor()
        for j in range(3)]
    table = FeatureTable(dict(
        y=Column(RealNN, y, None),
        **{f"x{j}": Column(Real, V[:, j], M[:, j]) for j in range(3)}),
        len(y))
    seen = []
    pearson = stats.pearson_correlation

    def on(X, yd):
        seen.append((X.device.type, yd.device.type))
        return pearson(X, yd)
    monkeypatch.setattr(stats, "pearson_correlation", on)
    _, _, got = RawFeatureFilter().filter_raw(table, feats)
    _, _, want = RawFeatureFilter(device="cpu").filter_raw(table, feats)
    assert seen == [("cuda", "cuda"), ("cpu", "cpu")]
    bound = 2 * 8 * np.sqrt(len(y)) * 2.0 ** -24
    for g, w in zip(got.metrics, want.metrics):
        assert (g.name, g.exclusion_reasons) == (w.name, w.exclusion_reasons)
        gc, wc = g.null_label_correlation, w.null_label_correlation
        assert (np.isnan(wc) and (np.isnan(gc) or abs(gc) <= bound)) or \
            abs(gc - wc) <= bound, (g.name, gc, wc)


def test_leads_vector_on_the_card_equals_the_cpu(cuda):
    """The lead-conversion vector (dates, a date list, a geolocation and
    nine maps through ``transmogrify``) fitted and built with the table on
    the card equals the one built on the CPU, bit for bit, with the same
    metadata; every block of it lands on the table's device."""
    import dataclasses
    from transmogrifai_tpu_torch.dag import (
        compute_dag, fit_and_transform_dag,
    )
    from transmogrifai_tpu_torch.testing import (
        LEADS_CLOCK_MS, leads_records, leads_workflow,
    )
    recs = leads_records(2000, 8)
    out = []
    for dev in ("cpu", cuda):
        wf, _, _, _ = leads_workflow(recs, device=dev,
                                     clock_ms=LEADS_CLOCK_MS)
        vec_stage = next(s for s in wf.stages
                         if type(s).__name__ == "VectorsCombiner")
        table = wf.reader.generate_table(wf.raw_features).to_device(dev)
        t, _ = fit_and_transform_dag(table, compute_dag(
            [vec_stage.get_output()]))
        blocks = [t[f.name] for f in vec_stage.input_features]
        assert all(b.values.device.type == torch.device(dev).type
                   for b in blocks), [f.name for f in
                                      vec_stage.input_features]
        col = t[vec_stage.get_output().name]
        out.append((col.values.cpu().numpy(), [
            dataclasses.asdict(c)
            for c in col.metadata["vector_meta"].columns]))
    (a, ma), (b, mb) = out
    assert a.shape[1] > 600
    np.testing.assert_array_equal(a, b)
    assert ma == mb


# ---------------------------------------------------------------------------
# The NLP stages' device arithmetic: word2vec and LDA on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("skew", [0.0, 1.3])
def test_ordered_scatter_on_the_card_is_the_in_order_add(cuda, skew):
    """``xla_scatter_add`` on the card: two runs the same bits, and those
    bits numpy's ``np.add.at`` (one update after another in order)."""
    from transmogrifai_tpu_torch.ops.xla_cpu import xla_scatter_add
    r = np.random.RandomState(1)
    W = r.randn(4096, 32).astype(np.float32)
    idx = ((r.zipf(skew, 8192) if skew else r.randint(0, 4096, 8192))
           % 4096).astype(np.int64)
    u = (r.randn(8192, 32) * 1e-3).astype(np.float32)
    want = W.copy()
    np.add.at(want, idx, u)
    runs = [xla_scatter_add(torch.as_tensor(W, device=cuda),
                            torch.as_tensor(idx, device=cuda),
                            torch.as_tensor(u, device=cuda)).cpu().numpy()
            for _ in range(2)]
    np.testing.assert_array_equal(runs[0].view(np.int32),
                                  runs[1].view(np.int32))
    np.testing.assert_array_equal(runs[0].view(np.int32),
                                  want.view(np.int32))


def test_xla_functions_on_the_card_equal_the_cpu(cuda):
    from transmogrifai_tpu_torch.ops.xla_cpu import (
        _glibc_sincos, xla_digamma, xla_sigmoid,
    )
    r = np.random.RandomState(2)
    x = np.concatenate([r.uniform(0, 0.5, 20000), r.uniform(0.5, 60, 20000),
                        r.uniform(-20, 0, 5000)]).astype(np.float32)
    for fn in (xla_digamma, xla_sigmoid, lambda t: _glibc_sincos(t, True),
               lambda t: _glibc_sincos(t, False)):
        a = fn(torch.as_tensor(x, device=cuda)).cpu().numpy()
        b = fn(torch.as_tensor(x)).numpy()
        same = (a.view(np.int32) == b.view(np.int32)) | (
            np.isnan(a) & np.isnan(b))
        assert same.all()


def _stage_on(dev, cls, kw, type_name, rows):
    from transmogrifai_tpu_torch import types as T
    from transmogrifai_tpu_torch.features import FeatureBuilder, reset_uids
    from transmogrifai_tpu_torch.impl.feature import text
    from transmogrifai_tpu_torch.table import Column, FeatureTable
    reset_uids()
    ft = T.FEATURE_TYPES[type_name]
    f = FeatureBuilder("f", ft).extract_field().as_predictor()
    t = FeatureTable({"f": Column.of_values(ft, rows)}, len(rows))
    if dev != "cpu":
        t = t.to_device(dev)
    st = getattr(text, cls)(**kw).set_input(f).fit(t)
    return st, st.transform_column(t)


def test_word2vec_on_the_card_equals_the_cpu(cuda):
    """Vectors fitted on the card and the means built there bit-equal to
    the CPU's, and on the card."""
    rng = np.random.RandomState(3)
    words = [f"w{i}" for i in range(200)]
    docs = [list(rng.choice(words, rng.randint(0, 30))) for _ in range(400)]
    got = _stage_on(cuda, "OpWord2Vec", dict(vector_size=32, steps=30),
                    "TextList", docs)
    want = _stage_on("cpu", "OpWord2Vec", dict(vector_size=32, steps=30),
                     "TextList", docs)
    assert got[0].vectors.device.type == "cuda"
    assert got[1].values.device.type == "cuda"
    np.testing.assert_array_equal(got[0].vectors.cpu().numpy(),
                                  want[0].vectors.cpu().numpy())
    np.testing.assert_array_equal(got[1].values.cpu().numpy(),
                                  want[1].values.cpu().numpy())


def test_lda_on_the_card_equals_the_cpu(cuda):
    X = np.random.RandomState(4).poisson(0.3, (1500, 128)).astype(np.float32)
    rows = [list(r) for r in X]
    got = _stage_on(cuda, "OpLDA", dict(k=10, max_iter=3), "OPVector", rows)
    want = _stage_on("cpu", "OpLDA", dict(k=10, max_iter=3), "OPVector",
                     rows)
    assert got[0].topics.device.type == "cuda"
    assert got[1].values.device.type == "cuda"
    np.testing.assert_array_equal(got[0].topics.cpu().numpy(),
                                  want[0].topics.cpu().numpy())
    np.testing.assert_array_equal(got[1].values.cpu().numpy(),
                                  want[1].values.cpu().numpy())


def test_tickets_vector_on_the_card_equals_the_cpu(cuda):
    """The ticket workflow's vector (the NLP stages, word2vec and LDA on
    the card, the parsers on the host) equals the CPU's bit for bit."""
    import dataclasses
    from transmogrifai_tpu_torch.dag import (
        compute_dag, fit_and_transform_dag,
    )
    from transmogrifai_tpu_torch.testing import (
        tickets_records, tickets_workflow,
    )
    recs = tickets_records(500, 8)
    out = []
    for dev in ("cpu", cuda):
        wf, _, _, results = tickets_workflow(recs, device=dev)
        checked = results[1]
        vec = checked.origin_stage.input_features[1]
        table = wf.reader.generate_table(wf.raw_features).to_device(dev)
        t, _ = fit_and_transform_dag(table, compute_dag([vec]))
        col = t[vec.name]
        assert col.values.device.type == torch.device(dev).type
        out.append((col.values.cpu().numpy(), [
            dataclasses.asdict(c)
            for c in col.metadata["vector_meta"].columns]))
    (a, ma), (b, mb) = out
    np.testing.assert_array_equal(a, b)
    assert ma == mb


@pytest.mark.parametrize("family,hyper", [
    ("OpRandomForestClassifier", {"maxDepth": 6, "numTrees": 10}),
    ("OpGBTClassifier", {"maxDepth": 4, "maxIter": 5, "stepSize": 0.1})])
def test_loco_on_the_card_equals_the_cpu(cuda, family, hyper):
    """LOCO of a small serve-bench workflow trained on the card (variants
    built there and scored by the forest predict kernels) against the
    same workflow trained and explained on the CPU: the diffs within 1e-6
    (the trees are equal and summed in the same order), and the maps agree
    on the entries that clear it."""
    from transmogrifai_tpu_torch.insights import RecordInsightsLOCO
    from transmogrifai_tpu_torch.testing import loco_map_gaps
    data = serve_bench_data(600, 8, seed=0)
    out = []
    for dev in ("cpu", cuda):
        model = serve_bench_workflow(family, hyper, 8, seed=0, device=dev
                                     ).set_input_dataset(data).train()
        sel = next(s for s in model.stages
                   if type(s).__name__ == "SelectedModel")
        loco = RecordInsightsLOCO(sel, top_k=5).set_input(
            sel.input_features[1])
        table = model.score(data=data)
        names, diffs = loco.diffs(table)
        out.append((names, diffs, loco.transform_column(table).values))
    (names, want, cm), (gnames, got, gm) = out
    assert gnames == names
    assert np.abs(got - want).max() <= 1e-6
    for i in range(0, 600, 7):
        assert not loco_map_gaps(want[:, i], got[:, i], names, cm[i], gm[i],
                                 5, 1e-6)


class _OverwrittenSource:
    """A random-access chunk source whose host buffers the test overwrites
    once the chunk is delivered (built on the fly: a ``ChunkSource``)."""

    @staticmethod
    def make(n_chunks, rows, d, seed):
        from transmogrifai_tpu_torch.streaming.source import (
            Chunk, ChunkSource)
        from transmogrifai_tpu_torch.table import Column, FeatureTable
        from transmogrifai_tpu_torch.types import Real, RealNN

        class Source(ChunkSource):
            random_access = True

            def __init__(self):
                self.chunk_rows = rows
                self.buffers = {}

            def fingerprint(self):
                return "overwritten"

            @property
            def num_chunks(self):
                return n_chunks

            def _arrays(self, i):
                rng = np.random.RandomState(seed + i)
                return (rng.randn(rows, d).astype(np.float32),
                        rng.rand(rows, d) > 0.1,
                        rng.rand(rows).astype(np.float32))

            def read_chunk(self, i):
                X, M, y = (a.copy() for a in self._arrays(i))
                self.buffers[i] = (X, M, y)
                cols = {f"x{j}": Column(Real, X[:, j], M[:, j])
                        for j in range(d)}
                cols["y"] = Column(RealNN, y, None)
                return Chunk(i, f"c{i}", FeatureTable(cols, rows))

            def chunks(self, start=0):
                for i in range(start, n_chunks):
                    yield self.read_chunk(i)

        return Source()


class _Double:
    """A transform run on the committer's stream: a new column x0 * 2."""

    def transform(self, table):
        from transmogrifai_tpu_torch.table import Column
        from transmogrifai_tpu_torch.types import Real
        col = table["x0"]
        return table.with_column("z", Column(Real, col.values * 2.0, None))


def _bits_sum(t):
    """An exact digest of a tensor's bits on its own device."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return t.contiguous().view(torch.uint8).to(torch.int64).mul(
        torch.arange(1, t.numel() * t.element_size() + 1, device=t.device)
        % 251 + 1).sum()


def test_feed_upload_survives_overwritten_buffers_and_a_slow_consumer(cuda):
    """Many small chunks through the pinned, side-stream upload with a
    transform on the card. The source's host buffers are overwritten as
    soon as a chunk is delivered, and the consumer's stream is kept busy
    before it reads each chunk, so the chunk's blocks would be handed out
    again by the allocator if a tensor lacked ``record_stream``, and a
    staging buffer reused before its copy completed would corrupt a later
    chunk: every delivered chunk must be byte-equal to its source."""
    from transmogrifai_tpu_torch.streaming import DeviceFeed
    n_chunks, rows, d = 96, 257, 3
    src = _OverwrittenSource.make(n_chunks, rows, d, seed=5)
    digests = []
    with DeviceFeed(src, transforms=[_Double()], prefetch=3, workers=2,
                    device=cuda) as feed:
        for chunk in feed:
            for name in chunk.table.column_names:
                assert chunk.table[name].values.is_cuda
            X, M, y = src.buffers.pop(chunk.index)
            for a in (X, M, y):
                a[...] = 0          # the source's memory is reused
            torch.cuda._sleep(2_000_000)   # the consumer's stream is busy
            t = chunk.table
            digests.append([_bits_sum(t[f"x{j}"].values)
                            for j in range(d)]
                           + [_bits_sum(t[f"x{j}"].mask) for j in range(d)]
                           + [_bits_sum(t["y"].values),
                              _bits_sum(t["z"].values)])
            del chunk, t
    torch.cuda.synchronize()
    assert feed.stats.chunks == n_chunks
    assert feed.stats.peak_resident_chunks <= 4
    for i, got in enumerate(digests):
        X, M, y = src._arrays(i)
        want = [torch.from_numpy(np.ascontiguousarray(X[:, j]))
                for j in range(d)]
        want += [torch.from_numpy(np.ascontiguousarray(M[:, j]))
                 for j in range(d)]
        want += [torch.from_numpy(y),
                 torch.from_numpy(np.ascontiguousarray(X[:, 0]) * 2.0)]
        assert [int(g) for g in got] == [int(_bits_sum(w)) for w in want], i


# ---------------------------------------------------------------------------
# The serving runtime on the card (serving/runtime.py): the pipelined
# dataplane against the serial loop, the pinned staging against
# ``FeatureTable.to_device``, the predicts at flush shapes, and the linear
# models' flush-size bits
# ---------------------------------------------------------------------------

SERVE_FIXTURES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "transmogrifai_tpu_torch", "fixtures",
    "serve64")
#: flush sizes of the serving runtime: a singleton, an odd size, max_batch
FLUSH_SIZES = (1, 37, 256)


def _serve_rows(n, seed=1):
    from transmogrifai_tpu_torch.testing import request_rows, score_frame
    return request_rows(score_frame(n, 64, seed))


@pytest.mark.parametrize("key", ["gbt", "rf"])
def test_runtime_at_depth_2_on_the_card_equals_the_serial_loop(cuda, key):
    """Records at pipeline depth 2 (its own stream, pinned staging, one
    event a flush) bit-equal to depth 1's and to the micro-batch scorer's;
    the gathered device table equals ``serve_table_builder``'s moved with
    ``to_device``."""
    import transmogrifai_tpu_torch as tt
    from transmogrifai_tpu_torch.local.scoring import (
        ServeStages, micro_batch_score_function, serve_table_builder)
    from transmogrifai_tpu_torch.serving import ServeConfig, ServingRuntime
    model = tt.load_model(os.path.join(SERVE_FIXTURES, key), device=cuda)
    rows = _serve_rows(600)
    st = ServeStages(model)
    got = st.gather(rows[:256])
    want = serve_table_builder(model)(rows[:256]).to_device(cuda)
    for name in want.column_names:
        a, b = got[name], want[name]
        assert torch.equal(a.values, b.values), name
        assert (a.mask is None) == (b.mask is None)
        if a.mask is not None:
            assert torch.equal(a.mask, b.mask), name
    recs = {}
    for depth in (1, 2):
        cfg = ServeConfig(max_batch=256, max_queue=4096, max_wait_ms=2.0,
                          pipeline_depth=depth)
        with ServingRuntime(model, f"card{depth}", cfg) as rt:
            futs = [rt.submit(r) for r in rows]
            recs[depth] = [f.result(timeout=120) for f in futs]
    assert recs[2] == recs[1]
    assert recs[1] == micro_batch_score_function(model)(rows)


@pytest.mark.parametrize("n", FLUSH_SIZES)
def test_predicts_at_flush_sizes_equal_plain(cuda, n):
    """Both forest predicts at the runtime's flush sizes, at the serve64
    shapes (GBT heaps T=20 depth 6, xgbmc heaps T=600 k=6, RF chains T=50
    depth 12 W=256): bit-equal to their plain versions."""
    rng = np.random.RandomState(n)
    for T, k in ((20, 1), (600, 6)):
        h = _on(cuda, random_heap(rng, n, 64, T, 6, k, 32))
        args = (h["codes"], h["feat"], h["bins"], h["leaf"])
        got, _ = F.forest_predict_heap_cuda(*args, depth=6, n_bins=32)
        assert torch.equal(got, F.forest_predict_plain(*args, depth=6,
                                                       n_bins=32))
    c = _on(cuda, random_chain(rng, n, 64, 50, 12, 256, 1, 32))
    args = (c["codes"], c["feat"], c["bins"], c["base"], c["leaf"])
    got, _ = F.forest_predict_chain_cuda(*args, n_bins=32)
    assert torch.equal(got, F.forest_predict_chain_plain(*args, n_bins=32))


@pytest.mark.parametrize("key,part,limit", [
    ("lr", "probability_1", 1e-5), ("svc", "rawPrediction_1", 1e-5)])
def test_linear_flush_sizes_stay_within_the_serve_limit(cuda, key, part,
                                                        limit):
    """A linear model's product is one cuBLAS call a flush, whose kernel
    may change with the row count: a row's score at flush sizes 1 and 37
    stays within the serve limit of its score in a 256-row flush (a
    platform order difference, not bit-equality; ROADMAP Queue 3)."""
    import transmogrifai_tpu_torch as tt
    from transmogrifai_tpu_torch.local.scoring import (
        micro_batch_score_function)
    model = tt.load_model(os.path.join(SERVE_FIXTURES, key), device=cuda)
    mb = micro_batch_score_function(model)
    name = model.result_features[0].name
    rows = _serve_rows(256)
    full = np.asarray([r[name][part] for r in mb(rows)], np.float32)
    odd = np.asarray([r[name][part] for r in mb(rows[:37])], np.float32)
    one = np.asarray([mb([r])[0][name][part] for r in rows[:37]],
                     np.float32)
    for got in (odd, one):
        gap = np.abs(got - full[:37]) / (1 + np.abs(full[:37]))
        assert gap.max() <= limit, gap.max()


def test_fleet_on_the_card_with_a_subprocess_replica(cuda, tmp_path):
    """A front door over two in-process replicas on the card, then one
    ``SubprocessReplica`` on ``cuda:0`` beside them: records bit-equal to
    the micro-batch scorer's through the door, from the child, and after
    the child is SIGKILLed with requests in flight; the child served on
    the card with its own kernel launches."""
    import shutil

    import transmogrifai_tpu_torch as tt
    from transmogrifai_tpu_torch.local.scoring import (
        micro_batch_score_function)
    from transmogrifai_tpu_torch.serving import (
        FleetConfig, FrontDoor, ServeConfig)
    path = str(tmp_path / "gbt")
    shutil.copytree(os.path.join(SERVE_FIXTURES, "gbt"), path)
    model = tt.load_model(path, device=cuda)
    rows = _serve_rows(600)
    want = micro_batch_score_function(model)(rows)
    cfg = ServeConfig(max_batch=256, max_queue=4096, max_wait_ms=2.0,
                      pipeline_depth=2)
    fc = FleetConfig(probe_interval_ms=0.0, autoscale=False,
                     max_failovers=3, device="cuda:0")
    with FrontDoor({"m": path}, replicas=2, config=cfg,
                   fleet_config=fc) as fd:
        assert [f.result(timeout=120)
                for f in [fd.submit(r) for r in rows]] == want
        fd.fleet_config.subprocess = True
        try:
            child = fd.spawn_replica()
        finally:
            fd.fleet_config.subprocess = False
        assert child.kind == "subprocess" and child.device == "cuda:0"
        assert [f.result(timeout=120)
                for f in [child.submit("m", r) for r in rows]] == want
        health = child.health(timeout=120)["device"]
        assert health["maxMemoryAllocated"] > 0
        assert health["kernelLaunches"]["forest_predict_heap"] > 0
        futs = [fd.submit(r) for r in rows]
        fd.kill_replica(child.rid)
        assert [f.result(timeout=120) for f in futs] == want
        assert fd.fleet_snapshot()["kills"] == 1


def test_killed_tree_sweep_resumes_bit_equal_on_the_card(cuda, tmp_path):
    """A checkpointed train whose selector sweeps LR, a small RF and a
    small GBT on the card, killed at ``preempt.sweep`` after LR's
    records and resumed: the RF and GBT sweep on the card (the histogram
    kernels launch) and the model is the unkilled run's bit for bit (the
    selection, every family's fold metrics, the refit's params and the
    scores)."""
    from transmogrifai_tpu_torch.features import reset_uids
    from transmogrifai_tpu_torch.models.api import MODEL_REGISTRY, to_numpy
    from transmogrifai_tpu_torch.robustness import faults
    from transmogrifai_tpu_torch.testing import (
        serve_bench_data, serve_bench_workflow)
    data = serve_bench_data(3000, 8, seed=0)
    rf = [{"maxDepth": d, "numTrees": 4, "minInstancesPerNode": 10,
           "minInfoGain": 0.001, "subsamplingRate": 1.0} for d in (3, 12)]
    gbt = [{"maxDepth": 3, "maxIter": 5, "minInstancesPerNode": 10,
            "minInfoGain": 0.001, "stepSize": 0.1}]
    lr = [{"regParam": 0.01, "elasticNetParam": 0.0}]

    def train(ckpt=None, resume=False):
        reset_uids()
        wf = serve_bench_workflow(None, None, 8, seed=0, device=cuda)
        sel = wf.stages[-1]
        sel.models = [(MODEL_REGISTRY["OpLogisticRegression"], lr),
                      (MODEL_REGISTRY["OpRandomForestClassifier"], rf),
                      (MODEL_REGISTRY["OpGBTClassifier"], gbt)]
        wf.set_input_dataset(data)
        if ckpt is not None:
            wf.with_checkpoint_dir(ckpt)
        return wf.train(resume=resume)

    def outcome(model):
        s = model.stages[-1].summary
        return (s.best_model_type, s.best_hyper, s.best_metric_value,
                [np.asarray(r.fold_metrics).tobytes()
                 for r in s.validation_results],
                {k: v.tobytes() for k, v in to_numpy(
                    model.stages[-1].fitted.params).items()},
                model.score(data=data)[model.result_features[0].name]
                .values.cpu().numpy().tobytes())

    want = outcome(train(str(tmp_path / "clean")))
    ck = str(tmp_path / "killed")
    with faults.injected({"preempt.sweep": {"mode": "preempt", "nth": 2}}):
        with pytest.raises(faults.SimulatedPreemption):
            train(ck)
    for k in (HK.HIST_MATMUL, HK.NODE_HIST):
        k.launches = 0
    model = train(ck, resume=True)
    torch.cuda.synchronize()
    assert HK.NODE_HIST.launches > 0
    res = model.summary()["resume"]
    assert [r["family"] for r in res["restoredSweepCandidates"]] == [
        "OpLogisticRegression"]
    assert outcome(model) == want
