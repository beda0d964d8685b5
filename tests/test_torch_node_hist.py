"""The node histogram of the PyTorch port (kernel 6 of the port plan)
against the JAX package, on the CPU.

The same numpy inputs go through the JAX package's ``node_hist_matmul``
(its XLA contraction over the masked-stat operand), through the retired
Pallas kernel of ``docs/experiments/node_hist_pallas.py`` in interpret
mode (as ``tests/test_node_hist.py`` runs it), and through the port's
plain version (``node_hist_plain``, behind ``node_hist_matmul`` on a CPU
tensor) and its direct formula (``node_hist_direct``, the CUDA kernel's
order, which ``tests/test_torch_cuda.py`` holds the kernel to bit for
bit).

Tolerances (stated once, used throughout):

* port plain against the JAX package: rtol 1e-6 and atol 1e-6 of the
  largest sum. Both round the stats to bf16 at the same point and cut the
  same pinned row blocks, but the sums inside a block run in another order
  (MKL against Eigen);
* plain against the retired Pallas kernel: rtol 1e-5 and atol 1e-5 of the
  largest sum (the kernel sums its row blocks in its own order);
* direct formula (rows one after the other within chunks of
  ``NODE_HIST_CHUNK`` rows, then the chunks) against the plain version:
  rtol 1e-5 and atol 1e-5 of the largest sum, f32 rounding of sums of at
  most a few thousand bf16 stats in two orders;
* integer-valued stats: equal everywhere, bit for bit.
"""
from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import jax.numpy as jnp
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from transmogrifai_tpu.histeng import kernels as jhk  # noqa: E402
from transmogrifai_tpu_torch import histeng as phist  # noqa: E402
from transmogrifai_tpu_torch.histeng import kernels as phk  # noqa: E402

JAX_RTOL = 1e-6
ORDER_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()), 1.0))


def _bits_equal(got, want):
    np.testing.assert_array_equal(np.asarray(got, np.float32).view(np.int32),
                                  np.asarray(want, np.float32).view(np.int32))


def _case(T, Wl, stride, seed=0, S=512, d=9, nb=8, k=3, integer=False):
    """``tests/test_node_hist.py``'s inputs (S 512, d 9, nb 8, k 3)."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, nb, size=(S, d)).astype(np.int32)
    node = rng.randint(0, max(stride * Wl, 1), size=(S, T)).astype(np.int32)
    if integer:
        sw = [rng.randint(-3, 4, (S, T)).astype(np.float32)
              for _ in range(k)]
    else:
        sw = [rng.randn(S, T).astype(np.float32) for _ in range(k)]
    return codes, node, sw, nb, k


def _port(codes, node, sw, Wl, nb, stride):
    return phist.node_hist_matmul(_t(codes), _t(node), [_t(s) for s in sw],
                                  Wl, nb, stride=stride)


def _jax(codes, node, sw, Wl, nb, stride):
    return jhk.node_hist_matmul(jnp.asarray(codes), jnp.asarray(node),
                                [jnp.asarray(s) for s in sw], Wl, nb,
                                stride=stride)


#: ``tests/test_node_hist.py``'s (T, Wl, stride) cases
JAX_CASES = [(5, 1, 1), (54, 7, 1), (54, 64, 1), (130, 16, 2), (20, 32, 2)]


@pytest.mark.parametrize("T,Wl,stride", JAX_CASES)
def test_plain_matches_the_jax_package(T, Wl, stride):
    codes, node, sw, nb, k = _case(T, Wl, stride)
    got = _port(codes, node, sw, Wl, nb, stride)
    assert got.shape == (k * Wl * T, codes.shape[1] * nb)
    _close(got.numpy(), _jax(codes, node, sw, Wl, nb, stride), JAX_RTOL)


@pytest.mark.parametrize("T,Wl,stride", JAX_CASES)
def test_integer_stats_are_bit_equal_to_the_jax_package(T, Wl, stride):
    codes, node, sw, nb, _ = _case(T, Wl, stride, seed=1, integer=True)
    _bits_equal(_port(codes, node, sw, Wl, nb, stride).numpy(),
                _jax(codes, node, sw, Wl, nb, stride))


@pytest.mark.parametrize("T,Wl,stride", [(54, 64, 1), (130, 16, 2)])
def test_plain_matches_the_retired_pallas_kernel(T, Wl, stride):
    """The Pallas kernel the CUDA kernel replaces, run in interpret mode
    as the JAX package's own test runs it."""
    from docs.experiments.node_hist_pallas import (_node_hist_pallas,
                                                   pad_node_inputs)
    codes, node, sw, nb, k = _case(T, Wl, stride)
    d = codes.shape[1]
    node_p, sws, Wl_eff, T_pad = pad_node_inputs(
        jnp.asarray(node), [jnp.asarray(s) for s in sw], Wl)
    want = np.asarray(_node_hist_pallas(jnp.asarray(codes), node_p, sws,
                                        Wl_eff, nb, stride, k))
    want = (want.reshape(k, Wl_eff, T_pad, d * nb)[:, :Wl, :T]
            .reshape(k * Wl * T, d * nb))
    _close(_port(codes, node, sw, Wl, nb, stride).numpy(), want, ORDER_RTOL)


def _odd_case(T, Wl, stride, integer=False, seed=7):
    """S prime, d 9, codes with sentinels, and node values that add
    nothing: negative, odd under stride 2, at or past stride * Wl."""
    rng = np.random.RandomState(seed + T)
    S, d, nb, k = 509, 9, 11, 3
    codes = rng.randint(0, nb + 1, (S, d)).astype(np.int32)   # nb: sentinel
    node = rng.randint(-2, stride * Wl + 3, (S, T)).astype(np.int32)
    if integer:
        sw = [rng.randint(-4, 5, (S, T)).astype(np.float32)
              for _ in range(k)]
    else:
        sw = [(rng.randn(S, T) * 3).astype(np.float32) for _ in range(k)]
    return codes, node, sw, nb


ODD_CASES = [(1, 1, 1), (1, 6, 2), (130, 5, 1), (130, 4, 2), (3, 17, 2)]


@pytest.mark.parametrize("T,Wl,stride", ODD_CASES)
def test_direct_formula_matches_plain_at_odd_shapes(T, Wl, stride):
    codes, node, sw, nb = _odd_case(T, Wl, stride)
    got = phk.node_hist_direct(_t(codes), _t(node), [_t(s) for s in sw],
                               Wl, nb, stride)
    want = _port(codes, node, sw, Wl, nb, stride)
    assert got.shape == want.shape
    _close(got.numpy(), want.numpy(), ORDER_RTOL)
    # the rows that add nothing: a histogram of only them is zero
    idle = (node < 0) | (node % stride != 0) | (node >= stride * Wl)
    only = [np.where(idle, s, 0).astype(np.float32) for s in sw]
    assert not phk.node_hist_direct(_t(codes), _t(node),
                                    [_t(s) for s in only], Wl, nb,
                                    stride).any()


@pytest.mark.parametrize("T,Wl,stride", ODD_CASES)
def test_integer_stats_are_bit_equal_at_odd_shapes(T, Wl, stride):
    codes, node, sw, nb = _odd_case(T, Wl, stride, integer=True)
    direct = phk.node_hist_direct(_t(codes), _t(node), [_t(s) for s in sw],
                                  Wl, nb, stride)
    _bits_equal(direct.numpy(), _port(codes, node, sw, Wl, nb,
                                      stride).numpy())
    _bits_equal(direct.numpy(), _jax(codes, node, sw, Wl, nb, stride))


def test_direct_formula_rounds_stats_to_bf16_and_sums_rows_in_order():
    """Three rows in one cell: 1 + 2^-9 rounds to 1 in bf16, and the cell
    holds the f32 sum of the rounded stats in row order."""
    codes = torch.zeros((3, 1), dtype=torch.int32)
    node = torch.zeros((3, 1), dtype=torch.int64)
    sw = torch.tensor([[1.0 + 2.0 ** -9], [2.0 ** 24], [1.0]])
    got = phk.node_hist_direct(codes, node, [sw], 1, 2)
    assert got[0, 0] == np.float32(np.float32(1.0 + 2.0 ** 24) + 1.0)
    assert got[0, 1] == 0


def test_direct_formula_adds_long_segments_by_chunks():
    """A segment longer than ``NODE_HIST_CHUNK`` rows sums each chunk in
    row order, then the chunk partials: 2^24 then 1 + 1 in the second
    chunk gives 2^24 + 2, where one pass over the rows would give 2^24."""
    ch = phk.NODE_HIST_CHUNK
    S = ch + 2
    codes = torch.zeros((S, 1), dtype=torch.int32)
    node = torch.zeros((S, 1), dtype=torch.int64)
    sw = torch.zeros((S, 1))
    sw[ch - 1], sw[ch], sw[ch + 1] = 2.0 ** 24, 1.0, 1.0
    got = phk.node_hist_direct(codes, node, [sw], 1, 1)
    assert got[0, 0] == 2.0 ** 24 + 2


@pytest.mark.parametrize("integer", [False, True])
def test_direct_formula_matches_plain_over_many_chunks(integer):
    """Two trees whose few slots hold several chunks of rows each."""
    rng = np.random.RandomState(8)
    S, d, nb, T, Wl = 3 * phk.NODE_HIST_CHUNK + 77, 5, 7, 2, 2
    codes = rng.randint(0, nb + 1, (S, d)).astype(np.int32)
    node = rng.randint(-1, 2 * Wl, (S, T)).astype(np.int32)
    sw = [(rng.randint(-4, 5, (S, T)) if integer else rng.randn(S, T))
          .astype(np.float32) for _ in range(2)]
    got = phk.node_hist_direct(_t(codes), _t(node), [_t(x) for x in sw],
                               Wl, nb, 2).numpy()
    want = _port(codes, node, sw, Wl, nb, 2).numpy()
    if integer:
        _bits_equal(got, want)
    else:
        _close(got, want, ORDER_RTOL)


def _row_walk(codes, node, sw, Wl, nb, stride):
    """The definition one row at a time in numpy f32: each (tree, slot)
    segment's rows ascending, chunks of ``NODE_HIST_CHUNK`` rows, the
    chunk partials added in chunk order."""
    S, d = codes.shape
    T, k, ch = node.shape[1], len(sw), phk.NODE_HIST_CHUNK
    sws = [torch.from_numpy(x).to(torch.bfloat16).float().numpy()
           for x in sw]
    out = np.zeros((k, Wl, T, d, nb), np.float32)
    for t in range(T):
        for j in range(Wl):
            rows = [s for s in range(S) if node[s, t] == stride * j]
            for q in range(0, max(len(rows), 1), ch):
                part = np.zeros((k, d, nb), np.float32)
                for s in rows[q:q + ch]:
                    for f in range(d):
                        if 0 <= codes[s, f] < nb:
                            for ki in range(k):
                                part[ki, f, codes[s, f]] += sws[ki][s, t]
                out[:, j, t] = out[:, j, t] + part
    return out.reshape(k * Wl * T, d * nb)


@pytest.mark.parametrize("S,T,Wl,stride", [(300, 2, 3, 1), (700, 1, 1, 1),
                                           (431, 3, 4, 2)])
def test_direct_formula_is_the_row_by_row_walk(S, T, Wl, stride):
    """The vectorized direct formula (one step per place within a chunk)
    against a plain walk over the rows: the same bits."""
    rng = np.random.RandomState(S)
    d, nb = 4, 5
    codes = rng.randint(0, nb + 1, (S, d)).astype(np.int32)
    node = rng.randint(-1, stride * Wl + 1, (S, T)).astype(np.int64)
    sw = [(rng.randn(S, T) * 3).astype(np.float32) for _ in range(2)]
    _bits_equal(phk.node_hist_direct(_t(codes), _t(node),
                                     [_t(x) for x in sw], Wl, nb,
                                     stride).numpy(),
                _row_walk(codes, node, sw, Wl, nb, stride))


def test_wrapper_routes_by_device():
    codes = torch.zeros((4, 2), dtype=torch.int32)
    node = torch.zeros((4, 3), dtype=torch.int64)
    sw = [torch.ones((4, 3))]
    out = phist.node_hist_matmul(codes, node, sw, 2, 3)
    assert out.device.type == "cpu" and out.shape == (1 * 2 * 3, 2 * 3)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        phk.node_hist_cuda(codes, node, sw, 2, 3)
    with pytest.raises(ValueError, match="no node histogram kernel"):
        phist.node_hist_matmul(codes.to("meta"), node.to("meta"),
                               [s.to("meta") for s in sw], 2, 3)


def test_node_hist_is_registered_with_the_pallas_kernel_it_replaces():
    assert phk.NODE_HIST in phk.KERNELS
    assert phk.NODE_HIST.source == "node_hist.cu"
    path, line = phk.NODE_HIST.replaces.split(":")
    with open(os.path.join(REPO, path)) as f:
        assert f.read().splitlines()[int(line) - 1].startswith(
            "def _node_hist_pallas(")
