"""The histogram engine of the PyTorch port against the JAX package's.

The same numpy inputs go through the JAX package's ``histeng`` (its XLA
contraction on the CPU, and its Pallas kernel in interpret mode) and
through the port's plain versions; the CUDA kernel itself is held to the
plain version in ``tests/test_torch_cuda.py``.

Tolerances (stated once, used throughout):

* against the direct float64 formula, bf16 mode: rtol 2e-2 and atol 2e-2 of
  the largest sum, as the JAX package's own tests (bf16 operands);
* exact mode on integer-valued stats: equal;
* port against the JAX package: rtol 1e-6 and atol 1e-6 of the largest
  sum. Both round the same operands and cut the same row blocks, but the
  sums inside a block run in another order (MKL against Eigen), so they
  agree to f32 rounding.
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

from transmogrifai_tpu import histeng as jhist  # noqa: E402
from transmogrifai_tpu.histeng import kernels as jhk  # noqa: E402
from transmogrifai_tpu_torch import histeng as phist  # noqa: E402
from transmogrifai_tpu_torch.histeng import kernels as phk  # noqa: E402
from transmogrifai_tpu_torch.testing import hist_direct  # noqa: E402

PORT_RTOL = 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close_to_jax(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=PORT_RTOL,
        atol=PORT_RTOL * max(float(np.abs(want).max()), 1.0))


def _bf16_close(got, want):
    got = np.asarray(got)
    assert np.allclose(got, want, rtol=2e-2, atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("shape", [(1000, 7, 32, 3), (2048, 64, 32, 8),
                                   (257, 130, 16, 2), (100, 3, 4, 129)])
def test_hist_matmul(shape):
    S, d, nb, B = shape
    rng = np.random.RandomState(0)
    codes = rng.randint(0, nb, (S, d)).astype(np.int32)
    A = rng.randn(S, B).astype(np.float32)
    got = phist.hist_matmul(_t(codes), _t(A), nb)
    _bf16_close(got, hist_direct(codes, A, nb))
    _close_to_jax(got, jhk.hist_matmul(jnp.asarray(codes), jnp.asarray(A),
                                       nb))


def test_hist_matmul_batches_by_widening_the_stat_columns():
    """The JAX package batches configurations (vmap) by widening A's
    columns; the port's callers do the same by hand, and each block of
    columns is that configuration's histogram."""
    rng = np.random.RandomState(1)
    codes = rng.randint(0, 8, (300, 6)).astype(np.int32)
    Ab = rng.randn(4, 300, 5).astype(np.float32)
    flat = Ab.transpose(1, 0, 2).reshape(300, 20)
    got = phist.hist_matmul(_t(codes), _t(flat), 8).reshape(4, 5, -1)
    want = np.asarray(jax.vmap(lambda a: jhk.hist_matmul(
        jnp.asarray(codes), a, 8))(jnp.asarray(Ab)))
    for v in range(4):
        _bf16_close(got[v], hist_direct(codes, Ab[v], 8))
        _close_to_jax(got[v], want[v])


def test_sentinel_codes_contribute_nothing():
    rng = np.random.RandomState(4)
    nb = 8
    codes = rng.randint(0, nb, (100, 3)).astype(np.int32)
    codes[50:, 1] = nb
    A = rng.randn(100, 2).astype(np.float32)
    got = phist.hist_matmul(_t(codes), _t(A), nb, exact=True).numpy()
    np.testing.assert_allclose(got[:, nb:2 * nb].sum(1), A[:50].sum(0),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, hist_direct(codes, A, nb), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("S", [5, 8, 333, 4096])
def test_pinned_contraction_matches_direct_reference(S):
    nb, d, B = 16, 5, 3
    rng = np.random.RandomState(0)
    codes = rng.randint(0, nb, (S, d)).astype(np.int32)
    A = rng.randn(S, B).astype(np.float32)
    got = phist.build_hist(_t(codes), _t(A), nb)
    _bf16_close(got, hist_direct(codes, A, nb))
    _close_to_jax(got, jhist.build_hist(jnp.asarray(codes), jnp.asarray(A),
                                        nb))


def test_exact_mode_integer_stats_are_exact():
    nb, S, d = 8, 500, 4
    rng = np.random.RandomState(1)
    codes = rng.randint(0, nb, (S, d)).astype(np.int32)
    A = rng.randint(0, 7, (S, 2)).astype(np.float32)
    got = phist.build_hist(_t(codes), _t(A), nb, exact=True).numpy()
    np.testing.assert_array_equal(got, hist_direct(codes, A, nb))
    np.testing.assert_array_equal(got, np.asarray(jhist.build_hist(
        jnp.asarray(codes), jnp.asarray(A), nb, exact=True)))


def test_exact_mode_keeps_f32_stats_that_bf16_would_round():
    rng = np.random.RandomState(7)
    codes = rng.randint(0, 4, (64, 2)).astype(np.int32)
    A = (1.0 + rng.randint(1, 100, (64, 1)) * 2.0 ** -12).astype(np.float32)
    exact = phist.hist_matmul(_t(codes), _t(A), 4, exact=True).numpy()
    np.testing.assert_allclose(exact, hist_direct(codes, A, 4), rtol=1e-6)
    rounded = phist.hist_matmul(_t(codes), _t(A), 4).numpy()
    assert np.abs(rounded - exact).max() > 1e-3


def test_tree_combine_is_fixed_order():
    """((p0 + p1) + (p2 + p3)) + p4, bit for bit, as the JAX package's."""
    rng = np.random.RandomState(2)
    p = rng.randn(5, 3, 2).astype(np.float32)
    got = phk._tree_combine(_t(p)).numpy()
    want = ((p[0] + p[1]) + (p[2] + p[3])) + p[4]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jhk._tree_combine(
        jnp.asarray(p))))


@pytest.mark.parametrize("S", [7, 1000])
def test_pinned_row_sum_matches_jax(S):
    x = np.random.RandomState(3).randn(S, 4).astype(np.float32)
    got = phist.pinned_row_sum(_t(x), dim=0)
    _close_to_jax(got, jhist.pinned_row_sum(jnp.asarray(x), axis=0))
    np.testing.assert_allclose(got.numpy(), x.astype(np.float64).sum(0),
                               rtol=1e-5, atol=1e-5)


def test_build_node_hist_device_layout_matches_flat_kernel():
    rng = np.random.RandomState(4)
    S, d, nb, T, Wl, k = 256, 5, 8, 6, 4, 2
    codes = rng.randint(0, nb, (S, d)).astype(np.int32)
    node = rng.randint(0, Wl, (S, T)).astype(np.int32)
    sws = [rng.randn(S, T).astype(np.float32) for _ in range(k)]
    got = phist.build_node_hist(_t(codes), _t(node), [_t(s) for s in sws],
                                nb, n_nodes=Wl)
    flat = phist.node_hist_matmul(_t(codes), _t(node), [_t(s) for s in sws],
                                  Wl, nb)
    assert torch.equal(got, flat.reshape(k, Wl, T, d, nb))
    _close_to_jax(got, jhist.build_node_hist(
        jnp.asarray(codes), jnp.asarray(node),
        [jnp.asarray(s) for s in sws], nb, n_nodes=Wl))


@pytest.mark.parametrize("T,Wl,stride", [(1, 1, 1), (3, 8, 2), (70, 2, 2)])
def test_node_hist_matches_jax_and_masked_stat_definition(T, Wl, stride):
    rng = np.random.RandomState(T + Wl)
    S, d, nb, k = 400, 4, 8, 3
    codes = rng.randint(0, nb, (S, d)).astype(np.int32)
    node = rng.randint(-1, stride * Wl, (S, T)).astype(np.int32)
    sws = [rng.randn(S, T).astype(np.float32) for _ in range(k)]
    got = phist.node_hist_matmul(_t(codes), _t(node), [_t(s) for s in sws],
                                 Wl, nb, stride=stride)
    _close_to_jax(got, jhist.node_hist_matmul(
        jnp.asarray(codes), jnp.asarray(node),
        [jnp.asarray(s) for s in sws], Wl, nb, stride=stride))
    lane = 0
    for ki in range(k):
        for j in range(Wl):
            for t in range(T):
                A = (sws[ki][:, t] * (node[:, t] == stride * j))[:, None]
                _bf16_close(got[lane:lane + 1], hist_direct(codes, A, nb))
                lane += 1


@pytest.mark.parametrize("exact", [True, False])
def test_plain_version_matches_the_pallas_kernel_in_interpret_mode(exact):
    rng = np.random.RandomState(5)
    S, d, nb, B = 300, 5, 8, 6
    codes = rng.randint(0, nb + 1, (S, d)).astype(np.int32)
    A = rng.randn(S, B).astype(np.float32)
    want = np.asarray(jhk._hist_pallas(jnp.asarray(codes), jnp.asarray(A),
                                       nb, exact=exact))
    _close_to_jax(phist.hist_matmul_plain(_t(codes), _t(A), nb, exact),
                  want)


@pytest.mark.parametrize("B", [1024, 1025])
def test_hist_matmul_matches_jax_on_both_sides_of_its_width_gate(B):
    """The JAX package takes its Pallas kernel up to 1024 stat columns and
    its XLA contraction above; the port has one kernel for every width, and
    its plain version agrees with the JAX package on both sides."""
    rng = np.random.RandomState(B)
    S, d, nb = 64, 3, 8
    codes = rng.randint(0, nb + 1, (S, d)).astype(np.int32)
    A = rng.randn(S, B).astype(np.float32)
    got = phist.hist_matmul(_t(codes), _t(A), nb)
    assert got.shape == (B, d * nb)
    _close_to_jax(got, jhk.hist_matmul(jnp.asarray(codes), jnp.asarray(A),
                                       nb))


def test_wrapper_routes_by_device():
    codes = torch.zeros((4, 2), dtype=torch.int32)
    A = torch.ones((4, 3))
    out = phist.hist_matmul(codes, A, 3)
    assert out.device.type == "cpu" and out.shape == (3, 6)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        phk.hist_matmul_cuda(codes, A, 3)
    with pytest.raises(ValueError, match="no histogram kernel"):
        phist.hist_matmul(codes.to("meta"), A.to("meta"), 3)
