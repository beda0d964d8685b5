"""Non-finite stats in the port's histograms against the JAX package, on
the CPU.

The JAX package contracts a one-hot (``hist_matmul``) or a masked-stat
operand (``node_hist_matmul``), so a NaN or +-Inf stat reaches every cell
its row multiplies by 0 as NaN. The same numpy inputs, integer-valued
stats with one NaN, one +Inf, one -Inf, a +Inf/-Inf pair or one finite
value that rounds to Inf in bf16, go through the JAX package's XLA path,
the port's plain versions and ``node_hist_direct`` (the CUDA kernel's
order, which ``tests/test_torch_cuda.py`` holds the kernel to).

Tolerance: none. The NaN cells are the same, and every other cell has the
same bits (integer-valued sums are exact in any order, and an Inf does not
depend on the order either).
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
from transmogrifai_tpu_torch.histeng import kernels as phk  # noqa: E402

#: a finite f32 stat that rounds to +Inf in bf16
BF16_OVERFLOW = 3.4e38
#: which stats go non-finite: (row, column, value) triples by kind
KINDS = ("nan", "+inf", "-inf", "+inf/-inf", "bf16 overflow")


def _same(got, want):
    """NaN where the other is NaN, the same bits everywhere else."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))


def _spoil(x, kind, rng, rows, cols):
    """Put the non-finite values of ``kind`` into x (S, ...) at rows of
    ``rows`` and columns of ``cols`` drawn from ``rng``."""
    vals = {"nan": [np.nan], "+inf": [np.inf], "-inf": [-np.inf],
            "+inf/-inf": [np.inf, -np.inf],
            "bf16 overflow": [BF16_OVERFLOW]}[kind]
    for v in vals:
        x[(rng.choice(rows), rng.choice(cols))] = v
    return x


def _roadmap_codes():
    """Rows [[0, 1], [1, 0], [2, 2], [0, 3]] four times: S 16, d 2, three
    bins (3 is the sentinel)."""
    return np.array([[0, 1], [1, 0], [2, 2], [0, 3]] * 4, np.int32), 3


def _odd_codes(rng):
    """S 509, d 9, 11 bins with a tenth sentinels and column 4 all
    sentinel."""
    codes = rng.randint(0, 12, (509, 9)).astype(np.int32)
    codes[:, 4] = 11
    return codes, 11


def _hist_case(shape, kind, seed):
    rng = np.random.RandomState(seed)
    if shape == "roadmap":
        codes, nb = _roadmap_codes()
        A = np.ones((16, 2), np.float32)
        # row 2 (codes [2, 2]) first, as the roadmap's case has it; a pair
        # puts its -Inf on the same codes (row 6) or on others (row 3)
        A[2, 0] = {"nan": np.nan, "-inf": -np.inf,
                   "bf16 overflow": BF16_OVERFLOW}.get(kind, np.inf)
        if kind == "+inf/-inf":
            A[6 if seed % 2 else 3, 0] = -np.inf
        return codes, A, nb
    codes, nb = _odd_codes(rng)
    A = rng.randint(-4, 5, (509, 13)).astype(np.float32)
    return codes, _spoil(A, kind, rng, np.arange(509), [0, 5, 12]), nb


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("shape,seed", [("roadmap", 0), ("roadmap", 1),
                                        ("odd", 2)])
@pytest.mark.parametrize("kind", KINDS)
def test_hist_plain_matches_the_jax_package(kind, shape, seed, exact):
    codes, A, nb = _hist_case(shape, kind, seed)
    got = phk.hist_matmul_plain(torch.from_numpy(codes), torch.from_numpy(A),
                                nb, exact)
    want = jhk.hist_matmul(jnp.asarray(codes), jnp.asarray(A), nb, exact)
    assert np.isnan(np.asarray(want)).any() or kind == "bf16 overflow"
    _same(got.numpy(), want)


def test_hist_plain_on_the_roadmap_input():
    """The reference's pattern, spelled out: NaN spreads over the stat
    column; +Inf stays Inf in the bins its row hits and makes the others
    NaN."""
    codes, A, nb = _hist_case("roadmap", "nan", 0)
    got = phk.hist_matmul_plain(torch.from_numpy(codes), torch.from_numpy(A),
                                nb, True)
    assert torch.isnan(got[0]).all()
    codes, A, nb = _hist_case("roadmap", "+inf", 0)
    got = phk.hist_matmul_plain(torch.from_numpy(codes), torch.from_numpy(A),
                                nb, True)
    inf, nan = float("inf"), float("nan")
    _same(got[0].numpy(), np.array([nan, nan, inf, nan, nan, inf],
                                   np.float32))
    _same(got[1].numpy(), np.array([8, 4, 4, 4, 4, 4], np.float32))


def _node_case(case, kind, seed):
    """codes, node (S, T) int64, k = 2 stats (S, T) and (Wl, nb, stride)."""
    rng = np.random.RandomState(seed)
    if case == "roadmap":
        codes, nb = _roadmap_codes()
        node = np.array([[0], [1]] * 8, np.int64)
        sw = [np.ones((16, 1), np.float32) for _ in range(2)]
        sw[0][2, 0] = {"nan": np.nan, "-inf": -np.inf,
                       "bf16 overflow": BF16_OVERFLOW}.get(kind, np.inf)
        if kind == "+inf/-inf":
            sw[0][6 if seed % 2 else 3, 0] = -np.inf
        return codes, node, sw, (2, nb, 1)
    codes, nb = _odd_codes(rng)
    T, Wl, stride = (3, 5, 2) if case == "odd, stride 2" else (1, 7, 1)
    # node values that add nothing too: negative, odd, past stride * Wl
    node = rng.randint(-2, stride * Wl + 2, (509, T)).astype(np.int64)
    sw = [rng.randint(-4, 5, (509, T)).astype(np.float32) for _ in range(2)]
    _spoil(sw[1], kind, rng, np.arange(509), np.arange(T))
    return codes, node, sw, (Wl, nb, stride)


NODE_CASES = [("roadmap", 0), ("roadmap", 1), ("odd, stride 2", 2),
              ("odd, one tree", 3)]


@pytest.mark.parametrize("case,seed", NODE_CASES)
@pytest.mark.parametrize("kind", KINDS)
def test_node_hist_plain_matches_the_jax_package(kind, case, seed):
    codes, node, sw, (Wl, nb, stride) = _node_case(case, kind, seed)
    got = phk.node_hist_plain(torch.from_numpy(codes), torch.from_numpy(node),
                              [torch.from_numpy(s) for s in sw], Wl, nb,
                              stride)
    want = jhk.node_hist_matmul(jnp.asarray(codes),
                                jnp.asarray(node.astype(np.int32)),
                                [jnp.asarray(s) for s in sw], Wl, nb,
                                stride=stride)
    _same(got.numpy(), want)


@pytest.mark.parametrize("case,seed", NODE_CASES)
@pytest.mark.parametrize("kind", KINDS)
def test_node_hist_direct_matches_plain(kind, case, seed):
    codes, node, sw, (Wl, nb, stride) = _node_case(case, kind, seed)
    args = (torch.from_numpy(codes), torch.from_numpy(node),
            [torch.from_numpy(s) for s in sw], Wl, nb, stride)
    _same(phk.node_hist_direct(*args).numpy(),
          phk.node_hist_plain(*args).numpy())


def test_node_hist_direct_on_the_roadmap_input():
    """+Inf in slot 0's stat: slot 0 keeps Inf in the bins row 2 hits and
    is NaN elsewhere; slot 1, which row 2 is not in, is NaN everywhere."""
    codes, node, sw, (Wl, nb, stride) = _node_case("roadmap", "+inf", 0)
    got = phk.node_hist_direct(torch.from_numpy(codes),
                               torch.from_numpy(node),
                               [torch.from_numpy(s) for s in sw], Wl, nb,
                               stride)
    inf, nan = float("inf"), float("nan")
    _same(got[0].numpy(), np.array([nan, nan, inf, nan, nan, inf],
                                   np.float32))
    assert torch.isnan(got[1]).all()
    assert torch.isfinite(got[2:]).all()      # the second stat is finite
