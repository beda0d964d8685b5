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
import jax
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


# ---------------------------------------------------------------------------
# The forest ops: leaf sums and predicts
#
# The JAX package sums a forest's leaf statistics and its predictions as a
# contraction with the one-hot of each row's leaf, at Precision.HIGHEST, so
# a NaN or +-Inf stat (or leaf value) meets every 0 of that one-hot and
# gives NaN there. The port's plain versions (``leaf_sums``,
# ``leaf_values``: the CPU path and what the kernels are held to) against
# its XLA path and its Pallas kernels in interpret mode, on small random
# forests with integer-valued stats and leaves: the same NaN cells or
# rows, every other cell's bits.
# ---------------------------------------------------------------------------

from transmogrifai_tpu.models import trees as jtrees  # noqa: E402
from transmogrifai_tpu.ops import forest as jforest  # noqa: E402
from transmogrifai_tpu_torch.models import trees as ptrees  # noqa: E402
from transmogrifai_tpu_torch.ops import forest as pforest  # noqa: E402
from transmogrifai_tpu_torch.testing import (  # noqa: E402
    leaf_sums_chunked, leaf_sums_direct, random_chain, random_heap,
)

#: forests: heaps n 200, d 6, T 3, depth 3; chains T 3, depth 5, W 8
#: (W_out 8); 8 bins
FN, FD, FT, FB = 200, 6, 3, 8
HEAP_DEPTH, CHAIN_DEPTH, CHAIN_W = 3, 5, 8
SUM_KINDS = ("nan", "+inf", "-inf", "+inf/-inf, one leaf",
             "+inf/-inf, two leaves", "inf, slot outside")
#: (kind, layout): a heap's leaves all lie inside its table
SUM_CASES = [(k, lay) for k in SUM_KINDS for lay in ("heap", "chain")
             if lay == "chain" or k != "inf, slot outside"]


def _forest(layout, seed):
    """Tables on numpy, their (n, T) leaf ids (the port's routing, which
    tests/test_torch_forest.py holds to the JAX package's) and W_out. A
    chain's tree 1 sends one last-level slot outside [0, W_out)."""
    rng = np.random.RandomState(seed)
    if layout == "heap":
        f = random_heap(rng, FN, FD, FT, HEAP_DEPTH, 1, FB)
        tabs = (f["codes"], f["feat"], f["bins"])
        ids = pforest.route_codes(*map(torch.from_numpy, tabs), HEAP_DEPTH,
                                  FB)
        return tabs, ids.numpy(), 2 ** HEAP_DEPTH
    f = random_chain(rng, FN, FD, FT, CHAIN_DEPTH, CHAIN_W, 1, FB)
    tabs = (f["codes"], f["feat"], f["bins"], f["base"])
    last = pforest.route_codes_chain(*(torch.from_numpy(x[:, :-1].copy())
                                       if x.ndim == 3 else torch.from_numpy(x)
                                       for x in tabs), FB).numpy()
    j = np.bincount(last[:, 1], minlength=CHAIN_W).argmax()
    f["base"][1, CHAIN_DEPTH - 1, j] = CHAIN_W + 3    # exact in bf16 too
    ids = pforest.route_codes_chain(*map(torch.from_numpy, tabs), FB).numpy()
    assert (ids[:, 1] >= CHAIN_W).any()
    return tabs, ids, CHAIN_W


def _sum_case(layout, kind, seed):
    """Tables, integer-valued stats (n, 3) with the non-finite values of
    ``kind`` in stat 1, and the ids."""
    tabs, ids, W_out = _forest(layout, seed)
    rng = np.random.RandomState(seed + 1)
    aug = rng.randint(-3, 4, (FN, 3)).astype(np.float32)
    r = int(rng.randint(FN))
    if kind == "inf, slot outside":             # chains only
        r = int(np.nonzero(ids[:, 1] >= W_out)[0][0])
        aug[r, 1] = np.inf
    elif kind.startswith("+inf/-inf"):
        same = kind.endswith("one leaf")
        peers = np.nonzero((ids[:, 0] == ids[r, 0]) == same)[0]
        peers = peers[peers != r]
        aug[r, 1], aug[int(peers[0]), 1] = np.inf, -np.inf
    else:
        aug[r, 1] = {"nan": np.nan, "+inf": np.inf, "-inf": -np.inf}[kind]
    return tabs, aug, ids, W_out


def _jax_sums(layout, tabs, aug, use_pallas, monkeypatch):
    monkeypatch.setenv("TG_TREE_PALLAS", "1" if use_pallas else "0")
    jax.clear_caches()
    j = [jnp.asarray(x) for x in tabs]
    if layout == "heap":
        return np.asarray(jforest.forest_leaf_sums(
            *j, jnp.asarray(aug), depth=HEAP_DEPTH, n_bins=FB))
    return np.asarray(jforest.forest_leaf_sums_chain(*j, jnp.asarray(aug),
                                                     n_bins=FB))


def _port_sums(layout, tabs, aug):
    t = [torch.from_numpy(x) for x in tabs]
    if layout == "heap":
        return pforest.forest_leaf_sums(*t, torch.from_numpy(aug),
                                        depth=HEAP_DEPTH, n_bins=FB).numpy()
    return pforest.forest_leaf_sums_chain(*t, torch.from_numpy(aug),
                                          n_bins=FB).numpy()


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("kind,layout", SUM_CASES)
def test_leaf_sums_spread_non_finite_stats_as_the_jax_package(
        kind, layout, use_pallas, monkeypatch):
    tabs, aug, ids, W_out = _sum_case(layout, kind, len(kind))
    want = _jax_sums(layout, tabs, aug, use_pallas, monkeypatch)
    got = _port_sums(layout, tabs, aug)
    assert np.isnan(want[..., 1]).any()
    assert np.isfinite(want[..., [0, 2]]).all()
    _same(got, want)
    _same(leaf_sums_direct(ids, aug, W_out).astype(np.float32), want)


def test_leaf_sums_on_an_inf_row_spell_out_the_contraction():
    """+Inf at row r, stat 1: in each tree, the leaf r reaches holds +Inf
    and every other cell of stat 1 is NaN; stats 0 and 2 stay finite."""
    tabs, aug, ids, W_out = _sum_case("heap", "+inf", 4)
    got = _port_sums("heap", tabs, aug)
    r = int(np.nonzero(np.isinf(aug[:, 1]))[0][0])
    for t in range(FT):
        assert got[t, ids[r, t], 1] == np.inf
        others = np.delete(got[t, :, 1], ids[r, t])
        assert np.isnan(others).all()
    assert np.isfinite(got[..., [0, 2]]).all()


@pytest.mark.parametrize("layout", ["heap", "chain"])
def test_exact_leaf_stats_inf_stat_times_zero_weight(layout):
    """The trees' leaf statistics weight each row's stats: an Inf stat at a
    row of weight 0 is NaN in aug (Inf * 0), and its stat column is NaN in
    every cell, in both packages."""
    tabs, _, _ = _forest(layout, 9)
    rng = np.random.RandomState(9)
    stats = rng.randint(0, 3, (FN, 2)).astype(np.float32)
    w = rng.randint(0, 2, FN).astype(np.float32)
    r = int(np.nonzero(w == 0)[0][0])
    stats[r, 0] = np.inf
    t = [torch.from_numpy(x) for x in tabs]
    j = [jnp.asarray(x) for x in tabs]
    if layout == "heap":
        got = ptrees._exact_leaf_stats(*t, torch.from_numpy(stats),
                                       torch.from_numpy(w), HEAP_DEPTH, FB)
        want = jtrees._exact_leaf_stats(*j, jnp.asarray(stats),
                                        jnp.asarray(w), HEAP_DEPTH, FB)
    else:
        got = ptrees._exact_leaf_stats_chain(*t, torch.from_numpy(stats),
                                             torch.from_numpy(w), FB)
        want = jtrees._exact_leaf_stats_chain(*j, jnp.asarray(stats),
                                              jnp.asarray(w), FB)
    assert np.isnan(np.asarray(want[0])[..., 0]).all()
    for g, wt in zip(got, want):
        _same(g.numpy(), wt)


@pytest.mark.parametrize("kind,layout", [
    ("finite", "heap"), ("finite", "chain"), ("nan", "heap"),
    ("+inf/-inf, two leaves", "heap"), ("+inf/-inf, two leaves", "chain"),
    ("inf, slot outside", "chain")])
def test_leaf_sums_chunked_matches_leaf_sums(kind, layout):
    """The kernels' order (row chunks, then the partials in chunk order)
    against one pass over the rows: bit for bit on integer-valued stats
    (NaN cells equal), within rtol 1e-5 / atol 1e-6 on [0, 1) stats."""
    if kind == "finite":
        tabs, ids, W_out = _forest(layout, 5)
        aug = np.random.RandomState(5).randint(-3, 4, (FN, 3)).astype(
            np.float32)
    else:
        tabs, aug, ids, W_out = _sum_case(layout, kind, 6)
    ids_t = torch.from_numpy(ids)
    for n_chunks, rpc in ((1, FN), (7, 29), pforest.row_chunks(FN)):
        _same(leaf_sums_chunked(ids_t, torch.from_numpy(aug), W_out,
                                n_chunks, rpc).numpy(),
              pforest.leaf_sums(ids_t, torch.from_numpy(aug), W_out).numpy())
    frac = np.random.RandomState(6).rand(FN, 3).astype(np.float32)
    np.testing.assert_allclose(
        leaf_sums_chunked(ids_t, torch.from_numpy(frac), W_out, 7, 29),
        pforest.leaf_sums(ids_t, torch.from_numpy(frac), W_out),
        rtol=1e-5, atol=1e-6)


PREDICT_KINDS = ("nan, reached", "nan, reached by no row", "+inf", "-inf",
                 "+inf/-inf")


def _predict_case(layout, kind, seed):
    """Tables, integer-valued leaves (T, W_out, 2) with the values of
    ``kind`` in output column 1, and the ids. The heaps' tree 2 sends every
    row left at its root, so its right half is reached by no row."""
    tabs, ids, W_out = _forest(layout, seed)
    rng = np.random.RandomState(seed + 2)
    leaf = rng.randint(-3, 4, (FT, W_out, 2)).astype(np.float32)
    if layout == "heap":
        tabs[2][2, 0] = FB                     # sentinel: route left
        ids = pforest.route_codes(*map(torch.from_numpy, tabs), HEAP_DEPTH,
                                  FB).numpy()
    r = int(np.nonzero((ids < W_out).all(1))[0][0])
    reached = [(t, int(ids[r, t])) for t in range(FT)]
    if kind == "nan, reached":
        leaf[reached[0] + (1,)] = np.nan
    elif kind == "nan, reached by no row":
        t = 2
        dead = sorted(set(range(W_out)) - set(ids[:, t].tolist()))
        leaf[t, dead[0], 1] = np.nan
    elif kind == "+inf/-inf":
        leaf[reached[0] + (1,)] = np.inf
        leaf[reached[1] + (1,)] = -np.inf
    else:
        leaf[reached[1] + (1,)] = np.inf if kind == "+inf" else -np.inf
    return tabs, leaf, ids


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("layout", ["heap", "chain"])
@pytest.mark.parametrize("kind", PREDICT_KINDS)
def test_predict_spreads_non_finite_leaves_as_the_jax_package(
        kind, layout, use_pallas, monkeypatch):
    tabs, leaf, ids = _predict_case(layout, kind, len(kind) + 20)
    monkeypatch.setenv("TG_TREE_PALLAS", "1" if use_pallas else "0")
    jax.clear_caches()
    j = [jnp.asarray(x) for x in tabs]
    t = [torch.from_numpy(x) for x in tabs]
    if layout == "heap":
        want = jforest.forest_predict(*j, jnp.asarray(leaf),
                                      depth=HEAP_DEPTH, n_bins=FB)
        got = pforest.forest_predict(*t, torch.from_numpy(leaf),
                                     depth=HEAP_DEPTH, n_bins=FB)
    else:
        want = jforest.forest_predict_chain(*j, jnp.asarray(leaf), n_bins=FB)
        got = pforest.forest_predict_chain(*t, torch.from_numpy(leaf),
                                           n_bins=FB)
    want = np.asarray(want)
    assert np.isnan(want[:, 1]).any() and np.isfinite(want[:, 0]).all()
    if kind != "+inf/-inf":
        assert not np.isnan(want[:, 1]).all() or kind.startswith("nan")
    _same(got.numpy(), want)
