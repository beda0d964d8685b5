"""Histogram-engine kernels (counterpart of
``transmogrifai_tpu.histeng.kernels``): the one-hot histogram of tree
growth,

    hist[a, f * nb + b] = sum_s A[s, a] * 1[codes[s, f] == b]

On a CUDA tensor ``hist_matmul`` launches the hand-written kernel of
``csrc/hist.cu`` at any width (the TPU runs ``_hist_pallas`` there). The
JAX package sends calls wider than 1024 stat columns to its XLA
contraction instead, because the Pallas kernel re-expands the one-hot for
every 128-column block; the CUDA kernel expands no one-hot, so it has no
such limit. On a CPU tensor ``hist_matmul`` runs
``hist_matmul_plain``, the one-hot formula over the same row chunks as the
kernel (the contraction the JAX package runs off the TPU); tensors on any
other device raise.

Two modes: ``exact`` keeps the stats f32; otherwise they are rounded to
bfloat16 first, as XLA's bf16 einsum with an f32 result rounds its
operands. Products and sums are f32 either way: a bf16 operand is widened
to f32 and multiplied with TF32 off, never through a bf16 matmul, whose
result PyTorch would round to bf16.

Pinned reduction: ``_hist_pinned`` and ``pinned_row_sum`` cut the rows into
``HIST_SHARDS`` blocks, reduce each block, and combine the block partials
in the fixed pairwise order of ``_tree_combine``, as the JAX package's
``_hist_xla_pinned`` does; the CUDA kernel cuts and combines its rows the
same way (inside a block it sums each block's rows in 16 fixed splits,
added in split order: an order the contraction never fixed, so the plain
version holds it to rtol 1e-5, and to the bit on integer-valued stats).

Node histograms (``node_hist_matmul``, the per-level split statistics of
every tree grower): on a CUDA tensor the hand-written kernel of
``csrc/node_hist.cu`` sorts each tree's rows by slot and sums every
(slot, feature, bin) cell over its rows in row order, by chunks of
``NODE_HIST_CHUNK`` rows added in chunk order; it reads the growers'
tensors in place, and no masked-stat operand is built and no tree lane is
padded. On a CPU tensor the plain version ``node_hist_plain``
materializes the masked-stat operand (with the JAX package's lane
padding) and runs the pinned contraction, as the JAX package's
``_node_hist_xla`` does; ``node_hist_direct`` is the definition summed
cell by cell in the kernel's order, the oracle at odd shapes.
"""
from __future__ import annotations

import ctypes
from contextlib import contextmanager
from typing import Sequence

import torch

from ..ops import cuda_build
from ..ops.cuda_build import check_int32, expect, ptr
from ..ops.xla_cpu import xla_sum

#: K, the pinned row-block count (the JAX package's TG_HIST_SHARDS default)
HIST_SHARDS = 8

_P, _I = ctypes.c_void_p, ctypes.c_int

HIST_MATMUL = cuda_build.CudaKernel(
    "hist_matmul", "hist.cu", "transmogrifai_tpu/histeng/kernels.py:235",
    [_P] * 5 + [_I] * 9 + [_P])

NODE_HIST = cuda_build.CudaKernel(
    "node_hist", "node_hist.cu", "docs/experiments/node_hist_pallas.py:62",
    [_P] * 6 + [ctypes.c_longlong] * 2 + [_I] * 13 + [_P])

KERNELS = (HIST_MATMUL, NODE_HIST)

#: the ``hist_matmul`` kernel's widest stat tile (a power of two, 1..32);
#: no bit of the result depends on it
HIST_COLS = 32

#: rows per chunk of a node-histogram segment: a cell sums each chunk's
#: rows in row order, then the chunk partials in chunk order. Part of the
#: function (it sets the order of the sums), shared by the kernel and
#: ``node_hist_direct``
NODE_HIST_CHUNK = 128

#: the node-histogram kernel's most threads per block (pass B), warps of
#: its scatter (pass A) and rows per staged sub-tile (pass B); no bit of
#: the result depends on any of them, nor on the sort's tile rows
NODE_HIST_THREADS = 256
NODE_SORT_WARPS = 8
NODE_STAGE_ROWS = 32


def _pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


@contextmanager
def _tf32_off():
    """Full-f32 matmuls on the card for the duration of the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _operand(A: torch.Tensor, exact: bool) -> torch.Tensor:
    """The stat operand as f32: as is when exact, else rounded to bf16."""
    if exact:
        return A.to(torch.float32)
    return A.to(torch.bfloat16).to(torch.float32)


def _one_hot(codes: torch.Tensor, n_bins: int) -> torch.Tensor:
    """(..., S, d) codes -> (..., S, d * n_bins) f32 feature-major one-hot;
    codes outside [0, n_bins) match no lane."""
    bins = torch.arange(n_bins, dtype=codes.dtype, device=codes.device)
    oh = (codes.unsqueeze(-1) == bins).to(torch.float32)
    return oh.reshape(*codes.shape[:-1], codes.shape[-1] * n_bins)


def _tree_combine(parts: torch.Tensor) -> torch.Tensor:
    """Fixed-order pairwise reduction over axis 0: ((p0 + p1) + (p2 + p3))
    + ..., an odd leftover carried to the next round."""
    while parts.shape[0] > 1:
        h = parts.shape[0] // 2
        s = parts[0:2 * h:2] + parts[1:2 * h:2]
        if parts.shape[0] % 2:
            s = torch.cat([s, parts[2 * h:]], dim=0)
        parts = s
    return parts[0]


def _hist_single(codes: torch.Tensor, A: torch.Tensor, n_bins: int,
                 exact: bool) -> torch.Tensor:
    """One one-hot contraction over every row: (B, d * n_bins) f32."""
    with _tf32_off():
        return _operand(A, exact).T @ _one_hot(codes.to(torch.int32), n_bins)


def _hist_pinned(codes: torch.Tensor, A: torch.Tensor, n_bins: int,
                 exact: bool = False) -> torch.Tensor:
    """K-blocked one-hot contraction with the pinned combine order
    (``_hist_xla_pinned``): rows sentinel-padded to a multiple of K, one
    batched contraction into per-block f32 partials, ``_tree_combine``."""
    K = HIST_SHARDS
    S, d = codes.shape
    if K <= 1 or S < K:
        return _hist_single(codes, A, n_bins, exact)
    B = A.shape[1]
    Sp = _pad_to(S, K)
    codes_p = torch.nn.functional.pad(codes.to(torch.int32),
                                      (0, 0, 0, Sp - S), value=n_bins)
    A_p = torch.nn.functional.pad(_operand(A, exact), (0, 0, 0, Sp - S))
    oh = _one_hot(codes_p.reshape(K, Sp // K, d), n_bins)
    with _tf32_off():
        parts = torch.bmm(A_p.reshape(K, Sp // K, B).transpose(1, 2), oh)
    return _tree_combine(parts)


def pinned_row_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Fixed-order K-blocked sum over ``dim`` (rows), the companion of
    ``_hist_pinned`` for direct row reductions of tree fits (GBT's base
    score f0): each block in ``ops.xla_cpu.xla_sum``'s order, the
    partials by
    ``_tree_combine``, bit for bit the JAX package's ``pinned_row_sum`` on
    the CPU."""
    K = HIST_SHARDS
    x = torch.movedim(x, dim, 0)
    S = x.shape[0]
    if K <= 1 or S < K:
        return xla_sum(x)
    Sp = _pad_to(S, K)
    xp = torch.cat([x, x.new_zeros((Sp - S,) + tuple(x.shape[1:]))])
    blocks = xp.reshape((K, Sp // K) + tuple(x.shape[1:]))
    return _tree_combine(xla_sum(blocks.movedim(1, 0)))


def hist_matmul_plain(codes: torch.Tensor, A: torch.Tensor, n_bins: int,
                      exact: bool = False) -> torch.Tensor:
    """The plain PyTorch version of the ``hist_matmul`` kernel, for CPU
    tensors and for holding the kernel to: the one-hot formula over the
    kernel's K row chunks, combined in the kernel's pinned order. It is
    the pinned contraction that the JAX package runs off the TPU."""
    return _hist_pinned(codes, A, n_bins, exact)


def hist_matmul_cuda(codes: torch.Tensor, A: torch.Tensor, n_bins: int,
                     exact: bool = False,
                     max_cols: int = HIST_COLS) -> torch.Tensor:
    """Launch ``hist_matmul`` (csrc/hist.cu) on the current stream:
    (B, d * n_bins) f32, rows cut into the pinned K chunks and each chunk
    into the kernel's 16 splits. ``max_cols`` caps the kernel's stat tile
    and changes no bit."""
    if not codes.is_cuda:
        raise ValueError(f"hist_matmul needs CUDA tensors, codes are on "
                         f"{codes.device}")
    dev = codes.device
    S, d = codes.shape
    B = A.shape[1]
    expect(codes, "codes", torch.int32, (S, d), dev)
    expect(A, "A", torch.float32, (S, B), dev)
    if n_bins < 1:
        raise ValueError(f"n_bins must be positive, got {n_bins}")
    K = HIST_SHARDS if S >= HIST_SHARDS else 1
    rows = -(-S // K)
    check_int32(S * d, S * B, K * d * n_bins * B)
    out = torch.empty((B, d * n_bins), dtype=torch.float32, device=dev)
    if S == 0 or B == 0 or d == 0:
        return out.zero_()
    # the features' and the stat columns' chunk masks (see csrc/hist.cu)
    flags = torch.empty(d + B, dtype=torch.int32, device=dev)
    part = torch.empty((K, d * n_bins, B), dtype=torch.float32, device=dev)
    HIST_MATMUL.launch(ptr(codes), ptr(A), ptr(flags), ptr(part), ptr(out),
                       S, d, B, n_bins, K, rows, int(exact), max_cols,
                       dev.index, torch.cuda.current_stream(dev).cuda_stream)
    return out


def hist_matmul(codes: torch.Tensor, A: torch.Tensor, n_bins: int,
                exact: bool = False) -> torch.Tensor:
    """hist[a, f * n_bins + b] = sum_s A[s, a] * 1[codes[s, f] == b], f32.

    codes: (S, d) int bin codes in [0, n_bins); a code equal to n_bins is
    a sentinel and adds nothing. A: (S, B) per-row statistics. Returns
    (B, d * n_bins) feature-major. ``exact`` keeps the stats f32 (leaf
    values that are served); growth histograms round them to bf16. A stat
    that is NaN or +-Inf (after the rounding) makes every cell of its
    column NaN whose bin its row's code misses, a sentinel included, as
    the one-hot contraction's 0 * Inf does."""
    if codes.is_cuda:
        return hist_matmul_cuda(codes.to(torch.int32).contiguous(),
                                A.to(torch.float32).contiguous(), n_bins,
                                exact)
    if codes.device.type != "cpu":
        raise ValueError(f"no histogram kernel for device {codes.device}")
    return hist_matmul_plain(codes, A, n_bins, exact)


def _t_pad128(T: int) -> int:
    """Tree-lane padding of the JAX package's node histogram: 32, 64, or a
    multiple of 128."""
    if T <= 32:
        return 32
    if T <= 64:
        return 64
    return _pad_to(T, 128)


def node_hist_direct(codes: torch.Tensor, node: torch.Tensor,
                     sw_list: Sequence[torch.Tensor], Wl: int, n_bins: int,
                     stride: int = 1) -> torch.Tensor:
    """The node histogram by its definition, in the kernel's order: each
    (tree, slot) segment's rows, ascending, are cut into chunks of
    ``NODE_HIST_CHUNK``; within a chunk the rows one after the other add
    their bf16-rounded stats into the (slot, feature, bin) cells they
    belong to, in f32, and a cell is then the sum of its chunks' partials
    in chunk order. So the kernel matches it to the bit; the oracle at odd
    shapes and, on the card, at the main path's. Same contract as
    ``node_hist_matmul``.

    It runs one step per row place within a chunk: step r adds the r-th
    row of every chunk at once, one indexed add in which no cell is hit
    twice, so each cell still takes its rows one at a time and in order;
    then one step per chunk of the longest segment. Non-finite stats then
    spread as in the plain version (``_nonfinite_lanes``)."""
    S, d = codes.shape
    T = node.shape[1]
    k = len(sw_list)
    dev = codes.device
    ch = NODE_HIST_CHUNK
    sw32 = torch.stack([sw.to(torch.float32) for sw in sw_list])
    sws = sw32.to(torch.bfloat16).to(torch.float32)           # (k, S, T)
    node, codes = node.long(), codes.long()
    ok = (node >= 0) & (node % stride == 0) & (node < stride * Wl)
    slot = torch.where(ok, node // stride, torch.full_like(node, Wl)).T
    # each tree's rows by slot, ascending within a slot (Wl: adds nothing)
    order = torch.sort(slot, dim=1, stable=True).indices      # (T, S)
    sl = slot.gather(1, order)
    counts = torch.zeros((T, Wl + 1), dtype=torch.long, device=dev)
    counts.scatter_add_(1, sl, torch.ones_like(sl))
    start = torch.cumsum(counts, 1) - counts
    place = torch.arange(S, device=dev)[None, :] - start.gather(1, sl)
    n_q = max(1, -(-int(counts[:, :Wl].max()) // ch)) if S else 1
    part = torch.zeros((T, Wl, n_q, k, d, n_bins), dtype=torch.float32,
                       device=dev)
    ks = torch.arange(k, device=dev)[None, :, None]
    fs = torch.arange(d, device=dev)[None, None, :]
    for r in range(min(ch, S)):
        ts, ps = torch.nonzero((sl < Wl) & (place % ch == r), as_tuple=True)
        if not len(ts):
            continue
        s = order[ts, ps]
        c = codes[s][:, None, :].expand(-1, k, -1)             # (n, k, d)
        keep = (c >= 0) & (c < n_bins)
        idx = [x.expand(-1, k, d)[keep] for x in (
            ts[:, None, None], sl[ts, ps][:, None, None],
            (place[ts, ps] // ch)[:, None, None])]
        vals = sws[:, s, ts].T[:, :, None].expand(-1, -1, d)[keep]
        part.index_put_((*idx, ks.expand(len(s), -1, d)[keep],
                         fs.expand(len(s), k, -1)[keep], c[keep]), vals,
                        accumulate=True)
    out = part[:, :, 0]
    for q in range(1, n_q):           # a segment's missing chunks add +0
        out = out + part[:, :, q]
    out = _nonfinite_lanes(out.permute(2, 1, 0, 3, 4), codes, slot.T, sw32,
                           sws, n_bins)
    return out.reshape(k * Wl * T, d * n_bins)


def _nonfinite_lanes(out: torch.Tensor, codes: torch.Tensor,
                     slot: torch.Tensor, sw32: torch.Tensor,
                     sws: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Where the plain version's contraction turns non-finite stats into
    NaN: its operand lane (k, j, t) of row s is bf16(1[slot == j] *
    sw[k, s, t]) and 0 * (+-Inf or NaN) is NaN. So (1) a row whose f32
    stat is not finite makes every lane of (k, t) but its own slot's NaN;
    (2) in a lane, cell (f, b) is NaN when a row of the slot whose rounded
    stat is not finite has codes[s, f] != b (an invalid code included).
    out (k, Wl, T, d, nb) sums, slot (S, T) in [0, Wl] (Wl: adds
    nothing), sw32 the f32 and sws the rounded (k, S, T) stats."""
    k, Wl, T = out.shape[:3]
    dev = out.device
    nan = torch.tensor(float("nan"), device=dev)
    bad = ~torch.isfinite(sw32)
    if bad.any():
        ki, s, t = torch.nonzero(bad, as_tuple=True)
        n_bad = torch.zeros((k, T), device=dev).index_put_(
            (ki, t), torch.ones_like(ki, dtype=torch.float32),
            accumulate=True)
        n_own = torch.zeros((k, Wl + 1, T), device=dev).index_put_(
            (ki, slot[s, t], t), torch.ones_like(ki, dtype=torch.float32),
            accumulate=True)[:, :Wl]
        out = torch.where((n_own < n_bad[:, None])[..., None, None], nan,
                          out)
    bad = ~torch.isfinite(sws) & (slot < Wl)[None]
    if bad.any():
        ki, s, t = torch.nonzero(bad, as_tuple=True)
        j = slot[s, t]
        n_bad = torch.zeros((k, Wl, T), device=dev).index_put_(
            (ki, j, t), torch.ones_like(ki, dtype=torch.float32),
            accumulate=True)
        c = codes[s].long()                                   # (m, d)
        m, f = torch.nonzero((c >= 0) & (c < n_bins), as_tuple=True)
        hit = torch.zeros(out.shape, device=dev).index_put_(
            (ki[m], j[m], t[m], f, c[m, f]),
            torch.ones_like(m, dtype=torch.float32), accumulate=True)
        out = torch.where(hit < n_bad[..., None, None], nan, out)
    return out


def _sort_tile(S: int, T: int, Wl: int) -> int:
    """Rows per tile of the node histogram's sort: about eight (tile,
    tree) blocks an SM, while a tree's (slot, tile) counts stay few enough
    for one block's scan."""
    tiles = max(1, min(-(-1056 // T), 4096 // Wl))
    return max(256, -(-S // tiles))


def node_hist_workspace(S: int, d: int, T: int, k: int, Wl: int,
                        n_bins: int, tile_rows: int) -> tuple:
    """(int32, f32) element counts of the workspaces ``node_hist`` takes
    for these arguments, as its source lays them out."""
    n = (ctypes.c_longlong(), ctypes.c_longlong())
    err = NODE_HIST.entry("node_hist_workspace", [_I] * 8 + [
        ctypes.POINTER(ctypes.c_longlong)] * 2)(
        S, d, T, k, Wl, n_bins, NODE_HIST_CHUNK, tile_rows,
        ctypes.byref(n[0]), ctypes.byref(n[1]))
    if err:
        raise ValueError(f"bad node histogram: S {S}, d {d}, T {T}, k {k}, "
                         f"Wl {Wl}, n_bins {n_bins}, tile rows {tile_rows}")
    return n[0].value, n[1].value


def node_hist_cuda(codes: torch.Tensor, node: torch.Tensor,
                   sw_list: Sequence[torch.Tensor], Wl: int, n_bins: int,
                   stride: int = 1, threads: int = NODE_HIST_THREADS,
                   sort_warps: int = NODE_SORT_WARPS,
                   tile_rows: int | None = None,
                   stage_rows: int = NODE_STAGE_ROWS) -> torch.Tensor:
    """Launch ``node_hist`` (csrc/node_hist.cu) on the current stream:
    codes (S, d) int32, node (S, T) int64, k (S, T) f32 stats, each read
    in place -> (k, Wl, T, d, n_bins) f32. ``threads``, ``sort_warps``,
    ``tile_rows`` and ``stage_rows`` shape the launch and change no
    bit."""
    if not codes.is_cuda:
        raise ValueError(f"node_hist needs CUDA tensors, codes are on "
                         f"{codes.device}")
    dev = codes.device
    S, d = codes.shape
    T = node.shape[1]
    k = len(sw_list)
    expect(codes, "codes", torch.int32, (S, d), dev)
    expect(node, "node", torch.int64, (S, T), dev)
    for i, sw in enumerate(sw_list):
        expect(sw, f"sw_list[{i}]", torch.float32, (S, T), dev)
    if stride not in (1, 2) or Wl < 1 or n_bins < 1:
        raise ValueError(f"bad node histogram: Wl {Wl}, n_bins {n_bins}, "
                         f"stride {stride}")
    if T > 65535:
        raise ValueError(f"{T} trees exceed the kernel's grid")
    tile = tile_rows or _sort_tile(S, T, Wl)
    tiles = -(-S // tile)
    check_int32(S * d, S * T, Wl * tiles + Wl + S, d * n_bins * k)
    out = torch.empty((k, Wl, T, d, n_bins), dtype=torch.float32,
                      device=dev)
    if S == 0 or T == 0 or d == 0 or k == 0:
        return out.zero_()
    n_int, n_float = node_hist_workspace(S, d, T, k, Wl, n_bins, tile)
    iws = torch.empty(n_int, dtype=torch.int32, device=dev)
    fws = torch.empty(n_float, dtype=torch.float32, device=dev)
    sws = (ctypes.c_void_p * k)(*(sw.data_ptr() for sw in sw_list))
    NODE_HIST.launch(ptr(codes), ptr(node), ctypes.cast(sws, ctypes.c_void_p),
                     ptr(iws), ptr(fws), ptr(out), n_int, n_float, S, d, T,
                     k, Wl, n_bins, stride, NODE_HIST_CHUNK, threads, tile,
                     sort_warps, stage_rows, dev.index,
                     torch.cuda.current_stream(dev).cuda_stream)
    return out


def node_hist_matmul(codes: torch.Tensor, node: torch.Tensor,
                     sw_list: Sequence[torch.Tensor], Wl: int, n_bins: int,
                     stride: int = 1) -> torch.Tensor:
    """hist[(k, j, t), f * nb + b] = sum_s bf16(sw_k[s, t]) * 1[node[s, t]
    == stride * j] * 1[codes[s, f] == b], f32.

    codes: (S, d) int bin codes; node: (S, T) int current slot per tree
    (values < 0 never match); sw_list: k (S, T) per-tree stats; ``stride``:
    slot-id multiplier (2 = heap left children). Returns (k * Wl * T,
    d * n_bins) f32, lane (k * Wl + j) * T + t. Non-finite stats spread
    as the masked-stat contraction spreads them (``_nonfinite_lanes``).

    A CUDA tensor goes to the ``node_hist`` kernel, which reads the
    growers' int64 ``node``, their int32 codes and each f32 stat tensor in
    place: nothing is copied unless an input comes in another type or
    layout. A CPU tensor takes the plain version, which pads the tree
    lanes as the JAX package pads them; padded lanes are zero and are cut
    off."""
    if codes.is_cuda:
        out = node_hist_cuda(codes.to(torch.int32).contiguous(),
                             node.to(torch.int64).contiguous(),
                             [sw.to(torch.float32).contiguous()
                              for sw in sw_list], Wl, n_bins, stride)
        return out.reshape(len(sw_list) * Wl * node.shape[1],
                           codes.shape[1] * n_bins)
    if codes.device.type != "cpu":
        raise ValueError(f"no node histogram kernel for device "
                         f"{codes.device}")
    return node_hist_plain(codes, node, sw_list, Wl, n_bins, stride)


def node_hist_plain(codes: torch.Tensor, node: torch.Tensor,
                    sw_list: Sequence[torch.Tensor], Wl: int, n_bins: int,
                    stride: int = 1) -> torch.Tensor:
    """The plain PyTorch version of the ``node_hist`` kernel, for CPU
    tensors and for holding the kernel to: the masked-stat operand over
    tree lanes padded as the JAX package pads them (padded lanes are zero
    and are cut off) and the pinned contraction, as the JAX package's
    ``_node_hist_xla`` computes it. Same contract as
    ``node_hist_matmul``."""
    S, d = codes.shape
    T = node.shape[1]
    k = len(sw_list)
    T_pad = _t_pad128(T)
    rep = max(1, 128 // T_pad)
    Wl_eff = max(Wl, rep)
    if Wl_eff * T_pad % 128:
        Wl_eff = -(-Wl_eff // rep) * rep
    pad = T_pad - T
    node_p = torch.nn.functional.pad(node, (0, pad), value=-1) if pad \
        else node
    sws = torch.stack([torch.nn.functional.pad(sw.to(torch.float32),
                                               (0, pad))
                       for sw in sw_list])
    # the masked-stat operand (S, k * Wl_eff * T_pad), lane (ki * Wl_eff +
    # j) * T_pad + t, and the pinned contraction over it
    j = stride * torch.arange(Wl_eff, dtype=node_p.dtype,
                              device=node_p.device)[None, :, None]
    n_oh = (node_p[:, None, :] == j).to(sws.dtype)     # (S, Wl_eff, T_pad)
    A = torch.cat([n_oh * sws[ki][:, None, :] for ki in range(k)],
                  dim=1).reshape(S, k * Wl_eff * T_pad)
    out = _hist_pinned(codes, A, n_bins)
    if Wl_eff != Wl or pad:
        out = (out.reshape(k, Wl_eff, T_pad, d * n_bins)[:, :Wl, :T]
               .reshape(k * Wl * T, d * n_bins))
    return out
