"""Forest descent (counterpart of ``transmogrifai_tpu.ops.forest``).

Every row is routed down every tree of an ensemble, and then either the
leaf values it reaches are summed (predict)::

    out[s, :] = sum_t leaf[t, node(s, t), :]

or per-row statistics are summed per (tree, leaf) (the exact leaf
statistics of a refit)::

    sums[t, l, :] = sum_s aug[s, :] * 1[node(s, t) == l]

in two tree layouts: complete heaps (``forest_predict``,
``forest_leaf_sums``) and slot chains (``forest_predict_chain``,
``forest_leaf_sums_chain``, any depth at a bounded width W). On a CUDA
tensor each runs its hand-written kernel from ``csrc/forest_predict.cu``;
on a CPU tensor it runs the plain PyTorch version beside it, which walks
the levels with ``torch.gather`` and sums with no matmul. Tensors on any
other device raise. The JAX package cuts the trees into groups for its
Pallas kernels (at most 128 heap trees of depth <= 7, 32 chain trees per
call); those are limits of the TPU's memory layout, not of the function,
and the kernels here take any tree count and any heap depth <= 8.

Routing: go right iff ``codes[s, feat] > bin``; a bin equal to ``n_bins`` is
the "route left" sentinel. The JAX package routes in bfloat16, which is
exact only for codes and slots up to 256, so ``n_bins`` and W above 256
raise here as they do there, although the port compares integers.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import cuda_build
from .cuda_build import check_int32, expect, ptr

_MAX_BINS = 256
_MAX_SLOTS = 256


def _check_bins(n_bins: int) -> None:
    """The JAX package routes bin codes in bfloat16, which represents
    integers exactly only up to 256."""
    if n_bins > _MAX_BINS:
        raise ValueError(
            f"n_bins={n_bins} > 256: bin codes are routed in bfloat16, "
            f"which is exact only for codes <= 256")


def _check_slots(W: int) -> None:
    if W > _MAX_SLOTS:
        raise ValueError(
            f"n_slots={W} > {_MAX_SLOTS}: slot ids are accumulated in "
            f"bfloat16 lanes, exact only up to 256")


def _chain_widths(depth: int, W: int):
    """Level l of a slot chain uses its first min(2^l, W) slots."""
    return [min(2 ** level, W) for level in range(depth)]


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and what the kernels are held to)
# ---------------------------------------------------------------------------

def _codes_at(codes: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """codes[s, f[s, t]] for (n, T) feature ids; ids outside [0, d) read 0,
    as the JAX package's one-hot gather does."""
    d = codes.shape[1]
    ok = (f >= 0) & (f < d)
    got = torch.gather(codes, 1, f.clamp(0, max(d - 1, 0)))
    return torch.where(ok, got, torch.zeros_like(got))


def _table_at(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[t, idx[s, t]] for a (T, m) table and (n, T) indices."""
    n = idx.shape[0]
    return torch.gather(table.unsqueeze(0).expand(n, -1, -1), 2,
                        idx.unsqueeze(2)).squeeze(2)


def route_codes(codes: torch.Tensor, feat_heap: torch.Tensor,
                bin_heap: torch.Tensor, depth: int,
                n_bins: int) -> torch.Tensor:
    """(n, T) int32 leaf ids of complete-heap trees (counterpart of the JAX
    package's ``route_codes_xla``). feat_heap/bin_heap: (T, 2^depth - 1)."""
    n, T = codes.shape[0], feat_heap.shape[0]
    feat = feat_heap.long()
    node = torch.zeros((n, T), dtype=torch.long, device=codes.device)
    for level in range(depth):
        j = node + (2 ** level - 1)
        go = _codes_at(codes, _table_at(feat, j)) > _table_at(bin_heap, j)
        node = 2 * node + go.long()
    return node.int()


def route_codes_chain(codes: torch.Tensor, feat_lv: torch.Tensor,
                      bin_lv: torch.Tensor, base_lv: torch.Tensor,
                      n_bins: int) -> torch.Tensor:
    """(n, T) int32 leaf slots of slot-chain trees (counterpart of the JAX
    package's ``route_codes_chain_xla``). Tables: (T, depth, W)."""
    n = codes.shape[0]
    T, depth, W = feat_lv.shape
    feat = feat_lv.long()
    slot = torch.zeros((n, T), dtype=torch.long, device=codes.device)
    for level, Wl in enumerate(_chain_widths(depth, W)):
        live = slot < Wl                  # a slot past the level reads 0
        s = torch.where(live, slot, torch.zeros_like(slot))
        go = (_codes_at(codes, _table_at(feat[:, level], s))
              > _table_at(bin_lv[:, level], s))
        nxt = _table_at(base_lv[:, level].long(), s) + go.long()
        slot = torch.where(live, nxt, torch.zeros_like(nxt))
    return slot.int()


def leaf_values(ids: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """sum_t leaf[t, ids[s, t], :] -> (n, k) float32; an id outside the
    leaf table adds nothing. Trees are added one at a time in ascending
    order, as the kernels add them, so both give the same bits.

    Non-finite leaves spread as in the JAX package's one-hot contraction,
    where every leaf meets every row: a column with a NaN leaf is NaN in
    every row, and a row that misses one of the column's +-Inf leaves
    (0 * Inf) is NaN; a row that reaches them all gets the float sum."""
    T, L, k = leaf.shape
    ids = ids.long()
    ok = (ids >= 0) & (ids < L)
    v = leaf[torch.arange(T, device=leaf.device).unsqueeze(0),
             torch.where(ok, ids, torch.zeros_like(ids))]     # (n, T, k)
    v = torch.where(ok.unsqueeze(2), v, torch.zeros_like(v))
    out = torch.zeros((ids.shape[0], k), dtype=torch.float32,
                      device=leaf.device)
    for t in range(T):
        out += v[:, t]
    if bool(torch.isfinite(leaf).all()):
        return out
    inf = torch.isinf(leaf)
    nan = (torch.isnan(leaf).any(0).any(0)
           | (torch.isinf(v).sum(1) != inf.sum(0).sum(0)))
    return torch.where(nan, torch.full_like(out, float("nan")), out)


def leaf_sums(ids: torch.Tensor, aug: torch.Tensor, L: int) -> torch.Tensor:
    """sum_s aug[s, :] * 1[ids[s, t] == l] -> (T, L, k) float32; an id
    outside [0, L) adds nothing. Each (tree, leaf) adds its rows one at a
    time in ascending row order (``index_add_`` on the CPU). Non-finite
    stats spread as ``spread_nonfinite_sums`` says."""
    T = ids.shape[1]
    k = aug.shape[1]
    ids = ids.long()
    ok = (ids >= 0) & (ids < L)
    cell = torch.where(ok, ids + L * torch.arange(T, device=ids.device),
                       torch.full_like(ids, T * L))
    out = torch.zeros((T * L + 1, k), dtype=torch.float32, device=aug.device)
    out.index_add_(0, cell.reshape(-1),
                   aug.to(torch.float32).repeat_interleave(T, dim=0))
    return spread_nonfinite_sums(out[:T * L].reshape(T, L, k), ids, aug)


def spread_nonfinite_sums(sums: torch.Tensor, ids: torch.Tensor,
                          aug: torch.Tensor) -> torch.Tensor:
    """Leaf sums (T, L, k) with the cells that non-finite stats reach made
    NaN, as in the JAX package's one-hot contraction, where every row meets
    every (tree, leaf) cell: a NaN stat makes its stat column NaN in every
    cell, and a +-Inf stat every cell of each tree but the leaf its row
    reaches there (0 * Inf; a row whose id is outside [0, L) reaches none).
    A cell that every such row of its tree reaches keeps its float sum."""
    T, L, k = sums.shape
    aug = aug.to(torch.float32)
    if bool(torch.isfinite(aug).all()):
        return sums
    ids = ids.long()
    leaf = torch.where((ids >= 0) & (ids < L), ids,
                       torch.full_like(ids, L))[:, :, None]     # (n, T, 1)
    inf = torch.isinf(aug)[:, None, :]                          # (n, 1, k)
    lo = torch.where(inf, leaf, torch.full_like(leaf, L + 1)).amin(0)
    hi = torch.where(inf, leaf, torch.full_like(leaf, -1)).amax(0)
    cell = torch.arange(L, device=sums.device)[None, :, None]
    keep = (hi < 0)[:, None] | ((lo == hi)[:, None] & (hi[:, None] == cell))
    nan = torch.isnan(aug).any(0)[None, None, :] | ~keep
    return torch.where(nan, torch.full_like(sums, float("nan")), sums)


def forest_leaf_sums_plain(codes, feat_heap, bin_heap, aug, *, depth: int,
                           n_bins: int) -> torch.Tensor:
    return leaf_sums(route_codes(codes, feat_heap, bin_heap, depth, n_bins),
                     aug, 2 ** depth)


def forest_leaf_sums_chain_plain(codes, feat_lv, bin_lv, base_lv, aug, *,
                                 n_bins: int) -> torch.Tensor:
    _, depth, W = feat_lv.shape
    return leaf_sums(route_codes_chain(codes, feat_lv, bin_lv, base_lv,
                                       n_bins), aug, min(2 ** depth, W))


def forest_predict_plain(codes, feat_heap, bin_heap, leaf, *, depth: int,
                         n_bins: int) -> torch.Tensor:
    return leaf_values(route_codes(codes, feat_heap, bin_heap, depth,
                                   n_bins), leaf)


def forest_predict_chain_plain(codes, feat_lv, bin_lv, base_lv, leaf, *,
                               n_bins: int) -> torch.Tensor:
    return leaf_values(route_codes_chain(codes, feat_lv, bin_lv, base_lv,
                                         n_bins), leaf)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int

#: ``replaces`` is the file:line of the Pallas kernel function each ports
FOREST_PREDICT_HEAP = cuda_build.CudaKernel(
    "forest_predict_heap", "forest_predict.cu",
    "transmogrifai_tpu/ops/forest.py:196", [_P] * 7 + [_I] * 7 + [_P])
FOREST_PREDICT_CHAIN = cuda_build.CudaKernel(
    "forest_predict_chain", "forest_predict.cu",
    "transmogrifai_tpu/ops/forest.py:503", [_P] * 8 + [_I] * 9 + [_P])

FOREST_LEAF_SUMS_HEAP = cuda_build.CudaKernel(
    "forest_leaf_sums_heap", "forest_predict.cu",
    "transmogrifai_tpu/ops/forest.py:141",
    [_P] * 6 + [_I] * 9 + [_P])
FOREST_LEAF_SUMS_CHAIN = cuda_build.CudaKernel(
    "forest_leaf_sums_chain", "forest_predict.cu",
    "transmogrifai_tpu/ops/forest.py:450",
    [_P] * 7 + [_I] * 11 + [_P])

KERNELS = (FOREST_PREDICT_HEAP, FOREST_PREDICT_CHAIN, FOREST_LEAF_SUMS_HEAP,
           FOREST_LEAF_SUMS_CHAIN)

#: the leaf-sum kernels' row tile (threads per block) and most row chunks
_SUM_ROWS = 128
_SUM_MAX_CHUNKS = 64


@functools.lru_cache(maxsize=None)
def workspace(T: int, depth: int, W: int, W_out: int, k: int,
              n_chunks: int = 0) -> int:
    """int32 words of the workspace a forest kernel takes for T trees (W 0:
    heaps of this depth) with W_out leaves of k values: the packed split
    records and the non-finite counts of a predict (n_chunks 0) or, with
    the leaf sums' row chunks, also their flags and chunk partials, as the
    source lays them out."""
    words = ctypes.c_longlong()
    if FOREST_PREDICT_HEAP.entry("forest_workspace", [
            _I] * 6 + [ctypes.POINTER(ctypes.c_longlong)])(
                T, depth, W, W_out, k, n_chunks, ctypes.byref(words)):
        raise ValueError(f"bad forest: T {T}, depth {depth}, W {W}, W_out "
                         f"{W_out}, k {k}, {n_chunks} chunks")
    return words.value


def row_chunks(n: int) -> Tuple[int, int]:
    """(chunk count, rows per chunk) of the leaf-sum kernels. It depends on
    the row count alone, so a sum never depends on how the trees are
    tiled."""
    c = max(1, min(_SUM_MAX_CHUNKS, -(-n // _SUM_ROWS)))
    rpc = max(1, -(-n // c))
    return max(1, -(-n // rpc)), rpc


def forest_predict_heap_cuda(codes, feat_heap, bin_heap, leaf, *, depth: int,
                             n_bins: int, with_ids: bool = False
                             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch ``forest_predict_heap`` on the current stream. Returns the
    (n, k) sums and, with ``with_ids``, the (n, T) int32 leaf ids. Codes
    lie in [0, n_bins)."""
    if not codes.is_cuda:
        raise ValueError(f"forest_predict_heap needs CUDA tensors, codes are "
                         f"on {codes.device}")
    dev = codes.device
    n, d = codes.shape
    T, L, k = leaf.shape
    if L != 2 ** depth:
        raise ValueError(f"leaf has {L} leaves, depth {depth} has "
                         f"{2 ** depth}")
    expect(codes, "codes", torch.int32, (n, d), dev)
    expect(feat_heap, "feat_heap", torch.int32, (T, L - 1), dev)
    expect(bin_heap, "bin_heap", torch.int32, (T, L - 1), dev)
    expect(leaf, "leaf", torch.float32, (T, L, k), dev)
    check_int32(n * d, n * k, n * T, T * L * k)
    out = torch.empty((n, k), dtype=torch.float32, device=dev)
    ids = (torch.empty((n, T), dtype=torch.int32, device=dev)
           if with_ids else None)
    if n:
        rec = torch.empty(workspace(T, depth, 0, L, k), dtype=torch.int32,
                          device=dev)
        FOREST_PREDICT_HEAP.launch(
            ptr(codes), ptr(feat_heap), ptr(bin_heap), ptr(leaf),
            ptr(out), ptr(ids), ptr(rec), n, d, T, depth, k, n_bins,
            dev.index, torch.cuda.current_stream(dev).cuda_stream)
    return out, ids


def forest_predict_chain_cuda(codes, feat_lv, bin_lv, base_lv, leaf, *,
                              n_bins: int, with_ids: bool = False
                              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch ``forest_predict_chain`` on the current stream. Returns the
    (n, k) sums and, with ``with_ids``, the (n, T) int32 leaf slots; as
    ``forest_predict_heap_cuda`` otherwise."""
    if not codes.is_cuda:
        raise ValueError(f"forest_predict_chain needs CUDA tensors, codes "
                         f"are on {codes.device}")
    dev = codes.device
    n, d = codes.shape
    T, depth, W = feat_lv.shape
    W_out, k = leaf.shape[1], leaf.shape[2]
    if W < 1:
        raise ValueError("slot chains need at least one slot")
    expect(codes, "codes", torch.int32, (n, d), dev)
    for name, t in (("feat_lv", feat_lv), ("bin_lv", bin_lv),
                    ("base_lv", base_lv)):
        expect(t, name, torch.int32, (T, depth, W), dev)
    expect(leaf, "leaf", torch.float32, (T, W_out, k), dev)
    check_int32(n * d, n * k, n * T, T * depth * W, T * W_out * k)
    out = torch.empty((n, k), dtype=torch.float32, device=dev)
    ids = (torch.empty((n, T), dtype=torch.int32, device=dev)
           if with_ids else None)
    if n:
        rec = torch.empty(workspace(T, depth, W, W_out, k),
                          dtype=torch.int32, device=dev)
        FOREST_PREDICT_CHAIN.launch(
            ptr(codes), ptr(feat_lv), ptr(bin_lv), ptr(base_lv),
            ptr(leaf), ptr(out), ptr(ids), ptr(rec), n, d, T, depth, W,
            W_out, k, n_bins, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    return out, ids


def forest_leaf_sums_heap_cuda(codes, feat_heap, bin_heap, aug, *,
                               depth: int, n_bins: int) -> torch.Tensor:
    """Launch ``forest_leaf_sums_heap`` on the current stream: (T, 2^depth,
    k) float32 sums, rows in ``row_chunks(n)`` chunks added in order (the
    order of ``testing.leaf_sums_chunked``). Codes lie in [0, n_bins)."""
    if not codes.is_cuda:
        raise ValueError(f"forest_leaf_sums_heap needs CUDA tensors, codes "
                         f"are on {codes.device}")
    dev = codes.device
    n, d = codes.shape
    T = feat_heap.shape[0]
    k = aug.shape[1]
    if not 0 <= depth <= 8:
        raise ValueError(f"heap depth {depth} is outside [0, 8]")
    L = 2 ** depth
    expect(codes, "codes", torch.int32, (n, d), dev)
    expect(feat_heap, "feat_heap", torch.int32, (T, L - 1), dev)
    expect(bin_heap, "bin_heap", torch.int32, (T, L - 1), dev)
    expect(aug, "aug", torch.float32, (n, k), dev)
    n_chunks, rpc = row_chunks(n)
    check_int32(n * d, n * k, n_chunks * T * L * k)
    if not (n and T and k):
        return torch.zeros((T, L, k), dtype=torch.float32, device=dev)
    out = torch.empty((T, L, k), dtype=torch.float32, device=dev)
    ws = torch.empty(workspace(T, depth, 0, L, k, n_chunks),
                     dtype=torch.int32, device=dev)
    FOREST_LEAF_SUMS_HEAP.launch(
        ptr(codes), ptr(feat_heap), ptr(bin_heap), ptr(aug), ptr(ws),
        ptr(out), n, d, T, depth, k, n_bins, n_chunks, rpc, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    return out


def forest_leaf_sums_chain_cuda(codes, feat_lv, bin_lv, base_lv, aug, *,
                                n_bins: int) -> torch.Tensor:
    """Launch ``forest_leaf_sums_chain`` on the current stream: (T, W_out,
    k) float32 sums with W_out = min(2^depth, W); as
    ``forest_leaf_sums_heap_cuda`` otherwise."""
    if not codes.is_cuda:
        raise ValueError(f"forest_leaf_sums_chain needs CUDA tensors, codes "
                         f"are on {codes.device}")
    dev = codes.device
    n, d = codes.shape
    T, depth, W = feat_lv.shape
    k = aug.shape[1]
    if W < 1:
        raise ValueError("slot chains need at least one slot")
    W_out = min(2 ** depth, W)
    expect(codes, "codes", torch.int32, (n, d), dev)
    for name, t in (("feat_lv", feat_lv), ("bin_lv", bin_lv),
                    ("base_lv", base_lv)):
        expect(t, name, torch.int32, (T, depth, W), dev)
    expect(aug, "aug", torch.float32, (n, k), dev)
    n_chunks, rpc = row_chunks(n)
    check_int32(n * d, n * k, T * depth * W, n_chunks * T * W_out * k)
    if not (n and T and k):
        return torch.zeros((T, W_out, k), dtype=torch.float32, device=dev)
    out = torch.empty((T, W_out, k), dtype=torch.float32, device=dev)
    ws = torch.empty(workspace(T, depth, W, W_out, k, n_chunks),
                     dtype=torch.int32, device=dev)
    FOREST_LEAF_SUMS_CHAIN.launch(
        ptr(codes), ptr(feat_lv), ptr(bin_lv), ptr(base_lv), ptr(aug),
        ptr(ws), ptr(out), n, d, T, depth, W, W_out, k, n_bins, n_chunks,
        rpc, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    return out


def _route(codes: torch.Tensor) -> str:
    if codes.is_cuda:
        return "cuda"
    if codes.device.type == "cpu":
        return "cpu"
    raise ValueError(f"no forest kernel for device {codes.device}")


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def forest_leaf_sums(codes: torch.Tensor, feat_heap: torch.Tensor,
                     bin_heap: torch.Tensor, aug: torch.Tensor, *,
                     depth: int, n_bins: int) -> torch.Tensor:
    """Exact leaf statistics of complete-heap trees in one fused pass.

    codes: (n, d) int32 bin codes; feat_heap/bin_heap: (T, 2^depth - 1)
    int32 (sentinel bin >= n_bins: route left); aug: (n, k) float32
    per-row statistics (zero rows add nothing). Returns (T, 2^depth, k)
    float32: the sums of aug over the rows that land in each (tree,
    leaf)."""
    _check_bins(n_bins)
    if _route(codes) == "cuda":
        return forest_leaf_sums_heap_cuda(
            codes.to(torch.int32).contiguous(), feat_heap.contiguous(),
            bin_heap.contiguous(), aug.to(torch.float32).contiguous(),
            depth=depth, n_bins=n_bins)
    return forest_leaf_sums_plain(codes, feat_heap, bin_heap, aug,
                                  depth=depth, n_bins=n_bins)


def forest_leaf_sums_chain(codes: torch.Tensor, feat_lv: torch.Tensor,
                           bin_lv: torch.Tensor, base_lv: torch.Tensor,
                           aug: torch.Tensor, *, n_bins: int) -> torch.Tensor:
    """Exact leaf statistics of slot-chain trees in one fused pass.

    feat_lv/bin_lv/base_lv: (T, depth, W) int32 per-level slot tables
    (level l uses the first min(2^l, W) slots); aug: (n, k) float32.
    Returns (T, W_out, k) float32 with W_out = min(2^depth, W)."""
    _check_bins(n_bins)
    _check_slots(feat_lv.shape[2])
    if _route(codes) == "cuda":
        return forest_leaf_sums_chain_cuda(
            codes.to(torch.int32).contiguous(), feat_lv.contiguous(),
            bin_lv.contiguous(), base_lv.contiguous(),
            aug.to(torch.float32).contiguous(), n_bins=n_bins)
    return forest_leaf_sums_chain_plain(codes, feat_lv, bin_lv, base_lv, aug,
                                        n_bins=n_bins)


def forest_predict(codes: torch.Tensor, feat_heap: torch.Tensor,
                   bin_heap: torch.Tensor, leaf: torch.Tensor, *,
                   depth: int, n_bins: int) -> torch.Tensor:
    """sum_t leaf[t, node(row, t), :] for complete-heap trees.

    codes: (n, d) int32 bin codes; feat_heap/bin_heap: (T, 2^depth - 1)
    int32; leaf: (T, 2^depth, k) float32 with any per-tree weighting baked
    in. Returns (n, k) float32."""
    _check_bins(n_bins)
    if _route(codes) == "cuda":
        return forest_predict_heap_cuda(codes, feat_heap, bin_heap, leaf,
                                        depth=depth, n_bins=n_bins)[0]
    return forest_predict_plain(codes, feat_heap, bin_heap, leaf,
                                depth=depth, n_bins=n_bins)


def forest_predict_chain(codes: torch.Tensor, feat_lv: torch.Tensor,
                         bin_lv: torch.Tensor, base_lv: torch.Tensor,
                         leaf: torch.Tensor, *, n_bins: int) -> torch.Tensor:
    """sum_t leaf[t, slot(row, t), :] for slot-chain trees.

    feat_lv/bin_lv/base_lv: (T, depth, W) int32 per-level slot tables;
    leaf: (T, min(2^depth, W), k) float32. Returns (n, k) float32."""
    _check_bins(n_bins)
    _check_slots(feat_lv.shape[2])
    if _route(codes) == "cuda":
        return forest_predict_chain_cuda(codes, feat_lv, bin_lv, base_lv,
                                         leaf, n_bins=n_bins)[0]
    return forest_predict_chain_plain(codes, feat_lv, bin_lv, base_lv, leaf,
                                      n_bins=n_bins)
