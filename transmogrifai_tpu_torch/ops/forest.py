"""Forest descent, predict half (counterpart of
``transmogrifai_tpu.ops.forest``).

Every row is routed down every tree of an ensemble and the leaf values it
reaches are summed::

    out[s, :] = sum_t leaf[t, node(s, t), :]

in two tree layouts: complete heaps (``forest_predict``) and slot chains
(``forest_predict_chain``, any depth at a bounded width W). On a CUDA
tensor each runs its hand-written kernel from ``csrc/forest_predict.cu``;
on a CPU tensor it runs the plain PyTorch version beside it, which walks
the levels with ``torch.gather`` and sums with no matmul. Tensors on any
other device raise.

Routing: go right iff ``codes[s, feat] > bin``; a bin equal to ``n_bins`` is
the "route left" sentinel. The JAX package routes in bfloat16, which is
exact only for codes and slots up to 256, so ``n_bins`` and W above 256
raise here as they do there, although the port compares integers.
"""
from __future__ import annotations

import ctypes
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
    order, as the kernels add them, so both give the same bits."""
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
    return out


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
    "transmogrifai_tpu/ops/forest.py:196",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
FOREST_PREDICT_CHAIN = cuda_build.CudaKernel(
    "forest_predict_chain", "forest_predict.cu",
    "transmogrifai_tpu/ops/forest.py:503",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P])

KERNELS = (FOREST_PREDICT_HEAP, FOREST_PREDICT_CHAIN)


def forest_predict_heap_cuda(codes, feat_heap, bin_heap, leaf, *, depth: int,
                             with_ids: bool = False
                             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch ``forest_predict_heap`` on the current stream. Returns the
    (n, k) sums and, with ``with_ids``, the (n, T) int32 leaf ids."""
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
        FOREST_PREDICT_HEAP.launch(
            ptr(codes), ptr(feat_heap), ptr(bin_heap), ptr(leaf),
            ptr(out), ptr(ids), n, d, T, depth, k, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    return out, ids


def forest_predict_chain_cuda(codes, feat_lv, bin_lv, base_lv, leaf, *,
                              with_ids: bool = False
                              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch ``forest_predict_chain`` on the current stream. Returns the
    (n, k) sums and, with ``with_ids``, the (n, T) int32 leaf slots."""
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
        FOREST_PREDICT_CHAIN.launch(
            ptr(codes), ptr(feat_lv), ptr(bin_lv), ptr(base_lv),
            ptr(leaf), ptr(out), ptr(ids), n, d, T, depth, W, W_out, k,
            dev.index, torch.cuda.current_stream(dev).cuda_stream)
    return out, ids


def _route(codes: torch.Tensor) -> str:
    if codes.is_cuda:
        return "cuda"
    if codes.device.type == "cpu":
        return "cpu"
    raise ValueError(f"no forest kernel for device {codes.device}")


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

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
                                        depth=depth)[0]
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
                                         leaf)[0]
    return forest_predict_chain_plain(codes, feat_lv, bin_lv, base_lv, leaf,
                                      n_bins=n_bins)
