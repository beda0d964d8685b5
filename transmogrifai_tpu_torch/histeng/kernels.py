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
same way.

Node histograms (``node_hist_matmul``) stay the pinned matmul contraction
over a masked-stat operand on every device, as in the JAX package, whose
Pallas node-histogram kernel was retired.
"""
from __future__ import annotations

import ctypes
from contextlib import contextmanager
from typing import Sequence

import torch

from ..ops import cuda_build
from ..ops.cuda_build import check_int32, expect, ptr

#: K, the pinned row-block count (the JAX package's TG_HIST_SHARDS default)
HIST_SHARDS = 8

_P, _I = ctypes.c_void_p, ctypes.c_int

HIST_MATMUL = cuda_build.CudaKernel(
    "hist_matmul", "hist.cu", "transmogrifai_tpu/histeng/kernels.py:235",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P])

KERNELS = (HIST_MATMUL,)


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
    ``_hist_pinned`` for direct row reductions of tree fits."""
    K = HIST_SHARDS
    x = torch.movedim(x, dim, 0)
    S = x.shape[0]
    if K <= 1 or S < K:
        return x.sum(0)
    Sp = _pad_to(S, K)
    xp = torch.cat([x, x.new_zeros((Sp - S,) + tuple(x.shape[1:]))])
    return _tree_combine(xp.reshape((K, Sp // K) + tuple(x.shape[1:])).sum(1))


def hist_matmul_plain(codes: torch.Tensor, A: torch.Tensor, n_bins: int,
                      exact: bool = False) -> torch.Tensor:
    """The plain PyTorch version of the ``hist_matmul`` kernel, for CPU
    tensors and for holding the kernel to: the one-hot formula over the
    kernel's K row chunks, combined in the kernel's pinned order. It is
    the pinned contraction that the JAX package runs off the TPU."""
    return _hist_pinned(codes, A, n_bins, exact)


def hist_matmul_cuda(codes: torch.Tensor, A: torch.Tensor, n_bins: int,
                     exact: bool = False) -> torch.Tensor:
    """Launch ``hist_matmul`` (csrc/hist.cu) on the current stream:
    (B, d * n_bins) f32, rows cut into the pinned K chunks."""
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
    part = torch.empty((K, d * n_bins, B), dtype=torch.float32, device=dev)
    HIST_MATMUL.launch(ptr(codes), ptr(A), ptr(part), ptr(out), S, d, B,
                       n_bins, K, rows, int(exact), dev.index,
                       torch.cuda.current_stream(dev).cuda_stream)
    return out


def hist_matmul(codes: torch.Tensor, A: torch.Tensor, n_bins: int,
                exact: bool = False) -> torch.Tensor:
    """hist[a, f * n_bins + b] = sum_s A[s, a] * 1[codes[s, f] == b], f32.

    codes: (S, d) int bin codes in [0, n_bins); a code equal to n_bins is
    a sentinel and adds nothing. A: (S, B) per-row statistics. Returns
    (B, d * n_bins) feature-major. ``exact`` keeps the stats f32 (leaf
    values that are served); growth histograms round them to bf16."""
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


def _node_hist_plain(codes, node, sws, Wl_eff: int, n_bins: int,
                     stride: int, k: int, exact: bool = False):
    """Materialize the masked-stat operand and run the pinned contraction.
    node: (S, T_pad) int (pad -1); sws: (k, S, T_pad). Returns
    (k * Wl_eff * T_pad, d * nb)."""
    S, T_pad = node.shape
    j = stride * torch.arange(Wl_eff, dtype=node.dtype,
                              device=node.device)[None, :, None]
    n_oh = (node[:, None, :] == j).to(sws.dtype)         # (S, Wl_eff, T_pad)
    A = torch.cat([n_oh * sws[ki][:, None, :] for ki in range(k)],
                  dim=1).reshape(S, k * Wl_eff * T_pad)
    return _hist_pinned(codes, A, n_bins, exact)


def node_hist_matmul(codes: torch.Tensor, node: torch.Tensor,
                     sw_list: Sequence[torch.Tensor], Wl: int, n_bins: int,
                     stride: int = 1) -> torch.Tensor:
    """hist[(k, j, t), f * nb + b] = sum_s sw_k[s, t] * 1[node[s, t] ==
    stride * j] * 1[codes[s, f] == b], as one contraction over the
    masked-stat operand.

    codes: (S, d) int bin codes; node: (S, T) int current slot per tree
    (values < 0 never match); sw_list: k (S, T) per-tree stats; ``stride``:
    slot-id multiplier (2 = heap left children). Returns (k * Wl * T,
    d * n_bins) f32, lane (k * Wl + j) * T + t. The tree lanes are padded as
    the JAX package pads them; padded lanes are zero and are cut off."""
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
    out = _node_hist_plain(codes, node_p, sws, Wl_eff, n_bins, stride, k)
    if Wl_eff != Wl or pad:
        out = (out.reshape(k, Wl_eff, T_pad, d * n_bins)[:, :Wl, :T]
               .reshape(k * Wl * T, d * n_bins))
    return out
