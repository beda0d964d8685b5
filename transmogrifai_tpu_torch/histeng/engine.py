"""Histogram engine (counterpart of ``transmogrifai_tpu.histeng.engine``):
the tree-growth primitive behind one contract, with two backends. Tensors
go to the device backend (``kernels.node_hist_matmul``: the ``node_hist``
kernel on CUDA, its plain version on the CPU); numpy inputs, or
``backend="host"``, go to the host backend (``host``: float64
``np.bincount``, StreamingGBT's level passes).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import kernels as _kernels
from .host import build_node_hist_host
from .kernels import hist_matmul, node_hist_matmul


def chaos_gate(family_name: str) -> None:
    """Fault site ``hist.build``: fires before a tree family's sweep
    builds its histograms; a raise quarantines the family."""
    from ..robustness import faults
    faults.inject("hist.build", key=family_name)


def engine_probe() -> dict:
    """Invariant probe for the oracles' no-leak check
    (``robustness/oracles.histeng_violations``): the full-f32 blocks that
    are open now, 0 between dispatches."""
    return {"tf32_blocks": _kernels._TF32_BLOCKS}


def build_hist(codes: torch.Tensor, A: torch.Tensor, n_bins: int,
               exact: bool = False) -> torch.Tensor:
    """Flat-stat histogram: hist[a, f * nb + b] = sum_s A[s, a] *
    1[codes[s, f] == b]. See ``kernels.hist_matmul``."""
    return hist_matmul(codes, A, n_bins, exact=exact)


def build_node_hist(codes, node, stats: Sequence, n_bins: int, *,
                    n_nodes: int = 1, stride: int = 1,
                    backend: Optional[str] = None):
    """(node, feature, bin) sufficient statistics.

    Device backend (tensors): ``codes`` (S, d) bin codes, ``node`` (S, T)
    current slot per tree (values < 0 never match), ``stats`` k (S, T)
    per-tree row statistics, ``stride`` the slot-id multiplier (2 = heap
    left children). Returns (k, n_nodes, T, d, n_bins) f32 on the inputs'
    device.

    Host backend (numpy integer codes and nodes, or ``backend="host"``):
    ``codes`` (d, n) int64 feature-major from ``host.bin_codes_host``,
    ``node`` (n,) int64, ``stats`` k entries each ``None`` (a count) or an
    (n,) float64 weight vector; stride 1 only. Returns (k, n_nodes, d,
    n_bins) float64.
    """
    if backend not in (None, "host", "device"):
        raise ValueError(f"unknown histogram backend {backend!r}")
    if backend == "host" or (backend is None
                             and isinstance(codes, np.ndarray)
                             and codes.dtype.kind in "iu"
                             and isinstance(node, np.ndarray)):
        if stride != 1:
            raise ValueError("host histogram backend is stride-1 only")
        return build_node_hist_host(codes, node, stats, n_bins, n_nodes)
    if not isinstance(codes, torch.Tensor) or not isinstance(node,
                                                            torch.Tensor):
        raise TypeError("the device histogram backend takes tensors; numpy "
                        "integer codes and nodes take the host backend")
    flat = node_hist_matmul(codes, node, list(stats), n_nodes, n_bins,
                            stride=stride)
    return flat.reshape(len(stats), n_nodes, node.shape[1], codes.shape[1],
                        n_bins)
