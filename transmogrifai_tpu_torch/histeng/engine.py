"""Histogram engine (counterpart of ``transmogrifai_tpu.histeng.engine``):
the tree-growth primitive behind one contract. This slice ports the device
backend; the host backend (numpy inputs, streaming growth) waits for the
streaming slice and raises here.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .kernels import hist_matmul, node_hist_matmul


def build_hist(codes: torch.Tensor, A: torch.Tensor, n_bins: int,
               exact: bool = False) -> torch.Tensor:
    """Flat-stat histogram: hist[a, f * nb + b] = sum_s A[s, a] *
    1[codes[s, f] == b]. See ``kernels.hist_matmul``."""
    return hist_matmul(codes, A, n_bins, exact=exact)


def build_node_hist(codes: torch.Tensor, node: torch.Tensor,
                    stats: Sequence[torch.Tensor], n_bins: int, *,
                    n_nodes: int = 1, stride: int = 1) -> torch.Tensor:
    """(node, feature, bin) sufficient statistics: ``codes`` (S, d) bin
    codes, ``node`` (S, T) current slot per tree (values < 0 never match),
    ``stats`` k (S, T) per-tree row statistics, ``stride`` the slot-id
    multiplier (2 = heap left children). Returns (k, n_nodes, T, d,
    n_bins) f32 on the inputs' device."""
    if not isinstance(codes, torch.Tensor) or not isinstance(node,
                                                            torch.Tensor):
        raise NotImplementedError(
            "the host histogram backend (numpy inputs) is not ported yet")
    flat = node_hist_matmul(codes, node, list(stats), n_nodes, n_bins,
                            stride=stride)
    return flat.reshape(len(stats), n_nodes, node.shape[1], codes.shape[1],
                        n_bins)
