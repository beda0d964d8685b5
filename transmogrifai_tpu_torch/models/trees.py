"""Tree model families (counterpart of ``transmogrifai_tpu.models.trees``):
the decision-tree, random-forest, gradient-boosted and XGBoost-style
classifiers and regressors fit and score on a device, at any maxDepth
(complete heaps up to depth 8, slot chains beyond). Classifiers take
binary and multiclass labels (the GBT classifier binary only, as in the
reference).

Features are binned as the JAX package bins them, ``bin(x) = #{edges < x}``
with ``n_bins = edges.shape[-1] + 1``, and routed by bin code. A fitted
forest comes in one of two layouts: complete heaps (``feat``/``bins``,
depth <= 8) or slot chains (``feat_lv``/``bins_lv``/``base_lv``, the
depth-12 refits).

Growth (``_grow_forest``, and ``_grow_forest_capped`` for slot chains of
any depth at a bounded width) follows the JAX package step for step: the
split search of each level is one node histogram (``histeng``), a cumsum
over bins and an argmax; routing compares each row's code of the chosen
feature with the chosen bin. GBT trains on the split-search sample; the
refit's Newton leaves are exact per-tree segment sums through the
``hist_matmul`` kernel (``_diag_leaf_hist``), the CV sweep's come off the
last level's histogram. RF and DT sweeps take their leaves from the
sample the same way; their refits route every row through the fused
leaf-sum kernels (``forest_leaf_sums``, ``forest_leaf_sums_chain``). RF
bootstrap weights and feature subsets are the JAX package's threefry
draws, bit for bit (``bootstrap.py``).

Arithmetic that must match the JAX package to the bit is written out:
the quantile edges and the boosting update ``F + eta * pred`` are fused
multiply-adds there (XLA on the CPU contracts them), computed here in f64,
where the product is exact, and rounded once to f32. Where the platforms
differ anyway (``exp`` inside the sigmoid, f32 sums in another order),
results agree to f32 rounding; the tests state those tolerances.

``predict_batch`` scores stacked configurations (a leading config axis),
``predict_config`` one configuration.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..histeng import build_hist, build_node_hist, pinned_row_sum
from ..ops.forest import (
    _chain_widths, _check_slots, forest_leaf_sums, forest_leaf_sums_chain,
    forest_predict, forest_predict_chain,
)
from ..ops.xla_cpu import fma32, xla_softmax
from . import bootstrap
from .api import FittedParams, ModelFamily, register_family

logger = logging.getLogger(__name__)

N_BINS = 32  # Spark maxBins default

#: split-search sample cap of a refit (evenly strided rows)
_HIST_SAMPLE = 65536

#: split-search sample cap of a CV-sweep fit
_SWEEP_HIST_SAMPLE = 8192

#: RF trees / boosting rounds CV candidates rank with; the winner refits
#: at its full numTrees / maxIter
_SWEEP_RF_TREES = 16
_SWEEP_GBT_ROUNDS = 12

#: per-level histogram element budget (f32) that bounds a config chunk
_LEVEL_HIST_ELEMS = 1 << 28

#: (sample rows x trees x level lanes) element budget of an RF/DT config
#: chunk
_CFG_CHUNK_ELEMS = 1 << 30

#: the slot-chain grower reconstructs odd slots by sibling subtraction
#: only for tree batches at least this wide
_CHAIN_SIBLING_MIN_TB = 128

#: the reference's default maxDepth values
_DEPTHS = (3, 6, 12)

#: slot-chain leaf budgets: CV-sweep candidates, and served refits
_SWEEP_SLOTS = 64
_REFIT_SLOTS = 256

#: trees per ``_diag_leaf_hist`` histogram call
_DIAG_BLOCK = 64

#: deepest tree grown as a complete heap; deeper trees are slot chains
_MAX_HEAP_DEPTH = 8

#: saved parameter keys the predict path reads, with their dtypes
_INT_KEYS = ("feat", "bins", "feat_lv", "bins_lv", "base_lv")
_FLOAT_KEYS = ("leaf", "tree_mask", "edges", "f0", "eta")

_INF = float("inf")


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------

def _quantile_edges(X: torch.Tensor, n_bins: int,
                    fused_gather: bool = False) -> torch.Tensor:
    """Per-feature quantile bin edges (d, n_bins - 1), as
    ``jnp.quantile(X, linspace(0, 1, n_bins + 1)[1:-1], axis=0)`` gives
    them: quantile i / n_bins in f32 at position q * (n - 1), linear
    interpolation low * (1 - w) + high * w with the low product fused into
    the add (one rounding). A column holding a NaN gets NaN edges.

    ``fused_gather``: the edges as XLA evaluates them where it fuses the
    quantile into the growers' split-threshold gather: the high product is
    the one fused into the add (see ``_thr_table``)."""
    n = X.shape[0]
    qs = torch.arange(1, n_bins, dtype=torch.float32,
                      device=X.device) / float(n_bins)
    pos = qs * float(n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    srt = torch.sort(X, dim=0).values
    lv = srt[low.clamp(0, n - 1).long()]
    hv = srt[high.clamp(0, n - 1).long()]
    if fused_gather:
        out = ((lv * lw[:, None]).double()
               + hv.double() * hw.double()[:, None]).float()
    else:
        out = (lv.double() * lw.double()[:, None]
               + (hv * hw[:, None]).double()).float()
    out = torch.where(torch.isnan(X).any(0)[None, :],
                      torch.full_like(out, float("nan")), out)
    return out.T.contiguous()


def _bin_features(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """bin(x) = #{edges < x} in [0, n_bins - 1], shape (n, d) int32: one
    elementwise comparison pass."""
    return (X.unsqueeze(2) > edges.unsqueeze(0)).sum(2, dtype=torch.int32)


def _sample_rows(n: int, cap: int = _HIST_SAMPLE) -> np.ndarray:
    """Deterministic strided sample indices for split search."""
    if n <= cap:
        return np.arange(n)
    return np.linspace(0, n - 1, cap).astype(np.int64)


# ---------------------------------------------------------------------------
# Growth
# ---------------------------------------------------------------------------

def _split_gain(SL, SR, total, cfg, mode: str):
    """Gain and validity of every candidate split.

    SL/SR: (m, d, n_bins - 1, k) left/right stats; total: (m, k); cfg
    values are (m,) tensors, one entry per node. Mode 'gh' (stats = grad,
    hess, count): Newton gain normalized by the parent count. Mode
    'counts' (per-class weighted counts): Gini gain."""
    def bc(v):
        return v[:, None, None]

    if mode == "gh":
        lam_v = cfg["lam"]
        lam = bc(lam_v)
        GL, HL, CL = SL[..., 0], SL[..., 1], SL[..., 2]
        GR, HR, CR = SR[..., 0], SR[..., 1], SR[..., 2]
        GP, HP, CP = total[:, 0], total[:, 1], total[:, 2]

        def score(G, H, l):
            return G * G / (H + l + 1e-12)

        raw = (score(GL, HL, lam) + score(GR, HR, lam)
               - score(GP, HP, lam_v)[:, None, None])
        gain = raw / torch.clamp(CP, min=1.0)[:, None, None]
        mcw = bc(cfg["min_child_weight"])
        mi = torch.clamp(bc(cfg["min_instances"]), min=1e-6)
        valid = (CL >= mi) & (CR >= mi) & (HL >= mcw) & (HR >= mcw)
        return gain, valid
    wL, wR, wP = SL.sum(-1), SR.sum(-1), total.sum(-1)

    def gini(S, W):
        # 1 - sum_c p_c^2, the squares accumulated class by class with
        # fused multiply-adds, as XLA on the CPU computes it
        p = (S / torch.clamp(W, min=1e-12)[..., None]).double()
        acc = torch.zeros_like(p[..., 0])
        for c in range(p.shape[-1]):
            acc = (p[..., c] * p[..., c] + acc).float().double()
        return 1.0 - acc.float()

    impP = gini(total, wP)[:, None, None]
    wPn = torch.clamp(wP, min=1e-12)[:, None, None]
    # impP - (wL / wPn) * giniL - (wR / wPn) * giniR, each product fused
    # into its subtraction
    t = (impP.double() - (wL / wPn).double() * gini(SL, wL).double()).float()
    gain = (t.double() - (wR / wPn).double() * gini(SR, wR).double()).float()
    mi = torch.clamp(bc(cfg["min_instances"]), min=1e-6)
    return gain, (wL >= mi) & (wR >= mi)


#: XLA on the CPU computes a cumulative sum of more than this many elements
#: in blocks of this many (a sequential sum within each block, plus the
#: sequential sum of the earlier blocks' totals)
_CUMSUM_BLOCK = 16


def _seq_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Prefix sums along ``dim``, added one element at a time in float32.
    On the card ``torch.cumsum`` over a dimension other than the last does
    exactly that (one thread per line with a float32 accumulator), in one
    launch; on the CPU it accumulates in float64, so the adds are spelled
    out there."""
    if x.is_cuda and x.dtype == torch.float32 and dim < x.dim() - 1 \
            and x.numel() != x.shape[dim]:
        return torch.cumsum(x, dim)
    out = x.clone()
    for i in range(1, x.shape[dim]):
        out.select(dim, i).add_(out.select(dim, i - 1))
    return out


def _cumsum_bins(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over axis 2 (the bins) in the JAX package's float32
    order: sequential up to ``_CUMSUM_BLOCK`` elements, blocked beyond."""
    n = x.shape[2]
    if n <= _CUMSUM_BLOCK:
        return _seq_cumsum(x, 2)
    nb = -(-n // _CUMSUM_BLOCK)
    pad = torch.zeros(x.shape[:2] + (nb * _CUMSUM_BLOCK - n,) + x.shape[3:],
                      dtype=x.dtype, device=x.device)
    blocks = torch.cat([x, pad], dim=2).reshape(
        x.shape[:2] + (nb, _CUMSUM_BLOCK) + x.shape[3:])
    inner = _seq_cumsum(blocks, 3)
    outer = _cumsum_bins(inner.select(3, _CUMSUM_BLOCK - 1))
    excl = torch.cat([torch.zeros_like(outer[:, :, :1]), outer[:, :, :-1]],
                     dim=2)
    out = inner + excl.unsqueeze(3)
    return out.reshape(x.shape[:2] + (-1,) + x.shape[3:])[:, :, :n]


def _grow_forest(codes_s, edges, sw_list, fmasks, cfg, *, depth: int,
                 n_bins: int, mode: str, return_leaf_stats: bool = False):
    """Grow Tb complete-heap trees at once on the split-search sample.

    codes_s: (S, d) int32 bin codes; sw_list: k (S, Tb) per-tree
    stat * row-weight products; fmasks: (Tb, d) bool feature subsets; cfg:
    (Tb,) f32 per-tree scalars {max_depth, min_instances, min_info_gain,
    lam, min_child_weight}. Lanes are j-major (lane = j * Tb + t), as in
    the JAX package. Each level histograms only the left children and takes
    the right ones as parent - left (sibling subtraction). Returns feat
    (Tb, H) int32, thresh (Tb, H) f32, bins (Tb, H) int32 (sentinel n_bins
    where a node does not split) and node_s (S, Tb) final sample leaves;
    with ``return_leaf_stats`` also (Tb, 2^depth, k) leaf stat sums read
    off the last level's histogram."""
    S, d = codes_s.shape
    Tb = sw_list[0].shape[1]
    k = len(sw_list)
    dev = codes_s.device
    H = 2 ** depth - 1
    feat_heap = torch.zeros((Tb, H), dtype=torch.int32, device=dev)
    thr_heap = torch.full((Tb, H), _INF, dtype=torch.float32, device=dev)
    bin_heap = torch.full((Tb, H), n_bins, dtype=torch.int32, device=dev)
    node = torch.zeros((S, Tb), dtype=torch.int64, device=dev)
    lanes = torch.arange(Tb, device=dev)
    hist_prev = None
    if return_leaf_stats and depth == 0:
        # one root leaf per tree whose stats are the column sums
        leaf_stats = torch.stack(
            [pinned_row_sum(s.to(torch.float32), dim=0) for s in sw_list],
            dim=-1)[:, None, :]                              # (Tb, 1, k)
    for level in range(depth):
        m = 2 ** level
        M = Tb * m
        if level == 0:
            hist = build_node_hist(codes_s, node, sw_list, n_bins,
                                   n_nodes=1)[:, 0].permute(1, 2, 3, 0)
        else:
            h = m // 2
            hist_l = build_node_hist(codes_s, node, sw_list, n_bins,
                                     n_nodes=h, stride=2)
            hist_l = hist_l.reshape(k, h * Tb, d, n_bins).permute(1, 2, 3, 0)
            hist_r = hist_prev - hist_l
            # interleave the children j-major: row (2j' + parity) * Tb + t
            hist = torch.stack([hist_l.reshape(h, Tb, d, n_bins, k),
                                hist_r.reshape(h, Tb, d, n_bins, k)],
                               dim=1).reshape(M, d, n_bins, k)
        hist_prev = hist
        cum = _cumsum_bins(hist)
        total = cum[:, 0, -1, :]                             # (M, k)
        SL = cum[:, :, :-1, :]
        SR = total[:, None, None, :] - SL
        cfg_m = {key: v.repeat(m) for key, v in cfg.items()}
        gain, valid = _split_gain(SL, SR, total, cfg_m, mode)
        valid = valid & fmasks.repeat(m, 1)[:, :, None]
        gain = torch.where(valid, gain, torch.full_like(gain, -_INF))
        gflat = gain.reshape(M, d * (n_bins - 1))
        best = torch.argmax(gflat, dim=1)
        bf = best // (n_bins - 1)
        bb = best % (n_bins - 1)
        bgain = gflat.gather(1, best[:, None])[:, 0]
        active = float(level) < cfg_m["max_depth"]
        do_split = (active & torch.isfinite(bgain)
                    & (bgain > cfg_m["min_info_gain"]))
        bf_eff = torch.where(do_split, bf, torch.zeros_like(bf))
        bb_eff = torch.where(do_split, bb, torch.full_like(bb, n_bins))
        thr = torch.where(do_split, edges[bf, bb],
                          torch.full_like(bgain, _INF))
        # j-major (M,) -> heap order (Tb, m)
        feat_heap[:, m - 1:2 * m - 1] = bf_eff.reshape(m, Tb).T.int()
        thr_heap[:, m - 1:2 * m - 1] = thr.reshape(m, Tb).T
        bin_heap[:, m - 1:2 * m - 1] = bb_eff.reshape(m, Tb).T.int()
        # route: each row compares its code of its node's split feature
        # with the split bin (sentinel n_bins: never greater, go left)
        go_lane = codes_s[:, bf_eff] > bb_eff[None, :]       # (S, M)
        go = go_lane.gather(1, node * Tb + lanes)            # (S, Tb)
        node = 2 * node + go.long()
        if return_leaf_stats and level == depth - 1:
            # left child = the chosen split's left cumsum (node total when
            # stopped: every row routes left), right child = the rest
            SL_flat = SL.reshape(M, d * (n_bins - 1), k)
            left = SL_flat.gather(
                1, best[:, None, None].expand(M, 1, k))[:, 0]
            left = torch.where(do_split[:, None], left, total)
            right = total - left
            leaf_stats = torch.stack(
                [left.reshape(m, Tb, k), right.reshape(m, Tb, k)],
                dim=1).permute(2, 0, 1, 3).reshape(Tb, 2 * m, k)
    if return_leaf_stats:
        return feat_heap, thr_heap, bin_heap, node, leaf_stats
    return feat_heap, thr_heap, bin_heap, node


def _grow_forest_capped(codes_s, edges, sw_list, fmasks, cfg, *, depth: int,
                        n_bins: int, mode: str, n_slots: int):
    """Grow Tb slot-chain ("leaf budget") trees at once: any depth, at most
    ``n_slots`` live nodes per level.

    Every level ranks each tree's valid candidate splits by gain and keeps
    as many as the budget allows (a split adds one net slot); unsplit live
    slots carry forward as leaves. Level l holds slots [0, n_live) of at
    most min(2^l, W). A kept split's children go to slots 2 * rank and
    2 * rank + 1, carried slots after them in slot order. Routing is
    ``slot' = base[slot] + go``, by integer gathers (the JAX package sums
    bf16 one-hots, which is exact for slots and bins <= 256).

    With Tb >= ``_CHAIN_SIBLING_MIN_TB`` a level of even width builds
    histograms for its even slots only: an odd slot is its parent minus
    its left sibling when it is a right child, or its own previous
    histogram when it was carried. Inputs as ``_grow_forest``. Returns
    (feat_lv, thr_lv, bin_lv, base_lv) (Tb, depth, W) and node_s (S, Tb),
    the final sample slot in [0, min(2^depth, W))."""
    _check_slots(n_slots)
    S, d = codes_s.shape
    Tb = sw_list[0].shape[1]
    k = len(sw_list)
    W = n_slots
    dev = codes_s.device
    feat_lv = torch.zeros((Tb, depth, W), dtype=torch.int32, device=dev)
    thr_lv = torch.full((Tb, depth, W), _INF, dtype=torch.float32,
                        device=dev)
    bin_lv = torch.full((Tb, depth, W), n_bins, dtype=torch.int32,
                        device=dev)
    base_lv = torch.zeros((Tb, depth, W), dtype=torch.int32, device=dev)
    node = torch.zeros((S, Tb), dtype=torch.int64, device=dev)
    n_live = torch.ones((Tb,), dtype=torch.int64, device=dev)
    lanes = torch.arange(Tb, device=dev)
    widths = _chain_widths(depth, W)
    sibling = Tb >= _CHAIN_SIBLING_MIN_TB
    hist5_prev = None                   # (Wl_prev, Tb, d, nb, k)
    odd_map_prev = None                 # (j_src (Wh, Tb), is_rchild)
    for level in range(depth):
        Wl = widths[level]
        Wn = widths[level + 1] if level + 1 < depth else min(2 ** depth, W)
        M = Wl * Tb
        if level == 0 or Wl % 2 or not sibling:
            hist5 = build_node_hist(codes_s, node, sw_list, n_bins,
                                    n_nodes=Wl).permute(1, 2, 3, 4, 0)
        else:
            Wh = Wl // 2
            he5 = build_node_hist(codes_s, node, sw_list, n_bins, n_nodes=Wh,
                                  stride=2).permute(1, 2, 3, 4, 0)
            j_src, is_rch = odd_map_prev
            prev = hist5_prev.reshape(hist5_prev.shape[0], Tb,
                                      d * n_bins * k).permute(1, 0, 2)
            src = prev.gather(1, j_src.T[:, :, None].expand(
                Tb, Wh, d * n_bins * k)).permute(1, 0, 2).reshape(
                Wh, Tb, d, n_bins, k)
            odd5 = src - torch.where(is_rch[:, :, None, None, None], he5,
                                     torch.zeros_like(he5))
            hist5 = torch.stack([he5, odd5], dim=1).reshape(Wl, Tb, d,
                                                            n_bins, k)
        hist5_prev = hist5
        hist = hist5.reshape(M, d, n_bins, k)
        cum = _cumsum_bins(hist)
        total = cum[:, 0, -1, :]
        SL = cum[:, :, :-1, :]
        SR = total[:, None, None, :] - SL
        cfg_m = {key: v.repeat(Wl) for key, v in cfg.items()}
        gain, valid = _split_gain(SL, SR, total, cfg_m, mode)
        valid = valid & fmasks.repeat(Wl, 1)[:, :, None]
        gain = torch.where(valid, gain, torch.full_like(gain, -_INF))
        gflat = gain.reshape(M, d * (n_bins - 1))
        best = torch.argmax(gflat, dim=1)
        bf = best // (n_bins - 1)
        bb = best % (n_bins - 1)
        bgain = gflat.gather(1, best[:, None])[:, 0]
        active = float(level) < cfg_m["max_depth"]
        cand = (active & torch.isfinite(bgain)
                & (bgain > cfg_m["min_info_gain"]))
        # live slots are [0, n_live) per tree; dead lanes never split
        slot_ids = torch.arange(Wl, device=dev)
        live = slot_ids[:, None] < n_live[None, :]             # (Wl, Tb)
        cand_2d = cand.reshape(Wl, Tb) & live
        # leaf budget: at most q = W_next - n_live splits this level, the
        # q best by gain; a slot's rank counts the slots that dominate it
        # (higher gain, or equal gain at a lower slot index)
        key = torch.where(cand_2d, bgain.reshape(Wl, Tb),
                          torch.full_like(bgain.reshape(Wl, Tb), -_INF))
        k_i, k_j = key[:, None, :], key[None, :, :]
        j_lt_i = slot_ids[None, :, None] < slot_ids[:, None, None]
        rank = ((k_j > k_i) | ((k_j == k_i) & j_lt_i)).sum(1)  # (Wl, Tb)
        q = torch.clamp(Wn - n_live, min=0)[None, :]
        kept = cand_2d & (rank < q)
        n_split = kept.sum(0)
        carried = live & ~kept
        c_rank = torch.cumsum(carried.long(), 0) - 1
        base_2d = torch.where(kept, 2 * rank,
                              torch.where(carried, 2 * n_split[None, :]
                                          + c_rank,
                                          torch.zeros_like(rank)))
        if sibling and level + 1 < depth and widths[level + 1] % 2 == 0:
            # odd slot i of the next level sources slot j of this one: j's
            # right child (base + 1 == i) or j carried onto i (base == i)
            i_odd = (1 + 2 * torch.arange(widths[level + 1] // 2,
                                          device=dev))[None, :, None]
            oh_r = torch.where(kept, base_2d + 1,
                               torch.full_like(base_2d, -1))[:, None, :] \
                == i_odd
            oh_c = torch.where(carried, base_2d,
                               torch.full_like(base_2d, -1))[:, None, :] \
                == i_odd
            odd_map_prev = (((oh_r | oh_c).long()
                             * slot_ids[:, None, None]).sum(0),
                            oh_r.any(0))
        kept_f = kept.reshape(M)
        bf_eff = torch.where(kept_f, bf, torch.zeros_like(bf))
        bb_eff = torch.where(kept_f, bb, torch.full_like(bb, n_bins))
        thr = torch.where(kept_f, edges[bf, bb],
                          torch.full_like(bgain, _INF))
        # j-major (M,) -> (Tb, Wl) table rows
        feat_lv[:, level, :Wl] = bf_eff.reshape(Wl, Tb).T.int()
        thr_lv[:, level, :Wl] = thr.reshape(Wl, Tb).T
        bin_lv[:, level, :Wl] = bb_eff.reshape(Wl, Tb).T.int()
        base_lv[:, level, :Wl] = base_2d.T.int()
        # route: slot' = base[slot] + (code of the split feature > bin)
        lane = node * Tb + lanes                               # (S, Tb)
        go = codes_s.gather(1, bf_eff[lane]) > bb_eff[lane]
        node = base_2d.reshape(M)[lane] + go.long()
        n_live = n_live + n_split
    return feat_lv, thr_lv, bin_lv, base_lv, node


def _diag_leaf_hist(node_s: torch.Tensor, A_cols: torch.Tensor,
                    L: int) -> torch.Tensor:
    """out[j, t, l] = sum_s A_cols[s, j, t] * 1[node_s[s, t] == l]:
    per-tree segment sums through the ``hist_matmul`` kernel in exact
    mode (trees as 'features', leaves as 'bins'), diagonal extracted.
    ``A_cols``: (S, Tb) for one stat or (S, J, Tb) for J stats at once.
    Trees go in blocks of ``_DIAG_BLOCK`` (padded with sentinel leaves and
    zero stats), so the cross-tree waste stays a constant factor."""
    squeeze = A_cols.dim() == 2
    if squeeze:
        A_cols = A_cols[:, None, :]
    S, J, Tb = A_cols.shape
    g = _DIAG_BLOCK
    Tp = -(-Tb // g) * g
    if Tp != Tb:
        node_s = torch.nn.functional.pad(node_s, (0, Tp - Tb), value=L)
        A_cols = torch.nn.functional.pad(A_cols, (0, Tp - Tb))
    diag = torch.arange(g, device=A_cols.device)
    outs = []
    for lo in range(0, Tp, g):
        blk = A_cols[:, :, lo:lo + g].reshape(S, J * g)       # stat-major
        full = build_hist(node_s[:, lo:lo + g].to(torch.int32).contiguous(),
                          blk.contiguous(), L, exact=True)    # (J*g, g*L)
        outs.append(full.reshape(J, g, g, L)[:, diag, diag])  # (J, g, L)
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    out = out[:, :Tb]
    return out[0] if squeeze else out


def _class_leaf(leaf_stats: torch.Tensor) -> torch.Tensor:
    """Per-leaf class probabilities from weighted class counts (..., L, k)."""
    tot = torch.clamp(leaf_stats.sum(-1, keepdim=True), min=1e-12)
    return leaf_stats / tot


def _mean_leaf(leaf_stats: torch.Tensor) -> torch.Tensor:
    """gh-mode stats with g = -y, h = 1: the Newton leaf -G / H is the
    weighted mean of y. (..., L, k) -> (..., L)."""
    return -leaf_stats[..., 0] / torch.clamp(leaf_stats[..., 1], min=1e-12)


def _leaf_values(ls: torch.Tensor, task: str):
    """Served leaf values of (..., L, k) stat sums: class shares, or the
    mean with a trailing axis of one."""
    if task == "classification":
        return _class_leaf(ls)
    return _mean_leaf(ls)[..., None]


def _exact_leaf_stats(codes, feat_heaps, bin_heaps, stats, w, depth: int,
                      n_bins: int):
    """Full-data leaf statistics of complete-heap trees through the fused
    leaf-sum kernel: (T, L, k) stat sums and (T, L) weight sums, f32."""
    aug = torch.cat([stats * w[:, None], w[:, None]], dim=1)
    out = forest_leaf_sums(codes, feat_heaps, bin_heaps, aug, depth=depth,
                           n_bins=n_bins)
    return out[..., :-1], out[..., -1]


def _exact_leaf_stats_chain(codes, feat_lv, bin_lv, base_lv, stats, w,
                            n_bins: int):
    """Slot-chain counterpart of ``_exact_leaf_stats``."""
    aug = torch.cat([stats * w[:, None], w[:, None]], dim=1)
    out = forest_leaf_sums_chain(codes, feat_lv, bin_lv, base_lv, aug,
                                 n_bins=n_bins)
    return out[..., :-1], out[..., -1]


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, dtype=np.float32).reshape(-1),
                           device=device)


def _make_stats(y: torch.Tensor, num_classes: int, task: str):
    """Per-row stats: class one-hot counts (classification) or
    [-y, 1, 1] for gh-mode regression trees."""
    if task == "classification":
        return torch.nn.functional.one_hot(
            y.long(), num_classes).to(torch.float32), "counts"
    ones = torch.ones_like(y)
    return torch.stack([-y, ones, ones], dim=1), "gh"


def _prep_tree_inputs(X, y, n_bins: int, num_classes: int, task: str,
                      full_bin: bool = True, sweep: bool = False):
    """Per-fit prep: the strided split-search sample, its quantile edges,
    full and sampled int32 bin codes (``full_bin`` False skips the full
    binning for fits that never route all rows), per-row stats and the
    n / S weight rescale (f32). ``sweep`` takes the CV-sweep sample."""
    n = X.shape[0]
    samp = torch.as_tensor(
        _sample_rows(n, _SWEEP_HIST_SAMPLE if sweep else _HIST_SAMPLE),
        device=X.device)
    Xs = X[samp]
    edges = _quantile_edges(Xs, n_bins)
    if full_bin:
        binned = _bin_features(X, edges)
        binned_s = binned[samp]
    else:
        binned = None
        binned_s = _bin_features(Xs, edges)
    stats, mode = _make_stats(y, num_classes, task)
    w_scale = torch.tensor(n / samp.shape[0], dtype=torch.float32,
                           device=X.device)
    return samp, edges, binned, binned_s, stats, mode, w_scale


def _thr_table(X, samp, edges, n_bins: int, fused: bool) -> torch.Tensor:
    """The table the growers read split thresholds from. The JAX package's
    threshold is ``edges[f, b]``, but where XLA fuses the quantile into
    that gather it evaluates the interpolation with the high product fused
    into the add, not the low one, and the threshold can differ from the
    returned edge by an ulp. Which of the two a program does is XLA's
    fusion choice for that program; the RF and DT fits pass ``fused`` as
    the JAX package's programs on the CPU choose it (its boosting programs
    read the table)."""
    return _quantile_edges(X[samp], n_bins, fused_gather=True) if fused \
        else edges


def _fit_gbt_batch(X, y, weights, max_depth, min_inst, min_gain, max_iter,
                   step_size, lam, min_child_weight, *, depth: int,
                   n_bins: int, num_classes: int, task: str, n_rounds: int,
                   sweep: bool = False,
                   n_slots: int = 0) -> Dict[str, torch.Tensor]:
    """Gradient boosting of B configurations: binary logistic, regression
    squared error or multiclass softmax. Each round grows one tree per
    (configuration, class), all B * C in one tree-batched ``_grow_forest``
    (complete heaps), or with ``n_slots`` > 0 in one
    ``_grow_forest_capped`` (slot chains of that leaf budget, any depth);
    tree lanes are t = b * C + c, as in the JAX package. Boosting state
    (F, gradients, leaves) lives on the split-search sample.
    Hyperparameters are (B,) host arrays."""
    dev = X.device
    max_depth, min_inst, min_gain, max_iter, step_size, lam, \
        min_child_weight = (_f32(v, dev) for v in (
            max_depth, min_inst, min_gain, max_iter, step_size, lam,
            min_child_weight))
    d = X.shape[1]
    samp, edges, _, binned_s, _, _, w_scale = _prep_tree_inputs(
        X, y, n_bins, num_classes, "regression", full_bin=False, sweep=sweep)
    C = num_classes if task == "multiclass" else 1
    B = weights.shape[0]
    Tb = B * C
    S = binned_s.shape[0]
    deep = n_slots > 0
    L = min(2 ** depth, n_slots) if deep else 2 ** depth
    y_s = y[samp]
    w_tb = (weights[:, samp] * w_scale).repeat_interleave(C, dim=0).T

    def rep(v):                                         # (B,) -> (Tb,)
        return v.repeat_interleave(C)
    cfg = {"max_depth": rep(max_depth), "min_instances": rep(min_inst),
           "min_info_gain": rep(min_gain), "lam": rep(lam),
           "min_child_weight": rep(min_child_weight)}
    lam_t = cfg["lam"]
    fmasks = torch.ones((Tb, d), dtype=torch.bool, device=dev)
    if task == "regression":
        # the mean label of each configuration's rows, summed in the JAX
        # package's pinned order
        f0 = (pinned_row_sum(weights * y[None, :], dim=1)
              / torch.clamp(pinned_row_sum(weights, dim=1), min=1.0))[:, None]
    else:
        f0 = torch.zeros((B, C), dtype=torch.float32, device=dev)
    F = f0[:, :, None].expand(B, C, S).contiguous()
    if task == "multiclass":
        Y1_s = torch.nn.functional.one_hot(
            y_s.long(), max(C, 2)).to(torch.float32).T[None, :C, :]
    per_round: List[Tuple[torch.Tensor, ...]] = []
    for t in range(n_rounds):
        if task == "binary":
            p = torch.sigmoid(F[:, 0, :])                    # (B, S)
            g = (p - y_s[None, :])[:, None, :]
            h = torch.clamp(p * (1 - p), min=1e-6)[:, None, :]
        elif task == "regression":
            g = F - y_s[None, None, :]
            h = torch.ones_like(g)
        else:
            P = xla_softmax(F)                              # (B, C, S)
            g = P - Y1_s
            h = torch.clamp(P * (1 - P), min=1e-6)
        g_tb = g.reshape(Tb, S).T                            # (S, Tb)
        h_tb = h.reshape(Tb, S).T
        sw_list = [g_tb * w_tb, h_tb * w_tb, w_tb]
        abs_ = None                                          # heap trees
        if deep:
            # slot chains take exact f32 Newton leaves in sweep and refit
            # alike: leaves settle at many levels, so the last level's
            # histogram does not hold them
            fs, ths, bhs, abs_, node_s = _grow_forest_capped(
                binned_s, edges, sw_list, fmasks, cfg, depth=depth,
                n_bins=n_bins, mode="gh", n_slots=n_slots)
            gh = _diag_leaf_hist(
                node_s, torch.stack([sw_list[0], sw_list[1]], dim=1), L)
            leaf = -gh[0] / (gh[1] + lam_t[:, None] + 1e-12)  # (Tb, L)
        elif sweep:
            # CV candidates take Newton leaves off the last level's
            # histogram; a near-empty leaf whose H is within bf16
            # cancellation noise of its parent's gets 0
            fs, ths, bhs, node_s, lst = _grow_forest(
                binned_s, edges, sw_list, fmasks, cfg, depth=depth,
                n_bins=n_bins, mode="gh", return_leaf_stats=True)
            h_leaf = lst[..., 1]                             # (Tb, L)
            if h_leaf.shape[-1] >= 2:
                h_sib = h_leaf.reshape(Tb, -1, 2).flip(-1).reshape(
                    h_leaf.shape)
                h_parent = h_leaf + h_sib
            else:
                h_parent = h_leaf
            raw = -lst[..., 0] / (h_leaf + lam_t[:, None] + 1e-12)
            leaf = torch.where(h_leaf < 2 ** -8 * h_parent,
                               torch.zeros_like(raw), raw)
        else:
            fs, ths, bhs, node_s = _grow_forest(
                binned_s, edges, sw_list, fmasks, cfg, depth=depth,
                n_bins=n_bins, mode="gh")
            # exact Newton leaves: per-tree G and H segment sums in one
            # histogram-kernel call
            gh = _diag_leaf_hist(
                node_s, torch.stack([sw_list[0], sw_list[1]], dim=1), L)
            leaf = -gh[0] / (gh[1] + lam_t[:, None] + 1e-12)  # (Tb, L)
        pred = leaf.gather(1, node_s.T).reshape(B, C, S)
        active = (float(t) < max_iter).to(torch.float32)
        scale = (step_size * active)[:, None, None]
        # F + scale * pred with one rounding, as XLA fuses it
        F = fma32(scale, pred, F)
        per_round.append((fs, ths, bhs, leaf, abs_))

    def to_bc(i):
        # (rounds, Tb = B * C, ...) -> (B, rounds, C, ...)
        a = torch.stack([r[i] for r in per_round])
        return a.reshape((n_rounds, B, C) + tuple(a.shape[2:])).transpose(
            0, 1).contiguous()

    tree_mask = (torch.arange(n_rounds, device=dev)[None, :]
                 < max_iter[:, None]).to(torch.float32)
    out = {"leaf": to_bc(3), "f0": f0, "eta": step_size,
           "tree_mask": tree_mask, "edges": edges}
    if deep:
        out.update(feat_lv=to_bc(0), thresh_lv=to_bc(1), bins_lv=to_bc(2),
                   base_lv=to_bc(4))
    else:
        out.update(feat=to_bc(0), thresh=to_bc(1), bins=to_bc(2))
    return out


def _map_chunks(B: int, cb: int, one_chunk):
    """Run ``one_chunk(idx)`` over configuration chunks of cb (the tail
    chunk wraps around to the first configurations, as the JAX package's
    ``lax.map`` over padded chunks does) and join each output along its
    leading axis, cut back to B."""
    outs = [one_chunk(np.arange(c * cb, (c + 1) * cb) % B)
            for c in range(-(-B // cb))]
    return [torch.cat(parts, dim=0)[:B] for parts in zip(*outs)]


def _fit_dt_batch(X, y, weights, max_depth, min_inst, min_gain, *,
                  depth: int, n_bins: int, num_classes: int, task: str,
                  sweep: bool = False, n_slots: int = 0):
    """One tree per configuration: ``_fit_rf_batch`` with one tree, no
    bootstrap and every feature. ``n_slots`` > 0 grows slot chains of that
    budget. The sweep's leaves come off the split-search sample; the
    refit's from every row through the leaf-sum kernel, one launch per
    configuration."""
    out = _fit_rf_batch(X, y, weights, max_depth, min_inst, min_gain,
                        np.ones(weights.shape[0], np.float32), None, None,
                        depth=depth, n_bins=n_bins, num_classes=num_classes,
                        task=task, n_trees=1, sweep=sweep, n_slots=n_slots)
    del out["tree_mask"]
    return {k: v if k == "edges" else v[:, 0] for k, v in out.items()}


def _cdf_folded(B: int, cb: int) -> bool:
    """Whether the JAX package's RF program folds the bootstrap CDF's
    gammaln table at compile time (``bootstrap.poisson_cdf``): it does
    unless all B configurations draw in one chunk of two or more."""
    return cb == 1 or cb < B


def _fit_rf_batch(X, y, weights, max_depth, min_inst, min_gain, num_trees,
                  subsample, seeds, *, depth: int, n_bins: int,
                  num_classes: int, task: str, n_trees: int,
                  sweep: bool = False, n_slots: int = 0):
    """``n_trees`` bootstrapped trees per configuration, grown as one tree
    batch per chunk of configurations. A tree's row weight is its
    configuration's fold weight times its Poisson(subsamplingRate) draw,
    and it splits on its own feature subset (``bootstrap.draw``, seeded by
    ``seeds``; None grows every tree on every row and feature). The
    sweep's leaves come off the split-search sample; the refit launches
    the leaf-sum kernel once per configuration over all its trees."""
    d = X.shape[1]
    dev = X.device
    B = weights.shape[0]
    samp, edges, binned, binned_s, stats, mode, w_scale = \
        _prep_tree_inputs(X, y, n_bins, num_classes, task,
                          full_bin=not sweep, sweep=sweep)
    p_feat = bootstrap.feature_share(d, task)
    S = binned_s.shape[0]
    k = stats.shape[1]
    stats_s = stats[samp]
    deep = n_slots > 0
    L = min(2 ** depth, n_slots) if deep else 2 ** depth
    # the JAX package's DT programs gather thresholds off the edge table
    # for one configuration, its RF programs for several chains
    thr_tab = _thr_table(X, samp, edges, n_bins,
                         B > 1 if seeds is None else not deep or B == 1)
    # chunk budgets: the grower's (S, trees x level lanes) transients and
    # the per-level (trees x nodes, d, n_bins, k) histogram pipeline, as
    # the JAX package sets them. They stay because the chunking decides
    # which numbers come out (it picks the bootstrap CDF table); on the
    # card no (S, trees x level lanes) operand is materialized any more
    # (the node-histogram kernel builds none), so they bound the
    # histogram pipeline and the grower's own transients
    lane_w = (min(2 ** (depth - 1), n_slots) * k if deep
              else 2 ** (depth - 1))
    cb = int(max(1, min(B, _CFG_CHUNK_ELEMS
                        // (S * n_trees * max(lane_w, 2 * (k + 1))))))
    nodes_w = min(2 ** depth, n_slots) if deep else 2 ** (depth - 1)
    cb = int(max(1, min(cb, _LEVEL_HIST_ELEMS
                        // (n_trees * nodes_w * d * n_bins * k))))
    md, mi, mg = (_f32(v, dev) for v in (max_depth, min_inst, min_gain))
    if seeds is None:
        def draw(idx):
            return (torch.ones((len(idx), n_trees, S), device=dev),
                    torch.ones((len(idx), n_trees, d), dtype=torch.bool,
                               device=dev))
    else:
        ss_np = np.asarray(subsample, np.float32).reshape(-1)
        seeds_np = np.asarray(seeds, np.float32).reshape(-1)
        folded = _cdf_folded(B, cb)

        def draw(idx):
            return bootstrap.draw(seeds_np[idx], ss_np[idx], n_trees, S, d,
                                  p_feat, dev, folded)

    def one_chunk(idx):
        rows = torch.as_tensor(idx, device=dev)
        n_c = len(idx)
        Tb = n_c * n_trees
        w_s = weights[rows][:, samp] * w_scale                # (cb, S)
        boots, fmasks = draw(idx)
        # tree lanes config-major: lane = c * n_trees + t
        w_ts = (w_s[:, None, :] * boots).reshape(Tb, S).T     # (S, Tb)
        sw_list = [stats_s[:, ki][:, None] * w_ts for ki in range(k)]
        cfg = {"max_depth": md[rows].repeat_interleave(n_trees),
               "min_instances": mi[rows].repeat_interleave(n_trees),
               "min_info_gain": mg[rows].repeat_interleave(n_trees),
               "lam": torch.full((Tb,), 1e-6, device=dev),
               "min_child_weight": torch.zeros((Tb,), device=dev)}
        if deep:
            fs, ths, bhs, abs_, node_s = _grow_forest_capped(
                binned_s, thr_tab, sw_list, fmasks.reshape(Tb, d), cfg,
                depth=depth, n_bins=n_bins, mode=mode, n_slots=n_slots)
        else:
            fs, ths, bhs, node_s = _grow_forest(
                binned_s, thr_tab, sw_list, fmasks.reshape(Tb, d), cfg,
                depth=depth, n_bins=n_bins, mode=mode)
            abs_ = torch.zeros((Tb, 0), dtype=torch.int32, device=dev)
        if sweep:
            # sample leaf stats of the whole chunk in one blocked segment
            # sum; the columns carry the fold weights, not the bootstrap
            w_cols = w_s.repeat_interleave(n_trees, dim=0).T  # (S, Tb)
            stats_aug = torch.cat([stats_s, torch.ones((S, 1), device=dev)],
                                  dim=1)
            sums = _diag_leaf_hist(
                node_s, stats_aug[:, :, None] * w_cols[:, None, :], L)
            sums = sums.permute(1, 2, 0)                      # (Tb, L, k+1)
            leaf_c = _leaf_values(sums[..., :-1], task)
            leaf_c = leaf_c.reshape((n_c, n_trees) + tuple(leaf_c.shape[1:]))
        else:
            leaf_c = torch.zeros(
                (n_c, n_trees, L, k if task == "classification" else 1),
                device=dev)

        def per_config(a):
            return a.reshape((n_c, n_trees) + tuple(a.shape[1:]))
        return (per_config(fs), per_config(ths), per_config(bhs),
                per_config(abs_), leaf_c)

    feat, thr, bheap, bases, leaf = _map_chunks(B, cb, one_chunk)
    if not sweep:
        leaves = []
        for b in range(B):
            if deep:
                ls, _ = _exact_leaf_stats_chain(binned, feat[b], bheap[b],
                                                bases[b], stats, weights[b],
                                                n_bins)
            else:
                ls, _ = _exact_leaf_stats(binned, feat[b], bheap[b], stats,
                                          weights[b], depth, n_bins)
            leaves.append(_leaf_values(ls, task))
        leaf = torch.stack(leaves)
    tree_mask = (torch.arange(n_trees, device=dev)[None, :]
                 < _f32(num_trees, dev)[:, None]).to(torch.float32)
    if deep:
        return {"feat_lv": feat, "thresh_lv": thr, "bins_lv": bheap,
                "base_lv": bases, "leaf": leaf, "tree_mask": tree_mask,
                "edges": edges}
    return {"feat": feat, "thresh": thr, "bins": bheap, "leaf": leaf,
            "tree_mask": tree_mask, "edges": edges}


def _sweep_ensemble_cap(vals: np.ndarray, cap: int,
                        param: str) -> Optional[np.ndarray]:
    """Sweep-time ensemble cap: all configs equal -> clamp to ``cap``;
    distinct values -> scale proportionally (max -> cap, floor 1) so the
    grid's relative budgets survive. None when no value exceeds the cap."""
    vals = np.asarray(vals, dtype=np.float64)
    vmax = float(vals.max())
    if vmax <= cap:
        return None
    if np.unique(vals).size == 1:
        return np.minimum(vals, float(cap))
    scaled = np.maximum(1.0, np.round(vals * (cap / vmax)))
    logger.warning(
        "custom grid sweeps %s over distinct values %s above the sweep "
        "ranking cap %d; candidates rank with proportionally scaled "
        "ensembles %s and the winner refits at its full %s",
        param, sorted(set(vals.tolist())), cap,
        sorted(set(scaled.tolist())), param)
    return scaled


def _g(grid: Dict[str, np.ndarray], key: str, default: float) -> np.ndarray:
    if key in grid:
        return np.asarray(grid[key])
    return np.full_like(np.asarray(next(iter(grid.values())),
                                   dtype=np.float32), default)


def _stitch_parts(B: int, parts) -> Dict[str, torch.Tensor]:
    """Scatter per-chunk param dicts back into a (B, ...) batch; 'edges' is
    shared and passes through."""
    stitched: Optional[Dict[str, torch.Tensor]] = None
    for idx, p in parts:
        if stitched is None:
            stitched = {k: (v if k == "edges" else
                            v.new_zeros((B,) + tuple(v.shape[1:])))
                        for k, v in p.items()}
        rows = torch.as_tensor(idx, device=next(iter(p.values())).device)
        for k, v in p.items():
            if k != "edges":
                stitched[k][rows] = v
    return stitched


def _pad_axis(x: torch.Tensor, axis: int, after: int,
              value: float = 0.0) -> torch.Tensor:
    """Pad ``after`` entries of ``value`` at the end of one axis."""
    if after <= 0:
        return x
    shape = list(x.shape)
    shape[axis % x.dim()] = after
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                    device=x.device)], dim=axis)


def _heap_to_chain(params, d_heap: int, depth: int, W: int, n_bins: int,
                   leaf_axis: int):
    """Re-express complete-heap trees in the slot-chain layout, exactly:
    heap node j of level l is chain slot j with child base 2j; levels past
    the heap's depth carry every slot (sentinel bin, base = slot). Needs
    2^d_heap <= W. Other entries (edges, tree_mask) pass through."""
    if 2 ** d_heap > W:
        raise ValueError(f"heap depth {d_heap} needs {2 ** d_heap} slots, "
                         f"chain budget is {W}")
    feat, bins = params["feat"], params["bins"]
    thr, leaf = params["thresh"], params["leaf"]
    lead = tuple(feat.shape[:-1])
    dev = feat.device
    f_lv = torch.zeros(lead + (depth, W), dtype=torch.int32, device=dev)
    b_lv = torch.full(lead + (depth, W), n_bins, dtype=torch.int32,
                      device=dev)
    t_lv = torch.full(lead + (depth, W), _INF, dtype=torch.float32,
                      device=dev)
    a_lv = torch.zeros(lead + (depth, W), dtype=torch.int32, device=dev)
    for level in range(depth):
        if level < d_heap:
            lo, m = 2 ** level - 1, 2 ** level
            f_lv[..., level, :m] = feat[..., lo:lo + m]
            b_lv[..., level, :m] = bins[..., lo:lo + m]
            t_lv[..., level, :m] = thr[..., lo:lo + m]
            a_lv[..., level, :m] = 2 * torch.arange(m, dtype=torch.int32,
                                                    device=dev)
        else:
            Wl = min(2 ** level, W)
            a_lv[..., level, :Wl] = torch.arange(Wl, dtype=torch.int32,
                                                 device=dev)
    ax = leaf_axis % leaf.dim()
    out = {k: v for k, v in params.items()
           if k not in ("feat", "bins", "thresh", "leaf")}
    out.update({"feat_lv": f_lv, "bins_lv": b_lv, "thresh_lv": t_lv,
                "base_lv": a_lv,
                "leaf": _pad_axis(leaf, ax, min(2 ** depth, W)
                                  - leaf.shape[ax])})
    return out


def _pad_chain_depth(params, d_small: int, depth: int, n_bins: int,
                     leaf_axis: int):
    """Extend chain tables from d_small to depth levels with carries, and
    pad the leaf axis to the deeper W_out. Exact."""
    if d_small == depth:
        return params
    f_lv = params["feat_lv"]
    W = f_lv.shape[-1]
    ext = depth - d_small
    out = dict(params)
    out["feat_lv"] = _pad_axis(f_lv, -2, ext, 0)
    out["bins_lv"] = _pad_axis(params["bins_lv"], -2, ext, n_bins)
    out["thresh_lv"] = _pad_axis(params["thresh_lv"], -2, ext, _INF)
    a_lv = _pad_axis(params["base_lv"], -2, ext, 0)
    for level in range(d_small, depth):
        Wl = min(2 ** level, W)
        a_lv[..., level, :Wl] = torch.arange(Wl, dtype=a_lv.dtype,
                                             device=a_lv.device)
    out["base_lv"] = a_lv
    leaf = params["leaf"]
    ax = leaf_axis % leaf.dim()
    out["leaf"] = _pad_axis(leaf, ax, min(2 ** depth, W) - leaf.shape[ax])
    return out


def _embed_depth(params, d_small: int, d_max: int, n_bins: int,
                 leaf_axis: int):
    """Re-express a depth-``d_small`` heap fit in the depth-``d_max``
    layout, exactly: the small heap is a prefix of the big one (the rest
    routes left), so small leaf l becomes big leaf l * 2^(d_max -
    d_small)."""
    if d_small == d_max:
        return params
    extra = (2 ** d_max - 1) - (2 ** d_small - 1)
    r = 2 ** (d_max - d_small)
    out = dict(params)
    out["feat"] = _pad_axis(params["feat"], -1, extra, 0)
    out["thresh"] = _pad_axis(params["thresh"], -1, extra, _INF)
    out["bins"] = _pad_axis(params["bins"], -1, extra, n_bins)
    leaf = params["leaf"]
    ax = leaf_axis % leaf.dim()
    shape = list(leaf.shape)
    shape[ax] *= r
    big = leaf.new_zeros(shape)
    idx = [slice(None)] * leaf.dim()
    idx[ax] = slice(None, None, r)
    big[tuple(idx)] = leaf
    out["leaf"] = big
    return out


def _fit_depth_grouped(grid, weights, fit_group, n_bins: int,
                       leaf_axis: int, fit_group_deep=None,
                       n_slots: int = 0):
    """Fit each maxDepth bucket of the grid with its own depth program and
    embed the results in the deepest layout, so the batch shares one
    predict program. ``fit_group(sub_grid, sub_weights, depth) -> params``.
    Depths past ``_MAX_HEAP_DEPTH`` grow slot chains through
    ``fit_group_deep(..., n_slots)``; when any bucket is that deep, every
    heap bucket is re-expressed as chains, with a budget that holds the
    deepest heap's leaves."""
    md = np.asarray(grid["maxDepth"], dtype=np.float64).reshape(-1)
    uniq = sorted({int(v) for v in md})
    d_max = uniq[-1]
    any_deep = d_max > _MAX_HEAP_DEPTH
    if len(uniq) == 1:
        return (fit_group_deep(grid, weights, d_max, n_slots) if any_deep
                else fit_group(grid, weights, d_max))
    if any_deep:
        d_heap_max = max([u for u in uniq if u <= _MAX_HEAP_DEPTH],
                         default=0)
        n_slots = max(n_slots, 2 ** d_heap_max)
    parts = []
    for u in uniq:
        idx = np.nonzero(md == u)[0]
        sub = {k: np.asarray(v)[idx] for k, v in grid.items()}
        w = weights[torch.as_tensor(idx, device=weights.device)]
        if u > _MAX_HEAP_DEPTH:
            p = _pad_chain_depth(fit_group_deep(sub, w, u, n_slots), u,
                                 d_max, n_bins, leaf_axis)
        elif any_deep:
            p = _heap_to_chain(fit_group(sub, w, u), u, d_max, n_slots,
                               n_bins, leaf_axis)
        else:
            p = _embed_depth(fit_group(sub, w, u), u, d_max, n_bins,
                             leaf_axis)
        parts.append((idx, p))
    return _stitch_parts(md.shape[0], parts)


# ---------------------------------------------------------------------------
# Predict half
# ---------------------------------------------------------------------------

def params_from_numpy(params: Dict[str, np.ndarray],
                      device) -> Dict[str, torch.Tensor]:
    """A saved tree ``FittedParams.params`` dict -> contiguous tensors on
    ``device``: int32 split tables, float32 leaves, mask, edges and boosting
    constants. Keys the predict path does not read (thresholds) stay host
    numpy arrays, so a loaded model saves again whole."""
    chain = "base_lv" in params
    need = (("feat_lv", "bins_lv", "base_lv") if chain
            else ("feat", "bins")) + ("leaf", "edges")
    missing = [k for k in need if k not in params]
    if missing:
        raise KeyError(f"tree params lack {missing}; have {sorted(params)}")
    out = {}
    for k, v in params.items():
        if k in _INT_KEYS:
            dtype = torch.int32
        elif k in _FLOAT_KEYS:
            dtype = torch.float32
        else:
            out[k] = np.asarray(v)
            continue
        # (np.ascontiguousarray would turn the 0-d ``eta`` into shape (1,))
        out[k] = torch.as_tensor(np.asarray(v), dtype=dtype,
                                 device=device).contiguous()
    return out


def _edges_of(params) -> torch.Tensor:
    """The shared (d, n_bins - 1) edge table, with or without a leading
    config axis."""
    e = params["edges"]
    return e[0] if e.dim() == 3 else e


def _depth_of(n_leaves: int) -> int:
    return int(np.log2(n_leaves))


def _shape_scores(out: torch.Tensor, num_classes: int, task: str):
    """(n, k) leaf outputs -> family score convention: binary (n,) p1,
    multiclass (n, C), regression (n,)."""
    if task == "regression":
        return out[:, 0]
    if num_classes <= 2:
        return out[:, 1]
    return out[:, :num_classes]


def _parts_j(out: torch.Tensor, num_classes: int, task: str):
    """Prediction parts from family-convention scores."""
    if task == "regression":
        return {"prediction": out}
    prob = torch.stack([1 - out, out], dim=1) if out.dim() == 1 else out
    pred = prob.argmax(dim=1).to(torch.float32)
    return {"prediction": pred, "probability": prob,
            "rawPrediction": torch.log(torch.clamp(prob, min=1e-12))}


def _forest_values(params, codes: torch.Tensor, leaf: torch.Tensor,
                   n_bins: int, lead: int = 0) -> torch.Tensor:
    """Sum of leaf values over the trees, in whichever layout the params
    hold. ``lead`` > 0 flattens that many axes after the tree axis into it
    (GBT's per-class trees)."""
    if "base_lv" in params:
        f, b, a = params["feat_lv"], params["bins_lv"], params["base_lv"]
        if lead:
            f, b, a = (x.reshape((-1,) + x.shape[-2:]) for x in (f, b, a))
        return forest_predict_chain(codes, f, b, a, leaf, n_bins=n_bins)
    f, b = params["feat"], params["bins"]
    if lead:
        f, b = (x.reshape(-1, x.shape[-1]) for x in (f, b))
    return forest_predict(codes, f.contiguous(), b.contiguous(), leaf,
                          depth=_depth_of(leaf.shape[1]), n_bins=n_bins)


class _TreeFamilyBase(ModelFamily):

    def params_from_numpy(self, params, device):
        return params_from_numpy(params, device)

    def _task(self, num_classes: int) -> str:
        if "regression" in self.supports and len(self.supports) == 1:
            return "regression"
        return "classification"

    def sweep_fit_batch(self, X, y, weights, grid, num_classes):
        """CV-sweep fits: leaf values from the split-search sample; the
        selector refits the winner through ``fit_batch``."""
        return self.fit_batch(X, y, weights, grid, num_classes, sweep=True)

    def select_params(self, batched, idx):
        """Per-config slice, except the bin-edge table, which every config
        of a fit shares."""
        return {k: (v if k == "edges" else v[idx]).contiguous()
                for k, v in batched.items()}

    def slice_params(self, batched, lo, hi):
        return {k: (v if k == "edges" else v[lo:hi])
                for k, v in batched.items()}

    def predict_batch(self, params, X: torch.Tensor, num_classes: int):
        """Scores of stacked configurations: one ``predict_config`` each,
        stacked on a leading config axis."""
        B = params["leaf"].shape[0]
        return torch.stack([
            self.predict_config(self.select_params(params, b), X,
                                num_classes) for b in range(B)])


class DecisionTreeFamilyBase(_TreeFamilyBase):
    """One tree per configuration (grids per the reference's
    DefaultSelectorParams: maxDepth x minInstancesPerNode {10, 100} x
    minInfoGain {0.001, 0.01, 0.1})."""

    def default_grid(self, problem):
        return [{"maxDepth": d, "minInstancesPerNode": mi, "minInfoGain": mg}
                for d in _DEPTHS for mi in (10, 100)
                for mg in (0.001, 0.01, 0.1)]

    def fit_batch(self, X, y, weights, grid, num_classes, sweep=False):
        task = self._task(num_classes)

        def fit_group(g, w, depth, slots=0):
            return _fit_dt_batch(
                X, y, w, g["maxDepth"], _g(g, "minInstancesPerNode", 1.0),
                _g(g, "minInfoGain", 0.0), depth=depth, n_bins=N_BINS,
                num_classes=max(num_classes, 2), task=task, sweep=sweep,
                n_slots=slots)

        return _fit_depth_grouped(
            grid, weights, fit_group, N_BINS, leaf_axis=-2,
            fit_group_deep=fit_group,
            n_slots=_SWEEP_SLOTS if sweep else _REFIT_SLOTS)

    def predict_config(self, params, X: torch.Tensor, num_classes: int):
        edges = _edges_of(params)
        task = self._task(num_classes)
        leaf = params["leaf"]                              # (L, k)
        binary = task == "classification" and num_classes <= 2
        if binary:
            leaf = leaf[..., 1:]
        tree = {k: v[None] for k, v in params.items() if k in _INT_KEYS}
        out = _forest_values(tree, _bin_features(X, edges),
                             leaf[None].contiguous(),
                             n_bins=edges.shape[-1] + 1)
        if binary:
            return out[:, 0]
        return _shape_scores(out, num_classes, task)

    def predict_parts(self, fitted: FittedParams, X: torch.Tensor):
        out = self.predict_config(fitted.params, X, fitted.num_classes)
        return _parts_j(out, fitted.num_classes,
                        self._task(fitted.num_classes))


class RandomForestFamilyBase(_TreeFamilyBase):
    """Random forest: the mean of the unmasked trees' leaf values
    (numTrees 50, subsamplingRate 1.0 per the reference's
    DefaultSelectorParams; Poisson bootstrap row weights, per-tree feature
    subsets)."""

    def default_grid(self, problem):
        return [{"maxDepth": d, "minInstancesPerNode": mi, "minInfoGain": mg,
                 "numTrees": 50, "subsamplingRate": 1.0}
                for d in _DEPTHS for mi in (10, 100)
                for mg in (0.001, 0.01, 0.1)]

    def fit_batch(self, X, y, weights, grid, num_classes, sweep=False):
        """Configuration b draws its bootstrap from seed b + 7. The sweep
        ranks with at most ``_SWEEP_RF_TREES`` trees a forest."""
        task = self._task(num_classes)
        tree_vals = np.asarray(_g(grid, "numTrees", 20.0))
        n_trees = int(tree_vals.max())
        B = weights.shape[0]
        grid = dict(grid, _seeds=np.arange(B, dtype=np.float32) + 7.0)
        if sweep:
            capped = _sweep_ensemble_cap(tree_vals, _SWEEP_RF_TREES,
                                         "numTrees")
            if capped is not None:
                n_trees = int(capped.max())
                grid = dict(grid, numTrees=capped.astype(np.float32))

        def fit_group(g, w, depth, slots=0):
            return _fit_rf_batch(
                X, y, w, g["maxDepth"], _g(g, "minInstancesPerNode", 1.0),
                _g(g, "minInfoGain", 0.0), _g(g, "numTrees", 20.0),
                _g(g, "subsamplingRate", 1.0), g["_seeds"], depth=depth,
                n_bins=N_BINS, num_classes=max(num_classes, 2), task=task,
                n_trees=n_trees, sweep=sweep, n_slots=slots)

        return _fit_depth_grouped(
            grid, weights, fit_group, N_BINS, leaf_axis=-2,
            fit_group_deep=fit_group,
            n_slots=_SWEEP_SLOTS if sweep else _REFIT_SLOTS)

    def predict_config(self, params, X: torch.Tensor, num_classes: int):
        edges = _edges_of(params)
        task = self._task(num_classes)
        leaf = params["leaf"]                              # (T, L, k)
        binary = task == "classification" and num_classes <= 2
        if binary:
            # p0 = 1 - p1, so only the class-1 column is routed
            leaf = leaf[..., 1:]
        mask = params["tree_mask"]
        lw = (leaf * mask[:, None, None]).contiguous()
        out = _forest_values(params, _bin_features(X, edges), lw,
                             n_bins=edges.shape[-1] + 1)
        out = out / torch.clamp(mask.sum(), min=1.0)
        if binary:
            return out[:, 0]
        return _shape_scores(out, num_classes, task)

    def predict_parts(self, fitted: FittedParams, X: torch.Tensor):
        out = self.predict_config(fitted.params, X, fitted.num_classes)
        return _parts_j(out, fitted.num_classes,
                        self._task(fitted.num_classes))


class GBTFamilyBase(_TreeFamilyBase):
    """Gradient-boosted trees: ``f0 + eta * sum of leaf values`` per class,
    then a sigmoid (binary), a softmax (multiclass) or nothing
    (regression). Complete heaps up to maxDepth 8, slot chains beyond
    (grids per the reference's DefaultSelectorParams: maxDepth x
    minInstancesPerNode {10, 100} x minInfoGain {0.001, 0.01, 0.1},
    maxIter 20, stepSize 0.1)."""

    lam_default = 0.0
    mcw_default = 0.0

    def default_grid(self, problem):
        return [{"maxDepth": d, "minInstancesPerNode": mi, "minInfoGain": mg,
                 "maxIter": 20, "stepSize": 0.1}
                for d in _DEPTHS for mi in (10, 100)
                for mg in (0.001, 0.01, 0.1)]

    def _gbt_task(self, num_classes: int) -> str:
        if "regression" in self.supports and len(self.supports) == 1:
            return "regression"
        return "multiclass" if num_classes > 2 else "binary"

    def fit_batch(self, X, y, weights, grid, num_classes, sweep=False):
        """GBT trains entirely on the split-search sample, so sweep and
        refit are one program; the sweep caps the boosting rounds. A grid
        deeper than ``_MAX_HEAP_DEPTH`` boosts slot chains for every
        configuration in one scan at its deepest depth."""
        task = self._gbt_task(num_classes)
        iter_vals = _g(grid, "maxIter", 20.0)
        n_rounds = int(iter_vals.max())
        if sweep:
            capped = _sweep_ensemble_cap(iter_vals, _SWEEP_GBT_ROUNDS,
                                         "maxIter")
            if capped is not None:
                n_rounds = int(capped.max())
                grid = dict(grid, maxIter=capped.astype(np.float32))
        n_slots = _SWEEP_SLOTS if sweep else _REFIT_SLOTS

        def one_raw(g, w, depth, slots):
            return _fit_gbt_batch(
                X, y, w, g["maxDepth"], _g(g, "minInstancesPerNode", 0.0),
                _g(g, "minInfoGain", 0.0), _g(g, "maxIter", 20.0),
                _g(g, "stepSize", 0.1), _g(g, "lambda", self.lam_default),
                _g(g, "minChildWeight", self.mcw_default), depth=depth,
                n_bins=N_BINS, num_classes=max(num_classes, 2), task=task,
                n_rounds=n_rounds, sweep=sweep, n_slots=slots)

        def one_call(g, w, depth, slots=0):
            # config chunks under the JAX package's budgets: the per-level
            # (configs x nodes, d, n_bins, k) split pipeline, and its bound
            # on the (S, k x nodes x configs) masked-stat operand. On the
            # card the node-histogram kernel builds no such operand; the
            # budgets stay because the chunking decides which numbers come
            # out, and they now bound the histogram pipeline alone
            B = w.shape[0]
            C_g = max(num_classes, 2) if task == "multiclass" else 1
            nodes_w = (min(2 ** depth, slots) if slots
                       else 2 ** max(depth - 1, 0))
            per_cfg = C_g * nodes_w * X.shape[1] * N_BINS * 3
            cb = max(1, min(B, _LEVEL_HIST_ELEMS // max(per_cfg, 1)))
            S_est = min(X.shape[0],
                        _SWEEP_HIST_SAMPLE if sweep else _HIST_SAMPLE)
            lanes_max = max((1 << 29) // max(S_est, 1), 192)
            cb = max(1, min(cb, lanes_max // (3 * nodes_w * C_g)))
            if cb >= B:
                return one_raw(g, w, depth, slots)
            parts = []
            for c in range(-(-B // cb)):
                # the tail chunk wraps around so every chunk has cb configs
                idx = np.arange(c * cb, (c + 1) * cb) % B
                p = one_raw({k: np.asarray(v)[idx] for k, v in g.items()},
                            w[torch.as_tensor(idx, device=X.device)], depth,
                            slots)
                count = min((c + 1) * cb, B) - c * cb
                parts.append((idx[:count],
                               {k: (v if k == "edges" else v[:count])
                                for k, v in p.items()}))
            return _stitch_parts(B, parts)

        md = np.asarray(grid["maxDepth"], dtype=np.float64).reshape(-1)
        d_max = int(md.max())
        if d_max <= _MAX_HEAP_DEPTH:
            # one heap scan: shallower configurations stop splitting by
            # their own max_depth
            return one_call(grid, weights, d_max)
        # one slot-chain scan for every configuration at the deepest
        # depth; the budget must hold a shallow configuration's whole tree
        shallow = md[md <= _MAX_HEAP_DEPTH]
        if shallow.size:
            n_slots = max(n_slots, 2 ** int(shallow.max()))
        return one_call(grid, weights, d_max, n_slots)

    def predict_config(self, params, X: torch.Tensor, num_classes: int):
        edges = _edges_of(params)
        leaf = params["leaf"]                              # (T, C, L)
        T, C, L = leaf.shape
        lv = leaf * params["tree_mask"][:, None, None]
        # class-routing leaf table: value * one-hot(class) per (tree·class,
        # leaf), so one descent over T·C trees yields per-class margins
        cls_oh = torch.eye(C, dtype=lv.dtype, device=lv.device)
        M = (lv[:, :, :, None] * cls_oh[None, :, None, :]).reshape(
            T * C, L, C)
        contrib = _forest_values(params, _bin_features(X, edges), M,
                                 n_bins=edges.shape[-1] + 1, lead=1)
        margins = params["f0"][None, :] + params["eta"] * contrib  # (n, C)
        task = self._gbt_task(num_classes)
        if task == "regression":
            return margins[:, 0]
        if task == "binary":
            return torch.sigmoid(margins[:, 0])
        return torch.softmax(margins, dim=-1)

    def predict_parts(self, fitted: FittedParams, X: torch.Tensor):
        task = self._gbt_task(fitted.num_classes)
        out = self.predict_config(fitted.params, X, fitted.num_classes)
        if task == "regression":
            return {"prediction": out}
        if task == "binary":
            prob = torch.stack([1 - out, out], dim=1)
            pred = (out > 0.5).to(torch.float32)
        else:
            prob = out
            pred = out.argmax(dim=1).to(torch.float32)
        return {"prediction": pred, "probability": prob,
                "rawPrediction": torch.log(torch.clamp(prob, min=1e-12))}


class DecisionTreeClassifierFamily(DecisionTreeFamilyBase):
    name = "OpDecisionTreeClassifier"
    supports = frozenset({"binary", "multiclass"})


class DecisionTreeRegressorFamily(DecisionTreeFamilyBase):
    name = "OpDecisionTreeRegressor"
    supports = frozenset({"regression"})


class RandomForestClassifierFamily(RandomForestFamilyBase):
    name = "OpRandomForestClassifier"
    supports = frozenset({"binary", "multiclass"})


class RandomForestRegressorFamily(RandomForestFamilyBase):
    name = "OpRandomForestRegressor"
    supports = frozenset({"regression"})


class GBTClassifierFamily(GBTFamilyBase):
    name = "OpGBTClassifier"
    supports = frozenset({"binary"})


class GBTRegressorFamily(GBTFamilyBase):
    name = "OpGBTRegressor"
    supports = frozenset({"regression"})


class XGBoostClassifierFamily(GBTFamilyBase):
    """The reference's OpXGBoostClassifier: second-order splits with L2
    ``lambda`` 1 and minChildWeight 1 by default (grid per
    DefaultSelectorParams: numRound 100 as maxIter, eta {0.1, 0.3} as
    stepSize, minChildWeight {1, 5, 10})."""
    name = "OpXGBoostClassifier"
    supports = frozenset({"binary", "multiclass"})
    lam_default = 1.0
    mcw_default = 1.0

    def default_grid(self, problem):
        return [{"maxDepth": 6, "maxIter": 100, "stepSize": e,
                 "minChildWeight": m, "lambda": 1.0, "minInfoGain": 0.0,
                 "minInstancesPerNode": 0.0}
                for e in (0.1, 0.3) for m in (1.0, 5.0, 10.0)]


class XGBoostRegressorFamily(XGBoostClassifierFamily):
    name = "OpXGBoostRegressor"
    supports = frozenset({"regression"})


for _family in (DecisionTreeClassifierFamily, DecisionTreeRegressorFamily,
                RandomForestClassifierFamily, RandomForestRegressorFamily,
                GBTClassifierFamily, GBTRegressorFamily,
                XGBoostClassifierFamily, XGBoostRegressorFamily):
    register_family(_family())
