"""Tree model families (counterpart of ``transmogrifai_tpu.models.trees``):
the gradient-boosted tree classifier fits and scores on a device; the
random-forest classifier scores (its fit is the next slice).

Features are binned as the JAX package bins them, ``bin(x) = #{edges < x}``
with ``n_bins = edges.shape[-1] + 1``, and routed by bin code. A fitted
forest comes in one of two layouts: complete heaps (``feat``/``bins``,
depth <= 8) or slot chains (``feat_lv``/``bins_lv``/``base_lv``, the
depth-12 refits).

Growth (``_grow_forest``) follows the JAX package step for step: the
split search of each level is one node histogram (``histeng``), a cumsum
over bins and an argmax; routing compares each row's code of the chosen
feature with the chosen bin. GBT trains on the split-search sample; the
refit's Newton leaves are exact per-tree segment sums through the
``hist_matmul`` kernel (``_diag_leaf_hist``), the CV sweep's come off the
last level's histogram.

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
from ..ops.forest import forest_predict, forest_predict_chain
from .api import FittedParams, ModelFamily, register_family

logger = logging.getLogger(__name__)

N_BINS = 32  # Spark maxBins default

#: split-search sample cap of a refit (evenly strided rows)
_HIST_SAMPLE = 65536

#: split-search sample cap of a CV-sweep fit
_SWEEP_HIST_SAMPLE = 8192

#: boosting rounds CV candidates rank with; the winner refits at maxIter
_SWEEP_GBT_ROUNDS = 12

#: per-level histogram element budget (f32) that bounds a config chunk
_LEVEL_HIST_ELEMS = 1 << 28

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

def _quantile_edges(X: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Per-feature quantile bin edges (d, n_bins - 1), as
    ``jnp.quantile(X, linspace(0, 1, n_bins + 1)[1:-1], axis=0)`` gives
    them: quantile i / n_bins in f32 at position q * (n - 1), linear
    interpolation low * (1 - w) + high * w with the low product fused into
    the add (one rounding). A column holding a NaN gets NaN edges."""
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
        p = S / torch.clamp(W, min=1e-12)[..., None]
        return 1.0 - (p * p).sum(-1)

    impP = gini(total, wP)[:, None, None]
    wPn = torch.clamp(wP, min=1e-12)[:, None, None]
    gain = impP - (wL / wPn) * gini(SL, wL) - (wR / wPn) * gini(SR, wR)
    mi = torch.clamp(bc(cfg["min_instances"]), min=1e-6)
    return gain, (wL >= mi) & (wR >= mi)


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
    # depth 0: one root leaf per tree whose stats are the column sums
    leaf_stats = torch.stack(
        [pinned_row_sum(s.to(torch.float32), dim=0) for s in sw_list],
        dim=-1)[:, None, :]                                  # (Tb, 1, k)
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
        cum = torch.cumsum(hist, dim=2)
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


def _fit_gbt_batch(X, y, weights, max_depth, min_inst, min_gain, max_iter,
                   step_size, lam, min_child_weight, *, depth: int,
                   n_bins: int, num_classes: int, task: str, n_rounds: int,
                   sweep: bool = False) -> Dict[str, torch.Tensor]:
    """Binary logistic gradient boosting of B configurations: each round
    grows one tree per configuration, all B in one tree-batched
    ``_grow_forest``. Boosting state (F, gradients, leaves) lives on the
    split-search sample. Hyperparameters are (B,) host arrays."""
    if task != "binary":
        raise NotImplementedError(
            f"GBT task {task!r} is not ported yet; this slice fits binary "
            f"classification")
    dev = X.device

    def f32(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float32), device=dev)

    max_depth, min_inst, min_gain, max_iter, step_size, lam, \
        min_child_weight = map(f32, (max_depth, min_inst, min_gain, max_iter,
                                     step_size, lam, min_child_weight))
    d = X.shape[1]
    samp, edges, _, binned_s, _, _, w_scale = _prep_tree_inputs(
        X, y, n_bins, num_classes, "regression", full_bin=False, sweep=sweep)
    B = weights.shape[0]
    S = binned_s.shape[0]
    L = 2 ** depth
    y_s = y[samp]
    w_tb = (weights[:, samp] * w_scale).T                   # (S, Tb = B)
    cfg = {"max_depth": max_depth, "min_instances": min_inst,
           "min_info_gain": min_gain, "lam": lam,
           "min_child_weight": min_child_weight}
    fmasks = torch.ones((B, d), dtype=torch.bool, device=dev)
    f0 = torch.zeros((B, 1), dtype=torch.float32, device=dev)
    F = torch.zeros((B, S), dtype=torch.float32, device=dev)
    per_round: List[Tuple[torch.Tensor, ...]] = []
    for t in range(n_rounds):
        p = torch.sigmoid(F)                                 # (B, S)
        g_tb = (p - y_s[None, :]).T                          # (S, B)
        h_tb = torch.clamp(p * (1 - p), min=1e-6).T
        sw_list = [g_tb * w_tb, h_tb * w_tb, w_tb]
        if sweep:
            # CV candidates take Newton leaves off the last level's
            # histogram; a near-empty leaf whose H is within bf16
            # cancellation noise of its parent's gets 0
            fs, ths, bhs, node_s, lst = _grow_forest(
                binned_s, edges, sw_list, fmasks, cfg, depth=depth,
                n_bins=n_bins, mode="gh", return_leaf_stats=True)
            h_leaf = lst[..., 1]                             # (B, L)
            if h_leaf.shape[-1] >= 2:
                h_sib = h_leaf.reshape(B, -1, 2).flip(-1).reshape(
                    h_leaf.shape)
                h_parent = h_leaf + h_sib
            else:
                h_parent = h_leaf
            raw = -lst[..., 0] / (h_leaf + lam[:, None] + 1e-12)
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
            leaf = -gh[0] / (gh[1] + lam[:, None] + 1e-12)   # (B, L)
        pred = leaf.gather(1, node_s.T)                      # (B, S)
        active = (float(t) < max_iter).to(torch.float32)
        scale = (step_size * active)[:, None]
        # F + scale * pred with one rounding, as XLA fuses it
        F = (F.double() + scale.double() * pred.double()).float()
        per_round.append((fs, ths, bhs, leaf))

    def to_bc(i):
        # (rounds, B, ...) -> (B, rounds, C = 1, ...)
        return torch.stack([r[i] for r in per_round], dim=1).unsqueeze(2)

    tree_mask = (torch.arange(n_rounds, device=dev)[None, :]
                 < max_iter[:, None]).to(torch.float32)
    return {"feat": to_bc(0), "thresh": to_bc(1), "bins": to_bc(2),
            "leaf": to_bc(3), "f0": f0, "eta": step_size,
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


# ---------------------------------------------------------------------------
# Predict half
# ---------------------------------------------------------------------------

def params_from_numpy(params: Dict[str, np.ndarray],
                      device) -> Dict[str, torch.Tensor]:
    """A saved tree ``FittedParams.params`` dict -> contiguous tensors on
    ``device``: int32 split tables, float32 leaves, mask, edges and boosting
    constants. Keys the predict path does not read (thresholds) are left
    out."""
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
            continue
        out[k] = torch.as_tensor(np.ascontiguousarray(v), dtype=dtype,
                                 device=device)
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


class RandomForestFamilyBase(_TreeFamilyBase):
    """Random forest: the mean of the unmasked trees' leaf values."""

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
    then a sigmoid (binary) or softmax (multiclass). Fitting ports the
    binary classifier on complete heaps (maxDepth <= 8)."""

    lam_default = 0.0
    mcw_default = 0.0

    def _gbt_task(self, num_classes: int) -> str:
        if "regression" in self.supports and len(self.supports) == 1:
            return "regression"
        return "multiclass" if num_classes > 2 else "binary"

    def fit_batch(self, X, y, weights, grid, num_classes, sweep=False):
        """GBT trains entirely on the split-search sample, so sweep and
        refit are one program; the sweep caps the boosting rounds."""
        task = self._gbt_task(num_classes)
        iter_vals = _g(grid, "maxIter", 20.0)
        n_rounds = int(iter_vals.max())
        if sweep:
            capped = _sweep_ensemble_cap(iter_vals, _SWEEP_GBT_ROUNDS,
                                         "maxIter")
            if capped is not None:
                n_rounds = int(capped.max())
                grid = dict(grid, maxIter=capped.astype(np.float32))
        md = np.asarray(grid["maxDepth"], dtype=np.float64).reshape(-1)
        depth = int(md.max())
        if depth > _MAX_HEAP_DEPTH:
            raise NotImplementedError(
                f"GBT with maxDepth {depth} > {_MAX_HEAP_DEPTH} grows slot "
                f"chains (_grow_forest_capped), which the RF/DT training "
                f"slice ports")

        def one_raw(g, w):
            return _fit_gbt_batch(
                X, y, w, g["maxDepth"], _g(g, "minInstancesPerNode", 0.0),
                _g(g, "minInfoGain", 0.0), _g(g, "maxIter", 20.0),
                _g(g, "stepSize", 0.1), _g(g, "lambda", self.lam_default),
                _g(g, "minChildWeight", self.mcw_default), depth=depth,
                n_bins=N_BINS, num_classes=max(num_classes, 2), task=task,
                n_rounds=n_rounds, sweep=sweep)

        # config chunks under the per-level histogram budget and the
        # masked-stat operand budget of the JAX package
        B = weights.shape[0]
        nodes_w = 2 ** max(depth - 1, 0)
        cb = max(1, min(B, _LEVEL_HIST_ELEMS
                        // max(nodes_w * X.shape[1] * N_BINS * 3, 1)))
        S_est = min(X.shape[0], _SWEEP_HIST_SAMPLE if sweep else _HIST_SAMPLE)
        lanes_max = max((1 << 29) // max(S_est, 1), 192)
        cb = max(1, min(cb, lanes_max // (3 * nodes_w)))
        if cb >= B:
            return one_raw(grid, weights)
        parts = []
        for c in range(-(-B // cb)):
            # the tail chunk wraps around so every chunk has cb configs
            idx = np.arange(c * cb, (c + 1) * cb) % B
            p = one_raw({k: np.asarray(v)[idx] for k, v in grid.items()},
                        weights[torch.as_tensor(idx, device=X.device)])
            count = min((c + 1) * cb, B) - c * cb
            parts.append((idx[:count], {k: (v if k == "edges" else v[:count])
                                        for k, v in p.items()}))
        return _stitch_parts(B, parts)

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


class RandomForestClassifierFamily(RandomForestFamilyBase):
    name = "OpRandomForestClassifier"
    supports = frozenset({"binary", "multiclass"})


class GBTClassifierFamily(GBTFamilyBase):
    name = "OpGBTClassifier"
    supports = frozenset({"binary"})


register_family(RandomForestClassifierFamily())
register_family(GBTClassifierFamily())
