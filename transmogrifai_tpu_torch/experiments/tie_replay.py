"""Replay one boosting round of a serve-bench refit and show how the tree
grower scored one node: that node's histogram cells at a few bins of one
feature, how each cell was made (built by ``node_hist``, or its parent's
minus its left sibling's), and the split gains there.

    python3 -m transmogrifai_tpu_torch.experiments.tie_replay
        [--device cuda|cpu] [--trained]

The node is ``XGBMC_TIE``: in the xgbmc train the card splits it at
another bin than the fixture, and both bins split its rows alike. The
state is the committed fixture's (``fixtures/serve64/xgbmc``, trained by
the JAX package on the serve bench's frame): the refit rows are rebuilt
from the training frame through the fixture's own stages
(``testing.refit_rows``), F after the rounds before from its trees and
leaves (``testing.boosting_stats``), and that round's trees (one per
class) are grown by the port's ``_grow_forest`` on ``--device``: on the
card ``node_hist`` is the CUDA kernel, on the CPU its plain version.
With ``--trained`` the port first trains the serve-bench workflow on the
device, and the state is its own refit's.

Prints how many leaf values of the trees before the round differ from
the fixture's, the replayed split at the node beside the fixture's, the
node's rows with each bin's code, and for each bin the cells (G, H, W;
float and hex) at the node, at its parent and at its left sibling, the
node's cells summed directly over its rows in float64, and the gain
there; then the node's best split and its gain.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..models import trees as TR
from ..models.api import MODEL_REGISTRY
from ..ops.forest import route_codes
from ..testing import (
    SERVE_MODELS, TRAIN_ROWS, TRAIN_SEED, boosting_stats, refit_rows,
    serve_bench_data, serve_bench_workflow,
)

#: (key, round, class, heap node, feature, bins) of the xgbmc train's first
#: tree that differs from its fixture
XGBMC_TIE = ("xgbmc", 26, 1, 14, 57, (20, 21))

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "fixtures", "serve64")


def replay(model, data, fixture, key: str, rnd: int, cls: int, node: int,
           feature: int, bins) -> dict:
    """Grow round ``rnd`` of ``model``'s refit again on its device and
    return, at heap node ``node`` of class ``cls``'s tree, the split
    chosen and the one in ``fixture`` (a fitted params dict), how many
    leaf values of the trees before differ from the fixture's, and per
    bin the row count, the cells (node, parent, left sibling, direct
    float64 sum) and the gain."""
    family, hyper, task = SERVE_MODELS[key]
    fam = MODEL_REGISTRY[family]
    p = model.stages[-1].fitted.params
    codes, y, w = refit_rows(model, data)
    sw_list = boosting_stats(p, codes, y, w, task, rnd)
    C = sw_list[0].shape[1]
    depth = TR._depth_of(p["leaf"].shape[-1])
    dev = codes.device

    def lanes(v):
        return torch.full((C,), float(v), dtype=torch.float32, device=dev)
    cfg = {"max_depth": lanes(hyper["maxDepth"]),
           "min_instances": lanes(hyper.get("minInstancesPerNode", 0.0)),
           "min_info_gain": lanes(hyper.get("minInfoGain", 0.0)),
           "lam": lanes(hyper.get("lambda", fam.lam_default)),
           "min_child_weight": lanes(hyper.get("minChildWeight",
                                               fam.mcw_default))}
    hists, gains = [], []
    cumsum, split_gain = TR._cumsum_bins, TR._split_gain

    def cumsum_seen(x):
        if x.shape[2] == TR.N_BINS:          # not the blocked inner call
            hists.append(x)
        return cumsum(x)

    def split_gain_seen(*a):
        gain, valid = split_gain(*a)
        gains.append(torch.where(valid, gain,
                                 torch.full_like(gain, -float("inf"))))
        return gain, valid
    TR._cumsum_bins, TR._split_gain = cumsum_seen, split_gain_seen
    try:
        feat, _, bin_heap, _ = TR._grow_forest(
            codes, p["edges"], sw_list,
            torch.ones((C, codes.shape[1]), dtype=torch.bool, device=dev),
            cfg, depth=depth, n_bins=TR.N_BINS, mode="gh")
    finally:
        TR._cumsum_bins, TR._split_gain = cumsum, split_gain
    level = int(np.log2(node + 1))
    j = node - (2 ** level - 1)
    row = j * C + cls
    hist, gain = hists[level], gains[level]
    at = ((j // 2) * C + cls, (j - 1) * C + cls) if j % 2 else None
    pos = (route_codes(codes, feat[cls:cls + 1], bin_heap[cls:cls + 1],
                       level, TR.N_BINS)[:, 0] if level
           else torch.zeros(codes.shape[0], dtype=torch.int32, device=dev))
    here = (pos == j).cpu().numpy()
    col = codes[:, feature].cpu().numpy()
    A = torch.stack([s[:, cls] for s in sw_list], 1).to(
        torch.bfloat16).double().cpu().numpy()
    # the leaves of every tree before this one, (rounds, classes) flat
    before = [x.reshape(-1, x.shape[-1])[:rnd * C + cls].cpu().double()
              for x in (p["leaf"], fixture["leaf"])]
    out = {"key": key, "round": rnd, "class": cls, "node": node,
           "level": level, "device": str(dev),
           "leaves_before": {"of": before[0].numel(),
                             "differ": int((before[0] != before[1]).sum()),
                             "max_abs": float((before[0] - before[1])
                                              .abs().max())},
           "replayed": [int(feat[cls, node]), int(bin_heap[cls, node])],
           "fixture": [int(fixture["feat"][rnd, cls, node]),
                       int(fixture["bins"][rnd, cls, node])],
           "rows_at_node": int(here.sum()), "bins": {}}
    for b in bins:
        sel = here & (col == b)
        cells = {"node": hist[row, feature, b].tolist()}
        if at is not None:
            cells["parent"] = hists[level - 1][at[0], feature, b].tolist()
            cells["left_sibling"] = hist[at[1], feature, b].tolist()
        cells["direct_f64"] = A[sel].sum(0).tolist()
        out["bins"][b] = {
            "rows": int(sel.sum()), "cells": cells,
            "gain": (float(gain[row, feature, b])
                     if b < TR.N_BINS - 1 else None)}
    best = int(torch.argmax(gain[row].reshape(-1)))
    out["best"] = {"feature": best // (TR.N_BINS - 1),
                   "bin": best % (TR.N_BINS - 1),
                   "gain": float(gain[row].reshape(-1)[best])}
    return out


def _fmt(v: float) -> str:
    return f"{v!r} ({float(v).hex()})"


def main(argv=None) -> int:
    import transmogrifai_tpu_torch as tt

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trained", action="store_true",
                    help="replay from the port's own train on the device")
    a = ap.parse_args(argv)
    key, rnd, cls, node, feature, bins = XGBMC_TIE
    family, hyper, task = SERVE_MODELS[key]
    ref = tt.load_model(os.path.join(FIXTURES, key), device=a.device)
    data = serve_bench_data(TRAIN_ROWS, 64, TRAIN_SEED, task)
    model = (serve_bench_workflow(family, hyper, 64, TRAIN_SEED,
                                  device=a.device, problem=task)
             .set_input_dataset(data).train() if a.trained else ref)
    r = replay(model, data, ref.stages[-1].fitted.params, key, rnd, cls,
               node, feature, bins)
    if r["device"].startswith("cuda"):
        import subprocess
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    lb = r["leaves_before"]
    print(f"{key} round {rnd}, class {cls}, heap node {node} "
          f"(level {r['level']}), replayed on {r['device']} from the "
          f"{'port train' if a.trained else 'fixture'}'s state (leaves of "
          f"the trees before: {lb['differ']} of {lb['of']} differ from the "
          f"fixture's, max |d| {lb['max_abs']!r}): split (feature, bin) "
          f"{r['replayed']}, the fixture's {r['fixture']}; "
          f"{r['rows_at_node']} rows at the node")
    for b, v in r["bins"].items():
        print(f"  feature {feature}, bin {b}: {v['rows']} rows at the "
              f"node with this code; gain {v['gain']!r}")
        for name, cell in v["cells"].items():
            print(f"    {name:13s} G {_fmt(cell[0])}, H {_fmt(cell[1])}, "
                  f"W {_fmt(cell[2])}")
    print(f"  best split at the node: feature {r['best']['feature']}, bin "
          f"{r['best']['bin']}, gain {r['best']['gain']!r}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
