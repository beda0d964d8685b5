"""Time the forest predict designs that were measured and not taken
(``experiments/forest_variants.cu``) beside the shipped kernel
(``csrc/forest_predict.cu``) at the serve shapes, on one NVIDIA GPU.

    python3 -m transmogrifai_tpu_torch.experiments.forest_variants
        [--runs 25] [--only variants|shipped]

Shapes (65,536 rows x 64 codes, 32 bins, k 1, trees from
``testing.random_chain`` / ``random_heap`` with seed 0): the RF serve
(slot chains, T 50, depth 12, W 256), the ``gbt12`` serve (chains, T 20,
depth 12, W 256) and the GBT serve (heaps, T 20, depth 6). Per shape: the
first design (``base``), each with one change (``+smem codes``,
``+packed``, ``+2 rows a thread``), all three at once; then the shipped
kernel (its public wrapper) and its descent at the launch shapes of
``SHAPES_SWEPT`` (rows and trees a thread, rows a block; ``--only
shipped`` times these alone). Every result is checked bit
for bit against the plain version; each time is the median of ``--runs``
CUDA-event timings of one call after warm-up, beside the device ms of its
kernels (``torch.profiler``). Prints the card's name and power limit,
then one JSON line per (shape, kernel).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from ..ops import cuda_build
from ..ops import forest as F
from ..ops.cuda_build import ptr
from ..profile_hist import pass_ms, time_ms
from ..testing import random_chain, random_heap

_P, _I = ctypes.c_void_p, ctypes.c_int

VARIANT = cuda_build.CudaKernel(
    "forest_variant", "../experiments/forest_variants.cu",
    "transmogrifai_tpu/ops/forest.py:503", [_I] * 3 + [_P] * 6 + [_I] * 7
    + [_P])
SWEEP = cuda_build.CudaKernel(
    "forest_sweep", "../experiments/forest_variants.cu",
    "transmogrifai_tpu/ops/forest.py:503", [_I] * 3 + [_P] * 7 + [_I] * 7
    + [_P])

ROWS, CODES, BINS = 65536, 64, 32
#: (tag, T, depth, W; W None for heaps)
SHAPES = (("RF serve", 50, 12, 256), ("gbt12 serve", 20, 12, 256),
          ("GBT serve", 20, 6, None))
#: (tag, smem codes, packed, rows a thread)
VARIANTS = (("base", 0, 0, 1), ("+smem codes", 1, 0, 1),
            ("+packed", 0, 1, 1), ("+2 rows a thread", 0, 0, 2),
            ("all three", 1, 1, 2))
#: the packed design's launch shapes: (rows a thread, trees a thread,
#: rows a block; 0 the shipped planner's); it ships at (1, 4, 0)
SHAPES_SWEPT = ((1, 1, 0), (2, 1, 0), (1, 2, 0), (2, 2, 0), (1, 4, 0),
                (1, 2, 128), (1, 2, 256), (1, 4, 256))


def variant(tabs, leaf, depth, W, smem_codes, packed, rpt):
    """One variant on (codes, feat, bins[, base]); leaf (T, W_out)."""
    codes = tabs[0]
    dev = codes.device
    n, d = codes.shape
    T, W_out = leaf.shape
    out = torch.empty(n, dtype=torch.float32, device=dev)
    base = tabs[3] if len(tabs) == 4 else None
    VARIANT.launch(smem_codes, packed, rpt, ptr(codes), ptr(tabs[1]),
                   ptr(tabs[2]), ptr(base), ptr(leaf), ptr(out), n, d, T,
                   depth, W or 0, W_out, dev.index,
                   torch.cuda.current_stream(dev).cuda_stream)
    return out[:, None]


def swept(tabs, leaf, depth, W, rpt, tpt, block_rows):
    """The packed design at one launch shape; leaf (T, W_out)."""
    codes = tabs[0]
    dev = codes.device
    n, d = codes.shape
    T, W_out = leaf.shape
    out = torch.empty(n, dtype=torch.float32, device=dev)
    base = tabs[3] if len(tabs) == 4 else None
    words = ctypes.c_longlong()
    SWEEP.entry("forest_sweep_workspace", [
        _I, _I, _I, ctypes.POINTER(ctypes.c_longlong)])(
            T, depth, W or 0, ctypes.byref(words))
    rec = torch.empty(words.value, dtype=torch.int32, device=dev)
    SWEEP.launch(rpt, tpt, block_rows, ptr(codes), ptr(tabs[1]),
                 ptr(tabs[2]), ptr(base), ptr(leaf), ptr(out), ptr(rec), n,
                 d, T, depth, W or 0, W_out, dev.index,
                 torch.cuda.current_stream(dev).cuda_stream)
    return out[:, None]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=25)
    ap.add_argument("--only", choices=("variants", "shipped"), default=None,
                    help="time only the variants or only the shipped kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("forest_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    rng = np.random.RandomState(0)
    for tag, T, depth, W in SHAPES:
        if W is None:
            f = random_heap(rng, ROWS, CODES, T, depth, 1, BINS)
            keys = ("codes", "feat", "bins")
        else:
            f = random_chain(rng, ROWS, CODES, T, depth, W, 1, BINS)
            keys = ("codes", "feat", "bins", "base")
        tabs = [torch.from_numpy(f[k]).to(dev) for k in keys]
        leaf = torch.from_numpy(f["leaf"]).to(dev)
        leaf1 = leaf[:, :, 0].contiguous()
        if W is None:
            want = F.forest_predict_plain(*tabs, leaf, depth=depth,
                                          n_bins=BINS)

            def shipped():
                return F.forest_predict_heap_cuda(*tabs, leaf, depth=depth,
                                                  n_bins=BINS)[0]
        else:
            want = F.forest_predict_chain_plain(*tabs, leaf, n_bins=BINS)

            def shipped():
                return F.forest_predict_chain_cuda(*tabs, leaf,
                                                   n_bins=BINS)[0]
        calls = []
        if args.only != "shipped":
            calls += [(name, lambda s=s, p=p, r=r: variant(
                tabs, leaf1, depth, W, s, p, r))
                for name, s, p, r in VARIANTS]
        if args.only != "variants":
            calls.append(("shipped", shipped))
            calls += [(f"packed, {r} rows x {u} trees a thread, "
                       f"{b or 'planned'} rows a block",
                       lambda r=r, u=u, b=b: swept(
                           tabs, leaf1, depth, W, r, u, b))
                      for r, u, b in SHAPES_SWEPT]
        for name, fn in calls:
            got = fn()
            torch.cuda.synchronize()
            print(json.dumps(dict(
                shape=tag, kernel=name,
                bit_equal=bool(torch.equal(got, want)),
                ms=time_ms(fn, args.runs),
                device_ms=sum(pass_ms(fn, args.runs).values()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
