"""Time the staged variant of ``hist_matmul``'s partial pass
(``experiments/hist_staged.cu``) against the shipped kernel
(``csrc/hist.cu``) on one NVIDIA GPU.

    python3 -m transmogrifai_tpu_torch.experiments.hist_staged [--runs 25]

For each shape (``profile_hist``'s three main-path leaf calls, then 64
features with every code valid, exact, 128 stat columns and 64 bins, and a
bf16 growth shape, 64 features, 384 stat columns and 32 bins; 19,712 rows)
it times the shipped kernel, then the staged one at feature tiles of 1, 2,
4, 8 and 16, each with CUDA events (median of ``--runs`` calls) and its
passes' device ms (``torch.profiler``), and checks that the staged result
is bit-equal to the shipped one (both add in one order). Prints the card's
name and power limit, then one JSON line per (shape, kernel).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from ..histeng import kernels as HK
from ..ops import cuda_build
from ..ops.cuda_build import ptr
from .. import profile_hist as PH

_P, _I = ctypes.c_void_p, ctypes.c_int

#: the staged variant, built from this directory like any kernel source
STAGED = cuda_build.CudaKernel(
    "hist_matmul", "../experiments/hist_staged.cu",
    "transmogrifai_tpu/histeng/kernels.py:235", [_P] * 5 + [_I] * 10 + [_P])

FEATURE_TILES = (1, 2, 4, 8, 16)


def staged(codes, A, n_bins, exact, feats):
    """The staged variant with ``hist_matmul_cuda``'s contract."""
    dev = codes.device
    S, d = codes.shape
    B = A.shape[1]
    K = HK.HIST_SHARDS if S >= HK.HIST_SHARDS else 1
    out = torch.empty((B, d * n_bins), dtype=torch.float32, device=dev)
    flags = torch.empty(d, dtype=torch.int32, device=dev)
    part = torch.empty((K, d * n_bins, B), dtype=torch.float32, device=dev)
    STAGED.launch(ptr(codes), ptr(A), ptr(flags), ptr(part), ptr(out), S, d,
                  B, n_bins, K, -(-S // K), int(exact), HK.HIST_COLS, feats,
                  dev.index, torch.cuda.current_stream(dev).cuda_stream)
    return out


def shapes(dev, rng):
    """(tag, codes, A, n_bins, exact) at each timed shape."""
    for tag, real, B, L in PH.HIST_CASES:
        yield (tag,) + PH.leaf_inputs(dev, rng, real, B, L) + (L, True)
    for tag, B, nb, exact in (("every code valid", 128, 64, True),
                              ("growth, bf16", 384, 32, False)):
        codes = rng.randint(0, nb + 1, (PH.ROWS, PH.CODES)).astype(np.int32)
        A = rng.rand(PH.ROWS, B).astype(np.float32)
        yield (tag, torch.from_numpy(codes).to(dev),
               torch.from_numpy(A).to(dev), nb, exact)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hist_staged: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    for tag, codes, A, nb, exact in shapes(dev, np.random.RandomState(0)):
        want = HK.hist_matmul_cuda(codes, A, nb, exact)
        runs = [("csrc/hist.cu", None,
                 lambda: HK.hist_matmul_cuda(codes, A, nb, exact))]
        runs += [("staged", f, lambda f=f: staged(codes, A, nb, exact, f))
                 for f in FEATURE_TILES]
        for name, f, fn in runs:
            print(json.dumps(dict(
                case=tag, kernel=name, feature_tile=f,
                bit_equal=bool(torch.equal(fn(), want)),
                ms=PH.time_ms(fn, args.runs),
                passes_ms=PH.pass_ms(fn, args.runs))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
