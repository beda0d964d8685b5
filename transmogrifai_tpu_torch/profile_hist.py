"""The two histogram kernels at their main-path shapes, the two forest
predict kernels at their serve shapes and the two leaf-sum kernels at
their refit shapes, pass by pass, on one NVIDIA GPU.

    python3 transmogrifai_tpu_torch/profile_hist.py [--root DIR] [--runs 25]

Times ``node_hist_matmul``, ``hist_matmul``, ``forest_predict_chain``,
``forest_predict``, ``forest_leaf_sums_chain`` and ``forest_leaf_sums``
through their public functions (wrapper included, as
the growers and the scorers call them) with CUDA events,
median of ``--runs`` calls after warm-up, and splits each call's device
time by kernel name with ``torch.profiler`` over ``--runs`` more calls.
``--root`` imports ``transmogrifai_tpu_torch`` from another checkout (for
example an older commit unpacked beside this one), so two versions of the
kernels can be timed in turns in one run; the inputs are made from one
seed with numpy and are the same for every root.

Shapes (19,712 rows, the refit's padded row count):

* ``node_hist`` (64 codes, 32 bins): the RF refit's deepest level (T 50,
  256 slots, k 2), the GBT depth-6 refit's level 5 (T 1, 16 left
  children, stride 2, k 3), the ``gbt12`` refit's deepest level (T 1, 256
  slots, k 3), a GBT level 0 (T 1, one slot holding every row, k 3), the
  ``rfmc`` refit's deepest level (6 class counts: k 6) and the ``xgbmc``
  refit's level 5 (T 6: one tree per class, k 3);
* ``hist_matmul`` (exact, ``_diag_leaf_hist``'s layout of 64 tree
  columns with the padded ones all sentinel): the GBT refit's leaf call
  (1 real column, 128 stat columns, 64 leaves), the ``gbt12`` refit's
  (1 real column, 128 stat columns, 256 leaves), the RF sweep's (48
  real columns, 192 stat columns, 64 leaves) and the ``xgbmc`` refit's
  (6 real columns, one per class: 12 of the 128 stat columns);
* the forest predicts (65,536 rows x 64 codes, 32 bins, trees from
  ``testing.random_chain`` / ``random_heap``): at k 1 the RF serve (slot
  chains, T 50, depth 12, W 256), the ``gbt12`` serve (chains, T 20, depth
  12, W 256), the GBT serve (heaps, T 20, depth 6) and the DT serve (one
  heap of depth 6); at k 6 the ``rfmc`` serve (chains as RF) and the
  ``xgbmc`` serve (heaps, T 600 = 100 rounds x 6 classes, depth 6);
* the leaf sums: the RF refit's (slot chains, T 50, depth 12, W 256, k
  3), the DT refit's (one heap of depth 6, k 3), the RF refit's with
  every row in leaf 0 of every tree (the skew of a trained refit at its
  extreme), the ``rfreg`` refit's (k 4) and the ``rfmc`` refit's (k 7).

Prints the card's name and power limit, then one JSON line per case.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

# run as a script, this file's directory would come first on the path and
# its modules (``types.py``, ...) would shadow the standard library's
if sys.path and os.path.abspath(sys.path[0] or ".") == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path.pop(0)

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: H100 SXM data-sheet peaks
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

#: the refit's padded row count, the serve bench's codes and growth bins
ROWS, CODES, NODE_BINS = 19712, 64, 32

#: the main-path shapes, shared with ``chip_smoke.py``:
#: ``node_hist`` (tag, T, Wl, stride, k, live slots)
NODE_CASES = (("RF refit, deepest level", 50, 256, 1, 2, 256),
              ("GBT depth-6 refit, level 5", 1, 16, 2, 3, 32),
              ("gbt12 refit, deepest level", 1, 256, 1, 3, 256),
              ("GBT level 0", 1, 1, 1, 3, 1),
              ("rfmc refit, deepest level", 50, 256, 1, 6, 256),
              ("xgbmc refit, level 5", 6, 16, 2, 3, 32))
#: ``hist_matmul`` (tag, real tree columns, stat columns, leaves)
HIST_CASES = (("GBT refit leaves", 1, 128, 64),
              ("gbt12 refit leaves", 1, 128, 256),
              ("RF sweep leaves", 48, 192, 64),
              ("xgbmc refit leaves", 6, 128, 64))
#: the forest predicts' serve shapes: (tag, T, depth, W; None for heaps,
#: k leaf columns)
SERVE_ROWS = 65536
PREDICT_CASES = (("RF serve", 50, 12, 256, 1),
                 ("gbt12 serve", 20, 12, 256, 1),
                 ("GBT serve", 20, 6, None, 1), ("DT serve", 1, 6, None, 1),
                 ("rfmc serve", 50, 12, 256, 6),
                 ("xgbmc serve", 600, 6, None, 6))
#: the leaf sums' refit shapes: (tag, T, depth, W; None for heaps, every
#: split the sentinel so that every row lands in leaf 0, k stats: the
#: class counts or [-y, 1, 1] times the weight, and the weight)
LEAF_SUM_CASES = (("RF refit", 50, 12, 256, False, 3),
                  ("DT refit", 1, 6, None, False, 3),
                  ("RF refit, every row in leaf 0", 50, 12, 256, True, 3),
                  ("rfreg refit", 50, 12, 256, False, 4),
                  ("rfmc refit", 50, 12, 256, False, 7))


def bound_ms(nbytes: int, ops: int):
    """Least time for the work: bytes over HBM rate vs operations over the
    fp32 non-tensor peak (the data sheet gives no separate int32 rate)."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def time_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn()`` after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_name(key: str) -> str:
    """A profiler kernel key without its namespaces, template arguments
    and parameters: ``ns::(anonymous namespace)::f<T>(int*)`` -> ``f``."""
    head = key.replace("(anonymous namespace)::", "").split("(")[0].strip()
    return head.split("<")[0].split("::")[-1].split(" ")[-1]


def pass_ms(fn, runs: int) -> dict:
    """Device ms per call of each kernel ``fn`` launches (``torch.profiler``
    over ``runs`` calls), by kernel name."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0))
        if dev_us > 0 and getattr(ev, "device_type", None) == \
                torch.autograd.DeviceType.CUDA:
            name = kernel_name(ev.key)
            out[name] = out.get(name, 0.0) + dev_us / 1e3 / runs
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def node_inputs(dev, rng, T, Wl, stride, k, live):
    """Growth-level inputs: codes (S, 64) in [0, 32] (5% the sentinel),
    each row's slot per tree among ``live`` slots, int64 as the growers
    keep it, [0, 1) stats."""
    codes = rng.randint(0, NODE_BINS, (ROWS, CODES))
    codes[rng.rand(ROWS, CODES) < 0.05] = NODE_BINS
    node = rng.randint(0, stride * live, (ROWS, T))
    return (torch.from_numpy(codes.astype(np.int32)).to(dev),
            torch.from_numpy(node.astype(np.int64)).to(dev),
            [torch.from_numpy(rng.rand(ROWS, T).astype(np.float32)).to(dev)
             for _ in range(k)])


def node_bound(codes, node, sw, Wl, stride):
    """Each input read once (the int64 node 8 bytes an entry), the cells
    written once; one add per stat for every valid (row, tree, code)."""
    S, d = codes.shape
    T, k = node.shape[1], len(sw)
    adds = k * int(((node >= 0) & (node % stride == 0)
                    & (node < stride * Wl)).sum(1).double()
                   @ (codes < NODE_BINS).sum(1).double())
    return bound_ms(4 * S * d + 8 * S * T + 4 * k * S * T
                    + 4 * k * Wl * T * d * NODE_BINS, adds)


def leaf_inputs(dev, rng, real, B, L):
    """``_diag_leaf_hist``'s layout: 64 tree columns, the first ``real``
    holding leaf ids and the rest the sentinel L; B // 64 stats per tree
    (stat column j * 64 + t: G and H at a GBT refit, two class counts and
    the weight at the RF sweep), [0, 1) for the real trees, zero for the
    padded ones."""
    codes = np.full((ROWS, CODES), L, np.int32)
    codes[:, :real] = rng.randint(0, L, (ROWS, real))
    A = np.zeros((ROWS, B), np.float32)
    for j in range(B // CODES):
        A[:, j * CODES:j * CODES + real] = rng.rand(ROWS, real)
    return torch.from_numpy(codes).to(dev), torch.from_numpy(A).to(dev)


def hist_bound(codes, A, nb):
    """Each input read once, the output written once; one add per stat
    column for every valid code."""
    S, d = codes.shape
    B = A.shape[1]
    return bound_ms(4 * (S * d + S * B + B * d * nb),
                    int((codes < nb).sum()) * B)


def profile(runs: int) -> list:
    from transmogrifai_tpu_torch.histeng import kernels as HK

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    rows = []
    for tag, T, Wl, stride, k, live in NODE_CASES:
        codes, node, sw = node_inputs(dev, rng, T, Wl, stride, k, live)

        def call():
            return HK.node_hist_matmul(codes, node, sw, Wl, NODE_BINS, stride)
        b = node_bound(codes, node, sw, Wl, stride)
        rows.append(dict(case="node_hist " + tag, ms=time_ms(call, runs),
                         passes_ms=pass_ms(call, runs), bound_ms=b[0],
                         bound_by=b[1]))
    for tag, real, B, L in HIST_CASES:
        codes, A = leaf_inputs(dev, rng, real, B, L)
        oh = HK._one_hot(codes, L)

        def call():
            return HK.hist_matmul(codes, A, L, exact=True)
        with HK._tf32_off():
            lib = time_ms(lambda: A.T @ oh, runs)
        b = hist_bound(codes, A, L)
        rows.append(dict(case="hist_matmul " + tag, ms=time_ms(call, runs),
                         passes_ms=pass_ms(call, runs), bound_ms=b[0],
                         bound_by=b[1], library_ms=lib))
        del oh
    rows += profile_predict(runs)
    rows += profile_leaf_sums(runs)
    return rows


def profile_predict(runs: int) -> list:
    """The forest predicts at their serve shapes, through the public
    functions."""
    from transmogrifai_tpu_torch.ops import forest as F
    from transmogrifai_tpu_torch.testing import random_chain, random_heap

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(1)
    rows = []
    for tag, T, depth, W, k in PREDICT_CASES:
        if W is None:
            f = {key: torch.from_numpy(v).to(dev) for key, v in random_heap(
                rng, SERVE_ROWS, CODES, T, depth, k, NODE_BINS).items()}

            def call():
                return F.forest_predict(f["codes"], f["feat"], f["bins"],
                                        f["leaf"], depth=depth,
                                        n_bins=NODE_BINS)
            name = "forest_predict_heap "
        else:
            f = {key: torch.from_numpy(v).to(dev) for key, v in random_chain(
                rng, SERVE_ROWS, CODES, T, depth, W, k, NODE_BINS).items()}

            def call():
                return F.forest_predict_chain(f["codes"], f["feat"], f["bins"],
                                              f["base"], f["leaf"],
                                              n_bins=NODE_BINS)
            name = "forest_predict_chain "
        rows.append(dict(case=name + tag, ms=time_ms(call, runs),
                         passes_ms=pass_ms(call, runs)))
    return rows


def profile_leaf_sums(runs: int) -> list:
    """The leaf sums at their refit shapes, through the public
    functions."""
    from transmogrifai_tpu_torch.ops import forest as F
    from transmogrifai_tpu_torch.testing import random_chain, random_heap

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(2)
    rows = []
    for tag, T, depth, W, one_leaf, k in LEAF_SUM_CASES:
        aug = torch.from_numpy(rng.rand(ROWS, k).astype(np.float32)).to(dev)
        f = (random_heap(rng, ROWS, CODES, T, depth, 1, NODE_BINS)
             if W is None else random_chain(rng, ROWS, CODES, T, depth, W, 1,
                                            NODE_BINS))
        if one_leaf:
            f["bins"][:] = NODE_BINS
            if W is not None:
                f["base"][:] = 0
        f = {key: torch.from_numpy(v).to(dev) for key, v in f.items()}
        if W is None:
            def call():
                return F.forest_leaf_sums(f["codes"], f["feat"], f["bins"],
                                          aug, depth=depth, n_bins=NODE_BINS)
            name = "forest_leaf_sums_heap "
        else:
            def call():
                return F.forest_leaf_sums_chain(
                    f["codes"], f["feat"], f["bins"], f["base"], aug,
                    n_bins=NODE_BINS)
            name = "forest_leaf_sums_chain "
        rows.append(dict(case=name + tag, ms=time_ms(call, runs),
                         passes_ms=pass_ms(call, runs)))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose package to time")
    ap.add_argument("--runs", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_hist: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    for row in profile(args.runs):
        print(json.dumps(dict(root=args.root, **row)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
