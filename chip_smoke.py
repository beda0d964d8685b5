"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero:

(a) build every CUDA source of the port (one nvcc each, all at once);
(b) hold each kernel against its plain PyTorch version on the card, at the
    shapes the serve path gives it (65,536 rows, 32 bins; RF slot chain
    T=50 depth 12 W=256, GBT heap T=20 depth 6, k=1): leaf ids exactly,
    sums within rtol 1e-5 / atol 1e-6, and their times;
(c) serve: load the committed RF and GBT fixtures on the card, score their
    4,096-row frames against the JAX package's outputs (probability_1 atol
    1e-5; prediction equal wherever |p - 0.5| > 1e-5), answer single-row
    requests through score_function, score 65,536-row batches and report
    rows/sec. The kernels' launch counts are zeroed just before this phase
    and read just after it; every kernel must have launched;
(d) print the ``kernels`` JSON line;
(e) print the card's name and power limit.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the package beside it, the script fails before printing it.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np
import torch

#: H100 SXM data-sheet peaks
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

N_ROWS = 65536
N_FEATURES = 64
N_BINS = 32
SUM_RTOL, SUM_ATOL = 1e-5, 1e-6
PROB_ATOL = 1e-5
PRED_MARGIN = 1e-5
TIMED_RUNS = 25


def time_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
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


def bound_ms(nbytes: int, ops: int):
    """Least time for the work: bytes over HBM rate vs operations over the
    fp32 non-tensor peak (the data sheet gives no separate int32 rate)."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def phase_build():
    from transmogrifai_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    logs = cuda_build.build()
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  [{name}] {line.strip()}")
    print(f"(a) build: {len(logs)} source(s) compiled in {secs:.2f} s")


def phase_kernels(dev):
    """Each kernel against its plain version at the serve shapes."""
    from transmogrifai_tpu_torch.ops import forest as F
    from transmogrifai_tpu_torch.testing import random_chain, random_heap

    rng = np.random.RandomState(0)
    results = {}

    # RF: slot chain, T=50, depth 12, W=256, k=1
    T, depth, W, k = 50, 12, 256, 1
    c = {key: torch.from_numpy(v).to(dev) for key, v in random_chain(
        rng, N_ROWS, N_FEATURES, T, depth, W, k, N_BINS).items()}
    args = (c["codes"], c["feat"], c["bins"], c["base"], c["leaf"])
    got, ids = F.forest_predict_chain_cuda(*args, with_ids=True)
    want_ids = F.route_codes_chain(c["codes"], c["feat"], c["bins"],
                                   c["base"], N_BINS)
    want = F.forest_predict_chain_plain(*args, n_bins=N_BINS)
    torch.cuda.synchronize()
    if not torch.equal(ids, want_ids):
        raise AssertionError("forest_predict_chain: leaf slots differ from "
                             "route_codes_chain")
    torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=SUM_ATOL)
    slots = sum(min(2 ** lv, W) for lv in range(depth))
    nbytes = (N_ROWS * N_FEATURES * 4 + T * slots * 3 * 4
              + c["leaf"].numel() * 4 + N_ROWS * k * 4)
    results["forest_predict_chain"] = dict(
        max_abs_err=float((got - want).abs().max()),
        ms=time_ms(lambda: F.forest_predict_chain_cuda(*args)),
        plain_ms=time_ms(lambda: F.forest_predict_chain_plain(
            *args, n_bins=N_BINS)),
        bound=bound_ms(nbytes, N_ROWS * T * (depth + k)))

    # GBT: complete heap, T=20, depth 6, k=1
    T, depth, k = 20, 6, 1
    h = {key: torch.from_numpy(v).to(dev) for key, v in random_heap(
        rng, N_ROWS, N_FEATURES, T, depth, k, N_BINS).items()}
    args = (h["codes"], h["feat"], h["bins"], h["leaf"])
    got, ids = F.forest_predict_heap_cuda(*args, depth=depth, with_ids=True)
    want_ids = F.route_codes(h["codes"], h["feat"], h["bins"], depth,
                             N_BINS)
    want = F.forest_predict_plain(*args, depth=depth, n_bins=N_BINS)
    torch.cuda.synchronize()
    if not torch.equal(ids, want_ids):
        raise AssertionError("forest_predict_heap: leaf ids differ from "
                             "route_codes")
    torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=SUM_ATOL)
    nbytes = (N_ROWS * N_FEATURES * 4 + 2 * h["feat"].numel() * 4
              + h["leaf"].numel() * 4 + N_ROWS * k * 4)
    results["forest_predict_heap"] = dict(
        max_abs_err=float((got - want).abs().max()),
        ms=time_ms(lambda: F.forest_predict_heap_cuda(*args, depth=depth)),
        plain_ms=time_ms(lambda: F.forest_predict_plain(
            *args, depth=depth, n_bins=N_BINS)),
        bound=bound_ms(nbytes, N_ROWS * T * (depth + k)))
    for name, r in results.items():
        print(f"(b) {name}: max_abs_err {r['max_abs_err']:.3g}, "
              f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound'][0]:.5f} ms by {r['bound'][1]})")
    return results


def _p1_and_pred(model, scored):
    col = scored[model.result_features[0].name]
    keys = list(col.metadata["keys"])
    vals = col.values.cpu().numpy()
    return (vals[:, keys.index("probability_1")],
            vals[:, keys.index("prediction")])


def phase_serve():
    """The port's main path: load, score, answer requests."""
    import transmogrifai_tpu_torch as tt

    fixtures = os.path.join(HERE, "transmogrifai_tpu_torch", "fixtures",
                            "serve64")
    for key in ("rf", "gbt"):
        path = os.path.join(fixtures, key)
        model = tt.load_model(path)                # default: the card
        if model.device.type != "cuda":
            raise AssertionError(f"{key} loaded on {model.device}")
        exp = np.load(os.path.join(path, "expected.npz"))
        X = exp["X"]
        frame = {f"x{i}": X[:, i] for i in range(X.shape[1])}
        p1, pred = _p1_and_pred(model, model.score(data=frame))
        if p1.shape != exp["probability_1"].shape or \
                not np.isfinite(p1).all():
            raise AssertionError(f"{key}: bad probability_1 {p1.shape}")
        err = float(np.abs(p1 - exp["probability_1"]).max())
        if err > PROB_ATOL:
            raise AssertionError(f"{key}: probability_1 off by {err}")
        far = np.abs(exp["probability_1"] - 0.5) > PRED_MARGIN
        flips = int((pred != exp["prediction"])[far].sum())
        if flips:
            raise AssertionError(f"{key}: {flips} predictions differ")
        score = model.score_function()
        for i in range(4):
            out = score({name: (None if np.isnan(v[i]) else float(v[i]))
                         for name, v in frame.items()})
            p = next(iter(out.values()))["probability_1"]
            if abs(p - exp["probability_1"][i]) > PROB_ATOL:
                raise AssertionError(f"{key}: request {i} scored {p}")
        reps = N_ROWS // X.shape[0]
        big = {name: np.tile(v, reps) for name, v in frame.items()}
        _p1_and_pred(model, model.score(data=big))          # warm-up
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            p1_big, _ = _p1_and_pred(model, model.score(data=big))
            times.append(time.perf_counter() - t0)
        if not np.allclose(p1_big, np.tile(p1, reps), atol=PROB_ATOL):
            raise AssertionError(f"{key}: 65,536-row batch disagrees")
        print(f"(c) {key}: probability_1 max err {err:.3g}, 0 prediction "
              f"flips, {N_ROWS / statistics.median(times):.1f} rows/sec "
              f"on {N_ROWS}-row batches")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from transmogrifai_tpu_torch.ops import forest as F

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    kern = phase_kernels(dev)
    for k in F.KERNELS:
        k.launches = 0
    phase_serve()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in F.KERNELS}
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"kernel(s) {idle} never launched on the "
                             f"serve path")
    print(json.dumps({"kernels": [{
        "name": k.name, "route": "cuda",
        "source": "transmogrifai_tpu_torch/csrc/" + k.source,
        "replaces": k.replaces, "launches": launches[k.name],
        "max_abs_err": kern[k.name]["max_abs_err"],
        "ms": kern[k.name]["ms"], "plain_ms": kern[k.name]["plain_ms"],
        "bound_ms": kern[k.name]["bound"][0],
        "bound_by": kern[k.name]["bound"][1],
        "library_ms": None} for k in F.KERNELS]}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
