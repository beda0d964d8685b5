"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero:

(a) build every CUDA source of the port (one nvcc each, all at once);
(b) hold each kernel against its plain PyTorch version on the card, at the
    shapes its path gives it, and report its times:
    - the forest descents at the serve shapes (65,536 rows, 32 bins; RF
      slot chain T=50 depth 12 W=256, GBT heap T=20 depth 6, k=1): leaf
      ids exactly, sums within rtol 1e-5 / atol 1e-6;
    - ``hist_matmul`` at the GBT refit's leaf-sum shape (19,712 rows, 64
      trees as features, 64 leaves as bins, 128 stat columns, exact), in
      that call's layout (one real tree, 63 sentinel columns; the timed
      case of the ``kernels`` line) and with every code valid, and at a
      bf16 growth shape (64 features, 32 bins, 384 columns): within rtol
      1e-5 / atol 1e-6 of the plain version on [0, 1) stats, bit-equal on
      integer-valued stats and across reruns, and at an odd shape within
      the same tolerance of the direct float64 formula;
(t) train: rebuild the serve bench's 20,000 x 64 frame and train the
    pinned GBT workflow on the card (``OpWorkflow().train()``), then hold
    it against the committed ``serve64/gbt`` fixture that the JAX package
    trained on the same frame: bin edges bit-equal, the same kept columns,
    trees identical (counted; the first differing node is reported with
    the split-gain gap there), fold and holdout AuPR within 5e-3, and
    probability_1 on the fixture's 4,096-row frame within mean 5e-3 (max
    1e-4 when every tree is identical). The kernels' launch counts are
    zeroed just before training and read just after; ``hist_matmul`` must
    have launched at least once per boosting round, and
    ``forest_predict_heap`` (CV fold scoring, the evaluations) at least once;
(c) serve: load the committed RF and GBT fixtures on the card, score their
    4,096-row frames against the JAX package's outputs (probability_1 atol
    1e-5; prediction equal wherever |p - 0.5| > 1e-5), answer single-row
    requests through score_function, score 65,536-row batches and report
    rows/sec. The launch counts are zeroed just before this phase and read
    just after it; both forest kernels must have launched;
(d) print each path's launch counts and the ``kernels`` JSON line, whose
    launches are the sums over (t) and (c);
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

FIXTURES = os.path.join(HERE, "transmogrifai_tpu_torch", "fixtures",
                        "serve64")
#: the training run behind the committed serve64/gbt fixture
TRAIN_ROWS = 20000
TRAIN_SEED = 0
GBT_HYPER = {"maxDepth": 6, "maxIter": 20, "stepSize": 0.1,
             "minInstancesPerNode": 10, "minInfoGain": 0.001}
#: the GBT refit's leaf sums: bucket_for(18,000) rows, 64 tree columns
#: (one tree padded to a block of 64), 64 leaves, G and H per tree
REFIT_ROWS, REFIT_TREES, REFIT_LEAVES = 19712, 64, 64
#: train-vs-fixture limits (sums run in another order than the JAX
#: package's XLA programs on the CPU, so metrics agree to rounding)
AUPR_ATOL = 5e-3
P1_MEAN_ATOL = 5e-3
P1_MAX_ATOL_SAME_TREES = 1e-4


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


def _hist_case(dev, rng, S, d, B, nb, sentinel=0.05):
    """codes (S, d) in [0, nb] (a ``sentinel`` share equal to nb), [0, 1)
    stats and integer-valued stats, on the card."""
    codes = rng.randint(0, nb, (S, d))
    codes[rng.rand(S, d) < sentinel] = nb
    return (torch.from_numpy(codes.astype(np.int32)).to(dev),
            torch.from_numpy(rng.rand(S, B).astype(np.float32)).to(dev),
            torch.from_numpy(rng.randint(-3, 4, (S, B)).astype(
                np.float32)).to(dev))


def _refit_leaf_case(dev, rng):
    """The layout of the GBT refit's leaf-sum call: one tree padded to a
    block of 64 tree columns, so column 0 holds leaf ids and the other 63
    the sentinel; stat columns 0 (G) and 64 (H) carry values, the padded
    trees' columns are zero."""
    codes = np.full((REFIT_ROWS, REFIT_TREES), REFIT_LEAVES, np.int32)
    codes[:, 0] = rng.randint(0, REFIT_LEAVES, REFIT_ROWS)
    A = np.zeros((REFIT_ROWS, 2 * REFIT_TREES), np.float32)
    A[:, 0] = rng.rand(REFIT_ROWS)
    A[:, REFIT_TREES] = rng.rand(REFIT_ROWS) * 0.25
    return torch.from_numpy(codes).to(dev), torch.from_numpy(A).to(dev)


def _check_hist(tag, codes, A, A_int, nb, exact):
    """Kernel against plain: tolerance on ``A``, bits on ``A_int`` and on
    a rerun."""
    from transmogrifai_tpu_torch.histeng import kernels as HK
    got = HK.hist_matmul_cuda(codes, A, nb, exact)
    want = HK.hist_matmul_plain(codes, A, nb, exact)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=SUM_ATOL)
    if A_int is not None and not torch.equal(
            HK.hist_matmul_cuda(codes, A_int, nb, exact),
            HK.hist_matmul_plain(codes, A_int, nb, exact)):
        raise AssertionError(f"hist_matmul ({tag}): integer-valued stats "
                             f"are not bit-equal to plain")
    if not torch.equal(got, HK.hist_matmul_cuda(codes, A, nb, exact)):
        raise AssertionError(f"hist_matmul ({tag}): reruns differ")
    return float((got - want).abs().max())


def _time_hist(codes, A, nb, exact):
    from transmogrifai_tpu_torch.histeng import kernels as HK
    S, d = codes.shape
    B = A.shape[1]
    oh = HK._one_hot(codes, nb)
    return dict(ms=time_ms(lambda: HK.hist_matmul_cuda(codes, A, nb, exact)),
                plain_ms=time_ms(lambda: HK.hist_matmul_plain(
                    codes, A, nb, exact)),
                library_ms=time_ms(lambda: A.T @ oh),
                # each input read once, the output written once; one add
                # per stat column for every valid code of this data
                bound=bound_ms(4 * (S * d + S * B + B * d * nb),
                               int((codes < nb).sum()) * B))


def phase_hist(dev, rng):
    """``hist_matmul`` against its plain version, the direct formula and
    one library matmul."""
    from transmogrifai_tpu_torch.histeng import kernels as HK
    from transmogrifai_tpu_torch.testing import hist_direct

    codes, A = _refit_leaf_case(dev, rng)
    r = dict(max_abs_err=_check_hist("refit", codes, A, A.round(),
                                     REFIT_LEAVES, True),
             **_time_hist(codes, A, REFIT_LEAVES, True))
    cases = [("refit layout", r)]
    for tag, B, d, nb, exact in (("refit shape, every code valid",
                                  2 * REFIT_TREES, REFIT_TREES, REFIT_LEAVES,
                                  True),
                                 ("growth, bf16", 384, N_FEATURES, N_BINS,
                                  False)):
        codes, A, A_int = _hist_case(dev, rng, REFIT_ROWS, d, B, nb)
        cases.append((tag, dict(
            max_abs_err=_check_hist(tag, codes, A, A_int, nb, exact),
            **_time_hist(codes, A, nb, exact))))
    for tag, c in cases:
        print(f"(b) hist_matmul {tag}: max_abs_err {c['max_abs_err']:.3g}, "
              f"{c['ms']:.4f} ms (plain {c['plain_ms']:.4f} ms, library "
              f"{c['library_ms']:.4f} ms, bound {c['bound'][0]:.5f} ms by "
              f"{c['bound'][1]})")
    # an odd shape against the definition, both modes
    S, d, B, nb = 1001, 7, 13, 37
    codes, A, _ = _hist_case(dev, rng, S, d, B, nb, sentinel=0.2)
    for exact in (True, False):
        Ain = A if exact else A.to(torch.bfloat16).to(torch.float32)
        want = torch.from_numpy(hist_direct(codes.cpu().numpy(),
                                            Ain.cpu().numpy(), nb)).to(dev)
        got = HK.hist_matmul_cuda(codes, A, nb, exact)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.double(), want, rtol=SUM_RTOL,
                                   atol=SUM_ATOL)
    print(f"(b) hist_matmul odd shape (S {S}, d {d}, B {B}, nb {nb}): "
          f"both modes match the direct float64 formula")
    return r


def phase_kernels(dev):
    """Each kernel against its plain version at its path's shapes."""
    from transmogrifai_tpu_torch.ops import forest as F
    from transmogrifai_tpu_torch.testing import random_chain, random_heap

    rng = np.random.RandomState(0)
    results = {"hist_matmul": phase_hist(dev, rng)}

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
        if name == "hist_matmul":
            continue
        print(f"(b) {name}: max_abs_err {r['max_abs_err']:.3g}, "
              f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound'][0]:.5f} ms by {r['bound'][1]})")
    return results


def _gain_gap(model, data, fixture, t: int, j: int) -> float:
    """Split gain of the port's choice minus the fixture's at heap node
    ``j`` of boosting round ``t``, both scored on the port's own state
    there: the refit rows, F after the first ``t`` (identical) trees, and
    the node's bf16-operand histogram, as the grower builds it."""
    from transmogrifai_tpu_torch.histeng import hist_matmul_plain
    from transmogrifai_tpu_torch.impl.tuning.splitters import DataBalancer
    from transmogrifai_tpu_torch.models import trees as TR
    from transmogrifai_tpu_torch.ops.forest import route_codes
    from transmogrifai_tpu_torch.utils.padding import bucket_for

    sel = model.stages[-1]
    p = sel.fitted.params
    checked = model.stages[-2].get_output().name
    X = model.score(data=data)[checked].values          # all rows, kept cols
    train_idx, _ = DataBalancer(seed=TRAIN_SEED).split(X.shape[0])
    X = X[torch.as_tensor(train_idx, device=X.device)]
    y = torch.as_tensor(data["y"][train_idx], device=X.device)
    n = X.shape[0]
    n_pad = bucket_for(n)
    X = torch.nn.functional.pad(X, (0, 0, 0, n_pad - n))
    y = torch.nn.functional.pad(y, (0, n_pad - n))
    w = (torch.arange(n_pad, device=X.device) < n).float()
    codes = TR._bin_features(X, p["edges"])
    F = torch.zeros(n_pad, device=X.device)
    feat, bins, leaf = p["feat"][:, 0], p["bins"][:, 0], p["leaf"][:, 0]
    depth = TR._depth_of(leaf.shape[-1])
    for r in range(t):
        ids = route_codes(codes, feat[r:r + 1], bins[r:r + 1], depth,
                          TR.N_BINS)[:, 0].long()
        F = (F.double() + float(p["eta"]) * leaf[r][ids].double()).float()
    pr = torch.sigmoid(F)
    stats = torch.stack([(pr - y) * w, torch.clamp(pr * (1 - pr), min=1e-6)
                         * w, w], dim=1)
    level = int(np.log2(j + 1))
    q = j - (2 ** level - 1)
    ids = route_codes(codes, feat[t:t + 1], bins[t:t + 1], level,
                      TR.N_BINS)[:, 0]
    at = (ids == q).float()[:, None]
    hist = hist_matmul_plain(codes, stats * at, TR.N_BINS).reshape(
        3, codes.shape[1], TR.N_BINS).permute(1, 2, 0)[None]
    cum = torch.cumsum(hist, dim=2)
    total = cum[:, 0, -1, :]
    SL = cum[:, :, :-1, :]
    one = lambda v: torch.tensor([v], dtype=torch.float32, device=X.device)
    gain, valid = TR._split_gain(
        SL, total[:, None, None, :] - SL, total,
        {"lam": one(0.0), "min_child_weight": one(0.0),
         "min_instances": one(GBT_HYPER["minInstancesPerNode"])}, "gh")
    gain = torch.where(valid, gain, torch.full_like(gain, -float("inf")))[0]

    def at_split(f, b):
        return (float(gain[f, b]) if b < TR.N_BINS - 1
                else GBT_HYPER["minInfoGain"])
    fx = fixture["feat"][t, 0, j], fixture["bins"][t, 0, j]
    return (at_split(int(feat[t, j]), int(bins[t, j]))
            - at_split(int(fx[0]), int(fx[1])))


def phase_train():
    """Train the serve bench's GBT workflow on the card and hold the model
    against the fixture the JAX package trained on the same frame."""
    import transmogrifai_tpu_torch as tt
    from transmogrifai_tpu_torch.testing import (
        serve_bench_data, serve_bench_workflow,
    )

    data = serve_bench_data(TRAIN_ROWS, N_FEATURES, TRAIN_SEED)
    wf = serve_bench_workflow("OpGBTClassifier", GBT_HYPER, N_FEATURES,
                              TRAIN_SEED).set_input_dataset(data)
    if wf.device.type != "cuda":
        raise AssertionError(f"training on {wf.device}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = wf.train()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"(t) train: {TRAIN_ROWS} x {N_FEATURES}, GBT depth 6 x 20 "
          f"rounds, 3-fold CV + refit + evaluations in {secs:.3f} s")

    path = os.path.join(FIXTURES, "gbt")
    ref = tt.load_model(path)
    rs, ps = ref.stages[-1], model.stages[-1]
    fx = {k: v.cpu().numpy() for k, v in rs.fitted.params.items()}
    got = {k: v.cpu().numpy() for k, v in ps.fitted.params.items()}
    if not np.array_equal(got["edges"], fx["edges"]):
        raise AssertionError("bin edges differ from the fixture's: max "
                             f"{np.abs(got['edges'] - fx['edges']).max()}")
    if model.stages[-2].keep_indices != ref.stages[-2].keep_indices:
        raise AssertionError("SanityChecker kept other columns than the "
                             "fixture")
    same = [np.array_equal(got["feat"][t], fx["feat"][t])
            and np.array_equal(got["bins"][t], fx["bins"][t])
            for t in range(len(fx["feat"]))]
    print(f"(t) edges bit-equal, kept columns equal "
          f"({len(model.stages[-2].keep_indices)}), trees identical: "
          f"{sum(same)} of {len(same)}")
    if not all(same):
        t = same.index(False)
        diff = np.nonzero((got["feat"][t, 0] != fx["feat"][t, 0])
                          | (got["bins"][t, 0] != fx["bins"][t, 0]))[0]
        j = int(diff[0])
        print(f"(t) first differing tree: round {t}, heap node {j} (port "
              f"split f{got['feat'][t, 0, j]}/b{got['bins'][t, 0, j]}, "
              f"fixture f{fx['feat'][t, 0, j]}/b{fx['bins'][t, 0, j]}), "
              f"gain gap {_gain_gap(model, data, fx, t, j):.6g}")
    folds = np.asarray(ps.summary.validation_results[0].fold_metrics,
                       dtype=np.float64).ravel()
    ref_folds = torch.as_tensor(
        rs.summary.validation_results[0].fold_metrics).cpu().numpy().ravel()
    hold = ps.summary.holdout_evaluation["AuPR"]
    ref_hold = rs.summary.holdout_evaluation["AuPR"]
    print(f"(t) fold AuPR {folds.tolist()} (fixture {ref_folds.tolist()}), "
          f"holdout AuPR {hold:.6f} (fixture {ref_hold:.6f}), splitter "
          f"{ps.summary.splitter_summary} (fixture "
          f"{rs.summary.splitter_summary})")
    if np.abs(folds - ref_folds).max() > AUPR_ATOL or \
            abs(hold - ref_hold) > AUPR_ATOL:
        raise AssertionError("AuPR off the fixture's by more than "
                             f"{AUPR_ATOL}")
    exp = np.load(os.path.join(path, "expected.npz"))
    frame = {f"x{i}": exp["X"][:, i] for i in range(exp["X"].shape[1])}
    p1, _ = _p1_and_pred(model, model.score(data=frame))
    if p1.shape != exp["probability_1"].shape or not np.isfinite(p1).all():
        raise AssertionError(f"bad probability_1 {p1.shape}")
    dp = np.abs(p1 - exp["probability_1"])
    print(f"(t) probability_1 vs the JAX-trained model on "
          f"{len(p1)} rows: max |d| {dp.max():.3g}, mean |d| {dp.mean():.3g}")
    if dp.mean() > P1_MEAN_ATOL or (all(same)
                                    and dp.max() > P1_MAX_ATOL_SAME_TREES):
        raise AssertionError("probability_1 off the fixture's beyond the "
                             "stated limits")
    return secs


def _p1_and_pred(model, scored):
    col = scored[model.result_features[0].name]
    keys = list(col.metadata["keys"])
    vals = col.values.cpu().numpy()
    return (vals[:, keys.index("probability_1")],
            vals[:, keys.index("prediction")])


def phase_serve():
    """The port's main path: load, score, answer requests."""
    import transmogrifai_tpu_torch as tt

    for key in ("rf", "gbt"):
        path = os.path.join(FIXTURES, key)
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
    from transmogrifai_tpu_torch.histeng import kernels as HK
    from transmogrifai_tpu_torch.ops import forest as F

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = HK.KERNELS + F.KERNELS
    phase_build()
    kern = phase_kernels(dev)

    def run_path(phase, path_kernels):
        """Zero every count, drive the path, read the counts; each of
        ``path_kernels`` must have launched."""
        for k in kernels:
            k.launches = 0
        phase()
        torch.cuda.synchronize()
        counts = {k.name: k.launches for k in path_kernels}
        idle = [name for name, n in counts.items() if n == 0]
        if idle:
            raise AssertionError(f"kernel(s) {idle} never launched on the "
                                 f"{phase.__name__} path")
        return counts

    # training scores its CV folds and evaluations with the heap descent
    train = run_path(phase_train, HK.KERNELS + (F.FOREST_PREDICT_HEAP,))
    if train["hist_matmul"] < GBT_HYPER["maxIter"]:
        raise AssertionError(f"hist_matmul launched {train['hist_matmul']} "
                             f"times in training, fewer than the boosting "
                             f"rounds")
    serve = run_path(phase_serve, F.KERNELS)
    print(f"launches: training {train}, serving {serve}")
    launches = {k.name: train.get(k.name, 0) + serve.get(k.name, 0)
                for k in kernels}
    print(json.dumps({"kernels": [{
        "name": k.name, "route": "cuda",
        "source": "transmogrifai_tpu_torch/csrc/" + k.source,
        "replaces": k.replaces, "launches": launches[k.name],
        "max_abs_err": kern[k.name]["max_abs_err"],
        "ms": kern[k.name]["ms"], "plain_ms": kern[k.name]["plain_ms"],
        "bound_ms": kern[k.name]["bound"][0],
        "bound_by": kern[k.name]["bound"][1],
        "library_ms": kern[k.name].get("library_ms")} for k in kernels]}))
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
