"""Where the serve path's time goes, on one NVIDIA GPU.

    python3 -m transmogrifai_tpu_torch.profile_serve [--rows 65536] [--reps 5]

Loads each saved model of the committed ``serve64`` fixtures
(``testing.SAVED_KEYS``) on the card and scores a batch of ``--rows``
rows (the fixtures' 4,096-row scoring frame, rebuilt from its seed by
``testing.score_frame``, tiled) through ``OpWorkflowModel.score``; and
``titanic``, the saved Titanic workflow (``fixtures/titanic/model``, its
lambdas from ``examples.titanic.build_workflow``) on its 4,096-row
scoring file (``testing.titanic_csv``, read as columns, tiled). For
each model it prints one JSON line with the median host-clock seconds of
each phase (host table build, host-to-device copy, each stage,
device-to-host copy of the result; every phase ends in
``torch.cuda.synchronize()``), the rows/sec of the whole call, and the
device time per kernel name from ``torch.profiler`` over ``--reps``
calls.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .testing import SAVED_KEYS, score_frame

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "serve64")


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _model_and_frame(key: str, tmp: str):
    """A saved model on the card and its scoring frame's columns."""
    import transmogrifai_tpu_torch as tt
    if key != "titanic":
        return tt.load_model(os.path.join(FIXTURES, key)), score_frame()
    from .examples.titanic import TITANIC_SCHEMA, build_workflow
    from .features import reset_uids
    from .readers import read_csv
    from .testing import TITANIC_SCORE_ROWS, TITANIC_SCORE_SEED, titanic_csv
    path = os.path.join(tmp, "titanic.csv")
    titanic_csv(path, TITANIC_SCORE_ROWS, TITANIC_SCORE_SEED)
    reset_uids()
    wf = build_workflow(path)[0]
    model = tt.load_model(os.path.join(os.path.dirname(FIXTURES), "titanic",
                                       "model"), workflow=wf)
    return model, read_csv(path, TITANIC_SCHEMA, header=False).columns


def profile(key: str, rows: int, reps: int) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        model, frame = _model_and_frame(key, tmp)
    n = len(next(iter(frame.values())))
    data = {k: np.tile(v, -(-rows // n))[:rows] for k, v in frame.items()}
    name = model.result_features[0].name
    phases: dict = {}

    def once():
        host, t = _timed(lambda: model.raw_table(data))
        phases.setdefault("host_table_s", []).append(t)
        dev, t = _timed(lambda: host.to_device(model.device))
        phases.setdefault("h2d_s", []).append(t)
        table = dev
        for stage in model.stages:
            table, t = _timed(lambda: stage.transform(table))
            phases.setdefault(f"{type(stage).__name__}_s", []).append(t)
        _, t = _timed(lambda: table[name].values.cpu().numpy())
        phases.setdefault("d2h_s", []).append(t)

    once()                                      # warm-up
    phases.clear()
    for _ in range(reps):
        once()
    whole = []
    for _ in range(reps):
        _, t = _timed(lambda: model.score(data=data)[name].values.cpu())
        whole.append(t)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            model.score(data=data)[name].values.cpu()
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0))
        if dev_us > 0 and getattr(ev, "device_type", None) == \
                torch.autograd.DeviceType.CUDA:
            kernels[ev.key[:80]] = dev_us / reps / 1e3
    busy_ms = sum(kernels.values())
    return {
        "model": key, "rows": rows, "reps": reps,
        "phases_s": {k: statistics.median(v) for k, v in phases.items()},
        "score_s": statistics.median(whole),
        "rows_per_sec": rows / statistics.median(whole),
        "device_busy_ms_per_call": busy_ms,
        "device_ms_by_kernel": dict(sorted(kernels.items(),
                                           key=lambda kv: -kv[1])[:12]),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=65536)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    for key in SAVED_KEYS + ["titanic"]:
        print(json.dumps(profile(key, args.rows, args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
