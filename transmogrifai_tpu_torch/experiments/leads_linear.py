"""Path (a)'s linear sweeps against the fixture's fold metrics, beside
controls that change only the arithmetic, on one NVIDIA GPU.

    python3 -m transmogrifai_tpu_torch.experiments.leads_linear
        [--rows 20000] [--device cuda|cpu] [--orders 3]

Trains the leads workflow (``testing.leads_workflow``, label
``Converted``, the date clock at ``LEADS_CLOCK_MS``) on
``leads_records(rows, LEADS_SEED)`` and takes its selector's rows again
(``testing.selection_rows``). Then it sweeps each linear family of the
default list on them (``testing.sweep_again``), in these runs:

* ``shipped``: the sweep as the train runs it, on ``--device``;
* ``f64``: the sweep on the rows in float64 (``models.linear``: the same
  bf16 roundings, XLA's float32 exp, every other value and sum in
  float64);
* ``no_bf16``: the sweep's schedule without its bf16 rounding (float32);
* ``cpu``: ``shipped`` on the CPU (the port's plain arithmetic there);
* ``order<s>``: ``shipped`` with the vector's columns in the seeded order
  ``RandomState(s).permutation`` (the same model; only the order of the
  float32 sums changes), ``--orders`` of them.

Prints the card's name and power limit, then one JSON line per (family,
run): its (folds, configurations) fold metrics, its largest |d| from the
``f64`` run, and, when ``rows`` is the fixture's, the largest |d| per
configuration from the fixture's fold metrics
(``fixtures/leads/fixture.json``). Each fold's base rate, and the metric
of a constant score (every row tied) and of NaN scores, are printed
first: the values a collapsed or a diverged fit takes.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ..impl.tuning import validators as VA
from ..models import linear as L
from ..testing import (
    LEADS_CLOCK_MS, LEADS_ROWS, LEADS_SEED, leads_records, leads_workflow,
    selection_rows, sweep_again,
)

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "fixtures", "leads", "fixture.json")
LINEAR = ("OpLogisticRegression", "OpLinearSVC")


def runs(selector, X, y, orders: int) -> dict:
    """{family: {run: (folds, configurations) metrics}}."""
    out = {f: {} for f in LINEAR}

    def put(run, got):
        for family, m in got.items():
            out[family][run] = m
    put("shipped", sweep_again(selector, X, y, LINEAR))
    put("f64", sweep_again(selector, X.double(), y.double(), LINEAR))
    saved = L._rounder
    L._rounder = lambda sweep: (lambda x: x)
    try:
        put("no_bf16", sweep_again(selector, X, y, LINEAR))
    finally:
        L._rounder = saved
    if X.is_cuda:
        put("cpu", sweep_again(selector, X.cpu(), y.cpu(), LINEAR))
    for s in range(orders):
        perm = torch.as_tensor(np.random.RandomState(s).permutation(
            X.shape[1]), device=X.device)
        put(f"order{s}", sweep_again(selector, X[:, perm], y, LINEAR))
    return out


def fold_floors(selector, y) -> list:
    """Per fold: (base rate, the metric of a constant score, the metric of
    NaN scores), by the selector's own metric on the fold's validation
    rows."""
    y = y.cpu().numpy()
    metric_name, _ = selector.validation_metric
    metric = VA._metric_fn(selector.problem, metric_name,
                           binned=VA.bucket_for(len(y)) >= VA._BINNED_MIN_N)
    out = []
    for m in selector.validator.make_splits(y):
        yv = torch.as_tensor(y[m], dtype=torch.float32)[None]
        every = torch.ones_like(yv, dtype=torch.bool)
        out.append([float(yv.mean())] + [
            float(metric(torch.full_like(yv, v), yv, every)[0])
            for v in (0.5, float("nan"))])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=LEADS_ROWS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--orders", type=int, default=3)
    a = ap.parse_args(argv)
    os.environ["TG_FAST_GRIDS"] = "0"
    if a.device.startswith("cuda"):
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    wf, _, pred, _ = leads_workflow(leads_records(a.rows, LEADS_SEED),
                                    device=a.device, clock_ms=LEADS_CLOCK_MS)
    model = wf.train()
    selector = pred.origin_stage
    X, y = selection_rows(selector, model.train_table)
    print(f"selection rows: X {tuple(X.shape)} on {X.device}")
    print(json.dumps({"fold_floors": fold_floors(selector, y)}))
    want = None
    if a.rows == LEADS_ROWS:
        with open(FIXTURE) as fh:
            want = {f["family"]: np.asarray(f["fold_metrics"], np.float64)
                    for f in json.load(fh)["selection"]["families"]}
    for family, rs in runs(selector, X, y, a.orders).items():
        for run, m in rs.items():
            line = {"family": family, "run": run, "folds": m.tolist(),
                    "from_f64": float(np.abs(m - rs["f64"]).max())}
            if want is not None:
                line["from_fixture"] = np.abs(
                    m - want[family]).max(axis=0).tolist()
            print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
