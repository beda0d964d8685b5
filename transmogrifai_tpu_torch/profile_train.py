"""Where the training path's time goes, on one NVIDIA GPU.

    python3 -m transmogrifai_tpu_torch.profile_train
        [--family gbt|gbt12|rf|dt|rfreg|gbtreg|rfmc|xgbmc|lr|svc|lrmc|nbmc|
                  linreg|glm|default_binary|default_mc|default_reg|mlp|
                  mlpmc|titanic|titanic_wcv|leads|leads_stage]
        [--rows 20000] [--reps 3]

Trains one of the serve bench's workflows (64 ``Real`` predictors,
``transmogrify -> sanity_check -> <problem>ModelSelector``;
``testing.serve_bench_workflow``, ``testing.SERVE_MODELS``): the pinned
binary ``gbt`` maxDepth 6, 20 rounds; ``gbt12`` maxDepth 12, 20 rounds
(slot chains); ``rf`` maxDepth 12, 50 trees; ``dt`` maxDepth 6; ``lr``
(elastic net) and ``svc``; regression ``rfreg`` (RF as ``rf``),
``gbtreg`` (GBT as ``gbt``), ``linreg`` and ``glm`` (gaussian); 6-class
``rfmc`` (RF as ``rf``), ``xgbmc`` (XGBoost maxDepth 6, 100 rounds),
``lrmc`` (softmax) and ``nbmc``; the MLP (two hidden layers of 50)
binary ``mlp`` and 6-class ``mlpmc``; or a problem kind's default model list
at full default grids (``default_binary``, ``default_mc``,
``default_reg``); or ``titanic``, the mixed-type path
(``examples.titanic.build_workflow``: the CSV reader, PickList, Text,
Integral and Real features, ``transmogrify`` to ~570 columns, the binary
default list) on the file ``testing.titanic_csv`` writes, whose host
phases (reading, each vectorizer's fit and transform) are timed too; or
``titanic_wcv``, that workflow with the raw feature filter reading the
4,096-row scoring file and workflow-level CV
(``testing.titanic_wcv_workflow``), whose workflow phases (the filter,
the label-independent stages, the folds' preparation, the per-fold
sweeps, the rest with the refit) are timed too; or ``leads`` and
``leads_stage``, the lead-conversion paths (``testing.leads_workflow``:
dates, geolocations and maps through ``transmogrify`` to ~620 columns,
then the binary default list, or the indexed stage label with the RF of
``rfmc`` and the prediction deindexer) on ``testing.leads_records``,
built with the date clock at the fixtures' instant. It
trains on ``--rows`` seeded rows, once to
warm up and then ``--reps`` times, and prints one JSON line: the median
over the trains of the seconds of the whole ``train()``, and of each
stage's fit, and inside the selector of the CV sweep (in all and per
family: its sweep fits and its validation predicts), the winner's refit
and the train/holdout evaluations, each summed over a train (host
clock, each ending in ``torch.cuda.synchronize()``);
the peak device memory allocated over those trains
(``torch.cuda.max_memory_allocated``); then, from ``torch.profiler`` over
one more train, the device time per kernel name and the device's busy
share of the train.
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
from contextlib import contextmanager

import torch

from .testing import (
    LEADS_CLOCK_MS, LEADS_PATHS, LEADS_SEED, SERVE_MODELS, leads_records,
    leads_workflow, serve_bench_data, serve_bench_workflow,
)


@contextmanager
def _timing(phases: dict):
    """Time each stage fit, the selector's sweep (and each family's sweep
    fits and validation predicts in it), refit and evaluations by wrapping
    them for the duration of the block."""
    from .evaluators import (
        OpBinaryClassificationEvaluator, OpMultiClassificationEvaluator,
        OpRegressionEvaluator,
    )
    from .filters import RawFeatureFilter
    from .impl.feature import dates as DT, geo as G, maps as M, text as TX
    from .impl.feature import vectorizers as V
    from .impl.preparators import prediction_deindexer as PD
    from .impl.preparators.sanity_checker import SanityChecker
    from .readers.readers import Reader
    from .stages.base import _LambdaTransformer
    from .impl.selector.model_selector import ModelSelector, SelectedModel
    from .impl.tuning.validators import OpValidator
    from .models import glm, linear, mlp, trees  # noqa: F401  (registers)
    from .models.api import MODEL_REGISTRY

    #: the sweep's own fit calls are not refits
    in_sweep = []
    targets = [
        (Reader, "generate_table", lambda *a, **k: "host: read raw table"),
        (_LambdaTransformer, "transform_column",
         lambda *a, **k: "host: lambda transformers"),
    ] + [
        (cls, "fit", lambda *a, name=cls.__name__, **k: f"fit {name}")
        for cls in (V.RealVectorizer, V.IntegralVectorizer,
                    V.OneHotVectorizer, V.SmartTextVectorizer,
                    G.GeolocationVectorizer, G.GeolocationMapVectorizer,
                    M.MapVectorizer, M.TextMapPivotVectorizer,
                    M.SmartTextMapVectorizer, TX.OpStringIndexer,
                    PD.PredictionDeIndexer)
    ] + [
        (cls, "transform_column",
         lambda *a, name=cls.__name__, **k: f"transform {name}")
        for cls in (V.RealVectorizerModel, V.OneHotVectorizerModel,
                    V.SmartTextVectorizerModel, V.VectorsCombiner,
                    DT.DateToUnitCircleTransformer, DT.DateListVectorizer,
                    DT.DateMapToUnitCircleVectorizer,
                    G.GeolocationVectorizerModel,
                    G.GeolocationMapVectorizerModel, M.MapVectorizerModel,
                    M.TextMapPivotVectorizerModel,
                    M.SmartTextMapVectorizerModel, TX.OpStringIndexerModel,
                    PD.PredictionDeIndexerModel)
    ] + [
        (SanityChecker, "fit", lambda *a, **k: "fit SanityChecker"),
        (RawFeatureFilter, "filter_raw",
         lambda *a, **k: "host: raw feature filter"),
        (ModelSelector, "fit", lambda *a, **k: "fit ModelSelector"),
        (OpValidator, "validate", lambda *a, **k: "selector: CV sweep"),
        (SelectedModel, "transform_column",
         lambda *a, **k: "selector: evaluation predicts"),
    ] + [
        (cls, "evaluate_all", lambda *a, **k: "selector: evaluation metrics")
        for cls in (OpBinaryClassificationEvaluator,
                    OpMultiClassificationEvaluator, OpRegressionEvaluator)
    ]
    for fam in MODEL_REGISTRY.values():
        targets += [
            (fam, "sweep_fit_batch",
             lambda *a, name=fam.name, **k: f"sweep fits: {name}"),
            (fam, "predict_batch",
             lambda *a, name=fam.name, **k: f"sweep predicts: {name}"),
            (fam, "fit_batch",
             lambda *a, name=fam.name, **k: None if in_sweep
             else f"refit: {name}")]
    saved = [(owner, name, getattr(owner, name), name in vars(owner))
             for owner, name, _ in targets]

    def timed(key_fn, fn, nests):
        def run(*a, **kw):
            key = key_fn(*a, **kw)
            if key is None:
                return fn(*a, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if nests:
                in_sweep.append(1)
            try:
                out = fn(*a, **kw)
            finally:
                if nests:
                    in_sweep.pop()
            torch.cuda.synchronize()
            phases.setdefault(key, []).append(time.perf_counter() - t0)
            return out
        return run

    for (owner, name, key_fn), (_, _, fn, _) in zip(targets, saved):
        setattr(owner, name, timed(key_fn, fn, name == "sweep_fit_batch"))
    try:
        yield
    finally:
        for owner, name, fn, own in saved:
            if own:
                setattr(owner, name, fn)
            else:
                delattr(owner, name)


def _workflow_fn(family: str, rows: int, tmp: str):
    """An untrained workflow of ``family`` over ``rows`` rows, anew per
    call."""
    if family in ("titanic", "titanic_wcv"):
        from .examples.titanic import build_workflow
        from .testing import (
            TITANIC_SCORE_ROWS, TITANIC_SCORE_SEED, titanic_csv,
            titanic_wcv_workflow,
        )
        path = os.path.join(tmp, "titanic.csv")
        titanic_csv(path, rows)
        if family == "titanic":
            return lambda: build_workflow(path)[0]
        score = os.path.join(tmp, "titanic_score.csv")
        titanic_csv(score, TITANIC_SCORE_ROWS, TITANIC_SCORE_SEED)
        return lambda: titanic_wcv_workflow(path, score)[0]
    if family in LEADS_PATHS:
        recs = leads_records(rows, LEADS_SEED)
        label, models = LEADS_PATHS[family]
        return lambda: leads_workflow(recs, label, models,
                                      clock_ms=LEADS_CLOCK_MS)[0]
    name, hyper, task = SERVE_MODELS[family]
    data = serve_bench_data(rows, 64, seed=0, task=task)
    return lambda: serve_bench_workflow(
        name, hyper, 64, seed=0, problem=task).set_input_dataset(data)


def profile(family: str, rows: int, reps: int) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        return _profile(_workflow_fn(family, rows, tmp), family, rows, reps)


def _profile(workflow, family: str, rows: int, reps: int) -> dict:
    #: the workflow's own phases of each train ({} without workflow CV
    #: or a filter)
    workflow_phases: list = []

    def train():
        wf = workflow()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wf.train()
        torch.cuda.synchronize()
        workflow_phases.append(dict(wf.phase_seconds))
        return time.perf_counter() - t0

    train()                                     # warm-up
    phases: dict = {}
    per_train = []
    with _timing(phases):
        for _ in range(reps):
            phases.clear()
            train()
            per_train.append({k: sum(v) for k, v in phases.items()})
    timed_phases = {k for p in per_train for k in p}
    workflow_phases.clear()
    torch.cuda.reset_peak_memory_stats()
    whole = [train() for _ in range(reps)]
    peak = torch.cuda.max_memory_allocated()
    wf_phases = list(workflow_phases)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall = train()
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0))
        if dev_us > 0 and getattr(ev, "device_type", None) == \
                torch.autograd.DeviceType.CUDA:
            kernels[ev.key[:80]] = dev_us / 1e3
    busy_ms = sum(kernels.values())
    return {
        "family": family, "rows": rows, "reps": reps,
        "train_s": statistics.median(whole),
        "phases_s": {k: statistics.median(p.get(k, 0.0) for p in per_train)
                     for k in sorted(timed_phases)},
        "workflow_phases_s": {
            k: statistics.median(p[k] for p in wf_phases)
            for k in wf_phases[0]},
        "peak_mem_bytes": peak,
        "profiled_train_s": wall,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / 1e3 / wall,
        "device_ms_by_kernel": dict(sorted(kernels.items(),
                                           key=lambda kv: -kv[1])[:40]),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", choices=sorted(SERVE_MODELS)
                    + ["titanic", "titanic_wcv"] + sorted(LEADS_PATHS),
                    default="gbt")
    ap.add_argument("--rows", type=int, default=20000)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    print(json.dumps(profile(args.family, args.rows, args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
