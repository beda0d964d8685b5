"""Command line (counterpart of ``transmogrifai_tpu.cli``): ``gen``,
``trace``, ``serve``, ``slo``, ``fleet``, ``campaign`` and ``doctor``.
``programs`` is registered and refuses: the AOT program store waits
(ROADMAP Queue 1 item 10).

    python -m transmogrifai_tpu_torch.cli gen --input data.csv \\
        --response y --output my_project --name MyApp [--id-field id] \\
        [--schema schema.avsc] [--answers answers.txt] [--device cpu]
    python -m transmogrifai_tpu_torch.cli trace --output ./trace_out \\
        [--dataset synthetic|iris] [--rows 600] [--seed 42]
    python -m transmogrifai_tpu_torch.cli serve --model DIR \\
        [--seconds 5] [--rps 0] [--listen 127.0.0.1:0] [--output DIR]
    python -m transmogrifai_tpu_torch.cli slo --model DIR [--seconds 5]
    python -m transmogrifai_tpu_torch.cli fleet --model DIR \\
        [--replicas 2] [--kill] [--subprocess] [--models N]
    python -m transmogrifai_tpu_torch.cli campaign [--schedules N] ...
    python -m transmogrifai_tpu_torch.cli doctor BUNDLE [--json]

Every subcommand that trains or serves runs on the CUDA device unless
``--device cpu`` (or another device) is given, and raises without one
(``device.resolve_device``). ``gen`` writes ``--device`` into the
generated app (``DEVICE``; none: the CUDA device). ``doctor`` reads a
post-mortem bundle of either package and runs nothing on a device.

``gen`` (the reference's ``op gen``) takes the schema from an Avro
``.avsc`` (``--schema``) or infers it from the data as the JAX package
does from a DataFrame (a numeric response with more than 20 distinct
values is a regression, two or fewer binary, else multiclass; bool
columns Binary, ints Integral, floats Real, other columns PickList when
they hold at most max(30, rows / 20) distinct values, else Text), applies
the ``--answers`` file (``problem=``, ``type.<field>=``, ``role.<field>=``)
and writes ``app.py``, ``README.md`` and ``test_app.py``. The app reads
through the port's ``DataReaders``, imports neither pandas nor the JAX
package, and its documented score run writes ``./scores.parquet``.

A campaign failure prints its reproducer, which re-runs one schedule:
``TG_CHAOS=1 TG_FAULTS='<json>' python -m transmogrifai_tpu_torch.cli
campaign --scenario <s>`` (exit 1 when an oracle fires).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# gen
# ---------------------------------------------------------------------------


def _present(arr: np.ndarray) -> list:
    """The column's values without its missing cells (``dropna``)."""
    if arr.dtype.kind == "f":
        return arr[~np.isnan(arr)].tolist()
    if arr.dtype.kind == "M":
        return arr[~np.isnat(arr)].tolist()
    return [v for v in arr.tolist()
            if v is not None and not (isinstance(v, float) and v != v)]


def _nunique(values: list) -> int:
    return len(set(values))


def _unique(values: list) -> list:
    """Distinct values in order of appearance (``Series.unique``)."""
    return list(dict.fromkeys(values))


def infer_schema(frame, response: str, id_field: Optional[str]
                 ) -> Tuple[str, List[Tuple[str, str]]]:
    """(problem kind, [(column, FeatureType name)]) of a frame, as the
    JAX package's ``infer_schema`` makes of the DataFrame of the same
    data (the module docstring has the rules)."""
    y = frame[response]
    ys = _present(y)
    if y.dtype.kind in "biufc" and _nunique(ys) > 20:
        problem = "regression"
    elif _nunique(ys) <= 2:
        problem = "binary"
    else:
        problem = "multiclass"
    fields: List[Tuple[str, str]] = []
    for col, s in frame.columns.items():
        if col == response or col == id_field:
            continue
        kind = s.dtype.kind
        if kind == "b":
            ft = "Binary"
        elif kind in "iu":
            ft = "Integral"
        elif kind == "f":
            ft = "Real"
        elif kind == "M":
            ft = "DateTime"
        else:
            nun = _nunique(_present(s))
            ft = "PickList" if nun <= max(30, len(s) // 20) else "Text"
        fields.append((col, ft))
    return problem, fields


#: Avro primitive -> FeatureType (enums pivot as PickList, nullable
#: unions unwrap)
_AVRO_TYPES = {"int": "Integral", "long": "Integral", "boolean": "Binary",
               "float": "Real", "double": "Real", "string": "Text"}


def avro_schema_fields(schema_path: str) -> List[Tuple[str, str]]:
    """An Avro record schema (.avsc) -> [(field, FeatureType)]."""
    with open(schema_path) as fh:
        schema = json.load(fh)
    if schema.get("type") != "record":
        raise SystemExit(f"{schema_path}: top-level avro type must be "
                         f"'record', got {schema.get('type')!r}")
    out: List[Tuple[str, str]] = []
    for f in schema.get("fields", []):
        t = f["type"]
        if isinstance(t, list):  # nullable union: unwrap the non-null arm
            arms = [a for a in t if a != "null"]
            if len(arms) != 1:
                raise SystemExit(
                    f"{schema_path}: field {f['name']!r} has a multi-type "
                    f"union {t} — only nullable two-arm unions are supported")
            t = arms[0]
        if isinstance(t, dict):
            if t.get("type") == "enum":
                out.append((f["name"], "PickList"))
                continue
            t = t.get("type")
        ft = _AVRO_TYPES.get(t)
        if ft is None:
            raise SystemExit(
                f"{schema_path}: unsupported avro type {t!r} for field "
                f"{f['name']!r} (supported: {sorted(_AVRO_TYPES)}, enum)")
        out.append((f["name"], ft))
    return out


def parse_answers(path: str) -> Dict[str, str]:
    """A ``key=value`` answers file (``#`` comments, blank lines)."""
    out: Dict[str, str] = {}
    with open(path) as fh:
        for ln, line in enumerate(fh, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if "=" not in line:
                raise SystemExit(f"{path}:{ln}: expected key=value, "
                                 f"got {line!r}")
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def _apply_answers(problem: str, fields: List[Tuple[str, str]],
                   answers: Dict[str, str],
                   reserved: Tuple[Optional[str], ...] = ()
                   ) -> Tuple[str, List[Tuple[str, str]]]:
    """The answers applied: the problem kind, each field's type and role
    (``predictor``, ``id`` or ``drop``); unknown fields, types, keys and
    roles that contradict the command line raise ``SystemExit``."""
    problem = answers.get("problem", problem)
    if problem not in ("binary", "multiclass", "regression"):
        raise SystemExit(f"answers: problem must be binary|multiclass|"
                         f"regression, got {problem!r}")
    from .types import FEATURE_TYPES
    known = {c for c, _ in fields}
    response_name = reserved[0] if reserved else None
    reserved_names = {r for r in reserved if r}
    for k, v in answers.items():
        if k.startswith(("role.", "type.")):
            fld = k.split(".", 1)[1]
            if fld in reserved_names:
                if k.startswith("role."):
                    want = "response" if fld == response_name else "id"
                    if v != want:
                        raise SystemExit(
                            f"answers: {k}={v!r} contradicts the command "
                            f"line, which assigned {fld!r} as the {want}")
                continue
            if fld not in known:
                raise SystemExit(
                    f"answers: {k} refers to unknown field {fld!r} "
                    f"(fields: {sorted(known)})")
        if k.startswith("type.") and v not in FEATURE_TYPES:
            raise SystemExit(f"answers: {k}={v!r} is not a feature type")
        if not k.startswith(("role.", "type.")) and k != "problem":
            raise SystemExit(f"answers: unknown key {k!r}")
    out: List[Tuple[str, str]] = []
    for col, ft in fields:
        role = answers.get(f"role.{col}", "predictor")
        if role in ("drop", "id"):
            continue
        if role != "predictor":
            raise SystemExit(f"answers: role.{col} must be "
                             f"predictor|id|drop, got {role!r}")
        out.append((col, answers.get(f"type.{col}", ft)))
    return problem, out


_APP_TEMPLATE = '''\
"""{name} — generated by `python -m transmogrifai_tpu_torch.cli gen`.

Train:   python app.py --run-type train --model-location ./model
Score:   python app.py --run-type score --model-location ./model \\\\
                       --write-location ./scores.parquet
"""
from transmogrifai_tpu_torch import FeatureBuilder, transmogrify
from transmogrifai_tpu_torch.impl.selector.factories import {selector}
from transmogrifai_tpu_torch.readers.readers import DataReaders
from transmogrifai_tpu_torch.runner import OpApp, OpWorkflowRunner
from transmogrifai_tpu_torch.workflow import OpWorkflow

DATA_PATH = {data_path!r}
#: where the workflow trains and scores (None: the CUDA device)
DEVICE = {device!r}

# -- raw features (inferred from the data's schema; edit types as needed) ----
{response_lines}
predictors = [
{predictor_lines}
]

# -- pipeline -----------------------------------------------------------------
features = transmogrify(predictors)
checked = features.sanity_check(response)
prediction = ({selector}
              .with_cross_validation(seed=42)
              .set_input(response, checked).get_output())

workflow = OpWorkflow(device=DEVICE).set_result_features(prediction)
runner = OpWorkflowRunner(
    workflow,
    train_reader={reader_expr},
)

if __name__ == "__main__":
    result = OpApp(runner).main()
    if result.model is not None:
        print(result.model.summary_pretty())
'''

_README_TEMPLATE = """\
# {name}

Generated by `python -m transmogrifai_tpu_torch.cli gen` from `{data_path}`.

- problem kind: **{problem}**
- response: `{response}`
- predictors: {n_predictors} columns
- device: {device_text}

```bash
python app.py --run-type train --model-location ./model
python app.py --run-type score --model-location ./model --write-location ./scores.parquet
```
"""

_TEST_TEMPLATE = '''\
"""Smoke test for the generated app."""
import subprocess
import sys


def test_app_trains(tmp_path):
    out = subprocess.run(
        [sys.executable, "app.py", "--run-type", "train",
         "--model-location", str(tmp_path / "model")],
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
'''


def _read_input(path: str):
    """(frame, reader expression of the generated app) of a CSV (header
    line, pandas' typing) or an Avro file."""
    from .readers.readers import Frame, read_csv
    if path.endswith(".avro"):
        from .utils.avro import read_avro
        return (Frame.of(list(read_avro(path))),
                "DataReaders.Simple.avro(DATA_PATH)")
    return read_csv(path), "DataReaders.Simple.csv_auto(DATA_PATH)"


def generate(input_csv: str, response: str, output: str, name: str,
             id_field: Optional[str] = None,
             schema: Optional[str] = None,
             answers: Optional[str] = None,
             device: Optional[str] = None) -> Dict[str, str]:
    """Write the project (``app.py``, ``README.md``, ``test_app.py``) into
    ``output``; -> {file name: text}."""
    frame, reader_expr = _read_input(input_csv)
    if response not in frame:
        raise SystemExit(f"response column {response!r} not in {input_csv} "
                         f"(columns: {list(frame.columns)})")
    problem, fields = infer_schema(frame, response, id_field)
    if schema is not None:
        declared = avro_schema_fields(schema)
        names = {c for c, _ in declared}
        if response not in names:
            raise SystemExit(f"response {response!r} not in schema {schema}")
        fields = [(c, ft) for c, ft in declared
                  if c != response and c != id_field]
    if answers is not None:
        problem, fields = _apply_answers(problem, fields,
                                         parse_answers(answers),
                                         reserved=(response, id_field))
    selector = {
        "binary": "BinaryClassificationModelSelector",
        "multiclass": "MultiClassificationModelSelector",
        "regression": "RegressionModelSelector",
    }[problem]
    predictor_lines = "\n".join(
        f"    FeatureBuilder.{ft}({col!r}).extract_field().as_predictor(),"
        for col, ft in fields)
    # classification labels reach the selector as 0..K-1: numeric labels
    # already so coded pass through, anything else indexes into the
    # sorted class list
    y = frame[response]
    ys = _present(y)
    numeric = y.dtype.kind in "biufc"
    if problem == "regression" or (
            numeric and sorted(float(v) for v in _unique(ys))
            == [float(i) for i in range(_nunique(ys))]):
        response_lines = (f"response = FeatureBuilder.RealNN({response!r})"
                          f".extract_field().as_response()")
    else:
        labels = sorted(str(v) for v in _unique(ys))
        response_lines = (
            f"RESPONSE_LABELS = {labels!r}\n"
            f"response = FeatureBuilder.RealNN({response!r}).extract(\n"
            f"    lambda r: float(RESPONSE_LABELS.index(str(r.get({response!r}))))\n"
            f"    if str(r.get({response!r})) in RESPONSE_LABELS else None"
            f").as_response()")
    app = _APP_TEMPLATE.format(
        name=name, selector=selector, data_path=os.path.abspath(input_csv),
        response_lines=response_lines, predictor_lines=predictor_lines,
        reader_expr=reader_expr, device=device)
    readme = _README_TEMPLATE.format(
        name=name, data_path=input_csv, problem=problem, response=response,
        n_predictors=len(fields),
        device_text=f"`{device}`" if device else "the CUDA device")
    os.makedirs(output, exist_ok=True)
    files = {"app.py": app, "README.md": readme, "test_app.py": _TEST_TEMPLATE}
    for fname, content in files.items():
        with open(os.path.join(output, fname), "w") as fh:
            fh.write(content)
    return files


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------

def _trace_workflow(dataset: str, rows: int, seed: int, device=None,
                    data_dir: Optional[str] = None):
    """(workflow, scoring rows) of the trace capture run. ``synthetic``:
    three seeded normals and a linear label, an LR / SVC sweep.
    ``iris``: the port's Iris example on its seeded file
    (``examples.iris.write_iris_file``, written under ``data_dir``)."""
    from .features import FeatureBuilder
    from .impl.feature.transmogrifier import transmogrify
    from .impl.selector.factories import BinaryClassificationModelSelector
    from .workflow import OpWorkflow

    if dataset == "iris":
        import tempfile
        from .examples.iris import build_workflow, write_iris_file
        path = os.path.join(data_dir or tempfile.mkdtemp(), "iris.data")
        write_iris_file(path, seed=seed)
        wf, _label, _pred = build_workflow(path, seed=seed, device=device)
        return wf, None
    rng = np.random.RandomState(seed)
    x1, x2, x3 = rng.randn(rows), rng.randn(rows), rng.randn(rows)
    y = ((x1 + 0.5 * x2 - 0.25 * x3) > 0).astype(float)
    data = {"x1": x1, "x2": x2, "x3": x3, "y": y}
    label = FeatureBuilder.RealNN("y").extract_field().as_response()
    preds = [FeatureBuilder.Real(c).extract_field().as_predictor()
             for c in ("x1", "x2", "x3")]
    checked = transmogrify(preds).sanity_check(label)
    # a small two-family sweep: per-family spans and a winner refit
    models = [("OpLogisticRegression",
               [{"regParam": r, "elasticNetParam": 0.0}
                for r in (0.01, 0.1)]),
              ("OpLinearSVC", [{"regParam": 0.01}])]
    pred = (BinaryClassificationModelSelector
            .with_cross_validation(seed=seed, models=models)
            .set_input(label, checked).get_output())
    wf = (OpWorkflow(device=device).set_input_dataset(data)
          .set_result_features(pred))
    score_rows = [dict(x1=float(a), x2=float(b), x3=float(c))
                  for a, b, c in zip(x1[:32], x2[:32], x3[:32])]
    return wf, score_rows


def run_trace(output: str, dataset: str = "synthetic", rows: int = 600,
              seed: int = 42, device=None) -> Dict[str, str]:
    """Train under forced tracing and metrics on ``device`` (default: the
    CUDA device) and write the telemetry bundle (trace.json, spans.jsonl,
    metrics.prom, summary.json) to ``output``."""
    from . import observability
    from .device import resolve_device
    from .observability import export as obs_export
    from .observability import metrics as obs_metrics
    from .observability import trace as obs_trace

    device = resolve_device(device)
    obs_trace.enable_tracing(True)
    obs_metrics.enable_metrics(True)
    try:
        os.makedirs(output, exist_ok=True)
        wf, score_rows = _trace_workflow(dataset, rows, seed, device,
                                         data_dir=output)
        model = wf.train()
        if score_rows:
            # the serving path too: latency histograms, micro-batch spans
            from .local.scoring import micro_batch_score_function
            micro_batch_score_function(model)(score_rows)
        files = {
            "trace.json": obs_export.write_chrome_trace(
                os.path.join(output, "trace.json")),
            "spans.jsonl": obs_export.write_jsonl(
                os.path.join(output, "spans.jsonl")),
            "metrics.prom": obs_export.write_prometheus(
                os.path.join(output, "metrics.prom")),
        }
        summary = observability.summarize()
        with open(os.path.join(output, "summary.json"), "w") as fh:
            json.dump(summary, fh, indent=2, default=str)
        files["summary.json"] = os.path.join(output, "summary.json")
        print(f"wrote {', '.join(sorted(files))} to {output}/ "
              f"({summary['spanCount']} spans; open trace.json in "
              f"chrome://tracing or https://ui.perfetto.dev)")
        return files
    finally:
        obs_trace.enable_tracing(None)
        obs_metrics.enable_metrics(None)


# ---------------------------------------------------------------------------
# serve, slo, fleet
# ---------------------------------------------------------------------------

def _capacity(model, rows, max_batch: int) -> float:
    """Rows/s of three micro-batch calls after one warm-up."""
    import time
    from .local.scoring import micro_batch_score_function
    mb = micro_batch_score_function(model)
    batch = rows[:max_batch]
    mb(batch)
    t0 = time.perf_counter()
    for _ in range(3):
        mb(batch)
    return 3 * len(batch) / (time.perf_counter() - t0)


def run_serve(model_path: str, seconds: float = 5.0, rps: float = 0.0,
              deadline_ms: Optional[float] = None, max_batch: int = 256,
              queue_max: int = 1024, name: str = "model",
              output: Optional[str] = None, seed: int = 42,
              listen: Optional[str] = None, device=None) -> Dict[str, Any]:
    """Load a saved model into the serving registry on ``device``
    (default: the CUDA device), drive the open-loop load generator for
    ``seconds`` and print the load, health and drift summary; with
    ``output`` write the telemetry bundle. ``rps=0`` runs at half the
    rows/s a short saturating run sustains. ``listen="host:port"`` serves
    through a ``NetEdge`` (port 0: a free one) and drives both wire
    framings; a lost or failed request or a broken accounting exits 1."""
    from .device import resolve_device
    from .observability import export as obs_export
    from .observability import metrics as obs_metrics
    from .observability import trace as obs_trace
    from .serving import ModelRegistry, ServeConfig
    from .serving.loadgen import run_open_loop, synthetic_rows

    device = resolve_device(device)
    obs_trace.enable_tracing(True)
    obs_metrics.enable_metrics(True)
    try:
        cfg = ServeConfig.from_env()
        cfg.max_batch = max_batch
        cfg.max_queue = queue_max
        with ModelRegistry(cfg) as reg:
            rt = reg.load(name, model_path, device=device)
            rows = synthetic_rows(rt.model, 512, seed=seed)
            if rps <= 0:
                cap = _capacity(rt.model, rows, max_batch)
                cal = run_open_loop(rt, rows, min(1.0, seconds), cap)
                rps = max(10.0, 0.5 * cal["rowsPerSec"])
            edge_addr = None
            if listen:
                from .serving.loadgen import run_wire_open_loop
                from .serving.netedge import NetEdge
                lhost, _, lport = listen.rpartition(":")
                with NetEdge(rt, host=lhost or "127.0.0.1",
                             port=int(lport or 0), name=name) as edge:
                    edge_addr = "%s:%d" % edge.address
                    print(f"serving '{name}' on {edge_addr} "
                          f"(HTTP/JSON + binary framing)")
                    report = run_wire_open_loop(
                        *edge.address, rows, seconds, rps,
                        deadline_ms=deadline_ms, batch_rows=16)
            else:
                report = run_open_loop(rt, rows, seconds, rps,
                                       deadline_ms=deadline_ms)
            health = reg.health()
            drift_report = None
            if rt.drift_monitor is not None:
                try:
                    rt.drift_monitor.run_verdict()
                except Exception:
                    pass  # report whatever the last pass computed
                drift_report = rt.drift_monitor.report()
        summary = {"model": model_path, "rpsOffered": round(rps, 1),
                   "listen": edge_addr, "device": str(device),
                   "load": report, "health": health["models"][name],
                   "drift": drift_report}
        print(json.dumps(summary, indent=2, default=str))
        if output:
            os.makedirs(output, exist_ok=True)
            obs_export.write_chrome_trace(os.path.join(output, "trace.json"))
            obs_export.write_jsonl(os.path.join(output, "spans.jsonl"))
            obs_export.write_prometheus(
                os.path.join(output, "metrics.prom"))
            with open(os.path.join(output, "serve_summary.json"), "w") as fh:
                json.dump(summary, fh, indent=2, default=str)
            print(f"wrote trace.json, spans.jsonl, metrics.prom, "
                  f"serve_summary.json to {output}/")
        if listen and (report["lost"] or report["failed"]
                       or not report["accountingOk"]):
            print(f"WIRE SOAK FAILED: lost={report['lost']} "
                  f"failed={report['failed']} "
                  f"accountingOk={report['accountingOk']}")
            raise SystemExit(1)
        return summary
    finally:
        obs_trace.enable_tracing(None)
        obs_metrics.enable_metrics(None)


def run_slo(model_path: str, seconds: float = 5.0, rps: float = 0.0,
            availability: Optional[float] = None,
            p99_ms: Optional[float] = None,
            window_s: Optional[float] = None,
            tenants: Optional[str] = None,
            intervals: int = 5, deadline_ms: Optional[float] = None,
            name: str = "model", output: Optional[str] = None,
            seed: int = 42, device=None) -> Dict[str, Any]:
    """Load a saved model on ``device`` (default: the CUDA device),
    register an SLO spec for it, drive the open loop for ``seconds`` in
    ``intervals`` slices and print the budget-burn and scale-hint
    timeline with the final verdicts; exit 1 when a page-severity
    burn-rate alert fired. ``window_s`` scales the 30-day budget window
    (default 3600); ``tenants="a:3,b:1"`` adds a weighted tenant mix with
    per-tenant budgets."""
    from .device import resolve_device
    from .observability import export as obs_export
    from .observability import slo as _slo
    from .observability import timeseries as _timeseries
    from .serving import ModelRegistry, ServeConfig
    from .serving.loadgen import run_open_loop, synthetic_rows

    device = resolve_device(device)
    window = float(window_s) if window_s else 3600.0
    # sample fast enough that the scaled alert windows hold several
    # samples during a seconds-long run
    every = max(min(seconds / max(intervals * 2, 1), 1.0), 0.05)
    saved_env = {k: os.environ.get(k)
                 for k in ("TG_SAMPLE_EVERY_S", "TG_SLO_WINDOW_S")}
    os.environ["TG_SAMPLE_EVERY_S"] = str(every)
    os.environ["TG_SLO_WINDOW_S"] = str(window)
    tenant_mix = None
    if tenants:
        tenant_mix = []
        for part in tenants.split(","):
            t, _, w = part.strip().partition(":")
            tenant_mix.append((t, float(w) if w else 1.0))
    spec_kw: Dict[str, Any] = {"window_s": window}
    if availability is not None:
        spec_kw["availability"] = availability
    if p99_ms is not None:
        spec_kw["latency_p99_ms"] = p99_ms
    _slo.register(_slo.SLOSpec(model=name, **spec_kw))
    if tenant_mix:
        for t, _w in tenant_mix:
            _slo.register(_slo.SLOSpec(model=name, tenant=t, **spec_kw))
    timeline: List[Dict[str, Any]] = []
    try:
        with ModelRegistry(ServeConfig.from_env()) as reg:
            rt = reg.load(name, model_path, device=device)
            rows = synthetic_rows(rt.model, 512, seed=seed)
            if rps <= 0:
                cal = run_open_loop(rt, rows, min(1.0, seconds),
                                    200.0, tenants=tenant_mix)
                rps = max(10.0, 0.5 * max(cal["rowsPerSec"], 20.0))
            slice_s = seconds / max(intervals, 1)
            agg = {"offered": 0, "completed": 0, "shedOverload": 0,
                   "shedDeadline": 0, "failed": 0, "lost": 0}
            for i in range(max(intervals, 1)):
                rep = run_open_loop(rt, rows, slice_s, rps,
                                    deadline_ms=deadline_ms,
                                    tenants=tenant_mix, tenant_seed=i)
                for k in agg:
                    agg[k] += rep.get(k, 0)
                if rt.sampler is not None:
                    rt.sampler.tick()
                rt._evaluate_slo(rt.sampler, None)
                snap = rt.slo_snapshot() or {}
                model_snap = snap.get(name, {})
                avail = (model_snap.get("objectives", {})
                         .get("availability", {}))
                hint = _slo.scale_hint(rt, snap)
                timeline.append({
                    "t": round((i + 1) * slice_s, 2),
                    "rowsPerSec": rep["rowsPerSec"],
                    "p99Ms": rep["p99Ms"],
                    "burnPageLong": round((avail.get("burn", {})
                                           .get("page", {})
                                           .get("long", 0.0)), 3),
                    "budgetRemaining": round(
                        avail.get("budgetRemaining", 1.0), 4),
                    "verdict": model_snap.get("worst", "n/a"),
                    "activeAlerts": model_snap.get("activeAlerts", []),
                    "scaleHint": hint["hint"],
                })
                print(json.dumps({"slice": timeline[-1]}, default=str),
                      flush=True)
            final = rt.slo_snapshot()
            health = reg.health()
            fired = {sev: sum(t.fired.get(sev, 0)
                              for t in rt.slo_trackers)
                     for sev in _slo.SEVERITIES}
            summary = {
                "model": model_path, "rpsOffered": round(rps, 1),
                "device": str(device),
                "windowS": window, "load": agg, "timeline": timeline,
                "slo": final,
                "scaleHint": health["models"][name]["scaleHint"],
                "scaleHints": health["scaleHints"],
                "tenants": health["models"][name].get("tenants"),
                "alertsFired": fired,
            }
            if output:
                os.makedirs(output, exist_ok=True)
                obs_export.write_prometheus(
                    os.path.join(output, "metrics.prom"), rt.metrics)
                with open(os.path.join(output, "slo_summary.json"),
                          "w") as fh:
                    json.dump(summary, fh, indent=2, default=str)
        print(json.dumps(summary, indent=2, default=str))
        if fired.get("page", 0) > 0:
            print(f"SLO: page-severity burn-rate alert fired "
                  f"{fired['page']}x — budget cannot hold at this load",
                  flush=True)
            sys.exit(1)
        return summary
    finally:
        _slo.reset()
        _timeseries.idle_join()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_fleet(model_path: str, replicas: int = 2, seconds: float = 5.0,
              rps: float = 0.0, deadline_ms: Optional[float] = None,
              max_batch: int = 256, queue_max: int = 1024,
              kill: bool = False, use_subprocess: bool = False,
              name: str = "model", output: Optional[str] = None,
              seed: int = 42, models: int = 1,
              device=None) -> Dict[str, Any]:
    """Start ``replicas`` replicas of a saved model on ``device``
    (default: the CUDA device) behind a front door, drive the open loop
    for ``seconds`` and print the fleet report (routing, failovers,
    ejections, sheds, the tail). ``kill`` kills one replica halfway;
    ``use_subprocess`` spawns subprocess replicas; ``models=N`` registers
    the directory under N names with placement on and drives an
    equal-weight model mix. A lost or failed request or a broken
    accounting exits 1."""
    import threading
    from .device import resolve_device
    from .observability import export as obs_export
    from .observability import metrics as obs_metrics
    from .observability import trace as obs_trace
    from .persistence import load_model
    from .serving import FleetConfig, FrontDoor, ServeConfig
    from .serving.loadgen import run_open_loop, synthetic_rows

    device = resolve_device(device)
    obs_trace.enable_tracing(True)
    obs_metrics.enable_metrics(True)
    try:
        cfg = ServeConfig.from_env()
        cfg.max_batch = max_batch
        cfg.max_queue = queue_max
        fc = FleetConfig.from_env()
        fc.device = str(device)
        if use_subprocess:
            fc.subprocess = True
        fc.max_replicas = max(fc.max_replicas, replicas)
        model = load_model(model_path, device=device)
        rows = synthetic_rows(model, 512, seed=seed)
        n_models = max(1, int(models))
        model_map = ({name: model_path} if n_models == 1 else
                     {f"{name}{i}": model_path
                      for i in range(1, n_models + 1)})
        placement = None
        model_mix = None
        if n_models > 1:
            from .serving import PlaceConfig
            placement = PlaceConfig.from_env()
            if placement.max_warm <= 0 and placement.device_budget <= 0:
                # no bound from the environment: one model stays cold, so
                # paging happens
                placement = PlaceConfig(
                    max_warm=n_models - 1,
                    device_budget=placement.device_budget,
                    pagein_timeout_s=placement.pagein_timeout_s,
                    protect_slo=placement.protect_slo)
            model_mix = [(m, 1.0) for m in sorted(model_map)]
        with FrontDoor(model_map, replicas=replicas, config=cfg,
                       fleet_config=fc, warm=True,
                       placement=placement) as fd:
            if rps <= 0:
                cap = _capacity(model, rows, max_batch)
                cal = run_open_loop(fd, rows, min(1.0, seconds), cap)
                rps = max(10.0, 0.5 * cal["rowsPerSec"])
            killer = None
            if kill:
                def _mid_soak_kill():
                    active = [rid for rid, r in sorted(
                        fd._replicas.items()) if r.state == "active"]
                    if active:
                        fd.kill_replica(active[0])
                killer = threading.Timer(seconds / 2.0, _mid_soak_kill)
                killer.daemon = True
                killer.start()
            try:
                report = run_open_loop(fd, rows, seconds, rps,
                                       deadline_ms=deadline_ms,
                                       models=model_mix)
            finally:
                if killer is not None:
                    killer.cancel()
                    killer.join()
            health = fd.health()
        summary = {"model": model_path, "replicas": replicas,
                   "device": str(device), "models": sorted(model_map),
                   "rpsOffered": round(rps, 1), "load": report,
                   "fleet": report.get("fleet"),
                   "placement": (report.get("fleet") or {}).get("placement"),
                   "perModel": report.get("models"),
                   "routing": report.get("replicas"),
                   "ready": health["ready"],
                   "replicaStates": {rid: r.get("state")
                                     for rid, r in
                                     health["replicas"].items()}}
        print(json.dumps(summary, indent=2, default=str))
        if output:
            os.makedirs(output, exist_ok=True)
            obs_export.write_prometheus(
                os.path.join(output, "metrics.prom"))
            with open(os.path.join(output, "fleet_summary.json"),
                      "w") as fh:
                json.dump(summary, fh, indent=2, default=str)
            print(f"wrote metrics.prom, fleet_summary.json to {output}/")
        if report["lost"] or report["failed"] or not report["accountingOk"]:
            print(f"FLEET SOAK FAILED: lost={report['lost']} "
                  f"failed={report['failed']} "
                  f"accountingOk={report['accountingOk']}")
            raise SystemExit(1)
        return summary
    finally:
        obs_trace.enable_tracing(None)
        obs_metrics.enable_metrics(None)


# ---------------------------------------------------------------------------
# campaign
# ---------------------------------------------------------------------------

def run_campaign(schedules: int = 0, seed: Optional[int] = None,
                 scenario: Optional[str] = None,
                 faults_json: Optional[str] = None,
                 output: Optional[str] = None,
                 no_minimize: bool = False,
                 device=None) -> Dict[str, Any]:
    """Run a seeded chaos campaign on ``device`` (default: the CUDA
    device), or re-run one schedule as a reproducer.

    Repro mode: ``faults_json`` (or ``TG_CHAOS=1 TG_FAULTS='<json>'`` in
    the environment) together with ``scenario``; the one schedule runs and
    the process exits 1 when an invariant oracle fires. Otherwise
    ``schedules`` schedules (coverage singletons first), violations
    minimized to reproducers, the report JSON on stdout (and
    ``campaign_report.json`` under ``output``); exit 1 on a violation."""
    from .robustness.campaign import ChaosCampaign

    repro_blob = faults_json or (
        os.environ.get("TG_FAULTS")
        if os.environ.get("TG_CHAOS") and scenario else None)
    if repro_blob and not scenario:
        raise SystemExit(
            "campaign repro mode needs --scenario naming the harness "
            "the TG_FAULTS schedule runs against")
    eng = ChaosCampaign(
        seed=seed, device=device,
        scenarios=None if (repro_blob or scenario is None) else [scenario])
    try:
        if repro_blob:
            result = eng.run_schedule(
                {"scenario": scenario, "faults": json.loads(repro_blob)})
            print(json.dumps(result, indent=2, default=str))
            if result["violations"]:
                sys.exit(1)
            return result
        report = eng.run(count=schedules or None, minimize=not no_minimize)
        doc = report.to_json()
        print(json.dumps(doc, indent=2, default=str))
        if output:
            os.makedirs(output, exist_ok=True)
            path = os.path.join(output, "campaign_report.json")
            with open(path, "w") as fh:
                json.dump(doc, fh, indent=2, default=str)
            print(f"wrote {path}")
        if doc["violations"]:
            sys.exit(1)
        return doc
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# doctor
# ---------------------------------------------------------------------------

def _doctor_ms(ts_ns: Optional[float], anchor_ns: Optional[float]) -> str:
    if ts_ns is None:
        return "       ?"
    if anchor_ns is None:
        return f"{ts_ns / 1e6:12.1f}"
    return f"{(ts_ns - anchor_ns) / 1e6:+12.1f}"


def _doctor_event_line(e: Dict[str, Any], anchor_ns: Optional[float]) -> str:
    attrs = e.get("attrs") or {}
    body = " ".join(f"{k}={v}" for k, v in sorted(attrs.items())
                    if v is not None)
    corr = f" [{e['corr']}]" if e.get("corr") else ""
    return (f"  {_doctor_ms(e.get('tsNs'), anchor_ns)} ms  "
            f"{e.get('kind', '?'):<22}{corr}  {body}"[:200])


def _doctor_series(metrics: Dict[str, Any], prefix: str) -> List[str]:
    lines = []
    for fname, series in sorted(metrics.items()):
        if not fname.startswith(prefix):
            continue
        for key, v in sorted(series.items()):
            if isinstance(v, dict):
                v = f"count={v.get('count')}"
            lines.append(f"   {fname}{{{key}}}: {v}")
    return lines


def _doctor_env(env: Dict[str, Any]) -> str:
    """The environment line: the port's bundle names torch and CUDA, the
    JAX package's jax and jaxlib."""
    devs = env.get("devices") or []
    if "torch" in env:
        return (f"   env     : torch {env.get('torch')} / cuda "
                f"{env.get('cuda')} / {env.get('backend')} x{len(devs)} "
                f"/ python {env.get('python')}")
    return (f"   env     : jax {env.get('jax')} / jaxlib {env.get('jaxlib')} "
            f"/ {env.get('backend')} x{len(devs)} "
            f"/ python {env.get('python')}")


def run_doctor(bundle: str, as_json: bool = False,
               tail: int = 40) -> Dict[str, Any]:
    """Render a post-mortem bundle (a file, or the newest bundle in a
    directory; either package's) as an incident report: the trigger,
    environment, the trigger's correlated timeline, the ring's tail, top
    metrics, compiles and memory, fleet, placement, network, streaming,
    SLO and program-store blocks, the fault log. Exit 1 when the bundle
    fails schema validation."""
    from .observability import postmortem as _postmortem

    path = bundle
    if os.path.isdir(path):
        bundles = _postmortem.list_bundles(path)
        if not bundles:
            raise SystemExit(f"no post-mortem bundles under {path}")
        path = bundles[-1]
    doc = _postmortem.read_bundle(path)
    problems = _postmortem.validate_bundle(doc)
    if as_json:
        out = {"bundle": path, "problems": problems, "doc": doc}
        print(json.dumps(out, indent=2, default=str))
        if problems:
            sys.exit(1)
        return out

    trig = doc.get("trigger", {}) or {}
    anchor = trig.get("tsNs")
    print(f"== post-mortem: {path}")
    print(f"   trigger : {trig.get('kind')}  (pid {doc.get('pid')}, "
          f"unix {trig.get('unixTime')})")
    if trig.get("corr"):
        print(f"   corr    : {trig['corr']}")
    detail = trig.get("detail") or {}
    for k, v in sorted(detail.items()):
        print(f"   {k:<8}: {v}")
    print(_doctor_env(doc.get("environment", {}) or {}))
    if problems:
        print("-- SCHEMA PROBLEMS --")
        for p in problems:
            print(f"   ! {p}")
    corr_events = doc.get("correlated") or []
    if corr_events:
        print(f"-- correlated timeline ({trig.get('corr')}; "
              f"{len(corr_events)} events; ms relative to trigger) --")
        for e in corr_events:
            print(_doctor_event_line(e, anchor))
    ring = (doc.get("recorder") or {}).get("events") or []
    shown = ring[-max(1, tail):]
    print(f"-- ring tail ({len(shown)}/{len(ring)} events; dropped "
          f"{(doc.get('recorder') or {}).get('dropped', 0)}) --")
    for e in shown:
        print(_doctor_event_line(e, anchor))
    # top metrics: the biggest series of the trigger site's registry
    metrics = doc.get("metrics") or doc.get("globalMetrics") or {}
    flat: List[Any] = []
    for name, series in metrics.items():
        for key, v in series.items():
            if isinstance(v, dict):
                lat = {q: v.get(q) for q in ("p50", "p95", "p99")
                       if v.get(q) is not None}
                flat.append((v.get("count", 0), name, key,
                             f"count={v.get('count')} {lat}"))
                for ex in (v.get("exemplars") or [])[:3]:
                    flat.append((v.get("count", 0), name, key,
                                 f"slowest {ex.get('value'):.4f}s -> "
                                 f"{ex.get('exemplar')}"))
            else:
                flat.append((float(v), name, key, f"{v}"))
    flat.sort(key=lambda t: -t[0])
    if flat:
        print("-- top metrics --")
        for _rank, name, key, desc in flat[:12]:
            print(f"   {name}{{{key}}}: {desc}")
    led = doc.get("ledger") or {}
    mem = doc.get("deviceMemory") or {}
    if led or mem:
        print(f"-- compiles & memory ({led.get('builds', 0)} builds) --")
        for sub, causes in sorted((led.get("counts") or {}).items()):
            body = " ".join(f"{c}={n}" for c, n in sorted(causes.items()))
            print(f"   compiles[{sub}]: {body}")
        for rec in (led.get("tail") or [])[-8:]:
            corr = f" [{rec['corr']}]" if rec.get("corr") else ""
            diff = rec.get("diff") or []
            why = f"  ({'; '.join(diff)})" if diff else ""
            print(f"   {rec.get('subsystem', '?'):<7} "
                  f"{rec.get('cause', '?'):<16}{corr}  "
                  f"{rec.get('identity', '?')} "
                  f"{rec.get('seconds', 0.0):.3f}s{why}"[:200])
        for sub, s in sorted((mem.get("subsystems") or {}).items()):
            meas = s.get("measuredPeakBytes")
            measured = (f"measuredPeak={meas}B" if meas is not None
                        else "measured n/a")
            print(f"   mem[{sub}]: dispatches={s.get('dispatches')} "
                  f"predictedPeak={s.get('predictedPeakBytes')}B "
                  f"{measured}")
    fleet_lines = _doctor_series(metrics, "tg_fleet_")
    if fleet_lines or trig.get("kind") == "replica_lost":
        print("-- fleet --")
        for line in fleet_lines:
            print(line)
    place_doc = doc.get("placement") or {}
    place_lines = _doctor_series(metrics, "tg_place_")
    if place_doc or place_lines:
        print("-- placement --")
        for fleet_name, snap in sorted(place_doc.items()):
            resident = snap.get("resident") or {}
            for rid, names in sorted(resident.items()):
                print(f"   {fleet_name}/{rid}: resident="
                      f"{','.join(names) or '-'}")
            cold = snap.get("cold") or []
            if cold:
                print(f"   {fleet_name}: cold={','.join(cold)}")
            refused = snap.get("refused") or []
            if refused:
                print(f"   {fleet_name}: refused={','.join(refused)}")
            print(f"   {fleet_name}: pageIns={snap.get('pageIns')} "
                  f"evictions={snap.get('evictions')} "
                  f"blindAdmits={snap.get('blindAdmits')} "
                  f"pageInP99Ms={snap.get('pageInP99Ms')}")
        for line in place_lines:
            print(line)
    net_lines = _doctor_series(metrics, "tg_net_")
    if net_lines:
        print("-- network --")
        for line in net_lines:
            print(line)
    stream_series = {n: s for n, s in metrics.items()
                     if n.startswith("tg_stream_")}
    if stream_series:
        print("-- streaming --")
        stages = stream_series.get("tg_stream_stage_seconds") or {}
        for key, v in sorted(stages.items()):
            if isinstance(v, dict):
                lat = {q: v.get(q) for q in ("p50", "p95", "p99")
                       if v.get(q) is not None}
                print(f"   stage{{{key}}}: count={v.get('count')} {lat}")
        hits = miss = 0.0
        for v in (stream_series.get("tg_stream_cache_hits_total")
                  or {}).values():
            hits += float(v) if not isinstance(v, dict) else 0.0
        for v in (stream_series.get("tg_stream_cache_misses_total")
                  or {}).values():
            miss += float(v) if not isinstance(v, dict) else 0.0
        if hits or miss:
            rate = hits / max(hits + miss, 1.0)
            print(f"   cache: hits={hits:.0f} misses={miss:.0f} "
                  f"hitRate={rate:.3f}")
        rest = {n: s for n, s in stream_series.items()
                if n not in ("tg_stream_stage_seconds",
                             "tg_stream_cache_hits_total",
                             "tg_stream_cache_misses_total")}
        for line in _doctor_series(rest, "tg_stream_"):
            print(line)
    slo_doc = doc.get("slo") or {}
    if slo_doc:
        print("-- SLO & budgets --")
        for model, specs in sorted(slo_doc.items()):
            for key, snap in sorted((specs or {}).items()):
                objs = snap.get("objectives") or {}
                parts = []
                for obj, o in sorted(objs.items()):
                    v = o.get("verdict", "?")
                    rem = o.get("budgetRemaining")
                    rem_s = (f" budget={rem:.3f}"
                             if isinstance(rem, (int, float)) else "")
                    parts.append(f"{obj}={v}{rem_s}")
                active = snap.get("activeAlerts") or []
                alert_s = ("  ALERTS: " + ", ".join(
                    f"{a.get('severity')}:{a.get('objective')}"
                    for a in active)) if active else ""
                fired = snap.get("fired") or {}
                fired_s = (f"  fired={fired}"
                           if any(fired.values()) else "")
                print(f"   {key:<20} {' '.join(parts)}"
                      f"{alert_s}{fired_s}"[:200])
    for src in (doc.get("samples") or [])[:4]:
        print(f"   sampler[{src.get('source', '?')}]: "
              f"{src.get('samples', 0)} samples / "
              f"{src.get('series', 0)} series @ "
              f"{src.get('everyS', '?')}s")
    aot = doc.get("aot") or {}
    if aot:
        st = aot.get("stats") or {}
        print(f"-- programs (AOT store: "
              f"{'on' if aot.get('enabled') else 'off'}) --")
        print(f"   hits={st.get('hitsTotal', 0)} "
              f"{st.get('hits') or {}}  "
              f"misses={st.get('missesTotal', 0)} "
              f"{st.get('misses') or {}}  "
              f"exports={st.get('exports', 0)}")
        for sess in (aot.get("sessions") or [])[:6]:
            print(f"   session[{sess.get('origin', '?')}]: "
                  f"{sess.get('entries', 0)} entries, "
                  f"{sess.get('loaded', 0)} loaded, "
                  f"{sess.get('planIdents', 0)} plan idents")
        aot_builds = {sub: causes.get("aot-miss", 0)
                      for sub, causes in (led.get("counts") or {}).items()
                      if causes.get("aot-miss")}
        if aot_builds:
            print(f"   aot-miss builds by subsystem: {aot_builds}")
    faults_doc = doc.get("faults") or {}
    buckets = {k: len(v) for k, v in faults_doc.items()
               if isinstance(v, list) and v}
    if buckets:
        print(f"-- fault log: {buckets} "
              f"(dropped {faults_doc.get('droppedReports', 0)})")
    verdict = "INVALID" if problems else "ok"
    print(f"== doctor verdict: {verdict} ==")
    if problems:
        sys.exit(1)
    return {"bundle": path, "problems": problems}


PROGRAMS_WAITS = ("the AOT program store (programstore/*) is not ported: "
                  "`programs` waits with it (ROADMAP Queue 1 item 10)")


# ---------------------------------------------------------------------------
# The parser
# ---------------------------------------------------------------------------

def _device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default=None,
                        help="cuda:0, cpu, ... (default: the CUDA device)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m transmogrifai_tpu_torch.cli",
                                description="transmogrifai_tpu_torch CLI")
    sub = p.add_subparsers(dest="command", required=True)
    gen = sub.add_parser(
        "gen", help="generate a project from a CSV or Avro schema")
    gen.add_argument("--input", required=True, help="CSV or .avro data file")
    gen.add_argument("--response", required=True, help="response column")
    gen.add_argument("--output", required=True, help="output project dir")
    gen.add_argument("--name", default="GeneratedApp")
    gen.add_argument("--id-field", default=None)
    gen.add_argument("--schema", default=None,
                     help="Avro .avsc record schema declaring field types")
    gen.add_argument("--answers", default=None,
                     help="key=value answers file (problem=, type.<f>=, "
                          "role.<f>=) for non-interactive generation")
    gen.add_argument("--device", default=None,
                     help="the generated app's device (default: the CUDA "
                          "device)")
    tr = sub.add_parser(
        "trace", help="train an example dataset under tracing and write "
                      "trace.json + metrics.prom")
    tr.add_argument("--output", required=True,
                    help="directory for trace.json / spans.jsonl / "
                         "metrics.prom / summary.json")
    tr.add_argument("--dataset", default="synthetic",
                    choices=["synthetic", "iris"],
                    help="synthetic: seeded normals; iris: the Iris "
                         "example on its seeded synthetic file")
    tr.add_argument("--rows", type=int, default=600,
                    help="synthetic dataset row count")
    tr.add_argument("--seed", type=int, default=42)
    _device_arg(tr)
    sv = sub.add_parser(
        "serve", help="load a saved model and drive the serving runtime "
                      "under synthetic open-loop load")
    sv.add_argument("--model", required=True,
                    help="saved model directory (OpWorkflowModel.save)")
    sv.add_argument("--seconds", type=float, default=5.0,
                    help="load duration")
    sv.add_argument("--rps", type=float, default=0.0,
                    help="offered requests/sec (0 = half the measured "
                         "capacity)")
    sv.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline; expired requests are shed "
                         "before dispatch")
    sv.add_argument("--max-batch", type=int, default=256,
                    help="continuous-batching flush size")
    sv.add_argument("--queue-max", type=int, default=1024,
                    help="admission bound (beyond it requests shed with "
                         "OverloadError)")
    sv.add_argument("--name", default="model", help="registry model name")
    sv.add_argument("--listen", default=None, metavar="HOST:PORT",
                    help="serve over the network edge (HTTP/JSON + binary "
                         "framing on a real socket; port 0 = a free port; "
                         "exits non-zero on any lost future or accounting "
                         "break)")
    sv.add_argument("--output", default=None,
                    help="directory for the telemetry bundle (trace.json / "
                         "spans.jsonl / metrics.prom / serve_summary.json)")
    sv.add_argument("--seed", type=int, default=42)
    _device_arg(sv)
    fl = sub.add_parser(
        "fleet", help="start N replicas of a saved model behind a front "
                      "door, drive the open-loop soak and print the fleet "
                      "report; exits non-zero on any lost request")
    fl.add_argument("--model", required=True,
                    help="saved model directory (OpWorkflowModel.save)")
    fl.add_argument("--replicas", type=int, default=2,
                    help="worker replica count")
    fl.add_argument("--seconds", type=float, default=5.0,
                    help="load duration")
    fl.add_argument("--rps", type=float, default=0.0,
                    help="offered requests/sec (0 = auto-calibrate)")
    fl.add_argument("--deadline-ms", type=float, default=None)
    fl.add_argument("--max-batch", type=int, default=256)
    fl.add_argument("--queue-max", type=int, default=1024)
    fl.add_argument("--kill", action="store_true",
                    help="kill one replica mid-soak (the run must still "
                         "account every request)")
    fl.add_argument("--subprocess", action="store_true",
                    help="subprocess replicas (one OS process each)")
    fl.add_argument("--name", default="model", help="registry model name")
    fl.add_argument("--models", type=int, default=1,
                    help="register the saved model under N names with "
                         "placement on and drive an equal-weight model mix")
    fl.add_argument("--output", default=None,
                    help="directory for metrics.prom + fleet_summary.json")
    fl.add_argument("--seed", type=int, default=42)
    _device_arg(fl)
    so = sub.add_parser(
        "slo", help="load a saved model, drive open-loop load and report "
                    "SLO verdicts, budget burn and the scale-hint "
                    "timeline; exits non-zero when a page-severity "
                    "burn-rate alert fires")
    so.add_argument("--model", required=True,
                    help="saved model directory (OpWorkflowModel.save)")
    so.add_argument("--seconds", type=float, default=5.0,
                    help="total load duration")
    so.add_argument("--rps", type=float, default=0.0,
                    help="offered requests/sec (0 = auto-calibrate)")
    so.add_argument("--availability", type=float, default=None,
                    help="availability target (default "
                         "TG_SLO_AVAILABILITY or 0.999)")
    so.add_argument("--p99-ms", type=float, default=None,
                    help="latency objective: windowed p99 target in ms")
    so.add_argument("--window-s", type=float, default=None,
                    help="scaled SLO budget window in seconds (default "
                         "3600)")
    so.add_argument("--tenants", default=None,
                    help='weighted tenant mix, e.g. "a:3,b:1"')
    so.add_argument("--intervals", type=int, default=5,
                    help="timeline resolution (load slices)")
    so.add_argument("--deadline-ms", type=float, default=None)
    so.add_argument("--name", default="model", help="registry model name")
    so.add_argument("--output", default=None,
                    help="directory for slo_summary.json + metrics.prom")
    so.add_argument("--seed", type=int, default=42)
    _device_arg(so)
    cp = sub.add_parser(
        "campaign", help="run a seeded chaos campaign: randomized "
                         "multi-fault schedules against real scenario "
                         "harnesses, invariant oracles and schedule "
                         "minimization")
    cp.add_argument("--schedules", type=int, default=0,
                    help="schedule budget (0 = TG_CAMPAIGN_SCHEDULES or "
                         "40; coverage singletons for every covered site "
                         "come first)")
    cp.add_argument("--seed", type=int, default=None,
                    help="campaign seed (default TG_CAMPAIGN_SEED or 0)")
    cp.add_argument("--scenario", default=None,
                    help="restrict to one scenario (train | sweep | serve "
                         "| serve_heal | stream | fleet | density | net | "
                         "transfer); required in repro mode")
    cp.add_argument("--faults", default=None,
                    help="repro mode: a TG_FAULTS-style JSON schedule run "
                         "once against --scenario (also read from "
                         "TG_CHAOS=1 TG_FAULTS=...)")
    cp.add_argument("--output", default=None,
                    help="directory for campaign_report.json")
    cp.add_argument("--no-minimize", action="store_true",
                    help="skip the minimization of violating schedules")
    _device_arg(cp)
    pg = sub.add_parser(
        "programs", help="list/verify/gc an AOT program store (not "
                         "ported: exits non-zero)")
    pg.add_argument("path",
                    help="model directory (MANIFEST.json present) or a "
                         "program-store directory")
    pg.add_argument("--gc", action="store_true")
    pg.add_argument("--json", action="store_true")
    dr = sub.add_parser(
        "doctor", help="render a flight-recorder post-mortem bundle into "
                       "a human-readable incident report")
    dr.add_argument("bundle",
                    help="bundle file (postmortem_*.json) or a directory "
                         "of bundles (the newest one is rendered)")
    dr.add_argument("--json", action="store_true",
                    help="machine-readable output (bundle + validation "
                         "problems) instead of the rendered report")
    dr.add_argument("--tail", type=int, default=40,
                    help="ring events to show in the recent-timeline tail")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    a = build_parser().parse_args(argv)
    if a.command == "gen":
        generate(a.input, a.response, a.output, a.name, a.id_field,
                 schema=a.schema, answers=a.answers, device=a.device)
        print(f"generated project in {a.output}/ "
              f"(app.py, README.md, test_app.py)")
    elif a.command == "trace":
        run_trace(a.output, dataset=a.dataset, rows=a.rows, seed=a.seed,
                  device=a.device)
    elif a.command == "serve":
        run_serve(a.model, seconds=a.seconds, rps=a.rps,
                  deadline_ms=a.deadline_ms, max_batch=a.max_batch,
                  queue_max=a.queue_max, name=a.name, output=a.output,
                  seed=a.seed, listen=a.listen, device=a.device)
    elif a.command == "fleet":
        run_fleet(a.model, replicas=a.replicas, seconds=a.seconds,
                  rps=a.rps, deadline_ms=a.deadline_ms,
                  max_batch=a.max_batch, queue_max=a.queue_max,
                  kill=a.kill, use_subprocess=a.subprocess,
                  name=a.name, output=a.output, seed=a.seed,
                  models=a.models, device=a.device)
    elif a.command == "slo":
        run_slo(a.model, seconds=a.seconds, rps=a.rps,
                availability=a.availability, p99_ms=a.p99_ms,
                window_s=a.window_s, tenants=a.tenants,
                intervals=a.intervals, deadline_ms=a.deadline_ms,
                name=a.name, output=a.output, seed=a.seed, device=a.device)
    elif a.command == "campaign":
        run_campaign(schedules=a.schedules, seed=a.seed,
                     scenario=a.scenario, faults_json=a.faults,
                     output=a.output, no_minimize=a.no_minimize,
                     device=a.device)
    elif a.command == "programs":
        print(f"programs: {PROGRAMS_WAITS}", file=sys.stderr)
        raise SystemExit(2)
    elif a.command == "doctor":
        run_doctor(a.bundle, as_json=a.json, tail=a.tail)


if __name__ == "__main__":
    main()
