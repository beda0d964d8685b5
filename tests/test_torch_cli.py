"""The port's command line (``transmogrifai_tpu_torch/cli.py``) against
the JAX package's (``transmogrifai_tpu/cli.py``), on the CPU at small
sizes.

- ``gen``: ``infer_schema`` equal on ``tests/test_cli.py``'s frame and
  its variants (regression, integer-coded, strings, bools, blanks); the
  generated app's feature lines, selector, reader expression and label
  remap equal to the JAX package's for the same input and answers (CSV,
  and Avro with an ``.avsc``); the answers' refusals; one generated app
  trained in a subprocess on the CPU (``gen --device cpu``,
  ``TG_FAST_GRIDS=1``, one thread), then scored by its own runner: its
  model saved, its scores Parquet.
- ``trace``: the same span names as the JAX package's trace on the same
  seed (``tests/test_observability.py``'s case), the four files.
- ``serve`` (also over ``--listen``), ``fleet`` (with ``--kill``) and
  ``slo`` (``tests/test_slo.py``'s case) for about a second over
  ``serve64/rf``: nothing lost or failed, a sample of the served records
  bit-equal to the micro-batch scorer's, and each summary with the JAX
  package's sections and keys (its own runs on copies of the same
  model) plus the port's ``device``.
- ``doctor`` on a bundle of each package: the port renders the JAX
  package's bundle as the JAX package does, line for line.
- ``programs`` exits non-zero naming ROADMAP Queue 1 item 10; with no
  ``--device`` a subcommand needs the card; the CLI, the reader, the
  runner and ``utils.parquet`` load neither pandas, pyarrow nor JAX.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stdout

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pandas as pd
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import transmogrifai_tpu  # noqa: E402,F401
from transmogrifai_tpu import cli as jcli  # noqa: E402

from transmogrifai_tpu_torch import cli as pcli  # noqa: E402
from transmogrifai_tpu_torch.readers.readers import read_csv  # noqa: E402
from transmogrifai_tpu_torch.testing import (  # noqa: E402
    close_serving_state, served_gaps, served_sample,
)

SERVE64 = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures",
                       "serve64")


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    monkeypatch.setenv("TG_POSTMORTEM_DIR", str(tmp_path / "postmortems"))
    yield
    leaks = close_serving_state()
    assert not leaks, f"the test leaked serving state: {leaks}"


@pytest.fixture()
def rf_dir(tmp_path):
    d = str(tmp_path / "rf")
    shutil.copytree(os.path.join(SERVE64, "rf"), d)
    return d


def _frame(n=150, seed=4):
    """``tests/test_cli.py``'s frame."""
    rng = np.random.RandomState(seed)
    x1 = rng.randn(n)
    return pd.DataFrame({
        "id": range(n),
        "x1": x1,
        "count": rng.randint(0, 10, n),
        "color": rng.choice(["red", "green", "blue"], n),
        "note": [f"free text {i} {rng.rand():.6f}" for i in range(n)],
        "y": (x1 > 0).astype(float),
    })


def _variants():
    df = _frame()
    rng = np.random.RandomState(0)
    blank = df.assign(x1=np.where(rng.rand(len(df)) < 0.2, np.nan, df.x1),
                      color=np.where(rng.rand(len(df)) < 0.2, None,
                                     df.color))
    return {
        "binary": (df, "y", "id"),
        "regression": (df.assign(y=rng.randn(len(df))), "y", None),
        "integer_coded": (df.assign(y=rng.randint(100, 999, len(df))), "y",
                          None),
        "labels_12": (df.assign(y=(df.y + 1).astype(int)), "y", "id"),
        "strings": (df.assign(y=rng.choice(["a", "b", "c"], len(df))), "y",
                    "id"),
        "bools": (df.assign(flag=df.x1 > 0.3), "y", "id"),
        "blanks": (blank, "y", "id"),
    }


@pytest.mark.parametrize("case", sorted(_variants()))
def test_infer_schema_and_generated_lines_match_jax(case, tmp_path):
    df, response, id_field = _variants()[case]
    path = str(tmp_path / "data.csv")
    df.to_csv(path, index=False)
    assert pcli.infer_schema(read_csv(path), response, id_field) == \
        jcli.infer_schema(pd.read_csv(path), response, id_field)
    jfiles = jcli.generate(path, response, str(tmp_path / "j"), "MyApp",
                           id_field=id_field)
    pfiles = pcli.generate(path, response, str(tmp_path / "p"), "MyApp",
                           id_field=id_field)
    assert set(pfiles) == set(jfiles) == {"app.py", "README.md",
                                          "test_app.py"}
    _same_app_lines(pfiles["app.py"], jfiles["app.py"])


def _app_lines(app: str):
    """The generated app's definitions: feature lines, selector, reader
    and the label's remap."""
    keep = ("FeatureBuilder.", "RESPONSE_LABELS", "lambda r:", "    if str",
            "prediction = (", "train_reader=", "DATA_PATH =")
    return [ln for ln in app.splitlines()
            if ln.lstrip().startswith(keep) or any(k in ln for k in keep)
            if "import" not in ln]


def _same_app_lines(p_app: str, j_app: str):
    compile(p_app, "app.py", "exec")
    assert _app_lines(p_app) == _app_lines(j_app)
    assert "import pandas" not in p_app and "transmogrifai_tpu." not in p_app
    assert "--write-location ./scores.parquet" in p_app


def test_generated_app_from_avro_with_schema_and_answers(tmp_path):
    from transmogrifai_tpu.utils.avro import write_avro
    df = _frame(60)
    recs = [dict(id=int(r.id), x1=float(r.x1), count=int(r["count"]),
                 color=str(r.color), note=str(r.note), y=float(r.y))
            for _, r in df.iterrows()]
    avro = str(tmp_path / "d.avro")
    write_avro(avro, recs)
    avsc = tmp_path / "d.avsc"
    avsc.write_text(json.dumps({"type": "record", "name": "D", "fields": [
        {"name": "id", "type": "long"}, {"name": "x1", "type": "double"},
        {"name": "count", "type": ["null", "int"]},
        {"name": "color", "type": {"type": "enum", "name": "C",
                                   "symbols": ["red", "green", "blue"]}},
        {"name": "note", "type": "string"}, {"name": "y", "type": "double"}]}))
    answers = tmp_path / "answers.txt"
    answers.write_text("problem=binary\nrole.note=drop\n"
                       "type.count=PickList\nrole.id=id\n")
    kw = dict(id_field="id", schema=str(avsc), answers=str(answers))
    j = jcli.generate(avro, "y", str(tmp_path / "j"), "A", **kw)
    p = pcli.generate(avro, "y", str(tmp_path / "p"), "A", **kw)
    _same_app_lines(p["app.py"], j["app.py"])
    assert "DataReaders.Simple.avro(DATA_PATH)" in p["app.py"]


@pytest.mark.parametrize("text", [
    "problem=ranking\n", "type.nope=Real\n", "type.x1=NotAType\n",
    "role.y=drop\n", "color\n", "role.x1=maybe\n", "what=1\n"])
def test_answers_refusals_match_jax(text, tmp_path):
    path = str(tmp_path / "data.csv")
    _frame(40).to_csv(path, index=False)
    answers = tmp_path / "a.txt"
    answers.write_text(text)
    msgs = []
    for mod in (jcli, pcli):
        with pytest.raises(SystemExit) as e:
            mod.generate(path, "y", str(tmp_path / "o"), "A",
                         id_field="id", answers=str(answers))
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


def test_generated_app_trains_and_scores_on_the_cpu(tmp_path, monkeypatch):
    """``gen --device cpu``, then the app's train run in a subprocess
    (``TG_FAST_GRIDS=1``): a saved model; its score run (the app's own
    runner, in this process): Parquet scores."""
    df = _frame(80)
    path = str(tmp_path / "data.csv")
    df.to_csv(path, index=False)
    out = str(tmp_path / "proj")
    with redirect_stdout(io.StringIO()):
        pcli.main(["gen", "--input", path, "--response", "y", "--output",
                   out, "--id-field", "id", "--device", "cpu"])
    # one thread: the tests run beside other pytest workers
    env = dict(os.environ, PYTHONPATH=REPO, TG_FAST_GRIDS="1",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "app.py", "--run-type", "train",
                        "--model-location", str(tmp_path / "model")],
                       cwd=out, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert os.path.exists(str(tmp_path / "model" / "plan.json"))
    import runpy
    from transmogrifai_tpu_torch.features import reset_uids
    from transmogrifai_tpu_torch.runner import OpApp
    monkeypatch.setenv("TG_FAST_GRIDS", "1")
    reset_uids()                   # the app's uids, as in its own process
    app = runpy.run_path(os.path.join(out, "app.py"), run_name="app")
    OpApp(app["runner"]).main([
        "--run-type", "score", "--model-location", str(tmp_path / "model"),
        "--write-location", str(tmp_path / "scores.parquet")])
    scores = pd.read_parquet(str(tmp_path / "scores.parquet"))
    assert len(scores) == len(df)
    pred = [c for c in scores.columns if "modelSelector" in c]
    assert pred and all(0.0 <= d["probability_1"] <= 1.0
                        for d in scores[pred[0]])


def _span_names(trace_dir):
    with open(os.path.join(trace_dir, "trace.json")) as fh:
        return {e["name"] for e in json.load(fh)["traceEvents"]
                if e.get("ph") == "X"}


#: spans of the transform-plan compiler (``plan.py``, both packages), and
#: the port's scoring span where the JAX package runs that plan alone
PLAN_SPANS = {"plan.compile", "plan.execute", "plan.segment"}
PORT_ONLY_SPANS = {"workflow.score"}


def test_trace_spans_match_jax(tmp_path):
    with redirect_stdout(io.StringIO()):
        jcli.main(["trace", "--output", str(tmp_path / "j"), "--rows",
                   "200"])
        pcli.main(["trace", "--output", str(tmp_path / "p"), "--rows",
                   "200", "--device", "cpu"])
    for f in ("trace.json", "spans.jsonl", "metrics.prom", "summary.json"):
        assert os.path.getsize(tmp_path / "p" / f) > 0, f
    got, want = _span_names(tmp_path / "p"), _span_names(tmp_path / "j")
    assert {"workflow.train", "score.micro_batch"} <= got
    assert PLAN_SPANS <= got
    assert got - PORT_ONLY_SPANS == want


def _load(summary):
    return summary["load"]


def _rf_model(rf_dir):
    from transmogrifai_tpu_torch.persistence import load_model
    return load_model(rf_dir, device="cpu")


def test_serve_and_listen_lose_nothing(rf_dir, tmp_path):
    with redirect_stdout(io.StringIO()), served_sample() as kept:
        s = pcli.run_serve(rf_dir, seconds=0.8, rps=200.0, device="cpu",
                           output=str(tmp_path / "out"))
    assert served_gaps(_rf_model(rf_dir), kept) == []
    with redirect_stdout(io.StringIO()):
        w = pcli.run_serve(rf_dir, seconds=0.8, rps=200.0, device="cpu",
                           listen="127.0.0.1:0")
    for summary in (s, w):
        load = _load(summary)
        assert load["lost"] == 0 and load["failed"] == 0
        assert load["completed"] > 0
    assert w["listen"].startswith("127.0.0.1:")
    for f in ("trace.json", "spans.jsonl", "metrics.prom",
              "serve_summary.json"):
        assert (tmp_path / "out" / f).exists(), f


def test_fleet_kill_loses_nothing_and_its_bundle_renders(rf_dir, tmp_path,
                                                         capsys,
                                                         monkeypatch):
    monkeypatch.setenv("TG_FLEET_MIN", "2")     # no retirement to 1
    with served_sample() as kept:
        s = pcli.run_fleet(rf_dir, replicas=2, seconds=1.0, rps=200.0,
                           kill=True, device="cpu")
    assert served_gaps(_rf_model(rf_dir), kept) == []
    load = _load(s)
    assert load["lost"] == 0 and load["failed"] == 0
    assert s["replicaStates"]["r0"] == "dead"
    assert s["fleet"]["sheds"]["no_replica"] == 0
    assert sum(v for r, v in s["routing"].items() if r != "r0") > 0
    capsys.readouterr()
    pcli.main(["doctor", str(tmp_path / "postmortems")])
    out = capsys.readouterr().out
    assert "replica_lost" in out and "doctor verdict: ok" in out
    assert "env     : torch" in out


def test_slo_reports_without_a_page(rf_dir, tmp_path, capsys):
    """``tests/test_slo.py``'s case on the port."""
    out = tmp_path / "out"
    with served_sample() as kept:
        summary = pcli.run_slo(rf_dir, seconds=1.2, rps=40.0, intervals=2,
                               availability=0.9, window_s=3600.0,
                               tenants="a:3,b:1", name="climodel",
                               output=str(out), device="cpu")
    assert served_gaps(_rf_model(rf_dir), kept) == []
    assert summary["alertsFired"]["page"] == 0
    assert len(summary["timeline"]) == 2
    assert all(t["scaleHint"] in ("up", "hold", "down")
               for t in summary["timeline"])
    assert summary["scaleHints"]["climodel"] in ("up", "hold", "down")
    assert (out / "slo_summary.json").exists()
    assert "tg_slo_budget_remaining" in (out / "metrics.prom").read_text()
    assert '"slice"' in capsys.readouterr().out


#: each subcommand's run, as ``mod.run_<kind>(model, **kw)``
SUMMARY_RUNS = {
    "serve": dict(seconds=0.5, rps=100.0),
    "slo": dict(seconds=0.6, rps=40.0, intervals=2, availability=0.9,
                window_s=3600.0, tenants="a:3,b:1"),
    "fleet": dict(replicas=2, seconds=0.6, rps=100.0, kill=True),
}


def _sections(summary):
    """A summary's keys, and each section's keys where it is a dict."""
    return {k: sorted(v) if isinstance(v, dict) else None
            for k, v in summary.items()}


@pytest.mark.parametrize("kind", sorted(SUMMARY_RUNS))
def test_summary_sections_match_jax(kind, rf_dir, tmp_path, monkeypatch):
    """The port's summary carries the JAX package's sections and each
    section's keys, on copies of the same saved model."""
    monkeypatch.setenv("TG_FLEET_MIN", "2")
    jdir = str(tmp_path / "jrf")
    shutil.copytree(rf_dir, jdir)
    with redirect_stdout(io.StringIO()):
        want = getattr(jcli, f"run_{kind}")(jdir, **SUMMARY_RUNS[kind])
        got = getattr(pcli, f"run_{kind}")(rf_dir, device="cpu",
                                           **SUMMARY_RUNS[kind])
    assert got["device"] == "cpu"
    got = {k: v for k, v in got.items() if k != "device"}
    assert _sections(got) == _sections(want)


def test_doctor_renders_a_jax_bundle_as_jax(tmp_path, monkeypatch, capsys):
    from transmogrifai_tpu.observability import blackbox as jbb
    from transmogrifai_tpu.observability import postmortem as jpm
    monkeypatch.setenv("TG_POSTMORTEM_DIR", str(tmp_path / "jb"))
    for i in range(3):
        jbb.record("serve.flush", model="dr", rows=i + 1)
    path = jpm.trigger("breaker_open", detail={"model": "dr"})
    assert path is not None
    capsys.readouterr()
    jcli.run_doctor(path)
    want = capsys.readouterr().out
    pcli.run_doctor(path)
    got = capsys.readouterr().out
    assert got == want and "doctor verdict: ok" in got
    doc = pcli.run_doctor(path, as_json=True)
    assert doc["problems"] == [] and doc["doc"]["trigger"]["kind"] == \
        "breaker_open"


def test_programs_refuses_naming_item_10(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        pcli.main(["programs", str(tmp_path)])
    assert e.value.code != 0
    assert "Queue 1 item 10" in capsys.readouterr().err


def test_without_device_a_subcommand_needs_the_card(tmp_path, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["trace", "--output", str(tmp_path / "t")],
                 ["serve", "--model", str(tmp_path / "m")]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pcli.main(argv)


def test_cli_reader_runner_and_parquet_load_no_pandas_pyarrow_or_jax(
        tmp_path):
    path = str(tmp_path / "data.csv")
    _frame(30).to_csv(path, index=False)
    code = (
        "import sys\n"
        "from transmogrifai_tpu_torch import cli, runner\n"
        "from transmogrifai_tpu_torch.readers import readers\n"
        "from transmogrifai_tpu_torch.utils import parquet\n"
        f"cli.main(['gen', '--input', {path!r}, '--response', 'y',\n"
        f"          '--output', {str(tmp_path / 'o')!r}])\n"
        "f = readers.read_csv(" + repr(path) + ")\n"
        f"runner.write_parquet({str(tmp_path / 'x.parquet')!r}, f)\n"
        f"parquet.read_parquet({str(tmp_path / 'x.parquet')!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'transmogrifai_tpu', 'pandas',\n"
        "              'pyarrow'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
