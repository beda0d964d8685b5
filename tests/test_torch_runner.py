"""The port's workflow runner, ``OpParams``, ``OpApp``, testkit, contract
specs and the Iris and Boston examples against the JAX package's, on the
CPU (``tests/test_runner_testkit.py``'s frame and seeded synthetic Iris
and Boston files; the reference's files are not in the repository).

Every run type runs in both packages from the same definitions; the
written outputs are compared: the Avro records decoded (every field
equal but the prediction, whose probabilities are within ``PROB_ATOL``:
the LR's dot product adds in another order), the CSV text line for line
(the features run's byte for byte; a score file's prediction cell, a
dict's text, within ``PROB_ATOL`` after reading it back), the metrics
JSON within ``PROB_ATOL``. The port's ``summary`` lacks the JAX package's
``faults``, ``resume`` and ``observability`` sections (not ported); the
port writes the ``features`` run by extension where the JAX package
writes Parquet. Testkit draws are equal.
"""
from __future__ import annotations

import ast
import csv
import json
import math
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pandas as pd
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import transmogrifai_tpu  # noqa: E402,F401
from transmogrifai_tpu import runner as jrun  # noqa: E402
from transmogrifai_tpu import testkit as jkit  # noqa: E402
from transmogrifai_tpu.evaluators import (  # noqa: E402
    OpBinaryClassificationEvaluator as JEval,
)
from transmogrifai_tpu.features import (  # noqa: E402
    FeatureBuilder as JFB, reset_uids as jax_reset,
)
from transmogrifai_tpu.impl.feature.transmogrifier import (  # noqa: E402
    transmogrify as jtr,
)
from transmogrifai_tpu.impl.selector.factories import (  # noqa: E402
    BinaryClassificationModelSelector as JSel,
)
from transmogrifai_tpu.readers.readers import (  # noqa: E402
    DataFrameReader, DataReaders as JReaders,
)
from transmogrifai_tpu.workflow import OpWorkflow as JWF  # noqa: E402

from transmogrifai_tpu_torch import runner as prun  # noqa: E402
from transmogrifai_tpu_torch import testkit as pkit  # noqa: E402
from transmogrifai_tpu_torch.evaluators.binary import (  # noqa: E402
    OpBinaryClassificationEvaluator as PEval,
)
from transmogrifai_tpu_torch.features import (  # noqa: E402
    FeatureBuilder as PFB, reset_uids as port_reset,
)
from transmogrifai_tpu_torch.impl.feature.transmogrifier import (  # noqa: E402
    transmogrify as ptr,
)
from transmogrifai_tpu_torch.impl.selector.factories import (  # noqa: E402
    BinaryClassificationModelSelector as PSel,
)
from transmogrifai_tpu_torch.readers.readers import (  # noqa: E402
    DataReaders as PReaders, FrameReader,
)
from transmogrifai_tpu_torch.workflow import OpWorkflow as PWF  # noqa: E402

PROB_ATOL = 1e-5


def _data(n=300, seed=3):
    rng = np.random.RandomState(seed)
    x1, x2 = rng.randn(n), rng.randn(n)
    y = ((x1 - 0.5 * x2 + 0.4 * rng.randn(n)) > 0).astype(float)
    x2 = np.where(rng.rand(n) < 0.1, np.nan, x2)
    return {"id": [f"r{i:03d}" for i in range(n)], "x1": x1, "x2": x2,
            "y": y}


def _wf(reset, FB, tr, Sel, wf):
    reset()
    y = FB.RealNN("y").extract_field().as_response()
    x1 = FB.Real("x1").extract_field().as_predictor()
    x2 = FB.Real("x2").extract_field().as_predictor()
    pred = (Sel.with_train_validation_split(
        seed=1, models=[("OpLogisticRegression", None)])
        .set_input(y, tr([x1, x2])).get_output())
    return wf.set_result_features(pred), y, pred


def _runners(**kw):
    data = _data()
    df = pd.DataFrame(data)
    jwf, jy, jpred = _wf(jax_reset, JFB, jtr, JSel, JWF())
    pwf, py, ppred = _wf(port_reset, PFB, ptr, PSel, PWF(device="cpu"))
    jr = jrun.OpWorkflowRunner(
        jwf, train_reader=DataFrameReader(df, key_field="id"),
        evaluator=JEval(), label_feature=jy, prediction_feature=jpred,
        **{k: v[0] for k, v in kw.items()})
    pr = prun.OpWorkflowRunner(
        pwf, train_reader=FrameReader(data, key_field="id"),
        evaluator=PEval(), label_feature=py, prediction_feature=ppred,
        **{k: v[1] for k, v in kw.items()})
    return jr, pr, jpred, data


def _close_dict(a, b):
    """Two predictions (dicts, or their text as a written file holds
    them) within PROB_ATOL."""
    if isinstance(a, str):
        a, b = ast.literal_eval(a), ast.literal_eval(b)
    assert set(a) == set(b)
    for k in a:
        assert abs(a[k] - b[k]) <= PROB_ATOL, (k, a[k], b[k])


def _same_records(got, want, pred_name):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if k == pred_name:
                _close_dict(g[k], w[k])
            elif isinstance(w[k], float) and math.isnan(w[k]):
                assert isinstance(g[k], float) and math.isnan(g[k])
            else:
                assert g[k] == w[k] and type(g[k]) is type(w[k]), k


def _metrics_close(got, want):
    if isinstance(want, dict):
        for k in want:
            if k in ("faults", "resume", "observability"):
                continue
            _metrics_close(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _metrics_close(a, b)
    elif isinstance(want, float):
        assert abs(got - want) <= PROB_ATOL or (math.isnan(got)
                                                and math.isnan(want))
    elif isinstance(want, str) and want.startswith("[") and got != want:
        # a float32 array's text in the JAX summary
        np.testing.assert_allclose(np.array(ast.literal_eval(got)),
                                   np.array(ast.literal_eval(want)),
                                   atol=PROB_ATOL)
    else:
        assert got == want


def test_every_run_type_and_app_match_jax(tmp_path):
    """train (model and metrics), score (.avro and .csv), evaluate,
    streamingScore, features (.csv) and OpApp in both packages."""
    data = _data()
    df = pd.DataFrame(data)
    batches = [{k: v[:120] for k, v in data.items()},
               {k: v[120:200] for k, v in data.items()}]
    jr, pr, jpred, _ = _runners(streaming_score_reader=(
        JReaders.Streaming.batches([pd.DataFrame(b) for b in batches],
                                   key_field="id"),
        PReaders.Streaming.batches(batches, key_field="id")))
    out = {}
    for name, mod, runner in (("jax", jrun, jr), ("port", prun, pr)):
        d = tmp_path / name
        m = mod.OpParams(model_location=str(d / "model"),
                         metrics_location=str(d / "train.json"))
        res = runner.run("train", m)
        assert res.model is not None and os.path.isfile(d / "model" /
                                                        "plan.json")
        runner.run("score", mod.OpParams(model_location=str(d / "model"),
                                         write_location=str(d / "s.avro")))
        runner.run("score", mod.OpParams(model_location=str(d / "model"),
                                         write_location=str(d / "s.csv")))
        ev = runner.run("evaluate", mod.OpParams(
            model_location=str(d / "model"),
            metrics_location=str(d / "eval.json")))
        st = runner.run("streamingScore", mod.OpParams(
            model_location=str(d / "model"),
            write_location=str(d / "stream.avro")))
        assert st.score_batches == 2
        feats = runner.run("features", mod.OpParams())
        if name == "jax":
            jrun.table_to_dataframe(feats.scores).to_csv(
                str(d / "raw.csv"), index=False)
        else:
            runner.run("features", mod.OpParams(
                write_location=str(d / "raw.csv")))
        app = mod.OpApp(runner).main([
            "--run-type", "score", "--model-location", str(d / "model"),
            "--write-location", str(d / "app.avro")])
        out[name] = (ev, app)
    from transmogrifai_tpu.utils.avro import read_avro
    j, p = tmp_path / "jax", tmp_path / "port"
    for f in ("s.avro", "stream.avro", "app.avro"):
        _same_records(list(read_avro(str(p / f))),
                      list(read_avro(str(j / f))), jpred.name)
    with open(j / "raw.csv") as a, open(p / "raw.csv") as b:
        assert b.read() == a.read()
    with open(j / "s.csv", newline="") as a, open(p / "s.csv",
                                                   newline="") as b:
        ja, pa = list(csv.reader(a)), list(csv.reader(b))
    assert pa[0] == ja[0]
    col = ja[0].index(jpred.name)
    for jrow, prow in zip(ja[1:], pa[1:]):
        assert prow[:col] + prow[col + 1:] == jrow[:col] + jrow[col + 1:]
        _close_dict(prow[col], jrow[col])
    for f in ("train.json", "eval.json"):
        with open(j / f) as a, open(p / f) as b:
            _metrics_close(json.load(b), json.load(a))
    assert out["port"][0].metrics["evaluation"]["AuROC"] > 0.8


def test_score_table_records_match_jax():
    """``table_to_records`` of a scored table is the JAX package's
    ``table_to_dataframe(...).to_dict("records")``."""
    jr, pr, jpred, data = _runners()
    js = jr.run("score", jrun.OpParams()).scores
    ps = pr.run("score", prun.OpParams()).scores
    _same_records(prun.table_to_records(ps),
                  jrun.table_to_dataframe(js).to_dict("records"), jpred.name)


def test_params_json_both_ways(tmp_path):
    p = prun.OpParams(stage_params={"ModelSelector": {"problem": "binary"}},
                      reader_params={"path": "x"}, model_location="m",
                      write_location="w.avro", metrics_location="q.json",
                      custom_params={"a": 1})
    j = jrun.OpParams.from_json(p.to_json())
    assert j.to_json() == p.to_json()
    path = tmp_path / "params.json"
    path.write_text(json.dumps(j.to_json()))
    assert prun.OpParams.from_file(str(path)).to_json() == j.to_json()


def test_stage_params_reach_the_stage():
    jr, pr, jpred, data = _runners()
    res = pr.run("train", prun.OpParams(
        stage_params={"ModelSelector": {"problem": "binary"}}))
    assert res.model.parameters == {
        "stageParams": {"ModelSelector": {"problem": "binary"}}}
    with pytest.raises(ValueError, match="has no param"):
        pr.run("train", prun.OpParams(
            stage_params={"ModelSelector": {"nope": 1}}))


def test_runner_refusals():
    jr, pr, jpred, data = _runners()
    with pytest.raises(ValueError, match="unknown run type"):
        pr.run("fit")
    with pytest.raises(ValueError, match="Parquet"):
        pr.run("features", prun.OpParams(write_location="x.parquet"))
    with pytest.raises(ValueError, match="streaming_score_reader"):
        pr.run("streamingScore")
    with pytest.raises(SystemExit):
        prun.OpApp(pr).main(["--run-type", "nope"])


# ---------------------------------------------------------------------------
# testkit and specs
# ---------------------------------------------------------------------------

GENS = [
    lambda k: k.RandomReal.normal(seed=7).with_probability_of_empty(0.2),
    lambda k: k.RandomReal.lognormal(seed=2),
    lambda k: k.RandomReal.poisson(3.0, seed=2),
    lambda k: k.RandomIntegral.integers(5, 10, seed=7),
    lambda k: k.RandomIntegral.dates(seed=3),
    lambda k: k.RandomBinary(0.9, seed=8),
    lambda k: k.RandomText.emails(seed=3),
    lambda k: k.RandomText.names(seed=3),
    lambda k: k.RandomText.ids(seed=3),
    lambda k: k.RandomText.base64(seed=3),
    lambda k: k.RandomText.phones(seed=3),
    lambda k: k.RandomList(k.RandomText.strings(words=1, seed=2), 1, 3,
                           seed=2),
    lambda k: k.RandomMap(k.RandomReal.normal(seed=4), ["x", "y", "z"],
                          seed=4),
    lambda k: k.RandomMultiPickList(["p", "q", "r"], seed=5),
    lambda k: k.RandomVector(4, seed=6),
    lambda k: k.RandomGeolocation(seed=1),
    lambda k: k.RandomCurrency(seed=1),
    lambda k: k.RandomDateList(seed=1),
    lambda k: k.RandomStream.random_between(0, 5, seed=3).map(
        lambda v: v * 2),
    lambda k: k.RandomStream.random_longs(0, 9, seed=3).zip(
        k.RandomBinary(seed=1)),
]


@pytest.mark.parametrize("i", range(len(GENS)))
def test_testkit_draws_equal_jax(i):
    assert GENS[i](pkit).take(40) == GENS[i](jkit).take(40)


def test_testkit_every_type_and_tables_equal_jax():
    from transmogrifai_tpu.types import FEATURE_TYPES as JT
    from transmogrifai_tpu_torch.testing import table_digest
    from transmogrifai_tpu_torch.types import FEATURE_TYPES as PT
    for name in sorted(PT):
        assert pkit.generator_of(name, seed=7).take(6) == \
            jkit.generator_of(name, seed=7).take(6), name
    assert sorted(PT) == sorted(JT)
    spec = {"r": "Real", "b": "Binary", "d": "Date", "i": "Integral",
            "v": "OPVector", "t": "Text", "m": "RealMap",
            "g": ("Real", None)}
    jspec = {k: (JT[v[0]], v[1]) if isinstance(v, tuple) else v
             for k, v in spec.items()}
    pspec = {k: (PT[v[0]], v[1]) if isinstance(v, tuple) else v
             for k, v in spec.items()}
    jt = jkit.random_table(jspec, 64, seed=5)
    pt = pkit.random_table(pspec, 64, seed=5)
    names = list(spec)
    dj, dp = table_digest(jt, names), table_digest(pt, names)
    assert dp == dj
    s = pkit.InfiniteStream.of(lambda i: i * i)
    assert s.map(lambda v: v + 1).take(3) == [1, 2, 5] and s.take(2) == [0, 1]


from transmogrifai_tpu_torch.test.specs import (  # noqa: E402
    OpEstimatorSpec, OpTransformerSpec,
)


class TestScalerSpec(OpTransformerSpec):
    @classmethod
    def build(cls):
        from transmogrifai_tpu_torch.impl.feature.scalers import (
            ScalerTransformer,
        )
        from transmogrifai_tpu_torch.table import FeatureTable
        from transmogrifai_tpu_torch.types import Real
        f = PFB.Real("x").extract_field().as_predictor()
        stage = ScalerTransformer("linear", 2.0, 1.0).set_input(f)
        table = FeatureTable.from_columns({"x": (Real, [1.0, None, 2.5])})
        return stage, table, [3.0, None, 6.0]


class TestFillMeanSpec(OpEstimatorSpec):
    @classmethod
    def build(cls):
        from transmogrifai_tpu_torch.impl.feature.scalers import (
            FillMissingWithMean,
        )
        from transmogrifai_tpu_torch.table import FeatureTable
        from transmogrifai_tpu_torch.types import Real
        f = PFB.Real("x").extract_field().as_predictor()
        stage = FillMissingWithMean().set_input(f)
        table = FeatureTable.from_columns({"x": (Real, [1.0, None, 3.0])})
        return stage, table, [1.0, 2.0, 3.0]


# ---------------------------------------------------------------------------
# Iris and Boston on synthetic files
# ---------------------------------------------------------------------------

def _iris_file(path, n=150, seed=0):
    rng = np.random.RandomState(seed)
    classes = ["Iris-setosa", "Iris-versicolor", "Iris-virginica"]
    with open(path, "w") as fh:
        for i in range(n):
            c = i % 3
            vals = rng.randn(4) * 0.4 + np.array([5.0, 3.4, 1.5, 0.2]) \
                + c * np.array([0.9, -0.6, 2.5, 1.0])
            fh.write(",".join(f"{v:.1f}" for v in vals) + f",{classes[c]}\n")
        fh.write("\n")
    return path


def _boston_file(path, n=160, seed=0):
    rng = np.random.RandomState(seed)
    with open(path, "w") as fh:
        for _ in range(n):
            x = rng.rand(13)
            x[3] = float(rng.rand() < 0.1)
            medv = 20 + 10 * x[5] - 8 * x[12] + rng.randn()
            fh.write(" " + "  ".join(f"{v:.4f}" for v in x)
                     + f"  {medv:.1f}\n")
    return path


def test_iris_example_matches_jax(tmp_path):
    from transmogrifai_tpu.examples import iris as ji
    from transmogrifai_tpu.impl.selector.factories import (
        MultiClassificationModelSelector as JM,
    )
    from transmogrifai_tpu_torch.examples import iris as pi
    path = _iris_file(str(tmp_path / "iris.data"))
    models = [("OpLogisticRegression", [{"regParam": 0.01}]),
              ("OpDecisionTreeClassifier", [{"maxDepth": 3}])]
    jax_reset()
    label, vec = ji.iris_features()
    pred = (JM.with_cross_validation(seed=11, models=models)
            .set_input(label, vec).get_output())
    df = pd.read_csv(path, header=None, names=ji.IRIS_SCHEMA).dropna()
    jm = JWF().set_input_dataset(df).set_result_features(pred).train()
    port_reset()
    wf, plabel, ppred = pi.build_workflow(path, seed=11, models=models,
                                          device="cpu")
    pm = wf.train()
    js = jm.get_stage(pred.origin_stage.uid).summary
    ps = pm.get_stage(ppred.origin_stage.uid).summary
    assert ps.best_model_type == js.best_model_type
    assert abs(ps.best_metric_value - js.best_metric_value) <= PROB_ATOL
    scored = pm.score(table=wf.reader.generate_table(pm.raw_features))
    parts = scored[ppred.name].values.cpu().numpy()
    keys = list(scored[ppred.name].metadata["keys"])
    acc = (parts[:, keys.index("prediction")] ==
           scored["irisClass"].host_values()).mean()
    assert acc > 0.9


def test_boston_example_matches_jax(tmp_path):
    from transmogrifai_tpu.examples import boston as jbos
    from transmogrifai_tpu.impl.selector.factories import (
        RegressionModelSelector as JR,
    )
    from transmogrifai_tpu_torch.examples import boston as pbos
    path = _boston_file(str(tmp_path / "housing.data"))
    models = [("OpLinearRegression",
               [{"regParam": 0.01, "elasticNetParam": 0.5}])]
    jax_reset()
    label, vec = jbos.boston_features()
    pred = (JR.with_train_validation_split(seed=11, models=models)
            .set_input(label, vec).get_output())
    df = pd.read_csv(path, header=None, names=jbos.BOSTON_SCHEMA,
                     sep=r"\s+")
    jm = JWF().set_input_dataset(df).set_result_features(pred).train()
    port_reset()
    wf, plabel, ppred = pbos.build_workflow(path, seed=11, models=models,
                                            device="cpu")
    pm = wf.train()
    js = jm.get_stage(pred.origin_stage.uid).summary
    ps = pm.get_stage(ppred.origin_stage.uid).summary
    assert ps.best_model_type == js.best_model_type
    assert abs(ps.best_metric_value - js.best_metric_value) <= \
        1e-4 * max(1.0, abs(js.best_metric_value))
    assert ps.best_metric_value < 3.0
