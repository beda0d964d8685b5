"""Saving what the port trains, in the JAX package's format, against the
JAX package on the CPU.

Both packages train the same tiny workflows (gbt, rf, lr, xgbmc, mlp on
the serve bench's frame at 400 x 5, and the Titanic workflow at 240 rows)
from the same uids. The port's save of its model:

* reloads in the port and scores bit for bit as the model it saved;
* loads in the JAX package (the Titanic model with the JAX workflow as
  ``workflow=``) and scores within the serve limits of
  ``test_torch_serve.py`` (the two packages' scores of one model);
* has the JAX package's plan: the same stages, class names, modules and
  state keys, and the same layout of every state value (descriptor kinds,
  class names, array dtypes and ranks), except the keys named in
  ``JAX_ONLY_STATE``.

A JAX-saved model the port loads and saves again loads in the JAX package
and scores bit for bit as the original. The cases of
``tests/test_persistence.py`` and ``tests/test_preemption.py`` run at
their inputs, and a save killed at each of its renames leaves the
previous model loadable, with ``*.tmp`` debris only.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: F401,E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
for p in (REPO, TESTS):
    if p not in sys.path:
        sys.path.insert(0, p)

from test_torch_serve import (  # noqa: E402
    FIXTURE_DIR, _assert_parts_agree, jax_table, prediction_parts,
    save_jax_model, score_frame, train_jax_model,
)
from test_torch_titanic_e2e import (  # noqa: E402
    PINNED_MODELS, _columns, _jax_workflow, _port_workflow, _titanic_df,
    assert_scores_agree,
)
from transmogrifai_tpu.features import reset_uids as jax_reset  # noqa: E402
from transmogrifai_tpu.persistence import (  # noqa: E402
    load_model as jax_load_model,
)

import transmogrifai_tpu_torch as port  # noqa: E402
from transmogrifai_tpu_torch import persistence as P  # noqa: E402
from transmogrifai_tpu_torch.features import (  # noqa: E402
    FeatureBuilder, reset_uids as port_reset,
)
from transmogrifai_tpu_torch.manifest import (  # noqa: E402
    CheckpointManifest, clean_tmp_debris,
)
from transmogrifai_tpu_torch.testing import (  # noqa: E402
    serve_bench_data, serve_bench_workflow,
)

#: tiny trains of both packages: {key: (family, hyperparameters, problem)}
TINY = {
    "gbt": ("OpGBTClassifier",
            {"maxDepth": 3, "maxIter": 5, "stepSize": 0.1,
             "minInstancesPerNode": 5, "minInfoGain": 0.001}, "binary"),
    "rf": ("OpRandomForestClassifier",
           {"maxDepth": 12, "numTrees": 4, "minInstancesPerNode": 5,
            "minInfoGain": 0.001, "subsamplingRate": 1.0}, "binary"),
    "lr": ("OpLogisticRegression",
           {"regParam": 0.01, "elasticNetParam": 0.5}, "binary"),
    "xgbmc": ("OpXGBoostClassifier",
              {"maxDepth": 3, "maxIter": 5, "stepSize": 0.3,
               "minChildWeight": 1.0, "lambda": 1.0, "minInfoGain": 0.0,
               "minInstancesPerNode": 0.0}, "multiclass"),
    "mlp": ("OpMultilayerPerceptronClassifier",
            {"hiddenLayer1": 8, "hiddenLayer2": 8, "stepSize": 0.05},
            "binary"),
}
KEYS = list(TINY) + ["titanic"]
TINY_N, TINY_D, TINY_SEED = 400, 5, 3

#: state the JAX package saves and the port's stages do not carry:
#: {class name: keys}. ``_stats_input_sharding`` records where a JAX mesh
#: placed the SanityChecker's statistics pass (a JAX placement; the port
#: has no mesh)
JAX_ONLY_STATE = {"SanityCheckerModel": {"_stats_input_sharding"}}


def _port_tiny(key):
    family, hyper, task = TINY[key]
    port_reset()
    wf = serve_bench_workflow(family, hyper, TINY_D, TINY_SEED,
                              device="cpu", problem=task)
    return wf, wf.set_input_dataset(serve_bench_data(
        TINY_N, TINY_D, TINY_SEED, task)).train()


def _jax_tiny(key):
    family, hyper, task = TINY[key]
    jax_reset()
    return train_jax_model(family, hyper, TINY_N, TINY_D, TINY_SEED,
                           task=task)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """{key: dict(pm, jm, pwf, jwf, port_dir, jax_dir, data)}: both
    packages' models and saves."""
    out = {}
    for key in KEYS:
        root = tmp_path_factory.mktemp(key)
        if key == "titanic":
            df = _titanic_df()
            jwf, _, _ = _jax_workflow(PINNED_MODELS)
            jm = jwf.set_input_dataset(df).train()
            pwf, _, _ = _port_workflow(PINNED_MODELS)
            pm = pwf.set_input_dataset(_columns(df)).train()
            data = df
        else:
            jwf, jm = None, _jax_tiny(key)
            pwf, pm = _port_tiny(key)
            data = score_frame(300, TINY_D, seed=4, nan_rate=0.05)
        port.save_model(pm, str(root / "port"))
        save_jax_model(jm, str(root / "jax"))
        out[key] = dict(pm=pm, jm=jm, pwf=pwf, jwf=jwf, data=data,
                        port_dir=str(root / "port"),
                        jax_dir=str(root / "jax"))
    return out


def _port_scores(model, data):
    data = _columns(data) if isinstance(data, pd.DataFrame) else data
    return prediction_parts(model.score(data=data), model)


def _jax_scores(model, data):
    scored = (model.score(df=data) if isinstance(data, pd.DataFrame)
              else model.score(table=jax_table(data)))
    return prediction_parts(scored, model)


@pytest.mark.parametrize("key", KEYS)
def test_port_save_reloads_and_scores_bit_for_bit(trained, key):
    t = trained[key]
    assert sorted(os.listdir(t["port_dir"])) == [
        "MANIFEST.json", "arrays.npz", "plan.json"]
    loaded = port.load_model(t["port_dir"], device="cpu",
                             workflow=t["pwf"])
    assert [type(s).__name__ for s in loaded.stages] == [
        type(s).__name__ for s in t["pm"].stages]
    want = _port_scores(t["pm"], t["data"])
    got = _port_scores(loaded, t["data"])
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].view(np.int32),
                                      want[k].view(np.int32), err_msg=k)


@pytest.mark.parametrize("key", KEYS)
def test_the_jax_package_loads_the_port_save(trained, key):
    t = trained[key]
    if key == "titanic":
        with pytest.raises(ValueError, match="unserializable state"):
            jax_load_model(t["port_dir"])
    jm = jax_load_model(t["port_dir"], workflow=t["jwf"])
    got = _jax_scores(jm, t["data"])
    want = _port_scores(t["pm"], t["data"])
    if key == "titanic":
        assert_scores_agree(got, want)
    else:
        _assert_parts_agree({k: got[k] for k in want}, want)


def _layout(d, arrays):
    """A saved descriptor's layout: its kinds, keys, class names, array
    dtypes and ranks, and list lengths; scalars by type only, a missing
    number (None) as a number: a constant column's label correlation is
    None where its float32 variance is 0 and a number where XLA leaves
    2.7e-15 (``testing.assert_same_sanity``), a value and not a layout."""
    if isinstance(d, list):
        return [_layout(x, arrays) for x in d]
    if isinstance(d, dict):
        if "__array__" in d:
            a = arrays[d["__array__"]]
            return f"array {a.dtype} rank {a.ndim}"
        if "__float__" in d:
            return "float"
        if "__unresolved__" in d:
            return "unresolved"
        return {k: (v if k in ("__obj__", "__family__", "__feature_type__")
                    else _layout(v, arrays)) for k, v in d.items()}
    return "number" if d is None or isinstance(d, (int, float)) and not \
        isinstance(d, bool) else type(d).__name__


@pytest.mark.parametrize("key", KEYS)
def test_the_plan_is_the_jax_packages(trained, key):
    t = trained[key]
    pplan, parr = P._read(t["port_dir"])
    jplan, jarr = P._read(t["jax_dir"])
    assert sorted(pplan) == sorted(jplan)
    assert pplan["formatVersion"] == jplan["formatVersion"]
    assert sorted(pplan["versionInfo"]) == sorted(jplan["versionInfo"])
    for k in ("resultFeatures", "rawFeatures", "blacklistedFeatures"):
        assert pplan[k] == jplan[k], k
    assert pplan["features"] == jplan["features"]
    for section in ("stages", "rawFeatureGenerators"):
        assert [(d["module"], d["className"], d["uid"])
                for d in pplan[section]] == [
            (d["module"], d["className"], d["uid"])
            for d in jplan[section]], section
        for pd_, jd in zip(pplan[section], jplan[section]):
            only = JAX_ONLY_STATE.get(jd["className"], set())
            assert set(pd_["state"]) == set(jd["state"]) - only, (
                jd["className"], set(pd_["state"]) ^ set(jd["state"]))
            for k in pd_["state"]:
                assert _layout(pd_["state"][k], parr) == _layout(
                    jd["state"][k], jarr), (jd["className"], k)


TRIPS = ["tiny_gbt", "serve64_mlp", "serve64_xgbmc", "titanic"]


@pytest.mark.parametrize("case", TRIPS)
def test_jax_save_port_load_port_save_jax_load(trained, case, tmp_path):
    """A JAX-saved model the port loads and saves again loads in the JAX
    package and scores as the original, bit for bit."""
    wf = jwf = None
    if case == "tiny_gbt":
        src, data = trained["gbt"]["jax_dir"], trained["gbt"]["data"]
    elif case == "titanic":
        t = trained["titanic"]
        src, data, wf, jwf = t["jax_dir"], t["data"], t["pwf"], t["jwf"]
    else:
        src = os.path.join(FIXTURE_DIR, case.split("_")[1])
        data = score_frame(300, 64, seed=5, nan_rate=0.05)
    pm = port.load_model(src, device="cpu", workflow=wf)
    port.save_model(pm, str(tmp_path / "again"))
    want = _jax_scores(jax_load_model(src, workflow=jwf), data)
    got = _jax_scores(jax_load_model(str(tmp_path / "again"),
                                     workflow=jwf), data)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # and the port's own reload of its save scores as its first load
    again = port.load_model(str(tmp_path / "again"), device="cpu",
                            workflow=wf)
    a, b = _port_scores(pm, data), _port_scores(again, data)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("key", ["gbt", "lr", "xgbmc", "mlp", "mlpmc",
                                 "titanic"])
def test_summary_sections_are_the_jax_packages(key):
    path = (os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures",
                         "titanic", "model") if key == "titanic"
            else os.path.join(FIXTURE_DIR, key))
    wf = jwf = None
    if key == "titanic":
        wf, _, _ = _port_workflow(None)
        jwf, _, _ = _jax_workflow(None)
    pm = port.load_model(path, device="cpu", workflow=wf)
    jm = jax_load_model(path, workflow=jwf)
    want = {k: v for k, v in json.loads(jm.summary_json()).items()
            if k in {s.uid for s in jm.stages}}
    assert want and json.loads(pm.summary_json()) == want
    assert sorted(pm.summary()) == sorted(want)


def test_summaries_of_a_port_train(trained):
    """A port train sets each summary's JSON as the JAX package does."""
    for key in ("gbt", "titanic"):
        pm, jm = trained[key]["pm"], trained[key]["jm"]
        got = json.loads(pm.summary_json())
        want = {k: v for k, v in json.loads(jm.summary_json()).items()
                if k in got}
        assert sorted(got) == sorted(want)
        for uid, sec in got.items():
            assert sorted(sec) == sorted(want[uid]), uid
        sel = pm.stages[-1]
        assert sel.summary_metadata == sel.summary.to_json()
        assert got[sel.uid]["bestModelType"] == want[sel.uid][
            "bestModelType"]


# -- the cases of tests/test_persistence.py and tests/test_preemption.py ---

def _make_df(n=240, seed=7):
    """``tests/test_persistence.py``'s frame."""
    rng = np.random.RandomState(seed)
    x1 = rng.randn(n)
    x2 = rng.randn(n)
    color = rng.choice(["red", "green", "blue"], size=n)
    y = ((x1 + (color == "red") * 1.5 + 0.3 * rng.randn(n)) > 0).astype(
        float)
    x1[rng.rand(n) < 0.1] = np.nan
    return {"x1": x1, "x2": x2, "color": color.astype(object), "y": y}


def _build_workflow(data):
    from transmogrifai_tpu_torch.impl.preparators.sanity_checker import (
        SanityChecker,
    )
    port_reset()
    y = FeatureBuilder.RealNN("y").extract_field().as_response()
    x1 = FeatureBuilder.Real("x1").extract_field().as_predictor()
    x2 = FeatureBuilder.Real("x2").extract_field().as_predictor()
    color = FeatureBuilder.PickList("color").extract_field().as_predictor()
    vec = port.transmogrify([x1, x2, color])
    checked = SanityChecker().set_input(y, vec).get_output()
    pred = (port.BinaryClassificationModelSelector
            .with_train_validation_split(
                seed=1, models=[("OpLogisticRegression", None)])
            .set_input(y, checked).get_output())
    wf = (port.OpWorkflow(device="cpu").set_input_dataset(data)
          .set_result_features(pred))
    return wf, y, pred


def test_save_load_round_trip(tmp_path):
    data = _make_df()
    wf, _, pred = _build_workflow(data)
    model = wf.train()
    before = model.score(data=data)[pred.name].values
    path = str(tmp_path / "model")
    model.save(path)
    loaded = port.OpWorkflowModel.load(path, device="cpu")
    assert [f.name for f in loaded.result_features] == [
        f.name for f in model.result_features]
    after = loaded.score(data=data)[pred.name].values
    assert torch.equal(before, after)
    sel = loaded.get_stage(pred.origin_stage.uid)
    assert sel.summary.best_model_type == "OpLogisticRegression"


def test_load_resolves_lambdas_from_workflow(tmp_path):
    data = _make_df()
    port_reset()
    y = FeatureBuilder.RealNN("y").extract(lambda r: r["y"]).as_response()
    x1 = FeatureBuilder.Real("x1").extract(
        lambda r: r.get("x1")).as_predictor()
    vec = port.transmogrify([x1])
    pred = (port.BinaryClassificationModelSelector
            .with_train_validation_split(
                seed=1, models=[("OpLogisticRegression", None)])
            .set_input(y, vec).get_output())
    wf = (port.OpWorkflow(device="cpu").set_input_dataset(data)
          .set_result_features(pred))
    model = wf.train()
    path = str(tmp_path / "model")
    model.save(path)
    plan = json.load(open(os.path.join(path, "plan.json")))
    extract = [d["state"]["extract_fn"] for d in plan["rawFeatureGenerators"]]
    assert all("__unresolved__" in e for e in extract)
    with pytest.raises(ValueError, match="unserializable state"):
        port.OpWorkflowModel.load(path, device="cpu")
    loaded = port.OpWorkflowModel.load(path, device="cpu", workflow=wf)
    assert callable(loaded.raw_features[0].origin_stage.extract_fn)
    assert torch.equal(model.score(data=data)[pred.name].values,
                       loaded.score(data=data)[pred.name].values)


def test_local_scoring_parity(tmp_path):
    data = _make_df()
    wf, _, pred = _build_workflow(data)
    model = wf.train()
    path = str(tmp_path / "model")
    model.save(path)
    loaded = port.load_model(path, device="cpu")
    scored = loaded.score(data=data)
    batch = scored[pred.name].values.numpy()
    pi = scored[pred.name].metadata["keys"].index("prediction")
    rows = pd.DataFrame(data).to_dict("records")
    score_row = loaded.score_function()
    for i in (0, 5, 17, 100):
        assert score_row(rows[i])[pred.name]["prediction"] == \
            pytest.approx(float(batch[i, pi]), abs=1e-5)
    outs = port.micro_batch_score_function(loaded)(rows[:16])
    for i, rec in enumerate(outs):
        assert rec[pred.name]["prediction"] == pytest.approx(
            float(batch[i, pi]), abs=1e-5)


def test_fresh_process_load(tmp_path):
    """A process that imported nothing but the package loads and scores
    the save (no jax, pandas or JAX package module)."""
    data = _make_df()
    wf, _, pred = _build_workflow(data)
    model = wf.train()
    path = str(tmp_path / "model")
    model.save(path)
    frame = str(tmp_path / "data.npz")
    np.savez(frame, **{k: np.asarray(v) for k, v in data.items()})
    want = model.score(data=data)[pred.name].values.numpy()
    np.save(str(tmp_path / "want.npy"), want)
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from transmogrifai_tpu_torch.workflow import OpWorkflowModel\n"
        f"m = OpWorkflowModel.load({path!r}, device='cpu')\n"
        f"d = dict(np.load({frame!r}, allow_pickle=True))\n"
        "s = m.score(data=d)\n"
        f"got = s[{pred.name!r}].values.numpy()\n"
        f"assert (got == np.load({str(tmp_path / 'want.npy')!r})).all()\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'pandas', 'transmogrifai_tpu')]\n"
        "assert not bad, bad\n"
        "print('FRESH_LOAD_OK')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert "FRESH_LOAD_OK" in out.stdout, out.stderr[-2000:]


def _preemption_model():
    """``tests/test_preemption.py``'s small model: two predictors, the
    LR and SVC grid, 3-fold CV, 250 rows."""
    rng = np.random.RandomState(7)
    x1, x2 = rng.randn(250), rng.randn(250)
    data = {"x1": x1, "x2": x2, "y": ((x1 + 0.5 * x2) > 0).astype(float)}
    port_reset()
    label = FeatureBuilder.RealNN("y").extract_field().as_response()
    f1 = FeatureBuilder.Real("x1").extract_field().as_predictor()
    f2 = FeatureBuilder.Real("x2").extract_field().as_predictor()
    checked = port.transmogrify([f1, f2]).sanity_check(label)
    models = [("OpLogisticRegression",
               [{"regParam": 0.01, "elasticNetParam": 0.0},
                {"regParam": 0.1, "elasticNetParam": 0.0}]),
              ("OpLinearSVC", [{"regParam": 0.01}])]
    pred = (port.BinaryClassificationModelSelector.with_cross_validation(
        models=models).set_input(label, checked).get_output())
    model = (port.OpWorkflow(device="cpu").set_input_dataset(data)
             .set_result_features(pred).train())
    return model, pred, data


def test_save_model_atomic_with_manifest(tmp_path):
    model, pred, data = _preemption_model()
    path = str(tmp_path / "model")
    model.save(path)
    assert os.path.isfile(os.path.join(path, "MANIFEST.json"))
    assert not [f for f in os.listdir(path) if f.endswith(".tmp")]
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    m, err = CheckpointManifest.load(path, 1)
    assert err is None
    assert m.verify_file("plan.json") is None
    assert m.verify_file("arrays.npz") is None
    loaded = port.OpWorkflowModel.load(path, device="cpu")
    assert torch.equal(model.score(data=data)[pred.name].values,
                       loaded.score(data=data)[pred.name].values)


@pytest.mark.parametrize("victim", ["arrays.npz", "plan.json"])
def test_load_model_corruption_raises_descriptive(tmp_path, victim):
    model, _, _ = _preemption_model()
    path = str(tmp_path / "model")
    model.save(path)
    target = os.path.join(path, victim)
    data = open(target, "rb").read()
    with open(target, "wb") as fh:
        fh.write(data[: len(data) // 2])
    with pytest.raises(P.CorruptModelError) as ei:
        port.OpWorkflowModel.load(path, device="cpu")
    assert victim in str(ei.value)
    assert ei.value.path.endswith(victim)
    assert "mismatch" in ei.value.reason


class _Killed(BaseException):
    """Stands for the process dying at a rename."""


@pytest.mark.parametrize("exchange", [True, False])
def test_a_save_killed_at_any_rename_leaves_the_previous_model(
        trained, tmp_path, monkeypatch, exchange):
    """Save the gbt model, then the lr model over it, killed at each
    rename of the second save in turn (the staged files' renames, the
    directory exchange, or where the file system cannot exchange, each of
    the two directory renames): the directory then loads as one whole
    model, the previous one until the swap, and holds no ``*.tmp``;
    beside it only ``*.tmp`` debris is left, which ``clean_tmp_debris``
    removes."""
    first, second = trained["gbt"]["pm"], trained["lr"]["pm"]
    data = trained["gbt"]["data"]
    want_first = _port_scores(first, data)
    want_second = _port_scores(second, data)
    real_replace, real_exchange = os.replace, P._exchange
    if not exchange:
        monkeypatch.setattr(P, "_exchange", lambda a, b: False)
    k = 0
    while True:
        k += 1
        root = tmp_path / f"kill{k}"
        root.mkdir()
        path = str(root / "model")
        port.save_model(first, path)
        calls = [0]

        def count(fn):
            def wrapped(*a):
                calls[0] += 1
                if calls[0] == k:
                    raise _Killed()
                return fn(*a)
            return wrapped
        monkeypatch.setattr(os, "replace", count(real_replace))
        if exchange:
            monkeypatch.setattr(P, "_exchange", count(real_exchange))
        try:
            port.save_model(second, path)
            killed = False
        except _Killed:
            killed = True
        finally:
            monkeypatch.setattr(os, "replace", real_replace)
            if exchange:
                monkeypatch.setattr(P, "_exchange", real_exchange)
        if not killed:
            break
        if os.path.isdir(path):
            assert not [f for f in os.listdir(path) if f.endswith(".tmp")]
            got = _port_scores(port.load_model(path, device="cpu"), data)
            assert any(all(np.array_equal(got[c], w[c]) for c in w)
                       for w in (want_first, want_second)), k
        else:
            # between the two directory renames: the previous model is
            # whole in the moved-aside directory
            assert not exchange
            old = [f for f in os.listdir(root) if f.endswith(".old.tmp")]
            got = _port_scores(port.load_model(
                str(root / old[0]), device="cpu"), data)
            assert all(np.array_equal(got[c], want_first[c])
                       for c in want_first)
        assert all(f == "model" or f.endswith(".tmp")
                   for f in os.listdir(root))
        clean_tmp_debris(str(root))
        assert [f for f in os.listdir(root) if f != "model"] == []
    assert k > (3 if exchange else 4)
    got = _port_scores(port.load_model(path, device="cpu"), data)
    for c in want_second:
        np.testing.assert_array_equal(got[c], want_second[c])


def test_a_save_keeps_other_files_and_the_class_table_is_one_to_one(
        trained, tmp_path):
    path = tmp_path / "model"
    path.mkdir()
    (path / "notes.txt").write_text("kept")
    port.save_model(trained["lr"]["pm"], str(path))
    assert (path / "notes.txt").read_text() == "kept"
    assert len(P.SAVED_NAMES) == len(P.CLASSES)


def test_a_class_without_a_saved_name_raises_at_save(trained, tmp_path):
    class Unknown:
        pass
    model = port.load_model(trained["gbt"]["port_dir"], device="cpu")
    model.stages[0].note = Unknown()
    with pytest.raises(ValueError, match="Unknown has no counterpart"):
        port.save_model(model, str(tmp_path / "bad"))
    assert not os.path.exists(str(tmp_path / "bad"))
