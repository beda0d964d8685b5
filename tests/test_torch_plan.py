"""The port's transform-plan compiler (``transmogrifai_tpu_torch/plan.py``)
against the JAX package's (``transmogrifai_tpu/plan.py``) and against its
own eager path, on the CPU.

- Structure: the same saved model (``fixtures/serve64/gbt``, and the
  port's Titanic model for host waves, loaded in both packages) over the
  same table gives the same plan in both packages: segments, host stages, each segment's stage uids,
  ``in_names`` and ``out_names``, and the schema fingerprint.
- Planned against eager, bit for bit (values and masks), on the example
  DAGs of ``tests/test_plan.py`` at its sizes (Titanic 240 rows, iris 150,
  boston 200, each with its linear selector), and a train under the
  planner against an eager train (winner, kept slots, fold metrics,
  scores).
- Against the JAX package's planned scores of the same saved models
  (``PROB_ATOL`` 1e-5, the serve limit between the packages).
- Reuse and accounting: one plan for the micro-batch scorer at 1, 37, 256
  and 300 rows with its buckets counted; planned dispatches at least 5
  times fewer than eager on Titanic; no counter written with metrics off;
  the spans and a cached compile; ``to_device``'s packed uploads; the LRU
  bound with its evictions in the compile ledger; a cache entry keeps its
  stages alive.
- Robustness: ``TG_CHAOS`` or an armed site outside the planner's prefixes
  turns planning off; ``plan.segment_execute`` falls back once, recorded,
  to identical output; ``oom.plan`` halves the rows bit-equal and falls
  back below the minimum bucket; ``plan_cache_violations`` is clean after
  every test (the autouse fixture).
- Warm start and costs: ``warm_runtime`` warms a plan, the port's
  fingerprint equals the JAX package's ``planFingerprint``, and a save
  after a warm pass writes ``costs`` that ``Placer`` reads without a blind
  admit.

On the CPU a segment runs its duals at the padded bucket, and the eager
Prediction emission predicts at the same bucket, so planned and eager are
bit-equal for every family. The card's graphs are in
``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import gc
import os
import shutil
import sys
import weakref

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (REPO, os.path.dirname(os.path.abspath(__file__))):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import transmogrifai_tpu.models.linear  # noqa: E402,F401  (registers)
import transmogrifai_tpu.models.trees  # noqa: E402,F401
from transmogrifai_tpu import plan as jplan  # noqa: E402
from transmogrifai_tpu.persistence import (  # noqa: E402
    load_model as jax_load_model,
)
from transmogrifai_tpu.readers.readers import (  # noqa: E402
    dataframe_to_table as jax_frame_to_table,
)
from transmogrifai_tpu.serving.warmup import (  # noqa: E402
    serve_plan_fingerprint as jax_serve_fingerprint,
)

import transmogrifai_tpu_torch as port  # noqa: E402
from transmogrifai_tpu_torch import plan  # noqa: E402
from transmogrifai_tpu_torch.examples import (  # noqa: E402
    boston as port_boston, iris as port_iris, titanic as port_titanic,
)
from transmogrifai_tpu_torch.features import (  # noqa: E402
    reset_uids as port_reset,
)
from transmogrifai_tpu_torch.impl.preparators.sanity_checker import (  # noqa: E402
    SanityChecker,
)
from transmogrifai_tpu_torch.local.scoring import (  # noqa: E402
    micro_batch_score_function,
)
from transmogrifai_tpu_torch.observability import ledger  # noqa: E402
from transmogrifai_tpu_torch.observability import metrics as om  # noqa: E402
from transmogrifai_tpu_torch.observability import trace as ot  # noqa: E402
from transmogrifai_tpu_torch.robustness import faults, oracles  # noqa: E402
from transmogrifai_tpu_torch.robustness.policy import FaultLog  # noqa: E402
from transmogrifai_tpu_torch.table import Column, FeatureTable  # noqa: E402
from transmogrifai_tpu_torch.testing import (  # noqa: E402
    close_serving_state, request_rows, score_frame,
)
from transmogrifai_tpu_torch.types import OPVector, Real, Text  # noqa: E402

from test_plan import _boston_df, _iris_df, _titanic_df  # noqa: E402

pytestmark = pytest.mark.plan

SERVE64 = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures",
                       "serve64")
#: a probability, the port against the JAX package (the serve limit)
PROB_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_planner():
    """Every test starts and ends with an empty plan cache and no forced
    switch; the planner's oracle holds after each."""
    plan.clear_plan_cache()
    plan.enable_planning(None)
    yield
    violations = oracles.plan_cache_violations()
    plan.clear_plan_cache()
    plan.enable_planning(None)
    assert violations == []


def _columns(df):
    return {c: df[c].to_numpy() for c in df.columns}


def _port_workflow(kind, seed=42):
    port_reset()
    if kind == "titanic":
        label, vec = port_titanic.titanic_features()
        checked = label.transform_with(SanityChecker(seed=seed), vec)
        pred = label.transform_with(
            port.BinaryClassificationModelSelector.with_cross_validation(
                seed=seed, models=[("OpLogisticRegression", None)]),
            checked)
        results = (pred, checked)
    elif kind == "iris":
        label, vec = port_iris.iris_features()
        pred = label.transform_with(
            port.MultiClassificationModelSelector.with_cross_validation(
                seed=seed, models=[("OpLogisticRegression", None)]), vec)
        results = (pred,)
    else:
        label, vec = port_boston.boston_features()
        pred = label.transform_with(
            port.RegressionModelSelector.with_train_validation_split(
                seed=seed, models=[("OpLinearRegression", None)]), vec)
        results = (pred,)
    return port.OpWorkflow(device="cpu").set_result_features(*results)


FRAMES = {"titanic": _titanic_df, "iris": _iris_df, "boston": _boston_df}


@pytest.fixture(scope="module")
def trained():
    """The three example DAGs trained by the port on ``tests/test_plan.py``'s
    frames."""
    out = {}
    for kind, frame in FRAMES.items():
        df = frame()
        model = _port_workflow(kind).set_input_dataset(_columns(df)).train()
        out[kind] = (model, df)
    return out


def _host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_tables_bit_equal(eager, planned, names=None):
    names = names or eager.column_names
    assert sorted(names) == sorted(
        n for n in planned.column_names if n in names)
    for nm in names:
        a, b = _host(eager[nm].values), _host(planned[nm].values)
        if a.dtype == object:
            assert all((x is None and y is None) or x == y
                       for x, y in zip(a, b)), nm
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), nm
        ma, mb = eager[nm].mask, planned[nm].mask
        assert (ma is None) == (mb is None), nm
        if ma is not None:
            assert np.array_equal(_host(ma), _host(mb)), nm


def _score_both_ways(model, table):
    planned = model.score(table=table)
    assert plan.cache_stats()["entries"] >= 1
    plan.enable_planning(False)
    try:
        eager = model.score(table=table)
    finally:
        plan.enable_planning(None)
    return eager, planned


# ---------------------------------------------------------------------------
# The plan's structure, against the JAX package's
# ---------------------------------------------------------------------------

def _jax_table(jm, df):
    """The JAX package's raw table of the model's predictors."""
    return jax_frame_to_table(
        df, [f for f in jm.raw_features if not f.is_response])


def _plan_shape(p):
    return (p.num_segments, p.num_host_stages,
            [(kind, [s.uid for s in pl] if kind == "host" else
              ([s.uid for s in pl.stages], pl.in_names, pl.out_names))
             for kind, pl in p.steps])


def _titanic_jax_and_port(trained, tmp_path):
    """The port's Titanic model saved (the JAX package's format) and loaded
    in both packages with their workflows (the lambdas; the same uids
    after each package's ``reset_uids``)."""
    from test_plan import _build_titanic
    from transmogrifai_tpu.features import reset_uids as jax_reset
    model, df = trained["titanic"]
    path = str(tmp_path / "titanic")
    model.save(path)
    jax_reset()
    jwf, _ = _build_titanic(df)
    jm = jax_load_model(path, workflow=jwf)
    pm = port.load_model(path, device="cpu",
                         workflow=_port_workflow("titanic"))
    return jm, pm, df


@pytest.mark.parametrize("case", ["gbt", "titanic"])
def test_plan_steps_and_fingerprint_equal_the_jax_plan(case, trained,
                                                       tmp_path):
    if case == "gbt":
        path = os.path.join(SERVE64, "gbt")
        jm, pm = jax_load_model(path), port.load_model(path, device="cpu")
        import pandas as pd
        frame = score_frame(300)
        jt = _jax_table(jm, pd.DataFrame(frame))
        pt = pm.raw_table(frame)
    else:
        jm, pm, df = _titanic_jax_and_port(trained, tmp_path)
        jt = jax_frame_to_table(df, jm.raw_features)
        pt = pm.raw_table(_columns(df))
    pt = pt.to_device("cpu")
    results = [f.name for f in pm.result_features]
    assert results == [f.name for f in jm.result_features]
    for keep, extra, min_dev in ((False, results, 1), (True, (), 2)):
        jp = jplan.get_plan(jm.stages, jt, keep_intermediates=keep,
                            extra_keep=extra, min_device_stages=min_dev)
        pp = plan.get_plan(pm.stages, pt, keep_intermediates=keep,
                           extra_keep=extra, min_device_stages=min_dev)
        assert jp is not None and pp is not None
        assert _plan_shape(pp) == _plan_shape(jp)
        assert plan.schema_fingerprint(pm.stages, pt) == \
            jplan.schema_fingerprint(jm.stages, jt)
    if case == "titanic":
        assert pp.num_host_stages > 0 and pp.num_segments >= 2
    jplan.clear_plan_cache()


# ---------------------------------------------------------------------------
# Planned against eager, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(FRAMES))
def test_planned_equals_eager_bit_exact(trained, kind):
    model, df = trained[kind]
    table = model.raw_table(_columns(df))
    eager, planned = _score_both_ways(model, table)
    _assert_tables_bit_equal(eager, planned)
    p = plan.get_plan(model.stages, table.to_device("cpu"),
                      min_device_stages=2)
    assert p is not None and p.num_segments >= 1


def test_train_under_the_planner_equals_the_eager_train():
    df = _titanic_df(n=180, seed=3)
    planned = _port_workflow("titanic", seed=4).set_input_dataset(
        _columns(df)).train()
    assert plan.cache_stats()["entries"] >= 1, "the train never planned"
    plan.enable_planning(False)
    try:
        eager = _port_workflow("titanic", seed=4).set_input_dataset(
            _columns(df)).train()
        table = eager.raw_table(_columns(df))
        se, sp = eager.score(table=table), planned.score(table=table)
    finally:
        plan.enable_planning(None)
    for fe, fp in zip(eager.result_features, planned.result_features):
        assert np.array_equal(_host(se[fe.name].values),
                              _host(sp[fp.name].values)), fe.name

    def stage(m, name):
        return next(s for s in m.stages if type(s).__name__ == name)
    assert stage(eager, "SanityCheckerModel").keep_indices == \
        stage(planned, "SanityCheckerModel").keep_indices
    se_, sp_ = (stage(m, "SelectedModel").summary for m in (eager, planned))
    assert se_.best_model_type == sp_.best_model_type
    assert se_.best_hyper == sp_.best_hyper
    for re_, rp_ in zip(se_.validation_results, sp_.validation_results):
        assert np.array_equal(_host(re_.mean_metrics),
                              _host(rp_.mean_metrics))
    assert se_.holdout_evaluation == sp_.holdout_evaluation


# ---------------------------------------------------------------------------
# Against the JAX package's planned scores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["gbt", "rf", "lr"])
def test_planned_scores_agree_with_the_jax_planned_scores(key):
    import pandas as pd
    path = os.path.join(SERVE64, key)
    jm, pm = jax_load_model(path), port.load_model(path, device="cpu")
    frame = score_frame(300)
    jt = _jax_table(jm, pd.DataFrame(frame))
    want = jm.score(table=jt)
    assert jplan.cache_stats()["entries"] >= 1
    got = pm.score(data=frame)
    name = pm.result_features[0].name
    keys = list(got[name].metadata["keys"])
    assert keys == list(want[name].metadata["keys"])
    g, w = _host(got[name].values), np.asarray(want[name].values)
    for i, k in enumerate(keys):
        if k.startswith("probability"):
            np.testing.assert_allclose(g[:, i], w[:, i], rtol=0,
                                       atol=PROB_ATOL, err_msg=k)
    jplan.clear_plan_cache()


# ---------------------------------------------------------------------------
# Reuse and accounting
# ---------------------------------------------------------------------------

def _dispatch_total():
    return sum(om.registry().snapshot().get("tg_dispatch_total",
                                             {}).values())


def test_micro_batch_scorer_reuses_one_plan_across_buckets():
    model = port.load_model(os.path.join(SERVE64, "rf"), device="cpu")
    rows = request_rows(score_frame(300))
    mb = micro_batch_score_function(model)
    got = {n: mb(rows[:n]) for n in (1, 37, 256, 300)}
    assert plan.cache_stats()["entries"] == 1
    (p, _), = plan._PLAN_CACHE.values()
    assert [len(s.stages) for s in p.segments] == [2, 1]
    assert all(s.seen_buckets == {256, 512} for s in p.segments)
    plan.enable_planning(False)
    try:
        for n, recs in got.items():
            assert recs == mb(rows[:n]), n
    finally:
        plan.enable_planning(None)


def test_titanic_dispatches_five_times_fewer_planned(trained):
    model, df = trained["titanic"]
    table = model.raw_table(_columns(df))
    om.enable_metrics(True)
    try:
        plan.enable_planning(False)
        model.score(table=table)
        plan.enable_planning(None)
        eager_n = _dispatch_total()
        om.reset()
        om.enable_metrics(True)
        model.score(table=table)
        planned_n = _dispatch_total()
        snap = om.registry().snapshot()["tg_dispatch_total"]
    finally:
        om.enable_metrics(None)
        om.reset()
    assert eager_n >= 10 and planned_n <= 3, (eager_n, planned_n)
    assert eager_n >= 5 * planned_n
    assert set(snap) <= {"kind=plan_segment", "kind=stage"}


def test_no_counter_written_with_metrics_off(trained):
    model, df = trained["titanic"]
    om.reset()
    assert not om.metrics_enabled()
    model.score(table=model.raw_table(_columns(df)))
    assert om.registry().snapshot() == {}


def test_spans_emitted_and_the_compile_cached(trained):
    model, df = trained["titanic"]
    table = model.raw_table(_columns(df))
    ot.enable_tracing(True)
    try:
        model.score(table=table)
        model.score(table=table)
        names = [s.name for s in ot.tracer().finished()]
    finally:
        ot.enable_tracing(None)
        ot.reset()
        om.reset()          # tracing implies metrics
    assert names.count("plan.compile") == 1
    assert names.count("plan.execute") == 2
    assert "plan.segment" in names


def test_to_device_packs_transfers():
    rng = np.random.RandomState(0)
    n = 64
    cols = {f"r{i}": Column(Real, rng.randn(n).astype(np.float32),
                            (rng.rand(n) < 0.9) if i % 2 == 0 else None)
            for i in range(10)}
    cols["vec"] = Column(OPVector, rng.randn(n, 5).astype(np.float32))
    txt = np.empty(n, dtype=object)
    txt[:] = "hello"
    cols["t"] = Column(Text, txt)
    om.enable_metrics(True)
    try:
        dev = FeatureTable(cols, n).to_device("cpu")
        snap = om.registry().snapshot()
    finally:
        om.enable_metrics(None)
        om.reset()
    # eleven device columns of one dtype and their masks: two uploads
    assert sum(snap["tg_device_transfer_total"].values()) == 2
    for name, col in cols.items():
        if name == "t":
            assert dev[name].values is col.values
            continue
        assert isinstance(dev[name].values, torch.Tensor)
        assert np.array_equal(dev[name].values.numpy(), col.values)
        assert (dev[name].mask is None) == (col.mask is None)


def test_lru_stays_bounded_and_records_evictions(trained, monkeypatch):
    model, df = trained["titanic"]
    table = model.raw_table(_columns(df)).to_device("cpu")
    monkeypatch.setattr(plan, "_PLAN_CACHE_MAX", 2)
    ledger.reset()
    try:
        for k in range(4):
            plan.get_plan(model.stages, table, keep_intermediates=False,
                          extra_keep=(f"x{k}",))
        assert len(plan._PLAN_CACHE) == 2
        assert len(ledger.ledger()._evicted) == 2
        mark = ledger.ledger().mark()
        plan.get_plan(model.stages, table, keep_intermediates=False,
                      extra_keep=("x0",))
        assert [r.cause for r in ledger.ledger().since(mark)] == [
            "cache-eviction"]
        assert len(plan._PLAN_CACHE) == 2
    finally:
        ledger.reset()


def test_a_cache_entry_keeps_its_stages_alive():
    model = port.load_model(os.path.join(SERVE64, "rf"), device="cpu")
    table = model.raw_table(score_frame(40)).to_device("cpu")
    stages = list(model.stages)
    refs = [weakref.ref(s) for s in stages]
    p = plan.get_plan(stages, table)
    assert p is not None
    del model, stages, p
    gc.collect()
    assert all(r() is not None for r in refs)
    plan.clear_plan_cache()
    gc.collect()
    assert all(r() is None for r in refs)


# ---------------------------------------------------------------------------
# Robustness
# ---------------------------------------------------------------------------

def test_chaos_and_armed_sites_turn_planning_off(monkeypatch):
    assert plan.planning_applicable()
    with faults.injected({"dag.stage_fit": {"mode": "raise"}}):
        assert not plan.planning_applicable()
    for site in ("plan.segment_execute", "oom.plan", "serve.flush"):
        with faults.injected({site: {"mode": ALL_MODES[site]}}):
            assert plan.planning_applicable(), site
    plan.enable_planning(False)
    assert not plan.planning_applicable()
    plan.enable_planning(None)
    monkeypatch.setenv(faults.CHAOS_ENV, "1")
    assert not plan.planning_applicable()


ALL_MODES = {s: faults.ALL_SITES[s].modes[0] for s in faults.ALL_SITES}


def test_a_fault_in_a_segment_falls_back_once_to_identical_output(trained):
    model, df = trained["titanic"]
    table = model.raw_table(_columns(df))
    plan.enable_planning(False)
    expected = model.score(table=table)
    plan.enable_planning(None)
    log = FaultLog()
    om.enable_metrics(True)
    try:
        with faults.injected({"plan.segment_execute": {
                "mode": "raise", "transient": True, "nth": 1, "count": 1}}):
            with log.activate():
                out = model.score(table=table)
        snap = om.registry().snapshot()
    finally:
        om.enable_metrics(None)
        om.reset()
    fallbacks = log.of_kind("plan_fallback")
    assert len(fallbacks) == 1
    assert "TransientFaultError" in fallbacks[0].detail["error"]
    assert snap["tg_faults_total"].get("kind=plan_fallback") == 1.0
    assert log.to_json()["planFallbacks"]
    _assert_tables_bit_equal(expected, out)


def test_oom_halves_the_rows_bit_equal_and_falls_back_below_the_bucket():
    model = port.load_model(os.path.join(SERVE64, "rf"), device="cpu")
    mb = micro_batch_score_function(model)
    rows = request_rows(score_frame(600))
    clean = mb(rows)
    log = FaultLog()
    with faults.injected({"oom.plan": {"mode": "oom", "nth": 1,
                                       "count": 1}}):
        with log.activate():
            halved = mb(rows)
    assert halved == clean
    down = log.of_kind("oom_downshift")
    assert len(down) == 1 and down[0].detail["splitRows"] == [300, 300]
    assert not log.of_kind("plan_fallback")
    # at the minimum bucket a halving cannot help: the run falls back
    log = FaultLog()
    with faults.injected({"oom.plan": {"mode": "oom", "nth": 1,
                                       "count": 1}}):
        with log.activate():
            small = mb(rows[:200])
    assert small == clean[:200]
    assert not log.of_kind("oom_downshift")
    assert len(log.of_kind("plan_fallback")) == 1


# ---------------------------------------------------------------------------
# Warm start and costs
# ---------------------------------------------------------------------------

def test_warm_start_fingerprint_costs_and_placement(tmp_path):
    from transmogrifai_tpu_torch.serving import ModelRegistry, ServeConfig
    from transmogrifai_tpu_torch.serving.placement import (
        PlaceConfig, Placer, model_cost_bytes,
    )
    from transmogrifai_tpu_torch.serving.warmup import (
        serve_plan_fingerprint,
    )
    from transmogrifai_tpu_torch.observability import devicemem
    src = os.path.join(SERVE64, "gbt")
    path = str(tmp_path / "gbt")
    shutil.copytree(src, path)
    pm = port.load_model(path, device="cpu")
    assert serve_plan_fingerprint(pm) == jax_serve_fingerprint(
        jax_load_model(src))
    devicemem.reset()
    try:
        with ModelRegistry(ServeConfig(max_batch=64)) as reg:
            rt = reg.load("gbt", path, device="cpu")
            info = rt.warm_info
        assert info["ok"] and info["plansWarmed"] > 0, info
        assert info["fingerprintMatch"] is True
        saved = str(tmp_path / "saved")
        pm.save(saved)
        assert model_cost_bytes(saved) and model_cost_bytes(saved) > 0
        with Placer({"gbt": saved},
                    PlaceConfig(device_budget=1 << 40)) as placer:
            assert placer.bytes["gbt"] == model_cost_bytes(saved)
            assert "gbt" not in placer.blind
            assert not placer.fault_log.of_kind("placement_blind_admit")
    finally:
        devicemem.reset()
        close_serving_state()
