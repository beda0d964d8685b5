"""The PyTorch port's drift-aware serving against the JAX package
(``transmogrifai_tpu_torch/serving/drift.py``; the cases of
``tests/test_drift.py`` on the port's CPU path).

Both packages train the same tiny GBT workflow on the same 300 rows (3
predictors, depth 3, 5 rounds, a random linear label), so their training
tables hold the same values. Tolerances: a baseline's counts, nulls and
fills exact, its sketch centroids and masses within 1e-12 relative (both
run the SPDT sketch in float64 on the host); verdicts equal on the same
request stream, JS divergences within 1e-9. The refit hook trains on the
CPU; no test sleeps: a refit is waited on through an ``Event`` its hook
sets and the refit thread's join, and a verdict after a runtime has
drained (its fold runs after the flush's futures resolve).
"""
from __future__ import annotations

import json
import os
import sys
import threading

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import jax  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import transmogrifai_tpu.models.trees  # noqa: E402,F401  (registers families)
import transmogrifai_tpu_torch as port  # noqa: E402
from transmogrifai_tpu_torch.filters.distribution import (  # noqa: E402
    fill_numeric_bins, js_divergence, numeric_distribution,
    text_distribution,
)
from transmogrifai_tpu_torch.local.scoring import (  # noqa: E402
    micro_batch_score_function,
)
from transmogrifai_tpu_torch.manifest import CheckpointManifest  # noqa: E402
from transmogrifai_tpu_torch.observability import metrics as obs_metrics  # noqa: E402
from transmogrifai_tpu_torch.persistence import FORMAT_VERSION  # noqa: E402
from transmogrifai_tpu_torch.robustness import faults  # noqa: E402
from transmogrifai_tpu_torch.serving import (  # noqa: E402
    ModelRegistry, ServeConfig, ServingRuntime,
)
from transmogrifai_tpu_torch.serving.drift import (  # noqa: E402
    DEGRADED, DRIFTING, OK, DriftBaseline, DriftConfig, DriftMonitor,
    live_refits,
)
from transmogrifai_tpu_torch.testing import (  # noqa: E402
    close_serving_state, serve_bench_workflow,
)

pytestmark = pytest.mark.drift

TINY_D, TINY_ROWS, TINY_SEED = 3, 300, 7
TINY_GBT = ("OpGBTClassifier",
            {"maxDepth": 3, "maxIter": 5, "stepSize": 0.1,
             "minInstancesPerNode": 5, "minInfoGain": 0.001})
FEATURES = [f"x{i}" for i in range(TINY_D)]
#: a sketch's centroids and masses against the JAX package's (both
#: float64 on the host), and a JS divergence from them
SKETCH_RTOL = 1e-12
JS_ATOL = 1e-9


@pytest.fixture(autouse=True)
def _clean_serving(tmp_path, monkeypatch):
    monkeypatch.setenv("TG_POSTMORTEM_DIR", str(tmp_path / "postmortems"))
    yield
    leaks = close_serving_state()
    assert not leaks, f"the test leaked serving state: {leaks}"


def _workflow(seed=TINY_SEED):
    from test_torch_serve import bench_frame
    return serve_bench_workflow(*TINY_GBT, TINY_D, seed,
                                device="cpu").set_input_dataset(
        bench_frame(TINY_ROWS, TINY_D, seed))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The port's and the JAX package's trains of the same workflow, each
    saved by its own package."""
    from test_torch_serve import save_jax_model, train_jax_model
    jm = train_jax_model(*TINY_GBT, n=TINY_ROWS, d=TINY_D, seed=TINY_SEED)
    pm = _workflow().train()
    root = tmp_path_factory.mktemp("drift_models")
    jpath, ppath = str(root / "jax"), str(root / "port")
    save_jax_model(jm, jpath)
    pm.save(ppath)
    return {"jax": jm, "port": pm, "jax_path": jpath, "port_path": ppath}


def _rows(n, shift=0.0, seed=3, missing=0.0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        row = {f: float(rng.randn() + (shift if f == "x0" else 0.0))
               for f in FEATURES}
        if missing and rng.rand() < missing:
            row["x0"] = None
        out.append(row)
    return out


def _cfg(**kw):
    base = dict(max_batch=32, max_queue=512, max_wait_ms=1.0)
    base.update(kw)
    return ServeConfig(**base)


def _assert_sketch_close(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, list):
            np.testing.assert_allclose(got[k], v, rtol=SKETCH_RTOL, atol=0)
        else:
            assert got[k] == pytest.approx(v, rel=SKETCH_RTOL, abs=0), k


# -- the baseline --------------------------------------------------------------

def test_baseline_json_is_the_jax_packages(models):
    """``DriftBaseline.to_json`` of the two packages' trains of one
    workflow: rows, bins, each feature's kind, count and nulls exact, the
    sketches within SKETCH_RTOL; and what each package's save wrote."""
    from transmogrifai_tpu.serving.drift import (
        DriftBaseline as JaxBaseline)
    got = DriftBaseline.from_model(models["port"]).to_json()
    want = JaxBaseline.from_model(models["jax"]).to_json()
    assert {k: got[k] for k in ("rows", "bins", "textBins")} == \
        {k: want[k] for k in ("rows", "bins", "textBins")} == \
        {"rows": TINY_ROWS, "bins": 64, "textBins": 64}
    assert sorted(got["features"]) == sorted(want["features"]) == FEATURES
    for name, w in want["features"].items():
        g = got["features"][name]
        assert {k: g[k] for k in ("kind", "key", "count", "nulls")} == \
            {k: w[k] for k in ("kind", "key", "count", "nulls")}
        _assert_sketch_close(g["sketch"], w["sketch"])
    for path in (models["port_path"], models["jax_path"]):
        man, err = CheckpointManifest.load(path, FORMAT_VERSION)
        assert err is None and man.drift
        saved = man.drift
        assert sorted(saved["features"]) == FEATURES
        for name, w in want["features"].items():
            _assert_sketch_close(saved["features"][name]["sketch"],
                                 w["sketch"])


def test_save_model_records_drift_baseline(models):
    """The port's save writes a ``drift`` section comparison-equivalent to
    the live model's baseline; a loaded model (no training table) saves
    none."""
    man, err = CheckpointManifest.load(models["port_path"], FORMAT_VERSION)
    loaded = DriftBaseline.from_json(man.drift)
    live = DriftBaseline.from_model(models["port"])
    assert sorted(loaded.features) == sorted(live.features) == FEATURES
    assert loaded.rows == live.rows == TINY_ROWS
    for name in loaded.features:
        a, b = loaded.distribution(name), live.distribution(name)
        assert a.fill_fraction() == b.fill_fraction()
        assert js_divergence(a.sketch, b.sketch, loaded.bins) == 0.0
    json.dumps(loaded.to_json())
    with pytest.raises(ValueError, match="train_table"):
        DriftBaseline.from_model(port.load_model(models["port_path"],
                                                 device="cpu"))


# -- verdicts against the JAX package's, on the same streams ----------------

def _both_monitors(models, **cfg):
    from transmogrifai_tpu.serving.drift import (
        DriftBaseline as JaxBaseline, DriftConfig as JaxConfig,
        DriftMonitor as JaxMonitor)
    return (DriftMonitor(DriftBaseline.from_model(models["port"]),
                         DriftConfig(**cfg)),
            JaxMonitor(JaxBaseline.from_model(models["jax"]),
                       JaxConfig(**cfg)))


def _same_snapshots(pm, jm):
    ps, js = pm.snapshot(), jm.snapshot()
    assert ps["verdict"] == js["verdict"] and ps["rows"] == js["rows"]
    assert sorted(ps["features"]) == sorted(js["features"])
    for name, m in js["features"].items():
        for k, v in m.items():
            if k == "verdict":
                assert ps["features"][name][k] == v
            else:
                assert ps["features"][name][k] == pytest.approx(
                    v, abs=JS_ATOL), (name, k)
    return ps


def test_verdict_transitions_equal_the_jax_packages(models):
    """ok -> drifting -> degraded under a progressively shifted stream,
    verdict by verdict and feature by feature as the JAX package's."""
    pmon, jmon = _both_monitors(models, every_rows=64, min_rows=64,
                                warn=0.12, refit=0.65)
    for rows, want in ((_rows(128, 0.0, 21), OK),
                       (_rows(128, 2.0, 22), DRIFTING),
                       (_rows(1280, 9.0, 23), DEGRADED)):
        pmon.observe(rows)
        jmon.observe(rows)
        assert _same_snapshots(pmon, jmon)["verdict"] == want
    hist = [h["verdict"] for h in pmon.report()["history"]]
    assert hist == [h["verdict"] for h in jmon.report()["history"]]
    assert hist.index(OK) < hist.index(DRIFTING) < hist.index(DEGRADED)


@pytest.mark.parametrize("shift,missing,want", [
    (0.0, 0.0, OK),            # in distribution
    (0.0, 0.8, DEGRADED),      # a fill-rate collapse
])
def test_monitor_verdicts_equal_the_jax_packages(models, shift, missing,
                                                 want):
    pmon, jmon = _both_monitors(models, every_rows=64, min_rows=64)
    rows = _rows(256, shift, 31, missing)
    pmon.observe(rows)
    jmon.observe(rows)
    snap = _same_snapshots(pmon, jmon)
    assert snap["verdict"] == want
    if missing:
        assert snap["features"]["x0"]["fillDelta"] > 0.5


def test_text_feature_drift_via_hash_bins():
    """Text features compare through hash-bin counts, with the JAX
    package's bins."""
    from transmogrifai_tpu.filters.distribution import (
        text_distribution as jax_text)
    toks = [["a"]] * 80 + [["b"]] * 20
    base = text_distribution("t", toks, text_bins=64)
    np.testing.assert_array_equal(base.distribution,
                                  jax_text("t", toks, 64).distribution)
    entry = {"kind": "text", "key": None, "count": base.count,
             "nulls": base.nulls, "counts": base.distribution.tolist()}
    baseline = DriftBaseline({"t": entry}, rows=100, bins=64, text_bins=64)
    cfg = DriftConfig(every_rows=16, min_rows=16)
    same = DriftMonitor(baseline, cfg)
    same.observe([{"t": "a"}] * 26 + [{"t": "b"}] * 6)
    assert same.verdict() == OK
    shifted = DriftMonitor(baseline, cfg)
    shifted.observe([{"t": "zzz"}] * 32)
    assert shifted.verdict() == DEGRADED


def test_a_jax_written_drift_section_drives_the_port(models):
    """The port's registry loads the JAX package's save: its monitor comes
    from the JAX-written ``drift`` section and reaches the JAX monitor's
    verdicts and JS divergences on the same stream."""
    from transmogrifai_tpu.serving.drift import (
        DriftBaseline as JaxBaseline, DriftConfig as JaxConfig,
        DriftMonitor as JaxMonitor)
    man, _ = CheckpointManifest.load(models["jax_path"], FORMAT_VERSION)
    jmon = JaxMonitor(JaxBaseline.from_json(man.drift),
                      JaxConfig(every_rows=32, min_rows=32))
    rows = _rows(96, shift=6.0)
    with ModelRegistry(_cfg()) as reg:
        rt = reg.load("m", models["jax_path"], device="cpu")
        rt.drift_monitor.config = DriftConfig(every_rows=32, min_rows=32)
        futs = [reg.submit("m", r) for r in rows]
        [f.result(timeout=60) for f in futs]
        reg.unregister("m")              # drains: every fold has run
    jmon.observe(rows)
    assert _same_snapshots(rt.drift_monitor, jmon)["verdict"] == DEGRADED


# -- end to end: shift -> degraded -> refit -> hot swap ----------------------

def test_e2e_shift_degrades_refits_and_hot_swaps(models, tmp_path,
                                                 monkeypatch):
    """A served model under a shifted stream degrades, fires the refit
    hook, and hot-swaps to the refreshed model with no request failed or
    shed; the swapped runtime serves bit-equal to a fresh load of the refit
    output."""
    monkeypatch.setenv("TG_DRIFT_EVERY_ROWS", "64")
    monkeypatch.setenv("TG_DRIFT_MIN_ROWS", "64")
    refit_path = str(tmp_path / "refit")
    hook_calls, called = [], threading.Event()

    def hook(name, rt, report):
        hook_calls.append((name, report["verdict"]))
        called.set()
        _workflow(seed=8).train().save(refit_path)
        return refit_path

    with ModelRegistry(_cfg(), refit_hook=hook) as reg:
        old_rt = reg.load("m", models["port_path"], device="cpu")
        assert old_rt.drift_monitor is not None
        futs = []
        for chunk in range(8):
            futs += [reg.submit("m", r)
                     for r in _rows(32, shift=6.0, seed=40 + chunk)]
        recs = [f.result(timeout=60) for f in futs]
        assert len(recs) == 256 and all(r is not None for r in recs)
        assert called.wait(timeout=60), "the refit hook never fired"
        for t in live_refits():
            t.join(timeout=60)
        new_rt = reg.runtime("m")
        assert hook_calls == [("m", DEGRADED)]
        assert new_rt is not old_rt
        assert old_rt.summary()["shed"] == {"overload": 0.0, "deadline": 0.0,
                                            "cancelled": 0.0}
        assert old_rt.summary()["drift"]["verdict"] == DEGRADED
        health = reg.health()
        assert health["refits"] == [{"model": "m", "ok": True,
                                     "swapped": True, "path": refit_path}]
        assert health["models"]["m"]["drift"]["verdict"] == OK
        assert "drift_refit" in [r.kind for r in new_rt.fault_log.reports]
        probe = _rows(8, seed=99)
        fresh = micro_batch_score_function(
            port.load_model(refit_path, device="cpu"))(probe)
        assert [reg.score("m", r, timeout=30) for r in probe] == fresh


def test_gauges_rise_and_mirror_into_observability(models):
    obs_metrics.enable_metrics(True)
    try:
        with ModelRegistry(_cfg()) as reg:
            rt = reg.load("m", models["port_path"], device="cpu")
            rt.drift_monitor.config = DriftConfig(every_rows=32,
                                                  min_rows=32)
            futs = [reg.submit("m", r) for r in _rows(64, shift=6.0)]
            [f.result(timeout=60) for f in futs]
            reg.unregister("m")
            local = rt.metrics.snapshot()
            assert local["tg_drift_js_divergence"][
                "feature=x0,model=m"] > 0.5
            assert "tg_drift_fill_delta" in local
            assert local["tg_drift_verdict"]["model=m"] == 2.0
        from transmogrifai_tpu_torch.observability import summarize
        serving = summarize()["serving"]
        assert serving["tg_drift_js_divergence"]["feature=x0,model=m"] > 0.5
        assert serving["tg_drift_verdict"]["model=m"] == 2.0
    finally:
        obs_metrics.enable_metrics(None)


def test_no_global_metric_writes_when_disabled(models):
    with ModelRegistry(_cfg()) as reg:
        rt = reg.load("m", models["port_path"], device="cpu")
        rt.drift_monitor.config = DriftConfig(every_rows=32, min_rows=32)
        futs = [reg.submit("m", r) for r in _rows(64, shift=6.0)]
        [f.result(timeout=60) for f in futs]
        reg.unregister("m")
        assert rt.drift_monitor.verdict() == DEGRADED
    assert obs_metrics.registry().snapshot() == {}


def test_drift_disabled_by_env(models, monkeypatch):
    monkeypatch.setenv("TG_DRIFT", "0")
    with ModelRegistry(_cfg()) as reg:
        rt = reg.load("m", models["port_path"], device="cpu")
        assert rt.drift_monitor is None
        assert rt.summary()["drift"] is None


# -- chaos at the drift.* sites ------------------------------------------------

@pytest.mark.chaos
def test_chaos_drift_fold_never_fails_requests(models):
    mon = DriftMonitor(DriftBaseline.from_model(models["port"]),
                       DriftConfig(every_rows=32, min_rows=32))
    with faults.injected({"drift.fold": {"mode": "raise", "nth": 1,
                                         "count": 2}}):
        with ServingRuntime(models["port"], "cf", _cfg(),
                            drift_monitor=mon) as rt:
            futs = [rt.submit(r) for r in _rows(96, shift=6.0)]
            recs = [f.result(timeout=60) for f in futs]
    assert len(recs) == 96 and all(r is not None for r in recs)
    failed = [r for r in rt.fault_log.reports
              if r.kind == "drift_fold_failed"]
    assert len(failed) == 2 and failed[0].site == "drift.fold"
    assert mon.fold_errors == 2 and mon.verdict() == DEGRADED
    assert rt.metrics.snapshot()["tg_drift_errors_total"][
        "model=cf,reason=fold"] == 2.0


@pytest.mark.chaos
def test_chaos_drift_verdict_typed_and_fold_state_intact(models):
    mon = DriftMonitor(DriftBaseline.from_model(models["port"]),
                       DriftConfig(every_rows=32, min_rows=32))
    with faults.injected({"drift.verdict": {"mode": "raise", "nth": 1,
                                            "count": 1}}):
        with ServingRuntime(models["port"], "cv", _cfg(),
                            drift_monitor=mon) as rt:
            futs = [rt.submit(r) for r in _rows(96, shift=6.0)]
            recs = [f.result(timeout=60) for f in futs]
    assert len(recs) == 96 and all(r is not None for r in recs)
    kinds = [r.kind for r in rt.fault_log.reports]
    assert "drift_verdict_failed" in kinds
    assert "drift_fold_failed" not in kinds
    snap = mon.snapshot()
    assert snap["rows"] == 96 and snap["verdict"] == DEGRADED
    assert snap["verdictErrors"] == 1


@pytest.mark.chaos
def test_chaos_drift_refit_fails_gracefully(models, monkeypatch):
    """A fault in the refit path: no swap, the old model serves on, the
    fault typed ``drift_refit_failed``, the breaker untouched."""
    monkeypatch.setenv("TG_DRIFT_EVERY_ROWS", "32")
    monkeypatch.setenv("TG_DRIFT_MIN_ROWS", "32")
    hook_calls = []
    with faults.injected({"drift.refit": {"mode": "raise", "nth": 1,
                                          "count": 1}}):
        with ModelRegistry(_cfg(), refit_hook=lambda *a: hook_calls.append(
                a)) as reg:
            rt = reg.load("m", models["port_path"], device="cpu")
            futs = [reg.submit("m", r) for r in _rows(96, shift=6.0)]
            recs = [f.result(timeout=60) for f in futs]
            rt.close()                   # drains: the degrading fold ran
            for t in live_refits():
                t.join(timeout=60)
            assert len(recs) == 96 and all(r is not None for r in recs)
            assert reg.runtime("m") is rt and not hook_calls
            kinds = [r.kind for r in rt.fault_log.reports]
            assert "drift_refit_failed" in kinds
            assert rt.breaker.state == "closed"
            assert reg.health()["refits"][0]["ok"] is False


def test_poisoned_monitor_never_fails_a_request(models):
    mon = DriftMonitor(DriftBaseline.from_model(models["port"]),
                       DriftConfig(every_rows=32, min_rows=32))

    def poisoned(rows):
        raise RuntimeError("poisoned fold")

    mon.observe = poisoned
    mb = micro_batch_score_function(models["port"])
    rows = _rows(16, seed=5)
    with ServingRuntime(models["port"], "poison", _cfg(pipeline_depth=1),
                        drift_monitor=mon, auto_start=False) as rt:
        futs = [rt.submit(r) for r in rows]
        rt.start()
        recs = [f.result(timeout=60) for f in futs]
    assert recs == mb(rows)              # one flush: the same batch
    assert rt.fault_log.reports
    assert all(r.kind == "drift_fold_failed" for r in rt.fault_log.reports)


# -- the shared JS implementation, the refit hook -------------------------------

def test_js_divergence_sketches_match_dense_path():
    from transmogrifai_tpu.filters.distribution import (
        js_divergence as jax_js, numeric_distribution as jax_numeric)
    rng = np.random.RandomState(0)
    a, b = rng.randn(2000), rng.randn(2000) + 3.0
    ones = np.ones(2000, bool)
    da = numeric_distribution("f", a, ones, 64)
    db = numeric_distribution("f", b, ones, 64)
    sketchy = js_divergence(da.sketch, db.sketch, 64)
    assert sketchy == pytest.approx(
        jax_js(jax_numeric("f", a, ones, 64).sketch,
               jax_numeric("f", b, ones, 64).sketch, 64), abs=JS_ATOL)
    fill_numeric_bins(da, db, 64)
    assert da.js_divergence(db) == pytest.approx(sketchy, abs=1e-12)
    assert sketchy > 0.5
    assert js_divergence(da.sketch, da.sketch, 64) == 0.0
    with pytest.raises(TypeError, match="two sketches or two arrays"):
        js_divergence(da.sketch, np.ones(3))


def test_workflow_drift_refit_hook(tmp_path):
    """``OpWorkflow.drift_refit_hook`` trains, saves under a fresh
    ``refit_N`` directory and returns a loadable path; with ``resume=True``
    it needs a checkpoint dir (a ValueError without one, as in the JAX
    package), and with one the refit resumes from it."""
    wf = _workflow()
    hook = wf.drift_refit_hook(str(tmp_path))
    p1 = hook("m", None, {})
    p2 = hook("m", None, {})
    assert p1.endswith("refit_000001") and p2.endswith("refit_000002")
    loaded = port.load_model(p1, device="cpu")
    assert micro_batch_score_function(loaded)(_rows(1))[0] is not None
    with pytest.raises(ValueError, match="with_checkpoint_dir"):
        wf.drift_refit_hook(str(tmp_path), resume=True)("m", None, {})
    wf.with_checkpoint_dir(str(tmp_path / "ckpt"))
    p3 = wf.drift_refit_hook(str(tmp_path / "resumed"))("m", None, {})
    resumed = port.load_model(p3, device="cpu")
    assert (micro_batch_score_function(resumed)(_rows(4))
            == micro_batch_score_function(loaded)(_rows(4)))
