"""The PyTorch port's chaos campaign on the CPU (``tests/test_campaign.py``'s
cases): the site registry against the JAX package's, ``WAITING_SITES``
pinned, fired-injection accounting, the run sentinel, the oracles, a
seeded campaign with 100% coverage of every other site and zero
violations, a planted recovery bug caught, minimized and reproduced, the
``campaign`` command line, and the two pairwise interactions.
"""
from __future__ import annotations

import json
import os
import re
import time

import numpy as np
import pytest

from transmogrifai_tpu.robustness import campaign as jcampaign
from transmogrifai_tpu.robustness import faults as jfaults

import transmogrifai_tpu_torch as port
from transmogrifai_tpu_torch import cli
from transmogrifai_tpu_torch.local.scoring import micro_batch_score_function
from transmogrifai_tpu_torch.manifest import (
    SENTINEL_FILE, RunSentinel, atomic_write_json,
)
from transmogrifai_tpu_torch.observability import metrics as obs_metrics
from transmogrifai_tpu_torch.robustness import faults, oracles
from transmogrifai_tpu_torch.robustness.campaign import (
    ACCOUNT_KINDS, WAITING_SITES, ChaosCampaign, campaign_sites,
)
from transmogrifai_tpu_torch.robustness.faults import (
    ALL_SITES, SimulatedPreemption, sites_for_scenario,
)
from transmogrifai_tpu_torch.testing import (
    close_serving_state, pressure_table, port_stream_namespace, stream_dag,
)

pytestmark = pytest.mark.campaign

PKG_ROOT = os.path.dirname(port.__file__)


@pytest.fixture(autouse=True)
def _clean_state():
    close_serving_state()
    yield
    leaks = close_serving_state()
    assert not leaks, leaks


@pytest.fixture(scope="module")
def engine():
    eng = ChaosCampaign(seed=7, device="cpu")
    yield eng
    eng.close()


# -- the registry -----------------------------------------------------------------

def test_waiting_sites_are_exactly_the_unported_modules_sites():
    """Items 10 (the AOT store) and 3 (the plan compiler) shrink this."""
    assert WAITING_SITES == {"aot.load", "plan.segment_execute", "oom.plan"}
    assert campaign_sites() == sorted(set(ALL_SITES) - WAITING_SITES)


def test_registry_matches_the_jax_package():
    assert set(ALL_SITES) == set(jfaults.ALL_SITES)
    for name, spec in ALL_SITES.items():
        j = jfaults.ALL_SITES[name]
        assert (spec.modes, spec.scenarios, spec.bit_equal) == (
            j.modes, j.scenarios, j.bit_equal), name
    for scn in ChaosCampaign.SCENARIO_WEIGHTS:
        assert sites_for_scenario(scn[0]) == \
            jfaults.sites_for_scenario(scn[0])
    assert ACCOUNT_KINDS == jcampaign.ACCOUNT_KINDS
    assert set(ACCOUNT_KINDS) <= set(ALL_SITES)
    assert ChaosCampaign.SCENARIO_WEIGHTS == \
        jcampaign.ChaosCampaign.SCENARIO_WEIGHTS
    assert [c.name for c in ChaosCampaign._SCENARIOS] == [
        c.name for c in jcampaign.ChaosCampaign._SCENARIOS]


def test_every_covered_site_is_compiled_into_the_port():
    """No covered site is dead: each is named, as a string, by a module
    of the port that is not the registry."""
    blob = ""
    for root, _, files in os.walk(PKG_ROOT):
        for f in files:
            path = os.path.join(root, f)
            if f.endswith(".py") and not path.endswith(
                    os.path.join("robustness", "faults.py")) \
                    and not path.endswith("campaign.py"):
                blob += open(path).read()
    missing = [s for s in campaign_sites() if f'"{s}"' not in blob]
    assert not missing, missing
    for s in WAITING_SITES:
        assert f'"{s}"' not in blob, s


# -- injection accounting, the run sentinel, the oracles ------------------------

@pytest.mark.chaos
def test_fired_counts_and_injection_counter():
    obs_metrics.enable_metrics(True)
    try:
        with faults.injected({
                "dag.stage_fit": {"mode": "raise", "nth": 2, "count": 1},
                "validator.fold_metrics": {"mode": "nan", "nth": 1}}):
            faults.inject("dag.stage_fit")
            with pytest.raises(faults.TransientFaultError):
                faults.inject("dag.stage_fit")
            faults.inject("dag.stage_fit")
            assert np.isnan(faults.poison("validator.fold_metrics",
                                          np.ones(3))[0])
            assert faults.fired_counts() == {
                "dag.stage_fit": {"raise": 1},
                "validator.fold_metrics": {"nan": 1}}
            series = obs_metrics.registry().snapshot()[
                "tg_chaos_injections_total"]
            assert series["mode=raise,site=dag.stage_fit"] == 1.0
            assert series["mode=nan,site=validator.fold_metrics"] == 1.0
        assert faults.fired_counts() == {}
    finally:
        obs_metrics.enable_metrics(None)


def test_run_sentinel_lifecycle(tmp_path):
    s = RunSentinel(str(tmp_path))
    s.start("dag_fit")
    assert RunSentinel.read(str(tmp_path)) == {"pid": os.getpid(),
                                               "phase": "dag_fit"}
    assert s.read_stale() is None
    s.set_phase("device_sweep")
    assert RunSentinel.suspects_oom_kill(RunSentinel.read(str(tmp_path)))
    assert not RunSentinel.suspects_oom_kill({"phase": "checkpoint_write"})
    s.clear()
    assert RunSentinel.read(str(tmp_path)) is None


def _ckpt_workflow(data, ckpt):
    from transmogrifai_tpu_torch.testing import serve_bench_workflow
    port.features.reset_uids()
    return (serve_bench_workflow("OpLogisticRegression",
                                 {"regParam": 0.01, "elasticNetParam": 0.0},
                                 2, seed=9, device="cpu")
            .set_input_dataset(data).with_checkpoint_dir(ckpt))


def _two_col(n=200, seed=3):
    rng = np.random.RandomState(seed)
    x0, x1 = rng.randn(n), rng.randn(n)
    return {"x0": x0, "x1": x1, "y": ((x0 + x1) > 0).astype(float)}


@pytest.mark.chaos
def test_unclean_exit_recorded_on_resume(tmp_path):
    data = _two_col()
    ckpt = str(tmp_path / "ckpt")
    clean = _ckpt_workflow(data, ckpt).train()
    assert not os.path.exists(os.path.join(ckpt, SENTINEL_FILE))
    assert clean.summary()["faults"]["uncleanExits"] == []
    atomic_write_json(os.path.join(ckpt, SENTINEL_FILE),
                      {"pid": 999_999_999, "phase": "device_upload"})
    exits = _ckpt_workflow(data, ckpt).train(resume=True).summary()[
        "faults"]["uncleanExits"]
    assert len(exits) == 1 and exits[0]["kind"] == "unclean_exit"
    assert exits[0]["detail"]["pid"] == 999_999_999
    assert exits[0]["detail"]["oomKillSuspected"] is True
    assert not os.path.exists(os.path.join(ckpt, SENTINEL_FILE))
    # a kill after the sweep leaves its device phase behind
    with faults.injected({"preempt.refit": {"mode": "preempt", "nth": 1}}):
        with pytest.raises(SimulatedPreemption):
            _ckpt_workflow(data, str(tmp_path / "k")).train()
    assert RunSentinel.read(str(tmp_path / "k"))["phase"] == "device_sweep"
    # a same-process resume is not an unclean exit
    resumed = _ckpt_workflow(data, str(tmp_path / "k")).train(resume=True)
    assert resumed.summary()["faults"]["uncleanExits"] == []


def test_oracles_clean_process_reports_nothing():
    assert oracles.campaign_violations() == []


# -- the engine ---------------------------------------------------------------------

def test_generate_is_deterministic_and_covering():
    e1, e2, e3 = (ChaosCampaign(seed=s, device="cpu") for s in (21, 21, 22))
    try:
        g1 = e1.generate(40)
        assert g1 == e2.generate(40)
        assert g1 != e3.generate(40)
        n = len(campaign_sites())
        assert {s for sch in g1[:n] for s in sch["faults"]} == set(
            campaign_sites())
        for sch in g1:
            assert sch["scenario"] in e1.scenarios
            assert set(sch["faults"]) <= set(
                sites_for_scenario(sch["scenario"])) - WAITING_SITES
            for site, spec in sch["faults"].items():
                assert spec["mode"] in ALL_SITES[site].modes
    finally:
        for e in (e1, e2, e3):
            e.close()


@pytest.mark.chaos
def test_seeded_campaign_full_coverage_zero_violations(engine):
    report = engine.run(count=len(campaign_sites()) + 4)
    doc = report.to_json()
    assert report.ok, doc["violations"]
    assert doc["uncovered"] == [] and doc["coveragePct"] == 100.0
    assert set(doc["firedBySite"]) == set(campaign_sites())
    acct = doc["accounting"]
    assert acct["lost"] == 0 and acct["failed"] == 0
    assert acct["submitted"] == (acct["completed"] + acct["shed"]
                                 + acct["cancelled"])
    assert acct["cancelled"] > 0
    for res in doc["results"]:
        assert (res["outcome"] == "completed"
                or res["outcome"].startswith("raised:")), res


@pytest.mark.chaos
def test_planted_recovery_bug_detected_minimized_and_reproduced(
        monkeypatch):
    from transmogrifai_tpu_torch.serving import runtime as srt
    orig = srt.ServingRuntime._eager_records

    def buggy(self, reqs):
        out = orig(self, reqs)
        return out[:-1] if len(out) > 1 else out

    eng = ChaosCampaign(seed=5, collect_timeout=1.5, device="cpu",
                        scenarios=["serve"])
    try:
        schedule = {"scenario": "serve", "faults": {
            "serve.flush": {"mode": "raise", "nth": 1, "count": 1},
            "drift.fold": {"mode": "raise", "nth": 1, "count": 1},
            "serve.enqueue": {"mode": "raise", "nth": 2, "count": 1}}}
        monkeypatch.setattr(srt.ServingRuntime, "_eager_records", buggy)
        res = eng.run_schedule(schedule)
        assert any("lost" in v for v in res["violations"]), res
        minimized = eng.minimize(schedule)
        assert len(minimized) <= 2 and "serve.flush" in minimized
        repro = eng.reproducer("serve", minimized)
        assert json.loads(repro["env"]["TG_FAULTS"]) == minimized
        assert "TG_CHAOS=1" in repro["cmd"]
        assert ("transmogrifai_tpu_torch.cli campaign --scenario serve"
                in repro["cmd"])
        assert eng.run_repro(repro)["violations"]
        monkeypatch.setattr(srt.ServingRuntime, "_eager_records", orig)
        assert not eng.run_repro(repro)["violations"]
    finally:
        eng.close()


@pytest.mark.chaos
def test_cli_campaign_repro_mode_runs_single_schedule(capsys):
    res = cli.run_campaign(
        scenario="transfer", device="cpu",
        faults_json='{"distributed.device_put": {"mode": "raise",'
                    ' "nth": 1}}')
    assert res["outcome"] == "completed"
    assert res["fired"] == {"distributed.device_put": {"raise": 1}}
    assert res["violations"] == []
    assert '"outcome": "completed"' in capsys.readouterr().out


def test_cli_parser_takes_the_campaign_options():
    a = cli.build_parser().parse_args(
        ["campaign", "--schedules", "5", "--seed", "3", "--scenario",
         "sweep", "--device", "cpu", "--no-minimize"])
    assert (a.schedules, a.seed, a.scenario, a.device, a.no_minimize) == (
        5, 3, "sweep", "cpu", True)


# -- the pairwise interactions --------------------------------------------------------

@pytest.mark.chaos
@pytest.mark.stream
def test_preempt_stage_fit_during_oom_downshifted_stream_resumes_bit_exact(
        tmp_path):
    from transmogrifai_tpu_torch.testing import stage_of
    ns = port_stream_namespace()
    table = pressure_table(ns, 1600, 4, seed=31)

    def make_wf(ckpt):
        ns.reset_uids()
        return (ns.OpWorkflow(device="cpu")
                .set_result_features(stream_dag(ns, 4))
                .with_checkpoint_dir(ckpt))

    def train(wf, resume=False):
        return wf.train(stream=ns.streaming.TableChunkSource(table, 400),
                        resume=resume)

    def fills(m):
        return np.asarray(stage_of(m, "RealVectorizerModel").fills)

    with faults.injected({"oom.stream": {"mode": "oom", "nth": 2}}):
        ref = train(make_wf(str(tmp_path / "ref")))
    assert ref.summary()["faults"]["oomDownshifts"]
    ckpt = str(tmp_path / "killed")
    wf = make_wf(ckpt)
    with faults.injected({
            "oom.stream": {"mode": "oom", "nth": 2},
            "preempt.stage_fit": {"mode": "preempt", "nth": 2}}):
        with pytest.raises(SimulatedPreemption):
            train(wf)
        assert os.path.exists(os.path.join(ckpt, SENTINEL_FILE))
        resumed = train(wf, resume=True)
    np.testing.assert_array_equal(fills(resumed), fills(ref))
    pred = resumed.result_features[0].name
    probe = table.take(np.arange(64))
    np.testing.assert_array_equal(
        resumed.score(table=probe)[pred].values.numpy(),
        ref.score(table=probe)[pred].values.numpy())
    assert resumed.summary()["resume"]["restoredStages"]
    assert not os.path.exists(os.path.join(ckpt, SENTINEL_FILE))


@pytest.mark.chaos
@pytest.mark.drift
def test_drift_refit_failure_with_oom_serve_split_keeps_old_model_serving(
        tmp_path, engine):
    from transmogrifai_tpu_torch.serving import ModelRegistry, ServeConfig
    from transmogrifai_tpu_torch.serving.drift import (
        DriftConfig, live_refits)
    model = engine.small_model()
    saved = str(tmp_path / "m")
    model.save(saved)
    rng = np.random.RandomState(44)
    shifted = [{f"x{i}": float(rng.randn() + 6.0) for i in range(3)}
               for _ in range(128)]
    expect = micro_batch_score_function(model)(shifted)
    hook_calls = []

    def hook(name, rt, report):
        hook_calls.append(name)
        return saved

    cfg = ServeConfig(max_batch=32, max_queue=512, max_wait_ms=1.0)
    with faults.injected({"drift.refit": {"mode": "raise", "nth": 1},
                          "oom.serve": {"mode": "oom", "nth": 1}}):
        with ModelRegistry(cfg, refit_hook=hook) as reg:
            rt = reg.load("m", saved, device="cpu")
            rt.drift_monitor.config = DriftConfig(min_rows=32,
                                                  every_rows=32)
            recs = [f.result(timeout=60)
                    for f in [rt.submit(r) for r in shifted]]
            t0 = time.monotonic()
            while live_refits() and time.monotonic() - t0 < 60:
                time.sleep(0.05)
            assert not live_refits()
            assert reg.runtime("m") is rt
            kinds = {r.kind for r in rt.fault_log.reports}
            health = reg.health()
            breaker = rt.breaker.snapshot()
    assert recs == expect
    assert {"drift_refit_failed", "oom_downshift"} <= kinds
    assert not hook_calls
    assert health["refits"] and health["refits"][0]["ok"] is False
    assert breaker["opens"] == 0 and breaker["state"] == "closed"


@pytest.mark.chaos
def test_distributed_device_put_retries_transient_faults():
    from transmogrifai_tpu_torch.parallel.distributed import (
        fetch_to_host, retrying_device_put)
    from transmogrifai_tpu_torch.robustness.policy import FaultLog
    x = np.arange(512, dtype=np.float32)
    log = FaultLog()
    with log.activate():
        with faults.injected({"distributed.device_put":
                              {"mode": "raise", "nth": 1, "count": 2}}):
            dev = retrying_device_put(x, "cpu")
        back = fetch_to_host(dev)
    assert np.array_equal(back, x) and back.dtype == np.float32
    assert log.of_kind("retry")
    with faults.injected({"distributed.to_host": {
            "mode": "raise", "nth": 1, "transient": False}}):
        with pytest.raises(faults.InjectedFaultError):
            fetch_to_host(dev)


def test_the_campaign_module_docstring_names_its_command():
    doc = ChaosCampaign.__module__
    import importlib
    mod = importlib.import_module(doc)
    assert re.search(r"python -m transmogrifai_tpu_torch\.cli\s+campaign",
                     mod.__doc__)
