"""The PyTorch port's replica fleet and front door against the JAX package
(``transmogrifai_tpu_torch/serving/{fleet,frontdoor,replica_worker}.py``;
the cases of ``tests/test_fleet.py`` and
``tests/test_serve_pipeline.py::test_replica_kill_with_pipelined_replicas_zero_lost``
on the port's CPU path).

Models: the LR workflow that ``tests/test_fleet.py:_train_model`` trains
with the JAX package, saved and loaded by the port; the committed JAX-saved
``serve64/gbt`` and ``serve64/rf`` (64 predictors). Tolerances: the port's
front door against the JAX package's on the same model and rows,
probabilities within ``PROB_ATOL`` (1e-5) and decided predictions equal;
within the port, records bit-equal to the micro-batch scorer through
failover and kills on ``serve64/rf`` (its forest sums each row's
trees in tree order, whatever the flush), and within ``ULP_ATOL`` on the
LR (PyTorch's CPU ``torch.sigmoid`` rounds its vector lanes and its scalar
tail differently, so a binary probability moves by an ulp with the flush a
row lands in: ROADMAP Queue 3). The front door's own behaviours (routing,
probes, chaos, deploys, admission, autoscale) and the subprocess replicas
are in ``test_torch_frontdoor.py``. Nothing here depends on the host's speed:
queue depths are staged behind a 500 ms flush timer and probes are manual
(``probe_interval_ms=0``).
"""
from __future__ import annotations

import os
import shutil
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import jax  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import transmogrifai_tpu.models.trees  # noqa: E402,F401  (registers families)
import transmogrifai_tpu_torch as port  # noqa: E402
from transmogrifai_tpu_torch.local.scoring import (  # noqa: E402
    micro_batch_score_function,
)
from transmogrifai_tpu_torch.observability import postmortem as pm  # noqa: E402
from transmogrifai_tpu_torch.robustness import oracles  # noqa: E402
from transmogrifai_tpu_torch.robustness.faults import ALL_SITES  # noqa: E402
from transmogrifai_tpu_torch.serving import (  # noqa: E402
    FleetConfig, FrontDoor, ServeConfig,
)
from transmogrifai_tpu_torch.serving.loadgen import synthetic_rows  # noqa: E402
from transmogrifai_tpu_torch.testing import (  # noqa: E402
    close_serving_state, request_rows, score_frame,
)

pytestmark = pytest.mark.fleet

SERVE64 = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures",
                       "serve64")
#: a probability of the port against the JAX package's
PROB_ATOL = 1e-5
#: a binary probability across CPU flush compositions (two ulps at 0.5)
ULP_ATOL = 2 * float(np.spacing(np.float32(0.5)))


@pytest.fixture(autouse=True)
def _clean_serving(tmp_path, monkeypatch):
    monkeypatch.setenv("TG_POSTMORTEM_DIR", str(tmp_path / "postmortems"))
    yield
    leaks = close_serving_state()
    assert not leaks, f"the test leaked serving state: {leaks}"


@pytest.fixture(scope="module")
def lr(tmp_path_factory):
    """{"jax": the JAX package's train of tests/test_fleet.py's LR
    workflow, "path": its save, "port": the port's load of it}."""
    from test_fleet import _train_model
    from test_torch_serve import save_jax_model
    jm = _train_model()
    path = str(tmp_path_factory.mktemp("fleet_lr") / "m")
    save_jax_model(jm, path)
    return {"jax": jm, "path": path,
            "port": port.load_model(path, device="cpu")}


@pytest.fixture(scope="module")
def rf_path(tmp_path_factory):
    """A copy of the committed ``serve64/rf`` (a load may write into it)."""
    d = str(tmp_path_factory.mktemp("fleet_rf") / "rf")
    shutil.copytree(os.path.join(SERVE64, "rf"), d)
    return d


@pytest.fixture(scope="module")
def rf(rf_path):
    return port.load_model(rf_path, device="cpu")


def _rows(n=24, seed=57):
    return request_rows(score_frame(n, 64, seed))


def _cfg(**kw):
    """Slow-flush default: requests sit queued for up to 500 ms, so queue
    depths (and mid-flight kills) are deterministic."""
    base = dict(max_batch=64, max_queue=256, max_wait_ms=500.0)
    base.update(kw)
    return ServeConfig(**base)


def _fc(**kw):
    """Manual probing, no autoscale, replicas on the CPU."""
    base = dict(min_replicas=1, max_replicas=4, probe_interval_ms=0.0,
                probe_failures=3, readmit_probes=2, max_failovers=2,
                autoscale=False, device="cpu")
    base.update(kw)
    return FleetConfig(**base)


def _fleet(model, replicas=2, cfg=None, fc=None, **kw):
    return FrontDoor({"m": model}, replicas=replicas,
                     config=cfg or _cfg(), fleet_config=fc or _fc(), **kw)


def _probs(model, recs):
    name = model.result_features[0].name
    return np.asarray([r[name]["probability_1"] for r in recs], np.float64)


def _preds(model, recs):
    name = model.result_features[0].name
    return np.asarray([r[name]["prediction"] for r in recs])


# -- parity with the JAX package's front door --------------------------------

@pytest.mark.parametrize("which", ["lr", "gbt"])
def test_frontdoor_records_against_the_jax_frontdoor(lr, which, tmp_path):
    """The same model and rows through each package's two-replica front
    door: probabilities within PROB_ATOL, predictions equal."""
    from transmogrifai_tpu.persistence import load_model as jax_load
    from transmogrifai_tpu.serving import (
        FleetConfig as JFleetConfig, FrontDoor as JFrontDoor,
        ServeConfig as JServeConfig)
    if which == "lr":
        jm, pm_ = lr["jax"], lr["port"]
        rows = synthetic_rows(pm_, 24, seed=57)
    else:
        path = str(tmp_path / "gbt")
        shutil.copytree(os.path.join(SERVE64, "gbt"), path)
        jm, pm_ = jax_load(path), port.load_model(path, device="cpu")
        rows = _rows(24, seed=5)
    jfc = JFleetConfig(probe_interval_ms=0.0, autoscale=False)
    with JFrontDoor({"m": jm}, replicas=2,
                    config=JServeConfig(max_batch=64, max_wait_ms=2.0),
                    fleet_config=jfc) as jfd:
        want = [f.result(timeout=60) for f in [jfd.submit(r) for r in rows]]
    with _fleet(pm_, cfg=_cfg(max_wait_ms=2.0)) as fd:
        got = [f.result(timeout=60) for f in [fd.submit(r) for r in rows]]
    np.testing.assert_allclose(_probs(pm_, got), _probs(pm_, want),
                               rtol=0, atol=PROB_ATOL)
    assert (_preds(pm_, got) == _preds(pm_, want)).all()
    assert [set(r) for r in got] == [set(r) for r in want]


@pytest.mark.parametrize("which", ["rf", "lr"])
def test_replica_kill_mid_flight_zero_lost(rf, lr, which, tmp_path):
    """24 requests staged on two replicas, r0 killed: every future resolves
    (the 12 on r0 fail over to r1) to the micro-batch scorer's record, one
    schema-valid ``replica_lost`` post-mortem, no request counted twice."""
    model = rf if which == "rf" else lr["port"]
    rows = _rows(24) if which == "rf" else synthetic_rows(model, 24, seed=57)
    baseline = micro_batch_score_function(model)(list(rows))
    with _fleet(model) as fd:
        futs = [fd.submit(r) for r in rows]
        assert fd.replica_distribution() == {"r0": 12, "r1": 12}
        fd.kill_replica("r0")
        recs = [f.result(timeout=30) for f in futs]
        snap = fd.fleet_snapshot()
        assert snap["kills"] == 1 and snap["failovers"] >= 12
        assert fd.replica_distribution()["r1"] == 24
        kinds = {r.kind for r in fd.fault_log.reports}
        assert "replica_lost" in kinds and "fleet_failover" in kinds
        assert fd.summary()["rowsScored"] == 24.0
    if which == "rf":
        assert recs == baseline
    else:
        np.testing.assert_allclose(_probs(model, recs),
                                   _probs(model, baseline), rtol=0,
                                   atol=ULP_ATOL)
        assert (_preds(model, recs) == _preds(model, baseline)).all()
    docs = [pm.read_bundle(p) for p in pm.list_bundles(
        str(tmp_path / "postmortems"))]
    assert [d["trigger"]["kind"] for d in docs] == ["replica_lost"]
    assert not pm.validate_bundle(docs[0])
    assert docs[0]["trigger"]["detail"]["replica"] == "r0"


def test_pipelined_replica_kill_zero_lost(rf):
    """A replica dies while its pipelined dataplane (depth 3) holds queued
    and in-flight flushes: every future resolves once, bit-equal."""
    rows = _rows(24, seed=9)
    baseline = micro_batch_score_function(rf)(list(rows))
    cfg = ServeConfig(max_batch=4, max_queue=256, max_wait_ms=30.0,
                      pipeline_depth=3)
    with _fleet(rf, cfg=cfg) as fd:
        futs = [fd.submit(r) for r in rows]
        fd.kill_replica("r0")
        assert [f.result(timeout=30) for f in futs] == baseline
        assert fd.fleet_snapshot()["kills"] == 1
        assert "replica_lost" in {r.kind for r in fd.fault_log.reports}
        assert fd.summary()["rowsScored"] == 24.0


# -- sites --------------------------------------------------------------------

def test_fleet_sites_registered():
    from transmogrifai_tpu.robustness.faults import ALL_SITES as JAX_SITES
    for site in ("fleet.route", "fleet.replica_kill", "fleet.probe"):
        spec = ALL_SITES[site]
        assert "fleet" in spec.scenarios and spec.modes == ("raise",)
        assert spec.module == "serving/frontdoor.py" and spec.bit_equal
        ref = JAX_SITES[site]
        assert (spec.scenarios, spec.modes, spec.module, spec.bit_equal) \
            == (ref.scenarios, ref.modes, ref.module, ref.bit_equal)


# -- the shapes ---------------------------------------------------------------

def test_summary_and_health_shapes(rf, lr):
    """The port's ``summary``/``health``/``fleet_snapshot`` carry the JAX
    package's keys."""
    from transmogrifai_tpu.serving import (
        FleetConfig as JFleetConfig, FrontDoor as JFrontDoor,
        ServeConfig as JServeConfig)
    shapes = []
    jfc = JFleetConfig(probe_interval_ms=0.0, autoscale=False)
    with JFrontDoor({"m": lr["jax"]}, replicas=2,
                    config=JServeConfig(max_wait_ms=2.0),
                    fleet_config=jfc) as jfd:
        jfd.submit(synthetic_rows(lr["port"], 1)[0]).result(timeout=60)
        shapes.append((jfd.summary(), jfd.health()))
    with _fleet(rf, cfg=_cfg(max_wait_ms=2.0)) as fd:
        fd.submit(_rows(1)[0]).result(timeout=30)
        s, h = fd.summary(), fd.health()
        shapes.append((s, h))
        assert s["state"] == "ready" and s["rowsScored"] == 1.0
        assert s["scaleHint"]["hint"] in ("up", "hold", "down")
        assert h["ready"] and set(h["replicas"]) == {"r0", "r1"}
        assert all(v["ready"] for v in h["replicas"].values())
        assert h["fleet"]["counts"] == {"active": 2}
        assert h["fleet"]["admission"]["enabled"] is False
    (js, jh), (ps, ph) = shapes
    assert sorted(ps) == sorted(js) and sorted(ph) == sorted(jh)
    assert sorted(ps["fleet"]) == sorted(js["fleet"])
    assert sorted(ps["shed"]) == sorted(js["shed"])
    assert sorted(ph["fleet"]["replicas"]["r0"]) == \
        sorted(jh["fleet"]["replicas"]["r0"])
