"""The PyTorch port's pipelined serving dataplane against the serial loop
and the JAX package (``transmogrifai_tpu_torch/serving/runtime.py``): the
cases of ``tests/test_serve_pipeline.py`` but the fleet tier's replica kill
(ROADMAP Queue 1 item 8b), on the port's CPU path.

They serve the committed JAX-saved ``serve64/rf`` model (64 predictors, 50
slot-chain trees). Its forest sums each row's trees in tree order on either
device, so records are bit-equal whatever the flush sizes (the binary GBT's
CPU ``torch.sigmoid`` is not: ``test_torch_serving.py`` pins that). Against
the JAX package's runtime on the same rows the records agree within
``PROB_ATOL`` (1e-5; the JAX package sums an RF's trees inside an Eigen
GEMM, ROADMAP Queue 3 "RF scores in the last bit"). Time is never slept
on: breakers take an injected clock, queues are staged before ``start()``,
and every wait is a future's with its own timeout.
"""
from __future__ import annotations

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
from transmogrifai_tpu_torch.local.scoring import (  # noqa: E402
    SCORE_ERROR_KEY, micro_batch_score_function, score_function,
)
from transmogrifai_tpu_torch.robustness import faults  # noqa: E402
from transmogrifai_tpu_torch.robustness.faults import ALL_SITES  # noqa: E402
from transmogrifai_tpu_torch.serving import (  # noqa: E402
    CircuitBreaker, ServeConfig, ServingRuntime,
)
from transmogrifai_tpu_torch.testing import (  # noqa: E402
    close_serving_state, request_rows, score_frame,
)

pytestmark = pytest.mark.serve

FIXTURE = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures",
                       "serve64", "rf")
#: the serve limit of a probability against the JAX package's
PROB_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_serving(tmp_path, monkeypatch):
    monkeypatch.setenv("TG_POSTMORTEM_DIR", str(tmp_path / "postmortems"))
    yield
    leaks = close_serving_state()
    assert not leaks, f"the test leaked serving state: {leaks}"


@pytest.fixture(scope="module")
def model():
    return port.load_model(FIXTURE, device="cpu")


def _rows(n, seed=3):
    return request_rows(score_frame(n, 64, seed))


def _cfg(depth, **kw):
    base = dict(max_batch=8, max_queue=128, max_wait_ms=2.0,
                pipeline_depth=depth)
    base.update(kw)
    return ServeConfig(**base)


def _prob(model, recs):
    name = model.result_features[0].name
    return np.asarray([r[name]["probability_1"] for r in recs])


def test_serve_complete_site_registered():
    spec = ALL_SITES["serve.complete"]
    assert spec.module == "serving/runtime.py"
    assert "serve" in spec.scenarios
    assert spec.modes == ("raise",)
    assert spec.bit_equal


def test_pipelined_bit_equal_across_depths(model):
    """Depths 1 (serial), 2 and 3 give identical records over flushes of
    mixed sizes, with two quarantined rows in the mix (a string where a
    Real belongs); and the JAX package's serial runtime gives the same
    records within PROB_ATOL."""
    from transmogrifai_tpu.persistence import load_model as jax_load
    from transmogrifai_tpu.serving import (
        ServeConfig as JaxConfig, ServingRuntime as JaxRuntime)

    rows = _rows(18, seed=11)
    rows.insert(5, dict(rows[0], x1="not-a-number"))
    rows.insert(13, dict(rows[1], x2="also-bad"))
    by_depth = {}
    for depth in (1, 2, 3):
        with ServingRuntime(model, f"eq{depth}", _cfg(depth)) as rt:
            futs = [rt.submit(r) for r in rows]
            by_depth[depth] = [f.result(timeout=30) for f in futs]
            assert rt.summary()["pipeline"]["depth"] == depth
        snap = rt.metrics.snapshot()
        assert snap["tg_serve_rows_total"][f"model=eq{depth}"] == 20.0
        stages = set(snap.get("tg_serve_stage_seconds", {}))
        if depth == 1:
            assert stages == {f"model=eq{depth},stage=serial"}
        else:
            assert f"model=eq{depth},stage=complete" in stages
    assert by_depth[2] == by_depth[1]
    assert by_depth[3] == by_depth[1]
    for recs in by_depth.values():
        assert SCORE_ERROR_KEY in recs[5] and SCORE_ERROR_KEY in recs[13]
        assert sum(SCORE_ERROR_KEY not in r for r in recs) == 18
    jm = jax_load(FIXTURE)
    with JaxRuntime(jm, "jeq", JaxConfig(max_batch=8, max_queue=128,
                                         max_wait_ms=2.0,
                                         pipeline_depth=1)) as rt:
        futs = [rt.submit(r) for r in rows]
        want = [f.result(timeout=60) for f in futs]
    clean = [i for i, r in enumerate(want) if SCORE_ERROR_KEY not in r]
    assert clean == [i for i, r in enumerate(by_depth[1])
                     if SCORE_ERROR_KEY not in r]
    got = _prob(model, [by_depth[1][i] for i in clean])
    np.testing.assert_allclose(got, _prob(model, [want[i] for i in clean]),
                               rtol=0, atol=PROB_ATOL)


def test_completer_thread_lifecycle(model):
    """Depth > 1 runs a tg-serve-completer[<name>] thread; depth 1 does
    not; close() retires it."""
    def completers():
        return [t.name for t in threading.enumerate()
                if t.name.startswith("tg-serve-completer")]

    with ServingRuntime(model, "lc1", _cfg(1)) as rt:
        rt.score(_rows(1)[0], timeout=30)
        assert completers() == []
    with ServingRuntime(model, "lc2", _cfg(2)) as rt:
        rt.score(_rows(1)[0], timeout=30)
        assert completers() == ["tg-serve-completer[lc2]"]
    assert completers() == []


def test_pipeline_depth_env_knob(monkeypatch):
    monkeypatch.setenv("TG_SERVE_PIPELINE", "1")
    assert ServeConfig.from_env().pipeline_depth == 1
    monkeypatch.setenv("TG_SERVE_PIPELINE", "4")
    assert ServeConfig.from_env().pipeline_depth == 4
    monkeypatch.setenv("TG_SERVE_PIPELINE", "0")
    assert ServeConfig.from_env().pipeline_depth == 1


@pytest.mark.chaos
def test_complete_chaos_counts_against_dispatching_flush(model):
    """serve.complete chaos surfaces in the completer but feeds the
    breaker as a dispatch failure would; the flush degrades to the eager
    records, which equal the clean ones."""
    row = _rows(1, seed=4)[0]
    eager = score_function(model)(row)
    with faults.injected({"serve.complete": {
            "mode": "raise", "nth": 1, "count": 2, "transient": True}}):
        with ServingRuntime(model, "cc", _cfg(2, max_wait_ms=1.0)) as rt:
            r1 = rt.score(row, timeout=30)
            assert rt.breaker.snapshot()["consecutiveFailures"] == 1
            r2 = rt.score(row, timeout=30)
            assert rt.breaker.snapshot()["consecutiveFailures"] == 2
            r3 = rt.score(row, timeout=30)
            assert rt.breaker.snapshot()["consecutiveFailures"] == 0
    assert r1 == eager and r2 == eager and r3 == eager
    degraded = rt.fault_log.of_kind("breaker_degraded")
    assert {r.site for r in degraded} == {"serve.complete"}
    assert rt.summary()["degradedRows"] == 2.0
    assert rt.summary()["rowsScored"] == 3.0


@pytest.mark.chaos
def test_flush_and_dispatch_chaos_at_depth_2(model):
    row = _rows(1, seed=5)[0]
    eager = score_function(model)(row)
    with faults.injected({
            "serve.flush": {"mode": "raise", "nth": 1, "count": 1,
                            "transient": True},
            "serve.dispatch": {"mode": "raise", "nth": 1, "count": 1,
                               "transient": True}}):
        with ServingRuntime(model, "fd2", _cfg(2, max_wait_ms=1.0)) as rt:
            r1 = rt.score(row, timeout=30)   # flush fault: no breaker hit
            assert rt.breaker.snapshot()["consecutiveFailures"] == 0
            r2 = rt.score(row, timeout=30)   # dispatch fault: breaker hit
            assert rt.breaker.snapshot()["consecutiveFailures"] == 1
            r3 = rt.score(row, timeout=30)
    assert r1 == eager and r2 == eager and r3 == eager
    sites = [r.site for r in rt.fault_log.of_kind("breaker_degraded")]
    assert sorted(sites) == ["serve.dispatch", "serve.flush"]
    assert rt.summary()["rowsScored"] == 3.0
    assert rt.summary()["degradedRows"] == 2.0


@pytest.mark.chaos
def test_oom_downshift_drains_pipeline_and_recovers(model):
    """oom.serve at depth 2: the downshift ladder runs in the completer
    (the halves bit-equal), the runtime backs off to serial for one clean
    flush, then pipelines again; resource faults never feed the breaker."""
    rows = _rows(8, seed=21)
    baseline = micro_batch_score_function(model)(list(rows))
    with faults.injected({"oom.serve": {"mode": "oom", "nth": 1,
                                        "count": 1}}):
        rt = ServingRuntime(model, "oo2", _cfg(2), auto_start=False)
        try:
            futs = [rt.submit(r) for r in rows]
            rt.start()
            recs = [f.result(timeout=30) for f in futs]
            assert recs == baseline
            assert rt.summary()["faults"]["oomDownshifts"] == 1
            assert rt.breaker.snapshot()["consecutiveFailures"] == 0
            again = [rt.score(r, timeout=30) for r in rows[:2]]
            assert again == baseline[:2]
            assert not rt._oom_serial
        finally:
            rt.close()
    assert rt.summary()["rowsScored"] == 10.0
    assert rt.summary()["degradedRows"] == 0.0


@pytest.mark.chaos
def test_oom_downshift_halves_to_singletons(model):
    """Armed for every halving of an 8-row flush, oom.serve splits it down
    to a singleton: zero failed requests, records bit-equal, 3 downshifts,
    the breaker closed."""
    rows = _rows(8, seed=22)
    baseline = micro_batch_score_function(model)(list(rows))
    with faults.injected({"oom.serve": {"mode": "oom", "nth": 1,
                                        "count": 3}}):
        rt = ServingRuntime(model, "oo1", _cfg(2), auto_start=False)
        try:
            futs = [rt.submit(r) for r in rows]
            rt.start()
            recs = [f.result(timeout=30) for f in futs]
            summ = rt.summary()
        finally:
            rt.close()
    assert recs == baseline
    assert summ["faults"]["oomDownshifts"] == 3
    assert summ["degradedRows"] == 0.0 and summ["breaker"]["opens"] == 0


@pytest.mark.chaos
def test_breaker_open_drains_pipeline_and_serves_serially(model):
    clk = [0.0]
    br = CircuitBreaker(name="bo2", failure_threshold=2, reset_after=10.0,
                        clock=lambda: clk[0])
    row = _rows(1, seed=6)[0]
    eager = score_function(model)(row)
    with faults.injected({"serve.dispatch": {
            "mode": "raise", "nth": 1, "count": 2, "transient": True}}):
        with ServingRuntime(model, "bo2", _cfg(2, max_wait_ms=1.0),
                            breaker=br) as rt:
            r1 = rt.score(row, timeout=30)
            r2 = rt.score(row, timeout=30)
            assert br.state == "open"
            r3 = rt.score(row, timeout=30)   # open: serial eager path
            assert br.state == "open"
            clk[0] = 20.0                    # past reset_after
            r4 = rt.score(row, timeout=30)   # the half-open probe closes
            assert br.state == "closed"
    assert r1 == eager and r2 == eager and r3 == eager and r4 == eager
    assert rt.summary()["rowsScored"] == 4.0


def test_cancelled_future_is_typed_shed_not_silent_drop(model):
    """A future cancelled after enqueue lands in the typed ``cancelled``
    shed bucket, so submitted = completed + typed sheds holds."""
    rt = ServingRuntime(model, "cx", _cfg(2), auto_start=False)
    try:
        futs = [rt.submit(r) for r in _rows(3, seed=9)]
        assert futs[1].cancel()
        rt.start()
        assert futs[0].result(timeout=30) is not None
        assert futs[2].result(timeout=30) is not None
    finally:
        rt.close()                      # drains: every flush accounted
    summ = rt.summary()
    assert summ["shed"]["cancelled"] == 1.0
    assert summ["rowsScored"] == 2.0
    assert rt.metrics.snapshot()["tg_serve_shed_total"][
        "model=cx,reason=cancelled"] == 1.0
