"""The PyTorch port's multi-model placement against the JAX package
(``transmogrifai_tpu_torch/serving/placement.py``; the cases of
``tests/test_placement.py`` on the port's CPU path).

The placer's decisions are pure bookkeeping, so they are held equal to
the JAX package's: first-fit-decreasing plans, LRU victims and their
tie-breaks, ``model_cost_bytes`` on a JAX-saved fixture (its MANIFEST
``costs`` rows, which the JAX package measured) and the blind admission
of a port-saved model (the port writes no cost rows of its own: ROADMAP
Queue 1 item 3). The front door's paging runs on the committed
``serve64/rf`` and ``serve64/gbt`` (64 predictors), records bit-equal to
the micro-batch scorer on ``rf``. Nothing waits on the host's speed: the
single-flight storm gates its leader on the arrivals it counts, faults
fire by count.
"""
from __future__ import annotations

import os
import shutil
import sys
import threading

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest
import jax  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import transmogrifai_tpu_torch as port  # noqa: E402
from transmogrifai_tpu_torch import plan  # noqa: E402
from transmogrifai_tpu_torch.local.scoring import (  # noqa: E402
    micro_batch_score_function,
)
from transmogrifai_tpu_torch.observability import blackbox as _blackbox  # noqa: E402
from transmogrifai_tpu_torch.observability import ledger as lg  # noqa: E402
from transmogrifai_tpu_torch.observability import postmortem as pm  # noqa: E402
from transmogrifai_tpu_torch.robustness import faults, oracles  # noqa: E402
from transmogrifai_tpu_torch.robustness.faults import ALL_SITES  # noqa: E402
from transmogrifai_tpu_torch.robustness.policy import FaultLog  # noqa: E402
from transmogrifai_tpu_torch.serving import (  # noqa: E402
    FleetConfig, FrontDoor, NetEdge, PlaceConfig, Placer,
    PlacementRefusedError, ServeConfig, UnknownModelError, WireClient,
    live_placers, model_cost_bytes,
)
from transmogrifai_tpu_torch.serving import placement as placement_mod  # noqa: E402
from transmogrifai_tpu_torch.serving.loadgen import run_open_loop  # noqa: E402
from transmogrifai_tpu_torch.testing import (  # noqa: E402
    close_serving_state, request_rows, score_frame,
)

from transmogrifai_tpu.serving import placement as jax_placement  # noqa: E402

pytestmark = pytest.mark.density

SERVE64 = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures",
                       "serve64")


@pytest.fixture(autouse=True)
def _clean_serving(tmp_path, monkeypatch):
    monkeypatch.setenv("TG_POSTMORTEM_DIR", str(tmp_path / "postmortems"))
    yield
    leaks = close_serving_state()
    assert not leaks, f"the test leaked serving state: {leaks}"


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Copies of ``serve64/{rf,gbt}`` and a port save of the rf."""
    root = tmp_path_factory.mktemp("place")
    out = {}
    for key in ("rf", "gbt"):
        out[key] = str(root / key)
        shutil.copytree(os.path.join(SERVE64, key), out[key])
    out["port_rf"] = str(root / "port_rf")
    port.load_model(out["rf"], device="cpu").save(out["port_rf"])
    return out


@pytest.fixture(scope="module")
def rf(saved):
    return port.load_model(saved["rf"], device="cpu")


def _rows(n=6, seed=57):
    return request_rows(score_frame(n, 64, seed))


def _cfg(**kw):
    base = dict(max_batch=64, max_queue=256, max_wait_ms=10.0)
    base.update(kw)
    return ServeConfig(**base)


def _fc(**kw):
    base = dict(min_replicas=1, max_replicas=4, probe_interval_ms=0.0,
                probe_failures=3, readmit_probes=2, max_failovers=2,
                autoscale=False, device="cpu")
    base.update(kw)
    return FleetConfig(**base)


def _noop(_m):
    return None


def test_place_sites_registered():
    for site in ("place.assign", "place.evict", "place.pagein"):
        spec = ALL_SITES[site]
        assert "density" in spec.scenarios and spec.modes == ("raise",)
        assert spec.module == "serving/placement.py" and spec.bit_equal


# -- costs and admission: the JAX package's numbers ---------------------------

def test_model_cost_bytes_of_a_jax_saved_fixture(saved):
    """``serve64/gbt`` carries two cost rows measured by the JAX package
    (XLA, bucket 4096): the predicted bytes are their sum, in both
    packages."""
    got = model_cost_bytes(saved["gbt"])
    assert got == jax_placement.model_cost_bytes(saved["gbt"])
    assert got == 4464640 + 1138688
    assert model_cost_bytes(object()) is None
    assert model_cost_bytes(saved["rf"]) == \
        jax_placement.model_cost_bytes(saved["rf"])


def test_a_port_saved_model_is_blind_admitted_as_in_the_jax_package(saved):
    """The port writes no cost rows, so under a byte budget its saves are
    blind-admitted: the same snapshot and FaultLog kinds as the JAX
    package's placer over the same directories."""
    snaps = []
    for mod in (placement_mod, jax_placement):
        with mod.Placer({"blind": saved["port_rf"], "gbt": saved["gbt"]},
                        mod.PlaceConfig(device_budget=10 ** 7),
                        name="t") as p:
            assert p.bytes["blind"] is None and "blind" in p.blind
            p.check_admitted("blind")
            kinds = [r.kind for r in p.fault_log.reports]
            assert kinds == ["placement_blind_admit"]
            snaps.append((p.snapshot(), p.plan(["r0", "r1"])))
    assert snaps[0] == snaps[1]


def test_oversized_model_refused_typed(monkeypatch):
    monkeypatch.setattr(placement_mod, "model_cost_bytes",
                        lambda src: {"big": 100, "small": 10}[src])
    log = FaultLog()
    with Placer({"big": "big", "small": "small"},
                PlaceConfig(device_budget=50), name="t",
                fault_log=log) as p:
        assert p.refused == {"big"}
        with pytest.raises(PlacementRefusedError):
            p.check_admitted("big")
        p.check_admitted("small")
        assert "placement_refused" in [r.kind for r in log.reports]
        assert "big" not in {m for ms in p.plan(["r0"]).values()
                             for m in ms}


# -- bin-packing and LRU: equal to the JAX package's --------------------------

@pytest.mark.parametrize("sizes,budget,warm,rids", [
    ({"a": 30, "b": 50, "c": 20, "d": 50}, 80, 0, ["r0", "r1"]),
    ({"a": 30, "b": 50, "c": 20, "d": 50, "e": 10}, 60, 2, ["r0", "r1"]),
    ({"m1": 7, "m2": 7, "m3": 7, "m4": 3, "m5": None}, 14, 0,
     ["r0", "r1", "r2"]),
    ({"x": 5, "y": 5, "z": 5}, 0, 1, ["r1", "r0"]),
])
def test_plan_first_fit_decreasing_equals_the_jax_packages(
        monkeypatch, sizes, budget, warm, rids):
    plans = []
    for mod in (placement_mod, jax_placement):
        monkeypatch.setattr(mod, "model_cost_bytes", lambda s: sizes[s])
        with mod.Placer({m: m for m in sizes},
                        mod.PlaceConfig(device_budget=budget,
                                        max_warm=warm), name="t") as p:
            plan = p.plan(rids)
            plans.append((plan, p.assign_new("r9"), p.snapshot()))
    assert plans[0] == plans[1]
    if sizes == {"a": 30, "b": 50, "c": 20, "d": 50}:
        assert plans[0][0] == {"r0": ["a", "b"], "r1": ["c", "d"]}


def test_lru_victim_tiebreak_equals_the_jax_packages():
    seen = []
    for mod in (placement_mod, jax_placement):
        with mod.Placer({m: None for m in ("c", "a", "b")},
                        mod.PlaceConfig(), name="t") as p:
            for m in ("a", "b", "c"):
                p.note_resident("r0", m)
            order = [p.victim("r0")]
            p.touch("a")
            order.append(p.victim("r0"))
            p.touch("b")
            order += [p.victim("r0"), p.victim("r0", exclude={"c"})]
            seen.append(order)
    assert seen[0] == seen[1] == ["a", "b", "c", "a"]


def test_evict_mid_pagein_refused_typed():
    gate, entered = threading.Event(), threading.Event()

    def _block_load(_m):
        entered.set()
        assert gate.wait(30.0)

    with Placer({"a": None}, PlaceConfig(), name="t") as p:
        t = threading.Thread(
            target=lambda: p.page_in("r0", "a", _block_load, _noop),
            daemon=True)
        t.start()
        assert entered.wait(30.0)
        assert p.paging("r0", "a")
        with pytest.raises(PlacementRefusedError):
            p.evict("r0", "a", _noop)
        gate.set()
        t.join(timeout=30.0)
        assert p.is_resident("r0", "a") and not p.inflight()


def test_evict_protected_model_skipped():
    with Placer({"a": None, "b": None}, PlaceConfig(protect_slo=True),
                name="t", protect=lambda m: m == "a") as p:
        p.note_resident("r0", "a")
        p.note_resident("r0", "b")
        assert p.victim("r0") == "b"
        p.touch("b")
        assert p.victim("r0") == "b"


def test_single_flight_under_thread_storm():
    """16 threads demand the same cold model; the leader's load waits until
    every thread has arrived, so all contend for the one page-in: exactly
    one load, every caller sees the model warm."""
    n = 16
    calls, arrived = [], [0]
    cond = threading.Condition()

    def _load(m):
        calls.append(m)
        with cond:
            assert cond.wait_for(lambda: arrived[0] == n, timeout=30.0)

    with Placer({"m": None}, PlaceConfig(), name="t") as p:
        results = [None] * n

        def _run(i):
            with cond:
                arrived[0] += 1
                cond.notify_all()
            results[i] = p.page_in("r0", "m", _load, _noop)
        threads = [threading.Thread(target=_run, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
        assert calls == ["m"] and results == [True] * n
        assert not p.inflight()


# -- the front door's paging ---------------------------------------------------

def test_unknown_model_is_typed_client_error(rf):
    with FrontDoor({"m": rf}, replicas=1, config=_cfg(), fleet_config=_fc(),
                   placement=PlaceConfig(max_warm=2)) as fd:
        with pytest.raises(UnknownModelError):
            fd.submit(_rows(1)[0], model="nope")
        fs = fd.fleet_snapshot()
        assert fs["submitted"] == 0
        assert fs["sheds"].get("unknown_model", 0) == 1


def test_evict_then_request_pages_back_bit_equal(saved, rf):
    """max_warm=1 over two saved models on one replica: demand for the
    cold one evicts the other and pages it in, and back, every record
    bit-equal, with no kernel build on the way (the CPU path builds
    none); the page-in's warm pass builds the model's serve plan and
    nothing else (the JAX package loads it from its program store, which
    the port does not have yet: ROADMAP Queue 1 item 10)."""
    rows = _rows(6)
    baseline = micro_batch_score_function(rf)(rows)
    with FrontDoor({"a": saved["rf"], "b": saved["port_rf"]}, replicas=1,
                   config=_cfg(), fleet_config=_fc(), warm=True,
                   placement=PlaceConfig(max_warm=1)) as fd:
        pl = fd.placer
        assert pl.residents("r0") == ["a"]
        assert pl.snapshot()["cold"] == ["b"]
        assert fd.submit(rows[0], model="a").result(30) == baseline[0]
        mark = lg.ledger().mark()
        recs = [fd.submit(r, model="b").result(30) for r in rows]
        assert recs == baseline
        # the page-in's builds: the serve plan of b's stages, then each of
        # its segments at one bucket, and nothing else
        stages = fd._replicas["r0"].registry.runtime("b").model.stages
        ident = "plan/" + ",".join(s.uid for s in stages)
        (served,) = [p for p, held in plan._PLAN_CACHE.values()
                     if p is not None and len(held) == len(stages)
                     and all(h is s for h, s in zip(held, stages))]
        built = lg.ledger().since(mark)
        assert len(built) == 1 + served.num_segments
        assert built[0].identity.startswith(ident + "/ki=0/ek=")
        assert [r.identity for r in built[1:]] == [
            f"{ident}/seg{i}" for i in range(served.num_segments)]
        assert len({r.bucket for r in built[1:]}) == 1
        assert pl.residents("r0") == ["b"]
        snap = pl.snapshot()
        assert snap["pageIns"] >= 1 and snap["evictions"] >= 1
        assert snap["pageInP99Ms"] is not None
        kinds = [r.kind for r in fd.fault_log.reports]
        assert "placement_evicted" in kinds and "placement_paged_in" in kinds
        assert fd.submit(rows[1], model="a").result(30) == baseline[1]
        rt = fd._replicas["r0"].registry.runtime("a")
        assert str(rt.model.device) == "cpu"


def test_warm_copy_kill_pages_in_on_survivor(saved, rf):
    rows = _rows(8)
    baseline = micro_batch_score_function(rf)(rows)
    with FrontDoor({"a": saved["rf"], "b": saved["port_rf"]}, replicas=2,
                   config=_cfg(max_wait_ms=500.0),
                   fleet_config=_fc(min_replicas=2, max_replicas=2),
                   warm=True, placement=PlaceConfig(max_warm=1)) as fd:
        pl = fd.placer
        holders = pl.holders("a")
        assert len(holders) == 1
        victim = holders[0]
        survivor = next(r for r in ("r0", "r1") if r != victim)
        futs = [fd.submit(r, model="a") for r in rows]
        fd.kill_replica(victim)
        assert [f.result(30) for f in futs] == baseline
        assert fd.submit(rows[0], model="a").result(30) == baseline[0]
        assert pl.holders("a") == [survivor]
        lost = [r for r in fd.fault_log.reports if r.kind == "replica_lost"]
        assert lost and lost[0].detail.get("orphanedModels") == ["a"]
        fs = fd.fleet_snapshot()
        assert fs["submitted"] == len(rows) + 1
        assert sum(fs["sheds"].values()) == 0


@pytest.mark.chaos
@pytest.mark.parametrize("site,kind", [
    ("place.pagein", "place_pagein_failed"),
    ("place.evict", "place_evict_failed"),
    ("place.assign", "place_assign_failed")])
def test_place_chaos_resolves_typed_and_bit_equal(saved, rf, site, kind):
    """Each ``place.*`` fault is typed on the FaultLog and the request
    still completes bit-equal: a failed page-in retries within the
    failover budget, a failed eviction is skipped (capacity is advisory),
    a failed assignment leaves the model cold until first demand."""
    rows = _rows(2)
    baseline = micro_batch_score_function(rf)(rows)
    spec = {site: {"mode": "raise", "nth": 1, "count": 1}}
    models = {"a": saved["rf"], "b": saved["port_rf"]}
    if site == "place.assign":
        with faults.injected(spec):
            fd = FrontDoor({"a": saved["rf"]}, replicas=1, config=_cfg(),
                           fleet_config=_fc(), warm=True,
                           placement=PlaceConfig(max_warm=2))
        want = "a"
    else:
        fd = FrontDoor(models, replicas=1, config=_cfg(),
                       fleet_config=_fc(), warm=True,
                       placement=PlaceConfig(max_warm=1))
        want = "b"
    with fd:
        if site == "place.assign":
            assert fd.submit(rows[0], model=want).result(30) == baseline[0]
        else:
            with faults.injected(spec):
                assert fd.submit(rows[0],
                                 model=want).result(30) == baseline[0]
        kinds = [r.kind for r in fd.fault_log.reports]
        assert kind in kinds
        if site == "place.pagein":
            assert "placement_paged_in" in kinds
        if site == "place.evict":
            assert fd.placer.residents("r0") == ["a", "b"]


def test_wire_model_routing_and_unknown_model_404(rf):
    rows = _rows(6)
    baseline = micro_batch_score_function(rf)(rows)
    with FrontDoor({"a": rf, "b": rf}, replicas=1, config=_cfg(),
                   fleet_config=_fc(),
                   placement=PlaceConfig(max_warm=2)) as fd:
        with NetEdge(fd, name="place-edge") as edge:
            for proto in ("http", "binary"):
                with WireClient(*edge.address, protocol=proto) as cli:
                    res = cli.request(rows, model="b")
                    assert res.status == 200 and res.records == baseline
                    assert cli.request(rows, model="nope").status == 404
            shed = sum(v for k, v in edge.metrics.snapshot().get(
                "tg_net_shed_total", {}).items()
                if "reason=unknown_model" in k)
            assert shed >= 2
        assert fd.fleet_snapshot()["sheds"].get("unknown_model", 0) >= 2


def test_loadgen_model_mix_accounting(rf):
    with FrontDoor({"a": rf, "b": rf}, replicas=1, config=_cfg(),
                   fleet_config=_fc(),
                   placement=PlaceConfig(max_warm=2)) as fd:
        report = run_open_loop(fd, _rows(16), seconds=0.5, rps=120.0,
                               models=[("a", 3.0), ("b", 1.0)],
                               model_seed=5)
    assert report["accountingOk"]
    assert report["lost"] == 0 and report["failed"] == 0
    per = report["models"]
    assert sum(b["offered"] for b in per.values()) == report["offered"]
    assert sum(b["completed"] for b in per.values()) == report["completed"]
    assert per["a"]["offered"] > per.get("b", {"offered": 0})["offered"]


def test_postmortem_carries_the_placement_section(tmp_path, monkeypatch):
    monkeypatch.setenv("TG_POSTMORTEM_DIR", str(tmp_path))
    with Placer({"a": None}, PlaceConfig(), name="pmfleet") as p:
        p.note_resident("r0", "a")
        _blackbox.record("place.assign", fleet="pmfleet", model="a",
                         replica="r0")
        path = pm.trigger("campaign_escape", detail={"why": "test"})
        assert path is not None
        doc = pm.read_bundle(path)
    assert doc["schemaVersion"] == pm.SCHEMA_VERSION >= 5
    assert pm.validate_bundle(doc) == []
    assert doc["placement"]["pmfleet"]["resident"] == {"r0": ["a"]}
    broken = dict(doc)
    broken.pop("placement")
    assert any("placement" in pr for pr in pm.validate_bundle(broken))


def test_fleet_snapshot_carries_placement(rf):
    with FrontDoor({"a": rf, "b": rf}, replicas=1, config=_cfg(),
                   fleet_config=_fc(),
                   placement=PlaceConfig(max_warm=2)) as fd:
        snap = fd.fleet_snapshot()
        assert snap["placement"]["fleet"] == fd.name
        assert snap["placement"]["models"] == ["a", "b"]
        assert snap["replicas"]["r0"]["resident"] == ["a", "b"]


def test_subprocess_fleet_disables_placement_typed(saved):
    """Placement needs in-process registries: a subprocess fleet keeps
    its full model set and says so (``placement_unsupported``), as the
    JAX package's does. No replica is spawned here (replicas=0)."""
    fd = FrontDoor({"a": saved["rf"]}, replicas=0, config=_cfg(),
                   fleet_config=_fc(subprocess=True),
                   placement=PlaceConfig(max_warm=1))
    try:
        assert fd.placer is None
        assert [r.kind for r in fd.fault_log.reports] == [
            "placement_unsupported"]
    finally:
        fd.close()


def test_placer_leak_oracle_detects_and_cleans():
    p = Placer({"a": None}, PlaceConfig(), name="leaky")
    assert any("leaky" in v for v in oracles.placement_violations())
    assert "leaky" in oracles.close_leaked_placers()
    assert oracles.placement_violations() == []
    assert p not in live_placers()
