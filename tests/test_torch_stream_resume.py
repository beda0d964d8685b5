"""Kill and resume of the port's streamed train (``streaming.trainer``,
``streaming.checkpoint``, ``persistence`` stage checkpoints,
``manifest.RunSentinel``, ``robustness``) on the CPU, mirroring the chaos
cases of ``tests/test_streaming.py`` and ``tests/test_stream_engine.py``
on their inputs: a kill at each of ``stream.read``, ``stream.upload``,
``stream.fold``, ``stream.cache``, ``preempt.stage_fit`` and
``preempt.checkpoint_write`` resumes to the unkilled train's trees, which
are the JAX package's bit for bit; so do a double preemption, a corrupt
fold checkpoint (reported and refolded), a kill while a downshifted pass
folds and a kill in a pass of 4 workers; a checkpoint directory left by a
killed JAX train resumes in the port to the JAX package's trees. The site
registry, the fired counts of one schedule and ``classify_exhaustion``
are the JAX package's.
"""
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import transmogrifai_tpu as jtg
from transmogrifai_tpu import streaming as jstream
from transmogrifai_tpu import types as jtypes
from transmogrifai_tpu.features import FeatureBuilder as JFB
from transmogrifai_tpu.features import reset_uids as jreset
from transmogrifai_tpu.impl.preparators.sanity_checker import (
    SanityChecker as JSanityChecker,
)
from transmogrifai_tpu.robustness import faults as jfaults
from transmogrifai_tpu.robustness import resources as jresources
from transmogrifai_tpu.table import Column as JColumn
from transmogrifai_tpu.table import FeatureTable as JTable
from transmogrifai_tpu.workflow import OpWorkflow as JWorkflow

from transmogrifai_tpu_torch import testing as T
from transmogrifai_tpu_torch.manifest import SENTINEL_FILE
from transmogrifai_tpu_torch.robustness import faults, resources
from transmogrifai_tpu_torch.robustness.faults import SimulatedPreemption
from transmogrifai_tpu_torch.streaming import feed as feed_mod

pytestmark = [pytest.mark.stream, pytest.mark.chaos]

JNS = SimpleNamespace(
    FeatureBuilder=JFB, transmogrify=jtg.transmogrify,
    SanityChecker=JSanityChecker, streaming=jstream, OpWorkflow=JWorkflow,
    Column=JColumn, FeatureTable=JTable, Real=jtypes.Real,
    RealNN=jtypes.RealNN, reset_uids=jreset)
PNS = T.port_stream_namespace()
GBT = dict(problem="binary", num_trees=1, max_depth=2, n_bins=8,
           learning_rate=1.0)


@pytest.fixture(autouse=True)
def _port_stream_threads_end():
    """Every feed a test opens is closed and the port's watchdog scanner
    (which ends with its last heart) has ended before the next test."""
    yield
    from transmogrifai_tpu_torch.robustness import watchdog
    from transmogrifai_tpu_torch.streaming import live_feeds
    leaked = live_feeds()
    for f in leaked:
        f.close()
    watchdog.idle_join(10.0)
    assert not leaked, f"a test left {len(leaked)} feed(s) open"
    assert not watchdog.live_hearts()


def _table(ns, n, d, seed, missing=0.05):
    """``tests/test_streaming.py``'s table, in either package."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    mask = rng.rand(n, d) >= missing
    y = (np.where(mask, X, 0.0)[:, 0] > 0.3).astype(np.float32)
    cols = {f"x{i}": ns.Column(ns.Real, X[:, i], mask[:, i])
            for i in range(d)}
    cols["y"] = ns.Column(ns.RealNN, y, None)
    return ns.FeatureTable(cols, n)


def _workflow(ns, d, ckpt=None):
    ns.reset_uids()
    kw = {"device": "cpu"} if ns is PNS else {}
    wf = ns.OpWorkflow(**kw).set_result_features(T.stream_dag(ns, d, GBT))
    return wf.with_checkpoint_dir(ckpt) if ckpt else wf


def _trees(model):
    return T.streamed_gbt_arrays(T.stage_of(model, "StreamingGBTModel"))


def _same(a, b):
    return sorted(a) == sorted(b) and all(
        np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes() for k in a)


_REFS = {}


def _refs(n, d, seed, chunk_rows):
    """(the port's table, its unkilled trees, the JAX package's trees) of
    one case, computed once."""
    key = (n, d, seed, chunk_rows)
    if key not in _REFS:
        out = []
        for ns in (PNS, JNS):
            table = _table(ns, n, d, seed)
            src = ns.streaming.TableChunkSource(table, chunk_rows=chunk_rows)
            out.append((table, _trees(_workflow(ns, d).train(stream=src))))
        (pt, pref), (_, jref) = out
        assert _same(pref, jref)
        _REFS[key] = (pt, pref, jref)
    return _REFS[key]


def _kill(wf, src, specs, resume=False):
    with pytest.raises(SimulatedPreemption):
        with faults.injected(specs):
            wf.train(resume=resume, stream=src)
    assert not feed_mod.live_feeds()


# ---------------------------------------------------------------------------
# a kill at every site resumes bit-equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("site,nth", [
    ("stream.read", 9), ("stream.upload", 15), ("stream.fold", 22),
    ("stream.read", 1), ("stream.fold", 1), ("preempt.stage_fit", 2),
    ("preempt.stage_fit", 3), ("preempt.checkpoint_write", 2),
])
def test_kill_at_site_resumes_bit_equal(site, nth, tmp_path):
    table, ref, jref = _refs(2000, 6, 11, 300)
    from transmogrifai_tpu_torch.streaming import TableChunkSource
    src = TableChunkSource(table, chunk_rows=300)
    ck = str(tmp_path / "ck")
    _kill(_workflow(PNS, 6, ck), src, {site: {"mode": "preempt",
                                              "nth": nth}})
    resumed = _workflow(PNS, 6, ck).train(resume=True, stream=src)
    assert _same(_trees(resumed), ref) and _same(_trees(resumed), jref)
    res = resumed.summary()["resume"]
    assert res["requested"] is True
    assert sorted(res["restoredStages"] + res["refitStages"]) == sorted(
        resumed._fitted_stage_uids)
    if site == "preempt.checkpoint_write":
        # the torn stage write is debris: reported, the stage refits
        skipped = resumed.summary()["faults"]["checkpointsSkipped"]
        assert any(r["site"] == "persistence.checkpoint" for r in skipped)
    assert not os.path.exists(os.path.join(ck, SENTINEL_FILE))


def test_kill_at_stream_cache_resumes_bit_equal(tmp_path, monkeypatch):
    """A preemption inside a cache lookup (a pass replaying cached chunks
    from the disk tier) escapes the cache's fallback and resumes
    bit-exactly."""
    monkeypatch.setenv("TG_STREAM_CACHE_DIR", str(tmp_path / "cache"))
    table, ref, jref = _refs(1400, 5, 31, 200)
    from transmogrifai_tpu_torch.streaming import TableChunkSource
    src = TableChunkSource(table, chunk_rows=200)
    ck = str(tmp_path / "ck")
    _kill(_workflow(PNS, 5, ck), src,
          {"stream.cache": {"mode": "preempt", "nth": 25}})
    resumed = _workflow(PNS, 5, ck).train(resume=True, stream=src)
    assert _same(_trees(resumed), ref) and _same(ref, jref)
    assert resumed.summary()["streaming"]["cache"]["diskHits"] > 0


def test_kill_mid_parallel_pass_resumes_bit_equal(tmp_path, monkeypatch):
    monkeypatch.setenv("TG_STREAM_WORKERS", "4")
    monkeypatch.setenv("TG_STREAM_PREFETCH", "4")
    table, ref, jref = _refs(1800, 5, 37, 200)
    from transmogrifai_tpu_torch.streaming import TableChunkSource
    src = TableChunkSource(table, chunk_rows=200)
    ck = str(tmp_path / "ck")
    _kill(_workflow(PNS, 5, ck), src,
          {"stream.read": {"mode": "preempt", "nth": 7}})
    resumed = _workflow(PNS, 5, ck).train(resume=True, stream=src)
    assert _same(_trees(resumed), ref) and _same(ref, jref)


def test_double_preemption_still_bit_equal(tmp_path):
    table, ref, jref = _refs(1500, 5, 13, 250)
    from transmogrifai_tpu_torch.streaming import TableChunkSource
    src = TableChunkSource(table, chunk_rows=250)
    ck = str(tmp_path / "ck")
    for nth in (5, 3):
        _kill(_workflow(PNS, 5, ck), src,
              {"stream.fold": {"mode": "preempt", "nth": nth}},
              resume=os.path.exists(os.path.join(ck, "MANIFEST.json")))
    resumed = _workflow(PNS, 5, ck).train(resume=True, stream=src)
    assert _same(_trees(resumed), ref) and _same(ref, jref)


def test_corrupt_stream_checkpoint_detected_and_refolded(tmp_path):
    """A truncated fold state fails its checksum: reported, the pass
    refolds from the start, the model is the same."""
    table, ref, jref = _refs(1200, 4, 17, 200)
    from transmogrifai_tpu_torch.streaming import TableChunkSource
    src = TableChunkSource(table, chunk_rows=200)
    ck = str(tmp_path / "ck")
    _kill(_workflow(PNS, 4, ck), src,
          {"stream.fold": {"mode": "preempt", "nth": 20}})
    corrupted = 0
    for fname in os.listdir(ck):
        if fname.startswith("stream_"):
            path = os.path.join(ck, fname)
            with open(path, "rb") as fh:
                data = fh.read()
            with open(path, "wb") as fh:
                fh.write(data[: max(1, len(data) // 2)])
            corrupted += 1
    assert corrupted
    resumed = _workflow(PNS, 4, ck).train(resume=True, stream=src)
    assert _same(_trees(resumed), ref) and _same(ref, jref)
    skipped = resumed.summary()["faults"]["checkpointsSkipped"]
    assert any(r["site"] == "stream.checkpoint" for r in skipped)


def test_kill_during_downshifted_stream_resumes_bit_equal(tmp_path):
    """An ``oom.stream`` fault halves the chunk rows mid-pass (400 ->
    200); a kill while the halved grid folds resumes on that grid (the
    record carries its ``chunkRows``) to the uninterrupted downshifted
    train's trees, which are the JAX package's under the same fault."""
    from transmogrifai_tpu_torch.streaming import TableChunkSource
    table = _table(PNS, 2000, 5, 19)
    oom = {"oom.stream": {"mode": "oom", "nth": 2}}
    with faults.injected(oom):
        ref_model = _workflow(PNS, 5).train(
            stream=TableChunkSource(table, chunk_rows=400))
    downs = ref_model.summary()["faults"]["oomDownshifts"]
    assert downs and downs[0]["detail"]["chunkRows"] == 200
    with jfaults.injected(oom):
        jref = _trees(_workflow(JNS, 5).train(
            stream=jstream.TableChunkSource(_table(JNS, 2000, 5, 19),
                                            chunk_rows=400)))
    ref = _trees(ref_model)
    assert _same(ref, jref)
    ck = str(tmp_path / "ck")
    _kill(_workflow(PNS, 5, ck), TableChunkSource(table, chunk_rows=400),
          {**oom, "stream.fold": {"mode": "preempt", "nth": 5}})
    with open(os.path.join(ck, "MANIFEST.json")) as fh:
        manifest = json.load(fh)
    assert any(rec.get("chunkRows") == 200
               for rec in manifest.get("streams", {}).values())
    resumed = _workflow(PNS, 5, ck).train(
        resume=True, stream=TableChunkSource(table, chunk_rows=400))
    assert _same(_trees(resumed), ref)
    restored = resumed.summary()["faults"]["restored"]
    assert any(r["detail"].get("chunkRows") == 200 for r in restored)


def test_a_jax_checkpoint_directory_resumes_in_the_port(tmp_path):
    """A JAX package's streamed train killed mid-pass leaves stage
    checkpoints and fold states; the port resumes from them (the
    manifest, the npz states and the stage descriptors are the same
    format) to the JAX package's trees."""
    table, ref, jref = _refs(2000, 6, 11, 300)
    from transmogrifai_tpu_torch.streaming import TableChunkSource
    for site, nth in (("stream.fold", 22), ("stream.fold", 9)):
        ck = str(tmp_path / f"ck{nth}")
        jwf = _workflow(JNS, 6, ck)
        with pytest.raises(jfaults.SimulatedPreemption):
            with jfaults.injected({site: {"mode": "preempt", "nth": nth}}):
                jwf.train(stream=jstream.TableChunkSource(
                    _table(JNS, 2000, 6, 11), chunk_rows=300))
        resumed = _workflow(PNS, 6, ck).train(
            resume=True, stream=TableChunkSource(table, chunk_rows=300))
        assert _same(_trees(resumed), jref)
        faults_ = resumed.summary()["faults"]
        assert faults_["restored"] and not faults_["checkpointsSkipped"]


def test_an_unclean_exit_of_another_process_is_recorded(tmp_path):
    table, ref, _ = _refs(1200, 4, 17, 200)
    from transmogrifai_tpu_torch.streaming import TableChunkSource
    ck = str(tmp_path / "ck")
    os.makedirs(ck)
    with open(os.path.join(ck, SENTINEL_FILE), "w") as fh:
        json.dump({"pid": -1, "phase": "device_upload"}, fh)
    resumed = _workflow(PNS, 4, ck).train(
        resume=True, stream=TableChunkSource(table, chunk_rows=200))
    unclean = resumed.summary()["faults"]["uncleanExits"]
    assert unclean and unclean[0]["detail"]["oomKillSuspected"] is True
    assert _same(_trees(resumed), ref)


# ---------------------------------------------------------------------------
# the registry and the classification
# ---------------------------------------------------------------------------

def test_site_registry_is_the_jax_packages():
    assert sorted(faults.ALL_SITES) == sorted(jfaults.ALL_SITES)
    for name, spec in jfaults.ALL_SITES.items():
        mine = faults.ALL_SITES[name]
        assert (mine.modes, mine.module, mine.scenarios, mine.bit_equal) == \
            (spec.modes, spec.module, spec.scenarios, spec.bit_equal), name


def test_fired_counts_are_the_jax_packages_under_one_schedule():
    """One schedule over a streamed train in each package: the same
    faults fire the same number of times, and the recovered models are
    the same."""
    schedule = {"oom.stream": {"mode": "oom", "nth": 2},
                "stream.cache": {"mode": "raise", "nth": 3, "count": 4},
                "stream.upload": {"mode": "raise", "nth": 99}}
    counts, trees = [], []
    for ns, mod in ((JNS, jfaults), (PNS, faults)):
        src = ns.streaming.TableChunkSource(_table(ns, 1200, 4, 17),
                                            chunk_rows=200)
        with mod.injected(schedule):
            m = _workflow(ns, 4).train(stream=src)
            counts.append(mod.fired_counts())
        trees.append(_trees(m))
    assert counts[0] == counts[1] == {"oom.stream": {"oom": 1},
                                      "stream.cache": {"raise": 4}}
    assert _same(*trees)
    assert faults.fired_counts() == {} and faults.active_sites() == []


def test_the_env_schedule_needs_the_chaos_gate(monkeypatch):
    monkeypatch.setattr(faults, "_ENV_LOADED", False)
    monkeypatch.setenv("TG_FAULTS", json.dumps(
        {"stream.read": {"mode": "raise", "nth": 1}}))
    monkeypatch.delenv("TG_CHAOS", raising=False)
    assert faults.active_sites() == []
    monkeypatch.setattr(faults, "_ENV_LOADED", False)
    monkeypatch.setenv("TG_CHAOS", "1")
    try:
        assert faults.active_sites() == ["stream.read"]
        with pytest.raises(faults.TransientFaultError):
            faults.inject("stream.read")
    finally:
        faults.clear()


@pytest.mark.parametrize("exc,typed", [
    ("cuda_oom", True), ("runtime_oom", True), ("memory", True),
    ("enomem", True), ("typed", True), ("other_runtime", False),
    ("value", False),
])
def test_classify_exhaustion(exc, typed):
    import errno
    made = {
        "cuda_oom": lambda: torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 2.00 GiB"),
        "runtime_oom": lambda: RuntimeError(
            "CUDA error: out of memory"),
        "memory": lambda: MemoryError("host"),
        "enomem": lambda: OSError(errno.ENOMEM, "Cannot allocate memory"),
        "typed": lambda: resources.ResourceExhaustedError("x"),
        "other_runtime": lambda: RuntimeError("device-side assert"),
        "value": lambda: ValueError("out of memory"),
    }[exc]()
    got = resources.classify_exhaustion(made)
    assert (got is not None) == typed
    if typed:
        assert isinstance(got, resources.ResourceExhaustedError)
    if exc not in ("cuda_oom", "typed"):
        # the JAX package classifies the same host and message cases
        assert (jresources.classify_exhaustion(made) is not None) == typed
    from transmogrifai_tpu_torch.robustness.policy import is_transient_error
    assert not (typed and is_transient_error(made))


def test_retry_policy_retries_a_transient_stage_fit(tmp_path):
    from transmogrifai_tpu_torch.robustness.policy import RetryPolicy
    table, ref, _ = _refs(1200, 4, 17, 200)
    from transmogrifai_tpu_torch.streaming import TableChunkSource
    wf = _workflow(PNS, 4).with_fault_policy(
        RetryPolicy(max_retries=2, base_delay=0.0, jitter=0.0))
    with faults.injected({"stream.fold": {"mode": "raise", "nth": 3}}):
        m = wf.train(stream=TableChunkSource(table, chunk_rows=200))
    retries = m.summary()["faults"]["retries"]
    assert retries and retries[0]["retries"] == 1
    assert _same(_trees(m), ref)


@pytest.mark.parametrize("index", [2, None])
def test_poison_is_the_jax_packages(index):
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    spec = {"validator.fold_metrics": {"mode": "nan", "nth": 2,
                                       "index": index}}
    out = []
    for mod in (jfaults, faults):
        with mod.injected(spec):
            first = mod.poison("validator.fold_metrics", arr)
            second = mod.poison("validator.fold_metrics", arr)
            out.append((first, second, mod.fired_counts()))
    (jf, js, jc), (pf, ps, pc) = out
    assert pf is arr and jf is arr            # the first call is inert
    assert np.array_equal(ps, js, equal_nan=True) and ps.dtype == js.dtype
    assert pc == jc == {"validator.fold_metrics": {"nan": 1}}
