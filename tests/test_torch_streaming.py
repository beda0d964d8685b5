"""The port's out-of-core streaming training (``transmogrifai_tpu_torch.
streaming``, ``histeng.host``) against the JAX package's, on the CPU.

Mirrors ``tests/test_streaming.py`` and the host cases of
``tests/test_histeng.py`` on the same seeded inputs through both packages:
every fold's state bit-equal to the JAX package's under three chunk
schedules, synthetic chunks byte-equal, the Avro chunk source reading a
file the JAX package wrote, the host histogram bit-equal, a streamed train
whose fills, SanityChecker choices, trees and scores are the JAX package's
bit for bit (``summary()["streaming"]`` with the same keys), models saved
by either package scored by the other, and the refusals raising as the JAX
package's do. The committed fixture ``transmogrifai_tpu_torch/fixtures/
stream`` (what ``chip_smoke.py``'s (stream) phase holds the card to) is
regenerated at a small size through both packages. Write the full fixture
with ``python tests/test_torch_streaming.py`` (the JAX package on the CPU,
~3 min).
"""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import transmogrifai_tpu as jtg
from transmogrifai_tpu import streaming as jstream
from transmogrifai_tpu import types as jtypes
from transmogrifai_tpu.features import FeatureBuilder as JFB
from transmogrifai_tpu.features import reset_uids as jreset
from transmogrifai_tpu.histeng import engine as jengine
from transmogrifai_tpu.impl.preparators.sanity_checker import (
    SanityChecker as JSanityChecker,
)
from transmogrifai_tpu.table import Column as JColumn
from transmogrifai_tpu.table import FeatureTable as JTable
from transmogrifai_tpu.workflow import OpWorkflow as JWorkflow
from transmogrifai_tpu.workflow import OpWorkflowModel as JModel

import transmogrifai_tpu_torch as ptg
from transmogrifai_tpu_torch import histeng as phist
from transmogrifai_tpu_torch import streaming as pstream
from transmogrifai_tpu_torch import testing as T
from transmogrifai_tpu_torch.features import FeatureBuilder as PFB
from transmogrifai_tpu_torch.workflow import OpWorkflow as PWorkflow
from transmogrifai_tpu_torch.workflow import OpWorkflowModel as PModel

pytestmark = pytest.mark.stream

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures", "stream")

JNS = SimpleNamespace(
    FeatureBuilder=JFB, transmogrify=jtg.transmogrify,
    SanityChecker=JSanityChecker, streaming=jstream, OpWorkflow=JWorkflow,
    Column=JColumn, FeatureTable=JTable, Real=jtypes.Real,
    RealNN=jtypes.RealNN, reset_uids=jreset)
PNS = T.port_stream_namespace()
PKG = {"jax": JNS, "port": PNS}


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


def _table(ns, n=3000, d=8, seed=0, missing=0.05):
    """``tests/test_streaming.py``'s table, in either package."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    mask = rng.rand(n, d) >= missing
    y = (np.where(mask, X, 0.0)[:, 0] > 0.3).astype(np.float32)
    cols = {f"x{i}": ns.Column(ns.Real, X[:, i], mask[:, i])
            for i in range(d)}
    cols["y"] = ns.Column(ns.RealNN, y, None)
    return ns.FeatureTable(cols, n), X, mask, y


def _train(ns, table, d, chunk_rows, gbt=None, **kw):
    ns.reset_uids()
    wf = ns.OpWorkflow(**kw).set_result_features(T.stream_dag(ns, d, gbt))
    src = ns.streaming.TableChunkSource(table, chunk_rows=chunk_rows)
    return wf.train(stream=src), src


def _schedules(n, seed=0):
    """The whole-table schedule and two random contiguous partitions."""
    rng = np.random.RandomState(seed)
    out = [[(0, n)]]
    for _ in range(2):
        cuts = np.sort(rng.choice(np.arange(1, n), size=5, replace=False))
        pts = [0] + cuts.tolist() + [n]
        out.append(list(zip(pts[:-1], pts[1:])))
    return out


def _assert_states_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


# ---------------------------------------------------------------------------
# folds: the JAX package's state bits under every schedule
# ---------------------------------------------------------------------------

def _fold_case(name, mod):
    rng = np.random.RandomState(3)
    n, d = 2400, 5
    X = rng.randn(n, d).astype(np.float32)
    mask = rng.rand(n, d) >= 0.1
    y = (X[:, 0] > 0.2).astype(np.float32)
    ind = (rng.rand(n, 4) < 0.3).astype(np.float32)
    lab = rng.randint(0, 3, size=n).astype(np.float32)
    if name == "colstats":
        return mod.ColStatsFold(d), lambda lo, hi: (X[lo:hi], mask[lo:hi])
    if name == "colstats_rowmask":
        return (mod.ColStatsFold(d),
                lambda lo, hi: (X[lo:hi], mask[lo:hi, 0]))
    if name == "correlation":
        return (mod.CorrelationFold(d, full=True),
                lambda lo, hi: (X[lo:hi], y[lo:hi]))
    if name == "correlation_masked":
        return (mod.CorrelationFold(d),
                lambda lo, hi: (X[lo:hi], y[lo:hi], mask[lo:hi, 1]))
    if name == "contingency":
        return (mod.ContingencyFold(4),
                lambda lo, hi: (ind[lo:hi], lab[lo:hi]))
    if name == "histogram":
        return (mod.HistogramFold(d, max_bins=16, sample_stride=3),
                lambda lo, hi: (X[lo:hi], mask[lo:hi], lo))
    if name == "arraysum":
        return (mod.ArraySumFold({"a": (d,), "b": (2, d)}),
                lambda lo, hi: ({"a": X[lo:hi].astype(np.float64).sum(0),
                                 "b": np.stack([X[lo:hi].min(0),
                                                X[lo:hi].max(0)])},))
    fold = mod.CompositeFold({"s": mod.ColStatsFold(d),
                              "c": mod.CorrelationFold(d)})
    return fold, lambda lo, hi: ({"s": (X[lo:hi],),
                                  "c": (X[lo:hi], y[lo:hi])},)


@pytest.mark.parametrize("name", [
    "colstats", "colstats_rowmask", "correlation", "correlation_masked",
    "contingency", "histogram", "arraysum", "composite"])
def test_fold_states_are_the_jax_packages_under_every_schedule(name):
    from transmogrifai_tpu.streaming import folds as jfolds
    from transmogrifai_tpu_torch.streaming import folds as pfolds
    for bounds in _schedules(2400, seed=1):
        states = []
        for mod in (jfolds, pfolds):
            fold, part = _fold_case(name, mod)
            st = fold.zero()
            for lo, hi in bounds:
                st = fold.accumulate(st, *part(lo, hi))
            states.append((fold, st))
        (jf, js), (pf, ps) = states
        _assert_states_equal(jf.state_to_arrays(js), pf.state_to_arrays(ps))
        # the checkpointed state round trips, and finalizes the same
        back = pf.state_from_arrays(pf.state_to_arrays(ps))
        _assert_states_equal(pf.state_to_arrays(back),
                             pf.state_to_arrays(ps))
        jr, pr = jf.finalize(js), pf.finalize(back)
        if name == "histogram":
            assert [h.to_state()["centers"].tobytes() for h in jr] == \
                [h.to_state()["centers"].tobytes() for h in pr]
            assert np.array_equal(jf.fill_rates(js), pf.fill_rates(back))
        else:
            assert repr(jr) == repr(pr)


def test_fold_merge_is_the_jax_packages():
    from transmogrifai_tpu.streaming import folds as jfolds
    from transmogrifai_tpu_torch.streaming import folds as pfolds
    for name in ("colstats", "correlation", "contingency", "histogram",
                 "composite"):
        merged = []
        for mod in (jfolds, pfolds):
            fold, part = _fold_case(name, mod)
            a = fold.accumulate(fold.zero(), *part(0, 1000))
            b = fold.accumulate(fold.zero(), *part(1000, 2400))
            merged.append(fold.state_to_arrays(fold.merge(a, b)))
        _assert_states_equal(*merged)


def test_contingency_fold_flags_non_integer_labels():
    fold = pstream.ContingencyFold(3)
    st = fold.accumulate(fold.zero(), np.ones((10, 3), np.float32),
                         np.linspace(0.1, 0.9, 10))
    assert fold.finalize(st) is None


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("problem", ["binary", "regression"])
def test_synthetic_chunks_are_the_jax_packages_bytes(problem):
    args = (2500, 5)
    kw = dict(chunk_rows=1000, seed=7, problem=problem)
    js, ps = (jstream.SyntheticChunkSource(*args, **kw),
              pstream.SyntheticChunkSource(*args, **kw))
    assert js.fingerprint() == ps.fingerprint()
    assert js.num_chunks == ps.num_chunks == 3
    for a, b in zip(js.chunks(), ps.chunks()):
        assert (a.index, a.chunk_id, a.rows) == (b.index, b.chunk_id, b.rows)
        for name in a.table.column_names:
            ca, cb = a.table[name], b.table[name]
            assert np.asarray(ca.values).tobytes() == \
                cb.host_values().tobytes(), name
            assert (ca.mask is None) == (cb.mask is None)
            if ca.mask is not None:
                assert np.asarray(ca.mask).tobytes() == \
                    cb.valid_mask().tobytes()
    # chunk i is a pure function of (seed, i, chunk_rows)
    tail = next(iter(ps.chunks(start=2)))
    assert tail.table["x0"].host_values().tobytes() == \
        ps.read_chunk(2).table["x0"].host_values().tobytes()


def test_table_chunk_source_ids_are_the_jax_packages():
    jt, _, _, _ = _table(JNS, 1000, 3, seed=2)
    pt, _, _, _ = _table(PNS, 1000, 3, seed=2)
    js = jstream.TableChunkSource(jt, chunk_rows=300)
    ps = pstream.TableChunkSource(pt, chunk_rows=300)
    assert js.fingerprint() == ps.fingerprint()
    assert [c.chunk_id for c in js.chunks()] == \
        [c.chunk_id for c in ps.chunks()]
    assert [c.rows for c in ps.chunks(start=1)] == [300, 300, 100]
    assert ps.with_chunk_rows(150).fingerprint() == \
        js.with_chunk_rows(150).fingerprint()


def test_avro_chunk_source_reads_a_jax_written_file(tmp_path):
    from transmogrifai_tpu.utils.avro import write_avro
    rows = [{"x0": float(i) * 0.5, "y": float(i % 2)} for i in range(130)]
    path = str(tmp_path / "stream.avro")
    write_avro(path, rows)
    out = []
    for FB, mod in ((JFB, jstream), (PFB, pstream)):
        label = FB.RealNN("y").extract_field().as_response()
        x0 = FB.Real("x0").extract_field().as_predictor()
        src = mod.AvroChunkSource(path, chunk_rows=50)
        src.bind((label, x0))
        out.append((src, list(src.chunks())))
    (js, jc), (ps, pc) = out
    assert js.fingerprint() == ps.fingerprint()
    assert [c.rows for c in pc] == [50, 50, 30] and ps.num_chunks == 3
    for a, b in zip(jc, pc):
        for name in ("x0", "y"):
            assert np.asarray(a.table[name].values).tobytes() == \
                b.table[name].host_values().tobytes()
    tail = list(ps.chunks(start=2))
    assert len(tail) == 1 and tail[0].rows == 30


# ---------------------------------------------------------------------------
# the host histogram backend
# ---------------------------------------------------------------------------

def test_host_histogram_is_the_jax_packages_bits():
    rng = np.random.RandomState(5)
    n, d, nb, n_nodes = 777, 6, 8, 4
    X = rng.randn(n, d).astype(np.float32)
    edges = np.sort(rng.randn(d, nb - 1), axis=1)
    edges[:, -2:] = np.inf                       # unused slots, like SPDT
    node = rng.randint(0, n_nodes, n).astype(np.int64)
    r = rng.randn(n)
    jcodes = jengine.bin_codes_host(X, edges)
    pcodes = phist.bin_codes_host(X, edges)
    assert pcodes.tobytes() == jcodes.tobytes()
    want = jengine.build_node_hist(jcodes, node, [None, r, r * r], nb,
                                   n_nodes=n_nodes)
    got = phist.build_node_hist(pcodes, node, [None, r, r * r], nb,
                                n_nodes=n_nodes)
    assert got.dtype == np.float64 and got.tobytes() == want.tobytes()
    forced = phist.build_node_hist(pcodes, node, [None, r], nb,
                                   n_nodes=n_nodes, backend="host")
    assert forced.tobytes() == want[:2].tobytes()
    for a, b in zip(jengine.node_stat_sums(node, [None, r], n_nodes),
                    phist.node_stat_sums(node, [None, r], n_nodes)):
        assert a.tobytes() == b.tobytes()
    with pytest.raises(ValueError, match="stride-1"):
        phist.build_node_hist(pcodes, node, [None], nb, n_nodes=n_nodes,
                              stride=2)


def test_device_backend_still_takes_tensors():
    codes = torch.randint(0, 4, (64, 3), dtype=torch.int32)
    node = torch.zeros((64, 1), dtype=torch.int32)
    stats = [torch.ones((64, 1))]
    h = phist.build_node_hist(codes, node, stats, 4)
    assert h.shape == (1, 1, 1, 3, 4) and float(h.sum()) == 64 * 3
    with pytest.raises(TypeError, match="tensors"):
        phist.build_node_hist(codes.numpy().astype(np.float32), node, stats,
                              4)


# ---------------------------------------------------------------------------
# a streamed train through both packages
# ---------------------------------------------------------------------------

def _committer_leads(release_prev):
    """A feed's ``_release_prev`` that first waits until the committer has
    queued the next chunk (or the end). The feed's peak residency depends
    on which thread runs ahead: a consumer slower than the committer holds
    chunk k while chunk k+1 is counted in, a faster one has let k go. A
    loaded host decides that differently run to run, so both packages'
    trains take the same order here: the committer always leads, and the
    peak is the largest pair of consecutive chunks."""
    def release(self):
        q = self._q
        with q.not_empty:
            q.not_empty.wait_for(
                lambda: q._qsize() > 0 or self._stop.is_set(), timeout=60)
        release_prev(self)
    return release


@pytest.fixture(scope="module")
def trained_pair():
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for feed_cls in (jstream.feed.DeviceFeed, pstream.feed.DeviceFeed):
            mp.setattr(feed_cls, "_release_prev",
                       _committer_leads(feed_cls._release_prev))
        for key, ns in PKG.items():
            table, _, _, _ = _table(ns, 3000, 8)
            kw = {"device": "cpu"} if key == "port" else {}
            model, src = _train(ns, table, 8, 450, **kw)
            out[key] = (table, model, src)
    return out


def test_streamed_train_is_the_jax_packages_bit_for_bit(trained_pair):
    (jt, jm, js), (pt, pm, ps) = trained_pair["jax"], trained_pair["port"]
    want = T.stream_result(jm, js, sample=512)
    got = T.stream_result(pm, ps, sample=512)
    assert T.stream_differences(got, want) == []
    assert got[0]["sanitySummary"] == want[0]["sanitySummary"]
    # every scored row of the whole table, bit for bit
    jp = np.asarray(jm.score(table=jt)[jm.result_features[0].name].values)
    pcol = pm.score(table=pt)[pm.result_features[0].name]
    assert pcol.values.device.type == "cpu"
    assert pcol.values.numpy().tobytes() == jp.tobytes()


def test_streamed_summary_has_the_jax_packages_sections(trained_pair):
    jm, pm = trained_pair["jax"][1], trained_pair["port"][1]
    js, ps = jm.summary(), pm.summary()
    assert sorted(ps["streaming"]) == sorted(js["streaming"])
    assert sorted(ps["streaming"]["cache"]) == \
        sorted(js["streaming"]["cache"])
    assert sorted(ps["faults"]) == sorted(js["faults"])
    assert ps["resume"] == js["resume"]
    st = ps["streaming"]
    for k in ("chunks", "rows", "maxChunkBytes", "peakDeviceBytes",
              "peakResidentChunks", "cacheHits", "cacheMisses"):
        assert st[k] == js["streaming"][k], k
    assert ps["streaming"]["cache"] == js["streaming"]["cache"]
    # O(chunk) residency: at most prefetch + 1 transformed chunks
    assert st["peakResidentChunks"] <= 2
    assert st["peakDeviceBytes"] <= 2 * st["maxChunkBytes"]
    assert pm.train_table.num_rows <= 256
    assert sorted(T.stage_of(pm, "StreamingGBTModel").summary_metadata) == \
        sorted(T.stage_of(jm, "StreamingGBTModel").summary_metadata)


def test_streamed_models_load_in_either_package(trained_pair, tmp_path):
    (jt, jm, _), (pt, pm, _) = trained_pair["jax"], trained_pair["port"]
    pm.save(str(tmp_path / "port"))
    jm.save(str(tmp_path / "jax"))
    from_port = JModel.load(str(tmp_path / "port"))
    from_jax = PModel.load(str(tmp_path / "jax"), device="cpu")
    name = jm.result_features[0].name
    want = np.asarray(jm.score(table=jt)[name].values)
    assert np.asarray(from_port.score(table=jt)[name].values).tobytes() == \
        want.tobytes()
    got = from_jax.score(table=pt)[name].values
    assert got.numpy().tobytes() == want.tobytes()
    g = T.stage_of(from_jax, "StreamingGBTModel")
    assert isinstance(g.trees[0]["leaf"], np.ndarray)   # host state
    row = {f"x{i}": float(i) * 0.1 for i in range(8)}
    # the port's row scorer is its columnar pass (float32); the JAX
    # package's row dual keeps float64: the same values rounded once
    got = ptg.score_function(from_jax)(row)[name]
    want = from_port.score_function()(row)[name]
    assert got == {k: float(np.float32(v)) for k, v in want.items()}


def test_in_core_fit_is_a_one_chunk_fold():
    """``StreamingGBT.fit`` on an in-memory table (one chunk), as
    ``tests/test_histeng.py`` drives it: the JAX package's trees."""
    from transmogrifai_tpu.types import OPVector as JVec
    from transmogrifai_tpu_torch.table import Column, FeatureTable
    from transmogrifai_tpu_torch.types import OPVector, RealNN
    rng = np.random.RandomState(6)
    n, d = 400, 5
    X = rng.randn(n, d).astype(np.float32)
    y = (X @ rng.randn(d) > 0).astype(np.float32)
    names = (SimpleNamespace(name="label"), SimpleNamespace(name="vec"))
    got = []
    for mod, table in (
            (jstream, JTable({"label": JColumn(jtypes.RealNN, y, None),
                              "vec": JColumn(JVec, X, None)}, n)),
            (pstream, FeatureTable({"label": Column(RealNN, y, None),
                                    "vec": Column(OPVector, X, None)}, n))):
        est = mod.StreamingGBT(problem="binary", num_trees=2, max_depth=3,
                               n_bins=8)
        est.input_features = names
        est.get_output = lambda: None
        got.append(T.streamed_gbt_arrays(est.fit_streaming(
            _one_chunk_run(mod, table, est.uid))))
    _assert_states_equal(*got)


def _one_chunk_run(mod, table, uid):
    kw = {"device": "cpu"} if mod is pstream else {}
    return mod.StreamRun(mod.TableChunkSource(table, table.num_rows),
                         upstream=[], stage_uid=uid, **kw)


def test_empty_mask_column_streams():
    """A column missing in every row folds to its fill value, not NaN."""
    n = 900
    rng = np.random.RandomState(3)
    from transmogrifai_tpu_torch.table import Column, FeatureTable
    from transmogrifai_tpu_torch.types import Real, RealNN
    table = FeatureTable({
        "x0": Column(Real, rng.randn(n).astype(np.float32), None),
        "x1": Column(Real, np.zeros(n, np.float32), np.zeros(n, bool)),
        "y": Column(RealNN, (rng.rand(n) > 0.5).astype(np.float32), None),
    }, n)
    label = PFB.RealNN("y").extract_field().as_response()
    feats = [PFB.Real("x0").extract_field().as_predictor(),
             PFB.Real("x1").extract_field().as_predictor()]
    pred = (pstream.StreamingGBT(problem="binary", num_trees=1, max_depth=2)
            .set_input(label, ptg.transmogrify(feats)).get_output())
    m = (PWorkflow(device="cpu").set_result_features(pred)
         .train(stream=pstream.TableChunkSource(table, chunk_rows=200)))
    assert np.isfinite(T.stage_of(m, "RealVectorizerModel").fills).all()


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _selector_dag(ns, pkg_selector):
    FB = ns.FeatureBuilder
    label = FB.RealNN("y").extract_field().as_response()
    feats = [FB.Real(f"x{i}").extract_field().as_predictor()
             for i in range(3)]
    return (pkg_selector.with_train_validation_split(seed=0)
            .set_input(label, ns.transmogrify(feats)).get_output())


def _refusal(key, case):
    """(workflow, the train call) of a refused streamed train."""
    ns = PKG[key]
    kw = {"device": "cpu"} if key == "port" else {}
    table, _, _, _ = _table(ns, 500, 3)
    src = ns.streaming.TableChunkSource(table, chunk_rows=100)
    ns.reset_uids()
    if case == "selector":
        sel = (jtg.BinaryClassificationModelSelector if key == "jax"
               else ptg.BinaryClassificationModelSelector)
        wf = ns.OpWorkflow(**kw).set_result_features(_selector_dag(ns, sel))
        return wf, lambda: wf.train(stream=src)
    if case == "spearman":
        FB = ns.FeatureBuilder
        label = FB.RealNN("y").extract_field().as_response()
        feats = [FB.Real(f"x{i}").extract_field().as_predictor()
                 for i in range(3)]
        checked = label.transform_with(
            ns.SanityChecker(seed=1, correlation_type_spearman=True),
            ns.transmogrify(feats))
        pred = (ns.streaming.StreamingGBT(problem="binary", num_trees=1,
                                          max_depth=2)
                .set_input(label, checked).get_output())
        wf = ns.OpWorkflow(**kw).set_result_features(pred)
        return wf, lambda: wf.train(stream=src)
    wf = ns.OpWorkflow(**kw).set_result_features(
        T.stream_dag(ns, 3, dict(T.PRESSURE_GBT, max_depth=2)))
    if case == "rff":
        wf.with_raw_feature_filter(object())
    elif case == "wcv":
        wf.with_workflow_cv()
    elif case == "mesh":
        wf.with_mesh(object())
    return wf, lambda: wf.train(resume=case == "resume", stream=src)


@pytest.mark.parametrize("case,err,match", [
    ("selector", "StreamingNotSupportedError", "ModelSelector"),
    ("spearman", "ValueError", "Spearman|ranks"),
    ("rff", "ValueError", "RawFeatureFilter"),
    ("wcv", "ValueError", "with_workflow_cv"),
    ("mesh", "ValueError", "with_mesh"),
    ("resume", "ValueError", "with_checkpoint_dir"),
])
def test_refusals_raise_as_the_jax_packages(case, err, match):
    for key in ("jax", "port"):
        _, call = _refusal(key, case)
        with pytest.raises(Exception, match=match) as info:
            call()
        assert type(info.value).__name__ == err, (key, info.value)
    assert not pstream.live_feeds()


def test_the_in_core_train_takes_no_checkpoints_yet(tmp_path):
    wf, _ = _refusal("port", "plain")
    table, _, _, _ = _table(PNS, 200, 3)
    wf.set_input_dataset({n: table[n].host_values()
                          for n in table.column_names})
    # the in-core train checkpoints now: resume needs a directory, as in
    # the JAX package, and a checkpointed train commits its stages
    with pytest.raises(ValueError, match="with_checkpoint_dir"):
        wf.train(resume=True)
    model = wf.with_checkpoint_dir(str(tmp_path)).train()
    assert model.summary()["resume"]["refitStages"]
    assert os.path.isfile(os.path.join(str(tmp_path), "MANIFEST.json"))
    wf._checkpoint_dir = None
    wf.with_mesh(object())
    with pytest.raises(NotImplementedError, match="item 10"):
        wf.train()


# ---------------------------------------------------------------------------
# the chip fixture, its generator, the module boundary
# ---------------------------------------------------------------------------

def test_fixture_generator_agrees_with_the_port(tmp_path):
    """``testing.write_stream_fixture`` through the JAX package and the
    port at a small size: no difference (the committed fixture is the
    same function at the workload's size)."""
    T.write_stream_fixture(JNS, str(tmp_path / "jax"), 12_000, 6, 2_000,
                           sample=256)
    T.write_stream_fixture(PNS, str(tmp_path / "port"), 12_000, 6, 2_000,
                           sample=256, device="cpu")
    got = T.read_stream_fixture(str(tmp_path / "port"))
    want = T.read_stream_fixture(str(tmp_path / "jax"))
    assert T.stream_differences(got, want) == []
    assert want[1]["prob1"].dtype == np.float32
    assert len(want[1]["rows"]) == 256


def test_committed_fixture_is_the_workload():
    js, arrays = T.read_stream_fixture(FIXTURE)
    assert js["config"] == {
        "rows": T.STREAM_ROWS, "features": T.STREAM_FEATURES,
        "chunkRows": T.STREAM_CHUNK_ROWS, "seed": T.STREAM_SEED,
        "sample": T.STREAM_SAMPLE, "gbt": T.STREAM_GBT}
    assert js["trees"] == T.STREAM_GBT["num_trees"]
    assert arrays["fills"].shape == (T.STREAM_FEATURES,)
    assert arrays["prob1"].shape == (T.STREAM_SAMPLE,)
    assert np.array_equal(arrays["rows"], T.stream_sample_rows())


def test_fixture_stays_small():
    total = sum(os.path.getsize(os.path.join(root, f))
                for root, _, files in os.walk(FIXTURE) for f in files)
    assert total < 256 * 1024, total


def test_streaming_modules_load_without_jax_or_pandas(tmp_path):
    """The streaming, robustness and checkpoint modules in a process of
    their own: a streamed train killed mid-pass under a checkpoint
    directory and resumed, with no jax, pandas or JAX package module
    loaded."""
    code = (
        "import sys\n"
        "import transmogrifai_tpu_torch.streaming as S\n"
        "import transmogrifai_tpu_torch.robustness as R\n"
        "import transmogrifai_tpu_torch.utils.fidelity\n"
        "import transmogrifai_tpu_torch.histeng.host\n"
        "from transmogrifai_tpu_torch.robustness import faults\n"
        "from transmogrifai_tpu_torch import testing as T\n"
        "ns = T.port_stream_namespace()\n"
        "src = S.TableChunkSource(T.pressure_table(ns, 4000, 4), 500)\n"
        "gbt = dict(T.PRESSURE_GBT, max_depth=2)\n"
        "ns.reset_uids()\n"
        f"wf = ns.OpWorkflow(device='cpu').with_checkpoint_dir("
        f"{str(tmp_path)!r}).set_result_features(T.stream_dag(ns, 4, gbt))\n"
        "try:\n"
        "    with faults.injected({'stream.fold': {'mode': 'preempt', "
        "'nth': 12}}):\n"
        "        wf.train(stream=src)\n"
        "except faults.SimulatedPreemption:\n"
        "    pass\n"
        "m = wf.train(resume=True, stream=src)\n"
        "assert m.summary()['resume']['restoredStages']\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'pandas', 'transmogrifai_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def generate_fixture(out_dir: str = FIXTURE) -> None:
    """Write ``fixtures/stream``: the JAX package's train of the stream
    workload (``testing.write_stream_fixture``, 1,000,000 x 64 in chunks
    of 65,536) on the CPU."""
    T.write_stream_fixture(JNS, out_dir)
    js, _ = T.read_stream_fixture(out_dir)
    print(json.dumps(js["sanity"])[:200])


if __name__ == "__main__":
    generate_fixture()
