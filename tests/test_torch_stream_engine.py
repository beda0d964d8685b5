"""The port's streaming input engine (``transmogrifai_tpu_torch.streaming.
feed`` and ``cache``) on the CPU, mirroring ``tests/test_stream_engine.py``
with the JAX package's inputs (and its results where both run): chunks in
schedule order and byte-equal at any worker count, the residency bound
under a full pool, a streamed train bit-equal at 1, 2 and 4 workers (and
to the JAX package's), the transformed-chunk cache's pack round trip,
byte-equal replay with no upload, LRU budget, sha256-verified disk tier
and the ``stream.cache`` fault degrading to a recompute, the watchdog
aborting a feed against a full queue and a wedged producer, fused prep
passes, and the fitted-transform identity. The threaded cases wait on
``threading.Event``s set at the point the test needs (never a sleep) and
bound every wait.
"""
import os
import threading

import numpy as np
import pytest

from transmogrifai_tpu import streaming as jstream
from transmogrifai_tpu.features import reset_uids as jreset

from transmogrifai_tpu_torch import testing as T
from transmogrifai_tpu_torch.features import FeatureBuilder
from transmogrifai_tpu_torch.impl.feature.vectorizers import RealVectorizer
from transmogrifai_tpu_torch.robustness import faults
from transmogrifai_tpu_torch.robustness.policy import FaultLog
from transmogrifai_tpu_torch.robustness.watchdog import WatchdogStallError
from transmogrifai_tpu_torch.streaming import (
    ChunkCache, DeviceFeed, TableChunkSource, pack_table,
)
from transmogrifai_tpu_torch.streaming import feed as feed_mod
from transmogrifai_tpu_torch.streaming.cache import transform_identity
from transmogrifai_tpu_torch.streaming.trainer import fit_dag_streaming
from transmogrifai_tpu_torch.table import Column, FeatureTable
from transmogrifai_tpu_torch.types import OPVector, Real, RealNN, Text

pytestmark = pytest.mark.stream

PNS = T.port_stream_namespace()
CPU = "cpu"


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


def _table(n=2000, d=6, seed=0, missing=0.05):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    mask = rng.rand(n, d) >= missing
    y = (np.where(mask, X, 0.0)[:, 0] > 0.3).astype(np.float32)
    cols = {f"x{i}": Column(Real, X[:, i], mask[:, i]) for i in range(d)}
    cols["y"] = Column(RealNN, y, None)
    return FeatureTable(cols, n)


def _train(table, d, chunk_rows, **kw):
    PNS.reset_uids()
    wf = PNS.OpWorkflow(device=CPU).set_result_features(
        T.stream_dag(PNS, d, dict(T.PRESSURE_GBT, max_depth=2, n_bins=8)))
    return wf.train(stream=TableChunkSource(table, chunk_rows=chunk_rows),
                    **kw)


def _wait_until(cond, timeout=10.0):
    """Poll ``cond`` until it holds or ``timeout`` passes."""
    tick = threading.Event()
    for _ in range(int(timeout / 0.002)):
        if cond():
            return
        tick.wait(0.002)


def _col_bytes(table):
    """Column name -> its value and mask bytes (the byte-equality probe)."""
    out = {}
    for name in table.column_names:
        col = table[name]
        out[name] = (np.ascontiguousarray(col.host_values()).tobytes(),
                     None if col.mask is None else
                     np.ascontiguousarray(col.valid_mask()).tobytes())
    return out


def _arrays(model):
    out = T.streamed_gbt_arrays(T.stage_of(model, "StreamingGBTModel"))
    out["fills"] = np.asarray(T.stage_of(model, "RealVectorizerModel").fills)
    return out


def _same(a, b):
    return sorted(a) == sorted(b) and all(
        np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes() for k in a)


# ---------------------------------------------------------------------------
# env plumbing and accounting
# ---------------------------------------------------------------------------

def test_env_workers_parsing(monkeypatch):
    assert feed_mod.env_workers(3) == 3
    assert feed_mod.env_workers(0) == 1          # floor
    monkeypatch.setenv("TG_STREAM_WORKERS", "7")
    assert feed_mod.env_workers() == 7
    monkeypatch.setenv("TG_STREAM_WORKERS", "")
    assert feed_mod.env_workers() == max(1, min(4, os.cpu_count() or 1))
    assert feed_mod.env_prefetch(None) == int(
        os.environ.get("TG_STREAM_PREFETCH", "") or 1)


def test_device_bytes_charges_full_mask_elements():
    """An (n, d) validity mask holds n * d bytes while resident, tensors
    by their element size, as the JAX package charges numpy arrays."""
    import torch
    n, d = 100, 3
    host = FeatureTable({"v": Column(OPVector, np.zeros((n, d), np.float32),
                                     np.ones((n, d), bool))}, n)
    assert feed_mod.device_bytes(host) == n * d * 4 + n * d
    dev = FeatureTable({"v": Column(OPVector, torch.zeros((n, d)),
                                    torch.ones((n, d), dtype=torch.bool))},
                       n, device=torch.device(CPU))
    assert feed_mod.device_bytes(dev) == n * d * 4 + n * d
    from transmogrifai_tpu.table import Column as JColumn
    from transmogrifai_tpu.table import FeatureTable as JTable
    from transmogrifai_tpu.types import OPVector as JVec
    jt = JTable({"v": JColumn(JVec, np.zeros((n, d), np.float32),
                              np.ones((n, d), bool))}, n)
    assert jstream.device_bytes(jt) == feed_mod.device_bytes(host)


def test_a_cuda_feed_needs_a_card():
    """The feed resolves its device as every entry point does: without a
    card and without ``device=``, it raises instead of staying on the
    host."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this process has a CUDA device")
    src = TableChunkSource(_table(100, 2), chunk_rows=50)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceFeed(src)
    assert not feed_mod.live_feeds()


# ---------------------------------------------------------------------------
# parallel preparation: order, content, residency, bits
# ---------------------------------------------------------------------------

def test_delivery_order_and_content_under_parallel_workers():
    src = TableChunkSource(_table(2048, 4, seed=7), chunk_rows=128)
    with DeviceFeed(src, prefetch=4, workers=4, to_device=False):
        pass  # close() of an unconsumed pooled feed drains cleanly
    with DeviceFeed(src, prefetch=1, workers=1, device=CPU) as f1:
        ref = [(c.index, _col_bytes(c.table)) for c in f1]
    with DeviceFeed(src, prefetch=4, workers=4, device=CPU) as f4:
        got = [(c.index, _col_bytes(c.table)) for c in f4]
    assert [i for i, _ in got] == list(range(16))
    assert got == ref
    assert not feed_mod.live_feeds()


def test_residency_bound_holds_under_worker_pool():
    """4 workers over prefetch 2 never hold more than 2 queued chunks and
    1 consumed: the slots gate the claims. The consumer holds each chunk
    until the pool has filled both slots (a bounded wait on that
    condition, not a sleep)."""
    src = TableChunkSource(_table(4096, 4, seed=5), chunk_rows=256)
    with DeviceFeed(src, prefetch=2, workers=4, device=CPU) as feed:
        for chunk in feed:
            left = 15 - chunk.index
            _wait_until(lambda: feed._q.qsize() >= min(2, left))
    st = feed.stats
    assert st.chunks == 16
    assert st.peak_resident_chunks <= 3
    assert st.peak_device_bytes <= 3 * st.max_chunk_bytes
    assert st.upload_bytes == sum(
        feed_mod.device_bytes(c.table) for c in src.chunks())


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_streamed_train_bit_equal_at_any_worker_count(workers, monkeypatch):
    table = _table(1500, 5, seed=11)
    monkeypatch.setenv("TG_STREAM_PREFETCH", "4")
    monkeypatch.setenv("TG_STREAM_WORKERS", "1")
    ref = _arrays(_train(table, 5, 250))
    monkeypatch.setenv("TG_STREAM_WORKERS", str(workers))
    assert _same(_arrays(_train(table, 5, 250)), ref)


def test_streamed_train_under_a_pool_is_the_jax_packages(monkeypatch):
    from transmogrifai_tpu.table import Column as JColumn
    from transmogrifai_tpu.table import FeatureTable as JTable
    from transmogrifai_tpu.types import Real as JReal
    from transmogrifai_tpu.types import RealNN as JRealNN
    from transmogrifai_tpu.workflow import OpWorkflow as JWorkflow
    import transmogrifai_tpu as jtg
    from transmogrifai_tpu.features import FeatureBuilder as JFB
    from transmogrifai_tpu.impl.preparators.sanity_checker import (
        SanityChecker as JSC)
    from types import SimpleNamespace
    monkeypatch.setenv("TG_STREAM_PREFETCH", "4")
    monkeypatch.setenv("TG_STREAM_WORKERS", "4")
    table = _table(1500, 5, seed=11)
    jns = SimpleNamespace(FeatureBuilder=JFB, transmogrify=jtg.transmogrify,
                          SanityChecker=JSC, streaming=jstream)
    jt = JTable({n: JColumn(JRealNN if n == "y" else JReal,
                            table[n].values, table[n].mask)
                 for n in table.column_names}, 1500)
    jreset()
    jm = JWorkflow().set_result_features(T.stream_dag(
        jns, 5, dict(T.PRESSURE_GBT, max_depth=2, n_bins=8))).train(
        stream=jstream.TableChunkSource(jt, chunk_rows=250))
    assert _same(_arrays(_train(table, 5, 250)), _arrays(jm))


def test_stage_seconds_split_and_summary_surface():
    m = _train(_table(1200, 4, seed=3), 4, 300)
    st = m.summary()["streaming"]
    for key in ("readSeconds", "transformSeconds", "uploadSeconds",
                "cacheHits", "cacheMisses", "overlapFraction"):
        assert key in st, key
    assert st["readSeconds"] + st["transformSeconds"] > 0
    assert st["cacheHits"] + st["cacheMisses"] == st["chunks"]
    cache = st["cache"]
    assert cache["stores"] > 0 and 0.0 <= cache["hitRate"] <= 1.0


# ---------------------------------------------------------------------------
# the transformed-chunk cache
# ---------------------------------------------------------------------------

def test_cache_hit_pass_is_byte_equal_with_zero_upload():
    src = TableChunkSource(_table(1024, 4, seed=13), chunk_rows=256)
    cache = ChunkCache(max_bytes=64 << 20)
    with DeviceFeed(src, cache=cache, cache_ident="t0", device=CPU) as f1:
        first = [_col_bytes(c.table) for c in f1]
    assert f1.stats.cache_misses == 4 and f1.stats.cache_hits == 0
    assert f1.stats.upload_bytes > 0
    assert cache.stats.stores == 4
    with DeviceFeed(src, cache=cache, cache_ident="t0", device=CPU) as f2:
        second = [c for c in f2]
    assert f2.stats.cache_hits == 4 and f2.stats.cache_misses == 0
    assert f2.stats.upload_bytes == 0       # a hit crosses nothing
    assert [_col_bytes(c.table) for c in second] == first
    assert all(c.table.device is None for c in second)   # host views
    with DeviceFeed(src, cache=cache, cache_ident="OTHER",
                    device=CPU) as f3:
        list(f3)
    assert f3.stats.cache_hits == 0 and f3.stats.cache_misses == 4


def test_pack_unpack_roundtrip_is_byte_equal():
    import torch
    table = _table(512, 3, seed=17)
    packed = pack_table(table)
    assert packed.content_sha() == pack_table(table).content_sha()
    # a chunk on a device packs from its host copy, to the same bytes
    dev = table.to_device(torch.device(CPU))
    assert pack_table(dev).content_sha() == packed.content_sha()
    un = packed.unpack()
    assert un.num_rows == table.num_rows
    assert _col_bytes(un) == _col_bytes(table)
    for name in table.column_names:
        assert un[name].feature_type is table[name].feature_type
    # the JAX package's packing of the same chunk: the same payload
    from transmogrifai_tpu.table import Column as JColumn
    from transmogrifai_tpu.table import FeatureTable as JTable
    from transmogrifai_tpu.types import Real as JReal
    from transmogrifai_tpu.types import RealNN as JRealNN
    jt = JTable({n: JColumn(JRealNN if n == "y" else JReal,
                            table[n].values, table[n].mask)
                 for n in table.column_names}, 512)
    jp = jstream.pack_table(jt)
    assert [jp.blocks[k].tobytes() for k in jp.header["dtypes"]] == \
        [packed.blocks[k].tobytes() for k in packed.header["dtypes"]]
    assert jp.mask_block.tobytes() == packed.mask_block.tobytes()
    bad = FeatureTable({"t": Column(
        Text, np.array(["a", "b"], dtype=object), None)}, 2)
    assert pack_table(bad) is None


def test_host_tier_lru_eviction_stays_under_budget():
    src = TableChunkSource(_table(2048, 4, seed=19), chunk_rows=256)
    one = pack_table(next(iter(src.chunks())).table).nbytes
    cache = ChunkCache(max_bytes=3 * one + one // 2)    # fits 3 of 8
    with DeviceFeed(src, cache=cache, cache_ident="t", device=CPU) as f1:
        first = [_col_bytes(c.table) for c in f1]
    assert cache.stats.evictions > 0
    assert cache.stats.host_bytes <= cache.max_bytes
    with DeviceFeed(src, cache=cache, cache_ident="t", device=CPU) as f2:
        second = [_col_bytes(c.table) for c in f2]
    assert second == first
    assert f2.stats.cache_hits + f2.stats.cache_misses == 8
    assert f2.stats.cache_misses > 0
    assert cache.stats.host_bytes <= cache.max_bytes


def test_disk_tier_sha_verified_roundtrip_and_corruption(tmp_path):
    src = TableChunkSource(_table(600, 4, seed=23), chunk_rows=200)
    d = str(tmp_path / "stream_cache")
    c1 = ChunkCache(max_bytes=0, disk_dir=d)            # disk tier only
    with DeviceFeed(src, cache=c1, cache_ident="t", device=CPU) as f1:
        first = [_col_bytes(c.table) for c in f1]
    files = sorted(f for f in os.listdir(d) if f.endswith(".npz"))
    assert len(files) == 3
    c2 = ChunkCache(max_bytes=0, disk_dir=d)            # a fresh process
    with DeviceFeed(src, cache=c2, cache_ident="t", device=CPU) as f2:
        second = [_col_bytes(c.table) for c in f2]
    assert second == first and c2.stats.disk_hits == 3
    with open(os.path.join(d, files[0]), "r+b") as fh:
        fh.seek(100)
        fh.write(b"\xff\xff\xff\xff")
    log = FaultLog()
    c3 = ChunkCache(max_bytes=0, disk_dir=d)
    with log.activate():
        with DeviceFeed(src, cache=c3, cache_ident="t", device=CPU) as f3:
            third = [_col_bytes(c.table) for c in f3]
    assert third == first                   # never wrong data
    assert c3.stats.fallbacks == 1
    assert "stream_cache_fallback" in {r.kind for r in log.reports}
    c4 = ChunkCache(max_bytes=0, disk_dir=d)             # repaired in place
    with DeviceFeed(src, cache=c4, cache_ident="t", device=CPU) as f4:
        assert [_col_bytes(c.table) for c in f4] == first
    assert c4.stats.disk_hits == 3 and c4.stats.fallbacks == 0


def test_chaos_stream_cache_raise_degrades_to_recompute():
    src = TableChunkSource(_table(768, 4, seed=29), chunk_rows=256)
    cache = ChunkCache(max_bytes=64 << 20)
    with DeviceFeed(src, cache=cache, cache_ident="t", device=CPU) as f1:
        first = [_col_bytes(c.table) for c in f1]
    log = FaultLog()
    with log.activate():
        with faults.injected(
                {"stream.cache": {"mode": "raise", "nth": 2, "count": 1}}):
            with DeviceFeed(src, cache=cache, cache_ident="t",
                            device=CPU) as f2:
                second = [_col_bytes(c.table) for c in f2]
            assert faults.fired_counts() == {"stream.cache": {"raise": 1}}
    assert second == first
    assert f2.stats.cache_hits == 2 and f2.stats.cache_misses == 1
    assert cache.stats.fallbacks == 1
    assert any(r.kind == "stream_cache_fallback" for r in log.reports)


# ---------------------------------------------------------------------------
# the watchdog abort
# ---------------------------------------------------------------------------

class _Wedge:
    """A transform that says when it is entered and blocks until
    released (bounded)."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()

    def transform(self, t):
        self.entered.set()
        self.release.wait(timeout=20)
        return t


def test_watchdog_stall_abort_survives_full_queue():
    """The stall callback wakes a consumer even against a full queue:
    with the pool wedged, fill the queue by hand and abort."""
    src = TableChunkSource(_table(512, 3, seed=41), chunk_rows=256)
    wedge = _Wedge()
    feed = DeviceFeed(src, transforms=[wedge], prefetch=2, workers=1,
                      to_device=False)
    try:
        assert wedge.entered.wait(timeout=20)
        while not feed._q.full():
            feed._q.put_nowait(("pad", (0, None)))
        feed._on_watchdog_stall(feed._heart, 99.0)
        wedge.release.set()
        with pytest.raises(WatchdogStallError, match="stalled"):
            next(feed)
    finally:
        wedge.release.set()
        feed.close()
    assert not feed_mod.live_feeds()


def test_wedged_producer_unblocks_consumer():
    """A transform wedged mid-chunk: the stall callback aborts the feed
    and the consumer gets the typed error, not the chunk the wedged thread
    goes on to finish. The wedge is released before the consumer reads,
    so the feed's close joins its threads at once instead of waiting out
    the join timeout on a thread that is still wedged."""
    src = TableChunkSource(_table(512, 3, seed=43), chunk_rows=128)
    wedge = _Wedge()
    feed = DeviceFeed(src, transforms=[wedge], prefetch=1, workers=1,
                      to_device=False)
    try:
        assert wedge.entered.wait(timeout=20)
        feed._on_watchdog_stall(feed._heart, 99.0)
        wedge.release.set()
        with pytest.raises(WatchdogStallError):
            next(feed)
        assert not feed._thread.is_alive()
    finally:
        wedge.release.set()
        feed.close()
    assert not feed_mod.live_feeds()


def test_the_watchdog_fires_on_a_silent_heart():
    """The scanner itself, on an injected clock: a heart that stops
    beating stalls once per episode, records ``thread_stalled`` and calls
    its handler; beats re-arm it."""
    from transmogrifai_tpu_torch.robustness.watchdog import Watchdog
    now = [0.0]
    wd = Watchdog(stall_after=5.0, clock=lambda: now[0], start_thread=False)
    fired = []
    log = FaultLog()
    heart = wd.register("w", on_stall=lambda h, waited: fired.append(waited),
                        fault_log=log)
    now[0] = 4.0
    assert wd.check_now() == []
    now[0] = 6.0
    assert wd.check_now() == [heart] and fired == [6.0]
    assert wd.check_now() == []             # once per episode
    heart.beat()
    now[0] = 7.0
    assert wd.check_now() == []             # beats resumed: re-armed
    now[0] = 12.0
    assert wd.check_now() == [heart]
    assert [r.kind for r in log.reports] == ["thread_stalled"] * 2
    heart.close()
    assert wd.hearts() == []


# ---------------------------------------------------------------------------
# fused prep passes and the transform identity
# ---------------------------------------------------------------------------

def test_fused_prep_passes_one_sweep_same_fills(monkeypatch):
    table = _table(1600, 6, seed=47)
    feats = [FeatureBuilder.Real(f"x{i}").extract_field().as_predictor()
             for i in range(6)]

    def build():
        rv_a, rv_b = RealVectorizer(), RealVectorizer()
        rv_a.set_input(*feats[:3])
        rv_a.get_output()
        rv_b.set_input(*feats[3:])
        rv_b.get_output()
        return rv_a, rv_b

    src = TableChunkSource(table, chunk_rows=200)       # 8 chunks
    rv_a, rv_b = build()
    fitted, _, stats = fit_dag_streaming(
        src, [[(rv_a, None), (rv_b, None)]], device=CPU)
    assert stats.chunks == src.num_chunks               # one fused sweep
    monkeypatch.setenv("TG_STREAM_FUSE", "0")
    rv_a2, rv_b2 = build()
    fitted2, _, stats2 = fit_dag_streaming(
        src, [[(rv_a2, None), (rv_b2, None)]], device=CPU)
    assert stats2.chunks == 2 * src.num_chunks          # one per stage
    assert fitted[rv_a.uid].fills == fitted2[rv_a2.uid].fills
    assert fitted[rv_b.uid].fills == fitted2[rv_b2.uid].fills
    # the fills are the in-core fit's
    assert fitted[rv_a.uid].fills == rv_a.fit(table).fills


def test_transform_identity_distinguishes_fitted_state():
    table = _table(400, 3, seed=53)
    feats = [FeatureBuilder.Real(f"x{i}").extract_field().as_predictor()
             for i in range(3)]
    rv = RealVectorizer()
    rv.set_input(*feats)
    rv.get_output()
    m1 = rv.fit(table)
    ident1 = transform_identity([m1])
    assert ident1 == transform_identity([m1])           # stable
    m2 = rv.fit(table.take(np.arange(200)))             # other fills
    assert transform_identity([m2]) != ident1
    a, b = object(), object()                           # opaque: a miss
    assert transform_identity([a]) != transform_identity([b])
