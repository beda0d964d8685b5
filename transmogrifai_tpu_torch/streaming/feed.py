"""Streaming input engine (counterpart of ``transmogrifai_tpu.streaming.feed``):
chunks prepared behind the consumer, uploaded to the card in schedule
order, replayed from the cache on repeat passes.

While the consumer folds chunk N, a pool of ``TG_STREAM_WORKERS`` worker
threads (default min(4, cores); ``1`` is the serial feed) prepares the
chunks behind it. Each worker takes a slot of the slot semaphore, which
bounds residency to ``prefetch + 1`` chunks whatever the worker count,
*claims* the next schedule index under one lock (site ``stream.read``; a
cache lookup, site ``stream.cache``, happens in the claim too) and reads
the raw host chunk. One ordered **committer** thread then takes the
claimed chunks strictly in schedule order (sites ``stream.upload`` and
``oom.stream``), uploads each, runs the fitted upstream transforms on it
on the card, stores the transformed chunk in the cache and hands it to
the consumer. Claims are serialized, so the fault counters, the delivery
order, the folds and the checkpoints are the same at any worker count.

On CUDA the committer packs the chunk's numeric columns into a pinned
staging buffer (a pool of ``prefetch + 1`` buffers per feed, each reused
only once the event of its last copy has completed), copies it with one
``non_blocking`` copy on a CUDA stream of its own, builds the columns as
views of the copy and runs the transforms on that stream. The consumer's
stream waits on an event recorded after the transforms before it touches
the chunk, and every tensor of the chunk is ``record_stream``-ed on the
consumer's stream, so the caching allocator hands none of its blocks out
again while the consumer still reads it. A feed that cannot pin or launch
raises: nothing falls back to the host. On the CPU (``device="cpu"``, the
tests) the upload is ``FeatureTable.to_device``; with ``to_device=False``
the transforms run on the host table.

A :class:`~.cache.ChunkCache` short-cuts the whole preparation: a hit is
delivered as host views of the packed blocks, so nothing is uploaded (the
folds read host arrays).

Accounting (:class:`FeedStats`, ``summary()["streaming"]``): the bytes
copied to the device (``uploadBytes``: the raw chunks' numeric columns),
seconds per stage (read, transform, upload), cache hits and misses, the
peak of the device bytes of the chunks resident at once (a chunk's
columns after its transforms, ``device_bytes``) and the overlap fraction,
the share of the consumer's wall clock not spent waiting on the feed.

Errors: an exception in a worker or the committer (``SimulatedPreemption``,
a ``BaseException`` that models a kill, included) is forwarded through the
queue in schedule order (the chunks claimed before it still deliver; the
first error in schedule order wins) and raised in the consumer, so a
streamed train dies as an in-core one would, with its last committed fold
state intact. Resource exhaustion (``oom.stream``, or a CUDA out-of-memory
error in the upload or a transform) forwards the same way; the trainer
closes this feed and halves the chunk row budget
(``robustness.resources``).

Hangs: every worker and the committer beat a watchdog heart
(``TG_WATCHDOG_S``). A thread wedged in a dead reader, a hung transform or
a stuck upload stops beating; the stall is recorded (``thread_stalled``)
and the feed aborts: the queue is drained and the typed error put in its
place, so a consumer blocked on an empty or a full queue wakes. ``close``
records any thread that outlives its join timeout.

Telemetry, by the JAX package's names: the flight recorder's
``stream.upload`` event per chunk, stamped with the owning run's
correlation id (taken on the constructing thread: context variables do
not reach the worker threads), the device-memory observatory's
``stream`` dispatch and sample per uploaded chunk, and the metrics
``tg_stream_stage_seconds{stage}``, ``tg_stream_chunks_total``,
``tg_stream_rows_total`` and ``tg_stream_wait_seconds``.
"""
from __future__ import annotations

import os
import queue
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Iterable, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..manifest import sentinel_phase as _sentinel_phase
from ..observability import blackbox as _blackbox
from ..observability import devicemem as _devicemem
from ..observability import metrics as _obs_metrics
from ..robustness import faults
from ..robustness import watchdog as _watchdog
from ..robustness.watchdog import WatchdogStallError
from ..table import DEVICE_KINDS, Column, FeatureTable
from .cache import ChunkCache, chunk_cache_key, pack_table
from .source import Chunk, ChunkSource

PREFETCH_ENV = "TG_STREAM_PREFETCH"
DEFAULT_PREFETCH = 1
WORKERS_ENV = "TG_STREAM_WORKERS"

#: live feeds (weak): a test asserts none survives a kill
_LIVE: "weakref.WeakSet[DeviceFeed]" = weakref.WeakSet()

#: byte alignment of each column block in a staging buffer
_ALIGN = 64


def live_feeds() -> List["DeviceFeed"]:
    return [f for f in list(_LIVE) if not f.closed]


def env_prefetch(prefetch: Optional[int] = None) -> int:
    if prefetch is not None:
        return max(1, int(prefetch))
    try:
        return max(1, int(os.environ.get(PREFETCH_ENV, "")
                          or DEFAULT_PREFETCH))
    except ValueError:
        return DEFAULT_PREFETCH


def env_workers(workers: Optional[int] = None) -> int:
    """Worker pool size: ``TG_STREAM_WORKERS``, default min(4, cores).
    The slot semaphore still bounds the chunks in flight to ``prefetch``,
    so parallel preparation needs ``TG_STREAM_PREFETCH >= workers``."""
    if workers is not None:
        return max(1, int(workers))
    try:
        raw = os.environ.get(WORKERS_ENV, "")
        if raw:
            return max(1, int(raw))
    except ValueError:
        pass
    return max(1, min(4, os.cpu_count() or 1))


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return int(a.element_size() * a.numel())
    return int(np.dtype(getattr(a, "dtype", np.float32)).itemsize
               * int(np.prod(np.shape(a))))


def device_bytes(table: FeatureTable) -> int:
    """Bytes of the numeric (device-kind) columns a chunk holds while
    resident: values and masks at their full element count (an (n, d)
    mask is n * d bytes), by the dtype's element size."""
    total = 0
    for name in table.column_names:
        col = table[name]
        if col.kind not in DEVICE_KINDS:
            continue
        total += _nbytes(col.values)
        if col.mask is not None:
            total += _nbytes(col.mask)
    return total


@dataclass
class FeedStats:
    chunks: int = 0
    rows: int = 0
    upload_bytes: int = 0
    max_chunk_bytes: int = 0
    peak_device_bytes: int = 0
    peak_resident_chunks: int = 0
    read_seconds: float = 0.0
    transform_seconds: float = 0.0
    upload_seconds: float = 0.0
    wait_seconds: float = 0.0
    wall_seconds: float = 0.0
    cache_hits: int = 0
    cache_misses: int = 0

    def overlap_fraction(self) -> float:
        """Share of the consumer's wall clock not spent waiting on the
        feed: 1.0 means read, transform and upload hid behind the folds."""
        if self.wall_seconds <= 0:
            return 0.0
        return max(0.0, 1.0 - self.wait_seconds / self.wall_seconds)

    def merge(self, other: "FeedStats") -> "FeedStats":
        self.chunks += other.chunks
        self.rows += other.rows
        self.upload_bytes += other.upload_bytes
        self.max_chunk_bytes = max(self.max_chunk_bytes,
                                   other.max_chunk_bytes)
        self.peak_device_bytes = max(self.peak_device_bytes,
                                     other.peak_device_bytes)
        self.peak_resident_chunks = max(self.peak_resident_chunks,
                                        other.peak_resident_chunks)
        self.read_seconds += other.read_seconds
        self.transform_seconds += other.transform_seconds
        self.upload_seconds += other.upload_seconds
        self.wait_seconds += other.wait_seconds
        self.wall_seconds += other.wall_seconds
        self.cache_hits += other.cache_hits
        self.cache_misses += other.cache_misses
        return self

    def to_json(self) -> dict:
        """``summary()["streaming"]``, with the JAX package's keys."""
        return {
            "chunks": self.chunks, "rows": self.rows,
            "uploadBytes": self.upload_bytes,
            "maxChunkBytes": self.max_chunk_bytes,
            "peakDeviceBytes": self.peak_device_bytes,
            "peakResidentChunks": self.peak_resident_chunks,
            "readSeconds": round(self.read_seconds, 4),
            "transformSeconds": round(self.transform_seconds, 4),
            "uploadSeconds": round(self.upload_seconds, 4),
            "waitSeconds": round(self.wait_seconds, 4),
            "overlapFraction": round(self.overlap_fraction(), 4),
            "cacheHits": self.cache_hits,
            "cacheMisses": self.cache_misses,
        }


class _PinnedUploader:
    """The CUDA committer's upload: pinned staging buffers, a copy stream
    of its own, events. Used by the committer thread only."""

    def __init__(self, device: torch.device, slots: int,
                 consumer: torch.cuda.Stream):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.consumer = consumer
        self._bufs: List[Optional[torch.Tensor]] = [None] * slots
        self._copied: List[Optional[torch.cuda.Event]] = [None] * slots
        self._next = 0

    def _staging(self, nbytes: int) -> torch.Tensor:
        """The next pinned buffer of the pool, once its previous copy has
        completed (allocated at the first chunk; grown only for a larger
        chunk)."""
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        if self._copied[i] is not None:
            self._copied[i].synchronize()
        buf = self._bufs[i]
        if buf is None or buf.numel() < nbytes:
            buf = self._bufs[i] = torch.empty(nbytes, dtype=torch.uint8,
                                              pin_memory=True)
        self._slot = i
        return buf

    def upload(self, table: FeatureTable, transforms: Sequence[Any]):
        """(the chunk on the card with ``transforms`` applied, the event
        after them, bytes copied, seconds spent issuing the transforms).
        The consumer's stream must wait on the event before it touches the
        chunk."""
        pieces = []            # (name, "values" | "mask", host array)
        for name in table.column_names:
            col = table[name]
            if col.kind not in DEVICE_KINDS:
                continue
            pieces.append((name, "values",
                           np.ascontiguousarray(col.host_values())))
            if col.mask is not None:
                pieces.append((name, "mask",
                               np.ascontiguousarray(col.valid_mask())))
        offs, total = [], 0
        for _, _, arr in pieces:
            offs.append(total)
            total += -(-arr.nbytes // _ALIGN) * _ALIGN
        staging = self._staging(max(total, _ALIGN))
        host = staging.numpy()
        for off, (_, _, arr) in zip(offs, pieces):
            host[off:off + arr.nbytes] = arr.reshape(-1).view(np.uint8)
        with torch.cuda.stream(self.stream):
            block = torch.empty(max(total, _ALIGN), dtype=torch.uint8,
                                device=self.device)
            block.copy_(staging[:block.numel()], non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self.stream)
            self._copied[self._slot] = copied
            parts = {}
            for off, (name, what, arr) in zip(offs, pieces):
                t = block[off:off + arr.nbytes].view(
                    _TORCH_DTYPES[arr.dtype.str]).view(arr.shape)
                parts[(name, what)] = t
            cols = {}
            for name in table.column_names:
                col = table[name]
                if (name, "values") in parts:
                    col = Column(col.feature_type, parts[(name, "values")],
                                 parts.get((name, "mask")), col.metadata)
                cols[name] = col
            out = FeatureTable(cols, table.num_rows, table.key, self.device)
            t0 = time.perf_counter()
            for model in transforms:
                out = model.transform(out)
            transform_s = time.perf_counter() - t0
            ready = torch.cuda.Event()
            ready.record(self.stream)
        for name in out.column_names:
            col = out[name]
            for t in (col.values, col.mask):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(self.consumer)
        return out, ready, total, transform_s


_TORCH_DTYPES = {np.dtype(k).str: v for k, v in (
    (np.float32, torch.float32), (np.float64, torch.float64),
    (np.int64, torch.int64), (np.int32, torch.int32),
    (np.bool_, torch.bool), (np.uint8, torch.uint8))}


class DeviceFeed:
    """Iterate chunks prepared by the input engine, on ``device``.

    ``chunks`` is a :class:`~.source.ChunkSource` (the cache and, for
    random-access sources, parallel reads) or any iterable of
    :class:`Chunk` (reads stay sequential under the claim lock).
    ``device``: where chunks go with ``to_device`` (default: the CUDA
    device; raises when there is none). Close it (``with``, or the
    trainer's ``finally``)::

        with DeviceFeed(source, transforms=models, start=k) as feed:
            for chunk in feed:
                ...fold chunk.table...
    """

    _SENTINEL = object()

    def __init__(self, chunks: Union[ChunkSource, Iterable[Chunk]],
                 transforms: Sequence[Any] = (),
                 prefetch: Optional[int] = None,
                 to_device: bool = True,
                 workers: Optional[int] = None,
                 cache: Optional[ChunkCache] = None,
                 cache_ident: str = "",
                 start: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        if isinstance(chunks, ChunkSource):
            self._source: Optional[ChunkSource] = chunks
            self._start = int(start)
            self._it: Optional[Iterator[Chunk]] = None
            self._it_pos = self._start
        else:
            self._source = None
            self._start = 0
            self._it = iter(chunks)
            self._it_pos = 0
        self._transforms = list(transforms)
        self.workers = env_workers(workers)
        self.prefetch = env_prefetch(prefetch)
        self._to_device = to_device
        self.device = resolve_device(device) if to_device else None
        self._uploader: Optional[_PinnedUploader] = None
        self._consumer: Optional[torch.cuda.Stream] = None
        if self.device is not None and self.device.type == "cuda":
            # the consumer's stream: the thread that builds the feed folds
            self._consumer = torch.cuda.current_stream(self.device)
            self._uploader = _PinnedUploader(self.device, self.prefetch + 1,
                                             self._consumer)
        # the cache needs index-addressed claims: source mode only
        self._cache = cache if self._source is not None else None
        self._cache_ident = cache_ident
        if self._cache is not None:
            # the owning run's fault log, taken on the consumer thread:
            # fallbacks on the feed's threads would miss the ambient log
            from ..robustness.policy import FaultLog
            self._cache.bind_log(FaultLog.current())
        self._random_access = bool(getattr(self._source, "random_access",
                                           False))
        self.stats = FeedStats()
        self._q: "queue.Queue" = queue.Queue(maxsize=self.prefetch + 1)
        #: the production gate: at most ``prefetch`` chunks beyond the one
        #: being consumed; a worker takes a slot before it claims an index
        #: (so before any read or cache fetch), the consumer frees one per
        #: chunk it takes
        self._slots = threading.Semaphore(self.prefetch)
        self._stop = threading.Event()
        self._resident = 0           # device bytes of chunks handed out
        self._resident_chunks = 0
        self._lock = threading.Lock()
        self._prev_bytes = 0
        self.closed = False
        self._stall_error: Optional[BaseException] = None
        self._t0 = time.perf_counter()
        # claim plane: workers claim increasing sequence numbers under
        # _claim_lock (seq s is schedule index start + s in source mode)
        # and leave their results by seq; the committer takes them in seq
        # order
        self._claim_lock = threading.Lock()
        self._next_seq = 0
        self._ready = threading.Condition()
        self._results: dict = {}
        self._halt_seq: Optional[int] = None   # first end or error seq
        # the run's flight-recorder correlation, taken here on the
        # constructing thread: the worker threads stamp it explicitly
        self._corr = _blackbox.current_correlation()
        self._heart = _watchdog.register(
            "tg-stream-feed", kind="stream.producer",
            on_stall=self._on_watchdog_stall)
        self._worker_hearts = [
            _watchdog.register(f"tg-stream-w{i}", kind="stream.producer",
                               on_stall=self._on_watchdog_stall)
            for i in range(self.workers)]
        self._thread = threading.Thread(
            target=self._commit_loop, name="tg-stream-feed", daemon=True)
        self._workers = [
            threading.Thread(target=self._work, args=(i,),
                             name=f"tg-stream-w{i}", daemon=True)
            for i in range(self.workers)]
        _LIVE.add(self)
        self._thread.start()
        for t in self._workers:
            t.start()

    def _on_watchdog_stall(self, heart, waited: float) -> None:
        """Abort the feed (the watchdog's scanner thread): drain the queue
        and put the typed error in its place, so a consumer blocked on an
        empty or a full queue wakes."""
        err = WatchdogStallError(
            f"stream feed producer stalled {waited:.1f}s "
            f"(> TG_WATCHDOG_S); aborting the feed")
        self._stall_error = err
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        try:
            self._q.put_nowait((self._SENTINEL, err))
        except queue.Full:
            pass

    # -- claim plane (workers) ------------------------------------------------
    def _key(self, index: int) -> str:
        return chunk_cache_key(self._source.fingerprint(), index,
                               self._cache_ident, self._source.chunk_rows)

    def _read_locked(self, index: int) -> Chunk:
        """Sequential read at ``index`` (claim lock held); after cache hits
        skipped ahead, the shared iterator reopens at the miss (an
        iterable of chunks is read in order and never reopens)."""
        if self._it is None or self._it_pos != index:
            self._it = iter(self._source.chunks(index))
            self._it_pos = index
        chunk = next(self._it)
        self._it_pos = index + 1
        return chunk

    def _claim(self):
        """Claim the next schedule index: ``(seq, index, chunk, packed)``
        (``packed`` on a cache hit, ``chunk`` when the read happened under
        the lock, both None for a random-access read the worker does
        outside it), or None when nothing is left to claim."""
        with self._claim_lock:
            if self._stop.is_set():
                return None
            with self._ready:
                if (self._halt_seq is not None
                        and self._next_seq >= self._halt_seq):
                    return None
            seq = self._next_seq
            self._next_seq += 1
            index = self._start + seq if self._source is not None else seq
            try:
                # in claim order: the fault counters follow the schedule
                # at any worker count
                faults.inject("stream.read")
                if self._cache is not None:
                    t0 = time.perf_counter()
                    packed = self._cache.get(self._key(index))
                    if packed is not None:
                        self._add_stage("read", time.perf_counter() - t0)
                        if not self._random_access:
                            self._it = None  # the iterator is now behind
                        return seq, index, None, packed
                if self._random_access:
                    if index >= self._source.num_chunks:
                        self._finish(seq, ("end", None, False))
                        return None
                    return seq, index, None, None
                t0 = time.perf_counter()
                chunk = self._read_locked(index)
                self._add_stage("read", time.perf_counter() - t0)
                return seq, index, chunk, None
            except StopIteration:
                self._finish(seq, ("end", None, False))
                return None
            except BaseException as e:  # noqa: BLE001 — a kill forwards
                self._finish(seq, ("err", e, False))
                return None

    def _finish(self, seq: int, result) -> None:
        with self._ready:
            self._results[seq] = result
            if result[0] != "ok" and (self._halt_seq is None
                                      or seq < self._halt_seq):
                # the first end or error in schedule order wins: chunks
                # claimed before it still deliver, later claims never start
                self._halt_seq = seq
            self._ready.notify_all()

    def _add_stage(self, stage: str, dt: float) -> None:
        with self._lock:
            if stage == "read":
                self.stats.read_seconds += dt
            elif stage == "transform":
                self.stats.transform_seconds += dt
            else:
                self.stats.upload_seconds += dt
        if _obs_metrics.metrics_enabled():
            _obs_metrics.observe(
                "tg_stream_stage_seconds", dt, stage=stage,
                help="seconds per chunk per input-engine stage")

    def _work(self, wid: int) -> None:
        heart = self._worker_hearts[wid]
        try:
            while not self._stop.is_set():
                heart.beat()
                if not self._slots.acquire(timeout=0.1):
                    continue
                claim = self._claim()
                if claim is None:
                    self._slots.release()
                    return
                seq, index, chunk, packed = claim
                try:
                    if packed is not None:
                        self._finish(seq, ("ok", Chunk(
                            index, self._source.chunk_id(index),
                            packed.unpack()), True))
                        continue
                    if chunk is None:  # random-access read, outside the lock
                        t0 = time.perf_counter()
                        chunk = self._source.read_chunk(index)
                        self._add_stage("read", time.perf_counter() - t0)
                    self._finish(seq, ("ok", chunk, False))
                except BaseException as e:  # noqa: BLE001
                    self._finish(seq, ("err", e, False))
                    return
        finally:
            heart.close()

    # -- commit plane (one ordered committer) ---------------------------------
    def _prepare(self, chunk: Chunk):
        """Upload ``chunk`` and run the transforms on it: (table, the event
        the consumer waits on or None, bytes moved to the device)."""
        table, ready, moved = chunk.table, None, 0
        t0 = time.perf_counter()
        if self._uploader is not None:
            table, ready, moved, transform_s = self._uploader.upload(
                table, self._transforms)
            self._add_stage("transform", transform_s)
            self._add_stage("upload",
                            time.perf_counter() - t0 - transform_s)
            return table, ready, moved
        if self._to_device:
            moved = device_bytes(table)
            table = table.to_device(self.device)
        t1 = time.perf_counter()
        self._add_stage("upload", t1 - t0)
        for model in self._transforms:
            table = model.transform(table)
        self._add_stage("transform", time.perf_counter() - t1)
        return table, ready, moved

    def _commit_loop(self) -> None:
        expected = 0
        try:
            while not self._stop.is_set():
                with self._ready:
                    while (expected not in self._results
                           and not self._stop.is_set()):
                        self._heart.beat()
                        self._ready.wait(timeout=0.1)
                    if self._stop.is_set():
                        return
                    kind, payload, from_cache = self._results.pop(expected)
                expected += 1
                self._heart.beat()
                if kind == "end":
                    self._put((self._SENTINEL, None))
                    return
                if kind == "err":
                    self._put((self._SENTINEL, payload))
                    return
                chunk = payload
                # crash evidence: a process killed here died in the upload
                _sentinel_phase("device_upload")
                faults.inject("stream.upload")
                # a ResourceExhaustedError here models the chunk not
                # fitting on the card: it forwards through the queue and
                # the trainer halves the chunk row budget
                faults.inject("oom.stream")
                ready, moved = None, 0
                table = chunk.table
                if not from_cache:
                    table, ready, moved = self._prepare(chunk)
                    if self._cache is not None:
                        if ready is not None:
                            ready.synchronize()
                        self._cache.put(self._key(chunk.index),
                                        pack_table(table))
                nbytes = device_bytes(table)
                with self._lock:
                    if from_cache:
                        # a hit is host views of the packed blocks:
                        # nothing crossed to the card
                        self.stats.cache_hits += 1
                    else:
                        self.stats.upload_bytes += moved
                        if self._cache is not None:
                            self.stats.cache_misses += 1
                    self._resident += nbytes
                    self._resident_chunks += 1
                    self.stats.max_chunk_bytes = max(
                        self.stats.max_chunk_bytes, nbytes)
                    self.stats.peak_device_bytes = max(
                        self.stats.peak_device_bytes, self._resident)
                    self.stats.peak_resident_chunks = max(
                        self.stats.peak_resident_chunks,
                        self._resident_chunks)
                _blackbox.record("stream.upload", corr=self._corr,
                                 chunk=chunk.index, bytes=nbytes,
                                 fromCache=from_cache)
                if not from_cache:
                    # the observatory: the upload's shape-derived bytes
                    # and, on the card, the allocator's measured peak
                    _devicemem.record_dispatch("stream", nbytes,
                                               rows=chunk.rows)
                    _devicemem.sample_measured("stream")
                self._put((Chunk(chunk.index, chunk.chunk_id, table),
                           (nbytes, ready)))
        except BaseException as e:  # noqa: BLE001 — a kill must forward
            self._put((self._SENTINEL, e))
        finally:
            # a finished committer has nothing left to stall on: an open
            # heart would flag a slow consumer as a feed stall
            self._heart.close()

    def _put(self, item) -> None:
        while not self._stop.is_set():
            self._heart.beat()
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    # -- consumer -------------------------------------------------------------
    def __iter__(self) -> Iterator[Chunk]:
        return self

    def __next__(self) -> Chunk:
        self._release_prev()
        t0 = time.perf_counter()
        while True:
            try:
                item, extra = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if self._stall_error is not None:
                    # the watchdog aborted the feed: fail the consumer
                    # with the typed error instead of waiting
                    err = self._stall_error
                    self.close()
                    raise err
                if not self._thread.is_alive() and self._q.empty():
                    raise RuntimeError(
                        "stream feed producer died without a sentinel")
        self.stats.wait_seconds += time.perf_counter() - t0
        self._slots.release()
        if item is self._SENTINEL:
            self.stats.wall_seconds = time.perf_counter() - self._t0
            self.close()
            if extra is not None:
                raise extra
            raise StopIteration
        nbytes, ready = extra
        if ready is not None:
            self._consumer.wait_event(ready)
        self._prev_bytes = nbytes
        self.stats.chunks += 1
        self.stats.rows += item.rows
        return item

    def _release_prev(self) -> None:
        if self._prev_bytes:
            with self._lock:
                self._resident -= self._prev_bytes
                self._resident_chunks -= 1
            self._prev_bytes = 0

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self._stop.set()
        with self._ready:
            self._ready.notify_all()
        # drain, so a committer blocked in put() wakes and exits
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        for t in self._workers:
            t.join(timeout=2.0)
        for t in [self._thread] + self._workers:
            if t.is_alive():
                # a pool thread still alive is recorded, never dropped
                _watchdog.report_thread_stalled(
                    site="stream.close", thread_name=t.name,
                    waited_s=5.0 if t is self._thread else 2.0)
        self._heart.close()
        for h in self._worker_hearts:
            h.close()
        if self.stats.wall_seconds == 0.0:
            self.stats.wall_seconds = time.perf_counter() - self._t0
        if _obs_metrics.metrics_enabled():
            _obs_metrics.inc_counter(
                "tg_stream_chunks_total", float(self.stats.chunks),
                help="chunks consumed through the streaming device feed")
            _obs_metrics.inc_counter(
                "tg_stream_rows_total", float(self.stats.rows),
                help="rows consumed through the streaming device feed")
            _obs_metrics.observe(
                "tg_stream_wait_seconds", self.stats.wait_seconds,
                help="consumer seconds stalled waiting on the chunk feed")

    def __enter__(self) -> "DeviceFeed":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
