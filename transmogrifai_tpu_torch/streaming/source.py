"""Chunk sources (counterpart of ``transmogrifai_tpu.streaming.source``):
the out-of-core replacement for "materialize the table".

A :class:`ChunkSource` is a re-iterable, deterministic producer of
fixed-row-budget host :class:`~..table.FeatureTable` chunks. Determinism
carries the resume contract: a resumed train replays the same chunk
sequence from the last committed chunk, so every fold is bit-identical to
the uninterrupted run.

* chunk ``index`` is the position in the schedule and ``chunk_id`` is
  ``<source fingerprint>:<index>``, stable across processes;
* ``chunks(start=k)`` restarts mid-schedule without replaying chunks < k;
* ``fingerprint()`` commits to the dataset and the chunk schedule and is
  embedded in every stream checkpoint, so a resume against other data (or
  another ``chunk_rows``) is detected, never folded in.

The fingerprints are the JAX package's, so a checkpoint directory either
package wrote resumes in the other. ``SyntheticChunkSource``'s chunk ``i``
is a pure function of ``(seed, i, chunk_rows)`` through numpy's
``RandomState``, the JAX package's bytes. ``AvroChunkSource`` reads
through the port's ``utils.avro`` and ``readers.Frame`` (the JAX package
reads through pandas).
"""
from __future__ import annotations

import abc
import hashlib
import os
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np

from ..table import FeatureTable

#: default fixed row budget per chunk (TG_STREAM_CHUNK_ROWS)
CHUNK_ROWS_ENV = "TG_STREAM_CHUNK_ROWS"
DEFAULT_CHUNK_ROWS = 65_536


def env_chunk_rows(chunk_rows: Optional[int] = None) -> int:
    if chunk_rows is not None:
        return max(1, int(chunk_rows))
    try:
        return max(1, int(os.environ.get(CHUNK_ROWS_ENV, "")
                          or DEFAULT_CHUNK_ROWS))
    except ValueError:
        return DEFAULT_CHUNK_ROWS


@dataclass
class Chunk:
    """One fixed-budget slice of the logical dataset."""
    index: int
    chunk_id: str
    table: FeatureTable

    @property
    def rows(self) -> int:
        return self.table.num_rows


class ChunkSource(abc.ABC):
    """Deterministic, re-iterable producer of FeatureTable chunks."""

    chunk_rows: int = DEFAULT_CHUNK_ROWS

    #: True when ``read_chunk(i)`` is O(chunk) for any i: the feed's
    #: workers then read claimed indices in parallel (``feed``).
    #: Sequential sources (Avro's record stream) keep False: their reads
    #: serialize under the claim lock.
    random_access: bool = False

    @abc.abstractmethod
    def fingerprint(self) -> str:
        """Stable hex digest of (dataset identity, chunk schedule)."""

    @property
    @abc.abstractmethod
    def num_chunks(self) -> int:
        """Chunks in one full pass (the schedule length)."""

    @abc.abstractmethod
    def chunks(self, start: int = 0) -> Iterator[Chunk]:
        """Yield chunks ``start..num_chunks-1`` of the fixed schedule."""

    def bind(self, raw_features: Sequence) -> None:
        """Called by the streaming trainer before the first pass; sources
        that build tables from records (Avro) need the raw feature set."""

    def with_chunk_rows(self, chunk_rows: int) -> "ChunkSource":
        """The same logical dataset re-chunked at ``chunk_rows`` rows per
        chunk, what the trainer's memory-pressure downshift halves to
        (``robustness.resources``). Sources that cannot re-chunk
        deterministically leave this unimplemented; exhaustion then
        propagates instead of downshifting."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support re-chunking")

    def chunk_id(self, index: int) -> str:
        return f"{self.fingerprint()[:16]}:{index:06d}"

    def read_chunk(self, index: int) -> Chunk:
        """Chunk ``index`` of the fixed schedule, in isolation. The
        default derives it from ``chunks(start=index)`` — correct for
        every source but O(prefix) for sequential ones; sources that set
        ``random_access = True`` make this O(chunk)."""
        chunk = next(iter(self.chunks(start=index)), None)
        if chunk is None or chunk.index != index:
            raise IndexError(f"chunk {index} is past the schedule "
                             f"({self.num_chunks} chunks)")
        return chunk


class TableChunkSource(ChunkSource):
    """Chunks over an in-memory host FeatureTable (``take`` slices): a
    streamed fold over ``TableChunkSource(t, chunk_rows=len(t))`` is the
    in-core fit of the fold's arithmetic."""

    random_access = True  # chunk i is one O(chunk) take() slice

    def __init__(self, table: FeatureTable, chunk_rows: Optional[int] = None):
        self.table = table
        self.chunk_rows = env_chunk_rows(chunk_rows)
        self._fp: Optional[str] = None

    def with_chunk_rows(self, chunk_rows: int) -> "TableChunkSource":
        return TableChunkSource(self.table, chunk_rows)

    def fingerprint(self) -> str:
        if self._fp is None:
            h = hashlib.sha256()
            h.update(f"table:{self.table.num_rows}:{self.chunk_rows}".encode())
            for name in sorted(self.table.column_names):
                col = self.table[name]
                h.update(f"{name}:{col.kind}:{col.width}".encode())
                vals = col.host_values()
                if vals.dtype != object and vals.size:
                    # a strided content sample: catches "same shape, other
                    # data" resumes
                    flat = np.ascontiguousarray(vals).reshape(-1)
                    h.update(flat[::max(1, flat.size // 256)].tobytes())
            self._fp = h.hexdigest()
        return self._fp

    @property
    def num_chunks(self) -> int:
        return max(1, -(-self.table.num_rows // self.chunk_rows))

    def chunks(self, start: int = 0) -> Iterator[Chunk]:
        n = self.table.num_rows
        for i in range(start, self.num_chunks):
            lo = i * self.chunk_rows
            hi = min(n, lo + self.chunk_rows)
            yield Chunk(i, self.chunk_id(i),
                        self.table.take(np.arange(lo, hi)))


class AvroChunkSource(ChunkSource):
    """Chunks decoded incrementally from an Avro container file
    (``utils.avro.read_avro`` iterates records, so the file never
    materializes whole); nested records flatten as ``AvroReader``
    flattens them."""

    def __init__(self, path: str, chunk_rows: Optional[int] = None,
                 raw_features: Optional[Sequence] = None):
        self.path = path
        self.chunk_rows = env_chunk_rows(chunk_rows)
        self.raw_features = tuple(raw_features) if raw_features else None
        self._num_chunks: Optional[int] = None

    def bind(self, raw_features: Sequence) -> None:
        if self.raw_features is None:
            self.raw_features = tuple(raw_features)

    def with_chunk_rows(self, chunk_rows: int) -> "AvroChunkSource":
        return AvroChunkSource(self.path, chunk_rows, self.raw_features)

    def fingerprint(self) -> str:
        st = os.stat(self.path)
        ident = f"avro:{os.path.abspath(self.path)}:{st.st_size}:{self.chunk_rows}"
        return hashlib.sha256(ident.encode()).hexdigest()

    @property
    def num_chunks(self) -> int:
        if self._num_chunks is None:
            from ..utils.avro import read_avro
            n = sum(1 for _ in read_avro(self.path))
            self._num_chunks = max(1, -(-n // self.chunk_rows))
        return self._num_chunks

    def chunks(self, start: int = 0) -> Iterator[Chunk]:
        from ..readers.readers import flatten_record
        from ..utils.avro import read_avro
        if self.raw_features is None:
            raise ValueError("AvroChunkSource needs raw_features: pass them "
                             "to the constructor or let the trainer bind()")
        buf = []
        index = 0
        for rec in read_avro(self.path):
            buf.append(flatten_record(rec))
            if len(buf) == self.chunk_rows:
                if index >= start:
                    yield self._emit(buf, index)
                buf = []
                index += 1
        if buf or index == 0:
            if index >= start:
                yield self._emit(buf, index)
            index += 1
        self._num_chunks = index

    def _emit(self, records, index: int) -> Chunk:
        from ..readers.readers import Frame, frame_to_table
        table = frame_to_table(Frame.of(records), self.raw_features)
        return Chunk(index, self.chunk_id(index), table)


class SyntheticChunkSource(ChunkSource):
    """Deterministic synthetic generator: chunk ``i`` is a pure function of
    ``(seed, i, chunk_rows)``, so any chunk regenerates on its own, a
    resume never replays the prefix and no pass materializes the dataset
    (the stream workload of ``chip_smoke.py``: 1,000,000 x 64).

    Emits ``x0..x{d-1}`` Real predictor columns (a deterministic ~3% of
    slots masked invalid) and a RealNN ``y`` response from a fixed hidden
    linear model — binary 0/1 by default, continuous for
    ``problem='regression'``.
    """

    random_access = True  # chunk i is a pure function of (seed, i)

    def __init__(self, num_rows: int, num_features: int,
                 chunk_rows: Optional[int] = None, seed: int = 0,
                 problem: str = "binary", missing_rate: float = 0.03):
        self.num_rows = int(num_rows)
        self.num_features = int(num_features)
        self.chunk_rows = env_chunk_rows(chunk_rows)
        self.seed = int(seed)
        self.problem = problem
        self.missing_rate = float(missing_rate)
        self._w = np.random.RandomState(seed).randn(num_features).astype(
            np.float64)

    # no ``with_chunk_rows``: chunk ``i``'s rows are a pure function of
    # ``(seed, i, chunk_rows)``, so re-chunking would change the data, not
    # the schedule; the memory-pressure downshift propagates instead of
    # folding another dataset

    def fingerprint(self) -> str:
        ident = (f"synthetic:{self.num_rows}:{self.num_features}:"
                 f"{self.chunk_rows}:{self.seed}:{self.problem}:"
                 f"{self.missing_rate}")
        return hashlib.sha256(ident.encode()).hexdigest()

    @property
    def num_chunks(self) -> int:
        return max(1, -(-self.num_rows // self.chunk_rows))

    def chunks(self, start: int = 0) -> Iterator[Chunk]:
        from ..table import Column
        from ..types import Real, RealNN
        for i in range(start, self.num_chunks):
            lo = i * self.chunk_rows
            n = min(self.num_rows, lo + self.chunk_rows) - lo
            rng = np.random.RandomState(
                (self.seed * 1_000_003 + i) % (2 ** 31 - 1))
            X = rng.randn(n, self.num_features).astype(np.float32)
            mask = rng.rand(n, self.num_features) >= self.missing_rate
            z = (np.where(mask, X, 0.0).astype(np.float64) @ self._w)
            if self.problem == "regression":
                y = (z + rng.randn(n)).astype(np.float32)
            else:
                y = (z > 0).astype(np.float32)
            cols = {f"x{j}": Column(Real, X[:, j], mask[:, j])
                    for j in range(self.num_features)}
            cols["y"] = Column(RealNN, y, None)
            yield Chunk(i, self.chunk_id(i), FeatureTable(cols, n))
