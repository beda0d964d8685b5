"""Transformed-chunk cache (counterpart of
``transmogrifai_tpu.streaming.cache``): skip read, transform and upload on
repeat passes.

A transformed chunk is a pure function of four identities::

    (source fingerprint) x (chunk index) x (fitted-transform identity) x
    (chunk row budget)

so once a pass has paid for chunk ``i``, every later pass with the same
upstream models can replay its bytes. The streamed GBT makes ``1 + trees
x (depth + 1)`` passes over one transformed stream; the cache turns that
into re-reading host blocks.

Two bounded tiers:

* **host tier**: packed per-dtype blocks, LRU under
  ``TG_STREAM_CACHE_BYTES`` (default 256 MiB; ``0`` disables);
* **disk tier** (optional): one npz per chunk under
  ``TG_STREAM_CACHE_DIR``, written atomically and sha256-verified on every
  read, so entries survive a kill and a resumed train skips the work its
  predecessor paid for.

The cache can only be slower, never wrong: a miss, an evicted entry, a
sha256 or header mismatch, or the ``stream.cache`` site firing all take
the same fallback, a recompute from the source (bit-equal by the
determinism contract) with ``stream_cache_fallback`` in the fault log. A
hit is delivered as host numpy views of the packed blocks: the folds read
host arrays, so nothing crosses to the card. A chunk transformed on the
card is packed from its host copy (``pack_table``).
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

import torch

from ..observability import metrics as _obs_metrics
from ..robustness import faults
from ..robustness.policy import FaultLog, FaultReport
from ..table import Column, FeatureTable
from ..types import feature_type_by_name

CACHE_BYTES_ENV = "TG_STREAM_CACHE_BYTES"
CACHE_DIR_ENV = "TG_STREAM_CACHE_DIR"
DEFAULT_CACHE_BYTES = 256 * 1024 * 1024


def env_cache_bytes(max_bytes: Optional[int] = None) -> int:
    if max_bytes is not None:
        return max(0, int(max_bytes))
    try:
        raw = os.environ.get(CACHE_BYTES_ENV, "")
        return max(0, int(raw)) if raw else DEFAULT_CACHE_BYTES
    except ValueError:
        return DEFAULT_CACHE_BYTES


def env_cache_dir() -> Optional[str]:
    return os.environ.get(CACHE_DIR_ENV) or None


def transform_identity(models: Sequence[Any]) -> str:
    """Stable digest of the fitted upstream transform stack: the form model
    persistence writes (class, uid and fitted state, arrays hashed by
    content). A model that does not serialize hashes as process-unique: a
    guaranteed miss, never a wrong hit."""
    from ..persistence import _Arrays, stage_to_json
    h = hashlib.sha256()
    for m in models:
        arrays = _Arrays()
        try:
            d = stage_to_json(m, arrays)
            h.update(json.dumps(d, sort_keys=True, default=repr).encode())
            for k in sorted(arrays.store):
                a = arrays.store[k]
                h.update(f"{k}:{a.dtype}:{a.shape}".encode())
                h.update(np.ascontiguousarray(a).tobytes())
        except Exception:
            h.update(f"opaque:{type(m).__name__}:{id(m)}".encode())
    return h.hexdigest()[:16]


def chunk_cache_key(source_fingerprint: str, index: int, ident: str,
                    chunk_rows: int) -> str:
    return f"{source_fingerprint[:16]}:{ident}:{chunk_rows}:{index:06d}"


@dataclass
class PackedChunk:
    """One transformed chunk in packed per-dtype form.

    ``header`` is JSON (the disk header): the row count, the dtype block
    order and a column directory (name, feature type, dtype, shape, mask
    flag, JSON metadata). ``blocks`` hold the concatenated flattened values
    per dtype; ``mask_block`` concatenates every mask. ``extra_meta``
    carries metadata that is not JSON (``vector_meta`` objects) by
    reference, in the host tier only; a chunk from disk keeps the JSON
    part (the folds read values; the schema comes from the probe
    table).
    """
    header: Dict[str, Any]
    blocks: Dict[str, np.ndarray]
    mask_block: Optional[np.ndarray]
    key_values: Optional[np.ndarray] = None
    extra_meta: Dict[str, Mapping[str, Any]] = field(default_factory=dict)

    @property
    def rows(self) -> int:
        return int(self.header["rows"])

    @property
    def nbytes(self) -> int:
        total = sum(int(b.nbytes) for b in self.blocks.values())
        if self.mask_block is not None:
            total += int(self.mask_block.nbytes)
        if self.key_values is not None:
            total += int(self.key_values.nbytes)
        return total

    def content_sha(self) -> str:
        """Digest of the packed payload bytes (cached against recomputed
        chunks compare on it)."""
        h = hashlib.sha256()
        h.update(json.dumps(self.header, sort_keys=True).encode())
        for dt in self.header["dtypes"]:
            h.update(np.ascontiguousarray(self.blocks[dt]).tobytes())
        if self.mask_block is not None:
            h.update(np.ascontiguousarray(self.mask_block).tobytes())
        return h.hexdigest()

    def unpack(self) -> FeatureTable:
        """The host FeatureTable; column values and masks are views of the
        packed blocks (which the views keep alive, so a later eviction
        cannot touch a delivered chunk). Feature types resolve by name in
        the port's ``types``."""
        offs = {dt: 0 for dt in self.blocks}
        moff = 0
        cols: Dict[str, Column] = {}
        for d in self.header["cols"]:
            dt = d["dtype"]
            shape = tuple(d["shape"])
            size = int(np.prod(shape)) if shape else 1
            vals = self.blocks[dt][offs[dt]:offs[dt] + size].reshape(shape)
            offs[dt] += size
            mask = None
            if d["masked"]:
                n = int(d["mask_size"])
                mask = self.mask_block[moff:moff + n].reshape(
                    tuple(d["mask_shape"]))
                moff += n
            meta = dict(d.get("meta") or {})
            meta.update(self.extra_meta.get(d["name"], {}))
            ftype = feature_type_by_name(d["type"].rpartition(":")[2])
            cols[d["name"]] = Column(ftype, vals, mask, meta)
        return FeatureTable(cols, self.rows, self.key_values)


def pack_table(table: FeatureTable) -> Optional[PackedChunk]:
    """Pack a transformed chunk table (tensor columns copied to the host);
    ``None`` when the chunk is not cacheable: any object column (text or
    map payloads not vectorized) makes the whole chunk uncacheable rather
    than partly cached."""
    key_values = table.key
    if key_values is not None:
        key_values = np.asarray(key_values)
        if key_values.dtype == object:
            return None
    directory: List[Dict[str, Any]] = []
    by_dtype: "OrderedDict[str, List[np.ndarray]]" = OrderedDict()
    masks: List[np.ndarray] = []
    extra_meta: Dict[str, Mapping[str, Any]] = {}
    for name in table.column_names:
        col = table[name]
        vals = col.values
        if isinstance(vals, torch.Tensor):
            vals = vals.cpu().numpy()
        if not isinstance(vals, np.ndarray) or vals.dtype == object:
            return None
        mask = None if col.mask is None else col.valid_mask()
        jsonable: Dict[str, Any] = {}
        opaque: Dict[str, Any] = {}
        for k, v in dict(col.metadata).items():
            try:
                json.dumps({k: v})
                jsonable[k] = v
            except (TypeError, ValueError):
                opaque[k] = v
        if opaque:
            extra_meta[name] = opaque
        directory.append({
            "name": name,
            "type": f"{col.feature_type.__module__}:"
                    f"{col.feature_type.__qualname__}",
            "dtype": str(vals.dtype), "shape": list(vals.shape),
            "masked": mask is not None,
            "mask_size": 0 if mask is None else int(mask.size),
            "mask_shape": [] if mask is None else list(mask.shape),
            "meta": jsonable,
        })
        by_dtype.setdefault(str(vals.dtype), []).append(
            np.ascontiguousarray(vals).reshape(-1))
        if mask is not None:
            masks.append(np.ascontiguousarray(mask).reshape(-1))
    blocks = {dt: (np.concatenate(parts) if len(parts) > 1 else parts[0])
              for dt, parts in by_dtype.items()}
    mask_block = (np.concatenate(masks) if len(masks) > 1
                  else masks[0] if masks else None)
    header = {"rows": table.num_rows, "dtypes": list(blocks),
              "cols": directory}
    return PackedChunk(header, blocks, mask_block, key_values, extra_meta)


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    stores: int = 0
    evictions: int = 0
    skipped: int = 0          # uncacheable chunks (object columns)
    fallbacks: int = 0        # corrupt/chaos entries recomputed from source
    disk_hits: int = 0
    hit_bytes: int = 0
    host_bytes: int = 0       # current host-tier residency

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def to_json(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "stores": self.stores, "evictions": self.evictions,
                "skipped": self.skipped, "fallbacks": self.fallbacks,
                "diskHits": self.disk_hits, "hitBytes": self.hit_bytes,
                "hostBytes": self.host_bytes,
                "hitRate": round(self.hit_rate(), 4)}


class CorruptCacheEntry(RuntimeError):
    """A disk-tier entry failed its sha256 or header check (``get`` turns
    it into the recompute fallback)."""


class ChunkCache:
    """Bounded two-tier transformed-chunk cache (host LRU and a
    sha256-verified disk tier). Thread-safe: the feed's threads get and
    put concurrently."""

    def __init__(self, max_bytes: Optional[int] = None,
                 disk_dir: Optional[str] = None):
        self.max_bytes = env_cache_bytes(max_bytes)
        self.disk_dir = disk_dir
        self.stats = CacheStats()
        self._lock = threading.Lock()
        self._host: "OrderedDict[str, PackedChunk]" = OrderedDict()
        # fallbacks are reported on the feed's worker threads, which do not
        # see the consumer's ambient FaultLog: the feed binds the run's
        # log here
        self._log: Optional[FaultLog] = None

    def bind_log(self, log: Optional[FaultLog]) -> None:
        """Bind the owning run's FaultLog, so fallbacks on worker threads
        land in it (``DeviceFeed`` calls this on the consumer thread)."""
        if log is not None:
            self._log = log

    @classmethod
    def from_env(cls, disk_dir: Optional[str] = None,
                 ) -> Optional["ChunkCache"]:
        """The workflow's cache: the host budget from
        ``TG_STREAM_CACHE_BYTES``, the disk tier in ``TG_STREAM_CACHE_DIR``
        (``<checkpoint dir>/stream_cache`` keeps it beside the fold states
        it matches). None when both tiers are off."""
        max_bytes = env_cache_bytes()
        disk = env_cache_dir() or disk_dir
        if max_bytes <= 0 and not disk:
            return None
        return cls(max_bytes=max_bytes, disk_dir=disk)

    # -- lookup ---------------------------------------------------------------
    def get(self, key: str) -> Optional[PackedChunk]:
        """The packed chunk of ``key``, or ``None`` (a miss: the caller
        recomputes from the source). Every failure inside (the
        ``stream.cache`` site, a sha256 or header mismatch on the disk
        tier) takes the same recompute fallback; a preemption (a
        ``BaseException``) propagates like any other kill."""
        try:
            faults.inject("stream.cache")
            with self._lock:
                entry = self._host.get(key)
                if entry is not None:
                    self._host.move_to_end(key)
            if entry is None and self.disk_dir:
                entry = self._disk_read(key)
                if entry is not None:
                    self.stats.disk_hits += 1
                    self._host_insert(key, entry)
        except CorruptCacheEntry as e:
            self._fallback(key, str(e))
            entry = None
        except Exception as e:  # an injected raise: recompute, never wrong data
            self._fallback(key, f"{type(e).__name__}: {e}")
            entry = None
        if entry is None:
            self.stats.misses += 1
            _obs_metrics.inc_counter(
                "tg_stream_cache_misses_total", 1.0,
                help="transformed-chunk cache misses (chunk recomputed)")
            return None
        self.stats.hits += 1
        self.stats.hit_bytes += entry.nbytes
        _obs_metrics.inc_counter(
            "tg_stream_cache_hits_total", 1.0,
            help="transformed-chunk cache hits (read+transform skipped)")
        return entry

    def _fallback(self, key: str, reason: str) -> None:
        self.stats.fallbacks += 1
        report = FaultReport(
            site="stream.cache", kind="stream_cache_fallback",
            detail={"key": key, "reason": reason[:200]})
        if self._log is not None:
            self._log.add(report)
        else:
            FaultLog.record(report)

    # -- store ----------------------------------------------------------------
    def put(self, key: str, packed: Optional[PackedChunk]) -> None:
        if packed is None:
            self.stats.skipped += 1
            return
        self.stats.stores += 1
        self._host_insert(key, packed)
        if self.disk_dir:
            try:
                self._disk_write(key, packed)
            except OSError as e:
                self._fallback(key, f"disk store failed: {e}")

    def _host_insert(self, key: str, packed: PackedChunk) -> None:
        if self.max_bytes <= 0 or packed.nbytes > self.max_bytes:
            return
        with self._lock:
            prev = self._host.pop(key, None)
            if prev is not None:
                self.stats.host_bytes -= prev.nbytes
            while (self._host
                   and self.stats.host_bytes + packed.nbytes
                   > self.max_bytes):
                _, evicted = self._host.popitem(last=False)
                self.stats.host_bytes -= evicted.nbytes
                self.stats.evictions += 1
            self._host[key] = packed
            self.stats.host_bytes += packed.nbytes

    # -- disk tier ------------------------------------------------------------
    def _paths(self, key: str) -> "tuple[str, str]":
        fname = f"chunk_{hashlib.sha256(key.encode()).hexdigest()[:24]}.npz"
        path = os.path.join(self.disk_dir, fname)
        return path, path + ".sha256"

    def _disk_write(self, key: str, packed: PackedChunk) -> None:
        from ..manifest import atomic_write_bytes
        os.makedirs(self.disk_dir, exist_ok=True)
        path, shapath = self._paths(key)
        if os.path.exists(path):
            return
        header = dict(packed.header)
        header["key"] = key
        arrays = {"__header__": np.frombuffer(
            json.dumps(header, sort_keys=True).encode(), dtype=np.uint8)}
        for i, dt in enumerate(packed.header["dtypes"]):
            arrays[f"block_{i}"] = packed.blocks[dt]
        if packed.mask_block is not None:
            arrays["mask"] = packed.mask_block
        if packed.key_values is not None:
            arrays["key_values"] = packed.key_values
        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        data = buf.getvalue()
        sha = atomic_write_bytes(path, data)
        atomic_write_bytes(shapath, sha.encode())

    def _disk_read(self, key: str) -> Optional[PackedChunk]:
        path, shapath = self._paths(key)
        if not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                data = f.read()
            with open(shapath, "rb") as f:
                want = f.read().decode().strip()
        except OSError as e:
            raise CorruptCacheEntry(f"unreadable entry: {e}")
        got = hashlib.sha256(data).hexdigest()
        if got != want:
            self._evict_disk(path, shapath)
            raise CorruptCacheEntry(
                f"sha256 mismatch ({got[:12]} != {want[:12]})")
        try:
            with np.load(io.BytesIO(data), allow_pickle=False) as z:
                header = json.loads(bytes(z["__header__"]).decode())
                if header.pop("key", None) != key:
                    raise CorruptCacheEntry("entry key mismatch")
                blocks = {dt: z[f"block_{i}"]
                          for i, dt in enumerate(header["dtypes"])}
                mask = z["mask"] if "mask" in z.files else None
                kv = z["key_values"] if "key_values" in z.files else None
        except (ValueError, KeyError, OSError) as e:
            self._evict_disk(path, shapath)
            raise CorruptCacheEntry(f"undecodable entry: {e}")
        return PackedChunk(header, blocks, mask, kv)

    @staticmethod
    def _evict_disk(path: str, shapath: str) -> None:
        for p in (path, shapath):
            try:
                os.remove(p)
            except OSError:
                pass
