"""Compile ledger: every program build, with a *classified cause*.

A build on the serving path is tens of ms to seconds of p99, and a bare
build count never says *why did this request pay one?*. The ledger
records each build the dispatch subsystems report (the JAX package's
transform-plan segments, fused sweep programs, serve warm-up and
flushes, streaming fold passes; in the port, the kernel builds below)
with its cache key, schema fingerprint, identity and wall time, and
classifies the *cause*:

``cold``
    first build for this identity (nothing to compare against);
``schema-change``
    the identity was built before with a different schema fingerprint —
    the ledger diffs the incoming fingerprint against the previous one
    and names exactly what changed (column added/removed, dtype,
    trailing shape, mask presence);
``bucket-change``
    same identity + fingerprint, different padding bucket (row growth
    crossed a bucket boundary — utils/padding.py — or a streaming
    chunk-budget downshift re-chunked the pass);
``donation-mismatch``
    same identity + fingerprint + bucket, but the donated-argument
    signature changed (a donated buffer shape/sharding no longer aliases
    — the sweep's packed grid block);
``cache-eviction``
    an unchanged program was rebuilt — its key was evicted from a
    bounded LRU (``TG_PLAN_CACHE_MAX``; the caches report evictions
    via :func:`record_eviction`) or the cache was cleared;
``aot-miss``
    the AOT program store was active but could not serve this build —
    no entry for the key, a version or device-kind mismatch, a corrupt
    blob, or a deserialization failure (the store notes the key via
    :func:`note_aot_miss` with the miss reason right before the caller
    falls back to building; the port has no program store yet, ROADMAP
    Queue 1 item 10). Near-miss
    causes with real forensics (``schema-change``/``bucket-change``)
    still win when the identity was built before: the AOT note only
    explains builds that would otherwise read ``cold``.

In the PyTorch port a "build" is what makes a first request slow there:
``ops/cuda_build`` records each ``nvcc`` build of a kernel source and
each ``ctypes`` load of a kernel library (identity ``cuda:<source>``,
attributed to the ambient :func:`subsystem_scope`), so the warm-load gate
— the first real request after ``registry.load(warm=True)`` records zero
builds — means on the card what it means on the TPU.

Exports: ``tg_compile_total{cause,subsystem}`` +
``tg_compile_seconds{subsystem}`` through the gated metrics helpers
(zero writes when observability is off), and a ``compile`` flight-
recorder event stamped with the ambient correlation id
(observability/blackbox.py) — so ``cli doctor`` timelines show which
request or run paid a retrace.

Cost model mirrors the flight recorder: ``TG_LEDGER=0`` turns every
touch point into one flag check; enabled, a record is one lock-guarded
append of a small ``__slots__`` object into a ring bounded by
``TG_LEDGER_MAX`` (default 1024, drops counted). State is process-global
(:func:`ledger`); :func:`reset` gives tests a clean slate
(tests/conftest.py ``_no_ledger_leak``).
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

from . import blackbox as _blackbox
from . import metrics as _obs_metrics

#: env switch: "0"/falsy disables the ledger (on by default — like the
#: flight recorder, a compile ledger must be recording when the retrace
#: storm happens)
LEDGER_ENV = "TG_LEDGER"
#: ring bound (records); drops are counted in CompileLedger.dropped
LEDGER_MAX_ENV = "TG_LEDGER_MAX"
DEFAULT_MAX_RECORDS = 1024

#: the closed cause taxonomy (docs/observability.md "Compile & memory
#: ledger"); classification can return nothing else
CAUSES = ("cold", "schema-change", "bucket-change", "donation-mismatch",
          "cache-eviction", "aot-miss")

#: the dispatch subsystems that report builds (docs/observability.md)
SUBSYSTEMS = ("plan", "sweep", "serve", "stream")

_FALSY = ("0", "false", "False", "no", "off")

_enabled_override: Optional[bool] = None


def ledger_enabled() -> bool:
    """True when the compile ledger is recording (default on;
    ``TG_LEDGER=0`` disables, :func:`enable_ledger` overrides)."""
    if _enabled_override is not None:
        return _enabled_override
    return os.environ.get(LEDGER_ENV, "1") not in _FALSY


def enable_ledger(on: Optional[bool]) -> None:
    """Force the ledger on/off from code (benches, tests); ``None`` hands
    control back to the ``TG_LEDGER`` environment switch."""
    global _enabled_override
    _enabled_override = None if on is None else bool(on)


# -- subsystem attribution ---------------------------------------------------

#: the plan compiler is shared by train/score/serve/stream paths; the
#: owning subsystem scopes itself so its builds are attributed to it
#: (serving wraps warm + dispatch, streaming wraps its passes)
_SUBSYSTEM: "contextvars.ContextVar[Optional[str]]" = contextvars.ContextVar(
    "tg_ledger_subsystem", default=None)


def current_subsystem(default: str = "plan") -> str:
    """The ambient dispatch subsystem, or ``default`` outside any scope."""
    return _SUBSYSTEM.get() or default


@contextlib.contextmanager
def subsystem_scope(name: str):
    """Attribute every build recorded inside the block (same thread /
    context) to ``name`` — e.g. a plan compile during serve warmup lands
    as ``subsystem="serve"``, not ``"plan"``."""
    token = _SUBSYSTEM.set(name)
    try:
        yield name
    finally:
        _SUBSYSTEM.reset(token)


# -- fingerprint diffing -----------------------------------------------------

def _fp_columns(fp: Any) -> Optional[Dict[str, Tuple]]:
    """Plan-style fingerprints — ``[[name, dtype, trailing, maskless]]``
    — as a name-keyed dict; None for any other shape."""
    if not isinstance(fp, (list, tuple)):
        return None
    out: Dict[str, Tuple] = {}
    for item in fp:
        if not isinstance(item, (list, tuple)) or len(item) != 4:
            return None
        nm, dt, shape, maskless = item
        out[str(nm)] = (str(dt), tuple(shape), bool(maskless))
    return out


def fingerprint_diff(old: Any, new: Any) -> List[str]:
    """Name exactly what changed between two schema fingerprints —
    the near-miss forensics a bare cache miss can never give. Handles
    the plan-cache column fingerprint (per-column dtype / trailing shape
    / mask presence), flat dict fingerprints (the sweep's config shape),
    and falls back to a repr comparison for anything else."""
    a, b = _fp_columns(old), _fp_columns(new)
    if a is not None and b is not None:
        diffs: List[str] = []
        for nm in sorted(set(a) | set(b)):
            if nm not in a:
                diffs.append(f"column added: '{nm}'")
            elif nm not in b:
                diffs.append(f"column removed: '{nm}'")
            else:
                (dt0, sh0, m0), (dt1, sh1, m1) = a[nm], b[nm]
                if dt0 != dt1:
                    diffs.append(f"column '{nm}': dtype {dt0} -> {dt1}")
                if sh0 != sh1:
                    diffs.append(f"column '{nm}': trailing shape "
                                 f"{list(sh0)} -> {list(sh1)}")
                if m0 != m1:
                    diffs.append(f"column '{nm}': mask "
                                 f"{'absent' if m0 else 'present'} -> "
                                 f"{'absent' if m1 else 'present'}")
        return diffs or ["fingerprints differ (no field-level delta found)"]
    if isinstance(old, dict) and isinstance(new, dict):
        diffs = []
        for k in sorted(set(old) | set(new)):
            if old.get(k) != new.get(k):
                diffs.append(f"{k}: {old.get(k)!r} -> {new.get(k)!r}")
        return diffs or ["fingerprints differ (no field-level delta found)"]
    return [f"fingerprint changed: {str(old)[:80]!r} -> {str(new)[:80]!r}"]


# -- records + ledger --------------------------------------------------------

class CompileRecord:
    """One program build. ``identity`` is the stable program identity the
    cause classification compares against (stage-uid sequence, sweep
    family, stream pass); ``key`` the exact cache key (hashed); ``diff``
    the named fields that changed when the cause is a near-miss."""

    __slots__ = ("seq", "subsystem", "identity", "key", "fingerprint",
                 "bucket", "donation", "cause", "diff", "seconds", "corr",
                 "ts_unix", "attrs")

    def __init__(self, seq: int, subsystem: str, identity: str, key: str,
                 fingerprint: Any, bucket: Optional[int],
                 donation: Optional[Tuple], cause: str, diff: List[str],
                 seconds: float, corr: Optional[str],
                 attrs: Dict[str, Any]):
        self.seq = seq
        self.subsystem = subsystem
        self.identity = identity
        self.key = key
        self.fingerprint = fingerprint
        self.bucket = bucket
        self.donation = donation
        self.cause = cause
        self.diff = diff
        self.seconds = seconds
        self.corr = corr
        self.ts_unix = time.time()
        self.attrs = attrs

    def to_json(self) -> Dict[str, Any]:
        return {"seq": self.seq, "subsystem": self.subsystem,
                "identity": self.identity, "key": self.key,
                "fingerprint": self.fingerprint, "bucket": self.bucket,
                "cause": self.cause, "diff": list(self.diff),
                "seconds": round(self.seconds, 6), "corr": self.corr,
                "unixTime": self.ts_unix, "attrs": dict(self.attrs)}


class CompileLedger:
    """The bounded build ring + per-identity classification memory. One
    module-level singleton records the process (:func:`ledger`); tests
    build their own instances."""

    #: how many evicted keys the eviction memory holds (older evictions
    #: age out — by then the rebuild they explain has long happened)
    EVICTED_MAX = 256

    def __init__(self, max_records: Optional[int] = None):
        if max_records is None:
            try:
                max_records = int(os.environ.get(LEDGER_MAX_ENV, "")
                                  or DEFAULT_MAX_RECORDS)
            except ValueError:
                max_records = DEFAULT_MAX_RECORDS
        self.max_records = max(1, int(max_records))
        self._records: deque = deque(maxlen=self.max_records)
        self.dropped = 0
        self._seq = 0
        self._lock = threading.Lock()
        #: identity → last build (the classification baseline); NOT ring-
        #: bounded — one entry per distinct program identity, the same
        #: O(#programs) footprint the compile caches already pay
        self._last: Dict[str, CompileRecord] = {}
        #: keys reported evicted by the bounded caches, awaiting rebuild
        self._evicted: "OrderedDict[str, bool]" = OrderedDict()
        #: keys the AOT program store failed to serve, awaiting the
        #: trace-path build they explain (key -> miss reason; bounded
        #: like the eviction memory)
        self._aot_misses: "OrderedDict[str, str]" = OrderedDict()
        #: (subsystem, cause) → builds (survives ring wrap)
        self._counts: Dict[Tuple[str, str], int] = {}
        self.seconds_total = 0.0

    # -- cache cooperation ---------------------------------------------------
    def record_eviction(self, key: str) -> None:
        """A bounded cache dropped ``key``: the next rebuild of that exact
        key is a ``cache-eviction``, not a mystery ``cold``."""
        if not ledger_enabled():
            return
        with self._lock:
            self._evicted[key] = True
            while len(self._evicted) > self.EVICTED_MAX:
                self._evicted.popitem(last=False)

    def note_aot_miss(self, key: str, reason: str) -> None:
        """The AOT program store could not serve ``key``: the trace-path
        build the caller is about to pay classifies ``aot-miss`` with
        ``reason`` as its diff (programstore/store.py fallback ladder)."""
        if not ledger_enabled():
            return
        with self._lock:
            self._aot_misses[key] = reason
            while len(self._aot_misses) > self.EVICTED_MAX:
                self._aot_misses.popitem(last=False)

    # -- classification ------------------------------------------------------
    def _classify(self, identity: str, key: str, fingerprint: Any,
                  bucket: Optional[int], donation: Optional[Tuple]
                  ) -> Tuple[str, List[str]]:
        """Lock held. Compare against the identity's previous build."""
        prev = self._last.get(identity)
        evicted = self._evicted.pop(key, False)
        aot_reason = self._aot_misses.pop(key, None)
        if prev is None:
            # a would-be-cold build the AOT store should have served:
            # name the miss. Builds with an in-process baseline keep
            # their richer near-miss causes (schema/bucket diffs) below.
            if aot_reason is not None:
                return "aot-miss", [aot_reason]
            return "cold", []
        if prev.fingerprint != fingerprint:
            diff = fingerprint_diff(prev.fingerprint, fingerprint)
            if bucket is not None and prev.bucket != bucket:
                diff.append(f"bucket {prev.bucket} -> {bucket}")
            return "schema-change", diff
        if bucket is not None and prev.bucket != bucket:
            return "bucket-change", [f"bucket {prev.bucket} -> {bucket}"]
        if donation != prev.donation:
            return "donation-mismatch", [
                f"donated args {prev.donation!r} -> {donation!r}"]
        # unchanged program rebuilt: the cached executable was lost
        diff = (["key evicted from a bounded cache"] if evicted
                else ["program rebuilt with unchanged key (cache cleared)"])
        return "cache-eviction", diff

    # -- recording (the instrumented-site entry point) -----------------------
    def record_build(self, subsystem: str, identity: str, key: str,
                     fingerprint: Any = None, seconds: float = 0.0,
                     bucket: Optional[int] = None,
                     donation: Optional[Tuple] = None,
                     corr: Optional[str] = None,
                     **attrs: Any) -> Optional[CompileRecord]:
        """Record one program build; returns the classified record (None
        when the ledger is disabled — zero writes, zero state)."""
        if not ledger_enabled():
            return None
        if corr is None:
            corr = _blackbox.current_correlation()
        with self._lock:
            cause, diff = self._classify(identity, key, fingerprint,
                                         bucket, donation)
            self._seq += 1
            rec = CompileRecord(self._seq, subsystem, identity, key,
                                fingerprint, bucket, donation, cause, diff,
                                float(seconds), corr, attrs)
            if len(self._records) == self._records.maxlen:
                self.dropped += 1
            self._records.append(rec)
            self._last[identity] = rec
            ck = (subsystem, cause)
            self._counts[ck] = self._counts.get(ck, 0) + 1
            self.seconds_total += float(seconds)
        _obs_metrics.inc_counter(
            "tg_compile_total", 1.0, cause=cause, subsystem=subsystem,
            help="program builds by classified cause and dispatch "
            "subsystem (docs/observability.md)")
        _obs_metrics.observe(
            "tg_compile_seconds", float(seconds), subsystem=subsystem,
            help="wall seconds per program build (trace + first-dispatch "
            "compile)")
        _blackbox.record("compile", corr=corr, subsystem=subsystem,
                         identity=identity, cause=cause,
                         seconds=round(float(seconds), 4),
                         diff=diff[0] if diff else None)
        return rec

    # -- queries -------------------------------------------------------------
    @property
    def total(self) -> int:
        with self._lock:
            return self._seq

    def mark(self) -> int:
        """A watermark for :meth:`since` — e.g. taken right after a warm
        ``registry.load`` so the zero-retrace gate can assert no build
        happened past it."""
        return self.total

    def since(self, mark: int) -> List[CompileRecord]:
        """Every ring record with ``seq > mark`` (oldest first). Records
        past the ring bound are gone from the ring but still counted —
        compare :attr:`total` against the mark for the exact count."""
        with self._lock:
            return [r for r in self._records if r.seq > mark]

    def entries(self) -> List[CompileRecord]:
        with self._lock:
            return list(self._records)

    def tail(self, n: int) -> List[CompileRecord]:
        with self._lock:
            if n >= len(self._records):
                return list(self._records)
            return list(self._records)[-n:]

    def counts(self) -> Dict[str, Dict[str, int]]:
        """``{subsystem: {cause: builds}}`` over the full process history
        (not just the ring)."""
        with self._lock:
            out: Dict[str, Dict[str, int]] = {}
            for (sub, cause), n in sorted(self._counts.items()):
                out.setdefault(sub, {})[cause] = n
            return out

    def counts_by_cause(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for (_sub, cause), n in self._counts.items():
                out[cause] = out.get(cause, 0) + n
            return dict(sorted(out.items()))

    def snapshot(self) -> Dict[str, Any]:
        """Ring + counter accounting for ``summary()`` / bundles."""
        with self._lock:
            by_sub: Dict[str, Dict[str, int]] = {}
            for (sub, cause), n in sorted(self._counts.items()):
                by_sub.setdefault(sub, {})[cause] = n
            return {"builds": self._seq,
                    "secondsTotal": round(self.seconds_total, 4),
                    "bySubsystem": by_sub,
                    "records": len(self._records),
                    "maxRecords": self.max_records,
                    "dropped": self.dropped}

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._last.clear()
            self._evicted.clear()
            self._aot_misses.clear()
            self._counts.clear()
            self._seq = 0
            self.dropped = 0
            self.seconds_total = 0.0


_LEDGER = CompileLedger()


def ledger() -> CompileLedger:
    return _LEDGER


def set_ledger(l: CompileLedger) -> CompileLedger:
    global _LEDGER
    _LEDGER = l
    return l


def reset() -> None:
    """Fresh ledger + env-driven enablement (test isolation)."""
    global _LEDGER, _enabled_override
    _LEDGER = CompileLedger()
    _enabled_override = None


# -- the instrumentation entry point (one enabled check, zero writes off) ----

def record_build(subsystem: Optional[str] = None, *, identity: str,
                 key: str, fingerprint: Any = None, seconds: float = 0.0,
                 bucket: Optional[int] = None,
                 donation: Optional[Tuple] = None,
                 corr: Optional[str] = None,
                 **attrs: Any) -> Optional[CompileRecord]:
    """Record one build on the process ledger; ``subsystem=None`` picks up
    the ambient :func:`subsystem_scope` (default ``"plan"``). This is the
    call compiled into every dispatch site — inert when ``TG_LEDGER=0``."""
    if not ledger_enabled():
        return None
    return _LEDGER.record_build(
        subsystem or current_subsystem(), identity, key,
        fingerprint=fingerprint, seconds=seconds, bucket=bucket,
        donation=donation, corr=corr, **attrs)


def record_eviction(key: str) -> None:
    if ledger_enabled():
        _LEDGER.record_eviction(key)


def note_aot_miss(key: str, reason: str) -> None:
    if ledger_enabled():
        _LEDGER.note_aot_miss(key, reason)


def cache_key_hash(key: Any) -> str:
    """A stable short hash of an arbitrary cache-key tuple (plan / fused
    caches key on nested tuples containing live objects)."""
    import hashlib
    return hashlib.sha256(repr(key).encode("utf-8")).hexdigest()[:16]
