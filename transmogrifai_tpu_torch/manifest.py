"""Atomic file writes and the integrity manifest of a saved model directory
(counterpart of ``transmogrifai_tpu.manifest``).

``atomic_write_bytes`` writes to a staging file of its own
(``<path>.<pid>.<seq>.tmp``), flushes and fsyncs it, then renames it into
place: a kill at any point leaves the old file or the new one, and
``*.tmp`` debris at worst. ``MANIFEST.json`` records the format version
and each file's size and sha256; a file whose size or checksum differs
from its record is corrupt and is never decoded. A checkpoint directory's
manifest also carries completion records: a stage checkpoint
(``persistence.save_stage_checkpoint``) and a streamed pass's fold state
(``streaming.checkpoint``) are trusted only when their record exists and
their files verify. The JAX package's sweep records and its advisory
serving, drift, costs and program entries are read and written back
unchanged; the port makes none of them yet.

``RunSentinel`` (``RUN_SENTINEL.json``) marks a training run that owns a
checkpoint directory, with its pid and coarse phase; a resume from
another process that finds one knows the earlier run died.
"""
from __future__ import annotations

import contextlib
import hashlib
import itertools
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

MANIFEST_FILE = "MANIFEST.json"
MANIFEST_VERSION = 1
#: the liveness marker of the training run that owns a checkpoint directory
SENTINEL_FILE = "RUN_SENTINEL.json"


def sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            b = fh.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


#: per-process staging-name counter: two writers of one destination never
#: share a staging file
_TMP_SEQ = itertools.count(1)


def atomic_write_bytes(path: str, data: bytes) -> str:
    """Write ``data`` to ``path`` through a staging file, fsync and
    ``os.replace``; returns the sha256 of ``data``. A failed write removes
    its staging file."""
    tmp = f"{path}.{os.getpid()}.{next(_TMP_SEQ)}.tmp"
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return sha256_bytes(data)


def atomic_write_json(path: str, obj: Any, **dump_kw) -> str:
    return atomic_write_bytes(
        path, json.dumps(obj, **dump_kw).encode("utf-8"))


def clean_tmp_debris(dirpath: str) -> List[str]:
    """Remove the ``*.tmp`` files and directories (a model save's staged
    directory) a killed writer left in ``dirpath``; returns their names."""
    removed: List[str] = []
    if not os.path.isdir(dirpath):
        return removed
    for fname in sorted(os.listdir(dirpath)):
        if fname.endswith(".tmp"):
            full = os.path.join(dirpath, fname)
            try:
                if os.path.isdir(full):
                    shutil.rmtree(full)
                else:
                    os.remove(full)
                removed.append(fname)
            except OSError:
                pass
    return removed


class CheckpointManifest:
    """The ``MANIFEST.json`` of one directory: per-file records, and the
    completion records of stage checkpoints (``stages``), sweeps
    (``sweeps``) and streamed fold states (``streams``, keyed by
    ``<stage uid>/<pass id>`` with the source fingerprint and the next
    chunk to fold). The JAX package's advisory sections: ``serving`` (the
    warm-start fingerprint) and ``drift`` (the training baseline) are
    written by ``persistence.save_model``; ``costs`` and ``programs`` are
    kept as read."""

    #: optional sections written only when not empty, as the JAX package
    #: writes them
    _OPTIONAL = ("serving", "streams", "drift", "costs", "programs")

    def __init__(self, dirpath: str, format_version: int):
        self.dirpath = dirpath
        self.format_version = format_version
        self.files: Dict[str, Dict[str, Any]] = {}
        self.stages: Dict[str, Dict[str, Any]] = {}
        self.sweeps: Dict[str, Dict[str, Any]] = {}
        self.streams: Dict[str, Dict[str, Any]] = {}
        self.serving: Dict[str, Any] = {}
        self.drift: Dict[str, Any] = {}
        self.costs: Dict[str, Any] = {}
        self.programs: Dict[str, Any] = {}

    @property
    def path(self) -> str:
        return os.path.join(self.dirpath, MANIFEST_FILE)

    @classmethod
    def load(cls, dirpath: str, format_version: int
             ) -> Tuple["CheckpointManifest", Optional[str]]:
        """``(manifest, error)``: the error is None when the manifest reads
        cleanly, "missing" when the directory has none, else the reason
        (and the manifest returned is empty: nothing in the directory is
        trusted)."""
        m = cls(dirpath, format_version)
        if not os.path.isfile(m.path):
            return m, None if not os.path.isdir(dirpath) else "missing"
        try:
            with open(m.path) as fh:
                doc = json.load(fh)
        except (OSError, ValueError) as e:
            return m, f"unreadable manifest: {type(e).__name__}: {e}"
        if doc.get("manifestVersion") != MANIFEST_VERSION:
            return m, (f"unsupported manifest version "
                       f"{doc.get('manifestVersion')!r}")
        if doc.get("formatVersion") != format_version:
            return m, (f"checkpoint format {doc.get('formatVersion')!r} != "
                       f"expected {format_version}")
        m.files = dict(doc.get("files", {}))
        m.stages = dict(doc.get("stages", {}))
        m.sweeps = dict(doc.get("sweeps", {}))
        for name in cls._OPTIONAL:
            sec = doc.get(name, {})
            setattr(m, name, dict(sec) if isinstance(sec, dict) else {})
        return m, None

    def record_file(self, fname: str, sha256: str, size: int) -> None:
        self.files[fname] = {"sha256": sha256, "size": size}

    def save(self) -> None:
        """Write ``MANIFEST.json`` atomically: the commit point of every
        completion recorded before it."""
        os.makedirs(self.dirpath, exist_ok=True)
        doc = {"manifestVersion": MANIFEST_VERSION,
               "formatVersion": self.format_version,
               "files": self.files, "stages": self.stages,
               "sweeps": self.sweeps}
        for name in ("serving", "streams", "drift", "costs", "programs"):
            if getattr(self, name):
                doc[name] = getattr(self, name)
        atomic_write_json(self.path, doc, indent=1)

    def complete_stage(self, uid: str, fnames: List[str]) -> None:
        """Record a stage checkpoint complete (its files written and
        recorded); the ``save`` that follows commits it."""
        self.stages[uid] = {"files": list(fnames)}

    def complete_sweep(self, owner_uid: str, fname: str) -> None:
        """Record a selector's sweep state (``sweep_<uid>.json``)
        complete; the ``save`` that follows commits it."""
        self.sweeps[owner_uid] = {"file": fname}

    def verify_recorded(self) -> List[str]:
        """Verify every file a completion record names (stages, sweeps,
        fold states): '<file>: <reason>' for each that fails. The
        campaign's checkpoint-integrity oracle: empty means everything a
        resume would trust verifies."""
        fnames: List[str] = []
        for rec in self.stages.values():
            fnames.extend(rec.get("files", ()))
        for rec in list(self.sweeps.values()) + list(self.streams.values()):
            if rec.get("file"):
                fnames.append(rec["file"])
        problems = []
        for fname in sorted(set(fnames)):
            reason = self.verify_file(fname)
            if reason is not None:
                problems.append(f"{fname}: {reason}")
        return problems

    def complete_stream(self, key: str, fname: str,
                        meta: Dict[str, Any]) -> None:
        """Record a streamed fold state (``key`` = ``<stage uid>/<pass>``,
        ``meta`` its source fingerprint and next chunk); the ``save`` that
        follows commits it, so a kill before it leaves the previous state
        in force."""
        self.streams[key] = {"file": fname, **meta}

    def drop_streams(self, stage_uid: str) -> None:
        """Forget a stage's fold states (once its stage checkpoint is
        committed they are not needed)."""
        for key in [k for k in self.streams
                    if k.split("/", 1)[0] == stage_uid]:
            del self.streams[key]

    def verify_file(self, fname: str) -> Optional[str]:
        """None when ``fname`` exists and matches its record, else why
        not."""
        rec = self.files.get(fname)
        path = os.path.join(self.dirpath, fname)
        if rec is None:
            return "file has no manifest record (incomplete write)"
        if not os.path.isfile(path):
            return "file recorded in manifest but missing on disk"
        size = os.path.getsize(path)
        if size != rec.get("size"):
            return (f"size mismatch: manifest says {rec.get('size')} bytes, "
                    f"file has {size}")
        actual = sha256_file(path)
        if actual != rec.get("sha256"):
            return (f"sha256 mismatch: manifest {rec.get('sha256')[:12]}..., "
                    f"file {actual[:12]}...")
        return None

    def unrecorded_files(self) -> List[str]:
        """Payload files in the directory that no completion record names:
        the debris of a write that was never committed."""
        if not os.path.isdir(self.dirpath):
            return []
        recorded = set(self.files)
        for rec in self.stages.values():
            recorded.update(rec.get("files", ()))
        for rec in self.sweeps.values():
            recorded.add(rec.get("file"))
        out = []
        for fname in sorted(os.listdir(self.dirpath)):
            if fname in (MANIFEST_FILE, SENTINEL_FILE, "programs") \
                    or fname.endswith(".tmp"):
                continue
            if fname not in recorded:
                out.append(fname)
        return out


class RunSentinel:
    """The pid and coarse phase of the training run that owns a checkpoint
    directory (``RUN_SENTINEL.json``). A run writes it at its start,
    rewrites it when its phase changes, and removes it when it ends
    cleanly; a ``train(resume=True)`` of another process that finds it
    records the earlier run's ``unclean_exit`` (``oomKillSuspected`` when
    its last phase was device work)."""

    #: phases with this prefix are device work (an upload)
    DEVICE_PHASE_PREFIX = "device"

    def __init__(self, dirpath: str):
        self.dirpath = dirpath
        self._phase: Optional[str] = None

    @property
    def path(self) -> str:
        return os.path.join(self.dirpath, SENTINEL_FILE)

    def start(self, phase: str = "start") -> None:
        os.makedirs(self.dirpath, exist_ok=True)
        self._phase = None
        self.set_phase(phase)

    def set_phase(self, phase: str) -> None:
        """Record the run's phase; writes only when it changes."""
        if phase == self._phase:
            return
        self._phase = phase
        atomic_write_json(self.path, {"pid": os.getpid(), "phase": phase})

    def clear(self) -> None:
        """The run ended cleanly."""
        self._phase = None
        try:
            os.remove(self.path)
        except OSError:
            pass

    @staticmethod
    def read(dirpath: str) -> Optional[Dict[str, Any]]:
        path = os.path.join(dirpath, SENTINEL_FILE)
        if not os.path.isfile(path):
            return None
        try:
            with open(path) as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return {"pid": None, "phase": "unreadable"}

    def read_stale(self) -> Optional[Dict[str, Any]]:
        """The sentinel of an earlier owner that was another process (None
        for this process's own sentinel or none)."""
        doc = self.read(self.dirpath)
        if doc is None or doc.get("pid") == os.getpid():
            return None
        return doc

    @staticmethod
    def suspects_oom_kill(doc: Dict[str, Any]) -> bool:
        return str(doc.get("phase", "")).startswith(
            RunSentinel.DEVICE_PHASE_PREFIX)


#: the sentinel of the running train, for phase hints from deep code (the
#: feed's committer thread included, so a module global and not a context
#: variable)
_ACTIVE_SENTINEL: Optional[RunSentinel] = None


@contextlib.contextmanager
def active_sentinel(sentinel: Optional[RunSentinel]):
    """Make ``sentinel`` the target of :func:`sentinel_phase` for the
    block (a no-op block when None)."""
    global _ACTIVE_SENTINEL
    prev = _ACTIVE_SENTINEL
    _ACTIVE_SENTINEL = sentinel
    try:
        yield sentinel
    finally:
        _ACTIVE_SENTINEL = prev


def sentinel_phase(phase: str) -> None:
    """A phase hint for the running train's sentinel (inert when none).
    Never raises: the evidence of a crash must not cause one."""
    s = _ACTIVE_SENTINEL
    if s is not None:
        try:
            s.set_phase(phase)
        except OSError:
            pass
