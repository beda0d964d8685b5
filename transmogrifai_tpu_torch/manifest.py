"""Atomic file writes and the integrity manifest of a saved model directory
(counterpart of ``transmogrifai_tpu.manifest``).

``atomic_write_bytes`` writes to a staging file of its own
(``<path>.<pid>.<seq>.tmp``), flushes and fsyncs it, then renames it into
place: a kill at any point leaves the old file or the new one, and
``*.tmp`` debris at worst. ``MANIFEST.json`` records the format version
and each file's size and sha256; a file whose size or checksum differs
from its record is corrupt and is never decoded. The JAX package's
manifest also carries stage, sweep and stream completion records and the
advisory serving, drift, costs and program entries; the port writes
none of them yet, and neither loader needs them to load a model.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

MANIFEST_FILE = "MANIFEST.json"
MANIFEST_VERSION = 1


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
    """The ``MANIFEST.json`` of one directory: its per-file records."""

    def __init__(self, dirpath: str, format_version: int):
        self.dirpath = dirpath
        self.format_version = format_version
        self.files: Dict[str, Dict[str, Any]] = {}

    @property
    def path(self) -> str:
        return os.path.join(self.dirpath, MANIFEST_FILE)

    @classmethod
    def load(cls, dirpath: str, format_version: int
             ) -> Tuple["CheckpointManifest", Optional[str]]:
        """``(manifest, error)``: the error is None when the manifest reads
        cleanly, "missing" when the directory has none, else the reason."""
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
        return m, None

    def record_file(self, fname: str, sha256: str, size: int) -> None:
        self.files[fname] = {"sha256": sha256, "size": size}

    def save(self) -> None:
        """Write ``MANIFEST.json`` atomically, with the empty completion
        sections the JAX package's manifest always has."""
        os.makedirs(self.dirpath, exist_ok=True)
        doc = {"manifestVersion": MANIFEST_VERSION,
               "formatVersion": self.format_version,
               "files": self.files, "stages": {}, "sweeps": {}}
        atomic_write_bytes(self.path,
                           json.dumps(doc, indent=1).encode("utf-8"))

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
