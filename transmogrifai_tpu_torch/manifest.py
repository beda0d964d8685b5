"""The integrity manifest of a saved model directory, read side
(counterpart of ``transmogrifai_tpu.manifest``).

``MANIFEST.json`` records the format version and each file's size and
sha256; a file whose size or checksum differs from its record is corrupt
and is never decoded.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Optional, Tuple

MANIFEST_FILE = "MANIFEST.json"
MANIFEST_VERSION = 1


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            b = fh.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


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
