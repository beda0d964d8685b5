"""Per-chunk fold-state checkpoints through the integrity manifest
(counterpart of ``transmogrifai_tpu.streaming.checkpoint``).

Every ``TG_STREAM_CKPT_EVERY`` chunks (default 1) the fold state of the
pass in flight is written as an npz, atomically
(``manifest.atomic_write_bytes``), and committed through the checkpoint
directory's ``MANIFEST.json`` ``streams`` section, the write-then-commit
protocol of the stage checkpoints, so a kill at any instruction leaves
either the previous committed chunk or the new one in force:

* the state after chunk ``k`` gets a name of its own (``..._<k>.npz``);
  the previous chunk's file is deleted only after the manifest commit;
* every record holds the source fingerprint, the pass id and the stage
  uid; a restore checks all three and the sha256 before it trusts a
  state, and on any mismatch reports it and refolds the pass from the
  start (deterministically the same).

The keys (``<stage uid>/<pass id>``), file names and records are the JAX
package's, so a checkpoint directory either package wrote resumes in the
other.
"""
from __future__ import annotations

import io
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..manifest import CheckpointManifest, atomic_write_bytes
from ..robustness.policy import FaultLog, FaultReport

CKPT_EVERY_ENV = "TG_STREAM_CKPT_EVERY"

#: chunk marker recorded when a pass's fold is complete
PASS_COMPLETE = -1


def env_ckpt_every() -> int:
    try:
        return max(1, int(os.environ.get(CKPT_EVERY_ENV, "") or 1))
    except ValueError:
        return 1


def _npz_bytes(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


class StreamCheckpoint:
    """Fold-state persistence for one checkpoint directory + one source."""

    def __init__(self, dirpath: str, manifest: CheckpointManifest,
                 source_fingerprint: str):
        self.dirpath = dirpath
        self.manifest = manifest
        self.fingerprint = source_fingerprint
        self.every = env_ckpt_every()

    def _fname(self, key: str, chunk: int) -> str:
        safe = key.replace("/", "_").replace(":", "_")
        return f"stream_{safe}_{max(chunk, 0)}.npz"

    # -- commit ---------------------------------------------------------------
    def commit(self, key: str, arrays: Dict[str, np.ndarray],
               next_chunk: int, fingerprint: Optional[str] = None,
               chunk_rows: Optional[int] = None) -> None:
        """Persist ``arrays`` as the fold state with chunks < ``next_chunk``
        folded in (``PASS_COMPLETE``: the pass finished).

        ``fingerprint`` and ``chunk_rows`` override the source identity the
        record commits to: the memory-pressure downshift re-chunks the
        source mid-pass (``trainer``), and the record carries the active
        chunking so a killed downshifted train resumes against the same
        schedule, bit-exactly."""
        os.makedirs(self.dirpath, exist_ok=True)
        rec = self.manifest.streams.get(key)
        prev_file = rec.get("file") if rec else None
        fname = self._fname(key, next_chunk)
        data = _npz_bytes(arrays)
        sha = atomic_write_bytes(os.path.join(self.dirpath, fname), data)
        self.manifest.record_file(fname, sha, len(data))
        extra = {"fingerprint": fingerprint or self.fingerprint,
                 "chunk": int(next_chunk)}
        if chunk_rows is not None:
            extra["chunkRows"] = int(chunk_rows)
        self.manifest.complete_stream(key, fname, extra)
        if prev_file and prev_file != fname:
            self.manifest.files.pop(prev_file, None)
        self.manifest.save()          # the commit point
        if prev_file and prev_file != fname:
            try:
                os.remove(os.path.join(self.dirpath, prev_file))
            except OSError:
                pass

    # -- restore --------------------------------------------------------------
    def restore(self, key: str, fingerprint: Optional[str] = None,
                ) -> Tuple[Optional[Dict[str, np.ndarray]], int]:
        """(state arrays, next chunk to fold): ``(None, 0)`` when nothing is
        committed and verifiable for this key and fingerprint; a verified
        complete pass gives ``(state, PASS_COMPLETE)``. ``fingerprint``
        overrides the expected source identity (the trainer passes a
        downshifted source's when the record carries its ``chunkRows``)."""
        rec = self.manifest.streams.get(key)
        if rec is None:
            return None, 0
        reason = None
        if rec.get("fingerprint") != (fingerprint or self.fingerprint):
            reason = ("source fingerprint mismatch — resumed against "
                      "different data or chunking")
        else:
            reason = self.manifest.verify_file(rec["file"])
        if reason is None:
            try:
                with np.load(os.path.join(self.dirpath, rec["file"]),
                             allow_pickle=False) as z:
                    arrays = {k: z[k] for k in z.files}
                return arrays, int(rec.get("chunk", 0))
            except (OSError, ValueError) as e:
                reason = f"unreadable state: {type(e).__name__}: {e}"
        FaultLog.record(FaultReport(
            site="stream.checkpoint", kind="checkpoint_skipped",
            detail={"key": key, "file": rec.get("file"), "reason": reason}))
        return None, 0
