"""Sweep checkpoints (counterpart of
``transmogrifai_tpu.impl.tuning.sweep_checkpoint``): per-candidate results
survive a kill.

Stage checkpoints make the DAG resumable at estimator granularity, but the
ModelSelector is one estimator whose fit sweeps families x grids x folds,
the costliest fit of a train. This module persists one record per
evaluated family (its whole sweep branch) into
``sweep_<selector-uid>.json`` in the workflow's checkpoint directory,
committed atomically through the shared ``manifest.CheckpointManifest``.
A resumed ``train()`` replays the matching records (fold metrics restored
bit for bit through the recorded dtype) and sweeps only the rest; the
winner is then chosen from the merged metrics as before.

Records are keyed by a candidate fingerprint: family, canonical grid,
fold and metric configuration, row count, and sha256 of the label vector
and of the fold assignment, so a record from other data, folds or sweep
settings never replays. The keys, the file and its format are the JAX
package's, byte for byte: a directory either package wrote resumes in the
other.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from ...manifest import CheckpointManifest
from ...robustness.policy import FaultLog, FaultReport

SWEEP_STATE_VERSION = 1


def candidate_key(family: str, grid: List[Dict[str, Any]],
                  fingerprint: Dict[str, Any]) -> str:
    """Stable fingerprint of one family's sweep branch: the family, its
    canonical grid, and the run fingerprint (fold config, metric, data
    hashes). Any difference → different key → no replay."""
    doc = {"family": family,
           "grid": [sorted((k, repr(v)) for k, v in g.items()) for g in grid],
           "fingerprint": {k: fingerprint[k] for k in sorted(fingerprint)}}
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode("utf-8")).hexdigest()


def params_hash(hyper: Dict[str, Any]) -> str:
    """sha256 of one candidate's canonical hyperparameter dict — the
    identity a restored record is matched and audited by."""
    return hashlib.sha256(json.dumps(
        sorted((k, repr(v)) for k, v in hyper.items())).encode()).hexdigest()


class SweepCheckpoint:
    """Durable per-candidate sweep state for one selector stage.

    ``get``/``put`` operate on whole-family records::

        {"family": "OpGBTClassifier",
         "grid": [...hyper dicts...],
         "paramsHashes": ["<sha256 per grid point>"],
         "metricName": "AuPR",
         "foldMetrics": [[...], ...],   # (F, G), null for non-finite
         "dtype": "float32",            # restores metrics bit-exactly
         "quarantined": false,          # family branch threw pre-dispatch
         "reason": null}

    Every ``put`` rewrites the state file atomically and commits it through
    the directory manifest, so the file always holds a consistent prefix of
    the sweep and a torn write is impossible.
    """

    def __init__(self, ckpt_dir: str, owner_uid: str,
                 manifest: Optional[CheckpointManifest] = None):
        from ...persistence import open_checkpoint_manifest
        self.ckpt_dir = ckpt_dir
        self.owner_uid = owner_uid
        self.fname = f"sweep_{owner_uid}.json"
        self.path = os.path.join(ckpt_dir, self.fname)
        self.manifest = manifest or open_checkpoint_manifest(ckpt_dir)
        self._state: Dict[str, Any] = {"sweepStateVersion": SWEEP_STATE_VERSION,
                                       "candidates": {}}
        self._load()

    def _load(self) -> None:
        if not os.path.isfile(self.path):
            return
        reason = None
        if self.manifest.sweeps.get(self.owner_uid):
            reason = self.manifest.verify_file(self.fname)
        elif self.manifest.files or self.manifest.stages:
            reason = "sweep state has no manifest completion record"
        if reason is not None:
            FaultLog.record(FaultReport(
                site="persistence.sweep", kind="checkpoint_skipped",
                detail={"uid": self.owner_uid, "file": self.path,
                        "reason": reason, "error": reason}))
            return
        try:
            with open(self.path) as fh:
                doc = json.load(fh)
            if doc.get("sweepStateVersion") != SWEEP_STATE_VERSION:
                raise ValueError(
                    f"sweep state version {doc.get('sweepStateVersion')!r}")
            self._state = doc
        except (OSError, ValueError) as e:
            FaultLog.record(FaultReport(
                site="persistence.sweep", kind="checkpoint_skipped",
                detail={"uid": self.owner_uid, "file": self.path,
                        "reason": f"{type(e).__name__}: {e}",
                        "error": f"{type(e).__name__}: {e}"}))

    # -- record access -------------------------------------------------------
    def get(self, cand_key: str) -> Optional[Dict[str, Any]]:
        return self._state["candidates"].get(cand_key)

    def put(self, cand_key: str, record: Dict[str, Any]) -> None:
        from ...manifest import atomic_write_bytes
        self._state["candidates"][cand_key] = record
        data = json.dumps(self._state).encode("utf-8")
        sha = atomic_write_bytes(self.path, data)
        self.manifest.record_file(self.fname, sha, len(data))
        self.manifest.complete_sweep(self.owner_uid, self.fname)
        self.manifest.save()

    # -- metric (de)hydration ------------------------------------------------
    @staticmethod
    def encode_metrics(fold_metrics: np.ndarray) -> Dict[str, Any]:
        """JSON-safe (F, G) metrics: non-finite → null/str markers, dtype
        kept so decoding reproduces the array bit-for-bit (float32 → python
        float widens exactly; json repr round-trips float64 exactly)."""
        fm = np.asarray(fold_metrics)

        def enc(v: float):
            if np.isnan(v):
                return None
            if np.isinf(v):
                return "inf" if v > 0 else "-inf"
            return float(v)
        return {"foldMetrics": [[enc(v) for v in row] for row in fm],
                "dtype": str(fm.dtype)}

    @staticmethod
    def decode_metrics(record: Dict[str, Any]) -> np.ndarray:
        def dec(v):
            if v is None:
                return np.nan
            if v == "inf":
                return np.inf
            if v == "-inf":
                return -np.inf
            return v
        rows = [[dec(v) for v in row] for row in record["foldMetrics"]]
        return np.asarray(rows, dtype=np.dtype(record.get("dtype",
                                                          "float64")))
