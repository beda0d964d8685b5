"""Subprocess replica worker: one ModelRegistry behind a JSON-lines
stdio protocol (docs/serving.md "Replica fleet & front door").

The PyTorch port's copy of the JAX package's ``serving/replica_worker.py``.
Spawned by :class:`~.fleet.SubprocessReplica` as::

    python -m transmogrifai_tpu_torch.serving.replica_worker \
        --device cuda:0 --model churn=/path/to/saved_model [--model ...]

It imports neither ``jax`` nor ``transmogrifai_tpu``. ``--device`` names
where the models load and serve (default: the CUDA device). On CUDA the
worker loads every kernel library of the port (built by the parent before
it spawned this process) before it loads a model; a missing CUDA device, a
library that does not load, or a model that does not load or warm ends the
spawn with ``{"ready": false, "error": ...}`` and exit code 1: the worker
never serves on another device than the one it was given.

Protocol (one JSON object per line, both directions):

parent → child
    ``{"op": "submit", "id": n, "model": m, "row": {...},
    "deadlineMs": x|null, "tenant": t|null}``,
    ``{"op": "health", "id": n}``,
    ``{"op": "swap", "id": n, "model": m, "path": dir}``,
    ``{"op": "close"}``

child → parent
    ``{"ready": true, "models": [...], "device": d}`` once, after every
    model is loaded + warm (or ``{"ready": false, "error": {...}}``);
    then per request ``{"id": n, "record": {...}}`` or
    ``{"id": n, "error": {"type": <typed class name>, "msg": ...}}``
    (typed serving errors survive the process boundary by name —
    fleet.py maps them back), ``{"id": n, "health": {...}}``; health
    carries a ``device`` block (device, process id, each kernel's
    launches in the child, and on CUDA ``torch.cuda.max_memory_allocated``
    and ``memory_allocated``).

Results are written from Future done-callbacks (the replica's batcher
thread) under one write lock — the protocol needs no ordering beyond
line atomicity. The protocol owns the process's original stdout; file
descriptor 1 is pointed at stderr before anything else is imported, so
what the model stack prints (Python or C level, e.g. a library's load
messages) cannot corrupt it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
from typing import Any, Dict, Optional


def _json_default(o: Any):
    """Records carry numpy or torch scalars off the serve path; JSON them
    as their Python values so bit-equality survives the pipe (binary64
    round-trips exactly through repr)."""
    item = getattr(o, "item", None)
    if callable(item):
        return item()
    return str(o)


class _Writer:
    def __init__(self, stream):
        self._stream = stream
        self._lock = threading.Lock()

    def send(self, msg: Dict[str, Any]) -> None:
        line = json.dumps(msg, separators=(",", ":"),
                          default=_json_default)
        with self._lock:
            self._stream.write(line + "\n")
            self._stream.flush()


def _typed_name(e: BaseException) -> str:
    from .runtime import ServingError
    return (type(e).__name__ if isinstance(e, ServingError)
            else "ReplicaError")


def _error(e: BaseException) -> Dict[str, str]:
    return {"type": _typed_name(e), "msg": f"{type(e).__name__}: {e}"[:300]}


def _protocol_stream():
    """The process's stdout as the protocol channel, with file descriptor
    1 (and ``sys.stdout``) pointed at stderr from here on."""
    sys.stdout.flush()
    proto = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    return proto


def _prepare_device(name: Optional[str]):
    """The worker's device; on CUDA, the device made current and every
    kernel library of the port loaded (a failure raises: no fallback)."""
    import torch

    from ..device import resolve_device
    device = resolve_device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device is available for {device}")
        torch.cuda.set_device(device)
        from ..ops import cuda_build
        for source in cuda_build.sources():
            cuda_build.load(source)
    return device


def _device_health(device) -> Dict[str, Any]:
    """The health payload's ``device`` block: the device, this process's
    id, each kernel's launches in this process, and on CUDA the card's
    name and ``torch.cuda`` memory."""
    import torch

    from ..histeng import kernels as HK
    from ..ops import forest as F
    out: Dict[str, Any] = {
        "device": str(device), "pid": os.getpid(),
        "kernelLaunches": {k.name: k.launches
                           for k in HK.KERNELS + F.KERNELS}}
    if device.type == "cuda":
        out["name"] = torch.cuda.get_device_name(device)
        out["maxMemoryAllocated"] = int(torch.cuda.max_memory_allocated(device))
        out["memoryAllocated"] = int(torch.cuda.memory_allocated(device))
    return out


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(prog="replica_worker")
    p.add_argument("--model", action="append", required=True,
                   help="name=saved_model_dir (repeatable)")
    p.add_argument("--device", default=None,
                   help="cuda:N or cpu (default: the CUDA device)")
    p.add_argument("--max-batch", type=int, default=256)
    p.add_argument("--queue-max", type=int, default=1024)
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    a = p.parse_args(argv)

    writer = _Writer(_protocol_stream())

    from .registry import ModelRegistry
    from .runtime import ServeConfig

    cfg = ServeConfig.from_env()
    cfg.max_batch = a.max_batch
    cfg.max_queue = a.queue_max
    cfg.max_wait_ms = a.max_wait_ms
    reg = ModelRegistry(cfg)
    try:
        try:
            device = _prepare_device(a.device)
            names = []
            for spec in a.model:
                name, _, path = spec.partition("=")
                reg.load(name, path, device=device)
                names.append(name)
        except Exception as e:  # noqa: BLE001 - the spawn fails typed
            writer.send({"ready": False, "error": {
                "type": "ReplicaSpawnError",
                "msg": f"{type(e).__name__}: {e}"[:600]}})
            return 1
        writer.send({"ready": True, "models": names, "device": str(device)})
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except ValueError:
                continue
            op = msg.get("op")
            if op == "close":
                break
            rid = msg.get("id")
            if op == "health":
                try:
                    h = reg.health()
                    h["device"] = _device_health(device)
                    writer.send({"id": rid, "health": h})
                except Exception as e:  # noqa: BLE001 - protocol fence
                    writer.send({"id": rid, "error": _error(e)})
            elif op == "swap":
                try:
                    reg.swap(msg["model"], msg["path"])
                    writer.send({"id": rid, "record": {"swapped": True}})
                except Exception as e:  # noqa: BLE001 - protocol fence
                    writer.send({"id": rid, "error": _error(e)})
            elif op == "submit":
                try:
                    fut = reg.submit(msg["model"], msg.get("row") or {},
                                     deadline_ms=msg.get("deadlineMs"),
                                     tenant=msg.get("tenant"))
                except Exception as e:  # typed shed (overload/stopped)
                    writer.send({"id": rid, "error": _error(e)})
                    continue

                def _emit(f, _rid=rid):
                    e = f.exception()
                    if e is not None:
                        writer.send({"id": _rid, "error": _error(e)})
                    else:
                        writer.send({"id": _rid, "record": f.result()})
                fut.add_done_callback(_emit)
    finally:
        reg.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
