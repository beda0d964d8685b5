"""Shared-nothing replica fleet: the worker side of the horizontal
serving layer (docs/serving.md "Replica fleet & front door").

The PyTorch port's copy of the JAX package's ``serving/fleet.py``. Every
replica serves on a device: the fleet's (``FleetConfig.device``) or its
own, and the CUDA device unless the caller names another one. A
subprocess replica is told its device on its command line (``--device
cuda:0`` or ``--device cpu``); on CUDA the parent builds the kernel
libraries before it spawns (``ops/cuda_build.build``), so a child only
loads them, and a child that has no CUDA device or cannot load a
library fails its spawn with the typed :class:`ReplicaSpawnError`
instead of serving on the CPU. Children are started with
``subprocess.Popen``, never forked from a process that holds a CUDA
context.

One :class:`~.runtime.ServingRuntime` is a single failure domain: kill
the process (or wedge its batcher) and every queued request dies with
it. The layer above is N worker replicas, each a
full :class:`~.registry.ModelRegistry` (own queues, batcher threads,
breakers, serve-local metrics, drift monitors), sharing **nothing** but
the saved model artifact. This module owns the replica lifecycle; the
routing/failover/admission brain lives in :mod:`~.frontdoor`.

Two replica kinds behind one duck-typed surface (``submit`` / ``health``
/ ``queue_depth`` / ``swap`` / ``kill`` / ``close``):

* :class:`Replica` — **in-process** (tier-1): a ModelRegistry in this
  process. Deterministic, fast to spawn, and failure-injectable —
  ``kill()`` models a replica crash by closing the registry without
  draining, so every queued request's future fails (the front door
  fails them over to a survivor). Used by the tier-1 tests and the
  chaos-campaign ``fleet`` scenario.
* :class:`SubprocessReplica` — **out-of-process** (``TG_FLEET_SUBPROCESS=1``
  / ``FleetConfig.subprocess``; the multi-process soak + bench scaling
  arm): a ``python -m transmogrifai_tpu_torch.serving.replica_worker`` child
  serving a saved model dir over a JSON-lines stdio protocol. A real
  process boundary — ``kill()`` is a SIGKILL, and the reader thread
  failing every pending future with :class:`ReplicaLostError` is
  exactly what a production TCP disconnect looks like.

Replica states (the front door's routing predicate):

``active``    routed; probed.
``draining``  rolling deploy in progress — skipped by the router when a
              healthier peer exists (a single-replica fleet keeps
              routing to it: ``registry.swap`` is itself zero-loss).
``ejected``   probe ladder tripped (breaker open / stalled / degraded
              readiness / consecutive probe failures) — no new traffic,
              still probed; readmitted after consecutive healthy probes.
``dead``      killed or vanished — futures failed over, never probed
              back in.
``retired``   scaled down gracefully (drained first; autoscale floor
              TG_FLEET_MIN).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .registry import ModelRegistry
from .runtime import (
    DeadlineExceededError, OverloadError, RuntimeStoppedError, ServeConfig,
    ServingError,
)

#: replica states (see module docstring)
ACTIVE = "active"
DRAINING = "draining"
EJECTED = "ejected"
DEAD = "dead"
RETIRED = "retired"


class ReplicaLostError(ServingError):
    """The replica serving this request died (process kill, closed
    registry, broken pipe). The front door fails the request over to a
    survivor — callers only ever see this wrapped in the typed shed the
    failover budget produces when NO survivor remains."""


class ReplicaSpawnError(ReplicaLostError):
    """A subprocess replica never became ready: its device is missing (no
    CUDA device where one was asked for), a kernel library did not load,
    a model did not load or warm, or the child died or timed out first.
    The replica never serves; the message carries the child's own error
    and the tail of its stderr."""


class AdmissionRefusedError(OverloadError):
    """Pre-flight admission control refused the request: the predicted
    flush bytes exceed ``TG_DEVICE_BUDGET`` even at the minimum padding
    bucket — dispatching would exhaust the device, so the request is
    shed *before* any replica (or scorer) sees it. A typed
    :class:`~.runtime.OverloadError`, so loadgen/campaign accounting
    buckets it as a shed, never a failure."""


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


@dataclass
class FleetConfig:
    """Fleet knobs; every field has a ``TG_FLEET_*`` / ``TG_DEVICE_BUDGET``
    environment default (docs/serving.md "Replica fleet & front door")."""
    #: autoscale floor/ceiling (replica count)
    min_replicas: int = 1
    max_replicas: int = 4
    #: health-probe cadence (ms); 0 disables the background probe thread
    #: (tests drive ``probe_now()`` synchronously)
    probe_interval_ms: float = 200.0
    #: consecutive probe FAILURES (raise/timeout) before ejection
    probe_failures: int = 3
    #: consecutive healthy probes before an ejected replica readmits
    readmit_probes: int = 2
    #: per-request failover budget: how many times a request may be
    #: re-dispatched after its replica fails before it sheds typed
    max_failovers: int = 2
    #: device-memory budget (bytes) admission control enforces per flush;
    #: 0 disables admission control
    device_budget: int = 0
    #: windowed-p99 weight in the routing score (queue-depth equivalents
    #: per millisecond of p99)
    p99_weight: float = 0.05
    #: run the autoscale step on the probe cadence
    autoscale: bool = True
    #: spawn subprocess replicas (saved-model path required)
    subprocess: bool = False
    #: subprocess spawn budget (torch import, CUDA context, model load
    #: and warm pass)
    spawn_timeout_s: float = 180.0
    #: the replicas' device: None is the CUDA device (and raises without
    #: one); "cpu" serves on the CPU
    device: Optional[str] = None

    @classmethod
    def from_env(cls) -> "FleetConfig":
        return cls(
            min_replicas=_env_int("TG_FLEET_MIN", 1),
            max_replicas=_env_int("TG_FLEET_MAX", 4),
            probe_interval_ms=_env_float("TG_FLEET_PROBE_MS", 200.0),
            probe_failures=_env_int("TG_FLEET_PROBE_FAILURES", 3),
            readmit_probes=_env_int("TG_FLEET_READMIT_PROBES", 2),
            max_failovers=_env_int("TG_FLEET_MAX_FAILOVERS", 2),
            device_budget=_env_int("TG_DEVICE_BUDGET", 0),
            p99_weight=_env_float("TG_FLEET_P99_WEIGHT", 0.05),
            subprocess=bool(_env_int("TG_FLEET_SUBPROCESS", 0)),
            spawn_timeout_s=_env_float("TG_FLEET_SPAWN_TIMEOUT_S", 180.0),
        )


@dataclass
class _Probe:
    """Per-replica probe-ladder bookkeeping (owned by the front door's
    probe pass; see docs/serving.md for the ladder)."""
    failures: int = 0
    healthy: int = 0
    #: cached windowed p99 (ms) per model from the last healthy probe —
    #: the routing score's latency term
    p99_ms: Dict[str, float] = field(default_factory=dict)
    #: cached per-model scale hints from the last healthy probe
    scale_hints: Dict[str, str] = field(default_factory=dict)


class Replica:
    """One in-process worker: a full ModelRegistry under a replica id."""

    kind = "inproc"

    def __init__(self, rid: str, models: Dict[str, Any],
                 config: Optional[ServeConfig] = None,
                 warm: Optional[bool] = None, device=None):
        self.rid = rid
        self.state = ACTIVE
        self.probe = _Probe()
        self.routed = 0
        self._dead = False
        #: where saved models load (None: the CUDA device); a live model
        #: object serves on its own device
        self.device = device
        self.registry = ModelRegistry(config)
        for name, src in models.items():
            # manifest-verified load + warm pass by default: the replica's
            # first flush finds its kernels built and loaded
            self.load(name, src, warm=warm)

    @property
    def dead(self) -> bool:
        return self._dead

    def submit(self, model: str, row: Dict[str, Any],
               deadline_ms: Optional[float] = None,
               tenant: Optional[str] = None) -> Future:
        if self._dead:
            raise ReplicaLostError(f"replica '{self.rid}' is dead")
        return self.registry.submit(model, row, deadline_ms=deadline_ms,
                                    tenant=tenant)

    def queue_depth(self, model: str) -> int:
        if self._dead:
            raise ReplicaLostError(f"replica '{self.rid}' is dead")
        return self.registry.runtime(model).queue_depth()

    def health(self) -> Dict[str, Any]:
        if self._dead:
            raise ReplicaLostError(f"replica '{self.rid}' is dead")
        return self.registry.health()

    def swap(self, model: str, model_or_path: Any) -> None:
        """Rolling-deploy hook: ``registry.swap`` is itself zero-loss
        (new runtime warmed + started before the entry flips; the old
        one drains after)."""
        self.registry.swap(model, model_or_path)

    # -- model mobility (the placement layer's page-in/evict hooks) ----------
    def load(self, name: str, src: Any,
             warm: Optional[bool] = None) -> None:
        """Page a model in: manifest-verified load of a saved directory
        onto the replica's device, or registration of a live model
        object."""
        if self._dead:
            raise ReplicaLostError(f"replica '{self.rid}' is dead")
        if isinstance(src, str):
            self.registry.load(name, src,
                               warm=True if warm is None else warm,
                               device=self.device)
        else:
            self.registry.register(name, src, warm=bool(warm))

    def unload(self, name: str, drain: bool = True) -> None:
        """Page a model out: close its runtime (draining queued work by
        default). The saved-model artifact stays — a later page-in loads
        it again."""
        self.registry.unregister(name, drain=drain)

    def resident(self) -> List[str]:
        """Models currently warm on this replica."""
        return self.registry.names()

    def warm_reports(self) -> Dict[str, Any]:
        """Per-model warm reports (the bench's per-replica zero-retrace
        evidence)."""
        out = {}
        for name in self.registry.names():
            out[name] = self.registry.runtime(name).warm_info
        return out

    def kill(self) -> None:
        """Simulate a replica crash: no drain — every queued request's
        future fails (RuntimeStoppedError), which the front door
        classifies as replica loss and fails over. Flushes already in
        the pipelined dataplane (dispatched, awaiting completion) still
        resolve with real records via the completer drain — so with
        ``TG_SERVE_PIPELINE`` > 1 a kill loses zero futures either way:
        in-flight work completes, queued work fails over."""
        self._dead = True
        self.state = DEAD
        self.registry.close(drain=False)

    def close(self, drain: bool = True) -> None:
        self._dead = True
        self.registry.close(drain=drain)


# -- subprocess replicas ------------------------------------------------------

#: typed-error names the worker protocol maps back to typed classes, so
#: a shed inside the child stays a typed shed in the parent
_TYPED_BY_NAME = {
    "OverloadError": OverloadError,
    "DeadlineExceededError": DeadlineExceededError,
    "RuntimeStoppedError": RuntimeStoppedError,
    "AdmissionRefusedError": AdmissionRefusedError,
    "ReplicaSpawnError": ReplicaSpawnError,
}


class SubprocessReplica:
    """One out-of-process worker speaking the replica_worker JSON-lines
    protocol over stdio (``TG_FLEET_SUBPROCESS``; docs/serving.md).

    Parent-side state is three pieces: a write lock (requests are
    single-line JSON), a pending-futures map keyed by request id, and a
    ``tg-fleet-io[rid]`` reader thread that resolves futures as result
    lines arrive — and fails every pending future with
    :class:`ReplicaLostError` when the pipe closes (child death IS the
    failure signal; no separate liveness protocol).

    The child serves on ``device`` (None: the CUDA device), named on its
    command line. ``spawn_seconds`` is the spawn-to-ready time: the
    torch import, the CUDA context, the kernel libraries' loads, the
    model loads and their warm passes."""

    kind = "subprocess"

    def __init__(self, rid: str, models: Dict[str, str],
                 config: Optional[ServeConfig] = None,
                 warm: Optional[bool] = None,
                 spawn_timeout_s: float = 180.0, device=None):
        for name, src in models.items():
            if not isinstance(src, str):
                raise ValueError(
                    f"subprocess replicas need saved-model paths; model "
                    f"'{name}' was passed a live object")
        self.rid = rid
        self.state = ACTIVE
        self.probe = _Probe()
        self.routed = 0
        self._dead = False
        self._seq = 0
        self._wlock = threading.Lock()
        self._plock = threading.Lock()
        self._pending: Dict[int, Future] = {}
        self._spawn_error: Optional[str] = None
        self.device = _child_device(device)
        if self.device.startswith("cuda"):
            # the child only loads the libraries: one nvcc per source in
            # the parent, not in every child
            from ..ops import cuda_build
            cuda_build.build()
        cmd = [sys.executable, "-m",
               "transmogrifai_tpu_torch.serving.replica_worker",
               "--device", self.device]
        for name, path in models.items():
            cmd += ["--model", f"{name}={path}"]
        cfg = config or ServeConfig.from_env()
        cmd += ["--max-batch", str(cfg.max_batch),
                "--queue-max", str(cfg.max_queue),
                "--max-wait-ms", str(cfg.max_wait_ms)]
        # the child's stderr goes to a file: a pipe nobody reads would
        # block it, and a failed spawn quotes the file's tail
        self._stderr = tempfile.TemporaryFile()
        t0 = time.perf_counter()
        env = dict(os.environ)
        # the child imports the package from where this one lives,
        # whatever its working directory
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_repo_root(), env.get("PYTHONPATH")) if p)
        self._proc = subprocess.Popen(
            cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self._stderr, text=True, env=env)
        self._ready = threading.Event()
        self._reader = threading.Thread(
            target=self._read_loop, name=f"tg-fleet-io[{rid}]", daemon=True)
        self._reader.start()
        ready = self._ready.wait(timeout=spawn_timeout_s)
        self.spawn_seconds = time.perf_counter() - t0
        if not ready or self._spawn_error is not None:
            why = self._spawn_error or (
                f"not ready within {spawn_timeout_s:.0f}s")
            tail = self._stderr_tail()
            self.kill()
            raise ReplicaSpawnError(
                f"subprocess replica '{rid}' on {self.device} failed to "
                f"spawn: {why}{tail}")

    @property
    def dead(self) -> bool:
        return self._dead

    def _stderr_tail(self, nbytes: int = 2000) -> str:
        try:
            self._stderr.seek(0, os.SEEK_END)
            size = self._stderr.tell()
            self._stderr.seek(max(0, size - nbytes))
            tail = self._stderr.read().decode("utf-8", "replace").strip()
        except (OSError, ValueError):
            return ""
        return f"\n--- child stderr (tail) ---\n{tail}" if tail else ""

    # -- protocol -------------------------------------------------------------
    def _send(self, msg: Dict[str, Any]) -> None:
        line = json.dumps(msg, separators=(",", ":"))
        with self._wlock:
            if self._dead or self._proc.stdin is None:
                raise ReplicaLostError(f"replica '{self.rid}' is dead")
            try:
                self._proc.stdin.write(line + "\n")
                self._proc.stdin.flush()
            except (BrokenPipeError, OSError, ValueError) as e:
                raise ReplicaLostError(
                    f"replica '{self.rid}' pipe closed: {e}") from e

    def _call(self, msg: Dict[str, Any]) -> Future:
        with self._plock:
            self._seq += 1
            rid = self._seq
            fut: Future = Future()
            self._pending[rid] = fut
        try:
            self._send({**msg, "id": rid})
        except ReplicaLostError:
            with self._plock:
                self._pending.pop(rid, None)
            raise
        return fut

    def _read_loop(self) -> None:
        out = self._proc.stdout
        try:
            for line in out:
                try:
                    msg = json.loads(line)
                except ValueError:
                    continue
                if "ready" in msg:
                    if not msg["ready"]:
                        err = msg.get("error") or {}
                        self._spawn_error = (f"{err.get('type')}: "
                                             f"{err.get('msg', '')}")
                    self._ready.set()
                    continue
                fut = None
                with self._plock:
                    fut = self._pending.pop(msg.get("id"), None)
                if fut is None:
                    continue
                err = msg.get("error")
                if err is not None:
                    cls = _TYPED_BY_NAME.get(err.get("type"),
                                             ReplicaLostError)
                    _try_set_exception(fut, cls(err.get("msg", "")))
                elif "health" in msg:
                    _try_set_result(fut, msg["health"])
                else:
                    _try_set_result(fut, msg.get("record"))
        finally:
            # pipe closed: the child is gone — every pending request's
            # future fails AS replica loss, which the front door fails
            # over (zero lost futures even on SIGKILL)
            self._dead = True
            if not self._ready.is_set():
                self._spawn_error = (
                    f"the child exited before it was ready (exit code "
                    f"{self._proc.poll()})")
                self._ready.set()
            with self._plock:
                pending = list(self._pending.values())
                self._pending.clear()
            for fut in pending:
                _try_set_exception(fut, ReplicaLostError(
                    f"replica '{self.rid}' died with the request in "
                    f"flight"))

    # -- replica surface ------------------------------------------------------
    def submit(self, model: str, row: Dict[str, Any],
               deadline_ms: Optional[float] = None,
               tenant: Optional[str] = None) -> Future:
        return self._call({"op": "submit", "model": model, "row": row,
                           "deadlineMs": deadline_ms, "tenant": tenant})

    def queue_depth(self, model: str) -> int:
        # parent-side proxy: requests written but not yet resolved — the
        # honest load signal without a synchronous round-trip per pick
        if self._dead:
            raise ReplicaLostError(f"replica '{self.rid}' is dead")
        with self._plock:
            return len(self._pending)

    def health(self, timeout: float = 10.0) -> Dict[str, Any]:
        """The child's ``registry.health()`` plus a ``device`` block (its
        device, process id and, on CUDA, ``torch.cuda`` memory peaks)."""
        return self._call({"op": "health"}).result(timeout=timeout)

    def swap(self, model: str, model_or_path: Any) -> None:
        if not isinstance(model_or_path, str):
            raise ValueError("subprocess replicas swap saved-model paths")
        self._call({"op": "swap", "model": model,
                    "path": model_or_path}).result(timeout=180.0)

    def warm_reports(self) -> Dict[str, Any]:
        """Per-model warm reports read through the health protocol —
        ``registry.health()`` carries each runtime's ``warm_info`` under
        ``models.<name>.warm``, so the per-replica warm evidence crosses
        the process boundary here."""
        try:
            models = self.health().get("models", {})
            return {name: m.get("warm") for name, m in models.items()}
        except Exception:
            return {}

    def kill(self) -> None:
        """A real process death: SIGKILL, then wait for the reader to fail
        every pending future over."""
        self._dead = True
        self.state = DEAD
        try:
            self._proc.kill()
        except OSError:
            pass
        self._proc.wait(timeout=10)
        self._finish()

    def close(self, drain: bool = True) -> None:
        if self._dead:
            self._finish()
            return
        try:
            self._send({"op": "close"})
            self._proc.wait(timeout=30)
        except (ReplicaLostError, subprocess.TimeoutExpired):
            self.kill()
            return
        self._dead = True
        self._finish()

    def _finish(self) -> None:
        """Join the reader and release the pipes and the stderr file: a
        closed replica leaves no ``tg-fleet-io`` thread behind."""
        if self._reader is not threading.current_thread():
            self._reader.join(timeout=10)
        for f in (self._proc.stdin, self._proc.stdout, self._stderr):
            try:
                if f is not None:
                    f.close()
            except (OSError, ValueError):
                pass


def _child_device(device) -> str:
    """The ``--device`` a child is given: ``device`` as named, or the
    CUDA device when None. Raises typed, before anything is spawned, when
    a CUDA device is asked for and this process sees none."""
    import torch
    if device is not None and torch.device(device).type != "cuda":
        return str(torch.device(device))
    if not torch.cuda.is_available():
        raise ReplicaSpawnError(
            "no CUDA device is available for a subprocess replica; pass "
            "device='cpu' to serve on the CPU")
    d = torch.device(device) if device is not None else torch.device(
        "cuda", torch.cuda.current_device())
    return f"cuda:{d.index if d.index is not None else 0}"


def _repo_root() -> str:
    """The directory that holds the package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _try_set_result(fut: Future, value: Any) -> None:
    try:
        fut.set_result(value)
    except InvalidStateError:
        pass


def _try_set_exception(fut: Future, exc: BaseException) -> None:
    try:
        fut.set_exception(exc)
    except InvalidStateError:
        pass


def build_replica(rid: str, models: Dict[str, Any],
                  config: Optional[ServeConfig] = None,
                  fleet_config: Optional[FleetConfig] = None,
                  warm: Optional[bool] = None):
    """The fleet's replica factory: subprocess when the flag asks for it
    (and every model is a saved path), in-process otherwise."""
    fc = fleet_config or FleetConfig.from_env()
    if fc.subprocess and all(isinstance(s, str) for s in models.values()):
        return SubprocessReplica(rid, models, config=config, warm=warm,
                                 spawn_timeout_s=fc.spawn_timeout_s,
                                 device=fc.device)
    return Replica(rid, models, config=config, warm=warm, device=fc.device)
