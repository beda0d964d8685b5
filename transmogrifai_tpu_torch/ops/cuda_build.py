"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file has a plain C interface and compiles on its own into
``transmogrifai_tpu_torch/_build/lib<name>-<hash>.so``; the hash covers the
source and the flags, so an edited source builds anew and an unchanged one
is reused. Nothing builds at import: the first launch of a kernel builds its
library, or ``build()`` builds every source at once (one ``nvcc`` process
each, all started together).

Each ``nvcc`` build and each ``ctypes`` load is a record of the compile
ledger (``observability/ledger.py``, identity ``cuda:<source>``), under the
ambient subsystem: what a first request pays, and what a warm serving load
pays before it instead.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import time

import torch

from ..observability import ledger as _ledger

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

#: sm_90a: Hopper with its architecture-specific instructions
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Names of every CUDA source of the port."""
    return sorted(p.name for p in CSRC_DIR.glob("*.cu"))


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot build")


def library_path(source: str) -> Path:
    src = (CSRC_DIR / source).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{Path(source).stem}-{digest[:12]}.so"


def build(names: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Compile the given sources (default: all) that are not built yet, one
    ``nvcc`` each, all running at once. Returns {source: compiler output}
    for the sources it compiled; raises with that output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for name in names or sources():
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / name)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    logs: Dict[str, str] = {}
    failed = []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode == 0:
            os.replace(tmp, out)        # atomic: readers see whole files
            _ledger.record_build(identity=f"cuda:{name}", key=out.name,
                                 seconds=time.perf_counter() - t0,
                                 step="nvcc")
        else:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            if tmp.exists():
                tmp.unlink()
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            path = library_path(source)
            if not path.exists():
                build([source])
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(path))
            lib.tg_cuda_error_string.argtypes = [ctypes.c_int]
            lib.tg_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[source] = lib
            _ledger.record_build(identity=f"cuda:{source}:load",
                                 key=path.name,
                                 seconds=time.perf_counter() - t0,
                                 step="ctypes")
        return lib


def expect(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel entry takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_int32(*vals: int) -> None:
    if any(v >= 2 ** 31 for v in vals):
        raise ValueError(f"sizes {vals} exceed the kernel's int32 range")


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


_CAPTURE = threading.local()


class capturing:
    """While a CUDA graph is captured on this thread: a launch is
    recorded into the graph, not run, so ``launches`` does not move; the
    block's ``counts`` {kernel: launches recorded} are what each replay of
    the graph runs (``CudaKernel.count_replays``), and ``after`` the
    callables registered with ``after_replay``, which the graph's owner
    calls after each replay."""

    def __enter__(self) -> "capturing":
        self._outer = (getattr(_CAPTURE, "counts", None),
                       getattr(_CAPTURE, "after", None))
        _CAPTURE.counts = self.counts = {}
        _CAPTURE.after = self.after = []
        return self

    def __exit__(self, *exc) -> None:
        _CAPTURE.counts, _CAPTURE.after = self._outer


def after_replay(fn) -> bool:
    """Run ``fn()`` after each replay of the graph being captured on this
    thread (on the replaying stream, once the replay is enqueued): how a
    wrapper that holds a launch to its plain version reaches launches that
    replays run. False when no capture is open here."""
    after = getattr(_CAPTURE, "after", None)
    if after is None:
        return False
    after.append(fn)
    return True


class CudaKernel:
    """One hand-written CUDA kernel bound through ``ctypes``.

    ``launches`` counts the launches of the kernel and nothing else: a
    call through the wrapper, or a replay of a CUDA graph that holds it
    (``count_replays``; a launch recorded into a graph while it is
    captured counts at each replay, not at the capture)."""

    def __init__(self, name: str, source: str, replaces: str, argtypes):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None                 # the bound entry, after first use

    def count_replays(self, launches: int) -> None:
        """Account ``launches`` runs of this kernel by graph replays."""
        self.launches += launches

    def entry(self, name: str, argtypes):
        """Another C entry of this kernel's library (a host-side helper,
        which launches nothing), returning int."""
        fn = getattr(load(self.source), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn

    def launch(self, *args) -> None:
        fn = self._fn
        if fn is None:
            fn = self._fn = self.entry(self.name, self.argtypes)
        err = fn(*args)
        if err != 0:
            msg = load(self.source).tg_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.name}: CUDA error {err} ({msg})")
        counts = getattr(_CAPTURE, "counts", None)
        if counts is not None:
            counts[self] = counts.get(self, 0) + 1
        else:
            self.launches += 1
