"""Resource-exhaustion classification and downshift accounting
(counterpart of ``transmogrifai_tpu.robustness.resources``).

A chunk that does not fit on the card raises ``torch.cuda.OutOfMemoryError``
(or a ``RuntimeError`` saying CUDA ran out of memory); host assembly raises
``MemoryError``. Neither is transient: the same allocation fails again, so
the only useful response is a downshift, the same work in smaller pieces
whose results compose exactly. ``classify_exhaustion`` is the one place
that says what out of memory looks like, and ``record_downshift`` the one
place that accounts a downshift. The streamed train's downshift
(``streaming.trainer.StreamRun.fold``) halves the chunk row budget and
continues from the committed-row prefix.
"""
from __future__ import annotations

import errno
import os
from typing import Any, Optional

import torch

#: message substrings (lowercased) that mark a runtime error as memory
#: exhaustion
EXHAUSTED_PATTERNS = (
    "resource_exhausted", "resource exhausted", "out of memory",
    "failed to allocate", "allocation failure",
)

#: the smallest chunk row budget the streaming downshift may halve to
OOM_MIN_CHUNK_ROWS_ENV = "TG_OOM_MIN_CHUNK_ROWS"
DEFAULT_MIN_CHUNK_ROWS = 64


def min_chunk_rows() -> int:
    try:
        return max(1, int(os.environ.get(OOM_MIN_CHUNK_ROWS_ENV, "")
                          or DEFAULT_MIN_CHUNK_ROWS))
    except ValueError:
        return DEFAULT_MIN_CHUNK_ROWS


class ResourceExhaustedError(RuntimeError):
    """The card or the host could not satisfy an allocation. The same work
    size fails again, so it is never retried: the downshift paths split
    the work instead."""

    def __init__(self, message: str, site: Optional[str] = None):
        super().__init__(message)
        self.site = site


def classify_exhaustion(exc: BaseException
                        ) -> Optional[ResourceExhaustedError]:
    """A typed :class:`ResourceExhaustedError` view of ``exc`` when it is
    memory exhaustion, else None: a ``ResourceExhaustedError`` itself,
    ``torch.cuda.OutOfMemoryError``, a host ``MemoryError`` or an
    ``OSError`` of ``ENOMEM``, or a ``RuntimeError`` whose message says
    memory ran out (:data:`EXHAUSTED_PATTERNS`)."""
    if isinstance(exc, ResourceExhaustedError):
        return exc
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return ResourceExhaustedError(f"CUDA out of memory: {exc}"[:500])
    if isinstance(exc, MemoryError):
        return ResourceExhaustedError(f"host MemoryError: {exc}")
    if isinstance(exc, OSError) and getattr(exc, "errno", None) == errno.ENOMEM:
        return ResourceExhaustedError(f"host ENOMEM: {exc}")
    if isinstance(exc, RuntimeError):
        msg = str(exc).lower()
        if any(p in msg for p in EXHAUSTED_PATTERNS):
            return ResourceExhaustedError(
                f"{type(exc).__name__}: {exc}"[:500])
    return None


def is_resource_exhausted(exc: BaseException) -> bool:
    return classify_exhaustion(exc) is not None


def record_downshift(site: str, fault_log: Optional[Any] = None,
                     **detail: Any) -> None:
    """Account one downshift at ``site`` (``oom.stream``): an
    ``oom_downshift`` report on ``fault_log``, or on the ambient log."""
    from .policy import FaultLog, FaultReport
    report = FaultReport(site=site, kind="oom_downshift",
                         detail=dict(detail))
    if fault_log is not None:
        fault_log.add(report)
    else:
        FaultLog.record(report)
