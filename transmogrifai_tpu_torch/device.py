"""Device policy of the port's entry points: they run on CUDA unless the
caller names another device, and they never fall back to the CPU on their
own."""
from __future__ import annotations

import time
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA device, and
    raises when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return torch.device("cuda", torch.cuda.current_device())


def synced_clock(device: torch.device) -> float:
    """The host clock once ``device`` has finished its queued work (a
    CUDA device is synchronized first): phase timings end here."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()
