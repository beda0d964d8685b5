"""Device policy of the port's entry points: they run on CUDA unless the
caller names another device, and they never fall back to the CPU on their
own."""
from __future__ import annotations

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
