"""Guarded host<->device transfers (counterpart of the transfer helpers of
``transmogrifai_tpu.parallel.distributed``).

A transfer is retried under a ``RetryPolicy`` when it fails with a
transient error; a retry re-issues only the copy, device state is
untouched. A "device put" is ``tensor.to(device)`` (synchronous) and a
fetch is ``.cpu()`` to a numpy array. Fault sites:
``distributed.to_host`` and ``distributed.device_put``. Moved bytes go to
``tg_transfer_bytes_total{direction=h2d|d2h}`` when metrics are on.

``initialize``, ``is_primary`` and ``barrier`` (``torch.distributed``)
wait for mesh training (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch


def _count_transfer_bytes(arr: Any, direction: str) -> None:
    """Count one successful crossing in ``tg_transfer_bytes_total``; no
    write when metrics are off."""
    from ..observability import metrics as _obs_metrics
    if not _obs_metrics.metrics_enabled():
        return
    nbytes = getattr(arr, "nbytes", None)
    if nbytes is None and isinstance(arr, torch.Tensor):
        nbytes = arr.numel() * arr.element_size()
    if nbytes:
        _obs_metrics.inc_counter(
            "tg_transfer_bytes_total", float(nbytes), direction=direction,
            help="bytes moved across the host<->device link")


def fetch_to_host(arr: Any, policy=None,
                  site: str = "distributed.to_host") -> np.ndarray:
    """``arr`` (a tensor on any device, or array-like) as a host numpy
    array, retried on transient errors. Fault site
    ``distributed.to_host``."""
    from ..robustness import faults
    from ..robustness.policy import RetryPolicy
    policy = policy or RetryPolicy(base_delay=0.01)

    def pull():
        faults.inject(site)
        if isinstance(arr, torch.Tensor):
            return arr.detach().cpu().numpy()
        return np.asarray(arr)

    out = policy.execute(pull, site=site)
    _count_transfer_bytes(out, "d2h")
    return out


def retrying_device_put(x: Any,
                        device: Optional[Union[str, torch.device]] = None,
                        policy=None,
                        site: str = "distributed.device_put"
                        ) -> torch.Tensor:
    """``x`` (numpy or a tensor) as a tensor on ``device`` (default: the
    CUDA device, ``device.resolve_device``), retried on transient errors.
    Fault site ``distributed.device_put``."""
    from ..device import resolve_device
    from ..robustness import faults
    from ..robustness.policy import RetryPolicy
    dev = resolve_device(device)
    policy = policy or RetryPolicy(base_delay=0.01)

    def put():
        faults.inject(site)
        return torch.as_tensor(x).to(dev, non_blocking=False)

    out = policy.execute(put, site=site)
    _count_transfer_bytes(out, "h2d")
    return out
