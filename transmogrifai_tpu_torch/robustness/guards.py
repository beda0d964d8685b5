"""Non-finite guards (counterpart of ``transmogrifai_tpu.robustness.guards``):
a diverging candidate is quarantined instead of crashing the sweep.

A linear candidate whose loss diverges, a tree whose leaf stats overflow,
or a poisoned metric (``faults.poison``) all surface as non-finite CV
metrics or fitted params. The guards turn each into a quarantine record,
the sweep goes on with the other candidates, and only the case where
every candidate failed raises, with every reason aggregated.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .policy import FaultLog, FaultReport


class AllCandidatesFailedError(RuntimeError):
    """Every candidate of the sweep was quarantined; carries the
    per-candidate reasons so one traceback explains the whole failure."""

    def __init__(self, records: List[Dict[str, Any]]):
        self.records = list(records)
        lines = [f"  - {r.get('family')}[{r.get('gridIndex')}] "
                 f"{r.get('hyper')}: {r.get('reason')}" for r in self.records]
        super().__init__("all %d sweep candidate(s) were quarantined:\n%s"
                         % (len(self.records), "\n".join(lines)))


def quarantine_non_finite(family: str, grid: List[Dict[str, Any]],
                          fold_metrics: np.ndarray, metric_name: str,
                          larger_better: bool,
                          reason: Optional[str] = None
                          ) -> Tuple[np.ndarray, np.ndarray,
                                     List[Dict[str, Any]]]:
    """Validate one family's (F, G) CV metric matrix.

    Returns ``(mean_metrics, masked_means, records)``: the per-config means
    (NaN kept for reporting), the means with non-finite entries made the
    worst value (so argmax/argmin never elects a quarantined config), and
    one record per non-finite config, each also recorded on the ambient
    ``FaultLog`` (``validator.candidate``/``quarantine``). ``reason``
    replaces the default reason (a family whose fit raised). With every
    config finite the masked means are the means, bit for bit."""
    mean_metrics = fold_metrics.mean(axis=0)
    finite = np.isfinite(mean_metrics)
    records: List[Dict[str, Any]] = []
    for g in np.nonzero(~finite)[0]:
        rec = {"family": family, "gridIndex": int(g),
               "hyper": dict(grid[g]) if g < len(grid) else {},
               "metricName": metric_name,
               "foldMetrics": [float(v) for v in fold_metrics[:, g]],
               "reason": reason or ("non-finite validation metric "
                                    f"({mean_metrics[g]!r})")}
        records.append(rec)
        FaultLog.record(FaultReport(site="validator.candidate",
                                    kind="quarantine", detail=rec))
    if finite.all():
        return mean_metrics, mean_metrics, records
    worst = -np.inf if larger_better else np.inf
    return mean_metrics, np.where(finite, mean_metrics, worst), records


def params_finite(params: Dict[str, Any], allow_inf: Sequence[str] = ()
                  ) -> bool:
    """True when every float tensor leaf of fitted params is finite
    (nested dicts and tuples of tensors, as the MLP's, included). Keys in
    ``allow_inf`` (tree thresholds, where +inf marks a stopped node) are
    checked for NaN only. The reduction runs on the tensors' device; one
    flag per leaf reaches the host."""
    for k, v in params.items():
        if isinstance(v, dict):
            if not params_finite(v, allow_inf):
                return False
            continue
        for t in (v if isinstance(v, tuple) else (v,)):
            if not (isinstance(t, torch.Tensor)
                    and torch.is_floating_point(t)):
                continue
            bad = torch.isnan(t) if k in allow_inf else ~torch.isfinite(t)
            if bool(bad.any()):
                return False
    return True
