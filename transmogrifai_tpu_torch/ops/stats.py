"""Statistics over masked columnar data (counterpart of
``transmogrifai_tpu.ops.stats``): per-column moments, correlations with a
label, average-tie ranks and contingency counts, in f32 on the tensors'
device."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class ColStats(NamedTuple):
    """Per-column moments."""
    count: torch.Tensor      # valid count per column
    mean: torch.Tensor
    variance: torch.Tensor   # unbiased (n - 1), as Spark colStats
    min: torch.Tensor
    max: torch.Tensor
    num_nonzeros: torch.Tensor


def _row_mask(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    return mask.to(x.dtype)


def col_stats(x: torch.Tensor, mask: Optional[torch.Tensor] = None
              ) -> ColStats:
    """Masked per-column stats of an (n, d) matrix."""
    m = _row_mask(x, mask)[:, None]
    cnt = m.sum(0)
    xm = x * m
    mean = xm.sum(0) / torch.clamp(cnt, min=1.0)
    var = ((x - mean[None, :]) ** 2 * m).sum(0) / torch.clamp(cnt - 1.0,
                                                              min=1.0)
    big = torch.finfo(x.dtype).max
    mn = torch.where(m > 0, x, torch.full_like(x, big)).min(0).values
    mx = torch.where(m > 0, x, torch.full_like(x, -big)).max(0).values
    nz = ((xm != 0) & (m > 0)).sum(0)
    zero = torch.zeros_like(mn)
    return ColStats(cnt, mean, var, torch.where(cnt > 0, mn, zero),
                    torch.where(cnt > 0, mx, zero), nz)


def pearson_correlation(x: torch.Tensor, y: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked Pearson correlation of each column of (n, d) x with y (n,);
    NaN where a column or y is constant."""
    m = _row_mask(x, mask)
    cnt = torch.clamp(m.sum(), min=1.0)
    yc = (y - (y * m).sum() / cnt) * m
    xc = (x - ((x * m[:, None]).sum(0) / cnt)[None, :]) * m[:, None]
    cov = (xc * yc[:, None]).sum(0)
    denom = torch.sqrt((xc ** 2).sum(0) * (yc ** 2).sum())
    return torch.where(denom > 0, cov / torch.clamp(denom, min=1e-30),
                       torch.full_like(cov, float("nan")))


def pearson_correlation_matrix(x: torch.Tensor,
                               mask: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Full (d, d) correlation matrix; NaN for constant columns."""
    m = _row_mask(x, mask)
    cnt = torch.clamp(m.sum(), min=1.0)
    xc = (x - ((x * m[:, None]).sum(0) / cnt)[None, :]) * m[:, None]
    cov = xc.T @ xc
    std = torch.sqrt(torch.diagonal(cov))
    denom = std[:, None] * std[None, :]
    return torch.where(denom > 0, cov / torch.clamp(denom, min=1e-30),
                       torch.full_like(cov, float("nan")))


def _rank(v: torch.Tensor) -> torch.Tensor:
    """Average-tie ranks (1-based) of a 1-D tensor."""
    n = v.shape[0]
    order = torch.argsort(v, stable=True)
    sorted_v = v[order]
    ranks_ord = torch.arange(1, n + 1, dtype=v.dtype, device=v.device)
    is_new = torch.ones(n, dtype=torch.bool, device=v.device)
    is_new[1:] = sorted_v[1:] != sorted_v[:-1]
    seg = torch.cumsum(is_new.long(), 0) - 1
    seg_sum = torch.zeros(n, dtype=v.dtype, device=v.device).index_add_(
        0, seg, ranks_ord)
    seg_cnt = torch.zeros(n, dtype=v.dtype, device=v.device).index_add_(
        0, seg, torch.ones_like(ranks_ord))
    avg = seg_sum / torch.clamp(seg_cnt, min=1.0)
    out = torch.empty_like(avg)
    out[order] = avg[seg]
    return out


def spearman_correlation(x: torch.Tensor, y: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked Spearman correlation per column: Pearson over ranks (masked
    rows are ranked but left out of the correlation)."""
    ranks_x = torch.stack([_rank(x[:, j]) for j in range(x.shape[1])], 1)
    return pearson_correlation(ranks_x, _rank(y), mask)


def contingency_table(indicators: torch.Tensor, label_idx: torch.Tensor,
                      num_labels: int, mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """(k, L) contingency counts of (n, k) 0/1 indicator columns against
    integer labels (labels outside [0, L) count nowhere)."""
    ok = (label_idx >= 0) & (label_idx < num_labels)
    oh = torch.nn.functional.one_hot(
        torch.where(ok, label_idx, torch.zeros_like(label_idx)).long(),
        num_labels).to(indicators.dtype) * ok[:, None].to(indicators.dtype)
    oh = oh * _row_mask(indicators, mask)[:, None]
    return indicators.T @ oh
