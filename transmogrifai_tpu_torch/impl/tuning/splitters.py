"""Data splitters (counterpart of ``transmogrifai_tpu.impl.tuning.splitters``):
test reservation, binary class balancing and multiclass label cutting.
Host numpy, seeded as the JAX package seeds them, so both packages draw
the same rows."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np


@dataclass
class PreparedData:
    """Pre-validation preparation: row indices into the train split
    (resampling as indices) and what was done."""
    indices: np.ndarray
    summary: Dict[str, Any] = field(default_factory=dict)
    label_mapping: Optional[Dict[int, int]] = None


class Splitter:
    """Reserve a test fraction, prepare the train rows."""

    def __init__(self, reserve_test_fraction: float = 0.1, seed: int = 42):
        if not 0.0 <= reserve_test_fraction < 1.0:
            raise ValueError("reserve_test_fraction must be in [0, 1)")
        self.reserve_test_fraction = reserve_test_fraction
        self.seed = seed
        self.summary: Dict[str, Any] = {}

    def split(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """(train_idx, test_idx): a seeded random split, each sorted."""
        rng = np.random.RandomState(self.seed)
        perm = rng.permutation(n)
        n_test = int(round(n * self.reserve_test_fraction))
        return np.sort(perm[n_test:]), np.sort(perm[:n_test])

    def pre_validation_prepare(self, y: np.ndarray) -> PreparedData:
        """Balancing/cutting of the train split. Default: identity."""
        return PreparedData(indices=np.arange(len(y)))


class DataSplitter(Splitter):
    """Plain random split (regression problems)."""


class DataBalancer(Splitter):
    """Binary balancer: when the minority fraction is below
    ``sample_fraction``, down-sample the majority so the minority makes up
    about ``sample_fraction`` of the result, at most
    ``max_training_sample`` rows."""

    def __init__(self, sample_fraction: float = 0.1,
                 max_training_sample: int = 1_000_000,
                 already_balanced_fraction_cutoff: float = 0.3, **kw):
        super().__init__(**kw)
        self.sample_fraction = sample_fraction
        self.max_training_sample = max_training_sample
        self.already_balanced_fraction_cutoff = \
            already_balanced_fraction_cutoff

    def pre_validation_prepare(self, y: np.ndarray) -> PreparedData:
        rng = np.random.RandomState(self.seed)
        pos_idx = np.nonzero(y > 0.5)[0]
        neg_idx = np.nonzero(y <= 0.5)[0]
        n_pos, n_neg = len(pos_idx), len(neg_idx)
        n = n_pos + n_neg
        small, big = ((pos_idx, neg_idx) if n_pos <= n_neg
                      else (neg_idx, pos_idx))
        frac = len(small) / max(n, 1)
        summary: Dict[str, Any] = {
            "positiveCount": int(n_pos), "negativeCount": int(n_neg),
            "minorityFraction": frac, "balanced": False,
        }
        if (frac >= min(self.sample_fraction,
                        self.already_balanced_fraction_cutoff)
                or len(small) == 0):
            idx = np.arange(n)
            if n > self.max_training_sample:
                idx = np.sort(rng.choice(n, self.max_training_sample,
                                         replace=False))
                summary["downsampledTo"] = self.max_training_sample
            self.summary = summary
            return PreparedData(indices=idx, summary=summary)
        target_big = int(len(small) * (1.0 - self.sample_fraction)
                         / self.sample_fraction)
        target_big = max(min(target_big, len(big)), len(small))
        big_keep = rng.choice(big, target_big, replace=False)
        idx = np.sort(np.concatenate([small, big_keep]))
        if len(idx) > self.max_training_sample:
            idx = np.sort(rng.choice(idx, self.max_training_sample,
                                     replace=False))
        summary.update({"balanced": True,
                        "downsampledMajorityTo": int(target_big),
                        "resultSize": int(len(idx))})
        self.summary = summary
        return PreparedData(indices=idx, summary=summary)


class DataCutter(Splitter):
    """Multiclass label cutter: keep at most ``max_label_categories``
    labels, the most frequent first, and only labels with at least
    ``min_label_fraction`` of the rows; drop the other rows and re-index
    the kept labels to 0..K-1 in ascending order (``label_mapping``)."""

    def __init__(self, max_label_categories: int = 100,
                 min_label_fraction: float = 0.0, **kw):
        super().__init__(**kw)
        if min_label_fraction >= 0.5:
            raise ValueError("min_label_fraction must be < 0.5")
        self.max_label_categories = max_label_categories
        self.min_label_fraction = min_label_fraction

    def pre_validation_prepare(self, y: np.ndarray) -> PreparedData:
        labels, counts = np.unique(y.astype(np.int64), return_counts=True)
        frac = counts / counts.sum()
        order = np.argsort(-counts)
        kept = {int(labels[i]) for i in order[:self.max_label_categories]
                if frac[i] >= self.min_label_fraction}
        if not kept:
            raise ValueError("DataCutter dropped all labels")
        mask = np.isin(y.astype(np.int64), list(kept))
        mapping = {lab: i for i, lab in enumerate(sorted(kept))}
        summary = {"labelsKept": sorted(kept),
                   "labelsDropped": sorted({int(v) for v in labels} - kept),
                   "rowsKept": int(mask.sum())}
        self.summary = summary
        return PreparedData(indices=np.nonzero(mask)[0], summary=summary,
                            label_mapping=mapping)
