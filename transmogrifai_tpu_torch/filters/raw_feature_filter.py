"""RawFeatureFilter (counterpart of
``transmogrifai_tpu.filters.raw_feature_filter``): before any stage fits,
compare each raw feature's training distribution with its distribution in
a scoring file and with the label, and exclude the features (or map keys)
that are too empty, too shifted, or leak the label through their null
pattern.

The distributions are host work (``filters.distribution``). The null-label
correlations of all features are one pass on the filter's device: an
(n, F) null-indicator matrix against the label through
``ops.stats.pearson_correlation`` (or Spearman), in float32 as in the JAX
package, each result turned into a python float on the host. The JAX
package's mesh path (``set_mesh``, its device-sharded numeric
distributions, and the device binning of the columns that path keeps
on the device) is not ported and raises.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..features import Feature
from ..table import Column, FeatureTable
from .distribution import (
    FeatureDistribution, column_distributions, compare_distributions,
    fill_numeric_bins,
)


@dataclass
class FeatureMetrics:
    """The filter's metrics of one feature (or map key)."""
    name: str
    key: Optional[str]
    train_fill_rate: float
    score_fill_rate: Optional[float] = None
    fill_rate_delta: Optional[float] = None
    fill_ratio_diff: Optional[float] = None
    js_divergence: Optional[float] = None
    null_label_correlation: Optional[float] = None
    exclusion_reasons: List[str] = field(default_factory=list)

    @property
    def full_name(self) -> str:
        return self.name if self.key is None else f"{self.name}[{self.key}]"


@dataclass
class RawFeatureFilterResults:
    """The filter's configuration, metrics and decisions."""
    config: Dict[str, Any]
    metrics: List[FeatureMetrics]
    excluded_features: List[str]
    excluded_map_keys: Dict[str, List[str]]

    def to_json(self) -> Dict[str, Any]:
        def clean(d: Dict[str, Any]) -> Dict[str, Any]:
            return {k: (None if isinstance(v, float) and not np.isfinite(v)
                        else v) for k, v in d.items()}
        return {"config": self.config,
                "metrics": [clean(vars(m)) for m in self.metrics],
                "excludedFeatures": self.excluded_features,
                "excludedMapKeys": self.excluded_map_keys}


class RawFeatureFilter:
    """Screens raw features before the DAG fits. ``score_reader`` (or
    ``score_table``) gives the scoring data; ``device`` is where the
    null-label correlations run (the workflow sets its own; None: the CUDA
    device, as ``resolve_device``)."""

    def __init__(self, score_reader=None,
                 score_table: Optional[FeatureTable] = None,
                 bins: int = 100, min_fill_rate: float = 0.001,
                 max_fill_difference: float = 0.90,
                 max_fill_ratio_diff: float = 20.0,
                 max_js_divergence: float = 0.90,
                 max_correlation: float = 0.90,
                 correlation_type: str = "pearson",
                 protected_features: Sequence[str] = (),
                 text_bins: int = 255, device=None):
        self.score_reader = score_reader
        self.score_table = score_table
        self.bins = bins
        self.min_fill_rate = min_fill_rate
        self.max_fill_difference = max_fill_difference
        self.max_fill_ratio_diff = max_fill_ratio_diff
        self.max_js_divergence = max_js_divergence
        self.max_correlation = max_correlation
        self.correlation_type = correlation_type
        self.protected_features = set(protected_features)
        self.text_bins = text_bins
        self.device = device

    def set_mesh(self, mesh) -> "RawFeatureFilter":
        raise NotImplementedError(
            "the raw feature filter's mesh path is not ported (ROADMAP "
            "Queue 1 item 10)")

    def _device_numeric_distributions(self, table, feats):
        raise NotImplementedError(
            "the raw feature filter's mesh path is not ported (ROADMAP "
            "Queue 1 item 10)")

    def _distributions(self, table: FeatureTable,
                       features: Sequence[Feature]
                       ) -> Dict[str, List[FeatureDistribution]]:
        out: Dict[str, List[FeatureDistribution]] = {}
        for f in features:
            if f.is_response or f.name not in table:
                continue
            out[f.name] = column_distributions(
                f.name, table[f.name], self.bins, self.text_bins)
        return out

    def _null_label_correlations(self, table: FeatureTable,
                                 features: Sequence[Feature],
                                 label: Optional[Column],
                                 dists: Dict[str, List[FeatureDistribution]]
                                 ) -> Dict[str, float]:
        """corr(null indicator, label) of every feature or map key, in one
        pass on ``self.device``."""
        if label is None:
            return {}
        device = resolve_device(self.device)
        from ..ops.stats import pearson_correlation, spearman_correlation

        y = np.asarray(label.host_values(), np.float32)
        cols: List[np.ndarray] = []
        names: List[str] = []
        for f in features:
            if f.is_response or f.name not in dists:
                continue
            col = table[f.name]
            if col.kind == "map":
                valid = col.valid_mask()
                vals = col.host_values()
                # a key present with a None/NaN value is null, as in the
                # fill rates
                row_keys = [
                    frozenset(str(k) for k, x in vals[i].items()
                              if x is not None and not (
                                  isinstance(x, float) and np.isnan(x)))
                    if valid[i] and vals[i] is not None else frozenset()
                    for i in range(len(col))]
                for d in dists[f.name]:
                    cols.append(np.array([0.0 if d.key in ks else 1.0
                                          for ks in row_keys], np.float32))
                    names.append(d.full_name)
            else:
                cols.append((~col.valid_mask()).astype(np.float32))
                names.append(f.name)
        if not cols:
            return {}
        X = torch.as_tensor(np.stack(cols, axis=1), device=device)
        yd = torch.as_tensor(y, device=device)
        corr_fn = (spearman_correlation
                   if self.correlation_type == "spearman"
                   else pearson_correlation)
        corrs = corr_fn(X, yd).cpu().numpy()
        return {n: float(c) for n, c in zip(names, corrs)}

    def filter_raw(self, table: FeatureTable, raw_features: Sequence[Feature]
                   ) -> Tuple[FeatureTable, List[Feature],
                              RawFeatureFilterResults]:
        """(the table without the excluded features and map keys, the
        excluded raw features, the results) of a host table."""
        train_dists = self._distributions(table, raw_features)
        score_table = self.score_table
        if score_table is None and self.score_reader is not None:
            score_table = self.score_reader.generate_table(
                [f for f in raw_features if not f.is_response],
                require_response=False)
        score_dists = (self._distributions(score_table, raw_features)
                       if score_table is not None else None)
        label_col = next((table[f.name] for f in raw_features
                          if f.is_response and f.name in table), None)
        null_corr = self._null_label_correlations(
            table, raw_features, label_col, train_dists)

        metrics: List[FeatureMetrics] = []
        excluded_features: List[str] = []
        excluded_map_keys: Dict[str, List[str]] = {}
        for f in raw_features:
            if f.is_response or f.name not in train_dists:
                continue
            f_metrics: List[FeatureMetrics] = []
            for d in train_dists[f.name]:
                sd = None
                if score_dists is not None:
                    sd = next((s for s in score_dists.get(f.name, [])
                               if s.key == d.key), None)
                if d.is_numeric and sd is None:
                    fill_numeric_bins(d, sd, self.bins)
                m = FeatureMetrics(
                    name=f.name, key=d.key,
                    train_fill_rate=d.fill_fraction(),
                    null_label_correlation=null_corr.get(d.full_name))
                if sd is not None:
                    # a fill ratio of inf (one side empty) exceeds the limit
                    cmp = compare_distributions(d, sd, self.bins)
                    m.score_fill_rate = cmp["scoreFill"]
                    m.fill_rate_delta = cmp["fillDelta"]
                    m.fill_ratio_diff = cmp["fillRatio"]
                    m.js_divergence = cmp["jsDivergence"]
                self._apply_exclusions(m, sd is not None)
                f_metrics.append(m)
                metrics.append(m)

            # a map feature with no key at all is held to the fill rates of
            # its whole column, as an empty scalar feature is
            whole_column = not f_metrics
            if whole_column:
                col = table[f.name]
                m = FeatureMetrics(
                    name=f.name, key=None,
                    train_fill_rate=(float(col.valid_mask().mean())
                                     if len(col) else 0.0))
                if score_table is not None and f.name in score_table:
                    scol = score_table[f.name]
                    m.score_fill_rate = (float(scol.valid_mask().mean())
                                         if len(scol) else 0.0)
                    m.fill_rate_delta = abs(m.train_fill_rate
                                            - m.score_fill_rate)
                    lo = min(m.train_fill_rate, m.score_fill_rate)
                    hi = max(m.train_fill_rate, m.score_fill_rate)
                    m.fill_ratio_diff = float(np.inf) if lo == 0 else hi / lo
                self._apply_exclusions(m, m.score_fill_rate is not None)
                f_metrics.append(m)
                metrics.append(m)

            if f.name in self.protected_features:
                for m in f_metrics:
                    if m.exclusion_reasons:
                        m.exclusion_reasons = [r + " (protected, kept)"
                                               for r in m.exclusion_reasons]
                continue
            if table[f.name].kind == "map" and not whole_column:
                bad_keys = [m.key for m in f_metrics
                            if m.exclusion_reasons and m.key is not None]
                if bad_keys and len(bad_keys) == len(f_metrics):
                    excluded_features.append(f.name)
                elif bad_keys:
                    excluded_map_keys[f.name] = bad_keys
            elif any(m.exclusion_reasons for m in f_metrics):
                excluded_features.append(f.name)

        results = RawFeatureFilterResults(
            config={"bins": self.bins, "minFillRate": self.min_fill_rate,
                    "maxFillDifference": self.max_fill_difference,
                    "maxFillRatioDiff": self.max_fill_ratio_diff,
                    "maxJSDivergence": self.max_js_divergence,
                    "maxCorrelation": self.max_correlation,
                    "correlationType": self.correlation_type},
            metrics=metrics, excluded_features=sorted(excluded_features),
            excluded_map_keys=excluded_map_keys)
        cleaned = self._clean_table(table, excluded_features,
                                    excluded_map_keys)
        gone = set(excluded_features)
        blacklist = [f for f in raw_features if f.name in gone]
        return cleaned, blacklist, results

    def _apply_exclusions(self, m: FeatureMetrics, has_score: bool) -> None:
        """The exclusion reasons of one feature's metrics."""
        if m.train_fill_rate < self.min_fill_rate:
            m.exclusion_reasons.append(
                f"train fill rate {m.train_fill_rate:.4f} below "
                f"{self.min_fill_rate}")
        if has_score:
            if (m.score_fill_rate is not None
                    and m.score_fill_rate < self.min_fill_rate):
                m.exclusion_reasons.append(
                    f"score fill rate {m.score_fill_rate:.4f} below "
                    f"{self.min_fill_rate}")
            if (m.fill_rate_delta is not None
                    and m.fill_rate_delta > self.max_fill_difference):
                m.exclusion_reasons.append(
                    f"fill rate delta {m.fill_rate_delta:.4f} above "
                    f"{self.max_fill_difference}")
            if (m.fill_ratio_diff is not None
                    and m.fill_ratio_diff > self.max_fill_ratio_diff):
                m.exclusion_reasons.append(
                    f"fill ratio diff {m.fill_ratio_diff:.2f} above "
                    f"{self.max_fill_ratio_diff}")
            if (m.js_divergence is not None
                    and m.js_divergence > self.max_js_divergence):
                m.exclusion_reasons.append(
                    f"JS divergence {m.js_divergence:.4f} above "
                    f"{self.max_js_divergence}")
        if (m.null_label_correlation is not None
                and abs(m.null_label_correlation) > self.max_correlation):
            m.exclusion_reasons.append(
                f"null-label correlation {m.null_label_correlation:.4f} "
                f"above {self.max_correlation} (leakage)")

    @staticmethod
    def _clean_table(table: FeatureTable, excluded: List[str],
                     excluded_keys: Dict[str, List[str]]) -> FeatureTable:
        """The table without the excluded columns, and without the excluded
        keys of each map column (a row left with no key is missing)."""
        out = table.drop([n for n in excluded if n in table])
        for name, keys in excluded_keys.items():
            if name not in out:
                continue
            col = out[name]
            gone = set(keys)
            vals = np.empty(len(col), dtype=object)
            for i, v in enumerate(col.host_values()):
                vals[i] = (None if v is None else
                           {k: x for k, x in v.items() if str(k) not in gone})
            mask = np.array([v is not None and len(v) > 0 for v in vals])
            out = out.with_column(name, Column(col.feature_type, vals, mask,
                                               col.metadata))
        return out

