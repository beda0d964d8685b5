"""SanityChecker (counterpart of
``transmogrifai_tpu.impl.preparators.sanity_checker``): drops the
feature-vector slots whose statistics flag leakage or uselessness.

The fit computes column moments, label correlations (Pearson, or Spearman
on request) and, for indicator groups, contingency counts on the table's
device; the column decisions run on the host from those arrays, with the
JAX package's thresholds, reasons and feature-group propagation. The
summary holders have the fields of the JAX package's summary classes
(``sanity_checker_metadata.py`` there), with its dict view and its
reader (``SanityCheckerSummary.from_json``).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...ops.stats import (
    col_stats, contingency_table, pearson_correlation,
    pearson_correlation_matrix, spearman_correlation, _rank,
)
from ...stages.base import AllowLabelAsInput, Estimator, Transformer
from ...table import Column, FeatureTable
from ...types import OPVector, RealNN
from ...vector_metadata import VectorColumnMetadata, VectorMetadata

#: parent types whose shared-hash slots ``protect_text_shared_hash`` keeps
_TEXT_PARENT_TYPES = ("Text", "TextArea", "TextMap", "TextAreaMap",
                      "TextList")


@dataclass
class ColumnStatistics:
    names: List[str] = field(default_factory=list)
    count: List[float] = field(default_factory=list)
    mean: List[float] = field(default_factory=list)
    variance: List[float] = field(default_factory=list)
    min: List[float] = field(default_factory=list)
    max: List[float] = field(default_factory=list)


@dataclass
class CategoricalGroupStats:
    cramers_v: Dict[str, float] = field(default_factory=dict)
    mutual_info: Dict[str, float] = field(default_factory=dict)
    pointwise_mutual_info: Dict[str, List[List[float]]] = field(
        default_factory=dict)


@dataclass
class SanityCheckerSummary:
    stats: ColumnStatistics = field(default_factory=ColumnStatistics)
    categorical: CategoricalGroupStats = field(
        default_factory=CategoricalGroupStats)
    correlations_with_label: List[Optional[float]] = field(
        default_factory=list)
    correlation_type: str = "pearson"
    dropped: List[str] = field(default_factory=list)
    reasons: Dict[str, List[str]] = field(default_factory=dict)
    sample_size: int = 0
    feature_correlations: Optional[Any] = None
    schema_version: int = 3

    #: widest feature-correlation matrix ``to_json`` inlines
    _JSON_CORR_MAX_D = 512

    #: the dict view: the JAX package's summary keys (and the flat stat
    #: names of schema 1) read as ``summary[key]``
    _ALIASES = {
        "names": lambda s: s.stats.names,
        "count": lambda s: s.stats.count,
        "mean": lambda s: s.stats.mean,
        "variance": lambda s: s.stats.variance,
        "min": lambda s: s.stats.min,
        "max": lambda s: s.stats.max,
        "correlationsWithLabel": lambda s: s.correlations_with_label,
        "correlationType": lambda s: s.correlation_type,
        "cramersV": lambda s: s.categorical.cramers_v,
        "mutualInfo": lambda s: s.categorical.mutual_info,
        "pointwiseMutualInfo": lambda s: s.categorical.pointwise_mutual_info,
        "featureCorrelations": lambda s: s._corr_json(),
        "dropped": lambda s: s.dropped,
        "reasons": lambda s: s.reasons,
        "sampleSize": lambda s: s.sample_size,
        "schemaVersion": lambda s: s.schema_version,
    }

    def __getitem__(self, key: str) -> Any:
        try:
            return self._ALIASES[key](self)
        except KeyError:
            raise KeyError(key) from None

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def __contains__(self, key: str) -> bool:
        return key in self._ALIASES

    def keys(self):
        return self._ALIASES.keys()

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "SanityCheckerSummary":
        """A summary from its JSON, as either package writes it: schema 1's
        flat dict and schema 2 are read as schema 3 (the categorical
        stats' mutual information and the feature-correlation matrix
        default empty); another version raises."""
        version = d.get("schemaVersion", 1)
        if version == 1:
            return cls(
                stats=ColumnStatistics(
                    names=list(d.get("names", [])),
                    count=list(d.get("count", [])),
                    mean=list(d.get("mean", [])),
                    variance=list(d.get("variance", [])),
                    min=list(d.get("min", [])),
                    max=list(d.get("max", []))),
                categorical=CategoricalGroupStats(
                    cramers_v=dict(d.get("cramersV", {}))),
                correlations_with_label=list(
                    d.get("correlationsWithLabel", [])),
                correlation_type=d.get("correlationType", "pearson"),
                dropped=list(d.get("dropped", [])),
                reasons=dict(d.get("reasons", {})),
                sample_size=int(d.get("sampleSize", 0)))
        if version in (2, 3):
            return cls(
                stats=ColumnStatistics(**d["stats"]),
                categorical=CategoricalGroupStats(**d["categorical"]),
                correlations_with_label=list(d["correlationsWithLabel"]),
                correlation_type=d["correlationType"],
                dropped=list(d["dropped"]),
                reasons=dict(d["reasons"]),
                sample_size=int(d["sampleSize"]),
                feature_correlations=d.get("featureCorrelations"))
        raise ValueError(
            f"unknown SanityChecker summary schemaVersion {version}")

    def to_json(self) -> Dict[str, Any]:
        """The JAX package's summary JSON (the fitted model's
        ``summary_metadata``)."""
        return {
            "schemaVersion": self.schema_version,
            "stats": asdict(self.stats),
            "categorical": asdict(self.categorical),
            "correlationsWithLabel": self.correlations_with_label,
            "correlationType": self.correlation_type,
            "dropped": list(self.dropped),
            "reasons": dict(self.reasons),
            "sampleSize": self.sample_size,
            "featureCorrelations": self._corr_json(),
        }

    def _corr_json(self) -> Optional[List[List[Optional[float]]]]:
        fc = self.feature_correlations
        if fc is None:
            return None
        if isinstance(fc, torch.Tensor):
            fc = fc.cpu().numpy()
        fc = np.asarray(fc, dtype=np.float64)
        if fc.shape[0] > self._JSON_CORR_MAX_D:
            return None
        return [[None if np.isnan(v) else round(float(v), 6) for v in r]
                for r in fc]


def _is_text_shared_hash(c: VectorColumnMetadata) -> bool:
    """A text-derived hash slot that is not an indicator."""
    return (c.parent_feature_type in _TEXT_PARENT_TYPES
            and c.indicator_value is None
            and (c.descriptor_value or "").startswith("hash_"))


def _contingency_stats_np(t: np.ndarray) -> Dict[str, Any]:
    """Cramér's V, rule confidence, support, mutual information and
    pointwise mutual information of a small (m, L) contingency table."""
    t = t.astype(np.float64)
    n = max(t.sum(), 1.0)
    row = t.sum(axis=1)
    col = t.sum(axis=0)
    expected = row[:, None] * col[None, :] / n
    chi2 = np.where(expected > 0,
                    (t - expected) ** 2 / np.maximum(expected, 1e-30),
                    0.0).sum()
    min_dim = max(min((row > 0).sum(), (col > 0).sum()) - 1, 1)
    conf = np.where(row[:, None] > 0, t / np.maximum(row[:, None], 1e-30),
                    0.0)
    p = t / n
    denom = (row[:, None] / n) * (col[None, :] / n)
    pmi = np.where((p > 0) & (denom > 0),
                   np.log2(np.maximum(p, 1e-300)
                           / np.maximum(denom, 1e-300)), 0.0)
    return {"cramers_v": float(np.sqrt(chi2 / (n * min_dim))),
            "max_rule_confidence": conf.max(axis=1),
            "support": row / n,
            "mutual_info": float((p * pmi).sum()),
            "pointwise_mutual_info": pmi}


class SanityChecker(AllowLabelAsInput, Estimator):
    """Estimator[RealNN label, OPVector] -> OPVector (defaults as the JAX
    package's ``SanityCheckerDefaults``)."""

    input_types = (RealNN, OPVector)
    output_type = OPVector

    def __init__(self, check_sample: float = 1.0,
                 sample_lower_limit: int = 1_000,
                 sample_upper_limit: int = 1_000_000,
                 protect_text_shared_hash: bool = False,
                 max_correlation: float = 0.95,
                 min_correlation: float = 0.0,
                 max_cramers_v: float = 0.95,
                 min_variance: float = 1e-5,
                 max_rule_confidence: float = 1.0,
                 min_required_rule_support: float = 1.0,
                 remove_bad_features: bool = True,
                 remove_feature_group: bool = True,
                 correlation_type_spearman: bool = False,
                 correlations: str = "label",
                 seed: int = 42, uid: Optional[str] = None):
        super().__init__("sanityCheck", uid)
        if correlations not in ("label", "full"):
            raise ValueError(
                f"correlations must be 'label' or 'full', got "
                f"{correlations!r}")
        self.check_sample = check_sample
        self.sample_lower_limit = sample_lower_limit
        self.sample_upper_limit = sample_upper_limit
        self.protect_text_shared_hash = protect_text_shared_hash
        self.max_correlation = max_correlation
        self.min_correlation = min_correlation
        self.max_cramers_v = max_cramers_v
        self.min_variance = min_variance
        self.max_rule_confidence = max_rule_confidence
        self.min_required_rule_support = min_required_rule_support
        self.remove_bad_features = remove_bad_features
        self.remove_feature_group = remove_feature_group
        self.correlation_type_spearman = correlation_type_spearman
        self.correlations = correlations
        self.seed = seed

    def fit(self, table: FeatureTable) -> Transformer:
        label_f, vec_f = self.input_features
        y_all = torch.as_tensor(table[label_f.name].values).to(
            torch.float32).reshape(-1)
        col = table[vec_f.name]
        vm: Optional[VectorMetadata] = col.metadata.get("vector_meta")
        X_all = torch.as_tensor(col.values).to(torch.float32)
        n, d = X_all.shape
        # sample: the check_sample fraction, clamped so the sample has at
        # least sample_lower_limit and at most sample_upper_limit rows
        min_frac = min(1.0, self.sample_lower_limit / max(n, 1))
        max_frac = max(0.0, self.sample_upper_limit / max(n, 1))
        frac = max(min(self.check_sample, max_frac), min_frac)
        target = min(int(round(n * frac)), n)
        if target < n:
            rng = np.random.RandomState(self.seed)
            idx = torch.as_tensor(rng.choice(n, size=target, replace=False),
                                  device=X_all.device)
            X, y = X_all[idx], y_all[idx]
        else:
            X, y = X_all, y_all
        stats = col_stats(X)
        dev: Dict[str, torch.Tensor] = dict(stats._asdict())
        dev["corr"] = (spearman_correlation(X, y)
                       if self.correlation_type_spearman
                       else pearson_correlation(X, y))
        if self.correlations == "full":
            Xc = X
            if self.correlation_type_spearman:
                Xc = torch.stack([_rank(X[:, j]) for j in range(d)], 1)
            dev["feature_corr"] = pearson_correlation_matrix(Xc)
        ys = y.cpu().numpy()
        groups: List[Any] = []
        if vm is not None:
            labels = np.unique(ys)
            if len(labels) <= 20 and np.allclose(labels,
                                                 labels.astype(int)):
                # contingency stats for indicator (0/1 pivot) groups only
                groups = [(g, idxs) for g, idxs in vm.index_of_group().items()
                          if all(vm.columns[i].indicator_value is not None
                                 for i in idxs)]
                if groups:
                    all_idx = torch.as_tensor(
                        np.concatenate([np.asarray(i) for _, i in groups]),
                        device=X.device)
                    dev["counts"] = contingency_table(
                        X[:, all_idx], y.to(torch.int64),
                        int(ys.max()) + 1)
        host = {k: v.cpu().numpy() for k, v in dev.items()}
        return self._decide(host, d=d, vm=vm, groups=groups,
                            n_sample=int(len(ys)))

    # -- streaming fit (OpWorkflow.train(stream=...)) ------------------------
    def fit_streaming_prep(self, run):
        """The one-pass spec ``(pass_id, fold, extract, finish)``: column
        moments, label correlations (Pearson; with ``correlations="full"``
        the feature matrix too) and the indicator groups' contingency
        counts as float64 folds over every row, then the in-core fit's
        decisions. Spearman raises: exact ranks need the whole dataset."""
        from ...streaming.folds import (
            ColStatsFold, CompositeFold, ContingencyFold, CorrelationFold,
        )
        if self.correlation_type_spearman:
            raise ValueError(
                "SanityChecker(correlation_type_spearman=True) cannot fit "
                "on a stream: exact ranks need the full dataset. Use "
                "Pearson, or train in-core.")
        label_f, vec_f = self.input_features
        col = run.probe_table()[vec_f.name]
        vm: Optional[VectorMetadata] = col.metadata.get("vector_meta")
        d = col.width
        groups: List[Any] = []
        all_idx = np.zeros(0, np.int64)
        if vm is not None:
            groups = [(g, idxs) for g, idxs in vm.index_of_group().items()
                      if all(vm.columns[i].indicator_value is not None
                             for i in idxs)]
            if groups:
                all_idx = np.concatenate(
                    [np.asarray(idxs) for _, idxs in groups])
        folds: Dict[str, Any] = {
            "stats": ColStatsFold(d),
            "corr": CorrelationFold(d, full=self.correlations == "full"),
        }
        if groups:
            folds["cont"] = ContingencyFold(len(all_idx))
        composite = CompositeFold(folds)

        def extract(table: FeatureTable):
            X = np.asarray(table[vec_f.name].host_values(), dtype=np.float32)
            y = np.asarray(table[label_f.name].host_values(),
                           dtype=np.float32).reshape(-1)
            parts = {"stats": (X,), "corr": (X, y)}
            if groups:
                parts["cont"] = (X[:, all_idx], y)
            return (parts,)

        def finish(state) -> Transformer:
            grps = groups
            res = composite.finalize(state)
            stats = res["stats"]
            host: Dict[str, np.ndarray] = {
                "count": stats.count, "mean": stats.mean,
                "variance": stats.variance, "min": stats.min,
                "max": stats.max, "corr": res["corr"]}
            if folds["corr"].full:
                host["feature_corr"] = folds["corr"].finalize_matrix(
                    state["corr"])
            if grps:
                if res["cont"] is None:
                    # labels were not binary-like: the in-core branch
                    grps = []
                else:
                    host["counts"] = res["cont"].astype(np.float64)
            return self._decide(host, d=d, vm=vm, groups=grps,
                                n_sample=int(state["corr"]["n"]))

        return "sanity", composite, extract, finish

    def fit_streaming(self, run) -> Transformer:
        """One pass of float64 folds over the chunks, then the in-core
        fit's decisions (``_decide``). Unlike the in-core fit it samples
        no rows: every row folds."""
        pass_id, fold, extract, finish = self.fit_streaming_prep(run)
        return finish(run.fold(pass_id, fold, extract))

    def _decide(self, host: Dict[str, np.ndarray], *, d: int,
                vm: Optional[VectorMetadata], groups: List[Any],
                n_sample: int) -> Transformer:
        """Column decisions from the host stat arrays (reasons as the
        reference's ColumnStatistics.reasonsToRemove)."""
        stats = {k: host[k] for k in ("count", "mean", "variance", "min",
                                      "max")}
        corr = host["corr"]
        cramers_by_col = np.full(d, np.nan)
        rule_conf_by_col = np.full(d, np.nan)
        support_by_col = np.full(d, np.nan)
        group_cramers: Dict[str, float] = {}
        group_mi: Dict[str, float] = {}
        group_pmi: Dict[str, List[List[float]]] = {}
        off = 0
        for group, idxs in groups:
            m = len(idxs)
            cs = _contingency_stats_np(host["counts"][off:off + m])
            off += m
            group_cramers[group] = cs["cramers_v"]
            group_mi[group] = cs["mutual_info"]
            group_pmi[group] = [[round(float(x), 6) for x in r]
                                for r in cs["pointwise_mutual_info"]]
            for j, i_col in enumerate(idxs):
                cramers_by_col[i_col] = cs["cramers_v"]
                rule_conf_by_col[i_col] = cs["max_rule_confidence"][j]
                support_by_col[i_col] = cs["support"][j]

        reasons: Dict[int, List[str]] = {}

        def flag(i: int, why: str):
            reasons.setdefault(i, []).append(why)

        for i in range(d):
            if stats["variance"][i] < self.min_variance:
                flag(i, f"variance {stats['variance'][i]:.3g} below min "
                        f"{self.min_variance}")
            c = corr[i]
            if not np.isnan(c):
                if abs(c) > self.max_correlation:
                    flag(i, f"label correlation {c:.3f} above max "
                            f"{self.max_correlation} (leakage)")
                elif abs(c) < self.min_correlation:
                    flag(i, f"label correlation {c:.3f} below min "
                            f"{self.min_correlation}")
            if (not np.isnan(cramers_by_col[i])
                    and cramers_by_col[i] > self.max_cramers_v):
                flag(i, f"Cramér's V {cramers_by_col[i]:.3f} above max "
                        f"{self.max_cramers_v}")
            if (not np.isnan(rule_conf_by_col[i])
                    and rule_conf_by_col[i] >= self.max_rule_confidence
                    and support_by_col[i] >= 0
                    and support_by_col[i] * n_sample
                    >= self.min_required_rule_support):
                flag(i, f"association rule confidence "
                        f"{rule_conf_by_col[i]:.3f} at/above max "
                        f"{self.max_rule_confidence} (leakage)")
        # one leaking slot of a feature group takes its siblings along
        if self.remove_feature_group and vm is not None and reasons:
            leak = {i for i, why in reasons.items()
                    if any("leakage" in w or "Cramér" in w for w in why)}
            for group, idxs in vm.index_of_group().items():
                if leak.intersection(idxs):
                    for i in idxs:
                        if i in reasons or (
                                self.protect_text_shared_hash
                                and _is_text_shared_hash(vm.columns[i])):
                            continue
                        flag(i, f"sibling column in group '{group}' flagged "
                                f"for leakage")
        to_remove = sorted(reasons) if self.remove_bad_features else []
        removed = set(to_remove)
        keep = [i for i in range(d) if i not in removed]
        if not keep:
            raise ValueError("SanityChecker would remove ALL feature columns "
                             "— loosen thresholds")
        names = (vm.column_names() if vm is not None
                 else [f"c{i}" for i in range(d)])
        summary = SanityCheckerSummary(
            stats=ColumnStatistics(
                names=names, count=stats["count"].tolist(),
                mean=stats["mean"].tolist(),
                variance=stats["variance"].tolist(),
                min=stats["min"].tolist(), max=stats["max"].tolist()),
            categorical=CategoricalGroupStats(
                cramers_v=group_cramers, mutual_info=group_mi,
                pointwise_mutual_info=group_pmi),
            correlations_with_label=[None if np.isnan(c) else float(c)
                                     for c in corr],
            correlation_type=("spearman" if self.correlation_type_spearman
                              else "pearson"),
            dropped=[names[i] for i in to_remove],
            reasons={names[i]: why for i, why in reasons.items()},
            sample_size=n_sample,
            feature_correlations=host.get("feature_corr"))
        model = SanityCheckerModel(keep_indices=keep, summary=summary)
        model.summary_metadata = summary.to_json()
        return self._finalize_model(model)


class SanityCheckerModel(AllowLabelAsInput, Transformer):
    """Index-keep filter: inputs are (label, feature vector); the output is
    the vector's ``keep_indices`` slots."""

    output_type = OPVector

    def __init__(self, keep_indices: List[int],
                 summary: SanityCheckerSummary, uid: Optional[str] = None):
        super().__init__("sanityCheck", uid)
        self.keep_indices = list(keep_indices)
        self.summary = summary

    def transform_column(self, table: FeatureTable) -> Column:
        _, vec_f = self.input_features
        col = table[vec_f.name]
        vals = col.values
        keep = self.device_constant("keep", self.keep_indices, torch.long,
                                    vals.device)
        vm: Optional[VectorMetadata] = col.metadata.get("vector_meta")
        meta: Dict[str, Any] = {}
        if vm is not None:
            meta["vector_meta"] = VectorMetadata(
                self.get_output().name, vm.select(self.keep_indices).columns)
        return Column(OPVector, vals.index_select(1, keep), None, meta)

    def summary_pretty(self) -> str:
        """The JAX package's text summary of the check."""
        s = self.summary
        lines = [f"-- SanityChecker ({self.uid}) --",
                 f"sample size: {s.sample_size}",
                 f"columns kept: {len(self.keep_indices)} / "
                 f"{len(s.stats.names)}"]
        if s.dropped:
            lines.append("dropped:")
            for name in s.dropped:
                lines.append(f"  {name}: " + "; ".join(s.reasons[name]))
        return "\n".join(lines)
