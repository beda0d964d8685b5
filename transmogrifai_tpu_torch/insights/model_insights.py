"""ModelInsights (counterpart of
``transmogrifai_tpu.insights.model_insights``): the report of a trained
model, assembled from its fitted stages on the host: the label's summary,
each derived column's statistics and drop decision (the SanityChecker's)
and its contribution to the winner, attributed to its raw feature; the
selection and its sweep; the redundant column pairs; the splitter's
decisions; the raw feature filter's blacklist and results; the version.
Record-level insights (LOCO) are not ported (ROADMAP.md).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass
class DerivedColumnInsights:
    """One vector-slot's insight row (reference Insights per derived feature)."""
    name: str
    parent_feature: str
    grouping: Optional[str] = None
    indicator_value: Optional[str] = None
    correlation: Optional[float] = None
    cramers_v: Optional[float] = None
    mutual_info: Optional[float] = None
    variance: Optional[float] = None
    mean: Optional[float] = None
    min: Optional[float] = None
    max: Optional[float] = None
    contribution: Optional[float] = None
    dropped: bool = False
    drop_reasons: List[str] = field(default_factory=list)


@dataclass
class FeatureInsights:
    """All derived columns of one raw feature (reference FeatureInsights)."""
    feature_name: str
    feature_type: str
    derived: List[DerivedColumnInsights] = field(default_factory=list)

    @property
    def max_abs_contribution(self) -> float:
        vals = [abs(d.contribution) for d in self.derived
                if d.contribution is not None]
        return max(vals) if vals else 0.0


@dataclass
class LabelSummary:
    name: str
    is_classification: bool
    sample_size: int = 0
    distribution: Optional[Dict[str, float]] = None  # classification counts
    mean: Optional[float] = None
    variance: Optional[float] = None


@dataclass
class ModelInsights:
    """The report (reference ModelInsights.scala)."""
    label: LabelSummary
    features: List[FeatureInsights]
    selected_model: Optional[Dict[str, Any]]
    model_validation_results: List[Dict[str, Any]]
    blacklisted_features: List[str]
    raw_feature_filter_results: Optional[Dict[str, Any]]
    version_info: Dict[str, str]
    #: cross-feature redundancy: column pairs whose |corr| exceeds the
    #: redundancy threshold, from the SanityChecker's full (d, d) matrix
    #: (``correlations="full"``; reference SanityChecker.scala:634-638
    #: computes the same matrix — empty under the label-only default)
    cross_feature_redundancy: List[Dict[str, Any]] = field(
        default_factory=list)
    #: per categorical group: the (feature value × label) pointwise mutual
    #: information table (reference OpStatistics.contingencyStats PMI)
    categorical_pmi: Dict[str, List[List[float]]] = field(
        default_factory=dict)
    #: DataSplitter/DataBalancer/DataCutter decisions recorded at fit time
    #: (reference ModelSelectorSummary splitter metadata)
    splitter_summary: Dict[str, Any] = field(default_factory=dict)

    #: |correlation| above which a kept column pair is reported redundant
    REDUNDANCY_THRESHOLD = 0.9
    #: cap on reported redundancy pairs (sorted by |corr| descending)
    REDUNDANCY_TOP_K = 50

    # -- extraction (reference extractFromStages :436) -----------------------
    @staticmethod
    def extract(model) -> "ModelInsights":
        """The report of a trained (or loaded) ``OpWorkflowModel``."""
        from ..impl.preparators.sanity_checker import SanityCheckerModel
        from ..impl.selector.model_selector import SelectedModel
        from ..utils.version import version_info

        checker: Optional[SanityCheckerModel] = None
        selected: Optional[SelectedModel] = None
        for st in model.stages:
            if isinstance(st, SanityCheckerModel) and checker is None:
                checker = st
            if isinstance(st, SelectedModel) and selected is None:
                selected = st

        label = ModelInsights._label_summary(model, selected)
        features = ModelInsights._feature_insights(model, checker, selected)
        sel_json: Optional[Dict[str, Any]] = None
        val_results: List[Dict[str, Any]] = []
        if selected is not None:
            s = selected.summary
            sel_json = {
                "bestModelType": s.best_model_type,
                "bestHyperparameters": s.best_hyper,
                "validationType": s.validation_type,
                "validationMetric": s.validation_metric,
                "bestMetricValue": s.best_metric_value,
                "trainEvaluation": getattr(s, "train_evaluation", {}),
                "holdoutEvaluation": getattr(s, "holdout_evaluation", {}),
                "problem": s.problem,
            }
            for r in s.validation_results:
                val_results.append({
                    "modelType": r.family,
                    "numConfigurations": len(r.grid),
                    "meanMetrics": [float(v) for v in np.asarray(r.mean_metrics)],
                    "grid": r.grid,
                })
        rff = getattr(model, "rff_results", None)
        redundancy: List[Dict[str, Any]] = []
        pmi: Dict[str, Any] = {}
        splitter_summary: Dict[str, Any] = {}
        if checker is not None:
            s = checker.summary
            redundancy = ModelInsights._redundancy_pairs(s)
            pmi = dict(s.categorical.pointwise_mutual_info or {})
        if selected is not None:
            splitter_summary = dict(
                getattr(selected.summary, "splitter_summary", {}) or {})
            if sel_json is not None:
                sel_json["splitterSummary"] = splitter_summary
        return ModelInsights(
            label=label,
            features=features,
            selected_model=sel_json,
            model_validation_results=val_results,
            blacklisted_features=[f.name for f in model.blacklisted_features],
            raw_feature_filter_results=rff.to_json() if rff is not None else None,
            version_info=version_info(),
            cross_feature_redundancy=redundancy,
            categorical_pmi=pmi,
            splitter_summary=splitter_summary,
        )

    @staticmethod
    def _redundancy_pairs(summary) -> List[Dict[str, Any]]:
        """Kept-column pairs with |corr| ≥ REDUNDANCY_THRESHOLD from the
        checker's full feature-feature matrix (None under the label-only
        correlation default)."""
        fc = summary._corr_json()
        if fc is None:
            return []
        names: List[str] = list(summary.stats.names)
        C = np.asarray(fc, dtype=np.float64)
        if C.ndim != 2 or C.shape[0] != C.shape[1]:
            return []
        thr = ModelInsights.REDUNDANCY_THRESHOLD
        iu, ju = np.triu_indices(C.shape[0], k=1)
        with np.errstate(invalid="ignore"):
            vals = C[iu, ju]
        hit = np.nonzero(np.abs(np.nan_to_num(vals)) >= thr)[0]
        order = hit[np.argsort(-np.abs(vals[hit]))]
        out = []
        for k in order[:ModelInsights.REDUNDANCY_TOP_K]:
            i, j = int(iu[k]), int(ju[k])
            out.append({
                "feature1": names[i] if i < len(names) else f"c{i}",
                "feature2": names[j] if j < len(names) else f"c{j}",
                "correlation": round(float(vals[k]), 6),
            })
        return out

    @staticmethod
    def _label_summary(model, selected) -> LabelSummary:
        label_f = next((f for f in model.raw_features if f.is_response), None)
        name = label_f.name if label_f is not None else "label"
        is_cls = True
        if selected is not None:
            is_cls = selected.summary.problem in ("binary", "multiclass")
        table = getattr(model, "train_table", None)
        if table is None or label_f is None or name not in table.column_names:
            return LabelSummary(name=name, is_classification=is_cls)
        y = np.asarray(table[name].host_values(), np.float64).reshape(-1)
        if is_cls:
            vals, counts = np.unique(y, return_counts=True)
            dist = {str(v): int(c) for v, c in zip(vals.tolist(), counts.tolist())}
            return LabelSummary(name=name, is_classification=True,
                                sample_size=int(y.size), distribution=dist)
        return LabelSummary(name=name, is_classification=False,
                            sample_size=int(y.size), mean=float(y.mean()),
                            variance=float(y.var()))

    @staticmethod
    def _feature_insights(model, checker, selected) -> List[FeatureInsights]:
        per_raw: Dict[str, FeatureInsights] = {}
        raw_types = {f.name: f.type_name for f in model.raw_features}
        if checker is None:
            return []
        s = checker.summary
        st = s.stats
        names: List[str] = st.names
        corr = s.correlations_with_label
        dropped = set(s.dropped)
        reasons: Dict[str, List[str]] = s.reasons
        cramers: Dict[str, float] = s.categorical.cramers_v
        mutual: Dict[str, float] = s.categorical.mutual_info or {}

        # column → raw-feature attribution via the vector-slot name prefix
        # (vector metadata column names start with the parent feature name)
        contributions = ModelInsights._contributions(checker, selected, names)

        for i, name in enumerate(names):
            parent = name.split("_", 1)[0]
            d = DerivedColumnInsights(
                name=name, parent_feature=parent,
                correlation=(None if corr[i] is None else float(corr[i])),
                variance=float(st.variance[i]),
                mean=float(st.mean[i]),
                min=float(st.min[i]),
                max=float(st.max[i]),
                contribution=contributions.get(name),
                dropped=name in dropped,
                drop_reasons=list(reasons.get(name, [])),
            )
            for group, v in cramers.items():
                gname = group.split("::")[0]
                if parent == gname:
                    d.cramers_v = float(v)
                    if group in mutual:
                        d.mutual_info = float(mutual[group])
                    break
            fi = per_raw.setdefault(parent, FeatureInsights(
                feature_name=parent,
                feature_type=raw_types.get(parent, "unknown")))
            fi.derived.append(d)
        return sorted(per_raw.values(),
                      key=lambda f: -f.max_abs_contribution)

    @staticmethod
    def _contributions(checker, selected, names: List[str]) -> Dict[str, float]:
        """Per-column model contribution: |coefficient| for linear families,
        split-gain importances for trees (reference contribution extraction
        from the winning model)."""
        if selected is None:
            return {}
        kept = checker.keep_indices if checker is not None else range(len(names))
        kept_names = [names[i] for i in kept]
        from ..models.api import MODEL_REGISTRY
        fitted = selected.fitted
        family = MODEL_REGISTRY.get(fitted.family)
        imp = None if family is None else family.feature_importances(fitted)
        if imp is None:
            return {}
        vals = np.asarray(imp).reshape(-1)
        if vals.size < len(kept_names):
            # tree split-frequency vectors stop at the highest used feature
            vals = np.pad(vals, (0, len(kept_names) - vals.size))
        elif vals.size > len(kept_names):
            return {}
        return {n: float(v) for n, v in zip(kept_names, vals)}

    # -- rendering (reference prettyPrint :99) -------------------------------
    def to_json(self) -> Dict[str, Any]:
        def enc(o):
            if isinstance(o, (DerivedColumnInsights, FeatureInsights,
                              LabelSummary)):
                return {k: enc(v) for k, v in vars(o).items()}
            if isinstance(o, list):
                return [enc(x) for x in o]
            if isinstance(o, dict):
                return {k: enc(v) for k, v in o.items()}
            if isinstance(o, (np.floating, np.integer)):
                return o.item()
            if isinstance(o, float) and not np.isfinite(o):
                return None
            return o
        return {
            "label": enc(self.label),
            "features": enc(self.features),
            "selectedModel": enc(self.selected_model),
            "modelValidationResults": enc(self.model_validation_results),
            "blacklistedFeatures": self.blacklisted_features,
            "rawFeatureFilterResults": enc(self.raw_feature_filter_results),
            "versionInfo": self.version_info,
            "crossFeatureRedundancy": enc(self.cross_feature_redundancy),
            "categoricalPointwiseMutualInfo": enc(self.categorical_pmi),
            "splitterSummary": enc(self.splitter_summary),
        }

    def to_json_string(self) -> str:
        return json.dumps(self.to_json(), indent=2)

    def pretty_print(self, top_k: int = 15) -> str:
        lines: List[str] = ["=" * 60, "Model Insights", "=" * 60]
        l = self.label
        lines.append(f"Label: {l.name} "
                     f"({'classification' if l.is_classification else 'regression'}, "
                     f"n={l.sample_size})")
        if l.distribution:
            lines.append(f"  distribution: {l.distribution}")
        if self.selected_model:
            sm = self.selected_model
            lines.append(f"Best model: {sm['bestModelType']} "
                         f"({sm['validationMetric']}="
                         f"{sm['bestMetricValue']:.4f})")
            lines.append(f"  hyperparameters: {sm['bestHyperparameters']}")
            if sm.get("holdoutEvaluation"):
                show = {k: round(v, 4) for k, v in sm["holdoutEvaluation"].items()
                        if isinstance(v, (int, float))}
                lines.append(f"  holdout: {show}")
        rows = []
        for fi in self.features:
            for d in fi.derived:
                rows.append(d)
        rows.sort(key=lambda d: -(abs(d.contribution)
                                  if d.contribution is not None else -1))
        from ..utils.table_format import format_table
        table_rows = [
            [(f"{d.contribution:+.4f}" if d.contribution is not None
              else "n/a"),
             (f"{d.correlation:+.3f}" if d.correlation is not None
              else "n/a"),
             d.name + (" [DROPPED]" if d.dropped else "")]
            for d in rows[:top_k]]
        lines.append(format_table(["contribution", "correlation", "feature"],
                                  table_rows,
                                  title="Top feature contributions"))
        if self.splitter_summary:
            lines.append(f"Splitter: {self.splitter_summary}")
        if self.cross_feature_redundancy:
            lines.append("Redundant column pairs (|corr| >= "
                         f"{self.REDUNDANCY_THRESHOLD}):")
            for p in self.cross_feature_redundancy[:10]:
                lines.append(f"  {p['feature1']} ~ {p['feature2']}: "
                             f"{p['correlation']:+.4f}")
        if self.blacklisted_features:
            lines.append(f"Blacklisted raw features: {self.blacklisted_features}")
        return "\n".join(lines)
