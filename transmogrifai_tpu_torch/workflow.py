"""Workflows (counterpart of ``transmogrifai_tpu.workflow``): ``OpWorkflow``
trains a feature DAG on a device and returns an ``OpWorkflowModel``, the
fitted workflow that scores on that device (a model also comes from
``persistence.load_model``).

Training is the in-core path: the raw table is built by a reader
(``readers``: a CSV file, or a mapping of columns or list of records given
to ``set_input_dataset``), by the JAX package's rules for each feature type,
screened by the raw feature filter when one is attached
(``with_raw_feature_filter``: the excluded raw features leave the DAG),
moved to the device, and every estimator fits layer by layer, or, with
``with_workflow_cv``, the label-dependent stages refit inside every fold of
the selector's cross-validation. The JAX package's stage checkpoints,
sweep checkpoints and resume, mesh sharding and streaming are not ported
(see ROADMAP.md).

A fitted model saves and loads in the JAX package's format
(``OpWorkflowModel.save`` / ``load``, ``persistence``). ``summary()`` gives
each stage's summary; the JAX package's ``faults``, ``resume``,
``observability`` and ``streaming`` sections wait for the robustness,
observability and streaming modules.
"""
from __future__ import annotations

import copy
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .dag import apply_transformations_dag, compute_dag, fit_and_transform_dag
from .device import resolve_device, synced_clock
from .features import Feature
from .readers.readers import Frame, FrameReader, Reader, frame_to_table
from .stages.base import AllowLabelAsInput, Estimator
from .table import FeatureTable


def raw_table(raw_features, data, require_response: bool) -> FeatureTable:
    """A host table of ``raw_features`` from a mapping of columns (numpy
    arrays or python sequences, NaN or None missing) or a list of records,
    by the readers' rules; response columns only when
    ``require_response``."""
    return frame_to_table(Frame.of(data), raw_features,
                          require_response=require_response)


class OpWorkflow:
    """A feature DAG to train: ``OpWorkflow().set_input_dataset(data)
    .set_result_features(pred).train()`` fits every stage on ``device``
    (default: the CUDA device; raises when there is none)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.result_features: Tuple[Feature, ...] = ()
        self.raw_features: Tuple[Feature, ...] = ()
        self.reader: Optional[Reader] = None
        self._layers = None
        self._raw_feature_filter = None
        self._workflow_cv = False
        #: {phase: seconds} of the last train: "filter", "fit" or, under
        #: workflow CV, "before", "fold_prep", "sweep" and "rest"
        self.phase_seconds: Dict[str, float] = {}

    def with_raw_feature_filter(self, rff) -> "OpWorkflow":
        """Screen the raw features with ``rff`` (a
        ``filters.RawFeatureFilter``) before fitting; the features it
        excludes leave the DAG (``_apply_blacklist``)."""
        self._raw_feature_filter = rff
        return self

    def with_workflow_cv(self) -> "OpWorkflow":
        """Workflow-level cross-validation: the label-dependent stages
        that feed the selector (the SanityChecker) refit inside every fold
        on that fold's training rows, instead of once before the sweep."""
        self._workflow_cv = True
        return self

    def set_reader(self, reader: Reader) -> "OpWorkflow":
        """The training data's reader (``readers.DataReaders``)."""
        self.reader = reader
        return self

    def set_input_dataset(self, data, key_field: Optional[str] = None
                          ) -> "OpWorkflow":
        """The training data in memory: a mapping of field name to column
        values, or a list of records."""
        self.reader = FrameReader(data, key_field=key_field)
        return self

    @property
    def stages(self) -> List[Any]:
        return [s for layer in (self._layers or []) for s, _ in layer]

    def set_result_features(self, *features: Feature) -> "OpWorkflow":
        """The features to produce; the stage DAG is their lineage."""
        if not features:
            raise ValueError("result features cannot be empty")
        self.result_features = tuple(features)
        raw: Dict[str, Feature] = {}
        for f in features:
            for r in f.raw_features():
                raw[r.uid] = r
        self.raw_features = tuple(sorted(raw.values(), key=lambda f: f.name))
        self._layers = compute_dag(self.result_features)
        return self

    def train(self) -> "OpWorkflowModel":
        """Fit the DAG on the device; returns the fitted model."""
        if not self.result_features:
            raise ValueError("call set_result_features before train")
        if self.reader is None:
            raise ValueError("no data: call set_reader or "
                             "set_input_dataset first")
        self.phase_seconds = {}
        table = self.reader.generate_table(self.raw_features)
        layers, result_features = self._layers, self.result_features
        blacklisted: Tuple[Feature, ...] = ()
        rff_results = None
        if self._raw_feature_filter is not None:
            t0 = synced_clock(self.device)
            rff = self._raw_feature_filter
            rff.device = self.device
            table, blacklist, rff_results = rff.filter_raw(table,
                                                           self.raw_features)
            if blacklist:
                result_features, layers = self._apply_blacklist(blacklist)
                blacklisted = tuple(blacklist)
            self.phase_seconds["filter"] = synced_clock(self.device) - t0
        table = table.to_device(self.device)
        if self._workflow_cv:
            table, fitted = self._fit_with_workflow_cv(table, layers)
        else:
            t0 = synced_clock(self.device)
            table, fitted = fit_and_transform_dag(table, layers)
            self.phase_seconds["fit"] = synced_clock(self.device) - t0
        model = OpWorkflowModel(self.device)
        model.reader = self.reader
        model.result_features = tuple(
            f.copy_with_new_stages(fitted) for f in result_features)
        model.raw_features = self.raw_features
        model.blacklisted_features = blacklisted
        model.rff_results = rff_results
        model.train_table = table
        model._layers = compute_dag(model.result_features)
        return model

    def _fit_with_workflow_cv(self, table: FeatureTable, layers):
        """Fit the label-independent stages once; run the selector's
        ``find_best_estimator`` with fold copies of the label-dependent
        stages that feed it; then fit the rest (those stages on all rows,
        and the selector, which refits the winner it recorded)."""
        from .impl.selector.model_selector import ModelSelector

        all_stages = [s for layer in layers for s, _ in layer]
        selectors = [s for s in all_stages if isinstance(s, ModelSelector)]
        if len(selectors) != 1:
            raise ValueError(
                f"workflow-level CV requires exactly one ModelSelector, "
                f"found {len(selectors)} (reference FitStagesUtil.cutDAG:313)")
        sel = selectors[0]
        _, vec_f = sel.input_features

        # a feature is label-dependent when its stage is an estimator that
        # reads the label (AllowLabelAsInput) or the selector, or when any
        # parent is; those stages and everything after them fit last
        tainted: Dict[str, bool] = {}
        ordered: List[Feature] = []
        for rf in self.result_features:
            for feat in rf.all_features():      # parents first
                if feat.uid in tainted:
                    continue
                ordered.append(feat)
                st = feat.origin_stage
                own = ((isinstance(st, Estimator)
                        and isinstance(st, AllowLabelAsInput))
                       or st is sel)
                tainted[feat.uid] = own or any(tainted.get(p.uid, False)
                                               for p in feat.parents)
        tainted_stages = {f.origin_stage.uid for f in ordered
                          if tainted[f.uid] and not f.is_raw}

        t0 = synced_clock(self.device)
        before = [[(s, d) for s, d in layer if s.uid not in tainted_stages]
                  for layer in layers]
        table1, fitted_before = fit_and_transform_dag(table, before)
        self.phase_seconds["before"] = synced_clock(self.device) - t0
        # the stages refit in every fold: label-dependent ones on the
        # selector's input ancestry, the selector excluded
        vec_anc = {f.origin_stage.uid for f in vec_f.all_features()
                   if not f.is_raw}
        during = [[(s, d) for s, d in layer
                   if s.uid in tainted_stages and s.uid in vec_anc
                   and s is not sel] for layer in layers]
        rest = [[(s, d) for s, d in layer if s.uid in tainted_stages]
                for layer in layers]
        try:
            sel.find_best_estimator(table1, [l for l in during if l])
            self.phase_seconds.update(sel.phase_seconds)
            t0 = synced_clock(self.device)
            table2, fitted_rest = fit_and_transform_dag(
                table1, [l for l in rest if l])
            self.phase_seconds["rest"] = synced_clock(self.device) - t0
        except Exception:
            # no recorded winner outlives a failed run
            sel._preset_best = None
            raise
        return table2, {**fitted_before, **fitted_rest}

    def _apply_blacklist(self, blacklist: Sequence[Feature]):
        """The result features and layers without the excluded raw
        features: a stage that loses every input goes, a stage that loses
        some is copied with the rest (its output keeps its name and uid)."""
        gone = {f.uid for f in blacklist}
        cache: Dict[str, Optional[Feature]] = {}

        def rebuild(f: Feature) -> Optional[Feature]:
            if f.uid in cache:
                return cache[f.uid]
            if f.is_raw:
                cache[f.uid] = None if f.uid in gone else f
                return cache[f.uid]
            kept = [np_ for np_ in (rebuild(p) for p in f.parents)
                    if np_ is not None]
            if not kept:
                cache[f.uid] = None
                return None
            stage = f.origin_stage
            if len(kept) != len(f.parents):
                stage = copy.copy(stage)
                stage.input_features = tuple(kept)
                stage._output_feature = None
                out = stage.get_output()
                out.name, out.uid = f.name, f.uid
                stage._output_feature = out
            else:
                stage.input_features = tuple(kept)
                out = Feature(f.name, f.feature_type, f.is_response, stage,
                              kept, uid=f.uid)
                stage._output_feature = out
            cache[f.uid] = out
            return out

        new_results = []
        for f in self.result_features:
            nf = rebuild(f)
            if nf is None:
                raise ValueError(f"result feature '{f.name}' lost all inputs "
                                 f"to the raw feature filter")
            new_results.append(nf)
        return tuple(new_results), compute_dag(new_results)


class OpWorkflowModel:
    """Fitted workflow: raw features in, result features out, every stage
    on ``device``."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.result_features: Tuple[Feature, ...] = ()
        self.raw_features: Tuple[Feature, ...] = ()
        self.blacklisted_features: Tuple[Feature, ...] = ()
        #: the raw feature filter's ``RawFeatureFilterResults``, if any
        self.rff_results = None
        #: the transformed training table (a trained model only)
        self.train_table: Optional[FeatureTable] = None
        self.parameters: Dict[str, Any] = {}
        self.reader: Optional[Reader] = None
        self._layers = None

    @property
    def stages(self) -> List[Any]:
        return [s for layer in (self._layers or []) for s, _ in layer]

    def get_stage(self, uid: str) -> Any:
        for s in self.stages:
            if s.uid == uid:
                return s
        raise KeyError(uid)

    def raw_table(self, data) -> FeatureTable:
        """A host table of the raw predictors from a mapping of columns or
        a list of records (``raw_table``). Response columns are not
        needed."""
        return raw_table(self.raw_features, data, require_response=False)

    def save(self, path: str) -> None:
        """Save to the directory ``path`` in the JAX package's format
        (``persistence.save_model``)."""
        from .persistence import save_model
        save_model(self, path)

    @staticmethod
    def load(path: str, device=None, workflow: Optional["OpWorkflow"] = None
             ) -> "OpWorkflowModel":
        """A saved model on ``device`` (``persistence.load_model``)."""
        from .persistence import load_model
        return load_model(path, device=device, workflow=workflow)

    def summary(self) -> Dict[str, Any]:
        """{stage uid: its summary metadata} of every fitted stage that
        has one, as the JAX package's per-stage sections."""
        return {s.uid: s.summary_metadata for s in self.stages
                if getattr(s, "summary_metadata", None)}

    def summary_json(self) -> str:
        return json.dumps(self.summary(), indent=2, default=_json_default)

    def summary_pretty(self) -> str:
        """Each fitted stage's text summary (the SanityChecker's and the
        ModelSelector's), as the JAX package prints it."""
        lines: List[str] = ["Workflow summary:"]
        for stage in self.stages:
            pretty = getattr(stage, "summary_pretty", None)
            if callable(pretty):
                lines.append(pretty())
            elif getattr(stage, "summary_metadata", None):
                lines.append(f"-- {type(stage).__name__} ({stage.uid})")
        return "\n".join(lines)

    def model_insights(self, feature=None):
        """The model's report (``insights.ModelInsights``); ``feature`` is
        accepted as in the JAX package and not used."""
        from .insights import ModelInsights
        return ModelInsights.extract(self)

    def score(self, table: Optional[FeatureTable] = None, data=None,
              reader: Optional[Reader] = None) -> FeatureTable:
        """Score a raw table, in-memory data (``raw_table``) or a reader's
        data on the model's device (with none of them: the reader the model
        was trained with): the raw, intermediate and result columns, as
        tensors on that device; a reader's key is the table's ``key``."""
        if sum(x is not None for x in (table, data, reader)) > 1:
            raise ValueError("pass at most one of table=, data= or reader=")
        if data is not None:
            table = self.raw_table(data)
        elif table is None:
            reader = reader or self.reader
            if reader is None:
                raise ValueError("no data: pass table=, data= or reader=")
            table = reader.generate_table(self.raw_features,
                                          require_response=False)
        return apply_transformations_dag(table.to_device(self.device),
                                         self._layers)

    def score_function(self):
        """Row-at-a-time scorer: ``fn(row) -> {result name: value}``."""
        from .local.scoring import score_function
        return score_function(self)


def _json_default(o):
    """JSON of the values a summary may hold beyond JSON's own."""
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    if hasattr(o, "to_json"):
        return o.to_json()
    if hasattr(o, "__dict__"):
        return {k: v for k, v in vars(o).items() if not k.startswith("_")}
    return str(o)
