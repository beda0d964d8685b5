"""Save and load a fitted workflow in the JAX package's format
(counterpart of ``transmogrifai_tpu.persistence``).

A saved model is a directory: ``plan.json`` (the feature graph and every
stage's state as JSON descriptors), ``arrays.npz`` (the arrays those
descriptors name) and ``MANIFEST.json`` (each file's size and sha256).
Every array is read as numpy and becomes a tensor on the model's device;
``save_model`` brings every tensor back to numpy. A model saved by either
package loads in the other.

The saved descriptors name their classes by the JAX package's module paths.
The port never imports those: each saved name maps through ``CLASSES`` to
the port's own class, and a name without an entry raises at load; a port
class without an entry raises at save. Each stage is saved with the state
keys the JAX package's stage of that class carries (``_JAX_STATE`` fills
those the port's stages do not hold), less the port's placement
(``_WIRING_ATTRS``). State that cannot be saved (a user's lambda: a custom
extract function, a lambda transformer's function) is written as
``__unresolved__`` and loads as ``Unresolved``; it is then taken from the
stage of the same uid in the workflow passed as ``workflow=``, as the JAX
package's ``load_model`` resolves it. A stage held by another stage
(``RecordInsightsLOCO.model_stage``) is saved as a ``__stage_ref__`` to
its uid and re-linked at load to the loaded stage of that uid.

A save stages the whole directory beside the target (``<path>.<pid>.
<seq>.tmp``) and swaps it in with one atomic exchange of the two
directories (``renameat2(RENAME_EXCHANGE)``), so a save killed at any
point leaves the previous model loadable, plus ``*.tmp`` debris
(``manifest.clean_tmp_debris``). Where the file system cannot exchange,
the target moves aside and the staged directory takes its place: a kill
between those two renames leaves the previous model in the moved-aside
``*.old.tmp`` directory.

Stage checkpoints (``OpWorkflow.with_checkpoint_dir``): each fitted stage
of a train is written as ``<uid>.json`` and ``<uid>.npz`` and committed
through the directory's manifest (``save_stage_checkpoint``), in the JAX
package's format, so a checkpoint directory either package wrote resumes
in the other. ``load_stage_checkpoints`` loads only the stages whose
completion record exists and whose files match their sha256; any other is
reported (``checkpoint_skipped``) and refits.
"""
from __future__ import annotations

import ctypes
import dataclasses
import errno
import io
import itertools
import json
import os
import shutil
import types as _pytypes
import warnings
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from . import aggregators as _agg
from .device import resolve_device
from .features import Feature, FieldExtractor
from .filters.raw_feature_filter import FeatureMetrics, RawFeatureFilterResults
from .impl.feature import bucketizers, dates, geo, maps, scalers, text
from .impl.feature import math as _math
from .impl.feature.vectorizers import (
    BinaryVectorizer, HashingVectorizer, OneHotVectorizerModel,
    RealNNVectorizer, RealVectorizerModel, SmartTextVectorizerModel,
    TextTokenizer, VectorsCombiner,
)
from .impl.preparators.prediction_deindexer import PredictionDeIndexerModel
from .impl.preparators.sanity_checker import (
    CategoricalGroupStats, ColumnStatistics, SanityCheckerModel,
    SanityCheckerSummary,
)
from .impl.selector.model_selector import ModelSelectorSummary, SelectedModel
from .impl.tuning.validators import ValidationResult
from .impl.regression.isotonic import IsotonicCalibratorModel
from .insights.record_insights import RecordInsightsCorr, RecordInsightsLOCO
from .manifest import (
    MANIFEST_FILE, SENTINEL_FILE, CheckpointManifest, atomic_write_bytes,
    clean_tmp_debris,
)
from .models import glm, linear, mlp, trees  # noqa: F401  (registers)
from .models.api import MODEL_REGISTRY, FittedParams, ModelFamily
from .stages.base import (
    BinarySequenceTransformer, BinaryTransformer, FeatureGeneratorStage,
    OpPipelineStage, SequenceTransformer, UnaryTransformer,
)
from .streaming.model import StreamingGBTModel
from .types import feature_type_by_name
from .vector_metadata import VectorColumnMetadata, VectorMetadata

PLAN_FILE = "plan.json"
ARRAYS_FILE = "arrays.npz"
FORMAT_VERSION = 1

_SAVED = "transmogrifai_tpu."

#: saved "module:Class" -> the port's class
CLASSES: Dict[str, type] = {
    _SAVED + spec: cls for spec, cls in {
        "stages.base:FeatureGeneratorStage": FeatureGeneratorStage,
        "stages.base:UnaryTransformer": UnaryTransformer,
        "stages.base:BinaryTransformer": BinaryTransformer,
        "stages.base:SequenceTransformer": SequenceTransformer,
        "stages.base:BinarySequenceTransformer": BinarySequenceTransformer,
        **{f"impl.feature.math:{c.__name__}": c for c in (
            _math.ScalarOp, _math.BinaryMathOp, _math.AliasTransformer,
            _math.FilterMap, _math._NumericUnary,
            _math.SubstringTransformer, _math.ToOccurTransformer,
            _math.TextLenTransformer, _math.TextListNullTransformer,
            _math.DropIndicesByTransformer, _math.JaccardSimilarity,
            _math.NGramSimilarity, _math.OPCollectionTransformer,
            _math.OPListTransformer, _math.OPSetTransformer,
            _math.OPMapTransformer)},
        "impl.feature.vectorizers:RealVectorizerModel": RealVectorizerModel,
        "impl.feature.vectorizers:RealNNVectorizer": RealNNVectorizer,
        "impl.feature.vectorizers:BinaryVectorizer": BinaryVectorizer,
        "impl.feature.vectorizers:OneHotVectorizerModel":
            OneHotVectorizerModel,
        "impl.feature.vectorizers:SmartTextVectorizerModel":
            SmartTextVectorizerModel,
        "impl.feature.vectorizers:TextTokenizer": TextTokenizer,
        "impl.feature.vectorizers:HashingVectorizer": HashingVectorizer,
        "impl.feature.vectorizers:VectorsCombiner": VectorsCombiner,
        **{f"impl.feature.dates:{c.__name__}": c for c in (
            dates.TimePeriodTransformer, dates.TimePeriodListTransformer,
            dates.TimePeriodMapTransformer,
            dates.DateToUnitCircleTransformer,
            dates.DateMapToUnitCircleVectorizer, dates.DateListVectorizer)},
        **{f"impl.feature.geo:{c.__name__}": c for c in (
            geo.GeolocationVectorizerModel,
            geo.GeolocationMapVectorizerModel)},
        **{f"impl.feature.maps:{c.__name__}": c for c in (
            maps.MapVectorizerModel, maps.TextMapPivotVectorizerModel,
            maps.SmartTextMapVectorizerModel, maps.TextMapNullModel)},
        **{f"impl.feature.text:{c.__name__}": c for c in (
            text.OpStringIndexerModel, text.OpIndexToString,
            text.OpIndexToStringNoFilter, text.OpCountVectorizerModel,
            text.OpNGram, text.OpStopWordsRemover, text.OpWord2VecModel,
            text.OpLDAModel, text.LangDetector, text.NameEntityRecognizer,
            text.MimeTypeDetector, text.PhoneNumberParser,
            text.IsValidPhoneDefaultCountry, text.ParsePhoneNumber,
            text.IsValidPhoneNumber, text.ValidEmailTransformer,
            text.EmailToPickList, text.UrlToDomain, text.IsValidUrl,
            text.EmailToPrefix, text.UrlToProtocol,
            text.TextToMultiPickList, text.RegexTokenizer,
            text.IsValidPhoneMap, text.OpIDFModel)},
        **{f"impl.feature.scalers:{c.__name__}": c for c in (
            scalers.ScalerTransformer, scalers.DescalerTransformer,
            scalers.OpScalarStandardScalerModel,
            scalers.FillMissingWithMeanModel)},
        **{f"impl.feature.bucketizers:{c.__name__}": c for c in (
            bucketizers.NumericBucketizer,
            bucketizers.DecisionTreeNumericBucketizerModel,
            bucketizers.DecisionTreeNumericMapBucketizerModel,
            bucketizers.PercentileCalibratorModel)},
        **{f"aggregators:{c.__name__}": c for c in (
            _agg.Sum, _agg.MaxAgg, _agg.MinAgg, _agg.MeanAgg,
            _agg.LogicalOr, _agg.ConcatText, _agg.ModeAgg, _agg.ConcatList,
            _agg.UnionSet, _agg.UnionMap, _agg.LastValue, _agg.FirstValue,
            _agg.GeoMidpoint, _agg.CutOffTime)},
        "insights.record_insights:RecordInsightsLOCO": RecordInsightsLOCO,
        "insights.record_insights:RecordInsightsCorr": RecordInsightsCorr,
        "impl.preparators.prediction_deindexer:PredictionDeIndexerModel":
            PredictionDeIndexerModel,
        "impl.preparators.sanity_checker:SanityCheckerModel":
            SanityCheckerModel,
        "impl.selector.model_selector:SelectedModel": SelectedModel,
        "impl.regression.isotonic:IsotonicCalibratorModel":
            IsotonicCalibratorModel,
        "features:FieldExtractor": FieldExtractor,
        "models.api:FittedParams": FittedParams,
        "impl.selector.model_selector:ModelSelectorSummary":
            ModelSelectorSummary,
        "impl.tuning.validators:ValidationResult": ValidationResult,
        "impl.preparators.sanity_checker_metadata:SanityCheckerSummary":
            SanityCheckerSummary,
        "impl.preparators.sanity_checker_metadata:ColumnStatistics":
            ColumnStatistics,
        "impl.preparators.sanity_checker_metadata:CategoricalGroupStats":
            CategoricalGroupStats,
        "vector_metadata:VectorMetadata": VectorMetadata,
        "vector_metadata:VectorColumnMetadata": VectorColumnMetadata,
        "filters.raw_feature_filter:RawFeatureFilterResults":
            RawFeatureFilterResults,
        "filters.raw_feature_filter:FeatureMetrics": FeatureMetrics,
        "streaming.model:StreamingGBTModel": StreamingGBTModel,
    }.items()}

#: saved "module:function" -> the port's function: stage state that is a
#: module-level function of the JAX package (saved as ``__fn__``)
FUNCTIONS: Dict[str, Any] = {
    _SAVED + "impl.feature.math:jaccard_similarity":
        _math.jaccard_similarity,
}
_FUNCTION_NAMES = {id(fn): spec for spec, fn in FUNCTIONS.items()}

#: the port's class -> the saved "module:Class" name
SAVED_NAMES: Dict[type, str] = {cls: spec for spec, cls in CLASSES.items()}

#: stage attributes rebuilt by the loading context, never saved: the
#: feature wiring and the port's placement (constants cached per device)
_WIRING_ATTRS = ("input_features", "_output_feature", "_device_constants")

#: state keys the JAX package's stages carry and the port's do not, with
#: the values the JAX package saves for them (None: every stage class)
_JAX_STATE: Dict[Optional[str], Dict[str, Any]] = {
    None: {"_params": {}},
    "VectorsCombiner": {"transform_fn": None, "columnar_fn": None},
    "BinaryVectorizer": {"transform_fn": None, "columnar_fn": None},
    "RealNNVectorizer": {"transform_fn": None, "columnar_fn": None},
    "HashingVectorizer": {"transform_fn": None, "columnar_fn": None},
}


class CorruptModelError(RuntimeError):
    """A saved model file failed its integrity check or could not be
    decoded."""

    def __init__(self, path: str, reason: str):
        self.path = path
        self.reason = reason
        super().__init__(f"corrupt model artifact {path!r}: {reason}")


class Unresolved:
    """Saved state that must come from the original workflow."""

    def __init__(self, desc: str):
        self.desc = desc

    def __repr__(self) -> str:
        return f"Unresolved({self.desc!r})"


class _StageRef:
    """A saved reference to the stage of uid ``uid``; ``load_model``
    re-links it to the loaded stage of that uid."""

    def __init__(self, uid: str):
        self.uid = uid

    def __repr__(self) -> str:
        return f"_StageRef({self.uid!r})"


def _class_of(spec: str) -> type:
    cls = CLASSES.get(spec)
    if cls is None:
        loads = ", ".join(sorted(s.split(":")[1] for s in CLASSES))
        raise ValueError(f"saved class {spec!r} has no counterpart in the "
                         f"PyTorch port yet; it loads {loads}")
    return cls


def _has_unresolved(v: Any, depth: int = 0) -> bool:
    if isinstance(v, (Unresolved, _StageRef)):
        return True
    if depth > 8:
        return False
    if isinstance(v, (list, tuple, set)):
        return any(_has_unresolved(x, depth + 1) for x in v)
    if isinstance(v, dict):
        return any(_has_unresolved(x, depth + 1) for x in v.values())
    if hasattr(v, "__dict__") and not isinstance(v, type):
        return any(_has_unresolved(x, depth + 1) for x in vars(v).values())
    return False


def _decode(d: Any, arrays: Dict[str, np.ndarray]) -> Any:
    """A JSON descriptor -> its value (arrays stay numpy here)."""
    if d is None or isinstance(d, (bool, int, float, str)):
        return d
    if isinstance(d, list):
        return [_decode(x, arrays) for x in d]
    if not isinstance(d, dict):
        raise ValueError(f"cannot decode {d!r}")
    if "__float__" in d:
        return float(d["__float__"])
    if "__array__" in d:
        return arrays[d["__array__"]]
    if "__tuple__" in d:
        return tuple(_decode(x, arrays) for x in d["__tuple__"])
    if "__set__" in d:
        return set(_decode(x, arrays) for x in d["__set__"])
    if "__dict__" in d:
        return {k: _decode(x, arrays) for k, x in d["__dict__"].items()}
    if "__kvdict__" in d:
        return {_decode(k, arrays): _decode(x, arrays)
                for k, x in d["__kvdict__"]}
    if "__feature_type__" in d:
        return feature_type_by_name(d["__feature_type__"])
    if "__family__" in d:
        return MODEL_REGISTRY[d["__family__"]]
    if "__obj__" in d:
        cls = _class_of(d["__obj__"])
        obj = cls.__new__(cls)
        for k, v in d["state"].items():
            # frozen dataclasses refuse setattr
            object.__setattr__(obj, k, _decode(v, arrays))
        return obj
    if "__unresolved__" in d:
        return Unresolved(d["__unresolved__"])
    if d.get("__fn__") in FUNCTIONS:
        return FUNCTIONS[d["__fn__"]]
    if isinstance(d.get("__stage_ref__"), str):
        return _StageRef(d["__stage_ref__"])
    for kind in ("__class__", "__fn__"):
        if kind in d:
            raise ValueError(f"saved state {kind}={d[kind]!r} cannot be "
                             f"loaded by the PyTorch port")
    raise ValueError(f"cannot decode {d!r}")


def _relink_stage_refs(v: Any, stages: Dict[str, OpPipelineStage],
                       depth: int = 0) -> Any:
    """``v`` with every ``_StageRef`` inside it (lists, tuples, dicts,
    objects) replaced by the loaded stage of its uid; a uid outside the
    plan stays a ``_StageRef`` and counts as unresolved."""
    if isinstance(v, _StageRef):
        return stages.get(v.uid, v)
    if depth > 8:
        return v
    if isinstance(v, list):
        return [_relink_stage_refs(x, stages, depth + 1) for x in v]
    if isinstance(v, tuple):
        return tuple(_relink_stage_refs(x, stages, depth + 1) for x in v)
    if isinstance(v, dict):
        return {k: _relink_stage_refs(x, stages, depth + 1)
                for k, x in v.items()}
    if (hasattr(v, "__dict__") and not isinstance(v, type)
            and not isinstance(v, OpPipelineStage)):
        for k, x in list(vars(v).items()):
            nx = _relink_stage_refs(x, stages, depth + 1)
            if nx is not x:
                object.__setattr__(v, k, nx)
    return v


def _to_device(v: Any, device: torch.device) -> Any:
    """Every numpy array inside ``v`` -> a tensor on ``device``; a
    model's fitted params go through its family's ``params_from_numpy``."""
    if isinstance(v, np.ndarray):
        return torch.as_tensor(v, device=device)
    if isinstance(v, FittedParams):
        v.params = MODEL_REGISTRY[v.family].params_from_numpy(v.params,
                                                              device)
        return v
    if isinstance(v, list):
        return [_to_device(x, device) for x in v]
    if isinstance(v, tuple):
        return tuple(_to_device(x, device) for x in v)
    if isinstance(v, dict):
        return {k: _to_device(x, device) for k, x in v.items()}
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        for f in dataclasses.fields(v):
            object.__setattr__(v, f.name,
                               _to_device(getattr(v, f.name), device))
    return v


def _stage_to_device(stage: OpPipelineStage, device: torch.device) -> None:
    """A loaded stage's arrays as tensors on ``device``; a stage whose
    state stays on the host (``_host_state``: the streamed GBT's trees)
    keeps its numpy arrays."""
    if getattr(stage, "_host_state", False):
        return
    for k, v in list(vars(stage).items()):
        setattr(stage, k, _to_device(v, device))


def stage_from_json(d: Dict[str, Any],
                    arrays: Dict[str, np.ndarray]) -> OpPipelineStage:
    cls = _class_of(f"{d.get('module')}:{d['className']}")
    stage = cls.__new__(cls)
    stage.input_features = ()
    stage._output_feature = None
    for k, v in d["state"].items():
        setattr(stage, k, _decode(v, arrays))
    return stage


def features_from_json(descs: List[Dict[str, Any]],
                       stages: Dict[str, OpPipelineStage]
                       ) -> Dict[str, Feature]:
    """Rebuild the feature graph (descriptors come in dependency order) and
    wire each stage's inputs and output."""
    feats: Dict[str, Feature] = {}
    for d in descs:
        parents = [feats[p] for p in d["parents"]]
        stage = stages.get(d["originStageUid"])
        f = Feature(d["name"], feature_type_by_name(d["typeName"]),
                    d["isResponse"], stage, parents, uid=d["uid"])
        feats[d["uid"]] = f
        if stage is not None:
            stage.input_features = tuple(parents)
            stage._output_feature = f
    return feats


def _read(path: str):
    """(plan, arrays) of a saved model directory, verified against its
    manifest when it has one."""
    plan_path = os.path.join(path, PLAN_FILE)
    npz_path = os.path.join(path, ARRAYS_FILE)
    manifest, merr = CheckpointManifest.load(path, FORMAT_VERSION)
    if merr not in (None, "missing"):
        raise CorruptModelError(manifest.path, merr)
    if merr is None and os.path.isdir(path) and manifest.files:
        for fname in (PLAN_FILE, ARRAYS_FILE):
            reason = manifest.verify_file(fname)
            if reason is not None:
                raise CorruptModelError(os.path.join(path, fname), reason)
    try:
        with open(plan_path) as fh:
            plan = json.load(fh)
    except ValueError as e:
        raise CorruptModelError(plan_path, f"undecodable JSON: {e}") from e
    if plan.get("formatVersion") != FORMAT_VERSION:
        raise ValueError(
            f"unsupported model format {plan.get('formatVersion')}")
    try:
        with np.load(npz_path, allow_pickle=False) as npz:
            arrays = {k: npz[k] for k in npz.files}
    except (ValueError, OSError, KeyError) as e:
        if not os.path.isfile(npz_path):
            raise
        raise CorruptModelError(
            npz_path, f"undecodable npz: {type(e).__name__}: {e}") from e
    return plan, arrays


def load_model(path: str, device: Optional[Union[str, torch.device]] = None,
               workflow=None):
    """Load a model saved by the JAX package's ``save_model`` onto
    ``device`` (default: the CUDA device; raises when there is none).
    State the JAX package could not save (user lambdas) is taken from the
    stage of the same uid in ``workflow`` (the port's ``OpWorkflow`` of the
    same definitions, built after ``features.reset_uids()`` as the saved
    one was); without it such a model raises."""
    from .dag import compute_dag
    from .workflow import OpWorkflowModel

    device = resolve_device(device)
    plan, arrays = _read(path)
    stages: Dict[str, OpPipelineStage] = {}
    for d in plan["stages"] + plan["rawFeatureGenerators"]:
        if d["uid"] not in stages:
            stages[d["uid"]] = stage_from_json(d, arrays)
    for stage in stages.values():
        for k, v in list(vars(stage).items()):
            nv = _relink_stage_refs(v, stages)
            if nv is not v:
                setattr(stage, k, nv)
    wf_stages: Dict[str, OpPipelineStage] = {}
    if workflow is not None:
        wf_stages.update((s.uid, s) for s in workflow.stages)
        wf_stages.update((f.origin_stage.uid, f.origin_stage)
                         for f in workflow.raw_features)
    for uid, stage in stages.items():
        missing = [k for k, v in vars(stage).items() if _has_unresolved(v)]
        if not missing:
            continue
        src = wf_stages.get(uid)
        if src is None:
            raise ValueError(
                f"stage {uid} has unserializable state {missing}; pass the "
                f"original workflow to load_model to resolve it")
        for k in missing:
            setattr(stage, k, getattr(src, k))
    for stage in stages.values():
        _stage_to_device(stage, device)
    feats = features_from_json(plan["features"], stages)
    model = OpWorkflowModel(device)
    model.result_features = tuple(feats[u] for u in plan["resultFeatures"])
    model.raw_features = tuple(feats[u] for u in plan["rawFeatures"])
    model.blacklisted_features = tuple(
        feats[u] for u in plan.get("blacklistedFeatures", []))
    model.parameters = _decode(plan.get("parameters", {}), arrays) or {}
    model.rff_results = _decode(plan.get("rffResults"), arrays)
    model._layers = compute_dag(model.result_features)
    return model


# ---------------------------------------------------------------------------
# Save
# ---------------------------------------------------------------------------

class _Arrays:
    """The npz store being written: arrays named a0, a1, ... in the order
    the plan meets them."""

    def __init__(self):
        self.store: Dict[str, np.ndarray] = {}

    def add(self, arr: np.ndarray) -> str:
        key = f"a{len(self.store)}"
        self.store[key] = np.asarray(arr)
        return key


def _saved_name(cls: type) -> str:
    spec = SAVED_NAMES.get(cls)
    if spec is None:
        raise ValueError(f"{cls.__module__}.{cls.__qualname__} has no "
                         f"counterpart in the JAX package's format "
                         f"(persistence.CLASSES); it cannot be saved")
    return spec


def _encode(v: Any, arrays: _Arrays) -> Any:
    """A value -> its JSON descriptor, as the JAX package's ``_encode``
    writes it; tensors and arrays go to the npz store, functions are
    ``__unresolved__``."""
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, float):
        return v if np.isfinite(v) else {"__float__": repr(v)}
    if isinstance(v, (np.floating, np.integer, np.bool_)):
        return _encode(v.item(), arrays)
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        return {"__array__": arrays.add(v)}
    if isinstance(v, tuple):
        return {"__tuple__": [_encode(x, arrays) for x in v]}
    if isinstance(v, list):
        return [_encode(x, arrays) for x in v]
    if isinstance(v, (set, frozenset)):
        return {"__set__": [_encode(x, arrays)
                            for x in sorted(v, key=repr)]}
    if isinstance(v, dict):
        if all(isinstance(k, str) for k in v):
            return {"__dict__": {k: _encode(x, arrays)
                                 for k, x in v.items()}}
        return {"__kvdict__": [[_encode(k, arrays), _encode(x, arrays)]
                               for k, x in v.items()]}
    if isinstance(v, type):
        from .types import FeatureType
        if issubclass(v, FeatureType):
            return {"__feature_type__": v.__name__}
        raise ValueError(f"cannot save the class {v.__qualname__}")
    if isinstance(v, ModelFamily):
        return {"__family__": v.name}
    if isinstance(v, FittedParams):
        v = dataclasses.replace(
            v, params=MODEL_REGISTRY[v.family].params_to_numpy(v.params))
    if dataclasses.is_dataclass(v):
        return {"__obj__": _saved_name(type(v)),
                "state": {f.name: _encode(getattr(v, f.name), arrays)
                          for f in dataclasses.fields(v)}}
    if id(v) in _FUNCTION_NAMES:
        return {"__fn__": _FUNCTION_NAMES[id(v)]}
    if isinstance(v, (_pytypes.FunctionType, _pytypes.MethodType,
                      _pytypes.BuiltinFunctionType, np.ufunc)):
        return {"__unresolved__": repr(v)}
    if isinstance(v, OpPipelineStage):
        return {"__stage_ref__": v.uid}
    if hasattr(v, "__dict__"):
        return {"__obj__": _saved_name(type(v)),
                "state": {k: _encode(x, arrays) for k, x in vars(v).items()}}
    raise ValueError(f"cannot save a {type(v).__name__}: {v!r}")


def stage_to_json(stage: OpPipelineStage, arrays: _Arrays) -> Dict[str, Any]:
    """A fitted stage's descriptor: the JAX package's class name, module,
    uid and state keys."""
    module, cls_name = _saved_name(type(stage)).split(":")
    state = {k: v for k, v in vars(stage).items() if k not in _WIRING_ATTRS}
    state.setdefault("output_type", stage.output_type)
    for name in (None, cls_name):
        for k, v in _JAX_STATE.get(name, {}).items():
            state.setdefault(k, v)
    return {"className": cls_name, "module": module, "uid": stage.uid,
            "state": {k: _encode(v, arrays) for k, v in state.items()}}


def features_to_json(result_features, extra_features=()
                     ) -> List[Dict[str, Any]]:
    """The feature graph in dependency order: every ancestor of the result
    features, then of ``extra_features`` (raw features outside them)."""
    seen: Dict[str, Feature] = {}
    for f in tuple(result_features) + tuple(extra_features):
        for a in f.all_features():
            seen.setdefault(a.uid, a)
    return [{"uid": f.uid, "name": f.name, "typeName": f.type_name,
             "isResponse": f.is_response,
             "originStageUid": f.origin_stage.uid if f.origin_stage
             else None,
             "parents": [p.uid for p in f.parents]}
            for f in seen.values()]


def _stage_ref_uids(v: Any) -> set:
    """Every ``__stage_ref__`` uid inside an encoded plan fragment."""
    out: set = set()
    if isinstance(v, dict):
        if isinstance(v.get("__stage_ref__"), str):
            out.add(v["__stage_ref__"])
        for x in v.values():
            out |= _stage_ref_uids(x)
    elif isinstance(v, list):
        for x in v:
            out |= _stage_ref_uids(x)
    return out


def _plan_and_arrays(model) -> Dict[str, bytes]:
    """{file name: bytes} of a fitted model's plan.json and arrays.npz."""
    from .utils.version import version_info
    arrays = _Arrays()
    stage_descs = [stage_to_json(s, arrays) for s in model.stages]
    extra = tuple({f.uid: f for f in tuple(model.raw_features) + tuple(
        model.blacklisted_features)}.values())
    raw_descs = [stage_to_json(f.origin_stage, arrays) for f in extra]
    plan = {
        "formatVersion": FORMAT_VERSION,
        "versionInfo": version_info(),
        "features": features_to_json(model.result_features, extra),
        "resultFeatures": [f.uid for f in model.result_features],
        "rawFeatures": [f.uid for f in model.raw_features],
        "blacklistedFeatures": [f.uid for f in model.blacklisted_features],
        "stages": stage_descs,
        "rawFeatureGenerators": raw_descs,
        "parameters": _encode(model.parameters, arrays),
        "rffResults": _encode(getattr(model, "rff_results", None), arrays),
    }
    saved = ({s.uid for s in model.stages}
             | {f.origin_stage.uid for f in extra})
    dangling = sorted(_stage_ref_uids([stage_descs, raw_descs,
                                       plan["parameters"]]) - saved)
    if dangling:
        warnings.warn(
            f"save_model: stage attribute(s) reference uid(s) {dangling} "
            f"that are not among the stages being saved; they will load "
            f"as permanent placeholders. Include those stages in the "
            f"workflow or drop the references before saving.", stacklevel=3)
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays.store)
    return {PLAN_FILE: json.dumps(plan, indent=2).encode("utf-8"),
            ARRAYS_FILE: buf.getvalue()}


_STAGE_SEQ = itertools.count(1)


def _exchange(a: str, b: str) -> bool:
    """Swap two directories in one atomic step (``renameat2`` with
    ``RENAME_EXCHANGE``); False where the system or file system cannot."""
    fn = getattr(ctypes.CDLL(None, use_errno=True), "renameat2", None)
    if fn is None:
        return False
    at_fdcwd, rename_exchange = -100, 2
    if fn(at_fdcwd, os.fsencode(a), at_fdcwd, os.fsencode(b),
          rename_exchange) == 0:
        return True
    err = ctypes.get_errno()
    if err in (errno.EINVAL, errno.ENOSYS, errno.EOPNOTSUPP):
        return False
    raise OSError(err, os.strerror(err), a)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _advisory_sections(model, manifest: CheckpointManifest) -> None:
    """The JAX package's advisory manifest sections: ``serving`` (the
    serve pass's schema fingerprint, which a warm registry load checks;
    ``serving/warmup.py``), ``drift`` (per-feature training sketches
    and fill rates, which a registry load hands to a ``DriftMonitor``;
    ``serving/drift.py``) and ``costs`` (the planned segments' measured
    bytes, which placement reads; ``serving/placement.py``). A model whose extracts cannot take the
    synthetic probe ships no fingerprint, and one without a usable
    training table (a loaded model) no baseline: neither ever fails a
    save."""
    try:
        from .serving.warmup import manifest_serving_entry
        manifest.serving = manifest_serving_entry(model)
    except Exception:
        pass
    try:
        from .serving.drift import manifest_drift_entry
        manifest.drift = manifest_drift_entry(model)
    except Exception:
        pass
    # the process's measured (segment fingerprint x bucket) cost rows
    # (``observability/devicemem``, filled by planned dispatches): what
    # placement and admission read at load
    try:
        from .observability import devicemem as _devicemem
        costs = _devicemem.costs_manifest_entry()
        if costs.get("table"):
            manifest.costs = costs
    except Exception:
        pass


def save_model(model, path: str) -> None:
    """Write the fitted workflow model to the directory ``path`` in the
    JAX package's format: plan.json + arrays.npz + MANIFEST.json with each
    file's sha256. The directory is staged beside ``path`` and swapped in
    whole (module docstring); other files already in ``path`` are carried
    over."""
    path = os.path.abspath(path)
    files = _plan_and_arrays(model)
    stage = f"{path}.{os.getpid()}.{next(_STAGE_SEQ)}.tmp"
    os.makedirs(stage)
    manifest = CheckpointManifest(stage, FORMAT_VERSION)
    for name, data in files.items():
        manifest.record_file(name, atomic_write_bytes(
            os.path.join(stage, name), data), len(data))
    _advisory_sections(model, manifest)
    manifest.save()
    if os.path.isdir(path):
        keep = set(files) | {os.path.basename(manifest.path)}
        for name in os.listdir(path):
            src = os.path.join(path, name)
            if (name not in keep and not name.endswith(".tmp")
                    and os.path.isfile(src)):
                shutil.copy2(src, os.path.join(stage, name))
    _fsync_dir(stage)
    if not os.path.exists(path):
        os.replace(stage, path)
    elif _exchange(stage, path):
        shutil.rmtree(stage, ignore_errors=True)
    else:
        old = f"{stage[:-len('.tmp')]}.old.tmp"
        os.replace(path, old)
        os.replace(stage, path)
        shutil.rmtree(old, ignore_errors=True)
    _fsync_dir(os.path.dirname(path))


# ---------------------------------------------------------------------------
# Stage checkpoints
# ---------------------------------------------------------------------------

def _npz_bytes(store: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **store)
    return buf.getvalue()


def open_checkpoint_manifest(ckpt_dir: str) -> CheckpointManifest:
    """The directory's manifest, or a fresh one when it is absent or
    unreadable (nothing in such a directory is trusted; the load reports
    it, and the new manifest commits from scratch)."""
    manifest, _err = CheckpointManifest.load(ckpt_dir, FORMAT_VERSION)
    return manifest


def save_stage_checkpoint(stage: OpPipelineStage, ckpt_dir: str,
                          manifest: Optional[CheckpointManifest] = None
                          ) -> None:
    """Write one fitted stage as ``<uid>.npz`` and ``<uid>.json``, each
    atomically, then commit it through the directory's manifest. The stage
    becomes loadable only when the manifest, written last, records it: a
    kill at any step leaves files the loader reports as debris and refits.
    The site ``preempt.checkpoint_write`` fires between the payload files
    and the commit."""
    from .manifest import sentinel_phase
    from .robustness import faults
    os.makedirs(ckpt_dir, exist_ok=True)
    sentinel_phase("checkpoint_write")
    if manifest is None:
        manifest = open_checkpoint_manifest(ckpt_dir)
    arrays = _Arrays()
    desc = stage_to_json(stage, arrays)
    npz_name, json_name = f"{stage.uid}.npz", f"{stage.uid}.json"
    npz_bytes = _npz_bytes(arrays.store)
    npz_sha = atomic_write_bytes(os.path.join(ckpt_dir, npz_name), npz_bytes)
    faults.inject("preempt.checkpoint_write", key=stage.uid)
    json_bytes = json.dumps(desc).encode("utf-8")
    json_sha = atomic_write_bytes(os.path.join(ckpt_dir, json_name),
                                  json_bytes)
    manifest.record_file(npz_name, npz_sha, len(npz_bytes))
    manifest.record_file(json_name, json_sha, len(json_bytes))
    manifest.complete_stage(stage.uid, [json_name, npz_name])
    manifest.save()


def _report_skipped(uid: str, ckpt_dir: str, file: str, reason: str) -> None:
    import logging
    from .robustness.policy import FaultLog, FaultReport
    logging.getLogger(__name__).warning(
        "skipping stage checkpoint %s in %s (%s: %s); the stage will refit",
        uid, ckpt_dir, file, reason)
    FaultLog.record(FaultReport(
        site="persistence.checkpoint", kind="checkpoint_skipped",
        detail={"uid": uid, "dir": ckpt_dir, "file": file,
                "reason": reason, "error": reason}))


def _load_stage_files(ckpt_dir: str, uid: str, json_name: str,
                      device: torch.device) -> OpPipelineStage:
    with open(os.path.join(ckpt_dir, json_name)) as fh:
        desc = json.load(fh)
    with np.load(os.path.join(ckpt_dir, f"{uid}.npz"),
                 allow_pickle=False) as npz:
        arrays = dict(npz)
    stage = stage_from_json(desc, arrays)
    _stage_to_device(stage, device)
    return stage


def load_stage_checkpoints(ckpt_dir: str,
                           manifest: Optional[CheckpointManifest] = None,
                           device: Optional[Union[str, torch.device]] = None
                           ) -> Dict[str, OpPipelineStage]:
    """Every verified stage checkpoint of ``ckpt_dir``, by uid, with its
    arrays on ``device`` (default: the CUDA device).

    With a manifest, only stages with a completion record load, and each
    of their files must match its recorded size and sha256; a stage that
    fails is reported as ``checkpoint_skipped`` (the file and the reason)
    and refits, as are payload files no record names. A directory without
    a manifest (the earliest checkpoints) is read file by file, and what
    does not decode is reported the same way."""
    import logging
    device = resolve_device(device)
    out: Dict[str, OpPipelineStage] = {}
    if not os.path.isdir(ckpt_dir):
        return out
    removed = clean_tmp_debris(ckpt_dir)
    if removed:
        logging.getLogger(__name__).info(
            "removed %d partial-write tmp file(s) from %s", len(removed),
            ckpt_dir)
    if manifest is None:
        manifest, merr = CheckpointManifest.load(ckpt_dir, FORMAT_VERSION)
        if merr not in (None, "missing"):
            _report_skipped("*", ckpt_dir, manifest.path,
                            f"manifest unusable ({merr}); no checkpoint in "
                            f"the directory can be verified")
            return out
        if merr == "missing" and any(
                f.endswith(".json")
                and f not in (MANIFEST_FILE, SENTINEL_FILE)
                for f in os.listdir(ckpt_dir)):
            return _load_legacy_checkpoints(ckpt_dir, device)
    for fname in manifest.unrecorded_files():
        uid = fname.rsplit(".", 1)[0]
        _report_skipped(uid, ckpt_dir, os.path.join(ckpt_dir, fname),
                        "file has no manifest completion record "
                        "(interrupted write)")
    for uid, rec in sorted(manifest.stages.items()):
        bad = [(f, manifest.verify_file(f)) for f in rec.get("files", [])]
        bad = [(f, r) for f, r in bad if r is not None]
        if bad:
            f0, r0 = bad[0]
            _report_skipped(uid, ckpt_dir, os.path.join(ckpt_dir, f0), r0)
            continue
        try:
            out[uid] = _load_stage_files(ckpt_dir, uid, f"{uid}.json",
                                         device)
        except Exception as e:
            # verified but undecodable (a format fault, a class that
            # moved): refit rather than fail the resume
            _report_skipped(uid, ckpt_dir,
                            os.path.join(ckpt_dir, f"{uid}.json"),
                            f"verified but undecodable: "
                            f"{type(e).__name__}: {e}")
    return out


def _load_legacy_checkpoints(ckpt_dir: str, device: torch.device
                             ) -> Dict[str, OpPipelineStage]:
    """A directory without a manifest: decode each stage's files or report
    it and let it refit."""
    out: Dict[str, OpPipelineStage] = {}
    for fname in sorted(os.listdir(ckpt_dir)):
        if (not fname.endswith(".json") or fname.startswith("sweep_")
                or fname in (MANIFEST_FILE, SENTINEL_FILE)):
            continue
        uid = fname[:-5]
        try:
            out[uid] = _load_stage_files(ckpt_dir, uid, fname, device)
        except Exception as e:
            _report_skipped(uid, ckpt_dir, os.path.join(ckpt_dir, fname),
                            f"{type(e).__name__}: {e} (unverified legacy "
                            f"checkpoint — no manifest)")
    return out
