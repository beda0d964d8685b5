"""Load a model that the JAX package saved (counterpart of the load half of
``transmogrifai_tpu.persistence``).

A saved model is a directory: ``plan.json`` (the feature graph and every
stage's state as JSON descriptors), ``arrays.npz`` (the arrays those
descriptors name) and ``MANIFEST.json`` (each file's size and sha256).
Every array is read as numpy and becomes a tensor on the model's device.

The saved descriptors name their classes by the JAX package's module paths.
The port never imports those: each saved name maps through ``CLASSES`` to
the port's own class, and a name without an entry raises. State the JAX
package could not save (a user's lambda: a custom extract function, a
lambda transformer's function) loads as ``Unresolved`` and is taken from
the stage of the same uid in the workflow passed as ``workflow=``, as the
JAX package's ``load_model`` resolves it.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .device import resolve_device
from .features import Feature, FieldExtractor
from .impl.feature.math import AliasTransformer, BinaryMathOp, ScalarOp
from .impl.feature.vectorizers import (
    BinaryVectorizer, HashingVectorizer, OneHotVectorizerModel,
    RealNNVectorizer, RealVectorizerModel, SmartTextVectorizerModel,
    TextTokenizer, VectorsCombiner,
)
from .impl.preparators.sanity_checker import (
    CategoricalGroupStats, ColumnStatistics, SanityCheckerModel,
    SanityCheckerSummary,
)
from .impl.selector.model_selector import ModelSelectorSummary, SelectedModel
from .impl.tuning.validators import ValidationResult
from .manifest import CheckpointManifest
from .models import glm, linear, trees  # noqa: F401  (registers families)
from .models.api import MODEL_REGISTRY, FittedParams
from .stages.base import (
    BinarySequenceTransformer, BinaryTransformer, FeatureGeneratorStage,
    OpPipelineStage, SequenceTransformer, UnaryTransformer,
)
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
        "impl.feature.math:ScalarOp": ScalarOp,
        "impl.feature.math:BinaryMathOp": BinaryMathOp,
        "impl.feature.math:AliasTransformer": AliasTransformer,
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
        "impl.preparators.sanity_checker:SanityCheckerModel":
            SanityCheckerModel,
        "impl.selector.model_selector:SelectedModel": SelectedModel,
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
    }.items()}


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


def _class_of(spec: str) -> type:
    cls = CLASSES.get(spec)
    if cls is None:
        loads = ", ".join(sorted(s.split(":")[1] for s in CLASSES))
        raise ValueError(f"saved class {spec!r} has no counterpart in the "
                         f"PyTorch port yet; it loads {loads}")
    return cls


def _has_unresolved(v: Any, depth: int = 0) -> bool:
    if isinstance(v, Unresolved):
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
        name = d["__family__"]
        if name not in MODEL_REGISTRY:
            raise ValueError(f"model family {name!r} is not ported yet; the "
                             f"port has {sorted(MODEL_REGISTRY)}")
        return MODEL_REGISTRY[name]
    if "__obj__" in d:
        cls = _class_of(d["__obj__"])
        obj = cls.__new__(cls)
        for k, v in d["state"].items():
            # frozen dataclasses refuse setattr
            object.__setattr__(obj, k, _decode(v, arrays))
        return obj
    if "__unresolved__" in d:
        return Unresolved(d["__unresolved__"])
    for kind in ("__class__", "__fn__", "__stage_ref__"):
        if kind in d:
            raise ValueError(f"saved state {kind}={d[kind]!r} cannot be "
                             f"loaded by the PyTorch port")
    raise ValueError(f"cannot decode {d!r}")


def _to_device(v: Any, device: torch.device) -> Any:
    """Every numpy array inside ``v`` -> a tensor on ``device``; a
    model's fitted params go through its family's ``params_from_numpy``."""
    if isinstance(v, np.ndarray):
        return torch.as_tensor(v, device=device)
    if isinstance(v, FittedParams):
        family = MODEL_REGISTRY.get(v.family)
        if family is None:
            raise ValueError(f"model family {v.family!r} is not ported yet; "
                             f"the port has {sorted(MODEL_REGISTRY)}")
        v.params = family.params_from_numpy(v.params, device)
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
        for k, v in list(vars(stage).items()):
            setattr(stage, k, _to_device(v, device))
    feats = features_from_json(plan["features"], stages)
    model = OpWorkflowModel(device)
    model.result_features = tuple(feats[u] for u in plan["resultFeatures"])
    model.raw_features = tuple(feats[u] for u in plan["rawFeatures"])
    model.blacklisted_features = tuple(
        feats[u] for u in plan.get("blacklistedFeatures", []))
    model.parameters = _decode(plan.get("parameters", {}), arrays) or {}
    model._layers = compute_dag(model.result_features)
    return model
