"""Transmogrifier (counterpart of
``transmogrifai_tpu.impl.feature.transmogrifier``): group features by type,
apply each group's default vectorizer, and combine the groups' vectors into
one OPVector feature. This slice vectorizes the ``Real`` and ``RealNN``
groups; any other type raises."""
from __future__ import annotations

from typing import Dict, List, Sequence

from ...features import Feature
from ...types import Real, RealNN
from .vectorizers import RealNNVectorizer, RealVectorizer, VectorsCombiner


def transmogrify(features: Sequence[Feature]) -> Feature:
    """Auto-vectorize a feature set into one OPVector feature: groups in
    name order, features by name within a group."""
    if not features:
        raise ValueError("transmogrify needs at least one feature")
    groups: Dict[str, List[Feature]] = {}
    for f in features:
        groups.setdefault(_group_of(f), []).append(f)
    vectorized: List[Feature] = []
    for group in sorted(groups):
        stage = _vectorizer_for(group)
        stage.set_input(*sorted(groups[group], key=lambda f: f.name))
        vectorized.append(stage.get_output())
    if len(vectorized) == 1:
        return vectorized[0]
    return VectorsCombiner().set_input(*vectorized).get_output()


def _group_of(f: Feature) -> str:
    ft = f.feature_type
    if issubclass(ft, RealNN):
        return "realnn"
    if issubclass(ft, Real):
        return "real"
    raise NotImplementedError(
        f"transmogrify has no vectorizer for {ft.__name__} (feature "
        f"'{f.name}') in the PyTorch port yet; it vectorizes Real and RealNN")


def _vectorizer_for(group: str):
    if group == "realnn":
        return RealNNVectorizer()
    if group == "real":
        return RealVectorizer()
    raise AssertionError(group)
