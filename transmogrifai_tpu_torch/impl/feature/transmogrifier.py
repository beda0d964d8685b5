"""Transmogrifier (counterpart of
``transmogrifai_tpu.impl.feature.transmogrifier``): group features by type,
apply each group's default vectorizer, and combine the groups' vectors into
one OPVector feature. The port vectorizes the groups realnn, real,
integral, binary, categorical, multipicklist, text, textlist and vector
as the JAX package does (pick-list-like text pivots, free text goes
through the smart text vectorizer); any other type raises by name."""
from __future__ import annotations

from typing import Dict, List, Sequence

from ...features import Feature
from ...types import (
    URL, Base64, Binary, City, ComboBox, Country, Currency, Email, ID,
    Integral, MultiPickList, OPVector, Percent, Phone, PickList, PostalCode,
    Prediction, Real, RealNN, State, Street, Text, TextArea, TextList,
)
from .vectorizers import (
    BinaryVectorizer, HashingVectorizer, IntegralVectorizer, OneHotVectorizer,
    RealNNVectorizer, RealVectorizer, SmartTextVectorizer, VectorsCombiner,
)

_CATEGORICAL_TYPES = (PickList, ComboBox, ID, Country, State, City,
                      PostalCode, Street, Phone)
_FREE_TEXT_TYPES = (TextArea, Base64, URL, Email)


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
    if issubclass(ft, Prediction):
        return "vector"
    if issubclass(ft, RealNN):
        return "realnn"
    if issubclass(ft, (Real, Currency, Percent)):
        return "real"
    if issubclass(ft, Binary):
        return "binary"
    if issubclass(ft, Integral):
        return "integral"
    if issubclass(ft, MultiPickList):
        return "multipicklist"
    if issubclass(ft, _CATEGORICAL_TYPES):
        return "categorical"
    if issubclass(ft, _FREE_TEXT_TYPES) or ft is Text:
        return "text"
    if issubclass(ft, TextList):
        return "textlist"
    if issubclass(ft, OPVector):
        return "vector"
    raise NotImplementedError(
        f"transmogrify has no vectorizer for {ft.__name__} (feature "
        f"'{f.name}') in the PyTorch port yet")


def _vectorizer_for(group: str):
    if group == "realnn":
        return RealNNVectorizer()
    if group == "real":
        return RealVectorizer()
    if group == "integral":
        return IntegralVectorizer()
    if group == "binary":
        return BinaryVectorizer()
    if group in ("categorical", "multipicklist"):
        return OneHotVectorizer()
    if group == "text":
        return SmartTextVectorizer()
    if group == "textlist":
        return HashingVectorizer()
    if group == "vector":
        return VectorsCombiner()
    raise AssertionError(group)
