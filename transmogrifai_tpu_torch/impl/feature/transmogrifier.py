"""Transmogrifier (counterpart of
``transmogrifai_tpu.impl.feature.transmogrifier``): group features by type,
apply each group's default vectorizer, and combine the groups' vectors into
one OPVector feature. Every concrete type goes to the JAX package's group,
tested in its order (maps by their kind and element type before the
scalars, dates before integrals): pick-list-like text and maps pivot,
free text and text maps go through the smart text vectorizers, dates to
the unit circle, date lists to days since the last date, geolocations to
their midpoint-filled triple."""
from __future__ import annotations

from typing import Dict, List, Sequence

from ...features import Feature
from ...types import (
    URL, Base64, Binary, City, ComboBox, Country, Currency, Date, DateList,
    DateMap, DateTime, DateTimeMap, Email, Geolocation, GeolocationMap, ID,
    Integral, MultiPickList, MultiPickListMap, OPMap, OPVector, Percent,
    Phone, PickList, PostalCode, Prediction, Real, RealNN, State, Street,
    Text, TextArea, TextAreaMap, TextList, TextMap,
)
from .dates import (
    DEFAULT_CIRCULAR_PERIODS, DateListVectorizer,
    DateMapToUnitCircleVectorizer, DateToUnitCircleTransformer,
)
from .geo import GeolocationMapVectorizer, GeolocationVectorizer
from .maps import MapVectorizer, SmartTextMapVectorizer, TextMapPivotVectorizer
from .vectorizers import (
    BinaryVectorizer, HashingVectorizer, IntegralVectorizer, OneHotVectorizer,
    RealNNVectorizer, RealVectorizer, SmartTextVectorizer, VectorsCombiner,
)

_CATEGORICAL_TYPES = (PickList, ComboBox, ID, Country, State, City,
                      PostalCode, Street, Phone)
_FREE_TEXT_TYPES = (TextArea, Base64, URL, Email)
_FREE_TEXT_MAP_TYPES = (TextMap, TextAreaMap)


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
    if issubclass(ft, GeolocationMap):
        return "geomap"
    if issubclass(ft, (DateMap, DateTimeMap)):
        return "datemap"
    if issubclass(ft, MultiPickListMap):
        return "multipicklistmap"
    if issubclass(ft, _FREE_TEXT_MAP_TYPES):
        return "textmap"
    if issubclass(ft, OPMap):
        elem = getattr(ft, "element_type", None)
        if elem is not None and issubclass(elem, (Real, Integral, Binary)):
            return "numericmap"
        return "categoricalmap"
    if issubclass(ft, RealNN):
        return "realnn"
    if issubclass(ft, (Real, Currency, Percent)):
        return "real"
    if issubclass(ft, Binary):
        return "binary"
    if issubclass(ft, (Date, DateTime)):
        return "date"
    if issubclass(ft, Integral):
        return "integral"
    if issubclass(ft, MultiPickList):
        return "multipicklist"
    if issubclass(ft, _CATEGORICAL_TYPES):
        return "categorical"
    if issubclass(ft, _FREE_TEXT_TYPES) or ft is Text:
        return "text"
    if issubclass(ft, DateList):
        return "datelist"
    if issubclass(ft, Geolocation):
        return "geolocation"
    if issubclass(ft, TextList):
        return "textlist"
    if issubclass(ft, OPVector):
        return "vector"
    raise NotImplementedError(
        f"transmogrify has no vectorizer for {ft.__name__} (feature "
        f"'{f.name}')")


def _vectorizer_for(group: str):
    if group == "realnn":
        return RealNNVectorizer()
    if group == "real":
        return RealVectorizer()
    if group == "integral":
        return IntegralVectorizer()
    if group == "date":
        return DateToUnitCircleTransformer(periods=DEFAULT_CIRCULAR_PERIODS)
    if group == "datelist":
        return DateListVectorizer(pivot="SinceLast")
    if group == "binary":
        return BinaryVectorizer()
    if group in ("categorical", "multipicklist"):
        return OneHotVectorizer()
    if group == "text":
        return SmartTextVectorizer()
    if group == "textlist":
        return HashingVectorizer()
    if group == "geolocation":
        return GeolocationVectorizer()
    if group == "numericmap":
        return MapVectorizer()
    if group in ("categoricalmap", "multipicklistmap"):
        return TextMapPivotVectorizer()
    if group == "textmap":
        return SmartTextMapVectorizer()
    if group == "datemap":
        return DateMapToUnitCircleVectorizer()
    if group == "geomap":
        return GeolocationMapVectorizer()
    if group == "vector":
        return VectorsCombiner()
    raise AssertionError(group)
