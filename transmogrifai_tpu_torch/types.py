"""Typed feature values (counterpart of ``transmogrifai_tpu.types``): the
numerics (``Real``, ``RealNN``, ``Currency``, ``Percent``, ``Integral``,
``Binary``) and the dates (``Date``, ``DateTime``: epoch milliseconds), the
text types (``Text`` and its free-text and categorical kinds),
``MultiPickList``, the lists (``TextList``, ``DateList``,
``DateTimeList``, ``Geolocation``), ``OPVector``, the 23 string-keyed maps
(``TextMap`` ... ``MultiPickListMap``, each with its ``element_type``)
and ``Prediction``: every concrete type of the JAX package.

Each class carries ``column_kind``, which decides how a column of the type
is stored in a ``FeatureTable``. The value classes exist for row-level
scoring; whole columns are numpy arrays on the host and tensors on the
device (``table.py``).
"""
from __future__ import annotations

import math
import numbers
from typing import Any, ClassVar, Dict, Optional, Tuple, Type

import numpy as np

__all__ = ["FeatureType", "OPNumeric", "Real", "RealNN", "Currency",
           "Percent", "Integral", "Date", "DateTime", "Binary", "Text",
           "TextArea", "Base64", "URL", "Email", "PickList", "ComboBox",
           "ID", "Country", "State", "City", "PostalCode", "Street",
           "Phone", "MultiPickList", "Location", "OPList", "TextList",
           "DateList", "DateTimeList", "Geolocation", "OPVector", "OPMap",
           "TextMap", "EmailMap", "Base64Map", "PhoneMap", "IDMap", "URLMap",
           "TextAreaMap", "PickListMap", "ComboBoxMap", "CountryMap",
           "StateMap", "CityMap", "PostalCodeMap", "StreetMap",
           "GeolocationMap", "BinaryMap", "IntegralMap", "RealMap",
           "CurrencyMap", "PercentMap", "DateMap", "DateTimeMap",
           "MultiPickListMap", "Prediction", "FEATURE_TYPES",
           "feature_type_by_name"]


class FeatureType:
    """Base value container: an optional value that may be empty."""

    is_nullable: ClassVar[bool] = True
    #: columnar storage kind: 'real', 'integral', 'binary', 'date',
    #: 'text', 'multipicklist', 'text_list', 'date_list', 'geolocation',
    #: 'map', 'vector' or 'prediction'
    column_kind: ClassVar[str] = "text"
    is_abstract: ClassVar[bool] = True

    __slots__ = ("value",)

    def __init__(self, value: Any = None):
        self.value = self._convert(value)
        if not self.is_nullable and self.is_empty:
            raise ValueError(f"{type(self).__name__} cannot be empty")

    @classmethod
    def _convert(cls, value: Any) -> Any:
        return value

    @property
    def is_empty(self) -> bool:
        return self.value is None

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.value!r})"


class NonNullable:
    """Marker mixin: the type cannot hold an empty value."""
    is_nullable = False


class OPNumeric(FeatureType):
    is_abstract = True


class Real(OPNumeric):
    """Optional real number; NaN is missing."""
    is_abstract = False
    column_kind = "real"

    @classmethod
    def _convert(cls, value):
        if value is None:
            return None
        if isinstance(value, bool):
            return 1.0 if value else 0.0
        if isinstance(value, numbers.Number):
            v = float(value)
            return None if math.isnan(v) else v
        raise TypeError(
            f"cannot make {cls.__name__} from {type(value).__name__}")


class RealNN(NonNullable, Real):
    """Non-nullable real: the label type."""
    is_abstract = False


class Currency(Real):
    is_abstract = False


class Percent(Real):
    is_abstract = False


class Integral(OPNumeric):
    """Optional whole number (a host int64 column)."""
    is_abstract = False
    column_kind = "integral"

    @classmethod
    def _convert(cls, value):
        if value is None:
            return None
        if isinstance(value, (bool, numbers.Integral)):
            return int(value)
        if isinstance(value, float):
            if math.isnan(value):
                return None
            if value.is_integer():
                return int(value)
        raise TypeError(f"cannot make {cls.__name__} from {value!r}")


class Date(Integral):
    """Optional epoch-milliseconds date (a host int64 column)."""
    is_abstract = False
    column_kind = "date"


class DateTime(Date):
    is_abstract = False


class Binary(OPNumeric):
    """Optional boolean; a column of them is float32 0/1 with a mask."""
    is_abstract = False
    column_kind = "binary"

    @classmethod
    def _convert(cls, value):
        if value is None:
            return None
        if isinstance(value, bool):
            return value
        if isinstance(value, numbers.Number):
            v = float(value)
            return None if math.isnan(v) else v != 0.0
        raise TypeError(f"cannot make {cls.__name__} from {value!r}")


class Text(FeatureType):
    """Optional string (a host object column)."""
    is_abstract = False
    column_kind = "text"

    @classmethod
    def _convert(cls, value):
        if value is None:
            return None
        if isinstance(value, str):
            return value
        raise TypeError(
            f"cannot make {cls.__name__} from {type(value).__name__}")


class Location:
    """Marker: a geographic location type."""


def _text_kind(name: str, *bases: type) -> type:
    return type(name, (Text,) + bases, {"is_abstract": False, "__doc__":
                                        f"Optional string: {name}."})


#: free text: ``transmogrify`` sends these through SmartTextVectorizer
TextArea = _text_kind("TextArea")
Base64 = _text_kind("Base64")
URL = _text_kind("URL")
Email = _text_kind("Email")
#: categorical text: ``transmogrify`` pivots these (OneHotVectorizer)
PickList = _text_kind("PickList")
ComboBox = _text_kind("ComboBox")
ID = _text_kind("ID")
Country = _text_kind("Country", Location)
State = _text_kind("State", Location)
City = _text_kind("City", Location)
PostalCode = _text_kind("PostalCode", Location)
Street = _text_kind("Street", Location)
Phone = _text_kind("Phone")


class MultiPickList(FeatureType):
    """A set of strings; the empty set is missing."""
    is_abstract = False
    column_kind = "multipicklist"

    @classmethod
    def _convert(cls, value):
        return set() if value is None else set(value)

    @property
    def is_empty(self) -> bool:
        return not self.value


class OPList(FeatureType):
    """A list; the empty list is missing."""
    is_abstract = True

    @classmethod
    def _convert(cls, value):
        return [] if value is None else list(value)

    @property
    def is_empty(self) -> bool:
        return not self.value


class TextList(OPList):
    """A list of strings (tokens)."""
    is_abstract = False
    column_kind = "text_list"


class DateList(OPList):
    """A list of epoch-milliseconds dates."""
    is_abstract = False
    column_kind = "date_list"

    @classmethod
    def _convert(cls, value):
        return [] if value is None else [int(v) for v in value]


class DateTimeList(DateList):
    is_abstract = False


class Geolocation(OPList, Location):
    """[latitude, longitude, accuracy]; the empty list is missing."""
    is_abstract = False
    column_kind = "geolocation"

    @classmethod
    def _convert(cls, value):
        if value is None:
            return []
        vals = [float(v) for v in value]
        if vals and len(vals) != 3:
            raise ValueError("Geolocation must have lat, lon, accuracy")
        if vals:
            lat, lon, _ = vals
            if not (-90.0 <= lat <= 90.0) or not (-180.0 <= lon <= 180.0):
                raise ValueError(f"invalid geolocation {vals}")
        return vals


class OPVector(NonNullable, FeatureType):
    """Dense float vector; a column of them is one (n, d) array."""
    is_abstract = False
    column_kind = "vector"

    @classmethod
    def _convert(cls, value):
        if value is None:
            return np.zeros((0,), dtype=np.float32)
        return np.asarray(value, dtype=np.float32)

    @property
    def is_empty(self) -> bool:
        return False


class OPMap(FeatureType):
    """A string-keyed map of values of ``element_type``; the empty map is
    missing."""
    is_abstract = True
    column_kind = "map"
    element_type: ClassVar[Optional[Type[FeatureType]]] = None

    @classmethod
    def _convert(cls, value):
        return {} if value is None else dict(value)

    @property
    def is_empty(self) -> bool:
        return not self.value


def _mk_map(name: str, element: Type[FeatureType],
            extra_bases: Tuple[type, ...] = ()) -> type:
    return type(name, (OPMap,) + extra_bases, {
        "is_abstract": False, "element_type": element,
        "__doc__": f"Map[str, {element.__name__}]."})


TextMap = _mk_map("TextMap", Text)
EmailMap = _mk_map("EmailMap", Email)
Base64Map = _mk_map("Base64Map", Base64)
PhoneMap = _mk_map("PhoneMap", Phone)
IDMap = _mk_map("IDMap", ID)
URLMap = _mk_map("URLMap", URL)
TextAreaMap = _mk_map("TextAreaMap", TextArea)
PickListMap = _mk_map("PickListMap", PickList)
ComboBoxMap = _mk_map("ComboBoxMap", ComboBox)
CountryMap = _mk_map("CountryMap", Country, (Location,))
StateMap = _mk_map("StateMap", State, (Location,))
CityMap = _mk_map("CityMap", City, (Location,))
PostalCodeMap = _mk_map("PostalCodeMap", PostalCode, (Location,))
StreetMap = _mk_map("StreetMap", Street, (Location,))
GeolocationMap = _mk_map("GeolocationMap", Geolocation, (Location,))
BinaryMap = _mk_map("BinaryMap", Binary)
IntegralMap = _mk_map("IntegralMap", Integral)
RealMap = _mk_map("RealMap", Real)
CurrencyMap = _mk_map("CurrencyMap", Currency)
PercentMap = _mk_map("PercentMap", Percent)
DateMap = _mk_map("DateMap", Date)
DateTimeMap = _mk_map("DateTimeMap", DateTime)
MultiPickListMap = _mk_map("MultiPickListMap", MultiPickList)

_MAPS = (TextMap, EmailMap, Base64Map, PhoneMap, IDMap, URLMap, TextAreaMap,
         PickListMap, ComboBoxMap, CountryMap, StateMap, CityMap,
         PostalCodeMap, StreetMap, GeolocationMap, BinaryMap, IntegralMap,
         RealMap, CurrencyMap, PercentMap, DateMap, DateTimeMap,
         MultiPickListMap)


class Prediction(NonNullable, OPMap):
    """Model output map with the reserved keys ``prediction``,
    ``rawPrediction_i`` and ``probability_i``."""
    is_abstract = False
    column_kind = "prediction"
    element_type = Real

    PredictionName = "prediction"
    RawPredictionName = "rawPrediction"
    ProbabilityName = "probability"

    @classmethod
    def _convert(cls, value):
        if value is None:
            raise ValueError("Prediction cannot be empty")
        d = dict(value)
        if cls.PredictionName not in d:
            raise ValueError(
                f"Prediction must contain '{cls.PredictionName}' key")
        return d

    @property
    def is_empty(self) -> bool:
        return False


#: name -> concrete feature type of the port
FEATURE_TYPES: Dict[str, Type[FeatureType]] = {
    t.__name__: t for t in (
        Real, RealNN, Currency, Percent, Integral, Date, DateTime, Binary,
        Text, TextArea, Base64, URL, Email, PickList, ComboBox, ID, Country,
        State, City, PostalCode, Street, Phone, MultiPickList, TextList,
        DateList, DateTimeList, Geolocation, OPVector, Prediction) + _MAPS}


def feature_type_by_name(name: str) -> Type[FeatureType]:
    try:
        return FEATURE_TYPES[name]
    except KeyError:
        raise ValueError(f"Unknown feature type '{name}'") from None
