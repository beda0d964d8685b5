"""Monoid aggregators of event records (counterpart of
``transmogrifai_tpu.aggregators``, host Python with the same outputs).

Every feature type has a default monoid (``default_aggregator``:
prepare -> plus -> present); the aggregating readers
(``readers.aggregates``) fold a key's time-ordered event records into one
row with it: predictors over the events before the cutoff
(``CutOffTime``), responses over the events after it. Partial aggregates
merge associatively, so shards of events can be folded apart and joined.
"""
from __future__ import annotations

import time as _time
from typing import Any, Optional, Sequence, Type

import numpy as np

from .types import (
    Binary, Date, DateList, DateTime, FeatureType, Geolocation, Integral,
    MultiPickList, OPList, OPMap, OPNumeric, PickList, Real, RealNN, Text,
    TextList,
)

_DAY_MS = 86_400_000


class MonoidAggregator:
    """prepare/plus/present monoid (reference algebird MonoidAggregator)."""

    def prepare(self, v: Any) -> Any:
        return v

    def plus(self, a: Any, b: Any) -> Any:
        raise NotImplementedError

    def present(self, a: Optional[Any]) -> Any:
        return a

    def aggregate(self, values: Sequence[Any]) -> Any:
        acc: Optional[Any] = None
        for v in values:
            if v is None:
                continue
            p = self.prepare(v)
            if p is None:
                continue
            acc = p if acc is None else self.plus(acc, p)
        return self.present(acc)


class Sum(MonoidAggregator):
    def plus(self, a, b):
        return a + b


class MaxAgg(MonoidAggregator):
    def plus(self, a, b):
        return max(a, b)


class MinAgg(MonoidAggregator):
    def plus(self, a, b):
        return min(a, b)


class MeanAgg(MonoidAggregator):
    def prepare(self, v):
        return (float(v), 1)

    def plus(self, a, b):
        return (a[0] + b[0], a[1] + b[1])

    def present(self, a):
        return None if a is None or a[1] == 0 else a[0] / a[1]


class LogicalOr(MonoidAggregator):
    def plus(self, a, b):
        return bool(a) or bool(b)


class ConcatText(MonoidAggregator):
    """Concatenate text with a separator (reference ConcatTextWithSeparator)."""

    def __init__(self, separator: str = " "):
        self.separator = separator

    def prepare(self, v):
        return str(v)

    def plus(self, a, b):
        return a + self.separator + b


class ModeAgg(MonoidAggregator):
    """Most frequent value, ties → smallest (reference mode semantics)."""

    def prepare(self, v):
        return {v: 1}

    def plus(self, a, b):
        out = dict(a)
        for k, c in b.items():
            out[k] = out.get(k, 0) + c
        return out

    def present(self, a):
        if not a:
            return None
        return sorted(a.items(), key=lambda kv: (-kv[1], str(kv[0])))[0][0]


class ConcatList(MonoidAggregator):
    def prepare(self, v):
        return list(v)

    def plus(self, a, b):
        return a + b


class UnionSet(MonoidAggregator):
    def prepare(self, v):
        return set(v)

    def plus(self, a, b):
        return a | b

    def present(self, a):
        return None if a is None else sorted(a)


class UnionMap(MonoidAggregator):
    """Merge maps, combining shared keys with an element aggregator
    (reference aggregators/Maps.scala)."""

    def __init__(self, element: Optional[MonoidAggregator] = None):
        self.element = element or LastValue()

    def prepare(self, v):
        return {k: self.element.prepare(x) for k, x in dict(v).items()
                if x is not None}

    def plus(self, a, b):
        out = dict(a)
        for k, x in b.items():
            out[k] = self.element.plus(out[k], x) if k in out else x
        return out

    def present(self, a):
        if a is None:
            return None
        return {k: self.element.present(x) for k, x in a.items()}


class LastValue(MonoidAggregator):
    """Keep the rightmost value (events are time-ordered by the reader;
    reference LastAggregator, TimeBasedAggregator.scala)."""

    def plus(self, a, b):
        return b


class FirstValue(MonoidAggregator):
    def plus(self, a, b):
        return a


class GeoMidpoint(MonoidAggregator):
    """Geographic midpoint of (lat, lon, acc) triples (reference
    Geolocation union semantics)."""

    def prepare(self, v):
        lat, lon = np.radians(float(v[0])), np.radians(float(v[1]))
        acc = float(v[2]) if len(v) > 2 else 0.0
        return (np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
                np.sin(lat), acc, 1)

    def plus(self, a, b):
        return tuple(x + y for x, y in zip(a, b))

    def present(self, a):
        if a is None or a[4] == 0:
            return None
        x, y, z, acc, n = a
        x, y, z = x / n, y / n, z / n
        hyp = np.hypot(x, y)
        return [float(np.degrees(np.arctan2(z, hyp))),
                float(np.degrees(np.arctan2(y, x))), acc / n]


def default_aggregator(ft: Type[FeatureType]) -> MonoidAggregator:
    """Per-type defaults (reference MonoidAggregatorDefaults.scala)."""
    if issubclass(ft, (Date, DateTime)):
        return MaxAgg()                       # latest event time
    if issubclass(ft, Binary):
        return LogicalOr()
    if issubclass(ft, (RealNN, Real, Integral)) or issubclass(ft, OPNumeric):
        return Sum()
    if issubclass(ft, Geolocation):
        return GeoMidpoint()
    if issubclass(ft, MultiPickList):     # the JAX package's only OPSet
        return UnionSet()
    if issubclass(ft, (TextList, DateList)) or issubclass(ft, OPList):
        return ConcatList()
    if issubclass(ft, OPMap):
        return UnionMap()
    if issubclass(ft, PickList):
        return ModeAgg()
    if issubclass(ft, Text):
        return ConcatText()
    return LastValue()


class CutOffTime:
    """Event-time cutoff separating predictor history from response window
    (reference aggregators/CutOffTime.scala)."""

    def __init__(self, kind: str, cutoff_ms: Optional[int] = None):
        self.kind = kind
        self.cutoff_ms = cutoff_ms

    @staticmethod
    def unix_epoch(ms: int) -> "CutOffTime":
        return CutOffTime("UnixEpoch", int(ms))

    @staticmethod
    def days_ago(days: int, now_ms: Optional[int] = None) -> "CutOffTime":
        now = int(_time.time() * 1000) if now_ms is None else int(now_ms)
        return CutOffTime("DaysAgo", now - days * _DAY_MS)

    @staticmethod
    def no_cutoff() -> "CutOffTime":
        return CutOffTime("NoCutoff", None)
