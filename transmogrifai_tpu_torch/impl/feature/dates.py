"""Date stages (counterpart of ``transmogrifai_tpu.impl.feature.dates``):
time periods of epoch-millisecond dates, their unit-circle encodings, and
the date-list pivots.

Dates stay on the host as int64 (epoch milliseconds exceed float32), as in
the JAX package, and every block is built there with the JAX package's
numpy calls (sine and cosine in float64, then float32; "days since" a
python integer difference over the day's milliseconds), then copied to the
table's device once: the blocks are bit-equal to the JAX package's.

``DateListVectorizer`` pins its reference date to the clock
(``_time.time()``) when it is built without one, as the JAX package does,
so two trains built at different instants give different "days since"
columns.
"""
from __future__ import annotations

import threading
import time as _time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ...stages.base import SequenceTransformer, UnaryTransformer
from ...table import Column, FeatureTable
from ...types import Date, DateList, DateMap, Integral, IntegralMap, OPVector
from ...vector_metadata import NULL_INDICATOR, VectorColumnMetadata
from .vectorizers import _emit_host, _map_rows

_DAY_MS = 86_400_000


def _dt_parts(ms: np.ndarray) -> Dict[str, np.ndarray]:
    """Each time period of the epoch-ms dates ``ms`` (UTC; Monday is day
    1 of the week)."""
    dt = ms.astype("datetime64[ms]")
    days = dt.astype("datetime64[D]")
    months = dt.astype("datetime64[M]")
    years = dt.astype("datetime64[Y]")
    day_of_month = (days - months.astype("datetime64[D]")).astype(np.int64) + 1
    day_of_year = (days - years.astype("datetime64[D]")).astype(np.int64) + 1
    return {
        "HourOfDay": (ms // 3_600_000) % 24,
        "DayOfWeek": ((days.astype(np.int64) + 3) % 7) + 1,  # 1970-01-01 = Thu
        "DayOfMonth": day_of_month,
        "DayOfYear": day_of_year,
        "MonthOfYear": (months.astype(np.int64) % 12) + 1,
        "WeekOfMonth": ((day_of_month - 1) // 7) + 1,
        "WeekOfYear": ((day_of_year - 1) // 7) + 1,
    }


#: period -> its cycle length and the value it starts at
TIME_PERIODS: Dict[str, Dict[str, float]] = {
    "HourOfDay": {"period": 24.0, "offset": 0.0},
    "DayOfWeek": {"period": 7.0, "offset": 1.0},
    "DayOfMonth": {"period": 31.0, "offset": 1.0},
    "DayOfYear": {"period": 366.0, "offset": 1.0},
    "MonthOfYear": {"period": 12.0, "offset": 1.0},
    "WeekOfMonth": {"period": 5.0, "offset": 1.0},
    "WeekOfYear": {"period": 53.0, "offset": 1.0},
}


def time_period_values(ms: np.ndarray, period: str) -> np.ndarray:
    """int64 ``period`` of each epoch-ms date."""
    if period not in TIME_PERIODS:
        raise ValueError(
            f"unknown time period '{period}'; one of {sorted(TIME_PERIODS)}")
    return _dt_parts(np.asarray(ms, dtype=np.int64))[period]


def unit_circle(values: np.ndarray, period: str) -> np.ndarray:
    """(n, 2) float32 [sin, cos] of each period value's angle on its
    cycle, computed in float64."""
    spec = TIME_PERIODS[period]
    radians = 2.0 * np.pi * (values - spec["offset"]) / spec["period"]
    return np.stack([np.sin(radians), np.cos(radians)],
                    axis=1).astype(np.float32)


class TimePeriodTransformer(UnaryTransformer):
    """Date -> Integral: the date's time period."""

    def __init__(self, period: str = "DayOfWeek", uid=None):
        def fn(v):
            if v is None:
                return None
            return int(time_period_values(np.array([v]), period)[0])
        super().__init__(f"timePeriod{period}", transform_fn=fn,
                         output_type=Integral, input_type=Date, uid=uid)
        self.period = period

    def transform_column(self, table: FeatureTable) -> Column:
        col = table[self.input_features[0].name]
        vals = time_period_values(col.host_values().astype(np.int64),
                                  self.period)
        return Column(Integral, vals.astype(np.int64),
                      None if col.mask is None else col.valid_mask())


class TimePeriodListTransformer(UnaryTransformer):
    """DateList -> OPVector of each element's time period, padded (-1) or
    cut to ``width`` elements. With ``width`` None the first batch
    transformed fixes it (its longest list, at least 1), or the first row
    on the row path, as in the JAX package."""

    #: class-level (never saved) lock of the width's first setting
    _WIDTH_LOCK = threading.Lock()

    def __init__(self, period: str = "DayOfWeek",
                 width: Optional[int] = None, uid=None):
        def fn(v):
            if v is None:
                return None
            arr = np.asarray(list(v), dtype=np.int64)
            vals = [float(x) for x in time_period_values(arr, period)]
            width = self._lock_width(len(vals))
            return (vals + [-1.0] * width)[:width]
        super().__init__(f"dateListToTimePeriod{period}", transform_fn=fn,
                         output_type=OPVector, input_type=DateList, uid=uid)
        self.period = period
        self.width = width

    def _lock_width(self, observed: int) -> int:
        if self.width is None:
            with self._WIDTH_LOCK:
                if self.width is None:
                    self.width = max(int(observed), 1)
        return self.width

    def transform_column(self, table: FeatureTable) -> Column:
        col = table[self.input_features[0].name]
        vals, valid = col.host_values(), col.valid_mask()
        if self.width is None:
            self._lock_width(max((len(vals[i]) if valid[i] and vals[i]
                                  is not None else 0
                                  for i in range(len(col))), default=1))
        width = self.width
        mat = np.full((len(col), width), -1.0, np.float32)
        for i in range(len(col)):
            r = self.transform_fn(vals[i]) if valid[i] else None
            if r:
                mat[i, :width] = (r + [-1.0] * width)[:width]
        return Column(OPVector, table.on_device(mat), None)


class TimePeriodMapTransformer(UnaryTransformer):
    """DateMap -> IntegralMap of each key's time period."""

    def __init__(self, period: str = "DayOfWeek", uid=None):
        def fn(v):
            if v is None:
                return None
            return {k: int(time_period_values(
                np.array([t], dtype=np.int64), period)[0])
                for k, t in v.items()}
        super().__init__(f"dateMapToTimePeriod{period}", transform_fn=fn,
                         output_type=IntegralMap, input_type=DateMap,
                         uid=uid)
        self.period = period


#: ``transmogrify``'s periods for a date
DEFAULT_CIRCULAR_PERIODS = ("HourOfDay", "DayOfWeek", "DayOfMonth",
                            "DayOfYear")


def _sin_cos_meta(f, grouping: str, period: str
                  ) -> List[VectorColumnMetadata]:
    return [VectorColumnMetadata(f.name, f.type_name, grouping, None,
                                 descriptor_value=f"{period}_{part}")
            for part in ("sin", "cos")]


class DateToUnitCircleTransformer(SequenceTransformer):
    """Seq[Date] -> OPVector: [sin, cos] of each date's angle on each of
    ``periods``; a missing date is (0, 0), off the circle."""

    output_type = OPVector

    def __init__(self, periods: Sequence[str] = ("HourOfDay",), uid=None):
        super().__init__("toUnitCircle", transform_fn=None,
                         output_type=OPVector, uid=uid)
        self.periods = tuple(periods)

    def transform_column(self, table: FeatureTable) -> Column:
        blocks, meta = [], []
        for f in self.input_features:
            col = table[f.name]
            ms = col.host_values().astype(np.int64)
            m = col.valid_mask()
            for period in self.periods:
                block = unit_circle(time_period_values(ms, period), period)
                block[~m] = 0.0
                blocks.append(block)
                meta.extend(_sin_cos_meta(f, f.name, period))
        return _emit_host(self, table, np.concatenate(blocks, axis=1), meta)


class DateMapToUnitCircleVectorizer(SequenceTransformer):
    """Seq[DateMap] -> OPVector: [sin, cos] of each key's date on
    ``period``. The keys are ``keys`` or, with None, those the batch holds
    (sorted), so a batch without a key gives a narrower vector, as in the
    JAX package."""

    output_type = OPVector

    def __init__(self, period: str = "HourOfDay",
                 keys: Optional[Sequence[str]] = None, uid=None):
        super().__init__("mapToUnitCircle", transform_fn=None,
                         output_type=OPVector, uid=uid)
        self.period = period
        self.keys = list(keys) if keys is not None else None

    def transform_column(self, table: FeatureTable) -> Column:
        n = table.num_rows
        blocks, meta = [], []
        for f in self.input_features:
            rows = _map_rows(table[f.name])
            keys = self.keys
            if keys is None:
                keys = sorted({str(k) for r in rows if r for k in r})
            for key in keys:
                ms = np.array([int(r[key]) if r and key in r
                               and r[key] is not None else 0 for r in rows],
                              dtype=np.int64)
                present = np.array([bool(r and key in r
                                         and r[key] is not None)
                                    for r in rows])
                block = unit_circle(time_period_values(ms, self.period),
                                    self.period)
                block[~present] = 0.0
                blocks.append(block)
                meta.extend(_sin_cos_meta(f, key, self.period))
        mat = (np.concatenate(blocks, axis=1) if blocks
               else np.zeros((n, 0), dtype=np.float32))
        return _emit_host(self, table, mat, meta)


#: the date-list pivots
DATE_LIST_PIVOTS = ("SinceFirst", "SinceLast", "ModeDay", "ModeMonth",
                    "ModeHour")


class DateListVectorizer(SequenceTransformer):
    """Seq[DateList] -> OPVector, one pivot for every input:

    * SinceFirst / SinceLast: days from the first / last date to
      ``reference_date_ms`` (the clock when built without one), with a
      null indicator when ``track_nulls``;
    * ModeDay / ModeMonth / ModeHour: one-hot of the list's most frequent
      day of the week (7) / month (12) / hour (24), ties to the smallest.
    """

    output_type = OPVector

    def __init__(self, pivot: str = "SinceLast",
                 reference_date_ms: Optional[int] = None,
                 track_nulls: bool = True, uid=None):
        super().__init__(f"dateList{pivot}", transform_fn=None,
                         output_type=OPVector, uid=uid)
        if pivot not in DATE_LIST_PIVOTS:
            raise ValueError(f"pivot must be one of {DATE_LIST_PIVOTS}")
        self.pivot = pivot
        self.reference_date_ms = (int(_time.time() * 1000)
                                  if reference_date_ms is None
                                  else int(reference_date_ms))
        self.track_nulls = track_nulls

    _MODE_SPECS = {"ModeDay": ("DayOfWeek", 7, 1),
                   "ModeMonth": ("MonthOfYear", 12, 1),
                   "ModeHour": ("HourOfDay", 24, 0)}

    def transform_column(self, table: FeatureTable) -> Column:
        n = table.num_rows
        blocks, meta = [], []
        for f in self.input_features:
            col = table[f.name]
            vals, valid = col.host_values(), col.valid_mask()
            lists = [vals[i] if valid[i] else None for i in range(n)]
            if self.pivot in ("SinceFirst", "SinceLast"):
                take = min if self.pivot == "SinceFirst" else max
                days = np.zeros(n, dtype=np.float32)
                nulls = np.zeros(n, dtype=np.float32)
                for i, lst in enumerate(lists):
                    if not lst:
                        nulls[i] = 1.0
                        continue
                    days[i] = (self.reference_date_ms - take(lst)) / _DAY_MS
                cols = [days]
                meta.append(VectorColumnMetadata(
                    f.name, f.type_name, f.name, None,
                    descriptor_value=self.pivot))
                if self.track_nulls:
                    cols.append(nulls)
                    meta.append(VectorColumnMetadata(
                        f.name, f.type_name, f.name, NULL_INDICATOR))
                blocks.append(np.stack(cols, axis=1))
            else:
                period, card, offset = self._MODE_SPECS[self.pivot]
                block = np.zeros((n, card), dtype=np.float32)
                for i, lst in enumerate(lists):
                    if not lst:
                        continue
                    pv = time_period_values(np.asarray(lst, dtype=np.int64),
                                            period)
                    vv, cc = np.unique(pv, return_counts=True)
                    block[i, int(vv[np.argmax(cc)]) - offset] = 1.0
                blocks.append(block)
                meta.extend(VectorColumnMetadata(
                    f.name, f.type_name, f.name, f"{self.pivot}_{j + offset}")
                    for j in range(card))
        return _emit_host(self, table, np.concatenate(blocks, axis=1), meta)
