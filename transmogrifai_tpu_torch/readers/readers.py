"""Data readers (counterpart of ``transmogrifai_tpu.readers.readers``): a
CSV file, a mapping of columns or a list of records -> a ``FeatureTable``
of a workflow's raw features, without pandas.

The JAX package reads through pandas (``read_csv``, a ``DataFrame``) and
converts each column with ``series_to_column``; custom extract functions
see ``df.to_dict("records")``. The port gives the same columns and records
with the csv module and numpy, so it repeats pandas' choices:

- each CSV column takes the first type all its non-missing fields parse as:
  int64, then float64, then bool ("True"/"False"), else strings; a blank
  or one of pandas' default NA strings (``NA_VALUES``) is missing;
- an integer column with a missing field is float64 (a record holds
  ``1.0``, ``str`` of it is ``"1.0"``), and a missing field is NaN, not
  None (``str`` of it is ``"nan"``);
- a numeric feature parses its column as numbers, anything else missing
  (``pd.to_numeric(errors="coerce")``); a text feature keeps non-empty
  strings only, so a column of numbers is all missing;
- quoted fields keep their commas and doubled quotes.

A ``Frame`` is the port's stand-in for the DataFrame: name -> numpy
column, in pandas' dtypes (a string column is an object array whose
missing cells are NaN, as pandas 3 stores it).
"""
from __future__ import annotations

import abc
import csv
import math
from typing import (
    Any, Callable, Dict, List, Mapping, Optional, Sequence, Union,
)

import numpy as np

from ..features import Feature
from ..table import Column, FeatureTable

#: pandas' default NA strings (``pandas._libs.parsers.STR_NA_VALUES``)
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
_TRUE, _FALSE = ("True", "TRUE", "true"), ("False", "FALSE", "false")


def _parse_int(s: str) -> Optional[int]:
    t = s.strip()
    if not t or "_" in t:
        return None
    try:
        return int(t, 10)
    except ValueError:
        return None


def _parse_float(s: str) -> Optional[float]:
    if "_" in s:
        return None
    try:
        return float(s)
    except ValueError:
        return None


def infer_column(fields: Sequence[str]) -> np.ndarray:
    """A CSV column of raw fields -> its numpy column, typed as pandas'
    ``read_csv`` types it (module docstring)."""
    na = [f in NA_VALUES for f in fields]
    present = [f for f, m in zip(fields, na) if not m]
    if not present:
        return np.full(len(fields), np.nan)
    ints = [_parse_int(f) for f in present]
    if all(v is not None for v in ints) and all(
            -2 ** 63 <= v < 2 ** 63 for v in ints):
        if not any(na):
            return np.array(ints, dtype=np.int64)
        it = iter(ints)
        return np.array([np.nan if m else float(next(it)) for m in na])
    floats = [_parse_float(f) for f in present]
    if all(v is not None for v in floats):
        it = iter(floats)
        return np.array([np.nan if m else next(it) for m in na])
    out = np.empty(len(fields), dtype=object)
    if all(f in _TRUE or f in _FALSE for f in present):
        for i, (f, m) in enumerate(zip(fields, na)):
            out[i] = np.nan if m else f in _TRUE
        return out.astype(bool) if not any(na) else out
    for i, (f, m) in enumerate(zip(fields, na)):
        out[i] = np.nan if m else f
    return out


def _column_of_python(values: Sequence[Any]) -> np.ndarray:
    """A column of python values -> the numpy column a DataFrame makes of
    it: bool, int64, float64 (None is NaN), or object (None is NaN when the
    other cells are strings)."""
    present = [v for v in values
               if v is not None and not (isinstance(v, float)
                                         and math.isnan(v))]
    if present and len(present) == len(values) and all(
            isinstance(v, (bool, np.bool_)) for v in present):
        return np.array(values, dtype=bool)
    if all(isinstance(v, (int, float, np.integer, np.floating))
           and not isinstance(v, (bool, np.bool_)) for v in present):
        if present and len(present) == len(values) and all(
                isinstance(v, (int, np.integer)) for v in present):
            return np.array(values, dtype=np.int64)
        return np.array([np.nan if v is None else v for v in values],
                        dtype=np.float64)
    out = np.empty(len(values), dtype=object)
    strings = all(isinstance(v, str) for v in present)
    for i, v in enumerate(values):
        out[i] = np.nan if (v is None and strings) else v
    return out


class Frame:
    """A columnar frame: name -> numpy column, all of ``num_rows`` rows."""

    def __init__(self, columns: Mapping[str, np.ndarray]):
        self.columns: Dict[str, np.ndarray] = dict(columns)
        sizes = {len(v) for v in self.columns.values()}
        if len(sizes) > 1:
            raise ValueError(f"frame columns differ in length: "
                             f"{sorted(sizes)}")
        self.num_rows = sizes.pop() if sizes else 0

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def records(self) -> List[Dict[str, Any]]:
        """One dict of python values a row (``df.to_dict("records")``)."""
        names = list(self.columns)
        cols = [self.columns[c].tolist() for c in names]
        return [dict(zip(names, row)) for row in zip(*cols)]

    @staticmethod
    def of(data: Union["Frame", Mapping[str, Any],
                       Sequence[Mapping[str, Any]]]) -> "Frame":
        """A frame of a mapping of columns (numpy arrays keep their dtype,
        python sequences are typed as a DataFrame types them) or of a list
        of records (missing fields are None)."""
        if isinstance(data, Frame):
            return data
        if isinstance(data, Mapping):
            return Frame({k: v if isinstance(v, np.ndarray)
                          else _column_of_python(list(v))
                          for k, v in data.items()})
        rows = list(data)
        names: Dict[str, None] = {}
        for r in rows:
            names.update(dict.fromkeys(r))
        return Frame({k: _column_of_python([r.get(k) for r in rows])
                      for k in names})


def read_csv(path: str, schema: Optional[Sequence[str]] = None,
             header: bool = True) -> Frame:
    """A CSV file as a frame. With ``header`` the first line names the
    columns; otherwise ``schema`` does. Blank lines are skipped."""
    with open(path, newline="") as fh:
        rows = [r for r in csv.reader(fh) if r]
    if header:
        names, rows = (rows[0], rows[1:]) if rows else ([], [])
    else:
        if schema is None:
            raise ValueError("a CSV without a header needs a schema")
        names = list(schema)
    width = len(names)
    fields = [[] for _ in names]
    for r in rows:
        r = r[:width] + [""] * (width - len(r))
        for j, f in enumerate(r):
            fields[j].append(f)
    return Frame({n: infer_column(f) for n, f in zip(names, fields)})


def _to_numeric(arr: np.ndarray) -> np.ndarray:
    """float64 of ``arr``; a cell that is no number is NaN
    (``pd.to_numeric(errors="coerce")``)."""
    if arr.dtype.kind in "biuf":
        return arr.astype(np.float64)
    out = np.full(len(arr), np.nan)
    for i, v in enumerate(arr):
        if isinstance(v, (bool, int, float, np.number, np.bool_)):
            out[i] = float(v)
        elif isinstance(v, str):
            p = _parse_float(v)
            out[i] = np.nan if p is None else p
    return out


def series_to_column(feature_type, arr: np.ndarray) -> Column:
    """One frame column -> the host column of ``feature_type`` (the JAX
    package's ``series_to_column``)."""
    kind = feature_type.column_kind
    if kind in ("real", "binary", "integral"):
        num = _to_numeric(arr)
        mask = ~np.isnan(num)
        filled = np.where(mask, num, 0.0)
        if kind == "real":
            return Column(feature_type, filled.astype(np.float32), mask)
        if kind == "binary":
            return Column(feature_type, (filled != 0.0).astype(np.float32),
                          mask)
        with np.errstate(invalid="ignore"):
            return Column(feature_type, filled.astype(np.int64), mask)
    if kind == "text":
        vals = arr if arr.dtype == object else arr.astype(object)
        mask = np.array([isinstance(v, str) and v != "" for v in vals],
                        dtype=bool)
        out = np.empty(len(vals), dtype=object)
        for i, (v, m) in enumerate(zip(vals, mask)):
            out[i] = v if m else None
        return Column(feature_type, out, mask)
    return Column.of_values(feature_type, list(arr))


def _field_name_of(extract_fn: Callable) -> Optional[str]:
    name = getattr(extract_fn, "__name__", "")
    return name[len("extract_"):] if name.startswith("extract_") else None


def frame_to_table(frame: Frame, raw_features: Sequence[Feature],
                   key_field: Optional[str] = None,
                   key_fn: Optional[Callable[[Any], str]] = None,
                   require_response: bool = True) -> FeatureTable:
    """A host table of ``raw_features`` from a frame (the JAX package's
    ``dataframe_to_table``): a field extractor converts its column whole,
    a custom extract function runs on each record. Response features are
    left out unless ``require_response``. The key is ``key_field``'s
    column as strings (missing stays NaN) or ``key_fn`` of each record."""
    cols: Dict[str, Column] = {}
    slow: List[Feature] = []
    missing: List[str] = []
    for f in raw_features:
        if f.is_response and not require_response:
            continue
        field = _field_name_of(f.origin_stage.extract_fn)
        if field is None:
            slow.append(f)
        elif field in frame:
            cols[f.name] = series_to_column(f.feature_type, frame[field])
        else:
            missing.append(field)
    if missing:
        raise ValueError(f"raw feature field(s) {missing} not present in "
                         f"the data (columns: {list(frame.columns)})")
    records = frame.records() if slow or (
        key_fn is not None and key_field is None) else None
    for f in slow:
        cols[f.name] = Column.of_values(
            f.feature_type, [f.origin_stage.extract(r) for r in records])
    key = None
    if key_field is not None and key_field in frame:
        key = np.array([v if isinstance(v, float) and math.isnan(v)
                        else str(v) for v in frame[key_field].tolist()],
                       dtype=object)
    elif key_fn is not None:
        key = np.array([key_fn(r) for r in records], dtype=object)
    return FeatureTable(cols, frame.num_rows, key)


class Reader(abc.ABC):
    """A source of raw data with an optional row key."""

    def __init__(self, key_fn: Optional[Callable[[Any], str]] = None,
                 key_field: Optional[str] = None):
        self.key_fn = key_fn
        self.key_field = key_field

    @abc.abstractmethod
    def read(self) -> Frame:
        """The raw data as a frame."""

    def generate_table(self, raw_features: Sequence[Feature],
                       require_response: bool = True) -> FeatureTable:
        """The host table of ``raw_features``."""
        return frame_to_table(self.read(), raw_features,
                              key_field=self.key_field, key_fn=self.key_fn,
                              require_response=require_response)


class FrameReader(Reader):
    """A mapping of columns or a list of records in memory (the role of
    the JAX package's ``DataFrameReader``)."""

    def __init__(self, data, **kw):
        super().__init__(**kw)
        self.frame = Frame.of(data)

    def read(self) -> Frame:
        return self.frame


class CSVReader(Reader):
    """A CSV file, with a header line or an explicit schema."""

    def __init__(self, path: str, schema: Optional[Sequence[str]] = None,
                 header: bool = True, **kw):
        super().__init__(**kw)
        self.path = path
        self.schema = list(schema) if schema else None
        self.header = header

    def read(self) -> Frame:
        return read_csv(self.path, self.schema, self.header)


class DataReaders:
    """Factory namespace, as the JAX package's ``DataReaders``; Parquet,
    Avro, aggregating and streaming readers are not ported."""

    class Simple:
        @staticmethod
        def csv(path: str, schema: Optional[Sequence[str]] = None,
                header: bool = True,
                key_field: Optional[str] = None) -> CSVReader:
            return CSVReader(path, schema=schema, header=header,
                             key_field=key_field)

        @staticmethod
        def dataframe(data, key_field: Optional[str] = None) -> FrameReader:
            """A mapping of columns or a list of records."""
            return FrameReader(data, key_field=key_field)


__all__ = ["NA_VALUES", "Frame", "read_csv", "infer_column",
           "series_to_column", "frame_to_table", "Reader", "FrameReader",
           "CSVReader", "DataReaders"]
