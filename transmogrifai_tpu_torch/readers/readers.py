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
- quoted fields keep their commas and doubled quotes;
- numbers are ASCII: a field of other Unicode digits is a string;
- an integer column outside int64 is uint64 when every field lies in
  [0, 2^64) and none is missing, raw strings when a field lies in
  [2^63, 2^64) but the column cannot be uint64, and python ints (missing
  NaN) when it reaches past both ranges otherwise;
- a UTF-8 byte-order mark is dropped, lines of blanks are skipped,
  duplicate header names become ``age``, ``age.1``, ..., and when the
  first data row has more fields than the header, its leading fields make
  pandas' implicit index: every name moves to the fields after them, and
  a later row with more fields than the first raises, as pandas does.

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


_I64 = (-2 ** 63, 2 ** 63)
_U64 = (0, 2 ** 64)


def _parse_int(s: str) -> Optional[int]:
    t = s.strip()
    if not t or "_" in t or not t.isascii():
        return None
    try:
        return int(t, 10)
    except ValueError:
        return None


def _parse_float(s: str) -> Optional[float]:
    if "_" in s or not s.isascii():
        return None
    try:
        return float(s)
    except ValueError:
        return None


def _csv_float(s: str) -> Optional[float]:
    """A CSV field as pandas' parser reads a float: a positive integer of
    2^64 or more, written without a point or exponent, is none (it takes
    that for an overflowing integer)."""
    i = _parse_int(s)
    return None if i is not None and i >= _U64[1] else _parse_float(s)


def _within(v: int, bounds) -> bool:
    return bounds[0] <= v < bounds[1]


def infer_column(fields: Sequence[str]) -> np.ndarray:
    """A CSV column of raw fields -> its numpy column, typed as pandas'
    ``read_csv`` types it (module docstring)."""
    na = [f in NA_VALUES for f in fields]
    present = [f for f, m in zip(fields, na) if not m]
    if not present:
        return np.full(len(fields), np.nan)
    ints = [_parse_int(f) for f in present]
    out = np.empty(len(fields), dtype=object)
    if all(v is not None for v in ints):
        if all(_within(v, _I64) for v in ints):
            if not any(na):
                return np.array(ints, dtype=np.int64)
            it = iter(ints)
            return np.array([np.nan if m else float(next(it)) for m in na])
        if any(_within(v, _U64) and not _within(v, _I64) for v in ints):
            if not any(na) and all(_within(v, _U64) for v in ints):
                return np.array(ints, dtype=np.uint64)
            out[:] = list(fields)
            return out
        it = iter(ints)
        out[:] = [np.nan if m else next(it) for m in na]
        return out
    floats = [_csv_float(f) for f in present]
    if all(v is not None for v in floats):
        it = iter(floats)
        return np.array([np.nan if m else next(it) for m in na])
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
    other cells are strings; a column of only None, or of lists or dicts,
    keeps them)."""
    present = [v for v in values
               if v is not None and not (isinstance(v, float)
                                         and math.isnan(v))]
    if not present and all(v is None for v in values):
        out = np.empty(len(values), dtype=object)
        out[:] = None
        return out
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
        # a record without a field is NaN there, not None
        return Frame({k: _column_of_python([r.get(k, math.nan)
                                            for r in rows])
                      for k in names})


def _dedup_names(names: Sequence[str]) -> List[str]:
    """pandas' renaming of duplicate header names: the second ``age``
    becomes ``age.1`` (or the next free ``age.<k>`` when the header holds
    that name too)."""
    header = set(names)
    counts: Dict[str, int] = {}
    out = []
    for col in names:
        base, cur = col, counts.get(col, 0)
        while cur > 0:
            counts[base] = cur + 1
            col = f"{base}.{cur}"
            cur = cur + 1 if col in header else counts.get(col, 0)
        out.append(col)
        counts[col] = cur + 1
    return out


def read_csv(path: str, schema: Optional[Sequence[str]] = None,
             header: bool = True) -> Frame:
    """A CSV file as a frame. With ``header`` the first line names the
    columns; otherwise ``schema`` does. See the module docstring for the
    blank lines, byte-order mark, duplicate names and index fields."""
    with open(path, newline="", encoding="utf-8-sig") as fh:
        reader = csv.reader(fh)
        rows, lines = [], []
        for r in reader:
            if r and not (len(r) == 1 and not r[0].strip(" \t")):
                rows.append(r)
                lines.append(reader.line_num)
    if header:
        names = _dedup_names(rows[0]) if rows else []
        rows, lines = rows[1:], lines[1:]
    else:
        if schema is None:
            raise ValueError("a CSV without a header needs a schema")
        names = list(schema)
        if len(set(names)) != len(names):
            raise ValueError("Duplicate names are not allowed.")
    width = len(names)
    first = len(rows[0]) if rows else width
    skip = max(first - width, 0)         # pandas' implicit index fields
    fields = [[] for _ in names]
    for r, line in zip(rows, lines):
        if len(r) > width + skip:
            raise ValueError(f"Error tokenizing data: expected "
                             f"{width + skip} fields in line {line}, saw "
                             f"{len(r)}")
        r = r[skip:] + [""] * (width + skip - len(r))
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
    if kind in ("real", "binary", "integral", "date"):
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
    a custom extract function runs on each record. Unless
    ``require_response``, a response feature is read only when it is a
    field the frame holds. The key is ``key_field``'s column as strings
    (missing stays NaN) or ``key_fn`` of each record."""
    cols: Dict[str, Column] = {}
    slow: List[Feature] = []
    missing: List[str] = []
    for f in raw_features:
        field = _field_name_of(f.origin_stage.extract_fn)
        if f.is_response and not require_response and (
                field is None or field not in frame):
            continue
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
