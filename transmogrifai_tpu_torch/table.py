"""FeatureTable: the columnar table the port scores (counterpart of
``transmogrifai_tpu.table``).

Host columns are numpy arrays. ``FeatureTable.to_device`` moves the numeric
columns (kinds ``real``, ``binary``, ``vector``, ``prediction``) onto a torch
device with one host-to-device copy per dtype (plus one for all validity
masks) and records the device; stages then compute on those tensors and emit
tensor columns on the same device. Integral (int64), text, multi-pick-list
and token-list columns stay on the host, as in the JAX package, until a
vectorizer turns them into float blocks on the table's device.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import (
    Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, Type,
)

import numpy as np
import torch

from .types import FeatureType

#: column kinds whose values are numeric arrays that move to the device
DEVICE_KINDS = frozenset({"real", "binary", "vector", "prediction"})


@dataclass(frozen=True)
class Column:
    """One feature column.

    values: float32 (n,) for 'real' and 'binary' (0/1; invalid slots hold
    0.0), int64 (n,) host array for 'integral' and 'date' (epoch ms;
    invalid slots hold 0), float32 (n, d) for 'vector', float32 (n, k) for
    'prediction' (key order in ``metadata['keys']``), a numpy object array
    (n,) of the python values for 'text', 'multipicklist', 'text_list',
    'date_list', 'geolocation' and 'map'; a numpy array on the host or a
    tensor on a device.
    mask: bool (n,) validity, None when every row is valid.
    """
    feature_type: Type[FeatureType]
    values: Any
    mask: Optional[Any] = None
    metadata: Mapping[str, Any] = field(default_factory=dict)

    @property
    def kind(self) -> str:
        return self.feature_type.column_kind

    def __len__(self) -> int:
        return int(self.values.shape[0])

    @property
    def width(self) -> int:
        """Slots a row: a vector's or a prediction's width, else 1."""
        return int(self.values.shape[1]) if len(self.values.shape) > 1 else 1

    def valid_mask(self) -> np.ndarray:
        """bool (n,) validity on the host."""
        if self.mask is None:
            return np.ones(len(self), dtype=bool)
        return _host(self.mask).astype(bool, copy=False)

    def host_values(self) -> np.ndarray:
        """The values as a numpy array."""
        return _host(self.values)

    @staticmethod
    def of_values(feature_type: Type[FeatureType], raw: Sequence[Any]
                  ) -> "Column":
        """A host column from python values, None or NaN missing (the JAX
        package's ``Column.of_values``)."""
        kind = feature_type.column_kind
        n = len(raw)
        if kind in ("real", "binary", "integral", "date"):
            missing = [_is_missing_scalar(v) for v in raw]
            mask = np.array([not m for m in missing], dtype=bool)
            if kind == "real":
                vals = np.array([0.0 if m else float(v)
                                 for v, m in zip(raw, missing)], np.float32)
            elif kind == "binary":
                vals = np.array([0.0 if m else float(bool(v))
                                 for v, m in zip(raw, missing)], np.float32)
            else:
                vals = np.array([0 if m else int(v)
                                 for v, m in zip(raw, missing)], np.int64)
            return Column(feature_type, vals, mask)
        if kind == "vector":
            vals = (np.stack([np.asarray([] if v is None else v,
                                         dtype=np.float32) for v in raw])
                    if n else np.zeros((0, 0), dtype=np.float32))
            return Column(feature_type, vals, None)
        if kind == "prediction":
            keys = sorted({k for d in raw if d is not None for k in d})
            vals = np.array([[float(d.get(k, 0.0)) for k in keys]
                             if d is not None else [0.0] * len(keys)
                             for d in raw], np.float32).reshape(n, len(keys))
            return Column(feature_type, vals, None, {"keys": tuple(keys)})
        arr = np.empty(n, dtype=object)
        for i, v in enumerate(raw):
            arr[i] = v
        mask = np.array([not _is_missing(v) for v in raw], dtype=bool)
        return Column(feature_type, arr, mask)

    def take(self, idx) -> "Column":
        """Rows ``idx`` (host ints) of the column, on its own device."""
        def pick(a):
            if isinstance(a, torch.Tensor):
                return a[torch.as_tensor(idx, device=a.device)]
            return np.asarray(a)[idx]
        return replace(self, values=pick(self.values),
                       mask=None if self.mask is None else pick(self.mask))

    def to_host(self) -> "Column":
        def host(a):
            return a.cpu().numpy() if isinstance(a, torch.Tensor) else a
        return replace(self, values=host(self.values),
                       mask=None if self.mask is None else host(self.mask))


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _is_missing_scalar(v: Any) -> bool:
    return v is None or (isinstance(v, float) and np.isnan(v))


def _is_missing(v: Any) -> bool:
    if _is_missing_scalar(v):
        return True
    return isinstance(v, (list, set, dict, tuple)) and len(v) == 0


def column_of_scalars(feature_type: Type[FeatureType], raw) -> Column:
    """A 'real', 'binary', 'integral' or 'date' host column from a numeric
    sequence: NaN is missing and its slot holds 0 (the JAX package's
    ``column_of_scalars``: binary tests != 0, integral and date truncate
    toward zero). Raises TypeError on values that are not numbers."""
    kind = feature_type.column_kind
    if kind not in ("real", "binary", "integral", "date"):
        raise TypeError(f"{feature_type.__name__} is not a numeric scalar "
                        f"type")
    try:
        vals = np.asarray(raw, dtype=np.float64)
    except (TypeError, ValueError) as e:
        raise TypeError(f"{feature_type.__name__} column is not numeric: "
                        f"{e}") from e
    if vals.ndim != 1:
        raise ValueError(f"{feature_type.__name__} column must be 1-D, got "
                         f"shape {vals.shape}")
    mask = ~np.isnan(vals)
    filled = np.where(mask, vals, 0.0)
    if kind == "real":
        return Column(feature_type, filled.astype(np.float32), mask)
    if kind == "binary":
        return Column(feature_type, (filled != 0.0).astype(np.float32), mask)
    with np.errstate(invalid="ignore"):
        return Column(feature_type, filled.astype(np.int64), mask)


class FeatureTable:
    """Columnar table: name -> Column, all of ``num_rows`` rows, with an
    optional row key (a host array, e.g. a reader's ``key_field``) and the
    device its numeric columns live on (None until ``to_device``)."""

    #: the key column's name in a written score table
    KEY = "key"

    def __init__(self, columns: Dict[str, Column], num_rows: int,
                 key: Optional[np.ndarray] = None,
                 device: Optional[torch.device] = None):
        self._columns = dict(columns)
        self.num_rows = num_rows
        self.key = key
        self.device = device
        for name, col in self._columns.items():
            if len(col) != num_rows:
                raise ValueError(
                    f"column '{name}' has {len(col)} rows, table has "
                    f"{num_rows}")

    def __getitem__(self, name: str) -> Column:
        return self._columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self._columns

    @property
    def column_names(self) -> List[str]:
        return list(self._columns)

    def __len__(self) -> int:
        return self.num_rows

    def with_column(self, name: str, col: Column) -> "FeatureTable":
        cols = dict(self._columns)
        cols[name] = col
        return FeatureTable(cols, self.num_rows, self.key, self.device)

    def select(self, names: Sequence[str]) -> "FeatureTable":
        """The table of the columns ``names``."""
        return FeatureTable({n: self._columns[n] for n in names},
                            self.num_rows, self.key, self.device)

    def row(self, i: int) -> Dict[str, Any]:
        """Row ``i`` as python values, None where a column is missing."""
        out: Dict[str, Any] = {}
        for name, col in self._columns.items():
            if not col.valid_mask()[i]:
                out[name] = None
                continue
            v = col.host_values()[i]
            out[name] = v.tolist() if isinstance(v, np.ndarray) else (
                v.item() if isinstance(v, np.generic) else v)
        return out

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for i in range(self.num_rows):
            yield self.row(i)

    @staticmethod
    def from_columns(data: Mapping[str, Tuple[Type[FeatureType],
                                              Sequence[Any]]],
                     key: Optional[Sequence[str]] = None) -> "FeatureTable":
        """A host table of {name: (feature type, python values)}."""
        cols = {name: Column.of_values(ft, vals)
                for name, (ft, vals) in data.items()}
        n = len(next(iter(cols.values()))) if cols else 0
        return FeatureTable(cols, n, None if key is None
                            else np.asarray(key, dtype=object))

    def drop(self, names) -> "FeatureTable":
        """The table without the columns ``names``."""
        gone = set(names)
        return FeatureTable({n: c for n, c in self._columns.items()
                             if n not in gone}, self.num_rows, self.key,
                            self.device)

    def take(self, idx) -> "FeatureTable":
        """Rows ``idx`` of every column."""
        idx = np.asarray(idx, dtype=np.int64)
        key = None if self.key is None else self.key[idx]
        return FeatureTable({n: c.take(idx) for n, c in self._columns.items()},
                            int(idx.shape[0]), key, self.device)

    def on_device(self, values: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the table's device (the CPU for a
        host table)."""
        return torch.as_tensor(values, device=self.device or "cpu")

    def to_device(self, device) -> "FeatureTable":
        """Move every numeric host column onto ``device``: the values pack
        into one block per dtype and the masks into one bool block, each
        block is copied once, and the columns become views of the copies.
        Host kinds stay on the host; the table records ``device``."""
        device = torch.device(device)
        todo = [(n, c) for n, c in self._columns.items()
                if c.kind in DEVICE_KINDS and isinstance(c.values, np.ndarray)]
        by_dtype: Dict[str, List[Tuple[str, np.ndarray]]] = {}
        masked: List[Tuple[str, np.ndarray]] = []
        for n, c in todo:
            by_dtype.setdefault(str(c.values.dtype), []).append(
                (n, np.ascontiguousarray(c.values).reshape(-1)))
            if c.mask is not None:
                masked.append((n, np.asarray(c.mask, dtype=bool)))
        flat = {dt: torch.from_numpy(np.concatenate([v for _, v in parts]))
                .to(device) for dt, parts in by_dtype.items()}
        mask_at: Dict[str, torch.Tensor] = {}
        if masked:
            mdev = torch.from_numpy(
                np.concatenate([m for _, m in masked])).to(device)
            off = 0
            for n, m in masked:
                mask_at[n] = mdev[off:off + m.shape[0]]
                off += m.shape[0]
        offs = {dt: 0 for dt in flat}
        cols: Dict[str, Column] = {}
        for n, c in self._columns.items():
            if c.kind not in DEVICE_KINDS:
                cols[n] = c
            elif isinstance(c.values, np.ndarray):
                dt = str(c.values.dtype)
                size = int(c.values.size)
                vals = flat[dt][offs[dt]:offs[dt] + size].view(c.values.shape)
                offs[dt] += size
                cols[n] = replace(c, values=vals, mask=mask_at.get(n))
            else:
                mask = None if c.mask is None else c.mask.to(device)
                cols[n] = replace(c, values=c.values.to(device), mask=mask)
        return FeatureTable(cols, self.num_rows, self.key, device)
