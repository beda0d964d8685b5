"""FeatureTable: the columnar table the port scores (counterpart of
``transmogrifai_tpu.table``).

Host columns are numpy arrays. ``FeatureTable.to_device`` moves the numeric
columns onto a torch device with one host-to-device copy per dtype (plus one
for all validity masks); stages then compute on those tensors and emit
tensor columns on the same device.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Mapping, Optional, Tuple, Type

import numpy as np
import torch

from .types import FeatureType

#: column kinds whose values are numeric arrays that move to the device
DEVICE_KINDS = frozenset({"real", "vector", "prediction"})


@dataclass(frozen=True)
class Column:
    """One feature column.

    values: float32 (n,) for 'real' (invalid slots hold 0.0), float32 (n, d)
    for 'vector', float32 (n, k) for 'prediction' (key order in
    ``metadata['keys']``); a numpy array on the host or a tensor on a device.
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


def column_of_scalars(feature_type: Type[FeatureType], raw) -> Column:
    """A 'real' host column from a numeric sequence: NaN is missing and its
    slot holds 0.0 (the JAX package's ``column_of_scalars``)."""
    try:
        vals = np.asarray(raw, dtype=np.float64)
    except (TypeError, ValueError) as e:
        raise TypeError(f"{feature_type.__name__} column is not numeric: "
                        f"{e}") from e
    if vals.ndim != 1:
        raise ValueError(f"{feature_type.__name__} column must be 1-D, got "
                         f"shape {vals.shape}")
    mask = ~np.isnan(vals)
    return Column(feature_type, np.where(mask, vals, 0.0).astype(np.float32),
                  mask)


class FeatureTable:
    """Columnar table: name -> Column, all of ``num_rows`` rows."""

    def __init__(self, columns: Dict[str, Column], num_rows: int):
        self._columns = dict(columns)
        self.num_rows = num_rows
        for name, col in self._columns.items():
            if len(col) != num_rows:
                raise ValueError(
                    f"column '{name}' has {len(col)} rows, table has "
                    f"{num_rows}")

    def __getitem__(self, name: str) -> Column:
        return self._columns[name]

    @property
    def column_names(self) -> List[str]:
        return list(self._columns)

    def __len__(self) -> int:
        return self.num_rows

    def with_column(self, name: str, col: Column) -> "FeatureTable":
        cols = dict(self._columns)
        cols[name] = col
        return FeatureTable(cols, self.num_rows)

    def take(self, idx) -> "FeatureTable":
        """Rows ``idx`` of every column."""
        idx = np.asarray(idx, dtype=np.int64)
        return FeatureTable({n: c.take(idx) for n, c in self._columns.items()},
                            int(idx.shape[0]))

    def to_device(self, device) -> "FeatureTable":
        """Move every numeric host column onto ``device``: the values pack
        into one block per dtype and the masks into one bool block, each
        block is copied once, and the columns become views of the copies."""
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
        return FeatureTable(cols, self.num_rows)
