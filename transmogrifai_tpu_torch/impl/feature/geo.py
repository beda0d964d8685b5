"""Geolocation vectorizers (counterpart of
``transmogrifai_tpu.impl.feature.geo``): a geolocation is [latitude,
longitude, accuracy]; the fit takes the geographic midpoint of the present
values (and their mean accuracy) as the fill, and the model emits the
triple with a null indicator.

The fills are fitted in float64 numpy and the blocks built on the host
with the JAX package's calls, then copied to the table's device once, so
both are bit-equal to the JAX package's.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...stages.base import Estimator, Transformer
from ...table import Column, FeatureTable
from ...types import OPVector
from ...vector_metadata import NULL_INDICATOR, VectorColumnMetadata
from .vectorizers import TransmogrifierDefaults, _emit_host, _map_rows

_GEO_NAMES = ("lat", "lon", "accuracy")


def geographic_midpoint(latlon: np.ndarray) -> Tuple[float, float]:
    """(lat, lon) in degrees of the mean of the points' 3-D unit vectors,
    (0, 0) where that mean is the origin."""
    lat = np.radians(latlon[:, 0])
    lon = np.radians(latlon[:, 1])
    x = np.cos(lat) * np.cos(lon)
    y = np.cos(lat) * np.sin(lon)
    z = np.sin(lat)
    xm, ym, zm = x.mean(), y.mean(), z.mean()
    hyp = np.hypot(xm, ym)
    if hyp < 1e-12 and abs(zm) < 1e-12:
        return 0.0, 0.0
    return (float(np.degrees(np.arctan2(zm, hyp))),
            float(np.degrees(np.arctan2(ym, xm))))


def _fill_of(points: Sequence[Sequence[float]]) -> List[float]:
    """[midpoint lat, midpoint lon, mean accuracy] of present points."""
    pts = np.array([[p[0], p[1]] for p in points], dtype=np.float64)
    lat, lon = geographic_midpoint(pts)
    acc = float(np.mean([p[2] if len(p) > 2 else 0.0 for p in points]))
    return [lat, lon, acc]


def _geo_rows(col: Column) -> List[Optional[List[float]]]:
    """Each row's geolocation, None where missing or shorter than two."""
    vals, valid = col.host_values(), col.valid_mask()
    out: List[Optional[List[float]]] = []
    for i in range(len(col)):
        v = vals[i] if valid[i] else None
        out.append(list(v) if v is not None and len(v) >= 2 else None)
    return out


def _geo_block(points: Sequence[Optional[Sequence[float]]],
               fill: Sequence[float], track_nulls: bool) -> np.ndarray:
    """(n, 3 or 4) float32: each point, or ``fill`` and a null flag."""
    block = np.zeros((len(points), 3 + (1 if track_nulls else 0)),
                     dtype=np.float32)
    for i, r in enumerate(points):
        if r is None:
            block[i, :3] = fill
            if track_nulls:
                block[i, 3] = 1.0
        else:
            block[i, 0], block[i, 1] = float(r[0]), float(r[1])
            block[i, 2] = float(r[2]) if len(r) > 2 else 0.0
    return block


def _geo_meta(f, grouping: str, track_nulls: bool
              ) -> List[VectorColumnMetadata]:
    meta = [VectorColumnMetadata(f.name, f.type_name, grouping, None,
                                 descriptor_value=g) for g in _GEO_NAMES]
    if track_nulls:
        meta.append(VectorColumnMetadata(f.name, f.type_name, grouping,
                                         NULL_INDICATOR))
    return meta


class GeolocationVectorizer(Estimator):
    """Seq[Geolocation] -> OPVector: the triple, missing ones filled with
    the midpoint (or zeros), and a null indicator."""

    output_type = OPVector

    def __init__(self, fill_with_mean: bool = True,
                 track_nulls: bool = TransmogrifierDefaults.TrackNulls,
                 uid=None):
        super().__init__("vecGeo", uid)
        self.fill_with_mean = fill_with_mean
        self.track_nulls = track_nulls

    def fit(self, table: FeatureTable) -> Transformer:
        fills: List[List[float]] = []
        for f in self.input_features:
            rows = [r for r in _geo_rows(table[f.name]) if r is not None]
            fills.append(_fill_of(rows) if self.fill_with_mean and rows
                         else [0.0, 0.0, 0.0])
        return self._finalize_model(GeolocationVectorizerModel(
            fills=fills, track_nulls=self.track_nulls))


class GeolocationVectorizerModel(Transformer):
    output_type = OPVector

    def __init__(self, fills: List[List[float]], track_nulls: bool,
                 uid=None):
        super().__init__("vecGeo", uid)
        self.fills = fills
        self.track_nulls = track_nulls

    def transform_column(self, table: FeatureTable) -> Column:
        blocks, meta = [], []
        for f, fill in zip(self.input_features, self.fills):
            blocks.append(_geo_block(_geo_rows(table[f.name]), fill,
                                     self.track_nulls))
            meta.extend(_geo_meta(f, f.name, self.track_nulls))
        return _emit_host(self, table, np.concatenate(blocks, axis=1), meta)


class GeolocationMapVectorizer(Estimator):
    """Seq[GeolocationMap] -> OPVector: per key the triple, missing ones
    filled with that key's midpoint, and a null indicator."""

    output_type = OPVector

    def __init__(self, track_nulls: bool = TransmogrifierDefaults.TrackNulls,
                 uid=None):
        super().__init__("vecGeoMap", uid)
        self.track_nulls = track_nulls

    def fit(self, table: FeatureTable) -> Transformer:
        all_keys: List[List[str]] = []
        fills: List[Dict[str, List[float]]] = []
        for f in self.input_features:
            per_key: Dict[str, List[List[float]]] = {}
            for r in _map_rows(table[f.name]):
                if not r:
                    continue
                for k, v in r.items():
                    if v is not None and len(v) >= 2:
                        per_key.setdefault(str(k), []).append(list(v))
            keys = sorted(per_key)
            all_keys.append(keys)
            fills.append({k: _fill_of(per_key[k]) for k in keys})
        return self._finalize_model(GeolocationMapVectorizerModel(
            keys=all_keys, fills=fills, track_nulls=self.track_nulls))


class GeolocationMapVectorizerModel(Transformer):
    output_type = OPVector

    def __init__(self, keys: List[List[str]],
                 fills: List[Dict[str, List[float]]], track_nulls: bool,
                 uid=None):
        super().__init__("vecGeoMap", uid)
        self.keys = keys
        self.fills = fills
        self.track_nulls = track_nulls

    def transform_column(self, table: FeatureTable) -> Column:
        n = table.num_rows
        blocks, meta = [], []
        for f, keys, kf in zip(self.input_features, self.keys, self.fills):
            rows = _map_rows(table[f.name])
            for key in keys:
                pts = []
                for r in rows:
                    v = r.get(key) if r else None
                    pts.append(None if v is None or len(v) < 2 else v)
                blocks.append(_geo_block(pts, kf.get(key, [0.0, 0.0, 0.0]),
                                         self.track_nulls))
                meta.extend(_geo_meta(f, key, self.track_nulls))
        mat = (np.concatenate(blocks, axis=1) if blocks
               else np.zeros((n, 0), dtype=np.float32))
        return _emit_host(self, table, mat, meta)
