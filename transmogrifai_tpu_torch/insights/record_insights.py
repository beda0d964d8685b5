"""Per-record explanations (counterpart of
``transmogrifai_tpu.insights.record_insights``): leave-one-covariate-out
(LOCO) and correlation insights, each a TextMap column of
``{column name: contribution}`` holding a row's top k.

``RecordInsightsLOCO`` runs on the table's device: the vector is there
(a host table's, such as the row dual's, is copied once to the model's
device), the zeroed variants
``X[None] * keep[:, None, :]`` are built there in (group x row) blocks of
at most ``VARIANT_BLOCK_BYTES``, each block is scored by the winner's
``predict_parts`` (a forest winner runs its predict kernel on the
block's rows), and only the ``(g, n)`` score differences come back to the
host. A metadata group (a text or date feature's sibling slots) is zeroed
together.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..stages.base import AllowLabelAsInput, Transformer
from ..table import Column, FeatureTable
from ..types import OPVector, TextMap
from ..vector_metadata import VectorMetadata


class TopKMaps:
    """Lazy array of per-row ``{column name: contribution}`` dicts.

    The top-k assembly is fully vectorized (argsort + take_along_axis on the
    whole batch); Python dicts materialize only on element ACCESS. At the
    1M-row scale the batched device scoring already handles, building a dict
    per row eagerly was the dominant serve-path cost (reference analog
    RecordInsightsLOCO.scala:61-97 builds per-row maps inside a Spark UDF —
    a row-at-a-time design this columnar layout replaces).

    names: group/column name vocabulary; idx: (n, k) int indices into it,
    -1 = unused slot; vals: (n, k) contribution values, slot order =
    descending |contribution| (dict insertion order preserves it).
    """

    def __init__(self, names: Sequence[str], idx: np.ndarray,
                 vals: np.ndarray):
        self._names = list(names)
        self._idx = idx
        self._vals = vals
        self._dense: Optional[np.ndarray] = None
        self.ndim = 1
        self.dtype = np.dtype(object)

    @property
    def shape(self):
        return (self._idx.shape[0],)

    def __len__(self) -> int:
        return int(self._idx.shape[0])

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            return {self._names[j]: float(v)
                    for j, v in zip(self._idx[i], self._vals[i]) if j >= 0}
        return TopKMaps(self._names, self._idx[i], self._vals[i])

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __array__(self, dtype=None, copy=None):
        # cached: consumers like np.asarray(col.values)[i] inside per-row
        # loops must not re-materialize the whole column per row
        if self._dense is None:
            out = np.empty(len(self), dtype=object)
            for i in range(len(self)):
                out[i] = self[i]
            self._dense = out
        return self._dense

    def tolist(self) -> List[Dict[str, float]]:
        return list(self)

    def any_mask(self) -> np.ndarray:
        """(n,) bool: row has at least one nonzero contribution."""
        return (self._idx >= 0).any(axis=1)


def _topk_maps_column(names: Sequence[str], contrib_rows: np.ndarray,
                      k: int) -> Column:
    """contrib_rows: (n, g) per-row contributions → TextMap column of lazy
    top-k dicts (vectorized: one argsort over the batch, no per-row loop)."""
    k = min(k, contrib_rows.shape[1])
    order = np.argsort(-np.abs(contrib_rows), axis=1)[:, :k]    # (n, k)
    vals = np.take_along_axis(contrib_rows, order, axis=1)      # (n, k)
    # filter on the RAW contribution (a tiny-but-nonzero slot stays in the
    # map, rounding to 0.0 in its value — the eager path's semantics), THEN
    # round for display
    idx = np.where(vals != 0.0, order, -1).astype(np.int32)
    vals = np.round(vals.astype(np.float64), 6)
    maps = TopKMaps(names, idx, vals)
    return Column(TextMap, maps, maps.any_mask())


def _score_of(parts: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A score a row, on the parts' device: P(class 1) for binary, the
    largest class probability for multiclass, the prediction for
    regression."""
    prob = parts.get("probability")
    if prob is not None and prob.ndim == 2 and prob.shape[1] >= 2:
        return prob[:, 1] if prob.shape[1] == 2 else prob.max(dim=1).values
    return parts["prediction"].reshape(-1)


def _model_device(fitted) -> torch.device:
    """The device of a fitted model's parameters (the CPU for none)."""
    for v in fitted.params.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def _vector_on_device(table: FeatureTable, col: Column,
                      fitted) -> torch.Tensor:
    """The vector column as float32 on the table's device, or for a host
    table (a row dual's) on the model's, in one copy."""
    if isinstance(col.values, torch.Tensor):
        return col.values.to(torch.float32)
    return torch.as_tensor(np.asarray(col.values, dtype=np.float32),
                           device=table.device or _model_device(fitted))


class RecordInsightsLOCO(AllowLabelAsInput, Transformer):
    """OPVector -> TextMap of {column group: score difference} a row.

    Built with the fitted ``SelectedModel`` (``model_stage``); its input
    is the feature vector the model scores (``set_input``).
    """

    input_types = (OPVector,)
    output_type = TextMap

    #: bytes of one float32 block of zeroed variants
    VARIANT_BLOCK_BYTES = 256 << 20

    def __init__(self, model_stage, top_k: int = 20, uid=None):
        super().__init__("loco", uid)
        self.model_stage = model_stage
        self.top_k = top_k

    def _groups(self, vm: Optional[VectorMetadata], d: int
                ) -> List[Tuple[str, List[int]]]:
        if vm is None:
            return [(f"c{i}", [i]) for i in range(d)]
        return [(group, list(idxs))
                for group, idxs in vm.index_of_group().items()]

    def diffs(self, table: FeatureTable) -> Tuple[List[str], np.ndarray]:
        """(group names, (g, n) float32 host array): each row's base score
        less its score with the group zeroed."""
        from ..models.api import MODEL_REGISTRY

        col = table[self.input_features[0].name]
        fitted = self.model_stage.fitted
        family = MODEL_REGISTRY[fitted.family]
        Xd = _vector_on_device(table, col, fitted)
        n, d = Xd.shape
        vm = col.metadata.get("vector_meta")
        if vm is not None:
            self._vm = vm          # kept for the metadata-less row dual
        elif getattr(self, "_vm", None) is not None and self._vm.size == d:
            vm = self._vm
        groups = self._groups(vm, d)
        g = len(groups)
        base = _score_of(family.predict_parts(fitted, Xd))
        keep = np.ones((g, d), np.float32)
        for v, (_, idxs) in enumerate(groups):
            keep[v, idxs] = 0.0
        keep_d = torch.as_tensor(keep, device=Xd.device)
        rows_per_block = max(1, int(self.VARIANT_BLOCK_BYTES // (4 * d)))
        gc = max(1, min(g, rows_per_block // max(n, 1)) or 1)
        rc = min(n, rows_per_block)
        self._peak_variant_bytes = 0
        out = torch.empty((g, n), dtype=torch.float32, device=Xd.device)
        for g0 in range(0, g, gc):
            g1 = min(g0 + gc, g)
            for r0 in range(0, n, rc):
                r1 = min(r0 + rc, n)
                gb, rb = g1 - g0, r1 - r0
                block = Xd[None, r0:r1, :] * keep_d[g0:g1, None, :]
                self._peak_variant_bytes = max(self._peak_variant_bytes,
                                               4 * gb * rb * d)
                s = _score_of(family.predict_parts(
                    fitted, block.reshape(gb * rb, d)))
                out[g0:g1, r0:r1] = base[None, r0:r1] - s.reshape(gb, rb)
        return [name for name, _ in groups], out.cpu().numpy()

    def transform_column(self, table: FeatureTable) -> Column:
        names, diffs = self.diffs(table)
        return _topk_maps_column(names, diffs.T, self.top_k)

    def transform_row(self, row: Dict[str, Any]) -> Any:
        one = FeatureTable(
            {f.name: Column.of_values(f.feature_type, [row.get(f.name)])
             for f in self.input_features}, 1)
        return self.transform_column(one).values[0]


class RecordInsightsCorr(AllowLabelAsInput, Transformer):
    """OPVector -> TextMap of {column: standardized value x the column's
    correlation with the model's score over the batch}."""

    input_types = (OPVector,)
    output_type = TextMap

    def __init__(self, model_stage, top_k: int = 20, uid=None):
        super().__init__("recordInsightsCorr", uid)
        self.model_stage = model_stage
        self.top_k = top_k

    def transform_column(self, table: FeatureTable) -> Column:
        from ..models.api import MODEL_REGISTRY
        from ..ops.stats import pearson_correlation

        col = table[self.input_features[0].name]
        fitted = self.model_stage.fitted
        Xd = _vector_on_device(table, col, fitted)
        n, d = Xd.shape
        vm = col.metadata.get("vector_meta")
        names = (vm.column_names() if vm is not None
                 else [f"c{i}" for i in range(d)])
        score = _score_of(MODEL_REGISTRY[fitted.family].predict_parts(
            fitted, Xd))
        corr = np.nan_to_num(pearson_correlation(Xd, score).cpu().numpy())
        X = Xd.cpu().numpy()
        mean = X.mean(axis=0)
        std = X.std(axis=0)
        std[std == 0] = 1.0
        contrib = ((X - mean) / std) * corr[None, :]
        return _topk_maps_column(names, contrib, self.top_k)

    def transform_row(self, row: Dict[str, Any]) -> Any:
        raise ValueError(
            "RecordInsightsCorr needs a scoring batch to estimate "
            "correlations; use the columnar path")
