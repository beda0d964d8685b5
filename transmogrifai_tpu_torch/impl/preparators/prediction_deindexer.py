"""PredictionDeIndexer (counterpart of
``transmogrifai_tpu.impl.preparators.prediction_deindexer``): an indexed
prediction back to its label's string. It reads the labels from the
indexed response column's metadata (``OpStringIndexerModel`` puts them
there) at fit; a prediction out of range is ``unseen_name``."""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ...stages.base import AllowLabelAsInput, Estimator, Transformer
from ...table import Column, FeatureTable
from ...types import RealNN, Text


class PredictionDeIndexer(AllowLabelAsInput, Estimator):
    """(indexed response, indexed prediction) -> Text."""

    input_types = (RealNN, RealNN)
    output_type = Text

    def __init__(self, unseen_name: str = "UnseenLabel", uid=None):
        super().__init__("idx2str", uid)
        self.unseen_name = unseen_name

    def fit(self, table: FeatureTable) -> Transformer:
        resp_f = self.input_features[0]
        labels = table[resp_f.name].metadata.get("labels")
        if labels is None:
            # the fitted indexer's own summary
            origin = getattr(resp_f, "origin_stage", None)
            labels = getattr(origin, "summary_metadata", {}).get("labels") \
                if origin is not None else None
        if labels is None:
            raise ValueError(
                f"the feature {resp_f.name!r} does not carry any label/index "
                f"mapping in its metadata — index it with OpStringIndexer "
                f"first")
        labels = ["null" if t is None else t for t in labels]
        model = PredictionDeIndexerModel(labels=labels,
                                         unseen_name=self.unseen_name)
        model.summary_metadata = {"labels": list(labels)}
        return self._finalize_model(model)


class PredictionDeIndexerModel(AllowLabelAsInput, Transformer):
    output_type = Text

    def __init__(self, labels: List[str], unseen_name: str = "UnseenLabel",
                 uid=None):
        super().__init__("idx2str", uid)
        self.labels = list(labels)
        self.unseen_name = unseen_name

    def _decode(self, v: Optional[float]) -> str:
        if v is None or (isinstance(v, float) and np.isnan(v)):
            return self.unseen_name
        # rounded, not truncated: 1.9999999 is 2, and -0.6 is out of range
        i = int(round(float(v)))
        return self.labels[i] if 0 <= i < len(self.labels) \
            else self.unseen_name

    def transform_column(self, table: FeatureTable) -> Column:
        col = table[self.input_features[1].name]
        raw = col.host_values().astype(np.float64).reshape(-1)
        valid = col.valid_mask()
        return Column.of_values(Text, [
            self._decode(float(raw[i]) if valid[i] else None)
            for i in range(len(raw))])

    def transform_row(self, row: Dict[str, Any]) -> Any:
        return self._decode(row.get(self.input_features[1].name))
