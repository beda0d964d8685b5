"""Label indexers (counterpart of the indexers of
``transmogrifai_tpu.impl.feature.text``): a text label to its index by
frequency, and an index back to its label. The language, MIME, entity and
phone stages, word2vec, LDA and the stemmers of that module are not ported
yet.

The labels are counted on the host; an indexed column is a RealNN column
on the table's device that carries its labels in its metadata
(``labels``), where ``PredictionDeIndexer`` reads them.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import List, Optional, Sequence

import numpy as np

from ...stages.base import Estimator, Transformer, _placed
from ...table import Column, FeatureTable
from ...types import RealNN, Text


class OpStringIndexer(Estimator):
    """Text -> RealNN: each label's index by frequency, ties by label.
    ``handle_invalid`` says what a label unseen at fit becomes: 'keep'
    the index ``len(labels)``, 'skip' missing, 'error' an error; a missing
    value indexes as the empty string."""

    input_types = (Text,)
    output_type = RealNN

    #: the NoFilter variant counts missing values as a label of their own
    count_nulls = False

    def __init__(self, handle_invalid: str = "keep", uid=None):
        super().__init__("strIdx", uid)
        if handle_invalid not in ("error", "skip", "keep"):
            raise ValueError("handle_invalid must be error|skip|keep")
        self.handle_invalid = handle_invalid

    def fit(self, table: FeatureTable) -> Transformer:
        col = table[self.input_features[0].name]
        vals, valid = col.host_values(), col.valid_mask()
        if self.count_nulls:
            cnt = Counter(str(vals[i]) if valid[i] else None
                          for i in range(len(col)))
        else:
            cnt = Counter(str(vals[i]) for i in range(len(col)) if valid[i])
        # by count, then a missing label before any string, then the string
        labels = sorted(cnt, key=lambda t: (-cnt[t], t is not None, t or ""))
        model = OpStringIndexerModel(labels=labels,
                                     handle_invalid=self.handle_invalid)
        model.summary_metadata = {"labels": labels}
        return self._finalize_model(model)


class OpStringIndexerModel(Transformer):
    output_type = RealNN

    def __init__(self, labels: List[Optional[str]], handle_invalid: str,
                 uid=None):
        super().__init__("strIdx", uid)
        self.labels = labels
        self.handle_invalid = handle_invalid
        #: the NoFilter variant: a missing value unseen at fit takes the
        #: unseen index instead of the empty string's
        self.null_to_unseen = False
        self._label_index = {t: i for i, t in enumerate(labels)}

    def _index(self, v: Optional[str]) -> Optional[float]:
        index = self._label_index
        if v is None:
            if None in index:
                return float(index[None])
            if self.null_to_unseen:
                return float(len(self.labels))
            v = ""
        j = index.get(str(v))
        if j is not None:
            return float(j)
        if self.handle_invalid == "keep":
            return float(len(self.labels))
        if self.handle_invalid == "skip":
            return None
        raise ValueError(f"unseen label {v!r}")

    def rendered_labels(self) -> List[str]:
        """The labels with a missing label written 'null'."""
        return ["null" if t is None else t for t in self.labels]

    def transform_column(self, table: FeatureTable) -> Column:
        col = table[self.input_features[0].name]
        vals, valid = col.host_values(), col.valid_mask()
        out = Column.of_values(RealNN, [
            self._index(vals[i] if valid[i] else None)
            for i in range(len(col))])
        return _placed(table, dataclasses.replace(
            out, metadata={"labels": self.rendered_labels()}))

    def transform_fn(self, v):
        return self._index(v)


#: the NoFilter indexers' name of a label unseen at fit
UNSEEN_LABEL = "UnseenLabel"


class OpStringIndexerNoFilter(OpStringIndexer):
    """Text -> RealNN that never drops a row: a missing value seen at fit
    is a label of its own (written 'null'), and anything unseen at fit
    takes the index ``len(labels)``, named ``unseen_name``."""

    count_nulls = True

    def __init__(self, unseen_name: str = UNSEEN_LABEL, uid=None):
        super().__init__(handle_invalid="keep", uid=uid)
        self.unseen_name = unseen_name

    def fit(self, table: FeatureTable) -> Transformer:
        model = super().fit(table)
        model.null_to_unseen = True
        model.summary_metadata = {
            "labels": model.rendered_labels() + [self.unseen_name],
            "unseenName": self.unseen_name,
        }
        return model


class OpIndexToString(Transformer):
    """RealNN index -> Text label; an index out of range is missing."""

    input_types = (RealNN,)
    output_type = Text

    def __init__(self, labels: Sequence[Optional[str]], uid=None):
        super().__init__("idxToStr", uid)
        self.labels = ["null" if t is None else t for t in labels]

    def transform_column(self, table: FeatureTable) -> Column:
        col = table[self.input_features[0].name]
        idx = col.host_values().astype(np.int64).reshape(-1)
        return Column.of_values(Text, [
            self.labels[v] if 0 <= v < len(self.labels) else None
            for v in idx])

    def transform_fn(self, v):
        i = int(v) if v is not None else -1
        return self.labels[i] if 0 <= i < len(self.labels) else None


class OpIndexToStringNoFilter(OpIndexToString):
    """RealNN index -> Text label; a missing or out-of-range index is
    ``unseen_name``."""

    def __init__(self, labels: Sequence[Optional[str]],
                 unseen_name: str = UNSEEN_LABEL, uid=None):
        super().__init__(labels, uid=uid)
        self.unseen_name = unseen_name

    def _label(self, v) -> str:
        if v is None or (isinstance(v, float) and np.isnan(v)):
            return self.unseen_name
        i = int(v)
        return self.labels[i] if 0 <= i < len(self.labels) \
            else self.unseen_name

    def transform_column(self, table: FeatureTable) -> Column:
        col = table[self.input_features[0].name]
        raw = col.host_values().astype(np.float64).reshape(-1)
        valid = col.valid_mask()
        return Column.of_values(Text, [
            self._label(float(raw[i]) if valid[i] else None)
            for i in range(len(raw))])

    def transform_fn(self, v):
        return self._label(v)
