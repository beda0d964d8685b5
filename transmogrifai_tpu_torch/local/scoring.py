"""Serve-time scoring of a fitted model (counterpart of
``transmogrifai_tpu.local.scoring``).

Both scorers build a host table from request rows (each raw feature's
extract function on each row, the label's too; numbers converted in one
sweep, other types as the JAX package's ``Column.of_values`` converts
python values), score it on the model's device through the same columnar
pass as ``OpWorkflowModel.score``, and hand back plain python records: a
Prediction as ``{key: float}``.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Sequence

import numpy as np

from ..table import Column, FeatureTable, column_of_scalars

logger = logging.getLogger(__name__)

#: per-row error key of micro-batch quarantine: the row could not be
#: scored, its result features are None and this key says why
SCORE_ERROR_KEY = "__score_error__"


class ScoreSchemaError(ValueError):
    """A request does not fit the model's raw schema."""


def _table_fn(model) -> Callable[[Sequence[Dict[str, Any]]], FeatureTable]:
    # every raw feature, the label too, as the JAX package's row scorer
    # extracts them: a request without the label gives a missing value,
    # which a fitted stage of the label (an indexer) reads as the JAX
    # package's does; the model's predictors never read it
    raw = list(model.raw_features)

    def build(rows: Sequence[Dict[str, Any]]) -> FeatureTable:
        cols = {}
        for f in raw:
            vals = [f.origin_stage.extract(r) for r in rows]
            try:
                if f.feature_type.column_kind in ("real", "binary",
                                                  "integral", "date"):
                    cols[f.name] = column_of_scalars(
                        f.feature_type, [np.nan if v is None else v
                                         for v in vals])
                else:
                    cols[f.name] = Column.of_values(f.feature_type, vals)
            except (TypeError, ValueError) as e:
                raise ScoreSchemaError(
                    f"raw feature '{f.name}' ({f.type_name}): value does not "
                    f"conform to the fitted schema ({e})") from e
        return FeatureTable(cols, len(rows))

    return build


def _records_fn(model) -> Callable[[FeatureTable], List[Dict[str, Any]]]:
    results = model.result_features

    def records(scored: FeatureTable) -> List[Dict[str, Any]]:
        per_col = []
        for f in results:
            col = scored[f.name].to_host()
            vals = np.asarray(col.values).tolist()
            masks = None if col.mask is None else np.asarray(col.mask).tolist()
            keys = col.metadata.get("keys") if col.kind == "prediction" \
                else None
            per_col.append((f.name, vals, masks, keys))
        out = []
        for i in range(scored.num_rows):
            rec: Dict[str, Any] = {}
            for name, vals, masks, keys in per_col:
                if masks is not None and not masks[i]:
                    rec[name] = None
                elif keys is not None:
                    rec[name] = dict(zip(keys, vals[i]))
                else:
                    rec[name] = vals[i]
            out.append(rec)
        return out

    return records


def micro_batch_score_function(model) -> Callable[[Sequence[Dict[str, Any]]],
                                                  List[Dict[str, Any]]]:
    """``fn(rows) -> [record]``: one columnar pass per batch of rows.

    A batch that fails the schema check is scored row by row, and only the
    rows that still fail are quarantined: their result features are None
    and :data:`SCORE_ERROR_KEY` carries the reason."""
    build = _table_fn(model)
    records = _records_fn(model)

    def score(rows: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
        try:
            return records(model.score(table=build(rows)))
        except ScoreSchemaError as batch_err:
            out = []
            for row in rows:
                try:
                    out.extend(records(model.score(table=build([row]))))
                except ScoreSchemaError as e:
                    rec = {f.name: None for f in model.result_features}
                    rec[SCORE_ERROR_KEY] = str(e)
                    out.append(rec)
            logger.warning("micro-batch scoring quarantined %d of %d rows "
                           "(first error: %s)",
                           sum(SCORE_ERROR_KEY in r for r in out), len(rows),
                           batch_err)
            return out

    return score


def score_function(model) -> Callable[[Dict[str, Any]], Dict[str, Any]]:
    """``fn(row) -> {result feature name: value}`` for one request row
    (raw feature names -> python values, None = missing)."""
    build = _table_fn(model)
    records = _records_fn(model)

    def score(row: Dict[str, Any]) -> Dict[str, Any]:
        return records(model.score(table=build([row])))[0]

    return score
