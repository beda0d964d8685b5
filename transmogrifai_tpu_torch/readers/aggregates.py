"""Aggregating, conditional and joined readers (counterpart of
``transmogrifai_tpu.readers.aggregates``).

``AggregateDataReader`` groups event records by key and folds each key's
events into one row with every raw feature's monoid
(``aggregators``): predictors over the events up to the cutoff,
responses over the events after it, each within its feature's window.
``ConditionalDataReader`` takes each key's cutoff from the time its
target condition fires. ``JoinedDataReader`` joins two readers' tables on
their keys. Aggregation is host work (string-keyed grouping); the table
it builds moves to the device like any other reader's.

The extract functions see the records ``Frame.records()`` gives, the
values pandas' ``to_dict("records")`` gives in the JAX package: an empty
numeric cell is NaN, an integer column with a gap is float (its key
``"123.0"``). Keys come out in ``sorted`` order (as strings); a join keeps
its left side's order.
"""
from __future__ import annotations

import random as _random
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..aggregators import CutOffTime, MonoidAggregator, default_aggregator
from ..features import Feature
from ..table import Column, FeatureTable
from .readers import Frame, Reader, _field_name_of


def _timestamp_getter(timestamp_field: Optional[str],
                      timestamp_fn: Optional[Callable[[Any], Optional[int]]]
                      ) -> Callable[[dict], Optional[int]]:
    if timestamp_fn is not None:
        return lambda r: timestamp_fn(r)
    if timestamp_field is not None:
        def get(r):
            v = r.get(timestamp_field)
            return None if v is None else int(v)
        return get
    return lambda r: None


class AggregateParams:
    """(reference AggregateParams: timeStampFn + cutOffTime)."""

    def __init__(self, cutoff: CutOffTime,
                 timestamp_field: Optional[str] = None,
                 timestamp_fn: Optional[Callable[[Any], Optional[int]]] = None):
        self.cutoff = cutoff
        self.timestamp = _timestamp_getter(timestamp_field, timestamp_fn)


def _aggregate_groups(groups: "Dict[str, List[Tuple[Optional[int], dict]]]",
                      raw_features: Sequence[Feature],
                      cutoff_of: Callable[[str], Optional[int]],
                      response_window_default: Optional[int] = None,
                      strict_predictor: bool = False,
                      ) -> FeatureTable:
    """Fold each key's time-sorted events into one row (reference
    FeatureAggregator.extract: predictors aggregate the trailing window
    (cutoff−window, cutoff]; responses the leading window
    (cutoff, cutoff+window]; windowless features take everything on their
    side of the cutoff). ``strict_predictor`` excludes events AT the cutoff
    from predictors — conditional readers use it so the condition-firing
    event itself is neither predictor nor response (reference
    ConditionalDataReader: predictors strictly before the target event)."""
    keys = sorted(groups)
    cols: Dict[str, Column] = {}
    for f in raw_features:
        gen = f.origin_stage
        agg: MonoidAggregator = gen.aggregator or default_aggregator(f.feature_type)
        window = gen.aggregate_window
        if f.is_response and window is None:
            window = response_window_default
        out_vals: List[Any] = []
        for k in keys:
            events = groups[k]   # sorted by time (None times first)
            cutoff = cutoff_of(k)
            vals = []
            for t, rec in events:
                if cutoff is not None:
                    if f.is_response:
                        if t is None or t <= cutoff:
                            continue
                        # leading window: (cutoff, cutoff + window]
                        if window is not None and t > cutoff + window:
                            continue
                    else:
                        if t is not None and (t > cutoff
                                              or (strict_predictor
                                                  and t == cutoff)):
                            continue
                        # trailing window is half-open: (cutoff-window, cutoff]
                        if (window is not None and t is not None
                                and t <= cutoff - window):
                            continue
                elif f.is_response:
                    pass  # no cutoff: responses aggregate over everything too
                vals.append(gen.extract(rec))
            out_vals.append(agg.aggregate(vals))
        cols[f.name] = Column.of_values(f.feature_type, out_vals)
    return FeatureTable(cols, len(keys),
                        np.array(keys, dtype=object) if keys else None)


def _group_records(frame: Frame, key_field: Optional[str],
                   key_fn: Optional[Callable[[Any], str]],
                   timestamp: Callable[[dict], Optional[int]],
                   ) -> "Dict[str, List[Tuple[Optional[int], dict]]]":
    records = frame.records()
    groups: Dict[str, List[Tuple[Optional[int], dict]]] = {}
    for r in records:
        if key_fn is not None:
            k = str(key_fn(r))
        elif key_field is not None:
            k = str(r.get(key_field))
        else:
            raise ValueError("aggregating readers need key_field or key_fn")
        groups.setdefault(k, []).append((timestamp(r), r))
    for k in groups:
        groups[k].sort(key=lambda tr: (tr[0] is not None, tr[0] or 0))
    return groups


class AggregateDataReader(Reader):
    """Event reader: one training row per key (reference
    AggregateDataReader, DataReader.scala:206-279)."""

    def __init__(self, inner: Reader, aggregate_params: AggregateParams,
                 key_field: Optional[str] = None,
                 key_fn: Optional[Callable[[Any], str]] = None):
        super().__init__(key_fn=key_fn, key_field=key_field or inner.key_field)
        self.inner = inner
        self.aggregate_params = aggregate_params

    def read(self) -> Frame:
        return self.inner.read()

    def generate_table(self, raw_features: Sequence[Feature],
                       require_response: bool = True) -> FeatureTable:
        """One row a key; responses aggregate whether or not they are
        required (a key without later events has them missing)."""
        ap = self.aggregate_params
        groups = _group_records(self.read(), self.key_field, self.key_fn,
                                ap.timestamp)
        cutoff = ap.cutoff.cutoff_ms
        return _aggregate_groups(groups, raw_features, lambda k: cutoff)


class ConditionalParams:
    """(reference ConditionalParams: targetCondition, timeStampToKeep,
    dropIfTargetConditionNotMet, response/predictor windows)."""

    def __init__(self, target_condition: Callable[[dict], bool],
                 timestamp_field: Optional[str] = None,
                 timestamp_fn: Optional[Callable[[Any], Optional[int]]] = None,
                 timestamp_to_keep: str = "min",
                 drop_if_target_condition_not_met: bool = True,
                 response_window: Optional[int] = None,
                 seed: int = 42):
        if timestamp_to_keep not in ("min", "max", "random"):
            raise ValueError("timestamp_to_keep must be min|max|random")
        self.target_condition = target_condition
        self.timestamp = _timestamp_getter(timestamp_field, timestamp_fn)
        self.timestamp_to_keep = timestamp_to_keep
        self.drop_if_target_condition_not_met = drop_if_target_condition_not_met
        #: default leading window for response features that set none
        #: (reference ConditionalParams.responseWindow)
        self.response_window = response_window
        self.seed = seed


class ConditionalDataReader(Reader):
    """Conditional-probability reader: per key, the cutoff is a time where
    ``target_condition`` fired; predictors aggregate before it, responses
    after (reference ConditionalDataReader, DataReader.scala:288-368)."""

    def __init__(self, inner: Reader, conditional_params: ConditionalParams,
                 key_field: Optional[str] = None,
                 key_fn: Optional[Callable[[Any], str]] = None):
        super().__init__(key_fn=key_fn, key_field=key_field or inner.key_field)
        self.inner = inner
        self.conditional_params = conditional_params

    def read(self) -> Frame:
        return self.inner.read()

    def generate_table(self, raw_features: Sequence[Feature],
                       require_response: bool = True) -> FeatureTable:
        cp = self.conditional_params
        groups = _group_records(self.read(), self.key_field, self.key_fn,
                                cp.timestamp)
        rng = _random.Random(cp.seed)
        cutoffs: Dict[str, Optional[int]] = {}
        for k, events in groups.items():
            fired = [t for t, r in events
                     if t is not None and cp.target_condition(r)]
            if not fired:
                cutoffs[k] = None
            elif cp.timestamp_to_keep == "min":
                cutoffs[k] = min(fired)
            elif cp.timestamp_to_keep == "max":
                cutoffs[k] = max(fired)
            else:
                cutoffs[k] = rng.choice(sorted(fired))
        if cp.drop_if_target_condition_not_met:
            groups = {k: v for k, v in groups.items() if cutoffs[k] is not None}
        return _aggregate_groups(
            groups, raw_features, lambda k: cutoffs[k],
            response_window_default=cp.response_window,
            strict_predictor=True)


class JoinedDataReader(Reader):
    """Typed join of two readers on their keys (reference
    JoinedDataReader.scala, JoinTypes.scala). Features are routed to the side
    whose frame carries their field (or via ``feature_sides``:
    {feature name: 'left'|'right'})."""

    def __init__(self, left: Reader, right: Reader, join_type: str = "inner",
                 feature_sides: Optional[Dict[str, str]] = None):
        super().__init__(key_field=left.key_field)
        if join_type not in ("inner", "left", "outer"):
            raise ValueError("join_type must be inner|left|outer")
        self.left = left
        self.right = right
        self.join_type = join_type
        self.feature_sides = dict(feature_sides or {})

    def read(self) -> Frame:
        return self.left.read()

    def _route(self, raw_features: Sequence[Feature]
               ) -> Tuple[List[Feature], List[Feature]]:
        lefts: List[Feature] = []
        rights: List[Feature] = []
        if all(f.name in self.feature_sides for f in raw_features):
            lcols = rcols = set()
        else:
            lcols = set(self.left.read().columns)
            rcols = set(self.right.read().columns)
        for f in raw_features:
            side = self.feature_sides.get(f.name)
            if side is None:
                field = _field_name_of(f.origin_stage.extract_fn)
                if field is not None and field in lcols:
                    side = "left"
                elif field is not None and field in rcols:
                    side = "right"
                else:
                    raise ValueError(
                        f"cannot route feature '{f.name}' to a join side; "
                        f"pass feature_sides")
            (lefts if side == "left" else rights).append(f)
        return lefts, rights

    def generate_table(self, raw_features: Sequence[Feature],
                       require_response: bool = True) -> FeatureTable:
        lefts, rights = self._route(raw_features)
        lt = self.left.generate_table(lefts, require_response)
        rt = self.right.generate_table(rights, require_response)
        if lt.key is None or rt.key is None:
            raise ValueError("joined readers need keys on both sides")
        lk = [str(k) for k in lt.key]
        rk = [str(k) for k in rt.key]
        l_index: Dict[str, int] = {}
        for i, k in enumerate(lk):
            l_index.setdefault(k, i)
        r_index: Dict[str, int] = {}
        for i, k in enumerate(rk):
            r_index.setdefault(k, i)
        if self.join_type == "inner":
            keys = [k for k in dict.fromkeys(lk) if k in r_index]
        elif self.join_type == "left":
            keys = list(dict.fromkeys(lk))
        else:
            keys = list(dict.fromkeys(lk + rk))

        def side_cols(tbl: FeatureTable, feats: Sequence[Feature],
                      index: Dict[str, int]) -> Dict[str, Column]:
            out: Dict[str, Column] = {}
            rows = [index.get(k) for k in keys]
            for f in feats:
                vals = _cells(tbl[f.name])
                out[f.name] = Column.of_values(
                    f.feature_type, [None if i is None else vals[i]
                                     for i in rows])
            return out

        cols = side_cols(lt, lefts, l_index)
        cols.update(side_cols(rt, rights, r_index))
        return FeatureTable(cols, len(keys), np.array(keys, dtype=object))


def _cells(col: Column) -> List[Any]:
    """Each row's python value, None where the row is missing."""
    valid, vals = col.valid_mask(), col.host_values()
    out: List[Any] = []
    for i in range(len(col)):
        v = vals[i]
        if not valid[i]:
            out.append(None)
        elif isinstance(v, np.ndarray):
            out.append(v.tolist())
        else:
            out.append(v.item() if isinstance(v, np.generic) else v)
    return out
