"""Feature DAG nodes (counterpart of ``transmogrifai_tpu.features``): a
``Feature`` is a typed node whose origin stage produced it and whose parents
are that stage's inputs. User code builds raw features with
``FeatureBuilder`` and derives the rest through stages; a loaded model
rebuilds them from its saved feature graph
(``persistence.features_from_json``).
"""
from __future__ import annotations

import itertools
from typing import (
    Any, Callable, Dict, List, Optional, Sequence, Set, Tuple, Type,
)

from .types import FEATURE_TYPES, FeatureType

_uid_counter = itertools.count(1)


def make_uid(cls_name: str) -> str:
    """Stage/feature uid: ``ClassName_000000000001``."""
    return f"{cls_name}_{next(_uid_counter):012x}"


def reset_uids() -> None:
    """Restart the uid counter: a DAG built after it gets the uids the JAX
    package gives the same definitions after its ``reset_uids``, which
    ``load_model(..., workflow=)`` matches stages by."""
    global _uid_counter
    _uid_counter = itertools.count(1)


class Feature:
    """A typed node in the feature DAG."""

    def __init__(self, name: str, feature_type: Type[FeatureType],
                 is_response: bool, origin_stage: Any,
                 parents: Sequence["Feature"], uid: Optional[str] = None):
        self.name = name
        self.feature_type = feature_type
        self.is_response = is_response
        self.origin_stage = origin_stage
        self.parents = tuple(parents)
        self.uid = uid or make_uid(feature_type.__name__)

    @property
    def type_name(self) -> str:
        return self.feature_type.__name__

    @property
    def is_raw(self) -> bool:
        return len(self.parents) == 0

    def __repr__(self) -> str:
        return (f"Feature[{self.type_name}](name={self.name!r}, "
                f"uid={self.uid!r}, isResponse={self.is_response})")

    def __eq__(self, other):
        return isinstance(other, Feature) and self.uid == other.uid

    def __hash__(self):
        return hash(self.uid)

    def transform_with(self, stage: Any, *others: "Feature") -> "Feature":
        """Apply ``stage`` to this feature (and ``others``); its output."""
        stage.set_input(self, *others)
        return stage.get_output()

    def traverse(self, visit: Callable[["Feature"], None]) -> None:
        """Post-order DFS over the ancestry, with cycle detection."""
        in_path: Set[str] = set()
        done: Set[str] = set()

        def rec(f: "Feature"):
            if f.uid in done:
                return
            if f.uid in in_path:
                raise ValueError(
                    f"Feature DAG contains a cycle at {f.name} ({f.uid})")
            in_path.add(f.uid)
            for p in f.parents:
                rec(p)
            in_path.discard(f.uid)
            done.add(f.uid)
            visit(f)

        rec(self)

    def all_features(self) -> List["Feature"]:
        out: List[Feature] = []
        self.traverse(out.append)
        return out

    def raw_features(self) -> List["Feature"]:
        """All raw ancestors, de-duplicated, in traversal order."""
        return [f for f in self.all_features() if f.is_raw]

    def copy_with_new_stages(self, stage_map: Dict[str, Any]) -> "Feature":
        """This feature's ancestry rebuilt with the stages of ``stage_map``
        (uid -> fitted stage) in place of the originals; a swapped-in
        stage's output feature is rewired to the copy."""
        cache: Dict[str, Feature] = {}

        def rec(f: "Feature") -> "Feature":
            if f.uid in cache:
                return cache[f.uid]
            parents = [rec(p) for p in f.parents]
            replaced = (f.origin_stage is not None
                        and f.origin_stage.uid in stage_map)
            stage = stage_map[f.origin_stage.uid] if replaced \
                else f.origin_stage
            nf = Feature(f.name, f.feature_type, f.is_response, stage,
                         parents, uid=f.uid)
            if replaced:
                stage._output_feature = nf
            cache[f.uid] = nf
            return nf

        return rec(self)

    def parent_stages(self) -> Dict[Any, int]:
        """Every ancestor stage mapped to its longest distance from this
        feature."""
        ordered = self.all_features()
        dist: Dict[str, int] = {self.uid: 0}
        by_uid = {f.uid: f for f in ordered}
        for f in reversed(ordered):
            d = dist.get(f.uid, 0)
            for p in f.parents:
                dist[p.uid] = max(dist.get(p.uid, 0), d + 1)
        out: Dict[Any, int] = {}
        for uid, d in dist.items():
            st = by_uid[uid].origin_stage
            if st is not None:
                out[st] = max(out.get(st, 0), d)
        return out

    def pretty_parent_stages(self) -> str:
        """One line ``[distance] StageClass -> uid`` per ancestor stage,
        farthest first."""
        return "\n".join(
            f"[{d}] {type(stage).__name__} -> {stage.uid}"
            for stage, d in sorted(self.parent_stages().items(),
                                   key=lambda kv: -kv[1]))

    def history(self) -> Dict[str, Any]:
        """The raw features this one derives from and its ancestor
        stages' uids."""
        return {"originFeatures": [f.name for f in self.raw_features()],
                "stages": [s.uid for s in self.parent_stages()]}

    def as_raw(self, extract_fn: Optional[Callable[[Any], Any]] = None
               ) -> "Feature":
        """A raw feature of this one's name, type and side, extracted by
        ``extract_fn`` (default: the record field of its name)."""
        builder = FeatureBuilder(self.name, self.feature_type).extract(
            extract_fn or FieldExtractor(self.name))
        return builder.as_response() if self.is_response \
            else builder.as_predictor()


class FieldExtractor:
    """Extract function of a raw feature: the record field with the
    feature's name."""

    def __init__(self, name: str):
        self.name = name
        self.__name__ = f"extract_{name}"

    def __call__(self, record: Any) -> Any:
        if isinstance(record, dict):
            return record.get(self.name)
        return getattr(record, self.name, None)


class FeatureBuilder:
    """Typed factory of raw features, one constructor per type of
    ``types.FEATURE_TYPES``::

        age = FeatureBuilder.Real("age").extract_field().as_predictor()
        sex = FeatureBuilder.PickList("sex").extract_field().as_predictor()
        label = FeatureBuilder.RealNN("y").extract_field().as_response()

    ``extract_field`` (a ``FieldExtractor`` named ``extract_<field>``) lets
    a reader convert the field's whole column at once; a custom
    ``extract(fn)`` runs per record. ``aggregate`` and ``window`` set how
    an aggregating reader (``readers.aggregates``) folds a key's events
    into the feature's value."""

    def __init__(self, name: str, feature_type: Type[FeatureType]):
        self.name = name
        self.feature_type = feature_type
        self._extract_fn: Optional[Callable[[Any], Any]] = None
        self._aggregator: Optional[Any] = None
        self._aggregate_window: Optional[int] = None

    def extract(self, fn: Callable[[Any], Any]) -> "FeatureBuilder":
        self._extract_fn = fn
        return self

    def extract_field(self) -> "FeatureBuilder":
        """Extract the record field with the feature's name."""
        return self.extract(FieldExtractor(self.name))

    def aggregate(self, aggregator: Any) -> "FeatureBuilder":
        """The monoid (``aggregators``) that folds a key's events; default
        ``aggregators.default_aggregator`` of the feature type."""
        self._aggregator = aggregator
        return self

    def window(self, millis: int) -> "FeatureBuilder":
        """Aggregate only the events within ``millis`` of the cutoff."""
        self._aggregate_window = millis
        return self

    def _build(self, is_response: bool) -> Feature:
        from .stages.base import FeatureGeneratorStage
        stage = FeatureGeneratorStage(
            extract_fn=self._extract_fn or FieldExtractor(self.name),
            output_name=self.name, output_type=self.feature_type,
            is_response=is_response, aggregator=self._aggregator,
            aggregate_window=self._aggregate_window)
        return stage.get_output()

    def as_predictor(self) -> Feature:
        return self._build(is_response=False)

    def as_response(self) -> Feature:
        return self._build(is_response=True)

    @staticmethod
    def from_dataframe(data, response: str,
                       response_type: Optional[Type[FeatureType]] = None
                       ) -> Tuple[Feature, List[Feature]]:
        """(response, predictors) of a frame's schema (a
        ``readers.Frame`` or what ``Frame.of`` takes), typed as the JAX
        package types a DataFrame's columns: bool -> Binary, integer ->
        Integral, float -> Real, datetime64 -> DateTime, anything else
        Text; the response is ``response_type`` (default RealNN)."""
        from .readers.readers import Frame
        from .types import Binary, DateTime, Integral, Real, RealNN, Text
        frame = Frame.of(data)
        if response not in frame:
            raise ValueError(f"response feature '{response}' is not "
                             f"present in the dataframe")
        by_kind = {"b": Binary, "i": Integral, "u": Integral, "f": Real,
                   "M": DateTime}
        resp, feats = None, []
        for col, arr in frame.columns.items():
            if col == response:
                resp = FeatureBuilder(col, response_type or RealNN
                                      ).extract_field().as_response()
                continue
            ft = by_kind.get(arr.dtype.kind, Text)
            feats.append(FeatureBuilder(col, ft).extract_field()
                         .as_predictor())
        return resp, feats

    @staticmethod
    def from_row(row: Dict[str, Any], response: str,
                 response_type: Optional[Type[FeatureType]] = None
                 ) -> Tuple[Feature, List[Feature]]:
        """``from_dataframe`` of a frame of the one record ``row``."""
        return FeatureBuilder.from_dataframe([row], response,
                                             response_type=response_type)


def _typed(feature_type: Type[FeatureType]):
    def factory(name: str) -> FeatureBuilder:
        return FeatureBuilder(name, feature_type)
    factory.__name__ = feature_type.__name__
    return staticmethod(factory)


for _name, _type in FEATURE_TYPES.items():
    setattr(FeatureBuilder, _name, _typed(_type))
