"""Feature DAG nodes (counterpart of ``transmogrifai_tpu.features``): a
``Feature`` is a typed node whose origin stage produced it and whose parents
are that stage's inputs. A loaded model rebuilds them from its saved
feature graph (``persistence.features_from_json``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Set, Type

from .types import FeatureType


class Feature:
    """A typed node in the feature DAG."""

    def __init__(self, name: str, feature_type: Type[FeatureType],
                 is_response: bool, origin_stage: Any,
                 parents: Sequence["Feature"], uid: str):
        self.name = name
        self.feature_type = feature_type
        self.is_response = is_response
        self.origin_stage = origin_stage
        self.parents = tuple(parents)
        self.uid = uid

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
