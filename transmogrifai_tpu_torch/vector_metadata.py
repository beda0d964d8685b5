"""Per-column provenance of feature vectors (counterpart of
``transmogrifai_tpu.vector_metadata``): every slot of an ``OPVector`` column
records the raw feature that produced it, its type, an optional grouping and
an optional indicator value (a pivot's category, ``OTHER_INDICATOR`` for
the pivot's other values, ``NULL_INDICATOR`` for its missing ones).
The SanityChecker groups slots by ``feature_group`` and computes
contingency statistics for the groups whose every slot has an indicator
value; saved models carry these records as they are.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence

NULL_INDICATOR = "NullIndicatorValue"
OTHER_INDICATOR = "OTHER"


@dataclass(frozen=True)
class VectorColumnMetadata:
    """Provenance of one vector slot."""
    parent_feature_name: str
    parent_feature_type: str
    grouping: Optional[str] = None
    indicator_value: Optional[str] = None
    descriptor_value: Optional[str] = None
    index: int = 0

    @property
    def is_null_indicator(self) -> bool:
        return self.indicator_value == NULL_INDICATOR

    @property
    def is_other_indicator(self) -> bool:
        return self.indicator_value == OTHER_INDICATOR

    def column_name(self) -> str:
        parts = [self.parent_feature_name]
        if self.grouping and self.grouping != self.parent_feature_name:
            parts.append(self.grouping)
        if self.indicator_value is not None:
            parts.append(self.indicator_value)
        elif self.descriptor_value is not None:
            parts.append(self.descriptor_value)
        return "_".join(parts) + f"_{self.index}"

    def feature_group(self) -> str:
        """Key that groups the sibling slots of one raw feature."""
        return f"{self.parent_feature_name}::{self.grouping or ''}"


@dataclass(frozen=True)
class VectorMetadata:
    """Provenance of a whole vector column."""
    name: str
    columns: tuple

    @property
    def size(self) -> int:
        return len(self.columns)

    def column_names(self) -> List[str]:
        return [c.column_name() for c in self.columns]

    def index_of_group(self) -> Dict[str, List[int]]:
        groups: Dict[str, List[int]] = {}
        for c in self.columns:
            groups.setdefault(c.feature_group(), []).append(c.index)
        return groups

    def select(self, indices: Sequence[int]) -> "VectorMetadata":
        return VectorMetadata.of(self.name, [self.columns[i] for i in indices])

    @staticmethod
    def of(name: str, cols: Sequence[VectorColumnMetadata]) -> "VectorMetadata":
        return VectorMetadata(
            name, tuple(replace(c, index=i) for i, c in enumerate(cols)))

    @staticmethod
    def flatten(name: str,
                metas: Sequence["VectorMetadata"]) -> "VectorMetadata":
        cols: List[VectorColumnMetadata] = []
        for m in metas:
            cols.extend(m.columns)
        return VectorMetadata.of(name, cols)
