"""Feature DSL (counterpart of the parts of ``transmogrifai_tpu.dsl`` that
the port's paths use): numeric ``+ - * /`` between features and with
scalars, ``alias``, ``pivot``, ``smart_vectorize``, ``tokenize``, ``tf``,
``vectorize``/``transmogrify`` and ``sanity_check``; ``indexed`` and
``deindexed`` of labels; ``to_unit_circle``, ``time_period``,
``since_last`` and ``to_date_list`` of dates; ``filter_keys``,
``vectorize_map``, ``smart_vectorize_map`` and ``pivot_map`` of maps;
attached to ``Feature`` on import (the package ``__init__`` imports this
module)."""
from __future__ import annotations

from typing import Optional, Sequence

from .features import Feature
from .impl.feature.dates import (
    DEFAULT_CIRCULAR_PERIODS, DateListVectorizer,
    DateMapToUnitCircleVectorizer, DateToUnitCircleTransformer,
    TimePeriodListTransformer, TimePeriodMapTransformer,
    TimePeriodTransformer,
)
from .impl.feature.maps import (
    MapVectorizer, SmartTextMapVectorizer, TextMapPivotVectorizer,
)
from .impl.feature.math import (
    AliasTransformer, BinaryMathOp, FilterMap, ScalarOp,
)
from .impl.feature.text import OpIndexToString, OpStringIndexer
from .impl.feature.transmogrifier import transmogrify
from .impl.feature.vectorizers import (
    HashingVectorizer, OneHotVectorizer, SmartTextVectorizer, TextTokenizer,
    VectorsCombiner,
)
from .stages.base import UnaryTransformer
from .types import DateList, DateMap


def _num_binop(op: str):
    def method(self: Feature, other):
        if isinstance(other, Feature):
            return BinaryMathOp(op).set_input(self, other).get_output()
        return ScalarOp(op, float(other)).set_input(self).get_output()
    return method


def _num_rbinop(op: str):
    # scalar + f == f + scalar; scalar - f == (f * -1) + scalar
    def method(self: Feature, other):
        if op in ("+", "*"):
            return _num_binop(op)(self, other)
        neg = ScalarOp("*", -1.0).set_input(self).get_output()
        return ScalarOp("+", float(other)).set_input(neg).get_output()
    return method


def alias(self: Feature, name: str) -> Feature:
    return AliasTransformer(name).set_input(self).get_output()


def pivot(self: Feature, top_k: int = 20, min_support: int = 10,
          track_nulls: bool = True) -> Feature:
    return OneHotVectorizer(top_k=top_k, min_support=min_support,
                            track_nulls=track_nulls
                            ).set_input(self).get_output()


def smart_vectorize(self: Feature, **kw) -> Feature:
    return SmartTextVectorizer(**kw).set_input(self).get_output()


def tokenize(self: Feature, min_token_length: int = 1) -> Feature:
    return TextTokenizer(min_token_length).set_input(self).get_output()


def tf(self: Feature, num_hashes: int = 512) -> Feature:
    """Term-frequency hashing vector of a TextList feature."""
    return HashingVectorizer(num_hashes=num_hashes
                             ).set_input(self).get_output()


def vectorize(self: Feature, *others: Feature) -> Feature:
    """``transmogrify`` of this feature (and ``others``)."""
    return transmogrify([self, *others])


def sanity_check(self: Feature, label: Feature, **kw) -> Feature:
    """The checked vector of an OPVector feature against a RealNN label
    (``SanityChecker(**kw)``)."""
    from .impl.preparators.sanity_checker import SanityChecker
    return SanityChecker(**kw).set_input(label, self).get_output()


def indexed(self: Feature, handle_invalid: str = "keep") -> Feature:
    """Text -> its label index by frequency (``OpStringIndexer``)."""
    return (OpStringIndexer(handle_invalid=handle_invalid)
            .set_input(self).get_output())


def deindexed(self: Feature, labels: Sequence[str]) -> Feature:
    """Index -> its label in ``labels`` (``OpIndexToString``)."""
    return OpIndexToString(labels).set_input(self).get_output()


def to_unit_circle(self: Feature,
                   periods: Sequence[str] = DEFAULT_CIRCULAR_PERIODS
                   ) -> Feature:
    """[sin, cos] of a date on each period; of a date map, one vectorizer
    a period, combined."""
    if issubclass(self.feature_type, DateMap):
        outs = [DateMapToUnitCircleVectorizer(period=p)
                .set_input(self).get_output() for p in periods]
        if len(outs) == 1:
            return outs[0]
        return VectorsCombiner().set_input(*outs).get_output()
    return DateToUnitCircleTransformer(periods=periods
                                       ).set_input(self).get_output()


def time_period(self: Feature, period: str = "DayOfWeek") -> Feature:
    """The time period of a Date, DateList or DateMap."""
    if issubclass(self.feature_type, DateList):
        return TimePeriodListTransformer(period).set_input(self).get_output()
    if issubclass(self.feature_type, DateMap):
        return TimePeriodMapTransformer(period).set_input(self).get_output()
    return TimePeriodTransformer(period).set_input(self).get_output()


def since_last(self: Feature, reference_date_ms: Optional[int] = None
               ) -> Feature:
    """Days from a date list's last date to ``reference_date_ms`` (the
    clock when None)."""
    return DateListVectorizer(
        "SinceLast", reference_date_ms=reference_date_ms
    ).set_input(self).get_output()


def to_date_list(self: Feature) -> Feature:
    """Date -> a DateList of that one date."""
    return UnaryTransformer(
        "toDateList", transform_fn=lambda v: None if v is None else [int(v)],
        output_type=DateList).set_input(self).get_output()


def filter_keys(self: Feature, white_list: Sequence[str] = (),
                black_list: Sequence[str] = ()) -> Feature:
    return FilterMap(white_list, black_list).set_input(self).get_output()


def vectorize_map(self: Feature, white_list_keys: Sequence[str] = (),
                  black_list_keys: Sequence[str] = (), **kw) -> Feature:
    """A numeric map's values a key (``MapVectorizer``)."""
    return MapVectorizer(white_list_keys=white_list_keys,
                         black_list_keys=black_list_keys, **kw
                         ).set_input(self).get_output()


def smart_vectorize_map(self: Feature, **kw) -> Feature:
    """A text map a key, pivoted or hashed by its cardinality."""
    return SmartTextMapVectorizer(**kw).set_input(self).get_output()


def pivot_map(self: Feature, top_k: int = 20,
              min_support: int = 10) -> Feature:
    """A text map's top values a key, pivoted."""
    return (TextMapPivotVectorizer(top_k=top_k, min_support=min_support)
            .set_input(self).get_output())


Feature.__add__ = _num_binop("+")
Feature.__sub__ = _num_binop("-")
Feature.__mul__ = _num_binop("*")
Feature.__truediv__ = _num_binop("/")
Feature.__radd__ = _num_rbinop("+")
Feature.__rmul__ = _num_rbinop("*")
Feature.__rsub__ = _num_rbinop("-")
for _name, _fn in (("alias", alias), ("pivot", pivot),
                   ("smart_vectorize", smart_vectorize),
                   ("tokenize", tokenize), ("tf", tf),
                   ("vectorize", vectorize), ("transmogrify", vectorize),
                   ("sanity_check", sanity_check), ("indexed", indexed),
                   ("deindexed", deindexed),
                   ("to_unit_circle", to_unit_circle),
                   ("time_period", time_period), ("since_last", since_last),
                   ("to_date_list", to_date_list),
                   ("filter_keys", filter_keys),
                   ("vectorize_map", vectorize_map),
                   ("smart_vectorize_map", smart_vectorize_map),
                   ("pivot_map", pivot_map)):
    setattr(Feature, _name, _fn)

__all__ = ["transmogrify", "sanity_check"]
