"""Feature DSL (counterpart of ``transmogrifai_tpu.dsl``): numeric
``+ - * /`` between features and with scalars, and the methods named in
``DSL_METHODS``, attached to ``Feature`` on import (the package
``__init__`` imports this module). ``DSL_METHODS`` is the JAX package's
list, in its order."""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

from .features import Feature
from .impl.feature.bucketizers import (
    DecisionTreeNumericBucketizer, DecisionTreeNumericMapBucketizer,
    NumericBucketizer, PercentileCalibrator,
)
from .impl.feature.dates import (
    DEFAULT_CIRCULAR_PERIODS, DateListVectorizer,
    DateMapToUnitCircleVectorizer, DateToUnitCircleTransformer,
    TimePeriodListTransformer, TimePeriodMapTransformer,
    TimePeriodTransformer,
)
from .impl.feature.maps import (
    MapVectorizer, SmartTextMapVectorizer, TextMapPivotVectorizer,
)
from .impl.feature import text as _text
from .impl.feature.math import (
    AbsoluteValue, AliasTransformer, BinaryMathOp, Ceil,
    DropIndicesByTransformer, Exp, FilterMap, Floor, JaccardSimilarity, Log, NGramSimilarity, Power,
    RoundTransformer, ScalarOp, Sqrt, SubstringTransformer,
    TextLenTransformer, ToOccurTransformer,
)
from .impl.feature.scalers import (
    DescalerTransformer, FillMissingWithMean, OpScalarStandardScaler,
    ScalerTransformer,
)
from .impl.feature.text import OpIndexToString, OpStringIndexer
from .impl.regression.isotonic import IsotonicRegressionCalibrator
from .impl.feature.transmogrifier import transmogrify
from .impl.feature.vectorizers import (
    HashingVectorizer, OneHotVectorizer, SmartTextVectorizer, TextTokenizer,
    VectorsCombiner,
)
from .stages.base import UnaryTransformer
from .types import Binary, DateList, DateMap


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


def abs_(self: Feature) -> Feature:
    return AbsoluteValue().set_input(self).get_output()


def log(self: Feature, base: float = 2.718281828459045) -> Feature:
    return Log(base).set_input(self).get_output()


def exp(self: Feature) -> Feature:
    return Exp().set_input(self).get_output()


def sqrt(self: Feature) -> Feature:
    return Sqrt().set_input(self).get_output()


def power(self: Feature, p: float) -> Feature:
    return Power(p).set_input(self).get_output()


def round_(self: Feature) -> Feature:
    return RoundTransformer().set_input(self).get_output()


def ceil(self: Feature) -> Feature:
    return Ceil().set_input(self).get_output()


def floor(self: Feature) -> Feature:
    return Floor().set_input(self).get_output()


def to_occur(self: Feature) -> Feature:
    return ToOccurTransformer().set_input(self).get_output()


def occurs(self: Feature,
           matches: Optional[Callable[[Any], bool]] = None) -> Feature:
    return ToOccurTransformer(matches).set_input(self).get_output()


def text_len(self: Feature) -> Feature:
    return TextLenTransformer().set_input(self).get_output()


def contains(self: Feature, other: Feature) -> Feature:
    """Binary: ``other``, lower-cased, occurs in this text."""
    return SubstringTransformer().set_input(self, other).get_output()


def jaccard_similarity(self: Feature, other: Feature) -> Feature:
    return JaccardSimilarity().set_input(self, other).get_output()


def ngram_similarity(self: Feature, other: Feature, n: int = 3) -> Feature:
    return NGramSimilarity(n).set_input(self, other).get_output()


def _unary(stage) -> Callable[[Feature], Feature]:
    """A DSL method applying a fresh ``stage()`` to the feature."""
    def method(self: Feature) -> Feature:
        return stage().set_input(self).get_output()
    return method


def is_valid_phone(self: Feature, region: str = "US") -> Feature:
    return (_text.IsValidPhoneDefaultCountry(default_region=region)
            .set_input(self).get_output())


def parse_phone(self: Feature, region: str = "US") -> Feature:
    return (_text.PhoneNumberParser(default_region=region)
            .set_input(self).get_output())


def is_valid_phone_map(self: Feature, region: str = "US") -> Feature:
    return (_text.IsValidPhoneMap(default_region=region)
            .set_input(self).get_output())


def tokenize_regex(self: Feature, pattern: str = r"\w+",
                   to_lowercase: bool = True,
                   min_token_length: int = 1) -> Feature:
    return (_text.RegexTokenizer(pattern, to_lowercase, min_token_length)
            .set_input(self).get_output())


def map_values(self: Feature, fn: Callable[[Any], Any],
               output_type=None) -> Feature:
    """``fn`` of each present value (missing stays missing)."""
    return UnaryTransformer(
        "map", transform_fn=lambda v: None if v is None else fn(v),
        output_type=output_type or self.feature_type
    ).set_input(self).get_output()


def exists(self: Feature, predicate: Callable[[Any], bool]) -> Feature:
    """Binary: the value is present and ``predicate`` holds."""
    return UnaryTransformer(
        "exists", transform_fn=lambda v: v is not None and bool(predicate(v)),
        output_type=Binary).set_input(self).get_output()


def filter_values(self: Feature, predicate: Callable[[Any], bool],
                  keep: bool = True) -> Feature:
    """The value where ``predicate`` is ``keep``, else missing."""
    return UnaryTransformer(
        "filter", transform_fn=lambda v: v if (
            v is not None and bool(predicate(v)) == keep) else None,
        output_type=self.feature_type).set_input(self).get_output()


def replace_with(self: Feature, old_val: Any, new_val: Any) -> Feature:
    return UnaryTransformer(
        "replaced", transform_fn=lambda v: new_val if v == old_val else v,
        output_type=self.feature_type).set_input(self).get_output()


def tfidf(self: Feature, num_hashes: int = 512,
          min_doc_freq: int = 0) -> Feature:
    """IDF weights of the hashed term counts of a TextList."""
    tf_f = tf(self, num_hashes=num_hashes)
    return _text.OpIDF(min_doc_freq=min_doc_freq).set_input(tf_f).get_output()


def idf(self: Feature, min_doc_freq: int = 0) -> Feature:
    """IDF weighting of a term-count vector."""
    return _text.OpIDF(min_doc_freq=min_doc_freq).set_input(self).get_output()


def word2vec(self: Feature, vector_size: int = 32, **kw) -> Feature:
    return (_text.OpWord2Vec(vector_size=vector_size, **kw)
            .set_input(self).get_output())


def count_vec(self: Feature, vocab_size: int = 512, min_df: int = 1,
              binary: bool = False) -> Feature:
    return (_text.OpCountVectorizer(vocab_size, min_df, binary)
            .set_input(self).get_output())


def ngram(self: Feature, n: int = 2) -> Feature:
    return _text.OpNGram(n).set_input(self).get_output()


def remove_stop_words(self: Feature,
                      stop_words: Optional[Sequence[str]] = None,
                      case_sensitive: bool = False) -> Feature:
    return (_text.OpStopWordsRemover(stop_words, case_sensitive)
            .set_input(self).get_output())


def lda(self: Feature, k: int = 10, **kw) -> Feature:
    """Topic mixture of a term-count vector."""
    return _text.OpLDA(k=k, **kw).set_input(self).get_output()


def combine(self: Feature, *others: Feature) -> Feature:
    """The vectors concatenated."""
    return VectorsCombiner().set_input(self, *others).get_output()


def drop_indices_by(self: Feature,
                    predicate: Callable[[Any], bool]) -> Feature:
    return DropIndicesByTransformer(predicate).set_input(self).get_output()


def bucketize(self: Feature, splits: Sequence[float],
              bucket_labels: Optional[Sequence[str]] = None,
              track_nulls: bool = True, track_invalid: bool = False
              ) -> Feature:
    return NumericBucketizer(
        splits, bucket_labels=bucket_labels, track_nulls=track_nulls,
        track_invalid=track_invalid).set_input(self).get_output()


def auto_bucketize(self: Feature, label: Feature, max_depth: int = 2,
                   min_info_gain: float = 0.01) -> Feature:
    return DecisionTreeNumericBucketizer(
        max_depth=max_depth, min_info_gain=min_info_gain
    ).set_input(label, self).get_output()


def auto_bucketize_map(self: Feature, label: Feature, max_depth: int = 2,
                       min_info_gain: float = 0.01) -> Feature:
    return DecisionTreeNumericMapBucketizer(
        max_depth=max_depth, min_info_gain=min_info_gain
    ).set_input(label, self).get_output()


def fill_missing_with_mean(self: Feature, default: float = 0.0) -> Feature:
    return FillMissingWithMean(default).set_input(self).get_output()


def zscore(self: Feature) -> Feature:
    return OpScalarStandardScaler().set_input(self).get_output()


def scale(self: Feature, scaling_type: str = "linear", slope: float = 1.0,
          intercept: float = 0.0) -> Feature:
    return ScalerTransformer(scaling_type, slope, intercept
                             ).set_input(self).get_output()


def descale(self: Feature, scaled: Feature) -> Feature:
    return DescalerTransformer().set_input(self, scaled).get_output()


def percentile_calibrate(self: Feature, buckets: int = 100) -> Feature:
    return PercentileCalibrator(buckets).set_input(self).get_output()


def to_isotonic_calibrated(self: Feature, label: Feature,
                           isotonic: bool = True) -> Feature:
    """Calibrate a score against the label."""
    return (IsotonicRegressionCalibrator(isotonic=isotonic)
            .set_input(label, self).get_output())


Feature.__add__ = _num_binop("+")
Feature.__sub__ = _num_binop("-")
Feature.__mul__ = _num_binop("*")
Feature.__truediv__ = _num_binop("/")
Feature.__radd__ = _num_rbinop("+")
Feature.__rmul__ = _num_rbinop("*")
Feature.__rsub__ = _num_rbinop("-")

#: the DSL methods, in the JAX package's order
_METHODS = (
    ("alias", alias), ("abs", abs_), ("log", log), ("exp", exp),
    ("sqrt", sqrt), ("power", power), ("round", round_), ("ceil", ceil),
    ("floor", floor), ("bucketize", bucketize),
    ("auto_bucketize", auto_bucketize),
    ("fill_missing_with_mean", fill_missing_with_mean),
    ("zscore", zscore), ("scale", scale), ("descale", descale),
    ("to_occur", to_occur), ("percentile_calibrate", percentile_calibrate),
    ("tokenize", tokenize), ("pivot", pivot),
    ("smart_vectorize", smart_vectorize), ("text_len", text_len),
    ("contains", contains), ("jaccard_similarity", jaccard_similarity),
    ("ngram_similarity", ngram_similarity),
    ("to_unit_circle", to_unit_circle), ("time_period", time_period),
    ("since_last", since_last), ("filter_keys", filter_keys),
    ("vectorize", vectorize), ("sanity_check", sanity_check),
    ("is_valid_email", _unary(_text.ValidEmailTransformer)),
    ("to_email_domain", _unary(_text.EmailToPickList)),
    ("to_url_domain", _unary(_text.UrlToDomain)),
    ("is_valid_url", _unary(_text.IsValidUrl)),
    ("is_valid_phone", is_valid_phone),
    ("detect_languages", _unary(_text.LangDetector)),
    ("detect_mime_types", _unary(_text.MimeTypeDetector)),
    ("recognize_entities", _unary(_text.NameEntityRecognizer)),
    ("map_values", map_values), ("exists", exists),
    ("filter_values", filter_values), ("replace_with", replace_with),
    ("occurs", occurs),
    ("to_multi_pick_list", _unary(_text.TextToMultiPickList)),
    ("indexed", indexed), ("deindexed", deindexed),
    ("tokenize_regex", tokenize_regex),
    ("to_email_prefix", _unary(_text.EmailToPrefix)),
    ("to_url_protocol", _unary(_text.UrlToProtocol)),
    ("parse_phone", parse_phone),
    ("tf", tf), ("tfidf", tfidf), ("idf", idf), ("word2vec", word2vec),
    ("count_vec", count_vec), ("ngram", ngram),
    ("remove_stop_words", remove_stop_words), ("lda", lda),
    ("to_date_list", to_date_list),
    ("vectorize_map", vectorize_map),
    ("smart_vectorize_map", smart_vectorize_map),
    ("pivot_map", pivot_map),
    ("auto_bucketize_map", auto_bucketize_map),
    ("is_valid_phone_map", is_valid_phone_map),
    ("combine", combine), ("drop_indices_by", drop_indices_by),
    ("to_isotonic_calibrated", to_isotonic_calibrated),
)
for _name, _fn in _METHODS:
    setattr(Feature, _name, _fn)
Feature.transmogrify = vectorize

#: every DSL method attached to ``Feature``
DSL_METHODS = tuple(name for name, _ in _METHODS)

__all__ = ["transmogrify", "sanity_check", "DSL_METHODS"]
