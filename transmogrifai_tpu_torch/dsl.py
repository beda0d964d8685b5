"""Feature DSL (counterpart of the parts of ``transmogrifai_tpu.dsl`` that
the port's paths use): numeric ``+ - * /`` between features and with
scalars, ``alias``, ``pivot``, ``smart_vectorize``, ``tokenize``, ``tf``,
``vectorize``/``transmogrify`` and ``sanity_check``, attached to
``Feature`` on import (the package ``__init__`` imports this module)."""
from __future__ import annotations

from .features import Feature
from .impl.feature.math import AliasTransformer, BinaryMathOp, ScalarOp
from .impl.feature.transmogrifier import transmogrify
from .impl.feature.vectorizers import (
    HashingVectorizer, OneHotVectorizer, SmartTextVectorizer, TextTokenizer,
)


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
                   ("sanity_check", sanity_check)):
    setattr(Feature, _name, _fn)

__all__ = ["transmogrify", "sanity_check"]
