"""Feature DSL (counterpart of ``transmogrifai_tpu.dsl``):
``transmogrify([...])`` and ``feature.sanity_check(label)``."""
from __future__ import annotations

from .features import Feature
from .impl.feature.transmogrifier import transmogrify


def sanity_check(self: Feature, label: Feature, **kw) -> Feature:
    """The checked vector of an OPVector feature against a RealNN label
    (``SanityChecker(**kw)``)."""
    from .impl.preparators.sanity_checker import SanityChecker
    return SanityChecker(**kw).set_input(label, self).get_output()


Feature.sanity_check = sanity_check

__all__ = ["transmogrify", "sanity_check"]
