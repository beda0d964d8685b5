"""Evaluators (counterpart of ``transmogrifai_tpu.evaluators``)."""
from .binary import OpBinaryClassificationEvaluator
from .factory import Evaluators
from .multi import OpMultiClassificationEvaluator
from .regression import OpRegressionEvaluator

__all__ = ["Evaluators", "OpBinaryClassificationEvaluator",
           "OpMultiClassificationEvaluator", "OpRegressionEvaluator"]
