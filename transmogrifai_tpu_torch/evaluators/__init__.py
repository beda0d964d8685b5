"""Evaluators (counterpart of ``transmogrifai_tpu.evaluators``)."""
from .binary import OpBinScoreEvaluator, OpBinaryClassificationEvaluator
from .factory import Evaluators
from .multi import OpMultiClassificationEvaluator
from .regression import OpRegressionEvaluator

__all__ = ["Evaluators", "OpBinScoreEvaluator",
           "OpBinaryClassificationEvaluator",
           "OpMultiClassificationEvaluator", "OpRegressionEvaluator"]
