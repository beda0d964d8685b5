"""Evaluators (counterpart of ``transmogrifai_tpu.evaluators``)."""
from .binary import OpBinaryClassificationEvaluator

__all__ = ["OpBinaryClassificationEvaluator"]
