"""Evaluator factory (counterpart of
``transmogrifai_tpu.evaluators.factory``): each evaluator set to the
metric that model selection optimizes, and the binary Brier score
(``OpBinScoreEvaluator``)."""
from __future__ import annotations

from .binary import OpBinScoreEvaluator, OpBinaryClassificationEvaluator
from .multi import OpMultiClassificationEvaluator
from .regression import OpRegressionEvaluator


def _with(ev, metric: str, larger_better: bool):
    ev.default_metric = metric
    ev.larger_better = larger_better
    return ev


class Evaluators:
    class BinaryClassification:
        @staticmethod
        def auPR() -> OpBinaryClassificationEvaluator:
            return _with(OpBinaryClassificationEvaluator(), "AuPR", True)

        @staticmethod
        def auROC() -> OpBinaryClassificationEvaluator:
            return _with(OpBinaryClassificationEvaluator(), "AuROC", True)

        @staticmethod
        def precision() -> OpBinaryClassificationEvaluator:
            return _with(OpBinaryClassificationEvaluator(), "Precision",
                         True)

        @staticmethod
        def recall() -> OpBinaryClassificationEvaluator:
            return _with(OpBinaryClassificationEvaluator(), "Recall", True)

        @staticmethod
        def f1() -> OpBinaryClassificationEvaluator:
            return _with(OpBinaryClassificationEvaluator(), "F1", True)

        @staticmethod
        def error() -> OpBinaryClassificationEvaluator:
            return _with(OpBinaryClassificationEvaluator(), "Error", False)

        @staticmethod
        def brier_score() -> OpBinScoreEvaluator:
            return OpBinScoreEvaluator()

    class MultiClassification:
        @staticmethod
        def f1() -> OpMultiClassificationEvaluator:
            return OpMultiClassificationEvaluator()

        @staticmethod
        def error() -> OpMultiClassificationEvaluator:
            return _with(OpMultiClassificationEvaluator(), "Error", False)

        @staticmethod
        def precision() -> OpMultiClassificationEvaluator:
            return _with(OpMultiClassificationEvaluator(), "Precision", True)

        @staticmethod
        def recall() -> OpMultiClassificationEvaluator:
            return _with(OpMultiClassificationEvaluator(), "Recall", True)

    class Regression:
        @staticmethod
        def rmse() -> OpRegressionEvaluator:
            return OpRegressionEvaluator()

        @staticmethod
        def mse() -> OpRegressionEvaluator:
            return _with(OpRegressionEvaluator(), "MeanSquaredError", False)

        @staticmethod
        def mae() -> OpRegressionEvaluator:
            return _with(OpRegressionEvaluator(), "MeanAbsoluteError", False)

        @staticmethod
        def r2() -> OpRegressionEvaluator:
            return _with(OpRegressionEvaluator(), "R2", True)
