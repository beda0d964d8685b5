"""ModelSelector factories (counterpart of
``transmogrifai_tpu.impl.selector.factories``)."""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..tuning.splitters import DataBalancer, DataCutter, DataSplitter, Splitter
from ..tuning.validators import OpCrossValidation
from .model_selector import ModelSelector

_Models = Optional[Sequence[Tuple[Any, Optional[List[Dict]]]]]


def _cv_selector(problem: str, splitter: Splitter, num_folds: int, seed: int,
                 models: _Models, evaluator, stratify: bool,
                 validator_kw) -> ModelSelector:
    return ModelSelector(
        problem=problem,
        validator=OpCrossValidation(num_folds=num_folds, seed=seed,
                                    stratify=stratify, **validator_kw),
        splitter=splitter, models=models, evaluator=evaluator)


class BinaryClassificationModelSelector:
    """Defaults: 3-fold CV, AuPR, DataBalancer."""

    @staticmethod
    def with_cross_validation(num_folds: int = 3, seed: int = 42,
                              splitter: Optional[Splitter] = None,
                              models: _Models = None, evaluator=None,
                              stratify: bool = False,
                              **validator_kw) -> ModelSelector:
        return _cv_selector(
            "binary", splitter if splitter is not None
            else DataBalancer(seed=seed), num_folds, seed, models, evaluator,
            stratify, validator_kw)


class MultiClassificationModelSelector:
    """Defaults: 3-fold CV, weighted F1, DataCutter."""

    @staticmethod
    def with_cross_validation(num_folds: int = 3, seed: int = 42,
                              splitter: Optional[Splitter] = None,
                              models: _Models = None, evaluator=None,
                              stratify: bool = False,
                              **validator_kw) -> ModelSelector:
        return _cv_selector(
            "multiclass", splitter if splitter is not None
            else DataCutter(seed=seed), num_folds, seed, models, evaluator,
            stratify, validator_kw)


class RegressionModelSelector:
    """Defaults: 3-fold CV, RMSE (smaller is better), DataSplitter."""

    @staticmethod
    def with_cross_validation(num_folds: int = 3, seed: int = 42,
                              splitter: Optional[Splitter] = None,
                              models: _Models = None, evaluator=None,
                              **validator_kw) -> ModelSelector:
        return _cv_selector(
            "regression", splitter if splitter is not None
            else DataSplitter(seed=seed), num_folds, seed, models, evaluator,
            False, validator_kw)
