"""ModelSelector factories (counterpart of
``transmogrifai_tpu.impl.selector.factories``). Without ``models=`` each
selector sweeps its problem kind's default model list
(``model_selector.DEFAULT_MODELS``)."""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..tuning.splitters import DataBalancer, DataCutter, DataSplitter, Splitter
from ..tuning.validators import OpCrossValidation, OpTrainValidationSplit
from .model_selector import ModelSelector

_Models = Optional[Sequence[Tuple[Any, Optional[List[Dict]]]]]


def _cv(num_folds: int, seed: int, stratify: bool, validator_kw):
    return OpCrossValidation(num_folds=num_folds, seed=seed,
                             stratify=stratify, **validator_kw)


def _tvs(train_ratio: float, seed: int, stratify: bool, validator_kw):
    return OpTrainValidationSplit(train_ratio=train_ratio, seed=seed,
                                  stratify=stratify, **validator_kw)


class BinaryClassificationModelSelector:
    """Defaults: 3-fold CV (or a 0.75 train/validation split), AuPR,
    DataBalancer."""

    @staticmethod
    def with_cross_validation(num_folds: int = 3, seed: int = 42,
                              splitter: Optional[Splitter] = None,
                              models: _Models = None, evaluator=None,
                              stratify: bool = False,
                              **validator_kw) -> ModelSelector:
        return ModelSelector(
            "binary", _cv(num_folds, seed, stratify, validator_kw),
            splitter if splitter is not None else DataBalancer(seed=seed),
            models, evaluator)

    @staticmethod
    def with_train_validation_split(train_ratio: float = 0.75,
                                    seed: int = 42,
                                    splitter: Optional[Splitter] = None,
                                    models: _Models = None, evaluator=None,
                                    stratify: bool = False,
                                    **validator_kw) -> ModelSelector:
        return ModelSelector(
            "binary", _tvs(train_ratio, seed, stratify, validator_kw),
            splitter if splitter is not None else DataBalancer(seed=seed),
            models, evaluator)


class MultiClassificationModelSelector:
    """Defaults: 3-fold CV (or a 0.75 train/validation split), weighted F1,
    DataCutter."""

    @staticmethod
    def with_cross_validation(num_folds: int = 3, seed: int = 42,
                              splitter: Optional[Splitter] = None,
                              models: _Models = None, evaluator=None,
                              stratify: bool = False,
                              **validator_kw) -> ModelSelector:
        return ModelSelector(
            "multiclass", _cv(num_folds, seed, stratify, validator_kw),
            splitter if splitter is not None else DataCutter(seed=seed),
            models, evaluator)

    @staticmethod
    def with_train_validation_split(train_ratio: float = 0.75,
                                    seed: int = 42,
                                    splitter: Optional[Splitter] = None,
                                    models: _Models = None, evaluator=None,
                                    stratify: bool = False,
                                    **validator_kw) -> ModelSelector:
        return ModelSelector(
            "multiclass", _tvs(train_ratio, seed, stratify, validator_kw),
            splitter if splitter is not None else DataCutter(seed=seed),
            models, evaluator)


class RegressionModelSelector:
    """Defaults: 3-fold CV (or a 0.75 train/validation split), RMSE
    (smaller is better), DataSplitter."""

    @staticmethod
    def with_cross_validation(num_folds: int = 3, seed: int = 42,
                              splitter: Optional[Splitter] = None,
                              models: _Models = None, evaluator=None,
                              **validator_kw) -> ModelSelector:
        return ModelSelector(
            "regression", _cv(num_folds, seed, False, validator_kw),
            splitter if splitter is not None else DataSplitter(seed=seed),
            models, evaluator)

    @staticmethod
    def with_train_validation_split(train_ratio: float = 0.75,
                                    seed: int = 42,
                                    splitter: Optional[Splitter] = None,
                                    models: _Models = None, evaluator=None,
                                    **validator_kw) -> ModelSelector:
        return ModelSelector(
            "regression", _tvs(train_ratio, seed, False, validator_kw),
            splitter if splitter is not None else DataSplitter(seed=seed),
            models, evaluator)
