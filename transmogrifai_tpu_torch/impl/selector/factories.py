"""ModelSelector factories (counterpart of
``transmogrifai_tpu.impl.selector.factories``)."""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..tuning.splitters import DataBalancer, Splitter
from ..tuning.validators import OpCrossValidation
from .model_selector import ModelSelector


class BinaryClassificationModelSelector:
    """Defaults: 3-fold CV, AuPR, DataBalancer."""

    @staticmethod
    def with_cross_validation(num_folds: int = 3, seed: int = 42,
                              splitter: Optional[Splitter] = None,
                              models: Optional[Sequence[Tuple[
                                  Any, Optional[List[Dict]]]]] = None,
                              evaluator=None, stratify: bool = False,
                              **validator_kw) -> ModelSelector:
        return ModelSelector(
            problem="binary",
            validator=OpCrossValidation(num_folds=num_folds, seed=seed,
                                        stratify=stratify, **validator_kw),
            splitter=(splitter if splitter is not None
                      else DataBalancer(seed=seed)),
            models=models, evaluator=evaluator)
