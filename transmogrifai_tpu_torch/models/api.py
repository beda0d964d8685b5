"""Model-family API, predict contract (counterpart of
``transmogrifai_tpu.models.api``). Fitting waits for the training slice; a
family here turns fitted parameters into predictions on a device.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch


@dataclass
class FittedParams:
    """One fitted configuration's parameters plus the hyperparameters that
    produced it."""
    family: str
    params: Any
    hyper: Dict[str, Any]
    num_classes: int = 2


class ModelFamily(abc.ABC):
    """A model family's predict contract."""

    #: family name, e.g. "OpRandomForestClassifier"
    name: str = ""
    #: problem kinds: subset of {"binary", "multiclass", "regression"}
    supports: frozenset = frozenset()

    @abc.abstractmethod
    def params_from_numpy(self, params: Dict[str, np.ndarray],
                          device) -> Dict[str, torch.Tensor]:
        """Saved numpy parameters -> tensors on ``device``."""

    @abc.abstractmethod
    def predict_parts(self, fitted: FittedParams,
                      X: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Prediction parts on X's device: {'prediction', 'probability'?,
        'rawPrediction'?}."""

    def predict_one(self, fitted: FittedParams,
                    X: torch.Tensor) -> Dict[str, np.ndarray]:
        """``predict_parts`` brought to the host as numpy arrays."""
        return {k: v.cpu().numpy()
                for k, v in self.predict_parts(fitted, X).items()}


MODEL_REGISTRY: Dict[str, ModelFamily] = {}


def register_family(family: ModelFamily) -> ModelFamily:
    MODEL_REGISTRY[family.name] = family
    return family
