"""Random-search hyperparameter grids (counterpart of
``transmogrifai_tpu.impl.selector.random_param_builder``): N points drawn
from per-parameter distributions with numpy's ``RandomState``, the JAX
package's draws bit for bit. A random grid is a grid like any other: a
family sweeps all its points in one batched fit."""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np


class RandomParamBuilder:
    """Fluent random-grid builder::

        grid = (RandomParamBuilder(seed=7)
                .log_uniform("regParam", 1e-4, 1.0)
                .uniform("elasticNetParam", 0.0, 1.0)
                .build(50))
    """

    def __init__(self, seed: int = 42):
        self._rng = np.random.RandomState(seed)
        self._specs: List[Any] = []

    def uniform(self, name: str, lo: float, hi: float) -> "RandomParamBuilder":
        self._specs.append(("uniform", name, float(lo), float(hi)))
        return self

    def log_uniform(self, name: str, lo: float, hi: float) -> "RandomParamBuilder":
        if lo <= 0 or hi <= 0:
            raise ValueError("log_uniform bounds must be positive")
        self._specs.append(("log_uniform", name, float(lo), float(hi)))
        return self

    def integers(self, name: str, lo: int, hi: int) -> "RandomParamBuilder":
        self._specs.append(("integers", name, int(lo), int(hi)))
        return self

    def choice(self, name: str, values: Sequence[Any]) -> "RandomParamBuilder":
        self._specs.append(("choice", name, list(values), None))
        return self

    def build(self, n: int) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for _ in range(n):
            point: Dict[str, Any] = {}
            for kind, name, a, b in self._specs:
                if kind == "uniform":
                    point[name] = float(self._rng.uniform(a, b))
                elif kind == "log_uniform":
                    point[name] = float(np.exp(
                        self._rng.uniform(np.log(a), np.log(b))))
                elif kind == "integers":
                    point[name] = int(self._rng.randint(a, b + 1))
                else:
                    point[name] = a[int(self._rng.randint(len(a)))]
            out.append(point)
        return out
