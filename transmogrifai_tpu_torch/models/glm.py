"""Generalized linear model family (counterpart of
``transmogrifai_tpu.models.glm``).

One IRLS (iteratively reweighted least squares) loop of fixed length fits
every distribution family; the working response and weights are chosen per
configuration by its family code, so a mixed gaussian/poisson grid is one
batch. The (d + 1) x (d + 1) systems of all B configurations are solved in
one batched ``torch.linalg.solve`` a step.

Links: gaussian -> identity; poisson / gamma / tweedie -> log (the JAX
package uses log for gamma too, for robustness on standardized features).
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from ..histeng.kernels import _tf32_off
from ..ops.xla_cpu import xla_exp
from .api import FittedParams, register_family
from .linear import _grid_tensor, _LinearFamily

_F32 = torch.float32

#: distribution family codes (carried as float32 through grid arrays)
FAMILY_CODES = {"gaussian": 0.0, "poisson": 1.0, "gamma": 2.0, "tweedie": 3.0}


def _fit_glm_batch(X, y, W, reg, fam, var_power, iters=25):
    """IRLS for B configurations: X (n, d), y (n,), W (B, n) row weights,
    reg / fam / var_power (B,) (var_power: tweedie's Var(mu) = mu^p).
    Every step keeps a configuration's proposal only when all of it is
    finite, and the result is each configuration's best-deviance iterate
    (a log link on negative labels oscillates or blows up). Returns (coef
    (B, d), bias (B,))."""
    with _tf32_off():
        nB, n, d = W.shape[0], X.shape[0], X.shape[1]
        dev = X.device
        Xa = torch.cat([X, torch.ones((n, 1), dtype=_F32, device=dev)], 1)
        cnt = torch.clamp(W.sum(1), min=1.0)                     # (B,)
        is_gauss = (fam == FAMILY_CODES["gaussian"])[:, None]    # (B, 1)
        one, two = torch.ones_like(fam), torch.full_like(fam, 2.0)
        p = torch.where(fam == FAMILY_CODES["poisson"], one,
                        torch.where(fam == FAMILY_CODES["gamma"], two,
                                    var_power))[:, None]
        ridge = torch.diag_embed(torch.cat(
            [reg[:, None].expand(nB, d),
             torch.zeros((nB, 1), dtype=_F32, device=dev)], dim=1)) \
            + 1e-8 * torch.eye(d + 1, dtype=_F32, device=dev)

        def deviance(theta):
            """Weighted mean loss per configuration: gaussian squared
            error; log link -y eta + mu (poisson-shaped)."""
            eta = torch.clamp(theta @ Xa.T, -30.0, 30.0)         # (B, n)
            loss = torch.where(is_gauss, 0.5 * (y - eta) ** 2,
                               xla_exp(eta) - y * eta)
            return (loss * W).sum(1) / cnt

        theta = torch.zeros((nB, d + 1), dtype=_F32, device=dev)
        best, best_loss = theta, deviance(theta)
        for _ in range(iters):
            eta = theta @ Xa.T                                   # (B, n)
            mu = xla_exp(torch.clamp(eta, -30.0, 30.0))
            mu_c = torch.clamp(mu, min=1e-12)
            Wk = torch.where(is_gauss, 1.0, torch.pow(mu_c, 2.0 - p)) * W
            z = torch.where(is_gauss, y, torch.clamp(
                eta + (y - mu) / mu_c, -1e6, 1e6))
            A = (Xa.T[None] * Wk[:, None, :]) @ Xa / cnt[:, None, None] \
                + ridge
            rhs = (Wk * z) @ Xa / cnt[:, None]
            prop = torch.linalg.solve(A, rhs)
            prop = torch.where(torch.isfinite(prop).all(1, keepdim=True),
                               prop, theta)
            loss = deviance(prop)
            better = (loss < best_loss)[:, None]
            best = torch.where(better, prop, best)
            best_loss = torch.where(better[:, 0], loss, best_loss)
            theta = prop
        return best[:, :d], best[:, d]


def _glm_mean(margin: torch.Tensor, fam: torch.Tensor) -> torch.Tensor:
    """The inverse link: identity for gaussian, exp (clipped) otherwise."""
    return torch.where(fam == FAMILY_CODES["gaussian"], margin,
                       xla_exp(torch.clamp(margin, -30.0, 30.0)))


class GeneralizedLinearRegressionFamily(_LinearFamily):
    """reference OpGeneralizedLinearRegression (defaults: family
    {gaussian, poisson} x regParam {0.001, 0.01, 0.1, 0.2})."""

    name = "OpGeneralizedLinearRegression"
    supports = frozenset({"regression"})

    def default_grid(self, problem: str) -> List[Dict[str, Any]]:
        return [{"family": f, "regParam": r}
                for f in ("gaussian", "poisson")
                for r in (0.001, 0.01, 0.1, 0.2)]

    def grid_to_arrays(self, grid: Sequence[Dict[str, Any]]
                       ) -> Dict[str, np.ndarray]:
        coded = []
        for g in grid:
            g = dict(g)
            if isinstance(g.get("family", "gaussian"), str):
                g["family"] = FAMILY_CODES[g.get("family", "gaussian")]
            g.setdefault("variancePower", 1.5)
            coded.append(g)
        return super().grid_to_arrays(coded)

    def fit_batch(self, X, y, weights, grid, num_classes):
        fam = _grid_tensor(grid, "family", X, 0.0)
        coef, bias = _fit_glm_batch(
            X, y, weights, _grid_tensor(grid, "regParam", X), fam,
            _grid_tensor(grid, "variancePower", X, 1.5))
        return {"coef": coef, "bias": bias, "family": fam}

    def predict_batch(self, params, X, num_classes):
        with _tf32_off():
            margin = params["coef"] @ X.T + params["bias"][:, None]
        return _glm_mean(margin, params["family"][:, None])

    def predict_parts(self, fitted: FittedParams, X):
        with _tf32_off():
            margin = X @ fitted.params["coef"] + fitted.params["bias"]
        return {"prediction": _glm_mean(margin, fitted.params["family"])}


register_family(GeneralizedLinearRegressionFamily())
