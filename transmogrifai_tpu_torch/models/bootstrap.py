"""Random-forest bootstrap draws (counterpart of ``boots_one`` inside the
JAX package's ``_fit_rf_batch``): Poisson(subsamplingRate) row weights by
inverse CDF over threefry uniforms, truncated at 7, and per-tree Bernoulli
feature subsets, bit for bit.

The CDF is 8 float32 values per rate, computed on the host. The JAX
package computes it inside its XLA program on the CPU, so the float32
arithmetic of that program is written out here step by step:

* ``log``, ``log1p`` and ``exp`` are XLA's CPU polynomial approximations
  (Cephes, with multiply-adds fused), not correctly rounded functions
  (``ops.xla_cpu``);
* ``gammaln(k + 1)`` is the Lanczos approximation (g = 7, 8 terms) in
  float32. Where XLA folds it at compile time, its ``log`` and ``log1p``
  are correctly rounded and nothing is fused; where it computes it when
  the program runs, they are the polynomial approximations and the last
  product is fused into its add. The JAX package's ``_fit_rf_batch``
  draws a chunk of configurations at once: XLA computes the table at run
  time when the whole batch is one chunk of at least two configurations,
  and folds it otherwise (one configuration, as in every refit, or a
  ``lax.map`` over several chunks). Both tables are kept, and the caller
  says which (``folded``);
* ``-lam + k * log(lam)`` is one fused multiply-add.

All of it is float32 arithmetic on CPU tensors; the CDF is summed on the
host in order.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import rng
from ..ops.xla_cpu import fma32, xla_exp, xla_log, xla_log1p

_LANCZOS_G = 7.0
_LANCZOS_BASE = 0.99999999999980993227684700473478
_LANCZOS = (676.520368121885098567009190444019,
            -1259.13921672240287047156078755283,
            771.3234287776530788486528258894,
            -176.61502916214059906584551354,
            12.507343278686904814458936853,
            -0.13857109526572011689554707,
            9.984369578019570859563e-6,
            1.50563273514931155834e-7)
_LOG_SQRT_2PI = 0.91893853320467274178032973640562

#: bootstrap counts 0..7 (P[X > 7 | lam <= 1] < 1e-6)
_MAX_COUNT = 7


def _correctly_rounded(fn, x: torch.Tensor) -> torch.Tensor:
    """fn (a float64 ``math`` function) of each float32 value, rounded to
    float32: what XLA folds at compile time."""
    return torch.tensor([fn(v) for v in x.tolist()], dtype=torch.float64
                        ).float()


def _lgamma_f32(x: torch.Tensor, folded: bool) -> torch.Tensor:
    """XLA's float32 log-gamma of x >= 1 (no reflection) on the CPU: the
    Lanczos approximation, its division by 7.5 a multiplication by the
    reciprocal; folded at compile time, or computed at run time."""
    def const(v):
        return torch.full_like(x, float(np.float32(v)))
    z = x - 1.0
    acc = const(_LANCZOS_BASE)
    for i, c in enumerate(_LANCZOS):
        acc = acc + const(c) / ((z + float(i)) + 1.0)
    lph = const(_LANCZOS_G + 0.5)
    t = lph + z
    q = z * (const(1.0) / lph)
    log1p_q = (_correctly_rounded(math.log1p, q) if folded
               else xla_log1p(q))
    log_t = float(np.float32(math.log(_LANCZOS_G + 0.5))) + log1p_q
    u = (z + 0.5) - t / log_t
    if folded:
        return ((float(np.float32(_LOG_SQRT_2PI)) + u * log_t)
                + _correctly_rounded(math.log, acc))
    return fma32(u, log_t, _LOG_SQRT_2PI) + xla_log(acc)


#: gammaln(k + 1), k = 0..7, as XLA computes it at run time / folds it
_LGAMMA = {folded: _lgamma_f32(
    torch.arange(1, _MAX_COUNT + 2, dtype=torch.float32), folded)
           for folded in (False, True)}


def poisson_cdf(rates, folded: bool) -> np.ndarray:
    """(B, 8) float32 CDF of Poisson(rate) at 0..7 for each rate in
    ``rates``: cumsum(exp(-lam + k log(lam) - gammaln(k + 1))), lam =
    max(rate, 1e-12), summed in order; ``folded`` picks the gammaln
    table."""
    lam = torch.clamp(torch.as_tensor(np.asarray(rates, np.float32))
                      .reshape(-1, 1), min=float(np.float32(1e-12)))
    ks = torch.arange(_MAX_COUNT + 1, dtype=torch.float32)[None, :]
    pmf = xla_exp(fma32(ks, xla_log(lam), -lam) - _LGAMMA[folded][None, :])
    return np.cumsum(pmf.numpy(), axis=1, dtype=np.float32)


def feature_share(d: int, task: str) -> float:
    """Spark's featureSubsetStrategy 'auto': sqrt(d) features for
    classification, d / 3 for regression."""
    if task == "classification":
        return float(np.ceil(np.sqrt(d)) / d)
    return max(1.0 / 3.0, 1.0 / d)


def draw(seeds: np.ndarray, rates: np.ndarray, n_trees: int, S: int, d: int,
         p_feat: float, device, folded: bool):
    """Bootstrap weights (C, n_trees, S) float32 and feature masks
    (C, n_trees, d) bool of C configurations: tree t of config c draws
    from ``split(fold_in(PRNGKey(uint32(seed_c)), t))``, the first key for
    its S row uniforms, the second for its d feature coins. ``folded``:
    see ``poisson_cdf``."""
    cdf = torch.from_numpy(poisson_cdf(rates, folded)).to(device)  # (C, 8)
    seed = torch.as_tensor(np.asarray(seeds, np.float32).astype(np.uint32)
                           .astype(np.int64), device=device)
    base = rng.prng_key(seed)                                   # (C, 2)
    trees = torch.arange(n_trees, dtype=torch.int64, device=device)
    keys = rng.split(rng.fold_in(base[:, None, :], trees[None, :]))
    u = rng.uniform(keys[..., 0, :], (S,))                      # (C, T, S)
    boot = (u[..., None] > cdf[:, None, None, :]).sum(-1)
    fmask = rng.bernoulli(keys[..., 1, :], p_feat, (d,))        # (C, T, d)
    return boot.to(torch.float32), fmask
