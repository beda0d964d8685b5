"""Random-forest bootstrap draws (counterpart of ``boots_one`` inside the
JAX package's ``_fit_rf_batch``): Poisson(subsamplingRate) row weights by
inverse CDF over threefry uniforms, truncated at 7, and per-tree Bernoulli
feature subsets, bit for bit.

The CDF is 8 float32 values per rate, computed on the host. The JAX
package computes it inside its XLA program on the CPU, so the float32
arithmetic of that program is written out here step by step:

* ``log``, ``log1p`` and ``exp`` are XLA's CPU polynomial approximations
  (Cephes, with multiply-adds fused), not correctly rounded functions;
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

A fused multiply-add is computed in float64 (the product of two float32
values is exact there) and rounded once to float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import rng

_F = np.float32

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

_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
               6.5787325942061044846969e0, 2.9911919328553073277375e1,
               6.0949667980987787057556e1, 5.7112963590585538103336e1,
               2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469310e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)

#: bootstrap counts 0..7 (P[X > 7 | lam <= 1] < 1e-6)
_MAX_COUNT = 7


def _fma(a, b, c) -> np.ndarray:
    f64 = np.float64
    return (np.asarray(a, f64) * np.asarray(b, f64)
            + np.asarray(c, f64)).astype(_F)


def _log_f32(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 log of positive normal x."""
    x = np.asarray(x, _F)
    bits = x.view(np.int32)
    e = ((bits >> 23) - 0x7F).astype(_F) + _F(1)
    m = ((bits & ~0x7F800000) | _F(0.5).view(np.int32)).view(_F)
    low = m < _F(0.707106781186547524)
    t = ((m - _F(1)) + np.where(low, m, _F(0))).astype(_F)
    e = (e - np.where(low, _F(1), _F(0))).astype(_F)
    x2 = (t * t).astype(_F)
    x3 = (x2 * t).astype(_F)
    p = _LOG_P
    y = _fma(t, _F(p[0]), _F(p[1]))
    y1 = _fma(t, _F(p[3]), _F(p[4]))
    y2 = _fma(t, _F(p[6]), _F(p[7]))
    y = _fma(y, t, _F(p[2]))
    y1 = _fma(y1, t, _F(p[5]))
    y2 = _fma(y2, t, _F(p[8]))
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, (_F(-2.12194440e-4) * e).astype(_F))
    t = _fma(_F(-0.5), x2, t)
    t = (t + y).astype(_F)
    return _fma(_F(0.693359375), e, t)


def _exp_f32(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 exp, for x in the normal range of the result."""
    x = np.asarray(x, _F)
    n = np.floor(_fma(x, _F(1.44269504088896341), _F(0.5)))
    a = _fma(n, _F(-0.693359375), x)
    a = _fma(n, _F(2.12194440e-4), a)
    z = (a * a).astype(_F)
    y = _fma(a, _F(_EXP_P[0]), _F(_EXP_P[1]))
    for c in _EXP_P[2:]:
        y = _fma(y, a, _F(c))
    y = _fma(y, z, a)
    y = (_F(1) + y).astype(_F)
    return np.ldexp(y, n.astype(np.int32)).astype(_F)


def _poly_f32(x, coeffs) -> np.float32:
    """Horner's rule from the leading coefficient, one fused multiply-add
    per step."""
    p = _F(0)
    for c in coeffs:
        p = _fma(p, x, _F(c))
    return _F(p)


def _log1p_f32(x) -> np.float32:
    """XLA's CPU float32 log1p: a Cephes rational function below
    sqrt(2) - 1, else log(1 + x)."""
    x = _F(x)
    if abs(x) < 0.41421356237309504880:
        x2 = _F(x * x)
        r = _F(_poly_f32(x, _LOG1P_NUM) / _poly_f32(x, _LOG1P_DEN))
        r = _fma(_F(-0.5), x2, _F(_F(x * x2) * r))
        return _F(x + r)
    return _F(_log_f32(np.array([_F(x + _F(1))]))[0])


def _lgamma_f32(x: float, folded: bool) -> np.float32:
    """XLA's float32 log-gamma of x >= 1 (no reflection) on the CPU: the
    Lanczos approximation, its division by 7.5 a multiplication by the
    reciprocal; folded at compile time, or computed at run time."""
    x = _F(x)
    z = _F(x - _F(1))
    acc = _F(_LANCZOS_BASE)
    for i, c in enumerate(_LANCZOS):
        acc = _F(acc + _F(_F(c) / _F(_F(z + _F(i)) + _F(1))))
    lph = _F(_LANCZOS_G + 0.5)
    t = _F(lph + z)
    q = _F(z * _F(_F(1) / lph))
    log1p_q = _F(math.log1p(float(q))) if folded else _log1p_f32(q)
    log_t = _F(_F(math.log(_LANCZOS_G + 0.5)) + log1p_q)
    u = _F(_F(z + _F(0.5)) - _F(t / log_t))
    if folded:
        return _F(_F(_F(_LOG_SQRT_2PI) + _F(u * log_t))
                  + _F(math.log(float(acc))))
    s = _fma(u, log_t, _F(_LOG_SQRT_2PI))
    return _F(s + _F(_log_f32(np.array([acc]))[0]))


#: gammaln(k + 1), k = 0..7, as XLA computes it at run time / folds it
_LGAMMA = {folded: np.array([_lgamma_f32(k + 1.0, folded)
                             for k in range(_MAX_COUNT + 1)], _F)
           for folded in (False, True)}


def poisson_cdf(rates, folded: bool) -> np.ndarray:
    """(B, 8) float32 CDF of Poisson(rate) at 0..7 for each rate in
    ``rates``: cumsum(exp(-lam + k log(lam) - gammaln(k + 1))), lam =
    max(rate, 1e-12), summed in order; ``folded`` picks the gammaln
    table."""
    lam = np.maximum(np.asarray(rates, _F).reshape(-1, 1), _F(1e-12))
    ks = np.arange(_MAX_COUNT + 1, dtype=_F)[None, :]
    a = _fma(ks, _log_f32(lam), -lam)
    pmf = _exp_f32((a - _LGAMMA[folded][None, :]).astype(_F))
    return np.cumsum(pmf, axis=1, dtype=_F)


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
