"""The float32 arithmetic of the JAX package's XLA programs on the CPU,
written out in PyTorch, where a result must match the JAX package's bits
(the RF bootstrap's Poisson CDF, the boosting state of GBT regression and
multiclass):

* XLA contracts a product into the add that follows it: ``fma32``
  computes it in float64, where the product of two float32 values is
  exact, and rounds once;
* its ``exp`` is the Cephes polynomial with float32 constants, its input
  clamped and subnormal results flushed to 0 (``xla_exp``); its ``log``
  and ``log1p`` are Cephes approximations too (``xla_log``,
  ``xla_log1p``), every multiply-add in them fused;
* it reduces more than 32 elements in windows of 32, each added in order
  (``xla_sum``);
* its ``erf_inv`` (``jax.random.normal``'s) is Giles' float32
  approximation: w = -log1p(-x^2), a polynomial in w - 2.5 or
  sqrt(w) - 3 by the branch w < 5, times x (``xla_erf_inv``).

Only float32 and float64 elementwise operations are used, so a CUDA
tensor gets the same bits as a CPU one.
"""
from __future__ import annotations

import numpy as np
import torch

#: XLA's CPU float32 exp (Cephes): input clamp and the polynomial
_EXP_CLAMP = (-87.8, 88.8)
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)

#: XLA's CPU float32 log (Cephes): the polynomial of the mantissa
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
#: and its log1p below sqrt(2) - 1: a rational function
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469310e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)

#: the least normal float32
_F32_TINY = float(np.finfo(np.float32).tiny)

#: XLA on the CPU rewrites a reduction of more than this many elements
#: into windows of this many, each added in order
REDUCE_WINDOW = 32


def fma32(a, b, c) -> torch.Tensor:
    """a * b + c of float32 values (a python constant is rounded to
    float32 first), rounded once to float32."""
    def f64(v):
        return (v.double() if isinstance(v, torch.Tensor)
                else float(np.float32(v)))
    return (f64(a) * f64(b) + f64(c)).float()


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """A float32 result below the normal range becomes 0."""
    return torch.where(x.abs() < _F32_TINY, torch.zeros_like(x), x)


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """e^x = e^a * 2^n with n = floor(x log2(e) + 0.5), n clamped to
    [-127, 127], and a Cephes polynomial for e^a."""
    x = torch.clamp(x, *_EXP_CLAMP)
    n = torch.clamp(torch.floor(fma32(x, 1.44269504088896341, 0.5)),
                    -127.0, 127.0)
    a = fma32(n, -0.693359375, x)
    a = fma32(n, 2.12194440e-4, a)
    z = a * a
    y = fma32(a, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        y = fma32(y, a, c)
    y = 1.0 + fma32(y, z, a)
    return flush_subnormal((y.double() * torch.pow(2.0, n.double()))
                           .float())


def _f32(v: float) -> float:
    """A python constant rounded to float32 (exact in either precision)."""
    return float(np.float32(v))


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """log of positive normal float32 x: x = m * 2^e with m in
    [sqrt(1/2), sqrt(2)), log(m) by the Cephes polynomial in t = m - 1,
    e * log(2) added in two parts."""
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    half = int(np.float32(0.5).view(np.int32))
    m = ((bits & ~0x7F800000) | half).view(torch.float32)
    low = m < _f32(0.707106781186547524)
    t = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.float()
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = fma32(t, p[0], p[1])
    y1 = fma32(t, p[3], p[4])
    y2 = fma32(t, p[6], p[7])
    y = fma32(y, t, p[2])
    y1 = fma32(y1, t, p[5])
    y2 = fma32(y2, t, p[8])
    y = fma32(y, x3, y1)
    y = fma32(y, x3, y2)
    y = fma32(y, x3, _f32(-2.12194440e-4) * e)
    t = fma32(-0.5, x2, t)
    return fma32(0.693359375, e, t + y)


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    """A polynomial from its leading coefficient, one fused multiply-add
    per step."""
    p = torch.zeros_like(x)
    for c in coeffs:
        p = fma32(p, x, c)
    return p


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """log(1 + x) of float32 x > -1: a Cephes rational function where
    |x| < sqrt(2) - 1, else ``xla_log(1 + x)``."""
    x2 = x * x
    r = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = x + fma32(-0.5, x2, (x * x2) * r)
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       xla_log(x + 1.0))


#: Giles' float32 erf_inv coefficients, leading first: w < 5, else
_ERF_INV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                -4.39150654e-06, 0.00021858087, -0.00125372503,
                -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def xla_erf_inv(x: torch.Tensor) -> torch.Tensor:
    """erf^-1 of float32 x in (-1, 1): w = -log1p(-x * x) (``xla_log1p``),
    the branch's coefficients selected per element, a Horner polynomial of
    fused multiply-adds in w - 2.5 (w < 5) or sqrt(w) - 3, times x; +-inf
    at +-1. The square root is taken in float64 and rounded once, which is
    IEEE's float32 square root on any device (PyTorch's vectorized float32
    CPU square root can be an ulp low)."""
    w = -xla_log1p(-(x * x))
    lt = w < 5.0
    z = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = None
    for a, b in zip(_ERF_INV_LT5, _ERF_INV_GE5):
        c = torch.where(lt, torch.tensor(_f32(a), device=x.device),
                        torch.tensor(_f32(b), device=x.device))
        p = c if p is None else fma32(p, z, c)
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 1, one element at a time from the first."""
    acc = x[:, 0].clone()
    for i in range(1, x.shape[1]):
        acc = acc + x[:, i]
    return acc


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0: while more than ``REDUCE_WINDOW`` elements remain,
    pad them to whole windows (half the padding in front) and add each
    window in order; then add what remains in order."""
    W = REDUCE_WINDOW
    while x.shape[0] > W:
        n = x.shape[0]
        pad = -(-n // W) * W - n
        x = torch.cat([x.new_zeros((pad // 2,) + tuple(x.shape[1:])), x,
                       x.new_zeros((pad - pad // 2,) + tuple(x.shape[1:]))])
        x = _seq_sum(x.reshape((-1, W) + tuple(x.shape[1:])))
    return _seq_sum(x[None])[0]


def xla_softmax(F: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax(F, axis=1)``: the max subtracted, ``xla_exp``, the
    sum over axis 1 in ``xla_sum``'s order, subnormal results flushed."""
    e = xla_exp(F - F.max(dim=1, keepdim=True).values)
    return flush_subnormal(e / xla_sum(e.movedim(1, 0)).unsqueeze(1))
