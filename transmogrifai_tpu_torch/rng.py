"""Threefry-2x32 random bits, as ``jax.random`` draws them (the JAX
package's RF bootstrap and feature subsets, ``models/trees.py``).

The JAX package runs with ``jax_threefry_partitionable`` on, under which

* a key is two uint32 words; ``prng_key(seed)`` of a uint32 seed is
  ``(0, seed)``;
* ``fold_in(key, data)`` hashes the count pair ``(0, data)`` under the key;
* ``split(key, num)`` hashes the counts ``(0, i)``, i < num, and the two
  output words of count i are key i;
* ``random_bits(key, shape)`` hashes the counts ``(hi, lo)`` of each flat
  index i (its 64 bits cut in two) and returns ``bits1 ^ bits2``;
* ``uniform`` keeps the top 23 bits as the mantissa of a float in [1, 2)
  and subtracts 1; ``bernoulli`` is ``uniform < p`` in float32;
* ``normal`` is ``sqrt(2) * erf_inv(u)`` of a uniform u stretched onto
  [nextafter(-1, 0), 1), with XLA's CPU ``erf_inv`` written out
  (``ops/xla_cpu.xla_erf_inv``).

uint32 arithmetic is done in int64 tensors masked to 32 bits (PyTorch's
uint32 lacks these operations on the CPU and the card). Keys are int64
tensors of shape (..., 2); every function broadcasts over the leading
axes, which is what ``vmap`` over keys gives in the JAX package. These are
plain tensor operations on any device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_F32_BITS = 0x3F800000


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the count pairs (x0, x1)
    under the key (k1, k2); all int64 tensors holding uint32 values,
    broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed: torch.Tensor) -> torch.Tensor:
    """``jax.random.PRNGKey`` of uint32 seeds (any shape) -> (..., 2)."""
    seed = seed.to(torch.int64) & _M32
    return torch.stack([torch.zeros_like(seed), seed], dim=-1)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in``: key (..., 2) and uint32 data broadcast
    together -> (..., 2)."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & _M32
    b0, b1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([b0, b1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (..., 2) -> (..., num, 2)."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(lo), lo)
    return torch.stack([b0, b1], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element: (..., 2) keys -> (..., *shape) int64
    holding uint32 values."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,))
    k2 = key[..., 1].reshape(lead + (1,))
    b0, b1 = threefry2x32(k1, k2, idx >> 32, idx & _M32)
    return (b0 ^ b1).reshape(lead + shape)


def uniform(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.uniform`` in [0, 1), float32: (..., 2) -> (..., *shape)."""
    bits = (random_bits(key, shape) >> 9) | _ONE_F32_BITS
    return bits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key: torch.Tensor, p: float,
              shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bernoulli`` with a float32 probability: uniform < p."""
    p32 = torch.tensor(p, dtype=torch.float32, device=key.device)
    return uniform(key, shape) < p32


#: the least uniform ``normal`` draws: the float32 after -1 toward 0
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(key: torch.Tensor, shape: Sequence[int],
           scale: float = 1.0) -> torch.Tensor:
    """``jax.random.normal`` in float32: (..., 2) -> (..., *shape). The
    uniform is ``max(lo, u * (1 - lo) + lo)`` with 1 - lo rounded to
    float32 (it is 2.0, so the product is exact). ``scale`` is a constant
    factor the caller multiplies in: XLA folds it into the sqrt(2), so the
    draw is ``erf_inv(u) * float32(sqrt(2) * scale)``."""
    from .ops.xla_cpu import xla_erf_inv
    lo = torch.tensor(_NORMAL_LO, dtype=torch.float32, device=key.device)
    span = torch.tensor(1.0, dtype=torch.float32, device=key.device) - lo
    u = torch.maximum(lo, uniform(key, shape) * span + lo)
    factor = np.float32(np.float32(np.sqrt(2)) * np.float32(scale))
    return xla_erf_inv(u) * torch.tensor(float(factor), dtype=torch.float32,
                                         device=key.device)
