"""The port's threefry draws (``rng.py``, ``models/bootstrap.py``) against
``jax.random`` and the JAX package's RF bootstrap.

Everything is compared bit for bit: keys, random bits, uniforms, coins,
the Poisson CDF and the bootstrap weights and feature masks. The JAX side
runs with ``jax_threefry_partitionable`` on, as the JAX package sets it.
"""
from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from transmogrifai_tpu_torch import rng  # noqa: E402
from transmogrifai_tpu_torch.models import bootstrap  # noqa: E402
from transmogrifai_tpu_torch.models import trees as ptrees  # noqa: E402


@pytest.fixture(autouse=True)
def partitionable():
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _bits(a) -> np.ndarray:
    """uint32 key or bit arrays as int64, float32 arrays as their bits."""
    a = np.asarray(a)
    if a.dtype == np.float32:
        return a.view(np.int32).astype(np.int64)
    return a.astype(np.int64)


def _t(x) -> np.ndarray:
    return _bits(x.numpy()) if x.dtype == torch.float32 else x.numpy()


@pytest.mark.parametrize("seed", [0, 7, 9, 123456789, 2 ** 32 - 1])
def test_key_fold_in_split_match_jax(seed):
    jk = jax.random.PRNGKey(jnp.uint32(seed))
    pk = rng.prng_key(torch.tensor(seed))
    np.testing.assert_array_equal(pk.numpy(), _bits(jk))
    for t in (0, 1, 49, 2 ** 31 + 5):
        jf = jax.random.fold_in(jk, jnp.uint32(t))
        pf = rng.fold_in(pk, torch.tensor(t))
        np.testing.assert_array_equal(pf.numpy(), _bits(jf))
        for num in (2, 3):
            np.testing.assert_array_equal(rng.split(pf, num).numpy(),
                                          _bits(jax.random.split(jf, num)))


@pytest.mark.parametrize("shape", [(1,), (7,), (1001,), (3, 5, 2)])
def test_bits_uniform_bernoulli_match_jax(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(jnp.uint32(11)), 3)
    pk = torch.from_numpy(_bits(key))
    np.testing.assert_array_equal(
        rng.random_bits(pk, shape).numpy(),
        _bits(jax.random.bits(key, shape, dtype=jnp.uint32)))
    np.testing.assert_array_equal(_t(rng.uniform(pk, shape)),
                                  _bits(jax.random.uniform(key, shape)))
    for p in (0.125, 0.3, float(np.ceil(np.sqrt(64)) / 64)):
        np.testing.assert_array_equal(
            rng.bernoulli(pk, p, shape).numpy(),
            np.asarray(jax.random.bernoulli(key, p, shape)))


def test_vmapped_fold_in_over_trees_matches_jax():
    """Keys batched over (configs, trees), as ``vmap`` gives them."""
    seeds = jnp.arange(3, dtype=jnp.float32) + 7.0

    def per_config(seed):
        base = jax.random.PRNGKey(seed.astype(jnp.uint32))

        def per_tree(t):
            k1, k2 = jax.random.split(jax.random.fold_in(base, t))
            return (jax.random.uniform(k1, (37,)),
                    jax.random.bernoulli(k2, 0.3, (5,)))
        return jax.vmap(per_tree)(jnp.arange(6))

    ju, jb = jax.jit(jax.vmap(per_config))(seeds)
    base = rng.prng_key(torch.arange(3) + 7)
    keys = rng.split(rng.fold_in(base[:, None, :], torch.arange(6)[None, :]))
    np.testing.assert_array_equal(_t(rng.uniform(keys[..., 0, :], (37,))),
                                  _bits(ju))
    np.testing.assert_array_equal(
        rng.bernoulli(keys[..., 1, :], 0.3, (5,)).numpy(), np.asarray(jb))


def _jax_boots(seeds, rates, n_trees, S, d, p_feat, cb=None):
    """``boots_one`` of the JAX package's ``_fit_rf_batch``, vmapped over
    chunks of ``cb`` configurations (default: all) under ``lax.map``
    inside a jitted program, as there. Returns ((boots, fmasks), cdf)."""
    B = len(seeds)
    cb = cb or B

    def boots_one(seed_c, ss_c):
        base = jax.random.PRNGKey(seed_c.astype(jnp.uint32))
        ks = jnp.arange(8, dtype=jnp.float32)
        lam = jnp.maximum(ss_c.astype(jnp.float32), 1e-12)
        log_pmf = (-lam + ks * jnp.log(lam)
                   - jax.scipy.special.gammaln(ks + 1.0))
        cdf = jnp.cumsum(jnp.exp(log_pmf))

        def per_tree(t):
            k1, k2 = jax.random.split(jax.random.fold_in(base, t))
            u = jax.random.uniform(k1, (S,))
            boot = (u[:, None] > cdf[None, :]).sum(-1).astype(jnp.float32)
            return boot, jax.random.bernoulli(k2, p_feat, (d,))
        return jax.vmap(per_tree)(jnp.arange(n_trees)), cdf

    def program(seeds, rates):
        chunks = (seeds.reshape(-1, cb), rates.reshape(-1, cb))
        out = jax.lax.map(lambda ch: jax.vmap(boots_one)(*ch), chunks)
        return jax.tree_util.tree_map(
            lambda a: a.reshape((B,) + a.shape[2:]), out)

    return jax.jit(program)(jnp.asarray(seeds), jnp.asarray(rates))


def _folded(B, cb=None):
    """The table ``_fit_rf_batch`` picks for B configurations in chunks
    of cb."""
    return ptrees._cdf_folded(B, cb or B)


@pytest.mark.parametrize("B,cb", [(1, None), (3, None), (2, 1), (4, 2)])
@pytest.mark.parametrize("rate", [1.0, 0.8, 0.5])
def test_poisson_cdf_is_bit_equal(rate, B, cb):
    rates = np.full(B, rate, np.float32)
    _, cdf = _jax_boots(np.arange(B, dtype=np.float32) + 7.0, rates, 1, 4,
                        2, 0.5, cb)
    np.testing.assert_array_equal(
        _bits(bootstrap.poisson_cdf(rates, _folded(B, cb))), _bits(cdf))


def test_poisson_cdf_over_many_rates():
    rates = np.random.RandomState(0).uniform(0.02, 1.0, 64).astype(
        np.float32)
    for cb in (64, 16):
        _, cdf = _jax_boots(np.arange(64, dtype=np.float32), rates, 1, 4, 2,
                            0.5, cb)
        np.testing.assert_array_equal(
            _bits(bootstrap.poisson_cdf(rates, _folded(64, cb))), _bits(cdf))


@pytest.mark.parametrize("d,task,B", [(64, "classification", 4),
                                      (5, "regression", 1)])
def test_bootstrap_weights_and_feature_masks_are_bit_equal(d, task, B):
    seeds = np.arange(B, dtype=np.float32) + 7.0
    rates = np.array([1.0, 0.8, 0.5, 1.0][:B], np.float32)
    p_feat = bootstrap.feature_share(d, task)
    (jb, jf), _ = _jax_boots(seeds, rates, 16, 5000, d, p_feat)
    pb, pf = bootstrap.draw(seeds, rates, 16, 5000, d, p_feat, "cpu",
                            _folded(B))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    assert pb.dtype == torch.float32 and pf.dtype == torch.bool
