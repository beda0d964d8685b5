"""The port's device-side NLP arithmetic against the JAX package on the CPU:
``rng.randint``, the XLA CPU functions it writes out (``xla_digamma`` and
the glibc sine and cosine under it, ``xla_sigmoid``), the ordered scatter
(``xla_scatter_add``: ``np.add.at`` on the CPU, and the rounds the card
takes, ``scatter_add_rounds``), word2vec's pair reservoir, and ``OpWord2Vec`` /
``OpLDA`` fitted and applied at ``tests/test_text_stages.py``'s sizes and
a little wider.

Tolerances: none. ``rng.randint`` and the written-out functions are bit
for bit on grids of inputs; both scatters equal numpy's ``np.add.at``
(one update after another in their order) and XLA's bit for bit; the
word2vec vectors and means, and the LDA topics and mixtures, are bit for
bit (measured gap 0) wherever the vector size is below 8 or a multiple of
8 -- XLA's order for the other sizes' dot is not reproduced, and there the
measured gap is stated at ``test_word2vec_other_sizes_stay_close``.
"""
from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from transmogrifai_tpu import types as JT  # noqa: E402
from transmogrifai_tpu.features import (  # noqa: E402
    FeatureBuilder as JFB, reset_uids as jax_reset,
)
from transmogrifai_tpu.impl.feature import text as JX  # noqa: E402
from transmogrifai_tpu.table import (  # noqa: E402
    Column as JColumn, FeatureTable as JTable,
)
from transmogrifai_tpu_torch import rng as prng  # noqa: E402
from transmogrifai_tpu_torch import types as PT  # noqa: E402
from transmogrifai_tpu_torch.features import (  # noqa: E402
    FeatureBuilder as PFB, reset_uids as port_reset,
)
from transmogrifai_tpu_torch.impl.feature import text as PX  # noqa: E402
from transmogrifai_tpu_torch.ops import xla_cpu  # noqa: E402
from transmogrifai_tpu_torch.table import (  # noqa: E402
    Column as PColumn, FeatureTable as PTable,
)

#: the largest gap of a word2vec mean vector at a vector size whose dot
#: order is not reproduced (12, on ``_cluster_docs``, 60 steps):
#: measured 4.59e-6; held to 1e-5
OTHER_SIZE_ATOL = 1e-5


def host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def same_bits(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    both_nan = np.isnan(got) & np.isnan(want)
    bad = (got.view(np.int32) != want.view(np.int32)) & ~both_nan
    assert not bad.any(), (int(bad.sum()), got[bad][:5], want[bad][:5])


# ---------------------------------------------------------------------------
# rng.randint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("span", [1, 2, 3, 7, 1000, 4096, 65535, 65536,
                                  65537, 70001, 1_234_567, 2_000_000,
                                  2 ** 31 - 10])
@pytest.mark.parametrize("lo", [0, 5])
def test_randint_bit_equal(span, lo):
    for seed in (0, 42):
        jk = jax.random.split(jax.random.PRNGKey(seed), 3)[1]
        pk = prng.split(prng.prng_key(torch.tensor(seed)), 3)[1]
        want = np.asarray(jax.random.randint(jk, (64, 3), lo, lo + span))
        got = prng.randint(pk, (64, 3), lo, lo + span).numpy()
        np.testing.assert_array_equal(got, want)


def test_randint_empty_span_gives_minval():
    pk = prng.prng_key(torch.tensor(3))
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (8,), 4, 4))
    np.testing.assert_array_equal(prng.randint(pk, (8,), 4, 4).numpy(), want)


# ---------------------------------------------------------------------------
# XLA's CPU functions
# ---------------------------------------------------------------------------

def _grid(seed):
    r = np.random.RandomState(seed)
    return np.concatenate([
        r.uniform(0, 0.5, 60000), r.uniform(0.5, 50, 40000),
        r.uniform(-20, 0, 20000), np.exp(r.uniform(-20, 8, 40000)),
        np.arange(-5, 5, 0.25), [0.0, -0.0, 1e-30, 3e38]]).astype(np.float32)


def test_digamma_bit_equal():
    x = _grid(0)
    same_bits(xla_cpu.xla_digamma(torch.from_numpy(x)).numpy(),
              np.asarray(jax.jit(jax.scipy.special.digamma)(x)))


def test_torch_digamma_differs_from_xla():
    """Why it is written out: PyTorch's digamma is not XLA's."""
    x = _grid(1)
    want = np.asarray(jax.jit(jax.scipy.special.digamma)(x))
    got = torch.special.digamma(torch.from_numpy(x)).numpy()
    assert (got.view(np.int32) != want.view(np.int32)).any()


@pytest.mark.parametrize("fn", ["sin", "cos"])
def test_glibc_sincos_bit_equal(fn):
    r = np.random.RandomState(2)
    a = np.concatenate([r.uniform(-1.6, 1.6, 100000),
                        r.uniform(-1e-3, 1e-3, 2000),
                        r.uniform(-110, 110, 50000)]).astype(np.float32)
    want = np.asarray(jax.jit(getattr(jnp, fn))(a))
    got = xla_cpu._glibc_sincos(torch.from_numpy(a), fn == "cos").numpy()
    same_bits(got, want)


def test_sigmoid_bit_equal_and_torch_differs():
    x = np.random.RandomState(3).uniform(-90, 90, 200000).astype(np.float32)
    want = np.asarray(jax.jit(jax.nn.sigmoid)(x))
    same_bits(xla_cpu.xla_sigmoid(torch.from_numpy(x)).numpy(), want)
    plain = torch.sigmoid(torch.from_numpy(x)).numpy()
    assert (plain.view(np.int32) != want.view(np.int32)).any()


# ---------------------------------------------------------------------------
# The ordered scatter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,n", [(300, 4096), (5, 1000), (1, 7),
                                    (100, 1), (50, 0)])
def test_scatter_add_is_the_sequential_in_order_add(rows, n):
    r = np.random.RandomState(rows + n)
    W = r.randn(rows, 32).astype(np.float32)
    idx = (r.zipf(1.5, n) % rows).astype(np.int64)
    u = (r.randn(n, 32) * 1e-3).astype(np.float32)
    want = W.copy()
    np.add.at(want, idx, u)
    jw = np.asarray(jax.jit(lambda w, i, v: w.at[i].add(v))(W, idx, u))
    same_bits(want, jw)
    for fn in (xla_cpu.xla_scatter_add, xla_cpu.scatter_add_rounds):
        got = fn(torch.from_numpy(W.copy()), torch.from_numpy(idx),
                 torch.from_numpy(u)).numpy()
        same_bits(got, want)


def test_index_put_accumulate_is_not_that_order():
    """Why the scatter is written out: PyTorch's accumulating index_put_
    adds duplicates in another order."""
    r = np.random.RandomState(0)
    W = r.randn(300, 32).astype(np.float32)
    idx = r.randint(0, 300, 4096)
    u = (r.randn(4096, 32) * 1e-3).astype(np.float32)
    want = W.copy()
    np.add.at(want, idx, u)
    t = torch.from_numpy(W.copy())
    t.index_put_((torch.from_numpy(idx),), torch.from_numpy(u),
                 accumulate=True)
    assert (t.numpy() != want).any()


# ---------------------------------------------------------------------------
# Word2vec and LDA
# ---------------------------------------------------------------------------

def _reservoir(docs, window, cap, seed):
    """The JAX package's reservoir, one pair and one draw at a time."""
    rng = np.random.RandomState(seed)
    centers, contexts, seen = [], [], 0
    for ids in docs:
        for i, c in enumerate(ids):
            for j in range(max(0, i - window), min(len(ids), i + window + 1)):
                if j == i:
                    continue
                seen += 1
                if len(centers) < cap:
                    centers.append(c)
                    contexts.append(ids[j])
                else:
                    r = rng.randint(0, seen)
                    if r < cap:
                        centers[r], contexts[r] = c, ids[j]
    return np.array(centers, np.int64), np.array(contexts, np.int64)


@pytest.mark.parametrize("cap", [10 ** 9, 5000, 100, 1])
def test_skipgram_pairs_are_the_jax_reservoir(cap):
    r = np.random.RandomState(0)
    docs = [r.randint(0, 50, r.randint(0, 30)).astype(np.int64)
            for _ in range(300)]
    want = _reservoir(docs, 5, cap, 3)
    got = PX.skipgram_pairs(docs, 5, cap, 3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def run_both(cls, kw, type_name, rows):
    """(JAX fitted stage, its output column, port fitted stage, its
    output column) of ``cls`` fitted on a column of ``rows``."""
    out = []
    for m, FB, reset, Col, Tab, T in (
            (JX, JFB, jax_reset, JColumn, JTable, JT),
            (PX, PFB, port_reset, PColumn, PTable, PT)):
        reset()
        ft = T.FEATURE_TYPES[type_name]
        f = FB("f", ft).extract_field().as_predictor()
        t = Tab({"f": Col.of_values(ft, rows)}, len(rows))
        st = getattr(m, cls)(**kw).set_input(f).fit(t)
        out += [st, st.transform_column(t)]
    return out


def _cluster_docs():
    """``test_text_stages.py``'s two co-occurrence clusters."""
    rng = np.random.RandomState(0)
    return [list(rng.permutation(["cat", "dog", "pet"])) if rng.rand() < 0.5
            else list(rng.permutation(["car", "road", "drive"]))
            for _ in range(200)]


def _zipf_docs(n=300, vocab=300, seed=1):
    """Documents of 0-40 words with frequencies falling as 1/sqrt(rank),
    5% missing."""
    rng = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(vocab)]
    p = 1.0 / np.sqrt(np.arange(1, vocab + 1))
    p /= p.sum()
    return [None if rng.rand() < 0.05 else
            list(rng.choice(words, rng.randint(0, 40), p=p))
            for _ in range(n)]


@pytest.mark.parametrize("docs,kw", [
    ("clusters", dict(vector_size=16, min_count=1, steps=20, seed=1)),
    ("zipf", dict(vector_size=32, steps=8, seed=42)),
    ("zipf", dict(vector_size=4, steps=30, window=2, num_negatives=2,
                  seed=7)),
    ("zipf", dict(vector_size=8, steps=20, max_pairs=3000, seed=3)),
])
def test_word2vec_bit_equal(docs, kw):
    rows = _cluster_docs() if docs == "clusters" else _zipf_docs()
    js, jc, ps, pc = run_both("OpWord2Vec", kw, "TextList", rows)
    assert ps.vocab == js.vocab
    same_bits(host(ps.vectors), host(js.vectors))
    same_bits(host(pc.values), host(jc.values))


def test_word2vec_other_sizes_stay_close():
    """A vector size past 8 and not a multiple of 8 takes another dot
    order than XLA's: the vectors stay within OTHER_SIZE_ATOL."""
    js, jc, ps, pc = run_both(
        "OpWord2Vec", dict(vector_size=12, min_count=1, steps=60, seed=1),
        "TextList", _cluster_docs())
    gap = np.abs(host(pc.values) - host(jc.values)).max()
    print("word2vec size 12 gap", gap)
    assert gap <= OTHER_SIZE_ATOL


def test_word2vec_tiny_vocabularies():
    for rows in ([["a", "b"], None], [["a"], ["a"]], [None, None]):
        js, jc, ps, pc = run_both("OpWord2Vec", dict(vector_size=8),
                                  "TextList", rows)
        same_bits(host(ps.vectors), host(js.vectors))
        same_bits(host(pc.values), host(jc.values))


def _lda_counts(kind):
    rng = np.random.RandomState(0)
    if kind == "topics":       # test_text_stages.py's two disjoint topics
        X = np.zeros((120, 6), dtype=np.float32)
        for i in range(120):
            X[i, :3 if i % 2 == 0 else 3:6] = 0
            if i % 2 == 0:
                X[i, :3] = rng.poisson(5, 3)
            else:
                X[i, 3:] = rng.poisson(5, 3)
        return X
    return rng.poisson(0.2, (300, 64)).astype(np.float32)


@pytest.mark.parametrize("kind,kw", [
    ("topics", dict(k=2, max_iter=20, seed=0)),
    ("sparse", dict(k=10, max_iter=2, seed=1)),
    ("sparse", dict(k=3, max_iter=3, alpha=0.5, beta=0.1, seed=2)),
])
def test_lda_bit_equal(kind, kw):
    X = _lda_counts(kind)
    js, jc, ps, pc = run_both("OpLDA", kw, "OPVector", [list(r) for r in X])
    same_bits(host(ps.topics), host(js.topics))
    same_bits(host(pc.values), host(jc.values))
