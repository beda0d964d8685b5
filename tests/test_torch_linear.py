"""The linear families and GLM of the PyTorch port against the JAX package
on the CPU, on the same seeded numpy inputs: ``_BatchStd``, the batched
solvers (``_fit_logreg_batch`` at sweep and refit settings,
``_fit_softmax_batch``, ``_fit_linreg_batch``, ``_fit_svc_batch``,
``_fit_nb_batch``, ``_fit_glm_batch``) and every family's
``predict_batch`` / ``predict_parts``. The selectors end to end are in
``test_torch_linear_e2e.py``.

The frame: 512 rows of 6 standard-normal features (one scaled by 100, one
offset by 5) and three CV folds of 0/1 row weights. ``_BatchStd`` and the
linear regression also see a column that is constant within fold 0's
training rows (a dead column there). ``_BatchStd`` flags a column dead
when its one-pass variance is below 1e-6 of its second moment, and the
f32 sums decide that: on this frame the port's variance of the constant
column is 2.4e-7 of its second moment, the JAX package's 1.06e-6 (its
sums add in another order), so only the port pins the coefficient to 0.
The test holds that the JAX package's value is rounding noise within 2x
of the threshold (ROADMAP.md, Queue 3). The linear regression's
standardization tests the weighted range exactly and agrees.

Tolerances (stated once, used throughout; the measured gaps on these
inputs in brackets):

* ``_BatchStd`` fields: rtol 1e-5; the dead-column scales equal [1e-7];
* f32 fits (refit settings, softmax, linear regression, NB, gaussian
  GLM): coefficients within 1e-4 of max |coef| [1e-6]; biases within
  1e-4 of max |coef| + max |bias|. The softmax's biases are held after
  removing each configuration's mean over classes, and its probabilities
  within 1e-5 [9e-7]: the bias is unpenalized and a common shift of all
  classes changes nothing, so Adam drifts along that direction on
  rounding noise (a fold whose class count is exactly a third of its rows
  has a first bias gradient of pure rounding noise, which Adam's
  normalized step turns into a step of the learning rate) [common shift
  2.1e-3];
* bf16 sweep fits: coefficients within 1e-3 of max |coef| [LR 2e-4,
  SVC 1.5e-6]; each configuration's AuPR on its ~171 validation rows
  within 1e-4 [6.3e-5 once: a 2e-4 coefficient gap swaps one pair of
  near-tied rows, and one swap is AuPR's step at that row count; 0
  elsewhere; the selectors' fold metrics in the e2e file hold 5e-5].
  A product's f32 sum rounds to bf16 across a boundary on one side and
  not the other, and the solvers amplify that: the CG residual falls by
  ~400x a step, and 25 steps past the 75th a single flipped hinge margin
  moves an SVC coefficient by 7e-4 of max |coef| on a frame with a dead
  column;
* poisson GLM on positive labels: coefficients within 1e-3 of max
  |coef| [6e-5; IRLS keeps the best-deviance iterate, and the log link's
  weights exp(eta) amplify f32 rounding step by step];
* predictions of identical params: within 1e-6 (1e-5 relative for the
  GLM's exp).
"""
from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import jax.numpy as jnp
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import transmogrifai_tpu.models.glm as JG  # noqa: E402
import transmogrifai_tpu.models.linear as JL  # noqa: E402
from transmogrifai_tpu.models.api import (  # noqa: E402
    FittedParams as JFitted, MODEL_REGISTRY as JAX_REGISTRY,
)
from transmogrifai_tpu.ops import metrics as jmetrics  # noqa: E402
import transmogrifai_tpu_torch.models.glm as PG  # noqa: E402
import transmogrifai_tpu_torch.models.linear as PL  # noqa: E402
from transmogrifai_tpu_torch.models.api import (  # noqa: E402
    FittedParams as PFitted, MODEL_REGISTRY as PORT_REGISTRY,
)

COEF_RTOL = 1e-4
SWEEP_RTOL = 1e-3
PROB_TOL = 1e-5
POISSON_RTOL = 1e-3
STD_RTOL = 1e-5
METRIC_ATOL = 1e-4
PRED_TOL = 1e-6

N, D, F = 512, 6, 3
#: the 3 x 6 LR grid of the reference defaults: regParam x elasticNet
LR_GRID = [(r, e) for r in (0.01, 0.1, 0.2) for e in (0.0, 0.5)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _frame(seed: int = 0, dead_column: bool = False):
    """X (N, D), binary y, 3-class y, fold ids, fold train weights (F, N);
    with ``dead_column`` column 4 is constant in fold 0's training rows."""
    rng = np.random.RandomState(seed)
    X = rng.randn(N, D).astype(np.float32)
    w = rng.randn(D).astype(np.float32)
    y = ((X @ w + 0.5 * rng.randn(N)) > 0).astype(np.float32)
    yc = np.argmax(X[:, :3] + 0.5 * rng.randn(N, 3), 1).astype(np.float32)
    folds = rng.permutation(N) % F
    X[:, 2] *= 100.0
    X[:, 3] += 5.0
    if dead_column:
        X[folds != 0, 4] = 1.0
    W = np.stack([folds != f for f in range(F)]).astype(np.float32)
    return X, y, yc, folds, W


def _tiled(grid_cols, G):
    """The validator's layout: configurations tiled per fold, fold-major."""
    return [np.tile(np.asarray(c, np.float32), F) for c in grid_cols]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_batch_std_fields_and_dead_column():
    X, _, _, _, W = _frame(dead_column=True)
    j = JL._BatchStd(jnp.asarray(X), jnp.asarray(W))
    p = PL._BatchStd(_t(X), _t(W))
    for name in ("g_mean", "g_scale", "Xg", "cnt", "mean"):
        np.testing.assert_allclose(getattr(p, name).numpy(),
                                   np.asarray(getattr(j, name)),
                                   rtol=STD_RTOL, atol=STD_RTOL, err_msg=name)
    js, ps = np.asarray(j.scale), p.scale.numpy()
    pdead = ps == np.float32(1e30)
    assert pdead[0, 4] and pdead.sum() == 1   # fold 0's constant column
    live = ~pdead
    np.testing.assert_allclose(ps[live], js[live], rtol=STD_RTOL)
    np.testing.assert_allclose(p.var.numpy()[live], np.asarray(j.var)[live],
                               rtol=STD_RTOL)
    # the JAX package keeps it live on rounding noise at the threshold
    ex2 = np.asarray(j.var)[0, 4] + np.asarray(j.mean)[0, 4] ** 2
    assert js[0, 4] != np.float32(1e30)
    assert np.asarray(j.var)[0, 4] < 2e-6 * ex2


def _aupr_per_config(coef, bias, X, y, folds, G):
    """Each configuration's AuPR on its fold's validation rows, through
    the JAX package's metric (the scores are sigmoid margins)."""
    out = []
    for b in range(coef.shape[0]):
        m = folds == b // G
        s = 1.0 / (1.0 + np.exp(-(X[m] @ coef[b] + bias[b])))
        out.append(float(jmetrics.aupr(jnp.asarray(s, jnp.float32),
                                       jnp.asarray(y[m]))))
    return np.asarray(out)


@pytest.mark.parametrize("sweep", [False, True], ids=["refit", "sweep"])
def test_logreg_batch_matches_jax(sweep):
    X, y, _, folds, W1 = _frame()
    G = len(LR_GRID)
    reg, en = _tiled(zip(*LR_GRID), G)
    W = np.repeat(W1, G, axis=0)
    kw = dict(newton_iters=8, cg_iters=6, sweep=True) if sweep else {}
    jc, jb = JL._fit_logreg_batch(X, y, W, reg, en, **kw)
    pc, pb = PL._fit_logreg_batch(_t(X), _t(y), _t(W), _t(reg), _t(en), **kw)
    jc, jb = np.asarray(jc), np.asarray(jb)
    tol = SWEEP_RTOL if sweep else COEF_RTOL
    assert _rel(pc, jc) < tol
    assert np.abs(pb.numpy() - jb).max() < tol * (
        np.abs(jc).max() + np.abs(jb).max())
    # the L1 prox zeroes the same coefficients
    np.testing.assert_array_equal(pc.numpy() == 0, jc == 0)
    assert (jc[en > 0] == 0).any()
    np.testing.assert_allclose(
        _aupr_per_config(pc.numpy(), pb.numpy(), X, y, folds, G),
        _aupr_per_config(jc, jb, X, y, folds, G), rtol=0, atol=METRIC_ATOL)


@pytest.mark.parametrize("sweep", [False, True], ids=["refit", "sweep"])
def test_svc_batch_matches_jax(sweep):
    X, y, _, folds, W1 = _frame()
    regs = (0.01, 0.1, 0.2)
    (reg,) = _tiled([regs], len(regs))
    W = np.repeat(W1, len(regs), axis=0)
    jc, jb = JL._fit_svc_batch(X, y, W, reg, sweep=sweep)
    pc, pb = PL._fit_svc_batch(_t(X), _t(y), _t(W), _t(reg), sweep=sweep)
    jc, jb = np.asarray(jc), np.asarray(jb)
    tol = SWEEP_RTOL if sweep else COEF_RTOL
    assert _rel(pc, jc) < tol
    assert np.abs(pb.numpy() - jb).max() < tol * (np.abs(jc).max()
                                                  + np.abs(jb).max())
    np.testing.assert_allclose(
        _aupr_per_config(pc.numpy(), pb.numpy(), X, y, folds, len(regs)),
        _aupr_per_config(jc, jb, X, y, folds, len(regs)), rtol=0,
        atol=METRIC_ATOL)


def test_softmax_batch_matches_jax():
    X, _, yc, _, W1 = _frame()
    (reg,) = _tiled([(0.01, 0.1)], 2)
    W = np.repeat(W1, 2, axis=0)
    jW, jb = JL._fit_softmax_batch(X, jnp.asarray(yc, jnp.int32), W, reg, 3)
    pW, pb = PL._fit_softmax_batch(_t(X), _t(yc), _t(W), _t(reg), 3)
    jW, jb = np.asarray(jW), np.asarray(jb)
    assert pW.shape == jW.shape == (2 * F, D, 3)
    assert _rel(pW, jW) < COEF_RTOL
    centred = [b - b.mean(1, keepdims=True) for b in (pb.numpy(), jb)]
    assert np.abs(centred[0] - centred[1]).max() < COEF_RTOL * (
        np.abs(jW).max() + np.abs(jb).max())

    def prob(Wc, b):
        z = np.einsum("nd,bdc->bnc", X.astype(np.float64), Wc) + b[:, None]
        e = np.exp(z - z.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)
    np.testing.assert_allclose(prob(pW.numpy(), pb.numpy()), prob(jW, jb),
                               rtol=0, atol=PROB_TOL)


def test_linreg_batch_mixes_l1_and_ridge_configs():
    X, _, _, _, W1 = _frame(dead_column=True)
    rng = np.random.RandomState(5)
    yr = (X / X.std(0) @ rng.randn(D).astype(np.float32)
          + 0.1 * rng.randn(N)).astype(np.float32)
    grid = [(r, e) for r in (0.001, 0.01, 0.1) for e in (0.0, 0.5)]
    reg, en = _tiled(zip(*grid), len(grid))
    assert (reg * en > 0).any() and (reg * en == 0).any()
    W = np.repeat(W1, len(grid), axis=0)
    jc, jb = JL._fit_linreg_batch(X, yr, W, reg, en)
    pc, pb = PL._fit_linreg_batch(_t(X), _t(yr), _t(W), _t(reg), _t(en))
    jc, jb = np.asarray(jc), np.asarray(jb)
    assert _rel(pc, jc) < COEF_RTOL
    assert np.abs(pb.numpy() - jb).max() < COEF_RTOL * (
        np.abs(jc).max() + np.abs(jb).max())
    # the dead column of fold 0 keeps a zero coefficient
    assert (jc[:len(grid), 4] == 0).all()
    assert (pc.numpy()[:len(grid), 4] == 0).all()


def test_nb_batch_matches_jax():
    X, _, yc, _, W1 = _frame()
    (sm,) = _tiled([(0.5, 1.0, 2.0)], 3)
    W = np.repeat(W1, 3, axis=0)
    jl, jp = JL._fit_nb_batch(X, jnp.asarray(yc, jnp.int32), W, sm, 3)
    pl, pp = PL._fit_nb_batch(_t(X), _t(yc), _t(W), _t(sm), 3)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=COEF_RTOL,
                               atol=COEF_RTOL)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=COEF_RTOL,
                               atol=COEF_RTOL)


def test_glm_batch_gaussian_and_poisson_on_positive_labels():
    X, _, _, _, W1 = _frame()
    Xs = ((X - X.mean(0)) / X.std(0)).astype(np.float32)
    rng = np.random.RandomState(6)
    ypos = np.exp(0.3 * Xs[:, 0] - 0.2 * Xs[:, 1] + 0.1
                  + 0.05 * rng.randn(N)).astype(np.float32)
    grid = [("gaussian", r) for r in (0.001, 0.1)] + [
        ("poisson", r) for r in (0.001, 0.1)]
    fam, reg = _tiled([[JG.FAMILY_CODES[f] for f, _ in grid],
                       [r for _, r in grid]], len(grid))
    vp = np.full_like(fam, 1.5)
    W = np.repeat(W1, len(grid), axis=0)
    jc, jb = JG._fit_glm_batch(Xs, ypos, W, reg, fam, vp)
    pc, pb = PG._fit_glm_batch(_t(Xs), _t(ypos), _t(W), _t(reg), _t(fam),
                               _t(vp))
    jc, jb = np.asarray(jc), np.asarray(jb)
    for code, tol in ((0.0, COEF_RTOL), (1.0, POISSON_RTOL)):
        m = fam == code
        assert _rel(pc[m], jc[m]) < tol, code
        assert np.abs(pb.numpy()[m] - jb[m]).max() < tol * (
            np.abs(jc[m]).max() + np.abs(jb[m]).max())
    assert np.isfinite(pc.numpy()).all()


def _jax_params(family, X, y, yc, W, num_classes):
    """The JAX package's fitted params of ``family``'s first two default
    configurations (the suite's TG_FAST_GRIDS width), on the frame."""
    jf = JAX_REGISTRY[family]
    problem = {"OpLinearRegression": "regression",
               "OpGeneralizedLinearRegression": "regression"}.get(
        family, "binary" if num_classes == 2 else "multiclass")
    grid = jf.default_grid(problem)[:2]
    label = y if num_classes <= 2 else yc
    params = jf.fit_batch(jnp.asarray(X), jnp.asarray(label),
                          jnp.asarray(W[:2]), jf.grid_to_arrays(grid),
                          num_classes)
    return grid, {k: np.asarray(v) for k, v in params.items()}


PREDICT_CASES = [("OpLogisticRegression", 2), ("OpLogisticRegression", 3),
                 ("OpLinearSVC", 2), ("OpNaiveBayes", 2), ("OpNaiveBayes", 3),
                 ("OpLinearRegression", 1),
                 ("OpGeneralizedLinearRegression", 1)]


@pytest.mark.parametrize("family,num_classes", PREDICT_CASES)
def test_predict_batch_and_parts_match_jax(family, num_classes):
    X, y, yc, _, W = _frame()
    if family == "OpGeneralizedLinearRegression":
        X = ((X - X.mean(0)) / X.std(0)).astype(np.float32)
    grid, params = _jax_params(family, X, y, yc, W, num_classes)
    jf, pf = JAX_REGISTRY[family], PORT_REGISTRY[family]
    pparams = pf.params_from_numpy(params, "cpu")
    Xq = np.random.RandomState(7).randn(64, D).astype(np.float32) * X.std(0)
    got = pf.predict_batch(pparams, _t(Xq), num_classes).numpy()
    want = np.asarray(jf.predict_batch(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(Xq),
        num_classes))
    np.testing.assert_allclose(got, want, rtol=PRED_TOL * 10,
                               atol=PRED_TOL)
    for idx in range(len(grid)):
        one = {k: v[idx] for k, v in params.items()}
        jp = jf.predict_one(JFitted(family, one, grid[idx], num_classes),
                            jnp.asarray(Xq))
        pp = pf.predict_parts(PFitted(family, pf.params_from_numpy(
            one, "cpu"), grid[idx], num_classes), _t(Xq))
        assert sorted(pp) == sorted(jp)
        for k in jp:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                       rtol=PRED_TOL * 10, atol=PRED_TOL,
                                       err_msg=k)


def test_grids_and_registry_match_jax():
    """Every family of the JAX package's registry is in the port's (the
    MLP included), with the same default grids and problem kinds."""
    import transmogrifai_tpu.models.glm  # noqa: F401
    import transmogrifai_tpu.models.mlp  # noqa: F401
    import transmogrifai_tpu.models.trees  # noqa: F401
    import transmogrifai_tpu_torch.models.mlp  # noqa: F401
    import transmogrifai_tpu_torch.models.trees  # noqa: F401
    assert sorted(PORT_REGISTRY) == sorted(JAX_REGISTRY)
    for name in ("OpLogisticRegression", "OpLinearSVC", "OpNaiveBayes",
                 "OpLinearRegression", "OpGeneralizedLinearRegression"):
        jf, pf = JAX_REGISTRY[name], PORT_REGISTRY[name]
        assert pf.supports == jf.supports
        for problem in sorted(jf.supports):
            assert pf.default_grid(problem) == jf.default_grid(problem)
            ja = jf.grid_to_arrays(jf.default_grid(problem))
            pa = pf.grid_to_arrays(pf.default_grid(problem))
            assert sorted(pa) == sorted(ja)
            for k in ja:
                np.testing.assert_array_equal(pa[k], np.asarray(ja[k]))
