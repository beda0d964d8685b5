"""Linear model families (counterpart of ``transmogrifai_tpu.models.linear``):
logistic regression (batched prox-Newton-CG for binary labels, batched Adam
softmax for multiclass), linear/ridge regression, linear SVC and naive
Bayes.

Each family fits its whole hyperparameter x fold batch at once: the heavy
work is shared (n, d) @ (d, B) products over the raw feature matrix, and
per-configuration 0/1 row weights express the folds. The conventions are
Spark ML's, as in the JAX package: objective = mean loss + regParam *
(alpha |w|_1 + (1 - alpha) / 2 |w|_2^2) with the bias unpenalized; features
are standardized internally and coefficients are reported in the original
scale.

The arithmetic follows the JAX package's XLA programs on the CPU:

* every f32 product runs in full f32 (TF32 off on the card, whatever the
  caller's global setting);
* the CV sweep's (n, B) temporaries are bfloat16 with f32 reductions
  (``sweep=True``): a product of two bf16 values is exact in f32, so the
  bf16 operands are multiplied in f32 and a bf16 result is rounded once;
  every elementwise bf16 operation rounds its result to bf16, as XLA does
  (the sigmoid as 1 / (1 + exp(-z)), each step rounded);
* the sigmoid and softmax use XLA's CPU exp (``ops.xla_cpu``), and the
  scalar schedules (Adam's bias corrections, the SVC step, ISTA's step)
  are float32 tensors.

The binary logistic regression and the SVC compute in X's dtype: float32
on every path; a float64 X evaluates the same sweep (its bf16 roundings
and float32 exp kept, every other value and sum float64), the reference a
float32 sweep is held to where the order of its float32 sums decides its
result.

Grid values reach the solvers as (B,) float32 tensors on X's device.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..histeng.kernels import _tf32_off
from ..ops.xla_cpu import xla_exp, xla_softmax
from .api import FittedParams, ModelFamily, register_family

_F32 = torch.float32


def _grid_tensor(grid: Dict[str, Any], key: str, X: torch.Tensor,
                 default: float = 0.0) -> torch.Tensor:
    """A (B,) float32 grid column on X's device."""
    v = grid.get(key)
    if v is None:
        B = len(next(iter(grid.values())))
        return torch.full((B,), default, dtype=_F32, device=X.device)
    return torch.as_tensor(np.asarray(v, np.float32), device=X.device)


def _rounder(sweep: bool):
    """x -> x rounded to bfloat16 (kept in x's dtype) when ``sweep``, else
    x."""
    if sweep:
        return lambda x: x.to(torch.bfloat16).to(x.dtype)
    return lambda x: x


def _sigmoid(z: torch.Tensor, r=lambda x: x) -> torch.Tensor:
    """XLA's logistic, 1 / (1 + exp(-z)), with ``r`` applied after each
    operation (bf16 rounding in the sweep)."""
    return r(1.0 / r(1.0 + r(xla_exp(-z))))


def _softmax_last(z: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax(z, axis=-1)`` in XLA's CPU arithmetic."""
    return xla_softmax(z.movedim(-1, 1)).movedim(1, -1)


def _f32_pow(base: float, t: torch.Tensor) -> torch.Tensor:
    """float32(base) ** t, rounded once from float64 (XLA's f32 pow)."""
    return torch.pow(torch.tensor(float(np.float32(base)), dtype=torch.float64,
                                  device=t.device), t.double()).to(_F32)


def _standardize(X: torch.Tensor, w: torch.Tensor):
    """Weighted feature standardization of each configuration: X (n, d),
    w (B, n) -> (Xs (B, n, d), mean (B, d), scale (B, d)).

    Columns constant within a configuration's weighted rows (weighted
    range 0) get a huge scale, so Xs ~ 0 and the coefficient stays 0."""
    cnt = torch.clamp(w.sum(1), min=1.0)                       # (B,)
    mean = (X[None] * w[:, :, None]).sum(1) / cnt[:, None]
    var = ((X[None] - mean[:, None, :]) ** 2 * w[:, :, None]).sum(1) \
        / cnt[:, None]
    active = w[:, :, None] > 0
    hi = torch.where(active, X[None], -torch.inf).amax(1)
    lo = torch.where(active, X[None], torch.inf).amin(1)
    dead = hi <= lo
    scale = torch.where(dead, torch.tensor(1e30, dtype=_F32, device=X.device),
                        torch.sqrt(torch.clamp(var, min=1e-30)))
    return (X[None] - mean[:, None, :]) / scale[:, None, :], mean, scale


def _unscale(coef_s, bias_s, mean, scale):
    coef = coef_s / scale
    return coef, bias_s - (coef * mean).sum(-1)


class _BatchStd:
    """Per-configuration standardization algebra over shared products.

    X is standardized once globally (keeps the shared products
    well-conditioned); each configuration's weighted standardization is
    then expressed algebraically, Xs v = Xg (v / scale) - mean . (v /
    scale), so X is never copied per configuration."""

    def __init__(self, X: torch.Tensor, W: torch.Tensor):
        # XLA divides by the row count as a product with its f32 reciprocal
        inv_n = float(np.float32(1.0 / X.shape[0]))
        g_mean = X.sum(0) * inv_n
        g_scale = torch.sqrt(torch.clamp(((X - g_mean) ** 2).sum(0) * inv_n,
                                         min=1e-12))
        self.g_mean, self.g_scale = g_mean, g_scale
        self.Xg = (X - g_mean) / g_scale
        self.Wt = W.T                                         # (n, B)
        self.cnt = torch.clamp(W.sum(1), min=1.0)             # (B,)
        mean = (W @ self.Xg) / self.cnt[:, None]              # (B, d)
        ex2 = (W @ (self.Xg * self.Xg)) / self.cnt[:, None]
        var_raw = ex2 - mean ** 2
        self.var = torch.clamp(var_raw, min=1e-12)
        # a column constant within a configuration's weighted rows has a
        # variance of rounding noise; give it a huge scale instead (Spark's
        # zero-variance semantics). The test is relative to ex2, with an
        # absolute floor for columns constant at ~0
        dead = var_raw < torch.clamp(1e-6 * ex2, min=1e-10)
        self.mean = mean
        self.scale = torch.where(dead, torch.tensor(1e30, dtype=X.dtype,
                                                    device=X.device),
                                 torch.sqrt(self.var))        # (B, d)
        #: the gradients' divisor, scale * cnt (XLA folds x / scale / cnt)
        self.scale_cnt = self.scale * self.cnt[:, None]

    def unscale(self, A, b):
        """Per-configuration standardized coefficients -> original scale
        (XLA folds A / scale / g_scale into A / (scale * g_scale))."""
        bias_g = b - ((A / self.scale) * self.mean).sum(1)
        coef = A / (self.scale * self.g_scale)
        return coef, bias_g - (coef * self.g_mean).sum(1)

    def typed_ops(self, r, Xg_c):
        """(xs_dot, xs_t_dot): the standardized products with (n, B)
        intermediates rounded by ``r`` (bf16 in the sweep) and f32
        reductions. ``Xg_c`` is ``r(Xg)``, shared by the callers.

        ``xs_t_dot`` returns (Xs^T V) * scale, the gradient's numerator
        before the division by scale * cnt, which XLA folds from the
        source's ``/ scale / cnt``. Its column sums add ``V_sum`` when
        given: XLA sums a bf16 product's unrounded f32 value (its convert
        pair is elided) while the product takes the rounded one."""
        def xs_dot(A):
            """Xs A^T -> (n, B), rounded by ``r``."""
            As = A / self.scale
            off = r((self.mean * As).sum(1))
            return r(r(Xg_c @ r(As).T) - off[None, :])

        def xs_t_dot(V, V_sum=None):
            """(Xs^T V) * scale -> (B, d) f32."""
            s = (V if V_sum is None else V_sum).sum(0)
            return (V.T @ Xg_c) - s[:, None] * self.mean

        return xs_dot, xs_t_dot


def _fit_logreg_batch(X, y, W, reg, elastic_net, newton_iters=10, cg_iters=8,
                      sweep=False):
    """B binary logistic regressions at once. W: (B, n) row weights;
    reg/elastic_net: (B,). Returns (coef (B, d), bias (B,)) in original
    scale. ``sweep``: bf16 (n, B) temporaries (see the module notes)."""
    with _tf32_off():
        W = W.to(X.dtype)
        nB, d = W.shape[0], X.shape[1]
        r = _rounder(sweep)
        std = _BatchStd(X, W)
        cnt, mean, var = std.cnt, std.mean, std.var
        l2 = reg * (1.0 - elastic_net)
        l1 = reg * elastic_net
        Xg_c = r(std.Xg)
        Wt_c = r(std.Wt)
        yv_c = r(y[:, None])
        xs_dot, xs_t_dot = std.typed_ops(r, Xg_c)
        floor = r(torch.tensor(1e-6, dtype=X.dtype, device=X.device))
        Xg2_c = Xg_c * Xg_c          # XLA keeps this bf16 product unrounded
        A = torch.zeros((nB, d), dtype=X.dtype, device=X.device)
        b = torch.zeros((nB,), dtype=X.dtype, device=X.device)
        for _ in range(newton_iters):
            Z = r(xs_dot(A) + r(b)[None, :])
            P = _sigmoid(Z, r)
            R = r(Wt_c * r(P - yv_c))
            S = r(Wt_c * torch.maximum(r(P * r(1.0 - P)), floor))
            g_A = xs_t_dot(R) / std.scale_cnt + l2[:, None] * A
            g_b = R.sum(0) / cnt
            ssum = S.sum(0)
            # conjugate gradients on H [dA; db] = g, all B at once
            dA, db = torch.zeros_like(A), torch.zeros_like(b)
            rA, rb, pA, pb = g_A, g_b, g_A, g_b
            rs = (g_A * g_A).sum(1) + g_b * g_b
            for _ in range(cg_iters):
                U = r(xs_dot(pA) + r(pb)[None, :])
                T_f = S * U              # the sums take it unrounded
                hA = xs_t_dot(r(T_f), T_f) / std.scale_cnt \
                    + (l2 + 1e-8)[:, None] * pA
                hb = T_f.sum(0) / cnt + 1e-8 * pb
                alpha = rs / torch.clamp((pA * hA).sum(1) + pb * hb,
                                         min=1e-20)
                dA = dA + alpha[:, None] * pA
                db = db + alpha * pb
                rA = rA - alpha[:, None] * hA
                rb = rb - alpha * hb
                rs_new = (rA * rA).sum(1) + rb * rb
                beta = rs_new / torch.clamp(rs, min=1e-20)
                pA = rA + beta[:, None] * pA
                pb = rb + beta * pb
                rs = rs_new
            A = A - dA
            b = b - db
            # the L1 prox in the diagonal-Hessian metric
            StX = S.T @ Xg_c
            StX2 = S.T @ Xg2_c
            diag = (StX2 - 2 * mean * StX + ssum[:, None] * mean ** 2) \
                / (var * cnt[:, None])
            thresh = l1[:, None] / torch.clamp(diag, min=1e-8)
            A = torch.where(l1[:, None] > 0, torch.sign(A) * torch.clamp(
                A.abs() - thresh, min=0.0), A)
        return std.unscale(A, b)


def _fit_softmax_batch(X, y_idx, W_rows, reg, num_classes, iters=200):
    """Multinomial logistic regression of B configurations by full-batch
    Adam (lr 0.1) over shared products, in the binary solver's
    standardization algebra. W_rows: (B, n); reg: (B,). Returns (W (B, d,
    C), b (B, C)) in original scale."""
    with _tf32_off():
        C = num_classes
        nB, n, d = W_rows.shape[0], X.shape[0], X.shape[1]
        std = _BatchStd(X, W_rows)
        Xg, cnt, mean, scale = std.Xg, std.cnt, std.mean, std.scale
        Wt = W_rows.T                                          # (n, B)
        # a label outside [0, C) (a class the cutter dropped) has no one-hot
        Y = (y_idx.long()[:, None] == torch.arange(
            C, device=X.device)).to(_F32)                      # (n, C)

        def grads(Wc, b):
            At = Wc / scale[:, :, None]                        # (B, d, C)
            off = (mean[:, :, None] * At).sum(1)               # (B, C)
            Z = (Xg @ At.permute(1, 0, 2).reshape(d, nB * C)).reshape(
                n, nB, C) + (b - off)[None]
            P = _softmax_last(Z)
            R = Wt[:, :, None] * (P - Y[:, None, :])           # (n, B, C)
            GX = (Xg.T @ R.reshape(n, nB * C)).reshape(
                d, nB, C).permute(1, 0, 2)                     # (B, d, C)
            Rsum = R.sum(0)
            g_W = (GX - mean[:, :, None] * Rsum[:, None, :]) \
                / std.scale_cnt[:, :, None] + reg[:, None, None] * Wc
            return g_W, Rsum / cnt[:, None]

        lr, b1, b2, eps = 0.1, 0.9, 0.999, 1e-8
        params = [torch.zeros((nB, d, C), dtype=_F32, device=X.device),
                  torch.zeros((nB, C), dtype=_F32, device=X.device)]
        m = [torch.zeros_like(p) for p in params]
        v = [torch.zeros_like(p) for p in params]
        for i in range(iters):
            g = grads(*params)
            t = torch.tensor(i + 1.0, dtype=_F32, device=X.device)
            c1 = 1 - _f32_pow(b1, t)
            c2 = 1 - _f32_pow(b2, t)
            for j in range(2):
                m[j] = b1 * m[j] + (1 - b1) * g[j]
                v[j] = b2 * v[j] + (1 - b2) * g[j] * g[j]
                params[j] = params[j] - lr * (m[j] / c1) / (
                    torch.sqrt(v[j] / c2) + eps)
        Wc, b = params
        W_g = Wc / scale[:, :, None]
        b_g = b - (W_g * mean[:, :, None]).sum(1)
        Wx = W_g / std.g_scale[None, :, None]
        return Wx, b_g - (Wx * std.g_mean[None, :, None]).sum(1)


def _fit_linreg_batch(X, y, W, reg, elastic_net, l1_iters=60):
    """B ridge / elastic-net regressions: the closed-form solve of each
    configuration's standardized normal equations (one batched solve),
    then ``l1_iters`` ISTA steps kept only where l1 > 0."""
    with _tf32_off():
        nB, n, d = W.shape[0], X.shape[0], X.shape[1]
        Xs, mean, scale = _standardize(X, W)
        cnt = torch.clamp(W.sum(1), min=1.0)
        l2 = reg * (1.0 - elastic_net)
        l1 = reg * elastic_net
        Xa = torch.cat([Xs, torch.ones((nB, n, 1), dtype=_F32,
                                       device=X.device)], dim=2)
        A = (Xa * W[:, :, None]).transpose(1, 2) @ Xa / cnt[:, None, None]
        ridge = torch.cat([l2[:, None].expand(nB, d),
                           torch.zeros((nB, 1), dtype=_F32, device=X.device)],
                          dim=1)
        A = A + torch.diag_embed(ridge) + 1e-8 * torch.eye(
            d + 1, dtype=_F32, device=X.device)
        rhs = (Xa * (W * y[None, :])[:, :, None]).sum(1) / cnt[:, None]
        theta = torch.linalg.solve(A, rhs)
        # ISTA for the L1 part, with trace(A) as the Lipschitz bound
        step = 1.0 / torch.clamp(torch.diagonal(A, dim1=1, dim2=2).sum(1),
                                 min=1e-6)
        th = theta
        for _ in range(l1_iters):
            grad = (A @ th[:, :, None])[:, :, 0] - rhs
            t = th - step[:, None] * grad
            coef = torch.sign(t[:, :d]) * torch.clamp(
                t[:, :d].abs() - (step * l1)[:, None], min=0.0)
            th = torch.cat([coef, t[:, d:]], dim=1)
        theta = torch.where((l1 > 0)[:, None], th, theta)
        return _unscale(theta[:, :d], theta[:, d], mean, scale)


def _fit_svc_batch(X, y, W, reg, iters=100, sweep=False):
    """B linear SVCs (squared hinge + L2) by Nesterov-accelerated gradient
    descent, two shared products a step. ``sweep``: bf16 (n, B) margin and
    gradient temporaries."""
    with _tf32_off():
        W = W.to(X.dtype)
        nB, d = W.shape[0], X.shape[1]
        r = _rounder(sweep)
        std = _BatchStd(X, W)
        cnt = std.cnt
        Wt_c = r(std.Wt)
        ypm_c = r(2.0 * y - 1.0)[:, None]                      # {-1, +1}
        xs_dot, xs_t_dot = std.typed_ops(r, r(std.Xg))

        def loss_grad(A, b):
            M = r(ypm_c * r(xs_dot(A) + r(b)[None, :]))
            act = torch.clamp(r(1.0 - M), min=0.0)
            G_m = r(r(r(-2.0 * act) * ypm_c) * Wt_c)
            return (xs_t_dot(G_m) / std.scale_cnt + reg[:, None] * A,
                    G_m.sum(0) / cnt)

        # Lipschitz ~ 2 mean row-norm^2 (+ reg); standardized rows: ~ d
        lr = 1.0 / ((2.0 * d / 4.0 + reg) + 1.0)               # (B,)
        A = Ap = torch.zeros((nB, d), dtype=X.dtype, device=X.device)
        b = bp = torch.zeros((nB,), dtype=X.dtype, device=X.device)
        t = torch.tensor(1.0, dtype=X.dtype, device=X.device)
        for _ in range(iters):
            mom = (t - 1.0) / (t + 2.0)
            mA = A + mom * (A - Ap)
            mb = b + mom * (b - bp)
            g_A, g_b = loss_grad(mA, mb)
            A, b, Ap, bp = mA - lr[:, None] * g_A, mb - lr * g_b, A, b
            t = t + 1.0
        return std.unscale(A, b)


def _fit_nb_batch(X, y_idx, W, smoothing, num_classes):
    """B multinomial naive Bayes fits (Laplace smoothing) by counting:
    (log_prob (B, C, d), log_prior (B, C))."""
    with _tf32_off():
        Xp = torch.clamp(X, min=0.0)     # multinomial NB needs counts >= 0
        onehot = (y_idx.long()[:, None] == torch.arange(
            num_classes, device=X.device)).to(_F32)             # (n, C)
        Y = onehot[None] * W[:, :, None]                        # (B, n, C)
        class_cnt = Y.sum(1)
        feat_cnt = Y.transpose(1, 2) @ Xp                       # (B, C, d)
        s = smoothing[:, None, None]
        log_prob = torch.log(feat_cnt + s) - torch.log(
            feat_cnt.sum(2, keepdim=True) + s * X.shape[1])
        log_prior = torch.log(
            torch.clamp(class_cnt, min=1e-12)
            / torch.clamp(class_cnt.sum(1, keepdim=True), min=1e-12))
        return log_prob, log_prior


def _margins(coef: torch.Tensor, bias: torch.Tensor,
             X: torch.Tensor) -> torch.Tensor:
    """(B, n) coef @ X^T + bias in full f32."""
    with _tf32_off():
        return coef @ X.T + bias[:, None]


def _margin_one(fitted: FittedParams, X: torch.Tensor) -> torch.Tensor:
    """(n,) X @ coef + bias of one fitted configuration, in full f32."""
    with _tf32_off():
        return X @ fitted.params["coef"] + fitted.params["bias"]


class _LinearFamily(ModelFamily):
    """Saved numpy parameters load as float32 tensors."""

    def params_from_numpy(self, params, device):
        return {k: torch.as_tensor(np.array(v), device=device)
                for k, v in params.items()}


class LogisticRegressionFamily(_LinearFamily):
    """reference OpLogisticRegression (defaults: regParam [0.01, 0.1, 0.2],
    elasticNetParam [0, 0.5])."""

    name = "OpLogisticRegression"
    supports = frozenset({"binary", "multiclass"})

    def default_grid(self, problem: str) -> List[Dict[str, Any]]:
        return [{"regParam": r, "elasticNetParam": e}
                for r in (0.01, 0.1, 0.2) for e in (0.0, 0.5)]

    def _fit(self, X, y, weights, grid, num_classes, sweep):
        reg = _grid_tensor(grid, "regParam", X)
        if num_classes <= 2:
            kw = dict(newton_iters=8, cg_iters=6, sweep=True) if sweep else {}
            coef, bias = _fit_logreg_batch(
                X, y, weights, reg, _grid_tensor(grid, "elasticNetParam", X),
                **kw)
            return {"coef": coef, "bias": bias}
        # softmax ignores elasticNetParam, as in the JAX package
        W, b = _fit_softmax_batch(X, y, weights, reg, num_classes)
        return {"W": W, "b": b}

    def fit_batch(self, X, y, weights, grid, num_classes):
        return self._fit(X, y, weights, grid, num_classes, sweep=False)

    def sweep_fit_batch(self, X, y, weights, grid, num_classes):
        # CV candidates: bf16 (n, B) temporaries and a shorter Newton-CG
        # schedule (8 x 6); the winner refits through fit_batch (f32,
        # 10 x 8)
        return self._fit(X, y, weights, grid, num_classes, sweep=True)

    def predict_batch(self, params, X, num_classes):
        if num_classes <= 2:
            return _sigmoid(_margins(params["coef"], params["bias"], X))
        with _tf32_off():
            B, d, C = params["W"].shape
            logits = (X @ params["W"].permute(1, 0, 2).reshape(d, B * C)
                      ).reshape(-1, B, C).permute(1, 0, 2) \
                + params["b"][:, None, :]
        return _softmax_last(logits)

    def predict_parts(self, fitted: FittedParams, X):
        if fitted.num_classes <= 2:
            margin = _margin_one(fitted, X)
            p1 = _sigmoid(margin)
            prob = torch.stack([1 - p1, p1], dim=1)
            raw = torch.stack([-margin, margin], dim=1)
        else:
            with _tf32_off():
                raw = X @ fitted.params["W"] + fitted.params["b"]
            prob = _softmax_last(raw)
        return {"prediction": prob.argmax(1).to(_F32), "probability": prob,
                "rawPrediction": raw}


class LinearRegressionFamily(_LinearFamily):
    """reference OpLinearRegression (defaults: regParam [0.001, 0.01, 0.1],
    elasticNetParam [0, 0.5])."""

    name = "OpLinearRegression"
    supports = frozenset({"regression"})

    def default_grid(self, problem: str) -> List[Dict[str, Any]]:
        return [{"regParam": r, "elasticNetParam": e}
                for r in (0.001, 0.01, 0.1) for e in (0.0, 0.5)]

    def fit_batch(self, X, y, weights, grid, num_classes):
        coef, bias = _fit_linreg_batch(
            X, y, weights, _grid_tensor(grid, "regParam", X),
            _grid_tensor(grid, "elasticNetParam", X))
        return {"coef": coef, "bias": bias}

    def predict_batch(self, params, X, num_classes):
        return _margins(params["coef"], params["bias"], X)

    def predict_parts(self, fitted: FittedParams, X):
        return {"prediction": _margin_one(fitted, X)}


class LinearSVCFamily(_LinearFamily):
    """reference OpLinearSVC (defaults: regParam [0.01, 0.1, 0.2])."""

    name = "OpLinearSVC"
    supports = frozenset({"binary"})

    def default_grid(self, problem: str) -> List[Dict[str, Any]]:
        return [{"regParam": r} for r in (0.01, 0.1, 0.2)]

    def fit_batch(self, X, y, weights, grid, num_classes):
        coef, bias = _fit_svc_batch(X, y, weights,
                                    _grid_tensor(grid, "regParam", X))
        return {"coef": coef, "bias": bias}

    def sweep_fit_batch(self, X, y, weights, grid, num_classes):
        coef, bias = _fit_svc_batch(X, y, weights,
                                    _grid_tensor(grid, "regParam", X),
                                    sweep=True)
        return {"coef": coef, "bias": bias}

    def predict_batch(self, params, X, num_classes):
        # margins squashed to [0, 1] for threshold metrics; ranks unchanged
        return _sigmoid(_margins(params["coef"], params["bias"], X))

    def predict_parts(self, fitted: FittedParams, X):
        margin = _margin_one(fitted, X)
        return {"prediction": (margin > 0).to(_F32),
                "rawPrediction": torch.stack([-margin, margin], dim=1)}


class NaiveBayesFamily(_LinearFamily):
    """reference OpNaiveBayes (default smoothing 1.0)."""

    name = "OpNaiveBayes"
    supports = frozenset({"binary", "multiclass"})

    def default_grid(self, problem: str) -> List[Dict[str, Any]]:
        return [{"smoothing": s} for s in (0.5, 1.0, 2.0)]

    def fit_batch(self, X, y, weights, grid, num_classes):
        lp, prior = _fit_nb_batch(X, y, weights,
                                  _grid_tensor(grid, "smoothing", X),
                                  max(num_classes, 2))
        return {"log_prob": lp, "log_prior": prior}

    def predict_batch(self, params, X, num_classes):
        with _tf32_off():
            lp = params["log_prob"]                           # (B, C, d)
            B, C, d = lp.shape
            logits = (torch.clamp(X, min=0.0) @ lp.reshape(B * C, d).T
                      ).reshape(-1, B, C).permute(1, 0, 2) \
                + params["log_prior"][:, None, :]
        prob = _softmax_last(logits)
        return prob[:, :, 1] if num_classes <= 2 else prob

    def predict_parts(self, fitted: FittedParams, X):
        with _tf32_off():
            raw = torch.clamp(X, min=0.0) @ fitted.params["log_prob"].T \
                + fitted.params["log_prior"]
        prob = _softmax_last(raw)
        return {"prediction": prob.argmax(1).to(_F32), "probability": prob,
                "rawPrediction": raw}


register_family(LogisticRegressionFamily())
register_family(LinearRegressionFamily())
register_family(LinearSVCFamily())
register_family(NaiveBayesFamily())
