"""Multilayer perceptron family (counterpart of
``transmogrifai_tpu.models.mlp``): two sigmoid hidden layers and a linear
head, trained by full-batch Adam on the weighted mean log-softmax loss.

Every configuration of a batch (configurations x folds) shares one
two-hidden-layer template as wide as the grid's widest layer; a
configuration's narrower layers are neuron masks (``iota < width``), as in
the JAX package. The batch trains as one set of tensors with a leading
config axis B: the forward pass is batched ``torch.matmul`` (TF32 off),
the gradient comes from ``torch.autograd`` (the JAX package's
``jax.grad``), and Adam's bias corrections ``b ** t`` are computed as
XLA's CPU computes them (``linear._f32_pow``).

The initial weights are the JAX package's bit for bit: configuration b
draws from ``PRNGKey(seed + b)`` split in three, three
``jax.random.normal`` tables (``rng.normal``) scaled by float32
``sqrt(2 / (fan_in + fan_out))``, which XLA folds into the normal's
sqrt(2). The family is off in every default
model list.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .. import rng
from ..histeng.kernels import _tf32_off
from .api import FittedParams, ModelFamily, register_family
from .linear import _f32_pow

_F32 = torch.float32


def _lane(v: torch.Tensor, batched: bool) -> torch.Tensor:
    """A (B, k) bias or mask as (B, 1, k) against (B, n, k) activations."""
    return v[:, None, :] if batched else v


def _forward(params, X: torch.Tensor, masks) -> torch.Tensor:
    """Logits of two masked sigmoid layers and a linear head: X (n, d) and
    params with a leading config axis (B, n, C), or without one (n, C)."""
    W1, b1, W2, b2, W3, b3 = params
    m1, m2 = masks
    batched = W1.dim() == 3
    h1 = torch.sigmoid(torch.matmul(X, W1) + _lane(b1, batched)) \
        * _lane(m1, batched)
    h2 = torch.sigmoid(torch.matmul(h1, W2) + _lane(b2, batched)) \
        * _lane(m2, batched)
    return torch.matmul(h2, W3) + _lane(b3, batched)


def _init(seeds: torch.Tensor, d: int, h_max: int, num_classes: int):
    """The JAX package's ``_init`` of each config's seed: (W1, b1, W2, b2,
    W3, b3) with a leading config axis, float32."""
    keys = rng.split(rng.prng_key(seeds), 3)                   # (B, 3, 2)
    B, dev = seeds.shape[0], seeds.device

    def scale(fan: int) -> float:
        # float32 sqrt of float32(2 / fan), correctly rounded
        return float(np.sqrt(np.float32(2.0 / fan)))

    def zeros(k: int) -> torch.Tensor:
        return torch.zeros((B, k), dtype=_F32, device=dev)

    return (rng.normal(keys[:, 0], (d, h_max), scale(d + h_max)),
            zeros(h_max),
            rng.normal(keys[:, 1], (h_max, h_max), scale(2 * h_max)),
            zeros(h_max),
            rng.normal(keys[:, 2], (h_max, num_classes),
                       scale(h_max + num_classes)),
            zeros(num_classes))


def _loss(params, X, Y, w, cnt, masks) -> torch.Tensor:
    """Sum over configs of each one's weighted mean log-softmax loss (the
    configs' gradients are independent)."""
    lp = torch.log_softmax(_forward(params, X, masks), dim=-1)
    return ((-(Y[None] * lp).sum(-1) * w).sum(-1) / cnt).sum()


def adam_step(params, m, v, g, t: int, step_size: torch.Tensor,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One Adam update of every parameter tensor (leading config axis B;
    ``step_size`` (B,)): the JAX package's step, its bias corrections
    ``1 - b ** t`` in XLA's CPU float32."""
    dev = params[0].device
    tt = torch.tensor(float(t), dtype=_F32, device=dev)
    c1, c2 = 1 - _f32_pow(b1, tt), 1 - _f32_pow(b2, tt)
    out_p, out_m, out_v = [], [], []
    for p, mm, vv, gg in zip(params, m, v, g):
        mm = b1 * mm + (1 - b1) * gg
        vv = b2 * vv + (1 - b2) * gg * gg
        lr = step_size.reshape((-1,) + (1,) * (p.dim() - 1))
        out_p.append(p - lr * (mm / c1) / (torch.sqrt(vv / c2) + eps))
        out_m.append(mm)
        out_v.append(vv)
    return tuple(out_p), tuple(out_m), tuple(out_v)


def _fit_mlp_batch(X, y_idx, w, h1, h2, step_size, seeds, h_max: int,
                   num_classes: int, iters: int):
    """B fits at once: X (n, d), y_idx (n,) class indices (-1: no class),
    w (B, n) row weights, h1 / h2 / step_size / seeds (B,). Returns
    (params, m1, m2)."""
    n, d = X.shape
    dev = X.device
    with _tf32_off():
        cnt = torch.clamp(w.sum(1), min=1.0)
        Y = (y_idx.long()[:, None] == torch.arange(
            num_classes, device=dev)).to(_F32)
        iota = torch.arange(h_max, dtype=_F32, device=dev)
        m1 = (iota[None] < h1[:, None]).to(_F32)
        m2 = (iota[None] < h2[:, None]).to(_F32)
        params = _init(seeds, d, h_max, num_classes)
        m = tuple(torch.zeros_like(p) for p in params)
        v = tuple(torch.zeros_like(p) for p in params)
        for i in range(iters):
            leaves = [p.detach().requires_grad_(True) for p in params]
            loss = _loss(leaves, X, Y, w, cnt, (m1, m2))
            g = torch.autograd.grad(loss, leaves)
            params, m, v = adam_step(params, m, v, g, i + 1, step_size)
        return tuple(p.detach() for p in params), m1, m2


class MultilayerPerceptronFamily(ModelFamily):
    """reference OpMultilayerPerceptronClassifier: sigmoid hidden layers,
    softmax output; grid over the hidden-layer sizes and stepSize."""

    name = "OpMultilayerPerceptronClassifier"
    supports = frozenset({"binary", "multiclass"})

    def __init__(self, max_iter: int = 100, seed: int = 42):
        self.max_iter = max_iter
        self.seed = seed

    def default_grid(self, problem: str) -> List[Dict[str, Any]]:
        return [{"hiddenLayer1": h, "hiddenLayer2": h, "stepSize": 0.05}
                for h in (10, 50, 100)]

    def fit_batch(self, X, y, weights, grid, num_classes):
        B = weights.shape[0]
        dev = X.device
        h_max = int(max(np.max(grid["hiddenLayer1"]),
                        np.max(grid["hiddenLayer2"])))
        nc = max(num_classes, 2)

        def col(k):
            return torch.as_tensor(np.asarray(grid[k], np.float32),
                                   device=dev)
        # the JAX package's float32 seeds arange(B) + seed, cast to int32
        seeds = (torch.arange(B, dtype=_F32, device=dev)
                 + float(self.seed)).to(torch.int32)
        params, m1, m2 = _fit_mlp_batch(
            X.to(_F32), y.to(torch.int32), weights.to(_F32),
            col("hiddenLayer1"), col("hiddenLayer2"), col("stepSize"),
            seeds, h_max, nc, self.max_iter)
        return {"params": params, "masks": (m1, m2), "num_classes": nc}

    def slice_params(self, batched, lo, hi):
        return {"params": tuple(a[lo:hi] for a in batched["params"]),
                "masks": tuple(a[lo:hi] for a in batched["masks"]),
                "num_classes": batched["num_classes"]}

    def select_params(self, batched, idx: int):
        return {"params": tuple(a[idx].contiguous()
                                for a in batched["params"]),
                "masks": tuple(a[idx].contiguous()
                               for a in batched["masks"]),
                "num_classes": batched["num_classes"]}

    def params_from_numpy(self, params, device):
        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=_F32,
                                   device=device).contiguous()
        return {"params": tuple(t(a) for a in params["params"]),
                "masks": tuple(t(a) for a in params["masks"]),
                "num_classes": int(params["num_classes"])}

    def predict_batch(self, params, X, num_classes):
        with _tf32_off():
            probs = torch.softmax(_forward(params["params"], X.to(_F32),
                                           params["masks"]), dim=-1)
        return probs[:, :, 1] if num_classes <= 2 else probs

    def predict_parts(self, fitted: FittedParams, X):
        p = fitted.params
        with _tf32_off():
            logits = _forward(p["params"], X.to(_F32), p["masks"])
        prob = torch.softmax(logits, dim=-1)
        return {"prediction": prob.argmax(dim=1).to(_F32),
                "probability": prob, "rawPrediction": logits}


register_family(MultilayerPerceptronFamily())
