"""Seeded inputs for the tests and ``chip_smoke.py``: random forests for
holding the descent kernels to their plain versions, the descent, the
leaf sums and the one-hot histogram by their definitions, and the serve
bench's pinned models, training frame and workflow; the Titanic-shaped
CSV; and the comparators that hold a fitted SanityChecker and a selector
summary to a fixture's.
Everything random is numpy, so the same seed gives the same inputs to the
JAX package and to the port."""
from __future__ import annotations

import re
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: the serve bench's models, as the committed ``serve64`` fixtures were
#: trained: {fixture key: (family, hyperparameters, problem kind)}; the
#: problem kind picks the frame's label and the selector. A pinned key
#: sweeps one family at one grid point; a ``default_*`` key (family None)
#: sweeps its problem kind's default model list at full default grids
SERVE_MODELS = {
    "rf": ("OpRandomForestClassifier",
           {"maxDepth": 12, "numTrees": 50, "minInstancesPerNode": 10,
            "minInfoGain": 0.001, "subsamplingRate": 1.0},
           "binary"),
    "gbt": ("OpGBTClassifier",
            {"maxDepth": 6, "maxIter": 20, "stepSize": 0.1,
             "minInstancesPerNode": 10, "minInfoGain": 0.001},
            "binary"),
    "dt": ("OpDecisionTreeClassifier",
           {"maxDepth": 6, "minInstancesPerNode": 10, "minInfoGain": 0.001},
           "binary"),
    "gbt12": ("OpGBTClassifier",
              {"maxDepth": 12, "maxIter": 20, "stepSize": 0.1,
               "minInstancesPerNode": 10, "minInfoGain": 0.001},
              "binary"),
    "rfreg": ("OpRandomForestRegressor",
              {"maxDepth": 12, "numTrees": 50, "minInstancesPerNode": 10,
               "minInfoGain": 0.001, "subsamplingRate": 1.0},
              "regression"),
    "gbtreg": ("OpGBTRegressor",
               {"maxDepth": 6, "maxIter": 20, "stepSize": 0.1,
                "minInstancesPerNode": 10, "minInfoGain": 0.001},
               "regression"),
    "rfmc": ("OpRandomForestClassifier",
             {"maxDepth": 12, "numTrees": 50, "minInstancesPerNode": 10,
              "minInfoGain": 0.001, "subsamplingRate": 1.0},
             "multiclass"),
    "xgbmc": ("OpXGBoostClassifier",
              {"maxDepth": 6, "maxIter": 100, "stepSize": 0.3,
               "minChildWeight": 1.0, "lambda": 1.0, "minInfoGain": 0.0,
               "minInstancesPerNode": 0.0},
              "multiclass"),
    "lr": ("OpLogisticRegression",
           {"regParam": 0.01, "elasticNetParam": 0.5}, "binary"),
    "svc": ("OpLinearSVC", {"regParam": 0.01}, "binary"),
    "lrmc": ("OpLogisticRegression", {"regParam": 0.01}, "multiclass"),
    "nbmc": ("OpNaiveBayes", {"smoothing": 1.0}, "multiclass"),
    "linreg": ("OpLinearRegression",
               {"regParam": 0.01, "elasticNetParam": 0.5}, "regression"),
    "glm": ("OpGeneralizedLinearRegression",
            {"family": "gaussian", "regParam": 0.01}, "regression"),
    "default_binary": (None, None, "binary"),
    "default_mc": (None, None, "multiclass"),
    "default_reg": (None, None, "regression"),
    "mlp": ("OpMultilayerPerceptronClassifier",
            {"hiddenLayer1": 50, "hiddenLayer2": 50, "stepSize": 0.05},
            "binary"),
    "mlpmc": ("OpMultilayerPerceptronClassifier",
              {"hiddenLayer1": 50, "hiddenLayer2": 50, "stepSize": 0.05},
              "multiclass"),
}

#: default lists whose refit is a pinned key's model (the same family,
#: hyperparameters, frame and refit program): their fixture keeps only
#: ``summary.json``, and the pinned key's saved model stands for theirs
SHARED_REFITS = {"default_binary": "svc", "default_mc": "lrmc"}

#: the keys whose fixture holds a saved model of its own
SAVED_KEYS = [k for k in SERVE_MODELS if k not in SHARED_REFITS]

#: the committed fixtures' training frame (``serve_bench_data``) and
#: scoring frame (``score_frame()``): rows and seed
TRAIN_ROWS, TRAIN_SEED = 20000, 0
SCORE_ROWS, SCORE_SEED = 4096, 1

#: classes of the multiclass serve frame
SERVE_CLASSES = 6

#: the fixture key whose scores the isotonic calibrator is fitted to
#: (``calibration.npz`` beside its model)
CALIBRATED_KEY = "mlp"


def calibration_labels(scores: np.ndarray,
                       seed: int = SCORE_SEED) -> np.ndarray:
    """Binary labels for calibrating ``scores`` in [0, 1]: 1 with
    probability score^2 (float32), from ``RandomState(seed)``, so the
    scores are miscalibrated and the isotonic fit has work to do."""
    s = np.asarray(scores, np.float32)
    return (np.random.RandomState(seed).rand(len(s)) < s * s).astype(
        np.float32)


def random_heap(rng: np.random.RandomState, n: int, d: int, T: int,
                depth: int, k: int, n_bins: int,
                stop: float = 0.2) -> Dict[str, np.ndarray]:
    """codes (n, d), feat/bins (T, 2^depth - 1), leaf (T, 2^depth, k) in
    [0, 1) like a forest's class shares; a ``stop`` share of the nodes
    carries the sentinel bin ``n_bins``."""
    H = 2 ** depth - 1
    bins = rng.randint(0, n_bins - 1, (T, H))
    bins = np.where(rng.rand(T, H) < stop, n_bins, bins)
    return {
        "codes": rng.randint(0, n_bins, (n, d)).astype(np.int32),
        "feat": rng.randint(0, d, (T, H)).astype(np.int32),
        "bins": bins.astype(np.int32),
        "leaf": rng.rand(T, 2 ** depth, k).astype(np.float32),
    }


def random_chain(rng: np.random.RandomState, n: int, d: int, T: int,
                 depth: int, W: int, k: int, n_bins: int,
                 stop: float = 0.3) -> Dict[str, np.ndarray]:
    """codes (n, d), feat/bins/base (T, depth, W), leaf (T, min(2^depth, W),
    k) in [0, 1): a consistent slot chain (every base points inside the
    next level) with a ``stop`` share of finished slots (sentinel bin)."""
    feat = rng.randint(0, d, (T, depth, W)).astype(np.int32)
    bins = rng.randint(0, n_bins - 1, (T, depth, W)).astype(np.int32)
    base = np.zeros((T, depth, W), np.int32)
    for lv in range(depth):
        Wl = min(2 ** lv, W)
        Wn = min(2 ** (lv + 1), W)
        base[:, lv, :Wl] = rng.randint(0, max(Wn - 1, 1), (T, Wl))
        done = rng.rand(T, Wl) < stop
        bins[:, lv, :Wl] = np.where(done, n_bins, bins[:, lv, :Wl])
    return {
        "codes": rng.randint(0, n_bins, (n, d)).astype(np.int32),
        "feat": feat, "bins": bins, "base": base,
        "leaf": rng.rand(T, min(2 ** depth, W), k).astype(np.float32),
    }


def hist_direct(codes: np.ndarray, A: np.ndarray, n_bins: int) -> np.ndarray:
    """The one-hot histogram by its definition, in float64:
    out[a, f * n_bins + b] = sum_s A[s, a] * 1[codes[s, f] == b]; codes
    outside [0, n_bins) add nothing."""
    S, d = codes.shape
    out = np.zeros((A.shape[1], d * n_bins), np.float64)
    A64 = A.astype(np.float64)
    for f in range(d):
        ok = (codes[:, f] >= 0) & (codes[:, f] < n_bins)
        for b in range(n_bins):
            out[:, f * n_bins + b] = A64[ok & (codes[:, f] == b)].sum(0)
    return out


def descend_direct(codes: np.ndarray, feat: np.ndarray, bins: np.ndarray,
                   base: Optional[np.ndarray] = None,
                   depth: Optional[int] = None) -> np.ndarray:
    """(n, T) leaf ids by a row-by-row walk of the definition: heap trees
    (feat/bins (T, 2^depth - 1), node' = 2 node + go) or, with ``base``,
    slot chains ((T, depth, W) tables, slot' = base + go; a slot past its
    level's width min(2^l, W) becomes slot 0); go = codes[s, feat] > bin,
    a feature outside [0, d) reading code 0."""
    n, d = codes.shape
    T = feat.shape[0]
    out = np.zeros((n, T), np.int64)
    for s in range(n):
        for t in range(T):
            def go(f, b):
                return int((codes[s, f] if 0 <= f < d else 0) > b)
            if base is None:
                node = 0
                for lv in range(depth):
                    j = 2 ** lv - 1 + node
                    node = 2 * node + go(feat[t, j], bins[t, j])
            else:
                node = 0
                W = feat.shape[2]
                for lv in range(feat.shape[1]):
                    if 0 <= node < min(2 ** lv, W):
                        node = int(base[t, lv, node]) + go(
                            feat[t, lv, node], bins[t, lv, node])
                    else:
                        node = 0
            out[s, t] = node
    return out


def leaf_sums_direct(ids: np.ndarray, aug: np.ndarray, L: int) -> np.ndarray:
    """sum_s aug[s, :] * 1[ids[s, t] == l] in float64, (T, L, k), as the
    contraction spells it: every row meets every (tree, leaf) cell, so a
    NaN or +-Inf stat times a 0 of the one-hot makes that cell NaN; ids
    outside [0, L) meet every cell with 0."""
    T = ids.shape[1]
    a = aug.astype(np.float64)
    out = np.empty((T, L, aug.shape[1]), np.float64)
    with np.errstate(invalid="ignore"):
        for t in range(T):
            onehot = (ids[:, t, None] == np.arange(L)).astype(np.float64)
            out[t] = (onehot[:, :, None] * a[:, None, :]).sum(0)
    return out


def leaf_sums_chunked(ids, aug, L: int, n_chunks: int, rows_per_chunk: int):
    """The leaf sums in the CUDA kernels' order, on the CPU: (T, L, k)
    float32. Rows [c * rows_per_chunk, +rows_per_chunk) make chunk c; each
    chunk adds its rows in ascending order from +0.0 (``index_add_``), then
    the chunk partials are added in chunk order; non-finite stats spread as
    in ``ops.forest.spread_nonfinite_sums``. ids (n, T) and aug (n, k) are
    torch tensors (ids outside [0, L) add nothing)."""
    import torch
    from .ops.forest import spread_nonfinite_sums
    ids, aug = ids.cpu().long(), aug.cpu().to(torch.float32)
    T, k = ids.shape[1], aug.shape[1]
    ok = (ids >= 0) & (ids < L)
    cell = torch.where(ok, ids + L * torch.arange(T), torch.full_like(
        ids, T * L))
    out = None
    for c in range(n_chunks):
        lo, hi = c * rows_per_chunk, (c + 1) * rows_per_chunk
        part = torch.zeros((T * L + 1, k), dtype=torch.float32)
        part.index_add_(0, cell[lo:hi].reshape(-1),
                        aug[lo:hi].repeat_interleave(T, dim=0))
        out = part if out is None else out + part
    return spread_nonfinite_sums(out[:T * L].reshape(T, L, k), ids, aug)


def _linear(X: np.ndarray, w: np.ndarray) -> np.ndarray:
    """X @ w with the products added in feature order in float64, rounded
    once to float32: the same bits on any machine (a BLAS product's order
    depends on the library and the CPU)."""
    W = w.reshape(w.shape[0], -1).astype(np.float64)
    acc = np.zeros((X.shape[0], W.shape[1]), np.float64)
    for i in range(X.shape[1]):
        acc += X[:, i, None].astype(np.float64) * W[i]
    return acc.reshape((X.shape[0],) + w.shape[1:]).astype(np.float32)


def serve_bench_data(n: int, d: int, seed: int,
                     task: str = "binary") -> Dict[str, np.ndarray]:
    """The serve bench's training frame: ``d`` standard-normal predictors
    ``x0..`` and a label ``y``, all float32 from ``RandomState(seed)`` (the
    recipe the committed fixtures were trained on). ``task`` picks the
    label: binary ``X @ w > 0``, regression ``X @ w`` (``_linear``),
    multiclass the argmax of ``SERVE_CLASSES`` linear scores whose
    weights are drawn after ``w``."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    w = rng.randn(d).astype(np.float32)
    data = {f"x{i}": X[:, i] for i in range(d)}
    if task == "binary":
        data["y"] = (X @ w > 0).astype(np.float32)
    elif task == "regression":
        data["y"] = _linear(X, w)
    elif task == "multiclass":
        W = rng.randn(d, SERVE_CLASSES).astype(np.float32)
        data["y"] = _linear(X, W).argmax(1).astype(np.float32)
    else:
        raise ValueError(f"unknown task {task!r}")
    return data


def score_frame(n: int = SCORE_ROWS, d: int = 64, seed: int = SCORE_SEED,
                nan_rate: float = 0.01) -> Dict[str, np.ndarray]:
    """A scoring frame, by default the serve fixtures': ``{x0..: float32
    column}`` of standard normals from ``RandomState(seed)``, a
    ``nan_rate`` share missing (NaN)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    X[rng.rand(n, d) < nan_rate] = np.nan
    return {f"x{i}": X[:, i] for i in range(d)}


def serve_bench_workflow(family: Optional[str], hyper: Optional[Dict],
                         d: int, seed: int, realnn: int = 0, device=None,
                         problem: str = "binary"):
    """``transmogrify -> sanity_check -> <problem>ModelSelector`` with
    cross-validation over ``d`` predictors (the first ``realnn`` RealNN,
    the rest Real), the winner pinned to one family and grid point, or,
    with ``family`` None, the selector's default model list: an untrained
    ``OpWorkflow`` without data."""
    from .dsl import transmogrify
    from .features import FeatureBuilder
    from .impl.selector import factories
    from .workflow import OpWorkflow
    selector = {"binary": factories.BinaryClassificationModelSelector,
                "multiclass": factories.MultiClassificationModelSelector,
                "regression": factories.RegressionModelSelector}[problem]
    label = FeatureBuilder.RealNN("y").extract_field().as_response()
    feats = [(FeatureBuilder.RealNN if i < realnn else FeatureBuilder.Real)(
        f"x{i}").extract_field().as_predictor() for i in range(d)]
    checked = transmogrify(feats).sanity_check(label)
    models = None if family is None else [(family, [dict(hyper)])]
    pred = (selector.with_cross_validation(seed=seed, models=models)
            .set_input(label, checked).get_output())
    return OpWorkflow(device=device).set_result_features(pred)


def refit_rows(model, data, seed: int = TRAIN_SEED):
    """The rows a trained serve-bench workflow's winner refit on, rebuilt
    from its training frame ``data``: (bin codes under the model's edges,
    labels, 0/1 row weights), padded to the row bucket as the selector
    pads them (every splitter of the three problem kinds keeps all of its
    train rows on the serve-bench frames)."""
    import torch

    from .impl.tuning.splitters import Splitter
    from .models import trees as TR
    from .utils.padding import bucket_for

    checked = model.stages[-2].get_output().name
    X = model.score(data=data)[checked].values          # all rows, kept cols
    train_idx, _ = Splitter(seed=seed).split(X.shape[0])
    X = X[torch.as_tensor(train_idx, device=X.device)]
    y = torch.as_tensor(data["y"][train_idx], device=X.device)
    n = X.shape[0]
    n_pad = bucket_for(n)
    X = torch.nn.functional.pad(X, (0, 0, 0, n_pad - n))
    y = torch.nn.functional.pad(y, (0, n_pad - n))
    w = (torch.arange(n_pad, device=X.device) < n).float()
    return TR._bin_features(X, model.stages[-1].fitted.params["edges"]), y, w


def boosting_stats(params, codes, y, w, task: str, rounds: int):
    """The per-row stats [g w, h w, w], each (S, C), that a boosted
    model's grower had at the start of round ``rounds``: F after its first
    ``rounds`` rounds of trees (heaps or slot chains) and leaves, replayed
    on the rows ``codes`` (labels ``y``, weights ``w``) as the grower adds
    them, then the task's gradients (sigmoid, squared error or
    softmax)."""
    import torch

    from .models import trees as TR
    from .ops.forest import route_codes, route_codes_chain
    from .ops.xla_cpu import fma32, xla_softmax

    leaf = params["leaf"]                                    # (R, C, L)
    C, S = leaf.shape[1], codes.shape[0]
    F = params["f0"].reshape(-1, 1).expand(C, S).contiguous()
    for r in range(rounds):
        if "base_lv" in params:
            ids = route_codes_chain(codes, params["feat_lv"][r],
                                    params["bins_lv"][r],
                                    params["base_lv"][r], TR.N_BINS)
        else:
            ids = route_codes(codes, params["feat"][r], params["bins"][r],
                              TR._depth_of(leaf.shape[-1]), TR.N_BINS)
        F = fma32(params["eta"].reshape(-1, 1),
                  leaf[r].gather(1, ids.long().T), F)
    if task == "binary":
        p = torch.sigmoid(F)
        g, h = p - y, torch.clamp(p * (1 - p), min=1e-6)
    elif task == "regression":
        g, h = F - y, torch.ones_like(F)
    else:
        P = xla_softmax(F[None])[0]
        Y1 = torch.nn.functional.one_hot(y.long(), max(C, 2)).float().T[:C]
        g, h = P - Y1, torch.clamp(P * (1 - P), min=1e-6)
    w_c = w[:, None].expand(S, C)
    return [g.T * w_c, h.T * w_c, w_c]


#: the Titanic fixture's training CSV (``titanic_csv``) and scoring rows:
#: rows and seed of each
TITANIC_ROWS, TITANIC_SEED = 20000, 0
TITANIC_SCORE_ROWS, TITANIC_SCORE_SEED = 4096, 1

_SURNAME_HEADS = ["Abb", "Ander", "Bar", "Beck", "Bir", "Brown", "Carl",
                  "Cor", "Dal", "Dav", "Ed", "Fal", "Ford", "Gold", "Gus",
                  "Hag", "Hans", "Hart", "Ib", "Jan", "John", "Kel", "Kir",
                  "Lar", "Lind", "Mac", "Mor", "Nel", "Nils", "Ol", "Pal",
                  "Pet", "Ras", "Rich", "Sand", "Sved", "Thom", "Van", "Wil",
                  "Zim"]
_SURNAME_TAILS = ["", "a", "ard", "berg", "by", "ell", "er", "es", "ett",
                  "ford", "gren", "ing", "ins", "kin", "land", "ley", "man",
                  "ner", "off", "on", "s", "sen", "ski", "son", "ston",
                  "ter", "ton", "us", "vik", "well"]
_MALE_NAMES = ["Albert", "Alfred", "Anders", "Arthur", "Charles", "Edward",
               "Ernst", "Frank", "Frederick", "George", "Harry", "Henry",
               "Hugh", "Jacob", "James", "Johan", "John", "Joseph", "Karl",
               "Leo", "Patrick", "Peter", "Richard", "Robert", "Samuel",
               "Thomas", "Walter", "William"]
_FEMALE_NAMES = ["Ada", "Agnes", "Alice", "Anna", "Annie", "Bertha",
                 "Catherine", "Edith", "Elizabeth", "Ellen", "Emily", "Emma",
                 "Florence", "Hanna", "Helen", "Ida", "Jane", "Kate", "Lily",
                 "Margaret", "Maria", "Marion", "Mary", "Nora", "Rose",
                 "Sarah", "Selma", "Susan"]
_TICKET_PREFIXES = ["", "", "", "", "PC ", "A/5 ", "STON/O2. ", "C.A. ",
                    "SOTON/O.Q. ", "W./C. ", "CA. ", "S.O.C. "]


def _skewed(rng: np.random.RandomState, n: int, k: int,
            shift: float) -> np.ndarray:
    """``n`` draws of 0..k-1 with P(i) proportional to 1 / (i + shift)."""
    p = 1.0 / (np.arange(k) + shift)
    return rng.choice(k, n, p=p / p.sum())


def _fmt(x: float) -> str:
    """A decimal as a CSV field: at most 4 places, no trailing zeros."""
    return f"{x:.4f}".rstrip("0").rstrip(".")


def titanic_frame(n: int, seed: int):
    """``n`` synthetic passengers in the Titanic schema
    (``examples.titanic.TITANIC_SCHEMA``), as rows of CSV fields ("" is
    blank), from ``RandomState(seed)``. At 20,000 rows: ``Name`` from
    surname, title and given-name pools (thousands of values, some with a
    quoted nickname), ``Ticket`` a few thousand values with a skewed group
    size (numeric and prefixed), ``Cabin`` ~75% blank, ``Embarked``
    S/C/Q and a few blanks, ``Age`` ~20% blank, ``Fare`` lognormal by
    class, ``SibSp``/``Parch`` small ints, ``Survived`` from sex, class,
    age and noise."""
    rng = np.random.RandomState(seed)
    female = rng.rand(n) < 0.35
    pclass = rng.choice([1, 2, 3], n, p=[0.24, 0.21, 0.55])
    title = np.where(
        female, np.where(rng.rand(n) < 0.45, "Mrs.", "Miss."),
        np.array(["Mr.", "Master.", "Dr.", "Rev."])[
            rng.choice(4, n, p=[0.88, 0.07, 0.03, 0.02])])
    surname = rng.randint(len(_SURNAME_HEADS), size=n) * len(
        _SURNAME_TAILS) + rng.randint(len(_SURNAME_TAILS), size=n)
    given_m = rng.randint(len(_MALE_NAMES), size=n)
    given_f = rng.randint(len(_FEMALE_NAMES), size=n)
    middle = rng.randint(26, size=n)
    has_middle = rng.rand(n) < 0.4
    nick = rng.rand(n) < 0.05
    age = np.where(title == "Master.", rng.uniform(0.42, 12, n),
                   np.clip(rng.normal(30.0, 13.5, n), 0.42, 80.0))
    age = np.where(age < 1, np.round(age, 2),
                   np.where(rng.rand(n) < 0.1, np.floor(age) + 0.5,
                            np.round(age)))
    age_blank = rng.rand(n) < 0.2
    sibsp = rng.choice([0, 1, 2, 3, 4, 5, 8], n,
                       p=[0.68, 0.23, 0.03, 0.02, 0.02, 0.01, 0.01])
    parch = rng.choice([0, 1, 2, 3, 4, 5, 6], n,
                       p=[0.76, 0.13, 0.09, 0.005, 0.005, 0.005, 0.005])
    n_tickets = max(n // 6, 20)
    t_prefix = rng.randint(len(_TICKET_PREFIXES), size=n_tickets)
    t_number = rng.randint(1000, 400000, size=n_tickets)
    ticket = _skewed(rng, n, n_tickets, 30.0)
    fare = np.choose(pclass - 1, [rng.lognormal(4.0, 0.6, n),
                                  rng.lognormal(2.9, 0.4, n),
                                  rng.lognormal(2.1, 0.35, n)])
    fare = np.where(rng.rand(n) < 0.01, 0.0, np.round(fare, 4))
    cabin_blank = rng.rand(n) < np.choose(pclass - 1, [0.2, 0.85, 0.97])
    deck = np.choose(pclass - 1, [rng.randint(0, 5, n),
                                  rng.randint(3, 6, n), rng.randint(4, 7, n)])
    cabin_no = 1 + _skewed(rng, n, 150, 4.0)
    cabin_multi = rng.rand(n) < 0.05
    embarked = np.array(["S", "C", "Q"])[rng.choice(3, n,
                                                    p=[0.72, 0.19, 0.09])]
    embarked_blank = rng.rand(n) < 0.002
    age_filled = np.where(age_blank, 30.0, age)
    logit = (-1.8 + 2.6 * female - 0.8 * (pclass - 2)
             - 0.025 * (age_filled - 30.0) + 0.8 * (title == "Master.")
             - 0.4 * (sibsp > 2) + 0.2 * np.log1p(fare)
             + 0.3 * (embarked == "C"))
    survived = rng.rand(n) < 1.0 / (1.0 + np.exp(-logit))
    rows = []
    for i in range(n):
        first = (_FEMALE_NAMES[given_f[i]] if female[i]
                 else _MALE_NAMES[given_m[i]])
        s = surname[i]
        name = (f"{_SURNAME_HEADS[s // len(_SURNAME_TAILS)]}"
                f"{_SURNAME_TAILS[s % len(_SURNAME_TAILS)]}, {title[i]} "
                f"{first}")
        if has_middle[i]:
            name += f" {chr(65 + middle[i])}."
        if nick[i]:
            pool = _FEMALE_NAMES if female[i] else _MALE_NAMES
            name += f' ("{pool[(given_f[i] + given_m[i]) % len(pool)]}")'
        t = ticket[i]
        letter = "ABCDEFG"[deck[i]]
        cabin = f"{letter}{cabin_no[i]}"
        if cabin_multi[i]:
            cabin += f" {letter}{cabin_no[i] + 2}"
        rows.append([
            str(i + 1), str(int(survived[i])), str(pclass[i]), name,
            "female" if female[i] else "male",
            "" if age_blank[i] else _fmt(age[i]), str(sibsp[i]),
            str(parch[i]), f"{_TICKET_PREFIXES[t_prefix[t]]}{t_number[t]}",
            _fmt(fare[i]), "" if cabin_blank[i] else cabin,
            "" if embarked_blank[i] else embarked[i]])
    return rows


def titanic_csv(path: str, n: int = TITANIC_ROWS,
                seed: int = TITANIC_SEED) -> str:
    """Write ``titanic_frame(n, seed)`` to ``path`` as a headerless CSV
    (the csv module's minimal quoting, ``\\n`` line ends); returns the
    sha256 of its bytes."""
    import csv
    import hashlib
    with open(path, "w", newline="") as fh:
        csv.writer(fh, lineterminator="\n").writerows(titanic_frame(n, seed))
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def titanic_wcv_workflow(train_csv: str, score_csv: str, device=None,
                         models=None):
    """(workflow, survived, prediction): ``examples.titanic``'s workflow
    on ``train_csv`` with a ``RawFeatureFilter`` (default thresholds)
    reading ``score_csv`` and workflow-level CV; ``models`` pins the
    selector's model list (None: the default list)."""
    from .examples.titanic import TITANIC_SCHEMA, build_workflow
    from .filters import RawFeatureFilter
    from .readers import DataReaders
    wf, survived, pred = build_workflow(train_csv, seed=42, models=models,
                                        device=device)
    score_reader = DataReaders.Simple.csv(
        score_csv, schema=TITANIC_SCHEMA, header=False,
        key_field="PassengerId")
    wf = (wf.with_raw_feature_filter(RawFeatureFilter(
        score_reader=score_reader, device=device)).with_workflow_cv())
    return wf, survived, pred


def json_gaps(got: Any, want: Any,
              limit: Callable[[Tuple[str, ...]], Optional[Tuple[float,
                                                                 float]]],
              path: Tuple[str, ...] = ()) -> Dict[str, float]:
    """Two JSON values: the same keys, strings, booleans, Nones and list
    lengths, and every number within ``limit(path)`` = (rtol, atol) of
    ``want``'s (``limit`` None: the path is not compared; a third entry
    lets a number of at most that size stand against None, a NaN that
    the other side's float32 rounding turned into noise); a string may
    differ only in the numbers it quotes, each held to the limit. Returns
    {top key: the largest gap / its limit (0 where exact)}; raises
    AssertionError with the count of differing values and the first
    eight."""
    out: Dict[str, float] = {}
    bad: list = []

    def note(p, ratio):
        key = p[0] if p else ""
        out[key] = max(out.get(key, 0.0), ratio)

    def rec(g, w, p):
        try:
            compare(g, w, p)
        except AssertionError as e:
            bad.append(str(e))

    def compare(g, w, p):
        lim = limit(p)
        if lim is None:
            return
        where = "/".join(p) or "<root>"
        if isinstance(w, dict):
            if not isinstance(g, dict) or sorted(g) != sorted(w):
                mine = sorted(g) if isinstance(g, dict) else g
                raise AssertionError(f"{where}: keys {mine!r} != "
                                     f"{sorted(w)!r}")
            for k in w:
                rec(g[k], w[k], p + (str(k),))
        elif isinstance(w, list):
            if not isinstance(g, list) or len(g) != len(w):
                raise AssertionError(f"{where}: {g!r} != {w!r}")
            for i, (a, b) in enumerate(zip(g, w)):
                rec(a, b, p + (str(i),))
        elif len(lim) > 2 and (g is None) != (w is None) and all(
                v is None or (isinstance(v, float) and abs(v) <= lim[2])
                for v in (g, w)):
            note(p, 0.0)        # NaN against a rounding-noise value
        elif isinstance(w, str) and isinstance(g, str) and g != w:
            # a message quoting numbers: the same words, each number
            # within the limit
            if _NUMBER.sub("#", g) != _NUMBER.sub("#", w):
                raise AssertionError(f"{where}: {g!r} != {w!r}")
            for a, b in zip(_NUMBER.findall(g), _NUMBER.findall(w)):
                compare(float(a), float(b), p)
        elif isinstance(w, bool) or w is None or isinstance(w, str):
            if g != w or type(g) is not type(w):
                raise AssertionError(f"{where}: {g!r} != {w!r}")
        elif isinstance(w, (int, float)):
            if isinstance(g, bool) or not isinstance(g, (int, float)):
                raise AssertionError(f"{where}: {g!r} != {w!r}")
            rtol, atol = lim[:2]
            bound = atol + rtol * abs(w)
            gap = abs(float(g) - float(w))
            if not gap <= bound:
                raise AssertionError(f"{where}: {g!r} vs {w!r} (gap {gap:.3g}"
                                     f" > limit {bound:.3g})")
            note(p, gap / bound if bound else 0.0)
        else:
            raise AssertionError(f"{where}: cannot compare {w!r}")

    rec(got, want, path)
    if bad:
        raise AssertionError(f"{len(bad)} value(s) differ: "
                             + "; ".join(bad[:8]))
    return out


def insights_by_feature(js: Dict[str, Any]) -> Dict[str, Any]:
    """``ModelInsights.to_json()`` with its feature list keyed by feature
    name (the list is sorted by contribution, whose near-ties may order
    two runs differently)."""
    return dict(js, features={f["feature_name"]: f for f in js["features"]})


#: the Titanic workflow-CV path's linear sweep fold metrics. Each fold's
#: sweep sees 18,000 rows x 529 columns, where the bf16 temporaries
#: amplify float32 summation order: the JAX package's own LR fold AuPR
#: moves by up to 6.0e-5 when only its input's columns are reordered, and
#: the port lies 1.02e-4 from it on the same fold matrices (CPU). The limit
#: sits above twice that spread and below the gaps of a sweep at the
#: refit's settings (8.3e-4) or with its CG schedule a step off (3.5e-4,
#: 7.2e-3); it does not see the bf16 rounding itself (1.7e-4 without it)
#: (``tests/test_torch_titanic_wcv_e2e.py``)
WCV_LIN_FOLD_ATOL = 2e-4

#: the linear families, whose fold metrics come from bf16 sweeps and
#: whose contributions are |coefficients|
LINEAR_FAMILIES = ("OpLogisticRegression", "OpLinearSVC")


def insight_limits(winner: str, want: Dict[str, Any],
                   coef_rtol: float = 2e-4, eval_atol: float = 1e-3,
                   count_atol: float = 2.0, fold_atol: float = 5e-5,
                   corr_atol: float = 1e-6):
    """The limit function (``json_gaps``) of two ``ModelInsights.to_json()``
    reports, each number held to the limit of its source: float32 Pearson
    correlations (the filter's null-label ones, the SanityChecker's label
    ones) ``corr_atol`` (a constant column's may be None in one and at
    most that in the other: a 0/0); the filter's JS divergences 1e-9
    relative, its other numbers exact; the SanityChecker's other
    statistics 1e-4 relative or 1e-12 absolute (as
    ``assert_same_sanity``), its redundancy pairs 2e-6 (rounded to six
    places); a linear winner's contributions (|coefficients|)
    ``coef_rtol`` of the largest, a tree winner's (split shares) exact;
    mean fold metrics and the winner's metric ``fold_atol`` (the linear
    sweeps' limit, the largest); the refit's train and holdout evaluation
    ``eval_atol`` and its confusion counts ``count_atol`` (rows whose
    probability sits within the refit's limit of 0.5 may flip); the
    version string exact, the git commit and save time not compared;
    everything else exact."""
    biggest = max([abs(d["contribution"]) for f in want["features"]
                   for d in f["derived"] if d["contribution"] is not None],
                  default=0.0)
    contribution = ((0.0, coef_rtol * biggest)
                    if winner in LINEAR_FAMILIES else (0.0, 1e-12))
    exact = (0.0, 0.0)

    def limit(path):
        top = path[0] if path else ""
        leaf = path[-1] if path else ""
        if top == "versionInfo":
            return exact if len(path) < 2 or path[1] == "version" else None
        if top == "rawFeatureFilterResults":
            return {"js_divergence": (1e-9, 0.0),
                    "null_label_correlation": (0.0, corr_atol)}.get(leaf,
                                                                    exact)
        if top == "features":
            if leaf == "contribution":
                return contribution
            # a constant column's label correlation is 0/0: NaN (None) in
            # one package, float32 rounding noise in the other
            return (0.0, corr_atol, corr_atol) if leaf == "correlation" \
                else (1e-4, 1e-12)
        if top == "crossFeatureRedundancy":
            return (0.0, 2e-6)
        if top == "categoricalPointwiseMutualInfo":
            return (1e-4, 1e-12)
        if top == "modelValidationResults" and "meanMetrics" in path:
            return (0.0, fold_atol)
        if top == "selectedModel":
            if leaf == "bestMetricValue":
                return (0.0, fold_atol)
            if len(path) > 1 and path[1] in ("trainEvaluation",
                                             "holdoutEvaluation"):
                return (0.0, count_atol if leaf in ("TP", "TN", "FP", "FN")
                        else eval_atol)
        return exact
    return limit


_NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def sanity_summary(stage) -> dict:
    """What a fixture keeps of a fitted SanityChecker (either package's):
    kept slots, dropped names and the removal reasons."""
    s = stage.summary
    return {"keep_indices": list(stage.keep_indices),
            "dropped": list(s.dropped),
            "reasons": {k: list(v) for k, v in s.reasons.items()}}


def assert_same_sanity(got: dict, want: dict, rel: float = 1e-4) -> None:
    """Two ``sanity_summary`` dicts: the same kept slots, dropped names and
    reasons, a number quoted in a reason within 1e-12 absolute or ``rel``
    relative (float32 moments summed in another order: a constant
    column's variance is 0 in one and 2.7e-15 where XLA fuses its mean
    into the subtraction; the streamed folds add in the JAX package's
    order, so the stream path passes 0). Raises AssertionError."""
    if (got["keep_indices"] != want["keep_indices"]
            or got["dropped"] != want["dropped"]
            or sorted(got["reasons"]) != sorted(want["reasons"])):
        raise AssertionError("the SanityChecker keeps or drops other "
                             "columns than expected")
    for name, why in want["reasons"].items():
        mine = got["reasons"][name]
        if [_NUMBER.sub("#", w) for w in mine] != [
                _NUMBER.sub("#", w) for w in why]:
            raise AssertionError(f"{name} dropped for {mine}, expected "
                                 f"{why}")
        for g, w in zip(mine, why):
            for a, b in zip(_NUMBER.findall(g), _NUMBER.findall(w)):
                if abs(float(a) - float(b)) > max(1e-12,
                                                  rel * abs(float(b))):
                    raise AssertionError(f"{name}: {g!r}, expected {w!r}")


def selection_summary(summary) -> dict:
    """Winner, hyperparameters, metric and each family's grid and (folds,
    configs) fold metrics of either package's selector summary (float32
    values, exact in JSON)."""
    def values(m):
        return np.asarray(m.detach().cpu() if hasattr(m, "detach") else m,
                          np.float32).tolist()
    return {"winner": summary.best_model_type,
            "hyper": dict(summary.best_hyper),
            "metric": summary.validation_metric,
            "value": float(summary.best_metric_value),
            "families": [{"family": r.family, "grid": list(r.grid),
                          "fold_metrics": values(r.fold_metrics)}
                         for r in summary.validation_results]}


def selection_gaps(got: dict, want: dict,
                   limit: Callable[[str, dict, float], Optional[float]]
                   ) -> Dict[str, Tuple[float, float]]:
    """Two ``selection_summary`` dicts: the same winner, hyperparameters,
    families and grids, and every (fold, configuration) metric within
    ``limit(family, hyper, want's value)`` of ``want``'s (a limit of None:
    finite exactly where ``want``'s is). Returns {family: (largest gap,
    largest gap / limit)}; raises AssertionError."""
    if (got["winner"], got["hyper"]) != (want["winner"], want["hyper"]):
        raise AssertionError(f"winner {got['winner']} {got['hyper']}, "
                             f"expected {want['winner']} {want['hyper']}")
    if [(g["family"], g["grid"]) for g in got["families"]] != [
            (w["family"], w["grid"]) for w in want["families"]]:
        raise AssertionError("other families or grids than expected")
    out = {}
    for g, w in zip(got["families"], want["families"]):
        gf = np.asarray(g["fold_metrics"], np.float64)
        wf = np.asarray(w["fold_metrics"], np.float64)
        if gf.shape != wf.shape:
            raise AssertionError(f"{g['family']} fold metrics {gf.shape}, "
                                 f"expected {wf.shape}")
        worst, share = 0.0, 0.0
        for (f, c), ref in np.ndenumerate(wf):
            lim = limit(g["family"], g["grid"][c], ref)
            if lim is None:
                if np.isfinite(gf[f, c]) != np.isfinite(ref):
                    raise AssertionError(f"{g['family']} {g['grid'][c]} "
                                         f"finite where expected not, or "
                                         f"the reverse")
                continue
            gap = abs(gf[f, c] - ref)
            worst, share = max(worst, gap), max(share, gap / lim)
            if gap > lim:
                raise AssertionError(
                    f"{g['family']} {g['grid'][c]} fold {f} metric "
                    f"{gf[f, c]} off the expected {ref} beyond {lim:.3g}")
        out[g["family"]] = (worst, share)
    return out


def selection_rows(selector, table):
    """(X, y): the rows the model selector ``selector`` (the estimator of
    a trained workflow) swept, rebuilt from the trained model's
    ``train_table`` on its device: the splitter's rows and label
    mapping, as the selector's fit takes them."""
    import torch
    label_f, vec_f = selector.input_features
    y_all = torch.as_tensor(table[label_f.name].values).to(
        torch.float32).reshape(-1)
    X_all = torch.as_tensor(table[vec_f.name].values).to(torch.float32)
    _, _, rows, prep = selector._prepared_rows(y_all.cpu().numpy())
    idx = torch.as_tensor(rows, device=X_all.device)
    X, y = X_all[idx], y_all[idx]
    if prep.label_mapping:
        # dense class indices, as the selector's fit maps them
        y = torch.as_tensor(np.array(
            [prep.label_mapping.get(int(v), -1) for v in y.cpu().numpy()],
            np.float32), device=X.device)
    return X, y


def sweep_again(selector, X, y, families) -> Dict[str, np.ndarray]:
    """{family name: (folds, configurations) fold metrics}: the sweep of
    ``families`` by ``selector`` (its validator, folds, grids and metric)
    on ``X`` and ``y`` (``selection_rows``, in any dtype, device or
    column order). On the rows as trained it repeats the train's sweep;
    in float64 it evaluates the same sweep with float64 sums
    (``models.linear``)."""
    metric, larger_better = selector.validation_metric
    out = {}
    for family, grid in selector.models:
        if family.name in families:
            best = selector.validator.validate(
                [(family, grid)], X, y, selector.problem, metric,
                larger_better, selector._num_classes(y.cpu().numpy()))
            out[family.name] = np.asarray(best.results[0].fold_metrics,
                                          np.float64)
    return out


# ---------------------------------------------------------------------------
# The lead-conversion table: dates, geolocations and maps
# ---------------------------------------------------------------------------

#: the leads fixtures' training and scoring records: rows and seed of each
LEADS_ROWS, LEADS_SEED = 20000, 0
LEADS_SCORE_ROWS, LEADS_SCORE_SEED = 4096, 1
#: the instant the leads fixtures were trained at (2026-01-01 00:00 UTC,
#: epoch ms): the date-list pivot's "days since" counts back from the
#: clock reading its vectorizer takes when it is built, so a train that
#: is to match the fixtures builds its DAG with the clock at this instant
#: (``fixed_clock``)
LEADS_CLOCK_MS = 1767225600000
_DAY_MS = 86_400_000

#: the leads table's predictors: (field, feature type), in the order the
#: workflows build them
LEADS_PREDICTORS = (
    ("CreatedDate", "Date"), ("LastActivity", "DateTime"),
    ("Activities", "DateList"), ("Location", "Geolocation"),
    ("Scores", "RealMap"), ("Visits", "IntegralMap"),
    ("Flags", "BinaryMap"), ("Attributes", "PickListMap"),
    ("Products", "MultiPickListMap"), ("Notes", "TextMap"),
    ("Milestones", "DateMap"), ("Offices", "GeolocationMap"),
    ("AnnualRevenue", "Currency"), ("Employees", "Integral"))
LEADS_STAGES = ("Open", "Working", "Nurturing", "Qualified")
#: the leads fixtures: directory -> (label, the selector's pinned models;
#: None sweeps the default list at full default grids). Path (a) trains
#: ``Converted``, path (b) the indexed ``Stage`` with the RF of
#: ``SERVE_MODELS["rfmc"]``
LEADS_PATHS = {
    "leads": ("Converted", None),
    "leads_stage": ("Stage", [(SERVE_MODELS["rfmc"][0],
                               [dict(SERVE_MODELS["rfmc"][1])])]),
}

_INDUSTRIES = ["Technology", "Finance", "Healthcare", "Retail",
               "Manufacturing", "Education", "Energy", "Media",
               "Transportation", "Hospitality", "Government", "Nonprofit"]
_SOURCES = ["Web", "Referral", "Partner", "Trade Show", "Email Campaign",
            "Cold Call", "Advertisement", "Social"]
_RATINGS = ["Hot", "Warm", "Cold"]
_PRODUCTS = [f"product_{c}" for c in "abcdefghij"]
_CHANNELS = ["email", "phone", "chat", "webinar", "meeting", "social"]
_METROS = [(37.7749, -122.4194), (40.7128, -74.006), (51.5074, -0.1278),
           (48.8566, 2.3522), (35.6762, 139.6503), (-33.8688, 151.2093),
           (19.4326, -99.1332), (52.52, 13.405)]
_NOTE_WORDS = (
    "asked about pricing budget approved next quarter wants demo follow up "
    "call back decision maker out of office renewal contract legal review "
    "competitor evaluating integration api security questionnaire trial "
    "extended champion left team expanding headcount interested in "
    "enterprise tier discount requested procurement timeline unclear sent "
    "proposal case study onboarding migration from legacy system pilot "
    "success stakeholders aligned no response voicemail meeting booked "
    "references needed").split()


def _geo(rng: np.random.RandomState, metro: int) -> List[float]:
    lat, lon = _METROS[metro]
    return [round(float(lat + 0.5 * rng.randn()), 4),
            round(float(lon + 0.5 * rng.randn()), 4),
            float(rng.randint(1, 10))]


def leads_records(n: int, seed: int) -> List[Dict[str, Any]]:
    """``n`` sales leads (one record a lead, like a CRM's Lead object) from
    ``RandomState(seed)``, in python values (None missing): ``LeadId``;
    ``CreatedDate`` (Date, two years of epoch ms before
    ``LEADS_CLOCK_MS``, 5% None); ``LastActivity`` (DateTime, half of them
    in business hours, 10% None); ``Activities`` (DateList of 0-30 event
    times, 15% empty); ``Location`` ([lat, lon, accuracy] near one of
    eight metros, 8% None); the maps ``Scores`` (RealMap, keys s0-s5 each
    present 70%), ``Visits`` (IntegralMap: web, email, phone), ``Flags``
    (BinaryMap: opted_in, bounced, vip), ``Attributes`` (PickListMap:
    industry of 12, source of 8, rating of 3), ``Products``
    (MultiPickListMap: interest, a sorted subset of 10), ``Notes``
    (TextMap: summary, free text of thousands of values; channel, 6
    values), ``Milestones`` (DateMap: first_call, demo, quote) and
    ``Offices`` (GeolocationMap: hq, branch); ``AnnualRevenue`` (Currency)
    and ``Employees`` (Integral), each ~10% None; the label ``Converted``
    (0/1) and ``Stage`` (4 skewed values: 45%, 30%, 15%, 10%), both from
    the same logit of business-hour activity, recency, scores, web visits,
    flags, rating, interests, channel, milestones and revenue."""
    rng = np.random.RandomState(seed)
    span = 730 * _DAY_MS
    created = LEADS_CLOCK_MS - span + rng.randint(0, span - 120 * _DAY_MS,
                                                  n, dtype=np.int64)
    created_null = rng.rand(n) < 0.05
    business = rng.rand(n) < 0.5
    hour = np.where(business, rng.randint(9, 18, n), rng.randint(0, 24, n))
    la_day = created // _DAY_MS + rng.randint(0, 90, n)
    last_activity = (la_day * _DAY_MS + hour * 3_600_000
                     + rng.randint(0, 3_600_000, n))
    la_null = rng.rand(n) < 0.10
    n_events = np.where(rng.rand(n) < 0.15, 0, rng.randint(1, 31, n))
    metro = rng.randint(len(_METROS), size=n)
    loc_null = rng.rand(n) < 0.08
    scores = np.round(rng.randn(n, 6), 4)
    score_on = rng.rand(n, 6) < 0.7
    visits = np.stack([rng.poisson(3.0, n), rng.poisson(2.0, n),
                       rng.poisson(1.0, n)], axis=1)
    visit_on = rng.rand(n, 3) < 0.8
    flags = rng.rand(n, 3) < np.array([0.6, 0.1, 0.05])
    flag_on = rng.rand(n, 3) < 0.9
    industry = _skewed(rng, n, len(_INDUSTRIES), 2.0)
    source = _skewed(rng, n, len(_SOURCES), 2.0)
    rating = rng.choice(3, n, p=[0.2, 0.5, 0.3])
    attr_on = rng.rand(n, 3) < 0.9
    interest = rng.rand(n, len(_PRODUCTS)) < 0.2
    channel = _skewed(rng, n, len(_CHANNELS), 1.5)
    notes_on = rng.rand(n, 2) < np.array([0.85, 0.9])
    miles_on = rng.rand(n, 3) < np.array([0.7, 0.4, 0.2])
    miles_after = rng.randint(1, 60 * _DAY_MS, (n, 3), dtype=np.int64)
    office_on = rng.rand(n, 2) < np.array([0.6, 0.3])
    revenue = np.round(rng.lognormal(15.0, 1.2, n), 2)
    revenue_null = rng.rand(n) < 0.1
    employees = np.floor(rng.lognormal(4.0, 1.3, n)).astype(np.int64) + 1
    employees_null = rng.rand(n) < 0.08
    records: List[Dict[str, Any]] = []
    logits = np.empty(n)
    for i in range(n):
        events = sorted(int(created[i] + rng.randint(
            0, LEADS_CLOCK_MS - created[i], dtype=np.int64))
            for _ in range(n_events[i]))
        recency = ((LEADS_CLOCK_MS - events[-1]) / _DAY_MS if events
                   else 365.0)
        words = rng.randint(len(_NOTE_WORDS), size=rng.randint(3, 9))
        summary = " ".join(_NOTE_WORDS[w] for w in words)
        if rng.rand() < 0.3:
            summary += f" #{rng.randint(1000)}"
        interests = [p for p, on in zip(_PRODUCTS, interest[i]) if on]
        ms = {k: int(created[i] + miles_after[i, j])
              for j, k in enumerate(("first_call", "demo", "quote"))
              if miles_on[i, j]}
        offices = {k: _geo(rng, (metro[i] + j) % len(_METROS))
                   for j, k in enumerate(("hq", "branch")) if office_on[i, j]}
        logits[i] = (
            -1.6 + 0.9 * (business[i] and not la_null[i])
            - 0.004 * recency
            + (0.6 * scores[i, 0] if score_on[i, 0] else 0.0)
            - (0.4 * scores[i, 1] if score_on[i, 1] else 0.0)
            + (0.15 * visits[i, 0] if visit_on[i, 0] else 0.0)
            + 0.8 * (flags[i, 2] and flag_on[i, 2])
            - 1.0 * (flags[i, 1] and flag_on[i, 1])
            + ((1.0, 0.0, -0.8)[rating[i]] if attr_on[i, 2] else 0.0)
            + 0.25 * len(interests)
            + (0.3 if notes_on[i, 1] and channel[i] == 4 else 0.0)
            + 0.7 * ("demo" in ms) + 1.2 * ("quote" in ms)
            + (0.2 * (np.log(revenue[i]) - 15.0) if not revenue_null[i]
               else 0.0))
        records.append({
            "LeadId": f"00Q{seed:03d}{i:08d}",
            "CreatedDate": None if created_null[i] else int(created[i]),
            "LastActivity": None if la_null[i] else int(last_activity[i]),
            "Activities": events,
            "Location": None if loc_null[i] else _geo(rng, metro[i]),
            "Scores": {f"s{j}": float(scores[i, j]) for j in range(6)
                       if score_on[i, j]},
            "Visits": {k: int(visits[i, j]) for j, k in enumerate(
                ("web", "email", "phone")) if visit_on[i, j]},
            "Flags": {k: bool(flags[i, j]) for j, k in enumerate(
                ("opted_in", "bounced", "vip")) if flag_on[i, j]},
            "Attributes": {k: v for k, v, on in zip(
                ("industry", "source", "rating"),
                (_INDUSTRIES[industry[i]], _SOURCES[source[i]],
                 _RATINGS[rating[i]]), attr_on[i]) if on},
            "Products": {"interest": interests} if interests else {},
            "Notes": {k: v for k, v, on in zip(
                ("summary", "channel"), (summary, _CHANNELS[channel[i]]),
                notes_on[i]) if on},
            "Milestones": ms,
            "Offices": offices,
            "AnnualRevenue": None if revenue_null[i] else float(revenue[i]),
            "Employees": None if employees_null[i] else int(employees[i]),
        })
    p = 1.0 / (1.0 + np.exp(-logits))
    converted = rng.rand(n) < p
    stage_score = logits + rng.logistic(size=n)
    cuts = np.quantile(stage_score, [0.45, 0.75, 0.9])
    stage = np.searchsorted(cuts, stage_score)
    for i, r in enumerate(records):
        r["Converted"] = float(converted[i])
        r["Stage"] = LEADS_STAGES[stage[i]]
    return records


def records_sha256(records: Sequence[Dict[str, Any]]) -> str:
    """sha256 of the records' canonical JSON (sorted keys, no spaces)."""
    import hashlib
    import json
    return hashlib.sha256(json.dumps(
        records, sort_keys=True, separators=(",", ":")).encode()).hexdigest()


@contextmanager
def fixed_clock(module, ms: int):
    """Within the block the clock ``module._time.time()`` reads ``ms`` /
    1000 (both packages' ``impl.feature.dates`` read the clock there when
    a date-list vectorizer is built); restored after."""
    saved = module._time.time
    module._time.time = lambda: ms / 1000.0
    try:
        yield
    finally:
        module._time.time = saved


def leads_dag(ns, label: str = "Converted", models=None, seed: int = 42):
    """(result features, label feature, prediction): the leads workflow's
    DAG built from the names in ``ns`` (either package's
    ``FeatureBuilder``, ``transmogrify``, ``SanityChecker``, the binary and
    multiclass selector factories, ``UnaryTransformer``, ``RealNN`` and
    ``PredictionDeIndexer``), in one order, so after each package's
    ``reset_uids`` every stage has the same uid. ``label`` "Converted":
    ``transmogrify`` of the fourteen predictors -> ``sanity_check`` ->
    the binary selector with cross-validation (results: prediction,
    checked vector). "Stage": the stage's string indexed as the label ->
    the multiclass selector -> the prediction's class turned back into the
    stage's string by ``PredictionDeIndexer`` (results: prediction, the
    predicted stage, checked vector). ``models`` pins the selector's list
    (None: the default list)."""
    FB = ns.FeatureBuilder
    feats = [getattr(FB, t)(name).extract_field().as_predictor()
             for name, t in LEADS_PREDICTORS]
    if label == "Converted":
        y = FB.RealNN("Converted").extract_field().as_response()
        selector = ns.BinaryClassificationModelSelector
    else:
        y = FB.PickList(label).extract_field().as_response().indexed()
        selector = ns.MultiClassificationModelSelector
    checked = ns.transmogrify(feats).sanity_check(y)
    pred = (selector.with_cross_validation(seed=seed, models=models)
            .set_input(y, checked).get_output())
    if label == "Converted":
        return (pred, checked), y, pred
    # the prediction's class: a column pass hands the transform a row of
    # the Prediction's values (the prediction first), a row scorer the
    # Prediction's {key: value}
    index = ns.UnaryTransformer(
        "predictedIndex", transform_fn=lambda p: (
            p["prediction"] if isinstance(p, dict) else p[0]),
        output_type=ns.RealNN).set_input(pred).get_output()
    stage = ns.PredictionDeIndexer().set_input(y, index).get_output()
    return (pred, stage, checked), y, pred


def port_leads_namespace():
    """``leads_dag``'s names from the port."""
    from types import SimpleNamespace
    from .features import FeatureBuilder
    from .impl.feature.transmogrifier import transmogrify
    from .impl.preparators.prediction_deindexer import PredictionDeIndexer
    from .impl.selector import factories
    from .stages.base import UnaryTransformer
    from .types import RealNN
    return SimpleNamespace(
        FeatureBuilder=FeatureBuilder, transmogrify=transmogrify,
        BinaryClassificationModelSelector=(
            factories.BinaryClassificationModelSelector),
        MultiClassificationModelSelector=(
            factories.MultiClassificationModelSelector),
        UnaryTransformer=UnaryTransformer, RealNN=RealNN,
        PredictionDeIndexer=PredictionDeIndexer)


def leads_workflow(records, label: str = "Converted", models=None,
                   seed: int = 42, device=None,
                   clock_ms: Optional[int] = None):
    """(workflow, label feature, prediction, result features): the port's
    leads workflow (``leads_dag``) on ``records`` keyed by ``LeadId``, on
    ``device``. With ``clock_ms`` the uids restart
    (``features.reset_uids``) and the DAG is built with the date clock at
    that instant: at ``LEADS_CLOCK_MS`` it is the workflow the fixtures
    were trained from."""
    from .features import reset_uids
    from .impl.feature import dates
    from .workflow import OpWorkflow
    if clock_ms is None:
        results, y, pred = leads_dag(port_leads_namespace(), label, models,
                                     seed)
    else:
        reset_uids()
        with fixed_clock(dates, clock_ms):
            results, y, pred = leads_dag(port_leads_namespace(), label,
                                         models, seed)
    wf = (OpWorkflow(device=device).set_input_dataset(records,
                                                      key_field="LeadId")
          .set_result_features(*results))
    return wf, y, pred, results


# ---------------------------------------------------------------------------
# Multilingual support tickets (the NLP stages' workflow)
# ---------------------------------------------------------------------------

TICKETS_ROWS, TICKETS_SEED = 20000, 0
TICKETS_SCORE_ROWS, TICKETS_SCORE_SEED = 2000, 1

#: issue topics: (content words, escalation weight)
_TICKET_TOPICS = {
    "billing": ("invoice refund charged twice payment card billing "
                "subscription overcharged receipt renewal price plan "
                "discount credit cancelled", 0.2),
    "login": ("password reset locked account login sign authentication "
              "code email verification session expired username access "
              "denied", -0.3),
    "outage": ("outage down error server unavailable crash timeout "
               "dashboard failing production broken latency incident "
               "degraded api", 1.4),
    "shipping": ("delivery package tracking shipped late courier address "
                 "warehouse damaged parcel returned carrier order box "
                 "missing", -0.1),
    "feature": ("feature request would like export integration support "
                "option improve roadmap suggestion dark mode report "
                "custom field", -1.0),
    "security": ("security breach phishing suspicious hacked fraud "
                 "unauthorized compromised leaked vulnerability exploit "
                 "malware alert attack", 1.8),
}
_TICKET_FILLER = (
    "the my is and to it a we have this for please can you on not with "
    "our was but since yesterday today again still help need urgent "
    "issue problem customer team thanks hello hi regards when after "
    "every time now already tried several ways same result").split()
#: bodies in other languages: (function words, content words, weight)
_TICKET_LANGS = {
    "fr": ("le la les de et est pas pour dans une un que qui avec sur "
           "nous vous mais", "facture compte problème commande livraison "
           "erreur paiement mot passe", 0.4),
    "de": ("der die das und ist nicht mit für auf ein eine ich sie wir "
           "aber auch", "rechnung konto problem bestellung lieferung "
           "fehler zahlung passwort", 0.3),
    "es": ("el la los de y es no para en una un que con por pero muy "
           "nosotros", "factura cuenta problema pedido entrega error pago "
           "contraseña", 0.2),
    "it": ("il la di e è non per in una un che con del della ma sono "
           "anche", "fattura conto problema ordine consegna errore "
           "pagamento", 0.1),
    "pt": ("o a de e é não para em uma um que com do da mas são mais "
           "pelo", "fatura conta problema pedido entrega erro pagamento "
           "senha", 0.1),
    "nl": ("de het een en is niet voor met op van dat wij maar ook zijn "
           "naar", "factuur account probleem bestelling levering fout "
           "betaling", 0.2),
}
#: bodies in script-unique languages: (text pieces, weight)
_TICKET_SCRIPTS = {
    "ja": ("パスワード を リセット できません アカウント が ロック されました "
           "エラー が 出ます", 0.5),
    "ru": ("не могу войти в аккаунт ошибка оплаты заказ не доставлен "
           "пожалуйста помогите", 0.5),
    "ar": ("لا أستطيع الدخول إلى الحساب خطأ في الدفع الطلب لم يصل "
           "الرجاء المساعدة", 0.5),
}
_TICKET_PEOPLE = ["John Carter", "Maria Lopez", "Mr Smith", "Dr Patel",
                  "Anna Schmidt", "james wilson", "Ms Okafor"]
_TICKET_PLACES = ["in London", "near Paris", "at Berlin", "in Chicago",
                  "in Tokyo", "at Toronto"]
_TICKET_ORGS = ["Acme Corp", "Globex Inc", "Initech LLC", "Umbrella Ltd",
                "Stark Industries Company"]
_FREE_MAIL = ["gmail.com", "yahoo.com", "hotmail.com", "outlook.com"]
_CORP_MAIL = ["acme.com", "globex.io", "initech.co.uk", "example.org",
              "contoso.de"]
_BAD_EMAILS = ["john@@acme.com", "no-at-sign.com", "maria@", "@globex.io",
               "first last@example.org"]
_URL_HOSTS = ["www.acme.com", "support.globex.io", "status.initech.co.uk",
              "docs.example.org", "shop.contoso.de"]
_BAD_URLS = ["www.acme.com/help", "htp:/broken", "acme dot com",
             "mailto:help@acme.com"]
#: (country text, phone builder) of the phone column
_PHONE_COUNTRIES = ["US", "United States", "UK", "United Kingdom",
                    "Germany", "DE", "France", "India", "Canada", "Narnia",
                    None]


def _ticket_phone(rng: np.random.RandomState, country) -> str:
    def d(k, lo=0):
        return "".join(str(rng.randint(lo if i == 0 else 0, 10))
                       for i in range(k))
    kind = rng.rand()
    if kind < 0.1:
        return ["12345", "555-CALL-NOW", "0000", "+999 12"][rng.randint(4)]
    if country in ("UK", "United Kingdom"):
        return f"020 7946 {d(4)}" if kind < 0.6 else f"07{d(3)} {d(6)}"
    if country in ("Germany", "DE"):
        return f"030 {d(7, 1)}" if kind < 0.6 else f"+49 15{d(9)}"
    if country == "France":
        return f"01 {d(2)} {d(2)} {d(2)} {d(2)}"
    if country == "India":
        return f"+91 9{d(4)} {d(5)}"
    return f"({d(3, 2)}) {d(3, 2)}-{d(4)}"


def _ticket_attachment(rng: np.random.RandomState):
    """(kind, base64 text): a small generated file or None."""
    import base64
    import gzip
    import io
    import zipfile
    kind = ["pdf", "png", "docx", "gzip", "text", None][
        rng.choice(6, p=[0.2, 0.15, 0.1, 0.1, 0.15, 0.3])]
    payload = bytes(rng.randint(0, 256, rng.randint(32, 160)).tolist())
    if kind is None:
        return None, None
    if kind == "pdf":
        raw = b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n1 0 obj\n" + payload
    elif kind == "png":
        raw = b"\x89PNG\r\n\x1a\n\x00\x00\x00\rIHDR" + payload
    elif kind == "docx":
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as z:
            for name, body in (("[Content_Types].xml", b"<Types/>"),
                               ("word/document.xml", b"<w:document>"
                                + payload.hex().encode() + b"</w:document>")):
                z.writestr(zipfile.ZipInfo(name, (2024, 1, 1, 0, 0, 0)),
                           body)
        raw = buf.getvalue()
    elif kind == "gzip":
        raw = gzip.compress(b"log line " + payload.hex().encode(), mtime=0)
    else:
        raw = ("Attached log: error code " + payload.hex()).encode()
    return kind, base64.b64encode(raw).decode("ascii")


def tickets_records(n: int, seed: int) -> List[Dict[str, Any]]:
    """``n`` customer-support tickets from ``RandomState(seed)``, python
    values (None missing): ``TicketId``; ``subject`` (Text, 3-10 words);
    ``body`` (Text, 40-120 words: 80% English from one of six issue topics
    with filler and stop words, 16% in French, German, Spanish, Italian,
    Portuguese or Dutch, 4% Japanese, Russian or Arabic; a third name a
    person, a place or an organisation); ``email`` (Email: free or
    corporate domains, 8% malformed, 5% None); ``url`` (URL: http, https
    or ftp links, 10% malformed, 20% None); ``phone`` (Phone) and
    ``country`` (Text: a region code, a country name, an unknown name or
    None), valid and invalid numbers; ``attachment`` (Base64: a small PDF,
    PNG, zip holding a Word part, gzip or plain-text file, or None); the
    label ``escalated`` (0/1, ~34% ones) from a logit of the body's
    topic, its language, the attachment's type, the phone's validity, the
    email's domain and the subject's length (that logit's own AuPR ~0.89,
    a constant score's ~0.67)."""
    from .impl.feature.text import IsValidPhoneNumber
    valid_phone = IsValidPhoneNumber().transform_fn
    rng = np.random.RandomState(seed)
    topics = list(_TICKET_TOPICS)
    langs = list(_TICKET_LANGS)
    scripts = list(_TICKET_SCRIPTS)
    mime_w = {"pdf": 0.5, "png": 0.0, "docx": 0.7, "gzip": 0.9,
              "text": -0.3, None: -0.2}
    records: List[Dict[str, Any]] = []
    logits = np.empty(n)
    for i in range(n):
        topic = topics[rng.randint(len(topics))]
        words, t_w = _TICKET_TOPICS[topic]
        words = words.split()
        u = rng.rand()
        n_words = rng.randint(40, 121)
        lang_w = 0.0
        if u < 0.8:
            pool = rng.rand(n_words) < 0.35
            toks = [words[rng.randint(len(words))] if p else
                    _TICKET_FILLER[rng.randint(len(_TICKET_FILLER))]
                    for p in pool]
        elif u < 0.96:
            lang = langs[rng.randint(len(langs))]
            fw, cw, lang_w = _TICKET_LANGS[lang]
            fw, cw = fw.split(), cw.split()
            toks = [cw[rng.randint(len(cw))] if rng.rand() < 0.3 else
                    fw[rng.randint(len(fw))] for _ in range(n_words)]
        else:
            lang = scripts[rng.randint(len(scripts))]
            pieces, lang_w = _TICKET_SCRIPTS[lang]
            pieces = pieces.split()
            toks = [pieces[rng.randint(len(pieces))]
                    for _ in range(n_words // 3)]
        if rng.rand() < 0.33:
            ent = [_TICKET_PEOPLE, _TICKET_PLACES, _TICKET_ORGS][
                rng.randint(3)]
            toks.insert(rng.randint(1, len(toks)), ent[rng.randint(len(ent))])
        body = " ".join(toks)
        if rng.rand() < 0.5:
            body = body[0].upper() + body[1:] + "."
        n_subj = rng.randint(3, 11)
        subject = " ".join(
            words[rng.randint(len(words))] if rng.rand() < 0.6 else
            _TICKET_FILLER[rng.randint(len(_TICKET_FILLER))]
            for _ in range(n_subj))
        e = rng.rand()
        corp = rng.rand() < 0.4
        domain = (_CORP_MAIL if corp else _FREE_MAIL)[rng.randint(5 if corp
                                                                  else 4)]
        if e < 0.05:
            email = None
        elif e < 0.13:
            email = _BAD_EMAILS[rng.randint(len(_BAD_EMAILS))]
        else:
            email = f"user{rng.randint(100000)}.{topic}@{domain}"
        v = rng.rand()
        if v < 0.2:
            url = None
        elif v < 0.3:
            url = _BAD_URLS[rng.randint(len(_BAD_URLS))]
        else:
            proto = ["https", "http", "ftp"][rng.choice(3, p=[0.7, 0.25,
                                                             0.05])]
            url = (f"{proto}://{_URL_HOSTS[rng.randint(len(_URL_HOSTS))]}"
                   f"/ticket/{rng.randint(10 ** 6)}")
        country = _PHONE_COUNTRIES[rng.randint(len(_PHONE_COUNTRIES))]
        phone = None if rng.rand() < 0.07 else _ticket_phone(rng, country)
        kind, attachment = _ticket_attachment(rng)
        ok_phone = phone is not None and valid_phone(phone, country)
        logits[i] = -3.5 + 2.5 * (
            t_w + lang_w + mime_w[kind]
            - (0.7 if phone is not None and not ok_phone else 0.0)
            + (0.8 if email is not None and corp and "@" in email else 0.0)
            + 0.12 * (n_subj - 6))
        records.append({
            "TicketId": f"T{seed:03d}{i:08d}", "subject": subject,
            "body": body, "email": email, "url": url, "phone": phone,
            "country": country, "attachment": attachment,
        })
    p = 1.0 / (1.0 + np.exp(-logits))
    escalated = rng.rand(n) < p
    for r, y in zip(records, escalated):
        r["escalated"] = float(y)
    return records


#: the tickets table's raw predictors: (field, feature type)
TICKETS_PREDICTORS = (
    ("subject", "Text"), ("body", "Text"), ("email", "Email"),
    ("url", "URL"), ("phone", "Phone"), ("country", "Text"),
    ("attachment", "Base64"))


def tickets_dag(ns, models=None, seed: int = 42, word2vec_steps: int = 400,
                lda_iters: int = 30):
    """(result features, label feature, prediction): the tickets workflow
    built from the names in ``ns`` (either package's ``FeatureBuilder``,
    ``transmogrify``, ``TextTokenizer``, ``ParsePhoneNumber``,
    ``IsValidPhoneNumber`` and binary selector factory; every other stage
    through the DSL), in one order, so after each package's
    ``reset_uids`` every stage has the same uid. The body is tokenized
    with English stemming and its stop words removed; those tokens give a
    256-word count vector weighed by IDF, a 128-bigram count vector and
    32-wide word2vec means; the count vector gives 10 LDA topics. The
    body's languages and entities, the attachment's MIME type, the phone
    parsed and validated alone and with its country, the email's validity,
    domain and local part's length, the URL's validity, domain and
    protocol, the subject's length and its token Jaccard and character
    n-gram similarity to the body go through ``transmogrify``; all of it
    is combined, checked by the SanityChecker and fed to the binary
    selector with cross-validation (``models`` pins its list; None sweeps
    the default list). ``word2vec_steps`` and ``lda_iters`` are the two
    learners' SGD steps and EM sweeps (their defaults; small CPU trains
    take fewer). Results: prediction, checked vector."""
    FB = ns.FeatureBuilder
    raw = {name: getattr(FB, t)(name).extract_field().as_predictor()
           for name, t in TICKETS_PREDICTORS}
    y = FB.RealNN("escalated").extract_field().as_response()
    body, subject = raw["body"], raw["subject"]
    tokens = (ns.TextTokenizer(stemming=True, language="en")
              .set_input(body).get_output().remove_stop_words())
    counts = tokens.count_vec(256)
    blocks = [counts.idf(), tokens.ngram(2).count_vec(128),
              tokens.word2vec(32, steps=word2vec_steps),
              counts.lda(k=10, max_iter=lda_iters)]
    phone, country, email, url = (raw["phone"], raw["country"],
                                  raw["email"], raw["url"])
    rest = [
        body.detect_languages(), body.recognize_entities(),
        raw["attachment"].detect_mime_types(), phone.parse_phone(),
        phone.is_valid_phone(),
        ns.ParsePhoneNumber().set_input(phone, country).get_output(),
        ns.IsValidPhoneNumber().set_input(phone, country).get_output(),
        email.is_valid_email(), email.to_email_domain(),
        email.to_email_prefix().text_len(), url.is_valid_url(),
        url.to_url_domain(), url.to_url_protocol(), subject.text_len(),
        subject.tokenize().jaccard_similarity(body.tokenize()),
        subject.ngram_similarity(body)]
    checked = (ns.transmogrify(rest).combine(*blocks).sanity_check(y))
    pred = (ns.BinaryClassificationModelSelector.with_cross_validation(
        seed=seed, models=models).set_input(y, checked).get_output())
    return (pred, checked), y, pred


def port_tickets_namespace():
    """``tickets_dag``'s names from the port."""
    from types import SimpleNamespace
    from .features import FeatureBuilder
    from .impl.feature.text import IsValidPhoneNumber, ParsePhoneNumber
    from .impl.feature.transmogrifier import transmogrify
    from .impl.feature.vectorizers import TextTokenizer
    from .impl.selector import factories
    return SimpleNamespace(
        FeatureBuilder=FeatureBuilder, transmogrify=transmogrify,
        TextTokenizer=TextTokenizer, ParsePhoneNumber=ParsePhoneNumber,
        IsValidPhoneNumber=IsValidPhoneNumber,
        BinaryClassificationModelSelector=(
            factories.BinaryClassificationModelSelector))


def tickets_workflow(records, models=None, seed: int = 42, device=None,
                     reset: bool = True, **dag_kw):
    """(workflow, label feature, prediction, result features): the port's
    tickets workflow (``tickets_dag``) on ``records`` keyed by
    ``TicketId``, on ``device``; with ``reset`` the uids restart
    (``features.reset_uids``), as the fixture's workflow was built;
    ``dag_kw`` goes to ``tickets_dag``."""
    from .features import reset_uids
    from .workflow import OpWorkflow
    if reset:
        reset_uids()
    results, y, pred = tickets_dag(port_tickets_namespace(), models, seed,
                                   **dag_kw)
    wf = (OpWorkflow(device=device).set_input_dataset(records,
                                                      key_field="TicketId")
          .set_result_features(*results))
    return wf, y, pred, results


# ---------------------------------------------------------------------------
# Customer events (the aggregating readers' workflow)
# ---------------------------------------------------------------------------

EVENTS_USERS, EVENTS_SEED = 20000, 0
EVENTS_SCORE_USERS, EVENTS_SCORE_SEED = 4096, 1
#: the cutoff between a user's history and the label's window:
#: 2025-06-01 00:00:00 UTC
EVENTS_CUTOFF_MS = 1748736000000
EVENTS_DAYS_BEFORE, EVENTS_DAYS_AFTER = 90, 14
EVENT_KINDS = ("send", "click", "visit", "purchase")
_EVENT_KIND_P = np.array([0.35, 0.25, 0.3, 0.1])
_EVENT_PAGES = [f"/p/{w}" for w in (
    "home pricing docs blog careers about contact login signup support "
    "features integrations security status partners press events webinar "
    "download trial demo faq terms privacy api changelog community "
    "customers compare enterprise").split()]
_EVENT_CATEGORIES = ["books", "music", "garden", "toys", "sports",
                     "beauty", "grocery", "electronics"]
_EVENT_REGIONS = ["us-east", "us-west", "us-central", "ca", "mx", "br",
                  "uk", "de", "fr", "in", "jp", "au"]
_EVENT_PLANS = ["free", "basic", "pro", "enterprise"]
_EVENT_CHANNELS = ["organic", "paid_search", "social", "referral", "email"]
EVENTS_COLUMNS = ("userId", "ts", "kind", "url", "category", "price")
USERS_COLUMNS = ("userId", "age", "income", "tenureDays", "region", "plan",
                 "signupChannel")


def event_ms(ts: str) -> int:
    """``yyyy-MM-dd::HH:mm:ss`` (UTC) -> epoch ms (the proleptic
    Gregorian day count of ``calendar.timegm``, spelled out: it runs once
    an event and a feature)."""
    y, m, d = int(ts[0:4]), int(ts[5:7]), int(ts[8:10])
    y -= m <= 2
    era = y // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    days = era * 146097 + yoe * 365 + yoe // 4 - yoe // 100 + doy - 719468
    return 1000 * (days * 86400 + int(ts[12:14]) * 3600
                   + int(ts[15:17]) * 60 + int(ts[18:20]))


def _event_ts(ms: int) -> str:
    import time
    return time.strftime("%Y-%m-%d::%H:%M:%S", time.gmtime(ms // 1000))


def _zipf(rng: np.random.RandomState, n: int, k: int, a: float = 1.1
          ) -> np.ndarray:
    p = 1.0 / np.arange(1, k + 1) ** a
    return rng.choice(k, size=n, p=p / p.sum())


def events_files(out_dir: str, n_users: int = EVENTS_USERS,
                 seed: int = EVENTS_SEED) -> Tuple[str, str]:
    """Write ``events.csv`` and ``users.csv`` (headed) for ``n_users``
    users of a marketing cohort into ``out_dir``; (events path, users
    path). Each user has ~12 events (send, click, visit, purchase) from
    90 days before ``EVENTS_CUTOFF_MS`` to 14 days after it, at least one
    of them within the 7 days after it; a latent propensity, higher from
    1,500 days of tenure on, drives the purchases, their prices and the
    user's income and plan. Timestamps are
    ``yyyy-MM-dd::HH:mm:ss``; a visit has a page ``url``, a purchase a
    ``category`` and a ``price``, the other cells are empty. The users
    file holds ``age`` (15% empty), ``income`` (log-normal, 20% empty),
    ``tenureDays``, a skewed ``region`` of 12, a ``plan`` of 4 and a
    ``signupChannel`` of 5. numpy and the csv module only."""
    import csv
    import os
    rng = np.random.RandomState(seed)
    day = _DAY_MS
    tenure = rng.randint(0, 3000, size=n_users)
    z = 1.2 * (tenure >= 1500) - 0.6 + 0.8 * rng.randn(n_users)
    counts = 1 + rng.poisson(11, size=n_users)
    user = np.repeat(np.arange(n_users), counts)
    span = (EVENTS_DAYS_BEFORE + EVENTS_DAYS_AFTER) * day
    t = EVENTS_CUTOFF_MS - EVENTS_DAYS_BEFORE * day + (
        rng.rand(user.size) * span).astype(np.int64)
    # one event a user within the label's window (cutoff, cutoff + 7 days]
    t_next = EVENTS_CUTOFF_MS + 1000 + (
        rng.rand(n_users) * (7 * day - 1000)).astype(np.int64)
    user = np.concatenate([user, np.arange(n_users)])
    t = (np.concatenate([t, t_next]) // 1000) * 1000
    p = np.tile(_EVENT_KIND_P, (n_users, 1))
    p[:, 3] *= np.exp(0.9 * z)
    p /= p.sum(axis=1, keepdims=True)
    cum = np.cumsum(p, axis=1)[user]
    kind = (rng.rand(user.size)[:, None] > cum).sum(axis=1).clip(0, 3)
    page = _zipf(rng, user.size, len(_EVENT_PAGES))
    cat = _zipf(rng, user.size, len(_EVENT_CATEGORIES), 0.8)
    price = np.round(np.exp(3.0 + 0.5 * z[user]
                            + 0.5 * rng.randn(user.size)), 2)
    order = np.lexsort((user, t))
    os.makedirs(out_dir, exist_ok=True)
    events_path = os.path.join(out_dir, "events.csv")
    with open(events_path, "w", newline="") as fh:
        w = csv.writer(fh, lineterminator="\n")
        w.writerow(EVENTS_COLUMNS)
        for i in order:
            k = int(kind[i])
            w.writerow([f"u{user[i]:06d}", _event_ts(int(t[i])),
                        EVENT_KINDS[k],
                        _EVENT_PAGES[page[i]] if k == 2 else "",
                        _EVENT_CATEGORIES[cat[i]] if k == 3 else "",
                        f"{price[i]:.2f}" if k == 3 else ""])
    age = rng.randint(18, 81, size=n_users)
    age_gap = rng.rand(n_users) < 0.15
    income = np.round(np.exp(10.8 + 0.3 * z + 0.5 * rng.randn(n_users)), 2)
    income_gap = rng.rand(n_users) < 0.2
    region = _zipf(rng, n_users, len(_EVENT_REGIONS))
    plan = np.clip((z + rng.randn(n_users) + 1.5).astype(int), 0, 3)
    channel = rng.randint(0, len(_EVENT_CHANNELS), size=n_users)
    users_path = os.path.join(out_dir, "users.csv")
    with open(users_path, "w", newline="") as fh:
        w = csv.writer(fh, lineterminator="\n")
        w.writerow(USERS_COLUMNS)
        for i in range(n_users):
            w.writerow([f"u{i:06d}", "" if age_gap[i] else str(age[i]),
                        "" if income_gap[i] else f"{income[i]:.2f}",
                        str(tenure[i]), _EVENT_REGIONS[region[i]],
                        _EVENT_PLANS[plan[i]],
                        _EVENT_CHANNELS[channel[i]]])
    return events_path, users_path


def files_sha256(*paths: str) -> str:
    """sha256 of the files' bytes, one after another."""
    import hashlib
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


#: the events workflow's features that come from the events (the rest
#: come from the users file)
EVENT_FEATURES = ("numSends30d", "numClicks7d", "numVisits7d",
                  "numPurchases", "spendByCategory", "topCategory",
                  "visitedUrls", "meanPrice", "lastEvent", "purchasedNext7d")
USER_FEATURES = ("age", "income", "tenureDays", "region", "plan",
                 "signupChannel")
#: the events workflow's models: the serve bench's GBT and RF
EVENTS_MODELS = [(SERVE_MODELS[k][0], [dict(SERVE_MODELS[k][1])])
                 for k in ("gbt", "rf")]


def events_dag(ns, models=None, seed: int = 42):
    """(result features, label feature, prediction): the events
    workflow's DAG from the names in ``ns`` (either package's
    ``FeatureBuilder``, ``aggregators`` module, ``transmogrify`` and
    binary selector factory), in one order, so after each package's
    ``reset_uids`` every stage has the same uid. Event features aggregate
    (windows trailing the cutoff); the label ``purchasedNext7d`` is the
    largest purchase indicator in the 7 days after it. Age is
    mean-filled and z-scored and bucketized at fixed splits, income
    mean-filled and log-scaled, tenure and the spend map bucketized on
    the label, the week's visits percentile-calibrated; then
    ``transmogrify`` of the rest, ``combine`` with the buckets, the
    SanityChecker and the selector with 3-fold cross-validation over
    ``models`` (default ``EVENTS_MODELS``)."""
    FB, agg, day = ns.FeatureBuilder, ns.aggregators, _DAY_MS

    def kind_is(kind):
        return lambda r: 1.0 if r.get("kind") == kind else 0.0

    def purchase(fn):
        return lambda r: fn(r) if r.get("kind") == "purchase" else None

    sends = (FB.Real("numSends30d").extract(kind_is("send"))
             .aggregate(agg.Sum()).window(30 * day).as_predictor())
    clicks = (FB.Real("numClicks7d").extract(kind_is("click"))
              .aggregate(agg.Sum()).window(7 * day).as_predictor())
    visits = (FB.Real("numVisits7d").extract(kind_is("visit"))
              .aggregate(agg.Sum()).window(7 * day).as_predictor())
    purchases = (FB.Real("numPurchases").extract(kind_is("purchase"))
                 .aggregate(agg.Sum()).as_predictor())
    spend = (FB.RealMap("spendByCategory")
             .extract(purchase(lambda r: {r["category"]: float(r["price"])}))
             .aggregate(agg.UnionMap(agg.Sum())).window(90 * day)
             .as_predictor())
    top = (FB.PickList("topCategory")
           .extract(purchase(lambda r: r["category"]))
           .aggregate(agg.ModeAgg()).as_predictor())
    urls = (FB.MultiPickList("visitedUrls")
            .extract(lambda r: [r["url"]] if r.get("kind") == "visit"
                     else None).window(30 * day).as_predictor())
    mean_price = (FB.Real("meanPrice")
                  .extract(purchase(lambda r: float(r["price"])))
                  .aggregate(agg.MeanAgg()).as_predictor())
    last = (FB.Date("lastEvent").extract(lambda r: event_ms(r["ts"]))
            .aggregate(agg.MaxAgg()).as_predictor())
    label = (FB.RealNN("purchasedNext7d").extract(kind_is("purchase"))
             .aggregate(agg.MaxAgg()).window(7 * day).as_response())
    age = FB.Real("age").extract_field().as_predictor()
    income = FB.Real("income").extract_field().as_predictor()
    tenure = FB.Real("tenureDays").extract_field().as_predictor()
    picks = [FB.PickList(c).extract_field().as_predictor()
             for c in ("region", "plan", "signupChannel")]
    age_z = age.fill_missing_with_mean().zscore()
    age_b = age.bucketize([18, 25, 35, 50, 65])
    income_log = income.fill_missing_with_mean().scale("log")
    tenure_b = tenure.auto_bucketize(label)
    spend_b = spend.auto_bucketize_map(label)
    visits_cal = visits.percentile_calibrate()
    vec = ns.transmogrify([sends, clicks, visits, purchases, spend, top,
                           urls, mean_price, last, *picks, age_z,
                           income_log, visits_cal])
    checked = vec.combine(age_b, tenure_b, spend_b).sanity_check(label)
    pred = (ns.BinaryClassificationModelSelector.with_cross_validation(
        seed=seed, models=EVENTS_MODELS if models is None else models)
        .set_input(label, checked).get_output())
    return (pred, checked), label, pred


def events_reader(ns, events_path: str, users_path: str):
    """The events workflow's reader from the names in ``ns`` (either
    package's ``readers.aggregates``, ``CSVReader`` and ``aggregators``):
    the events aggregated by ``userId`` at ``EVENTS_CUTOFF_MS`` (left)
    joined to the users file (right), keeping every aggregated user."""
    cutoff = ns.aggregators.CutOffTime.unix_epoch(EVENTS_CUTOFF_MS)
    left = ns.aggregates.AggregateDataReader(
        ns.CSVReader(events_path), ns.aggregates.AggregateParams(
            cutoff=cutoff, timestamp_fn=lambda r: event_ms(r["ts"])),
        key_field="userId")
    right = ns.CSVReader(users_path, key_field="userId")
    sides = {**{n: "left" for n in EVENT_FEATURES},
             **{n: "right" for n in USER_FEATURES}}
    return ns.aggregates.JoinedDataReader(left, right, join_type="left",
                                          feature_sides=sides)


def port_events_namespace():
    """``events_dag``'s and ``events_reader``'s names from the port."""
    from types import SimpleNamespace
    from . import aggregators
    from .dsl import transmogrify
    from .features import FeatureBuilder
    from .impl.selector import factories
    from .readers import aggregates
    from .readers.readers import CSVReader
    return SimpleNamespace(
        FeatureBuilder=FeatureBuilder, aggregators=aggregators,
        aggregates=aggregates, CSVReader=CSVReader,
        transmogrify=transmogrify,
        BinaryClassificationModelSelector=(
            factories.BinaryClassificationModelSelector))


def events_workflow(events_path: str, users_path: str, models=None,
                    seed: int = 42, device=None, reset: bool = True):
    """(workflow, label feature, prediction, result features): the port's
    events workflow (``events_dag``) reading ``events_reader`` on
    ``device``; with ``reset`` the uids restart, as the fixture's
    workflow was built."""
    from .features import reset_uids
    from .workflow import OpWorkflow
    if reset:
        reset_uids()
    ns = port_events_namespace()
    results, y, pred = events_dag(ns, models, seed)
    wf = (OpWorkflow(device=device)
          .set_reader(events_reader(ns, events_path, users_path))
          .set_result_features(*results))
    return wf, y, pred, results


def column_digest(col) -> str:
    """sha256 of a host or device column of either package: a numeric
    column's values (missing slots 0) and validity, any other column's
    cells as canonical JSON (None missing, sets sorted)."""
    import hashlib
    import json

    def host(a):
        a = a.detach().cpu().numpy() if hasattr(a, "detach") else a
        return np.asarray(a)
    vals = host(col.values)
    valid = (np.ones(len(vals), bool) if col.mask is None
             else host(col.mask).astype(bool))
    h = hashlib.sha256()
    if vals.dtype != object:
        vals = np.where(valid.reshape((-1,) + (1,) * (vals.ndim - 1)),
                        vals, 0).astype(vals.dtype)
        h.update(str(vals.dtype).encode())
        h.update(np.ascontiguousarray(vals).tobytes())
        h.update(valid.tobytes())
        return h.hexdigest()

    def canon(v):
        if isinstance(v, (set, frozenset)):
            return sorted(canon(x) for x in v)
        if isinstance(v, (list, tuple)):
            return [canon(x) for x in v]
        if isinstance(v, dict):
            return {str(k): canon(x) for k, x in v.items()}
        if isinstance(v, np.generic):
            return v.item()
        return v
    h.update(json.dumps([canon(v) if ok else None
                         for v, ok in zip(vals.tolist(), valid)],
                        sort_keys=True).encode())
    return h.hexdigest()


def table_digest(table, names: Sequence[str]) -> Dict[str, str]:
    """{column: ``column_digest``} of ``names``, and the key's sha256
    under ``"__key__"`` (None without a key)."""
    import hashlib
    import json
    out = {n: column_digest(table[n]) for n in names}
    out["__key__"] = None if table.key is None else hashlib.sha256(
        json.dumps([str(k) for k in table.key]).encode()).hexdigest()
    return out


#: the fitted host stages a fixture keeps, with the attributes it keeps
FITTED_ATTRS = {
    "FillMissingWithMeanModel": ("mean",),
    "OpScalarStandardScalerModel": ("mean", "std"),
    "DecisionTreeNumericBucketizerModel": ("splits",),
    "DecisionTreeNumericMapBucketizerModel": ("keys", "splits"),
    "PercentileCalibratorModel": ("boundaries", "buckets"),
}


def fitted_values(model) -> Dict[str, Dict[str, Any]]:
    """{stage uid: {attribute: value}} of a fitted model's (either
    package's) mean fills, z-scores, supervised bucketizers and
    percentile calibrators (``FITTED_ATTRS``); python floats, exact in
    JSON."""
    out: Dict[str, Dict[str, Any]] = {}
    for s in model.stages:
        attrs = FITTED_ATTRS.get(type(s).__name__)
        if attrs:
            out[s.uid] = {a: getattr(s, a) for a in attrs}
    return out


def events_loco_sample(n: int, rows: int = 256, seed: int = 0) -> np.ndarray:
    """The sorted scoring rows whose LOCO diffs and written records a
    fixture keeps."""
    return np.sort(np.random.RandomState(seed).choice(n, rows,
                                                      replace=False))


def loco_map_gaps(want_diffs, got_diffs, names, want_map, got_map,
                  top_k: int, atol: float) -> List[str]:
    """Where two LOCO maps of one row disagree beyond ``atol`` (empty when
    they agree). ``*_diffs`` are the row's (g,) score differences,
    ``*_map`` its top-k {group: rounded diff}. An entry whose |diff|
    clears ``atol`` and the k-th largest |diff| by ``2 * atol`` must be in
    both maps within ``atol`` (plus the maps' rounding to 6 decimals); an
    entry at or below ``atol`` may be in either map or neither (the
    summation order decides whether it is exactly 0)."""
    out: List[str] = []
    for diffs, mine, other, side in ((want_diffs, want_map, got_map, "got"),
                                     (got_diffs, got_map, want_map, "want")):
        a = np.abs(np.asarray(diffs, dtype=np.float64))
        kth = np.sort(a)[::-1][min(top_k, a.size) - 1] if a.size else 0.0
        for v, name in enumerate(names):
            if a[v] <= atol or a[v] <= kth + 2 * atol and a.size > top_k:
                continue
            if name not in mine:
                out.append(f"{name}: |diff| {a[v]:.3g} missing from its "
                           f"own map")
            elif name not in other:
                out.append(f"{name}: {mine[name]} missing in {side}")
            elif abs(mine[name] - other[name]) > atol + 1e-6:
                out.append(f"{name}: {mine[name]} vs {other[name]}")
    return out


# -- the stream workload (``bench.py`` BENCH_MODE=stream) ------------------

#: the synthetic stream: 1,000,000 rows of 64 Real predictors and a binary
#: RealNN label in 16 chunks of 65,536 rows (``SyntheticChunkSource``)
STREAM_ROWS = 1_000_000
STREAM_FEATURES = 64
STREAM_CHUNK_ROWS = 65_536
STREAM_SEED = 0
#: rows of chunk 0 whose probability_1 a stream fixture keeps
STREAM_SAMPLE = 4096
#: the streamed GBT of the workload
STREAM_GBT = dict(problem="binary", num_trees=2, max_depth=3, n_bins=32,
                  learning_rate=1.0)
#: the pressure stream: a 200,000 x 8 table from RandomState(0), read in
#: chunks of 25,000 (``bench.py``'s pressure mode)
PRESSURE_ROWS = 200_000
PRESSURE_FEATURES = 8
PRESSURE_CHUNK_ROWS = 25_000
PRESSURE_GBT = dict(problem="binary", num_trees=1, max_depth=3, n_bins=16,
                    learning_rate=1.0)


def port_stream_namespace():
    """``stream_dag``'s and ``pressure_table``'s names from the port."""
    from types import SimpleNamespace
    from . import streaming, types
    from .dsl import transmogrify
    from .features import FeatureBuilder, reset_uids
    from .impl.preparators.sanity_checker import SanityChecker
    from .table import Column, FeatureTable
    from .workflow import OpWorkflow
    return SimpleNamespace(
        FeatureBuilder=FeatureBuilder, transmogrify=transmogrify,
        SanityChecker=SanityChecker, streaming=streaming,
        OpWorkflow=OpWorkflow, Column=Column, FeatureTable=FeatureTable,
        Real=types.Real, RealNN=types.RealNN, reset_uids=reset_uids)


def stream_dag(ns, d: int, gbt: Optional[Dict[str, Any]] = None):
    """The streamed workflow's prediction from the names in ``ns`` (either
    package's): ``d`` Real predictors ``x0..`` and the RealNN label ``y``,
    ``transmogrify``, ``SanityChecker(seed=1)``, ``StreamingGBT(**gbt)``
    (default ``STREAM_GBT``); after each package's ``reset_uids`` every
    stage has the same uid."""
    FB = ns.FeatureBuilder
    label = FB.RealNN("y").extract_field().as_response()
    feats = [FB.Real(f"x{i}").extract_field().as_predictor()
             for i in range(d)]
    checked = label.transform_with(ns.SanityChecker(seed=1),
                                   ns.transmogrify(feats))
    return (ns.streaming.StreamingGBT(**(gbt or STREAM_GBT))
            .set_input(label, checked).get_output())


def pressure_table(ns, n: int = PRESSURE_ROWS, d: int = PRESSURE_FEATURES,
                   seed: int = 0):
    """The pressure stream's host table (either package's), drawn as
    ``bench.py`` draws it."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X @ rng.randn(d).astype(np.float32) > 0).astype(np.float32)
    cols = {f"x{i}": ns.Column(ns.Real, X[:, i], None) for i in range(d)}
    cols["y"] = ns.Column(ns.RealNN, y, None)
    return ns.FeatureTable(cols, n)


def stage_of(model, cls_name: str):
    """The fitted stage of class ``cls_name`` of a workflow model."""
    return [s for s in model.stages if type(s).__name__ == cls_name][0]


def streamed_gbt_arrays(gbt) -> Dict[str, np.ndarray]:
    """A fitted ``StreamingGBTModel``'s (either package's) trees and f0 as
    named arrays."""
    out = {"f0": np.float64(gbt.f0)}
    for t, tree in enumerate(gbt.trees):
        for lv, (f, thr) in enumerate(zip(tree["feat_lv"], tree["thr_lv"])):
            out[f"t{t}.feat{lv}"] = np.asarray(f)
            out[f"t{t}.thr{lv}"] = np.asarray(thr)
        out[f"t{t}.leaf"] = np.asarray(tree["leaf"])
    return out


def streamed_prob1(model, table, rows: np.ndarray) -> np.ndarray:
    """probability_1 of a streamed model (either package's) scoring
    ``table``, at ``rows``, as float32 on the host."""
    pred = model.result_features[0]
    col = model.score(table=table)[pred.name]
    vals = col.values
    vals = vals.cpu().numpy() if hasattr(vals, "cpu") else np.asarray(vals)
    return vals[:, list(col.metadata["keys"]).index("probability_1")][rows]


def stream_sample_rows(chunk_rows: int = STREAM_CHUNK_ROWS,
                       sample: int = STREAM_SAMPLE) -> np.ndarray:
    return np.sort(np.random.RandomState(STREAM_SEED).choice(
        chunk_rows, size=min(sample, chunk_rows), replace=False))


def stream_result(model, source, sample: int = STREAM_SAMPLE
                  ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """(JSON part, arrays) of a streamed train of ``stream_dag`` (either
    package's model): the mean fills, the SanityChecker's choices and
    summary, the trees and f0, and probability_1 on chunk 0 at
    ``stream_sample_rows``."""
    rv = stage_of(model, "RealVectorizerModel")
    sc = stage_of(model, "SanityCheckerModel")
    gbt = stage_of(model, "StreamingGBTModel")
    rows = stream_sample_rows(source.chunk_rows, sample)
    arrays = streamed_gbt_arrays(gbt)
    arrays["fills"] = np.asarray(rv.fills, dtype=np.float64)
    arrays["rows"] = rows
    arrays["prob1"] = streamed_prob1(model, source.read_chunk(0).table,
                                     rows)
    js = {"sanity": sanity_summary(sc),
          "sanitySummary": sc.summary.to_json(),
          "trees": len(gbt.trees)}
    return js, arrays


def write_stream_fixture(ns, out_dir: str, rows: int = STREAM_ROWS,
                         features: int = STREAM_FEATURES,
                         chunk_rows: int = STREAM_CHUNK_ROWS,
                         sample: int = STREAM_SAMPLE, **train_kw) -> None:
    """Train ``stream_dag`` on ``SyntheticChunkSource(rows, features,
    chunk_rows, seed=STREAM_SEED)`` with the package of ``ns`` and write
    ``stream_result`` to ``out_dir`` (``fixture.json``, ``fixture.npz``).
    ``train_kw`` go to that package's ``OpWorkflow``."""
    import json
    import os
    source = ns.streaming.SyntheticChunkSource(
        rows, features, chunk_rows=chunk_rows, seed=STREAM_SEED,
        problem="binary")
    ns.reset_uids()
    model = (ns.OpWorkflow(**train_kw)
             .set_result_features(stream_dag(ns, features))
             .train(stream=source))
    js, arrays = stream_result(model, source, sample)
    js["config"] = {"rows": rows, "features": features,
                    "chunkRows": chunk_rows, "seed": STREAM_SEED,
                    "sample": sample, "gbt": STREAM_GBT}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "fixture.json"), "w") as fh:
        json.dump(js, fh, indent=1, sort_keys=True)
    np.savez_compressed(os.path.join(out_dir, "fixture.npz"), **arrays)


def read_stream_fixture(path: str
                        ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    import json
    import os
    with open(os.path.join(path, "fixture.json")) as fh:
        js = json.load(fh)
    with np.load(os.path.join(path, "fixture.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return js, arrays


def array_differences(got: Dict[str, np.ndarray],
                      want: Dict[str, np.ndarray]) -> List[str]:
    """The names of the arrays that differ in their bits (or are in one
    dict only)."""
    out = []
    if sorted(got) != sorted(want):
        out.append(f"arrays {sorted(set(got) ^ set(want))} differ")
    for k in sorted(set(got) & set(want)):
        a, b = np.asarray(got[k]), np.asarray(want[k])
        if a.shape != b.shape or a.dtype != b.dtype or not np.array_equal(
                a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8)):
            out.append(f"{k} differs")
    return out


def stream_differences(got: Tuple[Dict[str, Any], Dict[str, np.ndarray]],
                       want: Tuple[Dict[str, Any], Dict[str, np.ndarray]]
                       ) -> List[str]:
    """What differs between two ``stream_result``s: the fills, trees, f0
    and sampled probability_1 are compared bit for bit (NaN thresholds of
    stopped nodes equal), the SanityChecker's choices with
    ``assert_same_sanity`` (a number in a reason within 1e-12)."""
    (gj, ga), (wj, wa) = got, want
    out = array_differences(ga, wa)
    try:
        assert_same_sanity(gj["sanity"], wj["sanity"], rel=0.0)
    except AssertionError as e:
        out.append(f"sanity: {e}")
    return out


# ---------------------------------------------------------------------------
# Serving (``serving``): request rows and the process-wide serving state
# ---------------------------------------------------------------------------

def request_rows(frame: Dict[str, np.ndarray], n: Optional[int] = None
                 ) -> List[Dict[str, Any]]:
    """Serving requests from a ``{name: column}`` frame: one dict a row,
    python floats, NaN sent as None (missing)."""
    n = len(next(iter(frame.values()))) if n is None else n
    return [{k: (None if np.isnan(v[i]) else float(v[i]))
             for k, v in frame.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# Frames as pandas gives them, kept without pandas (the Parquet fixtures)
# ---------------------------------------------------------------------------

def _enc_value(v):
    """A python or numpy value as tagged JSON (the type survives)."""
    import datetime
    if isinstance(v, np.ndarray):
        return {"nd": v.dtype.str if v.dtype != object else "O",
                "v": [_enc_value(x) for x in v.tolist()]}
    if isinstance(v, dict):
        return {"d": [[k, _enc_value(x)] for k, x in v.items()]}
    if isinstance(v, datetime.date):
        return {"date": v.isoformat()}
    if isinstance(v, bytes):
        return {"b": v.hex()}
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise TypeError(f"cannot keep a {type(v).__name__} value")


def _dec_value(v):
    import datetime
    if isinstance(v, dict):
        if "nd" in v:
            vals = [_dec_value(x) for x in v["v"]]
            if v["nd"] == "O":
                out = np.empty(len(vals), dtype=object)
                out[:] = vals
                return out
            return np.array(vals, dtype=np.dtype(v["nd"]))
        if "d" in v:
            return {k: _dec_value(x) for k, x in v["d"]}
        if "date" in v:
            return datetime.date.fromisoformat(v["date"])
        return bytes.fromhex(v["b"])
    return v


def save_columns(path: str, columns: Dict[str, np.ndarray]) -> None:
    """Keep a frame's columns (name -> numpy column, as ``pd.read_parquet``
    gives them) in an npz: numeric columns as arrays, object columns as
    tagged JSON; read back by ``load_columns`` without pandas."""
    import json
    arrays = {"__names__": np.array(json.dumps(list(columns)))}
    for i, (name, col) in enumerate(columns.items()):
        col = np.asarray(col)
        if col.dtype == object:
            arrays[f"c{i}"] = np.array(json.dumps(
                [_enc_value(v) for v in col.tolist()]))
        else:
            arrays[f"c{i}"] = col
    np.savez_compressed(path, **arrays)


def load_columns(path: str) -> Dict[str, np.ndarray]:
    """The columns ``save_columns`` kept."""
    import json
    with np.load(path) as z:
        names = json.loads(str(z["__names__"]))
        out = {}
        for i, name in enumerate(names):
            a = z[f"c{i}"]
            if a.dtype.kind == "U" and a.ndim == 0:
                vals = [_dec_value(v) for v in json.loads(str(a))]
                col = np.empty(len(vals), dtype=object)
                col[:] = vals
                out[name] = col
            else:
                out[name] = a
        return out


def columns_digest(columns: Dict[str, np.ndarray]) -> Dict[str, str]:
    """{column: sha256 of its dtype and every cell as tagged JSON} (the
    type of each cell, nested dicts and arrays by dtype, NaN and None
    apart): equal digests are equal columns in ``column_gaps``' sense."""
    import hashlib
    import json
    return {name: hashlib.sha256(json.dumps(
        [str(np.asarray(col).dtype),
         [_enc_value(v) for v in np.asarray(col).tolist()]]).encode()
    ).hexdigest() for name, col in columns.items()}


def _same_value(a, b) -> bool:
    if isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape
                and all(_same_value(x, y)
                        for x, y in zip(a.tolist(), b.tolist())))
    if isinstance(b, dict):
        return (isinstance(a, dict) and list(a) == list(b)
                and all(_same_value(a[k], b[k]) for k in b))
    if isinstance(b, float) and b != b:
        return isinstance(a, float) and a != a
    return type(a) is type(b) and a == b


def column_gaps(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
                limit: int = 5) -> List[str]:
    """Where two frames' columns differ: names and order, a column's
    dtype, or a cell (type, value, NaN where NaN; nested dicts and arrays
    alike); [] when equal."""
    if list(got) != list(want):
        return [f"columns {list(got)} != {list(want)}"]
    gaps = []
    for name, w in want.items():
        g = got[name]
        if g.dtype != w.dtype or g.shape != w.shape:
            gaps.append(f"{name}: {g.dtype}{g.shape} != {w.dtype}{w.shape}")
            continue
        for i, (x, y) in enumerate(zip(g.tolist(), w.tolist())):
            if not _same_value(x, y):
                gaps.append(f"{name}[{i}]: {x!r} != {y!r}")
                break
        if len(gaps) >= limit:
            break
    return gaps


@contextmanager
def held_flushes():
    """While the block runs, every serving runtime's batcher waits before
    it takes a batch, until the yielded ``threading.Event`` is set (or its
    runtime stops): requests stay queued, so queue depths and a kill with
    requests in flight do not depend on the host's speed. The event is set
    when the block exits. Enter it after the fleet has started (a warm-up
    waits on its own flushes)."""
    import threading
    from .serving.runtime import ServingRuntime

    gate = threading.Event()
    take = ServingRuntime._take_batch

    def held(self):
        while not gate.is_set() and self._running:
            gate.wait(0.005)
        return take(self)

    ServingRuntime._take_batch = held
    try:
        yield gate
    finally:
        gate.set()
        ServingRuntime._take_batch = take


@contextmanager
def served_sample(k: int = 32):
    """While the block runs, the first ``k`` requests that the open-loop
    load generator (``serving.loadgen.run_open_loop``) submits are kept:
    the yielded list fills with (row, future) pairs, whatever runtime or
    front door the generator drives (the command line's ``serve``,
    ``slo`` and ``fleet``). ``served_gaps`` holds them to the
    micro-batch scorer."""
    from .serving import loadgen

    kept: List[Tuple[Dict[str, Any], Any]] = []
    run = loadgen.run_open_loop

    def keeping(runtime, *args, **kwargs):
        submit = runtime.submit

        def keep(row, *a, **kw):
            fut = submit(row, *a, **kw)
            if len(kept) < k:
                kept.append((row, fut))
            return fut

        runtime.submit = keep
        try:
            return run(runtime, *args, **kwargs)
        finally:
            del runtime.submit

    loadgen.run_open_loop = keeping
    try:
        yield kept
    finally:
        loadgen.run_open_loop = run


def served_gaps(model, kept) -> List[str]:
    """Where the served records of ``served_sample``'s requests differ
    from ``micro_batch_score_function(model)`` on the same rows (a shed
    request is left out); [] when every one is equal, and at least one
    was served."""
    from .local.scoring import micro_batch_score_function
    done = [(row, fut.result(timeout=60)) for row, fut in kept
            if fut.exception(timeout=60) is None]
    if not done:
        return [f"none of {len(kept)} sampled requests was served"]
    want = micro_batch_score_function(model)([row for row, _ in done])
    return [f"request {i}: {got!r} != {w!r}"
            for i, ((_, got), w) in enumerate(zip(done, want)) if got != w]


def close_serving_state() -> List[str]:
    """Close what a serving test left behind and say what it was: network
    edges, fleet front doors and placers (closed first, so an edge's
    handlers resolve while its target still accepts), running runtimes
    (closed without draining), drift refit threads (joined), open
    watchdog hearts and attached sampler sources (closed and detached),
    armed fault sites (cleared); then the observability state is reset
    and the port's sampler and watchdog threads joined. The state is
    process-wide, so a test that leaks it would run underneath every later
    test. (The JAX package's threads carry the same names; its conftest
    checks them.)"""
    from .observability import reset as obs_reset
    from .observability import timeseries
    from .robustness import faults, oracles, watchdog
    from .serving import drift, live_runtimes
    leaks = [f"network edge {n}" for n in oracles.close_leaked_net_edges()]
    leaks += [f"fleet {n}" for n in oracles.close_leaked_fleets()]
    leaks += [f"placer {n}" for n in oracles.close_leaked_placers()]
    leaks += [f"runtime {rt.name}" for rt in live_runtimes()]
    for rt in live_runtimes():
        rt.close(drain=False)
    for t in drift.live_refits():
        t.join(timeout=30)
        if t.is_alive():
            leaks.append(f"refit {t.name}")
    for heart in watchdog.live_hearts():
        leaks.append(f"watchdog heart {heart.name}")
        heart.close()
    leaks += [f"sampler source {s.name}" for s in timeseries.attached()]
    faults.clear()
    obs_reset()
    timeseries.idle_join()
    watchdog.idle_join()
    return leaks
