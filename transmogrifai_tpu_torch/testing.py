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
from typing import Any, Callable, Dict, Optional, Tuple

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


def assert_same_sanity(got: dict, want: dict) -> None:
    """Two ``sanity_summary`` dicts: the same kept slots, dropped names and
    reasons, a number quoted in a reason within 1e-12 absolute or 1e-4
    relative (float32 moments summed in another order: a constant
    column's variance is 0 in one and 2.7e-15 where XLA fuses its mean
    into the subtraction). Raises AssertionError."""
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
                                                  1e-4 * abs(float(b))):
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
