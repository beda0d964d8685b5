"""Streaming gradient-boosted trees on merged SPDT histograms (counterpart
of ``transmogrifai_tpu.streaming.model``).

The Ben-Haim & Tom-Tov streaming decision tree (JMLR 2010) extended to
squared-loss gradient boosting: split candidates come from merged
streaming-histogram quantile edges (one sketch pass), and each tree level
grows from per (node, feature, bin) residual statistics accumulated as an
exact float64 monoid fold over the chunks: one pass per level and one leaf
pass per boosting round (the ensemble re-predicts each chunk on the fly;
nothing is materialized). Every pass checkpoints per chunk
(``checkpoint``), so a kill anywhere resumes to a bit-identical model.

The growth runs on the host with the host histogram backend
(``histeng.host``: float64 ``np.bincount`` in the JAX package's order), as
in the JAX package: a float32 device histogram would change split
choices. So the trees, ``f0`` and the scores are the JAX package's bit for
bit on the same chunks. The fitted model's descent is host numpy too
(``_host_state``: its arrays stay numpy when it loads); its Prediction
column goes to the table's device.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import torch

from ..histeng import bin_codes_host, build_node_hist, node_stat_sums
from ..stages.base import AllowLabelAsInput, Estimator, Transformer
from ..table import Column, FeatureTable
from ..types import OPVector, Prediction, RealNN
from .folds import ArraySumFold, ColStatsFold, CompositeFold, HistogramFold

#: total rows (per feature) sampled into the edge-finding sketch pass
HIST_SAMPLE_ROWS = 65_536


def _descend(X: np.ndarray, feat_lv: List[np.ndarray],
             thr_lv: List[np.ndarray], upto: Optional[int] = None
             ) -> np.ndarray:
    """Vectorized node assignment after ``upto`` split levels (a stopped
    node, feat < 0, routes left)."""
    n, d = X.shape
    node = np.zeros(n, dtype=np.int64)
    levels = len(feat_lv) if upto is None else upto
    rows = np.arange(n)
    for lv in range(levels):
        f = feat_lv[lv][node]
        t = thr_lv[lv][node]
        xf = X[rows, np.clip(f, 0, d - 1)]
        right = (f >= 0) & (xf > t)
        node = node * 2 + right
    return node


def _tree_values(X: np.ndarray, tree: Dict[str, Any]) -> np.ndarray:
    leaf_idx = _descend(X, tree["feat_lv"], tree["thr_lv"])
    return tree["leaf"][leaf_idx]


def _ensemble_raw(X: np.ndarray, f0: float, lr: float,
                  trees: List[Dict[str, Any]]) -> np.ndarray:
    F = np.full(X.shape[0], f0, dtype=np.float64)
    for tree in trees:
        F += lr * _tree_values(X, tree)
    return F


class StreamingGBT(AllowLabelAsInput, Estimator):
    """Estimator[(RealNN label, OPVector features)] -> Prediction, fit as
    streaming folds: the model stage a ``OpWorkflow.train(stream=...)``
    pipeline ends in. ``problem='regression'`` boosts squared loss on y;
    ``'binary'`` boosts squared loss on y in {0, 1} (LS-Boost) and emits
    clipped probabilities. ``fit`` on an in-memory table runs the same
    fold over one chunk."""

    input_types = (RealNN, OPVector)
    output_type = Prediction

    def __init__(self, problem: str = "binary", num_trees: int = 3,
                 max_depth: int = 4, n_bins: int = 32,
                 learning_rate: float = 0.3,
                 min_instances_per_node: int = 16,
                 min_info_gain: float = 1e-9,
                 uid: Optional[str] = None):
        super().__init__("streamingGBT", uid)
        if problem not in ("binary", "regression"):
            raise ValueError(
                f"StreamingGBT supports binary|regression, got {problem!r}")
        self.problem = problem
        self.num_trees = int(num_trees)
        self.max_depth = int(max_depth)
        self.n_bins = int(n_bins)
        self.learning_rate = float(learning_rate)
        self.min_instances_per_node = int(min_instances_per_node)
        self.min_info_gain = float(min_info_gain)

    # -- in-core fit = a one-chunk streamed fold ----------------------------
    def fit(self, table: FeatureTable) -> Transformer:
        from .source import TableChunkSource
        from .trainer import StreamRun
        run = StreamRun(TableChunkSource(table, max(1, table.num_rows)),
                        upstream=[], stage_uid=self.uid,
                        device=table.device or torch.device("cpu"))
        return self.fit_streaming(run)

    # -- streaming fit -------------------------------------------------------
    def _xy(self, table: FeatureTable) -> Tuple[np.ndarray, np.ndarray]:
        label_f, vec_f = self.input_features
        X = np.asarray(table[vec_f.name].host_values(), dtype=np.float32)
        y = np.asarray(table[label_f.name].host_values(),
                       dtype=np.float32).reshape(-1)
        return X, y

    def fit_streaming(self, run) -> Transformer:
        # the pass ids ("edges", "t{t}.l{lv}", "t{t}.leaf") are a
        # persistence contract: the stream checkpoint keys embed them. The
        # cache keys by (source x upstream identity x chunk rows), not by
        # pass id: all 1 + trees x (depth + 1) passes share one upstream
        # stack, so passes after the first replay cached chunks.
        probe = self.get_probe_width(run)
        d = probe
        nb = max(2, self.n_bins)
        depth = max(1, self.max_depth)

        # pass 0: quantile edges from merged SPDT sketches and the label
        # moments for the base score (one combined pass)
        total_rows = run.num_chunks * run.chunk_rows
        stride = max(1, total_rows // HIST_SAMPLE_ROWS)
        sketch = CompositeFold({
            "hist": HistogramFold(d, max_bins=4 * nb, sample_stride=stride),
            "y": ColStatsFold(1),
        })

        def extract_sketch(table: FeatureTable):
            X, y = self._xy(table)
            return ({"hist": (X,), "y": (y[:, None],)},)

        st = run.fold("edges", sketch, extract_sketch)
        hists = sketch.folds["hist"].finalize(st["hist"])
        ystats = sketch.folds["y"].finalize(st["y"])
        f0 = float(ystats.mean[0])
        edges = np.full((d, nb - 1), np.inf, dtype=np.float64)
        for j, h in enumerate(hists):
            b = h.uniform(nb)
            edges[j, :b.shape[0]] = b

        # boosting rounds: depth level passes + one leaf pass each
        trees: List[Dict[str, Any]] = []
        lr = self.learning_rate
        for t in range(self.num_trees):
            feat_lv: List[np.ndarray] = []
            thr_lv: List[np.ndarray] = []
            for lv in range(depth):
                n_nodes = 2 ** lv
                fold = ArraySumFold({"cnt": (n_nodes, d, nb),
                                     "sum": (n_nodes, d, nb),
                                     "sumsq": (n_nodes, d, nb)})

                def extract_level(table: FeatureTable, feat_lv=feat_lv,
                                  thr_lv=thr_lv, n_nodes=n_nodes):
                    X, y = self._xy(table)
                    r = (y.astype(np.float64)
                         - _ensemble_raw(X, f0, lr, trees))
                    node = _descend(X, feat_lv, thr_lv)
                    # the host histogram backend: float64 bincounts in the
                    # JAX package's order
                    codes = bin_codes_host(X, edges)
                    cnt, s, sq = build_node_hist(
                        codes, node, [None, r, r * r], nb, n_nodes=n_nodes)
                    return ({"cnt": cnt, "sum": s, "sumsq": sq},)

                st = run.fold(f"t{t}.l{lv}", fold, extract_level)
                feat, thr = self._best_splits(st, edges)
                feat_lv.append(feat)
                thr_lv.append(thr)

            leaf_nodes = 2 ** depth
            leaf_fold = ArraySumFold({"cnt": (leaf_nodes,),
                                      "sum": (leaf_nodes,)})

            def extract_leaf(table: FeatureTable, feat_lv=feat_lv,
                             thr_lv=thr_lv, leaf_nodes=leaf_nodes):
                X, y = self._xy(table)
                r = (y.astype(np.float64)
                     - _ensemble_raw(X, f0, lr, trees))
                node = _descend(X, feat_lv, thr_lv)
                cnt, s = node_stat_sums(node, [None, r], leaf_nodes)
                return ({"cnt": cnt, "sum": s},)

            st = run.fold(f"t{t}.leaf", leaf_fold, extract_leaf)
            leaf = np.where(st["cnt"] > 0, st["sum"]
                            / np.maximum(st["cnt"], 1.0), 0.0)
            trees.append({"feat_lv": feat_lv, "thr_lv": thr_lv,
                          "leaf": leaf})

        model = StreamingGBTModel(
            problem=self.problem, f0=f0, learning_rate=lr, trees=trees,
            num_features=d)
        model.summary_metadata = {
            "problem": self.problem, "numTrees": len(trees),
            "maxDepth": depth, "nBins": nb, "f0": f0,
            "learningRate": lr,
            "streaming": run.stats.to_json(),
        }
        return self._finalize_model(model)

    def get_probe_width(self, run) -> int:
        _, vec_f = self.input_features
        probe = run.probe_table()
        return probe[vec_f.name].width

    def _best_splits(self, stats: Dict[str, np.ndarray], edges: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Variance-gain split per node from (node, feature, bin) stats: the
        SPDT split finder, vectorized over every candidate at once."""
        cnt, s, q = stats["cnt"], stats["sum"], stats["sumsq"]
        n_nodes, d, nb = cnt.shape
        CL = np.cumsum(cnt, axis=2)[:, :, :-1]
        SL = np.cumsum(s, axis=2)[:, :, :-1]
        QL = np.cumsum(q, axis=2)[:, :, :-1]
        # per-node totals do not depend on the feature (vector rows carry
        # no mask); feature 0's bins are the canonical accumulator
        CT = cnt[:, 0, :].sum(axis=1)[:, None, None]
        ST = s[:, 0, :].sum(axis=1)[:, None, None]
        QT = q[:, 0, :].sum(axis=1)[:, None, None]
        CR, SR, QR = CT - CL, ST - SL, QT - QL

        def sse(c, sv, qv):
            return np.where(c > 0, qv - sv * sv / np.maximum(c, 1.0), 0.0)

        gain = sse(CT, ST, QT) - sse(CL, SL, QL) - sse(CR, SR, QR)
        feasible = ((CL >= self.min_instances_per_node)
                    & (CR >= self.min_instances_per_node)
                    & np.isfinite(edges[None, :, :]))
        gain = np.where(feasible, gain, -np.inf)
        flat = gain.reshape(n_nodes, d * (nb - 1))
        best = flat.argmax(axis=1)          # ties: lowest feature, bin
        best_gain = flat[np.arange(n_nodes), best]
        bf = (best // (nb - 1)).astype(np.int64)
        bb = best % (nb - 1)
        ok = best_gain > self.min_info_gain
        feat = np.where(ok, bf, -1)
        thr = np.where(ok, edges[bf, bb], np.nan)
        return feat, thr


class StreamingGBTModel(Transformer):
    """Fitted streaming ensemble: the Prediction column by a vectorized
    host descent (the model is small), moved to the table's device."""

    output_type = Prediction

    #: the trees stay numpy when the model loads (``persistence``)
    _host_state = True

    def __init__(self, problem: str, f0: float, learning_rate: float,
                 trees: List[Dict[str, Any]], num_features: int, uid=None):
        super().__init__("streamingGBT", uid)
        self.problem = problem
        self.f0 = f0
        self.learning_rate = learning_rate
        self.trees = trees
        self.num_features = num_features

    def _parts(self, X: np.ndarray) -> Dict[str, np.ndarray]:
        F = _ensemble_raw(X, self.f0, self.learning_rate, self.trees)
        if self.problem == "binary":
            p = np.clip(F, 1e-6, 1.0 - 1e-6)
            return {"prediction": (F > 0.5).astype(np.float64),
                    "probability": np.stack([1.0 - p, p], axis=1)}
        return {"prediction": F}

    def transform_column(self, table: FeatureTable) -> Column:
        from ..impl.selector.model_selector import prediction_column
        _, vec_f = self.input_features
        X = np.asarray(table[vec_f.name].host_values(), dtype=np.float32)
        return prediction_column({
            k: table.on_device(v.astype(np.float32))
            for k, v in self._parts(X).items()})

    def transform_row(self, row: Dict[str, Any]) -> Any:
        _, vec_f = self.input_features
        v = np.asarray(row.get(vec_f.name) or [], dtype=np.float32)[None, :]
        parts = self._parts(v)
        out = {"prediction": float(parts["prediction"][0])}
        if "probability" in parts:
            for i, x in enumerate(parts["probability"][0]):
                out[f"probability_{i}"] = float(x)
        return out
