"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero:

(a) build every CUDA source of the port (one nvcc each, all at once);
(titanic) the mixed-type path (``Titanic``): rebuild the 20,000-row
    training file and the 4,096-row scoring file of
    ``testing.titanic_csv`` from their seeds (sha256 equal to the
    fixture's), train ``examples.titanic.build_workflow`` (the CSV reader,
    PickList, Text, Integral, Real and RealNN features and the two derived
    ``BinaryTransformer`` ones, ``transmogrify`` to 583 columns,
    SanityChecker, the binary default list at full default grids, 3-fold
    CV) once with ``hist_matmul``, ``node_hist`` and
    ``forest_predict_chain`` wrapped (every launch held to plain as in (b)
    below; ``node_hist`` to its direct formula at each shape's first
    launch) and time each kernel's heaviest launch there; then the counted
    train against ``fixtures/titanic`` (what the JAX package made of the
    same file): vector metadata equal, 256 sampled rows bit-equal, the
    SanityChecker's kept columns, drops and reasons (numbers in a reason
    within 1e-12 or 1e-4 relative), the winner and every family's fold
    metrics (trees 1e-5, the linear families' bf16 sweeps
    ``LIN_FOLD_ATOL``), the linear refit's params and probability_1 on the
    scoring file (``TITANIC_LIN_*``); it must launch ``node_hist``, ``hist_matmul`` and
    ``forest_predict_chain``. Then the JAX-saved Titanic model on the card
    (its lambdas from the port's workflow, ``load_model(workflow=)``):
    the scoring file's probability_1 within 1e-5, keys equal, 64 requests
    through ``score_function`` of it and of the card-trained model against
    their ``score``, rows/sec on the file tiled to 65,536 rows;
(titanic_wcv) the same workflow on the same files with the raw feature
    filter reading the scoring file (default thresholds) and
    workflow-level CV (``testing.titanic_wcv_workflow``: the
    SanityChecker refit inside each of the 3 folds on its training rows,
    each fold's matrix padded to the widest). Before the counted paths it
    trains once with the three sweep kernels wrapped, as the Titanic phase
    does (every launch of the per-fold sweeps held to plain, ``node_hist``
    to its direct formula at each shape's first launch), and times each
    one's heaviest launch against plain and the library
    (``titanic_wcv_kernel`` JSON lines). After "serve titanic" the
    counted train, against ``fixtures/titanic_wcv`` (what the JAX package
    made of the same two files). Limits: the filter's exclusions, every
    feature's counts, fill rates and reasons, the blacklist, each fold's
    and the refit's SanityChecker choices (the kept columns, drops and
    reasons; numbers in a reason within 1e-12 or 1e-4 relative) and the
    winner and its config exact; JS divergences within ``WCV_JS_RTOL``
    (1e-9 relative: float64 on the host from the same bins); null-label
    correlations float32 on the card, as the JAX package's on its device,
    within ``WCV_CORR_ATOL`` (1e-6 absolute, ~5x the largest reading);
    fold metrics as the Titanic phase's for the trees (1e-5), the linear
    sweeps ``testing.WCV_LIN_FOLD_ATOL`` (2e-4, about twice the JAX
    package's own order noise at these folds' shapes); the LR refit's
    params and probability_1 on the scoring file ``TITANIC_LIN_*``
    (2e-4); the Brier score there within (2 + d) d for d =
    ``TITANIC_LIN_PROB_ATOL`` (each squared error moves by at most that);
    ``model_insights().to_json()``: equal keys and strings, each number
    within its source's limit (``testing.insight_limits``: the filter's
    as above, the SanityChecker's label correlations ``WCV_CORR_ATOL``
    and its other statistics 1e-4 relative, the winner's contributions
    ``TITANIC_LIN_COEF_RTOL`` of the largest, mean fold metrics
    ``WCV_LIN_FOLD_ATOL``, the refit's evaluations ``WCV_EVAL_ATOL`` and
    confusion counts ``WCV_COUNT_ATOL``); a save of the train reloads
    bit-equal with the fixture's plan layout, its blacklist and the
    filter's results. It prints the train's seconds with the filter's,
    the fold preparation's and the sweeps' apart, the exclusions, each
    fold's drop counts, the largest correlation gaps and the path's
    launches; it must launch ``hist_matmul``, ``node_hist`` and
    ``forest_predict_chain``;
(leads) the lead-conversion paths (``testing.leads_records``: 20,000
    training and 4,096 scoring records with dates, a date list, a
    geolocation and nine maps, rebuilt from their seeds, sha256 equal to
    the fixtures'; the DAGs built with the date clock at
    ``testing.LEADS_CLOCK_MS``): "train leads" (``transmogrify`` to 626
    columns, SanityChecker, the binary default list at full default grids)
    and "train leads_stage" (the indexed ``Stage`` label, the multiclass
    selector pinned to the RF of ``rfmc``, ``PredictionDeIndexer``), each
    against ``fixtures/leads`` or ``fixtures/leads_stage``: vector
    metadata equal, 256 sampled rows bit-equal, the SanityChecker's
    choices and the date pivot's reference instant the fixture's, the
    winner and its grid point equal, tree fold metrics within 1e-5, the
    SVC's within ``LEADS_SVC_FOLD_ATOL`` of the fixture's and both linear
    families' within ``LEADS_LIN_F64_ATOL`` of the same sweep evaluated
    on the card in float64 (the causes at the constants; every linear
    configuration's gap to the fixture printed); the LR refit's params
    and probability_1 ``TITANIC_LIN_*``; the RF's class probabilities
    within ``LEADS_STAGE_PROB_ATOL``, every decided prediction and
    deindexed stage equal, every scored stage the JAX package's label of
    its prediction, and the fitted deindexer on every class index and an
    unseen one the JAX package's labels; path (a)'s model insights (maps
    by key); a save and reload. Before the counted paths each leads train
    runs once with every launch of the four kernels it runs held to plain;
    their heaviest launches give the ``leads_kernel`` and
    ``leads_stage_kernel`` lines. "train leads" must launch
    ``hist_matmul``, ``node_hist`` and ``forest_predict_chain``, "train
    leads_stage" those and ``forest_leaf_sums_chain``;
(b) hold each kernel against its plain PyTorch version on the card, at the
    shapes its path gives it, and report its times:
    - ``node_hist`` at six growth levels (19,712 rows x 64 codes, 32
      bins): the RF refit's deepest level (T=50, 256 slots, k=2; the timed
      case of the ``kernels`` line), the GBT depth-6 refit's level 5 (T=1,
      16 left children, stride 2, k=3), the ``gbt12`` refit's deepest
      level (T=1, 256 slots, k=3), a GBT level 0 (T=1, every row in one
      slot, k=3), the ``rfmc`` refit's deepest level (six class counts,
      k=6: two of the kernel's stat groups) and the ``xgbmc`` refit's
      level 5 (T=6, one tree per class, stride 2, k=3): within rtol 1e-5 /
      atol 1e-6 of the plain version on [0, 1) stats, bit-equal on
      integer-valued stats and across reruns, and bit-equal to the direct
      formula (rows added in the kernel's order) there and at an odd
      shape; the library route is one f32 matmul over the materialized
      masked-stat operand;
    - the forest descents at the serve shapes (65,536 rows, 32 bins; at
      k=1 RF slot chains T=50 depth 12 W=256, ``gbt12`` slot chains T=20
      depth 12 W=256, GBT heaps T=20 depth 6, and the DT's one heap of
      depth 6, which takes the heap predict's int32 path; at k=6 the
      ``rfmc`` chains as RF's, launched four columns and then two, and the
      ``xgbmc`` heaps, T=600 = 100 rounds x 6 classes, depth 6): leaf ids
      exactly, sums bit-equal to the plain version (both add the trees in
      order) and across reruns;
    - the leaf sums at the refit shapes (19,712 rows x 64 codes, k=3: the
      RF refit's chain T=50 depth 12 W=256, the DT refit's heap T=1 depth
      6, and a heap T=50 depth 6; the chain also at k=4 and k=7, the
      ``rfreg`` and ``rfmc`` refits' stats and weight): within rtol 1e-5 /
      atol 1e-6 of the plain version on [0, 1) stats, bit-equal on
      integer-valued stats and across reruns, bit-equal to their own
      order spelled out on the CPU (``testing.leaf_sums_chunked``) at the
      RF (k 3, 4 and 7) and DT refit shapes and with every row in leaf 0
      (timed too), and at an odd shape within the same tolerance of the
      direct float64 formula;
    - ``hist_matmul`` at its four main-path shapes, in the layout of
      ``_diag_leaf_hist`` (19,712 rows, 64 trees as features, padded trees
      all sentinel, exact): the GBT refit's leaf sums (one real tree, 64
      leaves, 128 stat columns; the timed case of the ``kernels`` line),
      the ``gbt12`` refit's (one real tree, 256 leaves), the RF sweep's
      (48 real trees, 64 leaves, 192 stat columns) and the ``xgbmc``
      refit's (6 real trees, one per class); then at the GBT shape
      with every code valid and at a bf16 growth shape (64 features, 32
      bins, 384 columns): within rtol 1e-5 / atol 1e-6 of the plain
      version on [0, 1) stats, bit-equal on integer-valued stats and
      across reruns, and at an odd shape within the same tolerance of the
      direct float64 formula. Both histogram kernels print their time
      split by pass (``torch.profiler``) beside the library call's time
      and the bound;
    - both histogram kernels on stats with one NaN, one +Inf, one -Inf, a
      +Inf/-Inf pair or a finite value that rounds to +Inf in bf16, on
      the 16-row input of the roadmap's fault and at main-path shapes: the
      plain version's NaN cells and every other cell's bits;
    - the four forest kernels on values that are not finite: the leaf sums
      at the RF and DT refit shapes (a NaN, +Inf or -Inf stat, a
      +Inf/-Inf pair), the predicts at the RF, GBT and DT serve shapes (a
      NaN leaf that a row reaches or that none reaches, a +Inf leaf, a
      +Inf/-Inf pair): the plain versions' NaN cells and rows and every
      other one's bits;
    - ``hist_matmul``, ``node_hist`` and ``forest_predict_chain`` at the
      default lists' own sweep inputs (18 configurations x 3 folds a tree
      family; the depth-3 and 6 heaps turned into padded depth-12 chains):
      each default list is trained once with the three wrappers wrapped,
      and every launch is held against the plain version on its inputs:
      histograms within 2 * 8 sqrt(rows) 2^-24 of each cell's sum of
      |stat| plus atol 1e-6 (the probabilistic bound on two f32 sums in
      other orders), ``hist_matmul`` bit-equal on small integer stats of
      the same codes, ``node_hist`` bit-equal to its direct formula, chain
      predicts bit-equal with leaf ids exact;
(t) train: rebuild the serve bench's 20,000 x 64 frames and train eight
    pinned tree workflows on the card (``OpWorkflow().train()``,
    ``testing.SERVE_MODELS``): binary GBT (depth 6, 20 rounds, heaps),
    ``gbt12`` (GBT depth 12, 20 rounds, slot chains), RF (depth 12, 50
    trees, slot chains) and DT (depth 6); regression ``rfreg`` (RF as
    RF's) and ``gbtreg`` (GBT as GBT's) through the regression selector;
    6-class ``rfmc`` (RF as RF's) and ``xgbmc`` (XGBoost depth 6, 100
    rounds) through the multiclass selector. Each is held against the
    committed fixture that the JAX package trained on the same frame
    (``serve64/<key>``): bin edges bit-equal, the same kept columns,
    identical trees counted (a boosted model's per round and class; for a
    chain feat_lv, bins_lv and base_lv; the first differing node is
    reported, for the binary keys with the split-gain gap there). Binary:
    fold and holdout AuPR within 5e-3, probability_1 on the fixtures'
    4,096-row scoring frame within mean 5e-3 (max 1e-4 when every tree is
    identical); regression: fold and holdout RMSE within 1e-4 relative,
    prediction mean |d| <= 1e-4 std(y) (max <= 1e-5 (1 + |y|) with
    identical trees); multiclass: fold and holdout F1 within 5e-3, every
    probability within mean 5e-3 (max 1e-4 with identical trees), no
    prediction flip where the fixture's two highest probabilities are
    more than 1e-5 apart. Each train prints its seconds and peak device
    memory. The kernels' launch counts are zeroed just before each train
    and read just after it: every train must launch ``node_hist`` and
    ``hist_matmul``, the four boosted trains ``hist_matmul`` at least
    once per boosting round and ``node_hist`` at least rounds x levels
    times; the heap-boosted ones ``forest_predict_heap``, ``gbt12`` and
    the three RF trains ``forest_predict_chain``, the RF trains
    ``forest_leaf_sums_chain``; DT ``forest_leaf_sums_heap`` and
    ``forest_predict_heap``.
    Then six pinned linear workflows: binary ``lr`` (logistic regression,
    regParam 0.01, elasticNetParam 0.5: the L1 prox runs) and ``svc``
    (linear SVC, 0.01); 6-class ``lrmc`` (softmax LR, 0.01) and ``nbmc``
    (naive Bayes, smoothing 1); regression ``linreg`` (0.01 / 0.5: ISTA
    runs) and ``glm`` (gaussian, 0.01); and the three default model lists
    at full default grids (``default_binary``: LR, RF, GBT, SVC;
    ``default_mc``: LR, RF; ``default_reg``: linear regression, RF, GBT,
    GLM). Each must choose the fixture's winner (for the default lists
    the JAX package chose binary ``OpLinearSVC`` 0.01, multiclass
    ``OpLogisticRegression`` 0.01 / 0.0, regression
    ``OpLinearRegression`` 0.001 / 0.5) with every family's (folds,
    configs) fold metrics within the limits of its family: tree families
    within 1e-5 (AuPR, F1) or 1e-5 relative (RMSE), the linear families'
    bf16 sweeps AuPR and F1 within 5e-5, RMSE within 1e-4 relative or 3e-6
    std(y), a log-link GLM configuration finite exactly where the
    fixture's is; the holdout metric as the fold metrics; the linear
    winner's f32 refit params within 1e-5 of the fixture's largest param
    (a softmax's biases centred over the classes), probabilities within
    2e-5 (naive Bayes 5e-5), an SVC's margin and a regression's
    prediction within 5e-5 (1 + |value|), no flip of a prediction that no
    such gap can flip (each limit about 10x its card reading, stated with
    its cause at the constants). The default lists whose refit is a
    pinned key's model (``testing.SHARED_REFITS``: binary ``svc``,
    multiclass ``lrmc``) keep only their selection (``summary.json``);
    that key's saved model stands for their refit. The linear trains must
    launch nothing; each default list's sweep must launch ``node_hist``,
    ``hist_matmul`` and ``forest_predict_chain`` (its depth-3 and 6 trees
    are re-expressed as slot chains beside the depth-12 ones);
(m) the MLP keys ``mlp`` (binary) and ``mlpmc`` (6 classes):
    ``OpMultilayerPerceptronClassifier`` at hidden layers 50 and 50, step
    size 0.05, against their fixtures: the fixture's winner and config,
    fold and holdout metrics within ``MLP_FOLD_ATOL``, the refit's masks
    equal and weights within ``MLP_COEF_RTOL`` of each table's largest,
    probabilities within ``MLP_PROB_ATOL`` (causes at the constants);
    they launch none of the six kernels;
(s) save and load: every train above (the Titanic one included) is
    saved with ``save_model`` and loaded back on the card (the Titanic
    one with ``workflow=``); the reload scores the scoring frame bit for
    bit as the model in memory, and its plan.json holds the fixture's
    stages, class names and state keys (less ``JAX_ONLY_STATE``); each
    key's save and load seconds are printed, and a ``save_load_s`` JSON
    line gathers them. Then in a child process the saved ``gbt`` model
    is overwritten by the ``lr`` one, killed at the second ``os.replace``
    and again at the directory exchange: the directory still loads as the
    ``gbt`` model, with ``*.tmp`` debris only beside it;
(i) the isotonic calibrator fitted on the card to the ``mlp`` fixture's
    probability_1 (labels ``testing.calibration_labels``): boundaries,
    values and the calibrated column bit-equal to ``calibration.npz``;
(c) serve: load the seventeen committed saved models on the card, score the
    4,096-row scoring frame (rebuilt from its seed by
    ``testing.score_frame``) against the JAX package's outputs (binary:
    probability_1 atol 1e-5, prediction equal wherever |p - 0.5| > 1e-5;
    an SVC's rawPrediction_1 within 1e-5 (1 + |m|); regression and
    multiclass: the limits of (t) with identical trees),
    answer single-row requests through score_function, score 65,536-row
    batches and report rows/sec. The launch counts are zeroed just before
    this phase and read just after it; both forest predict kernels must
    have launched;
(d) print each path's launch counts and the ``kernels`` JSON line, whose
    launches are the sums over (t) and (c);
(e) print the card's name and power limit.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the package beside it, the script fails before printing it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np
import torch

# the histogram kernels' main-path shapes, input builders, bounds and
# timers: one definition, shared with the per-pass profiler
from transmogrifai_tpu_torch import profile_hist as PH
from transmogrifai_tpu_torch.profile_hist import bound_ms, time_ms
from transmogrifai_tpu_torch.models.api import to_numpy
# the committed serve64 fixtures' frames (their models:
# ``testing.SERVE_MODELS``)
from transmogrifai_tpu_torch.testing import (
    SCORE_ROWS, TRAIN_ROWS, TRAIN_SEED, WCV_LIN_FOLD_ATOL, refit_rows,
)
from transmogrifai_tpu_torch.testing import SERVE_CLASSES as N_CLASSES

N_ROWS = 65536
N_FEATURES = 64
N_BINS = 32
SUM_RTOL, SUM_ATOL = 1e-5, 1e-6
PROB_ATOL = 1e-5
PRED_MARGIN = 1e-5

FIXTURES = os.path.join(HERE, "transmogrifai_tpu_torch", "fixtures",
                        "serve64")
#: the tables that make a tree, per layout
HEAP_KEYS, CHAIN_KEYS = ("feat", "bins"), ("feat_lv", "bins_lv", "base_lv")
TREE_KEYS = {"gbt": HEAP_KEYS, "dt": HEAP_KEYS, "rf": CHAIN_KEYS,
             "gbt12": CHAIN_KEYS, "rfreg": CHAIN_KEYS, "gbtreg": HEAP_KEYS,
             "rfmc": CHAIN_KEYS, "xgbmc": HEAP_KEYS}
#: boosted fixtures: their tables carry (rounds, classes) in front
BOOSTED = ("gbt", "gbt12", "gbtreg", "xgbmc")
#: differing trees a train reports
MAX_REPORTED = 10
#: the leaf sums of the RF and DT refits: 19,712 padded rows, class counts
#: and the weight, k = 3
LEAF_K = 3
#: the refits' rows: bucket_for(18,000)
REFIT_ROWS = PH.ROWS
#: train-vs-fixture limits (sums run in another order than the JAX
#: package's XLA programs on the CPU, so metrics agree to rounding)
AUPR_ATOL = 5e-3
P1_MEAN_ATOL = 5e-3
P1_MAX_ATOL_SAME_TREES = 1e-4
#: regression trains: fold and holdout RMSE within this relative gap;
#: prediction mean |d| within this share of the label's std, max |d|
#: within REG_MAX_RTOL * (1 + |prediction|) when every tree is identical
RMSE_RTOL = 1e-4
REG_MEAN_SHARE = 1e-4
REG_MAX_RTOL = 1e-5
#: multiclass trains: F1 as the binary trains' AuPR, probabilities as
#: their probability_1
F1_ATOL = AUPR_ATOL
#: the default lists' tree families: every (fold, configuration) metric
#: within DEFAULT_TREE_ATOL (AuPR, F1) or DEFAULT_TREE_RTOL relative
#: (RMSE) of the fixture's (readings on an H100 80GB HBM3 at 700 W in
#: brackets: AuPR 3.6e-7, F1 6e-8, RMSE 1.6e-7 relative; 18
#: configurations x 3 folds a family, trees identical to the JAX
#: package's)
DEFAULT_TREE_ATOL = 1e-5
DEFAULT_TREE_RTOL = 1e-5
#: linear and GLM trains, each limit about 10x its reading on that card
#: (in brackets) and below the gap that would change a
#: selection (the binary list's winner leads by 1.95e-4 AuPR, the
#: regression list's by 1.5e-3 RMSE; LR's sweep was 3.8e-4 off the JAX
#: package's on the CPU before its bf16 roundings were placed as XLA
#: places them). bf16 sweep fold AuPR / F1 within LIN_FOLD_ATOL [8.7e-6],
#: as the CPU tests hold them. RMSE within LIN_RMSE_RTOL relative or
#: LIN_RMSE_YSTD of std(y), whichever is larger [7.5e-6 absolute, 1e-6
#: std(y)]: the penalty keeps a ridge or elastic-net fit off the RMSE
#: minimum, so the residual is correlated with X and a coefficient gap
#: dw moves the RMSE at first order, by about
#: regParam * <w, dw> / RMSE; as a fit's RMSE is itself about
#: proportional to regParam here (the labels are linear in X), rounding
#: gaps of ~1e-6 relative in w give a gap near 1e-6 std(y) whatever the
#: RMSE, which is 1e-3 of the 0.0058 RMSE of the regression list's
#: winner. The f32 refit's params within LIN_COEF_RTOL of the fixture's
#: largest [7.6e-7]; probabilities within LIN_PROB_ATOL [1.8e-6], naive
#: Bayes's within NB_PROB_ATOL, as the CPU tests hold them [card 7.9e-6,
#: CPU 1.8e-5: its logits reach ~300, so a gap of 1e-7 relative in its
#: log-probabilities moves a probability by up to ~1e-5]; margins and
#: regression predictions within LIN_REG_RTOL (1 + |value|) [4.8e-6]
LIN_FOLD_ATOL = 5e-5
LIN_RMSE_RTOL = 1e-4
LIN_RMSE_YSTD = 3e-6
LIN_COEF_RTOL = 1e-5
LIN_PROB_ATOL = 2e-5
NB_PROB_ATOL = 5e-5
LIN_REG_RTOL = 5e-5
#: the Titanic train's linear refit (529 kept columns, most of them
#: sparse one-hot and hash counts): the JAX package's own float32 refit
#: lies 9.4e-5 of the largest coefficient from a float64 run of the same
#: algorithm and its probability_1 1.25e-4, the port's 6.2e-6 and 1.6e-5
#: (``tests/test_torch_titanic_e2e.py``
#: ``test_the_lr_refit_gap_is_the_jax_packages_rounding``, CPU), so the
#: port's gap to the fixture is about their sum, 1.0e-4 and 1.4e-4: refit
#: params within TITANIC_LIN_COEF_RTOL of the largest, 2x that sum [card
#: 7.5e-5]; probability_1 within TITANIC_LIN_PROB_ATOL, 1.4x it [card
#: 3.5e-5]. Its sweep folds keep LIN_FOLD_ATOL [card LR 4.2e-5, SVC
#: 3.2e-5].
TITANIC_LIN_COEF_RTOL = 2e-4
TITANIC_LIN_PROB_ATOL = 2e-4
#: the MLP trains (``mlp``, ``mlpmc``; float32 matmuls with TF32 off).
#: Adam divides each step by sqrt(v): on the binary frame, which the MLP
#: separates almost perfectly, most weights' gradients are at rounding
#: level, so another order of the matmuls' adds moves them by a sizeable
#: share of the step size. The port against the fixtures on the CPU:
#: weights 5.7e-4 of their table's largest |weight| (6-class 1.8e-6),
#: probabilities 6.9e-5 (6-class 5.8e-6), fold metrics 6e-8, no
#: prediction flip [on an H100 80GB HBM3 at 700 W: 5.86e-4 (1.94e-6),
#: 7.16e-5 (6.68e-6), 0]. Limits ~10x the larger reading: weights
#: MLP_COEF_RTOL of each table's largest, probabilities MLP_PROB_ATOL, no
#: flip where the fixture's two highest probabilities are farther apart
#: than that; fold and holdout metrics at the linear sweeps'
#: LIN_FOLD_ATOL (a probability gap of 7e-5 can reorder near-tied rows in
#: AuPR)
MLP_COEF_RTOL = 6e-3
MLP_PROB_ATOL = 7e-4
MLP_FOLD_ATOL = LIN_FOLD_ATOL
#: state keys the JAX package saves and the port's stages do not carry
#: (a JAX mesh placement of the SanityChecker's statistics pass)
JAX_ONLY_STATE = {"SanityCheckerModel": {"_stats_input_sharding"}}
#: where (s) saves the trained models; set by ``_run``
SAVE_DIR = None
#: (s) seconds per saved key: {key: (save s, load s)}
SAVE_LOAD_S = {}

def phase_build():
    from transmogrifai_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    logs = cuda_build.build()
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  [{name}] {line.strip()}")
    print(f"(a) build: {len(logs)} source(s) compiled in {secs:.2f} s")


def _hist_case(dev, rng, S, d, B, nb, sentinel=0.05):
    """codes (S, d) in [0, nb] (a ``sentinel`` share equal to nb), [0, 1)
    stats and integer-valued stats, on the card."""
    codes = rng.randint(0, nb, (S, d))
    codes[rng.rand(S, d) < sentinel] = nb
    return (torch.from_numpy(codes.astype(np.int32)).to(dev),
            torch.from_numpy(rng.rand(S, B).astype(np.float32)).to(dev),
            torch.from_numpy(rng.randint(-3, 4, (S, B)).astype(
                np.float32)).to(dev))


def _check_hist(tag, codes, A, A_int, nb, exact):
    """Kernel against plain: tolerance on ``A``, bits on ``A_int`` and on
    a rerun."""
    from transmogrifai_tpu_torch.histeng import kernels as HK
    got = HK.hist_matmul_cuda(codes, A, nb, exact)
    want = HK.hist_matmul_plain(codes, A, nb, exact)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=SUM_ATOL)
    if A_int is not None and not torch.equal(
            HK.hist_matmul_cuda(codes, A_int, nb, exact),
            HK.hist_matmul_plain(codes, A_int, nb, exact)):
        raise AssertionError(f"hist_matmul ({tag}): integer-valued stats "
                             f"are not bit-equal to plain")
    if not torch.equal(got, HK.hist_matmul_cuda(codes, A, nb, exact)):
        raise AssertionError(f"hist_matmul ({tag}): reruns differ")
    return float((got - want).abs().max())


def passes(fn) -> str:
    """Device ms per call of each kernel ``fn`` launches, by name
    (``torch.profiler`` over 10 calls)."""
    return ", ".join(f"{k} {v:.4f}" for k, v in PH.pass_ms(fn, 10).items())


def _time_hist(codes, A, nb, exact):
    from transmogrifai_tpu_torch.histeng import kernels as HK
    oh = HK._one_hot(codes, nb)
    with HK._tf32_off():
        lib = time_ms(lambda: A.T @ oh)
    del oh

    def kernel():
        return HK.hist_matmul_cuda(codes, A, nb, exact)
    return dict(ms=time_ms(kernel), passes=passes(kernel),
                plain_ms=time_ms(lambda: HK.hist_matmul_plain(
                    codes, A, nb, exact)),
                library_ms=lib, bound=PH.hist_bound(codes, A, nb))


def phase_hist(dev, rng):
    """``hist_matmul`` against its plain version, the direct formula and
    one library matmul."""
    from transmogrifai_tpu_torch.histeng import kernels as HK
    from transmogrifai_tpu_torch.testing import hist_direct

    cases = []
    for tag, real, B, L in PH.HIST_CASES:
        codes, A = PH.leaf_inputs(dev, rng, real, B, L)
        cases.append((tag, dict(
            max_abs_err=_check_hist(tag, codes, A, (A * 8).round(), L, True),
            **_time_hist(codes, A, L, True))))
    r = cases[0][1]
    for tag, B, d, nb, exact in (("refit shape, every code valid",
                                  2 * PH.CODES, PH.CODES, 64, True),
                                 ("growth, bf16", 384, N_FEATURES, N_BINS,
                                  False)):
        codes, A, A_int = _hist_case(dev, rng, REFIT_ROWS, d, B, nb)
        cases.append((tag, dict(
            max_abs_err=_check_hist(tag, codes, A, A_int, nb, exact),
            **_time_hist(codes, A, nb, exact))))
    for tag, c in cases:
        print(f"(b) hist_matmul {tag}: max_abs_err {c['max_abs_err']:.3g}, "
              f"{c['ms']:.4f} ms (plain {c['plain_ms']:.4f} ms, library "
              f"{c['library_ms']:.4f} ms, bound {c['bound'][0]:.5f} ms by "
              f"{c['bound'][1]}); passes: {c['passes']}")
    # an odd shape against the definition, both modes
    S, d, B, nb = 1001, 7, 13, 37
    codes, A, _ = _hist_case(dev, rng, S, d, B, nb, sentinel=0.2)
    for exact in (True, False):
        Ain = A if exact else A.to(torch.bfloat16).to(torch.float32)
        want = torch.from_numpy(hist_direct(codes.cpu().numpy(),
                                            Ain.cpu().numpy(), nb)).to(dev)
        got = HK.hist_matmul_cuda(codes, A, nb, exact)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.double(), want, rtol=SUM_RTOL,
                                   atol=SUM_ATOL)
    print(f"(b) hist_matmul odd shape (S {S}, d {d}, B {B}, nb {nb}): "
          f"both modes match the direct float64 formula")
    return r


def _codes_read(codes, feat, bins, *, base=None, depth=None) -> int:
    """The codes a descent must read, counted on this run's data: each
    (row, feature) pair that some tree's path splits on, once (a node with
    the sentinel bin reads no code). Heap tables (T, 2^depth - 1), or with
    ``base`` slot-chain tables (T, depth, W)."""
    from transmogrifai_tpu_torch.ops import forest as F

    n, d = codes.shape
    seen = torch.zeros((n, d + 1), dtype=torch.bool, device=codes.device)
    for lv in range(depth if base is None else feat.shape[1]):
        if base is None:
            node = F.route_codes(codes, feat, bins, lv, N_BINS).long() \
                + (2 ** lv - 1)
            f, b = F._table_at(feat.long(), node), F._table_at(bins, node)
        else:
            slot = F.route_codes_chain(codes, feat[:, :lv], bins[:, :lv],
                                       base[:, :lv], N_BINS).long()
            live = slot < min(2 ** lv, feat.shape[2])
            s = torch.where(live, slot, torch.zeros_like(slot))
            f = F._table_at(feat[:, lv].long(), s)
            b = torch.where(live, F._table_at(bins[:, lv], s),
                            torch.full_like(s, N_BINS).int())
        seen.scatter_(1, torch.where((b < N_BINS) & (f >= 0) & (f < d), f,
                                     torch.full_like(f, d)), True)
    return int(seen[:, :d].sum())


def _check_leaf_sums(tag, cuda_fn, plain_fn, aug, aug_int):
    """Kernel against plain: tolerance on ``aug``, bits on ``aug_int`` and
    on a rerun."""
    got = cuda_fn(aug)
    want = plain_fn(aug)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=SUM_ATOL)
    if not torch.equal(cuda_fn(aug_int), plain_fn(aug_int)):
        raise AssertionError(f"{tag}: integer-valued stats are not "
                             f"bit-equal to plain")
    if not torch.equal(got, cuda_fn(aug)):
        raise AssertionError(f"{tag}: reruns differ")
    return float((got - want).abs().max())


def _check_chunked(tag, cuda_fn, ids, L, *augs):
    """Kernel against the kernels' order spelled out on the CPU
    (``testing.leaf_sums_chunked``): the same bits on each of ``augs``."""
    from transmogrifai_tpu_torch.ops import forest as F
    from transmogrifai_tpu_torch.testing import leaf_sums_chunked

    ids = ids.cpu()
    for a in augs:
        got = cuda_fn(a).cpu()
        want = leaf_sums_chunked(ids, a, L, *F.row_chunks(ids.shape[0]))
        nan = torch.isnan(want)
        if not (torch.equal(torch.isnan(got), nan) and torch.equal(
                got[~nan].view(torch.int32), want[~nan].view(torch.int32))):
            raise AssertionError(f"{tag}: not bit-equal to the chunked "
                                 f"order (max "
                                 f"{float((got - want).abs().max())})")


def _leaf_stats(dev, rng, n, k):
    """[0, 1) stats and integer-valued stats (n, k) on the card."""
    return (torch.from_numpy(rng.rand(n, k).astype(np.float32)).to(dev),
            torch.from_numpy(rng.randint(0, 4, (n, k)).astype(
                np.float32)).to(dev))


def phase_leaf_sums(dev, rng):
    """The leaf-sum kernels at the RF and DT refit shapes, against their
    plain versions and, at an odd shape, the direct float64 formula."""
    from transmogrifai_tpu_torch.ops import forest as F
    from transmogrifai_tpu_torch.testing import (
        descend_direct, leaf_sums_direct, random_chain, random_heap,
    )

    n, d, k = REFIT_ROWS, N_FEATURES, LEAF_K
    results = {}
    aug, aug_int = _leaf_stats(dev, rng, n, k)
    # the RF refit: slot chains, T=50, depth 12, W=256
    T, depth, W = 50, 12, 256
    c = {key: torch.from_numpy(v).to(dev) for key, v in random_chain(
        rng, n, d, T, depth, W, 1, N_BINS).items()}
    tabs = (c["codes"], c["feat"], c["bins"], c["base"])
    W_out = min(2 ** depth, W)

    def chain_sums(a, tabs=tabs):
        return F.forest_leaf_sums_chain_cuda(*tabs, a, n_bins=N_BINS)
    r = dict(max_abs_err=_check_leaf_sums(
        "forest_leaf_sums_chain", chain_sums,
        lambda a: F.forest_leaf_sums_chain_plain(*tabs, a, n_bins=N_BINS),
        aug, aug_int))
    _check_chunked("forest_leaf_sums_chain (RF refit)", chain_sums,
                   F.route_codes_chain(*tabs, N_BINS), W_out, aug, aug_int)
    slots = sum(min(2 ** lv, W) for lv in range(depth))
    r.update(ms=time_ms(lambda: chain_sums(aug)),
             plain_ms=time_ms(lambda: F.forest_leaf_sums_chain_plain(
                 *tabs, aug, n_bins=N_BINS)),
             # the codes the paths split on, the used table slots and the
             # stats read once, the sums written once; per row and tree one
             # step a level and one add per stat
             bound=bound_ms(4 * (_codes_read(c["codes"], c["feat"],
                                             c["bins"], base=c["base"])
                                 + T * slots * 3 + n * k + T * W_out * k),
                            n * T * (depth + k)))
    results["forest_leaf_sums_chain"] = r
    # the rfreg and rfmc refits: the same chains, k 4 ([-y, 1, 1] times
    # the weight, and the weight) and k 7 (six class counts and the weight)
    for tag, T_, depth_, W_, _, k_ in PH.LEAF_SUM_CASES:
        if k_ == k or W_ is None:
            continue
        a, a_int = _leaf_stats(dev, rng, n, k_)
        err = _check_leaf_sums(
            f"forest_leaf_sums_chain ({tag})", chain_sums,
            lambda x: F.forest_leaf_sums_chain_plain(*tabs, x,
                                                     n_bins=N_BINS),
            a, a_int)
        _check_chunked(f"forest_leaf_sums_chain ({tag})", chain_sums,
                       F.route_codes_chain(*tabs, N_BINS), W_out, a, a_int)
        b_ms, b_by = bound_ms(4 * (_codes_read(c["codes"], c["feat"],
                                               c["bins"], base=c["base"])
                                   + T * slots * 3 + n * k_
                                   + T * W_out * k_), n * T * (depth + k_))
        plain_ms = time_ms(lambda: F.forest_leaf_sums_chain_plain(
            *tabs, a, n_bins=N_BINS))
        print(f"(b) forest_leaf_sums_chain {tag} (k {k_}): max_abs_err "
              f"{err:.3g}, bit-equal to the chunked order, "
              f"{time_ms(lambda: chain_sums(a)):.4f} ms (plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms by {b_by})")
    # the DT refit (T=1) and a T=50 forest of depth-6 heaps
    for tag, T in (("DT refit", 1), ("T=50", 50)):
        depth = 6
        h = {key: torch.from_numpy(v).to(dev) for key, v in random_heap(
            rng, n, d, T, depth, 1, N_BINS).items()}
        tabs = (h["codes"], h["feat"], h["bins"])

        def heap_sums(a, tabs=tabs):
            return F.forest_leaf_sums_heap_cuda(*tabs, a, depth=depth,
                                                n_bins=N_BINS)
        r = dict(max_abs_err=_check_leaf_sums(
            f"forest_leaf_sums_heap ({tag})", heap_sums,
            lambda a: F.forest_leaf_sums_plain(*tabs, a, depth=depth,
                                               n_bins=N_BINS),
            aug, aug_int))
        _check_chunked(f"forest_leaf_sums_heap ({tag})", heap_sums,
                       F.route_codes(*tabs, depth, N_BINS), 2 ** depth, aug,
                       aug_int)
        r.update(
            ms=time_ms(lambda: heap_sums(aug)),
            plain_ms=time_ms(lambda: F.forest_leaf_sums_plain(
                *tabs, aug, depth=depth, n_bins=N_BINS)),
            bound=bound_ms(4 * (_codes_read(*tabs, depth=depth)
                                + 2 * T * (2 ** depth - 1) + n * k
                                + T * 2 ** depth * k), n * T * (depth + k)))
        print(f"(b) forest_leaf_sums_heap {tag}: max_abs_err "
              f"{r['max_abs_err']:.3g}, {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms by "
              f"{r['bound'][1]})")
        results.setdefault("forest_leaf_sums_heap", r)   # the DT refit's
    r = results["forest_leaf_sums_chain"]
    print(f"(b) forest_leaf_sums_chain RF refit: max_abs_err "
          f"{r['max_abs_err']:.3g}, {r['ms']:.4f} ms (plain "
          f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms by "
          f"{r['bound'][1]})")
    # the skew of a trained refit at its extreme: every split the sentinel,
    # so every row lands in leaf 0 of every tree
    for name, T, depth, W in (("forest_leaf_sums_chain", 50, 12, 256),
                              ("forest_leaf_sums_heap", 1, 6, None)):
        if W is None:
            h = random_heap(rng, n, d, T, depth, 1, N_BINS)
            h["bins"][:] = N_BINS
            tabs = tuple(torch.from_numpy(h[key]).to(dev)
                         for key in ("codes", "feat", "bins"))

            def sums(a, tabs=tabs, depth=depth):
                return F.forest_leaf_sums_heap_cuda(*tabs, a, depth=depth,
                                                    n_bins=N_BINS)
        else:
            c = random_chain(rng, n, d, T, depth, W, 1, N_BINS)
            c["bins"][:] = N_BINS
            c["base"][:] = 0
            tabs = tuple(torch.from_numpy(c[key]).to(dev)
                         for key in ("codes", "feat", "bins", "base"))

            def sums(a, tabs=tabs):
                return F.forest_leaf_sums_chain_cuda(*tabs, a, n_bins=N_BINS)
        ids = torch.zeros((n, T), dtype=torch.int32)
        _check_chunked(f"{name} (every row in leaf 0)", sums, ids,
                       2 ** depth if W is None else min(2 ** depth, W), aug,
                       aug_int)
        print(f"(b) {name}, every row in leaf 0 (T {T}, depth {depth}): "
              f"bit-equal to the chunked order, "
              f"{time_ms(lambda: sums(aug)):.4f} ms")
    # odd shapes against the definition
    n, d, nb = 301, 7, 13
    h = random_heap(rng, n, d, 5, 4, 1, nb)
    cn = random_chain(rng, n, d, 3, 9, 24, 1, nb)
    a64 = rng.rand(n, 5).astype(np.float32)
    aug = torch.from_numpy(a64).to(dev)
    got = F.forest_leaf_sums_heap_cuda(
        *(torch.from_numpy(h[key]).to(dev) for key in ("codes", "feat",
                                                       "bins")),
        aug, depth=4, n_bins=nb)
    want = leaf_sums_direct(descend_direct(h["codes"], h["feat"], h["bins"],
                                           depth=4), a64, 16)
    got_c = F.forest_leaf_sums_chain_cuda(
        *(torch.from_numpy(cn[key]).to(dev) for key in ("codes", "feat",
                                                        "bins", "base")),
        aug, n_bins=nb)
    want_c = leaf_sums_direct(descend_direct(cn["codes"], cn["feat"],
                                             cn["bins"], cn["base"]),
                              a64, 24)
    torch.cuda.synchronize()
    for g, w in ((got, want), (got_c, want_c)):
        np.testing.assert_allclose(g.cpu().numpy(), w, rtol=SUM_RTOL,
                                   atol=SUM_ATOL)
    print(f"(b) leaf sums odd shapes (n {n}, d {d}, nb {nb}; heap T 5 depth "
          f"4, chain T 3 depth 9 W 24, k 5): both match the direct float64 "
          f"formula")
    return results


def _node_library_ms(codes, node, sw, Wl, nb, stride):
    """``node_hist``'s library route: the masked-stat operand (built
    outside the timing), then one f32 matmul with the one-hot codes."""
    from transmogrifai_tpu_torch.histeng import kernels as HK
    S, T = node.shape
    slot = torch.arange(Wl, device=node.device) * stride
    A = torch.cat([(node[:, None, :] == slot[None, :, None]).float()
                   * s.to(torch.bfloat16).float()[:, None, :]
                   for s in sw], dim=1).reshape(S, len(sw) * Wl * T)
    oh = HK._one_hot(codes, nb)
    with HK._tf32_off():
        return time_ms(lambda: A.T @ oh, runs=5, warmup=1)


def phase_node_hist(dev, rng):
    """``node_hist`` against its plain version (the pinned contraction
    over the materialized masked-stat operand), the direct formula at an
    odd shape, and the library's route: one f32 matmul over that operand
    (cuBLAS, TF32 off), whose operand is built outside the timing."""
    from transmogrifai_tpu_torch.histeng import kernels as HK

    S = PH.ROWS
    out = {}
    for tag, T, Wl, stride, k, live in PH.NODE_CASES:
        codes, node, sw = PH.node_inputs(dev, rng, T, Wl, stride, k, live)
        sw_i = [(s * 4).floor() for s in sw]     # integer-valued, 0..3

        def kernel():
            return HK.node_hist_cuda(codes, node, sw, Wl, N_BINS, stride)

        def plain(stats=sw):
            return HK.node_hist_plain(codes, node, stats, Wl, N_BINS,
                                      stride).reshape(k, Wl, T, N_FEATURES,
                                                      N_BINS)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=SUM_ATOL)
        if not torch.equal(HK.node_hist_cuda(codes, node, sw_i, Wl, N_BINS,
                                             stride), plain(sw_i)):
            raise AssertionError(f"node_hist ({tag}): integer-valued stats "
                                 f"are not bit-equal to plain")
        if not torch.equal(got, kernel()):
            raise AssertionError(f"node_hist ({tag}): reruns differ")
        lib_ms = _node_library_ms(codes, node, sw, Wl, N_BINS, stride)
        # the direct formula adds in the kernel's order: the same bits
        if not torch.equal(got.reshape(k * Wl * T, -1),
                           HK.node_hist_direct(codes, node, sw, Wl, N_BINS,
                                               stride)):
            raise AssertionError(f"node_hist ({tag}): differs from the "
                                 f"direct formula")
        out[tag] = dict(
            max_abs_err=float((got - want).abs().max()),
            ms=time_ms(kernel), passes=passes(kernel),
            plain_ms=time_ms(plain, runs=5, warmup=1), library_ms=lib_ms,
            bound=PH.node_bound(codes, node, sw, Wl, stride))
        r = out[tag]
        print(f"(b) node_hist {tag} (S {S}, T {T}, Wl {Wl}, stride {stride}, "
              f"k {k}): max_abs_err {r['max_abs_err']:.3g}, {r['ms']:.4f} ms "
              f"(plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} "
              f"ms, bound {r['bound'][0]:.5f} ms by {r['bound'][1]}); "
              f"passes: {r['passes']}")
    # an odd shape against the definition: same bits (the rows in order)
    orng = np.random.RandomState(3)
    S, d, T, Wl, nb = 509, 9, 3, 17, 11
    codes = torch.from_numpy(orng.randint(0, nb + 1, (S, d)).astype(
        np.int32)).to(dev)
    node = torch.from_numpy(orng.randint(-2, 2 * Wl + 2, (S, T))).to(dev)
    sw = [torch.from_numpy(orng.randn(S, T).astype(np.float32)).to(dev)
          for _ in range(3)]
    got = HK.node_hist_matmul(codes, node, sw, Wl, nb, stride=2)
    want = HK.node_hist_direct(codes.cpu(), node.cpu(),
                               [x.cpu() for x in sw], Wl, nb, stride=2)
    torch.cuda.synchronize()
    if not torch.equal(got.cpu(), want):
        raise AssertionError("node_hist: odd shape differs from the direct "
                             "formula")
    print(f"(b) node_hist odd shape (S {S}, d {d}, T {T}, Wl {Wl}, stride 2, "
          f"nb {nb}): bit-equal to the direct formula")
    return out["RF refit, deepest level"]


def _predict_case(dev, rng, tag, T, depth, W, k=1):
    """A forest descent at a serve shape (W None: heaps; k leaf columns)
    against its plain version: sums bit-equal, leaf ids exact, reruns
    bit-equal; its time, the plain version's and the bound."""
    from transmogrifai_tpu_torch.ops import forest as F
    from transmogrifai_tpu_torch.testing import random_chain, random_heap

    if W is None:
        f = {key: torch.from_numpy(v).to(dev) for key, v in random_heap(
            rng, N_ROWS, N_FEATURES, T, depth, k, N_BINS).items()}
        args = (f["codes"], f["feat"], f["bins"], f["leaf"])

        def kernel(with_ids=False):
            return F.forest_predict_heap_cuda(*args, depth=depth,
                                              n_bins=N_BINS,
                                              with_ids=with_ids)

        def plain():
            return F.forest_predict_plain(*args, depth=depth, n_bins=N_BINS)
        want_ids = F.route_codes(*args[:3], depth, N_BINS)
        nbytes = 4 * (_codes_read(*args[:3], depth=depth)
                      + 2 * f["feat"].numel())
    else:
        f = {key: torch.from_numpy(v).to(dev) for key, v in random_chain(
            rng, N_ROWS, N_FEATURES, T, depth, W, k, N_BINS).items()}
        args = (f["codes"], f["feat"], f["bins"], f["base"], f["leaf"])

        def kernel(with_ids=False):
            return F.forest_predict_chain_cuda(*args, n_bins=N_BINS,
                                               with_ids=with_ids)

        def plain():
            return F.forest_predict_chain_plain(*args, n_bins=N_BINS)
        want_ids = F.route_codes_chain(*args[:4], N_BINS)
        slots = sum(min(2 ** lv, W) for lv in range(depth))
        nbytes = 4 * (_codes_read(*args[:3], base=f["base"])
                      + T * slots * 3)
    got, ids = kernel(with_ids=True)
    want = plain()
    torch.cuda.synchronize()
    if not torch.equal(ids, want_ids):
        raise AssertionError(f"forest predict ({tag}): leaf ids differ from "
                             f"the plain routing")
    if not torch.equal(got, want):
        raise AssertionError(f"forest predict ({tag}): sums differ from the "
                             f"plain version's bits (max "
                             f"{float((got - want).abs().max())})")
    if not torch.equal(got, kernel()[0]):
        raise AssertionError(f"forest predict ({tag}): reruns differ")
    # the codes the paths split on, the used table slots, the leaves and
    # the output once; per row and tree one step a level and one add a
    # column
    nbytes += 4 * (f["leaf"].numel() + N_ROWS * k)
    return dict(max_abs_err=float((got - want).abs().max()),
                ms=time_ms(lambda: kernel()[0]), plain_ms=time_ms(plain),
                bound=bound_ms(nbytes, N_ROWS * T * (depth + k)))


#: non-finite stats: one NaN, one +Inf, one -Inf, a +Inf/-Inf pair and a
#: finite value that rounds to +Inf in bf16
NONFINITE = {"nan": [float("nan")], "+inf": [float("inf")],
             "-inf": [-float("inf")],
             "+inf/-inf": [float("inf"), -float("inf")],
             "bf16 overflow": [3.4e38]}


def _same_or_nan(tag, got, want):
    got, want = got.cpu(), want.cpu()
    nan = torch.isnan(want)
    if not (torch.equal(torch.isnan(got), nan) and torch.equal(
            got[~nan].view(torch.int32), want[~nan].view(torch.int32))):
        raise AssertionError(f"{tag}: non-finite stats spread otherwise than "
                             f"in the plain version")


def phase_nonfinite(dev):
    """Both histogram kernels on stats with non-finite values, against the
    plain versions: the same NaN cells, the same bits in every other cell
    (integer-valued stats), on the roadmap's 16-row input (plain on the
    CPU) and at main-path shapes (``hist_matmul`` the GBT refit's stat
    width with a column all sentinel, plain on the CPU; ``node_hist`` the RF
    refit's deepest level, byte codes, and the GBT refit's level 5, plain
    on the card)."""
    from transmogrifai_tpu_torch.histeng import kernels as HK

    rng = np.random.RandomState(11)
    rm = torch.tensor([[0, 1], [1, 0], [2, 2], [0, 3]] * 4, dtype=torch.int32)
    n = 0
    for kind, vals in NONFINITE.items():
        def spoil(x, rows, cols):
            x = x.clone()
            for v in vals:
                x[int(rng.choice(rows)), int(rng.choice(cols))] = v
            return x
        for exact in (True, False):
            A = spoil(torch.ones(16, 2), [2, 3, 6], [0])
            _same_or_nan(f"hist_matmul ({kind}, roadmap input)",
                         HK.hist_matmul_cuda(rm.to(dev), A.to(dev), 3, exact),
                         HK.hist_matmul_plain(rm, A, 3, exact))
            codes = torch.from_numpy(rng.randint(0, N_BINS + 1, (
                PH.ROWS, N_FEATURES)).astype(np.int32))
            codes[:, 5] = N_BINS                   # a column all sentinel
            A = spoil(torch.from_numpy(rng.randint(-3, 4, (
                PH.ROWS, 128)).astype(np.float32)), np.arange(PH.ROWS),
                [0, 64, 127])
            _same_or_nan(f"hist_matmul ({kind}, {PH.ROWS} x {N_FEATURES})",
                         HK.hist_matmul_cuda(codes.to(dev), A.to(dev),
                                             N_BINS, exact),
                         HK.hist_matmul_plain(codes, A, N_BINS, exact))
            n += 2
        sw = [spoil(torch.ones(16, 1), [2, 3, 6], [0]), torch.ones(16, 1)]
        node = torch.tensor([[0], [1]] * 8, dtype=torch.int64)
        _same_or_nan(f"node_hist ({kind}, roadmap input)",
                     HK.node_hist_matmul(rm.to(dev), node.to(dev),
                                         [s.to(dev) for s in sw], 2, 3),
                     HK.node_hist_plain(rm, node, sw, 2, 3))
        for tag, T, Wl, stride, k, live in PH.NODE_CASES[:2]:
            codes = torch.from_numpy(rng.randint(0, N_BINS + 1, (
                PH.ROWS, N_FEATURES)).astype(np.int32))
            node = torch.from_numpy(rng.randint(-1, stride * live + 1, (
                PH.ROWS, T)))
            sw = [torch.from_numpy(rng.randint(-3, 4, (PH.ROWS, T)).astype(
                np.float32)) for _ in range(k)]
            sw[1] = spoil(sw[1], np.arange(PH.ROWS), np.arange(T))
            codes, node, sw = codes.to(dev), node.to(dev), [
                s.to(dev) for s in sw]
            _same_or_nan(f"node_hist ({kind}, {tag})",
                         HK.node_hist_matmul(codes, node, sw, Wl, N_BINS,
                                             stride),
                         HK.node_hist_plain(codes, node, sw, Wl, N_BINS,
                                            stride))
            n += 1
        n += 1
    print(f"(b) non-finite stats ({', '.join(NONFINITE)}): hist_matmul and "
          f"node_hist give the plain versions' NaN cells and every other "
          f"cell's bits in {n} cases")


def phase_forest_nonfinite(dev):
    """The four forest kernels on values that are not finite, against the
    plain versions: the same NaN cells or rows, every other one's bits
    (integer-valued stats and leaves). Leaf sums at the RF and DT refit
    shapes (one NaN, +Inf or -Inf stat, a +Inf/-Inf pair), also against the
    chunked order; predicts at the RF serve (chains), GBT serve (heaps) and
    DT serve (one heap, the int32 path) shapes, with a NaN leaf that a row
    reaches or that none reaches, a +Inf leaf and a +Inf/-Inf pair."""
    from transmogrifai_tpu_torch.ops import forest as F
    from transmogrifai_tpu_torch.testing import random_chain, random_heap

    rng = np.random.RandomState(12)
    n, d, k = REFIT_ROWS, N_FEATURES, LEAF_K
    count = 0
    for name, T, depth, W in (("forest_leaf_sums_chain", 50, 12, 256),
                              ("forest_leaf_sums_heap", 1, 6, None)):
        f = (random_heap(rng, n, d, T, depth, 1, N_BINS) if W is None
             else random_chain(rng, n, d, T, depth, W, 1, N_BINS))
        f = {key: torch.from_numpy(v).to(dev) for key, v in f.items()}
        if W is None:
            tabs = (f["codes"], f["feat"], f["bins"])
            ids = F.route_codes(*tabs, depth, N_BINS)
            L = 2 ** depth

            def kernel(a, tabs=tabs, depth=depth):
                return F.forest_leaf_sums_heap_cuda(*tabs, a, depth=depth,
                                                    n_bins=N_BINS)

            def plain(a, tabs=tabs, depth=depth):
                return F.forest_leaf_sums_plain(*tabs, a, depth=depth,
                                                n_bins=N_BINS)
        else:
            tabs = (f["codes"], f["feat"], f["bins"], f["base"])
            ids = F.route_codes_chain(*tabs, N_BINS)
            L = min(2 ** depth, W)

            def kernel(a, tabs=tabs):
                return F.forest_leaf_sums_chain_cuda(*tabs, a, n_bins=N_BINS)

            def plain(a, tabs=tabs):
                return F.forest_leaf_sums_chain_plain(*tabs, a,
                                                      n_bins=N_BINS)
        for kind in ("nan", "+inf", "-inf", "+inf/-inf"):
            a = torch.from_numpy(rng.randint(-3, 4, (n, k)).astype(
                np.float32))
            for v in NONFINITE[kind]:
                a[int(rng.randint(n)), 1] = v
            a = a.to(dev)
            _same_or_nan(f"{name} ({kind})", kernel(a), plain(a))
            _check_chunked(f"{name} ({kind})", kernel, ids, L, a)
            count += 1
    for tag, T, depth, W in (("RF serve", 50, 12, 256),
                             ("GBT serve", 20, 6, None),
                             ("DT serve", 1, 6, None)):
        f = (random_heap(rng, N_ROWS, N_FEATURES, T, depth, 2, N_BINS)
             if W is None else random_chain(rng, N_ROWS, N_FEATURES, T,
                                            depth, W, 2, N_BINS))
        f["leaf"] = rng.randint(-3, 4, f["leaf"].shape).astype(np.float32)
        if W is None:                # tree 0's right half: no row
            f["bins"][0, 0] = N_BINS
        else:                        # tree 0's last slot: no row
            f["base"][0, depth - 1] %= min(2 ** depth, W) - 2
        f = {key: torch.from_numpy(v).to(dev) for key, v in f.items()}
        if W is None:
            args = (f["codes"], f["feat"], f["bins"])
            ids = F.route_codes(*args, depth, N_BINS)

            def kernel(leaf, args=args, depth=depth):
                return F.forest_predict_heap_cuda(*args, leaf, depth=depth,
                                                  n_bins=N_BINS)[0]

            def plain(leaf, args=args, depth=depth):
                return F.forest_predict_plain(*args, leaf, depth=depth,
                                              n_bins=N_BINS)
        else:
            args = (f["codes"], f["feat"], f["bins"], f["base"])
            ids = F.route_codes_chain(*args, N_BINS)

            def kernel(leaf, args=args):
                return F.forest_predict_chain_cuda(*args, leaf,
                                                   n_bins=N_BINS)[0]

            def plain(leaf, args=args):
                return F.forest_predict_chain_plain(*args, leaf,
                                                    n_bins=N_BINS)
        L = f["leaf"].shape[1]
        r = int(torch.nonzero((ids < L).all(1))[0, 0])
        for kind in ("nan, reached", "nan, reached by no row", "+inf",
                     "+inf/-inf"):
            leaf = f["leaf"].clone()
            if kind == "nan, reached by no row":
                leaf[0, L - 1, 1] = float("nan")
            else:
                leaf[0, int(ids[r, 0]), 1] = (float("nan") if kind.startswith(
                    "nan") else float("inf"))
                if kind == "+inf/-inf":
                    leaf[T - 1, (int(ids[r, T - 1]) + (T == 1)) % L, 1] = \
                        -float("inf")
            _same_or_nan(f"forest predict {tag} ({kind})", kernel(leaf),
                         plain(leaf))
            count += 1
    print(f"(b) non-finite values: the four forest kernels give the plain "
          f"versions' NaN cells and rows and every other one's bits in "
          f"{count} cases (leaf sums also the chunked order's)")


def phase_kernels(dev):
    """Each kernel against its plain version at its path's shapes."""
    rng = np.random.RandomState(0)
    results = {"hist_matmul": phase_hist(dev, rng)}
    results["node_hist"] = phase_node_hist(dev, rng)
    results.update(phase_leaf_sums(dev, rng))

    # the serve shapes (``profile_hist.PREDICT_CASES``): RF and gbt12 slot
    # chains, GBT heaps, the DT's one heap (k 1); the rfmc chains and the
    # xgbmc heaps (T 600 = rounds x classes) at k 6
    for tag, T, depth, W, k in PH.PREDICT_CASES:
        name = "forest_predict_heap" if W is None else "forest_predict_chain"
        r = _predict_case(dev, rng, tag, T, depth, W, k)
        print(f"(b) {name} {tag} (T {T}, depth {depth}"
              f"{'' if W is None else f', W {W}'}, k {k}): bit-equal to "
              f"plain, ids exact, {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} "
              f"ms, bound {r['bound'][0]:.5f} ms by {r['bound'][1]})")
        results.setdefault(name, r)          # RF's chain, GBT's heap
    phase_nonfinite(dev)
    phase_forest_nonfinite(dev)
    return results


def _node_gains(codes, A, cfg, mode):
    """Split gains (d, n_bins - 1) of one node from its rows' stats A
    (rows outside the node zero), as the grower scores them."""
    from transmogrifai_tpu_torch.histeng import hist_matmul_plain
    from transmogrifai_tpu_torch.models import trees as TR

    k, d = A.shape[1], codes.shape[1]
    hist = hist_matmul_plain(codes, A, TR.N_BINS).reshape(
        k, d, TR.N_BINS).permute(1, 2, 0)[None]
    cum = TR._cumsum_bins(hist)
    total = cum[:, 0, -1, :]
    SL = cum[:, :, :-1, :]
    one = {key: torch.tensor([v], dtype=torch.float32, device=codes.device)
           for key, v in cfg.items()}
    gain, valid = TR._split_gain(SL, total[:, None, None, :] - SL, total,
                                 one, mode)
    return torch.where(valid, gain, torch.full_like(gain, -float("inf")))[0]


def _gap(gain, port, fixture, min_gain: float) -> float:
    """Gain of the port's split minus the fixture's at one node; a node
    that does not split scores ``min_gain``."""
    from transmogrifai_tpu_torch.models import trees as TR

    def at_split(f, b):
        return float(gain[f, b]) if b < TR.N_BINS - 1 else min_gain
    return at_split(*port) - at_split(*fixture)


def _gbt_gain_gap(model, data, fixture, key: str, t: int, level: int,
                  j: int, cls: int = 0) -> float:
    """Split gain of the port's choice minus the fixture's at node ``j`` of
    level ``level`` (a heap's position within the level, or a chain's
    slot) of boosting round ``t``'s tree of class ``cls``, both scored on
    the port's own state there: the refit rows, F after the first ``t``
    (identical) rounds (``testing.boosting_stats``), and the node's
    histogram built directly."""
    from transmogrifai_tpu_torch.models import trees as TR
    from transmogrifai_tpu_torch.models.api import MODEL_REGISTRY
    from transmogrifai_tpu_torch.ops.forest import (
        route_codes, route_codes_chain,
    )
    from transmogrifai_tpu_torch.testing import SERVE_MODELS, boosting_stats

    family, hyper, task = SERVE_MODELS[key]
    fam = MODEL_REGISTRY[family]
    p = model.stages[-1].fitted.params
    codes, y, w = refit_rows(model, data)
    keys = TREE_KEYS[key]
    chain = keys == CHAIN_KEYS
    tabs = [p[k][t:t + 1, cls] for k in keys]
    if not level:
        node = torch.zeros(codes.shape[0], dtype=torch.int32,
                           device=codes.device)
    elif chain:
        node = route_codes_chain(codes, *(x[:, :level].contiguous()
                                          for x in tabs), TR.N_BINS)[:, 0]
    else:
        node = route_codes(codes, tabs[0], tabs[1], level, TR.N_BINS)[:, 0]
    stats = torch.stack([s[:, cls] for s in boosting_stats(
        p, codes, y, w, task, t)], dim=1)
    gain = _node_gains(
        codes, stats * (node == j).float()[:, None],
        {"lam": hyper.get("lambda", fam.lam_default),
         "min_child_weight": hyper.get("minChildWeight", fam.mcw_default),
         "min_instances": hyper.get("minInstancesPerNode", 0.0)}, "gh")
    at = ((t, cls, level, j) if chain else (t, cls, 2 ** level - 1 + j))
    return _gap(gain, tuple(int(p[k][at]) for k in keys[:2]),
                tuple(int(fixture[k][at]) for k in keys[:2]),
                hyper.get("minInfoGain", 0.0))


def _forest_gain_gap(model, data, fixture, key: str, t: int, level: int,
                     j: int) -> float:
    """Split gain of the port's choice minus the fixture's at node ``j``
    (a chain's slot, or the DT heap's position within the level) of level
    ``level`` of forest tree ``t`` (the levels above are the same in
    both), scored on the tree's bootstrap rows and feature subset (the
    DT's: every row and feature): class counts (Gini) or, for a
    regressor, [-y, 1, 1] (Newton)."""
    from transmogrifai_tpu_torch.models import bootstrap
    from transmogrifai_tpu_torch.ops.forest import (
        route_codes, route_codes_chain,
    )
    from transmogrifai_tpu_torch.testing import SERVE_MODELS

    _, hyper, task = SERVE_MODELS[key]
    regression = task == "regression"
    keys = TREE_KEYS[key]
    p = model.stages[-1].fitted.params
    codes, y, w = refit_rows(model, data)
    S, d = codes.shape
    if key == "dt":
        boot = torch.ones(S, device=codes.device)
        fmask = torch.ones(d, dtype=torch.bool, device=codes.device)
        at = (2 ** level - 1 + j,)
    else:
        boots, fmasks = bootstrap.draw(
            np.array([7.0], np.float32),
            np.array([hyper["subsamplingRate"]], np.float32),
            hyper["numTrees"], S, d, bootstrap.feature_share(
                d, "regression" if regression else "classification"),
            codes.device, folded=True)          # one config: the refit
        boot, fmask = boots[0, t], fmasks[0, t]
        at = (t, level, j)
    if not level:
        node = torch.zeros(S, dtype=torch.int32, device=codes.device)
    elif key == "dt":
        node = route_codes(codes, p["feat"][None], p["bins"][None], level,
                           N_BINS)[:, 0]
    else:
        node = route_codes_chain(codes, *(p[k][t:t + 1, :level].contiguous()
                                          for k in keys), N_BINS)[:, 0]
    if regression:
        stats = torch.stack([-y, torch.ones_like(y), torch.ones_like(y)], 1)
    else:
        stats = torch.nn.functional.one_hot(
            y.long(), max(int(p["leaf"].shape[-1]), 2)).float()
    sw = stats * (w * boot)[:, None]
    A = (sw * (node == j).float()[:, None]).to(torch.bfloat16).float()
    gain = _node_gains(codes, A, {"min_instances":
                                  hyper["minInstancesPerNode"], "lam": 1e-6,
                                  "min_child_weight": 0.0},
                       "gh" if regression else "counts")
    gain = torch.where(fmask[:, None], gain,
                       torch.full_like(gain, -float("inf")))
    return _gap(gain, tuple(int(p[k][at]) for k in keys[:2]),
                tuple(int(fixture[k][at]) for k in keys[:2]),
                hyper["minInfoGain"])


def _tree_tables(params, key):
    """{table: (trees, ...)} of a fitted model's split tables: a boosted
    model's (rounds, classes) flattened to one tree axis, the DT's one
    tree given an axis of one."""
    out = {}
    for k in TREE_KEYS[key]:
        a = params[k]
        if key in BOOSTED:
            a = a.reshape((-1,) + a.shape[2:])
        elif key == "dt":
            a = a[None]
        out[k] = a
    return out


def _tree_differences(model, data, fixture, key, got, fx, same):
    """Report the first difference of each differing tree (the first
    ``MAX_REPORTED``): its (round, class) or tree index, level and node (a
    heap's node, a chain's slot), both splits there and, where the split
    choices differ, the split-gain gap. A forest's trees are independent,
    so each gets its gap; a boosted model's later rounds start from
    another state, so only its first differing tree does (``got``/``fx``:
    the tables of ``_tree_tables``; ``fixture``: the fixture's params)."""
    keys = TREE_KEYS[key]
    boosted = key in BOOSTED
    C = N_CLASSES if key == "xgbmc" else 1
    differing = [t for t, s in enumerate(same) if not s]
    for i, t in enumerate(differing[:MAX_REPORTED]):
        diff = np.zeros(fx[keys[0]][t].shape, bool)
        for k in keys:
            diff |= got[k][t] != fx[k][t]
        if keys == CHAIN_KEYS:
            level = int(np.nonzero(diff.any(1))[0][0])
            j = int(np.nonzero(diff[level])[0][0])
            at, where = (t, level, j), f"level {level}, slot {j}"
        else:
            node = int(np.nonzero(diff)[0][0])
            level = int(np.log2(node + 1))
            j = node - (2 ** level - 1)
            at, where = (t, node), f"level {level}, heap node {node}"
        port, fixt = ([int(tab[k][at]) for k in keys] for tab in (got, fx))
        gap = ""
        if port[:2] != fixt[:2] and not (boosted and i):
            g = (_gbt_gain_gap(model, data, fixture, key, t // C, level, j,
                               t % C) if boosted
                 else _forest_gain_gap(model, data, fixture, key, t, level,
                                       j))
            gap = f", gain gap {g:.6g}"
        tree = (f"round {t // C}, class {t % C}" if C > 1
                else f"round {t}" if boosted else f"tree {t}")
        print(f"(t) {key} {tree}: first difference at {where} (port "
              f"{port}, fixture {fixt}){gap}")
    if len(differing) > MAX_REPORTED:
        print(f"(t) {key}: {len(differing) - MAX_REPORTED} more trees "
              f"differ")


def _parts_of(model, scored):
    """{key: (n,) float32} of the model's Prediction column."""
    col = scored[model.result_features[0].name]
    vals = col.values.cpu().numpy()
    return {k: vals[:, i] for i, k in enumerate(col.metadata["keys"])}


def _check_parts(tag, task, got, exp, same_trees, y_std):
    """Hold a regression or multiclass model's prediction parts to the
    fixture's: regression mean |d| <= REG_MEAN_SHARE * std(y), and with
    identical trees max |d| <= REG_MAX_RTOL * (1 + |y|); multiclass each
    probability's mean |d| <= P1_MEAN_ATOL, with identical trees max |d|
    <= P1_MAX_ATOL_SAME_TREES, and no prediction flip where the fixture's
    two highest probabilities are more than PRED_MARGIN apart."""
    keys = (["prediction"] if task == "regression" else
            sorted(k for k in exp.files if k.startswith("probability_")))
    for k in keys:
        if got[k].shape != exp[k].shape or not np.isfinite(got[k]).all():
            raise AssertionError(f"{tag}: bad {k} {got[k].shape}")
    if task == "regression":
        w = exp["prediction"]
        d = np.abs(got["prediction"] - w)
        rel = float((d / (1 + np.abs(w))).max())
        if d.mean() > REG_MEAN_SHARE * y_std or (same_trees
                                                 and rel > REG_MAX_RTOL):
            raise AssertionError(f"{tag}: prediction off the fixture's "
                                 f"beyond the stated limits")
        return (f"prediction max |d| {d.max():.3g}, max |d| / (1 + |y|) "
                f"{rel:.3g}, mean |d| {d.mean():.3g} (std(y) {y_std:.4g})")
    d = np.stack([np.abs(got[k] - exp[k]) for k in keys], axis=1)
    if d.mean(0).max() > P1_MEAN_ATOL or (
            same_trees and d.max() > P1_MAX_ATOL_SAME_TREES):
        raise AssertionError(f"{tag}: probabilities off the fixture's beyond "
                             f"the stated limits")
    top2 = np.sort(np.stack([exp[k] for k in keys], axis=1), axis=1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > PRED_MARGIN
    flips = int((got["prediction"] != exp["prediction"])[decided].sum())
    if flips:
        raise AssertionError(f"{tag}: {flips} decided predictions differ")
    return (f"{len(keys)} probabilities: max |d| {d.max():.3g}, mean |d| "
            f"{d.mean(0).max():.3g} (worst class), 0 prediction flips of "
            f"{int(decided.sum())} decided rows")


#: an f32 sum of n terms, in any order, lies within
#: SUM_LAMBDA * sqrt(n) * 2^-24 * sum|x| of the exact sum but with
#: probability 2 exp(-SUM_LAMBDA^2 / 2), 3e-14 (Higham and Mary's
#: probabilistic bound); two such sums of one set, twice that
SUM_LAMBDA = 8.0


def _within_sum_bound(tag, got, want, scale, n):
    """A kernel's sums against the plain version's on the same inputs,
    each cell a sum of at most ``n`` terms: NaN cells equal, every other
    cell within 2 SUM_LAMBDA sqrt(n) 2^-24 of its sum of |stat| (``scale``:
    the plain version on the stats' magnitudes) plus SUM_ATOL. Returns
    the max |d| and its largest share of that bound."""
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        raise AssertionError(f"{tag}: NaN cells differ from plain")
    d = (got - want).abs()[~nan]
    if not d.numel():
        return 0.0, 0.0
    rtol = 2 * SUM_LAMBDA * n ** 0.5 * 2.0 ** -24
    share = float((d / (rtol * scale[~nan] + SUM_ATOL)).max())
    if share > 1:
        raise AssertionError(f"{tag}: max |d| {float(d.max())} from plain, "
                             f"{share:.3g} of the bound")
    return float(d.max()), share


#: the direct node histogram's partials a feature block may hold, bytes
DIRECT_BLOCK_BYTES = 4 << 30


#: lanes (stat x slot x tree columns of the masked-stat operand) of one
#: plain node histogram in a launch's check: its pinned contraction holds
#: 8 partials of (lanes, codes x bins) floats, ~100 GB for a whole
#: leads_stage deep level (150 trees x 256 slots x 4 stats at 589 codes)
PLAIN_NODE_LANES = 16384
#: the direct formula's partials (T, slots, chunks, k, codes, bins) a
#: launch's check may sum over, in all: wider launches (the leads_stage
#: deep levels, whose single-leaf trees put every row in one slot) are
#: held to plain only
DIRECT_MAX_BYTES = 64 << 30


def _node_within_bound(tag, flat, codes, node, sw_list, Wl, n_bins,
                       stride):
    """A ``node_hist`` launch's result ``flat`` ((k * Wl * T, d * bins))
    against ``node_hist_plain`` within ``_within_sum_bound``, over blocks
    of trees: each (stat, slot, tree) lane's cells are sums of their own,
    so the blocks are the whole check. Returns the max |d| and its
    largest share of the bound."""
    from transmogrifai_tpu_torch.histeng import kernels as HK
    T, k = node.shape[1], len(sw_list)
    tb = max(1, PLAIN_NODE_LANES // (k * Wl))
    got = flat.reshape(k, Wl, T, -1)
    ops = [s.to(torch.bfloat16).float().abs() for s in sw_list]
    err = share = 0.0
    for t in range(0, T, tb):
        cut = slice(t, t + tb)
        part = node[:, cut].contiguous()
        want = HK.node_hist_plain(codes, part, [s[:, cut].contiguous()
                                                for s in sw_list],
                                  Wl, n_bins, stride)
        scale = HK.node_hist_plain(codes, part, [s[:, cut].contiguous()
                                                 for s in ops],
                                   Wl, n_bins, stride)
        e, sh = _within_sum_bound(tag, got[:, :, cut].reshape(want.shape),
                                  want, scale, codes.shape[0])
        err, share = max(err, e), max(share, sh)
    return err, share


def _node_direct(codes, node, sw_list, Wl, n_bins, stride):
    """``node_hist_direct`` over blocks of features: its partials hold
    (T, Wl, chunks of the longest segment, k, d, bins) floats, too many at
    the Titanic's width, and each feature's cells are sums of their own,
    so the blocks side by side are the whole result, bit for bit."""
    from transmogrifai_tpu_torch.histeng import kernels as HK
    T, d = node.shape[1], codes.shape[1]
    ok = (node >= 0) & (node % stride == 0) & (node < stride * Wl)
    slot = torch.where(ok, node // stride, torch.full_like(node, Wl)).long()
    counts = torch.zeros((T, Wl + 1), dtype=torch.long, device=node.device)
    counts.scatter_add_(1, slot.T, torch.ones_like(slot.T))
    n_q = max(1, -(-int(counts[:, :Wl].max()) // HK.NODE_HIST_CHUNK))
    per_feature = 4 * T * Wl * n_q * len(sw_list) * n_bins
    if per_feature * d > DIRECT_MAX_BYTES:
        return None
    step = max(1, DIRECT_BLOCK_BYTES // per_feature)
    return torch.cat([HK.node_hist_direct(codes[:, f:f + step].contiguous(),
                                          node, sw_list, Wl, n_bins, stride)
                      for f in range(0, d, step)], dim=1)


class _KernelChecks:
    """``hist_matmul``, ``node_hist``, ``forest_predict_chain`` and
    ``forest_leaf_sums_chain`` wrapped for the duration of a ``with``
    block: every launch is held against the plain version on its own
    inputs (histograms and leaf sums within the sum bound of
    ``_within_sum_bound``, ``hist_matmul`` also bit-equal to plain on small
    integer stats of the same codes, ``node_hist`` bit-equal to its direct
    formula, chain predicts bit-equal with leaf ids exact, leaf sums
    bit-equal to their own order spelled out on the CPU). ``seen`` counts
    the calls, shapes, largest gap and bound share per kernel; with
    ``keep_heaviest`` the inputs of each kernel's heaviest launch are kept
    for timing (``heaviest``). With ``direct_per_shape`` only the first
    ``node_hist`` launch of each shape is also held to the direct formula
    (at ~530 codes the formula's indexed adds take seconds a launch; every
    launch is still held to plain). These launches are not counted: every
    count is zeroed before each path."""

    def __init__(self, keep_heaviest: bool = False,
                 direct_per_shape: bool = False):
        self.seen: dict = {}
        self.heaviest: dict = {}
        self.keep = keep_heaviest
        self.direct_per_shape = direct_per_shape
        self.direct_shapes: set = set()
        #: shapes whose direct formula is beyond DIRECT_MAX_BYTES
        self.too_wide: set = set()

    def _note(self, name, shape, err=0.0, share=0.0, work=0, args=None):
        r = self.seen.setdefault(name, dict(calls=0, shapes=set(), err=0.0,
                                            share=0.0))
        r["calls"] += 1
        r["shapes"].add(shape)
        r["err"], r["share"] = max(r["err"], err), max(r["share"], share)
        if self.keep and work > self.heaviest.get(name, (0,))[0]:
            self.heaviest[name] = (work, shape, args())

    def __enter__(self):
        from transmogrifai_tpu_torch.histeng import kernels as HK
        from transmogrifai_tpu_torch.ops import forest as F

        hist_cuda, node_cuda = HK.hist_matmul_cuda, HK.node_hist_cuda
        chain_cuda = F.forest_predict_chain_cuda
        sums_cuda = F.forest_leaf_sums_chain_cuda
        self._saved = (hist_cuda, node_cuda, chain_cuda, sums_cuda)
        note = self._note

        def hist(codes, A, n_bins, exact=False, *args, **kw):
            got = hist_cuda(codes, A, n_bins, exact, *args, **kw)
            op = HK._operand(A, exact)
            want = HK.hist_matmul_plain(codes, A, n_bins, exact)
            err, share = _within_sum_bound(
                "hist_matmul (sweep)", got, want,
                HK.hist_matmul_plain(codes, op.abs(), n_bins, True),
                codes.shape[0])
            # the same codes with small integer stats: every sum exact,
            # so a row added to a wrong cell, or twice, or not at all
            # shows
            A_int = (A * 4).round().clamp(-64, 64)
            if not torch.equal(hist_cuda(codes, A_int, n_bins, exact),
                               HK.hist_matmul_plain(codes, A_int, n_bins,
                                                    exact)):
                raise AssertionError("hist_matmul (sweep): integer-valued "
                                     "stats are not bit-equal to plain")
            note("hist_matmul", (tuple(codes.shape), A.shape[1], n_bins,
                                 exact), err, share,
                 codes.numel() * A.shape[1],
                 lambda: (codes.clone(), A.clone(), n_bins, exact))
            return got

        def node(codes, node, sw_list, Wl, n_bins, stride=1, *args, **kw):
            got = node_cuda(codes, node, sw_list, Wl, n_bins, stride, *args,
                            **kw)
            flat = got.reshape(-1, got.shape[-2] * got.shape[-1])
            err, share = _node_within_bound(
                "node_hist (sweep)", flat, codes, node, sw_list, Wl, n_bins,
                stride)
            shape = (tuple(codes.shape), node.shape[1], len(sw_list), Wl,
                     stride)
            if not (self.direct_per_shape and shape in self.direct_shapes):
                self.direct_shapes.add(shape)
                direct = _node_direct(codes, node, sw_list, Wl, n_bins,
                                      stride)
                if direct is None:
                    self.too_wide.add(shape)
                elif not torch.equal(flat, direct):
                    raise AssertionError("node_hist (sweep): differs from "
                                         "the direct formula")
                del direct
            note("node_hist", shape, err, share,
                 codes.numel() * node.shape[1] * len(sw_list),
                 lambda: (codes.clone(), node.clone(),
                          [s.clone() for s in sw_list], Wl, n_bins, stride))
            return got

        def chain(codes, feat_lv, bin_lv, base_lv, leaf, *, n_bins,
                  with_ids=False):
            out = chain_cuda(codes, feat_lv, bin_lv, base_lv, leaf,
                             n_bins=n_bins, with_ids=with_ids)
            want = F.forest_predict_chain_plain(codes, feat_lv, bin_lv,
                                                base_lv, leaf, n_bins=n_bins)
            _, ids = chain_cuda(codes, feat_lv, bin_lv, base_lv, leaf,
                                n_bins=n_bins, with_ids=True)
            if not torch.equal(out[0], want):
                raise AssertionError("forest_predict_chain (sweep): sums "
                                     "differ from the plain version's bits")
            if not torch.equal(ids, F.route_codes_chain(
                    codes, feat_lv, bin_lv, base_lv, n_bins)):
                raise AssertionError("forest_predict_chain (sweep): leaf "
                                     "ids differ from the plain routing")
            note("forest_predict_chain", (tuple(codes.shape),
                                          tuple(feat_lv.shape),
                                          leaf.shape[2]), 0.0, 0.0,
                 codes.shape[0] * feat_lv.shape[0] * feat_lv.shape[1],
                 lambda: (codes.clone(), feat_lv.clone(), bin_lv.clone(),
                          base_lv.clone(), leaf.clone(), n_bins))
            return out

        def sums(codes, feat_lv, bin_lv, base_lv, aug, *, n_bins):
            from transmogrifai_tpu_torch.testing import leaf_sums_chunked
            got = sums_cuda(codes, feat_lv, bin_lv, base_lv, aug,
                            n_bins=n_bins)
            want = F.forest_leaf_sums_chain_plain(codes, feat_lv, bin_lv,
                                                  base_lv, aug, n_bins=n_bins)
            err, share = _within_sum_bound(
                "forest_leaf_sums_chain (refit)", got, want,
                F.forest_leaf_sums_chain_plain(codes, feat_lv, bin_lv,
                                               base_lv, aug.abs(),
                                               n_bins=n_bins),
                codes.shape[0])
            ids = F.route_codes_chain(codes, feat_lv, bin_lv, base_lv,
                                      n_bins).cpu()
            order = leaf_sums_chunked(ids, aug.cpu(), got.shape[1],
                                      *F.row_chunks(ids.shape[0]))
            nan = torch.isnan(order)
            if not (torch.equal(torch.isnan(got.cpu()), nan) and torch.equal(
                    got.cpu()[~nan].view(torch.int32),
                    order[~nan].view(torch.int32))):
                raise AssertionError("forest_leaf_sums_chain (refit): not "
                                     "bit-equal to the chunked order")
            T, depth, W = feat_lv.shape
            note("forest_leaf_sums_chain", (tuple(codes.shape),
                                            (T, depth, W), aug.shape[1]),
                 err, share, codes.shape[0] * T * depth,
                 lambda: (codes.clone(), feat_lv.clone(), bin_lv.clone(),
                          base_lv.clone(), aug.clone(), n_bins))
            return got

        HK.hist_matmul_cuda, HK.node_hist_cuda = hist, node
        F.forest_predict_chain_cuda = chain
        F.forest_leaf_sums_chain_cuda = sums
        return self

    def __exit__(self, *exc):
        from transmogrifai_tpu_torch.histeng import kernels as HK
        from transmogrifai_tpu_torch.ops import forest as F
        HK.hist_matmul_cuda, HK.node_hist_cuda, \
            F.forest_predict_chain_cuda, \
            F.forest_leaf_sums_chain_cuda = self._saved
        return False

    def report(self, tag: str, names=("hist_matmul", "node_hist",
                                      "forest_predict_chain")) -> None:
        """Print what was held; every kernel of ``names`` must have
        launched."""
        for name in names:
            r = self.seen.get(name)
            if not r:
                raise AssertionError(f"{tag}: the train launched no {name}")
            held = ("bit-equal to plain, ids exact"
                    if name == "forest_predict_chain" else
                    f"max |d| {r['err']:.3g} from plain, "
                    f"{r['share']:.3f} of the sum bound; bit-equal to the "
                    f"chunked order"
                    if name == "forest_leaf_sums_chain" else
                    f"max |d| {r['err']:.3g} from plain, "
                    f"{r['share']:.3f} of the sum bound; " + (
                        "bit-equal to the direct formula"
                        + (" (each shape's first launch)"
                           if self.direct_per_shape else "")
                        + (f" but at {len(self.too_wide)} shapes beyond "
                           f"DIRECT_MAX_BYTES" if self.too_wide else "")
                        if name == "node_hist" else "on integer "
                        "stats of the same codes bit-equal to plain"))
            wide = max(shape[0][1] for shape in r["shapes"])
            print(f"(b) {name} at {tag}'s inputs: {r['calls']} launches, "
                  f"{len(r['shapes'])} shapes, codes {wide} wide at most: "
                  f"{held}")


def phase_sweep_inputs():
    """(b) ``hist_matmul``, ``node_hist`` and ``forest_predict_chain`` at
    the inputs of the default lists' sweeps: each list is trained once
    with the three wrappers wrapped (``_KernelChecks``), and every
    launch's result is held against the plain version on the same
    inputs; the chain predicts include the sweep's depth-3 and 6 heaps
    turned into padded depth-12 chains."""
    from transmogrifai_tpu_torch.testing import (
        SERVE_MODELS, serve_bench_data, serve_bench_workflow,
    )

    t0 = time.perf_counter()
    for key in ("default_binary", "default_mc", "default_reg"):
        task = SERVE_MODELS[key][2]
        wf = serve_bench_workflow(
            None, None, N_FEATURES, TRAIN_SEED, problem=task
        ).set_input_dataset(serve_bench_data(TRAIN_ROWS, N_FEATURES,
                                             TRAIN_SEED, task))
        if wf.device.type != "cuda":
            raise AssertionError(f"training on {wf.device}")
        with _KernelChecks() as checks:
            wf.train()
            torch.cuda.synchronize()
        checks.report(key)
    print(f"(b) the default lists' sweep inputs checked in "
          f"{time.perf_counter() - t0:.1f} s")


def _is_tree(family: str) -> bool:
    from transmogrifai_tpu_torch.models import trees
    from transmogrifai_tpu_torch.models.api import MODEL_REGISTRY
    return isinstance(MODEL_REGISTRY[family], trees._TreeFamilyBase)


def _fold_limit(family: str, hyper, task: str, ref, y_std: float,
                lin_atol: float = LIN_FOLD_ATOL):
    """The largest gap allowed between a default list's or a linear
    train's sweep fold metric and the fixture's ``ref``: tree families
    DEFAULT_TREE_ATOL (AuPR, F1) or DEFAULT_TREE_RTOL relative (RMSE); the
    linear families' bf16 sweeps ``lin_atol`` (AuPR, F1) or
    LIN_RMSE_RTOL relative, at least LIN_RMSE_YSTD std(y) (RMSE); a
    log-link GLM configuration only as finite or not (None)."""
    if _is_tree(family):
        return (DEFAULT_TREE_RTOL * abs(ref) if task == "regression"
                else DEFAULT_TREE_ATOL)
    if family == "OpMultilayerPerceptronClassifier":
        return MLP_FOLD_ATOL
    if family == "OpGeneralizedLinearRegression" and hyper.get(
            "family", "gaussian") != "gaussian":
        return None
    return (max(LIN_RMSE_RTOL * abs(ref), LIN_RMSE_YSTD * y_std)
            if task == "regression" else lin_atol)


def _check_selection(key, task, got, want, metric, y_std,
                     lin_atol: float = LIN_FOLD_ATOL):
    """The port's winner and every family's (folds, configs) fold metrics
    (``testing.selection_summary`` form) against the fixture's, each
    within ``_fold_limit``; prints each family's largest gap, and its
    share of the allowed gap."""
    from transmogrifai_tpu_torch.testing import selection_gaps
    try:
        gaps = selection_gaps(got, want, lambda family, hyper, ref: (
            _fold_limit(family, hyper, task, ref, y_std, lin_atol)))
    except AssertionError as e:
        raise AssertionError(f"{key}: {e}") from None
    for g in got["families"]:
        worst, share = gaps[g["family"]]
        print(f"(t) {key}: {g['family']} "
              f"{np.shape(g['fold_metrics'])} fold {metric} max gap "
              f"{worst:.3g} ({share:.2f} of its limit)")


def _linear_prob_limit(params) -> float:
    """NB_PROB_ATOL for a naive Bayes model, else LIN_PROB_ATOL."""
    return NB_PROB_ATOL if "log_prob" in params else LIN_PROB_ATOL


def _check_linear(key, task, ps, rs, parts, exp,
                  coef_rtol: float = LIN_COEF_RTOL, prob_atol=None):
    """A linear or GLM winner's refit params and scores against the
    fixture's: every float param within LIN_COEF_RTOL of the largest
    fixture param (a softmax's biases centred over the classes: a common
    shift is free); probabilities within LIN_PROB_ATOL (naive Bayes
    NB_PROB_ATOL), margins and
    regression predictions within LIN_REG_RTOL (1 + |value|), predictions
    equal where no such gap can flip them."""
    got = to_numpy(ps.fitted.params)
    fx = to_numpy(rs.fitted.params)
    if sorted(got) != sorted(fx):
        raise AssertionError(f"{key}: params {sorted(got)}, the fixture's "
                             f"{sorted(fx)}")
    scale = max(float(np.abs(v).max()) for v in fx.values())
    gaps = {}
    for k in fx:
        a, b = got[k], fx[k]
        if a.shape != b.shape:
            raise AssertionError(f"{key}: {k} {a.shape}, the fixture's "
                                 f"{b.shape}")
        if k == "b" and a.ndim == 1 and a.shape[0] > 1:
            a, b = a - a.mean(), b - b.mean()
        gaps[k] = float(np.abs(a - b).max()) / scale
    print(f"(t) {key}: refit params vs the fixture's, max |d| / max "
          f"|param|: { {k: float(f'{v:.3g}') for k, v in gaps.items()} }")
    if max(gaps.values()) > coef_rtol:
        raise AssertionError(f"{key}: refit params off the fixture's")
    if "probability_1" in exp.files or task == "multiclass":
        keys = sorted(k for k in exp.files if k.startswith("probability_"))
        lim = prob_atol or _linear_prob_limit(fx)
        d = np.stack([np.abs(parts[k] - exp[k]) for k in keys], axis=1)
        top = np.sort(np.stack([exp[k] for k in keys], axis=1), axis=1)
        if len(keys) == 1:
            decided = np.abs(exp[keys[0]] - 0.5) > lim
        else:
            decided = top[:, -1] - top[:, -2] > 2 * lim
        held = f"{len(keys)} probabilities: max |d| {d.max():.3g}"
        if d.max() > lim:
            raise AssertionError(f"{key}: probabilities off the fixture's")
    else:
        k = "rawPrediction_1" if task == "binary" else "prediction"
        w = exp[k]
        rel = np.abs(parts[k] - w) / (1 + np.abs(w))
        decided = np.abs(w) > LIN_REG_RTOL * (1 + np.abs(w))
        held = f"{k}: max |d| / (1 + |value|) {rel.max():.3g}"
        if rel.max() > LIN_REG_RTOL:
            raise AssertionError(f"{key}: {k} off the fixture's")
    if task != "regression":
        flips = int((parts["prediction"] != exp["prediction"])[decided].sum())
        if flips:
            raise AssertionError(f"{key}: {flips} decided predictions "
                                 f"differ")
        held += f", 0 prediction flips of {int(decided.sum())} decided rows"
    return held


def _plan_layout(path: str):
    """[(module, class, uid, state keys)] of a saved model's stages."""
    with open(os.path.join(path, "plan.json")) as fh:
        plan = json.load(fh)
    return [(d["module"], d["className"], d["uid"], set(d["state"]))
            for d in plan["stages"] + plan["rawFeatureGenerators"]]


def save_and_reload(key: str, model, fixture: str, data, workflow=None):
    """(s) Save a trained model with ``save_model``, load it back on the
    card (``workflow=`` resolves a Titanic model's lambdas): the reload
    must score ``data`` bit for bit as the model in memory, and its
    plan.json must hold the fixture's stages, class names and state keys
    (less ``JAX_ONLY_STATE``). Prints and keeps the save and load
    seconds."""
    import transmogrifai_tpu_torch as tt
    path = os.path.join(SAVE_DIR, key)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tt.save_model(model, path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = tt.load_model(path, workflow=workflow)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if again.device.type != "cuda":
        raise AssertionError(f"{key}: reloaded on {again.device}")
    got, want = _parts_of(again, again.score(data=data)), _parts_of(
        model, model.score(data=data))
    if sorted(got) != sorted(want) or not all(
            np.array_equal(got[k].view(np.int32), want[k].view(np.int32))
            for k in want):
        raise AssertionError(f"{key}: the reloaded model scores other bits")
    mine, theirs = _plan_layout(path), _plan_layout(fixture)
    if [m[:2] for m in mine] != [t[:2] for t in theirs] or any(
            m[3] != t[3] - JAX_ONLY_STATE.get(t[1], set())
            for m, t in zip(mine, theirs)):
        raise AssertionError(f"{key}: plan.json's stages or state keys "
                             f"differ from the fixture's")
    SAVE_LOAD_S[key] = (save_s, load_s)
    size = sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))
    print(f"(s) {key}: saved ({size} bytes) in {save_s:.4f} s, loaded in "
          f"{load_s:.4f} s; the reload scores bit-equal, plan.json's "
          f"{len(mine)} stages, classes and state keys the fixture's")


def _check_mlp(key, task, ps, rs, parts, exp) -> str:
    """An MLP winner's refit weights and scores against the fixture's:
    masks equal, each weight table within MLP_COEF_RTOL of its largest
    |weight|, probabilities within MLP_PROB_ATOL, no prediction flip where
    the fixture's two highest probabilities are farther apart."""
    got, fx = to_numpy(ps.fitted.params), to_numpy(rs.fitted.params)
    if got["num_classes"] != fx["num_classes"] or not all(
            np.array_equal(a, b) for a, b in zip(got["masks"],
                                                 fx["masks"])):
        raise AssertionError(f"{key}: classes or neuron masks differ")
    rel = max(float(np.abs(a - b).max() / np.abs(b).max())
              for a, b in zip(got["params"], fx["params"]))
    if rel > MLP_COEF_RTOL:
        raise AssertionError(f"{key}: refit weights off by {rel:.3g} of "
                             f"their largest")
    probs = sorted(k for k in exp.files if k.startswith("probability_"))
    err = max(float(np.abs(parts[k] - exp[k]).max()) for k in probs)
    P = np.stack([exp[k] for k in probs], 1)
    if P.shape[1] == 1:
        margin = np.abs(P[:, 0] - 0.5)
    else:
        top = np.sort(P, 1)
        margin = top[:, -1] - top[:, -2]
    flips = int((parts["prediction"] != exp["prediction"])[
        margin > MLP_PROB_ATOL].sum())
    if err > MLP_PROB_ATOL or flips:
        raise AssertionError(f"{key}: probabilities off by {err:.3g}, "
                             f"{flips} flips")
    return (f"refit weights max |d| / table max {rel:.3g} (limit "
            f"{MLP_COEF_RTOL}), probabilities max |d| {err:.3g} (limit "
            f"{MLP_PROB_ATOL}), 0 prediction flips")


def train_against_fixture(key: str):
    """Train the serve bench's ``key`` workflow on the card and hold the
    model against the fixture the JAX package trained on the same frame:
    a tree winner tree by tree; a linear or GLM winner by its refit params
    and scores; for a default-list key also the winner and every family's
    fold metrics. Returns the train's seconds."""
    import transmogrifai_tpu_torch as tt
    from transmogrifai_tpu_torch.testing import (
        SERVE_MODELS, SHARED_REFITS, score_frame, selection_summary,
        serve_bench_data, serve_bench_workflow,
    )

    family, hyper, task = SERVE_MODELS[key]
    data = serve_bench_data(TRAIN_ROWS, N_FEATURES, TRAIN_SEED, task)
    wf = serve_bench_workflow(family, hyper, N_FEATURES, TRAIN_SEED,
                              problem=task).set_input_dataset(data)
    if wf.device.type != "cuda":
        raise AssertionError(f"training on {wf.device}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = wf.train()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    what = (f"{family} {hyper}" if family is not None
            else "the default model list at full default grids")
    print(f"(t) {key} train: {TRAIN_ROWS} x {N_FEATURES}, {task}, {what}, "
          f"3-fold CV + refit + evaluations in {secs:.3f} s, peak "
          f"device memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")

    # a default list whose refit is a pinned key's model keeps only its
    # summary.json; that key's saved model stands for its refit
    path = os.path.join(FIXTURES, SHARED_REFITS.get(key, key))
    save_and_reload(key, model, path, score_frame())
    ref = tt.load_model(path)
    rs, ps = ref.stages[-1], model.stages[-1]
    if model.stages[-2].keep_indices != ref.stages[-2].keep_indices:
        raise AssertionError(f"{key}: SanityChecker kept other columns than "
                             f"the fixture")
    want = selection_summary(rs.summary)
    if family is None:
        with open(os.path.join(FIXTURES, key, "summary.json")) as fh:
            want = json.load(fh)
        if want["winner"] != rs.fitted.family or (
                key not in SHARED_REFITS
                and want["hyper"] != rs.summary.best_hyper):
            raise AssertionError(f"{key}: summary.json disagrees with the "
                                 f"saved model")
    if family is None or not _is_tree(family):
        y_std = float(np.std(data["y"]))
        metric = ps.summary.validation_metric
        _check_selection(key, task, selection_summary(ps.summary), want,
                         metric, y_std)
        hold = {k: ps.summary.holdout_evaluation[k] for k in
                ("AuPR", "F1", "RootMeanSquaredError") if k in
                ps.summary.holdout_evaluation}
        ref_hold = {k: rs.summary.holdout_evaluation[k] for k in hold}
        print(f"(t) {key}: winner {ps.summary.best_model_type} "
              f"{ps.summary.best_hyper} (the fixture's), {metric} "
              f"{ps.summary.best_metric_value:.6f} (fixture "
              f"{want.get('value', rs.summary.best_metric_value):.6f}), "
              f"holdout {hold} "
              f"(fixture {ref_hold})")
        for k, v in hold.items():
            lim = _fold_limit(ps.summary.best_model_type,
                              ps.summary.best_hyper, task, ref_hold[k], y_std)
            if abs(v - ref_hold[k]) > lim:
                raise AssertionError(f"{key}: holdout {k} {v} off the "
                                     f"fixture's {ref_hold[k]}")
        if not _is_tree(ps.summary.best_model_type):
            exp = np.load(os.path.join(path, "expected.npz"))
            parts = _parts_of(model, model.score(data=score_frame()))
            check = (_check_mlp if ps.summary.best_model_type
                     == "OpMultilayerPerceptronClassifier"
                     else _check_linear)
            print(f"(t) {key}: vs the JAX-trained model on {SCORE_ROWS} "
                  f"rows: " + check(key, task, ps, rs, parts, exp))
            return secs
    fx = to_numpy(rs.fitted.params)
    got = to_numpy(ps.fitted.params)
    if not np.array_equal(got["edges"], fx["edges"]):
        raise AssertionError(f"{key}: bin edges differ from the fixture's: "
                             f"max {np.abs(got['edges'] - fx['edges']).max()}")
    for k in TREE_KEYS[key]:
        if got[k].shape != fx[k].shape:
            raise AssertionError(f"{key}: {k} has shape {got[k].shape}, the "
                                 f"fixture's {fx[k].shape}")
    tg, tf = _tree_tables(got, key), _tree_tables(fx, key)
    same = [all(np.array_equal(tg[k][t], tf[k][t]) for k in tg)
            for t in range(len(tf[TREE_KEYS[key][0]]))]
    print(f"(t) {key}: edges bit-equal, kept columns equal "
          f"({len(model.stages[-2].keep_indices)}), trees identical: "
          f"{sum(same)} of {len(same)}")
    if not all(same):
        _tree_differences(model, data, fx, key, tg, tf, same)
    metric = {"binary": "AuPR", "regression": "RootMeanSquaredError",
              "multiclass": "F1"}[task]
    folds = np.asarray(ps.summary.validation_results[0].fold_metrics,
                       dtype=np.float64).ravel()
    ref_folds = torch.as_tensor(
        rs.summary.validation_results[0].fold_metrics).cpu().numpy().ravel()
    hold = ps.summary.holdout_evaluation[metric]
    ref_hold = rs.summary.holdout_evaluation[metric]
    print(f"(t) {key}: fold {metric} {folds.tolist()} (fixture "
          f"{ref_folds.tolist()}), holdout {metric} {hold:.6f} (fixture "
          f"{ref_hold:.6f}), splitter {ps.summary.splitter_summary} "
          f"(fixture {rs.summary.splitter_summary})")
    gaps = np.append(np.abs(folds - ref_folds), abs(hold - ref_hold))
    if task == "regression":
        if (gaps / np.abs(np.append(ref_folds, ref_hold))).max() > RMSE_RTOL:
            raise AssertionError(f"{key}: RMSE off the fixture's by more "
                                 f"than {RMSE_RTOL} relative")
    elif gaps.max() > (AUPR_ATOL if task == "binary" else F1_ATOL):
        raise AssertionError(f"{key}: {metric} off the fixture's by more "
                             f"than {AUPR_ATOL}")
    exp = np.load(os.path.join(path, "expected.npz"))
    frame = score_frame()
    parts = _parts_of(model, model.score(data=frame))
    if task != "binary":
        print(f"(t) {key}: vs the JAX-trained model on {SCORE_ROWS} rows: "
              + _check_parts(key, task, parts, exp, all(same),
                             float(np.std(data["y"]))))
        return secs
    p1 = parts["probability_1"]
    if p1.shape != exp["probability_1"].shape or not np.isfinite(p1).all():
        raise AssertionError(f"{key}: bad probability_1 {p1.shape}")
    dp = np.abs(p1 - exp["probability_1"])
    print(f"(t) {key}: probability_1 vs the JAX-trained model on "
          f"{len(p1)} rows: max |d| {dp.max():.3g}, mean |d| {dp.mean():.3g}")
    if dp.mean() > P1_MEAN_ATOL or (all(same)
                                    and dp.max() > P1_MAX_ATOL_SAME_TREES):
        raise AssertionError(f"{key}: probability_1 off the fixture's beyond "
                             f"the stated limits")
    return secs


def time_heaviest(heaviest, tag: str) -> dict:
    """Time each of ``hist_matmul``, ``node_hist``,
    ``forest_predict_chain`` and (where the train launched it)
    ``forest_leaf_sums_chain`` at its heaviest launch of a train
    (``heaviest``: {name: (work, shape, args)}) against its plain version
    and the library call; print and return {name: times, shape, passes,
    bound}."""
    from transmogrifai_tpu_torch.histeng import kernels as HK
    from transmogrifai_tpu_torch.ops import forest as F

    out = {}
    _, shape, a = heaviest["hist_matmul"]
    out["hist_matmul"] = dict(
        _time_hist(*a), shape=shape,
        bound=PH.hist_bound(a[0], HK._operand(a[1], a[3]), a[2]))
    _, shape, a = heaviest["node_hist"]
    codes, node, sw, Wl, nb, stride = a

    def node_kernel():
        return HK.node_hist_cuda(*a)
    out["node_hist"] = dict(
        shape=shape, ms=time_ms(node_kernel), passes=passes(node_kernel),
        plain_ms=time_ms(lambda: HK.node_hist_plain(*a), runs=5),
        library_ms=_node_library_ms(*a),
        bound=PH.node_bound(codes, node, sw, Wl, stride))
    _, shape, a = heaviest["forest_predict_chain"]
    codes, feat, bins, base, leaf, nb = a
    T, depth, W = feat.shape
    slots = sum(min(2 ** lv, W) for lv in range(depth))
    k = leaf.shape[2]
    nbytes = 4 * (_codes_read(codes, feat, bins, base=base)
                  + T * slots * 3 + leaf.numel() + codes.shape[0] * k)
    out["forest_predict_chain"] = dict(
        shape=shape, ms=time_ms(lambda: F.forest_predict_chain_cuda(
            codes, feat, bins, base, leaf, n_bins=nb)), passes=None,
        plain_ms=time_ms(lambda: F.forest_predict_chain_plain(
            codes, feat, bins, base, leaf, n_bins=nb), runs=5),
        library_ms=None,
        bound=bound_ms(nbytes, codes.shape[0] * T * (depth + k)))
    if "forest_leaf_sums_chain" in heaviest:
        _, shape, a = heaviest["forest_leaf_sums_chain"]
        codes, feat, bins, base, aug, nb = a
        T, depth, W = feat.shape
        slots = sum(min(2 ** lv, W) for lv in range(depth))
        n, k = aug.shape
        # as the refit shape's bound in (b): the codes the paths split on,
        # the used table slots and the stats read once, the sums written
        # once; per row and tree one step a level and one add per stat
        out["forest_leaf_sums_chain"] = dict(
            shape=shape, ms=time_ms(lambda: F.forest_leaf_sums_chain_cuda(
                codes, feat, bins, base, aug, n_bins=nb)), passes=None,
            plain_ms=time_ms(lambda: F.forest_leaf_sums_chain_plain(
                codes, feat, bins, base, aug, n_bins=nb), runs=5),
            library_ms=None,
            bound=bound_ms(4 * (_codes_read(codes, feat, bins, base=base)
                                + T * slots * 3 + n * k
                                + T * min(2 ** depth, W) * k),
                           n * T * (depth + k)))
    for name, r in out.items():
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"(b) {name} at the {tag}'s heaviest launch {r['shape']}: "
              f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
              f"{lib}), bound {r['bound'][0]:.5f} ms ({r['bound'][1]}); "
              f"passes: {r['passes'] or 'not taken'}")
    return out


TITANIC_DIR = os.path.join(HERE, "transmogrifai_tpu_torch", "fixtures",
                           "titanic")
#: the Titanic phase: rows of the scoring file answered one at a time
TITANIC_REQUESTS = 64


class Titanic:
    """The mixed-type path: the CSV reader, typed raw features (PickList,
    Text, Integral, Real, RealNN, two derived ``BinaryTransformer``
    features), ``transmogrify`` (pivots, smart text hashing, integral and
    real fills: ~570 columns), SanityChecker, the binary selector's
    default list at full default grids with 3-fold CV
    (``examples.titanic.build_workflow``), trained on the 20,000-row file
    ``testing.titanic_csv`` writes and served on its 4,096-row scoring
    file, against ``fixtures/titanic`` (what the JAX package made of the
    same files)."""

    def __init__(self, tmp: str):
        from transmogrifai_tpu_torch.testing import (
            TITANIC_ROWS, TITANIC_SCORE_ROWS, TITANIC_SCORE_SEED,
            TITANIC_SEED, titanic_csv,
        )
        with open(os.path.join(TITANIC_DIR, "fixture.json")) as fh:
            self.fx = json.load(fh)
        self.exp = np.load(os.path.join(TITANIC_DIR, "expected.npz"))
        self.sample = np.load(os.path.join(TITANIC_DIR, "vector_sample.npz"))
        self.train_csv = os.path.join(tmp, "titanic_train.csv")
        self.score_csv = os.path.join(tmp, "titanic_score.csv")
        for path, rows, seed, key in (
                (self.train_csv, TITANIC_ROWS, TITANIC_SEED, "train_csv"),
                (self.score_csv, TITANIC_SCORE_ROWS, TITANIC_SCORE_SEED,
                 "score_csv")):
            sha = titanic_csv(path, rows, seed)
            if sha != self.fx[key]["sha256"]:
                raise AssertionError(f"titanic: {key} sha256 {sha}, the "
                                     f"fixture's {self.fx[key]['sha256']}")
        print(f"(t) titanic: training and scoring files rebuilt, sha256 "
              f"equal to the fixture's")
        self.model = None

    def workflow(self):
        """The port's Titanic workflow over the training file, uids as the
        fixture's (``reset_uids`` first)."""
        from transmogrifai_tpu_torch.examples.titanic import build_workflow
        from transmogrifai_tpu_torch.features import reset_uids
        reset_uids()
        wf, _, _ = build_workflow(self.train_csv)
        if wf.device.type != "cuda":
            raise AssertionError(f"training on {wf.device}")
        return wf

    def check_inputs(self):
        """(b) the three sweep kernels at this train's own inputs, every
        launch against plain; then each one's heaviest launch timed."""
        from transmogrifai_tpu_torch.histeng import kernels as HK
        from transmogrifai_tpu_torch.ops import forest as F

        t0 = time.perf_counter()
        wf = self.workflow()
        with _KernelChecks(keep_heaviest=True,
                           direct_per_shape=True) as checks:
            wf.train()
            torch.cuda.synchronize()
        checks.report("titanic")
        print(f"(b) the titanic train's kernel inputs checked in "
              f"{time.perf_counter() - t0:.1f} s")
        return time_heaviest(checks.heaviest, "titanic train")

    def train(self):
        """The counted train, held to the fixture: the vector's metadata and
        sampled rows, the SanityChecker's choices, the selection (the
        fixture's winner, a linear family), and the refit's params with its
        scores on the scoring file."""
        import transmogrifai_tpu_torch as tt
        from transmogrifai_tpu_torch.testing import (
            assert_same_sanity, sanity_summary, selection_summary,
        )

        wf = self.workflow()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = wf.train()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        self.model, self.wf = model, wf
        print(f"(t) titanic train: {self.fx['train_csv']['rows']} rows, "
              f"default binary list at full default grids, 3-fold CV + "
              f"refit + evaluations in {secs:.3f} s (reader and vectorizers "
              f"included), peak device memory allocated "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
        sc = next(s for s in model.stages
                  if type(s).__name__ == "SanityCheckerModel")
        scored = model.score()                     # the training file
        vec = scored[sc.input_features[1].name]
        vm = vec.metadata["vector_meta"]
        meta = {"name": vm.name, "columns": [
            dataclasses.asdict(c) for c in vm.columns]}
        if meta != self.fx["vector"]:
            raise AssertionError("titanic: the vector's metadata differs "
                                 "from the fixture's")
        X = vec.values[torch.as_tensor(self.sample["rows"],
                                       device=vec.values.device)]
        if not np.array_equal(X.cpu().numpy(), self.sample["X"]):
            raise AssertionError("titanic: sampled vector rows differ from "
                                 "the fixture's bits")
        try:
            assert_same_sanity(sanity_summary(sc), self.fx["sanity"])
        except AssertionError as e:
            raise AssertionError(f"titanic: {e}") from None
        print(f"(t) titanic: vector {vm.size} columns, metadata equal, "
              f"{len(self.sample['rows'])} sampled rows bit-equal; "
              f"SanityChecker keeps {len(sc.keep_indices)}, drops "
              f"{len(sc.summary.dropped)} for the fixture's reasons")
        ps = model.stages[-1]
        if _is_tree(self.fx["selection"]["winner"]):
            raise AssertionError("titanic: the fixture's winner is not a "
                                 "linear family")
        _check_selection("titanic", "binary", selection_summary(ps.summary),
                         self.fx["selection"], ps.summary.validation_metric,
                         1.0)
        print(f"(t) titanic: winner {ps.summary.best_model_type} "
              f"{ps.summary.best_hyper} (the fixture's)")
        ref = tt.load_model(os.path.join(TITANIC_DIR, "model"),
                            workflow=wf)
        if sc.keep_indices != ref.stages[-2].keep_indices:
            raise AssertionError("titanic: the saved model keeps other "
                                 "columns")
        from transmogrifai_tpu_torch.readers import read_csv
        score_rows = read_csv(self.score_csv, self.reader().schema,
                              header=False).records()
        save_and_reload("titanic", model, os.path.join(TITANIC_DIR,
                                                       "model"),
                        score_rows, workflow=wf)
        parts = _parts_of(model, model.score(reader=self.reader()))
        print("(t) titanic: vs the JAX-trained model on the scoring file: "
              + _check_linear("titanic", "binary", ps, ref.stages[-1], parts,
                              self.exp, TITANIC_LIN_COEF_RTOL,
                              TITANIC_LIN_PROB_ATOL))
        return secs

    def reader(self):
        from transmogrifai_tpu_torch.examples.titanic import TITANIC_SCHEMA
        from transmogrifai_tpu_torch.readers import DataReaders
        return DataReaders.Simple.csv(self.score_csv, schema=TITANIC_SCHEMA,
                                      header=False, key_field="PassengerId")

    def serve(self):
        """The JAX-saved Titanic model on the card (its lambdas from the
        port's workflow): the scoring file through ``score`` and
        ``score_function`` within PROB_ATOL of the JAX package's scores,
        then rows/sec on the file tiled to N_ROWS rows; the card-trained
        model's ``score_function`` against its own ``score``."""
        import transmogrifai_tpu_torch as tt
        from transmogrifai_tpu_torch.readers import read_csv

        model = tt.load_model(os.path.join(TITANIC_DIR, "model"),
                              workflow=self.workflow())
        if model.device.type != "cuda":
            raise AssertionError(f"titanic loaded on {model.device}")
        scored = model.score(reader=self.reader())
        if list(scored.key) != self.exp["key"].tolist():
            raise AssertionError("titanic: scored keys differ")
        parts = _parts_of(model, scored)
        p1, exp = parts["probability_1"], self.exp["probability_1"]
        err = float(np.abs(p1 - exp).max())
        far = np.abs(exp - 0.5) > PRED_MARGIN
        flips = int((parts["prediction"] != self.exp["prediction"])[far]
                    .sum())
        if err > PROB_ATOL or flips or not np.isfinite(p1).all():
            raise AssertionError(f"titanic: saved model's probability_1 off "
                                 f"by {err}, {flips} flips")
        frame = read_csv(self.score_csv, self.reader().schema, header=False)
        rows = frame.records()[:TITANIC_REQUESTS]
        name = model.result_features[0].name
        for m, want in ((model, parts), (self.model, _parts_of(
                self.model, self.model.score(data=rows)))):
            fn = m.score_function()
            for i, row in enumerate(rows):
                got = fn(row)[name]["probability_1"]
                if abs(got - want["probability_1"][i]) > PROB_ATOL:
                    raise AssertionError(f"titanic: request {i} scored "
                                         f"{got}")
        reps = N_ROWS // len(exp)
        big = {k: np.tile(v, reps) for k, v in frame.columns.items()}
        _parts_of(model, model.score(data=big))           # warm-up
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            got_big = _parts_of(model, model.score(data=big))
            times.append(time.perf_counter() - t0)
        gap = float(np.abs(got_big["probability_1"] - np.tile(p1, reps))
                    .max())
        if gap > PROB_ATOL:
            raise AssertionError("titanic: the tiled batch disagrees")
        print(f"(c) titanic: saved model probability_1 max err {err:.3g}, 0 "
              f"prediction flips; {TITANIC_REQUESTS} requests through "
              f"score_function of the saved and the trained model within "
              f"{PROB_ATOL}; {N_ROWS / statistics.median(times):.1f} "
              f"rows/sec on {N_ROWS}-row batches (max |d| {gap:.3g} from "
              f"the {len(exp)}-row scores)")


TITANIC_WCV_DIR = os.path.join(HERE, "transmogrifai_tpu_torch", "fixtures",
                               "titanic_wcv")
#: the raw feature filter's JS divergences: float64 on the host from the
#: same bins and formulas as the JAX package's, numpy's order
WCV_JS_RTOL = 1e-9
#: its null-label correlations and the SanityChecker's label correlations
#: in the model insights: float32 Pearson sums over 20,000 rows, on the
#: card and in the JAX package in other orders. Readings off the fixture
#: (H100): the null-label ones 4.47e-8, the label ones 2.09e-7; the limit
#: is ~5x the largest (the smallest |label correlation| is 2.7e-5, so a
#: sign flip or a zero still fails)
WCV_CORR_ATOL = 1e-6
#: the model insights' refit evaluations (train and holdout metrics of a
#: refit whose probability_1 sits within TITANIC_LIN_PROB_ATOL of the
#: fixture's): rates and areas within WCV_EVAL_ATOL, confusion counts
#: within WCV_COUNT_ATOL rows (a row within that gap of 0.5 may flip)
WCV_EVAL_ATOL = 1e-3
WCV_COUNT_ATOL = 2.0


class TitanicWCV:
    """The Titanic workflow with the raw feature filter reading the
    scoring file and workflow-level CV (``testing.titanic_wcv_workflow``:
    the filter's default thresholds, the SanityChecker refit inside each
    of the 3 folds, the binary default list at full default grids), trained
    on the Titanic phase's 20,000-row file, against
    ``fixtures/titanic_wcv`` (what the JAX package made of the same two
    files)."""

    def __init__(self, titanic: "Titanic"):
        with open(os.path.join(TITANIC_WCV_DIR, "fixture.json")) as fh:
            self.fx = json.load(fh)
        with open(os.path.join(TITANIC_WCV_DIR, "insights.json")) as fh:
            self.insights = json.load(fh)
        self.exp = np.load(os.path.join(TITANIC_WCV_DIR, "expected.npz"))
        self.titanic = titanic
        for key in ("train_csv", "score_csv"):
            if self.fx[key] != titanic.fx[key]:
                raise AssertionError(f"titanic_wcv: {key} is not the "
                                     f"titanic fixture's")

    def workflow(self):
        from transmogrifai_tpu_torch.features import reset_uids
        from transmogrifai_tpu_torch.testing import titanic_wcv_workflow
        reset_uids()
        wf, survived, pred = titanic_wcv_workflow(self.titanic.train_csv,
                                                  self.titanic.score_csv)
        if wf.device.type != "cuda":
            raise AssertionError(f"training on {wf.device}")
        return wf, survived, pred

    def check_inputs(self):
        """(b) the three sweep kernels at this train's own inputs (the
        per-fold sweeps' shapes), every launch against plain; then each
        one's heaviest launch timed. Outside the counted path."""
        t0 = time.perf_counter()
        wf, _, _ = self.workflow()
        with _KernelChecks(keep_heaviest=True,
                           direct_per_shape=True) as checks:
            wf.train()
            torch.cuda.synchronize()
        checks.report("titanic_wcv")
        print(f"(b) the titanic_wcv train's kernel inputs checked in "
              f"{time.perf_counter() - t0:.1f} s")
        return time_heaviest(checks.heaviest, "titanic_wcv train")

    def train(self):
        """The counted train, held to the fixture: the filter's results
        and blacklist, each fold's SanityChecker, the final one, the
        selection, the refit's params and its scores and Brier score on
        the scoring file, the model insights, and a save and reload."""
        import transmogrifai_tpu_torch as tt
        from transmogrifai_tpu_torch.testing import (
            assert_same_sanity, insight_limits, insights_by_feature,
            json_gaps, sanity_summary, selection_summary,
        )

        wf, survived, pred = self.workflow()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = wf.train()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ph = wf.phase_seconds
        print(f"(t) titanic_wcv train: {self.fx['train_csv']['rows']} rows, "
              f"the filter against {self.fx['score_csv']['rows']} scoring "
              f"rows, default binary list at full default grids, workflow "
              f"CV over 3 folds + refit + evaluations in {secs:.3f} s: "
              f"filter {ph['filter']:.3f} s, label-free stages "
              f"{ph['before']:.3f} s, fold preparation {ph['fold_prep']:.3f}"
              f" s, per-fold sweeps {ph['sweep']:.3f} s, the rest "
              f"(SanityChecker and refit) {ph['rest']:.3f} s; peak device "
              f"memory allocated "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")

        # every check runs and its failure is kept; the phase fails after
        # the last one if any did
        faults = []

        def check(fn):
            try:
                fn()
            except AssertionError as e:
                print(f"(t) titanic_wcv: FAILED: {e}")
                faults.append(str(e))

        rff = model.rff_results.to_json()

        def filter_results():
            corr = max((abs(g["null_label_correlation"]
                            - w["null_label_correlation"])
                        for g, w in zip(rff["metrics"],
                                        self.fx["rff"]["metrics"])
                        if g["null_label_correlation"] is not None
                        and w["null_label_correlation"] is not None),
                       default=0.0)
            try:
                json_gaps(rff, self.fx["rff"], lambda p: {
                    "js_divergence": (WCV_JS_RTOL, 0.0),
                    "null_label_correlation": (0.0, WCV_CORR_ATOL)}.get(
                        p[-1] if p else "", (0.0, 0.0)))
            except AssertionError as e:
                raise AssertionError(f"titanic_wcv: filter results: {e}") \
                    from None
            blacklist = [f.name for f in model.blacklisted_features]
            if blacklist != self.fx["blacklist"]:
                raise AssertionError(f"titanic_wcv: blacklist {blacklist}, "
                                     f"the fixture's {self.fx['blacklist']}")
            print(f"(t) titanic_wcv: filter excludes "
                  f"{rff['excludedFeatures']} (map keys "
                  f"{rff['excludedMapKeys']}), the fixture's; "
                  f"{len(rff['metrics'])} features' counts, rates and "
                  f"reasons equal, null-label correlations within "
                  f"{corr:.3g}")
        check(filter_results)

        sel = next(s for s in wf.stages
                   if type(s).__name__ == "ModelSelector")
        sc = next(s for s in model.stages
                  if type(s).__name__ == "SanityCheckerModel")

        def sanity():
            if len(sel.fold_models) != len(self.fx["folds"]):
                raise AssertionError("titanic_wcv: fold count differs")
            for f, ((got,), want) in enumerate(zip(sel.fold_models,
                                                   self.fx["folds"])):
                try:
                    assert_same_sanity(sanity_summary(got), want)
                except AssertionError as e:
                    raise AssertionError(f"titanic_wcv fold {f}: {e}") \
                        from None
            try:
                assert_same_sanity(sanity_summary(sc), self.fx["sanity"])
            except AssertionError as e:
                raise AssertionError(f"titanic_wcv: {e}") from None
            drops = [len(m.summary.dropped) for (m,) in sel.fold_models]
            widths = [len(m.summary.stats.names) for (m,) in sel.fold_models]
            print(f"(t) titanic_wcv: each fold's SanityChecker drops {drops} "
                  f"of {widths} columns, the refit's "
                  f"{len(sc.summary.dropped)}: the fixture's columns and "
                  f"reasons")
        check(sanity)

        ps = model.stages[-1]
        winner = ps.summary.best_model_type
        check(lambda: _check_selection(
            "titanic_wcv", "binary", selection_summary(ps.summary),
            self.fx["selection"], ps.summary.validation_metric, 1.0,
            WCV_LIN_FOLD_ATOL))
        if _is_tree(winner):
            raise AssertionError("titanic_wcv: the winner is not a linear "
                                 "family: " + "; ".join(faults))
        print(f"(t) titanic_wcv: winner {winner} {ps.summary.best_hyper}")
        ref = tt.load_model(os.path.join(TITANIC_WCV_DIR, "model"),
                            workflow=wf)
        reader = self.titanic.reader()
        scored = model.score(table=reader.generate_table(model.raw_features))
        if list(scored.key) != self.exp["key"].tolist():
            raise AssertionError("titanic_wcv: scored keys differ")
        parts = _parts_of(model, scored)
        check(lambda: print(
            "(t) titanic_wcv: vs the JAX-trained model on the scoring "
            "file: " + _check_linear(
                "titanic_wcv", "binary", ps, ref.stages[-1], parts,
                self.exp, TITANIC_LIN_COEF_RTOL, TITANIC_LIN_PROB_ATOL)))

        def brier_score():
            brier = (tt.Evaluators.BinaryClassification.brier_score()
                     .set_label_col(survived).set_prediction_col(pred)
                     .evaluate_all(scored))
            d = TITANIC_LIN_PROB_ATOL
            gap = abs(brier["BrierScore"] - self.fx["brier"]["BrierScore"])
            if gap > (2 + d) * d or sum(brier["numberOfDataPoints"]) != sum(
                    self.fx["brier"]["numberOfDataPoints"]):
                raise AssertionError(f"titanic_wcv: Brier score "
                                     f"{brier['BrierScore']}, the fixture's "
                                     f"{self.fx['brier']['BrierScore']}")
            print(f"(t) titanic_wcv: Brier score {brier['BrierScore']:.6f} "
                  f"on the scoring file, {gap:.3g} from the fixture's "
                  f"(limit {(2 + d) * d:.3g} for probabilities within {d})")
        check(brier_score)

        def insights():
            got = insights_by_feature(model.model_insights().to_json())
            want = insights_by_feature(self.insights)
            corr = max((abs(a["correlation"] - b["correlation"])
                        for name, f in want["features"].items()
                        if name in got["features"]
                        for a, b in zip(got["features"][name]["derived"],
                                        f["derived"])
                        if a["correlation"] is not None
                        and b["correlation"] is not None), default=0.0)
            try:
                gaps = json_gaps(got, want, insight_limits(
                    winner, self.insights, TITANIC_LIN_COEF_RTOL,
                    WCV_EVAL_ATOL, WCV_COUNT_ATOL, WCV_LIN_FOLD_ATOL,
                    WCV_CORR_ATOL))
            except AssertionError as e:
                raise AssertionError(f"titanic_wcv insights (label "
                                     f"correlations within {corr:.3g}): "
                                     f"{e}") from None
            shares = {k: float(f"{v:.3g}") for k, v in sorted(gaps.items())}
            print(f"(t) titanic_wcv: model insights' keys and strings "
                  f"equal, the SanityChecker's label correlations within "
                  f"{corr:.3g}, each section's largest gap / its limit: "
                  f"{shares}")
        check(insights)

        def reload():
            from transmogrifai_tpu_torch.readers import read_csv
            score_rows = read_csv(self.titanic.score_csv, reader.schema,
                                  header=False).records()
            save_and_reload("titanic_wcv", model,
                            os.path.join(TITANIC_WCV_DIR, "model"),
                            score_rows, workflow=wf)
            again = tt.load_model(os.path.join(SAVE_DIR, "titanic_wcv"),
                                  workflow=wf)
            if ([f.uid for f in again.blacklisted_features]
                    != [f.uid for f in model.blacklisted_features]
                    or again.rff_results.to_json() != rff):
                raise AssertionError("titanic_wcv: the reload lost the "
                                     "blacklist or the filter's results")
        check(reload)
        if faults:
            raise AssertionError(f"titanic_wcv: {len(faults)} check(s) "
                                 f"failed: " + "; ".join(faults))
        return secs


LEADS_ROOT = os.path.join(HERE, "transmogrifai_tpu_torch", "fixtures")
#: path (b)'s RF on the scoring records: every class probability within
#: PROB_ATOL of the JAX-trained forest's (the same trees give the same
#: sums up to their order of addition), the prediction and the predicted
#: stage equal wherever the fixture's two highest probabilities are more
#: than PRED_MARGIN apart
LEADS_STAGE_PROB_ATOL = PROB_ATOL


#: the linear families of path (a)'s default list
LEADS_LINEAR = ("OpLogisticRegression", "OpLinearSVC")
#: path (a)'s linear sweep fold metrics against the same sweep evaluated
#: on the card in float64 (``testing.sweep_again``: the same bf16
#: roundings, float64 sums), per family. Measured by
#: ``experiments/leads_linear.py`` on an NVIDIA H100 80GB HBM3 at 700 W:
#: the card's float32 sweep lies 2.12e-4 (LR) and 1.38e-5 (SVC) from the
#: float64 one, and 1.2e-4 and 8.5e-6 under three reorderings of the
#: vector's columns; the sweep without its bf16 rounding, the control,
#: 5.55e-4 and 4.24e-5. Each limit sits between the two
LEADS_LIN_F64_ATOL = {"OpLogisticRegression": 3.4e-4, "OpLinearSVC": 2.4e-5}
#: path (a)'s SVC sweep fold metrics against the fixture's. The fixture's
#: sweep carries the error of the JAX package's float32 sums on the CPU:
#: the float64 evaluation lies 1.33e-3 AuPR from it (the port's own
#: float32 sweep on the CPU 1.55e-3 from the float64 one), the card
#: 1.32e-3 (``experiments/leads_linear.py``, the same card). The LR's
#: folds are not held to the fixture's: in 7 of its 18 cells the JAX
#: package's bf16 Newton sweep diverged under those sums (a fold's base
#: rate or its constant-score value, where the float64 evaluation and the
#: card give 0.62-0.67); they are held to the float64 evaluation, and the
#: LR to the fixture by the winner, its refit and its scores
LEADS_SVC_FOLD_ATOL = 2e-3


class Leads:
    """The lead-conversion paths (``testing.leads_records``: one record a
    sales lead, with dates, a date list, a geolocation and nine maps):
    (a) ``leads``: ``transmogrify`` of the fourteen predictors to ~620
    columns -> SanityChecker -> the binary default list at full default
    grids with 3-fold CV; (b) ``leads_stage``: the same predictors with the
    indexed ``Stage`` label -> the multiclass selector pinned to the RF of
    ``rfmc`` -> the prediction's class back to the stage's string
    (``PredictionDeIndexer``). Both are built with the date clock at the
    fixtures' instant (``testing.LEADS_CLOCK_MS``), trained on the
    20,000 training records and served on the 4,096 scoring records,
    against ``fixtures/leads`` and ``fixtures/leads_stage`` (what the JAX
    package made of the same records on the CPU)."""

    def __init__(self):
        from transmogrifai_tpu_torch.testing import (
            LEADS_PATHS, LEADS_ROWS, LEADS_SCORE_ROWS, LEADS_SCORE_SEED,
            LEADS_SEED, leads_records, records_sha256,
        )
        t0 = time.perf_counter()
        self.train_recs = leads_records(LEADS_ROWS, LEADS_SEED)
        self.score_recs = leads_records(LEADS_SCORE_ROWS, LEADS_SCORE_SEED)
        gen_s = time.perf_counter() - t0
        self.fx, self.exp, self.sample = {}, {}, {}
        for name in LEADS_PATHS:
            d = os.path.join(LEADS_ROOT, name)
            with open(os.path.join(d, "fixture.json")) as fh:
                self.fx[name] = json.load(fh)
            self.exp[name] = np.load(os.path.join(d, "expected.npz"))
            self.sample[name] = np.load(os.path.join(d,
                                                     "vector_sample.npz"))
            for key, recs in (("train_records", self.train_recs),
                              ("score_records", self.score_recs)):
                sha = records_sha256(recs)
                if sha != self.fx[name][key]["sha256"]:
                    raise AssertionError(f"{name}: {key} sha256 {sha}, the "
                                         f"fixture's "
                                         f"{self.fx[name][key]['sha256']}")
        with open(os.path.join(LEADS_ROOT, "leads", "insights.json")) as fh:
            self.insights = json.load(fh)
        print(f"(t) leads: {LEADS_ROWS} training and {LEADS_SCORE_ROWS} "
              f"scoring records rebuilt in {gen_s:.2f} s, sha256 equal to "
              f"both fixtures'")

    def workflow(self, name):
        """(workflow, label, prediction, results) of path ``name``, uids as
        the fixture's, the date clock at the fixture's instant."""
        from transmogrifai_tpu_torch.testing import (
            LEADS_CLOCK_MS, LEADS_PATHS, leads_workflow,
        )
        label, models = LEADS_PATHS[name]
        wf, y, pred, results = leads_workflow(self.train_recs, label, models,
                                              clock_ms=LEADS_CLOCK_MS)
        if wf.device.type != "cuda":
            raise AssertionError(f"training on {wf.device}")
        return wf, y, pred, results

    def check_inputs(self):
        """(b) each path's kernels at its own inputs, every launch against
        plain (path (a): the three sweep kernels; path (b): those at k 4
        and the refit's ``forest_leaf_sums_chain``); then each one's
        heaviest launch timed. Outside the counted paths. Returns {path:
        time_heaviest's result}."""
        out = {}
        for name, kernels in (
                ("leads", ("hist_matmul", "node_hist",
                           "forest_predict_chain")),
                ("leads_stage", ("hist_matmul", "node_hist",
                                 "forest_predict_chain",
                                 "forest_leaf_sums_chain"))):
            t0 = time.perf_counter()
            wf, _, _, _ = self.workflow(name)
            with _KernelChecks(keep_heaviest=True,
                               direct_per_shape=True) as checks:
                wf.train()
                torch.cuda.synchronize()
            checks.report(name, kernels)
            print(f"(b) the {name} train's kernel inputs checked in "
                  f"{time.perf_counter() - t0:.1f} s")
            out[name] = time_heaviest(checks.heaviest, f"{name} train")
        return out

    def train(self, name):
        """The counted train of path ``name``, held to its fixture: the
        vector's metadata and sampled rows, the SanityChecker's choices,
        the date pivot's reference instant, the selection, the scores on
        the scoring records (path (a): the LR refit's params and
        probabilities; path (b): the RF's probabilities and the
        deindexed stages), path (a)'s model insights, and a save and
        reload. Every check runs; the phase fails after the last if any
        did."""
        import transmogrifai_tpu_torch as tt
        from transmogrifai_tpu_torch.testing import (
            assert_same_sanity, insight_limits, insights_by_feature,
            json_gaps, sanity_summary, selection_summary,
        )
        fx, exp, sample = self.fx[name], self.exp[name], self.sample[name]
        task = "binary" if fx["label"] == "Converted" else "multiclass"
        wf, _, pred, results = self.workflow(name)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = wf.train()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(f"(t) {name} train: {fx['train_records']['rows']} records, "
              f"label {fx['label']}, " + (
                  "binary default list at full default grids"
                  if task == "binary" else "the RF of rfmc")
              + f", 3-fold CV + refit + evaluations in {secs:.3f} s "
              f"(records read and vectorized on the host included; the "
              f"JAX package's CPU train {fx['train_seconds_jax_cpu']:.1f}"
              f" s); peak device memory allocated "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
        faults = []

        def check(fn):
            try:
                fn()
            except AssertionError as e:
                print(f"(t) {name}: FAILED: {e}")
                faults.append(str(e))

        sc = next(s for s in model.stages
                  if type(s).__name__ == "SanityCheckerModel")
        ps = next(s for s in model.stages
                  if type(s).__name__ == "SelectedModel")

        def vector_and_checks():
            vec = model.train_table[sc.input_features[1].name]
            vm = vec.metadata["vector_meta"]
            meta = {"name": vm.name, "columns": [
                dataclasses.asdict(c) for c in vm.columns]}
            if meta != fx["vector"]:
                raise AssertionError(f"{name}: the vector's metadata "
                                     f"differs from the fixture's")
            if not isinstance(vec.values, torch.Tensor) or \
                    vec.values.device.type != "cuda":
                raise AssertionError(f"{name}: the vector is not on the "
                                     f"card")
            X = vec.values[torch.as_tensor(sample["rows"],
                                           device=vec.values.device)]
            if not np.array_equal(X.cpu().numpy(), sample["X"]):
                raise AssertionError(f"{name}: sampled vector rows differ "
                                     f"from the fixture's bits")
            assert_same_sanity(sanity_summary(sc), fx["sanity"])
            ref_ms = next(s for s in model.stages if type(s).__name__
                          == "DateListVectorizer").reference_date_ms
            if ref_ms != fx["reference_date_ms"]:
                raise AssertionError(f"{name}: reference_date_ms {ref_ms}, "
                                     f"the fixture's "
                                     f"{fx['reference_date_ms']}")
            print(f"(t) {name}: vector {vm.size} columns, metadata equal, "
                  f"{len(sample['rows'])} sampled rows bit-equal; "
                  f"SanityChecker keeps {len(sc.keep_indices)}, drops "
                  f"{len(sc.summary.dropped)} for the fixture's reasons; "
                  f"date pivot reference {ref_ms} (the fixture's)")
        check(vector_and_checks)
        winner = ps.summary.best_model_type
        got_sel = selection_summary(ps.summary)
        f64 = {}
        if task == "binary":
            from transmogrifai_tpu_torch.testing import (
                selection_rows, sweep_again,
            )
            t1 = time.perf_counter()
            X, y = selection_rows(pred.origin_stage, model.train_table)
            f64 = sweep_again(pred.origin_stage, X.double(), y.double(),
                              LEADS_LINEAR)
            del X, y
            print(f"(t) {name}: the linear sweeps evaluated again in "
                  f"float64 on the card in {time.perf_counter() - t1:.2f} s")

        def fold_limit(family, hyper, ref):
            if family == "OpLogisticRegression":
                return None                   # finite where the fixture's is
            if family == "OpLinearSVC":
                return LEADS_SVC_FOLD_ATOL
            return _fold_limit(family, hyper, task, ref, 1.0)

        def selection():
            from transmogrifai_tpu_torch.testing import selection_gaps
            try:
                gaps = selection_gaps(got_sel, fx["selection"], fold_limit)
            except AssertionError as e:
                raise AssertionError(f"{name}: {e}") from None
            print(f"(t) {name}: fold {ps.summary.validation_metric} gaps "
                  f"to the fixture (largest, share of its limit): "
                  f"{ {f: (float(f'{g:.3g}'), round(r, 3))
                       for f, (g, r) in gaps.items()} }")
        check(selection)

        def linear():
            by = {g["family"]: np.asarray(g["fold_metrics"], np.float64)
                  for g in got_sel["families"]}
            want = {g["family"]: np.asarray(g["fold_metrics"], np.float64)
                    for g in fx["selection"]["families"]}
            worst = {}
            for family in LEADS_LINEAR:
                d = float(np.abs(by[family] - f64[family]).max())
                worst[family] = float(f"{d:.3g}")
                if d > LEADS_LIN_F64_ATOL[family]:
                    raise AssertionError(
                        f"{name}: {family} fold metrics {d:.3g} from the "
                        f"float64 evaluation, beyond "
                        f"{LEADS_LIN_F64_ATOL[family]}")
            print(f"(t) {name}: linear fold metrics from the float64 "
                  f"evaluation (max |d|): {worst} (limits "
                  f"{LEADS_LIN_F64_ATOL}); from the fixture, per "
                  f"configuration (max over folds): " + "; ".join(
                      f"{family} " + str(np.round(np.abs(
                          by[family] - want[family]).max(axis=0), 6)
                          .tolist()) for family in LEADS_LINEAR))
        if task == "binary":
            check(linear)
        print(f"(t) {name}: winner {winner} {ps.summary.best_hyper}")
        ref = tt.load_model(os.path.join(LEADS_ROOT, name, "model"),
                            workflow=wf)
        scored = model.score(data=self.score_recs)
        parts = _parts_of(model, scored)
        ref_sel = next(s for s in ref.stages
                       if type(s).__name__ == "SelectedModel")
        if task == "binary":
            if _is_tree(winner):
                raise AssertionError(f"{name}: the winner is not the "
                                     f"fixture's linear family: "
                                     + "; ".join(faults))
            check(lambda: print(
                f"(t) {name}: vs the JAX-trained model on the scoring "
                f"records: " + _check_linear(
                    name, "binary", ps, ref_sel, parts, exp,
                    TITANIC_LIN_COEF_RTOL, TITANIC_LIN_PROB_ATOL)))
        else:
            def stages():
                keys = sorted(k for k in exp.files
                              if k.startswith("probability_"))
                d = max(float(np.abs(parts[k] - exp[k]).max())
                        for k in keys)
                top = np.sort(np.stack([exp[k] for k in keys], axis=1),
                              axis=1)
                decided = top[:, -1] - top[:, -2] > PRED_MARGIN
                got = np.asarray(scored[results[1].name].values,
                                 dtype=object).astype(str)
                flips = int((got != exp["stage"])[decided].sum()) + int(
                    (parts["prediction"] != exp["prediction"])[
                        decided].sum())
                if d > LEADS_STAGE_PROB_ATOL or flips:
                    raise AssertionError(
                        f"{name}: probabilities within {d:.3g} (limit "
                        f"{LEADS_STAGE_PROB_ATOL}), {flips} decided "
                        f"predictions or stages differ")
                counts = {s: int((got == s).sum()) for s in sorted(set(got))}
                print(f"(t) {name}: vs the JAX-trained model on the scoring "
                      f"records: {len(keys)} probabilities max |d| {d:.3g}, "
                      f"0 flips of prediction or deindexed stage in "
                      f"{int(decided.sum())} decided rows; stages {counts}")
                # the forest predicts one stage for every scoring record
                # (both packages' forests): most of its trees stop within
                # a few splits, so its class probabilities stay near the
                # classes' shares. The deindexer is held on its own too
                leaf = ps.fitted.params["leaf"]
                leaves = (leaf.abs().sum(-1) > 0).sum(1)
                probs = np.stack([parts[k] for k in keys], axis=1)
                print(f"(t) {name}: the forest: "
                      f"{int((leaves == 1).sum())} of {leaf.shape[0]} trees "
                      f"a single leaf, median "
                      f"{float(leaves.float().median()):.0f} leaves; "
                      f"probability_0 over the scoring records in "
                      f"[{probs[:, 0].min():.3f}, {probs[:, 0].max():.3f}], "
                      f"the classes' mean probabilities "
                      f"{np.round(probs.mean(axis=0), 3).tolist()}")
            check(stages)

            def deindexer():
                # the JAX package's labels, as its saved deindexer holds
                # them; every scored stage the label of its prediction,
                # and the fitted deindexer on the card fed every class
                # index, float noise and indices out of range
                from transmogrifai_tpu_torch.table import Column, FeatureTable
                from transmogrifai_tpu_torch.types import RealNN
                with open(os.path.join(LEADS_ROOT, name, "model",
                                       "plan.json")) as fh:
                    state = next(
                        st["state"] for st in json.load(fh)["stages"]
                        if st["className"] == "PredictionDeIndexerModel")
                labels, unseen = state["labels"], state["unseen_name"]
                got = np.asarray(scored[results[1].name].values,
                                 dtype=object).astype(str)
                mapped = np.asarray(labels, dtype=object)[
                    parts["prediction"].astype(np.int64)].astype(str)
                if not np.array_equal(got, mapped):
                    raise AssertionError(f"{name}: a scored stage is not "
                                         f"the JAX package's label of its "
                                         f"prediction")
                dix = next(s for s in model.stages if type(s).__name__
                           == "PredictionDeIndexerModel")
                probe = np.array(list(range(len(labels)))
                                 + [len(labels), 1.9999999, -0.6], np.float32)
                want = labels + [unseen, labels[2], unseen]
                col = dix.input_features[1].name
                out = dix.transform(FeatureTable(
                    {col: Column(RealNN, probe, None)}, len(probe))
                    .to_device(model.device))[dix.get_output().name]
                if list(out.values) != want:
                    raise AssertionError(f"{name}: the deindexer on the "
                                         f"card gives {list(out.values)}, "
                                         f"the JAX package's labels "
                                         f"{want}")
                print(f"(t) {name}: every scored stage the JAX package's "
                      f"label of its prediction; the deindexer on the card "
                      f"maps {probe.tolist()} to {want}")
            check(deindexer)
        if task == "binary":
            def insights():
                import copy
                got = insights_by_feature(model.model_insights().to_json())
                # the LR's mean fold metrics against the float64
                # evaluation's, as its folds are held
                ref = copy.deepcopy(self.insights)
                results = ref["modelValidationResults"]
                for r in results:
                    if r["modelType"] == "OpLogisticRegression":
                        r["meanMetrics"] = f64["OpLogisticRegression"].mean(
                            axis=0).tolist()
                want = insights_by_feature(ref)
                base = insight_limits(
                    winner, ref, TITANIC_LIN_COEF_RTOL,
                    WCV_EVAL_ATOL, WCV_COUNT_ATOL, LIN_FOLD_ATOL,
                    WCV_CORR_ATOL)
                lin = dict(LEADS_LIN_F64_ATOL,
                           OpLinearSVC=LEADS_SVC_FOLD_ATOL)

                def limit(path):
                    # a linear configuration's mean fold metric: its
                    # folds' limit
                    if (len(path) == 4 and path[0] ==
                            "modelValidationResults"
                            and path[2] == "meanMetrics"):
                        family = results[int(path[1])]["modelType"]
                        if family in lin:
                            return (0.0, lin[family])
                    return base(path)
                try:
                    gaps = json_gaps(got, want, limit)
                except AssertionError as e:
                    raise AssertionError(f"{name} insights: {e}") from None
                shares = {k: float(f"{v:.3g}")
                          for k, v in sorted(gaps.items())}
                print(f"(t) {name}: model insights of "
                      f"{len(got['features'])} features (maps by key) keys "
                      f"and strings equal, each section's largest gap / its "
                      f"limit: {shares}")
            check(insights)
        check(lambda: save_and_reload(
            name, model, os.path.join(LEADS_ROOT, name, "model"),
            self.score_recs, workflow=wf))
        if faults:
            raise AssertionError(f"{name}: {len(faults)} check(s) failed: "
                                 + "; ".join(faults))
        return secs


def phase_serve():
    """The port's main path: load, score, answer requests, for every
    committed fixture (binary probability_1 within PROB_ATOL; regression
    and multiclass parts within the limits of (t) with identical trees)."""
    import transmogrifai_tpu_torch as tt
    from transmogrifai_tpu_torch.testing import (
        SAVED_KEYS, SERVE_MODELS, score_frame, serve_bench_data,
    )

    frame = score_frame()
    reps = N_ROWS // SCORE_ROWS
    big = {name: np.tile(v, reps) for name, v in frame.items()}
    for key in SAVED_KEYS:
        task = SERVE_MODELS[key][2]
        path = os.path.join(FIXTURES, key)
        model = tt.load_model(path)                # default: the card
        if model.device.type != "cuda":
            raise AssertionError(f"{key} loaded on {model.device}")
        exp = np.load(os.path.join(path, "expected.npz"))
        parts = _parts_of(model, model.score(data=frame))
        margin = task == "binary" and "probability_1" not in exp.files
        if margin:
            # a linear SVC: its margin, rawPrediction_1
            m, pred = parts["rawPrediction_1"], parts["prediction"]
            w = exp["rawPrediction_1"]
            rel = float((np.abs(m - w) / (1 + np.abs(w))).max())
            if m.shape != w.shape or rel > REG_MAX_RTOL:
                raise AssertionError(f"{key}: rawPrediction_1 off by {rel}")
            far = np.abs(w) > REG_MAX_RTOL * (1 + np.abs(w))
            flips = int((pred != exp["prediction"])[far].sum())
            if flips:
                raise AssertionError(f"{key}: {flips} predictions differ")
            held = (f"rawPrediction_1 max |d| / (1 + |m|) {rel:.3g}, 0 "
                    f"prediction flips")
        elif task == "binary":
            p1, pred = parts["probability_1"], parts["prediction"]
            if p1.shape != exp["probability_1"].shape or \
                    not np.isfinite(p1).all():
                raise AssertionError(f"{key}: bad probability_1 {p1.shape}")
            err = float(np.abs(p1 - exp["probability_1"]).max())
            if err > PROB_ATOL:
                raise AssertionError(f"{key}: probability_1 off by {err}")
            far = np.abs(exp["probability_1"] - 0.5) > PRED_MARGIN
            flips = int((pred != exp["prediction"])[far].sum())
            if flips:
                raise AssertionError(f"{key}: {flips} predictions differ")
            held = f"probability_1 max err {err:.3g}, 0 prediction flips"
        else:
            y_std = float(np.std(serve_bench_data(
                TRAIN_ROWS, N_FEATURES, TRAIN_SEED, task)["y"]))
            held = _check_parts(key, task, parts, exp, True, y_std)
        score = model.score_function()
        keys = (["prediction"] if task == "regression" else
                ["rawPrediction_1"] if margin else
                sorted(k for k in exp.files if k.startswith("probability_")))
        for i in range(4):
            out = next(iter(score({
                name: (None if np.isnan(v[i]) else float(v[i]))
                for name, v in frame.items()}).values()))
            for k in keys:
                lim = (REG_MAX_RTOL * (1 + abs(float(exp[k][i])))
                       if task == "regression" or margin else PROB_ATOL
                       if task == "binary" else P1_MAX_ATOL_SAME_TREES)
                if abs(out[k] - exp[k][i]) > lim:
                    raise AssertionError(f"{key}: request {i} scored "
                                         f"{k} {out[k]}")
        _parts_of(model, model.score(data=big))              # warm-up
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            got_big = _parts_of(model, model.score(data=big))
            times.append(time.perf_counter() - t0)
        # the 65,536-row batch against the 4,096-row scores, tiled: a
        # forest adds each row's trees in one order whatever the batch; a
        # linear model's product is one cuBLAS call, whose kernel (and so
        # its order of adds) may change with the row count, so it is held
        # to the limit that holds it against the fixture
        tol = REG_MAX_RTOL if task == "regression" or margin else 0.0
        params = model.stages[-1].fitted.params
        prob_tol = (PROB_ATOL if "edges" in params
                    else _linear_prob_limit(params))
        batch_gap = 0.0
        for k in keys:
            tiled = np.tile(parts[k], reps)
            batch_gap = max(batch_gap, float(np.abs(got_big[k] - tiled).max()))
            if not np.allclose(got_big[k], tiled, rtol=tol,
                               atol=tol or prob_tol):
                raise AssertionError(f"{key}: 65,536-row batch disagrees")
        print(f"(c) {key}: {held}, {N_ROWS / statistics.median(times):.1f} "
              f"rows/sec on {N_ROWS}-row batches (max |d| {batch_gap:.3g} "
              f"from the 4,096-row scores)")


KILLED_SAVE = """
import os, sys
sys.path.insert(0, {here!r})
import transmogrifai_tpu_torch as tt
from transmogrifai_tpu_torch import persistence
second = tt.load_model({second!r}, device="cpu")
real_replace, real_exchange, calls = os.replace, persistence._exchange, [0]
def dying(*a):
    calls[0] += 1
    if calls[0] == 2:
        raise SystemExit("killed at the second os.replace")
    return real_replace(*a)
def dying_exchange(*a):
    raise SystemExit("killed at the directory exchange")
os.replace = dying
try:
    tt.save_model(second, {target!r})
except SystemExit as e:
    print(e)
os.replace = real_replace
persistence._exchange = dying_exchange
try:
    tt.save_model(second, {target!r})
except SystemExit as e:
    print(e)
"""


def phase_killed_save():
    """(s) A save killed mid-way in a child process: the ``gbt`` model's
    save is overwritten by the ``lr`` model's, killed first at the second
    ``os.replace`` (a staged file's rename) and then at the directory
    exchange; the directory still loads as the ``gbt`` model and scores
    its bits, and beside it lies only ``*.tmp`` debris, which
    ``manifest.clean_tmp_debris`` removes."""
    import transmogrifai_tpu_torch as tt
    from transmogrifai_tpu_torch.manifest import clean_tmp_debris
    from transmogrifai_tpu_torch.testing import score_frame
    root = os.path.join(SAVE_DIR, "killed")
    target = os.path.join(root, "model")
    shutil.copytree(os.path.join(SAVE_DIR, "gbt"), target)
    code = KILLED_SAVE.format(here=HERE, second=os.path.join(SAVE_DIR, "lr"),
                              target=target)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    said = res.stdout.split("\n")
    if res.returncode != 0 or not any("second os.replace" in x
                                      for x in said) or not any(
            "exchange" in x for x in said):
        raise AssertionError(f"the killed saves did not run: {res.stdout} "
                             f"{res.stderr[-2000:]}")
    frame = score_frame()
    got = _parts_of(tt.load_model(target), tt.load_model(target).score(
        data=frame))
    first = tt.load_model(os.path.join(SAVE_DIR, "gbt"))
    want = _parts_of(first, first.score(data=frame))
    if not all(np.array_equal(got[k], want[k]) for k in want):
        raise AssertionError("the killed saves changed the previous model")
    debris = sorted(f for f in os.listdir(root) if f != "model")
    if not debris or not all(f.endswith(".tmp") for f in debris) or [
            f for f in os.listdir(target) if f.endswith(".tmp")]:
        raise AssertionError(f"unexpected files after the killed saves: "
                             f"{debris}")
    clean_tmp_debris(root)
    if os.listdir(root) != ["model"]:
        raise AssertionError("clean_tmp_debris left debris")
    print(f"(s) saves killed at the second os.replace and at the directory "
          f"exchange in a child process: the previous gbt model loads and "
          f"scores its bits; {len(debris)} *.tmp debris entr(y/ies) beside "
          f"it, removed by clean_tmp_debris")


def phase_calibrator(dev):
    """(i) ``IsotonicRegressionCalibrator`` fitted on the card to the
    ``mlp`` fixture's probability_1 on the scoring frame against
    ``testing.calibration_labels``: boundaries, values and the calibrated
    column bit-equal to the JAX package's (``calibration.npz``)."""
    from transmogrifai_tpu_torch.features import FeatureBuilder, reset_uids
    from transmogrifai_tpu_torch.impl.regression import (
        IsotonicRegressionCalibrator,
    )
    from transmogrifai_tpu_torch.table import Column, FeatureTable
    from transmogrifai_tpu_torch.testing import (
        CALIBRATED_KEY, calibration_labels,
    )
    from transmogrifai_tpu_torch.types import RealNN
    path = os.path.join(FIXTURES, CALIBRATED_KEY)
    p1 = np.load(os.path.join(path, "expected.npz"))["probability_1"]
    cal = np.load(os.path.join(path, "calibration.npz"))
    reset_uids()
    label = FeatureBuilder.RealNN("label").extract_field().as_response()
    score = FeatureBuilder.RealNN("score").extract_field().as_predictor()
    est = IsotonicRegressionCalibrator()
    out = est.set_input(label, score).get_output()
    table = FeatureTable({
        "label": Column(RealNN, calibration_labels(p1), None),
        "score": Column(RealNN, p1, None)}, len(p1)).to_device(dev)
    t0 = time.perf_counter()
    model = est.fit(table)
    col = model.transform(table)[out.name].values
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if col.device.type != "cuda":
        raise AssertionError(f"calibrated on {col.device}")
    for name, a, b in (("boundaries", model.boundaries, cal["boundaries"]),
                       ("values", model.values, cal["values"]),
                       ("calibrated column", col.cpu().numpy(),
                        cal["calibrated"])):
        if a.dtype != b.dtype or not np.array_equal(
                np.asarray(a).view(np.int32), b.view(np.int32)):
            raise AssertionError(f"calibrator: {name} differ from the JAX "
                                 f"package's")
    print(f"(i) isotonic calibrator on the card, {len(p1)} mlp scores: "
          f"{len(cal['boundaries'])} boundaries and values and the "
          f"calibrated column bit-equal to the JAX package's ({secs:.4f} s)")


def _forest_kernels(model):
    """The forest predict kernel a fitted model's scoring launches."""
    from transmogrifai_tpu_torch.ops import forest as F
    params = model.stages[-1].fitted.params
    return ((F.FOREST_PREDICT_CHAIN,) if "feat_lv" in params else
            (F.FOREST_PREDICT_HEAP,) if "feat" in params else ())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from transmogrifai_tpu_torch.histeng import kernels as HK
    from transmogrifai_tpu_torch.ops import forest as F

    dev = torch.device("cuda", 0)
    # the default-list trains sweep the full default grids
    os.environ["TG_FAST_GRIDS"] = "0"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = HK.KERNELS + F.KERNELS
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    global SAVE_DIR
    SAVE_DIR = os.path.join(tmp, "saved")
    os.makedirs(SAVE_DIR)
    try:
        return _run(dev, kernels, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(dev, kernels, tmp) -> int:
    from transmogrifai_tpu_torch.histeng import kernels as HK
    from transmogrifai_tpu_torch.ops import forest as F
    from transmogrifai_tpu_torch.testing import SERVE_MODELS

    phase_build()
    titanic = Titanic(tmp)
    kern = phase_kernels(dev)
    phase_sweep_inputs()
    titanic_kern = titanic.check_inputs()
    wcv = TitanicWCV(titanic)
    wcv_kern = wcv.check_inputs()
    leads = Leads()
    leads_kern = leads.check_inputs()

    def run_path(name, phase, path_kernels):
        """Zero every count, drive the path, read the counts; each of
        ``path_kernels`` must have launched."""
        for k in kernels:
            k.launches = 0
        phase()
        torch.cuda.synchronize()
        counts = {k.name: k.launches for k in kernels}
        idle = [k.name for k in path_kernels if counts[k.name] == 0]
        if idle:
            raise AssertionError(f"kernel(s) {idle} never launched on the "
                                 f"{name} path")
        return counts

    hist, node = HK.HIST_MATMUL, HK.NODE_HIST
    # the Titanic default list sweeps its tree families as the serve
    # bench's default lists do: node_hist, hist_matmul, chain predicts
    sweep = (hist, node, F.FOREST_PREDICT_CHAIN)
    paths = {"train titanic": run_path("train titanic", titanic.train,
                                       sweep)}
    paths["serve titanic"] = run_path("serve titanic", titanic.serve,
                                      _forest_kernels(titanic.model))
    paths["train titanic_wcv"] = run_path("train titanic_wcv", wcv.train,
                                          sweep)
    print(f"launches, train titanic_wcv: "
          f"{ {k: v for k, v in paths['train titanic_wcv'].items() if v} }")
    # path (a) sweeps its tree families and refits the LR; path (b) grows
    # the RF at k = 4 classes and sums its refit's leaves
    paths["train leads"] = run_path("train leads",
                                    lambda: leads.train("leads"), sweep)
    paths["train leads_stage"] = run_path(
        "train leads_stage", lambda: leads.train("leads_stage"),
        (hist, node, F.FOREST_LEAF_SUMS_CHAIN, F.FOREST_PREDICT_CHAIN))
    for name in ("train leads", "train leads_stage"):
        print(f"launches, {name}: "
              f"{ {k: v for k, v in paths[name].items() if v} }")
    paths.update({
        "train gbt": run_path("train gbt",
                              lambda: train_against_fixture("gbt"),
                              (hist, node, F.FOREST_PREDICT_HEAP)),
        "train gbt12": run_path("train gbt12",
                                lambda: train_against_fixture("gbt12"),
                                (hist, node, F.FOREST_PREDICT_CHAIN)),
        "train rf": run_path("train rf", lambda: train_against_fixture("rf"),
                             (hist, node, F.FOREST_LEAF_SUMS_CHAIN,
                              F.FOREST_PREDICT_CHAIN)),
        "train dt": run_path("train dt", lambda: train_against_fixture("dt"),
                             (hist, node, F.FOREST_LEAF_SUMS_HEAP,
                              F.FOREST_PREDICT_HEAP)),
    })
    for key, path_kernels in (
            ("rfreg", (hist, node, F.FOREST_LEAF_SUMS_CHAIN,
                       F.FOREST_PREDICT_CHAIN)),
            ("gbtreg", (hist, node, F.FOREST_PREDICT_HEAP)),
            ("rfmc", (hist, node, F.FOREST_LEAF_SUMS_CHAIN,
                      F.FOREST_PREDICT_CHAIN)),
            ("xgbmc", (hist, node, F.FOREST_PREDICT_HEAP))):
        paths[f"train {key}"] = run_path(
            f"train {key}", lambda key=key: train_against_fixture(key),
            path_kernels)
    # the linear and GLM fits launch no kernel; a default list also sweeps
    # its tree families, whose growth (node_hist), sample leaves
    # (hist_matmul) and validation predicts launch three: a grid that
    # holds depth 12 re-expresses its depth-3 and 6 heaps as slot chains
    # (trees._fit_depth_grouped), so every sweep predict is a chain one;
    # the refit is linear on these frames
    for key, path_kernels in (
            ("lr", ()), ("svc", ()), ("lrmc", ()), ("nbmc", ()),
            ("linreg", ()), ("glm", ()), ("default_binary", sweep),
            ("default_mc", sweep), ("default_reg", sweep), ("mlp", ()),
            ("mlpmc", ())):
        paths[f"train {key}"] = run_path(
            f"train {key}", lambda key=key: train_against_fixture(key),
            path_kernels)
    phase_killed_save()
    phase_calibrator(dev)
    for key in ("gbt", "gbt12", "gbtreg", "xgbmc"):
        counts = paths[f"train {key}"]
        rounds = SERVE_MODELS[key][1]["maxIter"]
        levels = SERVE_MODELS[key][1]["maxDepth"]
        if counts["hist_matmul"] < rounds:
            raise AssertionError(f"hist_matmul launched "
                                 f"{counts['hist_matmul']} times in {key} "
                                 f"training, fewer than the boosting rounds")
        if counts["node_hist"] < rounds * levels:
            raise AssertionError(f"node_hist launched {counts['node_hist']} "
                                 f"times in {key} training, fewer than its "
                                 f"refit's rounds x levels")
    paths["serve"] = run_path("serve", phase_serve,
                              (F.FOREST_PREDICT_HEAP, F.FOREST_PREDICT_CHAIN))
    for name, counts in paths.items():
        print(f"launches, {name}: "
              f"{ {k: v for k, v in counts.items() if v} }")
    for name, r in titanic_kern.items():
        print(json.dumps({"titanic_kernel": name, "shape": str(r["shape"]),
                          "ms": r["ms"], "plain_ms": r["plain_ms"],
                          "library_ms": r["library_ms"],
                          "passes": r["passes"],
                          "bound_ms": r["bound"][0],
                          "bound_by": r["bound"][1],
                          "launches_per_train":
                              paths["train titanic"][name]}))
    for name, r in wcv_kern.items():
        print(json.dumps({"titanic_wcv_kernel": name,
                          "shape": str(r["shape"]), "ms": r["ms"],
                          "plain_ms": r["plain_ms"],
                          "library_ms": r["library_ms"],
                          "passes": r["passes"], "bound_ms": r["bound"][0],
                          "bound_by": r["bound"][1],
                          "launches_per_train":
                              paths["train titanic_wcv"][name]}))
    for path, kern_of in leads_kern.items():
        for name, r in kern_of.items():
            print(json.dumps({f"{path}_kernel": name,
                              "shape": str(r["shape"]), "ms": r["ms"],
                              "plain_ms": r["plain_ms"],
                              "library_ms": r["library_ms"],
                              "passes": r["passes"],
                              "bound_ms": r["bound"][0],
                              "bound_by": r["bound"][1],
                              "launches_per_train":
                                  paths[f"train {path}"][name]}))
    print(json.dumps({"save_load_s": {
        k: {"save": v[0], "load": v[1]} for k, v in SAVE_LOAD_S.items()}}))
    launches = {k.name: sum(c[k.name] for c in paths.values())
                for k in kernels}
    print(json.dumps({"kernels": [{
        "name": k.name, "route": "cuda",
        "source": "transmogrifai_tpu_torch/csrc/" + k.source,
        "replaces": k.replaces, "launches": launches[k.name],
        "max_abs_err": kern[k.name]["max_abs_err"],
        "ms": kern[k.name]["ms"], "plain_ms": kern[k.name]["plain_ms"],
        "bound_ms": kern[k.name]["bound"][0],
        "bound_by": kern[k.name]["bound"][1],
        "library_ms": kern[k.name].get("library_ms")} for k in kernels]}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
