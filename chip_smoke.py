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
    below; ``node_hist`` to its direct formula only at its heaviest
    shape, the RF sweep's first level: ``DIRECT_HELD_ELSEWHERE``)
    and time each kernel's heaviest launch there; then the counted
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
    to its direct formula only at its heaviest shape, the RF sweep's first
    level: ``DIRECT_HELD_ELSEWHERE``), and times each
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
    runs once with every launch of the four kernels it runs held to plain
    (``node_hist`` also to its direct formula at the first launch of each
    (codes width, T) class);
    their heaviest launches give the ``leads_kernel`` and
    ``leads_stage_kernel`` lines. "train leads" must launch
    ``hist_matmul``, ``node_hist`` and ``forest_predict_chain``, "train
    leads_stage" those and ``forest_leaf_sums_chain``;
(w) the NLP stages' device arithmetic (``phase_nlp_device``): the ordered
    scatter twice at word2vec's shapes, both runs the same bits and those
    of numpy's in-order ``np.add.at``; 40 SGNS steps, two LDA sweeps and
    the written-out digamma and sigmoid bit-equal to the CPU;
(tickets) the support-ticket path (``testing.tickets_records``: 20,000
    training and 2,000 scoring records rebuilt from their seeds, sha256
    equal to the fixture's; ``testing.tickets_dag``): stemmed tokens, stop
    words, IDF-weighed counts, bigram counts, word2vec and LDA fitted on
    the card, the language, entity, MIME, phone, email and URL parsers
    and the text similarities through ``transmogrify``, SanityChecker,
    the binary default list at full default grids. Before the counted
    paths one train with every launch of the three sweep kernels held to
    plain (``node_hist`` to its direct formula only at its heaviest
    shape: ``DIRECT_HELD_ELSEWHERE``; ``tickets_kernel``
    lines). "train tickets" against
    ``fixtures/tickets``: every vector block's sha256 the fixture's
    (word2vec and LDA included), the vector's metadata and 256 sampled
    rows, the SanityChecker's choices, the winner and its grid point,
    fold metrics as the default lists' (trees 1e-5, the SVC
    ``LIN_FOLD_ATOL``) but the LR's ``TICKETS_LR_FOLD_ATOL`` (its float32
    order noise; the cause at the constant), both linear sweeps' gaps to a
    float64 evaluation printed, the refit's scores (a linear winner's
    params and probability_1 ``TITANIC_LIN_*``, a tree winner's
    probability_1 ``PROB_ATOL``), a save and reload; it must launch ``hist_matmul``,
    ``node_hist`` and ``forest_predict_chain``. "serve tickets": the
    reload scores the 2,000 scoring tickets bit-equal to the trained
    model and answers 64 ``score_function`` requests;
(events) the customer-event path (``testing.events_files``: ~240,000
    events of 20,000 users and a users file, and a scoring cohort of
    4,096 users, written from their seeds, sha256 equal to the
    fixture's; ``testing.events_dag``): the events aggregated per user at
    a cutoff (``AggregateDataReader``) and joined to the users
    (``JoinedDataReader``), the mean fills, z-score, fixed and
    label-driven bucketizers (a map's per key) and the percentile
    calibrator, ``transmogrify``, SanityChecker and the binary selector
    over the serve bench's GBT and RF with 3-fold CV. Before the counted
    paths one train and LOCO of its winner with every launch of the
    sweep and predict kernels held to plain (``events_kernel`` lines).
    "train events" through ``OpWorkflowRunner``: train (the model
    saved), score (.avro), evaluate, features (Parquet) and an ``OpApp``
    score, against ``fixtures/events``: the raw table's digest (keys,
    order, values, nulls), every block's sha256, the vector's metadata
    and 256 sampled rows, the fitted host stages, the SanityChecker's
    choices, the winner, fold metrics within 1e-5, the refit's
    probabilities as the other tree paths' (``_check_parts``) and the
    sampled users' written records; it must launch ``hist_matmul``,
    ``node_hist`` and both forest predicts. "serve events": the JAX-saved
    model on the card scores the cohort within ``PROB_ATOL``, its LOCO
    within ``EVENTS_LOCO_ATOL`` of the fixture's diffs with equal maps, 64
    users through LOCO's row dual; the trained model's LOCO and Corr
    timed;
(stream) the out-of-core streamed train (``OpWorkflow.train(stream=)``,
    ``streaming``). "train stream": ``SyntheticChunkSource(1,000,000, 64,
    chunk_rows=65,536, seed=0)`` (16 chunks) through ``transmogrify``,
    ``SanityChecker(seed=1)`` and ``StreamingGBT(2 trees, depth 3, 32
    bins, learning rate 1)`` with 4 workers, prefetch 4 and the chunk
    cache sized to hold every transformed chunk: each chunk uploaded from
    pinned memory on the feed's own CUDA stream and transformed on the
    card, the folds float64 on the host; against ``fixtures/stream`` (the
    JAX package's train of the same seeds): the fills, the trees and f0
    and probability_1 at 4,096 rows of chunk 0 bit-equal, the
    SanityChecker's choices equal (numbers in a reason within 1e-12); the
    wall seconds, rows/s, ``summary()["streaming"]`` and the peak device
    memory printed; at most prefetch + 1 chunks and (prefetch + 1) x
    ``maxChunkBytes`` resident (the bench's bound of a quarter of the raw
    values applies only when the values are at least 40 chunks' bytes,
    and here they are not), cache hits. "resume stream": the pressure
    stream (``testing.pressure_table``, 200,000 x 8 in chunks of 25,000,
    1 tree of depth 3, 16 bins) killed at half of its folds
    (``stream.fold``) under a checkpoint directory and resumed to the
    uninterrupted trees with no feed left open; a train under
    ``oom.stream`` (chunks halved to 12,500) killed while the halved grid
    folds and resumed to that train's trees, the restored record carrying
    the halved ``chunkRows``; then the serial (1 worker, prefetch 1, no
    cache), parallel (4 workers, prefetch 4, no cache) and cached arms
    scoring byte-equal. Neither path launches a kernel of the port;
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
      the same codes, ``node_hist`` bit-equal to its direct formula at
      each shape's first launch, chain predicts bit-equal with leaf ids
      exact;
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
(serving) the serving runtime on the card (``Serving``): a cold and a warm
    start of a copy of ``serve64/gbt`` each in a fresh process
    (``registry.load`` then the first request; the warm one's first
    request must record no compile-ledger build, and both must score it
    alike); copies of ``serve64/gbt`` (depth-6 heaps), ``rf`` (depth-12
    slot chains) and ``xgbmc`` (600 heap trees, 6 classes) loaded through
    ``ModelRegistry.load`` (warm) on the card: warm reports ok with the
    fixtures' fingerprints, no build on the first request, the committed
    files byte-unchanged. Every ``forest_predict_heap`` and
    ``forest_predict_chain`` launch from the loads to the drift refit is
    held bit-equal to plain (``_KernelChecks`` without the second launch
    that reads leaf ids; the open loop's launches after it ran, on copies
    taken on the launching stream), and the launches held must equal the
    launches counted. The 4,096 rows of ``testing.score_frame()`` as
    requests at pipeline depth 1 and 2 (``max_batch`` 256, ``max_wait_ms``
    2; a staged 37-row flush and a 1-row flush first): records bit-equal
    across depths and to ``micro_batch_score_function``, the fixture's
    parts within (c)'s limits. Chaos on ``gbt``: ``serve.dispatch`` until
    the breaker opens and its half-open probe closes it, ``oom.serve``
    halving a 256-row flush down to a singleton, ``serve.complete`` at
    depth 2: every record the clean run's. The open loop on ``gbt`` at
    0.7x and 2x the runtime's calibrated capacity (``bench.py``'s serve
    line): no lost or failed request, every refusal a typed shed
    (``open_loop`` lines: rows/s, p50/p95/p99, the shed rate,
    ``tg_serve_stage_seconds`` by stage, peak allocated memory). (t)'s GBT
    saved by the port (``serving`` and ``drift`` sections, the fixture's
    fingerprint) and served with its workflow's ``drift_refit_hook``:
    2,048 in-distribution requests leave the verdict ok, 2,048 with x0..x7
    shifted by 3 training sd degrade it (``DRIFT_CONFIG``), the hook
    refits on the card and the registry hot-swaps while requests flow;
    none is refused, fails or is shed. Both predicts must launch. Past the
    counted path: ``serving_kernel`` lines time each model's 256-row flush
    against plain and the bound; the stages alone on one thread
    (``serving_stage_ms``) and once under
    ``torch.cuda.set_sync_debug_mode("warn")`` (``serving_syncs``: each
    synchronizing call by the port's file and line); ``lr`` and ``svc`` at
    flush sizes 1, 37 and 256 (``linear_flush`` lines: the gap, held to
    (c)'s limits);
(fleet) the fleet tier on the card (``Fleet``): fresh copies of
    ``serve64/{gbt,rf,xgbmc}``, the 4,096 rows of ``score_frame()`` as
    requests, replicas on ``cuda:0`` (``max_batch`` 256, ``max_wait_ms``
    2, pipeline depth 2), as ``bench.py``'s fleet and wire lines. A
    ``FrontDoor`` over 1, then 2 in-process replicas serving ``gbt`` and
    ``rf`` warm: records bit-equal to ``micro_batch_score_function`` on
    the card, then a saturated open loop of ``FLEET_OPEN_LOOP_S`` each
    (``fleet_replicas`` lines: rows/s, p50/p99) and the 2-vs-1 factor (a
    reading, no gate). Two replicas under an open loop at 0.8x the one
    replica's rows/s with r0 killed halfway: zero lost, zero failed,
    every completed record the clean one's, a ``replica_lost``
    post-mortem that validates. ``gbt``, ``rf`` and ``xgbmc`` on two
    replicas with ``PlaceConfig(max_warm=1)`` under a weighted model mix:
    page-ins and evictions happen, records bit-equal, zero lost, page-in
    seconds p50 and max. A ``NetEdge`` on 127.0.0.1 in front of two
    replicas: 256 rows over HTTP/JSON and 256 over ``TGB1`` bit-equal to
    in-process, ``run_wire_open_loop`` per framing at 0.35x the one
    replica's rows/s (32-row requests) beside the in-process loop at the
    same rate (``fleet_wire`` lines), then ``net.read``/``net.write``
    drops with reconnects: every drop in ``shedDisconnect``. One
    ``SubprocessReplica`` (``--device cuda:0``) beside one in-process
    replica: its records bit-equal to the in-process replica's, then
    SIGKILLed with requests in flight: failover, zero lost; its
    spawn-to-ready seconds, its ``torch.cuda.max_memory_allocated`` and
    its own kernel launches (``fleet_subprocess`` line). Every predict
    launch in the parent outside the timed loops is held bit-equal to
    plain; inside them one in ``FLEET_HOLD_EVERY``, on copies taken on
    the launching stream, held after the loop. Both predicts must launch;
(resume) the checkpointed in-core train of ``default_binary`` (20,000 x
    64, full default grids) killed and resumed on the card (``Resume``),
    every stage uid from ``reset_uids`` as the JAX package's; each arm is
    held to the unkilled checkpointed run (selection exact; refit params
    and the 4,096 scores of ``score_frame()`` bit-equal): (a) that run,
    bit-equal to (t)'s uncheckpointed ``default_binary``; (b) killed at
    ``preempt.sweep`` after LR's records, resumed: RF, GBT and SVC sweep
    and ``node_hist``, ``hist_matmul`` and ``forest_predict_chain``
    launch; (c) killed at ``preempt.refit``: every family and both
    upstream stages restore, and the resume launches no histogram
    kernel; (d) killed at ``preempt.stage_fit`` (nth 2) and
    ``preempt.checkpoint_write`` (nth 1); (e) ``oom.sweep`` on the RF
    halves its grid and a real ``torch.cuda.OutOfMemoryError`` raised
    once from its fit halves a half again: the RF's fold metrics
    bit-equal to the unsplit sweep's; (f) ``fixtures/resume/default_binary``
    (the JAX package's directory of this train killed at the refit)
    resumes: every family restored, the JAX package's selection, the
    refit's params and scores bit-equal to (a)'s; (g) a seeded
    ``ChaosCampaign`` on the card (coverage singletons for every site but
    ``WAITING_SITES``, then 4 random schedules): zero violations, 100%
    coverage, no lost or failed request, the accounting identity (a
    ``campaign`` line); (h) the runner's train with
    ``log_stage_metrics``: ``appMetrics.byStage`` names every fitted
    stage and ``compileCache.builds`` is the ledger's count. One line an
    arm with its seconds and restored counts, then each path's launches;
(parquet) after "serve titanic" (``Parquet``): the three files of
    ``fixtures/parquet`` read by the port's ``utils.parquet`` as pandas
    read them (the leads features file's structs, lists and dates whole;
    the Titanic files' per-column digests), and the raw Titanic table of
    the committed scoring file bit-equal to the CSV reader's of the
    rebuilt one; the port writes the 20,000-row training frame to Parquet
    and the Titanic workflow trains through ``OpWorkflowRunner`` with
    ``DataReaders.Simple.parquet``: the winner, every family's fold
    metrics and the LR refit's params bit-equal to the (titanic) CSV
    train of this call, launching ``node_hist``, ``hist_matmul`` and
    ``forest_predict_chain``; a score run of the JAX-saved Titanic model
    over the committed file writes ``.parquet``, read back equal to the
    returned scores, probability_1 within ``PARQUET_PROB_ATOL`` of the
    JAX package's score file with keys equal (``parquet_host_s``:
    the host's read and write seconds);
(cli) after (fleet) (``Cli``): the command line as a user runs it
    (``cli.main``) on copies of ``serve64/gbt``: ``serve`` for
    ``CLI_SECONDS`` at ``CLI_RPS`` with ``--output``, ``serve --listen
    127.0.0.1:0``, ``slo``, ``fleet --replicas 2 --kill``: each loses and
    fails nothing and launches ``forest_predict_heap``; ``trace --rows
    600`` with its four files; ``doctor`` on the kill's post-mortem;
    ``gen`` on the Titanic training file (a header added) with an answers
    file, the generated app trained in one subprocess on the card with
    ``TG_FAST_GRIDS=1`` (``cli_s``: each step's seconds; ``phase_s``:
    both phases' seconds);
(plan) after (cli) (``PlanPhase``): the transform-plan compiler on the
    card, which every phase above already runs through (its train
    layers, batch scores and serving flushes; one CUDA graph per
    segment and padding bucket: a bucket's first dispatch runs eagerly
    on the capture stream, its second captures the graph and replays
    it, later ones replay it). The counted path:
    ``serve64/{gbt,gbt12,rf,xgbmc,lr}`` through
    ``micro_batch_score_function`` at 1, 37, 256 and 300 requests and
    back, and ``score`` of the 4,096 rows of ``score_frame()`` twice,
    planned against ``enable_planning(False)``: tree records bit-equal,
    the LR's within ``PLAN_LINEAR_ATOL`` (``plan_model`` lines: each
    plan's segments, buckets, capture seconds and replays); (titanic)'s
    model on the scoring file, planned against eager, with
    ``tg_dispatch_total`` at least ``PLAN_DISPATCH_FACTOR`` times lower
    planned (``plan_titanic`` line); no ``plan_fallback`` on these; the
    drills:
    ``plan.segment_execute`` armed once gives one ``plan_fallback`` and
    ``oom.plan`` at ``PLAN_OOM_ROWS`` rows one ``oom_downshift``, records
    bit-equal to the clean run's. Past the counted path: fresh plans of
    the four tree models with both predicts wrapped, every launch a
    replay runs held to plain after the replay (sums bit-equal, leaf ids
    exact), the launches held equal to the replays' and the first
    dispatches'; a 256-row flush's dispatch ms planned and eager in turns
    (``plan_flush_dispatch_ms_256``); then, in turns planned and eager,
    the Titanic train (its records bit-equal across the arms) and the
    65,536-row score's first and second call from an empty plan cache,
    each with its peak device memory and the memory it leaves allocated
    (``plan_titanic_turns``);
(d) print each path's launch counts and the ``kernels`` JSON line, whose
    launches are the sums over the paths (a replay counts the launches
    its graph recorded);
(e) print the card's name and power limit.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the package beside it, the script fails before printing it.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np
import torch

# the histogram kernels' main-path shapes, input builders, bounds and
# timers: one definition, shared with the per-pass profiler
from transmogrifai_tpu_torch import profile_hist as PH
from transmogrifai_tpu_torch.profile_hist import bound_ms, time_ms
from transmogrifai_tpu_torch.device import synced_clock
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
#: {key: model} of the (t) trains the (serving) phase reuses
TRAINED = {}

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


#: the Titanic, titanic_wcv and tickets check trains hold every
#: ``node_hist`` launch to plain but not each shape's first launch to the
#: direct formula: the leads check train does that for its sweep shapes
#: (8,192 rows x 589 four-byte codes, T 288). Each of the three holds its
#: heaviest shape to it once (``_KernelChecks.hold_heaviest_direct``; the
#: RF sweep's first level: 529 codes at T 288 for the Titanic, at T 96
#: for titanic_wcv, 574 at T 288 for tickets; 0.8 s for titanic_wcv's).
#: Their lighter shapes are held to plain only. The formula took about 60% of the
#: Titanic train's check, 37-41 s of the tickets train's and 16 s of
#: titanic_wcv's (``python3 -m
#: transmogrifai_tpu_torch.experiments.smoke_phases direct-cost[:TRAIN]``,
#: PERF.md section 6): the room for the (fleet), (resume), (parquet) and
#: (cli) phases.
DIRECT_HELD_ELSEWHERE = ("leads",)
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
    """``hist_matmul``, ``node_hist``, ``forest_predict_chain``,
    ``forest_predict_heap`` and ``forest_leaf_sums_chain`` wrapped for the
    duration of a ``with`` block: every launch is held against the plain
    version on its own inputs (histograms and leaf sums within the sum
    bound of ``_within_sum_bound``, ``hist_matmul`` also bit-equal to plain
    on small integer stats of the same codes, ``node_hist`` bit-equal to
    its direct formula, chain and heap predicts bit-equal with leaf ids
    exact, leaf sums
    bit-equal to their own order spelled out on the CPU). ``seen`` counts
    the calls, shapes, largest gap and bound share per kernel; with
    ``keep_heaviest`` the inputs of each kernel's heaviest launch are kept
    for timing (``heaviest``). With ``direct_per_shape`` only the first
    ``node_hist`` launch of each shape is also held to the direct formula
    (at ~530 codes the formula's indexed adds take seconds a launch; every
    launch is still held to plain); with ``direct`` False no launch is
    (``DIRECT_HELD_ELSEWHERE``). These launches are not counted: every
    count is zeroed before each path. ``only`` names the kernels to wrap
    (all five by default); ``held`` counts the launches held per kernel,
    over threads. A predict launch recorded into a CUDA graph (a planned
    segment being captured) is held after each replay of the graph, on
    its static buffers (``cuda_build.after_replay``). With
    ``direct_per_class`` the direct formula holds one launch of each
    (codes width, T) class. While ``defer`` is set a predict launch's sums and codes
    are copied on the launching stream and held to plain at ``settle()``,
    so a timed run carries no plain work; then only one predict launch in
    ``every`` is kept (``skipped`` counts the others per kernel)."""

    def __init__(self, keep_heaviest: bool = False,
                 direct_per_shape: bool = False, check_ids: bool = True,
                 only=None, direct: bool = True,
                 direct_per_class: bool = False):
        self.seen: dict = {}
        #: False: the predicts' sums are held to plain without the second
        #: launch that reads the leaf ids, so the counts stay those of the
        #: main path (the serving phase)
        self.check_ids = check_ids
        self.only = only
        self.held: dict = {}
        self.defer = False
        self.every = 1
        self.skipped: dict = {}
        self._deferred_seen = 0
        self.pending: list = []
        self._lock = threading.Lock()
        self.heaviest: dict = {}
        self.keep = keep_heaviest
        self.direct_per_shape = direct_per_shape
        #: with ``direct_per_shape``: one launch of each (codes width, T)
        #: class, not of each whole shape
        self.direct_per_class = direct_per_class
        self.direct = direct
        self.direct_shapes: set = set()
        #: shapes whose direct formula is beyond DIRECT_MAX_BYTES
        self.too_wide: set = set()

    def _note(self, name, shape, err=0.0, share=0.0, work=0, args=None):
        with self._lock:
            self.held[name] = self.held.get(name, 0) + 1
            r = self.seen.setdefault(name, dict(calls=0, shapes=set(),
                                                err=0.0, share=0.0))
            r["calls"] += 1
            r["shapes"].add(shape)
            r["err"], r["share"] = max(r["err"], err), max(r["share"], share)
            if self.keep and work > self.heaviest.get(name, (0,))[0]:
                self.heaviest[name] = (work, shape, args())

    def _hold(self, check, out, codes, name) -> bool:
        """Run ``check(sums, codes)`` now, or at ``settle()`` on copies
        taken on the launching stream while ``defer`` is set (one launch
        in ``every``). False when the launch was sampled out."""
        if not self.defer:
            check(out, codes)
            return True
        with self._lock:
            self._deferred_seen += 1
            if self._deferred_seen % self.every:
                self.skipped[name] = self.skipped.get(name, 0) + 1
                return False
        out, codes = out.clone(), codes.clone()
        with self._lock:
            self.pending.append((check, out, codes))
        return True

    def settle(self) -> int:
        """Hold every deferred launch to plain; returns how many."""
        torch.cuda.synchronize()
        with self._lock:
            pending, self.pending = self.pending, []
        for check, out, codes in pending:
            check(out, codes)
        return len(pending)

    def __enter__(self):
        from transmogrifai_tpu_torch.histeng import kernels as HK
        from transmogrifai_tpu_torch.ops import cuda_build as CB
        from transmogrifai_tpu_torch.ops import forest as F

        hist_cuda, node_cuda = HK.hist_matmul_cuda, HK.node_hist_cuda
        chain_cuda = F.forest_predict_chain_cuda
        sums_cuda = F.forest_leaf_sums_chain_cuda
        heap_cuda = F.forest_predict_heap_cuda
        self._saved = (hist_cuda, node_cuda, chain_cuda, sums_cuda,
                       heap_cuda)
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
            key = ((codes.shape[1], node.shape[1]) if self.direct_per_class
                   else shape)
            if self.direct and not (self.direct_per_shape
                                    and key in self.direct_shapes):
                self.direct_shapes.add(key)
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

            def check(sums, codes):
                want = F.forest_predict_chain_plain(
                    codes, feat_lv, bin_lv, base_lv, leaf, n_bins=n_bins)
                if not torch.equal(sums, want):
                    raise AssertionError("forest_predict_chain (sweep): "
                                         "sums differ from the plain "
                                         "version's bits")
                if self.check_ids and not torch.equal(chain_cuda(
                        codes, feat_lv, bin_lv, base_lv, leaf,
                        n_bins=n_bins, with_ids=True)[1],
                        F.route_codes_chain(codes, feat_lv, bin_lv,
                                            base_lv, n_bins)):
                    raise AssertionError("forest_predict_chain (sweep): "
                                         "leaf ids differ from the plain "
                                         "routing")
            def hold():
                if not self._hold(check, out[0], codes,
                                  "forest_predict_chain"):
                    return
                note("forest_predict_chain", (tuple(codes.shape),
                                              tuple(feat_lv.shape),
                                              leaf.shape[2]), 0.0, 0.0,
                     codes.shape[0] * feat_lv.shape[0] * feat_lv.shape[1],
                     lambda: (codes.clone(), feat_lv.clone(),
                              bin_lv.clone(), base_lv.clone(), leaf.clone(),
                              n_bins))
            # a launch recorded into a CUDA graph (a planned segment) is
            # held after each replay that runs it, on its static buffers;
            # no rows, no launch (a plan's zero-row probe)
            if codes.shape[0] and not CB.after_replay(hold):
                hold()
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

        def heap(codes, feat_heap, bin_heap, leaf, *, depth, n_bins,
                 with_ids=False):
            out = heap_cuda(codes, feat_heap, bin_heap, leaf, depth=depth,
                            n_bins=n_bins, with_ids=with_ids)

            def check(sums, codes):
                want = F.forest_predict_plain(codes, feat_heap, bin_heap,
                                              leaf, depth=depth,
                                              n_bins=n_bins)
                if not torch.equal(sums, want):
                    raise AssertionError("forest_predict_heap (sweep): sums "
                                         "differ from the plain version's "
                                         "bits")
                if self.check_ids and not torch.equal(heap_cuda(
                        codes, feat_heap, bin_heap, leaf, depth=depth,
                        n_bins=n_bins, with_ids=True)[1].long(),
                        F.route_codes(codes, feat_heap, bin_heap, depth,
                                      n_bins).long()):
                    raise AssertionError("forest_predict_heap (sweep): leaf "
                                         "ids differ from the plain routing")
            def hold():
                if not self._hold(check, out[0], codes,
                                  "forest_predict_heap"):
                    return
                note("forest_predict_heap", (tuple(codes.shape),
                                             tuple(feat_heap.shape), depth,
                                             leaf.shape[2]), 0.0, 0.0,
                     codes.shape[0] * feat_heap.shape[0] * depth,
                     lambda: (codes.clone(), feat_heap.clone(),
                              bin_heap.clone(), leaf.clone(), depth,
                              n_bins))
            if codes.shape[0] and not CB.after_replay(hold):
                hold()
            return out

        for mod, name, fn in (
                (HK, "hist_matmul", hist), (HK, "node_hist", node),
                (F, "forest_predict_chain", chain),
                (F, "forest_leaf_sums_chain", sums),
                (F, "forest_predict_heap", heap)):
            if self.only is None or name in self.only:
                setattr(mod, f"{name}_cuda", fn)
        return self

    def __exit__(self, *exc):
        from transmogrifai_tpu_torch.histeng import kernels as HK
        from transmogrifai_tpu_torch.ops import forest as F
        HK.hist_matmul_cuda, HK.node_hist_cuda, \
            F.forest_predict_chain_cuda, \
            F.forest_leaf_sums_chain_cuda, \
            F.forest_predict_heap_cuda = self._saved
        return False

    def hold_heaviest_direct(self, tag: str) -> None:
        """Hold ``node_hist`` at the heaviest launch's shape (kept with
        ``keep_heaviest``) to the direct formula: the kernel run again on
        the kept inputs, bit-equal. For a check train whose launches are
        not held to the formula one by one (``direct`` False)."""
        from transmogrifai_tpu_torch.histeng import kernels as HK
        t0 = time.perf_counter()
        _, shape, (codes, node, sw_list, Wl, n_bins, stride) = \
            self.heaviest["node_hist"]
        got = HK.node_hist_cuda(codes, node, sw_list, Wl, n_bins, stride)
        direct = _node_direct(codes, node, sw_list, Wl, n_bins, stride)
        if direct is None:
            raise AssertionError(f"{tag}: node_hist's heaviest shape {shape}"
                                 f" is beyond DIRECT_MAX_BYTES")
        if not torch.equal(got.reshape(-1, got.shape[-2] * got.shape[-1]),
                           direct):
            raise AssertionError(f"{tag}: node_hist at its heaviest shape "
                                 f"{shape} differs from the direct formula")
        self.direct_shapes.add(shape)
        print(f"(b) {tag}: node_hist at its heaviest shape {shape} "
              f"bit-equal to the direct formula (held in "
              f"{time.perf_counter() - t0:.3f} s)")

    def report(self, tag: str, names=("hist_matmul", "node_hist",
                                      "forest_predict_chain")) -> None:
        """Print what was held; every kernel of ``names`` must have
        launched."""
        for name in names:
            r = self.seen.get(name)
            if not r:
                raise AssertionError(f"{tag}: the train launched no {name}")
            held = ("bit-equal to plain, ids exact"
                    if name in ("forest_predict_chain",
                                "forest_predict_heap") else
                    f"max |d| {r['err']:.3g} from plain, "
                    f"{r['share']:.3f} of the sum bound; bit-equal to the "
                    f"chunked order"
                    if name == "forest_leaf_sums_chain" else
                    f"max |d| {r['err']:.3g} from plain, "
                    f"{r['share']:.3f} of the sum bound; " + (
                        ("bit-equal to the direct formula"
                         + (" (each (codes width, T) class's first launch)"
                            if self.direct_per_class else
                            " (each shape's first launch)"
                            if self.direct_per_shape else "")
                         + (f" but at {len(self.too_wide)} shapes beyond "
                            f"DIRECT_MAX_BYTES" if self.too_wide else "")
                         if self.direct else
                         "bit-equal to the direct formula at the heaviest "
                         f"launch's shape {next(iter(self.direct_shapes))}"
                         if self.direct_shapes else "not held to the direct "
                         "formula here (DIRECT_HELD_ELSEWHERE)")
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
    inputs, each ``node_hist`` shape's first launch also against its
    direct formula; the chain predicts include the sweep's depth-3 and 6
    heaps turned into padded depth-12 chains."""
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
        with _KernelChecks(direct_per_shape=True) as checks:
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
    if key in (DRIFT_KEY, "default_binary"):
        # the (serving) phase's drift model; (resume)'s uncheckpointed run
        TRAINED[key] = model
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


def _predict_times(name: str, a) -> dict:
    """``forest_predict_chain`` or ``forest_predict_heap`` at the launch
    arguments ``a`` (as ``_KernelChecks`` keeps them): the kernel's and
    the plain version's wall ms and the bound. The bound counts the codes
    the paths split on, the tables' used slots and the leaves read once
    and the sums written once; per row and tree one step a level and one
    add a column."""
    from transmogrifai_tpu_torch.ops import forest as F
    if name == "forest_predict_chain":
        codes, feat, bins, base, leaf, nb = a
        T, depth, W = feat.shape
        slots = sum(min(2 ** lv, W) for lv in range(depth))
        k = leaf.shape[2]
        nbytes = 4 * (_codes_read(codes, feat, bins, base=base)
                      + T * slots * 3 + leaf.numel() + codes.shape[0] * k)
        return dict(
            ms=time_ms(lambda: F.forest_predict_chain_cuda(
                codes, feat, bins, base, leaf, n_bins=nb)), passes=None,
            plain_ms=time_ms(lambda: F.forest_predict_chain_plain(
                codes, feat, bins, base, leaf, n_bins=nb), runs=5),
            library_ms=None,
            bound=bound_ms(nbytes, codes.shape[0] * T * (depth + k)))
    codes, feat, bins, leaf, depth, nb = a
    T, L, k = leaf.shape
    return dict(
        ms=time_ms(lambda: F.forest_predict_heap_cuda(
            codes, feat, bins, leaf, depth=depth, n_bins=nb)),
        passes=None,
        plain_ms=time_ms(lambda: F.forest_predict_plain(
            codes, feat, bins, leaf, depth=depth, n_bins=nb), runs=5),
        library_ms=None,
        bound=bound_ms(4 * (_codes_read(codes, feat, bins, depth=depth)
                            + T * (L - 1) * 2 + leaf.numel()
                            + codes.shape[0] * k),
                       codes.shape[0] * T * (depth + k)))


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
    out["forest_predict_chain"] = dict(
        _predict_times("forest_predict_chain", a), shape=shape)
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
    if "forest_predict_heap" in heaviest:
        _, shape, a = heaviest["forest_predict_heap"]
        out["forest_predict_heap"] = dict(
            _predict_times("forest_predict_heap", a), shape=shape)
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
        with _KernelChecks(keep_heaviest=True, direct_per_shape=True,
                           direct=False) as checks:
            wf.train()
            torch.cuda.synchronize()
        checks.hold_heaviest_direct("titanic")
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
        with _KernelChecks(keep_heaviest=True, direct_per_shape=True,
                           direct=False) as checks:
            wf.train()
            torch.cuda.synchronize()
        checks.hold_heaviest_direct("titanic_wcv")
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
            with _KernelChecks(keep_heaviest=True, direct_per_shape=True,
                               direct_per_class=True) as checks:
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


TICKETS_DIR = os.path.join(HERE, "transmogrifai_tpu_torch", "fixtures",
                           "tickets")
#: the word2vec and LDA blocks: bit-equal to the fixture's (the card runs
#: the XLA CPU arithmetic the port writes out: ``xla_digamma``,
#: ``xla_exp``, ``xla_sigmoid``, fused multiply-adds in XLA's order,
#: ``xla_sum`` and the ordered scatter); on a difference the largest gap
#: is printed and the phase fails
TICKETS_DEVICE_BLOCKS = ("word2vec", "lda")
#: the LR sweep's fold metrics against the fixture's: the sweep's float32
#: order noise at 18,000 rows x 574 columns. Measured by
#: ``experiments/leads_linear.py --path tickets`` on an NVIDIA H100 80GB
#: HBM3 at 700 W: the card lies 2.53e-4 AuPR from the fixture, the same
#: sweep under three column orders 1.0e-4-2.89e-4, on the CPU 1.55e-4,
#: without its bf16 rounding 3.09e-4; the float64 evaluation lies 4.12e-4
#: from the card and 1.88e-4 from the fixture (the JAX package's sweep did
#: not diverge here, unlike leads'). Twice the largest order-only reading.
#: The SVC is held at ``LIN_FOLD_ATOL`` (readings 0.5-2.3e-5)
TICKETS_LR_FOLD_ATOL = 6e-4


def _block_sha(vals) -> str:
    import hashlib
    a = vals.detach().cpu().numpy() if isinstance(vals, torch.Tensor) \
        else np.asarray(vals)
    return hashlib.sha256(np.ascontiguousarray(
        a, dtype=np.float32).tobytes()).hexdigest()


def phase_nlp_device(dev):
    """(w) The NLP stages' device arithmetic on the card against the same
    code on the CPU: the ordered scatter (``xla_scatter_add``) twice at
    word2vec's shapes (4,096 center rows of 32 floats into a 4,096-word
    table, Zipf-skewed, and 16,384 negatives) -- the two runs the same
    bits and those bits numpy's ``np.add.at`` (one update after another
    in their order); 40 SGNS steps (``sgns_steps``) and two LDA EM sweeps
    (``lda_e_step``) on seeded inputs, bit-equal to the CPU; and
    ``xla_digamma`` / ``xla_sigmoid`` on grids, bit-equal to the CPU."""
    from transmogrifai_tpu_torch import rng as R
    from transmogrifai_tpu_torch.impl.feature.text import (
        lda_e_step, sgns_steps,
    )
    from transmogrifai_tpu_torch.ops.xla_cpu import (
        xla_digamma, xla_scatter_add, xla_sigmoid, xla_sum,
    )
    r = np.random.RandomState(0)
    out = {}
    for tag, n, skew in (("centers", 4096, 1.3), ("negatives", 16384, 0)):
        W = r.randn(4096, 32).astype(np.float32)
        idx = (r.zipf(skew, n) % 4096 if skew else
               r.randint(0, 4096, n)).astype(np.int64)
        u = (r.randn(n, 32) * 1e-3).astype(np.float32)
        want = W.copy()
        np.add.at(want, idx, u)
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = xla_scatter_add(torch.as_tensor(W, device=dev),
                                  torch.as_tensor(idx, device=dev),
                                  torch.as_tensor(u, device=dev))
            torch.cuda.synchronize()
            runs.append((got.cpu().numpy(), time.perf_counter() - t0))
        if not np.array_equal(runs[0][0].view(np.int32),
                              runs[1][0].view(np.int32)):
            raise AssertionError(f"(w) scatter {tag}: two runs differ")
        if not np.array_equal(runs[0][0].view(np.int32), want.view(np.int32)):
            raise AssertionError(f"(w) scatter {tag}: not the sequential "
                                 f"in-order add")
        dup = int(np.bincount(idx).max())
        out[tag] = runs[1][1]
        print(f"(w) ordered scatter, {tag}: {n} updates of 32 floats, "
              f"{dup} to one row at most: two runs bit-equal and equal to "
              f"np.add.at; {runs[1][1] * 1e3:.3f} ms")
    x = np.concatenate([r.uniform(0, 0.5, 50000), r.uniform(0.5, 60, 50000),
                        r.uniform(-20, 0, 10000)]).astype(np.float32)
    for name, fn in (("xla_digamma", xla_digamma),
                     ("xla_sigmoid", xla_sigmoid)):
        a = fn(torch.as_tensor(x, device=dev)).cpu().numpy()
        b = fn(torch.as_tensor(x)).numpy()
        same = (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a)
                                                         & np.isnan(b))
        if not same.all():
            raise AssertionError(f"(w) {name}: {int((~same).sum())} of "
                                 f"{len(x)} values differ from the CPU")
    v, K, n_pairs = 2000, 32, 200000
    cen = r.randint(0, v, n_pairs).astype(np.int64)
    ctx = r.randint(0, v, n_pairs).astype(np.int64)
    W0 = (r.randn(v, K).astype(np.float32) * 0.1)
    res = []
    for d in (dev, torch.device("cpu")):
        W = torch.as_tensor(W0, device=d).clone()
        C = torch.zeros_like(W)
        key = R.prng_key(torch.tensor(42, device=d))
        if d.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        sgns_steps(W, C, torch.as_tensor(cen, device=d),
                   torch.as_tensor(ctx, device=d), key, 40, 4096, 4,
                   0.5 / 4096)
        if d.type == "cuda":
            torch.cuda.synchronize()
        res.append((W.cpu().numpy(), time.perf_counter() - t0))
    if not np.array_equal(res[0][0].view(np.int32), res[1][0].view(np.int32)):
        raise AssertionError(f"(w) SGNS steps: the card's vectors differ "
                             f"from the CPU's by up to "
                             f"{np.abs(res[0][0] - res[1][0]).max():.3g}")
    print(f"(w) 40 SGNS steps (4,096 pairs, 4 negatives, 2,000 x 32 "
          f"vectors): card bit-equal to the CPU; card {res[0][1]:.3f} s, "
          f"CPU {res[1][1]:.3f} s")
    X0 = r.poisson(0.3, (3000, 256)).astype(np.float32)
    t0_ = r.dirichlet(np.ones(256), size=10).astype(np.float32)
    res = []
    for d in (dev, torch.device("cpu")):
        X = torch.as_tensor(X0, device=d)
        topics = torch.as_tensor(t0_, device=d)
        t0 = time.perf_counter()
        for _ in range(2):
            g, phi = lda_e_step(X, topics, 0.1)
            new = xla_sum(phi * X[:, None, :]) + 0.01
            topics = new / xla_sum(new.movedim(1, 0))[:, None]
        if d.type == "cuda":
            torch.cuda.synchronize()
        res.append((topics.cpu().numpy(), g.cpu().numpy(),
                    time.perf_counter() - t0))
    for i, what in ((0, "topics"), (1, "gammas")):
        if not np.array_equal(res[0][i].view(np.int32),
                              res[1][i].view(np.int32)):
            raise AssertionError(
                f"(w) LDA {what}: the card's differ from the CPU's by up "
                f"to {np.abs(res[0][i] - res[1][i]).max():.3g}")
    print(f"(w) 2 LDA EM sweeps (3,000 documents x 256 words, 10 topics): "
          f"card bit-equal to the CPU; card {res[0][2]:.3f} s, CPU "
          f"{res[1][2]:.3f} s")
    return out


class Tickets:
    """The support-ticket path (``testing.tickets_records``: subject,
    body in several languages, email, URL, phone and country, a base64
    attachment; ``testing.tickets_dag``): the NLP stages (stemmed tokens,
    stop words, a 256-word count vector weighed by IDF, 128 bigram counts,
    word2vec and LDA fitted on the card) and the parsers through
    ``transmogrify``, the SanityChecker and the binary default list at
    full default grids with 3-fold CV, trained on 20,000 records and
    served from its reload on 2,000, against ``fixtures/tickets`` (what
    the JAX package made of the same records on the CPU)."""

    def __init__(self):
        from transmogrifai_tpu_torch.testing import (
            TICKETS_ROWS, TICKETS_SCORE_ROWS, TICKETS_SCORE_SEED,
            TICKETS_SEED, records_sha256, tickets_records,
        )
        t0 = time.perf_counter()
        self.train_recs = tickets_records(TICKETS_ROWS, TICKETS_SEED)
        self.score_recs = tickets_records(TICKETS_SCORE_ROWS,
                                          TICKETS_SCORE_SEED)
        gen_s = time.perf_counter() - t0
        with open(os.path.join(TICKETS_DIR, "fixture.json")) as fh:
            self.fx = json.load(fh)
        self.exp = np.load(os.path.join(TICKETS_DIR, "expected.npz"))
        self.sample = np.load(os.path.join(TICKETS_DIR, "vector_sample.npz"))
        self.blocks = np.load(os.path.join(TICKETS_DIR, "device_blocks.npz"))
        for key, recs in (("train_records", self.train_recs),
                          ("score_records", self.score_recs)):
            sha = records_sha256(recs)
            if sha != self.fx[key]["sha256"]:
                raise AssertionError(f"tickets: {key} sha256 {sha}, the "
                                     f"fixture's {self.fx[key]['sha256']}")
        self.model = self.wf = None
        print(f"(t) tickets: {TICKETS_ROWS} training and "
              f"{TICKETS_SCORE_ROWS} scoring records rebuilt in "
              f"{gen_s:.2f} s, sha256 equal to the fixture's")

    def workflow(self):
        from transmogrifai_tpu_torch.testing import tickets_workflow
        wf, y, pred, results = tickets_workflow(self.train_recs)
        if wf.device.type != "cuda":
            raise AssertionError(f"training on {wf.device}")
        return wf, y, pred, results

    def check_inputs(self):
        """(b) one train with every launch of the three sweep kernels held
        to plain; then each one's heaviest launch timed."""
        t0 = time.perf_counter()
        wf, _, _, _ = self.workflow()
        with _KernelChecks(keep_heaviest=True, direct_per_shape=True,
                           direct=False) as checks:
            wf.train()
            torch.cuda.synchronize()
        checks.hold_heaviest_direct("tickets")
        checks.report("tickets", ("hist_matmul", "node_hist",
                                  "forest_predict_chain"))
        print(f"(b) the tickets train's kernel inputs checked in "
              f"{time.perf_counter() - t0:.1f} s")
        return {"tickets": time_heaviest(checks.heaviest, "tickets train")}

    def train(self):
        """The counted train, held to the fixture: every vector block
        (word2vec and LDA included) bit-equal by sha256, the vector's
        metadata and sampled rows, the SanityChecker's choices, the
        selection, the refit's scores on the scoring records, and a save
        and reload. Every check runs; the phase fails after the last if
        any did."""
        from transmogrifai_tpu_torch.testing import (
            assert_same_sanity, sanity_summary, selection_gaps,
            selection_summary,
        )
        fx, exp, sample = self.fx, self.exp, self.sample
        wf, _, pred, results = self.workflow()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = wf.train()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(f"(t) tickets train: {fx['train_records']['rows']} records, "
              f"binary default list at full default grids, 3-fold CV + "
              f"refit + evaluations in {secs:.3f} s (records read, parsed "
              f"and vectorized on the host, word2vec and LDA on the card "
              f"included; the JAX package's CPU train "
              f"{fx['train_seconds_jax_cpu']:.1f} s); peak device memory "
              f"allocated {torch.cuda.max_memory_allocated() / 2 ** 30:.3f}"
              f" GiB")
        self.model, self.wf = model, wf
        faults = []

        def check(fn):
            try:
                fn()
            except AssertionError as e:
                print(f"(t) tickets: FAILED: {e}")
                faults.append(str(e))

        sc = next(s for s in model.stages
                  if type(s).__name__ == "SanityCheckerModel")
        ps = next(s for s in model.stages
                  if type(s).__name__ == "SelectedModel")
        table = model.train_table

        def blocks():
            names = [n for n in table.column_names
                     if table[n].metadata.get("vector_meta") is not None]
            if sorted(names) != sorted(fx["blocks"]):
                raise AssertionError("tickets: other vector blocks than the "
                                     "fixture's")
            differ = [n for n in names
                      if _block_sha(table[n].values) != fx["blocks"][n]]
            on_card = all(isinstance(table[n].values, torch.Tensor)
                          and table[n].values.device.type == "cuda"
                          for n in names)
            gaps = {}
            for op in TICKETS_DEVICE_BLOCKS:
                n = next(n for n in names if f"_{op}_" in n)
                gaps[op] = float(np.abs(table[n].values.cpu().numpy()
                                        - self.blocks[op]).max())
            if differ or not on_card:
                raise AssertionError(
                    f"tickets: blocks {differ} differ from the fixture's "
                    f"bits (word2vec and LDA largest gaps {gaps}); all on "
                    f"the card: {on_card}")
            print(f"(t) tickets: {len(names)} vector blocks on the card, "
                  f"each bit-equal to the fixture's (sha256), word2vec and "
                  f"LDA gaps {gaps}")
        check(blocks)

        def vector_and_checks():
            vec = table[sc.input_features[1].name]
            vm = vec.metadata["vector_meta"]
            meta = {"name": vm.name, "columns": [
                dataclasses.asdict(c) for c in vm.columns]}
            if meta != fx["vector"]:
                raise AssertionError("tickets: the vector's metadata "
                                     "differs from the fixture's")
            X = vec.values[torch.as_tensor(sample["rows"],
                                           device=vec.values.device)]
            if not np.array_equal(X.cpu().numpy(), sample["X"]):
                raise AssertionError("tickets: sampled vector rows differ "
                                     "from the fixture's bits")
            assert_same_sanity(sanity_summary(sc), fx["sanity"])
            print(f"(t) tickets: vector {vm.size} columns, metadata equal, "
                  f"{len(sample['rows'])} sampled rows bit-equal; "
                  f"SanityChecker keeps {len(sc.keep_indices)}, drops "
                  f"{len(sc.summary.dropped)} for the fixture's reasons")
        check(vector_and_checks)
        winner = ps.summary.best_model_type
        got_sel = selection_summary(ps.summary)

        def selection():
            gaps = selection_gaps(got_sel, fx["selection"], lambda f, h, r: (
                TICKETS_LR_FOLD_ATOL if f == "OpLogisticRegression"
                else _fold_limit(f, h, "binary", r, 1.0)))
            shares = {f: (float(f"{g:.3g}"), round(float(r), 3))
                      for f, (g, r) in gaps.items()}
            print(f"(t) tickets: fold {ps.summary.validation_metric} gaps "
                  f"to the fixture (largest, share of its limit): {shares}")
        check(selection)

        def linear_f64():
            # the linear sweeps evaluated again on the card in float64
            # sums (``testing.sweep_again``), against the card's float32
            # folds and the fixture's (the JAX package's CPU float32 sums)
            from transmogrifai_tpu_torch.testing import (
                selection_rows, sweep_again,
            )
            X, y = selection_rows(pred.origin_stage, table)
            f64 = sweep_again(pred.origin_stage, X.double(), y.double(),
                              LEADS_LINEAR)
            del X, y
            by = {g["family"]: np.asarray(g["fold_metrics"], np.float64)
                  for g in got_sel["families"]}
            want = {g["family"]: np.asarray(g["fold_metrics"], np.float64)
                    for g in fx["selection"]["families"]}
            print("(t) tickets: linear fold metrics, max |d| (card float32 "
                  "vs float64; fixture vs float64): " + "; ".join(
                      f"{f} {np.abs(by[f] - f64[f]).max():.3g}, "
                      f"{np.abs(want[f] - f64[f]).max():.3g}"
                      for f in LEADS_LINEAR))
        check(linear_f64)
        print(f"(t) tickets: winner {winner} {ps.summary.best_hyper}")
        scored = model.score(data=self.score_recs)
        parts = _parts_of(model, scored)

        def scores():
            import transmogrifai_tpu_torch as tt
            ref = tt.load_model(os.path.join(TICKETS_DIR, "model"),
                                workflow=wf)
            ref_sel = next(s for s in ref.stages
                           if type(s).__name__ == "SelectedModel")
            if not _is_tree(winner):
                print("(t) tickets: vs the JAX-trained model on the scoring "
                      "records: " + _check_linear(
                          "tickets", "binary", ps, ref_sel, parts, exp,
                          TITANIC_LIN_COEF_RTOL, TITANIC_LIN_PROB_ATOL))
                return
            d = float(np.abs(parts["probability_1"]
                             - exp["probability_1"]).max())
            decided = np.abs(exp["probability_1"] - 0.5) > PRED_MARGIN
            flips = int((parts["prediction"] != exp["prediction"])[
                decided].sum())
            if d > PROB_ATOL or flips:
                raise AssertionError(f"tickets: probability_1 within "
                                     f"{d:.3g} (limit {PROB_ATOL}), {flips} "
                                     f"decided predictions differ")
            print(f"(t) tickets: vs the JAX-trained model on the scoring "
                  f"records: probability_1 max |d| {d:.3g}, 0 flips in "
                  f"{int(decided.sum())} decided rows")
        check(scores)
        check(lambda: save_and_reload(
            "tickets", model, os.path.join(TICKETS_DIR, "model"),
            self.score_recs, workflow=wf))
        if faults:
            raise AssertionError(f"tickets: {len(faults)} check(s) failed: "
                                 + "; ".join(faults))
        return secs

    def serve(self):
        """The saved ticket model reloaded on the card scores the 2,000
        scoring records (parsed, vectorized, word2vec means and LDA
        mixtures on the card) as the trained model does, and answers 64
        single-ticket requests through ``score_function`` as its batch
        score."""
        import transmogrifai_tpu_torch as tt
        path = os.path.join(SAVE_DIR, "tickets")
        m = tt.load_model(path, workflow=self.wf)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scored = m.score(data=self.score_recs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = _parts_of(m, scored)
        want = _parts_of(self.model, self.model.score(data=self.score_recs))
        if not all(np.array_equal(got[k].view(np.int32),
                                  want[k].view(np.int32)) for k in want):
            raise AssertionError("serve tickets: the reload scores other "
                                 "bits")
        fn = m.score_function()
        t0 = time.perf_counter()
        worst = 0.0
        for i in range(64):
            rec = self.score_recs[i]
            out = fn({k: v for k, v in rec.items() if k != "escalated"})
            p = next(v for k, v in out.items()
                     if isinstance(v, dict) and "probability_1" in v)
            worst = max(worst, abs(p["probability_1"]
                                   - float(got["probability_1"][i])))
        req_s = (time.perf_counter() - t0) / 64
        if worst > PROB_ATOL:
            raise AssertionError(f"serve tickets: score_function's "
                                 f"probability_1 {worst:.3g} from the batch "
                                 f"score's")
        print(f"(s) serve tickets: the reload scores {len(self.score_recs)} "
              f"tickets in {secs:.3f} s ({len(self.score_recs) / secs:.0f} "
              f"tickets/s, bit-equal to the trained model); 64 requests "
              f"through score_function {req_s * 1e3:.2f} ms each, "
              f"probability_1 within {worst:.3g} of the batch score")


EVENTS_DIR = os.path.join(HERE, "transmogrifai_tpu_torch", "fixtures",
                          "events")
#: LOCO diffs of the JAX-saved model on the card against the JAX
#: package's on the CPU: the trees are the same, the score's terms add in
#: another order (measured 1.19e-7 on the CPU, one float32 ulp at 1;
#: ``tests/test_torch_record_insights.py``)
EVENTS_LOCO_ATOL = 1e-6
EVENTS_LOCO_TOP_K = 20
#: the fold metrics of the pinned GBT and RF, as the default lists' tree
#: families (``DEFAULT_TREE_ATOL``)
EVENTS_FOLD_ATOL = DEFAULT_TREE_ATOL
EVENTS_REQUESTS = 64


def _nan_eq(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_nan_eq(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(map(_nan_eq, a, b))
    return a == b and type(a) is type(b)


class Events:
    """The customer-event path (``testing.events_files``: ~240,000 send,
    click, visit and purchase events of 20,000 users over 104 days, and a
    users file; ``testing.events_dag``): the events aggregated per user
    at a cutoff by ``AggregateDataReader`` and joined to the users by
    ``JoinedDataReader``, the scalers, bucketizers and the percentile
    calibrator, ``transmogrify``, the SanityChecker and the binary
    selector over the serve bench's GBT and RF with 3-fold CV; trained,
    scored (Avro), evaluated and its raw features written (Parquet) through
    ``OpWorkflowRunner`` and ``OpApp``; LOCO and Corr on the scoring
    cohort of 4,096 users; against ``fixtures/events`` (what the JAX
    package made of the same files on the CPU)."""

    def __init__(self, tmp):
        from transmogrifai_tpu_torch.testing import (
            EVENTS_SCORE_SEED, EVENTS_SCORE_USERS, EVENTS_SEED,
            EVENTS_USERS, events_files, files_sha256,
        )
        with open(os.path.join(EVENTS_DIR, "fixture.json")) as fh:
            self.fx = json.load(fh)
        self.exp = np.load(os.path.join(EVENTS_DIR, "expected.npz"))
        self.sample = np.load(os.path.join(EVENTS_DIR, "vector_sample.npz"))
        self.loco = np.load(os.path.join(EVENTS_DIR, "loco.npz"))
        self.dir = os.path.join(tmp, "events")
        t0 = time.perf_counter()
        self.train_files = events_files(os.path.join(self.dir, "train"),
                                        EVENTS_USERS, EVENTS_SEED)
        self.score_files = events_files(os.path.join(self.dir, "score"),
                                        EVENTS_SCORE_USERS,
                                        EVENTS_SCORE_SEED)
        gen_s = time.perf_counter() - t0
        for key, files in (("train_files", self.train_files),
                           ("score_files", self.score_files)):
            sha = files_sha256(*files)
            if sha != self.fx[key]["sha256"]:
                raise AssertionError(f"events: {key} sha256 {sha}, the "
                                     f"fixture's {self.fx[key]['sha256']}")
        with open(self.train_files[0]) as fh:
            self.n_events = sum(1 for _ in fh) - 1
        self.model = self.wf = self.pred = None
        print(f"(t) events: {EVENTS_USERS} users' files ({self.n_events} "
              f"events) and {EVENTS_SCORE_USERS} scoring users' written in "
              f"{gen_s:.2f} s, sha256 equal to the fixture's")

    def workflow(self):
        from transmogrifai_tpu_torch.testing import events_workflow
        wf, y, pred, results = events_workflow(*self.train_files)
        if wf.device.type != "cuda":
            raise AssertionError(f"training on {wf.device}")
        return wf, y, pred, results

    def score_reader(self):
        from transmogrifai_tpu_torch.testing import (
            events_reader, port_events_namespace,
        )
        return events_reader(port_events_namespace(), *self.score_files)

    def check_inputs(self):
        """(b) one train, then LOCO of its winner on the scoring cohort,
        with every launch of the sweep and predict kernels held to plain;
        then each one's heaviest launch timed."""
        from transmogrifai_tpu_torch.insights import RecordInsightsLOCO
        t0 = time.perf_counter()
        wf, _, pred, _ = self.workflow()
        with _KernelChecks(keep_heaviest=True,
                           direct_per_shape=True) as checks:
            model = wf.train()
            sel = model.get_stage(pred.origin_stage.uid)
            scored = model.score(reader=self.score_reader())
            RecordInsightsLOCO(sel, top_k=EVENTS_LOCO_TOP_K).set_input(
                sel.input_features[1]).diffs(scored)
            torch.cuda.synchronize()
        checks.report("events", ("hist_matmul", "node_hist",
                                  "forest_predict_chain",
                                  "forest_predict_heap"))
        print(f"(b) the events train's and LOCO's kernel inputs checked in "
              f"{time.perf_counter() - t0:.1f} s")
        return {"events": time_heaviest(checks.heaviest, "events train")}

    def train(self):
        """"train events": the runner's train, score (.avro), evaluate,
        features (Parquet) and an ``OpApp`` score, held to the fixture: the
        raw table (keys, order, values, nulls) by digest, every vector
        block by sha256, the vector's metadata and sampled rows, the fitted
        host stages, the SanityChecker's choices, the selection, the
        refit's scores and the written records of the sampled users.
        Every check runs; the phase fails after the last if any did."""
        import transmogrifai_tpu_torch as tt
        from transmogrifai_tpu_torch.evaluators.binary import (
            OpBinaryClassificationEvaluator,
        )
        from transmogrifai_tpu_torch.runner import (
            OpApp, OpParams, OpWorkflowRunner,
        )
        from transmogrifai_tpu_torch.testing import (
            assert_same_sanity, fitted_values, sanity_summary,
            selection_gaps, selection_summary, table_digest,
        )
        from transmogrifai_tpu_torch.utils.avro import read_avro
        fx, exp, sample = self.fx, self.exp, self.sample
        wf, y, pred, _ = self.workflow()
        runner = OpWorkflowRunner(
            wf, train_reader=wf.reader, score_reader=self.score_reader(),
            evaluator=OpBinaryClassificationEvaluator(), label_feature=y,
            prediction_feature=pred)
        out = os.path.join(self.dir, "out")
        model_dir = os.path.join(out, "model")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = runner.run("train", OpParams(
            model_location=model_dir,
            metrics_location=os.path.join(out, "train.json")))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        model = res.model
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"(t) events train through the runner: {self.n_events} "
              f"events of {fx['train_files']['users']} users aggregated, "
              f"joined, vectorized, GBT and RF swept with 3-fold CV, the "
              f"winner refit, the model saved, in {secs:.3f} s (wall; the "
              f"train alone {sum(wf.phase_seconds.values()):.3f} s on the "
              f"card after the host's reading and aggregation; the JAX "
              f"package's CPU train {fx['train_seconds_jax_cpu']:.1f} s); "
              f"peak device memory allocated {peak:.3f} GiB")
        self.model, self.wf, self.pred = model, wf, pred
        faults = []

        def check(fn):
            try:
                fn()
            except AssertionError as e:
                print(f"(t) events: FAILED: {e}")
                faults.append(str(e))

        sc = next(s for s in model.stages
                  if type(s).__name__ == "SanityCheckerModel")
        ps = model.get_stage(pred.origin_stage.uid)
        table = model.train_table
        names = [f.name for f in wf.raw_features]

        def raw():
            got = table_digest(table, names)
            differ = sorted(k for k in got if got[k] != fx["raw_digest"][k])
            if differ:
                raise AssertionError(f"events: raw columns {differ} differ "
                                     f"from the fixture's")
            print(f"(t) events: the aggregated and joined raw table "
                  f"({table.num_rows} users x {len(names)} features) "
                  f"equal to the fixture's: keys and order, values, nulls")
        check(raw)

        def blocks():
            vecs = [n for n in table.column_names
                    if table[n].metadata.get("vector_meta") is not None]
            if sorted(vecs) != sorted(fx["blocks"]):
                raise AssertionError("events: other vector blocks than the "
                                     "fixture's")
            differ = [n for n in vecs
                      if _block_sha(table[n].values) != fx["blocks"][n]]
            if differ:
                raise AssertionError(f"events: blocks {differ} differ from "
                                     f"the fixture's bits")
            vec = table[sc.input_features[1].name]
            vm = vec.metadata["vector_meta"]
            meta = {"name": vm.name, "columns": [
                dataclasses.asdict(c) for c in vm.columns]}
            if meta != fx["vector"]:
                raise AssertionError("events: the vector's metadata differs "
                                     "from the fixture's")
            X = vec.values[torch.as_tensor(sample["rows"],
                                           device=vec.values.device)]
            if not np.array_equal(X.cpu().numpy(), sample["X"]):
                raise AssertionError("events: sampled vector rows differ")
            got_fit = json.loads(json.dumps(fitted_values(model)))
            if got_fit != fx["fitted"]:
                raise AssertionError(f"events: fitted host stages differ: "
                                     f"{got_fit} vs {fx['fitted']}")
            assert_same_sanity(sanity_summary(sc), fx["sanity"])
            print(f"(t) events: {len(vecs)} vector blocks bit-equal "
                  f"(sha256), vector {vm.size} columns, metadata and "
                  f"{len(sample['rows'])} sampled rows equal; the fills, "
                  f"z-score, tree bucketizers' splits and calibrator's "
                  f"{len(next(v for v in got_fit.values() if 'boundaries' in v)['boundaries'])} "
                  f"boundaries equal; SanityChecker keeps "
                  f"{len(sc.keep_indices)}, drops "
                  f"{len(sc.summary.dropped)} for the fixture's reasons")
        check(blocks)
        winner = ps.summary.best_model_type
        got_sel = selection_summary(ps.summary)

        def selection():
            if winner != fx["selection"]["winner"]:
                raise AssertionError(f"events: winner {winner}, the "
                                     f"fixture's "
                                     f"{fx['selection']['winner']}")
            gaps = selection_gaps(got_sel, fx["selection"],
                                  lambda f, h, r: EVENTS_FOLD_ATOL)
            print(f"(t) events: winner {winner}; fold "
                  f"{ps.summary.validation_metric} gaps to the fixture "
                  f"(largest, share of its limit): "
                  f"{ {f: (float(f'{g:.3g}'), round(float(r), 3)) for f, (g, r) in gaps.items()} }")
        check(selection)
        ref = tt.load_model(os.path.join(EVENTS_DIR, "model"), workflow=wf)
        self.ref = ref
        same = None
        if _is_tree(winner):
            rp = ref.get_stage(pred.origin_stage.uid).fitted.params
            same = all(np.array_equal(ps.fitted.params[k].cpu().numpy(),
                                      rp[k].cpu().numpy())
                       for k in rp if isinstance(rp[k], torch.Tensor))
        avro = os.path.join(out, "score.avro")
        t0 = time.perf_counter()
        sres = runner.run("score", OpParams(model_location=model_dir,
                                            write_location=avro))
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
        scored = sres.scores
        self.scored = scored
        parts = _parts_of(model, scored)

        def scores():
            if [str(k) for k in scored.key] != exp["key"].tolist():
                raise AssertionError("events: scoring keys or their order "
                                     "differ from the fixture's")
            print(f"(t) events: the reloaded model scores "
                  f"{len(scored.key)} users through the runner in "
                  f"{score_s:.3f} s (aggregation included); refit trees "
                  f"identical to the JAX-trained model's: {same}; "
                  + _check_parts("events", "binary", parts, exp,
                                 bool(same), 1.0))
        check(scores)

        def written():
            recs = list(read_avro(avro))
            rows = self.loco["rows"]
            bad = []
            # the fixture keeps the records the JAX package wrote (its
            # ``to_dict``); a column of mixed kinds (a dict, a list, text
            # and a NaN) is an Avro string, each cell its value's text
            for i, want in zip(rows, fx["avro_sample"]):
                got = recs[int(i)]
                for k, v in want.items():
                    if isinstance(got[k], str) and not isinstance(v, str) \
                            and k != pred.name:
                        v = str(v)
                    if k == pred.name:
                        g, w = ast.literal_eval(got[k]), v
                        if g.keys() != w.keys() or max(
                                abs(g[q] - w[q]) for q in w) > (
                                P1_MAX_ATOL_SAME_TREES if same
                                else P1_MEAN_ATOL):
                            bad.append((int(i), k))
                    elif not _nan_eq(got[k], v):
                        bad.append((int(i), k))
            if len(recs) != len(exp["key"]) or bad:
                raise AssertionError(f"events: written records differ from "
                                     f"the fixture's at {bad[:5]} "
                                     f"({len(bad)} cells)")
            print(f"(t) events: {len(recs)} Avro records written; the "
                  f"{len(rows)} sampled users' key and raw features equal "
                  f"to the fixture's records, predictions within the "
                  f"tree limits")
        check(written)

        def evaluate():
            eres = runner.run("evaluate", OpParams(
                model_location=model_dir,
                metrics_location=os.path.join(out, "eval.json")))
            ev = eres.metrics["evaluation"]
            if not all(np.isfinite(v) for v in ev.values()):
                raise AssertionError(f"events: evaluation {ev}")
            t0 = time.perf_counter()
            runner.run("features", OpParams(
                write_location=os.path.join(out, "features.parquet")))
            feat_s = time.perf_counter() - t0
            from transmogrifai_tpu_torch.utils.parquet import read_metadata
            lines = read_metadata(os.path.join(
                out, "features.parquet"))["num_rows"] + 1
            app = os.path.join(out, "app.avro")
            OpApp(runner).main(["--run-type", "score", "--model-location",
                                model_dir, "--write-location", app])
            a, b = list(read_avro(app)), list(read_avro(avro))
            if not all(map(_nan_eq, a, b)) or lines != \
                    fx["train_files"]["users"] + 1:
                raise AssertionError("events: OpApp's score differs from the "
                                     "runner's, or the features file's "
                                     "lines")
            print(f"(t) events: evaluate on the scoring users: AuROC "
                  f"{ev['AuROC']:.4f}, AuPR {ev['AuPR']:.4f}; features run "
                  f"wrote {lines - 1} users' raw features (Parquet) in "
                  f"{feat_s:.3f} s; OpApp --run-type score wrote the "
                  f"runner's records")
        check(evaluate)
        if faults:
            raise AssertionError(f"events: {len(faults)} check(s) failed: "
                                 + "; ".join(faults))
        return secs

    def serve(self):
        """"serve events": LOCO (top 20 of ~24 groups) of the JAX-saved
        model on the card on the 4,096 scoring users, held to the
        fixture's diffs and maps on its sampled users, and of the trained
        model (timed, its peak memory); Corr; 64 users through LOCO's row
        dual against the columnar maps; the JAX-saved model's scores."""
        from transmogrifai_tpu_torch.insights import (
            RecordInsightsCorr, RecordInsightsLOCO,
        )
        from transmogrifai_tpu_torch.testing import loco_map_gaps
        fx, pred = self.fx, self.pred
        ref = self.ref
        reader = self.score_reader()
        t0 = time.perf_counter()
        rscored = ref.score(reader=reader)
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
        got = _parts_of(ref, rscored)
        d = float(np.abs(got["probability_1"]
                         - self.exp["probability_1"]).max())
        if d > PROB_ATOL:
            raise AssertionError(f"serve events: the JAX-saved model's "
                                 f"probability_1 {d:.3g} from the JAX "
                                 f"package's (limit {PROB_ATOL})")
        rsel = ref.get_stage(pred.origin_stage.uid)
        loco = RecordInsightsLOCO(rsel, top_k=EVENTS_LOCO_TOP_K).set_input(
            rsel.input_features[1])
        names, diffs = loco.diffs(rscored)
        rows = self.loco["rows"]
        want = self.loco["diffs"]
        if names != fx["loco"]["groups"]:
            raise AssertionError("serve events: LOCO groups differ")
        gap = float(np.abs(diffs[:, rows] - want).max())
        maps = loco.transform_column(rscored).values
        from transmogrifai_tpu_torch.insights.record_insights import (
            _topk_maps_column,
        )
        wmaps = _topk_maps_column(names, want.T, EVENTS_LOCO_TOP_K).values
        bad = [int(i) for j, i in enumerate(rows) if loco_map_gaps(
            want[:, j], diffs[:, i], names, wmaps[j], maps[int(i)],
            EVENTS_LOCO_TOP_K, EVENTS_LOCO_ATOL)]
        if gap > EVENTS_LOCO_ATOL or bad:
            raise AssertionError(f"serve events: LOCO diffs {gap:.3g} from "
                                 f"the fixture's (limit "
                                 f"{EVENTS_LOCO_ATOL}); maps differ at "
                                 f"{bad[:5]}")
        worst = 0
        t0 = time.perf_counter()
        for i in range(EVENTS_REQUESTS):
            row = rscored.row(i)
            one = loco.transform_row(row)
            gaps = loco_map_gaps(diffs[:, i], diffs[:, i], names, maps[i],
                                 one, EVENTS_LOCO_TOP_K, EVENTS_LOCO_ATOL)
            worst = max(worst, len(gaps))
        row_s = (time.perf_counter() - t0) / EVENTS_REQUESTS
        if worst:
            raise AssertionError("serve events: LOCO's row dual disagrees "
                                 "with its columnar maps")
        print(f"(s) serve events: the JAX-saved model scores "
              f"{len(rscored.key)} users on the card in {score_s:.3f} s "
              f"(aggregation included), probability_1 within {d:.3g} of the "
              f"JAX package's; its LOCO ({len(names)} groups, top "
              f"{EVENTS_LOCO_TOP_K}) on the card: diffs within {gap:.3g} of "
              f"the fixture's on {len(rows)} sampled users, maps equal on "
              f"the entries above {EVENTS_LOCO_ATOL}; {EVENTS_REQUESTS} "
              f"users through transform_row {row_s * 1e3:.2f} ms each, maps "
              f"equal to the columnar ones")
        sel = self.model.get_stage(pred.origin_stage.uid)
        scored = self.scored
        mine = RecordInsightsLOCO(sel, top_k=EVENTS_LOCO_TOP_K).set_input(
            sel.input_features[1])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        cols = mine.transform_column(scored)
        torch.cuda.synchronize()
        loco_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        _, mdiffs = mine.diffs(scored)
        t0 = time.perf_counter()
        corr = RecordInsightsCorr(sel, top_k=EVENTS_LOCO_TOP_K).set_input(
            sel.input_features[1]).transform_column(scored)
        torch.cuda.synchronize()
        corr_s = time.perf_counter() - t0
        if len(cols.values) != len(scored.key) or len(corr.values) != len(
                scored.key) or not all(np.isfinite(list(m.values())).all()
                                       for m in corr.values[:256]):
            raise AssertionError("serve events: LOCO or Corr columns bad")
        print(f"(s) serve events: the trained model's LOCO on the card "
              f"{loco_s:.3f} s for {len(scored.key)} users x {len(names)} "
              f"groups ({len(scored.key) * (len(names) + 1)} rows scored), "
              f"peak variant block {mine._peak_variant_bytes / 2 ** 20:.1f} "
              f"MiB, peak device memory above the table "
              f"{peak:.3f} GiB; its diffs within "
              f"{float(np.abs(mdiffs[:, rows] - want).max()):.3g} of the "
              f"fixture's; Corr {corr_s:.3f} s")


STREAM_DIR = os.path.join(HERE, "transmogrifai_tpu_torch", "fixtures",
                          "stream")
#: the streamed train's arms (``bench.py`` BENCH_MODE=stream): (name,
#: TG_STREAM_WORKERS, TG_STREAM_PREFETCH, cache bytes; None = sized to hold
#: every transformed chunk of the stream)
STREAM_ARMS = (("serial", 1, 1, 0), ("parallel", 4, 4, 0),
               ("parallel_cache", 4, 4, None))


class _StreamEnv:
    """The feed's variables set for a ``with`` block, restored after."""

    KEYS = ("TG_STREAM_WORKERS", "TG_STREAM_PREFETCH",
            "TG_STREAM_CACHE_BYTES")

    def __init__(self, workers, prefetch, cache_bytes):
        self.values = dict(zip(self.KEYS, (str(workers), str(prefetch),
                                           str(cache_bytes))))

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.KEYS}
        os.environ.update(self.values)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


class _PassClock:
    """``StreamRun.fold`` timed per pass id for a ``with`` block (host
    clock; the folds run on the host)."""

    def __enter__(self):
        from transmogrifai_tpu_torch.streaming import trainer
        self.seconds: dict = {}
        self._fold = fold = trainer.StreamRun.fold

        def timed(run, pass_id, *args):
            t0 = time.perf_counter()
            try:
                return fold(run, pass_id, *args)
            finally:
                self.seconds[pass_id] = (self.seconds.get(pass_id, 0.0)
                                         + time.perf_counter() - t0)

        trainer.StreamRun.fold = timed
        return self

    def __exit__(self, *exc):
        from transmogrifai_tpu_torch.streaming import trainer
        trainer.StreamRun.fold = self._fold
        return False

    def by_kind(self) -> dict:
        """Seconds summed by pass kind: prep passes by id, the trees'
        level and leaf passes together."""
        out: dict = {}
        for pid, sec in self.seconds.items():
            kind = ("leaves" if pid.endswith(".leaf") else "levels"
                    if ".l" in pid else pid)
            out[kind] = round(out.get(kind, 0.0) + sec, 3)
        return out


class Stream:
    """The out-of-core streamed train on the card (``OpWorkflow.train(
    stream=...)``): the repo's stream workload and the pressure stream,
    against ``fixtures/stream`` (what the JAX package made of the same
    seeds on the CPU)."""

    def __init__(self, dev):
        from transmogrifai_tpu_torch import testing as T
        self.T = T
        self.ns = T.port_stream_namespace()
        self.dev = dev
        self.fixture = T.read_stream_fixture(STREAM_DIR)

    def _workflow(self, d, gbt=None, ckpt=None):
        self.ns.reset_uids()
        wf = self.ns.OpWorkflow(device=self.dev).set_result_features(
            self.T.stream_dag(self.ns, d, gbt))
        if wf.device.type != "cuda":
            raise AssertionError(f"training on {wf.device}")
        return wf.with_checkpoint_dir(ckpt) if ckpt else wf

    def train(self):
        """"train stream": 1,000,000 x 64 in 16 chunks of 65,536, 4
        workers, prefetch 4, the cache sized to hold every transformed
        chunk; held to the fixture bit for bit; residency bounds."""
        T = self.T
        cfg = self.fixture[0]["config"]
        n, d = cfg["rows"], cfg["features"]
        src = self.ns.streaming.SyntheticChunkSource(
            n, d, chunk_rows=cfg["chunkRows"], seed=cfg["seed"],
            problem="binary")
        prefetch = 4
        with _StreamEnv(4, prefetch, max(1 << 28, 6 * n * d * 4)), \
                _PassClock() as clock:
            wf = self._workflow(d)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            model = wf.train(stream=src)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
        got = T.stream_result(model, src, cfg["sample"])
        diffs = T.stream_differences(got, self.fixture)
        if diffs:
            raise AssertionError(f"stream: differs from the fixture: "
                                 f"{diffs[:MAX_REPORTED]}")
        st = model.summary()["streaming"]
        passes = st["rows"] / n
        print(f"(stream) train: {n} x {d} in {src.num_chunks} chunks of "
              f"{src.chunk_rows} rows, {passes:.0f} passes, in {wall:.3f} s "
              f"wall ({n / wall:.1f} rows/s, {st['rows'] / wall:.1f} "
              f"chunk rows/s); fills, the SanityChecker's choices, the "
              f"trees, f0 and probability_1 at {cfg['sample']} rows of "
              f"chunk 0 bit-equal to the fixture")
        print(f"(stream) summary()['streaming']: {json.dumps(st)}")
        print(f"(stream) seconds by pass (a pass's feed and folds): "
              f"{json.dumps(clock.by_kind())}; the consumer waited on the "
              f"feed {st['waitSeconds']} s of them")
        shape_bound = (prefetch + 1) * st["maxChunkBytes"]
        print(f"(stream) peak device memory allocated {peak} bytes "
              f"({peak / 2 ** 20:.1f} MiB) beside (prefetch + 1) x "
              f"maxChunkBytes = {shape_bound} bytes and the raw dataset's "
              f"{n * d * 4} bytes of values")
        if st["peakDeviceBytes"] > shape_bound:
            raise AssertionError("stream: peakDeviceBytes above (prefetch "
                                 "+ 1) x maxChunkBytes")
        if st["peakResidentChunks"] > prefetch + 1:
            raise AssertionError("stream: more than prefetch + 1 chunks "
                                 "resident")
        # the bench's bound on the dataset's share, where it applies: the
        # dataset at least 40 chunks' bytes (here one transformed chunk is
        # more than a fortieth of the raw values, so it does not)
        if n * d * 4 >= 40 * st["maxChunkBytes"] and \
                st["peakDeviceBytes"] > n * d * 4 / 4:
            raise AssertionError("stream: peakDeviceBytes above a quarter "
                                 "of the raw dataset")
        print(f"(stream) peakDeviceBytes {st['peakDeviceBytes']} = "
              f"{st['peakDeviceBytes'] / (n * d * 4):.3f} of the raw "
              f"values, {st['peakResidentChunks']} chunks resident at most "
              f"(bound {prefetch + 1})")
        if st["cacheHits"] <= 0:
            raise AssertionError("stream: the cache was never hit")
        self.summary = st

    def resume(self):
        """"resume stream": the pressure stream (200,000 x 8 in chunks of
        25,000) killed at about half of its folds under a checkpoint
        directory and resumed to the uninterrupted trees, no feed left
        open; then a train downshifted by ``oom.stream`` and killed while
        its halved grid folds, resumed to the downshifted reference."""
        import tempfile as _tempfile
        from transmogrifai_tpu_torch.robustness import faults
        from transmogrifai_tpu_torch.streaming import (
            TableChunkSource, live_feeds,
        )
        T = self.T
        gbt = T.PRESSURE_GBT
        table = T.pressure_table(self.ns)
        rows = T.PRESSURE_CHUNK_ROWS

        def trees(m):
            return T.streamed_gbt_arrays(T.stage_of(m, "StreamingGBTModel"))

        def same(a, b):
            return not T.array_differences(a, b)

        def kill(wf, src, specs):
            try:
                with faults.injected(specs):
                    wf.train(stream=src)
            except faults.SimulatedPreemption:
                pass
            else:
                raise AssertionError(f"stream: {specs} killed nothing")
            if live_feeds():
                raise AssertionError("stream: a feed outlived the kill")

        t0 = time.perf_counter()
        src = TableChunkSource(table, chunk_rows=rows)
        ref = trees(self._workflow(T.PRESSURE_FEATURES, gbt).train(
            stream=src))
        folds = (3 + gbt["num_trees"] * (gbt["max_depth"] + 1)) * \
            src.num_chunks
        with _tempfile.TemporaryDirectory() as ck:
            kill(self._workflow(T.PRESSURE_FEATURES, gbt, ck), src,
                 {"stream.fold": {"mode": "preempt", "nth": folds // 2}})
            resumed = self._workflow(T.PRESSURE_FEATURES, gbt, ck).train(
                resume=True, stream=src)
        if not same(trees(resumed), ref):
            raise AssertionError("stream: the resumed trees differ")
        res = resumed.summary()["resume"]
        print(f"(stream) resume: killed at fold {folds // 2} of {folds}, "
              f"resumed on the card to the unkilled trees; restored "
              f"{res['restoredStages']}, refit {res['refitStages']}, "
              f"{len(resumed.summary()['faults']['restored'])} restored "
              f"records")
        oom = {"oom.stream": {"mode": "oom", "nth": 2}}
        with faults.injected(oom):
            down = self._workflow(T.PRESSURE_FEATURES, gbt).train(
                stream=TableChunkSource(table, chunk_rows=rows))
        downs = down.summary()["faults"]["oomDownshifts"]
        if not downs or downs[0]["detail"]["chunkRows"] != rows // 2:
            raise AssertionError(f"stream: no downshift to {rows // 2} "
                                 f"rows: {downs}")
        with _tempfile.TemporaryDirectory() as ck:
            kill(self._workflow(T.PRESSURE_FEATURES, gbt, ck),
                 TableChunkSource(table, chunk_rows=rows),
                 {**oom, "stream.fold": {"mode": "preempt", "nth": 5}})
            with open(os.path.join(ck, "MANIFEST.json")) as fh:
                recs = json.load(fh).get("streams", {}).values()
            if not any(r.get("chunkRows") == rows // 2 for r in recs):
                raise AssertionError("stream: no record of the halved grid")
            again = self._workflow(T.PRESSURE_FEATURES, gbt, ck).train(
                resume=True, stream=TableChunkSource(table,
                                                     chunk_rows=rows))
        if not same(trees(again), trees(down)):
            raise AssertionError("stream: the resumed downshifted trees "
                                 "differ")
        restored = again.summary()["faults"]["restored"]
        if not any(r["detail"].get("chunkRows") == rows // 2
                   for r in restored):
            raise AssertionError("stream: the restored record lacks the "
                                 "halved chunkRows")
        print(f"(stream) downshift: oom.stream halved the chunks "
              f"{rows} -> {downs[0]['detail']['chunkRows']} "
              f"({len(downs)} downshift(s) recorded); killed on the halved "
              f"grid and resumed to the downshifted trees, the restored "
              f"record carrying chunkRows {rows // 2}; "
              f"{time.perf_counter() - t0:.1f} s")

    def arms(self):
        """The serial, parallel and cached arms on the pressure stream:
        their scores byte-equal."""
        from transmogrifai_tpu_torch.streaming import TableChunkSource
        T = self.T
        table = T.pressure_table(self.ns)
        n, d = T.PRESSURE_ROWS, T.PRESSURE_FEATURES
        probe = table.take(np.arange(T.PRESSURE_CHUNK_ROWS))
        scored = {}
        for name, workers, prefetch, cache in STREAM_ARMS:
            cache = max(1 << 28, 6 * n * d * 4) if cache is None else cache
            with _StreamEnv(workers, prefetch, cache):
                wf = self._workflow(d, T.PRESSURE_GBT)
                t0 = time.perf_counter()
                model = wf.train(stream=TableChunkSource(
                    table, chunk_rows=T.PRESSURE_CHUNK_ROWS))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            st = model.summary()["streaming"]
            col = model.score(table=probe)[model.result_features[0].name]
            scored[name] = col.values.cpu().numpy().tobytes()
            print(f"(stream) arm {name}: {wall:.3f} s ({n / wall:.1f} "
                  f"rows/s), uploadBytes {st['uploadBytes']}, overlap "
                  f"{st['overlapFraction']}, cache hits {st['cacheHits']}, "
                  f"peak {st['peakResidentChunks']} chunks")
        if len(set(scored.values())) != 1:
            raise AssertionError("stream: the arms score differently")
        print(f"(stream) the {len(scored)} arms score byte-equal")


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


def _forest_kernels(model, pred=None):
    """The forest predict kernel a fitted model's scoring launches (its
    last stage's, or ``pred``'s selector's)."""
    from transmogrifai_tpu_torch.ops import forest as F
    stage = (model.stages[-1] if pred is None
             else model.get_stage(pred.origin_stage.uid))
    params = stage.fitted.params
    return ((F.FOREST_PREDICT_CHAIN,) if "feat_lv" in params else
            (F.FOREST_PREDICT_HEAP,) if "feat" in params else ())


def _resume_paths(resume: "Resume", run_path) -> dict:
    """The (resume) phase's counted paths: each arm's resume (or train)
    between zeroed and read counts; the kills run outside them."""
    from transmogrifai_tpu_torch.histeng import kernels as HK
    from transmogrifai_tpu_torch.ops import forest as F
    sweep = (HK.HIST_MATMUL, HK.NODE_HIST, F.FOREST_PREDICT_CHAIN)
    t0 = time.perf_counter()
    paths = {"resume (a)": run_path("resume (a)", resume.unkilled, sweep)}
    resume.kill_sweep()
    paths["resume (b)"] = run_path("resume (b)", resume.resume_sweep, sweep)
    resume.kill_refit()
    paths["resume (c)"] = run_path("resume (c)", resume.resume_refit, ())
    trees = {k: paths["resume (c)"][k.name] for k in sweep[:2]}
    if any(trees.values()):
        raise AssertionError(f"(resume) (c): the replayed sweep launched "
                             f"histogram kernels {trees}")
    paths["resume (d)"] = run_path("resume (d)", resume.kills, sweep)
    paths["resume (e)"] = run_path("resume (e)", resume.split, sweep)
    paths["resume (f)"] = run_path("resume (f)", resume.jax_dir, ())
    if any(paths["resume (f)"][k.name] for k in sweep[:2]):
        raise AssertionError("(resume) (f): the replayed sweep launched "
                             "histogram kernels")
    paths["resume (g) campaign"] = run_path(
        "resume (g) campaign", resume.campaign, (F.FOREST_PREDICT_HEAP,))
    paths["resume (h)"] = run_path("resume (h)", resume.runner, sweep)
    for name, counts in paths.items():
        print(f"(resume) launches, {name}: "
              f"{ {k: v for k, v in counts.items() if v} }")
    print(f"(resume) phase: {time.perf_counter() - t0:.3f} s, arms "
          f"{ {k: round(v, 3) for k, v in resume.seconds.items()} }")
    return paths


def _stream_paths(stream: "Stream", run_path) -> dict:
    """The (stream) phase's two paths; the folds run on the host and the
    card holds the chunks and runs the fill and the column select, so
    neither launches a kernel of the port."""
    out = {"train stream": run_path("train stream", stream.train, ()),
           "resume stream": run_path(
               "resume stream", lambda: (stream.resume(), stream.arms()),
               ())}
    for name, counts in out.items():
        if any(counts.values()):
            raise AssertionError(f"the {name} path launched {counts}")
        print(f"launches, {name}: none of the {len(counts)} kernels")
    return out


SERVING_DIR = os.path.join(HERE, "transmogrifai_tpu_torch", "fixtures",
                           "serve64")
#: the (serving) phase's models: depth-6 heaps, depth-12 slot chains, and
#: 600 heap trees of a 6-class model
SERVING_KEYS = ("gbt", "rf", "xgbmc")
#: the kernels the (serving) path launches, each launch held to plain
SERVING_PREDICTS = ("forest_predict_heap", "forest_predict_chain")
SERVE_MAX_BATCH = 256
SERVE_WAIT_MS = 2.0
#: an odd flush size held to plain beside the 1-row and full flushes
SERVE_ODD_FLUSH = 37
#: open-loop seconds at each offered rate, as ``bench.py``'s serve line
SERVE_OPEN_LOOP_S = 3.0
SERVE_CALIBRATE_S = 1.5
#: the drift path: (t)'s GBT saved and served, 2,048 requests from the
#: scoring frame's distribution, then 2,048 with x0..x7 shifted
DRIFT_KEY = "gbt"
DRIFT_REQUESTS = 2048
DRIFT_SHIFT_SD = 3.0
DRIFT_SHIFTED = 8
#: the monitor folds cumulatively, so after 2,048 in-distribution rows
#: the 2,048 rows shifted by 3 training sd reach a JS divergence of ~0.24
#: on the shifted features (a CPU reading of the same float64 host
#: arithmetic), under the default degradation line of 0.25: the phase
#: draws that line at 0.2 and runs a verdict every 256 rows
DRIFT_CONFIG = dict(every_rows=256, min_rows=256, refit=0.2)
#: linear models checked at flush sizes 1, 37 and 256 (batch invariance
#: of one cuBLAS product per flush is not a given)
SERVE_LINEAR_KEYS = ("lr", "svc")

#: one cold or warm start of the saved ``gbt`` copy in a fresh process:
#: registry load, then the first real request; the compile ledger's
#: builds at each step
START_CHILD = """
import json, sys, time
sys.path.insert(0, {here!r})
import numpy as np
import torch
from transmogrifai_tpu_torch.observability import ledger
from transmogrifai_tpu_torch.serving import ModelRegistry, ServeConfig
from transmogrifai_tpu_torch.testing import score_frame
arm, path = sys.argv[1], sys.argv[2]
frame = score_frame(1)
row = {{k: (None if np.isnan(v[0]) else float(v[0]))
        for k, v in frame.items()}}
t0 = time.perf_counter()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
init_s = time.perf_counter() - t0
led = ledger.ledger()
with ModelRegistry(ServeConfig(max_batch=256, max_wait_ms=2.0)) as reg:
    t0 = time.perf_counter()
    rt = reg.load("m", path, warm=(arm == "warm"))
    load_s = time.perf_counter() - t0
    mark = led.mark()
    t0 = time.perf_counter()
    rec = reg.score("m", row, timeout=120)
    first_s = time.perf_counter() - t0
    first = [r.to_json() for r in led.since(mark)]
    warm = rt.warm_info
print(json.dumps({{"arm": arm, "cudaInitS": init_s, "loadS": load_s,
                  "firstRequestS": first_s, "loadBuilds": mark,
                  "firstRequestBuilds": first, "warm": warm,
                  "record": rec}}))
"""


def _record_parts(model, recs):
    """{key: (n,) float32} of the Prediction of serving records."""
    name = model.result_features[0].name
    keys = list(recs[0][name])
    return {k: np.asarray([r[name][k] for r in recs], np.float32)
            for k in keys}


def _dir_digest(path):
    """{file: sha256} of a directory."""
    import hashlib
    return {f: hashlib.sha256(open(os.path.join(path, f), "rb").read())
            .hexdigest() for f in sorted(os.listdir(path))}


class Serving:
    """(serving) The serving runtime on the card (``serving``): the
    committed JAX-saved ``serve64`` models ``gbt``, ``rf`` and ``xgbmc``
    at full width loaded through ``ModelRegistry.load`` (warm) from copies
    of the fixtures, served under continuous batching at pipeline depths 1
    and 2, under chaos, under open-loop load, and a (t) model through a
    drift refit and hot swap."""

    def __init__(self, tmp: str):
        self.tmp = os.path.join(tmp, "serving")
        os.makedirs(self.tmp)
        self.digests = {k: _dir_digest(os.path.join(SERVING_DIR, k))
                        for k in SERVING_KEYS}
        self.copies = {}
        for key in SERVING_KEYS:
            self.copies[key] = os.path.join(self.tmp, key)
            shutil.copytree(os.path.join(SERVING_DIR, key), self.copies[key])
        from transmogrifai_tpu_torch.testing import request_rows, score_frame
        self.rows = request_rows(score_frame())
        #: {key: (kernel, shape, launch arguments, launches)}: each model's
        #: heaviest launch at the depths, timed after the counted path
        self.heaviest = {}

    @staticmethod
    def _cfg(depth, **kw):
        from transmogrifai_tpu_torch.serving import ServeConfig
        base = dict(max_batch=SERVE_MAX_BATCH, max_queue=8192,
                    max_wait_ms=SERVE_WAIT_MS, pipeline_depth=depth)
        base.update(kw)
        return ServeConfig(**base)

    def starts(self):
        """A cold and a warm start of the ``gbt`` copy, each in a fresh
        process: the warm one's first request must record no ledger build
        and the warm report a fingerprint match."""
        out = {}
        for arm in ("cold", "warm"):
            res = subprocess.run(
                [sys.executable, "-c", START_CHILD.format(here=HERE), arm,
                 self.copies["gbt"]], capture_output=True, text=True,
                timeout=300)
            if res.returncode != 0:
                raise AssertionError(f"the {arm} start failed:\n"
                                     f"{res.stdout}\n{res.stderr}")
            out[arm] = json.loads(res.stdout.strip().splitlines()[-1])
        warm, cold = out["warm"], out["cold"]
        if warm["firstRequestBuilds"] or not (
                warm["warm"]["ok"] and warm["warm"]["fingerprintMatch"]):
            raise AssertionError(f"warm start: {warm}")
        if warm["record"] != cold["record"]:
            raise AssertionError("the cold and warm starts score the first "
                                 "request differently")
        for arm in ("cold", "warm"):
            r = out[arm]
            print(f"(serving) {arm} start of gbt in a fresh process: CUDA "
                  f"context {r['cudaInitS']:.4f} s, registry.load "
                  f"{r['loadS']:.4f} s ({r['loadBuilds']} ledger builds), "
                  f"first request {r['firstRequestS']:.4f} s "
                  f"({len(r['firstRequestBuilds'])} builds), load to first "
                  f"request {r['loadS'] + r['firstRequestS']:.4f} s")

    def run(self):
        """The counted path: warm loads, the depths, chaos, the open loop
        and the drift refit, every predict launch held to plain (the open
        loop's after it ran)."""
        torch.cuda.synchronize()
        t_phase = time.perf_counter()
        self.checks = _KernelChecks(keep_heaviest=True, check_ids=False,
                                    only=SERVING_PREDICTS)
        with self.checks:
            self.models = self.loads()
            clean = {key: self.depths(key, self.models[key])
                     for key in SERVING_KEYS}
            self.chaos(self.models["gbt"], clean["gbt"])
            self.checks.defer = True
            try:
                self.open_loop(self.models["gbt"])
            finally:
                self.checks.defer = False
            self.deferred = self.checks.settle()
            self.drift()
        torch.cuda.synchronize()
        print(f"(serving) phase wall {time.perf_counter() - t_phase:.3f} s")

    def loads(self):
        """``registry.load(warm=True)`` of each fixture copy on the card:
        warm ok with the fixture's fingerprint, no ledger build on the
        first request, the committed files byte-unchanged."""
        from transmogrifai_tpu_torch.observability import ledger
        from transmogrifai_tpu_torch.serving import ModelRegistry
        led = ledger.ledger()
        with ModelRegistry(self._cfg(2)) as reg:
            models = {}
            for key in SERVING_KEYS:
                rt = reg.load(key, self.copies[key])      # default: the card
                info = rt.warm_info
                if rt.model.device.type != "cuda" or not (
                        info["ok"] and info["fingerprintMatch"]):
                    raise AssertionError(f"{key}: warm load {info} on "
                                         f"{rt.model.device}")
                mark = led.mark()
                rt.score(self.rows[0], timeout=120)
                if led.since(mark):
                    raise AssertionError(f"{key}: the first request after "
                                         f"the warm load built "
                                         f"{[r.to_json() for r in led.since(mark)]}")
                models[key] = rt.model
            print(f"(serving) registry.load(warm=True) of {list(models)}: "
                  f"fingerprints match the fixtures', first requests build "
                  f"nothing; health ready={reg.health()['ready']}")
        for key in SERVING_KEYS:
            if _dir_digest(os.path.join(SERVING_DIR, key)) != \
                    self.digests[key]:
                raise AssertionError(f"fixtures/serve64/{key} changed")
        return models

    def after(self, counts):
        """Past the counted path: every predict launch it counted was held
        (``held`` equals the counts); then the kernels timed at each
        model's 256-row flush, the stages timed alone and under the sync
        debug mode, and the linear flush sizes."""
        for k in SERVING_PREDICTS:
            if self.checks.held.get(k, 0) != counts[k]:
                raise AssertionError(
                    f"serving: {counts[k]} {k} launches counted, "
                    f"{self.checks.held.get(k, 0)} held to plain")
        print(f"(serving) every predict launch of the path held bit-equal "
              f"to plain: {counts['forest_predict_heap']} "
              f"forest_predict_heap, {counts['forest_predict_chain']} "
              f"forest_predict_chain ({self.deferred} of the open loop's "
              f"held after it ran)")
        for key, (name, shape, a, calls) in self.heaviest.items():
            times = _predict_times(name, a)
            print(json.dumps({"serving_kernel": name, "model": key,
                              "shape": str(shape), "ms": times["ms"],
                              "plain_ms": times["plain_ms"],
                              "bound_ms": times["bound"][0],
                              "bound_by": times["bound"][1],
                              "launches_at_depths": calls,
                              "launches_on_path": counts[name]}))
        self.sync_debug(self.models)
        self.linear_flushes()

    def depths(self, key, model):
        """The scoring frame's 4,096 rows as requests at depth 1, then 2:
        a staged 37-row flush, a 1-row flush, then the rest (each flush's
        predict at its padding bucket); every forest predict launch held
        bit-equal to plain. Records bit-equal across
        the depths and to ``micro_batch_score_function`` on the same rows,
        and the fixture's expected parts within (c)'s limits."""
        from transmogrifai_tpu_torch.local.scoring import (
            micro_batch_score_function)
        from transmogrifai_tpu_torch.serving import ServingRuntime
        from transmogrifai_tpu_torch.testing import (
            SERVE_MODELS, serve_bench_data)
        rows = self.rows
        by_depth, walls = {}, {}
        want = micro_batch_score_function(model)(rows)
        from transmogrifai_tpu_torch.local import scoring
        from transmogrifai_tpu_torch.utils.padding import bucket_for
        checks = self.checks
        checks.seen, checks.heaviest = {}, {}
        # the flushes' row counts as the runtime dispatches them (the
        # predict runs at each one's padding bucket)
        flushes = []
        dispatch = scoring.ServeStages.dispatch
        scoring.ServeStages.dispatch = (
            lambda st, table: flushes.append(table.num_rows)
            or dispatch(st, table))
        try:
            for depth in (1, 2):
                rt = ServingRuntime(model, f"{key}-d{depth}",
                                    self._cfg(depth), auto_start=False)
                try:
                    futs = [rt.submit(r) for r in rows[:SERVE_ODD_FLUSH]]
                    t0 = time.perf_counter()
                    rt.start()
                    for f in futs:
                        f.result(timeout=120)
                    futs.append(rt.submit(rows[SERVE_ODD_FLUSH]))
                    futs[-1].result(timeout=120)
                    futs += [rt.submit(r)
                             for r in rows[SERVE_ODD_FLUSH + 1:]]
                    by_depth[depth] = [f.result(timeout=120) for f in futs]
                    walls[depth] = time.perf_counter() - t0
                    summ = rt.summary()
                finally:
                    rt.close()
                if summ["degradedRows"] or summ["quarantinedRows"] or \
                        summ["rowsScored"] != len(rows):
                    raise AssertionError(f"{key} depth {depth}: {summ}")
        finally:
            scoring.ServeStages.dispatch = dispatch
        if by_depth[1] != by_depth[2]:
            raise AssertionError(f"{key}: depth 2's records differ from "
                                 f"depth 1's")
        if by_depth[1] != want:
            raise AssertionError(f"{key}: served records differ from "
                                 f"micro_batch_score_function's")
        name = next(n for n in checks.seen)
        sizes = sorted({shape[0][0] for shape in checks.seen[name]["shapes"]})
        for n in (1, SERVE_ODD_FLUSH, SERVE_MAX_BATCH):
            if n not in flushes or bucket_for(n) not in sizes:
                raise AssertionError(
                    f"{key}: no {n}-row flush reached {name} at its bucket "
                    f"(flushes {sorted(set(flushes))}, launches at {sizes} "
                    f"rows)")
        task = SERVE_MODELS[key][2]
        exp = np.load(os.path.join(SERVING_DIR, key, "expected.npz"))
        parts = _record_parts(model, want)
        if task == "binary":
            err = float(np.abs(parts["probability_1"]
                               - exp["probability_1"]).max())
            if err > PROB_ATOL:
                raise AssertionError(f"{key}: probability_1 off by {err}")
            held = f"probability_1 max err {err:.3g}"
        else:
            y_std = float(np.std(serve_bench_data(
                TRAIN_ROWS, N_FEATURES, TRAIN_SEED, task)["y"]))
            held = _check_parts(key, task, parts, exp, True, y_std)
        _, shape, a = checks.heaviest[name]
        self.heaviest[key] = (name, shape, a, checks.seen[name]["calls"])
        print(f"(serving) {key}: {len(rows)} requests at depth 1 in "
              f"{walls[1]:.3f} s, depth 2 in {walls[2]:.3f} s, records "
              f"bit-equal across depths and to micro_batch_score_function; "
              f"{held}; {checks.seen[name]['calls']} {name} launches at "
              f"the buckets {sizes} of flushes of "
              f"{sorted(set(flushes))[:4]}..{max(flushes)} rows, each "
              f"bit-equal to plain")
        return by_depth[1]

    def chaos(self, model, clean):
        """``serve.dispatch`` until the breaker opens (degraded flushes
        eager, the half-open probe closes it), ``oom.serve`` halving a
        256-row flush down to singletons, ``serve.complete`` at depth 2:
        every record the clean run's, none failed."""
        from transmogrifai_tpu_torch.robustness import faults
        from transmogrifai_tpu_torch.serving import (
            CircuitBreaker, ServingRuntime)
        rows = self.rows
        clk = [0.0]
        br = CircuitBreaker(name="chaos", failure_threshold=3,
                            reset_after=10.0, clock=lambda: clk[0])
        with faults.injected({"serve.dispatch": {
                "mode": "raise", "nth": 1, "count": 3, "transient": True}}):
            with ServingRuntime(model, "chaos-breaker", self._cfg(2),
                                breaker=br) as rt:
                got = [rt.score(rows[i], timeout=120) for i in range(4)]
                if br.state != "open":
                    raise AssertionError(f"breaker {br.state} after 3 "
                                         f"dispatch faults")
                clk[0] = 20.0
                got.append(rt.score(rows[4], timeout=120))
                if br.state != "closed":
                    raise AssertionError(f"the probe left the breaker "
                                         f"{br.state}")
                summ = rt.summary()
        if got != clean[:5] or summ["degradedRows"] != 4 or \
                summ["breaker"]["opens"] != 1 or \
                summ["breaker"]["probes"] != 1:
            raise AssertionError(f"serve.dispatch chaos: {summ}")
        n = SERVE_MAX_BATCH
        halvings = int(math.log2(n))
        with faults.injected({"oom.serve": {"mode": "oom", "nth": 1,
                                            "count": halvings}}):
            rt = ServingRuntime(model, "chaos-oom", self._cfg(2),
                                auto_start=False)
            try:
                futs = [rt.submit(r) for r in rows[:n]]
                rt.start()
                got = [f.result(timeout=120) for f in futs]
                summ = rt.summary()
            finally:
                rt.close()
        if got != clean[:n] or summ["faults"]["oomDownshifts"] != halvings \
                or summ["degradedRows"] or summ["breaker"]["opens"]:
            raise AssertionError(f"oom.serve chaos: {summ['faults']}")
        with faults.injected({"serve.complete": {
                "mode": "raise", "nth": 1, "count": 1, "transient": True}}):
            with ServingRuntime(model, "chaos-complete", self._cfg(2)) as rt:
                first = rt.score(rows[0], timeout=120)
                streak = rt.breaker.snapshot()["consecutiveFailures"]
                second = rt.score(rows[1], timeout=120)
                summ = rt.summary()
        sites = {r.site for r in rt.fault_log.of_kind("breaker_degraded")}
        if [first, second] != clean[:2] or streak != 1 or \
                sites != {"serve.complete"} or summ["degradedRows"] != 1:
            raise AssertionError(f"serve.complete chaos: {summ}")
        print(f"(serving) chaos on gbt: serve.dispatch x3 opened the "
              f"breaker (4 rows degraded eager, the probe closed it); "
              f"oom.serve halved a {n}-row flush {halvings} times down to "
              f"a singleton (0 degraded); serve.complete counted against "
              f"its flush; every record the clean run's, none failed")

    def open_loop(self, model):
        """Open loop on ``gbt`` at depth 2, calibrated as ``bench.py``'s
        serve line: 0.7x and 2x the runtime's capacity for 3 s each."""
        from transmogrifai_tpu_torch.local.scoring import (
            micro_batch_score_function)
        from transmogrifai_tpu_torch.serving import (
            ServingRuntime, run_open_loop)
        rows = self.rows
        mb = micro_batch_score_function(model)
        batch = rows[:SERVE_MAX_BATCH]
        mb(batch)
        t0 = time.perf_counter()
        for _ in range(3):
            mb(batch)
        raw = 3 * len(batch) / (time.perf_counter() - t0)
        cfg = self._cfg(2, max_queue=1024)
        with ServingRuntime(model, "calibrate", cfg) as rt:
            cal = run_open_loop(rt, rows, SERVE_CALIBRATE_S, raw)
        capacity = max(cal["rowsPerSec"], 1.0)
        shed_2x = 0
        for tag, mult in (("0.7x", 0.7), ("2x", 2.0)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with ServingRuntime(model, f"open-{tag}", cfg) as rt:
                rep = run_open_loop(rt, rows, SERVE_OPEN_LOOP_S,
                                    mult * capacity)
                stages = {k.split("stage=")[1]: v for k, v in
                          rt.metrics.snapshot()["tg_serve_stage_seconds"]
                          .items()}
            peak = torch.cuda.max_memory_allocated()
            if rep["lost"] or rep["failed"] or rep["submitErrors"] or \
                    not rep["accountingOk"]:
                raise AssertionError(f"open loop {tag}: {rep}")
            shed = rep["shedOverload"] + rep["shedDeadline"]
            line = {"open_loop": tag, "offeredRps": rep["offeredRps"],
                    "rowsPerSec": rep["rowsPerSec"],
                    "p50Ms": rep["p50Ms"], "p95Ms": rep["p95Ms"],
                    "p99Ms": rep["p99Ms"], "offered": rep["offered"],
                    "completed": rep["completed"],
                    "shedOverload": rep["shedOverload"],
                    "shedDeadline": rep["shedDeadline"],
                    "shedRate": shed / max(1, rep["offered"]),
                    "lost": rep["lost"], "failed": rep["failed"],
                    "stageSeconds": {s: {"count": v["count"],
                                         "sum": v["sum"], "p50": v["p50"],
                                         "p99": v["p99"]}
                                     for s, v in sorted(stages.items())},
                    "peakAllocatedBytes": peak,
                    "runtimeCapacity": capacity, "rawCapacity": raw}
            print(json.dumps(line))
            shed_2x = shed
        if not shed_2x:
            print("(serving) note: the 2x open loop shed nothing")

    def sync_debug(self, models):
        """The stages alone, on this thread, past the counted path: each
        model's 256-row flush through ``ServeStages`` (gather, dispatch,
        flatten; median ms of 20 flushes, a ``serving_stage_ms`` line),
        then the same flushes once
        under ``torch.cuda.set_sync_debug_mode("warn")``: every
        synchronizing call, by the innermost frame of the port that made
        it (a ``serving_syncs`` line)."""
        import collections
        import traceback
        import warnings
        from transmogrifai_tpu_torch.local.scoring import ServeStages
        rows = self.rows[:SERVE_MAX_BATCH]
        for key, model in models.items():
            st = ServeStages(model)
            st.flatten(st.dispatch(st.gather(rows)), len(rows))
            ms = {"gather": [], "dispatch": [], "flatten": []}
            for _ in range(20):
                t1 = time.perf_counter()
                table = st.gather(rows)
                t2 = time.perf_counter()
                fl = st.dispatch(table)
                t3 = time.perf_counter()
                st.flatten(fl, len(rows))
                t4 = time.perf_counter()
                for k, v in (("gather", t2 - t1), ("dispatch", t3 - t2),
                             ("flatten", t4 - t3)):
                    ms[k].append(v * 1e3)
            print(json.dumps({"serving_stage_ms": key, "rows": len(rows),
                              **{k: statistics.median(v)
                                 for k, v in ms.items()}}))
        seen = collections.Counter()
        pkg = os.path.join(HERE, "transmogrifai_tpu_torch")

        def record(message, category, filename, lineno, *a, **kw):
            if "synchroniz" not in str(message):
                return
            frames = [f for f in traceback.extract_stack()
                      if f.filename.startswith(pkg)]
            f = frames[-1] if frames else None
            seen[(os.path.relpath(f.filename, HERE), f.lineno, f.line)
                 if f else (os.path.relpath(filename, HERE), lineno,
                            "")] += 1

        prev = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for model in models.values():
                    st = ServeStages(model)
                    st.flatten(st.dispatch(st.gather(rows)), len(rows))
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        print(json.dumps({"serving_syncs": [
            {"file": f, "line": ln, "code": code, "count": c}
            for (f, ln, code), c in sorted(seen.items())]}))

    def linear_flushes(self):
        """``lr`` and ``svc`` at flush sizes 1, 37 and 256: a linear
        model's product is one cuBLAS call a flush, whose kernel may
        change with the row count; the gap is printed, and held to the
        (c) limits."""
        import transmogrifai_tpu_torch as tt
        from transmogrifai_tpu_torch.local.scoring import (
            micro_batch_score_function)
        rows = self.rows[:SERVE_MAX_BATCH]
        for key in SERVE_LINEAR_KEYS:
            model = tt.load_model(os.path.join(SERVING_DIR, key))
            mb = micro_batch_score_function(model)
            full = _record_parts(model, mb(rows))
            odd = _record_parts(model, mb(rows[:SERVE_ODD_FLUSH]))
            one = _record_parts(model, [mb([r])[0]
                                        for r in rows[:SERVE_ODD_FLUSH]])
            part = ("probability_1" if "probability_1" in full
                    else "rawPrediction_1")
            ref = full[part][:SERVE_ODD_FLUSH]
            gaps = {n: float(np.abs(got[part] - ref).max())
                    for n, got in (("1", one), ("37", odd))}
            same = {n: bool(np.array_equal(got[part].view(np.int32),
                                           ref.view(np.int32)))
                    for n, got in (("1", one), ("37", odd))}
            lim = PROB_ATOL if part == "probability_1" else REG_MAX_RTOL
            if max(gaps.values()) > lim:
                raise AssertionError(f"{key}: flush sizes move {part} by "
                                     f"{gaps}")
            print(json.dumps({"linear_flush": key, "part": part,
                              "max_abs_gap_vs_256": gaps,
                              "bit_equal_vs_256": same}))

    def drift(self):
        """(t)'s GBT saved with the port (its manifest must hold
        ``serving`` and ``drift``), loaded through a registry with its
        workflow's ``drift_refit_hook``: 2,048 in-distribution requests
        leave the verdict ``ok``, 2,048 with x0..x7 shifted by 3 training
        sd drive it to ``degraded``; the hook refits on the card and the
        registry hot-swaps while requests keep flowing; none fails."""
        import transmogrifai_tpu_torch as tt
        from transmogrifai_tpu_torch.manifest import CheckpointManifest
        from transmogrifai_tpu_torch.persistence import FORMAT_VERSION
        from transmogrifai_tpu_torch.serving import ModelRegistry
        from transmogrifai_tpu_torch.serving.drift import (
            DriftConfig, live_refits)
        from transmogrifai_tpu_torch.testing import (
            SERVE_MODELS, serve_bench_data, serve_bench_workflow)
        family, hyper, task = SERVE_MODELS[DRIFT_KEY]
        model = TRAINED[DRIFT_KEY]
        path = os.path.join(self.tmp, "drift_gbt")
        tt.save_model(model, path)
        man, err = CheckpointManifest.load(path, FORMAT_VERSION)
        fixture, _ = CheckpointManifest.load(
            os.path.join(SERVING_DIR, DRIFT_KEY), FORMAT_VERSION)
        if err or not man.serving or not man.drift or \
                man.serving["planFingerprint"] != \
                fixture.serving["planFingerprint"]:
            raise AssertionError("the port's save lacks its serving or "
                                 "drift section")
        data = serve_bench_data(TRAIN_ROWS, N_FEATURES, TRAIN_SEED, task)
        wf = serve_bench_workflow(family, hyper, N_FEATURES, TRAIN_SEED,
                                  problem=task).set_input_dataset(data)
        sd = {f"x{i}": float(np.std(data[f"x{i}"]))
              for i in range(DRIFT_SHIFTED)}
        base = self.rows[:DRIFT_REQUESTS]
        shifted = [{k: (v + DRIFT_SHIFT_SD * sd[k]
                        if k in sd and v is not None else v)
                    for k, v in r.items()}
                   for r in self.rows[DRIFT_REQUESTS:2 * DRIFT_REQUESTS]]
        refits = os.path.join(self.tmp, "refits")
        futs = []

        def submit(reg, row):
            # a refusal (the swap's close racing the request) raises here
            # and fails the phase
            return reg.submit("drift", row)

        def folded(mon, rows):
            # a flush's futures resolve before the completer folds its
            # rows into the monitor: wait for the fold
            deadline = time.monotonic() + 60
            while mon.snapshot()["rows"] < rows:
                if time.monotonic() > deadline:
                    raise AssertionError("the drift monitor fell behind")
                time.sleep(0.005)
            return mon.snapshot()

        t0 = time.perf_counter()
        with ModelRegistry(self._cfg(2),
                           refit_hook=wf.drift_refit_hook(refits)) as reg:
            old = reg.load("drift", path)
            old.drift_monitor.config = DriftConfig(**DRIFT_CONFIG)
            futs += [submit(reg, r) for r in base]
            for f in futs:
                f.result(timeout=120)
            before = folded(old.drift_monitor, len(base))
            if before["verdict"] != "ok":
                raise AssertionError(f"in-distribution traffic: {before}")
            futs += [submit(reg, r) for r in shifted]
            for f in futs:
                f.result(timeout=120)
            degraded_at = folded(old.drift_monitor, len(base) + len(shifted))
            if degraded_at["verdict"] != "degraded":
                raise AssertionError(f"shifted traffic: {degraded_at}")
            # requests keep flowing while the hook refits and swaps, one
            # at a time
            i = 0
            deadline = time.monotonic() + 300
            while (live_refits() or not reg.health()["refits"]) and \
                    time.monotonic() < deadline:
                futs.append(submit(reg, base[i % len(base)]))
                futs[-1].result(timeout=120)
                i += 1
                # leave the refit's train the interpreter between requests
                time.sleep(0.005)
            if live_refits():
                raise AssertionError("the drift refit did not finish")
            recs = [f.result(timeout=120) for f in futs]
            health = reg.health()
            new = reg.runtime("drift")
        wall = time.perf_counter() - t0
        refit = health["refits"]
        if not refit or not refit[0]["ok"] or new is old or \
                new.model.device.type != "cuda":
            raise AssertionError(f"no hot swap: {refit}")
        bad = [r for r in recs if r is None or "__score_error__" in r]
        shed = old.summary()["shed"]
        if bad or any(shed.values()) or len(recs) != len(futs):
            raise AssertionError(f"requests failed across the swap: "
                                 f"{len(bad)} bad, shed {shed}")
        worst = max(degraded_at["features"].items(),
                    key=lambda kv: kv[1]["jsDivergence"])
        print(f"(serving) drift: {DRIFT_REQUESTS} in-distribution requests "
              f"left the verdict ok (max JS "
              f"{max(m['jsDivergence'] for m in before['features'].values()):.4f}); "
              f"{DRIFT_REQUESTS} with x0..x{DRIFT_SHIFTED - 1} shifted by "
              f"{DRIFT_SHIFT_SD} sd degraded it ({worst[0]} JS "
              f"{worst[1]['jsDivergence']:.4f}); the hook refit on the card "
              f"and hot-swapped to {refit[0]['path']!r} while {i} more "
              f"requests flowed; {len(recs)} requests, none refused, failed "
              f"or shed ({wall:.3f} s)")


#: the (fleet) phase (``bench.py``'s fleet and wire lines): the models of
#: the in-process and subprocess replicas, and of the placement arm
FLEET_KEYS = ("gbt", "rf")
FLEET_PLACE_KEYS = ("gbt", "rf", "xgbmc")
FLEET_OPEN_LOOP_S = 3.0
#: the rates, of one runtime's calibrated capacity (``bench.py``): the
#: saturated lines 1.2x a replica, the kill arm 0.8x
FLEET_SATURATE = 1.2
FLEET_KILL_FRACTION = 0.8
#: the wire lines' rate, of the calibrated capacity, and their request
#: size (``bench.py``: BENCH_SERVE_CLEAN_FRACTION, BENCH_WIRE_BATCH_ROWS)
FLEET_WIRE_FRACTION = 0.35
FLEET_WIRE_BATCH = 32
FLEET_WIRE_CHAOS_S = 1.5
#: the placement arm: seconds, offered rows/s and the model mix. Three
#: models in two warm slots page on nearly every request for a cold one
#: (each page-in a load and a warm pass), so the mix leans on one model
#: and the rate stays low
FLEET_PLACE_S = 2.0
FLEET_PLACE_RPS = 100.0
FLEET_PLACE_MIX = (("gbt", 8.0), ("rf", 1.0), ("xgbmc", 1.0))
#: one predict launch in this many is held to plain inside a timed loop
FLEET_HOLD_EVERY = 16
#: requests queued in the subprocess replica when it is killed: under a
#: flush (256), behind the subprocess arm's flush timer
FLEET_SIGKILL_ROWS = 200
FLEET_STAGE_WAIT_MS = 500.0


class _Capture:
    """A front door as the load generator sees it, keeping every accepted
    request's row index, model and future, so the records a timed run
    completed are held to the clean ones after it."""

    def __init__(self, fd, rows):
        self.fd = fd
        self._index = {id(r): i for i, r in enumerate(rows)}
        self.accepted = []
        self._lock = threading.Lock()

    def submit(self, row, **kw):
        fut = self.fd.submit(row, **kw)
        with self._lock:
            self.accepted.append((self._index[id(row)], kw.get("model"),
                                  fut))
        return fut

    def __getattr__(self, name):
        return getattr(self.fd, name)

    def held_to(self, baselines, default, same) -> int:
        """How many completed records were compared; raises on the first
        that is not ``same`` as its model's clean record."""
        n = 0
        for i, model, fut in self.accepted:
            if not fut.done() or fut.exception() is not None:
                continue
            if not same([fut.result()], [baselines[model or default][i]]):
                raise AssertionError(f"fleet: the record of row {i} "
                                     f"({model or default}) differs from "
                                     f"the clean run's")
            n += 1
        return n


class Fleet:
    """(fleet) The fleet tier on the card (``serving/{fleet,frontdoor,
    placement,netedge,netproto,replica_worker}.py``): replicas in this
    process and in a child process, the front door's routing, failover
    and paging, and the network edge, on fresh copies of the committed
    ``serve64`` models at full width."""

    def __init__(self, tmp: str, device: str = "cuda:0"):
        self.tmp = os.path.join(tmp, "fleet")
        os.makedirs(self.tmp)
        self.device = device
        self.copies = {}
        for key in FLEET_PLACE_KEYS:
            self.copies[key] = os.path.join(self.tmp, key)
            shutil.copytree(os.path.join(SERVING_DIR, key), self.copies[key])
        from transmogrifai_tpu_torch.testing import request_rows, score_frame
        self.rows = request_rows(score_frame())

    @staticmethod
    def _same(got, want) -> bool:
        """Records compared: bit-equal."""
        return got == want

    def _cfg(self, **kw):
        from transmogrifai_tpu_torch.serving import ServeConfig
        base = dict(max_batch=SERVE_MAX_BATCH, max_queue=1024,
                    max_wait_ms=SERVE_WAIT_MS, pipeline_depth=2)
        base.update(kw)
        return ServeConfig(**base)

    def _fc(self, **kw):
        from transmogrifai_tpu_torch.serving import FleetConfig
        base = dict(min_replicas=1, max_replicas=4, probe_interval_ms=0.0,
                    max_failovers=3, autoscale=False, device=self.device)
        base.update(kw)
        return FleetConfig(**base)

    @staticmethod
    def _through(submit, rows, chunk=SERVE_MAX_BATCH * 2):
        """Records of ``rows`` through ``submit``, at most ``chunk``
        outstanding (under every queue's bound)."""
        out = []
        for i in range(0, len(rows), chunk):
            futs = [submit(r) for r in rows[i:i + chunk]]
            out += [f.result(timeout=120) for f in futs]
        return out

    def _door(self, keys=FLEET_KEYS, replicas=2, config=None, **kw):
        from transmogrifai_tpu_torch.serving import FrontDoor
        return FrontDoor({k: self.copies[k] for k in keys},
                         replicas=replicas, config=config or self._cfg(),
                         fleet_config=self._fc(), warm=True, **kw)

    def _timed(self, fn):
        """``fn()`` with the predict checks deferred and sampled."""
        checks = getattr(self, "checks", None)
        if checks is None:
            return fn()
        checks.defer, checks.every = True, FLEET_HOLD_EVERY
        try:
            return fn()
        finally:
            checks.defer, checks.every = False, 1

    @staticmethod
    def _accounted(tag, rep, disconnects=False):
        if rep["lost"] or rep["failed"] or rep["submitErrors"] or \
                not rep["accountingOk"] or (rep["shedDisconnect"]
                                            and not disconnects):
            raise AssertionError(f"fleet {tag}: {rep}")

    def run(self, checks=True):
        """The counted path; ``checks=False`` runs it without holding a
        launch to plain (a CPU dry run)."""
        if self.device.startswith("cuda"):
            torch.cuda.synchronize()
        t_phase = time.perf_counter()
        self.checks = (_KernelChecks(check_ids=False, only=SERVING_PREDICTS)
                       if checks else None)
        import contextlib
        with (self.checks or contextlib.nullcontext()):
            self.baselines()
            capacity = self.calibrate()
            self.scaling(capacity)
            self.kill(capacity)
            self.placement()
            self.edge(capacity)
            self.subprocess()
        self.deferred = self.checks.settle() if checks else 0
        print(f"(fleet) phase wall {time.perf_counter() - t_phase:.3f} s")

    def baselines(self):
        """Each model's records of the 4,096 rows from the micro-batch
        scorer on the device: what every replica must answer."""
        import transmogrifai_tpu_torch as tt
        from transmogrifai_tpu_torch.local.scoring import (
            micro_batch_score_function)
        self.clean = {}
        for key in FLEET_PLACE_KEYS:
            model = tt.load_model(self.copies[key], device=self.device)
            self.clean[key] = micro_batch_score_function(model)(self.rows)

    def calibrate(self) -> float:
        """One runtime's capacity on ``gbt``, as ``bench.py`` and the
        (serving) phase calibrate it: an open loop offered the micro-batch
        scorer's one-thread rows/s."""
        import transmogrifai_tpu_torch as tt
        from transmogrifai_tpu_torch.local.scoring import (
            micro_batch_score_function)
        from transmogrifai_tpu_torch.serving import (
            ServingRuntime, run_open_loop)
        model = tt.load_model(self.copies["gbt"], device=self.device)
        mb = micro_batch_score_function(model)
        batch = self.rows[:SERVE_MAX_BATCH]
        mb(batch)
        t0 = time.perf_counter()
        for _ in range(3):
            mb(batch)
        raw = 3 * len(batch) / (time.perf_counter() - t0)
        with ServingRuntime(model, "fleet-calibrate", self._cfg()) as rt:
            cal = self._timed(lambda: run_open_loop(
                rt, self.rows, SERVE_CALIBRATE_S, raw))
        capacity = max(cal["rowsPerSec"], 1.0)
        print(f"(fleet) calibrated capacity of one runtime on gbt: "
              f"{capacity} rows/s (offered {raw:.1f})")
        return capacity

    def scaling(self, capacity) -> None:
        """1 and 2 in-process replicas: records bit-equal, then an open
        loop each at 1.2x the calibrated capacity a replica."""
        from transmogrifai_tpu_torch.serving import run_open_loop
        lines = {}
        for n in (1, 2):
            with self._door(replicas=n) as fd:
                for rid, rep in sorted(fd._replicas.items()):
                    for key in FLEET_KEYS:
                        rt = rep.registry.runtime(key)
                        info = rt.warm_info
                        if str(rt.model.device) != self.device or not (
                                info["ok"] and info["fingerprintMatch"]):
                            raise AssertionError(
                                f"fleet {rid}/{key}: warm {info} on "
                                f"{rt.model.device}")
                for key in FLEET_KEYS:
                    if not self._same(self._through(
                            lambda r: fd.submit(r, model=key), self.rows),
                            self.clean[key]):
                        raise AssertionError(f"fleet x{n}: {key} records "
                                             f"differ from the scorer's")
                dist = fd.replica_distribution()
                rep = self._timed(lambda: run_open_loop(
                    fd, self.rows, FLEET_OPEN_LOOP_S,
                    FLEET_SATURATE * capacity * n))
            if rep["lost"] or rep["failed"] or not rep["accountingOk"]:
                raise AssertionError(f"fleet x{n} open loop: {rep}")
            lines[n] = rep
            print(json.dumps({
                "fleet_replicas": n, "rowsPerSec": rep["rowsPerSec"],
                "offeredRps": rep["offeredRps"], "p50Ms": rep["p50Ms"],
                "p99Ms": rep["p99Ms"], "completed": rep["completed"],
                "shedOverload": rep["shedOverload"],
                "routing": rep["replicas"],
                "routingOfTheParityRows": dist}))
        factor = lines[2]["rowsPerSec"] / max(lines[1]["rowsPerSec"], 1e-9)
        print(f"(fleet) in-process replicas on {self.device}: records of "
              f"gbt and rf bit-equal to micro_batch_score_function at 1 and "
              f"2 replicas; saturated rows/s x1 "
              f"{lines[1]['rowsPerSec']}, x2 {lines[2]['rowsPerSec']}: "
              f"2-vs-1 factor {factor:.3f} (a reading, no gate)")

    def kill(self, capacity):
        """Two replicas, r0 killed halfway through an open loop."""
        from transmogrifai_tpu_torch.observability import postmortem as pm
        from transmogrifai_tpu_torch.serving import run_open_loop
        pm_dir = os.path.join(self.tmp, "postmortems")
        prev = os.environ.get("TG_POSTMORTEM_DIR")
        os.environ["TG_POSTMORTEM_DIR"] = pm_dir
        try:
            with self._door() as fd:
                cap = _Capture(fd, self.rows)
                killer = threading.Timer(FLEET_OPEN_LOOP_S / 2.0,
                                         fd.kill_replica, ("r0",))
                killer.start()
                try:
                    rep = self._timed(lambda: run_open_loop(
                        cap, self.rows, FLEET_OPEN_LOOP_S,
                        FLEET_KILL_FRACTION * capacity))
                finally:
                    killer.cancel()
                    killer.join()
                snap = fd.fleet_snapshot()
        finally:
            if prev is None:
                os.environ.pop("TG_POSTMORTEM_DIR", None)
            else:
                os.environ["TG_POSTMORTEM_DIR"] = prev
        self._accounted("kill", rep)
        if snap["kills"] != 1:
            raise AssertionError(f"fleet kill: {snap['kills']} kills")
        held = cap.held_to(self.clean, "gbt", self._same)
        docs = [pm.read_bundle(p) for p in pm.list_bundles(pm_dir)]
        lost = [d for d in docs if d["trigger"]["kind"] == "replica_lost"]
        bad = [d["trigger"]["kind"] for d in docs if pm.validate_bundle(d)]
        if not lost or bad:
            raise AssertionError(f"fleet kill: post-mortems {docs} "
                                 f"(invalid: {bad})")
        print(json.dumps({
            "fleet_kill": 2, "rowsPerSec": rep["rowsPerSec"],
            "offeredRps": rep["offeredRps"], "p50Ms": rep["p50Ms"],
            "p99Ms": rep["p99Ms"], "completed": rep["completed"],
            "recordsHeld": held, "kills": snap["kills"],
            "failovers": snap["failovers"],
            "inflightAtKill": lost[0]["trigger"]["detail"]["inflight"],
            "shedNoReplica": rep["shedNoReplica"],
            "shedOverload": rep["shedOverload"], "lost": rep["lost"],
            "failed": rep["failed"], "routing": rep["replicas"]}))

    def placement(self):
        """Three models on two replicas that keep one warm each, under a
        weighted mix: page-ins and evictions, records bit-equal."""
        from transmogrifai_tpu_torch.serving import (
            PlaceConfig, run_open_loop)
        with self._door(FLEET_PLACE_KEYS,
                        placement=PlaceConfig(max_warm=1)) as fd:
            cap = _Capture(fd, self.rows)
            rep = self._timed(lambda: run_open_loop(
                cap, self.rows, FLEET_PLACE_S, FLEET_PLACE_RPS,
                models=list(FLEET_PLACE_MIX), model_seed=7))
            snap = fd.placer.snapshot()
            pageins = sorted(fd.placer._pagein_ms)
        self._accounted("placement", rep)
        if not (snap["pageIns"] and snap["evictions"]):
            raise AssertionError(f"fleet placement: no paging {snap}")
        held = cap.held_to(self.clean, "gbt", self._same)
        print(json.dumps({
            "fleet_placement": dict(FLEET_PLACE_MIX),
            "rowsPerSec": rep["rowsPerSec"], "completed": rep["completed"],
            "recordsHeld": held, "pageIns": snap["pageIns"],
            "evictions": snap["evictions"],
            "pageInSecondsP50": statistics.median(pageins) / 1e3,
            "pageInSecondsMax": pageins[-1] / 1e3,
            "perModel": {m: {"offered": b["offered"],
                             "completed": b["completed"]}
                         for m, b in sorted(rep["models"].items())},
            "lost": rep["lost"], "failed": rep["failed"]}))

    def edge(self, capacity):
        """A ``NetEdge`` on 127.0.0.1 in front of two replicas: both
        framings bit-equal to in-process, the wire loops per framing
        beside the in-process one at the same rate, then drops."""
        from transmogrifai_tpu_torch.robustness import faults
        from transmogrifai_tpu_torch.serving import (
            NetEdge, WireClient, run_open_loop, run_wire_open_loop)
        rows = self.rows
        rate = max(10.0, FLEET_WIRE_FRACTION * capacity)
        with self._door() as fd, NetEdge(fd, host="127.0.0.1", port=0,
                                         name="fleet") as edge:
            host, port = edge.address
            for proto in ("http", "binary"):
                with WireClient(host, port, protocol=proto,
                                timeout=120) as cli:
                    res = cli.request(rows[:SERVE_MAX_BATCH])
                if res.status != 200 or not self._same(
                        res.records, self.clean["gbt"][:SERVE_MAX_BATCH]):
                    raise AssertionError(f"fleet edge {proto}: "
                                         f"{res.status} {res.error}")
            inproc = self._timed(lambda: run_open_loop(
                fd, rows, FLEET_OPEN_LOOP_S, rate))
            self._accounted("in-process reference", inproc)
            for proto in ("http", "binary"):
                wrep = self._timed(lambda: run_wire_open_loop(
                    host, port, rows, FLEET_OPEN_LOOP_S, rate,
                    protocols=(proto,), batch_rows=FLEET_WIRE_BATCH))
                self._accounted(f"wire {proto}", wrep)
                pp = wrep["protocols"][proto]
                print(json.dumps({
                    "fleet_wire": proto, "offeredRps": wrep["offeredRps"],
                    "rowsPerSec": wrep["rowsPerSec"], "p50Ms": pp["p50Ms"],
                    "p99Ms": pp["p99Ms"], "requests": pp["requests"],
                    "batchRows": FLEET_WIRE_BATCH,
                    "inprocRowsPerSec": inproc["rowsPerSec"],
                    "inprocP50Ms": inproc["p50Ms"],
                    "inprocP99Ms": inproc["p99Ms"],
                    "ratio": wrep["rowsPerSec"] / max(
                        inproc["rowsPerSec"], 1.0)}))
            with faults.injected({
                    "net.read": {"mode": "raise", "nth": 4, "count": 2},
                    "net.write": {"mode": "raise", "nth": 9, "count": 2}}):
                crep = self._timed(lambda: run_wire_open_loop(
                    host, port, rows, FLEET_WIRE_CHAOS_S, rate,
                    batch_rows=FLEET_WIRE_BATCH, reconnect_every=5))
        self._accounted("wire chaos", crep, disconnects=True)
        if not crep["shedDisconnect"]:
            raise AssertionError(f"fleet wire chaos: no drop {crep}")
        print(f"(fleet) edge: {SERVE_MAX_BATCH} rows over HTTP/JSON and "
              f"over TGB1 bit-equal to in-process; wire loops at {rate:.1f} "
              f"rows/s accounted, no lost or failed; net.read/net.write "
              f"drops: {crep['shedDisconnect']} rows in shedDisconnect, "
              f"{crep['completed']} completed, lost {crep['lost']}")

    def subprocess(self):
        """One subprocess replica beside one in-process replica: bit-equal
        records, then SIGKILL with requests queued in the child (the
        in-process replica steps aside while they route, as in a rolling
        deploy, and the child's flush timer holds them)."""
        from transmogrifai_tpu_torch.serving.fleet import ACTIVE, DRAINING
        with self._door(replicas=1, config=self._cfg(
                max_wait_ms=FLEET_STAGE_WAIT_MS)) as fd:
            fd.fleet_config.subprocess = True
            try:
                child = fd.spawn_replica()
            finally:
                fd.fleet_config.subprocess = False
            if child.kind != "subprocess" or child.device != self.device:
                raise AssertionError(f"fleet: spawned {child.kind} on "
                                     f"{getattr(child, 'device', None)}")
            inproc = fd._replicas["r0"]
            for key in FLEET_KEYS:
                rows = self.rows[:SERVE_MAX_BATCH]
                theirs = self._through(lambda r: child.submit(key, r), rows)
                ours = self._through(lambda r: inproc.submit(key, r), rows)
                if not (self._same(theirs, ours) and self._same(
                        ours, self.clean[key][:len(rows)])):
                    raise AssertionError(f"fleet subprocess: {key} records "
                                         f"differ from the in-process "
                                         f"replica's")
            health = child.health(timeout=120)
            rows = self.rows[:FLEET_SIGKILL_ROWS]
            inproc.state = DRAINING
            try:
                futs = [fd.submit(r, model="gbt") for r in rows]
            finally:
                inproc.state = ACTIVE
            fd.kill_replica(child.rid)
            recs = [f.result(timeout=120) for f in futs]
            snap = fd.fleet_snapshot()
            lost = [r for r in fd.fault_log.reports
                    if r.kind == "replica_lost"]
        if not self._same(recs, self.clean["gbt"][:len(rows)]) or \
                snap["kills"] != 1 or not snap["failovers"]:
            raise AssertionError(f"fleet subprocess SIGKILL: {snap}")
        dev = health["device"]
        launches = dev.get("kernelLaunches", {})
        if self.device.startswith("cuda") and not all(
                launches.get(k) for k in SERVING_PREDICTS):
            raise AssertionError(f"the subprocess replica launched "
                                 f"{launches}")
        print(json.dumps({
            "fleet_subprocess": child.device,
            "spawnToReadySeconds": child.spawn_seconds,
            "childMaxMemoryAllocated": dev.get("maxMemoryAllocated"),
            "childMemoryAllocated": dev.get("memoryAllocated"),
            "childKernelLaunches": launches,
            "inflightAtSigkill": lost[0].detail["inflight"],
            "failovers": snap["failovers"],
            "routing": {r: v["routed"] for r, v in snap["replicas"].items()},
            "recordsAfterSigkill": len(recs)}))

    def after(self, counts):
        """Past the counted path: every predict launch was held to plain
        or sampled out inside a timed loop, and some of each were held."""
        for k in SERVING_PREDICTS:
            held = self.checks.held.get(k, 0)
            skipped = self.checks.skipped.get(k, 0)
            if held + skipped != counts[k] or not held:
                raise AssertionError(
                    f"fleet: {counts[k]} {k} launches counted, {held} "
                    f"held to plain, {skipped} sampled out")
        print(f"(fleet) predict launches on the path: "
              f"{counts['forest_predict_heap']} forest_predict_heap, "
              f"{counts['forest_predict_chain']} forest_predict_chain; "
              f"held bit-equal to plain: "
              f"{self.checks.held.get('forest_predict_heap', 0)} and "
              f"{self.checks.held.get('forest_predict_chain', 0)} "
              f"({self.deferred} of them after their timed loop, one in "
              f"{FLEET_HOLD_EVERY} there)")


RESUME_FIXTURE = os.path.join(HERE, "transmogrifai_tpu_torch", "fixtures",
                              "resume", "default_binary")
#: the kill sites of arm (d), as ``tests/test_preemption.py`` kills them
RESUME_KILLS = (("preempt.stage_fit", 2), ("preempt.checkpoint_write", 1))


class Resume:
    """(resume): the checkpointed in-core train of the serve bench's
    default binary list (20,000 x 64, full default grids), killed and
    resumed on the card; each arm is held to the unkilled checkpointed
    run: the selection exact, the refit's parameters and the scores of
    ``testing.score_frame()`` bit-equal."""

    FAMILIES = ("OpLogisticRegression", "OpRandomForestClassifier",
                "OpGBTClassifier", "OpLinearSVC")

    def __init__(self, tmp: str, dev):
        from transmogrifai_tpu_torch.testing import (
            score_frame, serve_bench_data)
        self.tmp = os.path.join(tmp, "resume")
        os.makedirs(self.tmp)
        self.dev = dev
        self.data = serve_bench_data(TRAIN_ROWS, N_FEATURES, TRAIN_SEED)
        self.frame = score_frame()
        self.ref = None
        #: each arm's wall seconds (kill and resume, or train)
        self.seconds = {}

    def workflow(self, ckpt=None):
        """The default list's workflow, built after ``reset_uids`` as the
        JAX package built the committed directory's."""
        from transmogrifai_tpu_torch.features import reset_uids
        from transmogrifai_tpu_torch.testing import serve_bench_workflow
        reset_uids()
        wf = serve_bench_workflow(None, None, N_FEATURES, TRAIN_SEED,
                                  device=self.dev)
        wf.set_input_dataset(self.data)
        return wf if ckpt is None else wf.with_checkpoint_dir(ckpt)

    def outcome(self, model) -> dict:
        sel = model.stages[-1]
        s = sel.summary
        scored = model.score(data=self.frame)[model.result_features[0].name]
        return {"selection": (s.best_model_type, s.best_hyper,
                              s.best_metric_value),
                "folds": {r.family: np.asarray(r.fold_metrics)
                          for r in s.validation_results},
                "params": to_numpy(sel.fitted.params),
                "scores": scored.values.cpu().numpy()}

    def _same(self, tag: str, model, folds=True, selection=True) -> dict:
        got, want = self.outcome(model), self.ref
        if selection and got["selection"] != want["selection"]:
            raise AssertionError(f"(resume) {tag}: selection "
                                 f"{got['selection']}, unkilled "
                                 f"{want['selection']}")
        if folds and any(not np.array_equal(got["folds"][f], v)
                         for f, v in want["folds"].items()):
            raise AssertionError(f"(resume) {tag}: fold metrics differ")
        if set(got["params"]) != set(want["params"]) or any(
                not np.array_equal(got["params"][k], want["params"][k])
                for k in want["params"]):
            raise AssertionError(f"(resume) {tag}: refit params differ")
        if not np.array_equal(got["scores"], want["scores"]):
            gap = np.abs(got["scores"] - want["scores"]).max()
            raise AssertionError(f"(resume) {tag}: scores differ (max "
                                 f"{gap:.3g})")
        return got

    def _kill(self, ckpt, site, nth, resume=False) -> None:
        from transmogrifai_tpu_torch.robustness import faults
        with faults.injected({site: {"mode": "preempt", "nth": nth}}):
            try:
                self.workflow(ckpt).train(resume=resume)
            except faults.SimulatedPreemption:
                return
        raise AssertionError(f"(resume) the train was not killed at {site}")

    def _resume(self, tag, ckpt, restored_families):
        t0 = time.perf_counter()
        model = self.workflow(ckpt).train(resume=True)
        secs = synced_clock(self.dev) - t0
        res = model.summary()["resume"]
        fams = [r["family"] for r in res["restoredSweepCandidates"]]
        if fams != list(restored_families):
            raise AssertionError(f"(resume) {tag}: restored families {fams},"
                                 f" expected {list(restored_families)}")
        self._same(tag, model)
        self.seconds[tag] = secs
        print(f"(resume) {tag}: resumed in {secs:.3f} s, restored stages "
              f"{len(res['restoredStages'])}, refit stages "
              f"{len(res['refitStages'])}, restored sweep families {fams}")
        return model

    def unkilled(self):
        """(a): the unkilled checkpointed train, bit-equal to (t)'s
        uncheckpointed ``default_binary`` train (the per-family host fetch
        and the commits move no bit)."""
        t0 = time.perf_counter()
        model = self.workflow(os.path.join(self.tmp, "a")).train()
        self.seconds["a"] = synced_clock(self.dev) - t0
        self.ref = self.outcome(model)
        self._same("(a) vs the uncheckpointed train",
                   TRAINED["default_binary"])
        ck = os.path.join(self.tmp, "a")
        files = sorted(os.listdir(ck))
        print(f"(resume) (a) checkpointed train: {self.seconds['a']:.3f} s "
              f"({len(files)} files committed), winner "
              f"{self.ref['selection']}: bit-equal to the uncheckpointed "
              f"train (selection, fold metrics, refit params, "
              f"{len(self.ref['scores'])} scores)")

    def kill_sweep(self):
        self._kill(os.path.join(self.tmp, "b"), "preempt.sweep", 2)

    def resume_sweep(self):
        """(b): killed at ``preempt.sweep`` after LR's records; the resume
        sweeps RF, GBT and SVC on the card."""
        self._resume("(b) preempt.sweep", os.path.join(self.tmp, "b"),
                     self.FAMILIES[:1])

    def kill_refit(self):
        self._kill(os.path.join(self.tmp, "c"), "preempt.refit", 1)

    def resume_refit(self):
        """(c): killed at ``preempt.refit``; every family and the
        upstream stages restore."""
        m = self._resume("(c) preempt.refit", os.path.join(self.tmp, "c"),
                         self.FAMILIES)
        if len(m.summary()["resume"]["restoredStages"]) != 2:
            raise AssertionError("(resume) (c): the upstream stages did not "
                                 "restore")

    def kills(self):
        """(d): killed at ``preempt.stage_fit`` (the second estimator) and
        inside the first checkpoint write; the torn write is reported and
        refit."""
        for site, nth in RESUME_KILLS:
            ck = os.path.join(self.tmp, site)
            self._kill(ck, site, nth)
            m = self._resume(f"(d) {site}", ck, ())
            skipped = m.summary()["faults"]["checkpointsSkipped"]
            if site == "preempt.checkpoint_write" and not skipped:
                raise AssertionError("(resume) (d): the torn checkpoint "
                                     "write was not reported")

    def split(self):
        """(e): ``oom.sweep`` on the RF family halves its grid, and a real
        ``torch.cuda.OutOfMemoryError`` raised once from the RF's fit
        halves one half again: the RF's (F, G) fold metrics are the
        unsplit sweep's bit for bit, and the outcome is unchanged."""
        from transmogrifai_tpu_torch.models.api import MODEL_REGISTRY
        from transmogrifai_tpu_torch.robustness import faults
        rf = type(MODEL_REGISTRY["OpRandomForestClassifier"])
        orig = rf.sweep_fit_batch
        calls = []

        def once(self, *a, **k):
            calls.append(a[2].shape[0])
            if len(calls) == 1:
                raise torch.cuda.OutOfMemoryError(
                    "CUDA out of memory (raised once by chip_smoke)")
            return orig(self, *a, **k)
        rf.sweep_fit_batch = once
        t0 = time.perf_counter()
        try:
            with faults.injected({"oom.sweep": {
                    "mode": "oom", "nth": 1,
                    "key": "OpRandomForestClassifier"}}):
                model = self.workflow().train()
        finally:
            rf.sweep_fit_batch = orig
        self.seconds["e"] = synced_clock(self.dev) - t0
        self._same("(e) oom.sweep", model)
        ds = model.summary()["faults"]["oomDownshifts"]
        splits = [d["detail"]["splitConfigs"] for d in ds]
        G = len(MODEL_REGISTRY["OpRandomForestClassifier"].default_grid(
            "binary"))
        half = G // 2
        if splits != [[half, G - half], [half // 2, half - half // 2]] or \
                "OutOfMemoryError" not in ds[1]["detail"]["error"]:
            raise AssertionError(f"(resume) (e): downshifts {ds}")
        print(f"(resume) (e) oom.sweep on the RF: {self.seconds['e']:.3f} s, "
              f"grid splits {splits} (the second from a real "
              f"torch.cuda.OutOfMemoryError; RF fits of {calls} fold x "
              f"config rows), RF fold metrics bit-equal to the unsplit "
              f"sweep's, winner unchanged, no quarantine")

    def jax_dir(self):
        """(f): the committed directory the JAX package wrote for this
        train, killed at ``preempt.refit``, resumes in the port: every
        family restores from the JAX records, the selection is the JAX
        package's (``serve64/default_binary/summary.json``), and the
        refit on the restored stages gives the unkilled run's scores."""
        ck = os.path.join(self.tmp, "f")
        shutil.copytree(RESUME_FIXTURE, ck)
        t0 = time.perf_counter()
        model = self.workflow(ck).train(resume=True)
        self.seconds["f"] = synced_clock(self.dev) - t0
        res = model.summary()["resume"]
        fams = {r["family"] for r in res["restoredSweepCandidates"]}
        with open(os.path.join(FIXTURES, "default_binary",
                               "summary.json")) as fh:
            want = json.load(fh)
        s = model.stages[-1].summary
        got = (s.best_model_type, s.best_hyper, s.best_metric_value)
        if fams != set(self.FAMILIES) or len(res["restoredStages"]) != 2:
            raise AssertionError(f"(resume) (f): restored {res}")
        if got != (want["winner"], want["hyper"], want["value"]) or \
                got[:2] != self.ref["selection"][:2]:
            raise AssertionError(f"(resume) (f): selection {got}, the JAX "
                                 f"package's {want}, unkilled "
                                 f"{self.ref['selection']}")
        # the metric is the JAX package's (restored); the refit is the
        # port's, on the stages the JAX package fitted
        self._same("(f) the JAX-written directory", model, folds=False,
                   selection=False)
        print(f"(resume) (f) JAX-written directory: resumed in "
              f"{self.seconds['f']:.3f} s, restored stages "
              f"{res['restoredStages']}, restored families {sorted(fams)}, "
              f"winner {got} (the JAX package's), scores bit-equal to the "
              f"unkilled run")

    def campaign(self):
        """(g): a seeded chaos campaign on the card. Its post-mortems
        (replica kills, escaped typed errors) go to a directory of their
        own, and the process's dump counters are reset after it: the
        dumps are rate-limited per process, and a later phase waits for
        its own."""
        from transmogrifai_tpu_torch.observability import postmortem as pm
        from transmogrifai_tpu_torch.robustness.campaign import (
            ChaosCampaign, campaign_sites)
        t0 = time.perf_counter()
        prev = os.environ.get("TG_POSTMORTEM_DIR")
        os.environ["TG_POSTMORTEM_DIR"] = os.path.join(self.tmp,
                                                       "postmortems")
        eng = ChaosCampaign(seed=7, device=self.dev,
                            workdir=os.path.join(self.tmp, "campaign"))
        try:
            doc = eng.run(count=len(campaign_sites()) + 4).to_json()
        finally:
            eng.close()
            pm.reset()
            if prev is None:
                os.environ.pop("TG_POSTMORTEM_DIR", None)
            else:
                os.environ["TG_POSTMORTEM_DIR"] = prev
        secs = time.perf_counter() - t0
        acct = doc["accounting"]
        if (doc["violations"] or doc["uncovered"]
                or doc["coveragePct"] != 100.0 or acct["lost"]
                or acct["failed"] or acct["submitted"] != acct["completed"]
                + acct["shed"] + acct["cancelled"]):
            raise AssertionError("(resume) (g) campaign: " + json.dumps(
                {k: doc[k] for k in ("violations", "uncovered",
                                     "accounting")}, default=str)[:4000])
        by_scenario = {}
        for r in doc["results"]:
            by_scenario[r["scenario"]] = by_scenario.get(r["scenario"], 0) + 1
        print(f"(resume) campaign on {self.dev}: {doc['schedules']} "
              f"schedules {by_scenario}, coverage {doc['coveragePct']}% of "
              f"{doc['sites']} sites, 0 violations, accounting {acct}, "
              f"{secs:.3f} s")

    def runner(self):
        """(h): the runner's train with ``log_stage_metrics``."""
        from transmogrifai_tpu_torch.observability import ledger
        from transmogrifai_tpu_torch.readers.readers import FrameReader
        from transmogrifai_tpu_torch.runner import OpParams, OpWorkflowRunner
        from transmogrifai_tpu_torch.stages.base import Estimator
        wf = self.workflow()
        res = OpWorkflowRunner(wf, train_reader=FrameReader(self.data)).run(
            "train", OpParams(log_stage_metrics=True))
        app = res.metrics["appMetrics"]
        fitted = {type(s).__name__ for s in wf.stages
                  if isinstance(s, Estimator)}
        if not fitted <= set(app["byStage"]):
            raise AssertionError(f"(resume) (h): byStage {app['byStage']} "
                                 f"misses a fitted stage of {fitted}")
        if app["compileCache"]["builds"] != ledger.ledger().total:
            raise AssertionError("(resume) (h): compileCache.builds is not "
                                 "the ledger's")
        self._same("(h) runner", res.model)
        print(f"(resume) (h) runner train with log_stage_metrics: byStage "
              f"{ {k: round(v, 4) for k, v in app['byStage'].items()} }, "
              f"compileCache {app['compileCache']}, device memory peak "
              f"{(app.get('deviceMemory') or {}).get('peak_bytes_in_use')}")


PARQUET_DIR = os.path.join(HERE, "transmogrifai_tpu_torch", "fixtures",
                           "parquet")
#: the JAX fixture's probability_1 against the port's score of the same
#: saved model (the (titanic) phase's limit for the saved Titanic model)
PARQUET_PROB_ATOL = PROB_ATOL


class Parquet:
    """(parquet): the port's Parquet reader and writer on the Titanic and
    leads paths, against ``fixtures/parquet`` (what the JAX package and
    pandas made of the same files) and the (titanic) phase's CSV train in
    this call."""

    def __init__(self, titanic: "Titanic", tmp: str):
        self.t = titanic
        self.tmp = tmp
        with open(os.path.join(PARQUET_DIR, "fixture.json")) as fh:
            self.fx = json.load(fh)
        self.host_s = {}

    def read(self):
        """(1) the committed scoring file's raw Titanic table is the CSV
        reader's of the rebuilt file, bit for bit; (4) the leads features
        file reads as pandas read it; both Titanic files' columns as
        pandas read them (per-column digests)."""
        from transmogrifai_tpu_torch.readers import DataReaders
        from transmogrifai_tpu_torch.testing import (
            column_gaps, columns_digest, load_columns, table_digest,
        )
        from transmogrifai_tpu_torch.utils.parquet import read_parquet
        for name, f in self.fx["files"].items():
            path = os.path.join(PARQUET_DIR, f"{name}.parquet")
            t0 = time.perf_counter()
            cols = read_parquet(path)
            self.host_s[f"read {name}"] = time.perf_counter() - t0
            if columns_digest(cols) != f["columns"]:
                bad = [c for c, d in columns_digest(cols).items()
                       if f["columns"].get(c) != d]
                raise AssertionError(f"parquet: {name} reads otherwise "
                                     f"than pandas did: {bad}")
        gaps = column_gaps(read_parquet(os.path.join(
            PARQUET_DIR, "leads_features.parquet")), load_columns(
            os.path.join(PARQUET_DIR, "leads_features.npz")))
        if gaps:
            raise AssertionError(f"parquet: leads features: {gaps}")
        raw = self.t.workflow().raw_features
        names = [f.name for f in raw]
        t0 = time.perf_counter()
        got = DataReaders.Simple.parquet(
            os.path.join(PARQUET_DIR, "titanic_score.parquet"),
            key_field="PassengerId").generate_table(raw)
        self.host_s["titanic scoring table from Parquet"] = \
            time.perf_counter() - t0
        want = self.t.reader().generate_table(raw)
        if table_digest(got, names) != table_digest(want, names) or [
                got[n].feature_type for n in names] != [
                want[n].feature_type for n in names]:
            raise AssertionError("parquet: the scoring file's raw table "
                                 "differs from the CSV reader's")
        print(f"(parquet) the three committed files read as pandas read "
              f"them (leads {self.fx['leads_rows']} rows: structs, lists, "
              f"dates; whole values); the Titanic scoring table from "
              f"Parquet bit-equal to the CSV reader's ({len(names)} raw "
              f"features, keys)")

    def train(self):
        """(2) the port writes the 20,000-row training frame to Parquet;
        the Titanic workflow trains through ``OpWorkflowRunner`` from it:
        winner, every family's fold metrics and the LR refit's params
        bit-equal to the (titanic) phase's CSV train."""
        from transmogrifai_tpu_torch.examples.titanic import TITANIC_SCHEMA
        from transmogrifai_tpu_torch.readers import DataReaders, read_csv
        from transmogrifai_tpu_torch.runner import (
            OpParams, OpWorkflowRunner, write_parquet,
        )
        from transmogrifai_tpu_torch.testing import selection_summary

        frame = read_csv(self.t.train_csv, TITANIC_SCHEMA, header=False)
        path = os.path.join(self.tmp, "titanic_train.parquet")
        t0 = time.perf_counter()
        write_parquet(path, frame)
        self.host_s["write the training frame"] = time.perf_counter() - t0
        wf = self.t.workflow()
        runner = OpWorkflowRunner(wf, train_reader=DataReaders.Simple.parquet(
            path, key_field="PassengerId"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = runner.run("train", OpParams()).model
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ref = self.t.model
        got_sel = selection_summary(model.stages[-1].summary)
        want_sel = selection_summary(ref.stages[-1].summary)
        if got_sel != want_sel:
            raise AssertionError("parquet: the Parquet train's selection "
                                 "differs from the CSV train's")
        gp = to_numpy(model.stages[-1].fitted.params)
        rp = to_numpy(ref.stages[-1].fitted.params)
        if sorted(gp) != sorted(rp) or not all(
                np.array_equal(gp[k], rp[k]) for k in rp):
            raise AssertionError("parquet: the refit's params differ from "
                                 "the CSV train's")
        print(f"(parquet) titanic train from Parquet ({os.path.getsize(path)}"
              f" bytes) through OpWorkflowRunner in {secs:.3f} s: winner "
              f"{got_sel['winner']} {got_sel['hyper']}, every family's fold "
              f"metrics and the refit's params bit-equal to the CSV train")
        self.train_s = secs

    def score(self):
        """(3) a score run of the JAX-saved Titanic model over the
        committed scoring file writes ``.parquet``; read back it holds the
        returned scores; probability_1 within PARQUET_PROB_ATOL of the JAX
        package's score file, keys equal."""
        from transmogrifai_tpu_torch.readers import DataReaders
        from transmogrifai_tpu_torch.runner import (
            OpParams, OpWorkflowRunner, table_to_frame, write_parquet,
        )
        from transmogrifai_tpu_torch.testing import column_gaps
        from transmogrifai_tpu_torch.utils.parquet import read_parquet

        out = os.path.join(self.tmp, "scores.parquet")
        runner = OpWorkflowRunner(
            self.t.workflow(), score_reader=DataReaders.Simple.parquet(
                os.path.join(PARQUET_DIR, "titanic_score.parquet"),
                key_field="PassengerId"))
        t0 = time.perf_counter()
        res = runner.run("score", OpParams(
            model_location=os.path.join(TITANIC_DIR, "model"),
            write_location=out))
        self.host_s["score run with its Parquet write"] = \
            time.perf_counter() - t0
        t0 = time.perf_counter()
        back = read_parquet(out)
        self.host_s["read the scores back"] = time.perf_counter() - t0
        # the run's file holds the returned scores: it reads as a direct
        # write of their frame reads
        frame = table_to_frame(res.scores)
        again = os.path.join(self.tmp, "scores_again.parquet")
        write_parquet(again, frame)
        gaps = column_gaps(back, read_parquet(again))
        if gaps:
            raise AssertionError(f"parquet: the written scores differ from "
                                 f"the returned ones: {gaps}")
        want = read_parquet(os.path.join(PARQUET_DIR,
                                         "titanic_scores.parquet"))
        pred = self.fx["prediction"]
        if back["key"].tolist() != want["key"].tolist():
            raise AssertionError("parquet: score keys differ from the JAX "
                                 "package's")
        p1 = np.array([d["probability_1"] for d in back[pred]])
        w1 = np.array([d["probability_1"] for d in want[pred]])
        err = float(np.abs(p1 - w1).max())
        if not err <= PARQUET_PROB_ATOL:
            raise AssertionError(f"parquet: probability_1 off the JAX "
                                 f"package's by {err}")
        print(f"(parquet) score run wrote {os.path.getsize(out)} bytes of "
              f"Parquet ({len(frame.columns)} columns x {frame.num_rows} "
              f"rows), read back equal to the returned scores; "
              f"probability_1 max |d| {err:.3g} from the JAX package's "
              f"score file, keys equal")

    def report(self):
        print(json.dumps({"parquet_host_s": {
            k: round(v, 4) for k, v in self.host_s.items()},
            "parquet_train_s": round(self.train_s, 4)}))


#: the (cli) phase's load: seconds and requests/s a run
CLI_SECONDS = 1.0
CLI_RPS = 200.0
#: requests of each served command held to the micro-batch scorer
CLI_SERVED_SAMPLE = 32


class Cli:
    """(cli): the port's command line on the card, as a user runs it
    (``cli.main``): ``serve`` (with ``--output``, then ``--listen``),
    ``slo``, ``fleet --replicas 2 --kill`` on copies of ``serve64/gbt``,
    ``trace``, ``doctor`` on the kill's post-mortem, and ``gen`` on the
    Titanic training file, whose app trains in a subprocess."""

    def __init__(self, titanic: "Titanic", tmp: str):
        self.t = titanic
        self.tmp = os.path.join(tmp, "cli")
        os.makedirs(self.tmp)
        self.secs = {}
        #: per command, the (row, future) pairs of its first requests
        self.kept = {}

    def _model(self, name):
        d = os.path.join(self.tmp, name)
        shutil.copytree(os.path.join(FIXTURES, "gbt"), d)
        return d

    def _main(self, tag, argv):
        from transmogrifai_tpu_torch import cli
        from transmogrifai_tpu_torch.testing import served_sample
        t0 = time.perf_counter()
        try:
            with served_sample(CLI_SERVED_SAMPLE) as kept:
                cli.main(argv)
        except SystemExit as e:
            raise AssertionError(f"cli {tag}: exited {e.code}") from None
        finally:
            self.secs[tag] = time.perf_counter() - t0
        if kept:
            self.kept[tag] = kept

    @staticmethod
    def _lost_nothing(tag, path):
        with open(path) as fh:
            load = json.load(fh)["load"]
        if load["lost"] or load["failed"] or not load["completed"]:
            raise AssertionError(f"cli {tag}: lost {load['lost']}, failed "
                                 f"{load['failed']}, completed "
                                 f"{load['completed']}")
        return load

    def serve(self):
        out = os.path.join(self.tmp, "serve")
        self._main("serve", ["serve", "--model", self._model("serve_gbt"),
                             "--seconds", str(CLI_SECONDS), "--rps",
                             str(CLI_RPS), "--output", out])
        for f in ("trace.json", "spans.jsonl", "metrics.prom",
                  "serve_summary.json"):
            if not os.path.getsize(os.path.join(out, f)):
                raise AssertionError(f"cli serve: {f} empty")
        self.serve_load = self._lost_nothing(
            "serve", os.path.join(out, "serve_summary.json"))

    def listen(self):
        out = os.path.join(self.tmp, "listen")
        self._main("serve --listen", [
            "serve", "--model", self._model("listen_gbt"), "--seconds",
            str(CLI_SECONDS), "--rps", str(CLI_RPS), "--listen",
            "127.0.0.1:0", "--output", out])
        self._lost_nothing("serve --listen",
                           os.path.join(out, "serve_summary.json"))

    def slo(self):
        out = os.path.join(self.tmp, "slo")
        self._main("slo", ["slo", "--model", self._model("slo_gbt"),
                           "--seconds", str(CLI_SECONDS), "--rps",
                           str(CLI_RPS), "--intervals", "2",
                           "--availability", "0.9", "--output", out])
        with open(os.path.join(out, "slo_summary.json")) as fh:
            load = json.load(fh)["load"]
        if load["lost"] or load["failed"] or not load["completed"]:
            raise AssertionError(f"cli slo: {load}")

    def fleet(self):
        from transmogrifai_tpu_torch.observability import postmortem as pm
        out = os.path.join(self.tmp, "fleet")
        self.pm_dir = os.path.join(self.tmp, "postmortems")
        # the autoscaler keeps two replicas (at this light load it would
        # retire one, and the kill would leave none to fail over to)
        env = {"TG_POSTMORTEM_DIR": self.pm_dir, "TG_FLEET_MIN": "2"}
        prev = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        pm.reset()
        try:
            self._main("fleet --kill", [
                "fleet", "--model", self._model("fleet_gbt"), "--replicas",
                "2", "--seconds", str(CLI_SECONDS), "--rps", str(CLI_RPS),
                "--kill", "--output", out])
        finally:
            for k, v in prev.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        self._lost_nothing("fleet --kill",
                           os.path.join(out, "fleet_summary.json"))
        with open(os.path.join(out, "fleet_summary.json")) as fh:
            doc = json.load(fh)
        states, routing = doc["replicaStates"], doc["routing"]
        no_replica = doc["fleet"]["sheds"]["no_replica"]
        if states.get("r0") != "dead" or no_replica or not sum(
                v for r, v in routing.items() if r != "r0"):
            raise AssertionError(f"cli fleet: the kill did not fail over: "
                                 f"states {states}, routing {routing}, "
                                 f"{no_replica} shed for no replica")
        self.fleet_routing = routing

    def trace(self):
        out = os.path.join(self.tmp, "trace")
        self._main("trace", ["trace", "--output", out, "--rows", "600"])
        for f in ("trace.json", "spans.jsonl", "metrics.prom",
                  "summary.json"):
            if not os.path.getsize(os.path.join(out, f)):
                raise AssertionError(f"cli trace: {f} empty")

    def doctor(self):
        import contextlib
        import io
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            self._main("doctor", ["doctor", self.pm_dir])
        text = buf.getvalue()
        if "replica_lost" not in text or "doctor verdict: ok" not in text:
            raise AssertionError(f"cli doctor: {text[-600:]}")

    def gen(self):
        """``gen`` on the Titanic training file (a header line added) with
        an answers file; the generated app trains in one subprocess on
        the card (``TG_FAST_GRIDS=1``)."""
        from transmogrifai_tpu_torch.examples.titanic import TITANIC_SCHEMA
        data = os.path.join(self.tmp, "titanic.csv")
        with open(self.t.train_csv) as src, open(data, "w") as dst:
            dst.write(",".join(TITANIC_SCHEMA) + "\n")
            shutil.copyfileobj(src, dst)
        answers = os.path.join(self.tmp, "answers.txt")
        with open(answers, "w") as fh:
            fh.write("problem=binary\nrole.Name=drop\nrole.Ticket=drop\n"
                     "type.Pclass=PickList\ntype.Cabin=PickList\n")
        proj = os.path.join(self.tmp, "app")
        self._main("gen", ["gen", "--input", data, "--response", "Survived",
                           "--id-field", "PassengerId", "--output", proj,
                           "--name", "TitanicApp", "--answers", answers])
        env = dict(os.environ, PYTHONPATH=HERE, TG_FAST_GRIDS="1")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "app.py", "--run-type", "train",
                            "--model-location",
                            os.path.join(self.tmp, "app_model")],
                           cwd=proj, env=env, capture_output=True,
                           text=True, timeout=300)
        self.secs["generated app train (subprocess)"] = \
            time.perf_counter() - t0
        if r.returncode or not os.path.isfile(
                os.path.join(self.tmp, "app_model", "plan.json")):
            raise AssertionError(f"cli gen: the generated app's train "
                                 f"failed: {r.stderr[-2000:]}")

    def check_served(self):
        """The first requests that ``serve``, ``slo`` and ``fleet --kill``
        submitted: their served records bit-equal to the micro-batch
        scorer's on the same rows (the (serving) phase's limit). Outside
        the counted paths."""
        from transmogrifai_tpu_torch.persistence import load_model
        from transmogrifai_tpu_torch.testing import served_gaps
        if sorted(self.kept) != ["fleet --kill", "serve", "slo"]:
            raise AssertionError(f"cli: served samples of {sorted(self.kept)}")
        model = load_model(os.path.join(FIXTURES, "gbt"),
                           device=torch.device("cuda", 0))
        for tag, kept in self.kept.items():
            gaps = served_gaps(model, kept)
            if gaps:
                raise AssertionError(f"cli {tag}: served records differ from "
                                     f"the micro-batch scorer's: {gaps[:2]}")
        self.served = {tag: len(kept) for tag, kept in self.kept.items()}

    def report(self):
        print(f"(cli) served records bit-equal to the micro-batch scorer's "
              f"({self.served} requests sampled)")
        print(f"(cli) serve {self.serve_load['completed']} completed, 0 "
              f"lost; serve --listen, slo and fleet --kill lost nothing "
              f"(the kill's routing {self.fleet_routing}); "
              f"trace wrote its four files; doctor rendered the kill's "
              f"post-mortem; the generated Titanic app trained")
        print(json.dumps({"cli_s": {k: round(v, 4)
                                    for k, v in self.secs.items()}}))


#: the (plan) phase's saved models: heaps, slot chains, 6-class heaps
#: and a linear family
PLAN_KEYS = ("gbt", "gbt12", "rf", "xgbmc", "lr")
#: request counts planned against eager (buckets 256 and 512; each
#: bucket's first dispatch runs eagerly, its second captures), then the
#: 4,096 rows of ``score_frame()`` as one batch score, twice
PLAN_ROWS = (1, 37, 256, 300, 300, 256, 37, 1)
#: a linear family's planned records against eager: the serve limit
#: (``linear_flush``), for a matmul that may run another cuBLAS kernel at
#: another row count; on the card the eager predict also runs at the
#: bucket, so the gap reads 0
PLAN_LINEAR_ATOL = PROB_ATOL
#: the ``oom.plan`` drill's rows: two halves of 256, one bucket each
PLAN_OOM_ROWS = 512
#: eager dispatches at least this many times the planned ones (Titanic),
#: as ``tests/test_plan.py`` holds the JAX package's
PLAN_DISPATCH_FACTOR = 5


class PlanPhase:
    """(plan): the transform-plan compiler on the card (``plan.py``: one
    CUDA graph per segment and bucket)."""

    def __init__(self, titanic: "Titanic"):
        from transmogrifai_tpu_torch.testing import request_rows, score_frame
        self.titanic = titanic
        self.frame = score_frame()
        self.rows = request_rows(self.frame)
        self.times = {}

    @staticmethod
    def _model(key):
        import transmogrifai_tpu_torch as tt
        model = tt.load_model(os.path.join(SERVING_DIR, key))
        if model.device.type != "cuda":
            raise AssertionError(f"(plan) {key} loaded on {model.device}")
        return model

    @staticmethod
    def _eager(fn):
        from transmogrifai_tpu_torch import plan
        plan.enable_planning(False)
        try:
            return fn()
        finally:
            plan.enable_planning(None)

    @staticmethod
    def _plans(model):
        """The cached plans over the model's stages."""
        from transmogrifai_tpu_torch import plan
        ids = {id(s) for s in model.stages}
        return [p for p, stages in list(plan._PLAN_CACHE.values())
                if p is not None and {id(s) for s in stages} <= ids]

    def _same(self, key, linear, got, want, tag):
        """Records (or parts) planned against eager: bit-equal, a linear
        family's within PLAN_LINEAR_ATOL. Returns the largest gap."""
        gap = 0.0
        for k in want:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            if np.array_equal(g.view(np.int32), w.view(np.int32)):
                continue
            gap = max(gap, float(np.abs(g - w).max()))
            if not linear or gap > PLAN_LINEAR_ATOL:
                raise AssertionError(f"(plan) {key} {tag}: {k} planned "
                                     f"differs from eager by {gap}")
        return gap

    def run(self):
        """The counted path: every model planned against eager, the Titanic
        score's dispatches, the two drills; no ``plan_fallback`` outside
        the armed drill."""
        from transmogrifai_tpu_torch.local.scoring import (
            micro_batch_score_function)
        from transmogrifai_tpu_torch.robustness.policy import FaultLog
        t0 = time.perf_counter()
        log = FaultLog()
        with log.activate():
            for key in PLAN_KEYS:
                self._model_check(key, micro_batch_score_function)
            self._titanic()
        fallbacks = log.of_kind("plan_fallback")
        if fallbacks:
            raise AssertionError(f"(plan) {len(fallbacks)} plan_fallback "
                                 f"record(s) on clean paths: "
                                 f"{fallbacks[0].detail}")
        self._drills(micro_batch_score_function)
        self.times["path_s"] = time.perf_counter() - t0

    def _model_check(self, key, mb_of):
        model = self._model(key)
        linear = key == "lr"
        mb = mb_of(model)
        gaps = {}
        for n in PLAN_ROWS:
            rows = self.rows[:n]
            got = _record_parts(model, mb(rows))
            want = _record_parts(model, self._eager(lambda: mb(rows)))
            gaps[n] = max(gaps.get(n, 0.0),
                          self._same(key, linear, got, want, f"{n} rows"))
        torch.cuda.synchronize()
        want = _parts_of(model, self._eager(
            lambda: model.score(data=self.frame)))
        gaps[len(self.rows)] = max(
            self._same(key, linear,
                       _parts_of(model, model.score(data=self.frame)), want,
                       f"4,096-row score {i}") for i in (1, 2))
        segs = []
        for p in self._plans(model):
            for i, seg in enumerate(p.segments):
                segs.append({
                    "plan": p.ident_hash, "segment": i,
                    "stages": [type(s).__name__ for s in seg.stages],
                    "in": seg.in_names, "out": seg.out_names,
                    "buckets": sorted(seg.seen_buckets),
                    "capture_s": [round(c, 4) for _, c in seg.captures],
                    "replays": seg.replays})
        print(json.dumps({"plan_model": key, "max_abs_gap_by_rows": gaps,
                          "segments": segs}))

    def _titanic(self):
        """The card-trained Titanic model: the scoring file planned against
        eager (its LR winner within PLAN_LINEAR_ATOL) and the dispatches
        of each, ``tg_dispatch_total``."""
        from transmogrifai_tpu_torch.observability import metrics as om
        from transmogrifai_tpu_torch.readers import read_csv
        t = self.titanic
        model = t.model
        data = read_csv(t.score_csv, t.reader().schema,
                        header=False).columns

        def dispatches(fn):
            om.reset()
            om.enable_metrics(True)
            try:
                out = fn()
                snap = om.registry().snapshot().get("tg_dispatch_total", {})
            finally:
                om.enable_metrics(None)
                om.reset()
            return out, sum(snap.values())
        got, planned_n = dispatches(lambda: model.score(data=data))
        want, eager_n = dispatches(lambda: self._eager(
            lambda: model.score(data=data)))
        gap = self._same("titanic", True, _parts_of(model, got),
                         _parts_of(model, want), "scoring file")
        if eager_n < PLAN_DISPATCH_FACTOR * planned_n or not planned_n:
            raise AssertionError(f"(plan) titanic: {eager_n} eager "
                                 f"dispatches against {planned_n} planned")
        print(json.dumps({"plan_titanic": {
            "dispatches": {"planned": planned_n, "eager": eager_n},
            "max_abs_gap": gap}}))

    def _drills(self, mb_of):
        """``plan.segment_execute`` armed once: one ``plan_fallback``, the
        clean records; ``oom.plan`` armed at PLAN_OOM_ROWS rows: one
        ``oom_downshift``, the clean records bit-equal."""
        from transmogrifai_tpu_torch.robustness import faults
        from transmogrifai_tpu_torch.robustness.policy import FaultLog
        model = self._model("gbt")
        mb = mb_of(model)
        rows = self.rows[:PLAN_OOM_ROWS]
        clean = mb(rows)
        for site, mode, kind in (("plan.segment_execute", "raise",
                                  "plan_fallback"),
                                 ("oom.plan", "oom", "oom_downshift")):
            log = FaultLog()
            spec = {"mode": mode, "nth": 1, "count": 1}
            if mode == "raise":
                spec["transient"] = True
            with faults.injected({site: spec}), log.activate():
                got = mb(rows)
            kinds = [r.kind for r in log.reports]
            if kinds != [kind] or got != clean:
                raise AssertionError(f"(plan) {site}: records "
                                     f"{'equal' if got == clean else 'differ'}"
                                     f", fault log {kinds}")
        print(f"(plan) drills: plan.segment_execute -> one plan_fallback, "
              f"oom.plan at {PLAN_OOM_ROWS} rows -> one oom_downshift "
              f"({PLAN_OOM_ROWS // 2} + {PLAN_OOM_ROWS // 2}); records "
              f"bit-equal to the clean run's")

    def held(self):
        """Past the counted path: fresh plans of the tree models with both
        predicts wrapped (``_KernelChecks``), so each launch a replay runs
        is held to plain after the replay (sums bit-equal, leaf ids
        exact); each bucket's capture seconds and a 256-row flush's
        dispatch, planned and eager."""
        from transmogrifai_tpu_torch import plan
        from transmogrifai_tpu_torch.local.scoring import (
            ServeStages, micro_batch_score_function)
        plan.clear_plan_cache()
        replays, expect = {}, {}
        with _KernelChecks(only=SERVING_PREDICTS) as checks:
            for key in ("gbt", "rf", "xgbmc", "gbt12"):
                model = self._model(key)
                mb = micro_batch_score_function(model)
                for n in (256, 300, 256, 300):
                    mb(self.rows[:n])
                torch.cuda.synchronize()
                for p in self._plans(model):
                    for seg in p.segments:
                        for g in seg.graphs.values():
                            for k, c in g.launches.items():
                                replays[k.name] = (replays.get(k.name, 0)
                                                   + c * g.replays)
                                # and the bucket's eager first dispatch
                                expect[k.name] = (expect.get(k.name, 0)
                                                  + c * (g.replays + 1))
        for name in SERVING_PREDICTS:
            if not replays.get(name) or checks.held.get(name) != \
                    expect[name]:
                raise AssertionError(f"(plan) {name}: {replays.get(name)} "
                                     f"launches in replays and "
                                     f"{expect.get(name)} with the first "
                                     f"dispatches"
                                     f", {checks.held.get(name, 0)} held")
        print(f"(plan) replayed launches held to plain (sums bit-equal, "
              f"leaf ids exact): " + ", ".join(
                  f"{k} {replays[k]} in replays, {checks.held.get(k, 0)} "
                  f"held" for k in SERVING_PREDICTS))
        model = self._model("gbt")
        st = ServeStages(model)
        rows = self.rows[:SERVE_MAX_BATCH]
        flush = {}
        for arm in ("planned", "eager", "eager", "planned"):
            def one():
                table = st.gather(rows)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                inflight = st.dispatch(table)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                st.flatten(inflight, len(rows))
                return secs
            run = one if arm == "planned" else (lambda: self._eager(one))
            run()
            flush.setdefault(arm, []).append(
                round(1e3 * statistics.median(run() for _ in range(5)), 4))
        print(json.dumps({"plan_flush_dispatch_ms_256": flush}))

    def turns(self):
        """In turns planned and eager, each arm from an empty plan cache:
        the Titanic train (records on the scoring file bit-equal across
        the arms), then the 65,536-row score's first call (the plan built,
        each segment run eagerly at the bucket) and second (captured and
        replayed). Each with its peak device memory and the bytes it
        leaves allocated: a train's model and its cached plans, a score's
        cached plan and graphs."""
        import gc

        from transmogrifai_tpu_torch import plan
        from transmogrifai_tpu_torch.readers import read_csv
        t = self.titanic
        data = read_csv(t.score_csv, t.reader().schema,
                        header=False).columns
        reps = N_ROWS // len(next(iter(data.values())))
        big = {k: np.tile(v, reps) for k, v in data.items()}

        def measured(fn):
            plan.clear_plan_cache()
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            out = fn()
            gc.collect()
            torch.cuda.synchronize()
            return out, (torch.cuda.max_memory_allocated() - before,
                         torch.cuda.memory_allocated() - before)

        def train():
            wf = t.workflow()
            t0 = time.perf_counter()
            model = wf.train()
            torch.cuda.synchronize()
            return model, [time.perf_counter() - t0]

        def score():
            secs = []
            for _ in range(2):
                t0 = time.perf_counter()
                _parts_of(t.model, t.model.score(data=big))
                secs.append(time.perf_counter() - t0)
            return None, secs

        out = {}
        for what, fn in (("train", train), ("score_65536", score)):
            rec = out[what] = {"s": {}, "peak_bytes": {}, "left_bytes": {}}
            parts = {}
            for arm in ("planned", "eager", "eager", "planned"):
                run = fn if arm == "planned" else (lambda: self._eager(fn))
                (model, secs), (peak, left) = measured(run)
                if model is not None:
                    parts[arm] = self._eager(
                        lambda: _parts_of(model, model.score(data=data)))
                del model
                rec["s"].setdefault(arm, []).append(
                    [round(x, 4) for x in secs])
                rec["peak_bytes"].setdefault(arm, []).append(peak)
                rec["left_bytes"].setdefault(arm, []).append(left)
            if parts:
                self._same("titanic train", False, parts["planned"],
                           parts["eager"], "planned against eager train")
        plan.clear_plan_cache()
        print(json.dumps({"plan_titanic_turns": out}))


def _plan_paths(titanic: "Titanic", run_path):
    """The (plan) phase: its counted path, then the held replays and the
    times. (paths, seconds)."""
    from transmogrifai_tpu_torch import plan
    from transmogrifai_tpu_torch.ops import forest as F
    t0 = time.perf_counter()
    phase = PlanPhase(titanic)
    plan.clear_plan_cache()
    paths = {"plan": run_path("plan", phase.run,
                              (F.FOREST_PREDICT_HEAP,
                               F.FOREST_PREDICT_CHAIN))}
    phase.held()
    phase.turns()
    return paths, time.perf_counter() - t0


def _parquet_paths(titanic: "Titanic", tmp: str, run_path):
    """The (parquet) phase's counted paths, after the (titanic) phase's
    CSV train: the committed files read, the Titanic train from Parquet
    (the sweep kernels, bit-equal to the CSV train), a score run written
    as Parquet (the saved model's LR: no kernel). (paths, seconds)."""
    from transmogrifai_tpu_torch.histeng import kernels as HK
    from transmogrifai_tpu_torch.ops import forest as F
    sweep = (HK.HIST_MATMUL, HK.NODE_HIST, F.FOREST_PREDICT_CHAIN)
    t0 = time.perf_counter()
    parquet = Parquet(titanic, tmp)
    paths = {"read parquet": run_path("read parquet", parquet.read, ())}
    paths["train parquet"] = run_path("train parquet", parquet.train, sweep)
    paths["score parquet"] = run_path("score parquet", parquet.score, ())
    parquet.report()
    return paths, time.perf_counter() - t0


def _cli_paths(titanic: "Titanic", tmp: str, run_path):
    """The (cli) phase's counted paths: the command line on copies of
    serve64/gbt (heap predicts), ``trace``, then ``doctor``, ``gen`` and
    the served records' check outside the counts. (paths, seconds)."""
    from transmogrifai_tpu_torch.ops import forest as F
    t0 = time.perf_counter()
    cli = Cli(titanic, tmp)
    heap = (F.FOREST_PREDICT_HEAP,)
    paths = {"cli serve": run_path("cli serve", cli.serve, heap)}
    paths["cli serve --listen"] = run_path("cli serve --listen", cli.listen,
                                           heap)
    paths["cli slo"] = run_path("cli slo", cli.slo, heap)
    paths["cli fleet --kill"] = run_path("cli fleet --kill", cli.fleet, heap)
    paths["cli trace"] = run_path("cli trace", cli.trace, ())
    cli.check_served()
    cli.doctor()
    cli.gen()
    cli.report()
    return paths, time.perf_counter() - t0


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
    tickets = Tickets()
    phase_nlp_device(dev)
    leads_kern.update(tickets.check_inputs())
    events = Events(tmp)
    leads_kern.update(events.check_inputs())

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
    phase_s = {}
    pq_paths, phase_s["parquet"] = _parquet_paths(titanic, tmp, run_path)
    paths.update(pq_paths)
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
    # the ticket sweep's trees launch the three sweep kernels; word2vec
    # and LDA run as tensor code on the card
    paths["train tickets"] = run_path("train tickets", tickets.train, sweep)
    paths["serve tickets"] = run_path("serve tickets", tickets.serve,
                                      _forest_kernels(tickets.model))
    # the events sweep grows the RF (node_hist) and the GBT (hist_matmul)
    # and scores their folds with the chain and heap predicts; LOCO scores
    # the winner's variants with its predict kernel
    paths["train events"] = run_path(
        "train events", events.train,
        (hist, node, F.FOREST_PREDICT_CHAIN, F.FOREST_PREDICT_HEAP))
    paths["serve events"] = run_path(
        "serve events", events.serve,
        _forest_kernels(events.model, events.pred))
    paths.update(_stream_paths(Stream(dev), run_path))
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
    paths.update(_resume_paths(Resume(tmp, dev), run_path))
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
    serving = Serving(tmp)
    paths["serving"] = run_path(
        "serving", lambda: (serving.starts(), serving.run()),
        (F.FOREST_PREDICT_HEAP, F.FOREST_PREDICT_CHAIN))
    serving.after(paths["serving"])
    fleet = Fleet(tmp)
    paths["fleet"] = run_path("fleet", fleet.run,
                              (F.FOREST_PREDICT_HEAP, F.FOREST_PREDICT_CHAIN))
    fleet.after(paths["fleet"])
    cli_paths, phase_s["cli"] = _cli_paths(titanic, tmp, run_path)
    paths.update(cli_paths)
    plan_paths, phase_s["plan"] = _plan_paths(titanic, run_path)
    paths.update(plan_paths)
    print(json.dumps({"phase_s": {k: round(v, 3)
                                  for k, v in phase_s.items()}}))
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
