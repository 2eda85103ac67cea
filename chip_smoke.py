#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU.

    python3 chip_smoke.py

The main paths are GBM and DRF training followed by scoring, at the
HIGGS-shaped width of 1,000,000 rows x 28 features the repository
benchmarks, the path a user takes first: a CSV parsed, a GBM trained on
it and explained, GLM with every family and solver, then KMeans,
DeepLearning, GAM and RuleFit, then PCA, SVD, GLRM, Word2Vec,
NaiveBayes and CoxPH, then IsotonicRegression, Aggregator,
TargetEncoder, ModelSelection, AnovaGLM, PSVM, Infogram,
StackedEnsemble and Grep, then the trained models served: MOJO files
written and read, the array fast path, Generic and ScoringEngine, and
the serving layers above it: micro-batching, the deployment registry,
the load breaker and the replica fleet; then the other ingest formats
(SVMLight with sparse columns feeding a GBM, ARFF, Avro, XLSX/XLS), a
remote path, a frame snapshot, streaming ingest and the cluster
timezone; then the data plane below Rapids: map_reduce, quantiles, and
the sort, filter, take, group-by and merge verbs; then builds run as
jobs, their models and frames published in the DKV and read back by
key, and a user's distribution and metric.  Every training runs as a
job of the process registry (core/job.py) and publishes its model in
the DKV; main removes what each phase published once it returns.
Phases (each
prints one JSON line; any failure raises and the exit code is not 0):

  0 device  - card name and power limit
  1 build   - nvcc builds the histogram kernels from h2o_tpu_torch/csrc
  2 K1      - hist_cuda at the QuantilesGlobal shapes (uint8 bins, B=64,
              L = 1..16) in f32, bf16, int16 and int8 modes: held against
              the plain PyTorch version, launched twice and once on
              row-permuted inputs (all three bitwise equal), f32 and int16
              timed, f32 beside its bound, the plain version and
              index_add_; at the first shape an active row's NaN stat must
              come out NaN in its slot
  3 K2      - hist_cuda_adaptive at the default-GBM shapes (int16 fine
              bins, F=1024, (L, Bd) = (1,1024) .. (16,64)), likewise
  3f frontier - K1 and K2 at the sparse-frontier shape of a default DRF
              (L = 4,096 live leaves, B = 20) in f32 and int16: held
              against the plain version, bitwise under repeat and row
              permutation, timed beside the bound
  4 default GBM (UniformAdaptive) on 1M x 28: K2 must carry every level;
    then the same GBM on the first 100,000 rows on the card and on the
    CPU (the plain versions) must grow the same first tree
  5 QuantilesGlobal GBM (nbins=64): K1 must carry every level
  6 scoring - predict() on the training frame reproduces the training AUC
  8 stochastic GBM - sample_rate 0.7, col_sample_rate 0.8,
              col_sample_rate_per_tree 0.9, int16 stats: Random histograms
              (K2 must carry every level), then QuantilesGlobal nbins=64
              (K1 every level, sibling subtraction on the int32 tables);
              the Random GBM on the first 100,000 rows on the card and on
              the CPU must grow the same first tree
  9 DRF     - defaults (depth 20 on the sparse-frontier engine, mtries 5,
              sample_rate 0.632) with ntrees cut to DRF_TREES: K2 must
              carry all 20 levels of every tree, predict() reproduces the
              training AUC; 2 trees on the first 100,000 rows on the card
              and on the CPU must be equal (0/1 stats sum exactly)
  3x K2 at the XGBoost shapes (int16 fine bins, F=1024, (L, Bd) = (8,256),
              (16,256), (32,256)) in f32 and int16, as phase 3f
  3c K2 at the covertype frame's shape (581,012 x 54, 44 one-hot columns
              in two fine bins each): the deepest multinomial GBM level
              (16, 64) and the multiclass DRF's frontier (4096, 20), in
              f32 and int16, as phase 3f
 10 XGBoost gbtree at its defaults (max_bins 256, depth 6, eta 0.3,
              reg_lambda 1, Newton leaves) with 20 trees: K2 must carry all
              6 levels of every tree (120 launches); predict() reproduces
              the training AUC; 2 trees on the first 100,000 rows on the
              card and on the CPU must grow the same first tree.  Then dart
              (rate_drop 0.1, skip_drop 0.5, seed 1, 10 trees): 60 K2
              launches, the AUC from predict()
 11 multinomial on a covertype-shaped frame (581,012 x 54: 10 normal
              columns, a 4-way and a 40-way one-hot block, 7 classes with
              covertype's class counts, the label from a seeded softmax
              signal): the default GBM with 20 iterations (K2 700 launches)
              and the default DRF with 3 iterations (21 trees of depth 20,
              420 launches); logloss and mean per-class error reproduced by
              predict(); one GBM iteration on the first 100,000 rows and
              one DRF iteration on the first 25,000 equal on the card and
              on the CPU
 12 distributions, weights, offset, monotone: poisson, gamma, tweedie,
              laplace, quantile and huber GBMs (3 trees on 100,000 rows, a
              response made for each) and a bernoulli GBM with a weights
              column (uniform 0.5-2) and an offset column, each growing the
              same first tree on the card and on the CPU; a 20-tree GBM at
              1M x 28 with monotone_constraints {x0: 1, x1: -1} whose
              link-scale predictions are monotone along a 64-point grid of
              each constrained column over 1,000 sampled rows
 13 the training loop on the 1M rows of make_data(1,250,000, 28, seed 0)
              with its last 250,000 rows as the validation frame:
              13a a default GBM of up to 300 trees with stopping_rounds 3
              (logloss), tolerance 1e-3 and score_tree_interval 5: K2 5
              launches a tree, the last scoring-history row equal to a full
              re-score of the validation frame to 1e-6; then 50 trees with
              and without score_tree_interval 5 in turns, and one scoring
              round timed alone: the cost of a round over 250,000 rows;
              13b 20 trees (learn_rate_annealing 0.99) in one call and in
              blocks of 3, and a default DRF of 10 trees in one call and in
              blocks of 4: equal node arrays, values within 1e-6;
              13c a 10-tree GBM saved, loaded (predict() bitwise the same)
              and resumed from the file to 20 trees: equal to 13b's
              uninterrupted forest; 13d a 20-tree GBM with 5 Modulo folds
              (K2 600 launches): CV AUC mean and sd, wall against one
              training; 13e a DRF (10 trees, stopping_rounds 2, interval 2)
              and XGBoost gbtree (20 trees, score_each_iteration,
              stopping_rounds 3) with the validation frame; 13f 6 trees
              with score_tree_interval 2 on the first 100,000 training and
              25,000 validation rows on the card and on the CPU: the same
              first tree, every scoring-history value within 1e-5
  3u K1_uplift - hist_cuda at UpliftDRF's shapes (1M rows x 12 columns,
              B = 20, L = 1, 64, 512: the frontier widths of depth-10 trees)
              in f32 and int16, as phase 3f
 14 the rest of the tree family at full width:
              14a DT at its defaults (one tree of depth 10 over every column)
              on the 1M x 28 frame: K2 10 launches, training AUC reproduced
              by predict(), the scoring wall; the first 100,000 rows grow the
              same tree on the card and on the CPU;
              14b IsolationForest at H2O-3's defaults (50 trees, sample_size
              256, depth 8) on the same frame with 10,000 rows (1 %) shifted
              by +4 in 3 columns: the AUC of the anomaly score against the
              planted label; 10 trees on the first 100,000 rows equal on the
              card and on the CPU (split columns and thresholds);
              14c ExtendedIsolationForest (100 trees, sample_size 256) at
              extension_level 0 and 27: the same, the card's and the CPU's
              normals, points and values equal and the rows whose mean path
              differs counted (projections within rounding of 0);
              14d UpliftDRF on a Criteo-uplift-shaped frame (1M rows of
              12 features, 85 % treated, ~4.7 % visits, +2 points of lift
              where f0 > 0): KL with 50 trees of depth 10, then ChiSquared
              and Euclidean with 10: K1 one launch a level, AUUC, ATE and
              qini; 2 trees on the first 100,000 rows equal on the card and
              on the CPU (rates to 1e-6)
 15 ingest and explain: make_data(1,000,000, 28, seed 0) written as two
              headed CSV files of 500,000 rows (9 significant digits, y as
              b/s), then parse_setup and parse_files through the native
              tokenizer (bytes, wall, MB/s; its build timed apart): the
              parsed frame bitwise equal to the in-memory one; the default
              GBM (20 trees) trained on it equal to phase 4's forest, AUC
              0.783277011 (K2 100 launches); predict_contributions and
              predict_leaf_node_assignment (Node_ID, Path) over its first
              100,000 rows (walls, rows/s; Σφ + bias and the assigned
              leaves' values within 1e-4 of the logit margin),
              staged_predict_proba over the 1M rows (last stage = predict's
              p0 within 1e-6); 3 trees on the first 100,000 rows on the card
              and on the CPU: equal forests, contributions, staged
              probabilities and varimp within 1e-6, leaf ids and paths
              equal
 16 GLM and XGBoost gblinear (no histogram kernel: the counters must
              read 0 over the phase; every pass over the rows on the
              card, the (P+1) x (P+1) solves on the host):
              16a the default binomial GLM (IRLSM with COD inside) on the
              1M x 28 frame: iterations, lambda, device ms per data pass
              beside its bytes bound, host ms per solve, the training AUC
              reproduced by predict(), two trainings with bitwise-equal
              coefficients; the first 100,000 rows on the card and on the
              CPU: equal iterations, coefficients and predictions within
              1e-4;
              16b lambda search with phase 13's 250,000 validation rows:
              the lambdas walked, the best, its validation deviance;
              16c compute_p_values at lambda 0 (card vs CPU std errors
              within 1e-4 relative);
              16d the covertype-shaped frame with wild and soil as 4- and
              40-level categoricals (52 predictors): multinomial at its
              defaults (7 one-vs-rest IRLSM passes an iteration), the
              joint-softmax L_BFGS at alpha 0, lambda 0, and ordinal
              (10,000 Adam steps): logloss reproduced by predict();
              the ordinal thresholds' increments as one CUDA graph
              bitwise the CPU's arithmetic, ms a call beside eager;
              16e gaussian, poisson, gamma, tweedie, quasibinomial,
              fractionalbinomial and negativebinomial on 100,000 rows,
              and beta_constraints and non_negative (bounds hold), each
              card vs CPU as 16a;
              16f XGBoost gblinear at its defaults: AUC, card vs CPU;
              16g one IRLSM iteration under torch.profiler: device busy
              share, top operations, the Gram GEMM's ms beside its bound,
              the host solve
  3r K1_rulefit - hist_cuda at RuleFit's shapes (1M x 28 uint8 bins,
              B = 20, L = 1, 2, 4: the levels of depth-3 rule trees) in f32
              and int16, as phase 3f
 17 KMeans, DeepLearning, GAM and RuleFit (the first three launch no
              histogram kernel: their counters must read 0):
              17a KMeans at k = 10, standardized, 10 iterations, PlusPlus
              and Furthest on the 1M x 28 frame (wall, init wall,
              iterations), one Lloyd step's device ms beside its bytes
              bound, k = 7 on the covertype frame with wild and soil as
              categoricals; the first 100,000 rows on the card and on the
              CPU: equal iterations and assignments, centers within 1e-5;
              17b DeepLearning at H2O-3's defaults (hidden [200, 200],
              Rectifier, ADADELTA; 3 of their 10 epochs: 2,929 steps of 1,024 rows):
              wall, ms a step, training AUC reproduced by predict(); rate/
              momentum and RectifierWithDropout for 1 epoch; an autoencoder
              (hidden [20], 1 epoch) and anomaly() over the 1M rows; card
              against CPU on 100,000 rows after one step of ADADELTA,
              rate/momentum and dropout at full width (weights within
              1e-6 relative, probabilities 1e-3), and the drift after one
              block of 200 steps reported (training amplifies rounding:
              ~1e-2 there between the reference and the port on one CPU);
              17c a binomial GAM over x0 (cr), x1 (I-spline) and x4
              (M-spline) at 10 knots, standardized with ridge 0.1: wall;
              card against CPU on 100,000 rows: equal iterations,
              coefficients and probabilities within 1e-4;
              17d RuleFit at its defaults (50 DRF trees of depth 3,
              QuantilesGlobal, L1 GLM at lambda 1e-3): K1 150 launches
              (trees x levels), rule count, wall and the GLM's share of it;
              card against CPU on 25,000 rows: equal rule sets and
              descriptions, coefficients within 1e-4
 18 PCA, SVD, GLRM, Word2Vec, NaiveBayes and CoxPH (no histogram kernel:
              each run's counters and the phase's total must read 0):
              18a PCA k = 10 standardized on the 1M x 28 frame, k = 7 on
              the categorical covertype frame, SVD GramSVD nv = 10 with
              keep_u (U orthonormal) and Randomized nv = 10 (10 power
              iterations; its values within 2 % below GramSVD's); the
              Gram GEMM's device ms beside its bytes bound, the host
              eigendecomposition's ms;
              18b GLRM k = 10 (Quadratic, 500 iterations at most) on the
              1M x 28 frame with 10 % of its cells NaN: wall, iterations,
              ms an iteration, objective, numerr, predict()'s wall (the
              30-iteration X solve over 1M rows);
              18c Word2Vec at the reference's defaults (vec_size 100,
              window 5, 5 negatives, batches of 4,096, min_word_freq 5)
              on a seeded Zipf corpus of 1,000,000 tokens over 30,000
              types in sentences of 20, 2 epochs of the default 5: wall,
              pairs/s, a device step's ms, the host's share;
              18d NaiveBayes on the 1M x 28 frame and on covertype (7
              classes, wild and soil categorical): walls, predict() walls;
              18e CoxPH, Efron and Breslow, on the 1M x 28 frame with
              exponential times from a seeded linear predictor, ~30 %
              censored, rounded up to whole days: wall, Newton
              iterations, ms an iteration, concordance, a Newton state's
              (likelihood, gradient, Hessian) device ms.
              Card against CPU on 100,000 rows (100,000 tokens) at the
              CPU tests' tolerances: eigenvalues 1e-5 relative,
              eigenvectors 1e-5 (Randomized 1e-4) up to sign plus the
              Davis-Kahan bound of their gaps; Omega bitwise; GLRM's
              first 20 accepted objectives 1e-5 relative; Word2Vec's
              vocabulary, pairs and negatives equal, Win and Wout after
              each of the first two steps 1e-6 relative plus 1e-6 of the
              largest |value| (the card's scatter order); NaiveBayes's
              tables 1e-6, probabilities 1e-5, labels equal where
              decided; CoxPH's first two Newton
              iterates 1e-5, log-likelihood 1e-6 relative, iterations
              within 1, coefficients within the region the float32
              likelihood cannot resolve, concordance 1e-4
 19 IsotonicRegression, Aggregator, TargetEncoder, ModelSelection,
              AnovaGLM, PSVM, Infogram, StackedEnsemble and Grep (K2
              carries Infogram's and the ensemble's GBMs; every other run's
              counters must read 0):
              19a IsotonicRegression of y on x0 over the 1M rows (a score's
              calibration): wall, PAV's host share, thresholds, predict()'s
              wall, predictions monotone in x0;
              19b Aggregator at its defaults (5,000 exemplars, rel_tol 0.5,
              NORMALIZE) on the first AGG_ROWS rows of the 28 columns,
              `reduced` from 1M: on iid 28-d rows the radius search never
              reaches the nearest-neighbour distance, every trial keeps
              every row, and the host loop (the reference's sequential
              rule) is O(rows x 2,048 x 28) a trial: trials, exemplars, s a
              trial, the host share, the distance product's device ms
              beside its bound;
              19c TargetEncoder (KFold 5, blending, noise 0.01) on
              covertype's wild and soil (the most frequent class against
              the rest) and on a 2,000-level Zipf key beside the 1M x 28
              frame: fit and transform(as_training=True) walls;
              19d ModelSelection maxr up to 2 predictors and 19e AnovaGLM
              at its defaults (29 GLMs) on 1M x 28: GLM fits, walls, the
              chosen predictors and the table;
              19f PSVM at its defaults (256 Fourier features, 200
              subgradient steps): wall, a step's device ms beside its
              bound (Z, 1.02 GB, read twice), Platt's wall, the training
              AUC and the decision values' AUC (Platt's Newton steps
              diverge on these margins, in the reference too, and the
              sign of its slope follows rounding);
              19g Infogram at its defaults (seed 1): K2 940 launches (20
              trees x 5 levels + 28 GBMs x 10 trees x 3 levels), the
              admissible features;
              19h StackedEnsemble over a 5-fold GBM (20 trees, depth 5: K2
              600) and a 5-fold binomial GLM, in CV mode and with a
              250,000-row blending frame (make_data seed 1): the bases'
              walls apart from the ensemble's, predict()'s wall, the AUCs;
              19i Grep over the first CSV file of phase 15 (written again):
              matches and offsets equal to an independent re.finditer
              pass, MB/s.
              Card against CPU on 100,000 rows at the CPU tests'
              tolerances: Isotonic thresholds equal and predictions
              bitwise; Aggregator on clustered rows (no distance within
              rounding of the radius there): counts and frames equal,
              exemplars 1e-6, predict()'s labels equal where the two
              nearest exemplars' squared distances are more than 1e-5 of
              |b|^2 + |e|^2 apart (the expanded product's rounding);
              TargetEncoder aggregates and encodings 1e-6;
              ModelSelection's predictors equal, scores 1e-5; AnovaGLM
              deviances 1e-5 and the statistic within 1e-4 or its
              cancellation bound; PSVM W and b bitwise, Z within
              its rounding bound, beta 1e-4 (or the step where the hinge
              masks part, and the decision values' AUCs 1e-3); Infogram's
              (on 25,000 rows) admissible set equal, every relevance index 1e-5, each
              column's information index 1e-5 and their order where
              its 10 trees are equal on both devices (every admissible
              column's must be), and where they part, the first node
              that differs a tie (gains within 1e-6 of its cover);
              the ensemble's metalearner 1e-5 relative and probabilities
              1e-5 over the card's base models loaded onto the CPU, and
              the saved ensemble loaded onto the CPU scoring as on the
              card
 20 scoring artifacts and online serving over models earlier phases
              trained (the default GBM, DRF, XGBoost gbtree, binomial GLM
              and KMeans PlusPlus) and one deployment trained first, a GBM
              (20 trees, depth 5, K2 100) on the covertype frame with wild
              and soil as categoricals, class c1 against the rest; then,
              counters set to 0, neither histogram kernel may run:
              20a the default GBM written as an npz MOJO and as a genmodel
              zip and read back (walls, bytes), the first HOST_ROWS rows
              scored by each host scorer: probabilities within 1e-5 of the
              card's predict_raw, labels equal where p1 is more than 1e-6
              from the threshold, rows/s;
              20b predict_raw_array over the 1M rows on the card for GBM,
              DRF, XGBoost and GLM: bitwise predict_raw(frame), and its
              first HOST_ROWS rows against each model's npz host scorer
              (20a's for the GBM): probabilities within 1e-5, labels
              equal where p1 is more than 1e-5 from the threshold; walls,
              the matrix build apart;
              20c the genmodel zip through import_mojo and the Generic
              builder (both on the card): predict_raw and predict() over
              HOST_ROWS bitwise 20a's host scores as float32; the
              deployment's genmodel zip imported, scoring REMAP_ROWS rows
              of its frame with wild's and soil's domains reversed and an
              unseen level on 1 % of their cells: bitwise the frame in
              training order with those cells NA, and within 1e-5 of the
              card's model on it (labels as in 20b);
              20d ScoringEngine: buckets 1, 32 and 1,024 warmed, REQUESTS
              requests of 1..1,024 JSON-like rows (seed 20; level strings,
              2 % unseen levels, 2 % missing keys, 1 % numbers as
              strings), each answer bitwise predict_raw_array on the same
              encoded rows; p50/p99 per bucket, encode times, the device
              operations of one request (torch.profiler), device_batches
              = REQUESTS and fallback_batches 0; a KMeans deployment
              answered by the host scorer (fallback_batches 1), its
              labels the card's but where two centers are equally near
              (1e-5 of the squared norms); evict empties the buckets;
              20e the launch counters read 0 over 20a-20d
 21 the serving layers above the engine over phase 20's models (the
              default GBM, the DRF, the covertype deployment), counters
              set to 0, neither histogram kernel may run:
              21a the GBM behind ServingConfig(max_batch=32,
              max_delay_ms=2, queue_cap=256), score_rows from 1, 8 and
              32 client threads for SERVE_SECONDS each, cycling through
              SERVE_POOL requests of 1-4 rows drawn by seed from the
              training frame: requests/s, p50/p99 a request, batches and
              requests a batch; every answer bitwise the engine on that
              request's rows alone;
              21b under 8 clients a hot swap to the DRF, a rollback and
              an undeploy: every answer bitwise one version's alone, the
              DRF's only while it was active, none after the undeploy
              (404s), the evicted versions' buckets empty;
              21c the DRF deployed, a canary of the GBM at 0.25 (each
              lane's answers its version's), promoted; a canary made to
              fail, rolled back
              automatically while its clients see the stable version; a
              shadow of the active model, 0 mismatches;
              21d the breaker CLOSED -> SHEDDING (queue depth held by
              chaos slow-score) -> OPEN (chaos serve-pressure, seed 21)
              -> HALF_OPEN (cooldown) -> CLOSED (three probes), every
              refusal ShedLoad or BreakerOpen with retry_after_s > 0;
              deadlines of 100 ms expiring as TimeoutError under a
              300 ms slow-score; QueueFull at a cap of 2;
              21e a fleet of two replicas serving the covertype
              deployment (level strings): converged; one replica dies
              unannounced mid-traffic, then is killed: every request
              answered bitwise, at most one retry each; all killed:
              NoHealthyReplica;
              21f an adaptive deployment under 12 clients: every retune
              a power of two within [serve_min_batch, serve_max_batch];
              the engine's host-scorer count stays 0 and no deployment
              is left
 22 ingest, the rest (files written by the script from its seeded
              frames, into a temporary directory; host parsers, the GBM on
              the card):
              22a the covertype-shaped frame of phase 11 written as LIBSVM
              publishes covtype (label 1-7, the non-zero index:value pairs
              from index 1, 9 significant digits), parsed with
              column_types {target: enum}: every column bitwise the
              in-memory frame's, a SparseVec exactly where fewer than half
              its rows are non-zero (every one-hot column), C1 (index 0)
              all zero; C1 dropped, the multinomial GBM of phase 11 cut to
              SVM_GBM_ITERS iterations (K2 175) equal, node for node and
              value for value, to the same GBM on the in-memory frame;
              22b ARFF_ROWS HIGGS-shaped rows (OpenML data id 23512's
              shape: 28 numeric attributes, class {0,1}) as ARFF, held
              bitwise; 22c AVRO_ROWS of them and a b/s label written by the
              port's Avro writer (deflate) and parsed, held bitwise
              (`reduced` from 1M); 22d XLSX_ROWS as a SpreadsheetML
              workbook, equal to the CSV parse of the same rows, and the
              CPU tests' BIFF8 workbook held against its cells; 22e the
              ARFF file over http from a server on 127.0.0.1: equal to the
              local parse, two parses one GET; 22a's frame saved and
              loaded, bitwise; 22f phase 15's first CSV file streamed
              (ChunkReader, 4,096-row chunks, frame_from_chunk and
              append_rows): numerics bitwise and labels equal to the
              whole-file parse, rows/s; 22g TZ_ROWS naive times parsed
              under set_timezone(TZ_NAME): zoneinfo's UTC milliseconds row
              by row, the DST gap and fold rows NA (without a tz database,
              the refusal is asserted and printed).  Each prints its
              bytes, walls and MB/s
 23 the data plane (core/mrtask.py, core/quantile.py, core/munge.py),
              each sub-phase run on the card and on the CPU through the
              same port code and held card against CPU, with the card's
              wall, the bytes it moved to and from the host and the
              card's name and power limit on its line; the 1M x 28 frame
              gains a 100,000-level Zipf (s = 1.1) integer key zkey and a
              7-level categorical c7 (1 % NA):
              23a map_reduce over the 1M x 28 matrix (column sums, the
              28 x 28 Gram block, min, max): min/max bitwise, sums and
              Gram within 1e-5 of their summed magnitudes (sum |x|,
              sqrt(G_ii G_jj)), bitwise over three calls on the card;
              mutate_array and Vec.map_inplace on one column bitwise;
              23b the quantiles of all 28 columns with 1 % NaN cells at
              nine probabilities: bitwise, each within 1e-5 of its span
              of the exact order statistic;
              23c sort of the 1M frame by (c7 ascending, x0 descending)
              and of the covertype frame (wild/soil categorical) by
              (wild, soil, elev0): every column bitwise, in numpy's stable
              lexsort order;
              23d group-by with every DEVICE_AGGS aggregate (mode on a
              categorical) of the covertype frame by (wild, soil) and of
              the 1M frame by zkey: keys, counts, min, max, median and
              mode bitwise; sum, mean, sd and var at rtol 1e-6 (their
              sums run in one tree order on every device, so they are
              bitwise too, which the line prints); bitwise over three
              calls;
              23e the 1M frame joined to a 100,000-row right frame on
              zkey (~10 % of its keys absent from the left, ~10 % of its
              rows repeating a key): inner, left, right and outer, every
              column (row ids included, so the pair order) bitwise and
              the row counts numpy's; a categorical-key outer join whose
              domains differ, matched by label through the union domain;
              23f a ~50 % mask (x1 > 0) and 100,000 row indices: bitwise
              and numpy's selection;
              23g F8's repeat check (h2o_tpu_torch/tools/repeat_check.py):
              a weighted binomial GBM (AUC stopping, scoring every tree)
              and a weighted 7-class GBM on 100,000 rows, three trainings
              each, and KMeans' and GLRM's steps three times at one state:
              histories, tree counts, varimp, the AUC bins and threshold
              table, the confusion matrix bitwise; K2 5 launches a tree
 24 jobs, the DKV and user functions (core/job.py, core/store.py,
              core/udf.py), each part printing its wall, its K2 launches
              and its holds:
              24a the default GBM through train_async on cuda:0, joined:
              the job DONE at progress 1.0, the model in the DKV under
              the job's dest, its forest bitwise phase 4's, K2 100;
              24b that GBM and a DRF_TREES-tree DRF started together on
              the pool: each forest bitwise the same build alone (phases
              4 and 9), K2 the sum of the two alone (300);
              24c a user's asymmetric loss and MAE metric zipped, put in
              the DKV under upload keys: a distribution="custom" GBM
              (numeric y) with custom_metric_func on the 1M rows and
              JOB_VALID_ROWS validation rows (make_data seed 2): K2 100,
              custom_metric_value on both metrics within 1e-9 relative
              of the same MAE in numpy over the card's predictions; 3
              trees on the first 100,000 rows on the card and on the
              CPU: the same first tree;
              24d on KEYS_ROWS rows: a 5-fold GBM (K2 600) and GLM with
              keep_cross_validation_predictions (fold models and holdout
              frames under the reference's keys), a StackedEnsemble from
              their keys, Generic from a MOJO's upload key, GLM with
              beta_constraints as a frame key, GAM keep_gam_cols and
              DeepLearning export_weights_and_biases: each bitwise the
              same build from objects or a path; every published
              frame's shape; torch.cuda.memory_allocated before and
              after;
              24e on a registry of one worker: a DeepLearning and a
              GBM build cancelled from their own first update() end
              CANCELLED; a JOB_LATE_TREES-tree GBM past its
              JOB_DEADLINE_S deadline ends FAILED with TimeoutError
              within one watchdog interval and stops at its next tree;
              nothing published, a job runs on the pool after each;
              then every key published in 24 is removed and the store
              is back to its keys before it
  7 profile - torch.profiler over 2 default trees: device busy share and
              the kernels that take the device time; then 2 QuantilesGlobal
              trees: each histogram kernel's device ms per main-path launch
              (first pass + kernel + last pass, over the launch counter);
              the same for the two int16 stochastic GBMs, for one DRF tree
              (where its time goes), one XGBoost tree, one multinomial
              iteration (7 class trees) and one UpliftDRF tree

The kernels line's launches sum every main-path training above (phases
4, 5, 8-24), each read from counters set to 0 just before it; the
launches phase lists them path by path (phase 16 as "glm", 0 and 0;
phase 17's KMeans, DeepLearning and GAM paths 0 and 0, "rulefit" 150
and 0; phase 18's PCA, SVD, GLRM, Word2Vec, NaiveBayes and CoxPH runs 0
and 0; phase 19's "infogram" 0 and 940, "stackedensemble_bases" 0 and
600, its other runs 0 and 0; phase 20's deployment
"gbm_covertype_categorical" 0 and 100, "serving" 0 and 0; phase 21's
"serving_layers" 0 and 0; phase 22's "ingest_formats" 0 and 175;
phase 23's "data_plane" 0 and 0, "repeat_check" 0 and 5 a tree;
phase 24's "job_gbm" 0 and 100, "job_gbm_drf_together" 0 and 300,
"gbm_custom" 0 and 100, "keys_for_objects" 0 and 600).

The line before the last holds every kernel's numbers; the last line is
the device summary.  Needs one CUDA card; exits non-zero without one.
"""

import http.server
import json
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import warnings
import zipfile

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device available", file=sys.stderr)
    sys.exit(2)

from h2o_tpu_torch import native  # noqa: E402
from h2o_tpu_torch.core.avro import write_avro  # noqa: E402
from h2o_tpu_torch.core.device import set_timezone  # noqa: E402
from h2o_tpu_torch.core.frame import (T_CAT, T_STR, Frame,  # noqa: E402
                                      SparseVec, Vec)
from h2o_tpu_torch.core.parse import (parse_files,  # noqa: E402
                                      parse_setup)
from h2o_tpu_torch.core.persist import load_frame, save_frame  # noqa: E402
from h2o_tpu_torch.stream import ChunkReader, frame_from_chunk  # noqa: E402
from h2o_tpu_torch.models import aggregator as agg_mod  # noqa: E402
from h2o_tpu_torch.models import anovaglm as anova_mod  # noqa: E402
from h2o_tpu_torch.models import coxph as cox_mod  # noqa: E402
from h2o_tpu_torch.models import infogram as infogram_mod  # noqa: E402
from h2o_tpu_torch.models import isotonic as iso_mod  # noqa: E402
from h2o_tpu_torch.models import modelselection as ms_mod  # noqa: E402
from h2o_tpu_torch.models import psvm as psvm_mod  # noqa: E402
from h2o_tpu_torch.models import glm as glm_mod  # noqa: E402
from h2o_tpu_torch.models import glrm as glrm_mod  # noqa: E402
from h2o_tpu_torch.models import kmeans as km_mod  # noqa: E402
from h2o_tpu_torch.models import rulefit as rulefit_mod  # noqa: E402
from h2o_tpu_torch.models import word2vec as w2v_mod  # noqa: E402
from h2o_tpu_torch.models.aggregator import Aggregator  # noqa: E402
from h2o_tpu_torch.models.anovaglm import AnovaGLM  # noqa: E402
from h2o_tpu_torch.models.coxph import CoxPH  # noqa: E402
from h2o_tpu_torch.models.ensemble import StackedEnsemble  # noqa: E402
from h2o_tpu_torch.models.generic import Generic  # noqa: E402
from h2o_tpu_torch.models.grep import Grep  # noqa: E402
from h2o_tpu_torch.models.infogram import Infogram  # noqa: E402
from h2o_tpu_torch.models.isotonic import IsotonicRegression  # noqa: E402
from h2o_tpu_torch.models.modelselection import ModelSelection  # noqa: E402
from h2o_tpu_torch.models.psvm import PSVM  # noqa: E402
from h2o_tpu_torch.models.target_encoder import TargetEncoder  # noqa: E402
from h2o_tpu_torch.models.deeplearning import DeepLearning  # noqa: E402
from h2o_tpu_torch.models.gam import GAM  # noqa: E402
from h2o_tpu_torch.models.glrm import GLRM  # noqa: E402
from h2o_tpu_torch.models.glm import expand_for_scoring  # noqa: E402
from h2o_tpu_torch.models.kmeans import KMeans  # noqa: E402
from h2o_tpu_torch.models.rulefit import RuleFit  # noqa: E402
from h2o_tpu_torch.models.glm import GLM  # noqa: E402
from h2o_tpu_torch.models.metrics import (binomial_metrics,  # noqa: E402
                                          multinomial_metrics)
from h2o_tpu_torch.models.model import DataInfo, Model  # noqa: E402
from h2o_tpu_torch.models.naive_bayes import NaiveBayes  # noqa: E402
from h2o_tpu_torch.models.pca import PCA  # noqa: E402
from h2o_tpu_torch.models.svd import SVD  # noqa: E402
from h2o_tpu_torch.models.tree import shared_tree as st  # noqa: E402
from h2o_tpu_torch.models.tree.driver import IncrementalScorer  # noqa: E402
from h2o_tpu_torch.models.tree.drf import DRF  # noqa: E402
from h2o_tpu_torch.models.tree.dt import DT  # noqa: E402
from h2o_tpu_torch.models.tree.engine import TrainedForest  # noqa: E402
from h2o_tpu_torch.models.tree.gbm import GBM, raw_from_F  # noqa: E402
from h2o_tpu_torch.models.tree.isofor import (  # noqa: E402
    ExtendedIsolationForest, IsolationForest)
from h2o_tpu_torch.models.tree.uplift import UpliftDRF  # noqa: E402
from h2o_tpu_torch.models.tree.xgboost import XGBoost  # noqa: E402
from h2o_tpu_torch.models.word2vec import Word2Vec  # noqa: E402
from h2o_tpu_torch.mojo import (MojoModel, _flatten_arrays,  # noqa: E402
                                export_genmodel_mojo, export_mojo,
                                import_mojo, load_mojo, scorers)
from h2o_tpu_torch.core import chaos as chaos_mod  # noqa: E402
from h2o_tpu_torch.core import mrtask  # noqa: E402
from h2o_tpu_torch.core import munge as dp_munge  # noqa: E402
from h2o_tpu_torch.core import quantile as dp_quantile  # noqa: E402
from h2o_tpu_torch.core.diag import TimeLine, TransferStats  # noqa: E402
from h2o_tpu_torch.serve import (BreakerOpen, NoHealthyReplica,  # noqa: E402
                                 QueueFull, ScoringEngine, ServingConfig,
                                 ShedLoad, breaker, fleet, registry)
from h2o_tpu_torch.serve.replica import reset_fleet  # noqa: E402
from h2o_tpu_torch.ops import hist_kernels as hk  # noqa: E402
from h2o_tpu_torch.ops import prng  # noqa: E402
from h2o_tpu_torch.ops.histogram import hist_plain  # noqa: E402
from h2o_tpu_torch.ops.linalg import eigh_desc  # noqa: E402
from h2o_tpu_torch.tools.repeat_check import (all_equal,  # noqa: E402
                                              repeat_check)

DEV = torch.device("cuda:0")
R, C = 1_000_000, 28
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_OPS_PER_S = 67e12            # float32 outside the tensor cores
# the kernels' f32 tables come from 64-bit fixed-point sums (one rounding
# per stat at 2^-k, one to float32 at the end); the plain version sums in
# float64: they agree far inside 1e-4 of the largest cell
F32_RTOL = 1e-4
TIMED_LAUNCHES = 12
#: DRF trees at full width (the default is 50; cut to fit the time limit)
DRF_TREES = 10
#: the stochastic GBM options of phase 8
STOCHASTIC = dict(sample_rate=0.7, col_sample_rate=0.8,
                  col_sample_rate_per_tree=0.9, stats_dtype="int16")
L2_FLUSH_BYTES = 256 * 2 ** 20   # written before each timed launch (L2: 50 MB)
#: K2's shapes under XGBoost's defaults (max_bins 256, depth 6, F = 1024):
#: Bd = max(256, 1024 >> d) at levels 3..5
XGB_SHAPES = [(8, 256), (16, 256), (32, 256)]
XGB_TREES = 20
DART = dict(rate_drop=0.1, skip_drop=0.5, seed=1, ntrees=10)
#: UCI Covertype's published shape and class counts (581,012 x 54, 7 classes)
COV_COUNTS = (211_840, 283_301, 35_754, 2_747, 9_493, 17_367, 20_510)
COV_GBM_ITERS = 20
#: K2's (L, Bd) at the multinomial GBM's deepest level (depth 5, B = 20,
#: F = 1024: Bd = max(20, 1024 >> 4))
COV_GBM_SHAPE = (16, 64)
COV_DRF_ITERS = 3
#: the families of phase 12, with the parameters each is run with
FAMILIES = {"poisson": {}, "gamma": {}, "tweedie": dict(tweedie_power=1.3),
            "laplace": {}, "quantile": dict(quantile_alpha=0.25),
            "huber": dict(huber_alpha=0.8)}
SUB_ROWS = 100_000
#: phase 11: rows of the multinomial DRF's card-against-CPU first tree
#: (depth 20, seven classes: ~100 s on the CPU at SUB_ROWS)
COV_DRF_CPU_ROWS = 25_000
#: phases 17d and 19g: rows of RuleFit's and Infogram's card-against-CPU
#: runs (their CPU fits took 24-30 and 27-50 s at SUB_ROWS)
RULEFIT_CPU_ROWS = INFO_CPU_ROWS = 25_000
#: phase 13: validation rows after the 1M training rows, and the
#: early-stopped GBM of 13a
VALID_ROWS = 250_000
EARLY_STOP = dict(ntrees=300, stopping_rounds=3, stopping_metric="AUTO",
                  stopping_tolerance=1e-3, score_tree_interval=5, seed=1)
#: 13a's scoring-cost pair: trees, scoring interval, trainings of each
COST_TREES, COST_INTERVAL, COST_REPEATS = 50, 5, 2
#: phase 14: K1 at UpliftDRF's shapes (Criteo uplift v2.1's 12 features,
#: nbins 20, frontier widths of depth-10 trees), the planted outliers of
#: the anomaly frame, the uplift forests and EIF's extension levels
UPLIFT_COLS = 12
UPLIFT_SHAPES = [(1, 20), (64, 20), (512, 20)]
OUTLIERS, OUTLIER_SHIFT, OUTLIER_COLS = 10_000, 4.0, 3
UPLIFT_RUNS = (("KL", 50), ("ChiSquared", 10), ("Euclidean", 10))
EIF_LEVELS = (0, C - 1)
#: phase 15: the CSV files make_data(R) is written to, the rows explained
#: and the training AUC of the default GBM on 1M x 28 (phase 4)
CSV_FILES = 2
EXPLAIN_ROWS = 100_000
DEFAULT_GBM_AUC = 0.783277011
#: phase 20: rows the host MOJO scorers score, the engine's requests, its
#: warm buckets and the largest request
HOST_ROWS = 100_000
REQUESTS, WARM_BUCKETS, MAX_REQUEST = 120, (1, 32, 1024), 1024
#: 20c: covertype rows of the remap check (the genmodel scorer walks
#: categorical splits at ~11,000 rows/s on the host, twice over them)
REMAP_ROWS = 20_000
#: the models earlier phases trained that phase 20 deploys
KEEP = {}
#: phase 22: OpenML HIGGS ARFF's shape (data id 23512: 98,050 rows, 28
#: numeric attributes, a nominal class), the Avro rows (bench.py's 1M
#: cut: the reader decodes each cell in Python), the XLSX rows, the
#: iterations of the multinomial GBM on the SVMLight frame (phase 11's
#: 20, cut), the streaming chunk (the reference's default), the
#: timezone CSV's rows and zone, and the BIFF8 workbook's rows (num,
#: colour's shared-string index, y or an empty cell)
ARFF_ROWS = 98_050
AVRO_ROWS = 100_000
XLSX_ROWS = 50_000
SVM_GBM_ITERS = 5
STREAM_CHUNK_ROWS = 4096
TZ_ROWS = 100_000
TZ_NAME = "America/New_York"
XLS_CELLS = ((1.5, 3, 10.0), (2.5, 4, None), (4.0, 3, 30.0))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sync() -> None:
    torch.cuda.synchronize(DEV)


_flush_buf = None
_spin_cycles_per_ms = None


def _spin_rate() -> float:
    """Cycles of ``torch.cuda._sleep`` per device millisecond."""
    global _spin_cycles_per_ms
    if _spin_cycles_per_ms is None:
        cycles = 10 ** 7
        torch.cuda._sleep(cycles // 10)           # warm the spin kernel
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        sync()
        _spin_cycles_per_ms = cycles / a.elapsed_time(b)
    return _spin_cycles_per_ms


def time_ms(fn, n: int = TIMED_LAUNCHES, warm: int = 2) -> float:
    """Median device time of ``n`` launches of ``fn``.  Before each one a
    256 MB write evicts L2, and a spin kernel holds the stream for twice
    the longest host enqueue seen in the warm-up, so the two events
    bracket the device work of ``fn`` and not the wrapper's host work."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(L2_FLUSH_BYTES // 4, device=DEV)
    host = 0.0
    for _ in range(warm):
        t0 = time.perf_counter()
        fn()
        host = max(host, time.perf_counter() - t0)
        sync()
    spin = int(_spin_rate() * max(1.0, 2e3 * host))
    ts = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        _flush_buf.zero_()
        torch.cuda._sleep(spin)
        a.record()
        fn()
        b.record()
        sync()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def bound(nbytes: int, ops: int):
    """(ms, "bytes" or "operations"): the least time for ``nbytes`` of
    memory traffic and ``ops`` float32 operations, and which term wins."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def make_data(rows: int, cols: int, seed: int = 0):
    """HIGGS-like binomial data (the repository benchmark's generator)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, cols)).astype(np.float32)
    logits = (1.2 * X[:, 0] - 0.8 * X[:, 1] + X[:, 2] * X[:, 3]
              + 0.5 * np.sin(3 * X[:, 4]))
    y = (rng.uniform(size=rows) < 1 / (1 + np.exp(-logits))).astype(np.int32)
    return X, y


def frame(X, y, extra=()) -> Frame:
    """Columns x0.. and a binomial y, or a numeric y when ``y`` is
    float; ``extra`` adds (name, values) numeric columns."""
    names = [f"x{j}" for j in range(X.shape[1])] + [n for n, _ in extra] + \
        ["y"]
    vecs = [Vec(X[:, j]) for j in range(X.shape[1])] + \
        [Vec(v) for _, v in extra] + \
        [Vec(y) if y.dtype.kind == "f" else Vec(y, T_CAT, domain=["b", "s"])]
    return Frame(names, vecs)


def make_covertype(seed: int = 0, categorical: bool = False) -> Frame:
    """A covertype-shaped frame: 10 normal columns, a 4-way and a 40-way
    one-hot block (0/1 numeric columns; with ``categorical``, the same
    draws as two categorical columns ``wild`` and ``soil`` of 4 and 40
    levels instead) and 7 classes with covertype's class counts.  Class
    scores are a seeded linear signal over three numeric columns and
    both blocks; with Gumbel noise on each score, the rarest class takes
    its count of the unassigned rows that score it highest, then the
    next rarest, so the counts are exact."""
    rng = np.random.default_rng(seed)
    n, K = sum(COV_COUNTS), len(COV_COUNTS)
    X = rng.normal(size=(n, 10)).astype(np.float32)
    wild = rng.choice(4, size=n, p=[0.45, 0.05, 0.44, 0.06])
    soil_p = 0.9 * rng.dirichlet(np.ones(40)) + 0.1 / 40
    soil = rng.choice(40, size=n, p=soil_p)
    score = (X[:, :3] @ rng.normal(size=(3, K)) * 1.5
             + rng.normal(size=(4, K))[wild]
             + 0.8 * rng.normal(size=(40, K))[soil]
             + rng.gumbel(size=(n, K)))
    y = np.full(n, -1, np.int32)
    for k in np.argsort(COV_COUNTS):
        free = np.flatnonzero(y < 0)
        top = np.argpartition(-score[free, k], COV_COUNTS[k] - 1)[
            :COV_COUNTS[k]]
        y[free[top]] = k
    ydom = [f"c{k}" for k in range(K)]
    if categorical:
        names = [f"elev{j}" for j in range(10)] + ["wild", "soil", "y"]
        return Frame(names, [Vec(X[:, j]) for j in range(10)] + [
            Vec(wild.astype(np.int32), T_CAT,
                domain=[f"w{j}" for j in range(4)]),
            Vec(soil.astype(np.int32), T_CAT,
                domain=[f"s{j:02d}" for j in range(40)]),
            Vec(y, T_CAT, domain=ydom)])
    cols = [X] + [(wild[:, None] == np.arange(4)).astype(np.float32),
                  (soil[:, None] == np.arange(40)).astype(np.float32)]
    M = np.concatenate(cols, axis=1)
    names = ([f"elev{j}" for j in range(10)] + [f"wild{j}" for j in range(4)]
             + [f"soil{j}" for j in range(40)] + ["y"])
    vecs = [Vec(M[:, j]) for j in range(M.shape[1])] + \
        [Vec(y, T_CAT, domain=ydom)]
    return Frame(names, vecs)


def family_response(family: str, X, seed: int = 5) -> np.ndarray:
    """A response for ``family`` around a smooth signal of ``X``."""
    rng = np.random.default_rng(seed)
    eta = 0.6 * X[:, 0] - 0.4 * X[:, 1] + 0.3 * X[:, 2] * X[:, 3]
    mu = np.exp(0.5 * eta)
    if family == "poisson":
        return rng.poisson(mu).astype(np.float32)
    if family == "gamma":
        return rng.gamma(2.0, mu / 2.0).astype(np.float32)
    if family == "tweedie":
        y = rng.gamma(1.5, mu / 1.5)
        y[rng.uniform(size=y.shape) < 0.3] = 0.0
        return y.astype(np.float32)
    return (eta + 0.5 * rng.standard_t(3, size=eta.shape)).astype(
        np.float32)


def library_ms(bins, leaf, stats, L: int, B1: int, fine_map=None) -> float:
    """One index_add_ over precomputed flat indices of the active rows —
    a yardstick only; the port never calls it for a histogram."""
    act = leaf >= 0
    b = bins[act].long()
    if fine_map is not None:
        from h2o_tpu_torch.ops.histogram import map_buckets
        lo, hi, off, is_cat, fine_na = fine_map
        b = map_buckets(bins[act], leaf[act], lo, hi, off, is_cat, B1 - 1,
                        fine_na).long()
    cols = torch.arange(b.shape[1], device=DEV)
    cell = ((cols[None, :] * B1 + b) * L + leaf[act].long()[:, None]) * 4
    idx = (cell[:, :, None] + torch.arange(4, device=DEV)).reshape(-1).to(
        torch.int32)
    vals = stats[act][:, None, :].expand(-1, b.shape[1], -1).reshape(-1)
    vals = vals.contiguous()
    out = torch.zeros(b.shape[1] * B1 * L * 4, device=DEV)
    ms = time_ms(lambda: out.index_add_(0, idx, vals), n=5, warm=1)
    del idx, vals, cell, b
    return ms


def nan_check(name, L, B, bins, leaf, stats_f, fm, run_kernel) -> dict:
    """One active row's stat slot 1 set to NaN: the plain version's cells
    that row reaches are NaN, and the kernel's slot 1 must be NaN there
    (the kernel makes the whole slot NaN); the other slots stay within
    F32_RTOL of the plain version."""
    row = int(torch.nonzero(leaf >= 0)[0, 0])
    st = stats_f.clone()
    st[row, 1] = float("nan")
    got = run_kernel(bins, leaf, st, L, B, False, fm)
    plain = hist_plain(bins, leaf, st, L, B, fine_map=fm)
    sync()
    want_nan = torch.isnan(plain)
    slot = torch.arange(got.shape[1], device=DEV) % 4
    finite = slot != 1
    err = (got[:, finite].double() - plain[:, finite].double()).abs().max()
    scale = plain[:, finite].double().abs().max()
    ok = (bool(want_nan.any()) and bool(torch.isnan(got[want_nan]).all())
          and not bool(torch.isnan(got[:, finite]).any())
          and float(err) <= F32_RTOL * float(scale))
    rec = dict(phase=name, L=L, B=B, mode="f32_nan_row", row=row,
               plain_nan_cells=int(want_nan.sum()),
               kernel_nan_cells=int(torch.isnan(got).sum()),
               other_slots_max_abs_err=float(err))
    if not ok:
        raise AssertionError(f"{name} L={L}: a NaN stat on an active row "
                             f"did not give NaN in its slot: {rec}")
    return rec


def kernel_phase(name: str, shapes, make_inputs, run_kernel, fine: bool,
                 modes=("f32", "bf16", "int16", "int8")):
    """Check and time one kernel over the main-path shapes; returns the
    totals over the schedule (f32 mode, and int16 ms and bound) for the
    summary line.  Every mode is launched twice and once more on
    row-permuted inputs: all three tables must have the same bits."""
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
               max_abs_err=0.0, bytes_ms=0.0, ops_ms=0.0, int16_ms=0.0,
               int16_bound_ms=0.0)
    for si, (L, B) in enumerate(shapes):
        bins, leaf, stats_f, stats_i, fm = make_inputs(L, B)
        # int8 stats from the int16 ones, and a row permutation from a
        # generator of their own, so the draws above match earlier runs
        stats_i8 = torch.div(stats_i, 16, rounding_mode="floor").to(
            torch.int8)
        rows, cols = bins.shape
        perm = torch.from_numpy(np.random.default_rng(1000 + si).permutation(
            rows)).to(DEV)
        pbins, pleaf = bins[perm].contiguous(), leaf[perm].contiguous()
        active = int((leaf >= 0).sum())
        if si == 0:
            emit(nan_check(name, L, B, bins, leaf, stats_f, fm, run_kernel))
        for mode in modes:
            stats = {"int16": stats_i, "int8": stats_i8}.get(mode, stats_f)
            bf16 = mode == "bf16"

            def kern():
                return run_kernel(bins, leaf, stats, L, B, bf16, fm)

            k1, k2 = kern(), kern()
            kp = run_kernel(pbins, pleaf, stats[perm].contiguous(), L, B,
                            bf16, fm)
            sync()
            plain = hist_plain(bins, leaf, stats, L, B, bf16=bf16,
                               fine_map=fm)
            sync()
            if not torch.equal(k1, k2):
                raise AssertionError(f"{name} L={L} {mode}: two launches "
                                     "differ")
            if not torch.equal(k1, kp):
                raise AssertionError(f"{name} L={L} {mode}: permuted rows "
                                     "give other bits")
            err = (k1.double() - plain.double()).abs().max().item()
            scale = plain.double().abs().max().item()
            if mode in ("int16", "int8"):
                if not torch.equal(k1, plain):
                    raise AssertionError(f"{name} L={L} {mode}: not equal "
                                         f"to the plain version ({err})")
            elif err > F32_RTOL * scale:
                raise AssertionError(f"{name} L={L} {mode}: max|k-p| {err} "
                                     f"> {F32_RTOL} * {scale}")
            rec = dict(phase=name, rows=rows, cols=cols, L=L, B=B,
                       mode=mode, max_abs_err=err,
                       max_abs_plain=scale, bitwise_repeat=True,
                       bitwise_permuted=True)
            # bytes: bins, leaf, each active row's stats and the table
            # (16 bytes a cell) once; operations: one add per (active
            # row, column, stat), K2's integer bucket arithmetic not
            # counted
            nbytes = (bins.numel() * bins.element_size() + leaf.numel() * 4
                      + active * 4 * stats.element_size()
                      + cols * (B + 1) * L * 16)
            if fine:
                nbytes += 3 * L * cols * 4 + cols * 4
            ops = active * cols * 4
            if mode == "int16":
                rec.update(ms=time_ms(kern), bound_ms=bound(nbytes, ops)[0],
                           bound_bytes=nbytes)
                tot["int16_ms"] += rec["ms"]
                tot["int16_bound_ms"] += rec["bound_ms"]
            if mode == "f32":
                plan = hk.plan_hist(rows, cols, B + 1, L, adaptive=fine,
                                    n_sm=torch.cuda.get_device_properties(
                                        DEV).multi_processor_count,
                                    bins_itemsize=bins.element_size(),
                                    stats_itemsize=stats.element_size())
                b_ms, b_by = bound(nbytes, ops)
                rec.update(
                    ms=time_ms(kern),
                    plain_ms=time_ms(lambda: hist_plain(
                        bins, leaf, stats, L, B, fine_map=fm), n=3, warm=1),
                    bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
                    bound_ops=ops,
                    library_ms=library_ms(bins, leaf, stats, L, B + 1, fm),
                    plan=plan._asdict())
                for k in ("ms", "plain_ms", "bound_ms", "library_ms"):
                    tot[k] += rec[k]
                tot["bytes_ms"] += bound(nbytes, 0)[0]
                tot["ops_ms"] += bound(0, ops)[0]
                tot["max_abs_err"] = max(tot["max_abs_err"], err)
            emit(rec)
            sync()
    return tot


def k1_inputs(rng, cols: int = C):
    def make(L, B):
        bins = torch.from_numpy(rng.integers(0, B + 1, size=(R, cols),
                                             dtype=np.uint8)).to(DEV)
        leaf_np = rng.integers(0, L, size=R).astype(np.int32)
        leaf_np[rng.uniform(size=R) < 0.01] = -1
        st = rng.normal(size=(R, 4)).astype(np.float32)
        st[leaf_np < 0] = np.nan
        sti = rng.integers(-2000, 2000, size=(R, 4)).astype(np.int16)
        return (bins, torch.from_numpy(leaf_np).to(DEV),
                torch.from_numpy(st).to(DEV), torch.from_numpy(sti).to(DEV),
                None)
    return make


def k2_inputs(rng, F: int = 1024, rows: int = R, cols: int = C):
    def make(L, B):
        bins_np = rng.integers(0, F, size=(rows, cols)).astype(np.int16)
        bins_np[rng.uniform(size=(rows, cols)) < 0.05] = F  # NA fine bins
        bins_np[:, 3] = rng.integers(0, 12, size=rows)    # categorical codes
        bins_np[rng.uniform(size=rows) < 0.05, 3] = F
        is_cat = np.zeros(cols, bool)
        is_cat[3] = True
        leaf_np = rng.integers(0, L, size=rows).astype(np.int32)
        leaf_np[rng.uniform(size=rows) < 0.01] = -1
        lo = rng.integers(0, F // 2, size=(L, cols)).astype(np.int32)
        hi = (lo + rng.integers(1, F // 2, size=(L, cols))).astype(np.int32)
        off = rng.integers(0, hi - lo + 1).astype(np.int32)
        st = rng.normal(size=(rows, 4)).astype(np.float32)
        st[leaf_np < 0] = np.nan
        sti = rng.integers(-2000, 2000, size=(rows, 4)).astype(np.int16)
        fm = tuple(torch.from_numpy(a).to(DEV) for a in (lo, hi, off,
                                                          is_cat)) + (F,)
        return (torch.from_numpy(bins_np).to(DEV),
                torch.from_numpy(leaf_np).to(DEV),
                torch.from_numpy(st).to(DEV), torch.from_numpy(sti).to(DEV),
                fm)
    return make


def cov_k2_inputs(rng, F: int = 1024):
    """K2's inputs at the covertype frame's shape (581,012 x 54): the
    draws of ``k2_inputs``, then columns 10..53 made the 4- and 40-way
    one-hot blocks of ``make_covertype`` -- fine bin 0 or F - 1, as the
    uniform grid bins a 0/1 column -- so 44 columns pile each leaf's
    rows into two buckets, as on the multinomial main path."""
    n = sum(COV_COUNTS)
    base = k2_inputs(rng, F, rows=n, cols=54)

    def make(L, B):
        bins, leaf, st, sti, fm = base(L, B)
        wild = rng.choice(4, size=n, p=[0.45, 0.05, 0.44, 0.06])
        soil = rng.choice(40, size=n)
        hot = np.concatenate([wild[:, None] == np.arange(4),
                              soil[:, None] == np.arange(40)], axis=1)
        bins[:, 10:] = torch.from_numpy(
            np.where(hot, F - 1, 0).astype(np.int16)).to(DEV)
        return bins, leaf, st, sti, fm
    return make


def run_k1(bins, leaf, stats, L, B, bf16, fm):
    return hk.hist_cuda(bins, leaf, stats, L, B, bf16=bf16)


def run_k2(bins, leaf, stats, L, B, bf16, fm):
    lo, hi, off, is_cat, fine_na = fm
    return hk.hist_cuda_adaptive(bins, leaf, stats, lo, hi, off, is_cat, L,
                                 B, fine_na, bf16=bf16)


def fit(cls, fr, valid=None, **kw):
    """(model, wall) of one training of builder ``cls`` on ``fr``, with
    ``valid`` as its validation frame."""
    sync()
    t0 = time.perf_counter()
    m = cls(**kw).train(y="y", training_frame=fr, validation_frame=valid)
    sync()
    return m, time.perf_counter() - t0


def train(fr, **kw):
    return fit(GBM, fr, **{"ntrees": 20, "max_depth": 5, "seed": 1, **kw})


def train_drf(fr, **kw):
    return fit(DRF, fr, **{"ntrees": DRF_TREES, "seed": 1, **kw})


def train_xgb(fr, **kw):
    return fit(XGBoost, fr, **{"ntrees": XGB_TREES, "seed": 1, **kw})


def launched(fn, **kw):
    """(model, wall, (K1 launches, K2 launches)) of one training, the
    counters set to 0 just before it."""
    hk.reset_launches()
    m, wall = fn(**kw)
    return m, wall, (hk.hist_cuda.launches, hk.hist_cuda_adaptive.launches)


def same_forest(a: dict, b: dict, trees=None) -> dict:
    """Which node arrays of two forests' first ``trees`` trees are equal,
    and their node values' max |difference|."""
    sl = slice(None, trees)
    eq = {k: bool(np.array_equal(a[k][sl], b[k][sl]))
          for k in ("split_col", "thr_bin", "na_left", "bitset")
          if a.get(k) is not None}
    if a.get("child") is not None:
        eq["child"] = bool(np.array_equal(a["child"][sl], b["child"][sl]))
    return dict(equal=eq, value_max_abs_diff=float(
        np.abs(a["value"][sl] - b["value"][sl]).max()))


def first_tree_check(name: str, cls, sub: Frame, trees: int = 1,
                     **kw) -> dict:
    """Train ``cls`` on ``sub`` on the card and on the CPU; their first
    ``trees`` iterations must have equal split columns, thresholds, NA
    directions, bitsets (and child pointers)."""
    m_gpu, _ = fit(cls, sub, device="cuda", **kw)
    m_cpu, _ = fit(cls, sub, device="cpu", **kw)
    cmp_ = same_forest(m_gpu.output, m_cpu.output, trees=trees)
    rec = dict(phase=name + "_cuda_vs_cpu", rows=sub.nrows, **cmp_)
    emit(rec)
    if not all(cmp_["equal"].values()):
        raise AssertionError(f"{name}: the card's and the CPU's first "
                             f"trees differ: {cmp_}")
    return rec


def phase_xgboost(fr: Frame, sub: Frame, yt: torch.Tensor, paths) -> None:
    """10: XGBoost gbtree and dart at full width."""
    m, wall, got = launched(train_xgb, fr=fr)
    paths["xgboost_gbtree"] = got
    KEEP["xgboost"] = m
    auc = m.output["training_metrics"]["AUC"]
    emit(dict(phase="xgboost_gbtree", rows=R, cols=C, ntrees=XGB_TREES,
              max_depth=6, max_bins=256, wall_s=wall,
              rows_trees_per_s=R * XGB_TREES / wall, train_auc=auc,
              k1_launches=got[0], k2_launches=got[1]))
    if got != (0, 6 * XGB_TREES):
        raise AssertionError(f"XGBoost: (K1, K2) launched {got}, want "
                             f"(0, {6 * XGB_TREES})")
    if not (0.5 < auc <= 1.0) or not np.isfinite(m.output["value"]).all():
        raise AssertionError(f"XGBoost: implausible model (AUC {auc})")
    pred = m.predict(fr)
    auc_pred = binomial_metrics(
        torch.from_numpy(pred.vec("s").data).to(DEV), yt)["AUC"]
    if auc_pred != auc:
        raise AssertionError(f"XGBoost scoring: AUC from predict() "
                             f"{auc_pred} != training AUC {auc}")
    first_tree_check("xgboost_gbtree", XGBoost, sub, ntrees=2, seed=1)

    m, wall, got = launched(fit, cls=XGBoost, fr=fr, booster="dart",
                            **DART)
    paths["xgboost_dart"] = got
    pred = m.predict(fr)
    auc_pred = binomial_metrics(
        torch.from_numpy(pred.vec("s").data).to(DEV), yt)["AUC"]
    auc = m.output["training_metrics"]["AUC"]
    emit(dict(phase="xgboost_dart", rows=R, cols=C, **DART, wall_s=wall,
              train_auc=auc, predict_auc=auc_pred, k1_launches=got[0],
              k2_launches=got[1]))
    if got != (0, 6 * DART["ntrees"]) or auc_pred != auc or \
            not (0.5 < auc <= 1.0):
        raise AssertionError(f"XGBoost dart: launches {got}, AUC {auc} / "
                             f"predict() {auc_pred}")


def phase_multinomial(cov: Frame, paths) -> None:
    """11: multinomial GBM and DRF on the covertype-shaped frame."""
    K = len(COV_COUNTS)
    ycov = torch.from_numpy(cov.vec("y").as_float()).to(DEV)
    counts = np.bincount(cov.vec("y").data, minlength=K)
    if tuple(counts) != COV_COUNTS or cov.nrows != sum(COV_COUNTS):
        raise AssertionError(f"covertype frame: counts {counts}")
    for name, cls, iters, depth, want in (
            ("multinomial_gbm", GBM, COV_GBM_ITERS, 5,
             COV_GBM_ITERS * K * 5),
            ("multinomial_drf", DRF, COV_DRF_ITERS, 20,
             COV_DRF_ITERS * K * 20)):
        m, wall, got = launched(fit, cls=cls, fr=cov, ntrees=iters, seed=1)
        paths[name] = got
        tm = m.output["training_metrics"]
        pred = m.predict(cov)
        probs = torch.stack([torch.from_numpy(pred.vec(f"c{k}").data)
                             for k in range(K)], dim=1).to(DEV)
        pm = multinomial_metrics(probs, ycov)
        emit(dict(phase=name, rows=cov.nrows, cols=54, classes=K,
                  iterations=iters, trees=iters * K, max_depth=depth,
                  wall_s=wall, rows_trees_per_s=cov.nrows * iters * K / wall,
                  logloss=tm["logloss"], err=tm["err"],
                  mean_per_class_error=tm["mean_per_class_error"],
                  predict_logloss=pm["logloss"],
                  predict_mean_per_class_error=pm["mean_per_class_error"],
                  k1_launches=got[0], k2_launches=got[1]))
        if got != (0, want):
            raise AssertionError(f"{name}: (K1, K2) launched {got}, want "
                                 f"(0, {want})")
        if m.output["split_col"].shape[:2] != (iters, K):
            raise AssertionError(f"{name}: forest shape "
                                 f"{m.output['split_col'].shape}")
        if abs(pm["logloss"] - tm["logloss"]) > 1e-6 or \
                pm["mean_per_class_error"] != tm["mean_per_class_error"] or \
                not np.isfinite(tm["logloss"]) or tm["err"] >= 0.5:
            raise AssertionError(f"{name}: training logloss "
                                 f"{tm['logloss']} / predict() "
                                 f"{pm['logloss']}, mean per-class error "
                                 f"{tm['mean_per_class_error']} / "
                                 f"{pm['mean_per_class_error']}")
    sub = cov.slice_rows(slice(0, SUB_ROWS))
    first_tree_check("multinomial_gbm", GBM, sub, ntrees=1, seed=1)
    rec = first_tree_check("multinomial_drf", DRF,
                           cov.slice_rows(slice(0, COV_DRF_CPU_ROWS)),
                           ntrees=1, seed=1)
    if rec["value_max_abs_diff"] > 1e-6:
        raise AssertionError("multinomial DRF: card and CPU values differ")


def phase_families(X, y, fr: Frame, paths) -> None:
    """12: the other distributions, weights and offset, monotone."""
    Xs = X[:SUB_ROWS]
    for fam, extra in FAMILIES.items():
        sub = frame(Xs, family_response(fam, Xs))
        kw = dict(ntrees=3, max_depth=5, seed=1, distribution=fam, **extra)
        hk.reset_launches()
        m, wall = fit(GBM, sub, **kw)
        got = (hk.hist_cuda.launches, hk.hist_cuda_adaptive.launches)
        paths["gbm_" + fam] = got
        tm = m.output["training_metrics"]
        emit(dict(phase="gbm_" + fam, rows=SUB_ROWS, **extra, wall_s=wall,
                  mse=tm["mse"],
                  mean_residual_deviance=tm["mean_residual_deviance"],
                  k1_launches=got[0], k2_launches=got[1]))
        if got != (0, 15) or not np.isfinite(tm["mean_residual_deviance"]):
            raise AssertionError(f"{fam} GBM: launches {got}, deviance "
                                 f"{tm['mean_residual_deviance']}")
        first_tree_check("gbm_" + fam, GBM, sub, **kw)
    rng = np.random.default_rng(11)
    w = rng.uniform(0.5, 2.0, SUB_ROWS).astype(np.float32)
    off = (0.3 * np.sin(2.0 * Xs[:, 5])).astype(np.float32)
    sub = frame(Xs, y[:SUB_ROWS], extra=[("w", w), ("off", off)])
    kw = dict(ntrees=3, seed=1, weights_column="w", offset_column="off")
    hk.reset_launches()
    m, _ = fit(GBM, sub, **kw)
    paths["gbm_weights_offset"] = (hk.hist_cuda.launches,
                                   hk.hist_cuda_adaptive.launches)
    if paths["gbm_weights_offset"] != (0, 15) or \
            m.output["x"] != [f"x{j}" for j in range(C)]:
        raise AssertionError("weighted GBM: launches "
                             f"{paths['gbm_weights_offset']}, x "
                             f"{m.output['x']}")
    first_tree_check("gbm_weights_offset", GBM, sub, **kw)

    mono = {"x0": 1, "x1": -1}
    m, wall, got = launched(train, fr=fr, monotone_constraints=mono)
    paths["gbm_monotone"] = got
    auc = m.output["training_metrics"]["AUC"]
    rows = np.random.default_rng(12).choice(R, 1000, replace=False)
    base = X[rows]
    worst = {}
    for col, sign in mono.items():
        j = int(col[1:])
        grid = np.linspace(X[:, j].min(), X[:, j].max(), 64,
                           dtype=np.float32)
        G = np.repeat(base[None], 64, axis=0)          # (64, 1000, C)
        G[:, :, j] = grid[:, None]
        F = m._forest_F(torch.from_numpy(G.reshape(-1, C)).to(DEV))
        d = sign * torch.diff(F[:, 0].reshape(64, -1), dim=0)
        worst[col] = float(d.min())
    emit(dict(phase="gbm_monotone", rows=R, ntrees=20,
              monotone_constraints=mono, wall_s=wall, train_auc=auc,
              grid=64, grid_rows=1000, min_step_along_grid=worst,
              k1_launches=got[0], k2_launches=got[1]))
    if got != (0, 100) or min(worst.values()) < 0 or not 0.5 < auc <= 1:
        raise AssertionError(f"monotone GBM: launches {got}, AUC {auc}, "
                             f"grid steps against the constraint {worst}")


def make_uplift(rows: int, seed: int = 0) -> Frame:
    """A frame of Criteo uplift v2.1's shape (12 numeric features f0..f11,
    ~85 % treated, a ~4.7 % visit rate) with a planted lift of +2 points
    for treated rows where f0 > 0."""
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(rows, UPLIFT_COLS)).astype(np.float32)
    treat = (rng.uniform(size=rows) < 0.85).astype(np.int32)
    p = 0.038 + 0.01 * np.tanh(F[:, 1]) + 0.02 * treat * (F[:, 0] > 0)
    y = (rng.uniform(size=rows) < p).astype(np.int32)
    names = [f"f{j}" for j in range(UPLIFT_COLS)] + ["treatment", "y"]
    return Frame(names, [Vec(F[:, j]) for j in range(UPLIFT_COLS)] +
                 [Vec(treat, T_CAT, domain=["0", "1"]),
                  Vec(y, T_CAT, domain=["0", "1"])])


def scored(m, fr: Frame):
    """(prediction frame, wall) of ``m.predict`` over ``fr``."""
    sync()
    t0 = time.perf_counter()
    pred = m.predict(fr)
    sync()
    return pred, time.perf_counter() - t0


def label_auc(score: np.ndarray, label: np.ndarray) -> float:
    return binomial_metrics(torch.from_numpy(score).to(DEV),
                            torch.from_numpy(label).to(DEV))["AUC"]


def phase_family(X, y, fr: Frame, paths) -> Frame:
    """14: DT, IsolationForest, ExtendedIsolationForest and UpliftDRF at
    full width; returns the uplift frame for the profile."""
    sub = fr.slice_rows(slice(0, SUB_ROWS))
    # 14a DT
    m, wall, got = launched(fit, cls=DT, fr=fr, seed=1)
    paths["dt"] = got
    pred, s_wall = scored(m, fr)
    auc = m.output["training_metrics"]["AUC"]
    auc_pred = label_auc(pred.vec("s").data, y.astype(np.float32))
    emit(dict(phase="dt", rows=R, cols=C, max_depth=10, min_rows=10,
              wall_s=wall, score_wall_s=s_wall, train_auc=auc,
              predict_auc=auc_pred, k1_launches=got[0], k2_launches=got[1]))
    if got != (0, 10) or auc_pred != auc or not 0.5 < auc <= 1.0:
        raise AssertionError(f"DT: launches {got}, AUC {auc} / predict() "
                             f"{auc_pred}")
    rec = first_tree_check("dt", DT, sub, seed=1)
    if rec["value_max_abs_diff"] > 1e-6:
        raise AssertionError("DT: card and CPU values differ")

    # 14b / 14c the anomaly builders on planted outliers
    rng = np.random.default_rng(14)
    Xa = X.copy()
    planted = rng.choice(R, OUTLIERS, replace=False)
    Xa[planted, :OUTLIER_COLS] += OUTLIER_SHIFT
    label = np.zeros(R, np.float32)
    label[planted] = 1.0
    fr_a = frame(Xa, y)
    sub_a = fr_a.slice_rows(slice(0, SUB_ROWS))
    m, wall, got = launched(fit, cls=IsolationForest, fr=fr_a, seed=1)
    paths["isolationforest"] = got
    pred, s_wall = scored(m, fr_a)
    auc = label_auc(pred.vec("predict").data, label)
    emit(dict(phase="isolationforest", rows=R, cols=C, ntrees=50,
              sample_size=256, max_depth=8, outliers=OUTLIERS, wall_s=wall,
              score_wall_s=s_wall, planted_auc=auc,
              mean_score=m.output["training_metrics"]["mean_score"],
              mean_length=m.output["training_metrics"]["mean_length"],
              k1_launches=got[0], k2_launches=got[1]))
    if got != (0, 0) or not 0.9 < auc <= 1.0:
        raise AssertionError(f"IsolationForest: launches {got}, planted "
                             f"AUC {auc}")
    g, _ = fit(IsolationForest, sub_a, device="cuda", ntrees=10, seed=1)
    c, _ = fit(IsolationForest, sub_a, device="cpu", ntrees=10, seed=1)
    eq = {k: bool(np.array_equal(g.output[k], c.output[k]))
          for k in ("split_col", "thresh")}
    pg = g.predict_raw(sub_a).cpu().numpy()
    pc = c.predict_raw(sub_a).cpu().numpy()
    emit(dict(phase="isolationforest_cuda_vs_cpu", rows=SUB_ROWS, ntrees=10,
              equal=eq, scores_equal=bool(np.array_equal(pg, pc))))
    if not all(eq.values()) or not np.array_equal(pg, pc):
        raise AssertionError(f"IsolationForest: card and CPU differ {eq}")
    for ext in EIF_LEVELS:
        name = f"eif_ext{ext}"
        m, wall, got = launched(fit, cls=ExtendedIsolationForest, fr=fr_a,
                                seed=1, extension_level=ext)
        paths[name] = got
        pred, s_wall = scored(m, fr_a)
        auc = label_auc(pred.vec("anomaly_score").data, label)
        emit(dict(phase=name, rows=R, cols=C, ntrees=100, sample_size=256,
                  extension_level=ext, wall_s=wall, score_wall_s=s_wall,
                  planted_auc=auc,
                  mean_score=m.output["training_metrics"]["mean_score"],
                  k1_launches=got[0], k2_launches=got[1]))
        if got != (0, 0) or not 0.9 < auc <= 1.0:
            raise AssertionError(f"{name}: launches {got}, planted AUC {auc}")
        g, _ = fit(ExtendedIsolationForest, sub_a, device="cuda", ntrees=10,
                   seed=1, extension_level=ext)
        c, _ = fit(ExtendedIsolationForest, sub_a, device="cpu", ntrees=10,
                   seed=1, extension_level=ext)
        eq = {k: bool(np.array_equal(g.output[k], c.output[k]))
              for k in ("normals", "points", "value", "is_split", "counts")}
        pg = g.predict_raw(sub_a).cpu().numpy()
        pc = c.predict_raw(sub_a).cpu().numpy()
        rerouted = int((pg[:, 1] != pc[:, 1]).sum())
        emit(dict(phase=name + "_cuda_vs_cpu", rows=SUB_ROWS, ntrees=10,
                  equal=eq, rows_rerouted=rerouted,
                  score_max_abs_diff=float(np.abs(pg[:, 0] - pc[:, 0]).max())))
        # the card's projections sum in another order: a row whose
        # projection lies within rounding of 0 may take the other side
        if not all(eq.values()) or rerouted > SUB_ROWS // 1000:
            raise AssertionError(f"{name}: card and CPU differ {eq}, "
                                 f"{rerouted} rows rerouted")

    # 14d UpliftDRF
    fr_u = make_uplift(R)
    yu = fr_u.vec("y").data
    emit(dict(phase="uplift_frame", rows=R, cols=UPLIFT_COLS,
              treated_share=float(fr_u.vec("treatment").data.mean()),
              visit_rate=float(yu.mean())))
    for metric, ntrees in UPLIFT_RUNS:
        name = "upliftdrf_" + metric.lower()
        m, wall, got = launched(fit, cls=UpliftDRF, fr=fr_u, seed=1,
                                treatment_column="treatment",
                                uplift_metric=metric, ntrees=ntrees)
        paths[name] = got
        pred, s_wall = scored(m, fr_u)
        tm = m.output["training_metrics"]
        u = pred.vec("uplift_predict").data
        f0 = fr_u.vec("f0").data
        # the planted lift: +0.02 where f0 > 0, none below
        lift = float(u[f0 > 0.5].mean() - u[f0 < -0.5].mean())
        emit(dict(phase=name, rows=R, cols=UPLIFT_COLS, ntrees=ntrees,
                  max_depth=10, wall_s=wall, score_wall_s=s_wall,
                  auuc=tm["auuc"], ate=tm["ate"], qini=tm["qini"],
                  planted_lift_recovered=lift,
                  splits=int((m.output["split_col"] >= 0).sum()),
                  k1_launches=got[0], k2_launches=got[1]))
        if got != (10 * ntrees, 0) or not tm["qini"] > 0 or \
                not tm["auuc"] > 0 or not np.isfinite(tm["ate"]) or \
                (metric == "KL" and not lift > 0.005) or \
                pred.names != ["uplift_predict", "p_y1_ct1", "p_y1_ct0"]:
            raise AssertionError(f"{name}: launches {got}, metrics {tm.data}"
                                 f", planted lift {lift}")
    sub_u = fr_u.slice_rows(slice(0, SUB_ROWS))
    kw = dict(treatment_column="treatment", ntrees=2, seed=1)
    g, _ = fit(UpliftDRF, sub_u, device="cuda", **kw)
    c, _ = fit(UpliftDRF, sub_u, device="cpu", **kw)
    eq = {k: bool(np.array_equal(g.output[k], c.output[k]))
          for k in ("split_col", "bitset", "child")}
    diff = max(float(np.abs(g.output[k] - c.output[k]).max())
               for k in ("val_t", "val_c"))
    emit(dict(phase="upliftdrf_cuda_vs_cpu", rows=SUB_ROWS, ntrees=2,
              equal=eq, rates_max_abs_diff=diff,
              splits=int((g.output["split_col"] >= 0).sum())))
    if not all(eq.values()) or diff > 1e-6:
        raise AssertionError(f"UpliftDRF: card and CPU differ {eq}, rates "
                             f"{diff}")
    return fr_u


def format_g9(a: np.ndarray) -> np.ndarray:
    """(n, c) float32 -> (n, c, 15) ASCII bytes: each value as
    sign, d.dddddddd, e, sign and two exponent digits (9 significant
    digits, through which every float32 round-trips), with numpy integer
    arithmetic instead of a formatting loop."""
    mag = np.abs(a.astype(np.float64))
    nz = mag > 0
    e = np.zeros(a.shape, np.int64)
    e[nz] = np.floor(np.log10(mag[nz])).astype(np.int64)
    for _ in range(2):      # log10's rounding and the mantissa's carry
        m = np.rint(mag / 10.0 ** (e - 8)).astype(np.int64)
        e += m >= 10 ** 9
        e -= nz & (m < 10 ** 8)
    m = np.rint(mag / 10.0 ** (e - 8)).astype(np.int64)
    if not (((m >= 10 ** 8) & (m < 10 ** 9)) | ~nz).all():
        raise AssertionError("format_g9: mantissa out of range")
    out = np.empty(a.shape + (15,), np.uint8)
    out[..., 0] = np.where(np.signbit(a), ord("-"), ord("+"))
    out[..., 2] = ord(".")
    for k in range(9):
        out[..., 1 if k == 0 else k + 2] = (m // 10 ** (8 - k)) % 10 + 48
    out[..., 11] = ord("e")
    out[..., 12] = np.where(e < 0, ord("-"), ord("+"))
    out[..., 13] = np.abs(e) // 10 + 48
    out[..., 14] = np.abs(e) % 10 + 48
    return out


def write_csv(path: str, X, y, chunk: int = 100_000) -> int:
    """A headed CSV of columns x0.. and y as b/s; returns its bytes."""
    n, c = X.shape
    with open(path, "wb") as f:
        f.write((",".join([f"x{j}" for j in range(c)] + ["y"]) +
                 "\n").encode())
        for i in range(0, n, chunk):
            xb = X[i: i + chunk]
            row = np.empty((len(xb), c, 16), np.uint8)
            row[..., :15] = format_g9(xb)
            row[..., 15] = ord(",")
            line = np.empty((len(xb), c * 16 + 2), np.uint8)
            line[:, : c * 16] = row.reshape(len(xb), -1)
            line[:, c * 16] = np.where(y[i: i + chunk] == 1, ord("s"),
                                       ord("b"))
            line[:, c * 16 + 1] = ord("\n")
            f.write(line.tobytes())
    return os.path.getsize(path)


def explain_all(m, head: Frame, whole: Frame) -> dict:
    """Contributions, leaf ids and paths over ``head``, staged
    probabilities over ``whole``, varimp: the outputs and their walls."""
    out = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out[name] = fn()
        sync()
        out[name + "_s"] = time.perf_counter() - t0

    timed("contrib", lambda: m.predict_contributions(head))
    timed("node_id", lambda: m.predict_leaf_node_assignment(head, "Node_ID"))
    timed("path", lambda: m.predict_leaf_node_assignment(head, "Path"))
    timed("staged", lambda: m.staged_predict_proba(whole))
    out["varimp"] = m.varimp()
    return out


def columns(fr: Frame) -> np.ndarray:
    return np.stack([v.data for v in fr.vecs], axis=1)


def phase_ingest_explain(X, y, fr: Frame, m_def, paths) -> None:
    """15: make_data's frame written as CSV files, parsed, trained on and
    explained; the parsed frame and its GBM equal the in-memory ones."""
    # 15a the files
    n_part = R // CSV_FILES
    with tempfile.TemporaryDirectory(prefix="h2o_ingest_") as tmp:
        t0 = time.perf_counter()
        files = [os.path.join(tmp, f"part{i}.csv") for i in range(CSV_FILES)]
        nbytes = sum(write_csv(f, X[i * n_part:(i + 1) * n_part],
                               y[i * n_part:(i + 1) * n_part])
                     for i, f in enumerate(files))
        write_s = time.perf_counter() - t0
        # 15b the parse, the tokenizer's build timed apart
        tok = native.load("csv_tokenizer")
        t0 = time.perf_counter()
        setup = parse_setup(files)
        pf = parse_files(files, setup)
        parse_s = time.perf_counter() - t0
    emit(dict(phase="ingest", files=CSV_FILES, rows=pf.nrows,
              cols=pf.ncols, bytes=nbytes, write_s=write_s, parse_s=parse_s,
              parse_mb_per_s=nbytes / parse_s / 1e6,
              tokenizer_build_s=tok.seconds, separator=setup.separator,
              header=setup.header))
    same = pf.names == fr.names and pf.types() == fr.types() and \
        pf.vec("y").domain == ["b", "s"] == fr.vec("y").domain
    unequal = [n for n in fr.names if not np.array_equal(
        pf.vec(n).data.view(np.uint32), fr.vec(n).data.view(np.uint32))]
    if not same or unequal:
        raise AssertionError(f"ingest: the parsed frame differs from the "
                             f"in-memory one (names/types/domain equal: "
                             f"{same}; unequal columns {unequal})")

    # 15c the default GBM on the parsed frame
    m, wall, got = launched(train, fr=pf)
    paths["ingest_gbm"] = got
    auc = m.output["training_metrics"]["AUC"]
    eq = {k: bool(np.array_equal(m.output[k], m_def.output[k]))
          for k in ("split_col", "thr_bin", "na_left", "bitset", "value",
                    "f0")}
    emit(dict(phase="ingest_gbm", rows=R, ntrees=20, wall_s=wall,
              train_auc=auc, forest_equal=eq, k1_launches=got[0],
              k2_launches=got[1]))
    if got != (0, 100) or not all(eq.values()) or \
            round(auc, 9) != DEFAULT_GBM_AUC:
        raise AssertionError(f"ingest GBM: launches {got}, forest equal "
                             f"{eq}, AUC {auc}")

    # 15d explain on the card's model
    shap = native.load("treeshap")
    head = pf.slice_rows(slice(0, EXPLAIN_ROWS))
    ex = explain_all(m, head, pf)
    phi = columns(ex["contrib"]).astype(np.float64)
    margin = m._forest_F(head.as_matrix(m.output["x"], DEV))[:, 0].double()
    margin = margin.cpu().numpy()
    local = float(np.abs(phi.sum(axis=1) - margin).max())
    ids = columns(ex["node_id"]).astype(np.int64)
    vl = m.output["value"][:, 0]
    leaf_sum = sum(vl[t][ids[:, t]].astype(np.float64)
                   for t in range(ids.shape[1])) + float(m.output["f0"][0])
    leaf_err = float(np.abs(leaf_sum - margin).max())
    path_leaves = all(len(v.domain) == len(np.unique(ids[:, t]))
                      for t, v in enumerate(ex["path"].vecs))
    p0 = m.predict(pf).vec("b").data
    staged_err = float(np.abs(ex["staged"].vecs[-1].data - p0).max())
    emit(dict(phase="explain", rows=EXPLAIN_ROWS, ntrees=20,
              treeshap_build_s=shap.seconds,
              contributions_s=ex["contrib_s"],
              contributions_rows_per_s=EXPLAIN_ROWS / ex["contrib_s"],
              local_accuracy_max_err=local, leaf_node_id_s=ex["node_id_s"],
              leaf_path_s=ex["path_s"],
              leaf_rows_per_s=EXPLAIN_ROWS / ex["node_id_s"],
              leaf_sum_max_err=leaf_err, staged_rows=R,
              staged_s=ex["staged_s"], staged_rows_per_s=R / ex["staged_s"],
              staged_last_vs_p0_max_err=staged_err,
              varimp_top=ex["varimp"][:3]))
    if not (local <= 1e-4 and leaf_err <= 1e-4 and staged_err <= 1e-6 and
            path_leaves and ex["contrib"].names == fr.names[:-1] +
            ["BiasTerm"]):
        raise AssertionError(f"explain: local accuracy {local}, leaf sums "
                             f"{leaf_err}, staged {staged_err}, paths one "
                             f"a leaf {path_leaves}")

    # 15e card against CPU
    sub = pf.slice_rows(slice(0, SUB_ROWS))
    m_gpu, _ = train(sub, ntrees=3, device="cuda")
    m_cpu, _ = train(sub, ntrees=3, device="cpu")
    cmp_ = same_forest(m_gpu.output, m_cpu.output)
    eg, ec = explain_all(m_gpu, sub, sub), explain_all(m_cpu, sub, sub)

    def max_diff(k):
        return float(np.abs(columns(eg[k]).astype(np.float64) -
                            columns(ec[k]).astype(np.float64)).max())

    # varimp: relative importances (squared-error reductions, float32
    # differences of large sums) against the largest, scaled importances
    # and percentages as they are; each variable's own relative
    # difference is reported beside them
    vg = {r[0]: np.array(r[1:]) for r in eg["varimp"]}
    vc = {r[0]: np.array(r[1:]) for r in ec["varimp"]}
    top = max(v[0] for v in vc.values())
    vi_top = max(float(abs(vg[k][0] - vc[k][0])) for k in vc) / top
    vi_abs = max(float(np.abs(vg[k][1:] - vc[k][1:]).max()) for k in vc)
    vi_own = max(float(abs(vg[k][0] - vc[k][0]) / max(vc[k][0], 1e-30))
                 for k in vc)
    rec = dict(phase="explain_cuda_vs_cpu", rows=SUB_ROWS, ntrees=3,
               forest=cmp_, contributions_max_abs_diff=max_diff("contrib"),
               leaf_ids_equal=bool(np.array_equal(columns(eg["node_id"]),
                                                  columns(ec["node_id"]))),
               paths_equal=bool(np.array_equal(columns(eg["path"]),
                                               columns(ec["path"]))),
               staged_max_abs_diff=max_diff("staged"),
               varimp_relative_max_diff_over_top=vi_top,
               varimp_scaled_pct_max_abs_diff=vi_abs,
               varimp_relative_max_own_rel_diff=vi_own,
               contributions_s=dict(cuda=eg["contrib_s"],
                                    cpu=ec["contrib_s"]),
               staged_s=dict(cuda=eg["staged_s"], cpu=ec["staged_s"]))
    emit(rec)
    if not all(cmp_["equal"].values()) or \
            rec["contributions_max_abs_diff"] > 1e-6 or \
            not rec["leaf_ids_equal"] or not rec["paths_equal"] or \
            rec["staged_max_abs_diff"] > 1e-6 or set(vg) != set(vc) or \
            vi_top > 1e-6 or vi_abs > 1e-6:
        raise AssertionError(f"explain: card and CPU differ: {rec}")


def history_rows(m) -> list:
    """A model's scoring history without its timestamps."""
    return [{k: v for k, v in row.items() if k != "timestamp"}
            for row in m.output["scoring_history"]]


def last_row_check(name: str, m, valid: Frame) -> dict:
    """The last scoring-history row must equal a full re-score of the
    model on the validation frame to 1e-6: the incremental scorer adds
    each block's trees to a running F."""
    full = m.model_metrics(valid)
    last = m.output["scoring_history"][-1]
    diff = {k: abs(last["validation_" + k.lower()] - full[k])
            for k in ("logloss", "AUC", "mse")}
    if last["number_of_trees"] != m.output["ntrees_actual"] or \
            max(diff.values()) > 1e-6:
        raise AssertionError(f"{name}: last scoring row {last} against "
                             f"the re-score {diff}")
    return diff


def blocks_check(name: str, blk, one) -> dict:
    """A forest trained in blocks must equal the one trained in one
    call: node arrays equal, values within 1e-6."""
    cmp_ = same_forest(blk.output, one.output)
    if not all(cmp_["equal"].values()) or cmp_["value_max_abs_diff"] > 1e-6:
        raise AssertionError(f"{name}: blocked and one-call forests "
                             f"differ: {cmp_}")
    return cmp_


def scoring_round_ms(m, valid: Frame, trees: int, n: int = 10) -> float:
    """Median host ms of one scoring round of ``trees`` trees over
    ``valid``: the driver's ``IncrementalScorer.add`` and ``metrics``,
    ending in a synchronize."""
    out = m.output
    bins = st.bin_matrix(valid.as_matrix(out["x"], DEV),
                         out["split_points"], out["is_cat"],
                         st.model_fine_na(out))

    def first(k):
        return torch.tensor(np.asarray(out[k])[:trees], device=DEV)

    tf = TrainedForest(first("split_col"), first("bitset"), first("value"),
                       None, first("thr_bin"), first("na_left"),
                       first("node_gain"), first("node_w"))
    dom = out["response_domain"]

    def to_metrics(F, _):
        return m.metrics_from_raw(raw_from_F(F, dom, m.family()), valid)

    f0 = torch.tensor(np.asarray(out["f0"], np.float32), device=DEV)
    sc = IncrementalScorer(bins, f0[None, :].expand(valid.nrows, 1),
                           int(out["max_depth"]), to_metrics, True,
                           fine_na=st.model_fine_na(out))
    ts = []
    for _ in range(n + 2):
        sync()
        t0 = time.perf_counter()
        sc.add(tf)
        sc.metrics(trees)
        sync()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts[2:]) * 1e3


def phase_loop(paths) -> None:
    """13: the training loop at full width, with a validation frame of
    VALID_ROWS more rows of the same signal."""
    Xa, ya = make_data(R + VALID_ROWS, C, seed=0)
    tr, va = frame(Xa[:R], ya[:R]), frame(Xa[R:], ya[R:])

    # 13a early stopping on the validation frame
    m, wall, got = launched(fit, cls=GBM, fr=tr, valid=va, **EARLY_STOP)
    n = m.output["ntrees_actual"]
    paths["loop_gbm_early_stopping"] = got
    diff = last_row_check("13a", m, va)
    vm = m.output["validation_metrics"]
    emit(dict(phase="loop_gbm_early_stopping", rows=R, valid_rows=VALID_ROWS,
              **EARLY_STOP, ntrees_actual=n, wall_s=wall,
              train_auc=m.output["training_metrics"]["AUC"],
              valid_auc=vm["AUC"], valid_logloss=vm["logloss"],
              last_row_vs_rescore=diff, scoring_history=history_rows(m),
              k1_launches=got[0], k2_launches=got[1]))
    if got != (0, 5 * n) or not 0.5 < vm["AUC"] <= 1.0:
        raise AssertionError(f"13a: launches {got} for {n} trees, "
                             f"validation AUC {vm['AUC']}")
    # the cost of a scoring round: the same trees with and without a
    # scoring interval, in turns, and one round timed alone
    walls = {"plain": [], "scored": []}
    for turn in ("plain", "scored", "scored", "plain")[:2 * COST_REPEATS]:
        kw = dict(score_tree_interval=COST_INTERVAL) if turn == "scored" \
            else {}
        _, w, got = launched(fit, cls=GBM, fr=tr, valid=va, seed=1,
                             ntrees=COST_TREES, **kw)
        walls[turn].append(w)
        if got != (0, 5 * COST_TREES):
            raise AssertionError(f"13a cost pair: launches {got}")
        key = "loop_gbm_cost_" + turn
        old_ = paths.get(key, (0, 0))
        paths[key] = (old_[0] + got[0], old_[1] + got[1])
    rounds = COST_TREES // COST_INTERVAL
    per_round = (statistics.median(walls["scored"]) -
                 statistics.median(walls["plain"])) / rounds
    emit(dict(phase="loop_scoring_round_cost", valid_rows=VALID_ROWS,
              ntrees=COST_TREES, score_tree_interval=COST_INTERVAL,
              walls_plain_s=walls["plain"], walls_scored_s=walls["scored"],
              per_round_from_walls_ms=per_round * 1e3,
              one_round_alone_ms=scoring_round_ms(m, va, COST_INTERVAL)))

    # 13b blocks equal one dispatch
    kw = dict(ntrees=20, learn_rate_annealing=0.99, seed=1)
    one, w_one, got = launched(fit, cls=GBM, fr=tr, **kw)
    paths["loop_gbm_one_call"] = got
    blk, w_blk, got_b = launched(fit, cls=GBM, fr=tr, score_tree_interval=3,
                                 **kw)
    paths["loop_gbm_blocked"] = got_b
    cmp_g = blocks_check("13b GBM", blk, one)
    trees = [r["number_of_trees"] for r in blk.output["scoring_history"]]
    d_one, wd_one, got_d = launched(fit, cls=DRF, fr=tr, ntrees=10, seed=1)
    paths["loop_drf_one_call"] = got_d
    d_blk, wd_blk, got_db = launched(fit, cls=DRF, fr=tr, ntrees=10, seed=1,
                                     score_tree_interval=4)
    paths["loop_drf_blocked"] = got_db
    cmp_d = blocks_check("13b DRF", d_blk, d_one)
    emit(dict(phase="loop_blocks_equal_one_call", rows=R,
              gbm=dict(**kw, score_tree_interval=3, blocks_end_at=trees,
                       wall_one_s=w_one, wall_blocked_s=w_blk, **cmp_g),
              drf=dict(ntrees=10, score_tree_interval=4, wall_one_s=wd_one,
                       wall_blocked_s=wd_blk, **cmp_d)))
    if trees != [3, 6, 9, 12, 15, 18, 20] or got != got_b or \
            got != (0, 100) or got_d != got_db or got_d != (0, 200):
        raise AssertionError(f"13b: blocks {trees}, launches {got} / "
                             f"{got_b}, DRF {got_d} / {got_db}")

    # 13c save, load, resume
    with tempfile.TemporaryDirectory() as d:
        m10, _ = fit(GBM, tr, **dict(kw, ntrees=10))
        path = m10.save(os.path.join(d, "gbm10.bin"))
        size = os.path.getsize(path)
        loaded = Model.load(path)
        same_pred = bool(torch.equal(loaded.predict_raw(va),
                                     m10.predict_raw(va)))
        m20, w20, got = launched(fit, cls=GBM, fr=tr, checkpoint=path, **kw)
    paths["loop_gbm_resumed"] = got
    cmp_r = blocks_check("13c resume", m20, one)
    emit(dict(phase="loop_checkpoint_resume", rows=R, saved_bytes=size,
              loaded_predict_bitwise=same_pred, resumed_to=20,
              wall_resume_s=w20, **cmp_r, k1_launches=got[0],
              k2_launches=got[1]))
    if not same_pred or got != (0, 50) or \
            loaded.device != DEV or m20.output["ntrees_actual"] != 20:
        raise AssertionError(f"13c: loaded predict bitwise {same_pred}, "
                             f"launches {got}")

    # 13d 5-fold cross-validation
    m, w_cv, got = launched(fit, cls=GBM, fr=tr, ntrees=20, nfolds=5,
                            fold_assignment="Modulo", seed=1)
    paths["loop_gbm_cv5"] = got
    auc_cv = m.output["cross_validation_metrics_summary"]["AUC"]
    auc_main = m.output["training_metrics"]["AUC"]
    emit(dict(phase="loop_gbm_cv", rows=R, nfolds=5, ntrees=20,
              wall_s=w_cv, wall_over_one_training=w_cv / w_one,
              cv_auc=m.output["cross_validation_metrics"]["AUC"],
              cv_auc_mean=auc_cv["mean"], cv_auc_sd=auc_cv["sd"],
              cv_auc_values=auc_cv["values"], main_auc=auc_main,
              k1_launches=got[0], k2_launches=got[1]))
    if got != (0, 6 * 100) or len(m.output["cross_validation_models"]) != 5 \
            or not 0.5 < auc_cv["mean"] <= auc_main + 0.02:
        raise AssertionError(f"13d: launches {got}, CV AUC {auc_cv}")

    # 13e DRF and XGBoost with a validation frame
    for name, cls, kw_, per_tree in (
            ("loop_drf_validation", DRF,
             dict(ntrees=10, stopping_rounds=2, score_tree_interval=2), 20),
            ("loop_xgboost_validation", XGBoost,
             dict(ntrees=20, score_each_iteration=True, stopping_rounds=3),
             6)):
        m, wall, got = launched(fit, cls=cls, fr=tr, valid=va, seed=1, **kw_)
        paths[name] = got
        n = m.output["ntrees_actual"]
        diff = last_row_check(name, m, va)
        vm = m.output["validation_metrics"]
        emit(dict(phase=name, rows=R, valid_rows=VALID_ROWS, **kw_,
                  ntrees_actual=n, wall_s=wall, valid_auc=vm["AUC"],
                  valid_logloss=vm["logloss"], last_row_vs_rescore=diff,
                  scoring_history=history_rows(m), k1_launches=got[0],
                  k2_launches=got[1]))
        if got != (0, per_tree * n) or not 0.5 < vm["AUC"] <= 1.0:
            raise AssertionError(f"{name}: launches {got} for {n} trees, "
                                 f"validation AUC {vm['AUC']}")

    # 13f card against CPU, with a validation frame and blocks of 2
    sub_tr = tr.slice_rows(slice(0, SUB_ROWS))
    sub_va = va.slice_rows(slice(0, SUB_ROWS // 4))
    kw = dict(ntrees=6, score_tree_interval=2, seed=1)
    m_g, _ = fit(GBM, sub_tr, valid=sub_va, device="cuda", **kw)
    m_c, _ = fit(GBM, sub_tr, valid=sub_va, device="cpu", **kw)
    cmp_ = same_forest(m_g.output, m_c.output, trees=1)
    hg, hc = history_rows(m_g), history_rows(m_c)
    worst = max(abs(a[k] - b[k]) for a, b in zip(hg, hc) for k in a)
    emit(dict(phase="loop_cuda_vs_cpu", rows=SUB_ROWS,
              valid_rows=SUB_ROWS // 4, **kw, first_tree=cmp_,
              history_max_abs_diff=worst, history_cuda=hg))
    if not all(cmp_["equal"].values()) or len(hg) != 3 or \
            [list(r) for r in hg] != [list(r) for r in hc] or worst > 1e-5:
        raise AssertionError(f"13f: first tree {cmp_}, scoring histories "
                             f"{hg} / {hc}")


#: phase 16: GLM.  Card against CPU on SUB_ROWS rows: IRLSM/COD iteration
#: counts equal, coefficients and predictions within GLM_ATOL, std
#: errors within GLM_SE_RTOL relative (the Gram's float32 sums run in
#: cuBLAS's order on the card and in the CPU BLAS's order here)
GLM_ATOL = 1e-4
GLM_SE_RTOL = 1e-4
#: 16e: the families held card against CPU, with their parameters
GLM_FAMILIES = {"gaussian": {}, "poisson": {}, "gamma": {},
                "tweedie": dict(tweedie_power=1.3), "quasibinomial": {},
                "fractionalbinomial": {},
                "negativebinomial": dict(theta=0.5)}
#: 16e: the coefficient bounds held (raw coefficient space)
GLM_BOUNDS = {"x0": (-0.5, 0.2), "x1": (0.0, None), "x2": (-0.1, 0.1)}


def ordinal_increments_check(n: int, calls: int = 200) -> None:
    """16d: the ordinal thresholds' increments (XLA's softplus and
    prefix sum, ~260 small operations) as the Adam loop takes them on
    the card, one CUDA graph replayed, held bitwise against the same
    arithmetic on the CPU; host ms a call, graph and eager (synced)."""
    gen = torch.Generator().manual_seed(5)
    xs = [torch.randn(n, generator=gen) * 4.0 for _ in range(calls)]
    graph = glm_mod._Increments(n, DEV)
    got = [graph(x.to(DEV)).cpu() for x in xs]
    bitwise = all(torch.equal(a, glm_mod._xla_increments(x))
                  for a, x in zip(got, xs))
    ms = {}
    for name, f in (("graph", graph), ("eager", glm_mod._xla_increments)):
        xd = [x.to(DEV) for x in xs]
        sync()
        t0 = time.perf_counter()
        for x in xd:
            f(x)
        sync()
        ms[name] = (time.perf_counter() - t0) * 1e3 / calls
    emit(dict(phase="glm_ordinal_increments", n=n, calls=calls,
              bitwise_cuda_graph_vs_cpu=bitwise, graph_ms_a_call=ms["graph"],
              eager_ms_a_call=ms["eager"]))
    if not bitwise:
        raise AssertionError("16d: ordinal increments differ on the card")


class GlmProbe:
    """While installed, records the device of every GLM pass over the
    rows (the IRLSM pass, the deviance at a beta, the L-BFGS objective,
    the ordinal Adam loop), the device time of each IRLSM pass (CUDA
    events around it: launch to the Gram's copy to the host) and the
    host time of each (P+1) x (P+1) solve."""

    _PASSES = ("_irlsm_pass", "_deviance_at", "_glm_objective_fn",
               "_ordinal_gd")
    _SOLVES = ("_cod_solve", "_chol_solve")

    def __enter__(self):
        self.devices, self.pass_ms, self.solve_ms = set(), [], []
        self.passes = 0
        self._orig = {n: getattr(glm_mod, n)
                      for n in self._PASSES + self._SOLVES}
        for n in self._PASSES:
            setattr(glm_mod, n, self._pass(n, self._orig[n]))
        for n in self._SOLVES:
            setattr(glm_mod, n, self._solve(self._orig[n]))
        return self

    def __exit__(self, *exc):
        for n, f in self._orig.items():
            setattr(glm_mod, n, f)

    def _pass(self, name, f):
        def run(*a, **k):
            X = a[1] if name == "_ordinal_gd" else a[0]
            self.devices.add(str(X.device))
            if name != "_irlsm_pass":
                return f(*a, **k)
            self.passes += 1
            if X.device.type != "cuda":
                return f(*a, **k)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = f(*a, **k)
            ev[1].record()
            ev[1].synchronize()
            self.pass_ms.append(ev[0].elapsed_time(ev[1]))
            return out
        return run

    def _solve(self, f):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = f(*a, **k)
            self.solve_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    def summary(self) -> dict:
        med = (lambda v: statistics.median(v) if v else None)
        return dict(devices=sorted(self.devices), irlsm_passes=self.passes,
                    pass_ms_median=med(self.pass_ms),
                    solves=len(self.solve_ms),
                    solve_host_ms_median=med(self.solve_ms),
                    solve_host_ms_total=sum(self.solve_ms))


def fit_glm(fr, cls=GLM, valid=None, **kw):
    """(model, wall, builder, probe summary) of one GLM training on
    ``fr``; every pass over the rows must have run on ``kw``'s device
    (the card unless ``device`` is given)."""
    want = str(torch.device(kw.get("device") or DEV))
    b = cls(**kw)
    with GlmProbe() as pr:
        sync()
        t0 = time.perf_counter()
        m = b.train(y="y", training_frame=fr, validation_frame=valid)
        sync()
        wall = time.perf_counter() - t0
    if pr.devices and pr.devices != {want}:
        raise AssertionError(f"GLM passes ran on {pr.devices}, not {want}")
    return m, wall, b, pr.summary()


def glm_pass_bound(rows: int, P: int):
    """(ms, bound_by) of one IRLSM pass: X read once (rows x P float32),
    y, w and the mask read once; 2 rows P^2 operations of the Gram."""
    return bound(rows * (P * 4 + 4 + 4 + 1) + (P + 1) * (P + 2) * 4,
                 2 * rows * P * P)


def glm_card_vs_cpu(name: str, sub: Frame, cls=GLM, **kw) -> dict:
    """The same GLM on ``sub`` on the card and on the CPU: iteration
    counts equal, coefficients and predictions within GLM_ATOL."""
    m_g, _, _, _ = fit_glm(sub, cls, **kw)
    m_c, _, _, _ = fit_glm(sub, cls, device="cpu", **kw)
    key = "beta_multinomial" if m_g.output.get("is_multinomial") else "beta"
    d_beta = float(np.abs(m_g.output[key] - m_c.output[key]).max())
    d_pred = float(np.abs(m_g.predict_raw(sub).cpu().numpy() -
                          m_c.predict_raw(sub).numpy()).max())
    rec = dict(phase=name + "_cuda_vs_cpu", rows=sub.nrows,
               iterations=(m_g.output.get("iterations"),
                           m_c.output.get("iterations")),
               beta_max_abs_diff=d_beta, predict_max_abs_diff=d_pred)
    emit(rec)
    if m_g.output.get("iterations") != m_c.output.get("iterations") or \
            d_beta > GLM_ATOL or d_pred > GLM_ATOL or \
            not np.isfinite(m_g.output[key]).all():
        raise AssertionError(f"{name}: the card's and the CPU's GLMs "
                             f"differ: {rec}")
    return dict(rec, models=(m_g, m_c))


def glm_probs(m, fr: Frame) -> torch.Tensor:
    pred = m.predict(fr)
    dom = m.output["response_domain"]
    return torch.stack([torch.from_numpy(pred.vec(d).data) for d in dom],
                       dim=1).to(DEV)


def phase_glm(X, y, fr: Frame, paths) -> None:
    """16: GLM and XGBoost gblinear at full width."""
    hk.reset_launches()
    sub = fr.slice_rows(slice(0, SUB_ROWS))
    yt = torch.from_numpy(fr.vec("y").as_float()).to(DEV)

    # 16a the default binomial GLM: IRLSM with COD inside
    m, wall, _, pr = fit_glm(fr)
    KEEP["glm"] = m
    P = len(m.output["coef_names"])
    tm = m.output["training_metrics"]
    auc_pred = binomial_metrics(
        torch.from_numpy(m.predict(fr).vec("s").data).to(DEV), yt)["AUC"]
    m2, wall2, _, _ = fit_glm(fr)
    same = bool(np.array_equal(m.output["beta"], m2.output["beta"]))
    pb_ms, pb_by = glm_pass_bound(R, P)
    emit(dict(phase="glm_binomial_default", rows=R, predictors=P,
              solver=m.params["_solver_resolved"],
              iterations=m.output["iterations"],
              lambda_used=m.output["lambda_used"], wall_s=wall,
              wall_second_run_s=wall2, train_auc=tm["AUC"],
              predict_auc=auc_pred, logloss=tm["logloss"],
              pass_bound_ms=pb_ms, pass_bound_by=pb_by,
              betas_bitwise_equal_over_two_runs=same, **pr))
    if auc_pred != tm["AUC"] or not same or not 0.5 < tm["AUC"] <= 1 or \
            pr["irlsm_passes"] < 1:
        raise AssertionError(f"16a: AUC {tm['AUC']} / predict() "
                             f"{auc_pred}, two runs bitwise {same}")
    glm_card_vs_cpu("glm_binomial_default", sub)

    # 16b lambda search, validation-deviance selection
    Xa, ya = make_data(R + VALID_ROWS, C, seed=0)
    tr, va = frame(Xa[:R], ya[:R]), frame(Xa[R:], ya[R:])
    del Xa, ya
    m, wall, _, pr = fit_glm(tr, valid=va, lambda_search=True)
    rp, vm = m.output["reg_path"], m.output["validation_metrics"]
    emit(dict(phase="glm_lambda_search", rows=R, valid_rows=VALID_ROWS,
              lambdas_walked=len(rp["lambdas"]),
              lambda_max=m.output["lambda_max"],
              lambda_best=m.output["lambda_best"],
              best_index=rp["lambdas"].index(m.output["lambda_best"]),
              iterations=m.output["iterations"],
              valid_logloss=vm["logloss"],
              valid_deviance=2 * vm["logloss"] * vm["nobs"],
              valid_auc=vm["AUC"], wall_s=wall, **pr))
    if not np.isfinite(vm["logloss"]) or not 0.5 < vm["AUC"] <= 1:
        raise AssertionError(f"16b: validation {vm['logloss']}")
    del tr, va

    # 16c p-values at lambda 0
    m, wall, _, pr = fit_glm(fr, lambda_=0.0, compute_p_values=True)
    se = np.asarray(m.output["std_errs"])
    cmp_ = glm_card_vs_cpu("glm_p_values", sub, lambda_=0.0,
                           compute_p_values=True)
    mg, mc = cmp_["models"]
    se_rel = float(np.max(np.abs(mg.output["std_errs"] -
                                 mc.output["std_errs"]) /
                          mc.output["std_errs"]))
    emit(dict(phase="glm_p_values", rows=R, wall_s=wall,
              iterations=m.output["iterations"], std_errs=se.tolist(),
              p_values_below_1e_3=int((m.output["p_values"] < 1e-3).sum()),
              std_err_rel_diff_cuda_vs_cpu=se_rel, **pr))
    if se_rel > GLM_SE_RTOL or not np.isfinite(se).all():
        raise AssertionError(f"16c: std errors card vs CPU {se_rel}")

    # 16d the covertype-shaped frame with categorical wild and soil
    cov = make_covertype(seed=0, categorical=True)
    ycov = torch.from_numpy(cov.vec("y").as_float()).to(DEV)
    for name, kw in (("glm_multinomial", {}),
                     ("glm_multinomial_lbfgs",
                      dict(solver="L_BFGS", alpha=0.0, lambda_=0.0)),
                     ("glm_ordinal", dict(family="ordinal"))):
        m, wall, b, pr = fit_glm(cov, **kw)
        tm = m.output["training_metrics"]
        pm = multinomial_metrics(glm_probs(m, cov), ycov)
        P = len(m.output["coef_names"])
        emit(dict(phase=name, rows=cov.nrows, predictors=P,
                  classes=len(COV_COUNTS), params=kw,
                  solver=m.params["_solver_resolved"],
                  iterations=getattr(b, "_last_iters", None),
                  adam_steps=200 * 50 if name == "glm_ordinal" else None,
                  wall_s=wall, logloss=tm["logloss"], err=tm["err"],
                  mean_per_class_error=tm["mean_per_class_error"],
                  predict_logloss=pm["logloss"], **pr))
        if P != 10 + 3 + 39 or abs(pm["logloss"] - tm["logloss"]) > 1e-6 \
                or not np.isfinite(tm["logloss"]) or tm["err"] >= 0.7:
            raise AssertionError(f"{name}: {P} predictors, logloss "
                                 f"{tm['logloss']} / {pm['logloss']}")
    del cov
    ordinal_increments_check(len(COV_COUNTS) - 2)

    # 16e the other families, bounds and non_negative on SUB_ROWS rows
    Xs = X[:SUB_ROWS]
    eta = 0.6 * Xs[:, 0] - 0.4 * Xs[:, 1]
    for fam, extra in GLM_FAMILIES.items():
        if fam in ("quasibinomial",):
            ys = y[:SUB_ROWS].astype(np.float32)
        elif fam == "fractionalbinomial":
            ys = (1 / (1 + np.exp(-eta))).astype(np.float32)
        elif fam == "negativebinomial":
            ys = family_response("poisson", Xs)
        else:
            ys = family_response(fam, Xs)
        rec = glm_card_vs_cpu("glm_" + fam, frame(Xs, ys), family=fam,
                              **extra)
        mg = rec["models"][0]
        emit(dict(phase="glm_" + fam, rows=SUB_ROWS, **extra,
                  iterations=mg.output["iterations"],
                  residual_deviance=mg.output["residual_deviance"],
                  mean_residual_deviance=mg.output["training_metrics"][
                      "mean_residual_deviance"]))
    for name, kw in (("glm_beta_constraints",
                      dict(beta_constraints=GLM_BOUNDS)),
                     ("glm_non_negative", dict(non_negative=True))):
        rec = glm_card_vs_cpu(name, sub, **kw)
        co = rec["models"][0].coef()
        if "beta_constraints" in kw:
            bad = {c: co[c] for c, (lo, hi) in GLM_BOUNDS.items()
                   if co[c] < lo - 1e-6 or (hi is not None and
                                            co[c] > hi + 1e-6)}
        else:
            bad = {c: v for c, v in co.items()
                   if c != "Intercept" and v < -1e-6}
        emit(dict(phase=name, rows=SUB_ROWS, coef=co, outside_bounds=bad))
        if bad:
            raise AssertionError(f"{name}: coefficients outside their "
                                 f"bounds: {bad}")

    # 16f XGBoost gblinear at its defaults
    m, wall, _, pr = fit_glm(fr, cls=XGBoost, booster="gblinear")
    tm = m.output["training_metrics"]
    emit(dict(phase="xgboost_gblinear", rows=R, wall_s=wall,
              solver=m.params["_solver_resolved"],
              iterations=m.output["iterations"], train_auc=tm["AUC"],
              **pr))
    if not 0.5 < tm["AUC"] <= 1:
        raise AssertionError(f"16f: gblinear AUC {tm['AUC']}")
    glm_card_vs_cpu("xgboost_gblinear", sub, cls=XGBoost,
                    booster="gblinear")

    # 16g one IRLSM iteration under the profiler
    from torch.profiler import ProfilerActivity, profile
    m_def = fit_glm(fr, max_iterations=1)[0]
    di = DataInfo(fr, [f"x{j}" for j in range(C)], "y", DEV,
                  mode="expanded", standardize=True, impute_missing=True)
    Xd, yv, w, vm_ = di.matrix(), di.response(), di.weights(), \
        di.valid_mask()
    P = Xd.shape[1]
    fam = glm_mod._family("binomial")
    beta = np.asarray(m_def.output["beta"], np.float32)
    lam = m_def.output["lambda_used"]
    glm_mod._irlsm_pass(Xd, yv, w, vm_, beta, fam)           # warm
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        G, q, _ = glm_mod._irlsm_pass(Xd, yv, w, vm_, beta, fam)
        t1 = time.perf_counter()
        glm_mod._cod_solve(G, q, beta, lam * 0.5 * R, lam * 0.5 * R)
        t2 = time.perf_counter()
    per = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            per[ev.name] = per.get(ev.name, 0.0) + ev.device_time_total / 1e3
    busy = sum(per.values())
    gemm = sum(v for k, v in per.items()
               if re.search(r"gemm|xmma|cutlass", k, re.I) and
               not re.search(r"gemv", k, re.I))
    g_ms, g_by = bound(2 * R * P * 4 + P * P * 4, 2 * R * P * P)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    emit(dict(phase="profile_glm_iteration", rows=R, predictors=P,
              pass_wall_ms=(t1 - t0) * 1e3, solve_host_ms=(t2 - t1) * 1e3,
              device_busy_ms=busy,
              device_busy_share=busy / ((t2 - t0) * 1e3),
              device_ops=len([e for e in prof.events() if e.device_type ==
                              torch.autograd.DeviceType.CUDA]),
              gram_gemm_ms=gemm, gram_gemm_bound_ms=g_ms,
              gram_gemm_bound_by=g_by,
              top_device_ms={k[:60]: v for k, v in top}))
    if busy <= 0:
        raise AssertionError("16g: the profiler saw no device time")
    got = (hk.hist_cuda.launches, hk.hist_cuda_adaptive.launches)
    paths["glm"] = got
    if got != (0, 0):
        raise AssertionError(f"phase 16 launched the histogram kernels "
                             f"{got} times")


# -- 17: KMeans, DeepLearning, GAM and RuleFit -------------------------------

#: 17a: KMeans's k and iterations on the 1M x 28 frame, k on covertype
KM_K, KM_ITERS, KM_COV_K = 10, 10, 7
#: 17b: DeepLearning at H2O-3's defaults (hidden [200, 200], Rectifier,
#: ADADELTA) cut from 10 epochs to 3 = 2,929 steps of 1,024 rows (the
#: script's time limit); the 1-epoch variants
DL_EPOCHS = 3.0
DL_VARIANTS = {"momentum": dict(adaptive_rate=False, rate=0.005,
                                momentum_start=0.5, momentum_stable=0.99,
                                momentum_ramp=1e6),
               "dropout": dict(activation="RectifierWithDropout")}
#: the CPU test's tolerances: weights after one step (relative, atol
#: 1e-8), predictions (absolute)
DL_STEP_RTOL, DL_BLOCK_ATOL = 1e-6, 1e-3
#: 17c: the smoothers (column, bs: cr, I-spline, M-spline) at 10 knots,
#: standardized, ridge 0.1: the Gram the float32 solve determines (at
#: lambda 0 cr's Gram has a condition number of ~1e6-1e7, tests/
#: test_torch_gam.py, and two float32 solves differ by more than 1e-4)
GAM_KW = dict(gam_columns=["x0", "x1", "x4"], bs=[0, 2, 3], num_knots=10,
              family="binomial", standardize=True, lambda_=0.1, seed=1)
GAM_ATOL = 1e-4
#: 17d / 3r: RuleFit's defaults (50 DRF trees of depth 3, QuantilesGlobal
#: with 20 bins, L1 GLM at lambda 1e-3); K1's shapes a level: L = 1, 2, 4
RULEFIT_TREES, RULEFIT_DEPTH = 50, 3
RULEFIT_SHAPES = [(1, 20), (2, 20), (4, 20)]
RULEFIT_ATOL = 1e-4


def hist_launches():
    return (hk.hist_cuda.launches, hk.hist_cuda_adaptive.launches)


def no_hist(name: str, got) -> None:
    if got != (0, 0):
        raise AssertionError(f"{name} launched the histogram kernels {got} "
                             "times; it reaches no Pallas kernel")


def phase_kmeans(X, fr: Frame, paths) -> None:
    """17a: KMeans at full width, on covertype, card against CPU (the
    unsupervised builders leave the response column out)."""
    starts = []
    orig = km_mod._lloyd_step

    def lloyd(*a, **k):                 # the host clock at each step
        sync()
        starts.append(time.perf_counter())
        return orig(*a, **k)

    km_mod._lloyd_step = lloyd
    try:
        for init in ("PlusPlus", "Furthest"):
            hk.reset_launches()
            starts.clear()
            sync()
            t0 = time.perf_counter()
            m, wall = fit(KMeans, fr, k=KM_K, init=init,
                          max_iterations=KM_ITERS, seed=1)
            got = hist_launches()
            paths[f"kmeans_{init.lower()}"] = got
            no_hist("KMeans", got)
            KEEP.setdefault("kmeans", m)
            tm = m.output["training_metrics"]
            emit(dict(phase=f"kmeans_{init.lower()}", rows=R, cols=C, k=KM_K,
                      standardize=True, wall_s=wall,
                      init_wall_s=starts[0] - t0,
                      iterations=m.output["iterations"],
                      tot_withinss=tm["tot_withinss"], totss=tm["totss"],
                      betweenss_share=tm["betweenss"] / tm["totss"],
                      sizes=tm["size"]))
            if not np.isfinite(m.output["centers"]).all() or \
                    sum(tm["size"]) != R or not 0 < tm["betweenss"]:
                raise AssertionError(f"KMeans {init}: implausible {tm.data}")
    finally:
        km_mod._lloyd_step = orig
    # one Lloyd step, device time beside its bound
    Xd = expand_for_scoring(fr, m.output["expansion_spec"], DEV)
    cen = torch.tensor(m.output["centers_std"], device=DEV)
    ms = time_ms(lambda: km_mod._lloyd_step(Xd, cen, KM_K))
    b_ms, b_by = bound(R * C * 4 + KM_K * C * 8, 4 * R * KM_K * C)
    emit(dict(phase="kmeans_lloyd_step", rows=R, cols=C, k=KM_K, ms=ms,
              bound_ms=b_ms, bound_by=b_by))
    del Xd
    # covertype with wild and soil as categoricals (one-hot, every level)
    cov = make_covertype(seed=0, categorical=True)
    hk.reset_launches()
    m, wall = fit(KMeans, cov, k=KM_COV_K, init="PlusPlus",
                  max_iterations=KM_ITERS, seed=1)
    got = hist_launches()
    paths["kmeans_covertype"] = got
    no_hist("KMeans covertype", got)
    tm = m.output["training_metrics"]
    emit(dict(phase="kmeans_covertype", rows=cov.nrows,
              expanded_cols=len(m.output["coef_names"]), k=KM_COV_K,
              wall_s=wall, iterations=m.output["iterations"],
              betweenss_share=tm["betweenss"] / tm["totss"]))
    # card against CPU on the first 100,000 rows
    sub = fr.slice_rows(slice(0, SUB_ROWS))
    for init in ("PlusPlus", "Furthest"):
        kw = dict(k=KM_K, init=init, max_iterations=KM_ITERS, seed=1)
        g, _ = fit(KMeans, sub, device="cuda", **kw)
        c, _ = fit(KMeans, sub, device="cpu", **kw)
        same = int((g.predict_raw(sub).cpu() == c.predict_raw(sub)).sum())
        d_c = float(np.abs(g.output["centers_std"] -
                           c.output["centers_std"]).max())
        rec = dict(phase=f"kmeans_{init.lower()}_cuda_vs_cpu", rows=SUB_ROWS,
                   iterations=(g.output["iterations"],
                               c.output["iterations"]),
                   assignments_equal=same, centers_max_abs_diff=d_c)
        emit(rec)
        if g.output["iterations"] != c.output["iterations"] or \
                same != SUB_ROWS or d_c > 1e-5:
            raise AssertionError(f"KMeans: card and CPU differ {rec}")


def dl_probs(m, fr: Frame) -> torch.Tensor:
    return torch.from_numpy(m.predict(fr).vec("s").data).to(DEV)


def phase_deeplearning(fr: Frame, yt: torch.Tensor, paths) -> None:
    """17b: DeepLearning at H2O-3's defaults, its variants and the
    autoencoder; card against CPU."""
    hk.reset_launches()
    m, wall = fit(DeepLearning, fr, seed=1, epochs=DL_EPOCHS)
    got = hist_launches()
    paths["deeplearning"] = got
    no_hist("DeepLearning", got)
    steps = m.output["steps"]
    auc = m.output["training_metrics"]["AUC"]
    pred, s_wall = scored(m, fr)
    auc_pred = binomial_metrics(
        torch.from_numpy(pred.vec("s").data).to(DEV), yt)["AUC"]
    emit(dict(phase="deeplearning", rows=R, cols=C, hidden=[200, 200],
              epochs=DL_EPOCHS, steps=steps, batch=m.output["batch"],
              wall_s=wall, ms_per_step=wall / steps * 1e3,
              train_auc=auc, predict_auc=auc_pred, score_wall_s=s_wall,
              k1_launches=got[0], k2_launches=got[1]))
    if steps != int(DL_EPOCHS * R / 1024) or auc_pred != auc or \
            not 0.5 < auc <= 1.0:
        raise AssertionError(f"DeepLearning: {steps} steps, AUC {auc} / "
                             f"predict() {auc_pred}")
    for name, kw in DL_VARIANTS.items():
        hk.reset_launches()
        mv, wall = fit(DeepLearning, fr, seed=1, epochs=1.0, **kw)
        got = hist_launches()
        paths[f"deeplearning_{name}"] = got
        no_hist(f"DeepLearning {name}", got)
        a = mv.output["training_metrics"]["AUC"]
        emit(dict(phase=f"deeplearning_{name}", rows=R, epochs=1.0, **kw,
                  steps=mv.output["steps"], wall_s=wall,
                  ms_per_step=wall / mv.output["steps"] * 1e3,
                  train_auc=a))
        if not 0.5 < a <= 1.0:
            raise AssertionError(f"DeepLearning {name}: AUC {a}")
    hk.reset_launches()
    ae, wall = fit(DeepLearning, fr, seed=1, epochs=1.0, hidden=[20],
                   autoencoder=True)
    sync()
    t0 = time.perf_counter()
    an = ae.anomaly(fr)
    a_wall = time.perf_counter() - t0
    got = hist_launches()
    paths["deeplearning_autoencoder"] = got
    no_hist("DeepLearning autoencoder", got)
    mse = an.vec("Reconstruction.MSE").data
    emit(dict(phase="deeplearning_autoencoder", rows=R, hidden=[20],
              epochs=1.0, steps=ae.output["steps"], wall_s=wall,
              anomaly_wall_s=a_wall, mean_reconstruction_mse=float(
                  mse.mean()), train_mse=ae.output["training_metrics"]["MSE"]))
    if an.nrows != R or not np.isfinite(mse).all() or \
            abs(float(mse.mean()) - ae.output["training_metrics"]["MSE"]) > \
            1e-4 * ae.output["training_metrics"]["MSE"]:
        raise AssertionError("autoencoder: anomaly() disagrees with its MSE")
    # card against CPU on the first 100,000 rows: one step of each
    # optimizer path at full width (held), then one block of 200 steps
    # (reported): training amplifies float rounding — at [200, 200]
    # ADADELTA's predictions drift from ~1e-7 after 20 steps to ~1e-2
    # after 200 between the reference and the port on one CPU
    # (tools/torch_port_probes.py dl), so only the first step is held
    sub = fr.slice_rows(slice(0, SUB_ROWS))
    for name, steps_, kw in (("adadelta", 1, {}),
                             ("momentum", 1, DL_VARIANTS["momentum"]),
                             ("dropout", 1, DL_VARIANTS["dropout"]),
                             ("adadelta", 200, {})):
        kw = dict(kw, seed=1, epochs=steps_ * 1024 / SUB_ROWS)
        g, _ = fit(DeepLearning, sub, device="cuda", **kw)
        c, _ = fit(DeepLearning, sub, device="cpu", **kw)
        # |card - CPU| over the CPU test's allowance 1e-8 + 1e-6 |CPU|
        rel = max(float(np.max(np.abs(gl[k] - cl[k]) /
                               (1e-8 + DL_STEP_RTOL * np.abs(cl[k]))))
                  for gl, cl in zip(g.output["weights"], c.output["weights"])
                  for k in ("W", "b"))
        # the probabilities (a label may flip where p1 is within
        # rounding of the threshold)
        d_pred = float(np.abs(g.predict_raw(sub).cpu().numpy()[:, 1:] -
                              c.predict_raw(sub).numpy()[:, 1:]).max())
        held = steps_ == 1
        rec = dict(phase=f"deeplearning_{name}_cuda_vs_cpu_{steps_}_steps",
                   rows=SUB_ROWS, held=held,
                   steps=(g.output["steps"], c.output["steps"]),
                   weights_diff_over_allowance=rel,
                   predict_max_abs_diff=d_pred)
        emit(rec)
        if g.output["steps"] != steps_ or \
                (held and (rel > 1.0 or d_pred > DL_BLOCK_ATOL)):
            raise AssertionError(f"DeepLearning: card and CPU differ {rec}")


def phase_gam(fr: Frame, yt: torch.Tensor, paths) -> None:
    """17c: a binomial GAM with three smoothers at full width; card
    against CPU."""
    hk.reset_launches()
    m, wall = fit(GAM, fr, **GAM_KW)
    got = hist_launches()
    paths["gam"] = got
    no_hist("GAM", got)
    auc = m.output["training_metrics"]["AUC"]
    emit(dict(phase="gam", rows=R, cols=C, **GAM_KW, wall_s=wall,
              basis_cols=len(m.output["basis_names"]),
              iterations=m.output["glm_output"]["iterations"],
              train_auc=auc))
    if not 0.5 < auc <= 1.0 or \
            not np.isfinite(m.output["glm_output"]["beta"]).all():
        raise AssertionError(f"GAM: implausible model (AUC {auc})")
    sub = fr.slice_rows(slice(0, SUB_ROWS))
    g, _ = fit(GAM, sub, device="cuda", **GAM_KW)
    c, _ = fit(GAM, sub, device="cpu", **GAM_KW)
    gc, cc = g.coef(), c.coef()
    d_beta = max(abs(gc[k] - cc[k]) for k in cc)
    d_pred = float(np.abs(g.predict_raw(sub).cpu().numpy()[:, 1:] -
                          c.predict_raw(sub).numpy()[:, 1:]).max())
    rec = dict(phase="gam_cuda_vs_cpu", rows=SUB_ROWS,
               iterations=(g.output["glm_output"]["iterations"],
                           c.output["glm_output"]["iterations"]),
               coef_max_abs_diff=d_beta, proba_max_abs_diff=d_pred)
    emit(rec)
    if list(gc) != list(cc) or d_beta > GAM_ATOL or d_pred > GAM_ATOL or \
            rec["iterations"][0] != rec["iterations"][1]:
        raise AssertionError(f"GAM: card and CPU differ {rec}")


def phase_rulefit(fr: Frame, paths) -> None:
    """17d: RuleFit at its defaults: K1 carries every level of the rule
    trees; where the wall goes (the rule trees, the rule frame, the L1
    GLM); card against CPU."""
    walls = {"trees": 0.0, "rule_frame": 0.0, "glm": 0.0}
    orig = rulefit_mod.GLM

    def timed(key, f):
        def run(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = f(*a, **k)
            sync()
            walls[key] += time.perf_counter() - t0
            return out
        return run

    class TimedGLM(orig):
        _fit = timed("glm", orig._fit)

    rulefit_mod.GLM = TimedGLM
    forest = RuleFit._rule_forest
    frame_fn = rulefit_mod.RuleFitModel._rule_frame
    RuleFit._rule_forest = timed("trees", forest)
    rulefit_mod.RuleFitModel._rule_frame = timed("rule_frame", frame_fn)
    try:
        hk.reset_launches()
        m, wall = fit(RuleFit, fr, seed=1)
        got = hist_launches()
    finally:
        rulefit_mod.GLM = orig
        RuleFit._rule_forest = forest
        rulefit_mod.RuleFitModel._rule_frame = frame_fn
    glm_walls = [walls["glm"]]
    paths["rulefit"] = got
    rules = m.rule_importance()
    n_rules = sum(len(f["rule_names"]) for f in m.output["forests"])
    auc = m.output["training_metrics"]["AUC"]
    emit(dict(phase="rulefit", rows=R, cols=C, trees=RULEFIT_TREES,
              depth=RULEFIT_DEPTH, rule_columns=n_rules,
              linear_columns=len(m.output["linear_names"]),
              nonzero_rules=len(rules), wall_s=wall, glm_wall_s=glm_walls[0],
              glm_share=glm_walls[0] / wall, trees_wall_s=walls["trees"],
              rule_frame_wall_s=walls["rule_frame"],
              glm_iterations=m.output["glm_output"]["iterations"],
              train_auc=auc, top_rules=[r[3] for r in rules[:3]],
              k1_launches=got[0], k2_launches=got[1]))
    if got != (RULEFIT_TREES * RULEFIT_DEPTH, 0) or not 0.5 < auc <= 1.0:
        raise AssertionError(f"RuleFit: (K1, K2) launched {got}, want "
                             f"({RULEFIT_TREES * RULEFIT_DEPTH}, 0); AUC "
                             f"{auc}")
    sub = fr.slice_rows(slice(0, RULEFIT_CPU_ROWS))
    g, _ = fit(RuleFit, sub, device="cuda", seed=1)
    c, _ = fit(RuleFit, sub, device="cpu", seed=1)
    names_g = [n for f in g.output["forests"] for n in f["rule_names"]]
    names_c = [n for f in c.output["forests"] for n in f["rule_names"]]
    gc, cc = g._inner().coef(), c._inner().coef()
    d_beta = max(abs(gc[k] - cc[k]) for k in cc)
    rec = dict(phase="rulefit_cuda_vs_cpu", rows=RULEFIT_CPU_ROWS,
               rules=(len(names_g), len(names_c)),
               rules_equal=names_g == names_c,
               descriptions_equal=[r[3] for r in g.rule_importance()] ==
               [r[3] for r in c.rule_importance()],
               coef_max_abs_diff=d_beta)
    emit(rec)
    if names_g != names_c or not rec["descriptions_equal"] or \
            d_beta > RULEFIT_ATOL:
        raise AssertionError(f"RuleFit: card and CPU differ {rec}")


def phase_more(X, fr: Frame, paths) -> None:
    """17: KMeans, DeepLearning, GAM and RuleFit."""
    yt = torch.from_numpy(fr.vec("y").as_float()).to(DEV)
    t0 = time.perf_counter()
    phase_kmeans(X, fr, paths)
    t1 = time.perf_counter()
    phase_deeplearning(fr, yt, paths)
    t2 = time.perf_counter()
    phase_gam(fr, yt, paths)
    t3 = time.perf_counter()
    phase_rulefit(fr, paths)
    t4 = time.perf_counter()
    emit(dict(phase="phase17_walls", kmeans_s=t1 - t0,
              deeplearning_s=t2 - t1, gam_s=t3 - t2, rulefit_s=t4 - t3,
              total_s=t4 - t0))


#: 18: the decompositions, GLRM, Word2Vec, NaiveBayes and CoxPH.  PCA's
#: and SVD's k, GLRM's rank and the share of its cells set to NaN
DECOMP_K, GLRM_K, GLRM_NAN = 10, 10, 0.10
#: 18c: the seeded Zipf corpus (tokens, types, tokens a sentence) and the
#: epochs run (the reference's default is 5: cut, the host pair loop is
#: the reference's own Python loop)
W2V_TOKENS, W2V_TYPES, W2V_SENTENCE, W2V_EPOCHS = 1_000_000, 30_000, 20, 2
W2V_SUB_TOKENS = 100_000
#: 18e: the share of censored rows the censoring rate aims at
COX_CENSORED = 0.3
#: the CPU tests' tolerances (tests/test_torch_{pca_svd,glrm,word2vec,
#: naive_bayes,coxph}.py), held card against CPU on SUB_ROWS rows
EIG_RTOL, VEC_ATOL, RAND_VEC_ATOL = 1e-5, 1e-5, 1e-4
GLRM_OBJ_RTOL, W2V_STEP_RTOL, NB_TABLE_TOL, NB_PROB_ATOL = 1e-5, 1e-6, \
    1e-6, 1e-5
COX_STEP_ATOL, COX_LL_RTOL = 1e-5, 1e-6


def glrm_steps(rows: int) -> dict:
    """GLRM's step sizes for ``rows`` rows.  One step size serves X and
    Y, and Y's gradient sums every row: at the reference's defaults
    (init_step_size 1, min_step_size 1e-4) a fit over more than ~10,000
    rows halves its step below the minimum before one step is accepted
    (20,000 rows: 9 iterations, none accepted, in h2o_tpu and the port
    alike, on the CPU).  Starting near 1 / (2 rows) keeps Y's step
    stable, and the step then grows by 1.05 on each accepted one."""
    return dict(init_step_size=10.0 / rows, min_step_size=1e-12)


def eig_check(name, got_vals, want_vals, got_vecs, want_vecs, G_diff,
              vec_atol) -> dict:
    """Eigenvalues within EIG_RTOL (plus EIG_RTOL/10 of the largest, the
    Gram's float32 rounding, Weyl); each vector aligned to the CPU's
    sign within ``vec_atol`` plus the Davis-Kahan bound 2 ||E|| / gap of
    its eigenvalue, E the two Grams' difference plus each float32
    eigensolver's backward error (P eps ||G||).  The 1M x 28 frame's 28
    iid columns put every eigenvalue within a few % of the others, so
    the vectors are determined only that far."""
    gv, wv = np.asarray(got_vals, np.float64), np.asarray(want_vals,
                                                          np.float64)
    val_err = float(np.max(np.abs(gv - wv) / (EIG_RTOL * np.abs(wv) +
                                              EIG_RTOL / 10 * wv.max())))
    gaps = np.array([np.min(np.abs(np.delete(wv, i) - wv[i]))
                     if len(wv) > 1 else np.inf for i in range(len(wv))])
    k = got_vecs.shape[1]
    signs = np.sign(np.sum(got_vecs * want_vecs, axis=0))
    diff = np.abs(got_vecs * signs[None, :] - want_vecs).max(axis=0)
    E = G_diff + 2 * len(wv) * np.finfo(np.float32).eps * wv.max()
    allowed = vec_atol + 2 * E / gaps[:k]
    rec = dict(eigenvalue_err_over_tol=val_err,
               vector_max_abs_diff=float(diff.max()),
               vector_err_over_bound=float(np.max(diff / allowed)),
               signs_flipped=int(np.sum(signs < 0)),
               min_gap=float(gaps[:k].min()))
    if val_err > 1.0 or rec["vector_err_over_bound"] > 1.0:
        raise AssertionError(f"{name}: card and CPU differ {rec}")
    return rec


def phase_decompositions(fr: Frame, cov: Frame, paths) -> None:
    """18a: PCA and SVD at full width; the Gram GEMM's device ms, the
    host eigendecomposition; card against CPU."""
    runs = (("pca", PCA, fr, dict(k=DECOMP_K, transform="STANDARDIZE")),
            ("pca_covertype", PCA, cov, dict(k=7)),
            ("svd_gram", SVD, fr, dict(nv=DECOMP_K, svd_method="GramSVD",
                                       keep_u=True)),
            ("svd_randomized", SVD, fr, dict(nv=DECOMP_K, seed=1,
                                             svd_method="Randomized",
                                             max_iterations=10,
                                             keep_u=False)))
    models = {}
    for name, cls, data, kw in runs:
        hk.reset_launches()
        m, wall = fit(cls, data, device=DEV, **kw)
        got = hist_launches()
        paths[name] = got
        no_hist(name, got)
        models[name] = m
        o = m.output
        vals = o["std_deviation"] ** 2 if cls is PCA else o["d"]
        rec = dict(phase=name, rows=data.nrows,
                   expanded_cols=len(o.get("coef_names", o.get("v_names"))),
                   **kw, wall_s=wall)
        rec.update({"pct_variance": o["pct_variance"].tolist()} if cls is PCA
                   else {"d": o["d"].tolist()})
        if name == "svd_gram":
            U = np.stack([o["u_frame"].vec(c).data
                          for c in o["u_frame"].names], axis=1)
            rec["u_orthonormality_err"] = float(np.abs(
                U.T.astype(np.float64) @ U - np.eye(U.shape[1])).max())
            if rec["u_orthonormality_err"] > 1e-3:
                raise AssertionError(f"SVD U not orthonormal: {rec}")
        emit(rec)
        if not np.isfinite(vals).all() or (cls is PCA and not 0.0 < float(
                np.sum(o["pct_variance"])) <= 1.0 + 1e-6):
            raise AssertionError(f"{name}: implausible output {rec}")
    # Ritz values of a subspace lie below the eigenvalues (interlacing)
    dg, dr = models["svd_gram"].output["d"], models["svd_randomized"].output[
        "d"]
    if np.any(dr > dg * (1 + 1e-5)) or np.any(dr < 0.98 * dg):
        raise AssertionError(f"Randomized d {dr} not within 2 % below "
                             f"GramSVD's {dg}")
    # the Gram GEMM (device) and the eigendecomposition (host)
    Xd = expand_for_scoring(fr, models["pca"].output["expansion_spec"], DEV)
    gram_ms = time_ms(lambda: Xd.T @ Xd)
    G = (Xd.T @ Xd).cpu()
    t0 = time.perf_counter()
    for _ in range(20):
        eigh_desc(G)
    eigh_ms = (time.perf_counter() - t0) / 20 * 1e3
    b_ms, b_by = bound(R * C * 4 + C * C * 4, 2 * R * C * C)
    emit(dict(phase="decomposition_gram", rows=R, cols=C, gram_ms=gram_ms,
              bound_ms=b_ms, bound_by=b_by, host_eigh_ms=eigh_ms))
    del Xd
    # card against CPU on the first SUB_ROWS rows of each run's frame
    for name, cls, data, kw in runs:
        sub = data.slice_rows(slice(0, SUB_ROWS))
        kw = dict(kw, keep_u=False) if cls is SVD else kw
        g, _ = fit(cls, sub, device=DEV, **kw)
        c, _ = fit(cls, sub, **dict(kw, device="cpu"))
        Xg = expand_for_scoring(sub, g.output["expansion_spec"], DEV)
        Xc = expand_for_scoring(sub, c.output["expansion_spec"], "cpu")
        scale = float(max(sub.nrows - 1, 1)) if cls is PCA else 1.0
        G_diff = float(torch.linalg.matrix_norm(
            (Xg.T @ Xg).cpu().double() - (Xc.T @ Xc).double(), ord=2)) / \
            scale
        if cls is PCA:
            rec = eig_check(name, g.output["std_deviation"] ** 2,
                            c.output["std_deviation"] ** 2,
                            g.output["eigenvectors"],
                            c.output["eigenvectors"], G_diff, VEC_ATOL)
        else:
            randomized = kw["svd_method"] == "Randomized"
            rec = eig_check(name, g.output["d"] ** 2, c.output["d"] ** 2,
                            g.output["v"], c.output["v"], G_diff,
                            RAND_VEC_ATOL if randomized else VEC_ATOL)
        emit(dict(phase=name + "_cuda_vs_cpu", rows=SUB_ROWS,
                  gram_diff_norm=G_diff, **rec))
    om_equal = torch.equal(prng.normal(prng.key(1), (C, DECOMP_K), DEV).cpu(),
                           prng.normal(prng.key(1), (C, DECOMP_K), "cpu"))
    emit(dict(phase="svd_randomized_omega", shape=[C, DECOMP_K],
              bitwise_equal=om_equal))
    if not om_equal:
        raise AssertionError("Randomized SVD: Omega differs card vs CPU")


def glrm_frame(X, seed: int = 3) -> Frame:
    """``X`` with GLRM_NAN of its cells set to NaN (seeded)."""
    A = X.copy()
    A[np.random.default_rng(seed).uniform(size=A.shape) < GLRM_NAN] = np.nan
    return Frame([f"x{j}" for j in range(A.shape[1])],
                 [Vec(A[:, j]) for j in range(A.shape[1])])


def phase_glrm(X, paths) -> None:
    """18b: GLRM k = 10, Quadratic, 500 iterations at most, over 1M x 28
    with 10 % of the cells missing; one step and one objective timed;
    predict()'s 30-iteration X solve over the 1M rows; card against
    CPU."""
    fr_g = glrm_frame(X)
    kw = dict(k=GLRM_K, loss="Quadratic", seed=1)
    hk.reset_launches()
    m, wall = fit(GLRM, fr_g, device=DEV, **kw, **glrm_steps(R))
    got = hist_launches()
    paths["glrm"] = got
    no_hist("GLRM", got)
    o = m.output
    sync()
    t0 = time.perf_counter()
    pred = m.predict(fr_g)
    p_wall = time.perf_counter() - t0
    emit(dict(phase="glrm", rows=R, cols=C, k=GLRM_K, nan_share=GLRM_NAN,
              max_iterations=500, **glrm_steps(R), wall_s=wall,
              iterations=o["iterations"], accepted=len(o["history"]) - 1,
              ms_per_iteration=wall / o["iterations"] * 1e3,
              objective=o["objective"], numerr=o["numerr"],
              initial_objective=o["history"][0], predict_wall_s=p_wall))
    recon = pred.vec("reconstr_x0").data
    if pred.nrows != R or not np.isfinite(recon).all() or \
            not o["objective"] < o["history"][0]:
        raise AssertionError("GLRM: implausible fit or reconstruction")
    # one step and one objective, device-timed, at the fitted factors
    A = DataInfo(fr_g, fr_g.names, None, DEV, mode="expanded",
                 use_all_factor_levels=True, impute_missing=False).matrix()
    prob = glrm_mod._Problem(A, ~torch.isnan(A), "Quadratic", "None",
                             "None", 0.0, 0.0)
    Xf = torch.from_numpy(np.stack(
        [o["representation_frame"].vec(c).data
         for c in o["representation_frame"].names], axis=1)).to(DEV)
    Yf = torch.from_numpy(o["archetypes"]).to(DEV)
    alpha = torch.tensor(o["step_size"], dtype=torch.float32, device=DEV)
    step_ms = time_ms(lambda: prob.step(Xf, Yf, alpha))
    obj_ms = time_ms(lambda: prob.objective(Xf, Yf))
    # A (float32) and its mask (bool) read once, X read and written once
    # (a row's new X needs only its own row), four (R, C, k) products
    b_ms, b_by = bound(R * C * 5 + 2 * R * GLRM_K * 4, 8 * R * C * GLRM_K)
    emit(dict(phase="glrm_iteration", rows=R, cols=C, k=GLRM_K,
              step_ms=step_ms, objective_ms=obj_ms, bound_ms=b_ms,
              bound_by=b_by))
    del A, prob
    sub = glrm_frame(X[:SUB_ROWS])
    kw.update(glrm_steps(SUB_ROWS))
    g, _ = fit(GLRM, sub, device=DEV, **kw)
    c, _ = fit(GLRM, sub, **dict(kw, device="cpu"))
    gh, ch = np.asarray(g.output["history"]), np.asarray(c.output["history"])
    n = min(20, len(gh), len(ch))
    first = float(np.max(np.abs(gh[:n] - ch[:n]) / np.abs(ch[:n])))
    rec = dict(phase="glrm_cuda_vs_cpu", rows=SUB_ROWS,
               iterations=(g.output["iterations"], c.output["iterations"]),
               accepted=(len(gh) - 1, len(ch) - 1),
               first20_max_rel=first,
               objective_rel=abs(g.output["objective"] -
                                 c.output["objective"]) /
               abs(c.output["objective"]),
               numerr_rel=abs(g.output["numerr"] - c.output["numerr"]) /
               abs(c.output["numerr"]))
    emit(rec)
    # the final values are reported: the accept decisions on float32
    # noise part the trajectories (tests/test_torch_glrm.py)
    if first > GLRM_OBJ_RTOL:
        raise AssertionError(f"GLRM: card and CPU differ {rec}")


def zipf_tokens(n: int, types: int, sentence: int, seed: int = 0) -> list:
    """``n`` tokens ``w<rank>`` drawn with probability ~ 1 / rank over
    ``types`` types, an NA after every ``sentence`` tokens."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, types + 1)
    ranks = rng.choice(types, size=n, p=p / p.sum())
    names = np.array([f"w{r}" for r in range(types)], dtype=object)
    toks = names[ranks].reshape(-1, sentence)
    out = np.full((toks.shape[0], sentence + 1), None, dtype=object)
    out[:, :sentence] = toks
    return out.reshape(-1).tolist()


class W2VProbe:
    """While installed, records every Word2Vec step's host inputs and
    copies of (Win, Wout) after each of the first two steps (Wout starts
    at 0, so the first step moves Wout alone)."""

    def __enter__(self):
        self.inputs, self.snaps = [], []
        self._orig = w2v_mod.sgns_step

        def run(Win, Wout, c, t, labels, lr):
            self.inputs.append((c.cpu().numpy().copy(),
                                t.cpu().numpy().copy(), float(lr)))
            self._orig(Win, Wout, c, t, labels, lr)
            if len(self.snaps) < 2:
                self.snaps.append((Win.cpu().numpy().copy(),
                                   Wout.cpu().numpy().copy()))
        w2v_mod.sgns_step = run
        return self

    def __exit__(self, *exc):
        w2v_mod.sgns_step = self._orig


def phase_word2vec(paths) -> None:
    """18c: Word2Vec at the reference's defaults on a 1M-token Zipf
    corpus, 2 epochs; one device step timed; card against CPU."""
    fr_w = Frame(["tokens"], [Vec(zipf_tokens(W2V_TOKENS, W2V_TYPES,
                                              W2V_SENTENCE), T_STR)])
    kw = dict(epochs=W2V_EPOCHS, seed=1)
    hk.reset_launches()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with W2VProbe() as pr:
            m, wall = fit(Word2Vec, fr_w, device=DEV, **kw)
    got = hist_launches()
    paths["word2vec"] = got
    no_hist("Word2Vec", got)
    steps = len(pr.inputs)
    pairs = sum(len(c) for c, _, _ in pr.inputs)
    c, t, lr = pr.inputs[-1]
    Win = torch.from_numpy(m.output["vectors"]).to(DEV)
    Wout = torch.zeros_like(Win)
    labels = torch.zeros(t.shape, dtype=torch.float32, device=DEV)
    labels[:, 0] = 1.0
    cd, td = torch.from_numpy(c).to(DEV), torch.from_numpy(t).to(DEV)
    lrd = torch.tensor(lr, dtype=torch.float32, device=DEV)
    step_ms = time_ms(lambda: w2v_mod.sgns_step(Win, Wout, cd, td, labels,
                                                lrd))
    syn = m.find_synonyms("w0", 5)
    emit(dict(phase="word2vec", tokens=W2V_TOKENS, types=W2V_TYPES,
              vocab=len(m.output["words"]), vec_size=100, window_size=5,
              negative_samples=5, batch_size=4096, epochs=W2V_EPOCHS,
              wall_s=wall, steps=steps, pairs=pairs, pairs_per_s=pairs / wall,
              device_step_ms=step_ms,
              host_share=1.0 - steps * step_ms / 1e3 / wall,
              synonyms_w0=list(syn)))
    if not np.isfinite(m.output["vectors"]).all() or len(syn) != 5:
        raise AssertionError("Word2Vec: implausible embeddings")
    sub = Frame(["tokens"], [Vec(zipf_tokens(W2V_SUB_TOKENS, W2V_TYPES,
                                             W2V_SENTENCE, seed=2), T_STR)])
    runs = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for dev in (DEV, "cpu"):
            with W2VProbe() as pr:
                mm_, _ = fit(Word2Vec, sub, **dict(kw, device=dev))
            runs[str(dev)] = (mm_, pr)
    (g, pg), (cm, pc) = runs[str(DEV)], runs["cpu"]
    same_inputs = len(pg.inputs) == len(pc.inputs) and all(
        np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) and
        np.float32(a[2]) == np.float32(b[2])
        for a, b in zip(pg.inputs, pc.inputs))
    # the CPU tests' 1e-6 relative, plus 1e-6 of the matrix's largest
    # |value|: on the card index_add_ adds a frequent word's hundreds of
    # terms a batch in no fixed order
    first = max(float(np.max(np.abs(a - b) / (W2V_STEP_RTOL * (
        np.abs(b) + np.abs(b).max())))) for sg, sc in zip(pg.snaps, pc.snaps)
        for a, b in zip(sg, sc))
    drift = float(np.abs(g.output["vectors"] - cm.output["vectors"]).max() /
                  np.abs(cm.output["vectors"]).max())
    rec = dict(phase="word2vec_cuda_vs_cpu", tokens=W2V_SUB_TOKENS,
               steps=(len(pg.inputs), len(pc.inputs)),
               vocab_equal=g.output["words"] == cm.output["words"],
               pairs_and_negatives_equal=same_inputs,
               first_steps_err_over_tol=first, final_drift=drift)
    emit(rec)
    if not (rec["vocab_equal"] and same_inputs) or first > 1.0:
        raise AssertionError(f"Word2Vec: card and CPU differ {rec}")


def label_check(name, g_raw, c_raw) -> dict:
    """Labels equal where the top two probabilities are more than
    NB_PROB_ATOL apart; probabilities within NB_PROB_ATOL."""
    gp, cp = g_raw[:, 1:], c_raw[:, 1:]
    top2 = np.sort(cp, axis=1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > NB_PROB_ATOL
    rec = dict(label_diffs=int(np.sum(g_raw[:, 0] != c_raw[:, 0])),
               label_diffs_decided=int(np.sum((g_raw[:, 0] != c_raw[:, 0])
                                              & decided)),
               proba_max_abs_diff=float(np.abs(gp - cp).max()))
    if rec["label_diffs_decided"] or rec["proba_max_abs_diff"] > \
            NB_PROB_ATOL:
        raise AssertionError(f"{name}: card and CPU differ {rec}")
    return rec


def phase_naive_bayes(fr: Frame, cov: Frame, paths) -> None:
    """18d: NaiveBayes on 1M x 28 (binomial) and on covertype (7
    classes, two categoricals); predict() walls; card against CPU."""
    for name, data in (("naivebayes", fr), ("naivebayes_covertype", cov)):
        hk.reset_launches()
        m, wall = fit(NaiveBayes, data, device=DEV)
        got = hist_launches()
        paths[name] = got
        no_hist(name, got)
        tm = m.output["training_metrics"]
        sync()
        t0 = time.perf_counter()
        pred = m.predict(data)
        p_wall = time.perf_counter() - t0
        emit(dict(phase=name, rows=data.nrows, classes=len(
            m.output["response_domain"]), wall_s=wall, predict_wall_s=p_wall,
            logloss=tm["logloss"], auc=tm.get("AUC"),
            mean_per_class_error=tm.get("mean_per_class_error")))
        if pred.nrows != data.nrows or not np.isfinite(tm["logloss"]):
            raise AssertionError(f"{name}: implausible model")
        sub = data.slice_rows(slice(0, SUB_ROWS))
        g, _ = fit(NaiveBayes, sub, device=DEV)
        c, _ = fit(NaiveBayes, sub, device="cpu")
        tab = max([float(np.max(np.abs(g.output["apriori"] -
                                       c.output["apriori"])))] +
                  [float(np.max(np.abs(g.output["pcond_cat"][k] - v)))
                   for k, v in c.output["pcond_cat"].items()] +
                  [float(np.max(np.abs(g.output[k] - c.output[k]) /
                                np.maximum(np.abs(c.output[k]), 1.0)))
                   for k in ("num_mean", "num_sd")])
        rec = dict(phase=name + "_cuda_vs_cpu", rows=SUB_ROWS,
                   tables_max_diff=tab, **label_check(
                       name, g.predict_raw(sub).cpu().numpy(),
                       c.predict_raw(sub).numpy()))
        emit(rec)
        if tab > NB_TABLE_TOL:
            raise AssertionError(f"{name}: card and CPU tables differ {rec}")


def cox_frame(X, seed: int = 4) -> Frame:
    """``X`` with event times drawn from an exponential whose rate is a
    seeded linear predictor's exp (median ~1 year), about COX_CENSORED of
    the rows censored by an exponential censoring time, both rounded up
    to whole days (so Efron sees ties)."""
    rng = np.random.default_rng(seed)
    beta = rng.normal(0.0, 0.2, X.shape[1])
    rate = np.exp(X.astype(np.float64) @ beta) / 365.0
    t_event = rng.exponential(1.0 / rate)
    # the censoring rate c with mean(c / (c + rate)) = COX_CENSORED
    lo, hi = 0.0, float(rate.max())
    for _ in range(60):
        c = (lo + hi) / 2
        lo, hi = (c, hi) if np.mean(c / (c + rate)) < COX_CENSORED \
            else (lo, c)
    t_cens = rng.exponential(1.0 / c, size=len(rate))
    time_ = np.ceil(np.minimum(t_event, t_cens)).astype(np.float32)
    event = (t_event <= t_cens).astype(np.int32)
    return Frame([f"x{j}" for j in range(X.shape[1])] + ["time", "event"],
                 [Vec(X[:, j]) for j in range(X.shape[1])] +
                 [Vec(time_), Vec(event, T_CAT, domain=["0", "1"])])


class CoxProbe:
    """While installed, the betas the likelihood is evaluated at and the
    host clock around each Newton state (nll, gradient, Hessian)."""

    def __enter__(self):
        self.betas, self.state_s = [], []
        self._orig = (cox_mod.RiskSets.state, cox_mod.RiskSets.nll)
        st, nl = self._orig

        def state(rs, b):
            self.betas.append(np.asarray(b).copy())
            t0 = time.perf_counter()
            out = st(rs, b)
            self.state_s.append(time.perf_counter() - t0)
            self.rs = rs
            return out

        def nll(rs, b):
            self.betas.append(np.asarray(b).copy())
            return nl(rs, b)
        cox_mod.RiskSets.state, cox_mod.RiskSets.nll = state, nll
        return self

    def __exit__(self, *exc):
        cox_mod.RiskSets.state, cox_mod.RiskSets.nll = self._orig

    def distinct(self):
        out = []
        for b in self.betas:
            if not out or not np.array_equal(out[-1], b):
                out.append(b)
        return out


def fit_cox(fr, **kw):
    kw.setdefault("device", DEV)
    sync()
    t0 = time.perf_counter()
    m = CoxPH(stop_column="time", **kw).train(
        x=[n for n in fr.names if n not in ("time", "event")], y="event",
        training_frame=fr)
    sync()
    return m, time.perf_counter() - t0


def phase_coxph(X, paths) -> None:
    """18e: CoxPH, Efron and Breslow, at 1M x 28 with whole-day ties;
    the Hessian's device ms; card against CPU."""
    fr_c = cox_frame(X)
    t_ = fr_c.vec("time").data
    for ties in ("efron", "breslow"):
        hk.reset_launches()
        with CoxProbe() as pr:
            m, wall = fit_cox(fr_c, ties=ties)
        got = hist_launches()
        paths[f"coxph_{ties}"] = got
        no_hist("CoxPH", got)
        o = m.output
        rs = pr.rs

        def grad_hessian():         # forward, gradient, batched Hessian
            return rs.state(o["coef"])
        h_ms = time_ms(grad_hessian, n=3, warm=1)
        # the Newton state at one beta is the same at every call (the
        # float32 stop test and the steps follow its last places)
        reps = [grad_hessian() for _ in range(3)]
        state_repeats = all(r[0] == reps[0][0] and
                            np.array_equal(r[1], reps[0][1]) and
                            np.array_equal(r[2], reps[0][2]) for r in reps)
        emit(dict(phase=f"coxph_{ties}", rows=R, cols=C, wall_s=wall,
                  iterations=o["iterations"],
                  ms_per_iteration=wall / o["iterations"] * 1e3,
                  state_host_ms_median=statistics.median(pr.state_s) * 1e3,
                  grad_hessian_device_ms=h_ms, tie_groups=rs.n_groups,
                  max_ties=rs.max_ties, n_events=o["n_events"],
                  censored_share=1 - o["n_events"] / R,
                  distinct_times=int(len(np.unique(t_))),
                  loglik=o["loglik"], null_loglik=o["null_loglik"],
                  concordance=o["concordance"],
                  state_bitwise_over_3_calls=state_repeats))
        if not state_repeats:
            raise AssertionError(f"CoxPH {ties}: the Newton state at one "
                                 "beta differs between calls")
        if not np.isfinite(o["coef"]).all() or \
                not o["loglik"] > o["null_loglik"] or \
                not 0.5 < o["concordance"] <= 1.0:
            raise AssertionError(f"CoxPH {ties}: implausible model")
        sub = cox_frame(X[:SUB_ROWS], seed=5)
        with CoxProbe() as pg:
            g, _ = fit_cox(sub, ties=ties)
        with CoxProbe() as pc:
            c, _ = fit_cox(sub, ties=ties, device="cpu")
        steps = max(float(np.abs(a - b).max())
                    for a, b in zip(pg.distinct()[:3], pc.distinct()[:3]))
        go, co = g.output, c.output
        rec = dict(phase=f"coxph_{ties}_cuda_vs_cpu", rows=SUB_ROWS,
                   iterations=(go["iterations"], co["iterations"]),
                   first_iterates_max_abs_diff=steps,
                   loglik_rel=abs(go["loglik"] - co["loglik"]) /
                   abs(co["loglik"]),
                   coef_max_abs_diff=float(np.abs(go["coef"] -
                                                  co["coef"]).max()),
                   # the region the float32 likelihood cannot resolve
                   # (tests/test_torch_coxph.py)
                   coef_unresolved=float(np.sqrt(
                       8 * np.spacing(np.float32(abs(co["loglik"]))) *
                       np.sum(co["se_coef"] ** 2))),
                   concordance=(go["concordance"], co["concordance"]))
        emit(rec)
        # the tests' tolerances (tests/test_torch_coxph.py); the
        # concordance over 4,000 rows moves with the coefficients' last
        # places (ties of the linear predictor): within 1e-4
        if steps > COX_STEP_ATOL or rec["loglik_rel"] > COX_LL_RTOL or \
                abs(go["iterations"] - co["iterations"]) > 1 or \
                rec["coef_max_abs_diff"] > rec["coef_unresolved"] or \
                abs(go["concordance"] - co["concordance"]) > 1e-4:
            raise AssertionError(f"CoxPH {ties}: card and CPU differ {rec}")


def phase_slice10(X, fr: Frame, paths) -> None:
    """18: PCA, SVD, GLRM, Word2Vec, NaiveBayes and CoxPH (no histogram
    kernel: each run's counters and the phase's total must read 0)."""
    cov = make_covertype(seed=0, categorical=True)
    total = list(hist_launches())
    reset = hk.reset_launches

    def counted_reset():            # keep the phase's total across resets
        got = hist_launches()
        total[0] += got[0]
        total[1] += got[1]
        reset()

    hk.reset_launches = counted_reset
    hk.reset_launches()
    total[:] = [0, 0]
    t = [time.perf_counter()]
    try:
        phase_decompositions(fr, cov, paths)
        t.append(time.perf_counter())
        phase_glrm(X, paths)
        t.append(time.perf_counter())
        phase_word2vec(paths)
        t.append(time.perf_counter())
        phase_naive_bayes(fr, cov, paths)
        t.append(time.perf_counter())
        phase_coxph(X, paths)
        t.append(time.perf_counter())
        hk.reset_launches()
    finally:
        hk.reset_launches = reset
    got = tuple(total)
    no_hist("phase 18", got)
    emit(dict(phase="phase18_walls", decompositions_s=t[1] - t[0],
              glrm_s=t[2] - t[1], word2vec_s=t[3] - t[2],
              naivebayes_s=t[4] - t[3], coxph_s=t[5] - t[4],
              total_s=t[5] - t[0], k1_launches=got[0], k2_launches=got[1]))


#: 19: IsotonicRegression, Aggregator, TargetEncoder, ModelSelection,
#: AnovaGLM, PSVM, Infogram, StackedEnsemble and Grep.  Aggregator's
#: rows (cut: see phase19's docstring), the Zipf key's levels, the
#: blending frame's rows, the clustered frame of the card-vs-CPU
#: Aggregator check (centers, spread) and Grep's pattern (x0 in
#: (-2.5, -2.0], some 8,000 lines of the first CSV file)
AGG_ROWS = 10_000
TE_LEVELS, TE_ZIPF = 2_000, 1.1
BLEND_ROWS = 250_000
AGG_CENTERS, AGG_SPREAD = 50, 6.0
GREP_REGEX = r"(?m)^-2\.[0-4]\d{7}e\+00,"
#: the CPU tests' tolerances (tests/test_torch_{isotonic_aggregator,
#: target_encoder,modelselection_anova,psvm,infogram,ensemble_grep}.py)
AGG_STD_ATOL, TE_RTOL, MS_RTOL, DEV_RTOL = 1e-6, 1e-6, 1e-5, 1e-5
PSVM_RTOL, INFO_ATOL, SE_RTOL = 1e-4, 1e-5, 1e-5


def run19(name: str, paths, fn, want=(0, 0)):
    """(result, wall) of one run of phase 19 with the launch counters set
    to 0 just before it; its (K1, K2) launches must be ``want``."""
    hk.reset_launches()
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    wall = time.perf_counter() - t0
    got = hist_launches()
    paths[name] = got
    if got != want:
        raise AssertionError(f"{name}: (K1, K2) launched {got}, want {want}")
    return out, wall


def wrap_timed(mod, name: str):
    """Wrap ``mod.name`` to count its calls and add up their seconds (on
    the host clock, the device synchronized around each); returns the
    tally and the restore function."""
    orig = getattr(mod, name)
    tally = dict(calls=0, s=0.0)

    def timed(*a, **k):
        sync()
        t0 = time.perf_counter()
        out = orig(*a, **k)
        sync()
        tally["calls"] += 1
        tally["s"] += time.perf_counter() - t0
        return out

    setattr(mod, name, timed)
    return tally, lambda: setattr(mod, name, orig)


def card_cpu(name: str, rec: dict, ok: bool) -> None:
    rec = dict(phase=name + "_cuda_vs_cpu", **rec)
    emit(rec)
    if not ok:
        raise AssertionError(f"{name}: card and CPU differ: {rec}")


def phase_isotonic(fr: Frame, paths) -> None:
    """19a: IsotonicRegression of the binary label on x0 (a score's
    calibration); PAV's host share, predict() over the rows."""
    xy = fr.subframe(["x0", "y"])
    pav, restore = wrap_timed(iso_mod, "_pav")
    try:
        m, wall = run19("isotonicregression", paths,
                        lambda: IsotonicRegression(device=DEV).train(
                            x=["x0"], y="y", training_frame=xy))
    finally:
        restore()
    sync()
    t0 = time.perf_counter()
    pred = m.predict(xy)
    p_wall = time.perf_counter() - t0
    p = pred.vec("predict").to_numpy()
    order = np.argsort(xy.vec("x0").to_numpy(), kind="stable")
    emit(dict(phase="isotonic", rows=R, wall_s=wall, pav_s=pav["s"],
              pav_share=pav["s"] / wall,
              thresholds=len(m.output["thresholds_x"]),
              predict_wall_s=p_wall, mse=m.output["training_metrics"]["mse"]))
    if pred.nrows != R or not np.isfinite(p).all() or \
            (np.diff(p[order]) < 0).any():
        raise AssertionError("isotonic: predictions not monotone in x0")
    sub = xy.slice_rows(slice(0, SUB_ROWS))
    g = IsotonicRegression(device=DEV).train(x=["x0"], y="y",
                                             training_frame=sub)
    c = IsotonicRegression(device="cpu").train(x=["x0"], y="y",
                                               training_frame=sub)
    eq_thr = all(np.array_equal(g.output[k], c.output[k])
                 for k in ("thresholds_x", "thresholds_y"))
    gp, cp = g.predict_raw(sub).cpu().numpy(), c.predict_raw(sub).numpy()
    card_cpu("isotonic", dict(rows=SUB_ROWS, thresholds_equal=eq_thr,
                              predict_bitwise=bool(np.array_equal(gp, cp))),
             eq_thr and np.array_equal(gp, cp))


def clustered_frame(rows: int, seed: int = 9) -> Frame:
    """``rows`` rows of C columns around AGG_CENTERS seeded centers."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(AGG_CENTERS, C)) * AGG_SPREAD
    Xc = (centers[rng.integers(0, AGG_CENTERS, rows)] +
          rng.normal(size=(rows, C)) * 0.3).astype(np.float32)
    return Frame([f"x{j}" for j in range(C)],
                 [Vec(Xc[:, j]) for j in range(C)])


def phase_aggregator(X, paths) -> None:
    """19b: Aggregator at its defaults on AGG_ROWS rows of the 28
    columns; trials, exemplars, the host share, the distance product's
    device ms against its bound."""
    fa = Frame([f"x{j}" for j in range(C)],
               [Vec(X[:AGG_ROWS, j]) for j in range(C)])
    trials, restore_a = wrap_timed(agg_mod, "aggregate")
    near, restore_n = wrap_timed(agg_mod, "nearest")
    try:
        m, wall = run19("aggregator", paths, lambda: Aggregator(
            device=DEV).train(training_frame=fa))
    finally:
        restore_n()
        restore_a()
    ex = torch.from_numpy(np.asarray(m.output["exemplars_std"],
                                     np.float32)).to(DEV)
    Xb = expand_for_scoring(fa, m.output["expansion_spec"], DEV)[
        :agg_mod.BATCH]
    gemm_ms = time_ms(lambda: agg_mod.nearest(Xb, ex))
    nb, ne = Xb.shape[0], ex.shape[0]
    g_bound, g_by = bound((nb + ne) * C * 4 + nb * 12, 2 * nb * ne * C)
    emit(dict(phase="aggregator", rows=AGG_ROWS, cols=C, wall_s=wall,
              trials=trials["calls"], s_per_trial=trials["s"] /
              max(trials["calls"], 1), exemplars=m.output["num_exemplars"],
              radius_scale=m.output["radius_scale"],
              distance_device_s=near["s"],
              host_share=(trials["s"] - near["s"]) / wall,
              gemm_ms=gemm_ms, gemm_bound_ms=g_bound, gemm_bound_by=g_by,
              gemm_shape=[nb, ne, C],
              reduced=dict(rows=[R, AGG_ROWS], s_per_trial=trials["s"] /
                           max(trials["calls"], 1))))
    agg = m.aggregated_frame()
    if agg.nrows != m.output["num_exemplars"] or \
            int(agg.vec("counts").to_numpy().sum()) != AGG_ROWS:
        raise AssertionError("aggregator: the aggregated frame's counts "
                             "do not cover the rows")
    # card against CPU where the radius decides every row: clusters
    cf = clustered_frame(SUB_ROWS)
    kw = dict(target_num_exemplars=100, rel_tol_num_exemplars=0.7)
    g = Aggregator(device=DEV, **kw).train(training_frame=cf)
    c = Aggregator(device="cpu", **kw).train(training_frame=cf)
    go, co = g.output, c.output
    # predict()'s labels: equal wherever the two nearest exemplars'
    # squared distances (float64 here) differ by more than the rounding
    # of the expanded product |b|^2 - 2 b.e + |e|^2 in float32 (28 terms:
    # ~1e-6 of |b|^2 + |e|^2, which inside a cluster exceeds d^2 itself)
    gl, cl = g.predict_raw(cf).cpu().numpy(), c.predict_raw(cf).numpy()
    rows = np.flatnonzero(gl != cl)
    Xs = expand_for_scoring(cf, co["expansion_spec"], "cpu").numpy()[
        rows].astype(np.float64)
    E = co["exemplars_std"].astype(np.float64)
    d2 = ((Xs[:, None, :] - E[None, :, :]) ** 2).sum(axis=2)
    near = np.argsort(d2, axis=1)[:, :2]
    gap = np.take_along_axis(d2, near[:, 1:], 1)[:, 0] - \
        np.take_along_axis(d2, near[:, :1], 1)[:, 0]
    scale = (Xs ** 2).sum(axis=1) + (E ** 2).sum(axis=1)[near].max(axis=1)
    decided = int(np.sum(gap > 1e-5 * scale))
    rec = dict(rows=SUB_ROWS, exemplars=(go["num_exemplars"],
                                         co["num_exemplars"]),
               counts_equal=bool(np.array_equal(go["counts"], co["counts"])),
               exemplars_std_max_diff=float(np.abs(
                   go["exemplars_std"] - co["exemplars_std"]).max()),
               frames_equal=all(np.array_equal(
                   g.aggregated_frame().vec(n).to_numpy(),
                   c.aggregated_frame().vec(n).to_numpy())
                   for n in g.aggregated_frame().names),
               label_diffs=len(rows), label_diffs_decided=decided)
    card_cpu("aggregator", rec, rec["counts_equal"] and rec["frames_equal"]
             and not decided
             and rec["exemplars_std_max_diff"] <= AGG_STD_ATOL)


def zipf_codes(rows: int, levels: int, seed: int = 11) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, levels + 1) ** TE_ZIPF
    return rng.choice(levels, size=rows, p=p / p.sum()).astype(np.int32)


TE_KW = dict(data_leakage_handling="KFold", nfolds=5, blending=True,
             noise=0.01, seed=1)


def te_check(name: str, sub: Frame, x, y: str) -> None:
    g = TargetEncoder(device=DEV, **TE_KW).train(x=x, y=y,
                                                 training_frame=sub)
    c = TargetEncoder(device="cpu", **TE_KW).train(x=x, y=y,
                                                   training_frame=sub)
    agg = max(float(np.max(np.abs(g.output["enc"][k][s] -
                                  c.output["enc"][k][s]) /
                           np.maximum(np.abs(c.output["enc"][k][s]), 1.0)))
              for k in x for s in ("cnt", "sum"))
    enc = 0.0
    for as_training in (True, False):
        tg = g.transform(sub, as_training=as_training)
        tc = c.transform(sub, as_training=as_training)
        enc = max([enc] + [float(np.abs(tg.vec(f"{k}_te").to_numpy() -
                                        tc.vec(f"{k}_te").to_numpy()).max())
                           for k in x])
    card_cpu(name, dict(rows=sub.nrows, aggregates_max_rel_diff=agg,
                        encodings_max_diff=enc),
             agg <= TE_RTOL and enc <= TE_RTOL)


def phase_target_encoder(fr: Frame, cov: Frame, paths) -> None:
    """19c: TargetEncoder on covertype's wild and soil (the most frequent
    class against the rest) and on a 2,000-level Zipf key beside the
    1M x 28 frame: KFold 5, blending, noise 0.01; fit and transform
    walls."""
    yc = cov.vec("y").data
    top = int(np.argmax(np.bincount(yc)))
    cv = Frame(["wild", "soil", "top"],
               [cov.vec("wild"), cov.vec("soil"),
                Vec((yc == top).astype(np.int32), T_CAT,
                    domain=["rest", "top"])])
    fk = Frame(list(fr.names), list(fr.vecs))
    fk.add("key", Vec(zipf_codes(R, TE_LEVELS), T_CAT,
                      domain=[f"k{i}" for i in range(TE_LEVELS)]))
    for name, data, x, y in (("targetencoder_covertype", cv,
                              ["wild", "soil"], "top"),
                             ("targetencoder_zipf", fk, ["key"], "y")):
        m, wall = run19(name, paths, lambda: TargetEncoder(
            device=DEV, **TE_KW).train(x=x, y=y, training_frame=data))
        sync()
        t0 = time.perf_counter()
        t = m.transform(data, as_training=True)
        t_wall = time.perf_counter() - t0
        enc = np.stack([t.vec(f"{k}_te").to_numpy() for k in x])
        emit(dict(phase=name, rows=data.nrows, columns=x,
                  levels=[data.vec(k).cardinality for k in x],
                  fit_wall_s=wall, transform_wall_s=t_wall,
                  prior=m.output["prior"]))
        if not np.isfinite(enc).all():
            raise AssertionError(f"{name}: encodings not finite")
        te_check(name, data.slice_rows(slice(0, SUB_ROWS)), x, y)


def phase_selection(fr: Frame, paths) -> None:
    """19d ModelSelection maxr up to 2 predictors and 19e AnovaGLM at its
    defaults on 1M x 28 (the port's GLM: passes on the card)."""
    glm_fits, restore = wrap_timed(ms_mod, "_fit_glm")
    try:
        m, wall = run19("modelselection", paths, lambda: ModelSelection(
            device=DEV, mode="maxr", max_predictor_number=2, seed=1).train(
                y="y", training_frame=fr))
    finally:
        restore()
    best = m.best_model_per_size()
    emit(dict(phase="modelselection", rows=R, cols=C, mode="maxr",
              wall_s=wall, glm_fits=glm_fits["calls"],
              s_per_fit=glm_fits["s"] / glm_fits["calls"],
              predictors={s: b["predictors"] for s, b in best.items()},
              scores={s: b["score"] for s, b in best.items()}))
    if sorted(best) != [1, 2] or best[1]["score"] >= best[2]["score"]:
        raise AssertionError("modelselection: implausible best subsets")
    sub = fr.slice_rows(slice(0, SUB_ROWS))
    kw = dict(mode="maxr", max_predictor_number=2, seed=1)
    g = ModelSelection(device=DEV, **kw).train(y="y", training_frame=sub)
    c = ModelSelection(device="cpu", **kw).train(y="y", training_frame=sub)
    gb, cb = g.best_model_per_size(), c.best_model_per_size()
    same = all(gb[s]["predictors"] == cb[s]["predictors"] for s in cb)
    rel = max(abs(gb[s]["score"] - cb[s]["score"]) / abs(cb[s]["score"])
              for s in cb)
    card_cpu("modelselection", dict(rows=SUB_ROWS, predictors_equal=same,
                                    score_max_rel_diff=rel),
             same and rel <= MS_RTOL)

    m, wall = run19("anovaglm", paths, lambda: AnovaGLM(
        device=DEV, seed=1).train(y="y", training_frame=fr))
    table = m.result()
    emit(dict(phase="anovaglm", rows=R, cols=C, wall_s=wall,
              glm_fits=m.output["glm_fits"],
              s_per_fit=wall / m.output["glm_fits"],
              table=[[t, df, float(d), float(p)] for t, df, d, p in table]))
    if len(table) != C or not all(np.isfinite([r[2] for r in table])):
        raise AssertionError("anovaglm: implausible table")
    g = AnovaGLM(device=DEV, seed=1).train(y="y", training_frame=sub)
    c = AnovaGLM(device="cpu", seed=1).train(y="y", training_frame=sub)
    go, co = g.output, c.output
    dev_rel = max([abs(go["full_deviance"] - co["full_deviance"]) /
                   co["full_deviance"]] +
                  [abs(a - b) / b for a, b in zip(go["term_deviances"],
                                                  co["term_deviances"])])
    ok = dev_rel <= DEV_RTOL
    for a, b, dsub in zip(g.result(), c.result(), co["term_deviances"]):
        bnd = 1e-4 * abs(b[2]) + DEV_RTOL * (dsub + co["full_deviance"]) / \
            co["dispersion"]
        ok = ok and a[:2] == b[:2] and abs(a[2] - b[2]) <= bnd and (
            abs(a[3] - b[3]) <= 1e-4 or
            anova_mod._chi2_sf(b[2] + bnd, b[1]) <= a[3] <=
            anova_mod._chi2_sf(max(b[2] - bnd, 0.0), b[1]))
    card_cpu("anovaglm", dict(rows=SUB_ROWS, deviance_max_rel_diff=dev_rel,
                              statistic_max_diff=max(
                                  abs(a[2] - b[2]) for a, b in
                                  zip(g.result(), c.result()))), ok)


def rank_auc(score: np.ndarray, label: np.ndarray) -> float:
    """The AUC of an unbounded score (Mann-Whitney over its ranks)."""
    ranks = np.empty(len(score))
    ranks[np.argsort(score, kind="stable")] = np.arange(1, len(score) + 1)
    pos = label == 1
    n1 = int(pos.sum())
    return float((ranks[pos].sum() - n1 * (n1 + 1) / 2) /
                 (n1 * (len(label) - n1)))


def phase_psvm(fr: Frame, paths) -> None:
    """19f: PSVM at its defaults (256 Fourier features, 200 iterations):
    a step's device ms against its bound (Z read twice), Platt's wall,
    the training AUC."""
    fit_t, restore_f = wrap_timed(psvm_mod, "svm_fit")
    platt_t, restore_p = wrap_timed(psvm_mod, "platt")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m, wall = run19("psvm", paths, lambda: PSVM(
                device=DEV, seed=1).train(y="y", training_frame=fr))
    finally:
        restore_p()
        restore_f()
    out = m.output
    X = expand_for_scoring(fr, out["expansion_spec"], DEV)
    W = torch.from_numpy(out["rff_w"]).to(DEV)
    b = torch.from_numpy(out["rff_b"]).to(DEV)
    Z = psvm_mod.fourier_features(X, W, b)
    del X
    beta = torch.from_numpy(out["beta"]).to(DEV)
    ysign = torch.where(torch.from_numpy(fr.vec("y").as_float()).to(DEV) >
                        0, 1.0, -1.0)
    w = torch.ones_like(ysign)
    c = torch.tensor(1.0, device=DEV)

    def step():
        marg = ysign * (Z @ beta[:-1] + beta[-1])
        gy = torch.where(marg < 1.0, w, torch.zeros_like(w)) * ysign
        return torch.cat([beta[:-1] - c * (Z.T @ gy), (-c * gy.sum())[None]])

    step_ms = time_ms(step)
    s_bound, s_by = bound(2 * Z.numel() * 4, 4 * Z.numel())
    iters = int(m.params["max_iterations"])
    del Z
    torch.cuda.empty_cache()
    auc = out["training_metrics"]["AUC"]
    # the decision values' own ranking: Platt's host Newton steps diverge
    # on these margins in both packages (|a| > 1e8), and the sign of a,
    # hence the training AUC, then follows rounding
    dec_auc = rank_auc(m.decision(fr).cpu().numpy(), fr.vec("y").data)
    emit(dict(phase="psvm", rows=R, cols=C, features=out["feature_dim"],
              iterations=iters, wall_s=wall, fit_s=fit_t["s"],
              ms_per_iteration=fit_t["s"] * 1e3 / iters,
              step_device_ms=step_ms, step_bound_ms=s_bound,
              step_bound_by=s_by, platt_s=platt_t["s"], train_auc=auc,
              decision_auc=dec_auc, platt_a=out["platt_a"],
              z_gb=R * out["feature_dim"] * 4 / 1e9))
    if not (0.0 <= auc <= 1.0 and 0.5 < dec_auc <= 1.0):
        raise AssertionError(f"psvm: AUC {auc}, decision AUC {dec_auc}")
    sub = fr.slice_rows(slice(0, SUB_ROWS))
    masks = {}

    def fit_on(device):
        hook = []
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mm_ = PSVM(device=device, seed=1)._fit(
                [n for n in sub.names if n != "y"], "y", sub, None,
                step_hook=lambda t, bt, mk: hook.append(mk.cpu().numpy()))
        masks[str(device)] = hook
        return mm_

    g, cpu_m = fit_on(DEV), fit_on("cpu")
    go, co = g.output, cpu_m.output
    Xc = expand_for_scoring(sub, co["expansion_spec"], "cpu")
    Xg = expand_for_scoring(sub, go["expansion_spec"], DEV)
    Wc, bc = torch.from_numpy(co["rff_w"]), torch.from_numpy(co["rff_b"])
    Zc = psvm_mod.fourier_features(Xc, Wc, bc).numpy()
    Zg = psvm_mod.fourier_features(Xg, Wc.to(DEV), bc.to(DEV)).cpu().numpy()
    P, D = Wc.shape
    absW = np.abs(co["rff_w"]).astype(np.float64)
    Xn = Xc.numpy()
    zbound = np.sqrt(2.0 / D) * ((P + 2) * 2.0 ** -24 *
                                 (np.abs(Xn) @ absW + np.abs(co["rff_b"])) +
                                 np.abs(Xg.cpu().numpy() - Xn) @ absW +
                                 2.0 ** -23) + np.spacing(
        np.abs(Zc).astype(np.float32))
    parted = next((t for t, (a, b2) in enumerate(zip(
        masks[str(DEV)], masks["cpu"])) if not np.array_equal(a, b2)), None)
    beta_rel = float(np.abs(go["beta"] - co["beta"]).max() /
                     np.abs(co["beta"]).max())
    rec = dict(rows=SUB_ROWS, w_b_bitwise=bool(
        np.array_equal(go["rff_w"], co["rff_w"]) and
        np.array_equal(go["rff_b"], co["rff_b"])),
        z_within_bound=bool(np.all(np.abs(Zg - Zc) <= zbound)),
        z_max_diff=float(np.abs(Zg - Zc).max()),
        beta_max_rel_diff=beta_rel, masks_part_at_step=parted,
        decision_auc=tuple(rank_auc(mm_.decision(sub).cpu().numpy(),
                                    sub.vec("y").data)
                           for mm_ in (g, cpu_m)))
    held = beta_rel <= PSVM_RTOL or (
        parted is not None and
        abs(rec["decision_auc"][0] - rec["decision_auc"][1]) <= 1e-3)
    card_cpu("psvm", rec, rec["w_b_bitwise"] and rec["z_within_bound"]
             and held)


def phase_infogram(fr: Frame, paths) -> None:
    """19g: Infogram at its defaults (seed 1): 1 + 28 GBMs whose every
    level K2 carries (20 x 5 + 28 x 10 x 3 = 940 launches)."""
    m, wall = run19("infogram", paths, lambda: Infogram(
        device=DEV, seed=1).train(y="y", training_frame=fr),
        want=(0, 20 * 5 + C * 10 * 3))
    emit(dict(phase="infogram", rows=R, cols=C, wall_s=wall,
              admissible=m.admissible_features(),
              table=[[r[0], r[1], r[2], r[3]] for r in m.result()],
              k2_launches=paths["infogram"][1]))
    if not m.admissible_features():
        raise AssertionError("infogram: no admissible feature")
    sub = fr.slice_rows(slice(0, INFO_CPU_ROWS))
    g, g_gbms = infogram_and_gbms(sub, DEV)
    c, c_gbms = infogram_and_gbms(sub, "cpu")
    gt = {r[0]: r for r in g.result()}
    ct = {r[0]: r for r in c.result()}
    adm = c.admissible_features()
    # a predictor's information index is held where its 10 trees are the
    # same on both devices; where they part, the first node that differs
    # (its ancestors and the earlier trees equal) must be a tie: the two
    # devices' gains there within 1e-6 of the node's wgg, which is at
    # most its cover (a binomial residual is below 1 in size)
    held, parted = [], {}
    for col, a, b in zip(c.output["x"], g_gbms[1:], c_gbms[1:]):
        first = first_split_difference(a.output, b.output)
        if first is None:
            held.append(col)
            continue
        t, k, n = first
        ga, gb = (float(o["node_gain"][t, k, n]) for o in (a.output,
                                                           b.output))
        parted[col] = dict(tree=t, node=n, gains=(ga, gb),
                           cover=float(b.output["node_w"][t, k, n]),
                           information=(gt[col][2], ct[col][2]))
    rel = max(abs(gt[k][1] - ct[k][1]) for k in ct)
    info = max(abs(gt[k][2] - ct[k][2]) for k in held)
    ties = all(abs(v["gains"][0] - v["gains"][1]) <= 1e-6 * v["cover"]
               for v in parted.values())
    order = [r[0] for r in g.result() if r[0] in held] == \
        [r[0] for r in c.result() if r[0] in held]
    card_cpu("infogram", dict(rows=INFO_CPU_ROWS, admissible=adm,
                              relevance_max_diff=rel,
                              relevance_trees_equal=first_split_difference(
                                  g_gbms[0].output, c_gbms[0].output) is None,
                              columns_trees_equal=len(held),
                              held_information_max_diff=info,
                              held_order_equal=order, parted=parted),
             g.admissible_features() == adm and set(adm) <= set(held) and
             rel <= INFO_ATOL and info <= INFO_ATOL and ties and order)


_SPLIT_KEYS = ("split_col", "thr_bin", "na_left", "bitset")


def first_split_difference(a: dict, b: dict):
    """(tree, class, node) of the first node, in tree and heap order,
    where two GBM outputs' splits differ; None when every tree is equal."""
    diff = np.zeros(a["split_col"].shape, bool)
    for k in _SPLIT_KEYS:
        diff |= (np.asarray(a[k]) != np.asarray(b[k])).reshape(
            diff.shape + (-1,)).any(axis=-1)
    hit = np.argwhere(diff)
    return tuple(int(v) for v in hit[0]) if len(hit) else None


def infogram_and_gbms(fr: Frame, device):
    """An Infogram (seed 1) on ``fr`` and the GBMs it fitted, in its
    order: the relevance model, then one per predictor."""
    fitted = []

    class Kept(GBM):
        def _fit(self, *a, **k):
            fitted.append(super()._fit(*a, **k))
            return fitted[-1]

    infogram_mod.GBM = Kept
    try:
        m = Infogram(device=device, seed=1).train(y="y", training_frame=fr)
    finally:
        infogram_mod.GBM = GBM
    return m, fitted


def se_bases(fr: Frame, device):
    common = dict(device=device, nfolds=5, seed=1,
                  keep_cross_validation_predictions=True)
    gbm = GBM(ntrees=20, max_depth=5, **common).train(y="y",
                                                      training_frame=fr)
    glm = GLM(family="binomial", **common).train(y="y", training_frame=fr)
    return gbm, glm


def phase_ensemble(fr: Frame, paths) -> None:
    """19h: StackedEnsemble over a 5-fold GBM (K2 600) and a 5-fold
    binomial GLM on 1M x 28, in CV mode and with a 250,000-row blending
    frame; base walls apart from the ensemble's."""
    (gbm, glm), base_wall = run19("stackedensemble_bases", paths,
                                  lambda: se_bases(fr, DEV),
                                  want=(0, 6 * 20 * 5))
    se, se_wall = run19("stackedensemble", paths, lambda: StackedEnsemble(
        device=DEV, base_models=[gbm, glm], seed=1).train(
            y="y", training_frame=fr))
    sync()
    t0 = time.perf_counter()
    pred = se.predict(fr)
    p_wall = time.perf_counter() - t0
    Xb, yb = make_data(BLEND_ROWS, C, seed=1)
    fb = frame(Xb, yb)
    bl, bl_wall = run19("stackedensemble_blending", paths,
                        lambda: StackedEnsemble(
                            device=DEV, base_models=[gbm, glm],
                            blending_frame=fb, seed=1).train(
                                y="y", training_frame=fr))
    aucs = dict(ensemble=se.output["training_metrics"]["AUC"],
                ensemble_cv=se.output["cross_validation_metrics"]["AUC"],
                blending=bl.output["training_metrics"]["AUC"],
                blending_holdout=bl.output["validation_metrics"]["AUC"],
                gbm=gbm.output["training_metrics"]["AUC"],
                gbm_cv=gbm.output["cross_validation_metrics"]["AUC"],
                glm=glm.output["training_metrics"]["AUC"],
                glm_cv=glm.output["cross_validation_metrics"]["AUC"])
    emit(dict(phase="stackedensemble", rows=R, cols=C, folds=5,
              bases_wall_s=base_wall, ensemble_wall_s=se_wall,
              blending_rows=BLEND_ROWS, blending_wall_s=bl_wall,
              predict_wall_s=p_wall, aucs=aucs,
              metalearner_coef=se.output["metalearner"].coef()))
    if pred.nrows != R or aucs["ensemble_cv"] < aucs["glm_cv"] - 0.01:
        raise AssertionError(f"stackedensemble: implausible AUCs {aucs}")
    # card against CPU: the same base models (trained on the card, loaded
    # onto the CPU from their files), the metalearner trained on each
    sub = fr.slice_rows(slice(0, SUB_ROWS))
    bases = se_bases(sub, DEV)
    with tempfile.TemporaryDirectory() as d:
        cpu_bases = [Model.load(b.save(os.path.join(d, f"b{i}.bin")),
                                device="cpu") for i, b in enumerate(bases)]
        g = StackedEnsemble(device=DEV, base_models=list(bases),
                            seed=1).train(y="y", training_frame=sub)
        c = StackedEnsemble(device="cpu", base_models=cpu_bases,
                            seed=1).train(y="y", training_frame=sub)
        back = Model.load(g.save(os.path.join(d, "se.bin")), device="cpu")
    gc, cc = g.output["metalearner"].coef(), c.output["metalearner"].coef()
    coef = max(abs(gc[k] - v) / max(1.0, abs(v)) for k, v in cc.items())
    gp = g.predict_raw(sub).cpu().numpy()
    prob = float(np.abs(gp[:, 1:] - c.predict_raw(sub).numpy()[:, 1:]).max())
    loaded = float(np.abs(gp[:, 1:] - back.predict_raw(sub).numpy()[:, 1:])
                   .max())
    card_cpu("stackedensemble", dict(
        rows=SUB_ROWS, metalearner_coef_max_rel_diff=coef,
        proba_max_diff=prob, loaded_on_cpu_proba_max_diff=loaded,
        loaded_devices=sorted({str(m_.device) for m_ in
                               back.output["base_models"] +
                               [back.output["metalearner"]]})),
        coef <= SE_RTOL and prob <= SE_RTOL and loaded <= SE_RTOL)


def phase_grep(X, y, paths) -> None:
    """19i: Grep over phase 15's first CSV file (written again), held
    against an independent ``re.finditer`` pass."""
    n_part = R // CSV_FILES
    with tempfile.TemporaryDirectory(prefix="h2o_grep_") as tmp:
        path = os.path.join(tmp, "part0.csv")
        nbytes = write_csv(path, X[:n_part], y[:n_part])
        m, wall = run19("grep", paths, lambda: Grep(
            device=DEV, regex=GREP_REGEX).train(training_frame=path))
        with open(path, "r") as f:
            text = f.read()
    want = [(mt.start(), mt.group(0)) for mt in re.finditer(GREP_REGEX,
                                                            text)]
    got = list(zip(m.output["offsets"], m.output["matches"]))
    emit(dict(phase="grep", bytes=nbytes, matches=len(got), wall_s=wall,
              mb_per_s=nbytes / wall / 1e6, regex=GREP_REGEX))
    if got != want or not 1_000 <= len(got) <= 100_000:
        raise AssertionError(f"grep: {len(got)} matches, the independent "
                             f"pass {len(want)}, equal: {got == want}")


def phase_slice11(X, y, fr: Frame, paths) -> None:
    """19: IsotonicRegression, Aggregator, TargetEncoder, ModelSelection,
    AnovaGLM, PSVM, Infogram, StackedEnsemble and Grep (see the module
    docstring)."""
    cov = make_covertype(seed=0, categorical=True)
    t = [time.perf_counter()]
    for run in (lambda: phase_isotonic(fr, paths),
                lambda: phase_aggregator(X, paths),
                lambda: phase_target_encoder(fr, cov, paths),
                lambda: phase_selection(fr, paths),
                lambda: phase_psvm(fr, paths),
                lambda: phase_infogram(fr, paths),
                lambda: phase_ensemble(fr, paths),
                lambda: phase_grep(X, y, paths)):
        run()
        torch.cuda.empty_cache()
        t.append(time.perf_counter())
    names = ("isotonic", "aggregator", "targetencoder", "selection", "psvm",
             "infogram", "stackedensemble", "grep")
    emit(dict(phase="phase19_walls", total_s=t[-1] - t[0],
              **{f"{n}_s": b - a for n, a, b in zip(names, t, t[1:])}))


def bits_equal(a, b) -> bool:
    """Two arrays or tensors equal bit for bit (NaN included)."""
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        a.tobytes() == b.tobytes()


def phase_mojo(m, head: Frame, d: str) -> tuple:
    """20a: the default GBM written as an npz MOJO and as a genmodel zip,
    read back, and both scored by the host scorers on ``head``: held
    against the card's ``predict_raw`` (probabilities within 1e-5,
    labels equal where p1 is more than 1e-6 from the threshold)."""
    Xh = head.as_matrix(m.output["x"], "cpu").numpy().astype(np.float64)
    card = m.predict_raw(head).cpu().numpy()
    thr = float(m.output.get("default_threshold", 0.5))
    decided = np.abs(card[:, 2] - thr) > 1e-6
    paths_ = {"npz": os.path.join(d, "gbm_npz.zip"),
              "genmodel": os.path.join(d, "gbm_genmodel.zip")}
    rec, host = {}, {}
    for fmt, path in paths_.items():
        t0 = time.perf_counter()
        if fmt == "npz":
            export_mojo(m, path)
        else:
            with open(path, "wb") as f:
                f.write(export_genmodel_mojo(m))
        t1 = time.perf_counter()
        mojo = load_mojo(path)
        t2 = time.perf_counter()
        # in blocks of 10,000 rows: the npz scorer bins through a (rows,
        # C, fine bins) comparison, 2.9 GB at 100,000 rows at once
        raw = np.concatenate([np.asarray(mojo.score_matrix(Xh[i:i + 10_000]))
                              for i in range(0, len(Xh), 10_000)])
        t3 = time.perf_counter()
        err = float(np.max(np.abs(raw[:, 1:] - card[:, 1:])))
        labels = bool(np.array_equal(raw[decided, 0], card[decided, 0]))
        rec[fmt] = dict(bytes=os.path.getsize(path), write_s=t1 - t0,
                        read_s=t2 - t1, score_s=t3 - t2,
                        rows_per_s=HOST_ROWS / (t3 - t2),
                        max_abs_err_p=err, labels_equal=labels,
                        rows_near_threshold=int((~decided).sum()))
        if err > 1e-5 or not labels or raw.shape != card.shape:
            raise AssertionError(f"20a {fmt} MOJO: max |p - card| {err}, "
                                 f"labels equal {labels}")
        host[fmt] = raw
    emit(dict(phase="mojo", model=m.model_id, rows=HOST_ROWS, **rec))
    return paths_["genmodel"], host


def host_scores(m, Xh: np.ndarray) -> np.ndarray:
    """The pure-NumPy MOJO scorer of ``m`` (the arrays ``export_mojo``
    writes) on the rows ``Xh``, in blocks of 10,000 rows (its binning
    compares each value with every fine bin edge)."""
    arrays, meta = _flatten_arrays(m.output)
    mojo = MojoModel(m.algo, dict(m.params), meta, arrays)
    return np.concatenate([np.asarray(mojo.score_matrix(Xh[i:i + 10_000]))
                           for i in range(0, len(Xh), 10_000)])


def held_to_host(what: str, card: np.ndarray, host: np.ndarray,
                 thr: float, tol: float = 1e-5) -> dict:
    """The card's binomial raw predictions against the host scorer's on
    the same rows: probabilities within ``tol``, labels equal where p1
    is more than ``tol`` from the threshold."""
    decided = np.abs(card[:, 2] - thr) > tol
    err = float(np.max(np.abs(host[:, 1:] - card[:, 1:])))
    labels = bool(np.array_equal(host[decided, 0], card[decided, 0]))
    if host.shape != card.shape or not err <= tol or not labels:
        raise AssertionError(f"{what}: max |p - host| {err}, labels equal "
                             f"{labels}, shapes {card.shape} {host.shape}")
    return dict(max_abs_err_host=err, labels_equal_host=labels,
                rows_near_threshold=int((~decided).sum()))


def phase_fast_path(fr: Frame, head: Frame, models: dict,
                    gbm_host: np.ndarray) -> None:
    """20b: ``predict_raw_array`` over the 1M rows on the card, bitwise
    ``predict_raw(frame)``, and its first HOST_ROWS rows held against
    the model's host MOJO scorer (20a's scores for the GBM).  The
    array's wall leaves out building the matrix (``as_matrix_s``),
    which ``predict_raw(frame)`` does itself."""
    rec = {}
    for name, m in models.items():
        sync()
        t0 = time.perf_counter()
        Xd = fr.as_matrix(m.output["x"], DEV)
        sync()
        t1 = time.perf_counter()
        a = m.predict_raw_array(Xd)
        sync()
        t2 = time.perf_counter()
        b = m.predict_raw(fr)
        sync()
        t3 = time.perf_counter()
        same = bits_equal(a, b)
        if not same or a.device != DEV:
            raise AssertionError(f"20b {name}: predict_raw_array differs "
                                 "from predict_raw(frame)")
        Xh = head.as_matrix(m.output["x"], "cpu").numpy().astype(np.float64)
        host = gbm_host if name == "gbm" else host_scores(m, Xh)
        t4 = time.perf_counter()
        rec[name] = dict(as_matrix_s=t1 - t0, array_s=t2 - t1,
                         frame_s=t3 - t2, bitwise_equal=same,
                         device=str(a.device), host_score_s=t4 - t3,
                         **held_to_host(f"20b {name}",
                                        a[:HOST_ROWS].cpu().numpy(), host,
                                        float(m.output.get(
                                            "default_threshold", 0.5))))
    emit(dict(phase="fast_path", rows=R, host_rows=HOST_ROWS, **rec))


def reordered(fc: Frame, cols, seed: int = 21) -> tuple:
    """``fc`` with each categorical of ``cols`` under its domain
    reversed plus a level "unseen" that 1 % of its rows take, and ``fc``
    with those cells NA: the frame Generic remaps, and the frame the
    card's model scores as it was trained."""
    rng = np.random.default_rng(seed)
    moved, na = fc, fc
    for c in cols:
        v = fc.vec(c)
        L, codes = len(v.domain), v.data
        hit = rng.uniform(size=codes.shape[0]) < 0.01
        new = np.where(hit, L, np.where(codes < 0, -1, L - 1 - codes))
        moved = moved.drop(c).add(c, Vec(new, T_CAT, domain=list(
            reversed(v.domain)) + ["unseen"]))
        na = na.drop(c).add(c, Vec(np.where(hit, -1, codes), T_CAT,
                                   domain=v.domain))
    return moved, na


def phase_generic(path: str, head: Frame, host: np.ndarray, m_cat,
                  fc: Frame, d: str) -> None:
    """20c: the genmodel zip imported as a Generic model (import_mojo and
    the Generic builder, both on the card): its predictions equal 20a's
    host scores, as float32, bitwise.  Then the categorical deployment's
    genmodel zip, imported, scores a frame whose wild and soil domains
    are reversed and hold an unseen level (the adaptTestForTrain remap):
    bitwise as it scores the frame in training order with those cells
    NA, and within 1e-5 of the card's model on that frame."""
    want = host.astype(np.float32)
    rec = {}
    for name, load in (("import_mojo", lambda: import_mojo(path)),
                       ("Generic", lambda: Generic(path=path).train())):
        t0 = time.perf_counter()
        g = load()
        t1 = time.perf_counter()
        raw = g.predict_raw(head)
        sync()
        t2 = time.perf_counter()
        pred = g.predict(head)
        same = bits_equal(raw, want) and raw.device == DEV and \
            bits_equal(pred.vec("s").data, want[:, 2])
        rec[name] = dict(load_s=t1 - t0, predict_raw_s=t2 - t1,
                         bitwise_equal=same)
        if not same:
            raise AssertionError(f"20c {name}: Generic predictions differ "
                                 "from the host scorer's")
    cat_path = os.path.join(d, "gbm_covertype_genmodel.zip")
    with open(cat_path, "wb") as f:
        f.write(export_genmodel_mojo(m_cat))
    moved, na = reordered(fc.slice_rows(slice(0, REMAP_ROWS)),
                          ("wild", "soil"))
    g = import_mojo(cat_path)
    t0 = time.perf_counter()
    raw = g.predict_raw(moved)
    sync()
    t1 = time.perf_counter()
    same = bits_equal(raw, g.predict_raw(na)) and raw.device == DEV
    if not same:
        raise AssertionError("20c remap: the reordered frame scores "
                             "otherwise than the frame in training order")
    rec["remap"] = dict(model=m_cat.model_id, rows=REMAP_ROWS,
                        predict_raw_s=t1 - t0,
                        bitwise_equal=same,
                        **held_to_host("20c remap", m_cat.predict_raw(
                            na).cpu().numpy(), raw.cpu().numpy().astype(
                            np.float64), float(m_cat.output.get(
                                "default_threshold", 0.5))))
    emit(dict(phase="generic", rows=HOST_ROWS, **rec))


def serving_model(paths) -> tuple:
    """The deployment of 20d: a GBM (20 trees, depth 5) on the
    covertype-shaped frame with wild and soil as categoricals, class c1
    against the rest, trained on the card (K2 every level)."""
    cov = make_covertype(seed=0, categorical=True)
    yc = cov.vec("y").data
    fc = cov.drop("y").add("y", Vec((yc == 1).astype(np.int32), T_CAT,
                                    domain=["rest", "c1"]))
    m, wall, got = launched(train, fr=fc)
    paths["gbm_covertype_categorical"] = got
    emit(dict(phase="serving_model", rows=fc.nrows, ntrees=20, max_depth=5,
              wall_s=wall, train_auc=m.output["training_metrics"]["AUC"],
              k1_launches=got[0], k2_launches=got[1]))
    if got != (0, 100):
        raise AssertionError(f"serving model: (K1, K2) launched {got}, "
                             "want (0, 100)")
    return m, fc


def request_rows(fc: Frame, x, seed: int = 20) -> list:
    """REQUESTS JSON-like requests of 1..MAX_REQUEST row dicts drawn from
    ``fc``: categoricals as their level strings, 2 % of them an unseen
    level, 2 % of the keys missing, 1 % of the numbers as strings."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, MAX_REQUEST + 1, size=REQUESTS)
    starts = rng.integers(0, fc.nrows - MAX_REQUEST, size=REQUESTS)
    vals = {c: fc.vec(c).data for c in x}
    doms = {c: fc.vec(c).domain for c in x if fc.vec(c).is_categorical}
    reqs = []
    for n, s in zip(sizes, starts):
        unseen = rng.uniform(size=(n, len(x))) < 0.02
        missing = rng.uniform(size=(n, len(x))) < 0.02
        as_str = rng.uniform(size=(n, len(x))) < 0.01
        rows = []
        for i in range(n):
            row = {}
            for j, c in enumerate(x):
                if missing[i, j]:
                    continue
                v = vals[c][s + i]
                if c in doms:
                    row[c] = "unseen" if unseen[i, j] else doms[c][v]
                else:
                    row[c] = repr(float(v)) if as_str[i, j] else float(v)
            rows.append(row)
        reqs.append(rows)
    return reqs


def phase_engine(m, fc: Frame, km, fr: Frame) -> None:
    """20d: ScoringEngine warms buckets 1, 32 and 1,024, then answers
    REQUESTS requests, each bitwise ``predict_raw_array`` on the same
    encoded rows; the KMeans deployment goes to the host scorer; evict
    empties the model's buckets."""
    from torch.profiler import ProfilerActivity, profile
    eng = ScoringEngine()
    x = list(m.output["x"])
    reqs = request_rows(fc, x)
    t0 = time.perf_counter()
    eng.warm(m, 1, WARM_BUCKETS)
    sync()
    warm_s = time.perf_counter() - t0
    lat, enc, mism, nrows = {}, [], 0, 0
    for rows in reqs:
        t0 = time.perf_counter()
        X = eng.encode_rows(m, 1, rows)
        t1 = time.perf_counter()
        ans = eng.predict(m, 1, X)
        t2 = time.perf_counter()
        enc.append(t1 - t0)
        b = 1 if len(rows) <= 1 else 1 << (len(rows) - 1).bit_length()
        lat.setdefault(b, []).append((t2 - t1) * 1e3)
        want = m.predict_raw_array(torch.from_numpy(
            X.astype(np.float32)).to(DEV))
        mism += not bits_equal(ans, want)
        nrows += len(rows)
    stats = eng.stats()
    buckets = {str(b): dict(requests=len(v), p50_ms=float(np.percentile(
        v, 50)), p99_ms=float(np.percentile(v, 99)))
        for b, v in sorted(lat.items())}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.predict(m, 1, eng.encode_rows(m, 1, reqs[0]))
    dev_ops = sum(1 for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA)
    # the KMeans deployment: no device predict, the host scorer answers
    head = fr.slice_rows(slice(0, 100))
    krows = [{c: float(head.vec(c).data[i]) for c in km.output[
        "expansion_spec"]["num_names"]} for i in range(head.nrows)]
    kx = eng.encode_rows(km, 0, krows)
    lab = eng.predict(km, 0, kx)
    card = km.predict_raw(head).cpu().numpy()
    # a label may differ only where the two centers are equally near
    kv = eng.view(km, 0)
    Xe = scorers._expand(kv.meta, kx)
    cen = kv.arrays["centers_std"]
    d2 = ((Xe[:, None, :] - cen[None]) ** 2).sum(-1)
    diff = np.flatnonzero(lab != card)
    gap = d2[diff, card[diff].astype(int)] - d2[diff, lab[diff].astype(int)]
    scale = (Xe[diff] ** 2).sum(1) + (cen ** 2).sum(1).max()
    not_tie = int((np.abs(gap) > 1e-5 * scale).sum())
    k_stats = eng.stats()
    eng.evict(m.model_id, 1)
    left = eng.buckets_for(m.model_id, 1)
    emit(dict(phase="engine", model=m.model_id, requests=REQUESTS,
              rows=nrows, warm_buckets=list(WARM_BUCKETS), warm_s=warm_s,
              encode_ms_p50=float(np.percentile(enc, 50)) * 1e3,
              encode_ms_p99=float(np.percentile(enc, 99)) * 1e3,
              buckets=buckets, mismatched_requests=mism,
              device_ops_one_request=dev_ops, rows_one_request=len(reqs[0]),
              stats=stats, kmeans_fallback_batches=k_stats[
                  "fallback_batches"],
              kmeans_label_agreement=float(np.mean(lab == card)),
              kmeans_differences_not_ties=not_tie,
              buckets_after_evict=left))
    if mism or stats["device_batches"] != REQUESTS or \
            stats["fallback_batches"] != 0:
        raise AssertionError(f"20d: {mism} answers differ from "
                             f"predict_raw_array; stats {stats}")
    if k_stats["fallback_batches"] != 1 or lab.shape != (100,) or \
            not np.isfinite(lab).all() or not_tie or left:
        raise AssertionError(f"20d: KMeans host scoring {k_stats}, "
                             f"{not_tie} labels differ from the card's "
                             f"outside ties, buckets after evict {left}")


def phase_slice12(fr: Frame, m_def, m_drf, paths) -> tuple:
    """20: MOJO write and read, the array fast path, Generic and the
    engine over models earlier phases trained (and 20d's deployment);
    neither histogram kernel runs.  Returns the deployment and its
    frame for phase 21."""
    m_cat, fc = serving_model(paths)
    hk.reset_launches()
    t0 = time.perf_counter()
    head = fr.slice_rows(slice(0, HOST_ROWS))
    with tempfile.TemporaryDirectory(prefix="h2o_mojo_") as d:
        path, host = phase_mojo(m_def, head, d)
        phase_fast_path(fr, head, {"gbm": m_def, "drf": m_drf,
                                   "xgboost": KEEP["xgboost"],
                                   "glm": KEEP["glm"]}, host["npz"])
        phase_generic(path, head, host["genmodel"], m_cat, fc, d)
    phase_engine(m_cat, fc, KEEP["kmeans"], fr)
    got = hist_launches()
    paths["serving"] = got
    no_hist("phase 20", got)
    emit(dict(phase="phase20_walls", total_s=time.perf_counter() - t0))
    return m_cat, fc


# ---------------------------------------------------------------------------
# 21 the serving layers above the engine
# ---------------------------------------------------------------------------

#: 21a: distinct requests in the pool the clients cycle through (each one's
#: answer alone is computed once), client counts, seconds of traffic each
SERVE_POOL, SERVE_CLIENTS, SERVE_SECONDS = 128, (1, 8, 32), 3.0
#: 21b-c: requests of the pool the lifecycle, canary and shadow runs use
LIFE_POOL = 32
#: 21b, 21e: seconds the clients run on after the last timed action
ACTION_TAIL_S = 0.5
#: 21e: the covertype deployment's pool for the fleet
FLEET_POOL = 48


def pool_rows(fr: Frame, x, n: int, seed: int) -> list:
    """``n`` requests of 1-4 JSON-like rows drawn by seed from ``fr``:
    numbers as floats, categoricals as their level strings."""
    rng = np.random.default_rng(seed)
    vals = {c: fr.vec(c).data for c in x}
    doms = {c: fr.vec(c).domain for c in x if fr.vec(c).is_categorical}
    reqs = []
    for k in rng.integers(1, 5, size=n):
        rows = []
        for r in rng.integers(0, fr.nrows, size=k):
            rows.append({c: (doms[c][vals[c][r]] if c in doms
                             else float(vals[c][r])) for c in x})
        reqs.append(rows)
    return reqs


def alone(eng, m, version: int, pool: list) -> tuple:
    """Each request of ``pool`` scored by the engine on its rows alone,
    and the wall of one such call (ms, median)."""
    out, ms = [], []
    for rows in pool:
        t0 = time.perf_counter()
        out.append(eng.predict(m, version, eng.encode_rows(m, version,
                                                             rows)))
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, float(np.median(ms))


def drive(score, pool: list, clients: int, seconds: float,
          at=()) -> tuple:
    """``clients`` threads call ``score(rows)`` over ``pool`` for
    ``seconds``; ``at`` holds (delay, name, action) triples the calling
    thread runs meanwhile, each ``delay`` seconds after the previous
    action returned (the first after the start), so a slow action (a
    hot swap's warm) never eats the next one's window.  The clients run
    on until ``ACTION_TAIL_S`` after the last action when that is later
    than ``seconds``.  A client whose alias is gone (``KeyError``)
    stops.  Returns (request index, answer and version or the exception,
    start, end) for every request, and the actions' times."""
    box = {"end": float("inf") if at else None}
    res = [[] for _ in range(clients)]
    barrier = threading.Barrier(clients + 1, timeout=60)

    def client(tid):
        barrier.wait()
        i = tid
        while time.perf_counter() < box["end"]:
            k = i % len(pool)
            t0 = time.perf_counter()
            try:
                got = score(pool[k])
            except Exception as e:  # noqa: BLE001 — classified by the caller
                got = e
            res[tid].append((k, got, t0, time.perf_counter()))
            if isinstance(got, KeyError):
                return
            i += clients

    threads = [threading.Thread(target=client, args=(t,), daemon=True)
               for t in range(clients)]
    for t in threads:
        t.start()
    t_start = time.perf_counter()
    if not at:
        box["end"] = t_start + seconds
    barrier.wait()
    marks, t_prev = {}, t_start
    for delay, name, fn in at:
        time.sleep(max(0.0, t_prev + delay - time.perf_counter()))
        t0 = time.perf_counter()
        fn()
        t_prev = time.perf_counter()
        marks[name] = (t0, t_prev)
    if at:
        box["end"] = max(t_start + seconds, t_prev + ACTION_TAIL_S)
    for t in threads:
        t.join(seconds + 120)
        if t.is_alive():
            raise AssertionError("21: a client thread did not finish")
    return [r for per in res for r in per], marks


def traffic_stats(res: list, dep, b0: int) -> dict:
    lat = [(t1 - t0) * 1e3 for _k, _g, t0, t1 in res]
    wall = max(t1 for *_x, t1 in res) - min(t0 for _k, _g, t0, _t in res)
    batches = dep.stats.batches - b0
    return dict(requests=len(res), requests_per_s=len(res) / wall,
                p50_ms=float(np.percentile(lat, 50)),
                p99_ms=float(np.percentile(lat, 99)), batches=batches,
                mean_requests_per_batch=len(res) / max(batches, 1))


def phase_batched(reg, m, fr: Frame) -> tuple:
    """21a: the default GBM behind ``ServingConfig(max_batch=32,
    max_delay_ms=2, queue_cap=256)``, driven from 1, 8 and 32 client
    threads; every answer bitwise the engine on that request alone."""
    reg.deploy("higgs", m, ServingConfig(max_batch=32, max_delay_ms=2,
                                         queue_cap=256))
    dep = reg.get("higgs")
    x = list(m.output["x"])
    pool = pool_rows(fr, x, SERVE_POOL, seed=21)
    want, call_ms = alone(reg.engine, m, 1, pool)
    runs = {}
    for n in SERVE_CLIENTS:
        b0 = dep.stats.batches
        res, _ = drive(lambda rows: reg.score_rows("higgs", rows), pool, n,
                       SERVE_SECONDS)
        bad = [repr(g) for _k, g, *_t in res if isinstance(g, Exception)]
        mism = sum(not bits_equal(g[0], want[k]) or g[1].version != 1
                   for k, g, *_t in res if not isinstance(g, Exception))
        runs[str(n)] = dict(traffic_stats(res, dep, b0), errors=len(bad),
                            mismatched=mism)
        if bad or mism:
            raise AssertionError(f"21a: {n} clients, {len(bad)} errors "
                                 f"({bad[:3]}), {mism} answers differ "
                                 "from the engine alone")
    emit(dict(phase="serve_batched", model=m.model_id, pool=SERVE_POOL,
              rows=sum(len(r) for r in pool), engine_call_ms_p50=call_ms,
              seconds=SERVE_SECONDS, clients=runs,
              speedup_32_vs_1=runs["32"]["requests_per_s"] /
              runs["1"]["requests_per_s"],
              stats={k: v for k, v in reg.describe(dep)["stats"].items()}))
    return pool, want


def phase_lifecycle(reg, m, m_drf, pool, want) -> tuple:
    """21b: hot swap to the DRF under load, roll back, undeploy while the
    clients run; every answer is the engine's alone on one of the two
    versions, the swapped-in version's only while it was active, and
    nothing is answered after the undeploy."""
    pool = pool[:LIFE_POOL]
    want_drf, drf_ms = alone(reg.engine, m_drf, 2, pool)
    cfg = reg.get("higgs").config

    res, marks = drive(
        lambda rows: reg.score_rows("higgs", rows), pool, 8, 3.0,
        at=((0.5, "swap", lambda: reg.deploy("higgs", m_drf, cfg)),
            (0.8, "rollback", lambda: reg.rollback("higgs")),
            (0.8, "undeploy", lambda: reg.undeploy("higgs"))))
    drf_buckets = reg.engine.buckets_for(m_drf.model_id, 2)
    gbm_buckets = reg.engine.buckets_for(m.model_id, 1)
    counts = {"v1": 0, "v2": 0, "gone": 0}
    bad = []
    for k, g, t0, t1 in res:
        if isinstance(g, KeyError):
            counts["gone"] += 1
            if t1 < marks["undeploy"][0]:
                bad.append(("404 before the undeploy", k))
            continue
        if isinstance(g, Exception):
            bad.append(("error", repr(g)))
            continue
        if t0 > marks["undeploy"][1]:
            bad.append(("answered after the undeploy", k))
        if bits_equal(g[0], want[k]):
            counts["v1"] += 1
        elif bits_equal(g[0], want_drf[k]):
            counts["v2"] += 1
            if t1 < marks["swap"][0] or t0 > marks["rollback"][1]:
                bad.append(("DRF answer outside its window", k))
        else:
            bad.append(("answer of neither version", k))
    emit(dict(phase="serve_lifecycle", requests=len(res), **counts,
              drf_engine_call_ms_p50=drf_ms,
              marks_s={n: [a - res[0][2], b - res[0][2]]
                       for n, (a, b) in marks.items()},
              drf_buckets_after_rollback=drf_buckets,
              gbm_buckets_after_undeploy=gbm_buckets, violations=bad[:5]))
    if bad or drf_buckets or gbm_buckets or not counts["v2"] or \
            not counts["gone"] or reg.get("higgs") is not None:
        raise AssertionError(f"21b: {bad[:5]}, counts {counts}, buckets "
                             f"{drf_buckets} / {gbm_buckets}")
    return pool, want_drf


def phase_canary_shadow(reg, m, m_drf, pool, want, want_drf) -> None:
    """21c: the DRF deployed, a canary of the GBM at 0.25 under load,
    promoted; a canary made to fail, rolled back automatically while its
    clients see the stable version; a shadow of the active model with 0
    mismatches.  The canary is the faster model: a DRF call takes ~2.3x
    a GBM call, and a canary whose p99 passes 2x the primary's is rolled
    back by the registry's own rule (a DRF canary over the GBM was, in
    some runs), which would leave nothing to promote."""
    reg.deploy("higgs", m_drf, ServingConfig(max_batch=32, max_delay_ms=2,
                                             queue_cap=256))
    reg.set_canary("higgs", m, fraction=0.25)
    dep = reg.get("higgs")
    res, _ = drive(lambda rows: reg.score_rows("higgs", rows), pool, 8, 1.5)
    lanes, bad = {1: 0, 2: 0}, []
    for k, g, *_t in res:
        if isinstance(g, Exception):
            bad.append(repr(g))
            continue
        lanes[g[1].version] += 1
        if not bits_equal(g[0], (want_drf if g[1].version == 1
                                 else want)[k]):
            bad.append(("wrong answer", k, g[1].version))
    canary_share = lanes[2] / max(1, len(res))
    reg.promote_canary("higgs")
    out, ver = reg.score_rows("higgs", pool[0])
    promoted = ver.version == 2 and bits_equal(out, want[0])
    # a canary that fails on every batch it scores
    reg.set_canary("higgs", m_drf, fraction=0.5)
    bad_version = dep.canary.version
    orig = reg.engine.predict

    def failing(model, version, X):
        if version == bad_version:
            raise RuntimeError("canary made to fail")
        return orig(model, version, X)
    reg.engine.predict = failing
    seen = []
    try:
        for i in range(60):
            out, ver = reg.score_rows("higgs", pool[i % len(pool)])
            seen.append(ver.version == 2 and bits_equal(
                out, want[i % len(pool)]))
            if dep.canary is None:
                break
    finally:
        reg.engine.predict = orig
    rolled = dict(rollbacks=dep.canary_rollbacks,
                  fallbacks=dep.canary_fallbacks, requests=len(seen))
    # a shadow of the active GBM: compared, never returned
    reg.set_shadow("higgs", m)
    sres, _ = drive(lambda rows: reg.score_rows("higgs", rows), pool, 2, 0.5)
    t_end = time.perf_counter() + 60
    while time.perf_counter() < t_end:
        sh = reg.describe(dep)["shadow"]
        if sh["compared"] + sh["errors"] + sh["dropped"] >= len(sres):
            break
        time.sleep(0.01)
    sh = reg.describe(dep)["shadow"]
    s_bad = sum(isinstance(g, Exception) or not bits_equal(g[0], want[k])
                for k, g, *_t in sres)
    reg.undeploy("higgs")
    emit(dict(phase="serve_canary_shadow", requests=len(res),
              lanes=lanes, canary_share=canary_share, promoted=promoted,
              failing_canary=rolled, shadow=sh,
              shadow_requests=len(sres), errors=bad[:5]))
    if bad or not 0.15 < canary_share < 0.35 or not promoted or \
            rolled["rollbacks"] != 1 or rolled["fallbacks"] < 5 or \
            not all(seen) or sh["mismatches"] or sh["errors"] or \
            not sh["compared"] or s_bad:
        raise AssertionError(f"21c: errors {bad[:5]}, share "
                             f"{canary_share}, promoted {promoted}, "
                             f"failing canary {rolled}, shadow {sh}, "
                             f"{s_bad} shadowed answers off")


def _concurrently(fn, n: int) -> tuple:
    """``n`` threads call ``fn()`` once each; their outcomes."""
    out = [None] * n

    def run(i):
        try:
            out[i] = fn()
        except Exception as e:  # noqa: BLE001 — classified by the caller
            out[i] = e
    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    return threads, out


def _join(threads) -> None:
    for t in threads:
        t.join(60)
        if t.is_alive():
            raise AssertionError("21d: a request thread did not finish")


def phase_protection(reg, m, pool) -> None:
    """21d: the breaker's whole cycle (queue pressure held by chaos
    slow-score enters SHEDDING, chaos serve-pressure trips OPEN, the
    cooldown opens HALF_OPEN, three probes close it), deadlines expiring
    as ``TimeoutError`` under slow-score, and ``QueueFull``."""
    saved = {k: os.environ.get(k) for k in ("H2O_TPU_BREAKER_INTERVAL_MS",
                                            "H2O_TPU_BREAKER_OPEN_SECS")}
    os.environ["H2O_TPU_BREAKER_INTERVAL_MS"] = "0"
    os.environ["H2O_TPU_BREAKER_OPEN_SECS"] = "0.25"
    try:
        reg.deploy("guard", m, ServingConfig(max_batch=1, max_delay_ms=0,
                                             queue_cap=20))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    dep = reg.get("guard")
    breaker.reset_totals()
    chaos_mod.configure(score_slow_p=1.0, score_slow_ms=150, seed=21)
    threads, held = _concurrently(
        lambda: reg.score_rows("guard", pool[1]), 19)
    t_end = time.perf_counter() + 20
    while dep.batcher.pending < 17 and time.perf_counter() < t_end:
        time.sleep(0.002)
    state_queued = dep.breaker.state
    chaos_mod.configure(score_slow_p=1.0, score_slow_ms=150,
                        serve_pressure_p=1.0, seed=21)
    refusals = []
    try:
        reg.score_rows("guard", pool[2])
    except (ShedLoad, BreakerOpen) as e:
        refusals.append(e)
    state_injected = dep.breaker.state
    injected = chaos_mod.chaos().counters()
    chaos_mod.reset()
    _join(threads)
    time.sleep(0.3)                           # the cooldown
    probes = []
    for i in range(3):
        out, _ver = reg.score_rows("guard", pool[i])
        probes.append(dep.breaker.state)
    refusals += [o for o in held if isinstance(o, (ShedLoad, BreakerOpen))]
    other = [repr(o) for o in held if isinstance(o, Exception) and
             not isinstance(o, (ShedLoad, BreakerOpen))]
    edges = [(e["from"], e["to"]) for e in dep.breaker.stats()["events"]]
    want_edges = [("closed", "shedding"), ("shedding", "open"),
                  ("open", "half_open"), ("half_open", "closed")]
    b_stats = dep.breaker.stats()
    reg.undeploy("guard")

    # deadlines: slow-score holds the worker past each request's 100 ms
    reg.deploy("slow", m, ServingConfig(max_batch=1, max_delay_ms=0,
                                        queue_cap=16, deadline_ms=100,
                                        breaker_enabled=False))
    chaos_mod.configure(score_slow_p=1.0, score_slow_ms=300, seed=22)
    threads, late = _concurrently(
        lambda: reg.score_rows("slow", pool[3]), 4)
    _join(threads)
    slow_counts = chaos_mod.chaos().counters()["injected_slow_scores"]
    chaos_mod.reset()
    expired = reg.get("slow").stats.snapshot()["deadline_expired_count"]
    reg.undeploy("slow")

    # a full queue
    reg.deploy("full", m, ServingConfig(max_batch=1, max_delay_ms=0,
                                        queue_cap=2,
                                        breaker_enabled=False))
    chaos_mod.configure(score_slow_p=1.0, score_slow_ms=200, seed=23)
    threads, fulls = _concurrently(
        lambda: reg.score_rows("full", pool[4]), 8)
    _join(threads)
    chaos_mod.reset()
    rejected = reg.get("full").stats.snapshot()["reject_count"]
    reg.undeploy("full")
    n_full = sum(isinstance(o, QueueFull) for o in fulls)
    n_ok = sum(isinstance(o, tuple) for o in fulls)
    emit(dict(phase="serve_protection", state_with_queue=state_queued,
              state_injected=state_injected, probe_states=probes,
              breaker_edges=edges, breaker_totals=breaker.totals(),
              refusals={"ShedLoad": sum(isinstance(e, ShedLoad)
                                        for e in refusals),
                        "BreakerOpen": sum(isinstance(e, BreakerOpen)
                                           for e in refusals)},
              min_retry_after_s=min((e.retry_after_s for e in refusals),
                                    default=None),
              injected_serve_pressure=injected["injected_serve_pressure"],
              breaker=dict(trips=b_stats["trips"], sheds=b_stats["sheds"]),
              deadline=dict(requests=len(late),
                            timeouts=sum(isinstance(o, TimeoutError)
                                         for o in late),
                            expired_count=expired,
                            injected_slow_scores=slow_counts),
              queue_full=dict(requests=len(fulls), queue_full=n_full,
                              answered=n_ok, reject_count=rejected)))
    it = iter(edges)
    if not all(e in it for e in want_edges) or other or \
            state_injected != "open" or probes[-1] != "closed" or \
            not refusals or any(e.retry_after_s <= 0 for e in refusals):
        raise AssertionError(f"21d breaker: edges {edges}, other errors "
                             f"{other[:3]}, refusals {len(refusals)}")
    if not all(isinstance(o, TimeoutError) for o in late) or expired != 4:
        raise AssertionError(f"21d deadlines: {late}, expired {expired}")
    if not n_full or not n_ok or n_full + n_ok != len(fulls) or \
            rejected != n_full:
        raise AssertionError(f"21d queue: {fulls}")


def phase_fleet(m_cat, fc: Frame) -> None:
    """21e: two replicas serving the covertype deployment (level strings
    in the rows); one dies while clients run, unannounced (its batcher
    stops, its health bit stays up), then is killed: every request
    answered, bitwise the engine alone, with at most one retry; all
    killed: ``NoHealthyReplica``."""
    reset_fleet()
    fl = fleet(2)
    fl.deploy("cov", m_cat)
    converged = fl.converged("cov")
    pool = pool_rows(fc, list(m_cat.output["x"]), FLEET_POOL, seed=25)
    want, _ms = alone(fl.engine, m_cat, 1, pool)
    def die():
        for dep in fl.replicas[1].registry._deployments.values():
            dep.batcher.stop(timeout=5.0)
    res, marks = drive(lambda rows: fl.score_rows("cov", rows), pool, 8,
                       2.0, at=((0.6, "die", die),
                                (0.6, "kill", lambda: fl.kill(1))))
    bad = [repr(g) for _k, g, *_t in res if isinstance(g, Exception)]
    mism = sum(not bits_equal(g[0], want[k]) for k, g, *_t in res
               if not isinstance(g, Exception))
    st = fl.stats()
    fl.kill(0)
    try:
        fl.score_rows("cov", pool[0])
        none = None
    except NoHealthyReplica as e:
        none = e.retry_after_s
    emit(dict(phase="serve_fleet", replicas=2, converged=converged,
              requests=len(res), errors=bad[:3], mismatched=mism,
              retries=st["retries"], redistributed=st["redistributed"],
              healthy_after_kill=st["healthy"],
              served=[r["served"] for r in st["members"]],
              no_healthy_retry_after_s=none))
    reset_fleet()
    if not converged or bad or mism or st["healthy"] != 1 or \
            st["retries"] != st["redistributed"] or \
            not st["redistributed"] or none is None or \
            none <= 0 or fleet().records():
        raise AssertionError(f"21e: converged {converged}, errors {bad}, "
                             f"{mism} answers off, stats {st}")


def phase_tuner(reg, m, pool, want) -> None:
    """21f: the adaptive tuner under 12 clients: every retune picks a
    power of two within [serve_min_batch, serve_max_batch]."""
    from h2o_tpu_torch import config
    TimeLine.clear()
    reg.deploy("tune", m, ServingConfig(max_batch=4, max_delay_ms=1,
                                        queue_cap=16, adaptive=True,
                                        breaker_enabled=False))
    dep = reg.get("tune")
    res, _ = drive(lambda rows: reg.score_rows("tune", rows), pool, 12, 2.0)
    picks = [e["max_batch"] for e in TimeLine.snapshot()
             if e["what"] == "batch_retune" and e["deployment"] == "tune"]
    t = dep.tuner.stats()
    lo, hi = config.serve_min_batch(), config.serve_max_batch()
    bad = [repr(g) for _k, g, *_t in res if isinstance(g, Exception)]
    mism = sum(not bits_equal(g[0], want[k]) for k, g, *_t in res
               if not isinstance(g, Exception))
    reg.undeploy("tune")
    emit(dict(phase="serve_tuner", requests=len(res), picks=picks,
              tuner=t, bounds=[lo, hi], errors=bad[:3], mismatched=mism))
    if not picks or t["grows"] < 1 or bad or mism or any(
            p & (p - 1) or not lo <= p <= hi for p in picks):
        raise AssertionError(f"21f: picks {picks}, tuner {t}, errors "
                             f"{bad[:3]}, {mism} answers off")


def phase_slice13(fr: Frame, m_def, m_drf, m_cat, fc: Frame, paths) -> None:
    """21: the serving layers above the engine over phase 20's models;
    neither histogram kernel runs."""
    hk.reset_launches()
    t = [time.perf_counter()]
    reg = registry()
    pool, want = phase_batched(reg, m_def, fr)
    t.append(time.perf_counter())
    pool_l, want_drf = phase_lifecycle(reg, m_def, m_drf, pool, want)
    t.append(time.perf_counter())
    phase_canary_shadow(reg, m_def, m_drf, pool_l, want[:LIFE_POOL],
                        want_drf)
    t.append(time.perf_counter())
    phase_protection(reg, m_def, pool)
    t.append(time.perf_counter())
    phase_fleet(m_cat, fc)
    t.append(time.perf_counter())
    phase_tuner(reg, m_def, pool, want)
    t.append(time.perf_counter())
    got = hist_launches()
    paths["serving_layers"] = got
    no_hist("phase 21", got)
    stats = reg.engine.stats()
    names = ("batched", "lifecycle", "canary_shadow", "protection", "fleet",
             "tuner")
    emit(dict(phase="phase21_walls", total_s=t[-1] - t[0],
              **{f"{n}_s": b - a for n, a, b in zip(names, t, t[1:])},
              engine=stats, deployments=[d["name"] for d in reg.list()]))
    if stats["fallback_batches"] or reg.list():
        raise AssertionError(f"21: host scorer batches {stats}, "
                             f"deployments left {reg.list()}")



# -- 22 ingest, the rest -------------------------------------------------------

def g9_lines(X, tail: np.ndarray, sep: int = ord(",")) -> np.ndarray:
    """(n, c) float32 -> (n, c * 16 + tail width) bytes: each value as
    ``format_g9`` writes it followed by ``sep``, then ``tail``'s bytes."""
    n, c = X.shape
    out = np.empty((n, c * 16 + tail.shape[1]), np.uint8)
    cells = out[:, : c * 16].reshape(n, c, 16)
    cells[..., :15] = format_g9(X)
    cells[..., 15] = sep
    out[:, c * 16:] = tail
    return out


def digits(v: np.ndarray, width: int) -> np.ndarray:
    """(n,) non-negative ints -> (n, width) ASCII digits, zero-padded."""
    return np.stack([(v // 10 ** (width - 1 - k)) % 10 + 48
                     for k in range(width)], axis=1).astype(np.uint8)


def covertype_matrix(cov: Frame) -> np.ndarray:
    return np.stack([v.data for v in cov.vecs[:-1]], axis=1)


def write_svmlight(path: str, cov: Frame) -> int:
    """``cov`` as LIBSVM publishes covtype: the label 1-7, then the
    non-zero ``index:value`` pairs with indices from 1, the normal
    columns' values with 9 significant digits, the one-hot blocks' ones
    as ``1``; returns the file's bytes."""
    M = covertype_matrix(cov)
    n = M.shape[0]
    normal, wild, soil = M[:, :10], M[:, 10:14], M[:, 14:54]
    if (normal == 0).any() or not ((wild.sum(1) == 1) &
                                   (soil.sum(1) == 1)).all():
        raise AssertionError("svmlight: a zero normal value or a one-hot "
                             "row without one 1")
    parts = [digits(cov.vec("y").data.astype(np.int64) + 1, 1)]
    for j in range(10):
        key = np.frombuffer(f" {j + 1}:".encode(), np.uint8)
        parts += [np.broadcast_to(key, (n, len(key))), format_g9(
            normal[:, j:j + 1]).reshape(n, 15)]
    for base, block in ((11, wild), (15, soil)):
        parts += [np.full((n, 1), ord(" "), np.uint8),
                  digits(base + block.argmax(1), 2),
                  np.broadcast_to(np.frombuffer(b":1", np.uint8), (n, 2))]
    parts.append(np.full((n, 1), ord("\n"), np.uint8))
    with open(path, "wb") as f:
        f.write(np.ascontiguousarray(np.concatenate(parts, axis=1)).tobytes())
    return os.path.getsize(path)


def write_arff(path: str, X, y) -> int:
    """OpenML's HIGGS ARFF layout: 28 numeric attributes and a nominal
    class {0,1}, values with 9 significant digits."""
    head = ("% HIGGS-shaped rows (OpenML data id 23512)\n@relation higgs\n"
            + "".join(f"@attribute x{j} numeric\n" for j in range(X.shape[1]))
            + "@attribute class {0,1}\n@data\n")
    tail = np.stack([y.astype(np.uint8) + 48,
                     np.full(len(y), ord("\n"), np.uint8)], axis=1)
    with open(path, "wb") as f:
        f.write(head.encode())
        f.write(g9_lines(X, tail).tobytes())
    return os.path.getsize(path)


def write_xlsx(path: str, X, y) -> int:
    """A SpreadsheetML workbook of one sheet: a header row of shared
    strings x0.. and y, then one row a record (values with 9
    significant digits, the label a shared string b or s)."""
    n, c = X.shape
    names = [f"x{j}" for j in range(c)] + ["y", "b", "s"]
    sst = ('<?xml version="1.0"?><sst xmlns="http://schemas.openxmlformats'
           '.org/spreadsheetml/2006/main">' + "".join(
               f"<si><t>{s}</t></si>" for s in names) + "</sst>")
    open_c, close_c = b"<c><v>", b"</v></c>"
    cell = len(open_c) + 15 + len(close_c)
    body = np.empty((n, c, cell), np.uint8)
    body[..., : len(open_c)] = np.frombuffer(open_c, np.uint8)
    body[..., len(open_c): len(open_c) + 15] = format_g9(X)
    body[..., len(open_c) + 15:] = np.frombuffer(close_c, np.uint8)
    lab = np.frombuffer(b'<c t="s"><v>', np.uint8)
    end = np.frombuffer(b"</v></c></row>\n", np.uint8)
    rows = np.concatenate([
        np.broadcast_to(np.frombuffer(b"<row>", np.uint8), (n, 5)),
        body.reshape(n, -1), np.broadcast_to(lab, (n, len(lab))),
        digits(c + 1 + y.astype(np.int64), 2),
        np.broadcast_to(end, (n, len(end)))], axis=1)
    header = "<row>" + "".join(f'<c t="s"><v>{j}</v></c>'
                               for j in range(c + 1)) + "</row>\n"
    sheet = ('<?xml version="1.0"?><worksheet xmlns="http://schemas.'
             'openxmlformats.org/spreadsheetml/2006/main"><sheetData>\n'
             + header).encode() + np.ascontiguousarray(rows).tobytes() + \
        b"</sheetData></worksheet>"
    import zipfile
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("xl/sharedStrings.xml", sst)
        z.writestr("xl/worksheets/sheet1.xml", sheet)
    return os.path.getsize(path)


def biff_record(op: int, body: bytes = b"") -> bytes:
    return struct.pack("<HH", op, len(body)) + body


def xls_book() -> bytes:
    """The CPU tests' workbook (``tests/test_xls_ingest.py``): an OLE2
    compound file whose Workbook stream holds a BIFF8 shared-string
    table, a header row and three rows of NUMBER, LABELSST and RK
    cells, one of them empty."""
    def bstr(s):
        return struct.pack("<HB", len(s), 0) + s.encode("latin-1")
    out = biff_record(0x0809, struct.pack("<HH12x", 0x0600, 0x0005))
    strings = ["num", "color", "y", "red", "blue"]
    out += biff_record(0x00FC, struct.pack("<II", 5, 5) +
                       b"".join(bstr(s) for s in strings))
    out += biff_record(0x000A)
    out += biff_record(0x0809, struct.pack("<HH12x", 0x0600, 0x0010))
    for c in range(3):
        out += biff_record(0x00FD, struct.pack("<HHHI", 0, c, 0, c))
    for r, (a, cc, yv) in enumerate(XLS_CELLS, start=1):
        out += biff_record(0x0203, struct.pack("<HHHd", r, 0, 0, a))
        out += biff_record(0x00FD, struct.pack("<HHHI", r, 1, 0, cc))
        if yv is not None:
            out += biff_record(0x027E, struct.pack(
                "<HHHI", r, 2, 0, (int(yv) << 2) | 2))
    out += biff_record(0x000A)
    stream = out + b"\x00" * max(0, 4096 - len(out))
    n_data = (len(stream) + 511) // 512
    stream = stream.ljust(n_data * 512, b"\x00")
    end_, free, fatsect = 0xFFFFFFFE, 0xFFFFFFFF, 0xFFFFFFFD
    fat = [fatsect, end_] + [2 + i + 1 if i + 1 < n_data else end_
                             for i in range(n_data)]
    fat += [free] * (128 - len(fat))

    def direntry(name, typ, start, size):
        raw = name.encode("utf-16-le")
        return (raw + b"\x00" * (64 - len(raw)) +
                struct.pack("<H", len(raw) + 2) + bytes([typ, 1]) +
                struct.pack("<III", free, free, free) + b"\x00" * 36 +
                struct.pack("<II", start, size) + b"\x00" * 4)

    dirs = direntry("Root Entry", 5, end_, 0) + \
        direntry("Workbook", 2, 2, len(stream)) + b"\x00" * 256
    header = b"\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1" + b"\x00" * 16 + \
        struct.pack("<HHHHH6x9I", 0x3E, 3, 0xFFFE, 9, 6, 0, 1, 1, 0, 4096,
                    end_, 0, end_, 0) + struct.pack("<109I", 0,
                                                   *[free] * 108)
    return header + struct.pack("<128I", *fat) + dirs + stream


class _OneFile(http.server.BaseHTTPRequestHandler):
    """Serves one file's bytes at any path and counts the GETs."""
    body, gets = b"", 0

    def log_message(self, *a):
        pass

    def do_GET(self):
        type(self).gets += 1
        self.send_response(200)
        self.send_header("Content-Length", str(len(self.body)))
        self.end_headers()
        self.wfile.write(self.body)


def timed(fn):
    """(result, host wall) of ``fn()``."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def frame_bits_equal(a: Frame, b: Frame) -> list:
    """Names of the columns whose payloads (numeric bits, codes and
    domains) differ."""
    bad = []
    for n in a.names:
        va, vb = a.vec(n), b.vec(n)
        if va.is_categorical:
            ok = list(va.domain) == list(vb.domain) and \
                np.array_equal(va.data, vb.data)
        else:
            x, w = va.to_numpy(), vb.to_numpy()
            ok = x.dtype == w.dtype and np.array_equal(
                x.view(np.uint32 if x.dtype == np.float32 else np.uint64),
                w.view(np.uint32 if w.dtype == np.float32 else np.uint64))
        if not ok:
            bad.append(n)
    return bad


def phase_svmlight(cov: Frame, tmp: str, paths) -> Frame:
    """22a: covertype as LIBSVM's covtype file, parsed with sparse
    columns, held against the in-memory frame; the multinomial GBM on
    it (K2 each level) equal to the GBM on the in-memory frame."""
    path = os.path.join(tmp, "covtype.svm")
    nbytes, write_s = timed(lambda: write_svmlight(path, cov))
    pf, parse_s = timed(lambda: parse_files([path], column_types={
        "target": "enum"}))
    M = covertype_matrix(cov)
    n = cov.nrows
    want_sparse = [bool(np.count_nonzero(M[:, j]) < 0.5 * n)
                   for j in range(M.shape[1])]
    got_sparse = [isinstance(v, SparseVec) for v in pf.vecs[2:]]
    unequal = [j for j in range(M.shape[1]) if not np.array_equal(
        pf.vecs[j + 2].data.view(np.uint32), M[:, j].view(np.uint32))]
    c1 = pf.vec("C1")
    held = dict(
        names=pf.names == ["target"] + [f"C{j}" for j in range(1, 56)],
        sparse_where_under_half=got_sparse == want_sparse,
        c1_all_zero=isinstance(c1, SparseVec) and c1.nnz == 0,
        columns_bitwise=not unequal,
        target=pf.vec("target").domain == [str(k) for k in range(1, 8)]
        and np.array_equal(pf.vec("target").data, cov.vec("y").data))
    emit(dict(phase="ingest_svmlight", rows=n, cols=54, bytes=nbytes,
              write_s=write_s, parse_s=parse_s,
              parse_mb_per_s=nbytes / parse_s / 1e6,
              sparse_columns=sum(got_sparse), held=held))
    if not all(held.values()):
        raise AssertionError(f"22a svmlight: {held}; unequal columns "
                             f"{unequal}")
    fr = pf.drop("C1")
    m_mem, wall_mem = fit(GBM, cov, ntrees=SVM_GBM_ITERS, seed=1)
    hk.reset_launches()
    sync()
    t0 = time.perf_counter()
    m = GBM(ntrees=SVM_GBM_ITERS, seed=1).train(y="target",
                                                training_frame=fr)
    sync()
    wall = time.perf_counter() - t0
    got = (hk.hist_cuda.launches, hk.hist_cuda_adaptive.launches)
    paths["ingest_formats"] = got
    eq = {k: bool(np.array_equal(m.output[k], m_mem.output[k]))
          for k in ("split_col", "thr_bin", "na_left", "bitset", "value",
                    "f0")}
    want = (0, SVM_GBM_ITERS * len(COV_COUNTS) * 5)
    emit(dict(phase="ingest_svmlight_gbm", rows=n, cols=54,
              iterations=SVM_GBM_ITERS, trees=SVM_GBM_ITERS * 7,
              wall_s=wall, in_memory_wall_s=wall_mem,
              logloss=m.output["training_metrics"]["logloss"],
              forest_equal=eq, k1_launches=got[0], k2_launches=got[1],
              reduced=dict(iterations=f"{SVM_GBM_ITERS} of phase 11's "
                           f"{COV_GBM_ITERS}")))
    if got != want or not all(eq.values()):
        raise AssertionError(f"22a GBM: launches {got} (want {want}), "
                             f"forest equal {eq}")
    return pf


def phase_arff(X, y, tmp: str) -> tuple:
    """22b: HIGGS-shaped rows as OpenML's ARFF, held bitwise."""
    path = os.path.join(tmp, "higgs.arff")
    Xa, ya = X[:ARFF_ROWS], y[:ARFF_ROWS]
    nbytes = write_arff(path, Xa, ya)
    pf, wall = timed(lambda: parse_files([path]))
    held = dict(names=pf.names == [f"x{j}" for j in range(C)] + ["class"],
                types=pf.types() == ["real"] * C + ["enum"],
                values=all(np.array_equal(pf.vecs[j].data.view(np.uint32),
                                          Xa[:, j].view(np.uint32))
                           for j in range(C)),
                cls=pf.vec("class").domain == ["0", "1"] and
                np.array_equal(pf.vec("class").data, ya))
    emit(dict(phase="ingest_arff", rows=ARFF_ROWS, cols=C + 1, bytes=nbytes,
              parse_s=wall, parse_mb_per_s=nbytes / wall / 1e6, held=held))
    if not all(held.values()):
        raise AssertionError(f"22b ARFF: {held}")
    return path, pf


def phase_avro(X, y, tmp: str) -> None:
    """22c: bench.py's rows and a string label as a deflate Avro file
    written by the port's writer, held bitwise."""
    path = os.path.join(tmp, "higgs.avro")
    Xa, ya = X[:AVRO_ROWS], y[:AVRO_ROWS]
    cols = [Xa[:, j].astype(np.float64).tolist() for j in range(C)] + \
        [np.where(ya == 1, "s", "b").tolist()]
    _, write_s = timed(lambda: write_avro(
        path, [f"x{j}" for j in range(C)] + ["y"], ["num"] * C + ["str"],
        cols, codec="deflate"))
    nbytes = os.path.getsize(path)
    pf, wall = timed(lambda: parse_files([path]))
    held = dict(names=pf.names == [f"x{j}" for j in range(C)] + ["y"],
                values=all(np.array_equal(pf.vecs[j].data.view(np.uint32),
                                          Xa[:, j].view(np.uint32))
                           for j in range(C)),
                label=pf.vec("y").domain == ["b", "s"] and
                np.array_equal(pf.vec("y").data, ya))
    emit(dict(phase="ingest_avro", rows=AVRO_ROWS, cols=C + 1, bytes=nbytes,
              codec="deflate", write_s=write_s, parse_s=wall,
              parse_mb_per_s=nbytes / wall / 1e6,
              rows_per_s=AVRO_ROWS / wall, held=held,
              reduced=dict(rows=f"{AVRO_ROWS} of {R}: the reader decodes "
                           "each cell in Python")))
    if not all(held.values()):
        raise AssertionError(f"22c Avro: {held}")


def phase_xls(X, y, tmp: str) -> None:
    """22d: an XLSX workbook held against the CSV parse of the same
    rows; the BIFF8 workbook of the CPU tests against its cells."""
    path = os.path.join(tmp, "higgs.xlsx")
    Xx, yx = X[:XLSX_ROWS], y[:XLSX_ROWS]
    nbytes = write_xlsx(path, Xx, yx)
    pf, wall = timed(lambda: parse_files([path]))
    csv_path = os.path.join(tmp, "higgs_xlsx.csv")
    write_csv(csv_path, Xx, yx)
    want = parse_files([csv_path])
    bad = frame_bits_equal(pf, want)
    book = os.path.join(tmp, "book.xls")
    with open(book, "wb") as f:
        f.write(xls_book())
    bf, wall_xls = timed(lambda: parse_files([book]))
    xls_ok = bf.names == ["num", "color", "y"] and \
        bf.vec("color").domain == ["blue", "red"] and np.array_equal(
            bf.vec("num").data, np.float32([r[0] for r in XLS_CELLS])) and \
        np.array_equal(bf.vec("color").data, [1, 0, 1]) and np.array_equal(
            bf.vec("y").data, np.float32([10, np.nan, 30]), equal_nan=True)
    emit(dict(phase="ingest_xls", xlsx_rows=XLSX_ROWS, xlsx_bytes=nbytes,
              xlsx_parse_s=wall, xlsx_mb_per_s=nbytes / wall / 1e6,
              xlsx_equal_to_csv_parse=not bad, xls_parse_s=wall_xls,
              xls_cells_held=xls_ok))
    if bad or pf.nrows != XLSX_ROWS or not xls_ok:
        raise AssertionError(f"22d: XLSX columns unlike the CSV parse "
                             f"{bad}, rows {pf.nrows}; XLS cells {xls_ok}")


def phase_remote(arff_path: str, arff_frame: Frame, svm_frame: Frame,
                 tmp: str) -> None:
    """22e: the ARFF file over http from 127.0.0.1 (one GET for two
    parses within max_age_s), and 22a's frame saved and loaded."""
    with open(arff_path, "rb") as f:
        _OneFile.body = f.read()
    _OneFile.gets = 0
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _OneFile)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        uri = f"http://127.0.0.1:{srv.server_address[1]}/higgs.arff"
        first, wall = timed(lambda: parse_files([uri]))
        again, wall2 = timed(lambda: parse_files([uri]))
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)
    bad = frame_bits_equal(first, arff_frame) + \
        frame_bits_equal(again, arff_frame)
    snap = os.path.join(tmp, "snapshot")
    _, save_s = timed(lambda: save_frame(svm_frame, snap))
    back, load_s = timed(lambda: load_frame(snap))
    snap_bytes = sum(os.path.getsize(os.path.join(snap, f))
                     for f in os.listdir(snap))
    bad_snap = [] if back.names != svm_frame.names else \
        frame_bits_equal(back, svm_frame)
    emit(dict(phase="ingest_remote_persist", bytes=len(_OneFile.body),
              http_parse_s=wall, http_mb_per_s=len(_OneFile.body) / wall
              / 1e6, second_parse_s=wall2, gets=_OneFile.gets,
              equal_to_local=not bad, snapshot_bytes=snap_bytes,
              save_s=save_s, load_s=load_s,
              snapshot_bitwise=back.names == svm_frame.names and
              not bad_snap))
    if bad or _OneFile.gets != 1 or back.names != svm_frame.names or \
            bad_snap:
        raise AssertionError(f"22e: remote columns unlike local {bad}, "
                             f"GETs {_OneFile.gets}; snapshot {bad_snap}")


def phase_stream(X, y, tmp: str) -> None:
    """22f: phase 15's first CSV file streamed in 4,096-row chunks into a
    growing frame, equal to the whole-file parse."""
    n_part = R // CSV_FILES
    path = os.path.join(tmp, "part0.csv")
    nbytes = write_csv(path, X[:n_part], y[:n_part])
    whole, whole_s = timed(lambda: parse_files([path]))

    def stream():
        rd = ChunkReader(path, chunk_rows=STREAM_CHUNK_ROWS)
        fr = None
        for cols in rd:
            fr = frame_from_chunk(cols, rd.setup) if fr is None else \
                fr.append_rows(cols)
        rd.close()
        return fr, rd.chunks_read
    (fr, chunks), wall = timed(stream)
    bad = [n for n in whole.names[:-1] if not np.array_equal(
        fr.vec(n).data.view(np.uint32), whole.vec(n).data.view(np.uint32))]
    dom = np.asarray(fr.vec("y").domain)
    labels_equal = np.array_equal(dom[fr.vec("y").data], np.asarray(
        whole.vec("y").domain)[whole.vec("y").data])
    emit(dict(phase="ingest_stream", rows=fr.nrows, bytes=nbytes,
              chunk_rows=STREAM_CHUNK_ROWS, chunks=chunks, stream_s=wall,
              rows_per_s=fr.nrows / wall, mb_per_s=nbytes / wall / 1e6,
              whole_file_parse_s=whole_s, numerics_bitwise=not bad,
              labels_equal=bool(labels_equal)))
    if fr.nrows != n_part or bad or not labels_equal or \
            chunks < n_part // STREAM_CHUNK_ROWS:
        raise AssertionError(f"22f stream: rows {fr.nrows}, columns unlike "
                             f"the whole parse {bad}, labels {labels_equal}")


def phase_timezone(tmp: str) -> None:
    """22g: naive times parsed under TZ_NAME equal zoneinfo's UTC
    milliseconds row by row, the DST gap and fold rows NA."""
    import datetime as dt
    import zoneinfo
    try:
        set_timezone(TZ_NAME)
    except ValueError as e:
        if "Unacceptable timezone" not in str(e) or \
                TZ_NAME in zoneinfo.available_timezones():
            raise
        emit(dict(phase="ingest_timezone", zone=TZ_NAME,
                  tz_database=False, refused=str(e)))
        return
    rng = np.random.default_rng(22)
    t0 = np.datetime64("2020-01-01T00:00", "m")
    walls = t0 + rng.integers(0, 3 * 365 * 1440, size=TZ_ROWS)
    special = np.array(["2021-03-14T02:30", "2021-11-07T01:30",
                        "2020-03-08T02:00", "2022-11-06T01:59"],
                       "datetime64[m]")
    walls[: len(special)] = special
    text = np.datetime_as_string(walls, unit="m")
    path = os.path.join(tmp, "times.csv")
    with open(path, "w") as f:
        f.write("t,n\n" + "".join(f"{s},{i}\n" for i, s in enumerate(text)))
    zone = zoneinfo.ZoneInfo(TZ_NAME)
    want = np.empty(TZ_ROWS)
    for i, s in enumerate(text):
        w = dt.datetime.fromisoformat(s)
        a, b = (w.replace(tzinfo=zone, fold=k) for k in (0, 1))
        want[i] = np.nan if a.utcoffset() != b.utcoffset() else \
            a.timestamp() * 1e3
    fr, wall = timed(lambda: parse_files([path]))
    nbytes = os.path.getsize(path)
    got = fr.vec("t").host_f64
    ok = np.array_equal(got, want, equal_nan=True)
    n_na = int(np.isnan(got).sum())
    emit(dict(phase="ingest_timezone", zone=TZ_NAME, tz_database=True,
              rows=TZ_ROWS, bytes=nbytes, parse_s=wall,
              parse_mb_per_s=nbytes / wall / 1e6, rows_per_s=TZ_ROWS / wall,
              equal_to_zoneinfo=bool(ok), na_rows=n_na,
              special_rows_na=np.isnan(got[: len(special)]).tolist()))
    set_timezone("UTC")
    if not ok or not np.isnan(got[: len(special)]).all():
        raise AssertionError(f"22g: zone {TZ_NAME} parse unlike zoneinfo "
                             f"({ok}), special rows {got[:len(special)]}")


def phase_slice15(X, y, cov: Frame, paths) -> None:
    """22: SVMLight, ARFF, Avro, XLSX/XLS, a remote path, a snapshot,
    streaming and the cluster timezone; K2 carries 22a's GBM."""
    t = [time.perf_counter()]
    with tempfile.TemporaryDirectory(prefix="h2o_ingest22_") as tmp:
        svm = phase_svmlight(cov, tmp, paths)
        t.append(time.perf_counter())
        arff_path, arff = phase_arff(X, y, tmp)
        t.append(time.perf_counter())
        phase_avro(X, y, tmp)
        t.append(time.perf_counter())
        phase_xls(X, y, tmp)
        t.append(time.perf_counter())
        phase_remote(arff_path, arff, svm, tmp)
        t.append(time.perf_counter())
        phase_stream(X, y, tmp)
        t.append(time.perf_counter())
        phase_timezone(tmp)
        t.append(time.perf_counter())
    names = ("svmlight", "arff", "avro", "xls", "remote_persist", "stream",
             "timezone")
    emit(dict(phase="phase22_walls", total_s=t[-1] - t[0],
              **{f"{n}_s": b - a for n, a, b in zip(names, t, t[1:])}))


# ---------------------------------------------------------------------------
# 23 the data plane: map_reduce, quantiles, sort, group-by, merge, filter,
# take; F8's repeat check
# ---------------------------------------------------------------------------

DP_LEVELS, DP_ZIPF = 100_000, 1.1
DP_CATS = 7
DP_PROBS = (0.001, 0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 0.999)
DP_NA = 0.01
DP_RIGHT_ROWS = 100_000
DP_TAKE_ROWS = 100_000
DP_CALLS = 3
DP_SUM_TOL = 1e-5     # 23a: of the summed magnitudes
DP_AGG_RTOL = 1e-6    # 23d: sum, mean, sd and var, card against CPU
DP_FLOAT_AGGS = ("sum", "mean", "sd", "var")


def dp_frame(fr: Frame, seed: int = 31) -> Frame:
    """The 1M x 28 frame with a 100,000-level Zipf (s = 1.1) integer key
    ``zkey`` and a 7-level categorical ``c7`` (1 % NA)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, DP_LEVELS + 1) ** DP_ZIPF
    key = rng.choice(DP_LEVELS, size=fr.nrows, p=p / p.sum())
    c7 = rng.integers(0, DP_CATS, size=fr.nrows).astype(np.int32)
    c7[rng.uniform(size=fr.nrows) < DP_NA] = -1
    return Frame(fr.names + ["zkey", "c7"], fr.vecs + [
        Vec(key.astype(np.float32)),
        Vec(c7, T_CAT, domain=[f"k{j}" for j in range(DP_CATS)])])


def on_card(fn):
    """(result, wall s, bytes to the device, bytes to the host) of one
    call ``fn(DEV)``, the wall ending in a synchronize."""
    TransferStats.reset()
    sync()
    t0 = time.perf_counter()
    out = fn(DEV)
    sync()
    wall = time.perf_counter() - t0
    moved = TransferStats.snapshot()
    return out, wall, moved["to_device"], moved["to_host"]


def on_cpu(fn):
    """(result, host wall s) of ``fn("cpu")``."""
    t0 = time.perf_counter()
    out = fn("cpu")
    return out, time.perf_counter() - t0


def frame_diff(a: Frame, b: Frame) -> list:
    """Columns of two frames that differ in name, type, domain or bits."""
    if a.names != b.names or a.nrows != b.nrows:
        return ["<names or rows>"]
    return [n for n in a.names if a.vec(n).type != b.vec(n).type] + \
        frame_bits_equal(a, b)


def dp_hold(name: str, smi: str, rec: dict, ok: bool) -> None:
    emit(dict(phase=name, gpu=smi, **rec))
    if not ok:
        raise AssertionError(f"{name}: a hold failed: {rec}")


def dp_map_reduce(X, smi: str) -> None:
    """23a: per-column sums, the 28 x 28 Gram block, min and max in one
    map_reduce; mutate_array and Vec.map_inplace on one column."""
    def stats(m):
        return dict(sum=m.sum(dim=0), gram=m.T @ m, min=m.amin(dim=0),
                    max=m.amax(dim=0))

    def run(dev):
        out = mrtask.map_reduce(stats, X, device=dev)
        return {k: v.cpu().numpy() for k, v in out.items()}

    card = [on_card(run) for _ in range(DP_CALLS)]
    cpu, cpu_wall = on_cpu(run)
    c = card[0][0]
    repeat = all(bits_equal(r[0][k], c[k]) for r in card[1:] for k in c)
    scale_sum = np.abs(X).sum(axis=0, dtype=np.float64)
    g = np.diag(cpu["gram"]).astype(np.float64)
    scale_gram = np.sqrt(np.outer(g, g))
    # relative to the summed magnitudes: an entry that cancels toward 0
    # keeps no relative precision in any summation order
    sum_err = float(np.max(np.abs(c["sum"] - cpu["sum"]) / scale_sum))
    gram_err = float(np.max(np.abs(c["gram"] - cpu["gram"]) / scale_gram))
    plain = {k: float(np.max(np.abs(c[k] - cpu[k]) / np.abs(cpu[k])))
             for k in ("sum", "gram")}
    exact = X.sum(axis=0, dtype=np.float64)
    ref_err = float(np.max(np.abs(cpu["sum"] - exact) / scale_sum))
    minmax = bits_equal(c["min"], cpu["min"]) and \
        bits_equal(c["max"], cpu["max"]) and \
        bits_equal(cpu["min"], X.min(axis=0)) and \
        bits_equal(cpu["max"], X.max(axis=0))

    def affine(t):
        return t.mul_(2.0).add_(1.0)

    col = X[:, 0]
    mut_card = mrtask.mutate_array(affine, col.copy(), device=DEV).cpu()
    mut_cpu = mrtask.mutate_array(affine, col.copy(), device="cpu")
    v_card, v_cpu = Vec(col.copy()), Vec(col.copy())
    v_card.map_inplace(affine, device=DEV)
    v_cpu.map_inplace(affine, device="cpu")
    mut_ok = bits_equal(mut_card, mut_cpu) and \
        bits_equal(v_card.data, mut_cpu) and bits_equal(v_cpu.data, mut_cpu)
    down = sum(v.nbytes for v in c.values())
    dp_hold("23a_map_reduce", smi, dict(
        rows=X.shape[0], cols=X.shape[1], calls=DP_CALLS,
        card_wall_s=[r[1] for r in card], cpu_wall_s=cpu_wall,
        to_device_bytes=card[0][2], to_host_bytes=down,
        min_max_bitwise=minmax, sums_rel_to_abs_sum=sum_err,
        gram_rel_to_diag=gram_err, sums_max_rel=plain["sum"],
        gram_max_rel=plain["gram"], cpu_sum_vs_float64=ref_err,
        sums_bitwise=bits_equal(c["sum"], cpu["sum"]),
        gram_bitwise=bits_equal(c["gram"], cpu["gram"]),
        card_repeats_bitwise=repeat, mutate_and_map_inplace_bitwise=mut_ok),
        minmax and repeat and mut_ok and sum_err <= DP_SUM_TOL and
        gram_err <= DP_SUM_TOL and ref_err <= DP_SUM_TOL)


def dp_quantiles(X, smi: str) -> None:
    """23b: the nine quantiles of all 28 columns with 1 % NaN cells."""
    rng = np.random.default_rng(37)
    Xq = X.copy()
    Xq[rng.uniform(size=X.shape) < DP_NA] = np.nan
    fq = Frame.from_numpy(Xq, names=[f"x{j}" for j in range(X.shape[1])])

    def run(dev):
        return dp_quantile.quantile(fq, DP_PROBS, device=dev)

    card, wall, up, down = on_card(run)
    cpu, cpu_wall = on_cpu(run)
    bad = [k for k in card if not bits_equal(card[k], cpu[k])]
    # the refined bracket holds the order statistic of index
    # floor(p (n - 1)) (the rank taken in float32 as the verb takes it)
    got = np.stack([card[f"x{j}"] for j in range(X.shape[1])], axis=1)
    off = 0.0
    for j in range(X.shape[1]):
        xs = np.sort(Xq[:, j][~np.isnan(Xq[:, j])])
        k = np.floor(np.float32(np.asarray(DP_PROBS) * (xs.size - 1)))
        want = xs[k.astype(np.int64)]
        off = max(off, float(np.max(np.abs(got[:, j] - want)) /
                             (xs[-1] - xs[0])))
    monotone = bool(np.all(np.diff(got, axis=0) >= 0))
    dp_hold("23b_quantiles", smi, dict(
        rows=X.shape[0], cols=X.shape[1], probs=list(DP_PROBS),
        na_cells=int(np.isnan(Xq).sum()), card_wall_s=wall,
        cpu_wall_s=cpu_wall, to_device_bytes=up, to_host_bytes=down,
        columns_not_bitwise=bad, max_off_order_statistic_rel_span=off,
        nondecreasing=monotone),
        not bad and monotone and off <= 1e-5)


def sort_reference(fr: Frame, idxs, asc) -> np.ndarray:
    """numpy's stable order of the verbs' sort keys (NA first)."""
    keys = []
    for j, a in zip(idxs, asc):
        v = fr.vecs[j]
        d = v.data.astype(np.float64)
        na = np.isnan(d) | (v.is_categorical & (d < 0))
        keys.append(np.where(na, -np.inf, d if a else -d))
    return np.lexsort(keys[::-1])


def dp_sort(f23: Frame, cov: Frame, smi: str) -> None:
    """23c: the 1M frame by (c7 ascending, x0 descending), the covertype
    frame by (wild, soil, elev0)."""
    for name, fr, idxs, asc in (
            ("dp_c7_asc_x0_desc", f23, [f23.names.index("c7"), 0],
             [True, False]),
            ("covertype_wild_soil_elev0", cov,
             [cov.names.index(n) for n in ("wild", "soil", "elev0")],
             [True, True, True])):
        def run(dev):
            return dp_munge.sort_frame(fr, idxs, asc, device=dev)

        card, wall, up, down = on_card(run)
        cpu, cpu_wall = on_cpu(run)
        bad = frame_diff(card, cpu)
        order = sort_reference(fr, idxs, asc)
        ref_ok = all(bits_equal(card.vecs[j].data, fr.vecs[j].data[order])
                     for j in range(fr.ncols))
        dp_hold("23c_sort", smi, dict(
            case=name, rows=fr.nrows, cols=fr.ncols, card_wall_s=wall,
            cpu_wall_s=cpu_wall, to_device_bytes=up, to_host_bytes=down,
            columns_not_bitwise=bad, numpy_lexsort_order=ref_ok),
            not bad and ref_ok)


def dp_groupby(f23: Frame, cov: Frame, smi: str) -> None:
    """23d: every DEVICE_AGGS aggregate, mode on a categorical, on the
    covertype frame by (wild, soil) and the 1M frame by the Zipf key."""
    for name, fr, gnames, col, mode_col in (
            ("covertype_by_wild_soil", cov, ("wild", "soil"), "elev0", "y"),
            ("dp_by_zipf_key", f23, ("zkey",), "x0", "c7")):
        gcols = [fr.names.index(n) for n in gnames]
        ci = fr.names.index(col)
        aggs = [(a, ci, "all") for a in dp_munge.DEVICE_AGGS if a != "mode"]
        aggs.append(("mode", fr.names.index(mode_col), "all"))

        def run(dev):
            return dp_munge.groupby_frame(fr, gcols, aggs, device=dev)

        card = [on_card(run) for _ in range(DP_CALLS)]
        cpu, cpu_wall = on_cpu(run)
        c = card[0][0]
        repeat = all(not frame_diff(r[0], c) for r in card[1:])
        bad_exact = [n for n in frame_diff(c, cpu)
                     if n.split("_")[0] not in DP_FLOAT_AGGS]
        floats, close = {}, True
        for op in DP_FLOAT_AGGS:
            n = f"{op}_{col}"
            a = c.vec(n).data.astype(np.float64)
            b = cpu.vec(n).data.astype(np.float64)
            ok = np.isclose(a, b, rtol=DP_AGG_RTOL, atol=0.0,
                            equal_nan=True)
            floats[n] = dict(bitwise=bits_equal(c.vec(n).data,
                                                cpu.vec(n).data),
                             max_abs_diff=float(np.nanmax(np.abs(a - b)))
                             if a.size else 0.0)
            close = close and bool(ok.all())
        counts_ok = float(c.vec(f"nrow_{col}").data.sum()) == fr.nrows
        dp_hold("23d_groupby", smi, dict(
            case=name, rows=fr.nrows, groups=c.nrows,
            aggs=[a for a, _c, _n in aggs],
            card_wall_s=[r[1] for r in card], cpu_wall_s=cpu_wall,
            to_device_bytes=card[0][2], to_host_bytes=card[0][3],
            exact_columns_not_bitwise=bad_exact, float_aggs=floats,
            card_repeats_bitwise=repeat, counts_sum_to_rows=counts_ok),
            not bad_exact and repeat and counts_ok and close)


def dp_right_frame(f23: Frame, seed: int = 41) -> Frame:
    """100,000 rows keyed on zkey: ~10 % of the keys absent from the left
    frame, ~10 % of the rows repeating another row's key; a row id, a
    value, a column named like a left one (x0) and a categorical."""
    rng = np.random.default_rng(seed)
    present = np.unique(f23.vec("zkey").data)
    absent = np.setdiff1d(np.arange(2 * DP_LEVELS, dtype=np.float32),
                          present)
    n_dup = DP_RIGHT_ROWS // 10
    n_abs = (DP_RIGHT_ROWS - n_dup) // 10
    n_pres = min(DP_RIGHT_ROWS - n_dup - n_abs, present.size)
    uniq = np.concatenate([rng.choice(present, n_pres, replace=False),
                           rng.choice(absent, DP_RIGHT_ROWS - n_dup - n_pres,
                                      replace=False)])
    keys = np.concatenate([uniq, rng.choice(uniq, n_dup)])
    keys = keys[rng.permutation(keys.size)].astype(np.float32)
    n = keys.size
    return Frame(["zkey", "rid", "rv", "x0", "rc"], [
        Vec(keys), Vec(np.arange(n, dtype=np.float32)),
        Vec(rng.normal(size=n).astype(np.float32)),
        Vec(rng.normal(size=n).astype(np.float32)),
        Vec(rng.integers(-1, 3, size=n).astype(np.int32), T_CAT,
            domain=["r0", "r1", "r2"])])


def join_counts(lk: np.ndarray, rk: np.ndarray) -> dict:
    """Rows of each join of two numeric key columns (numpy)."""
    ul, cl = np.unique(lk, return_counts=True)
    ur, cr = np.unique(rk, return_counts=True)
    both, il, ir = np.intersect1d(ul, ur, return_indices=True)
    inner = int((cl[il] * cr[ir]).sum())
    ul_only = int(cl.sum() - cl[il].sum())
    ur_only = int(cr.sum() - cr[ir].sum())
    return dict(inner=inner, left=inner + ul_only, right=inner + ur_only,
                outer=inner + ul_only + ur_only)


def dp_merge(f23: Frame, smi: str) -> None:
    """23e: the 1M frame against a 100,000-row right frame on the Zipf
    key (inner, left, right, outer); a categorical-key join whose
    domains differ, matched by label."""
    left = f23.subframe(["zkey", "x0", "x1", "c7", "y"])
    left.add("lid", Vec(np.arange(left.nrows, dtype=np.float32)))
    right = dp_right_frame(f23)
    want = join_counts(left.vec("zkey").data, right.vec("zkey").data)
    for join, (ax, ay) in (("inner", (False, False)), ("left", (True, False)),
                           ("right", (False, True)),
                           ("outer", (True, True))):
        def run(dev):
            return dp_munge.merge_frames(left, right, ax, ay, [0], [0],
                                         device=dev)

        card, wall, up, down = on_card(run)
        cpu, cpu_wall = on_cpu(run)
        bad = frame_diff(card, cpu)
        # left rows in order, then the right-only rows (no left row)
        lid = card.vec("lid").data
        n_left = int(np.sum(~np.isnan(lid)))
        ordered = bool(np.all(np.diff(lid[:n_left]) >= 0) and
                       np.isnan(lid[n_left:]).all())
        dp_hold("23e_merge", smi, dict(
            join=join, left_rows=left.nrows, right_rows=right.nrows,
            rows_out=card.nrows, numpy_rows=want[join], card_wall_s=wall,
            cpu_wall_s=cpu_wall, to_device_bytes=up, to_host_bytes=down,
            columns_not_bitwise=bad, names=card.names,
            pairs_in_left_order=ordered),
            not bad and card.nrows == want[join] and ordered and
            "x0_y" in card.names)
    # categorical keys: the right domain in another order, with a level
    # the left lacks
    rdom = ["k6", "k5", "kx", "k0", "k3"]
    rcat = Frame(["c7", "cv"], [
        Vec(np.arange(len(rdom), dtype=np.int32), T_CAT, domain=rdom),
        Vec(np.arange(len(rdom), dtype=np.float32) * 10)])
    lcat = f23.subframe(["c7"])
    lcat.add("lid", Vec(np.arange(lcat.nrows, dtype=np.float32)))

    def run_cat(dev):
        return dp_munge.merge_frames(lcat, rcat, True, True, [0], [0],
                                     device=dev)

    card, wall, up, down = on_card(run_cat)
    cpu, cpu_wall = on_cpu(run_cat)
    bad = frame_diff(card, cpu)
    dom = card.vec("c7").domain
    labels = np.asarray(dom + ["<NA>"], dtype=object)[card.vec("c7").data]
    cv = card.vec("cv").data
    hit = ~np.isnan(cv)
    by_label = bool(np.all(labels[hit] == np.asarray(rdom, dtype=object)[
        (cv[hit] / 10).astype(int)]))
    dp_hold("23e_merge_categorical", smi, dict(
        rows_out=card.nrows, union_domain=dom, card_wall_s=wall,
        cpu_wall_s=cpu_wall, to_device_bytes=up, to_host_bytes=down,
        columns_not_bitwise=bad, matched_by_label=by_label),
        not bad and by_label and dom == [f"k{j}" for j in range(DP_CATS)] +
        ["kx"])


def dp_filter_take(f23: Frame, smi: str) -> None:
    """23f: a mask of about 50 % (x1 > 0), then 100,000 row indices."""
    mask = f23.vec("x1").data > 0
    idx = np.random.default_rng(43).integers(0, f23.nrows, DP_TAKE_ROWS)
    for name, fn, sel in (
            ("filter", lambda dev: dp_munge.filter_rows(f23, mask,
                                                        device=dev), mask),
            ("take", lambda dev: dp_munge.take_rows(f23, idx, device=dev),
             idx)):
        card, wall, up, down = on_card(fn)
        cpu, cpu_wall = on_cpu(fn)
        bad = frame_diff(card, cpu)
        ref_ok = all(bits_equal(card.vecs[j].data, f23.vecs[j].data[sel])
                     for j in range(f23.ncols))
        dp_hold("23f_" + name, smi, dict(
            rows=f23.nrows, rows_out=card.nrows, card_wall_s=wall,
            cpu_wall_s=cpu_wall, to_device_bytes=up, to_host_bytes=down,
            columns_not_bitwise=bad, numpy_selection=ref_ok),
            not bad and ref_ok)


def phase_slice16(X, fr: Frame, cov: Frame, smi: str, paths) -> None:
    """23: the data plane on the card, each sub-phase held against the
    same port code on the CPU; then F8's repeat check (23g)."""
    t = [time.perf_counter()]
    f23 = dp_frame(fr)
    covc = make_covertype(seed=0, categorical=True)
    t.append(time.perf_counter())
    hk.reset_launches()
    dp_map_reduce(X, smi)
    t.append(time.perf_counter())
    dp_quantiles(X, smi)
    t.append(time.perf_counter())
    dp_sort(f23, covc, smi)
    t.append(time.perf_counter())
    dp_groupby(f23, covc, smi)
    t.append(time.perf_counter())
    dp_merge(f23, smi)
    t.append(time.perf_counter())
    dp_filter_take(f23, smi)
    t.append(time.perf_counter())
    got = hist_launches()
    no_hist("data plane", got)
    paths["data_plane"] = got
    # 23g: F8's repeat check, the GBMs on K2
    hk.reset_launches()
    records = repeat_check(fr, cov, runs=DP_CALLS, device=DEV)
    got = hist_launches()
    t.append(time.perf_counter())
    trees = records[0]["trees"]
    iters = records[1]["trees"]
    want = (0, 5 * sum(trees) + 5 * len(COV_COUNTS) * sum(iters))
    paths["repeat_check"] = got
    for r in records:
        emit(dict(phase="23g_repeat", gpu=smi, **r))
    ok = all_equal(records) and got == want
    emit(dict(phase="23g_repeat_summary", gpu=smi, all_equal=ok,
              k1_launches=got[0], k2_launches=got[1], want_launches=want))
    if not ok:
        raise AssertionError(f"23g: a repeat differed or the launches "
                             f"{got} are not {want}")
    names = ("frames", "map_reduce", "quantiles", "sort", "groupby",
             "merge", "filter_take", "repeat_check")
    emit(dict(phase="phase23_walls", gpu=smi, total_s=t[-1] - t[0],
              **{f"{n}_s": b - a for n, a, b in zip(names, t, t[1:])}))


# -- 24: jobs, models and frames in the DKV, user functions ------------------

#: phase 24: the custom GBM's validation rows, the deadline of 24e's job
#: and the rows of 24d's key-for-object builds
JOB_VALID_ROWS = 250_000
JOB_DEADLINE_S = 1.0
#: 24e: its registry's watchdog interval, the trees of its GBM that
#: outlives the deadline (it stops at its next tree) and how long the
#: histogram counts may take to settle once that GBM is expired
JOB_WATCHDOG_S = 0.1
JOB_LATE_TREES = 2000
JOB_SETTLE_S = 3.0
KEYS_ROWS = SUB_ROWS
#: a user's distribution and metric, the stock client's upload flow
#: (tests/test_custom_metric.py's CUSTOM_ASYMMETRIC and CUSTOM_MAE)
CUSTOM_ASYMMETRIC = """class AsymmetricLossDist:
    def link(self):
        return "identity"

    def init(self, w, o, y):
        return [w * y, w]

    def gradient(self, y, f):
        return (y - f) * ((y > f) * 3.0 + (y <= f) * 1.0)
"""
CUSTOM_MAE = """class CustomMaeFunc:
    def map(self, pred, act, w, o, model):
        return [w * abs(act[0] - pred[0]), w]

    def reduce(self, l, r):
        return [l[0] + r[0], l[1] + r[1]]

    def metric(self, l):
        return l[0] / l[1]
"""
_FOREST_KEYS = ("split_col", "thr_bin", "na_left", "bitset", "child",
                "value")


def forest_bitwise(a: dict, b: dict) -> bool:
    """Every node array and value of two forests bitwise equal."""
    for k in _FOREST_KEYS:
        x, y = a.get(k), b.get(k)
        if (x is None) != (y is None):
            return False
        if x is not None and not (np.asarray(x).shape == np.asarray(y).shape
                                  and np.array_equal(np.asarray(x).view(
                                      np.uint8), np.asarray(y).view(
                                          np.uint8))):
            return False
    return True


def upload(tmp: str, key: str, source: str, module: str, cls: str) -> str:
    """A zip of ``source`` as ``<module>.py`` under the upload ``key`` in
    the DKV; the ``python:<key>=<module>.<cls>`` reference."""
    from h2o_tpu_torch.core.store import dkv
    path = os.path.join(tmp, f"{key}.zip")
    with zipfile.ZipFile(path, "w") as z:
        z.writestr(f"{module}.py", source)
    dkv().put(key, path)
    return f"python:{key}={module}.{cls}"


def jobs_24a(fr: Frame, m_def, paths) -> None:
    """24a: the default GBM as a job on cuda:0."""
    from h2o_tpu_torch.core.job import DONE
    from h2o_tpu_torch.core.store import dkv
    hk.reset_launches()
    sync()
    t0 = time.perf_counter()
    job = GBM(ntrees=20, max_depth=5, seed=1).train_async(
        y="y", training_frame=fr)
    m = job.join()
    sync()
    wall = time.perf_counter() - t0
    got = hist_launches()
    paths["job_gbm"] = got
    holds = dict(status=job.status == DONE, progress=job.progress == 1.0,
                 published=dkv().get(m.model_id) is m,
                 dest=str(job.dest) == m.model_id,
                 forest_equals_phase4=forest_bitwise(m.output, m_def.output),
                 launches=got == (0, 100))
    emit(dict(phase="job_gbm", rows=fr.nrows, wall_s=wall,
              k1_launches=got[0], k2_launches=got[1], holds=holds))
    if not all(holds.values()):
        raise AssertionError(f"24a: {holds}")


def jobs_24b(fr: Frame, m_def, m_drf, paths) -> None:
    """24b: a GBM and a 10-tree DRF as two jobs at once on the pool."""
    hk.reset_launches()
    sync()
    t0 = time.perf_counter()
    jg = GBM(ntrees=20, max_depth=5, seed=1).train_async(
        y="y", training_frame=fr)
    jd = DRF(ntrees=DRF_TREES, seed=1).train_async(y="y", training_frame=fr)
    g, d = jg.join(), jd.join()
    sync()
    wall = time.perf_counter() - t0
    got = hist_launches()
    paths["job_gbm_drf_together"] = got
    alone = (paths["gbm_default"][1] + paths["drf"][1])
    holds = dict(gbm_equals_alone=forest_bitwise(g.output, m_def.output),
                 drf_equals_alone=forest_bitwise(d.output, m_drf.output),
                 k2_sum=got == (0, alone))
    emit(dict(phase="jobs_together", rows=fr.nrows, drf_trees=DRF_TREES,
              wall_s=wall, k1_launches=got[0], k2_launches=got[1],
              k2_alone_sum=alone, holds=holds))
    if not all(holds.values()):
        raise AssertionError(f"24b: {holds}")


def jobs_24c(X, y, tmp: str, paths) -> None:
    """24c: a user's distribution and metric from upload keys: the custom
    GBM on the card at full width, its metric against numpy, and the
    first tree against the CPU's on the first 100,000 rows."""
    dist = upload(tmp, "upload_asym", CUSTOM_ASYMMETRIC, "asym",
                  "AsymmetricLossDist")
    mae = upload(tmp, "upload_mae", CUSTOM_MAE, "mae", "CustomMaeFunc")
    fr = frame(X, y.astype(np.float32))
    Xv, yv = make_data(JOB_VALID_ROWS, C, seed=2)
    fv = frame(Xv, yv.astype(np.float32))
    kw = dict(distribution="custom", custom_distribution_func=dist,
              custom_metric_func=mae)
    m, wall, got = launched(train, fr=fr, valid=fv, **kw)
    paths["gbm_custom"] = got
    metrics = {}
    for mk, f in (("training_metrics", fr), ("validation_metrics", fv)):
        p = m.predict_raw(f).cpu().numpy().astype(np.float64)
        a = f.vec("y").as_float().astype(np.float64)
        want = float(np.sum(np.abs(a - p)) / len(a))
        have = m.output[mk]["custom_metric_value"]
        metrics[mk] = dict(custom=have, numpy=want,
                           rel=abs(have - want) / abs(want))
    sub = fr.slice_rows(slice(0, SUB_ROWS))
    cmp_ = first_tree_check("gbm_custom", GBM, sub, ntrees=3, max_depth=5,
                            seed=1, **kw)
    holds = dict(launches=got == (0, 100),
                 custom_link=m.output["custom_link"] == "identity",
                 metric_name=m.output["training_metrics"][
                     "custom_metric_name"] == "upload_mae",
                 metrics_1e9=all(v["rel"] <= 1e-9 for v in metrics.values()),
                 first_tree=all(cmp_["equal"].values()))
    emit(dict(phase="gbm_custom", rows=R, valid_rows=JOB_VALID_ROWS,
              wall_s=wall, k1_launches=got[0], k2_launches=got[1],
              f0=float(m.output["f0"][0]), metrics=metrics, holds=holds))
    if not all(holds.values()):
        raise AssertionError(f"24c: {holds}")


def jobs_24d(fr: Frame, tmp: str, paths) -> None:
    """24d: keys in place of objects on KEYS_ROWS rows: each build from
    keys bitwise the same build from objects or a path; every published
    frame present with its shape."""
    from h2o_tpu_torch.core.store import dkv
    store = dkv()
    sub = fr.slice_rows(slice(0, KEYS_ROWS))
    alloc0 = torch.cuda.memory_allocated(DEV)
    hk.reset_launches()
    sync()
    t0 = time.perf_counter()
    common = dict(nfolds=5, seed=1, keep_cross_validation_predictions=True)
    gbm = GBM(ntrees=20, max_depth=5, model_id="keys_gbm", **common).train(
        y="y", training_frame=sub)
    glm = GLM(family="binomial", model_id="keys_glm", **common).train(
        y="y", training_frame=sub)
    holds, shapes = {}, {}
    for b in (gbm, glm):
        ids = b.output["cross_validation_models"]
        hf = store.get(b.output[
            "cross_validation_holdout_predictions_frame_id"])
        holds[f"{b.algo}_cv_keys"] = ids == [
            f"{b.model_id}_cv_{i}" for i in range(1, 6)] and \
            all(store.get(k).model_id == k for k in ids)
        shapes[str(hf.key)] = [hf.nrows, hf.ncols]
        holds[f"{b.algo}_holdout_shape"] = (hf.nrows, hf.ncols) == (
            KEYS_ROWS, 3)
    se_keys = StackedEnsemble(base_models=["keys_gbm", "keys_glm"],
                              seed=1).train(y="y", training_frame=sub)
    se_objs = StackedEnsemble(base_models=[gbm, glm], seed=1).train(
        y="y", training_frame=sub)
    holds["ensemble_keys_equals_objects"] = bool(torch.equal(
        se_keys.predict_raw(sub), se_objs.predict_raw(sub))) and \
        store.get(se_keys.output["metalearner_key"]) is \
        se_keys.output["metalearner"]
    path = os.path.join(tmp, "keys_gbm.zip")
    with open(path, "wb") as f:
        f.write(export_genmodel_mojo(gbm))
    store.put("upload_keys_mojo", path)
    g_key = Generic(model_key="upload_keys_mojo").train()
    g_path = Generic(path=path).train()
    holds["generic_key_equals_path"] = bool(torch.equal(
        g_key.predict_raw(sub), g_path.predict_raw(sub)))
    names = ["x0", "x1", "Intercept"]
    bc = Frame(["names", "lower_bounds", "upper_bounds"],
               [Vec(np.arange(3, dtype=np.int32), T_CAT, domain=names),
                Vec(np.asarray([-0.1, 0.0, -1.0], np.float32)),
                Vec(np.asarray([0.3, 5.0, 0.05], np.float32))],
               key="keys_bounds")
    store.put(bc.key, bc)
    b_key = GLM(beta_constraints="keys_bounds").train(y="y",
                                                      training_frame=sub)
    b_obj = GLM(beta_constraints=bc).train(y="y", training_frame=sub)
    holds["beta_constraints_key_equals_frame"] = bool(np.array_equal(
        b_key.output["beta"], b_obj.output["beta"]))
    gam_kept = GAM(model_id="keys_gam", keep_gam_cols=True,
                   **GAM_KW).train(y="y", training_frame=sub)
    gam_plain = GAM(**GAM_KW).train(y="y", training_frame=sub)
    gf = store.get(gam_kept.output["gam_transformed_center_key"])
    shapes[str(gf.key)] = [gf.nrows, gf.ncols]
    holds["gam_kept_equals_plain"] = bool(np.array_equal(
        gam_kept.output["glm_output"]["beta"],
        gam_plain.output["glm_output"]["beta"]))
    holds["gam_frame"] = gf.nrows == KEYS_ROWS and gf.names == \
        gam_kept.expand(sub).names
    dl_kw = dict(hidden=[64, 64], epochs=1.0, seed=1)
    dl_wb = DeepLearning(model_id="keys_dl", export_weights_and_biases=True,
                         **dl_kw).train(y="y", training_frame=sub)
    dl_plain = DeepLearning(**dl_kw).train(y="y", training_frame=sub)
    wb_ok = True
    for i, (lw, lp) in enumerate(zip(dl_wb.output["weights"],
                                     dl_plain.output["weights"])):
        wf = store.get(f"keys_dl_weights_{i + 1}")
        bf = store.get(f"keys_dl_biases_{i + 1}")
        shapes[str(wf.key)] = [wf.nrows, wf.ncols]
        shapes[str(bf.key)] = [bf.nrows, bf.ncols]
        wb_ok &= bool(np.array_equal(lw["W"], lp["W"]) and
                      np.array_equal(lw["b"], lp["b"]) and
                      (wf.nrows, wf.ncols) == lw["W"].shape and
                      bf.nrows == lw["b"].shape[0] and np.array_equal(
                          np.stack([v.data for v in wf.vecs], 1), lw["W"]))
    holds["dl_export_equals_plain"] = wb_ok
    sync()
    wall = time.perf_counter() - t0
    got = hist_launches()
    paths["keys_for_objects"] = got
    holds["launches"] = got == (0, 6 * 20 * 5)
    alloc1 = torch.cuda.memory_allocated(DEV)
    emit(dict(phase="keys_for_objects", rows=KEYS_ROWS, wall_s=wall,
              k1_launches=got[0], k2_launches=got[1], shapes=shapes,
              memory_allocated_before=alloc0, memory_allocated_after=alloc1,
              holds=holds))
    if not all(holds.values()):
        raise AssertionError(f"24d: {holds}")


def cancelling(cls):
    """``cls`` whose build cancels its own job at its first progress
    report (24e)."""
    class Cancelling(cls):
        def _update(self, progress: float, msg: str = "") -> None:
            if self._job is not None:
                self._job.cancel()
            super()._update(progress, msg)
    return Cancelling


def settled_launches(window_s: float):
    """The histogram launch counts once two reads 0.1 s apart agree
    (a build still running keeps adding to them), or None after
    ``window_s``."""
    last = hist_launches()
    end = time.perf_counter() + window_s
    while time.perf_counter() < end:
        time.sleep(0.1)
        now = hist_launches()
        if now == last:
            return now
        last = now
    return None


def jobs_24e(fr: Frame) -> None:
    """24e, on a registry of one worker made the process's for the part:
    a DeepLearning and a GBM build cancelled from their first progress
    report; a GBM past its deadline; the slot free after each, nothing
    published, the late GBM stopped at its next tree."""
    from h2o_tpu_torch.core import job as job_mod
    from h2o_tpu_torch.core.job import (CANCELLED, FAILED, Job,
                                        JobCancelledException, JobRegistry)
    from h2o_tpu_torch.core.store import dkv
    reg = JobRegistry(max_workers=1, watchdog_interval=JOB_WATCHDOG_S)
    sub = fr.slice_rows(slice(0, SUB_ROWS))
    process_reg, job_mod._instance = job_mod._instance, reg
    try:
        rows, holds = {}, {}
        for name, cls, kw in (
                ("dl", DeepLearning, dict(hidden=[64], epochs=1.0, seed=1)),
                ("gbm", GBM, dict(ntrees=20, max_depth=5, seed=1))):
            hk.reset_launches()
            t0 = time.perf_counter()
            job = cancelling(cls)(model_id=f"cancelled_{name}",
                                  **kw).train_async(y="y", training_frame=sub)
            try:
                job.join()
                cancelled = False
            except JobCancelledException:
                cancelled = True
            rows[f"{name}_cancel_wall_s"] = time.perf_counter() - t0
            rows[f"{name}_cancel_k2_launches"] = hist_launches()[1]
            holds[f"{name}_cancelled"] = cancelled and \
                job.status == CANCELLED
            holds[f"{name}_unpublished"] = \
                dkv().get(f"cancelled_{name}") is None
            holds[f"{name}_slot_free"] = reg.run_sync(
                Job(description=f"after the {name} cancel"),
                lambda j: "ran") == "ran"

        reg.default_deadline_secs = JOB_DEADLINE_S
        hk.reset_launches()
        t1 = time.perf_counter()
        late = GBM(ntrees=JOB_LATE_TREES, max_depth=5, seed=1,
                   model_id="late_gbm").train_async(y="y",
                                                    training_frame=sub)
        # the watchdog scans once an interval: the job is FAILED at most
        # one interval past its deadline (and the thread's wake-up)
        try:
            late.join(JOB_DEADLINE_S + JOB_WATCHDOG_S + 0.25)
            timed_out = False
        except TimeoutError as e:
            timed_out = "deadline" in str(e)
        rows["expiry_wall_s"] = time.perf_counter() - t1
        holds["deadline"] = timed_out and late.status == FAILED and \
            isinstance(late.exception, TimeoutError)
        holds["slot_after_deadline"] = reg.run_sync(
            Job(description="after the deadline"), lambda j: "ran") == "ran"
        # the body stops at its first tree past the deadline
        got = settled_launches(JOB_SETTLE_S)
        rows["late_k2_launches"] = got and got[1]
        holds["late_body_stopped"] = got is not None and \
            got[1] < 5 * JOB_LATE_TREES
        holds["late_unpublished"] = dkv().get("late_gbm") is None
    finally:
        job_mod._instance = process_reg
    emit(dict(phase="job_cancel_deadline", rows=SUB_ROWS,
              deadline_s=JOB_DEADLINE_S, watchdog_interval_s=JOB_WATCHDOG_S,
              late_trees=JOB_LATE_TREES, **rows, holds=holds))
    if not all(holds.values()):
        raise AssertionError(f"24e: {holds}")


def phase_slice18(X, y, fr: Frame, m_def, m_drf, paths) -> None:
    """24: jobs, models and frames published in the DKV, a user's
    distribution and metric; every key published here removed at the
    end, the store back to its keys before the phase."""
    from h2o_tpu_torch.core.store import dkv
    before = set(dkv().keys())
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        jobs_24a(fr, m_def, paths)
        jobs_24b(fr, m_def, m_drf, paths)
        jobs_24c(X, y, tmp, paths)
        jobs_24d(fr, tmp, paths)
        jobs_24e(fr)
        published = sorted(set(dkv().keys()) - before)
        for k in published:
            dkv().remove(k, force=True)
    restored = set(dkv().keys()) == before
    import gc
    gc.collect()
    emit(dict(phase="slice18", wall_s=time.perf_counter() - t0,
              keys_published=len(published), store_restored=restored,
              memory_allocated_after_removal=torch.cuda.memory_allocated(
                  DEV)))
    if not restored:
        raise AssertionError("24: the DKV is not back to its keys")


def unpublish(before: set) -> None:
    """Remove every DKV key published since ``before`` (each phase's
    models and frames; the phase's own variables keep what it returns)."""
    from h2o_tpu_torch.core.store import dkv
    for k in set(dkv().keys()) - before:
        dkv().remove(k, force=True)


def main() -> None:
    t_start = time.perf_counter()
    # -- 0 device ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit(dict(phase="device", name=kind, nvidia_smi=smi,
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda))

    # -- 1 build -------------------------------------------------------------
    lib = hk.build()
    spills = [ln.strip() for ln in lib.log.splitlines()
              if "spill" in ln and not ln.strip().startswith(
                  "0 bytes stack frame, 0 bytes spill stores")]
    emit(dict(phase="build", seconds=lib.seconds, library=lib.path.name,
              spill_lines=spills))

    # -- 2 / 3 kernels at main-path shapes -----------------------------------
    rng = np.random.default_rng(0)
    k1 = kernel_phase("K1", [(L, 64) for L in (1, 2, 4, 8, 16)],
                      k1_inputs(rng), run_k1, fine=False)
    k2 = kernel_phase("K2", [(1, 1024), (2, 512), (4, 256), (8, 128),
                             (16, 64)], k2_inputs(rng), run_k2, fine=True)
    emit(dict(phase="kernel_sums", hist_cuda=dict(f32_ms=k1["ms"],
                                                  int16_ms=k1["int16_ms"]),
              hist_cuda_adaptive=dict(f32_ms=k2["ms"],
                                      int16_ms=k2["int16_ms"])))
    torch.cuda.empty_cache()

    # -- 3f kernels at the sparse-frontier shape of a default DRF -----------
    rng_f = np.random.default_rng(3)
    k1f = kernel_phase("K1_frontier", [(4096, 20)], k1_inputs(rng_f), run_k1,
                       fine=False, modes=("f32", "int16"))
    k2f = kernel_phase("K2_frontier", [(4096, 20)], k2_inputs(rng_f), run_k2,
                       fine=True, modes=("f32", "int16"))
    torch.cuda.empty_cache()

    # -- 3x K2 at the XGBoost shapes -----------------------------------------
    k2x = kernel_phase("K2_xgb", XGB_SHAPES, k2_inputs(
        np.random.default_rng(4)), run_k2, fine=True, modes=("f32", "int16"))
    torch.cuda.empty_cache()

    # -- 3c K2 at the covertype shapes ---------------------------------------
    rng_c = np.random.default_rng(5)
    k2c = kernel_phase("K2_covertype", [COV_GBM_SHAPE], cov_k2_inputs(rng_c),
                       run_k2, fine=True, modes=("f32", "int16"))
    k2cf = kernel_phase("K2_covertype_frontier", [(4096, 20)],
                        cov_k2_inputs(rng_c), run_k2, fine=True,
                        modes=("f32", "int16"))
    torch.cuda.empty_cache()

    # -- 3u K1 at UpliftDRF's shapes ----------------------------------------
    k1u = kernel_phase("K1_uplift", UPLIFT_SHAPES,
                       k1_inputs(np.random.default_rng(6), UPLIFT_COLS),
                       run_k1, fine=False, modes=("f32", "int16"))
    torch.cuda.empty_cache()

    # -- 3r K1 at RuleFit's shapes ------------------------------------------
    k1r = kernel_phase("K1_rulefit", RULEFIT_SHAPES,
                       k1_inputs(np.random.default_rng(7)), run_k1,
                       fine=False, modes=("f32", "int16"))
    torch.cuda.empty_cache()

    # -- 4 default GBM, full width -------------------------------------------
    X, y = make_data(R, C, seed=0)
    fr = frame(X, y)
    hk.reset_launches()
    m_def, wall = train(fr)
    launches_k2 = hk.hist_cuda_adaptive.launches
    launches_k1 = hk.hist_cuda.launches
    if launches_k2 != 20 * 5 or launches_k1 != 0:
        raise AssertionError(f"default GBM: K2 launched {launches_k2} times "
                             f"(want 100), K1 {launches_k1} (want 0)")
    auc = m_def.output["training_metrics"]["AUC"]
    if not (0.5 < auc <= 1.0) or not np.isfinite(m_def.output["value"]).all():
        raise AssertionError(f"default GBM: implausible model (AUC {auc})")
    emit(dict(phase="gbm_default", rows=R, cols=C, ntrees=20, max_depth=5,
              histogram_type=m_def.output["hist_type"],
              wall_s=wall, wall_with_build_s=wall + lib.seconds,
              rows_trees_per_s=R * 20 / wall, train_auc=auc,
              k2_launches=launches_k2, k1_launches=launches_k1))

    sub = fr.slice_rows(slice(0, 100_000))
    m_gpu, _ = train(sub, device="cuda")
    m_cpu, _ = train(sub, device="cpu")
    same = {k: bool(np.array_equal(m_gpu.output[k][0], m_cpu.output[k][0]))
            for k in ("split_col", "thr_bin", "na_left")}
    auc_gpu = m_gpu.output["training_metrics"]["AUC"]
    auc_cpu = m_cpu.output["training_metrics"]["AUC"]
    emit(dict(phase="gbm_default_cuda_vs_cpu", rows=100_000,
              first_tree_equal=same, auc_cuda=auc_gpu, auc_cpu=auc_cpu))
    if not all(same.values()) or abs(auc_gpu - auc_cpu) > 1e-3:
        raise AssertionError("cuda and cpu forests disagree")

    # -- 5 QuantilesGlobal GBM -----------------------------------------------
    hk.reset_launches()
    m_qg, wall_qg = train(fr, histogram_type="QuantilesGlobal", nbins=64)
    q_k1, q_k2 = hk.hist_cuda.launches, hk.hist_cuda_adaptive.launches
    if q_k1 != 20 * 5 or q_k2 != 0:
        raise AssertionError(f"QuantilesGlobal GBM: K1 launched {q_k1} "
                             f"times (want 100), K2 {q_k2} (want 0)")
    auc_qg = m_qg.output["training_metrics"]["AUC"]
    if not (0.5 < auc_qg <= 1.0):
        raise AssertionError(f"QuantilesGlobal GBM: AUC {auc_qg}")
    emit(dict(phase="gbm_quantiles_global", rows=R, cols=C, ntrees=20,
              max_depth=5, nbins=64, wall_s=wall_qg,
              rows_trees_per_s=R * 20 / wall_qg, train_auc=auc_qg,
              k1_launches=q_k1, k2_launches=q_k2))

    # -- 6 scoring -----------------------------------------------------------
    t0 = time.perf_counter()
    pred = m_def.predict(fr)
    score_s = time.perf_counter() - t0
    p1 = torch.from_numpy(pred.vec("s").data).to(DEV)
    yt = torch.from_numpy(fr.vec("y").as_float()).to(DEV)
    auc_pred = binomial_metrics(p1, yt)["AUC"]
    if pred.nrows != R or not np.isfinite(pred.vec("s").data).all() or \
            auc_pred != auc:
        raise AssertionError(f"scoring: AUC from predict() {auc_pred} != "
                             f"training AUC {auc}")
    emit(dict(phase="score", rows=R, wall_s=score_s, auc=auc_pred))
    sync()

    # -- 8 stochastic GBM ----------------------------------------------------
    paths = {"gbm_default": (launches_k1, launches_k2),
             "gbm_quantiles_global": (q_k1, q_k2)}
    for name, kw, want in (
            ("gbm_stochastic_random", dict(histogram_type="Random"),
             (0, 100)),
            ("gbm_stochastic_quantiles_global",
             dict(histogram_type="QuantilesGlobal", nbins=64), (100, 0))):
        m_s, wall_s, got = launched(train, fr=fr, **STOCHASTIC, **kw)
        auc_s = m_s.output["training_metrics"]["AUC"]
        emit(dict(phase=name, rows=R, cols=C, ntrees=20, max_depth=5,
                  **STOCHASTIC, **kw, wall_s=wall_s,
                  rows_trees_per_s=R * 20 / wall_s, train_auc=auc_s,
                  k1_launches=got[0], k2_launches=got[1]))
        if got != want:
            raise AssertionError(f"{name}: (K1, K2) launched {got}, want "
                                 f"{want}")
        if not (0.5 < auc_s <= 1.0) or \
                not np.isfinite(m_s.output["value"]).all():
            raise AssertionError(f"{name}: implausible model (AUC {auc_s})")
        paths[name] = got
    kw_r = dict(STOCHASTIC, histogram_type="Random", ntrees=3)
    m_gpu, _ = train(sub, device="cuda", **kw_r)
    m_cpu, _ = train(sub, device="cpu", **kw_r)
    cmp_r = same_forest(m_gpu.output, m_cpu.output, trees=1)
    emit(dict(phase="gbm_stochastic_cuda_vs_cpu", rows=100_000, ntrees=3,
              first_tree=cmp_r,
              auc_cuda=m_gpu.output["training_metrics"]["AUC"],
              auc_cpu=m_cpu.output["training_metrics"]["AUC"]))
    if not all(cmp_r["equal"].values()):
        raise AssertionError("stochastic GBM: cuda and cpu first trees "
                             "differ")

    # -- 9 DRF at its defaults ------------------------------------------------
    m_drf, wall_drf, got = launched(train_drf, fr=fr)
    paths["drf"] = got
    auc_drf = m_drf.output["training_metrics"]["AUC"]
    n_split = int((m_drf.output["split_col"] >= 0).sum())
    emit(dict(phase="drf", rows=R, cols=C, ntrees=DRF_TREES, max_depth=20,
              mtries=5, sample_rate=0.632, wall_s=wall_drf,
              s_per_tree=wall_drf / DRF_TREES, train_auc=auc_drf,
              splits=n_split, pool=int(m_drf.output["split_col"].shape[2]),
              k1_launches=got[0], k2_launches=got[1]))
    if got != (0, 20 * DRF_TREES):
        raise AssertionError(f"DRF: (K1, K2) launched {got}, want "
                             f"(0, {20 * DRF_TREES})")
    if m_drf.output["child"] is None or not (0.5 < auc_drf <= 1.0):
        raise AssertionError(f"DRF: implausible model (AUC {auc_drf})")
    t0 = time.perf_counter()
    pred = m_drf.predict(fr)
    score_drf = time.perf_counter() - t0
    auc_pred = binomial_metrics(
        torch.from_numpy(pred.vec("s").data).to(DEV), yt)["AUC"]
    emit(dict(phase="drf_score", rows=R, wall_s=score_drf, auc=auc_pred))
    if pred.nrows != R or auc_pred != auc_drf:
        raise AssertionError(f"DRF scoring: AUC from predict() {auc_pred} "
                             f"!= training AUC {auc_drf}")
    m_gpu, _ = train_drf(sub, ntrees=2, device="cuda")
    m_cpu, _ = train_drf(sub, ntrees=2, device="cpu")
    cmp_d = same_forest(m_gpu.output, m_cpu.output)
    emit(dict(phase="drf_cuda_vs_cpu", rows=100_000, ntrees=2, forest=cmp_d,
              splits=int((m_gpu.output["split_col"] >= 0).sum())))
    if not all(cmp_d["equal"].values()) or \
            cmp_d["value_max_abs_diff"] > 1e-6:
        raise AssertionError("DRF: cuda and cpu forests differ")
    sync()

    # each phase removes the models and frames its trainings published
    # in the DKV (what it returns stays referenced by main)
    from h2o_tpu_torch.core.store import dkv
    base_keys = set(dkv().keys())
    unpublish(base_keys)

    # -- 10 XGBoost, 11 multinomial, 12 distributions / weights / monotone --
    phase_xgboost(fr, sub, yt, paths)
    unpublish(base_keys)
    cov = make_covertype(seed=0)
    phase_multinomial(cov, paths)
    unpublish(base_keys)
    phase_families(X, y, fr, paths)
    unpublish(base_keys)
    # -- 13 the training loop: validation, early stopping, blocks,
    # checkpoints, cross-validation ------------------------------------------
    torch.cuda.empty_cache()
    phase_loop(paths)
    unpublish(base_keys)
    # -- 14 DT, IsolationForest, ExtendedIsolationForest, UpliftDRF ---------
    torch.cuda.empty_cache()
    fr_u = phase_family(X, y, fr, paths)
    unpublish(base_keys)
    # -- 15 ingest and explain ----------------------------------------------
    torch.cuda.empty_cache()
    phase_ingest_explain(X, y, fr, m_def, paths)
    unpublish(base_keys)
    # -- 16 GLM and XGBoost gblinear ------------------------------------------
    torch.cuda.empty_cache()
    phase_glm(X, y, fr, paths)
    unpublish(base_keys)
    # -- 17 KMeans, DeepLearning, GAM, RuleFit --------------------------------
    torch.cuda.empty_cache()
    phase_more(X, fr, paths)
    unpublish(base_keys)
    # -- 18 PCA, SVD, GLRM, Word2Vec, NaiveBayes, CoxPH -----------------------
    torch.cuda.empty_cache()
    phase_slice10(X, fr, paths)
    unpublish(base_keys)
    # -- 19 IsotonicRegression .. Grep ----------------------------------------
    torch.cuda.empty_cache()
    phase_slice11(X, y, fr, paths)
    unpublish(base_keys)
    # -- 20 MOJO, the array fast path, Generic, ScoringEngine -----------------
    torch.cuda.empty_cache()
    m_cat, fc = phase_slice12(fr, m_def, m_drf, paths)
    unpublish(base_keys)
    # -- 21 micro-batcher, registry, breaker, fleet -------------------------
    torch.cuda.empty_cache()
    phase_slice13(fr, m_def, m_drf, m_cat, fc, paths)
    unpublish(base_keys)
    # -- 22 the other formats, remote paths, streaming, the timezone -------
    torch.cuda.empty_cache()
    phase_slice15(X, y, cov, paths)
    unpublish(base_keys)
    # -- 23 the data plane and F8's repeat check ---------------------------
    torch.cuda.empty_cache()
    phase_slice16(X, fr, cov, smi, paths)
    unpublish(base_keys)
    # -- 24 jobs, the DKV, user functions ----------------------------------
    torch.cuda.empty_cache()
    phase_slice18(X, y, fr, m_def, m_drf, paths)
    emit(dict(phase="launches", paths={k: dict(k1=v[0], k2=v[1])
                                       for k, v in paths.items()}))
    sync()

    # -- 7 where a tree's time goes (torch.profiler) -------------------------
    from torch.profiler import ProfilerActivity, profile

    def profiled(fn=train, ntrees=2, on=fr, **kw):
        """Device ms by kernel name over a short training on ``on``, its
        wall, the number of device operations, and the two counters'
        launches."""
        hk.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = fn(on, ntrees=ntrees, **kw)
        per, n = {}, 0
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                per[ev.name] = per.get(ev.name, 0.0) + \
                    ev.device_time_total / 1e3
                n += 1
        return per, wall, n, (hk.hist_cuda.launches,
                              hk.hist_cuda_adaptive.launches)

    def per_launch(per, launches):
        """Device ms per launch of a histogram kernel on the main path:
        its first pass, kernel and last pass (csrc/hist.cu names), from
        the profiler's totals over the counter's launches."""
        parts = {k: v for k, v in per.items()
                 if re.search(r"hist_(kernel|amax_kernel|finish)", k)}
        total = sum(parts.values())
        return dict(launches=launches, ms_per_launch=total / max(launches, 1),
                    parts_ms={k[:70]: v for k, v in parts.items()})

    def breakdown(per, wall, n):
        busy = sum(per.values())
        top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
        return dict(wall_s=wall, device_busy_ms=busy,
                    device_busy_share=busy / (wall * 1e3), device_ops=n,
                    top_device_ms={k[:60]: v for k, v in top})

    per_name, wall_p, n_kernels, (p_k1, p_k2) = profiled()
    per_q, _, _, (pq_k1, pq_k2) = profiled(histogram_type="QuantilesGlobal",
                                           nbins=64)
    per_r, _, _, (pr_k1, pr_k2) = profiled(histogram_type="Random",
                                           **STOCHASTIC)
    per_qi, _, _, (pqi_k1, pqi_k2) = profiled(
        histogram_type="QuantilesGlobal", nbins=64, **STOCHASTIC)
    if p_k1 or pq_k2 or not p_k2 or not pq_k1 or pr_k1 or pqi_k2:
        raise AssertionError("profiled trainings took the wrong kernels")
    main_path = dict(hist_cuda_adaptive=per_launch(per_name, p_k2),
                     hist_cuda=per_launch(per_q, pq_k1),
                     hist_cuda_adaptive_int16=per_launch(per_r, pr_k2),
                     hist_cuda_int16=per_launch(per_qi, pqi_k1))
    # two fixed costs of every training, timed alone on the host clock
    t0 = time.perf_counter()
    fr.as_matrix(m_def.output["x"], DEV)
    sync()
    t1 = time.perf_counter()
    m_def.model_metrics(fr)
    sync()
    t2 = time.perf_counter()
    emit(dict(phase="profile_default_gbm", ntrees=2,
              **breakdown(per_name, wall_p, n_kernels),
              frame_to_device_s=t1 - t0, training_metrics_s=t2 - t1,
              main_path_kernels=main_path))
    per_d, wall_d, n_d, (pd_k1, pd_k2) = profiled(train_drf, ntrees=1)
    if pd_k1 or pd_k2 != 20:
        raise AssertionError(f"profiled DRF tree: (K1, K2) launched "
                             f"{(pd_k1, pd_k2)}, want (0, 20)")
    emit(dict(phase="profile_drf_tree", ntrees=1,
              **breakdown(per_d, wall_d, n_d),
              hist_cuda_adaptive=per_launch(per_d, pd_k2)))
    per_x, wall_x, n_x, (px_k1, px_k2) = profiled(train_xgb, ntrees=1)
    per_m, wall_m, n_m, (pm_k1, pm_k2) = profiled(
        lambda on, **kw: fit(GBM, on, seed=1, **kw), ntrees=1, on=cov)
    if (px_k1, px_k2) != (0, 6) or (pm_k1, pm_k2) != (0, 35):
        raise AssertionError(f"profiled XGBoost tree / multinomial "
                             f"iteration: (K1, K2) launched "
                             f"{(px_k1, px_k2)} / {(pm_k1, pm_k2)}")
    emit(dict(phase="profile_xgboost_tree", ntrees=1,
              **breakdown(per_x, wall_x, n_x),
              hist_cuda_adaptive=per_launch(per_x, px_k2)))
    emit(dict(phase="profile_multinomial_iteration", trees=7,
              **breakdown(per_m, wall_m, n_m),
              hist_cuda_adaptive=per_launch(per_m, pm_k2)))
    per_u, wall_u, n_u, (pu_k1, pu_k2) = profiled(
        lambda on, **kw: fit(UpliftDRF, on, seed=1,
                             treatment_column="treatment", **kw),
        ntrees=1, on=fr_u)
    if (pu_k1, pu_k2) != (10, 0):
        raise AssertionError(f"profiled UpliftDRF tree: (K1, K2) launched "
                             f"{(pu_k1, pu_k2)}, want (10, 0)")
    emit(dict(phase="profile_uplift_tree", ntrees=1,
              **breakdown(per_u, wall_u, n_u),
              hist_cuda=per_launch(per_u, pu_k1)))

    def block(tot, **shape):
        return dict(**shape, ms=tot["ms"], bound_ms=tot["bound_ms"],
                    plain_ms=tot["plain_ms"], library_ms=tot["library_ms"],
                    max_abs_err=tot["max_abs_err"], int16_ms=tot["int16_ms"],
                    int16_bound_ms=tot["int16_bound_ms"])

    def entry(name, replaces, launches, tot, front, **more):
        return dict(name=name, route="cuda",
                    source="h2o_tpu_torch/csrc/hist.cu", replaces=replaces,
                    launches=launches, max_abs_err=tot["max_abs_err"],
                    ms=tot["ms"], plain_ms=tot["plain_ms"],
                    bound_ms=tot["bound_ms"],
                    bound_by=("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                              else "operations"),
                    library_ms=tot["library_ms"], int16_ms=tot["int16_ms"],
                    frontier=block(front, L=4096, B=20), **more)

    emit(dict(phase="done", seconds=time.perf_counter() - t_start))
    print(smi, flush=True)
    emit({"kernels": [
        entry("hist_cuda", "h2o_tpu/ops/hist_pallas.py:308",
              sum(v[0] for v in paths.values()), k1, k1f,
              uplift=dict(rows=R, cols=UPLIFT_COLS,
                          **block(k1u, shapes=UPLIFT_SHAPES),
                          launches=sum(v[0] for k, v in paths.items()
                                       if k.startswith("upliftdrf"))),
              rulefit=dict(rows=R, cols=C,
                           **block(k1r, shapes=RULEFIT_SHAPES),
                           launches=paths["rulefit"][0])),
        entry("hist_cuda_adaptive", "h2o_tpu/ops/hist_pallas.py:220",
              sum(v[1] for v in paths.values()), k2, k2f,
              xgb=block(k2x, shapes=XGB_SHAPES),
              covertype=dict(rows=sum(COV_COUNTS), cols=54,
                             gbm=block(k2c, shapes=[COV_GBM_SHAPE]),
                             frontier=block(k2cf, shapes=[(4096, 20)])))]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
