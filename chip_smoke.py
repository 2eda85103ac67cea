#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU.

    python3 chip_smoke.py

The main paths are GBM and DRF training followed by scoring, at the
HIGGS-shaped width of 1,000,000 rows x 28 features the repository
benchmarks.  Phases (each prints one JSON line; any failure raises and the
exit code is not 0):

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
              predict(); one GBM and one DRF iteration on the first 100,000
              rows equal on the card and on the CPU
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
  7 profile - torch.profiler over 2 default trees: device busy share and
              the kernels that take the device time; then 2 QuantilesGlobal
              trees: each histogram kernel's device ms per main-path launch
              (first pass + kernel + last pass, over the launch counter);
              the same for the two int16 stochastic GBMs, for one DRF tree
              (where its time goes), one XGBoost tree, one multinomial
              iteration (7 class trees) and one UpliftDRF tree

The kernels line's launches sum every main-path training above (phases
4, 5, 8-14), each read from counters set to 0 just before it; the
launches phase lists them path by path.

The line before the last holds every kernel's numbers; the last line is
the device summary.  Needs one CUDA card; exits non-zero without one.
"""

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device available", file=sys.stderr)
    sys.exit(2)

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec  # noqa: E402
from h2o_tpu_torch.models.metrics import (binomial_metrics,  # noqa: E402
                                          multinomial_metrics)
from h2o_tpu_torch.models.model import Model  # noqa: E402
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
from h2o_tpu_torch.ops import hist_kernels as hk  # noqa: E402
from h2o_tpu_torch.ops.histogram import hist_plain  # noqa: E402

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


def make_covertype(seed: int = 0) -> Frame:
    """A covertype-shaped frame: 10 normal columns, a 4-way and a 40-way
    one-hot block (0/1 numeric columns) and 7 classes with covertype's
    class counts.  Class scores are a seeded linear signal over three
    numeric columns and both blocks; with Gumbel noise on each score, the
    rarest class takes its count of the unassigned rows that score it
    highest, then the next rarest, so the counts are exact."""
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
    cols = [X] + [(wild[:, None] == np.arange(4)).astype(np.float32),
                  (soil[:, None] == np.arange(40)).astype(np.float32)]
    M = np.concatenate(cols, axis=1)
    names = ([f"elev{j}" for j in range(10)] + [f"wild{j}" for j in range(4)]
             + [f"soil{j}" for j in range(40)] + ["y"])
    vecs = [Vec(M[:, j]) for j in range(M.shape[1])] + \
        [Vec(y, T_CAT, domain=[f"c{k}" for k in range(K)])]
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
    rec = first_tree_check("multinomial_drf", DRF, sub, ntrees=1, seed=1)
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

    # -- 10 XGBoost, 11 multinomial, 12 distributions / weights / monotone --
    phase_xgboost(fr, sub, yt, paths)
    cov = make_covertype(seed=0)
    phase_multinomial(cov, paths)
    phase_families(X, y, fr, paths)
    # -- 13 the training loop: validation, early stopping, blocks,
    # checkpoints, cross-validation ------------------------------------------
    torch.cuda.empty_cache()
    phase_loop(paths)
    # -- 14 DT, IsolationForest, ExtendedIsolationForest, UpliftDRF ---------
    torch.cuda.empty_cache()
    fr_u = phase_family(X, y, fr, paths)
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
                                       if k.startswith("upliftdrf")))),
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
