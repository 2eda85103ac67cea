#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU.

    python3 chip_smoke.py

The main path is GBM training followed by scoring, at the HIGGS-shaped
width of 1,000,000 rows x 28 features the repository benchmarks.  Phases
(each prints one JSON line; any failure raises and the exit code is not 0):

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
  4 default GBM (UniformAdaptive) on 1M x 28: K2 must carry every level;
    then the same GBM on the first 100,000 rows on the card and on the
    CPU (the plain versions) must grow the same first tree
  5 QuantilesGlobal GBM (nbins=64): K1 must carry every level
  6 scoring - predict() on the training frame reproduces the training AUC
  7 profile - torch.profiler over 2 default trees: device busy share and
              the kernels that take the device time; then 2 QuantilesGlobal
              trees: each histogram kernel's device ms per main-path launch
              (first pass + kernel + last pass, over the launch counter)

The line before the last holds every kernel's numbers; the last line is
the device summary.  Needs one CUDA card; exits non-zero without one.
"""

import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device available", file=sys.stderr)
    sys.exit(2)

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec  # noqa: E402
from h2o_tpu_torch.models.metrics import binomial_metrics  # noqa: E402
from h2o_tpu_torch.models.tree.gbm import GBM  # noqa: E402
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
L2_FLUSH_BYTES = 256 * 2 ** 20   # written before each timed launch (L2: 50 MB)


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


def frame(X, y) -> Frame:
    names = [f"x{j}" for j in range(X.shape[1])] + ["y"]
    vecs = [Vec(X[:, j]) for j in range(X.shape[1])] + \
        [Vec(y, T_CAT, domain=["b", "s"])]
    return Frame(names, vecs)


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


def kernel_phase(name: str, shapes, make_inputs, run_kernel, fine: bool):
    """Check and time one kernel over the main-path shapes; returns the
    totals over the schedule (f32 mode, and int16 ms) for the summary
    line.  Every mode is launched twice and once more on row-permuted
    inputs: all three tables must have the same bits."""
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
               max_abs_err=0.0, bytes_ms=0.0, ops_ms=0.0, int16_ms=0.0)
    for si, (L, B) in enumerate(shapes):
        bins, leaf, stats_f, stats_i, fm = make_inputs(L, B)
        # int8 stats from the int16 ones, and a row permutation from a
        # generator of their own, so the draws above match earlier runs
        stats_i8 = torch.div(stats_i, 16, rounding_mode="floor").to(
            torch.int8)
        perm = torch.from_numpy(np.random.default_rng(1000 + si).permutation(
            bins.shape[0])).to(DEV)
        pbins, pleaf = bins[perm].contiguous(), leaf[perm].contiguous()
        active = int((leaf >= 0).sum())
        if si == 0:
            emit(nan_check(name, L, B, bins, leaf, stats_f, fm, run_kernel))
        for mode in ("f32", "bf16", "int16", "int8"):
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
            rec = dict(phase=name, L=L, B=B, mode=mode, max_abs_err=err,
                       max_abs_plain=scale, bitwise_repeat=True,
                       bitwise_permuted=True)
            if mode == "int16":
                rec["ms"] = time_ms(kern)
                tot["int16_ms"] += rec["ms"]
            if mode == "f32":
                nbytes = (bins.numel() * bins.element_size() + leaf.numel() * 4
                          + active * 16 + C * (B + 1) * L * 16)
                if fine:
                    nbytes += 3 * L * C * 4 + C * 4
                # operations: one float32 add per (active row, column,
                # stat); K2's integer bucket arithmetic is not counted
                ops = active * C * 4
                plan = hk.plan_hist(R, C, B + 1, L, adaptive=fine,
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


def k1_inputs(rng):
    def make(L, B):
        bins = torch.from_numpy(rng.integers(0, B + 1, size=(R, C),
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


def k2_inputs(rng, F: int = 1024):
    def make(L, B):
        bins_np = rng.integers(0, F, size=(R, C)).astype(np.int16)
        bins_np[rng.uniform(size=(R, C)) < 0.05] = F      # NA fine bins
        bins_np[:, 3] = rng.integers(0, 12, size=R)       # categorical codes
        bins_np[rng.uniform(size=R) < 0.05, 3] = F
        is_cat = np.zeros(C, bool)
        is_cat[3] = True
        leaf_np = rng.integers(0, L, size=R).astype(np.int32)
        leaf_np[rng.uniform(size=R) < 0.01] = -1
        lo = rng.integers(0, F // 2, size=(L, C)).astype(np.int32)
        hi = (lo + rng.integers(1, F // 2, size=(L, C))).astype(np.int32)
        off = rng.integers(0, hi - lo + 1).astype(np.int32)
        st = rng.normal(size=(R, 4)).astype(np.float32)
        st[leaf_np < 0] = np.nan
        sti = rng.integers(-2000, 2000, size=(R, 4)).astype(np.int16)
        fm = tuple(torch.from_numpy(a).to(DEV) for a in (lo, hi, off,
                                                          is_cat)) + (F,)
        return (torch.from_numpy(bins_np).to(DEV),
                torch.from_numpy(leaf_np).to(DEV),
                torch.from_numpy(st).to(DEV), torch.from_numpy(sti).to(DEV),
                fm)
    return make


def run_k1(bins, leaf, stats, L, B, bf16, fm):
    return hk.hist_cuda(bins, leaf, stats, L, B, bf16=bf16)


def run_k2(bins, leaf, stats, L, B, bf16, fm):
    lo, hi, off, is_cat, fine_na = fm
    return hk.hist_cuda_adaptive(bins, leaf, stats, lo, hi, off, is_cat, L,
                                 B, fine_na, bf16=bf16)


def train(fr, **kw):
    sync()
    t0 = time.perf_counter()
    m = GBM(**{"ntrees": 20, "max_depth": 5, "seed": 1, **kw}).train(
        y="y", training_frame=fr)
    sync()
    return m, time.perf_counter() - t0


def main() -> None:
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

    # -- 7 where a default tree's time goes (torch.profiler, 2 trees) ------
    from torch.profiler import ProfilerActivity, profile

    def profiled(**kw):
        """Device ms by kernel name over a 2-tree training, its wall, the
        number of device operations, and the two counters' launches."""
        hk.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = train(fr, ntrees=2, **kw)
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

    per_name, wall_p, n_kernels, (p_k1, p_k2) = profiled()
    per_q, _, _, (pq_k1, pq_k2) = profiled(histogram_type="QuantilesGlobal",
                                           nbins=64)
    if p_k1 or pq_k2 or not p_k2 or not pq_k1:
        raise AssertionError("profiled trainings took the wrong kernels")
    main_path = dict(hist_cuda_adaptive=per_launch(per_name, p_k2),
                     hist_cuda=per_launch(per_q, pq_k1))
    busy_ms = sum(per_name.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
    # two fixed costs of every training, timed alone on the host clock
    t0 = time.perf_counter()
    fr.as_matrix(m_def.output["x"], DEV)
    sync()
    t1 = time.perf_counter()
    m_def.model_metrics(fr)
    sync()
    t2 = time.perf_counter()
    emit(dict(phase="profile_default_gbm", ntrees=2, wall_s=wall_p,
              device_busy_ms=busy_ms,
              device_busy_share=busy_ms / (wall_p * 1e3),
              device_ops=n_kernels,
              top_device_ms={k[:60]: v for k, v in top},
              frame_to_device_s=t1 - t0, training_metrics_s=t2 - t1,
              main_path_kernels=main_path))

    def entry(name, replaces, launches, tot):
        return dict(name=name, route="cuda",
                    source="h2o_tpu_torch/csrc/hist.cu", replaces=replaces,
                    launches=launches, max_abs_err=tot["max_abs_err"],
                    ms=tot["ms"], plain_ms=tot["plain_ms"],
                    bound_ms=tot["bound_ms"],
                    bound_by=("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                              else "operations"),
                    library_ms=tot["library_ms"])

    print(smi, flush=True)
    emit({"kernels": [
        entry("hist_cuda", "h2o_tpu/ops/hist_pallas.py:308", q_k1, k1),
        entry("hist_cuda_adaptive", "h2o_tpu/ops/hist_pallas.py:220",
              launches_k2, k2)]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
