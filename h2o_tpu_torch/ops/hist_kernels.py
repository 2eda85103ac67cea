"""Hand-written CUDA histogram kernels for Hopper, their wrappers, the
group planner, the launch counters and the build.

Replaces the TPU kernels of ``h2o_tpu/ops/hist_pallas.py``:

* K1 ``hist_pallas`` (:306-350, body ``_hist_kernel`` :115-151) ->
  ``hist_cuda``;
* K2 ``hist_pallas_adaptive`` (:218-303, body ``_adaptive_kernel``
  :154-215) -> ``hist_cuda_adaptive``.

Source: ``csrc/hist.cu``.  What bounds the work on an H100: each input
byte is read once and the table is small, so the floor is memory
bandwidth (bins + leaf + stats over 3.35 TB/s); the adds themselves are
a data-dependent scatter.  The design (detailed in the source): a grid
over (column group, leaf group, bin group, row chunk), each CTA holding
a private table in shared memory; one warp per table column resolves
same-cell collisions with ``__match_any_sync`` and adds in row order, so
no atomics are needed and float32 results are bit-reproducible; per-
chunk partial tables are summed in fixed order by a second kernel.

The planner below sizes the groups so one CTA's table fits
``SMEM_BUDGET`` bytes of dynamic shared memory (H100 allows 227 KB per
block with the opt-in), so no shape is refused: wide bucket counts
split columns, wide frontiers split leaves, and a bucket count too wide
for one column splits bins.

The library is built with ``nvcc`` at first launch, from the sources in
this package, into ``h2o_tpu_torch/_build/`` (gitignored), and loaded
with ``ctypes``.  A failed build raises.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Iterator, NamedTuple, Optional, Tuple

import torch

from h2o_tpu_torch.ops.binpack import PACKED_DTYPES

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "hist.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

#: dynamic shared memory one CTA's table may take (of 227 KB allowed)
SMEM_BUDGET = 200 * 1024
#: shared memory an H100 SM holds for resident CTAs, and per-CTA reserve
_SM_SMEM = 228 * 1024
_CTA_RESERVE = 1024
_MAX_WARPS = 16
#: a chunk holds at least this many rows
MIN_CHUNK_ROWS = 2048
#: per-chunk partial tables may take at most this much scratch
SCRATCH_BYTES = 256 * 2 ** 20

_BINS_CODE = {torch.uint8: 0, torch.int16: 1, torch.int32: 2}
_INT_STATS_CODE = {torch.int16: 0, torch.int8: 1}


class HistPlan(NamedTuple):
    """Group sizes and chunking of one launch.  CTA (g, chunk) with
    g = cgi + ncg*(lgi + nlg*bgi) covers columns [cgi*cg, ...), leaves
    [lgi*lg, ...) and bins [bgi*bg, ...), each clipped to the shape."""
    C: int
    L: int
    B1: int
    cg: int
    lg: int
    bg: int
    ncg: int
    nlg: int
    nbg: int
    n_chunks: int
    chunk_rows: int
    warps: int
    smem_bytes: int

    def groups(self) -> Iterator[Tuple[int, int, int, int, int, int]]:
        """(c0, c1, l0, l1, b0, b1) of every CTA group, as the kernel
        maps ``blockIdx.x`` (half-open ranges)."""
        for g in range(self.ncg * self.nlg * self.nbg):
            cgi, rest = g % self.ncg, g // self.ncg
            lgi, bgi = rest % self.nlg, rest // self.nlg
            c0, l0, b0 = cgi * self.cg, lgi * self.lg, bgi * self.bg
            yield (c0, min(c0 + self.cg, self.C), l0,
                   min(l0 + self.lg, self.L), b0,
                   min(b0 + self.bg, self.B1))


def _split(n: int, most: int) -> Tuple[int, int]:
    """(size, count) of the fewest balanced groups of at most ``most``."""
    count = -(-n // max(most, 1))
    return -(-n // count), count


def plan_hist(R: int, C: int, B1: int, L: int, adaptive: bool = False,
              n_sm: int = 132) -> HistPlan:
    """Group sizes so one CTA's shared memory — the table
    ``cg*lg*bg*4`` cells of 4 stats of 4 bytes, plus for K2 the
    (lo, hi, off) ranges of its leaves and columns and the columns'
    is_cat flags — fits ``SMEM_BUDGET``.  Leaves are grouped before
    columns, and bins only when a single (column, leaf) row of the table
    does not fit.  Row chunks then fill about one wave of CTAs on
    ``n_sm`` SMs, within ``SCRATCH_BYTES`` of partial tables."""
    budget = SMEM_BUDGET
    cell = 4 * 4                          # S=4 stats of 4 bytes
    per_lc = 12 if adaptive else 0        # lo, hi, off per (leaf, col)
    per_c = 4 if adaptive else 0          # is_cat per column
    bg, nbg = _split(B1, (budget - per_lc - per_c) // cell)
    lg, nlg = _split(L, (budget - per_c) // (bg * cell + per_lc))
    cg, ncg = _split(C, budget // (lg * (bg * cell + per_lc) + per_c))
    smem = cg * (lg * (bg * cell + per_lc) + per_c)
    warps = max(1, min(cg, _MAX_WARPS))
    resident = max(1, min(32, 2048 // (32 * warps),
                          _SM_SMEM // (smem + _CTA_RESERVE)))
    n_groups = ncg * nlg * nbg
    table_bytes = C * B1 * L * cell
    n_chunks = max(1, min(-(-n_sm * resident // n_groups),
                          -(-max(R, 1) // MIN_CHUNK_ROWS),
                          SCRATCH_BYTES // table_bytes, 65535))
    chunk_rows = 32 * -(-max(R, 1) // (32 * n_chunks))
    n_chunks = -(-max(R, 1) // chunk_rows)
    return HistPlan(C, L, B1, cg, lg, bg, ncg, nlg, nbg, n_chunks,
                    chunk_rows, warps, smem)


# -- build --------------------------------------------------------------------

class _Library(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    log: str
    seconds: float


_LIBRARY: Optional[_Library] = None


def _find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("h2o_tpu_torch: nvcc not found (set CUDA_HOME); the "
                       "CUDA histogram kernels cannot be built")


def _bind(lib: ctypes.CDLL) -> None:
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    plan = [LL, I, I, I, I, I, I, I, I, I, LL, I, I, I, P]
    lib.h2o_hist_f32.argtypes = [P, I, P, P, I, P, P] + plan
    lib.h2o_hist_i32.argtypes = [P, I, P, P, I, P, P] + plan
    lib.h2o_hist_adaptive_f32.argtypes = [P, I, P, P, P, P, P, P, I, I,
                                          P, P] + plan
    lib.h2o_hist_adaptive_i32.argtypes = [P, I, P, P, I, P, P, P, P, I,
                                          P, P] + plan
    for fn in (lib.h2o_hist_f32, lib.h2o_hist_i32,
               lib.h2o_hist_adaptive_f32, lib.h2o_hist_adaptive_i32):
        fn.restype = ctypes.c_int


def build() -> _Library:
    """Compile ``csrc/hist.cu`` for sm_90a (once per source content) and
    load it.  Raises with nvcc's output when the build fails."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"libh2o_hist_{digest[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        nvcc = _find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {SOURCE}:\n"
                    f"{log}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(so))
    _bind(lib)
    _LIBRARY = _Library(lib, so, log, time.perf_counter() - t0)
    return _LIBRARY


# -- wrappers -----------------------------------------------------------------

def _check(bins, leaf, stats, n_leaves, nbins, bf16, what):
    if not (isinstance(bins, torch.Tensor) and bins.is_cuda):
        raise ValueError(f"{what}: bins must be a CUDA tensor")
    dev = bins.device
    for name, t in (("leaf", leaf), ("stats", stats)):
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"{what}: {name} must be a tensor on {dev}")
    if bins.dim() != 2 or bins.dtype not in PACKED_DTYPES:
        raise ValueError(f"{what}: bins must be (R, C) uint8/int16/int32, "
                         f"got {tuple(bins.shape)} {bins.dtype}")
    R = bins.shape[0]
    if leaf.dtype != torch.int32 or tuple(leaf.shape) != (R,):
        raise ValueError(f"{what}: leaf must be ({R},) int32")
    if tuple(stats.shape) != (R, 4) or stats.dtype not in (
            torch.float32, torch.int16, torch.int8):
        raise ValueError(f"{what}: stats must be ({R}, 4) float32, int16 "
                         f"or int8, got {tuple(stats.shape)} {stats.dtype}")
    if bf16 and stats.dtype != torch.float32:
        raise ValueError(f"{what}: bf16 rounding applies to float32 stats")
    for name, t in (("bins", bins), ("leaf", leaf), ("stats", stats)):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if int(n_leaves) < 1 or int(nbins) < 1:
        raise ValueError(f"{what}: n_leaves and nbins must be >= 1")


def _launch_args(bins, stats, n_leaves, nbins, adaptive):
    R, C = bins.shape
    L, B1 = int(n_leaves), int(nbins) + 1
    n_sm = torch.cuda.get_device_properties(bins.device).multi_processor_count
    plan = plan_hist(R, C, B1, L, adaptive=adaptive, n_sm=n_sm)
    quantized = stats.dtype != torch.float32
    acc = torch.int32 if quantized else torch.float32
    out = torch.empty((C * B1, L * 4), dtype=acc, device=bins.device)
    scratch = (torch.empty(plan.n_chunks * C * B1 * L * 4, dtype=acc,
                           device=bins.device)
               if plan.n_chunks > 1 else out)
    tail = (R, C, L, int(nbins), plan.cg, plan.lg, plan.bg, plan.ncg,
            plan.nlg, plan.nbg, plan.chunk_rows, plan.n_chunks, plan.warps,
            plan.smem_bytes,
            torch.cuda.current_stream(bins.device).cuda_stream)
    return out, scratch, tail


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def hist_cuda(bins: torch.Tensor, leaf: torch.Tensor, stats: torch.Tensor,
              n_leaves: int, nbins: int, bf16: bool = False) -> torch.Tensor:
    """K1: ``(C*(B+1), L*S)`` table of one device's rows (float32, or an
    exact int32 table for int16/int8 stats).  Same contract as
    ``hist_pallas``: rows with leaf < 0 add nothing (their stats are
    never read); bin B is the NA bucket."""
    _check(bins, leaf, stats, n_leaves, nbins, bf16, "hist_cuda")
    lib = build().lib
    with torch.cuda.device(bins.device):
        out, scratch, tail = _launch_args(bins, stats, n_leaves, nbins,
                                          False)
        code = _BINS_CODE[bins.dtype]
        if stats.dtype == torch.float32:
            err = lib.h2o_hist_f32(bins.data_ptr(), code, leaf.data_ptr(),
                                   stats.data_ptr(), int(bf16),
                                   scratch.data_ptr(), out.data_ptr(), *tail)
        else:
            err = lib.h2o_hist_i32(bins.data_ptr(), code, leaf.data_ptr(),
                                   stats.data_ptr(),
                                   _INT_STATS_CODE[stats.dtype],
                                   scratch.data_ptr(), out.data_ptr(), *tail)
    _raise_on(err, "hist_cuda")
    hist_cuda.launches += 1
    return out


def hist_cuda_adaptive(bins: torch.Tensor, leaf: torch.Tensor,
                       stats: torch.Tensor, lo: torch.Tensor,
                       hi: torch.Tensor, off: torch.Tensor,
                       is_cat: torch.Tensor, n_leaves: int, nbins: int,
                       fine_na: int, bf16: bool = False) -> torch.Tensor:
    """K2: K1's table over per-node adaptive buckets — ``map_buckets``
    applied per row inside the kernel.  lo/hi/off are (L, C) int32 fine
    ranges and offsets; is_cat (C,) bool or int; fine_na the NA fine bin."""
    _check(bins, leaf, stats, n_leaves, nbins, bf16, "hist_cuda_adaptive")
    L, C = int(n_leaves), bins.shape[1]
    for name, t in (("lo", lo), ("hi", hi), ("off", off)):
        if (not isinstance(t, torch.Tensor) or t.device != bins.device or
                t.dtype != torch.int32 or tuple(t.shape) != (L, C) or
                not t.is_contiguous()):
            raise ValueError(f"hist_cuda_adaptive: {name} must be a "
                             f"contiguous ({L}, {C}) int32 tensor on "
                             f"{bins.device}")
    if (not isinstance(is_cat, torch.Tensor) or
            is_cat.device != bins.device or tuple(is_cat.shape) != (C,)):
        raise ValueError(f"hist_cuda_adaptive: is_cat must be ({C},) on "
                         f"{bins.device}")
    cat = is_cat.to(torch.int32).contiguous()
    lib = build().lib
    with torch.cuda.device(bins.device):
        out, scratch, tail = _launch_args(bins, stats, n_leaves, nbins, True)
        code = _BINS_CODE[bins.dtype]
        if stats.dtype == torch.float32:
            err = lib.h2o_hist_adaptive_f32(
                bins.data_ptr(), code, leaf.data_ptr(), stats.data_ptr(),
                lo.data_ptr(), hi.data_ptr(), off.data_ptr(), cat.data_ptr(),
                int(fine_na), int(bf16), scratch.data_ptr(), out.data_ptr(),
                *tail)
        else:
            err = lib.h2o_hist_adaptive_i32(
                bins.data_ptr(), code, leaf.data_ptr(), stats.data_ptr(),
                _INT_STATS_CODE[stats.dtype], lo.data_ptr(), hi.data_ptr(),
                off.data_ptr(), cat.data_ptr(), int(fine_na),
                scratch.data_ptr(), out.data_ptr(), *tail)
    _raise_on(err, "hist_cuda_adaptive")
    hist_cuda_adaptive.launches += 1
    return out


hist_cuda.launches = 0
hist_cuda_adaptive.launches = 0


def reset_launches() -> None:
    """Zero both launch counters (before a run whose launches are read)."""
    hist_cuda.launches = 0
    hist_cuda_adaptive.launches = 0
