"""Hand-written CUDA histogram kernels for Hopper, their wrappers, the
group planner, the fixed-point scale rule, the launch counters and the
build.

Replaces the TPU kernels of ``h2o_tpu/ops/hist_pallas.py``:

* K1 ``hist_pallas`` (:306-350, body ``_hist_kernel`` :115-151) ->
  ``hist_cuda``;
* K2 ``hist_pallas_adaptive`` (:218-303, body ``_adaptive_kernel``
  :154-215) -> ``hist_cuda_adaptive``.

Source: ``csrc/hist.cu``.  What bounds the work on an H100: each input
byte is read once and the table is small, so the floor is memory
bandwidth (bins + leaf + active stats over 3.35 TB/s).  What costs the
time in practice is the shared-memory atomics each (row, column) item
issues and how often each row is streamed again (once per column
group).  The design (detailed in the source):

* order-free integer sums, one 32-bit shared-memory word per stat: the
  int16/int8 stats themselves, or for float32 stats a fixed point with
  one power-of-two scale per stat slot (``fixed_point_exponents``, from a
  first pass over the active rows' max |stat| on the device), whose rare
  32-bit wraps go to the global int64 table as +-2^32.  The table has
  the same bits for any order of rows, warps or CTAs, and a float32 cell
  takes 16 bytes, as an int16 one does, with one atomic a stat (which
  returns the old word for the wrap test);
* every warp of a CTA takes any (row, column) item of the CTA's column
  group, so residency follows shared memory, not the column count;
* row tiles (bins, leaves, stats of ``tile_rows`` rows) are staged into
  shared memory by ``cp.async.bulk`` through a ring of mbarrier stages
  fed by one producer thread, sized to keep the most bytes in flight that
  the table's room allows;
* CTAs merge into one table with ``red.global.add`` and a last pass
  writes the float32 output.

The planner below lays out one CTA's shared memory (barriers, the ring,
K2's ranges, the table) within the 227 KB a block may take, and sizes
the groups so no shape is refused: wide bucket counts split columns,
wide frontiers split leaves, a bucket count too wide for one column
splits bins, and rows too wide to stage are read from global memory.

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

#: dynamic shared memory one block may take on an H100 (227 KB)
SMEM_MAX = 232_448
#: shared memory an H100 SM holds for resident blocks, and per-block reserve
_SM_SMEM = 233_472
_CTA_RESERVE = 1024
#: a block's table and ranges start after its barriers, scales and ring
_RING_OFF = 128
#: staged row tiles: rows a tile, ring depths, and the most shared memory
#: one CTA's ring takes
_TILE_ROWS = (512, 384, 256, 192, 128, 96, 64, 32)
_STAGES = (4, 3, 2)
RING_BYTES = 96 * 1024
#: resident warps an SM holds at 64 registers a thread
_SM_WARPS = 32
#: a chunk holds at least this many rows
MIN_CHUNK_ROWS = 2048
#: float32 stats become fixed point below 2^FIXED_POINT_BITS in magnitude
FIXED_POINT_BITS = 26
#: rows one launch takes: the int64 fixed-point sums stay below 2^62
MAX_ROWS = 1 << (62 - FIXED_POINT_BITS)
#: one (bin, leaf) cell: 4 stats, a 32-bit word each, in every mode
CELL_BYTES = 16

_BINS_CODE = {torch.uint8: 0, torch.int16: 1, torch.int32: 2}
_STATS_CODE = {torch.float32: 0, torch.int16: 1, torch.int8: 2}
#: fields of csrc/hist.cu's Plan, the count included
_PLAN_FIELDS = 22


class HistPlan(NamedTuple):
    """Group sizes, chunking and shared-memory layout of one launch.  CTA
    (g, chunk) with g = cgi + ncg*(lgi + nlg*bgi) covers columns
    [cgi*cg, ...), leaves [lgi*lg, ...) and bins [bgi*bg, ...), each
    clipped to the shape, over rows [chunk*chunk_rows, ...)."""
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
    tile_rows: int      # rows per staged tile; 0 = rows read from global
    stages: int
    warps: int          # per CTA, the producer warp included when staged
    resident: int       # CTAs per SM that shared memory and registers allow
    ring_off: int
    ranges_off: int
    table_off: int
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


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def plan_hist(R: int, C: int, B1: int, L: int, adaptive: bool = False,
              n_sm: int = 132, bins_itemsize: int = 1,
              stats_itemsize: int = 4) -> HistPlan:
    """Plan one launch.  A row of the staged tile takes ``C*bins_itemsize``
    bytes of bins, 4 of leaf and ``4*stats_itemsize`` of stats.  Behind the
    barriers and the ring of ``stages`` tiles of ``tile_rows`` rows come
    K2's per-(leaf, column) ranges (lo, span or 0 for a categorical
    column, off, 1/span: 16 bytes), then the table: ``cg*lg*bg`` cells of
    ``CELL_BYTES``.  Bins are split only when one (column, leaf) row of
    the table does not fit, then leaves, then columns.

    Of the rings up to ``RING_BYTES``, the plan takes one that leaves the
    table room for the fewest groups (each group streams every row once
    more), then the one that keeps the most bytes in flight on an SM
    (CTAs per SM follow shared memory), then fewer CTAs per SM (each
    merges a table) and the deeper ring.  Rows too wide for any ring are
    read from global memory.  Warps per CTA fill ``_SM_WARPS`` resident
    warps; row chunks fill one wave of CTAs on ``n_sm`` SMs."""
    cell = CELL_BYTES
    row_bytes = C * bins_itemsize + 4 + 4 * stats_itemsize
    per_lc = 16 if adaptive else 0        # lo, span or 0 if is_cat, off, 1/span

    def layout(tile, stages):
        ranges_off = _RING_OFF + stages * tile * row_bytes
        budget = SMEM_MAX - ranges_off - 32   # 16-byte rounding, two regions
        bg, nbg = _split(B1, (budget - per_lc) // cell)
        lg, nlg = _split(L, budget // (bg * cell + per_lc))
        cg, ncg = _split(C, budget // (lg * (bg * cell + per_lc)))
        table_off = ranges_off + cg * lg * per_lc
        smem = table_off + _up16(cg * lg * bg * cell)
        fit = _SM_SMEM // (smem + _CTA_RESERVE)
        resident = next(r for r in (8, 4, 2, 1) if r <= max(fit, 1))
        key = (ncg * nlg * nbg, -resident * stages * tile * row_bytes,
               resident, -stages)
        return key, (tile, stages, ranges_off, cg, lg, bg, ncg, nlg, nbg,
                     table_off, smem, resident)

    rings = [(t, n) for t in _TILE_ROWS for n in _STAGES
             if n * t * row_bytes <= RING_BYTES] or [(0, 0)]
    _, (tile, stages, ranges_off, cg, lg, bg, ncg, nlg, nbg, table_off,
        smem, resident) = min(layout(t, n) for t, n in rings)
    warps = _SM_WARPS // resident
    n_groups = ncg * nlg * nbg
    n_chunks = max(1, min(-(-n_sm * resident // n_groups),
                          -(-max(R, 1) // MIN_CHUNK_ROWS), 65535))
    unit = tile or 32
    chunk_rows = unit * -(-max(R, 1) // (unit * n_chunks))
    n_chunks = -(-max(R, 1) // chunk_rows)
    return HistPlan(C, L, B1, cg, lg, bg, ncg, nlg, nbg, n_chunks,
                    chunk_rows, tile, stages, warps, resident, _RING_OFF,
                    ranges_off, table_off, smem)


def _plan_array(plan: HistPlan, R: int, nbins: int, fine_na: int,
                bf16: bool):
    """The Plan struct of ``csrc/hist.cu`` as 64-bit integers, in its
    field order, then the field count."""
    f = (R, plan.chunk_rows, plan.C, plan.L, nbins, fine_na, plan.cg,
         plan.lg, plan.bg, plan.ncg, plan.nlg, plan.nbg, plan.n_chunks,
         plan.tile_rows, plan.stages, plan.warps, plan.ring_off,
         plan.ranges_off, plan.table_off, plan.smem_bytes, int(bf16),
         _PLAN_FIELDS)
    return (ctypes.c_longlong * len(f))(*f)


# -- fixed point for float32 stats --------------------------------------------

def fixed_point_exponents(amax: torch.Tensor) -> torch.Tensor:
    """int32 k per stat slot: the largest k with ``amax * 2^k <
    2^FIXED_POINT_BITS``, clamped to [-126, 126] so 2^k and 2^-k are
    normal float32.  With q = round(stat * 2^k):

    * |q| <= 2^FIXED_POINT_BITS, so the kernel's 32-bit word of a cell
      wraps at most once in 2^(32 - FIXED_POINT_BITS) adds, and each wrap
      costs one global atomic;
    * up to ``MAX_ROWS`` stats of a slot sum below 2^62 in magnitude: the
      int64 table cannot overflow;
    * each stat is off by at most 2^(-k-1) <= amax * 2^-FIXED_POINT_BITS
      (finer than float32's rounding of amax itself).

    amax is taken after the bf16 rounding where that is asked.  A slot
    whose amax is not finite gets some k in range; the kernel adds 0 for
    it and its cells come out NaN.  Runs on amax's device; the CUDA
    wrappers call it between their first pass and the kernel."""
    _, e = torch.frexp(amax)      # amax = m * 2^e, m in [0.5, 1)
    return (FIXED_POINT_BITS - e).clamp_(-126, 126).to(torch.int32)


def active_amax(leaf: torch.Tensor, stats: torch.Tensor, n_leaves: int,
                bf16: bool = False) -> torch.Tensor:
    """Plain version of the first pass: float32 max |stat| per slot over
    the rows with leaf in [0, n_leaves) (after bf16 rounding where
    asked).  Inactive rows' stats (NaN allowed) never reach the max; an
    active NaN does, and marks its slot."""
    act = (leaf >= 0) & (leaf < int(n_leaves))
    s = stats.to(torch.bfloat16).to(torch.float32) if bf16 else stats
    a = torch.where(act[:, None], s.abs(), torch.zeros((), dtype=s.dtype))
    if a.shape[0] == 0:
        return torch.zeros(stats.shape[1], dtype=torch.float32)
    return a.amax(0)


def quantize(stats: torch.Tensor, exps: torch.Tensor) -> torch.Tensor:
    """float32 stats -> int64 fixed point, round half to even, as the
    kernel's ``__float2int_rn(x * 2^k)`` (scaling by 2^k is exact)."""
    return torch.round(stats * torch.exp2(exps.to(torch.float32))).to(
        torch.int64)


def dequantize(sums: torch.Tensor, exps: torch.Tensor) -> torch.Tensor:
    """int64 fixed-point sums -> float32, as the kernel's last pass: one
    rounding to float32, then an exact scaling by 2^-k.  Against the
    exact sum of n quantized stats the result is off by at most
    ``n * 2^(-k-1)`` (the rounding of each stat) plus half a float32 ulp
    of the sum."""
    return sums.to(torch.float32) * torch.exp2(-exps.to(torch.float32))


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
    lib.h2o_hist.argtypes = [I, I, I] + [P] * 11 + [
        ctypes.POINTER(LL), P]
    lib.h2o_hist_amax.argtypes = [P, P, LL, I, I, P, I, P]
    lib.h2o_hist_plan_fields.argtypes = []
    for fn in (lib.h2o_hist, lib.h2o_hist_amax, lib.h2o_hist_plan_fields):
        fn.restype = ctypes.c_int
    if lib.h2o_hist_plan_fields() != _PLAN_FIELDS:
        raise RuntimeError("h2o_tpu_torch: csrc/hist.cu's Plan does not "
                           "match the planner")


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
    if tuple(stats.shape) != (R, 4) or stats.dtype not in _STATS_CODE:
        raise ValueError(f"{what}: stats must be ({R}, 4) float32, int16 "
                         f"or int8, got {tuple(stats.shape)} {stats.dtype}")
    if bf16 and stats.dtype != torch.float32:
        raise ValueError(f"{what}: bf16 rounding applies to float32 stats")
    for name, t in (("bins", bins), ("leaf", leaf), ("stats", stats)):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        # cp.async.bulk copies 16-byte-aligned ranges
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"{what}: {name} must start on a 16-byte "
                             f"boundary")
    if int(n_leaves) < 1 or int(nbins) < 1:
        raise ValueError(f"{what}: n_leaves and nbins must be >= 1")
    if R > MAX_ROWS:
        raise ValueError(f"{what}: at most {MAX_ROWS} rows a launch (the "
                         f"int64 fixed-point sums), got {R}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def _launch(what, bins, leaf, stats, n_leaves, nbins, bf16, adaptive,
            ranges=(None, None, None, None), fine_na=-1) -> torch.Tensor:
    """First pass (float32 stats), the kernel and the last pass, all on
    the current stream with no host sync."""
    R, C = bins.shape
    L, B1 = int(n_leaves), int(nbins) + 1
    dev = bins.device
    lib = build().lib
    with torch.cuda.device(dev):
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = plan_hist(R, C, B1, L, adaptive=adaptive, n_sm=n_sm,
                         bins_itemsize=bins.element_size(),
                         stats_itemsize=stats.element_size())
        stream = torch.cuda.current_stream(dev).cuda_stream
        n = C * B1 * L * 4
        amax = exps = None
        if stats.dtype == torch.float32:
            # the int64 table (CTAs and carries add into it), then 4
            # uint32 max |stat| bits
            acc = torch.zeros(n + 2, dtype=torch.int64, device=dev)
            amax = acc[-2:].view(torch.int32)
            _raise_on(lib.h2o_hist_amax(leaf.data_ptr(), stats.data_ptr(), R,
                                        L, int(bf16), amax.data_ptr(), n_sm,
                                        stream), what)
            exps = fixed_point_exponents(amax.view(torch.float32))
            out = torch.empty((C * B1, L * 4), dtype=torch.float32,
                              device=dev)
        else:
            acc = out = torch.zeros((C * B1, L * 4), dtype=torch.int32,
                                    device=dev)
        ptrs = [t.data_ptr() if t is not None else None
                for t in (bins, leaf, stats, *ranges, amax, exps, acc, out)]
        err = lib.h2o_hist(int(adaptive), _BINS_CODE[bins.dtype],
                           _STATS_CODE[stats.dtype], *ptrs,
                           _plan_array(plan, R, int(nbins), int(fine_na),
                                       bf16), stream)
    _raise_on(err, what)
    return out


def hist_cuda(bins: torch.Tensor, leaf: torch.Tensor, stats: torch.Tensor,
              n_leaves: int, nbins: int, bf16: bool = False) -> torch.Tensor:
    """K1: ``(C*(B+1), L*S)`` table of one device's rows (float32 from
    64-bit fixed point, or an exact int32 table for int16/int8 stats).
    Same contract as ``hist_pallas``: rows with leaf outside [0, L) add
    nothing (their stats are never used); bin B is the NA bucket."""
    _check(bins, leaf, stats, n_leaves, nbins, bf16, "hist_cuda")
    out = _launch("hist_cuda", bins, leaf, stats, n_leaves, nbins, bf16,
                  False)
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
    out = _launch("hist_cuda_adaptive", bins, leaf, stats, n_leaves, nbins,
                  bf16, True, (lo, hi, off, cat), fine_na)
    hist_cuda_adaptive.launches += 1
    return out


hist_cuda.launches = 0
hist_cuda_adaptive.launches = 0


def reset_launches() -> None:
    """Zero both launch counters (before a run whose launches are read)."""
    hist_cuda.launches = 0
    hist_cuda_adaptive.launches = 0
