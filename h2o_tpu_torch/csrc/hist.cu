// (leaf, column, bin) histogram kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of h2o_tpu/ops/hist_pallas.py:
//   K1  hist_pallas           (body _hist_kernel, :115-151)
//   K2  hist_pallas_adaptive  (body _adaptive_kernel, :154-215), which
//       applies map_buckets (h2o_tpu/ops/histogram.py:152-178) per row.
// Both compute, for one device's rows,
//   out[(c*(B+1) + b) * L*S + l*S + s] = sum_r [bucket(r,c)=b][leaf[r]=l] stats[r,s]
// with S = 4, bin B the NA bucket, and rows whose leaf is outside [0, L)
// adding nothing (their stats are never used: they may hold NaN).
//
// What bounds it on an H100: each input byte is read once (R*C packed
// bins, R leaves, 16 bytes of stats per active row) and the table is
// small, so the floor is memory bandwidth; the work itself is a scatter
// of R*C*S adds into data-dependent cells.  The TPU kernel recast the
// scatter as a one-hot matmul over a sequential grid that read-modify-
// wrote one VMEM block; here CTAs run in no order on 132 SMs, and what
// costs the time is the shared-memory atomics each (row, column) item
// issues and how often each row is streamed again (once per group of
// columns whose table fits one CTA).  The design, and what it does about
// each cost:
//
//   * order-free integer sums, one 32-bit word per stat.  Every table
//     word only receives shared-memory atomicAdds, which wrap mod 2^32,
//     so the table has the same bits for any order of rows, warps or CTAs
//     and any permutation of the rows.  int16/int8 stats: the stat itself
//     (exact, wrapping like the reference's int32).  float32 stats: fixed
//     point.  A first pass (hist_amax_kernel) finds max|stat| per slot
//     over the active rows; the wrapper turns it into a power-of-two
//     scale 2^k per slot (hist_kernels.fixed_point_exponents: the largest
//     k with max * 2^k < 2^26), and each stat, after the optional bf16
//     rounding, becomes q = round(stat * 2^k), |q| <= 2^26.  q goes into
//     its cell's 32-bit word, which starts at 2^31, by an atomicAdd that
//     returns the old word; when the word wraps (a carry for q >= 0, a
//     borrow for q < 0: at most one add in 2^(32-26) = 64 even when every
//     row sits at the max, and none while a CTA's partial sum stays
//     within 2^31 of zero) the thread adds +-2^32 to the cell's int64 in
//     the global table (red.global.add).  At the merge the word less 2^31
//     joins that int64, which then holds the exact 64-bit sum whatever
//     the order.  A 64-bit shared-memory atomicAdd compiles to a compare-
//     and-swap loop on Hopper, and a split of q into two words that never
//     carry needs two atomics a stat and cells twice as wide (twice the
//     column groups); this scheme costs one atomic a stat, as the integer
//     modes do.  A slot whose max is not finite (an active row with a NaN
//     or inf stat) comes out NaN.
//   * the table is stored as 4 planes, one per stat, so the lanes of a
//     warp, hitting random cells, hit random banks.
//   * every warp works on the CTA's whole column group: item (row, col)
//     of a staged tile goes to any consumer thread, so residency is set
//     by shared memory and registers, not by the number of columns.
//   * row tiles are staged into shared memory by cp.async.bulk (TMA's
//     1-D copy, no tensor map): the bins, leaves and stats of T rows are
//     three contiguous 16-byte-aligned ranges, in place of strided loads
//     of a few bytes and a leaf -> bins -> stats chain of dependent
//     loads.  One producer thread keeps a ring of 2-4 stages in flight on
//     mbarriers; each consumer warp hands a stage back on its own.  The
//     planner gives the ring the most bytes that the table's room allows
//     (up to 96 KB a CTA): with too few bytes in flight the stream waits
//     on the copies' latency.  The ragged last tile (and every tile of a
//     shape whose rows are too wide to stage) is read straight from
//     global memory.
//   * CTAs merge into one int64/int32 table with red.global.add (order-
//     free) and a last pass writes float32 from the fixed point (int
//     stats: the int32 table is the output).
//
// grid = (column group x leaf group x bin group, row chunk), sized by the
// Python planner (ops/hist_kernels.py plan_hist) so a CTA's shared memory
// fits; no shape is refused.  Bins of every packed dtype (uint8/int16/
// int32) are widened in registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxStages = 4;

// -- PTX helpers: mbarrier and the 1-D bulk copy -----------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\n"
      "bra.uni LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// bytes: a multiple of 16; src and dst 16-byte aligned
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

// -- loads, fixed point and adds --------------------------------------------

__device__ __forceinline__ int load_bin(const uint8_t* p, long long i) {
  return static_cast<int>(p[i]);
}
__device__ __forceinline__ int load_bin(const int16_t* p, long long i) {
  return static_cast<int>(p[i]);
}
__device__ __forceinline__ int load_bin(const int32_t* p, long long i) {
  return p[i];
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The global table one launch merges into: int64 fixed point for float32
// stats, int32 for int16/int8 stats; and the value a table word starts
// at.  A float32 word starts mid-range, 2^31, so a CTA's partial sum,
// which for a signed stat wanders around zero, crosses no wrap until it
// has moved 2^31 either way (from 0 it would wrap at each crossing).
template <typename StatT> struct Mode {
  using Global = int;
  static constexpr uint32_t kWord0 = 0u;
};
template <> struct Mode<float> {
  using Global = unsigned long long;
  static constexpr uint32_t kWord0 = 0x80000000u;
};

// One row's stats as the four words it adds to its cells.  float32: q =
// round(stat * 2^k), half to even (the scaling is exact; a slot whose max
// is not finite has scale 0, so its words are 0).  int16/int8: the stats
// sign-extended.
__device__ __forceinline__ void row_words(const float* s, int r, int bf16,
                                          const float* scale, int w[4]) {
  const float4 v = reinterpret_cast<const float4*>(s)[r];
  const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float x = bf16 ? round_bf16(f[k]) : f[k];
    w[k] = __float2int_rn(x * scale[k]);
  }
}
__device__ __forceinline__ void row_words(const int16_t* s, int r, int,
                                          const float*, int w[4]) {
  const short4 v = reinterpret_cast<const short4*>(s)[r];
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void row_words(const int8_t* s, int r, int,
                                          const float*, int w[4]) {
  const char4 v = reinterpret_cast<const char4*>(s)[r];
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}

// floor(n / span) for span >= 1 and any sign of n (the reference's // on
// arrays): a float reciprocal, then one correction step either way
__device__ __forceinline__ int floor_div(int n, int span, float rcp) {
  if (n > -(1 << 22) && n < (1 << 22)) {
    int q = __float2int_rd(__int2float_rn(n) * rcp);
    const int r = n - q * span;
    if (r < 0) --q;
    else if (r >= span) ++q;
    return q;
  }
  int q = n / span;
  if ((n % span != 0) && (n < 0)) --q;
  return q;
}

struct Plan {
  long long R;           // rows
  long long chunk_rows;  // rows per chunk (a multiple of tile_rows, or 32)
  int C, L, nbins;       // columns, leaves, histogram buckets (B; B+1 with NA)
  int fine_na;           // K2: fine-bin NA sentinel
  int cg, lg, bg;        // group sizes: columns, leaves, bins per CTA
  int ncg, nlg, nbg;     // number of column / leaf / bin groups
  int n_chunks;
  int tile_rows;         // rows per staged tile; 0: nothing is staged
  int stages;            // ring depth (<= kMaxStages)
  int warps;             // warps per CTA (the last one produces if staged)
  int ring_off, ranges_off, table_off, smem_bytes;  // shared-memory layout
  int bf16;              // round float32 stats to bf16 before the sum
};

// What one CTA needs to add one (row, column) item into its table.  The
// table is 4 planes of nbin*nleaf*ncol cells, cell (bb, ll, col) at
// (bb*nleaf + ll)*ncol + col, and stat s of a cell at table[s*plane +
// cell].  The column is the fastest index: the lanes of a warp that take
// one row's columns share its leaf and land in distinct banks.  dst is
// the global table the CTA merges into (and, for float32 stats, where its
// carries go).
template <typename StatT, bool ADAPTIVE>
struct Ctx {
  uint32_t* table;
  typename Mode<StatT>::Global* dst;
  int plane;
  const int4* s_rng;  // per (leaf, col): lo, span (0: categorical), off, 1/span
  const float* scale;
  int C, L, B1, c0, l0, b0, ncol, nleaf, nbin, nbins, fine_na, bf16;
};

// The CTA's table cell of (row, col) with local leaf ll, or -1 when the
// row's bucket lies outside the CTA's bin group.
template <typename BinT, typename StatT, bool ADAPTIVE>
__device__ __forceinline__ int item_cell(const Ctx<StatT, ADAPTIVE>& x,
                                         const BinT* bins, int row, int col,
                                         int ll) {
  int b = load_bin(bins, static_cast<long long>(row) * x.C + x.c0 + col);
  if (ADAPTIVE) {
    if (b == x.fine_na) {
      b = x.nbins;
    } else {
      const int4 g = x.s_rng[ll * x.ncol + col];  // one 16-byte load
      if (g.y == 0) {                             // categorical
        b = min(b, x.nbins);
      } else {
        const int xx = min(max(b - g.x, 0), g.y - 1);
        b = min(max(floor_div(xx * x.nbins + g.z, g.y, __int_as_float(g.w)),
                    0), x.nbins - 1);
      }
    }
  }
  // bins outside [b0, b0+nbin) belong to another CTA (or, beyond B, to no
  // bucket at all, as in the reference's one-hot)
  const int bb = b - x.b0;
  if (static_cast<unsigned>(bb) >= static_cast<unsigned>(x.nbin)) return -1;
  return (bb * x.nleaf + ll) * x.ncol + col;
}

// index of stat 0 of the CTA's cell (bb, ll, cc) in the global table:
// ((c*(B+1) + b) * L + l) * 4
template <typename StatT, bool ADAPTIVE>
__device__ __forceinline__ long long out_index(
    const Ctx<StatT, ADAPTIVE>& x, int bb, int ll, int cc) {
  return (((long long)(x.c0 + cc) * x.B1 + (x.b0 + bb)) * x.L +
          (x.l0 + ll)) * 4;
}
// the same, of a CTA cell given by its index
template <typename StatT, bool ADAPTIVE>
__device__ __forceinline__ long long out_index(
    const Ctx<StatT, ADAPTIVE>& x, int cell) {
  const int t = cell / x.ncol;
  return out_index(x, t / x.nleaf, t % x.nleaf, cell % x.ncol);
}

// float32: each stat's 32-bit word by an atomicAdd that returns the old
// word, then, behind one branch an item, +-2^32 to the global int64 where
// a word wrapped (rare: |q| <= 2^26 and the word starts mid-range)
template <bool ADAPTIVE>
__device__ __forceinline__ void cell_add(const Ctx<float, ADAPTIVE>& x,
                                         int cell, const int w[4]) {
  uint32_t old[4];
#pragma unroll
  for (int s = 0; s < 4; ++s)
    old[s] = atomicAdd(x.table + s * x.plane + cell,
                       static_cast<uint32_t>(w[s]));
  uint32_t wrapped = 0u;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint32_t now = old[s] + static_cast<uint32_t>(w[s]);
    wrapped |= static_cast<uint32_t>(w[s] >= 0 ? now < old[s] : now > old[s])
               << s;
  }
  if (wrapped != 0u) {
    unsigned long long* dst = x.dst + out_index(x, cell);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (wrapped & (1u << s))
        atomicAdd(dst + s, w[s] >= 0 ? 0x100000000ull : 0xffffffff00000000ull);
    }
  }
}
// int16/int8: each stat's int32 word, wrapping like the reference's int32
template <typename StatT, bool ADAPTIVE>
__device__ __forceinline__ void cell_add(const Ctx<StatT, ADAPTIVE>& x,
                                         int cell, const int w[4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
    atomicAdd(x.table + s * x.plane + cell, static_cast<uint32_t>(w[s]));
}

// Items (row, col) of rows [0, nrows), straight from a staged tile or from
// global memory (the ragged last tile, or every row when rows are not
// staged).  Thread `t` of `nthr` takes items t, t+nthr, ... in (row, col)
// order, col fastest, so the lanes of a warp spread over several columns
// and rarely hit one cell together.  Each item tests its row's leaf (a
// leaf outside the CTA's group, or < 0, fails the unsigned compare before
// the row's stats are read) and converts its row's stats itself.
template <typename BinT, typename StatT, bool ADAPTIVE>
__device__ __forceinline__ void add_rows(
    const Ctx<StatT, ADAPTIVE>& x, const BinT* bins, const int32_t* leaf,
    const StatT* stats, int nrows, int t, int nthr) {
  const int dr = nthr / x.ncol, dc = nthr - dr * x.ncol;
  int row = t / x.ncol, col = t - row * x.ncol;
  while (row < nrows) {
    const int ll = leaf[row] - x.l0;
    if (static_cast<unsigned>(ll) < static_cast<unsigned>(x.nleaf)) {
      const int cell = item_cell<BinT, StatT, ADAPTIVE>(x, bins, row, col,
                                                        ll);
      if (cell >= 0) {
        int w[4];
        row_words(stats, row, x.bf16, x.scale, w);
        cell_add(x, cell, w);
      }
    }
    row += dr;
    col += dc;
    if (col >= x.ncol) { col -= x.ncol; ++row; }
  }
}

// a table word as its global addend: less its start 2^31, into the
// int64 fixed point (the carries hold the rest), or the int32 as it stands
__device__ __forceinline__ void red_add(unsigned long long* p, uint32_t v) {
  atomicAdd(p, static_cast<unsigned long long>(static_cast<long long>(v) -
                                               0x80000000LL));
}
__device__ __forceinline__ void red_add(int* p, uint32_t v) {
  atomicAdd(p, static_cast<int>(v));
}

// One CTA: its (column, leaf, bin) groups' table over the rows of chunk
// blockIdx.y, merged into acc by red.global.add.
template <typename BinT, typename StatT, bool ADAPTIVE>
__global__ void __launch_bounds__(1024)
hist_kernel(const BinT* __restrict__ bins, const int32_t* __restrict__ leaf,
            const StatT* __restrict__ stats, const int32_t* __restrict__ lo,
            const int32_t* __restrict__ hi, const int32_t* __restrict__ off,
            const int32_t* __restrict__ is_cat,
            const uint32_t* __restrict__ amax,
            const int32_t* __restrict__ exps,
            typename Mode<StatT>::Global* __restrict__ acc, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B1 = p.nbins + 1;
  int g = blockIdx.x;
  const int cgi = g % p.ncg;
  g /= p.ncg;
  const int lgi = g % p.nlg;
  const int bgi = g / p.nlg;
  const long long chunk = blockIdx.y;

  Ctx<StatT, ADAPTIVE> x;
  x.C = p.C; x.L = p.L; x.B1 = B1; x.nbins = p.nbins; x.fine_na = p.fine_na;
  x.bf16 = p.bf16;
  x.c0 = cgi * p.cg; x.l0 = lgi * p.lg; x.b0 = bgi * p.bg;
  x.ncol = min(p.cg, p.C - x.c0);
  x.nleaf = min(p.lg, p.L - x.l0);
  x.nbin = min(p.bg, B1 - x.b0);
  x.plane = x.ncol * x.nbin * x.nleaf;
  x.dst = acc;

  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  float* scale = reinterpret_cast<float*>(smem + 16 * kMaxStages);
  int4* s_rng = reinterpret_cast<int4*>(smem + p.ranges_off);
  x.table = reinterpret_cast<uint32_t*>(smem + p.table_off);
  x.s_rng = s_rng; x.scale = scale;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const bool staged = p.tile_rows > 0;
  const int n_cons = staged ? nthr - 32 : nthr;  // consumer threads

  {
    constexpr uint32_t w0 = Mode<StatT>::kWord0;
    uint4* t4 = reinterpret_cast<uint4*>(x.table);
    const int n4 = x.plane;  // 4 words a cell
    for (int i = tid; i < n4; i += nthr) t4[i] = make_uint4(w0, w0, w0, w0);
  }
  if (ADAPTIVE) {
    for (int i = tid; i < x.nleaf * x.ncol; i += nthr) {
      const int ll = i / x.ncol, cc = i % x.ncol;
      const long long src = (long long)(x.l0 + ll) * p.C + (x.c0 + cc);
      const int span = max(hi[src] - lo[src] + 1, 1);
      s_rng[i] = make_int4(lo[src], is_cat[x.c0 + cc] != 0 ? 0 : span,
                           off[src],
                           __float_as_int(1.0f / static_cast<float>(span)));
    }
  }
  if (tid < 4) {
    // 2^k as a float32 (k in [-126, 126], see fixed_point_exponents); 0
    // for a slot whose max is not finite (its output is NaN)
    scale[tid] = exps == nullptr ? 1.0f
                 : amax[tid] >= 0x7f800000u
                     ? 0.0f
                     : __int_as_float((exps[tid] + 127) << 23);
  }
  if (staged && tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, n_cons / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long r_begin = chunk * p.chunk_rows;
  const long long r_end = min(p.R, r_begin + p.chunk_rows);
  long long tail = r_begin;
  if (staged) {
    const int T = p.tile_rows;
    const long long n_tiles = (r_end - r_begin) / T;
    tail = r_begin + n_tiles * T;
    const uint32_t bin_bytes = T * p.C * sizeof(BinT);
    const uint32_t stat_bytes = T * 4 * sizeof(StatT);
    const uint32_t stage_bytes = bin_bytes + T * 4 + stat_bytes;
    unsigned char* ring = smem + p.ring_off;
    if (tid >= n_cons) {
      if (tid == n_cons) {  // the producer: one elected thread
        for (long long i = 0; i < n_tiles; ++i) {
          const int s = static_cast<int>(i % p.stages);
          const long long round = i / p.stages;
          if (round > 0) mbar_wait(empty + s, (round - 1) & 1);
          unsigned char* st = ring + s * stage_bytes;
          const long long r0 = r_begin + i * T;
          mbar_arrive_expect_tx(full + s, stage_bytes);
          bulk_copy(st, bins + r0 * p.C, bin_bytes, full + s);
          bulk_copy(st + bin_bytes, leaf + r0, T * 4, full + s);
          bulk_copy(st + bin_bytes + T * 4, stats + r0 * 4, stat_bytes,
                    full + s);
        }
      }
    } else {
      // every warp takes its share of each tile's (row, col) items and
      // hands the stage back on its own: no barrier across warps
      for (long long i = 0; i < n_tiles; ++i) {
        const int s = static_cast<int>(i % p.stages);
        mbar_wait(full + s, (i / p.stages) & 1);
        const unsigned char* st = ring + s * stage_bytes;
        add_rows<BinT, StatT, ADAPTIVE>(
            x, reinterpret_cast<const BinT*>(st),
            reinterpret_cast<const int32_t*>(st + bin_bytes),
            reinterpret_cast<const StatT*>(st + bin_bytes + T * 4), T, tid,
            n_cons);
        __syncwarp();
        if ((tid & 31) == 0) mbar_arrive(empty + s);
      }
    }
  }
  // the ragged last tile, or the whole chunk when rows are not staged
  if (tid < n_cons && tail < r_end)
    add_rows<BinT, StatT, ADAPTIVE>(x, bins + tail * p.C, leaf + tail,
                                    stats + tail * 4,
                                    static_cast<int>(r_end - tail), tid,
                                    n_cons);
  __syncthreads();

  // merge: thread tid takes stat s = tid % 4 of cells tid/4, tid/4 +
  // step, ...; it steps the cell's (bb, ll, cc) by carries, with no
  // division a word
  {
    const int s = tid & 3, step = nthr >> 2;
    int cell = tid >> 2;
    int cc = cell % x.ncol, t = cell / x.ncol;
    int ll = t % x.nleaf, bb = t / x.nleaf;
    const int dcc = step % x.ncol, dt = step / x.ncol;
    const int dll = dt % x.nleaf, dbb = dt / x.nleaf;
    for (; cell < x.plane; cell += step) {
      const uint32_t v = x.table[s * x.plane + cell];
      if (v != Mode<StatT>::kWord0)
        red_add(x.dst + out_index(x, bb, ll, cc) + s, v);
      cc += dcc;
      const int c1 = cc >= x.ncol;
      if (c1) cc -= x.ncol;
      ll += dll + c1;
      const int c2 = ll >= x.nleaf;
      if (c2) ll -= x.nleaf;
      bb += dbb + c2;
    }
  }
}

// float32 mode, last pass: out[i] = acc[i] * 2^-k[s], or NaN for a slot
// whose max |stat| was not finite.
__global__ void hist_finish_f32(const unsigned long long* __restrict__ acc,
                                long long n,
                                const uint32_t* __restrict__ amax,
                                const int32_t* __restrict__ exps,
                                float* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const unsigned long long v = acc[i];
    const int s = static_cast<int>(i & 3);
    out[i] = amax[s] >= 0x7f800000u
                 ? __int_as_float(0x7fc00000)
                 : ldexpf(__ll2float_rn(static_cast<long long>(v)),
                          -exps[s]);
  }
}

// First pass of float32 mode: amax[s] = bits of max |stat[r, s]| over rows
// with leaf in [0, L) (after the bf16 rounding where asked).  Non-negative
// floats order as their bits, and NaN's bits exceed inf's, so a NaN stat
// wins the max and marks its slot.  A thread takes kRows rows, their
// leaves first and then the active rows' stats, so its loads are in
// flight together; a block reduces in shared memory and adds one
// atomicMax a slot.
constexpr int kAmaxThreads = 256;
constexpr int kAmaxRows = 4;

__global__ void __launch_bounds__(kAmaxThreads)
hist_amax_kernel(const int32_t* __restrict__ leaf,
                 const float* __restrict__ stats, long long R, int L,
                 int bf16, uint32_t* __restrict__ amax) {
  __shared__ uint32_t s_max[4];
  if (threadIdx.x < 4) s_max[threadIdx.x] = 0u;
  __syncthreads();
  uint32_t m[4] = {0u, 0u, 0u, 0u};
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r0 < R; r0 += kAmaxRows * stride) {
    bool act[kAmaxRows];
#pragma unroll
    for (int u = 0; u < kAmaxRows; ++u) {
      const long long r = r0 + u * stride;
      act[u] = r < R && static_cast<unsigned>(leaf[r]) <
                            static_cast<unsigned>(L);
    }
#pragma unroll
    for (int u = 0; u < kAmaxRows; ++u) {
      if (!act[u]) continue;
      const float4 q = reinterpret_cast<const float4*>(stats)[r0 + u * stride];
      const float f[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float v = bf16 ? round_bf16(f[k]) : f[k];
        m[k] = max(m[k], __float_as_uint(fabsf(v)));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m[k] = max(m[k], __shfl_xor_sync(0xffffffffu, m[k], o));
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (m[k] != 0u) atomicMax(s_max + k, m[k]);
  }
  __syncthreads();
  if (threadIdx.x < 4 && s_max[threadIdx.x] != 0u)
    atomicMax(amax + threadIdx.x, s_max[threadIdx.x]);
}

int grid_for(long long n, int threads) {
  const long long want = (n + threads - 1) / threads;
  return static_cast<int>(want < 4096 ? (want > 0 ? want : 1) : 4096);
}

template <typename BinT, typename StatT, bool ADAPTIVE>
int launch(const void* bins, const void* leaf, const void* stats,
           const void* lo, const void* hi, const void* off,
           const void* is_cat, const void* amax, const void* exps,
           void* acc, void* out, const Plan& p, cudaStream_t stream) {
  using Global = typename Mode<StatT>::Global;
  auto kern = hist_kernel<BinT, StatT, ADAPTIVE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(p.ncg * p.nlg * p.nbg, p.n_chunks);
  kern<<<grid, p.warps * 32, p.smem_bytes, stream>>>(
      static_cast<const BinT*>(bins), static_cast<const int32_t*>(leaf),
      static_cast<const StatT*>(stats), static_cast<const int32_t*>(lo),
      static_cast<const int32_t*>(hi), static_cast<const int32_t*>(off),
      static_cast<const int32_t*>(is_cat),
      static_cast<const uint32_t*>(amax), static_cast<const int32_t*>(exps),
      static_cast<Global*>(acc), p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = (long long)p.C * (p.nbins + 1) * p.L * 4;
  if (sizeof(Global) == 8) {
    hist_finish_f32<<<grid_for(n, 256), 256, 0, stream>>>(
        static_cast<const unsigned long long*>(acc), n,
        static_cast<const uint32_t*>(amax),
        static_cast<const int32_t*>(exps), static_cast<float*>(out));
  }  // else acc is out: red.global.add summed into it
  return static_cast<int>(cudaGetLastError());
}

template <typename StatT, bool ADAPTIVE>
int dispatch_bins(int bins_dtype, const void* bins, const void* leaf,
                  const void* stats, const void* lo, const void* hi,
                  const void* off, const void* is_cat, const void* amax,
                  const void* exps, void* acc, void* out, const Plan& p,
                  cudaStream_t stream) {
  switch (bins_dtype) {
    case 0:
      return launch<uint8_t, StatT, ADAPTIVE>(bins, leaf, stats, lo, hi, off,
                                              is_cat, amax, exps, acc, out, p,
                                              stream);
    case 1:
      return launch<int16_t, StatT, ADAPTIVE>(bins, leaf, stats, lo, hi, off,
                                              is_cat, amax, exps, acc, out, p,
                                              stream);
    case 2:
      return launch<int32_t, StatT, ADAPTIVE>(bins, leaf, stats, lo, hi, off,
                                              is_cat, amax, exps, acc, out, p,
                                              stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool ADAPTIVE>
int dispatch_stats(int stats_dtype, int bins_dtype, const void* bins,
                   const void* leaf, const void* stats, const void* lo,
                   const void* hi, const void* off, const void* is_cat,
                   const void* amax, const void* exps, void* acc, void* out,
                   const Plan& p, cudaStream_t stream) {
  switch (stats_dtype) {  // 0 float32, 1 int16, 2 int8
    case 0:
      return dispatch_bins<float, ADAPTIVE>(bins_dtype, bins, leaf, stats, lo,
                                            hi, off, is_cat, amax, exps, acc,
                                            out, p, stream);
    case 1:
      return dispatch_bins<int16_t, ADAPTIVE>(bins_dtype, bins, leaf, stats,
                                              lo, hi, off, is_cat, amax, exps,
                                              acc, out, p, stream);
    case 2:
      return dispatch_bins<int8_t, ADAPTIVE>(bins_dtype, bins, leaf, stats,
                                             lo, hi, off, is_cat, amax, exps,
                                             acc, out, p, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Each entry returns cudaGetLastError() after its launches (0 = ok).

// plan: the Plan's fields in declaration order, as 64-bit integers, then
// their count (kPlanFields values; the Python planner builds the array).
constexpr int kPlanFields = 22;

extern "C" int h2o_hist_plan_fields() { return kPlanFields; }

extern "C" int h2o_hist(int adaptive, int bins_dtype, int stats_dtype,
                        const void* bins, const void* leaf, const void* stats,
                        const void* lo, const void* hi, const void* off,
                        const void* is_cat, const void* amax,
                        const void* exps, void* acc, void* out,
                        const long long* plan, void* stream) {
  const long long* f = plan;
  Plan p;
  p.R = f[0]; p.chunk_rows = f[1];
  p.C = (int)f[2]; p.L = (int)f[3]; p.nbins = (int)f[4];
  p.fine_na = (int)f[5];
  p.cg = (int)f[6]; p.lg = (int)f[7]; p.bg = (int)f[8];
  p.ncg = (int)f[9]; p.nlg = (int)f[10]; p.nbg = (int)f[11];
  p.n_chunks = (int)f[12]; p.tile_rows = (int)f[13]; p.stages = (int)f[14];
  p.warps = (int)f[15];
  p.ring_off = (int)f[16]; p.ranges_off = (int)f[17];
  p.table_off = (int)f[18]; p.smem_bytes = (int)f[19];
  p.bf16 = (int)f[20];
  if (f[21] != kPlanFields || p.stages > kMaxStages || p.warps < 1 ||
      p.warps > 32 || (p.tile_rows > 0 && p.warps < 2) ||
      (stats_dtype == 0 && (amax == nullptr || exps == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (adaptive)
    return dispatch_stats<true>(stats_dtype, bins_dtype, bins, leaf, stats,
                                lo, hi, off, is_cat, amax, exps, acc, out, p,
                                st);
  return dispatch_stats<false>(stats_dtype, bins_dtype, bins, leaf, stats, lo,
                               hi, off, is_cat, amax, exps, acc, out, p, st);
}

extern "C" int h2o_hist_amax(const void* leaf, const void* stats,
                             long long R, int L, int bf16, void* amax,
                             int n_sm, void* stream) {
  // one pass of kAmaxRows rows a thread where 16 blocks an SM allow it
  const long long want =
      (R + kAmaxThreads * kAmaxRows - 1) / (kAmaxThreads * kAmaxRows);
  const long long cap = 16LL * n_sm;
  const int blocks = static_cast<int>(want < cap ? (want > 0 ? want : 1)
                                                 : cap);
  hist_amax_kernel<<<blocks, kAmaxThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(leaf), static_cast<const float*>(stats), R,
      L, bf16, static_cast<uint32_t*>(amax));
  return static_cast<int>(cudaGetLastError());
}
