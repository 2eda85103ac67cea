// (leaf, column, bin) histogram kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of h2o_tpu/ops/hist_pallas.py:
//   K1  hist_pallas           (body _hist_kernel, :115-151)
//   K2  hist_pallas_adaptive  (body _adaptive_kernel, :154-215), which
//       applies map_buckets (h2o_tpu/ops/histogram.py:152-178) per row.
// Both compute, for one device's rows,
//   out[(c*(B+1) + b) * L*S + l*S + s] = sum_r [bucket(r,c)=b][leaf[r]=l] stats[r,s]
// with S = 4, bin B the NA bucket, and rows whose leaf is < 0 adding
// nothing (their stats are never read: they may hold NaN).
//
// What bounds it: the inputs are read once (R*C packed bins, R leaves,
// R*16 bytes of stats) and the table is tiny, so the floor is memory
// bandwidth; the work itself is a scatter of R*C*S adds into
// data-dependent addresses.  The TPU kernel recast the scatter as a
// one-hot matmul over a sequential grid that read-modify-wrote one VMEM
// block; here CTAs run in no order on 132 SMs, so the design is:
//
//   * grid = (column group x leaf group x bin group, row chunk).  A
//     CTA keeps a private table for its groups in shared memory (the
//     Python planner sizes the groups to a stated shared-memory budget,
//     so no shape is refused) and sweeps its row chunk;
//   * one warp owns a column of the table and takes 32 rows at a time
//     (loading 4 such tiles at once, so one memory latency covers
//     four).  Lanes whose rows hit the same table cell are found with
//     __match_any_sync and add in rounds ordered by lane, i.e. by row.
//     No two threads ever touch a cell at once, so there are no atomics
//     and every cell is summed in row order: the float32 result does
//     not depend on scheduling, and two launches give the same bits;
//   * each CTA writes its partial table to scratch[chunk]; a second
//     kernel sums the chunks in fixed order into the output.
//
// Numeric modes: float32 stats accumulate in float32 (optionally each
// stat first rounded to bf16 with round-to-nearest-even, as the TPU
// kernel's astype(bf16)); int16/int8 stats sign-extend and accumulate
// exactly in int32.  Bins of every packed dtype (uint8/int16/int32) are
// widened in registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// row tiles of 32 whose loads are in flight at once (4 keeps the
// register count low enough for several CTAs per SM on small tables)
constexpr int kTiles = 4;

__device__ __forceinline__ int load_bin(const uint8_t* p, long long i) {
  return static_cast<int>(p[i]);
}
__device__ __forceinline__ int load_bin(const int16_t* p, long long i) {
  return static_cast<int>(p[i]);
}
__device__ __forceinline__ int load_bin(const int32_t* p, long long i) {
  return p[i];
}

__device__ __forceinline__ void load_stats(const float* s, long long r,
                                           int bf16, float v[4]) {
  const float4 q = reinterpret_cast<const float4*>(s)[r];
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  if (bf16) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = __bfloat162float(__float2bfloat16_rn(v[k]));
  }
}
__device__ __forceinline__ void load_stats(const int16_t* s, long long r,
                                           int, int v[4]) {
  const short4 q = reinterpret_cast<const short4*>(s)[r];
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_stats(const int8_t* s, long long r,
                                           int, int v[4]) {
  const char4 q = reinterpret_cast<const char4*>(s)[r];
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void add4(float* cell, const float v[4]) {
  float4 t = *reinterpret_cast<float4*>(cell);
  t.x += v[0]; t.y += v[1]; t.z += v[2]; t.w += v[3];
  *reinterpret_cast<float4*>(cell) = t;
}
__device__ __forceinline__ void add4(int* cell, const int v[4]) {
  int4 t = *reinterpret_cast<int4*>(cell);
  t.x += v[0]; t.y += v[1]; t.z += v[2]; t.w += v[3];
  *reinterpret_cast<int4*>(cell) = t;
}

// floor division for a positive divisor, whatever the numerator's sign
// (the reference's // on arrays)
__device__ __forceinline__ int floor_div(int num, int den) {
  int q = num / den;
  if ((num % den != 0) && (num < 0)) --q;
  return q;
}

struct Plan {
  long long R;          // rows
  long long chunk_rows; // rows per chunk (multiple of 32)
  int C, L, nbins;      // columns, leaves, histogram buckets (B; B+1 with NA)
  int fine_na;          // K2: fine-bin NA sentinel
  int cg, lg, bg;       // group sizes: columns, leaves, bins per CTA
  int ncg, nlg;         // number of column / leaf groups
  int bf16;             // round float32 stats to bf16 before adding
};

// One CTA: table[ncol][nbin][nleaf][4] for its (column, leaf, bin)
// groups over rows [chunk*chunk_rows, ...), written to scratch[chunk].
template <typename BinT, typename StatT, typename AccT, bool ADAPTIVE>
__global__ void hist_partial_kernel(
    const BinT* __restrict__ bins, const int32_t* __restrict__ leaf,
    const StatT* __restrict__ stats, const int32_t* __restrict__ lo,
    const int32_t* __restrict__ hi, const int32_t* __restrict__ off,
    const int32_t* __restrict__ is_cat, AccT* __restrict__ scratch,
    Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int B1 = p.nbins + 1;
  int g = blockIdx.x;
  const int cgi = g % p.ncg;
  g /= p.ncg;
  const int lgi = g % p.nlg;
  const int bgi = g / p.nlg;
  const long long chunk = blockIdx.y;
  const int c0 = cgi * p.cg, l0 = lgi * p.lg, b0 = bgi * p.bg;
  const int ncol = min(p.cg, p.C - c0);
  const int nleaf = min(p.lg, p.L - l0);
  const int nbin = min(p.bg, B1 - b0);
  const int per_col = nbin * nleaf * 4;
  const int tab_n = ncol * per_col;

  AccT* table = reinterpret_cast<AccT*>(smem_raw);
  // adaptive ranges staged behind the table, sized by the plan's maxima
  int32_t* s_lo = reinterpret_cast<int32_t*>(
      table + (long long)p.cg * p.bg * p.lg * 4);
  int32_t* s_hi = s_lo + p.lg * p.cg;
  int32_t* s_off = s_hi + p.lg * p.cg;
  int32_t* s_cat = s_off + p.lg * p.cg;

  const int tid = threadIdx.x, nthr = blockDim.x;
  for (int i = tid; i < tab_n; i += nthr) table[i] = AccT(0);
  if (ADAPTIVE) {
    for (int i = tid; i < nleaf * ncol; i += nthr) {
      const int ll = i / ncol, cc = i % ncol;
      const long long src = (long long)(l0 + ll) * p.C + (c0 + cc);
      s_lo[i] = lo[src];
      s_hi[i] = hi[src];
      s_off[i] = off[src];
    }
    for (int i = tid; i < ncol; i += nthr) s_cat[i] = is_cat[c0 + i];
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const long long r_begin = chunk * p.chunk_rows;
  const long long r_end = min(p.R, r_begin + p.chunk_rows);

  // kTiles row tiles of 32 at a time: their loads are all issued before
  // any of them is used, so one memory latency covers kTiles tiles
  for (long long base = r_begin; base < r_end; base += 32 * kTiles) {
    int ll[kTiles];
#pragma unroll
    for (int u = 0; u < kTiles; ++u) {
      const long long r = base + u * 32 + lane;
      ll[u] = -1;
      if (r < r_end) {
        const int lf = leaf[r];
        // leaf < 0 fails lf >= l0 (l0 >= 0): inactive rows drop out here
        if (lf >= l0 && lf < l0 + nleaf) ll[u] = lf - l0;
      }
    }
    unsigned live = 0u;  // tiles with an active row (warp-uniform)
    AccT v[kTiles][4];
#pragma unroll
    for (int u = 0; u < kTiles; ++u) {
      if (__ballot_sync(kFull, ll[u] >= 0) != 0u) live |= 1u << u;
      if (ll[u] >= 0)  // stats of rows outside this group are never read
        load_stats(stats, base + u * 32 + lane, p.bf16, v[u]);
    }
    if (live == 0u) continue;

    for (int cc = warp; cc < ncol; cc += nwarps) {  // warp-uniform loop
      int bv[kTiles];
#pragma unroll
      for (int u = 0; u < kTiles; ++u)
        bv[u] = ll[u] >= 0
            ? load_bin(bins, (base + u * 32 + lane) * p.C + (c0 + cc)) : 0;
#pragma unroll
      for (int u = 0; u < kTiles; ++u) {  // tiles in row order
        if (((live >> u) & 1u) == 0u) continue;
        int key = -1 - lane;  // distinct negatives never match another lane
        if (ll[u] >= 0) {
          int b = bv[u];
          if (ADAPTIVE) {
            if (b == p.fine_na) {
              b = p.nbins;
            } else if (s_cat[cc] != 0) {
              b = min(b, p.nbins);
            } else {
              const int i = ll[u] * ncol + cc;
              const int lo_ = s_lo[i];
              const int span = max(s_hi[i] - lo_ + 1, 1);
              const int x = min(max(b - lo_, 0), span - 1);
              b = min(max(floor_div(x * p.nbins + s_off[i], span), 0),
                      p.nbins - 1);
            }
          }
          // bins outside [b0, b0+nbin) belong to another CTA (or, beyond
          // B, to no bucket at all, as in the reference's one-hot)
          if (b >= b0 && b - b0 < nbin) key = (b - b0) * nleaf + ll[u];
        }
        const bool mine = key >= 0;
        const unsigned peers = __match_any_sync(kFull, key);
        const int rank = __popc(peers & lt_mask);
        const int rounds = __reduce_max_sync(kFull, mine ? rank + 1 : 0);
        AccT* cell = table + cc * per_col + (mine ? key : 0) * 4;
        for (int k = 0; k < rounds; ++k) {
          if (mine && rank == k) add4(cell, v[u]);
          __syncwarp();
        }
      }
    }
  }
  __syncthreads();

  AccT* dst = scratch + chunk * ((long long)p.C * B1 * p.L * 4);
  for (int i = tid; i < tab_n; i += nthr) {
    const int s = i & 3;
    int t = i >> 2;
    const int ll = t % nleaf;
    t /= nleaf;
    const int bb = t % nbin;
    const int cc = t / nbin;
    dst[((long long)(c0 + cc) * B1 + (b0 + bb)) * p.L * 4 +
        (long long)(l0 + ll) * 4 + s] = table[i];
  }
}

// out[i] = sum_k scratch[k][i], k in fixed order.
template <typename AccT>
__global__ void hist_reduce_kernel(const AccT* __restrict__ scratch,
                                   AccT* __restrict__ out, long long n,
                                   int n_chunks) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    AccT acc = AccT(0);
    for (int k = 0; k < n_chunks; ++k) acc += scratch[(long long)k * n + i];
    out[i] = acc;
  }
}

template <typename BinT, typename StatT, typename AccT, bool ADAPTIVE>
int launch(const void* bins, const void* leaf, const void* stats,
           const void* lo, const void* hi, const void* off,
           const void* is_cat, void* scratch, void* out, const Plan& p,
           int nbg, int n_chunks, int warps, int smem_bytes,
           cudaStream_t stream) {
  auto kern = hist_partial_kernel<BinT, StatT, AccT, ADAPTIVE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  AccT* partial = static_cast<AccT*>(n_chunks > 1 ? scratch : out);
  dim3 grid(p.ncg * p.nlg * nbg, n_chunks);
  kern<<<grid, warps * 32, smem_bytes, stream>>>(
      static_cast<const BinT*>(bins), static_cast<const int32_t*>(leaf),
      static_cast<const StatT*>(stats), static_cast<const int32_t*>(lo),
      static_cast<const int32_t*>(hi), static_cast<const int32_t*>(off),
      static_cast<const int32_t*>(is_cat), partial, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks <= 1) return static_cast<int>(err);
  const long long n = (long long)p.C * (p.nbins + 1) * p.L * 4;
  const long long want = (n + 255) / 256;
  const long long blocks = want < 65535LL ? want : 65535LL;
  hist_reduce_kernel<AccT><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const AccT*>(scratch), static_cast<AccT*>(out), n,
      n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// bins_dtype: 0 uint8, 1 int16, 2 int32.  Unknown codes -> invalid value.
template <typename StatT, typename AccT, bool ADAPTIVE>
int dispatch_bins(int bins_dtype, const void* bins, const void* leaf,
                  const void* stats, const void* lo, const void* hi,
                  const void* off, const void* is_cat, void* scratch,
                  void* out, const Plan& p, int nbg, int n_chunks,
                  int warps, int smem_bytes, cudaStream_t stream) {
  switch (bins_dtype) {
    case 0:
      return launch<uint8_t, StatT, AccT, ADAPTIVE>(
          bins, leaf, stats, lo, hi, off, is_cat, scratch, out, p, nbg,
          n_chunks, warps, smem_bytes, stream);
    case 1:
      return launch<int16_t, StatT, AccT, ADAPTIVE>(
          bins, leaf, stats, lo, hi, off, is_cat, scratch, out, p, nbg,
          n_chunks, warps, smem_bytes, stream);
    case 2:
      return launch<int32_t, StatT, AccT, ADAPTIVE>(
          bins, leaf, stats, lo, hi, off, is_cat, scratch, out, p, nbg,
          n_chunks, warps, smem_bytes, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool ADAPTIVE>
int dispatch_int_stats(int stats_dtype, int bins_dtype, const void* bins,
                       const void* leaf, const void* stats, const void* lo,
                       const void* hi, const void* off, const void* is_cat,
                       void* scratch, void* out, const Plan& p, int nbg,
                       int n_chunks, int warps, int smem_bytes,
                       cudaStream_t stream) {
  // stats_dtype: 0 int16, 1 int8
  if (stats_dtype == 0)
    return dispatch_bins<int16_t, int, ADAPTIVE>(
        bins_dtype, bins, leaf, stats, lo, hi, off, is_cat, scratch, out, p,
        nbg, n_chunks, warps, smem_bytes, stream);
  if (stats_dtype == 1)
    return dispatch_bins<int8_t, int, ADAPTIVE>(
        bins_dtype, bins, leaf, stats, lo, hi, off, is_cat, scratch, out, p,
        nbg, n_chunks, warps, smem_bytes, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

Plan make_plan(long long R, int C, int L, int nbins, int fine_na, int cg,
               int lg, int bg, int ncg, int nlg, long long chunk_rows,
               int bf16) {
  Plan p;
  p.R = R; p.chunk_rows = chunk_rows; p.C = C; p.L = L; p.nbins = nbins;
  p.fine_na = fine_na; p.cg = cg; p.lg = lg; p.bg = bg; p.ncg = ncg;
  p.nlg = nlg; p.bf16 = bf16;
  return p;
}

}  // namespace

// Each launcher returns cudaGetLastError() after its launches (0 = ok).

extern "C" int h2o_hist_f32(
    const void* bins, int bins_dtype, const void* leaf, const void* stats,
    int bf16, void* scratch, void* out, long long R, int C, int L,
    int nbins, int cg, int lg, int bg, int ncg, int nlg, int nbg,
    long long chunk_rows, int n_chunks, int warps, int smem_bytes,
    void* stream) {
  const Plan p = make_plan(R, C, L, nbins, -1, cg, lg, bg, ncg, nlg,
                           chunk_rows, bf16);
  return dispatch_bins<float, float, false>(
      bins_dtype, bins, leaf, stats, nullptr, nullptr, nullptr, nullptr,
      scratch, out, p, nbg, n_chunks, warps, smem_bytes,
      static_cast<cudaStream_t>(stream));
}

extern "C" int h2o_hist_i32(
    const void* bins, int bins_dtype, const void* leaf, const void* stats,
    int stats_dtype, void* scratch, void* out, long long R, int C, int L,
    int nbins, int cg, int lg, int bg, int ncg, int nlg, int nbg,
    long long chunk_rows, int n_chunks, int warps, int smem_bytes,
    void* stream) {
  const Plan p = make_plan(R, C, L, nbins, -1, cg, lg, bg, ncg, nlg,
                           chunk_rows, 0);
  return dispatch_int_stats<false>(
      stats_dtype, bins_dtype, bins, leaf, stats, nullptr, nullptr, nullptr,
      nullptr, scratch, out, p, nbg, n_chunks, warps, smem_bytes,
      static_cast<cudaStream_t>(stream));
}

extern "C" int h2o_hist_adaptive_f32(
    const void* bins, int bins_dtype, const void* leaf, const void* stats,
    const void* lo, const void* hi, const void* off, const void* is_cat,
    int fine_na, int bf16, void* scratch, void* out, long long R, int C,
    int L, int nbins, int cg, int lg, int bg, int ncg, int nlg, int nbg,
    long long chunk_rows, int n_chunks, int warps, int smem_bytes,
    void* stream) {
  const Plan p = make_plan(R, C, L, nbins, fine_na, cg, lg, bg, ncg, nlg,
                           chunk_rows, bf16);
  return dispatch_bins<float, float, true>(
      bins_dtype, bins, leaf, stats, lo, hi, off, is_cat, scratch, out, p,
      nbg, n_chunks, warps, smem_bytes, static_cast<cudaStream_t>(stream));
}

extern "C" int h2o_hist_adaptive_i32(
    const void* bins, int bins_dtype, const void* leaf, const void* stats,
    int stats_dtype, const void* lo, const void* hi, const void* off,
    const void* is_cat, int fine_na, void* scratch, void* out, long long R,
    int C, int L, int nbins, int cg, int lg, int bg, int ncg, int nlg,
    int nbg, long long chunk_rows, int n_chunks, int warps, int smem_bytes,
    void* stream) {
  const Plan p = make_plan(R, C, L, nbins, fine_na, cg, lg, bg, ncg, nlg,
                           chunk_rows, 0);
  return dispatch_int_stats<true>(
      stats_dtype, bins_dtype, bins, leaf, stats, lo, hi, off, is_cat,
      scratch, out, p, nbg, n_chunks, warps, smem_bytes,
      static_cast<cudaStream_t>(stream));
}
