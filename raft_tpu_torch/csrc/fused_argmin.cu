// Fused distance + argmin: per row of X, the (min, first-min argmin) of
// the metric (l2 squared, cosine 1 - cos, inner -<x, y>) against every row
// of Y, never materialising the m x n matrix.
//
// Replaces raft_tpu/linalg/contractions.py:_argmin_resident_kernel (:665),
// _argmin_resident_kernel_split (:672), _argmin_tiled_kernel (:683) and
// _argmin_tiled_kernel_split (:691), with the epilogue.iota_argmin /
// masked_fold rules they inline. The TPU needs a resident and a tiled
// variant because Y must fit VMEM for the first; here one kernel covers
// both, following the resident kernel's rules at every size: a NaN
// distance is minimal (the first NaN column wins), ties go to the smaller
// column, and columns >= n are never candidates. The result is the global
// first minimum under common.cuh's order before<false>, in whatever order
// the pairs are folded.
//
// Bound on an H100 SXM: operations. At the k-means shapes (m = 1M, n = 1024,
// k = 128, tier 'high') the three bf16 passes are 8.1e11 products, 0.81 ms
// at 989 TFLOP/s, against 0.16 ms to read X's bf16 halves at 3.35 TB/s;
// the output is 8 bytes a row.
//
// Design, tiers 'default' and 'high': wgmma_tile.cuh's tensor-core tile
// (bf16, one pass or bf16x3, f32 accumulators) with the argmin on the
// accumulator fragment, as fused_lloyd.cu's argmin does for l2: each
// thread folds the distance of its 32 columns of each of its two rows into
// a running (value, column) under the NaN-minimal order (fold_min<false>),
// the four lanes of a quad combine by two shuffles (quad_argmin<false>).
// The terms are norm_term<METRIC>'s (row_term, col_term below), but for
// cosine, which multiplies by reciprocal roots instead of dividing.
// The walk comes from the shapes alone (contractions._argmin_plan):
// - the row-owning walk where X has enough 128-row tiles to fill the
//   card (the k-means shapes): a block owns whole rows and writes val and
//   idx itself;
// - the split walk where it has few (4096 queries against 2^20 rows): the
//   column tiles are cut into splits, none empty, a block takes (row
//   tile, split) units and writes the unit's partial into a [splits][m]
//   scratch, and a second kernel folds each row's partials in split
//   order under the same order, so a NaN in a later split still wins and
//   the earlier split wins a tie.
// A min under a strict order is exact, so no output depends on the grid,
// the split count or the walk.
// The fold's form, picked by the plan from n (contractions._argmin_plan's
// fold): "flat" (n >= 128) folds a whole tile branch-free, its column
// terms loaded before its product, and only the tile that n cuts in the
// branching form; "branching" (n < 128: the one tile is cut, as at the
// spectral partition's n = 4) reads the terms after the product and
// branches around columns past n, as fused_lloyd.cu's loop does. The
// second form is a kernel of its own because the flat form's kernel,
// with its branch-free path beside the branching one, folds that one
// cut tile 15-30% slower on an H100 (PERF.md).
// Tier 'highest' (no exact f32 tensor-core product) keeps common.cuh's FMA
// block_argmin, one block a 128-row tile.

#include "common.cuh"
#include "wgmma_tile.cuh"

namespace raft_port {

// The fold's terms. Rows: l2 the squared norm, cosine 1 / sqrt(|x|^2 +
// 1e-30) (the reference's guard), inner none. Columns: l2 the squared
// norm, cosine rsqrtf(|y|^2 + 1e-30), inner none. So cosine's distance is
// 1 - cross * xt * yt, two multiplies where metric_value<kMetricCosine>
// divides: a few f32 roundings from the plain version's quotient (within
// its 1e-5 tolerance), and no division an element.
template <int METRIC>
__device__ __forceinline__ float row_term(const float* xn, int r) {
  if constexpr (METRIC == kMetricCosine)
    return 1.0f / norm_term<kMetricCosine>(xn, r);
  return norm_term<METRIC>(xn, r);
}

template <int METRIC>
__device__ __forceinline__ float col_term(const float* yn, int c) {
  if constexpr (METRIC == kMetricCosine) return rsqrtf(yn[c] + 1e-30f);
  return norm_term<METRIC>(yn, c);
}

template <int METRIC>
__device__ __forceinline__ float distance(float cross, float xt, float yt) {
  if constexpr (METRIC == kMetricCosine) return 1.0f - cross * xt * yt;
  return metric_value<METRIC>(cross, xt, yt);
}

// The terms of this thread's 32 fragment columns of a whole tile at col0:
// yt[2 j + e] for column col0 + frag_col(4 j) + e.
template <int METRIC>
__device__ __forceinline__ void tile_terms(float (&yt)[wg::kBN / 4],
                                           int col0, const float* yn) {
#pragma unroll
  for (int b = 0; b < wg::kBN / 4; ++b)
    yt[b] = col_term<METRIC>(yn, col0 + wg::frag_col(4 * (b / 2)) + b % 2);
}

// Whether the branch-free fold takes the tile at col0: a whole tile, in
// the flat form. Only then are its terms loaded before the product.
template <bool FLAT>
__device__ __forceinline__ bool branch_free(int col0, int n) {
  return FLAT && col0 + wg::kBN <= n;
}

// Fold this thread's 32 columns of the tile at col0 (accumulators d) into
// the running (min, argmin) of its rows frag_row(0) (xt0, bv0, bi0) and
// frag_row(0) + 8 (xt1, bv1, bi1), NaN minimal: branch-free on the terms
// yt from tile_terms, or reading them from yn and branching around columns
// past n.
template <int METRIC, bool FLAT>
__device__ __forceinline__ void fold_tile(const float (&d)[wg::kAcc],
                                          const float (&yt)[wg::kBN / 4],
                                          const float* yn, int col0, int n,
                                          float xt0, float xt1, float& bv0,
                                          int& bi0, float& bv1, int& bi1) {
  const bool flat = branch_free<FLAT>(col0, n);
#pragma unroll
  for (int b = 0; b < wg::kBN / 4; ++b) {
    const int j = b / 2, e = b % 2;
    const int c = col0 + wg::frag_col(4 * j) + e;
    if (!flat && c >= n) continue;
    const float y = flat ? yt[b] : col_term<METRIC>(yn, c);
    wg::fold_min<false>(distance<METRIC>(d[4 * j + e], xt0, y), c, bv0,
                        bi0);
    wg::fold_min<false>(distance<METRIC>(d[4 * j + 2 + e], xt1, y), c, bv1,
                        bi1);
  }
}

// The wgmma argmin in walk WALK (wg::kRowWalk: out_v/out_i are val/idx
// [m]; wg::kSplitWalk: the [splits][m] partials), in the flat fold form
// if FLAT, else the branching one.
template <int HALVES, int METRIC, int WALK, bool FLAT>
__global__ void __launch_bounds__(wg::kThreads, 1)
    argmin_wgmma(const uint16_t* x0, const uint16_t* x1, const float* xn,
                 int64_t ldx, const uint16_t* y0, const uint16_t* y1,
                 const float* yn, int64_t ldy, int m, int n, int k, int tps,
                 float* out_v, int* out_i) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  wg::Pipe<HALVES, WALK> pipe(x0, x1, ldx, y0, y1, ldy, m, n, k, smem, tps);
  constexpr bool kSplit = WALK == wg::kSplitWalk;
  const int units = kSplit ? pipe.units : (m + wg::kBM - 1) / wg::kBM;
  const int rl = wg::frag_row(0);         // this thread's rows rl, rl + 8
  float d[wg::kAcc];
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int row0 = kSplit ? pipe.unit_row0(u) : u * wg::kBM;
    const int r0 = row0 + rl, r1 = r0 + 8;
    const float xt0 = r0 < m ? row_term<METRIC>(xn, r0) : 0.f;
    const float xt1 = r1 < m ? row_term<METRIC>(xn, r1) : 0.f;
    float bv0 = __int_as_float(0x7f800000), bv1 = bv0;   // +inf
    int bi0 = 0x7fffffff, bi1 = 0x7fffffff;
    const int ct1 = kSplit ? pipe.unit_end(u) : pipe.tiles_n;
    for (int ct = kSplit ? pipe.unit_first(u) : 0; ct < ct1; ++ct) {
      float yt[wg::kBN / 4];        // in flight while the tensor cores run
      if (branch_free<FLAT>(ct * wg::kBN, n))
        tile_terms<METRIC>(yt, ct * wg::kBN, yn);
      pipe.cross(d);
      fold_tile<METRIC, FLAT>(d, yt, yn, ct * wg::kBN, n, xt0, xt1, bv0,
                              bi0, bv1, bi1);
    }
    wg::quad_argmin<false>(bv0, bi0, bv1, bi1);
    if ((threadIdx.x & 3) == 0) {
      const int64_t base =
          kSplit ? static_cast<int64_t>(pipe.unit_split(u)) * m : 0;
      if (r0 < m) {
        out_v[base + r0] = bv0;
        out_i[base + r0] = bi0;
      }
      if (r1 < m) {
        out_v[base + r1] = bv1;
        out_i[base + r1] = bi1;
      }
    }
  }
  pipe.drain();
}

// Per row: the splits' partials folded in split order under the
// NaN-minimal order, from split 0's.
__global__ void argmin_merge(const float* part_v, const int* part_i,
                             int splits, int m, float* val, int* idx) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= m) return;
  float bv = part_v[r];
  int bi = part_i[r];
  for (int s = 1; s < splits; ++s) {
    const int64_t at = static_cast<int64_t>(s) * m + r;
    wg::fold_min<false>(part_v[at], part_i[at], bv, bi);
  }
  val[r] = bv;
  idx[r] = bi;
}

template <int METRIC>
__global__ void __launch_bounds__(THREADS)
    argmin_fma(const void* x0, const float* xn, int64_t ldx, const void* y0,
               const float* yn, int64_t ldy, float* val, int* idx, int m,
               int n, int k) {
  __shared__ TileSmem<kTierHighest> s;
  const int row0 = blockIdx.x * BM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float bv[TM];
  int bi[TM];
  block_argmin<kTierHighest, METRIC, false>(bv, bi, s, x0, nullptr, xn, ldx,
                                            row0, m, y0, nullptr, yn, ldy, n,
                                            k);
  if (tx != 0) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + sub_index(ty, i);
    if (r < m) {
      val[r] = bv[i];
      idx[r] = bi[i];
    }
  }
}

struct Args {
  const void *x0, *x1;
  const float* xn;
  int64_t ldx;
  const void *y0, *y1;
  const float* yn;
  int64_t ldy;
  int m, n, k;
};

template <int HALVES, int METRIC, int WALK, bool FLAT = true>
static cudaError_t launch_wgmma(const Args& a, int grid, int tps,
                                cudaStream_t st, float* out_v, int* out_i) {
  auto kern = argmin_wgmma<HALVES, METRIC, WALK, FLAT>;
  constexpr int smem = wg::Layout<HALVES>::kRingBytes + 1024;  // + alignment
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, wg::kThreads, smem, st>>>(
      static_cast<const uint16_t*>(a.x0), static_cast<const uint16_t*>(a.x1),
      a.xn, a.ldx, static_cast<const uint16_t*>(a.y0),
      static_cast<const uint16_t*>(a.y1), a.yn, a.ldy, a.m, a.n, a.k, tps,
      out_v, out_i);
  return cudaGetLastError();
}

// The branching form only on the row walk: it serves n < 128, one tile.
template <int HALVES, int METRIC>
static cudaError_t launch_walk(const Args& a, int splits, int flat,
                               int grid, int tps, cudaStream_t st,
                               float* part_v, int* part_i, float* val,
                               int* idx) {
  if (!flat)
    return launch_wgmma<HALVES, METRIC, wg::kRowWalk, false>(a, grid, tps,
                                                             st, val, idx);
  if (splits == 1)
    return launch_wgmma<HALVES, METRIC, wg::kRowWalk>(a, grid, tps, st, val,
                                                      idx);
  const cudaError_t err = launch_wgmma<HALVES, METRIC, wg::kSplitWalk>(
      a, grid, tps, st, part_v, part_i);
  if (err != cudaSuccess) return err;
  argmin_merge<<<(a.m + 255) / 256, 256, 0, st>>>(part_v, part_i, splits,
                                                 a.m, val, idx);
  return cudaGetLastError();
}

template <int HALVES>
static cudaError_t launch_metric(int metric, const Args& a, int splits,
                                 int flat, int grid, int tps,
                                 cudaStream_t st, float* part_v, int* part_i,
                                 float* val, int* idx) {
  if (metric == kMetricL2)
    return launch_walk<HALVES, kMetricL2>(a, splits, flat, grid, tps, st,
                                          part_v, part_i, val, idx);
  if (metric == kMetricCosine)
    return launch_walk<HALVES, kMetricCosine>(a, splits, flat, grid, tps, st,
                                              part_v, part_i, val, idx);
  return launch_walk<HALVES, kMetricInner>(a, splits, flat, grid, tps, st,
                                           part_v, part_i, val, idx);
}

static cudaError_t launch_fma(int metric, const Args& a, cudaStream_t st,
                              float* val, int* idx) {
  const int blocks = (a.m + BM - 1) / BM;
  if (metric == kMetricL2)
    argmin_fma<kMetricL2><<<blocks, THREADS, 0, st>>>(
        a.x0, a.xn, a.ldx, a.y0, a.yn, a.ldy, val, idx, a.m, a.n, a.k);
  else if (metric == kMetricCosine)
    argmin_fma<kMetricCosine><<<blocks, THREADS, 0, st>>>(
        a.x0, a.xn, a.ldx, a.y0, a.yn, a.ldy, val, idx, a.m, a.n, a.k);
  else
    argmin_fma<kMetricInner><<<blocks, THREADS, 0, st>>>(
        a.x0, a.xn, a.ldx, a.y0, a.yn, a.ldy, val, idx, a.m, a.n, a.k);
  return cudaGetLastError();
}

}  // namespace raft_port

// Operands as in common.cuh at tier 'highest' (2), whose FMA grid is one
// block a 128-row tile (splits, flat, grid and the scratch not read); at
// tiers 'default' (0) and 'high' (1) as in wgmma_tile.cuh: bf16 rows (at
// 'high' the hi and lo halves), k, ldx and ldy multiples of 8, 16-byte
// aligned bases, zeros in the padded depth. splits == 1: the row-owning
// walk; splits > 1: the split walk, part_v/part_i f32/int32 scratch
// [splits][m], and splits must equal ceil(n_tiles / ceil(n_tiles /
// splits)) so that no split is empty. flat: 1 the flat fold form, 0 the
// branching one (on the row walk only). grid: the persistent blocks.
// Returns the CUDA error of the launches.
extern "C" int raft_fused_argmin(int tier, int metric, const void* x0,
                                 const void* x1, const float* xn,
                                 int64_t ldx, const void* y0,
                                 const void* y1, const float* yn,
                                 int64_t ldy, int m, int n, int k,
                                 int splits, int flat, int grid,
                                 void* part_v,
                                 void* part_i, float* val, int* idx,
                                 void* stream) {
  using namespace raft_port;
  if (tier < 0 || tier > 2 || metric < 0 || metric > 2 || m < 1 || n < 1 ||
      k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x0, x1, xn, ldx, y0, y1, yn, ldy, m, n, k};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tier == kTierHighest)
    return static_cast<int>(launch_fma(metric, a, st, val, idx));
  const int n_tiles = (n + BN - 1) / BN;
  if (splits < 1 || splits > n_tiles || grid < 1 || flat < 0 || flat > 1 ||
      (!flat && splits != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tps = (n_tiles + splits - 1) / splits;
  const int64_t tiles = static_cast<int64_t>((m + BM - 1) / BM) * n_tiles;
  if ((n_tiles + tps - 1) / tps != splits ||
      (splits > 1 && (part_v == nullptr || part_i == nullptr)) ||
      !wg::operands_ok(tier == kTierHigh, k, ldx, ldy, x0, x1, y0, y1) ||
      2 * tiles >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  const cudaError_t err =
      tier == kTierDefault
          ? launch_metric<1>(metric, a, splits, flat, grid, tps, st, pv, pi,
                             val, idx)
          : launch_metric<2>(metric, a, splits, flat, grid, tps, st, pv, pi,
                             val, idx);
  return static_cast<int>(err);
}
