// Shared tile machinery of the port's contraction kernels (pairwise_tile.cu,
// fused_argmin.cu, fused_lloyd.cu, fused_topk.cu, minonly.cu): the operand
// formats of the three precision tiers, the shared-memory staging of X and
// Y tiles, the cross-product tile on CUDA-core FMAs, the distance epilogue
// and the (value, index) order of the argmin.
//
// Operand block, the same in every entry point:
//   x0, x1 : X rows [m, >= k], row stride ldx elements
//   xn     : f32 squared row norms of X [m] (unused for the inner metric)
//   y0, y1 : Y rows [n, >= k], row stride ldy
//   yn     : f32 squared row norms of Y [n]
// Tier 'default' (0): x0/y0 f32, rounded to bf16 (round half to even) as
//   they are staged, products accumulated in f32 — one bf16 pass.
// Tier 'high' (1): x0/y0 the bf16 hi halves, x1/y1 the bf16 lo halves
//   (split outside, as raft_tpu's _split_side does); the cross term is
//   hi*hi + hi*lo + lo*hi. A product of two bf16 values is exact in f32,
//   so these FMAs give the tensor-core bf16x3 numbers up to accumulation
//   order.
// Tier 'highest' (2): x0/y0 f32, f32 FMA.
// Rows >= m, columns >= n and depth >= k are never read (staged as 0), so
// ragged shapes need no padding.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace raft_port {

enum Tier { kTierDefault = 0, kTierHigh = 1, kTierHighest = 2 };
enum Metric { kMetricL2 = 0, kMetricCosine = 1, kMetricInner = 2 };

// Block tile: BM rows of X by BN rows of Y, depth staged BK at a time;
// 256 threads as 16 x 16, each owning an 8 x 8 register tile whose rows
// (and columns) are t*4 + {0..3} and 64 + t*4 + {0..3}, so that a warp's
// shared-memory reads of one k-slice are contiguous (no bank conflicts).
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int THREADS = 256;
constexpr int PAD = 4;   // keeps the transposed staging stores at 2-way

template <int TIER>
struct Halves {
  static constexpr int N = TIER == kTierHigh ? 2 : 1;
};

// 16-byte aligned: the inner loop reads it as float4
template <int TIER>
struct alignas(16) TileSmem {
  float a[Halves<TIER>::N][BK][BM + PAD];
  float b[Halves<TIER>::N][BK][BN + PAD];
};

__device__ __forceinline__ int sub_index(int t, int i) {
  return (i < 4 ? 0 : 64) + t * 4 + (i & 3);
}

__device__ __forceinline__ float bf16_bits_to_float(uint16_t u) {
  return __uint_as_float(static_cast<uint32_t>(u) << 16);
}

__device__ __forceinline__ float round_to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The tier's value(s) of one operand element.
template <int TIER>
__device__ __forceinline__ void load_operand(const void* p0, const void* p1,
                                             int64_t off, float& v0,
                                             float& v1) {
  if constexpr (TIER == kTierHigh) {
    v0 = bf16_bits_to_float(static_cast<const uint16_t*>(p0)[off]);
    v1 = bf16_bits_to_float(static_cast<const uint16_t*>(p1)[off]);
  } else if constexpr (TIER == kTierDefault) {
    v0 = round_to_bf16(static_cast<const float*>(p0)[off]);
  } else {
    v0 = static_cast<const float*>(p0)[off];
  }
}

// Stage rows [row0, row0 + ROWS) x depth [k0, k0 + BK) of an operand into
// shared memory, transposed to [depth][row]; out-of-range elements are 0.
template <int TIER, int ROWS>
__device__ __forceinline__ void stage(
    float (&dst)[Halves<TIER>::N][BK][ROWS + PAD], const void* p0,
    const void* p1, int64_t ld, int row0, int rows, int k0, int k) {
  for (int e = threadIdx.x; e < ROWS * BK; e += THREADS) {
    const int r = e / BK, c = e % BK;
    const int gr = row0 + r, gc = k0 + c;
    float v0 = 0.f, v1 = 0.f;
    if (gr < rows && gc < k)
      load_operand<TIER>(p0, p1, static_cast<int64_t>(gr) * ld + gc, v0, v1);
    dst[0][c][r] = v0;
    if constexpr (Halves<TIER>::N == 2) dst[1][c][r] = v1;
  }
}

__device__ __forceinline__ void load8(float (&v)[8], const float* row,
                                      int t) {
  const float4 lo = *reinterpret_cast<const float4*>(row + t * 4);
  const float4 hi = *reinterpret_cast<const float4*>(row + 64 + t * 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// acc[i][j] = <x row sub_index(ty, i), y row sub_index(tx, j)> over depth
// k for the block tile at (row0, col0), at the tier's precision. Every
// thread of the block must call it (it synchronises).
template <int TIER>
__device__ __forceinline__ void cross_tile(
    float (&acc)[TM][TN], TileSmem<TIER>& s, const void* x0, const void* x1,
    int64_t ldx, int row0, int m, const void* y0, const void* y1,
    int64_t ldy, int col0, int n, int k) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < k; k0 += BK) {
    stage<TIER, BM>(s.a, x0, x1, ldx, row0, m, k0, k);
    stage<TIER, BN>(s.b, y0, y1, ldy, col0, n, k0, k);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
      load8(a, s.a[0][kk], ty);
      load8(b, s.b[0][kk], tx);
      if constexpr (TIER == kTierHigh) {
        float al[TM], bl[TN];
        load8(al, s.a[1][kk], ty);
        load8(bl, s.b[1][kk], tx);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
            acc[i][j] = fmaf(a[i], bl[j], acc[i][j]);
            acc[i][j] = fmaf(al[i], b[j], acc[i][j]);
          }
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
}

// Per-row factor of the epilogue: the squared norm for l2, its root (with
// the reference's 1e-30 guard) for cosine, nothing for inner.
template <int METRIC>
__device__ __forceinline__ float norm_term(const float* norms, int i) {
  if constexpr (METRIC == kMetricL2) return norms[i];
  if constexpr (METRIC == kMetricCosine) return sqrtf(norms[i] + 1e-30f);
  return 0.f;
}

// The distance of the fused metric menu (raft_tpu contractions._metric_tile
// and _metric_tile_split): l2 squared, cosine 1 - cos, inner -<x, y>.
template <int METRIC>
__device__ __forceinline__ float metric_value(float cross, float xt,
                                              float yt) {
  if constexpr (METRIC == kMetricL2) return (xt - 2.0f * cross) + yt;
  if constexpr (METRIC == kMetricCosine) return 1.0f - cross / (xt * yt);
  return -cross;
}

// Strict order on (value, index) pairs behind every argmin: smaller value
// first, the smaller index on a tie; unless FINITE, a NaN comes before
// every number (NaN is minimal, as XLA's reduce-min makes it). Reducing
// with it in any order gives the global first minimum.
template <bool FINITE>
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  if constexpr (!FINITE) {
    const bool vn = v != v, bn = bv != bv;
    if (vn || bn) return vn && (!bn || i < bi);
  }
  return v < bv || (v == bv && i < bi);
}

// Per-row (min, argmin) of the metric over columns [c_begin, c_end) (c_begin
// a multiple of BN, c_end <= n) for the block's row tile at row0, without
// materialising the tile row: each thread folds its columns tile by tile,
// then the 16 threads sharing a row (one half-warp) combine by shuffles. On
// return every thread holds the results for its rows sub_index(ty, i).
template <int TIER, int METRIC, bool FINITE>
__device__ __forceinline__ void block_argmin_range(
    float (&bv)[TM], int (&bi)[TM], TileSmem<TIER>& s, const void* x0,
    const void* x1, const float* xn, int64_t ldx, int row0, int m,
    const void* y0, const void* y1, const float* yn, int64_t ldy, int n,
    int k, int c_begin, int c_end) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float xt[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + sub_index(ty, i);
    xt[i] = r < m ? norm_term<METRIC>(xn, r) : 0.f;
    bv[i] = __int_as_float(0x7f800000);  // +inf
    bi[i] = 0x7fffffff;
  }
  float acc[TM][TN];
  for (int col0 = c_begin; col0 < c_end; col0 += BN) {
    cross_tile<TIER>(acc, s, x0, x1, ldx, row0, m, y0, y1, ldy, col0, n, k);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + sub_index(tx, j);
      if (c >= n) continue;
      const float yt = norm_term<METRIC>(yn, c);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float d = metric_value<METRIC>(acc[i][j], xt[i], yt);
        if (before<FINITE>(d, c, bv[i], bi[i])) {
          bv[i] = d;
          bi[i] = c;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[i], off);
      if (before<FINITE>(ov, oi, bv[i], bi[i])) {
        bv[i] = ov;
        bi[i] = oi;
      }
    }
}

// block_argmin_range over all n columns.
template <int TIER, int METRIC, bool FINITE>
__device__ __forceinline__ void block_argmin(
    float (&bv)[TM], int (&bi)[TM], TileSmem<TIER>& s, const void* x0,
    const void* x1, const float* xn, int64_t ldx, int row0, int m,
    const void* y0, const void* y1, const float* yn, int64_t ldy, int n,
    int k) {
  block_argmin_range<TIER, METRIC, FINITE>(bv, bi, s, x0, x1, xn, ldx, row0,
                                           m, y0, y1, yn, ldy, n, k, 0, n);
}

}  // namespace raft_port
