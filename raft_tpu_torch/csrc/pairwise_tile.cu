// Pairwise distance tile: out[i, j] = metric(x_i, y_j) for the expanded
// metrics l2 (squared), cosine (1 - cos) and inner (-<x, y>).
//
// Replaces raft_tpu/linalg/contractions.py:_pairwise_tile_kernel (:360) and
// _pairwise_tile_kernel_split (:364), launched by _pairwise_padded (:427)
// and _pairwise_padded_split (:377). pairwise_l2_pallas clamps at >= 0 and
// takes the optional root outside the kernel, as the reference does
// (:479-480).
//
// Bound on an H100 SXM: at k = 128 the output dominates. The m x n f32
// matrix is written once (4 bytes per pair) while each pair costs 2k
// products per pass (x3 at tier 'high'), so at the main shape (1M x 1024,
// k = 128) the bytes (4.2 GB, 1.25 ms at 3.35 TB/s) bound it above the
// bf16 tensor-core operations (0.81 ms at 989 TFLOP/s).
// Design: a 2-D grid tiles the output in 128 x 128 blocks; X and Y tiles
// are staged in shared memory 16 deep and each thread accumulates an 8 x 8
// register tile on CUDA-core FMAs (common.cuh), then applies the epilogue
// and writes its 64 outputs. It is CUDA-core bound, far above that bound;
// wgmma with TMA-fed tiles is the later step.

#include "common.cuh"

namespace raft_port {

template <int TIER, int METRIC>
__global__ void __launch_bounds__(THREADS)
    pairwise_tile_kernel(const void* x0, const void* x1, const float* xn,
                         int64_t ldx, const void* y0, const void* y1,
                         const float* yn, int64_t ldy, float* out, int m,
                         int n, int k) {
  __shared__ TileSmem<TIER> s;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[TM][TN];
  cross_tile<TIER>(acc, s, x0, x1, ldx, row0, m, y0, y1, ldy, col0, n, k);
  float yt[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = col0 + sub_index(tx, j);
    yt[j] = c < n ? norm_term<METRIC>(yn, c) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + sub_index(ty, i);
    if (r >= m) continue;
    const float xt = norm_term<METRIC>(xn, r);
    float* orow = out + static_cast<int64_t>(r) * n;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + sub_index(tx, j);
      if (c < n) orow[c] = metric_value<METRIC>(acc[i][j], xt, yt[j]);
    }
  }
}

template <int TIER>
static void launch(int metric, dim3 grid, cudaStream_t st, const void* x0,
                   const void* x1, const float* xn, int64_t ldx,
                   const void* y0, const void* y1, const float* yn,
                   int64_t ldy, float* out, int m, int n, int k) {
  switch (metric) {
    case kMetricL2:
      pairwise_tile_kernel<TIER, kMetricL2><<<grid, THREADS, 0, st>>>(
          x0, x1, xn, ldx, y0, y1, yn, ldy, out, m, n, k);
      break;
    case kMetricCosine:
      pairwise_tile_kernel<TIER, kMetricCosine><<<grid, THREADS, 0, st>>>(
          x0, x1, xn, ldx, y0, y1, yn, ldy, out, m, n, k);
      break;
    default:
      pairwise_tile_kernel<TIER, kMetricInner><<<grid, THREADS, 0, st>>>(
          x0, x1, xn, ldx, y0, y1, yn, ldy, out, m, n, k);
  }
}

}  // namespace raft_port

// Returns the CUDA error of the launch (0 on success).
extern "C" int raft_pairwise_tile(int tier, int metric, const void* x0,
                                  const void* x1, const float* xn,
                                  int64_t ldx, const void* y0,
                                  const void* y1, const float* yn,
                                  int64_t ldy, float* out, int m, int n,
                                  int k, void* stream) {
  using namespace raft_port;
  if (tier < 0 || tier > 2 || metric < 0 || metric > 2 || m < 1 || n < 1 ||
      k < 1 || (n + BN - 1) / BN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tier == kTierDefault)
    launch<kTierDefault>(metric, grid, st, x0, x1, xn, ldx, y0, y1, yn, ldy,
                         out, m, n, k);
  else if (tier == kTierHigh)
    launch<kTierHigh>(metric, grid, st, x0, x1, xn, ldx, y0, y1, yn, ldy,
                      out, m, n, k);
  else
    launch<kTierHighest>(metric, grid, st, x0, x1, xn, ldx, y0, y1, yn, ldy,
                         out, m, n, k);
  return static_cast<int>(cudaGetLastError());
}
