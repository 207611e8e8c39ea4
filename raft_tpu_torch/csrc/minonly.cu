// The 1-NN floor probe: per query row of X, the smallest squared L2
// distance to the rows of Y and the first column reaching it, at the fused
// top-k kernel's grid and distance tile. A NaN distance never wins; a row
// with no finite candidate gets (+inf, 0).
//
// Replaces raft_tpu/neighbors/fused_topk.py:_minonly_kernel (:195) and
// _minonly_kernel_split (:202), launched from _minonly_probe (:212) at
// :237 and :252: the fused kernel's distance tile with a running min fold
// in place of the sorted insertion. It exists to price the selection: the
// gap between this kernel and fused_topk.cu at the same shape and tier is
// what the insertion costs.
//
// Bound on an H100 SXM: operations, the same products as fused_topk.cu (at
// the kNN shape, 4096 x 2^20 x 128 at tier 'high', 3.3 ms at 989 TFLOP/s).
// Design: the same grid as fused_topk.cu (query tiles of 128 by database
// splits, the split count chosen by the same rule) and the same distance
// tile (common.cuh's cross_tile), each block folding its split's columns
// into per-row (min, first argmin) with block_argmin_range; a second kernel
// folds each row's split results in split order with a strict <, so the
// earlier split, and with it the smaller column, wins ties. A min is exact,
// so the result does not depend on the split count.

#include "common.cuh"

namespace raft_port {

template <int TIER>
__global__ void __launch_bounds__(THREADS)
    minonly_split_kernel(const void* x0, const void* x1, const float* xn,
                         int64_t ldx, const void* y0, const void* y1,
                         const float* yn, int64_t ldy, int m, int n, int k,
                         int tiles_per_split, float* part_v, int* part_i) {
  __shared__ TileSmem<TIER> s;
  const int row0 = blockIdx.x * BM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int c_begin = blockIdx.y * tiles_per_split * BN;
  const int c_end = min(n, c_begin + tiles_per_split * BN);
  float bv[TM];
  int bi[TM];
  block_argmin_range<TIER, kMetricL2, true>(bv, bi, s, x0, x1, xn, ldx, row0,
                                            m, y0, y1, yn, ldy, n, k, c_begin,
                                            c_end);
  if (tx != 0) return;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * m;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + sub_index(ty, i);
    if (r < m) {
      part_v[base + r] = bv[i];
      part_i[base + r] = bi[i];
    }
  }
}

// Per row: the running (min, argmin) over the splits in order, from
// (+inf, 0), taking a split's pair only when strictly smaller.
__global__ void minonly_merge_kernel(const float* part_v, const int* part_i,
                                     int splits, int m, float* val,
                                     int* idx) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= m) return;
  float bv = __int_as_float(0x7f800000);
  int bi = 0;
  for (int s = 0; s < splits; ++s) {
    const float v = part_v[static_cast<int64_t>(s) * m + r];
    if (v < bv) {
      bv = v;
      bi = part_i[static_cast<int64_t>(s) * m + r];
    }
  }
  val[r] = bv;
  idx[r] = bi;
}

template <int TIER>
static void launch_split(dim3 grid, cudaStream_t st, const void* x0,
                         const void* x1, const float* xn, int64_t ldx,
                         const void* y0, const void* y1, const float* yn,
                         int64_t ldy, int m, int n, int k, int tps,
                         float* part_v, int* part_i) {
  minonly_split_kernel<TIER><<<grid, THREADS, 0, st>>>(
      x0, x1, xn, ldx, y0, y1, yn, ldy, m, n, k, tps, part_v, part_i);
}

}  // namespace raft_port

// Operands as in common.cuh (metric l2); part_v/part_i: f32/int32 scratch
// [splits][m]; splits must equal ceil(n_tiles / ceil(n_tiles / splits)) so
// that no split is empty. Returns the CUDA error of the launches.
extern "C" int raft_minonly(int tier, const void* x0, const void* x1,
                            const float* xn, int64_t ldx, const void* y0,
                            const void* y1, const float* yn, int64_t ldy,
                            int m, int n, int k, int splits, void* part_v,
                            void* part_i, float* val, int* idx,
                            void* stream) {
  using namespace raft_port;
  const int n_tiles = (n + BN - 1) / BN;
  if (tier < 0 || tier > 2 || m < 1 || n < 1 || k < 1 || splits < 1 ||
      splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tps = (n_tiles + splits - 1) / splits;
  if ((n_tiles + tps - 1) / tps != splits)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + BM - 1) / BM, splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  if (tier == kTierDefault)
    launch_split<kTierDefault>(grid, st, x0, x1, xn, ldx, y0, y1, yn, ldy, m,
                               n, k, tps, pv, pi);
  else if (tier == kTierHigh)
    launch_split<kTierHigh>(grid, st, x0, x1, xn, ldx, y0, y1, yn, ldy, m, n,
                            k, tps, pv, pi);
  else
    launch_split<kTierHighest>(grid, st, x0, x1, xn, ldx, y0, y1, yn, ldy, m,
                               n, k, tps, pv, pi);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  minonly_merge_kernel<<<(m + 255) / 256, 256, 0, st>>>(pv, pi, splits, m,
                                                       val, idx);
  return static_cast<int>(cudaGetLastError());
}
