// Fused distance + argmin: per row of X, the (min, first-min argmin) of
// the metric against every row of Y, never materialising the m x n matrix.
//
// Replaces raft_tpu/linalg/contractions.py:_argmin_resident_kernel (:665),
// _argmin_resident_kernel_split (:672), _argmin_tiled_kernel (:683) and
// _argmin_tiled_kernel_split (:691), with the epilogue.iota_argmin /
// masked_fold rules they inline. The TPU needs a resident and a tiled
// variant because Y must fit VMEM for the first; here one kernel covers
// both: each block owns a 128-row tile of X and loops over Y in 128-row
// tiles through shared memory, keeping a running (value, index) per row.
// Columns >= n are never considered. A NaN distance is minimal (the first
// NaN column wins) and ties go to the smaller index, so the result is the
// reference's global first minimum in whatever order the pairs are folded.
//
// Bound on an H100 SXM: operations. At the k-means shapes (m = 1M, n = 1024,
// k = 128, tier 'high') the three bf16 passes are 8.1e11 products, 0.81 ms
// at 989 TFLOP/s, against 0.16 ms to read X's bf16 halves at 3.35 TB/s.
// Design: the cross tile runs on CUDA-core FMAs (common.cuh), so the kernel
// sits far from that bound; the output is only 8 bytes a row, and Y stays
// in L2 across the row blocks. wgmma is the later step.

#include "common.cuh"

namespace raft_port {

template <int TIER, int METRIC>
__global__ void __launch_bounds__(THREADS)
    fused_argmin_kernel(const void* x0, const void* x1, const float* xn,
                        int64_t ldx, const void* y0, const void* y1,
                        const float* yn, int64_t ldy, float* val, int* idx,
                        int m, int n, int k) {
  __shared__ TileSmem<TIER> s;
  const int row0 = blockIdx.x * BM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float bv[TM];
  int bi[TM];
  block_argmin<TIER, METRIC, false>(bv, bi, s, x0, x1, xn, ldx, row0, m, y0,
                                    y1, yn, ldy, n, k);
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

template <int TIER>
static void launch(int metric, int blocks, cudaStream_t st, const void* x0,
                   const void* x1, const float* xn, int64_t ldx,
                   const void* y0, const void* y1, const float* yn,
                   int64_t ldy, float* val, int* idx, int m, int n, int k) {
  switch (metric) {
    case kMetricL2:
      fused_argmin_kernel<TIER, kMetricL2><<<blocks, THREADS, 0, st>>>(
          x0, x1, xn, ldx, y0, y1, yn, ldy, val, idx, m, n, k);
      break;
    case kMetricCosine:
      fused_argmin_kernel<TIER, kMetricCosine><<<blocks, THREADS, 0, st>>>(
          x0, x1, xn, ldx, y0, y1, yn, ldy, val, idx, m, n, k);
      break;
    default:
      fused_argmin_kernel<TIER, kMetricInner><<<blocks, THREADS, 0, st>>>(
          x0, x1, xn, ldx, y0, y1, yn, ldy, val, idx, m, n, k);
  }
}

}  // namespace raft_port

// Returns the CUDA error of the launch (0 on success).
extern "C" int raft_fused_argmin(int tier, int metric, const void* x0,
                                 const void* x1, const float* xn,
                                 int64_t ldx, const void* y0,
                                 const void* y1, const float* yn,
                                 int64_t ldy, float* val, int* idx, int m,
                                 int n, int k, void* stream) {
  using namespace raft_port;
  if (tier < 0 || tier > 2 || metric < 0 || metric > 2 || m < 1 || n < 1 ||
      k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (m + BM - 1) / BM;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tier == kTierDefault)
    launch<kTierDefault>(metric, blocks, st, x0, x1, xn, ldx, y0, y1, yn,
                         ldy, val, idx, m, n, k);
  else if (tier == kTierHigh)
    launch<kTierHigh>(metric, blocks, st, x0, x1, xn, ldx, y0, y1, yn, ldy,
                      val, idx, m, n, k);
  else
    launch<kTierHighest>(metric, blocks, st, x0, x1, xn, ldx, y0, y1, yn,
                         ldy, val, idx, m, n, k);
  return static_cast<int>(cudaGetLastError());
}
