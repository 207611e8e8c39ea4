// One Lloyd data pass: per row of X the clamped min squared-L2 distance to
// the centroids Y and its first-min label, plus the per-centroid sums of
// the assigned rows [n, k] and their counts [n].
//
// Replaces raft_tpu/linalg/contractions.py:_lloyd_kernel (:931) and
// _lloyd_kernel_split (:963), launched by _fused_lloyd_padded (:1076) and
// _fused_lloyd_padded_split (:1030) — the k-means north-star kernel. As
// there, distances are taken as finite (k-means on non-finite data is
// undefined), rows >= m never count, and at tier 'high' the sums are
// accumulated over the hi and the lo halves separately and added at the
// end (:996-1001). At tier 'default' the summed rows are the bf16-rounded
// ones, as the reference's one-pass one-hot product makes them.
//
// The hard part: the TPU accumulates sums and counts in an output block
// that a *sequential* grid revisits (:935-938, "arbitrary" semantics at
// :1064). Hopper blocks run in parallel in no order, and at the main shape
// sums are 1024 x 128 f32 = 512 KB, more than one block's shared memory.
// Float atomics would make the result change from run to run. Design:
//   1. fused_lloyd_kernel runs a persistent grid of G blocks (G fixed by
//      the shapes, not the card, see contractions._lloyd_blocks). Block b
//      takes row tiles b, b + G, b + 2G, ...; for each it runs the fused
//      argmin (common.cuh block_argmin), writes labels and distances, then
//      adds the tile's rows into its OWN partial [n, k] slice (and int
//      counts [n]) in scratch, one row after another in row order.
//   2. lloyd_reduce_kernel sums the G partials in block order.
// Every sum is thus taken in a fixed order: the result is bitwise the same
// from run to run. Counts are exact integers.
//
// Bound on an H100 SXM: operations. At 1M x 128, k = 1024, tier 'high' the
// distance is 8.1e11 bf16 products (0.81 ms at 989 TFLOP/s) while the bytes
// (X's halves once, 0.5 GB) take 0.16 ms. The CUDA-core FMA tile keeps the
// kernel far from that; the partial scratch (G x n x k f32, twice at
// 'high') adds one write and one read of about 0.28 GB.

#include "common.cuh"

namespace raft_port {

template <int TIER>
__global__ void __launch_bounds__(THREADS)
    fused_lloyd_kernel(const void* x0, const void* x1, const float* xn,
                       int64_t ldx, const void* y0, const void* y1,
                       const float* yn, int64_t ldy, float* val, int* idx,
                       float* part0, float* part1, int* part_cnt, int m,
                       int n, int k) {
  __shared__ TileSmem<TIER> s;
  __shared__ int lab[BM];
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t nk = static_cast<int64_t>(n) * k;
  float* p0 = part0 + blockIdx.x * nk;
  float* p1 = TIER == kTierHigh ? part1 + blockIdx.x * nk : nullptr;
  int* pc = part_cnt + static_cast<int64_t>(blockIdx.x) * n;
  for (int64_t e = threadIdx.x; e < nk; e += THREADS) {
    p0[e] = 0.f;
    if constexpr (TIER == kTierHigh) p1[e] = 0.f;
  }
  for (int e = threadIdx.x; e < n; e += THREADS) pc[e] = 0;
  __syncthreads();

  for (int64_t tile = blockIdx.x; tile * BM < m; tile += gridDim.x) {
    const int row0 = static_cast<int>(tile * BM);
    float bv[TM];
    int bi[TM];
    block_argmin<TIER, kMetricL2, true>(bv, bi, s, x0, x1, xn, ldx, row0, m,
                                        y0, y1, yn, ldy, n, k);
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = row0 + sub_index(ty, i);
        const bool live = r < m && bi[i] < n;
        lab[sub_index(ty, i)] = live ? bi[i] : -1;
        if (r < m) {
          val[r] = bv[i] < 0.f ? 0.f : bv[i];   // NaN stays NaN
          idx[r] = bi[i];
        }
      }
    }
    __syncthreads();
    const int rows = min(BM, m - row0);
    for (int f = threadIdx.x; f < k; f += THREADS) {
      for (int r = 0; r < rows; ++r) {
        const int c = lab[r];
        if (c < 0) continue;
        const int64_t o = static_cast<int64_t>(row0 + r) * ldx + f;
        const int64_t t = static_cast<int64_t>(c) * k + f;
        float v0 = 0.f, v1 = 0.f;
        load_operand<TIER>(x0, x1, o, v0, v1);
        p0[t] += v0;
        if constexpr (TIER == kTierHigh) p1[t] += v1;
      }
    }
    if (threadIdx.x == THREADS - 1) {
      for (int r = 0; r < rows; ++r)
        if (lab[r] >= 0) pc[lab[r]] += 1;
    }
    __syncthreads();
  }
}

// sums[c, f] = sum over b of part0[b, c, f] (+ the same over part1 at tier
// 'high'), counts[c] = sum over b of part_cnt[b, c], in block order.
__global__ void lloyd_reduce_kernel(const float* part0, const float* part1,
                                    const int* part_cnt, int blocks, int n,
                                    int k, float* sums, float* counts) {
  const int64_t nk = static_cast<int64_t>(n) * k;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e < nk) {
    float s0 = 0.f;
    for (int b = 0; b < blocks; ++b) s0 += part0[b * nk + e];
    if (part1 != nullptr) {
      float s1 = 0.f;
      for (int b = 0; b < blocks; ++b) s1 += part1[b * nk + e];
      s0 += s1;
    }
    sums[e] = s0;
  }
  if (e < n) {
    int c = 0;
    for (int b = 0; b < blocks; ++b) c += part_cnt[static_cast<int64_t>(b) * n + e];
    counts[e] = static_cast<float>(c);
  }
}

}  // namespace raft_port

// part0 (and part1 at tier 'high') are scratch of blocks x n x k f32,
// part_cnt blocks x n int32; the kernel initialises them itself. Returns
// the CUDA error of the launches (0 on success).
extern "C" int raft_fused_lloyd(int tier, const void* x0, const void* x1,
                                const float* xn, int64_t ldx, const void* y0,
                                const void* y1, const float* yn, int64_t ldy,
                                float* sums, float* counts, float* val,
                                int* idx, float* part0, float* part1,
                                int* part_cnt, int blocks, int m, int n,
                                int k, void* stream) {
  using namespace raft_port;
  if (tier < 0 || tier > 2 || m < 1 || n < 1 || k < 1 || blocks < 1 ||
      (tier == kTierHigh && part1 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tier == kTierDefault)
    fused_lloyd_kernel<kTierDefault><<<blocks, THREADS, 0, st>>>(
        x0, x1, xn, ldx, y0, y1, yn, ldy, val, idx, part0, part1, part_cnt, m,
        n, k);
  else if (tier == kTierHigh)
    fused_lloyd_kernel<kTierHigh><<<blocks, THREADS, 0, st>>>(
        x0, x1, xn, ldx, y0, y1, yn, ldy, val, idx, part0, part1, part_cnt, m,
        n, k);
  else
    fused_lloyd_kernel<kTierHighest><<<blocks, THREADS, 0, st>>>(
        x0, x1, xn, ldx, y0, y1, yn, ldy, val, idx, part0, part1, part_cnt, m,
        n, k);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t nk = static_cast<int64_t>(n) * k;
  const int64_t work = nk > n ? nk : n;
  const int reduce_threads = 256;
  lloyd_reduce_kernel<<<static_cast<unsigned>((work + reduce_threads - 1) /
                                              reduce_threads),
                        reduce_threads, 0, st>>>(
      part0, tier == kTierHigh ? part1 : nullptr, part_cnt, blocks, n, k,
      sums, counts);
  return static_cast<int>(cudaGetLastError());
}
