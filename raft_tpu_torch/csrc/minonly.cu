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
// Design, tiers 'default' and 'high': fused_topk.cu's tile and walk,
// wgmma_tile.cuh's tensor-core tile in its split walk (work units (row
// tile, database split), the splits chosen by the same plan), with the
// L2 argmin epilogue of wgmma_tile.cuh (fold_l2_tile and quad_argmin,
// on the accumulator fragment, fused_lloyd.cu's fold in a branch-free
// form: the column norms loaded before the tile's product, a column past
// n folded as a NaN, which never wins, rather than branched around): each thread folds its 32 distances
// of each of its two rows into a running (min, first argmin) under
// common.cuh's strict order, the quad combines by two shuffles at the
// unit's end, and lane 0 of the quad writes the unit's [split][row]
// partial. Tier 'highest' (no exact f32 tensor-core
// product) keeps common.cuh's FMA tile on a (query tile, split) grid, with
// block_argmin_range. A second kernel folds each row's split results in
// split order with a strict <, so the earlier split, and with it the
// smaller column, wins ties. A min is exact, so the result does not depend
// on the split count or the grid.

#include "common.cuh"
#include "wgmma_tile.cuh"

namespace raft_port {

template <int HALVES>
__global__ void __launch_bounds__(wg::kThreads, 1)
    minonly_wgmma(const uint16_t* x0, const uint16_t* x1, const float* xn,
                  int64_t ldx, const uint16_t* y0, const uint16_t* y1,
                  const float* yn, int64_t ldy, int m, int n, int k, int tps,
                  float* part_v, int* part_i) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  wg::Pipe<HALVES, wg::kSplitWalk> pipe(x0, x1, ldx, y0, y1, ldy, m, n, k,
                                        smem, tps);
  const int rl = wg::frag_row(0);         // this thread's rows rl, rl + 8
  float d[wg::kAcc];
  for (int u = blockIdx.x; u < pipe.units; u += gridDim.x) {
    const int r0 = pipe.unit_row0(u) + rl, r1 = r0 + 8;
    const float xt0 = r0 < m ? xn[r0] : 0.f;
    const float xt1 = r1 < m ? xn[r1] : 0.f;
    float bv0 = __int_as_float(0x7f800000), bv1 = bv0;   // +inf
    int bi0 = 0x7fffffff, bi1 = 0x7fffffff;
    for (int ct = pipe.unit_first(u); ct < pipe.unit_end(u); ++ct) {
      float yt[wg::kBN / 4];        // in flight while the tensor cores run
      wg::col_terms<kMetricL2>(yt, ct * wg::kBN, n, yn);
      pipe.cross(d);
      wg::fold_l2_tile(d, yt, ct * wg::kBN, n, xt0, xt1, bv0, bi0, bv1, bi1);
    }
    wg::quad_argmin(bv0, bi0, bv1, bi1);
    if ((threadIdx.x & 3) == 0) {
      const int64_t base = static_cast<int64_t>(pipe.unit_split(u)) * m;
      if (r0 < m) {
        part_v[base + r0] = bv0;
        part_i[base + r0] = bi0;
      }
      if (r1 < m) {
        part_v[base + r1] = bv1;
        part_i[base + r1] = bi1;
      }
    }
  }
  pipe.drain();
}

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

template <int HALVES>
static cudaError_t launch_wgmma(int grid, cudaStream_t st, const void* x0,
                                const void* x1, const float* xn, int64_t ldx,
                                const void* y0, const void* y1,
                                const float* yn, int64_t ldy, int m, int n,
                                int k, int tps, float* part_v, int* part_i) {
  auto kern = minonly_wgmma<HALVES>;
  constexpr int smem = wg::Layout<HALVES>::kRingBytes + 1024;  // + alignment
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, wg::kThreads, smem, st>>>(
      static_cast<const uint16_t*>(x0), static_cast<const uint16_t*>(x1), xn,
      ldx, static_cast<const uint16_t*>(y0),
      static_cast<const uint16_t*>(y1), yn, ldy, m, n, k, tps, part_v,
      part_i);
  return cudaSuccess;
}

}  // namespace raft_port

// Operands as in common.cuh (metric l2) at tier 'highest' (2); at tiers
// 'default' (0) and 'high' (1) as in wgmma_tile.cuh: bf16 rows (at 'high'
// the hi and lo halves), k, ldx and ldy multiples of 8, 16-byte aligned
// bases, zeros in the padded depth. part_v/part_i: f32/int32 scratch
// [splits][m]; splits must equal ceil(n_tiles / ceil(n_tiles / splits)) so
// that no split is empty. grid: the persistent blocks of the wgmma split
// walk (not read at 'highest', whose grid is query tiles x splits).
// Returns the CUDA error of the launches.
extern "C" int raft_minonly(int tier, const void* x0, const void* x1,
                            const float* xn, int64_t ldx, const void* y0,
                            const void* y1, const float* yn, int64_t ldy,
                            int m, int n, int k, int splits, int grid,
                            void* part_v, void* part_i, float* val, int* idx,
                            void* stream) {
  using namespace raft_port;
  const int n_tiles = (n + BN - 1) / BN;
  if (tier < 0 || tier > 2 || m < 1 || n < 1 || k < 1 || splits < 1 ||
      splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tps = (n_tiles + splits - 1) / splits;
  if ((n_tiles + tps - 1) / tps != splits)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = static_cast<int64_t>((m + BM - 1) / BM) * n_tiles;
  if (tier != kTierHighest &&
      (grid < 1 ||
       !wg::operands_ok(tier == kTierHigh, k, ldx, ldy, x0, x1, y0, y1) ||
       2 * tiles >= (int64_t(1) << 31)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  cudaError_t err = cudaSuccess;
  if (tier == kTierDefault)
    err = launch_wgmma<1>(grid, st, x0, x1, xn, ldx, y0, y1, yn, ldy, m, n,
                          k, tps, pv, pi);
  else if (tier == kTierHigh)
    err = launch_wgmma<2>(grid, st, x0, x1, xn, ldx, y0, y1, yn, ldy, m, n,
                          k, tps, pv, pi);
  else
    launch_split<kTierHighest>(dim3((m + BM - 1) / BM, splits), st, x0, x1,
                               xn, ldx, y0, y1, yn, ldy, m, n, k, tps, pv,
                               pi);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  minonly_merge_kernel<<<(m + 255) / 256, 256, 0, st>>>(pv, pi, splits, m,
                                                       val, idx);
  return static_cast<int>(cudaGetLastError());
}
