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
//
// Design, tiers 'default' and 'high': the tensor-core tile of
// wgmma_tile.cuh (bf16 operands, one pass or bf16x3, f32 accumulators) on
// a persistent grid of one 256-thread block a multiprocessor. The epilogue
// applies the norms and the metric (common.cuh's norm_term, metric_value)
// to the accumulator fragment in registers, writes the 128 x 128 f32 tile
// to shared memory, and streams it out as 16-byte stores, a warp to a
// 512-byte row segment (scalar stores where n is not a multiple of 4); the
// next tile's operands are in flight meanwhile. The wrapper hands bf16
// rows with k and the row strides padded to multiples of 8.
// Tier 'highest' (full f32, no TF32) stays on common.cuh's CUDA-core FMA
// tile: the tensor cores have no exact f32 product, and that tile already
// beats torch.cdist at the main shape (PERF.md).

#include "common.cuh"
#include "wgmma_tile.cuh"

namespace raft_port {

// f32 pitch of the epilogue tile: 136 = 8 mod 32 words, so the fragment's
// float2 stores (4 rows x 4 lanes a half-warp) hit 32 distinct banks
constexpr int kEpiPitch = wg::kBN + 8;
constexpr int kEpiBytes = wg::kBM * kEpiPitch * 4;

template <int HALVES>
constexpr int wgmma_smem_bytes() {
  return wg::Layout<HALVES>::kRingBytes + kEpiBytes + 1024;  // + alignment
}

template <int HALVES, int METRIC>
__global__ void __launch_bounds__(wg::kThreads, 1)
    pairwise_wgmma_kernel(const uint16_t* x0, const uint16_t* x1,
                          const float* xn, int64_t ldx, const uint16_t* y0,
                          const uint16_t* y1, const float* yn, int64_t ldy,
                          float* out, int m, int n, int k) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* epi = reinterpret_cast<float*>(smem +
                                        wg::Layout<HALVES>::kRingBytes);
  wg::Pipe<HALVES> pipe(x0, x1, ldx, y0, y1, ldy, m, n, k, smem);
  const bool vec = (n & 3) == 0;
  float d[wg::kAcc];
#pragma unroll
  for (int i = 0; i < wg::kAcc; ++i) d[i] = 0.f;
  for (int tile = blockIdx.x; tile < pipe.tiles; tile += gridDim.x) {
    // the previous tile's epilogue reads are behind cross()'s first barrier
    pipe.cross(d);
    const int row0 = pipe.row0(tile), col0 = pipe.col0(tile);
    const int rl = wg::frag_row(0);
    const float xt0 = row0 + rl < m ? norm_term<METRIC>(xn, row0 + rl) : 0.f;
    const float xt1 =
        row0 + rl + 8 < m ? norm_term<METRIC>(xn, row0 + rl + 8) : 0.f;
#pragma unroll
    for (int j = 0; j < wg::kBN / 8; ++j) {
      const int cl = wg::frag_col(4 * j);
      const float yt0 =
          col0 + cl < n ? norm_term<METRIC>(yn, col0 + cl) : 0.f;
      const float yt1 =
          col0 + cl + 1 < n ? norm_term<METRIC>(yn, col0 + cl + 1) : 0.f;
      *reinterpret_cast<float2*>(epi + rl * kEpiPitch + cl) = make_float2(
          metric_value<METRIC>(d[4 * j], xt0, yt0),
          metric_value<METRIC>(d[4 * j + 1], xt0, yt1));
      *reinterpret_cast<float2*>(epi + (rl + 8) * kEpiPitch + cl) =
          make_float2(metric_value<METRIC>(d[4 * j + 2], xt1, yt0),
                      metric_value<METRIC>(d[4 * j + 3], xt1, yt1));
    }
    __syncthreads();
    // a warp writes 32 float4 of one row; rows and columns past m, n masked
#pragma unroll 4
    for (int i = 0; i < wg::kBM * wg::kBN / 4 / wg::kThreads; ++i) {
      const int e = threadIdx.x + i * wg::kThreads;
      const int r = e / (wg::kBN / 4), c = (e % (wg::kBN / 4)) * 4;
      const int gr = row0 + r, gc = col0 + c;
      if (gr >= m || gc >= n) continue;
      const float4 v = *reinterpret_cast<const float4*>(epi + r * kEpiPitch +
                                                        c);
      float* dst = out + static_cast<int64_t>(gr) * n + gc;
      if (vec) {
        __stcs(reinterpret_cast<float4*>(dst), v);
      } else {
        dst[0] = v.x;
        if (gc + 1 < n) dst[1] = v.y;
        if (gc + 2 < n) dst[2] = v.z;
        if (gc + 3 < n) dst[3] = v.w;
      }
    }
  }
  pipe.drain();
}

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

template <int HALVES, int METRIC>
static cudaError_t launch_wgmma(cudaStream_t st, const void* x0,
                                const void* x1, const float* xn, int64_t ldx,
                                const void* y0, const void* y1,
                                const float* yn, int64_t ldy, float* out,
                                int m, int n, int k) {
  auto kern = pairwise_wgmma_kernel<HALVES, METRIC>;
  constexpr int smem = wgmma_smem_bytes<HALVES>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t tiles = static_cast<int64_t>((m + wg::kBM - 1) / wg::kBM) *
                        ((n + wg::kBN - 1) / wg::kBN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kern<<<grid, wg::kThreads, smem, st>>>(
      static_cast<const uint16_t*>(x0), static_cast<const uint16_t*>(x1), xn,
      ldx, static_cast<const uint16_t*>(y0),
      static_cast<const uint16_t*>(y1), yn, ldy, out, m, n, k);
  return cudaSuccess;
}

template <int HALVES>
static cudaError_t launch_wgmma(int metric, cudaStream_t st, const void* x0,
                                const void* x1, const float* xn, int64_t ldx,
                                const void* y0, const void* y1,
                                const float* yn, int64_t ldy, float* out,
                                int m, int n, int k) {
  switch (metric) {
    case kMetricL2:
      return launch_wgmma<HALVES, kMetricL2>(st, x0, x1, xn, ldx, y0, y1, yn,
                                             ldy, out, m, n, k);
    case kMetricCosine:
      return launch_wgmma<HALVES, kMetricCosine>(st, x0, x1, xn, ldx, y0, y1,
                                                 yn, ldy, out, m, n, k);
    default:
      return launch_wgmma<HALVES, kMetricInner>(st, x0, x1, xn, ldx, y0, y1,
                                                yn, ldy, out, m, n, k);
  }
}

static void launch_fma(int metric, dim3 grid, cudaStream_t st,
                       const void* x0, const float* xn, int64_t ldx,
                       const void* y0, const float* yn, int64_t ldy,
                       float* out, int m, int n, int k) {
  switch (metric) {
    case kMetricL2:
      pairwise_tile_kernel<kTierHighest, kMetricL2><<<grid, THREADS, 0, st>>>(
          x0, nullptr, xn, ldx, y0, nullptr, yn, ldy, out, m, n, k);
      break;
    case kMetricCosine:
      pairwise_tile_kernel<kTierHighest, kMetricCosine>
          <<<grid, THREADS, 0, st>>>(x0, nullptr, xn, ldx, y0, nullptr, yn,
                                     ldy, out, m, n, k);
      break;
    default:
      pairwise_tile_kernel<kTierHighest, kMetricInner>
          <<<grid, THREADS, 0, st>>>(x0, nullptr, xn, ldx, y0, nullptr, yn,
                                     ldy, out, m, n, k);
  }
}

}  // namespace raft_port

// Tiers 'default' (0) and 'high' (1) take bf16 rows (x0/y0; at 'high' also
// the lo halves x1/y1, laid out as x0/y0) with k, ldx and ldy multiples of
// 8 and 16-byte aligned bases; tier 'highest' (2) takes f32 rows of any
// shape (common.cuh's operand block). Returns the CUDA error of the launch
// (0 on success).
extern "C" int raft_pairwise_tile(int tier, int metric, const void* x0,
                                  const void* x1, const float* xn,
                                  int64_t ldx, const void* y0,
                                  const void* y1, const float* yn,
                                  int64_t ldy, float* out, int m, int n,
                                  int k, void* stream) {
  using namespace raft_port;
  if (tier < 0 || tier > 2 || metric < 0 || metric > 2 || m < 1 || n < 1 ||
      k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tier == kTierHighest) {
    if ((n + BN - 1) / BN > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
    launch_fma(metric, grid, st, x0, xn, ldx, y0, yn, ldy, out, m, n, k);
    return static_cast<int>(cudaGetLastError());
  }
  const bool high = tier == kTierHigh;
  if (!wg::operands_ok(high, k, ldx, ldy, x0, x1, y0, y1) ||
      static_cast<int64_t>((m + wg::kBM - 1) / wg::kBM) *
              ((n + wg::kBN - 1) / wg::kBN) >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      high ? launch_wgmma<2>(metric, st, x0, x1, xn, ldx, y0, y1, yn, ldy,
                             out, m, n, k)
           : launch_wgmma<1>(metric, st, x0, x1, xn, ldx, y0, y1, yn, ldy,
                             out, m, n, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
