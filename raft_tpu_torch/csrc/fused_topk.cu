// Fused distance + top-k: per query row of X, the k nearest rows of Y under
// the metric, as (f32 distance, int32 column) best-first, without
// materialising the m x n distance matrix. Empty slots are (+inf, 0); a
// NaN or +inf distance never enters (raft_tpu epilogue.insert_drain).
//
// Replaces raft_tpu/neighbors/fused_topk.py:_topk_kernel (:102) and
// _topk_kernel_split (:109), launched by _fused_topk_padded (:129) and
// _fused_topk_padded_split (:160): a distance tile plus the bound-gated
// sorted insertion of epilogue.insert_drain.
//
// Bound on an H100 SXM: operations. At the kNN shape (q = 4096 queries,
// n = 2^20 rows, 128 features, tier 'high') the three bf16 passes are
// 1.6e12 products, 3.3 ms at 989 TFLOP/s, against 0.2 ms to read both
// sides' bf16 halves at 3.35 TB/s.
// Design: grid (query tiles of 128, splits of the database). Each block
// runs common.cuh's 128 x 128 cross tile on CUDA-core FMAs over its split,
// writes the metric tile to shared memory (over the staging buffers), and
// each warp then checks 16 rows of the tile against the rows' k-th keys;
// the few candidates below them merge into the row's sorted list for this
// split (topk_common.cuh:warp_merge), kept in a global scratch
// [splits][m][k] that stays in L2. The splits give 4096 queries enough
// blocks for 132 SMs. A second kernel merges each row's split lists into
// the output; the keys are exact, so the result does not depend on the
// number of splits. wgmma for the cross tile is the later step.

#include "common.cuh"
#include "topk_common.cuh"

namespace raft_port {

constexpr int kTopkWarps = THREADS / kWarp;       // 8
constexpr int kRowsPerWarp = BM / kTopkWarps;     // 16
constexpr int kTileLd = BN + 1;                   // distance tile row stride

template <int TIER>
__host__ __device__ constexpr size_t tile_bytes() {
  return sizeof(TileSmem<TIER>) > sizeof(float) * BM * kTileLd
             ? sizeof(TileSmem<TIER>)
             : sizeof(float) * BM * kTileLd;
}

template <int TIER>
size_t fused_smem_bytes(int k) {
  return tile_bytes<TIER>() +
         sizeof(uint64_t) * (BM + kTopkWarps * (static_cast<size_t>(k) + BN));
}

template <int TIER, int METRIC>
__global__ void __launch_bounds__(THREADS)
    fused_topk_kernel(const void* x0, const void* x1, const float* xn,
                      int64_t ldx, const void* y0, const void* y1,
                      const float* yn, int64_t ldy, int m, int n, int kd,
                      int k, int tiles_per_split, uint64_t* lists) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& ts = *reinterpret_cast<TileSmem<TIER>*>(smem_raw);
  float* dt = reinterpret_cast<float*>(smem_raw);   // aliases ts
  uint64_t* bound = reinterpret_cast<uint64_t*>(smem_raw + tile_bytes<TIER>());
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  uint64_t* tmp = bound + BM + warp * k;
  uint64_t* cand = bound + BM + kTopkWarps * k + warp * BN;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int row0 = blockIdx.x * BM;
  uint64_t* split_lists =
      lists + static_cast<int64_t>(blockIdx.y) * m * k;   // row r at r * k

  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = row0 + warp * kRowsPerWarp + rr;
    if (r >= m) break;
    for (int e = lane; e < k; e += kWarp)
      split_lists[static_cast<int64_t>(r) * k + e] = kEmpty;
  }
  for (int i = threadIdx.x; i < BM; i += THREADS) bound[i] = kEmpty;
  float xt[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + sub_index(ty, i);
    xt[i] = r < m ? norm_term<METRIC>(xn, r) : 0.f;
  }
  const int n_tiles = (n + BN - 1) / BN;
  const int t0 = blockIdx.y * tiles_per_split;
  const int t1 = min(n_tiles, t0 + tiles_per_split);
  float acc[TM][TN];
  __syncthreads();
  for (int tile = t0; tile < t1; ++tile) {
    const int col0 = tile * BN;
    // ends with __syncthreads: the staging buffers under dt are free
    cross_tile<TIER>(acc, ts, x0, x1, ldx, row0, m, y0, y1, ldy, col0, n,
                     kd);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int cl = sub_index(tx, j);
      const bool live = col0 + cl < n;
      const float yt = live ? norm_term<METRIC>(yn, col0 + cl) : 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i)
        dt[sub_index(ty, i) * kTileLd + cl] =
            live ? metric_value<METRIC>(acc[i][j], xt[i], yt)
                 : __int_as_float(0x7fc00000);     // NaN: never enters
    }
    __syncthreads();
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int rl = warp * kRowsPerWarp + rr, r = row0 + rl;
      if (r >= m) break;
      const uint64_t b = bound[rl];
      int count = 0;
#pragma unroll
      for (int t = 0; t < BN / kWarp; ++t) {
        const int cl = t * kWarp + lane;
        const float d = dt[rl * kTileLd + cl];
        uint64_t key = 0;
        bool take = false;
        if (insertable(d)) {
          key = pack_key(d, col0 + cl);
          take = key < b;
        }
        count = warp_append(cand, count, take, key);
      }
      __syncwarp();
      if (count) {
        const uint64_t nb = warp_merge(
            split_lists + static_cast<int64_t>(r) * k, tmp, cand, count, k);
        if (lane == 0) bound[rl] = nb;
      }
    }
    __syncthreads();   // dt is read out before the next tile is staged
  }
}

// Per row: the k smallest keys of its split lists, best-first.
__global__ void merge_splits_kernel(const uint64_t* lists, int splits, int m,
                                    int k, float* out_v, int* out_i) {
  extern __shared__ uint64_t sl[];                  // [splits][k]
  const int64_t r = blockIdx.x;
  for (int p = threadIdx.x; p < splits * k; p += blockDim.x) {
    const int s = p / k, e = p % k;
    sl[p] = lists[(static_cast<int64_t>(s) * m + r) * k + e];
  }
  __syncthreads();
  block_merge_lists(sl, splits, k, k, out_v + r * k, out_i + r * k);
}

template <int TIER, int METRIC>
static cudaError_t launch_metric(dim3 grid, size_t smem, cudaStream_t st,
                                 const void* x0, const void* x1,
                                 const float* xn, int64_t ldx, const void* y0,
                                 const void* y1, const float* yn, int64_t ldy,
                                 int m, int n, int kd, int k, int tps,
                                 uint64_t* lists) {
  auto kern = fused_topk_kernel<TIER, METRIC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, smem, st>>>(x0, x1, xn, ldx, y0, y1, yn, ldy, m, n,
                                    kd, k, tps, lists);
  return cudaGetLastError();
}

template <int TIER>
static cudaError_t launch(int metric, dim3 grid, int k, cudaStream_t st,
                          const void* x0, const void* x1, const float* xn,
                          int64_t ldx, const void* y0, const void* y1,
                          const float* yn, int64_t ldy, int m, int n, int kd,
                          int tps, uint64_t* lists) {
  const size_t smem = fused_smem_bytes<TIER>(k);
  switch (metric) {
    case kMetricL2:
      return launch_metric<TIER, kMetricL2>(grid, smem, st, x0, x1, xn, ldx,
                                            y0, y1, yn, ldy, m, n, kd, k, tps,
                                            lists);
    case kMetricCosine:
      return launch_metric<TIER, kMetricCosine>(grid, smem, st, x0, x1, xn,
                                                ldx, y0, y1, yn, ldy, m, n,
                                                kd, k, tps, lists);
    default:
      return launch_metric<TIER, kMetricInner>(grid, smem, st, x0, x1, xn,
                                               ldx, y0, y1, yn, ldy, m, n, kd,
                                               k, tps, lists);
  }
}

}  // namespace raft_port

// lists: u64 scratch [splits][m][k]; splits must equal
// ceil(n_tiles / ceil(n_tiles / splits)) so that no split is empty.
// Returns the CUDA error of the launches (0 on success).
extern "C" int raft_fused_topk(int tier, int metric, const void* x0,
                               const void* x1, const float* xn, int64_t ldx,
                               const void* y0, const void* y1,
                               const float* yn, int64_t ldy, int m, int n,
                               int kd, int k, int splits, void* lists,
                               float* out_v, int* out_i, void* stream) {
  using namespace raft_port;
  const int n_tiles = (n + BN - 1) / BN;
  if (tier < 0 || tier > 2 || metric < 0 || metric > 2 || m < 1 || n < 1 ||
      kd < 1 || k < 1 || k > kMaxTopK || splits < 1 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tps = (n_tiles + splits - 1) / splits;
  if ((n_tiles + tps - 1) / tps != splits)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t merge_smem = sizeof(uint64_t) * splits * static_cast<size_t>(k);
  if (merge_smem > 200 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + BM - 1) / BM, splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint64_t* ls = static_cast<uint64_t*>(lists);
  cudaError_t err;
  if (tier == kTierDefault)
    err = launch<kTierDefault>(metric, grid, k, st, x0, x1, xn, ldx, y0, y1,
                               yn, ldy, m, n, kd, tps, ls);
  else if (tier == kTierHigh)
    err = launch<kTierHigh>(metric, grid, k, st, x0, x1, xn, ldx, y0, y1, yn,
                            ldy, m, n, kd, tps, ls);
  else
    err = launch<kTierHighest>(metric, grid, k, st, x0, x1, xn, ldx, y0, y1,
                               yn, ldy, m, n, kd, tps, ls);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(merge_splits_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(merge_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_splits_kernel<<<m, 256, merge_smem, st>>>(ls, splits, m, k, out_v,
                                                  out_i);
  return static_cast<int>(cudaGetLastError());
}
