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
// 3.3e12 flops, 3.3 ms at 989 TFLOP/s, against 0.2 ms to read both
// sides' bf16 halves at 3.35 TB/s.
//
// Design, tiers 'default' and 'high': wgmma_tile.cuh's tensor-core tile
// (bf16, one pass or bf16x3, f32 accumulators) in its split walk, one
// persistent block a multiprocessor over work units (128-row query tile,
// database split); the wrapper's plan picks the fewest splits that keep
// every multiprocessor busy, since each split refills every row's list.
// The selection works on the accumulator fragment: warp w of the block
// holds all 128 columns of the tile's rows 16 w .. 16 w + 15, a quad
// (four lanes) a row pair, so a warp selects for its own rows with
// __syncwarp alone. The column norms are loaded before the tile's product
// (the epilogue does not overlap the tensor cores, so its loads would
// otherwise wait in it). Each thread tests its values, a chunk of 16 a
// row at a time, against its rows' k-th keys, held in registers (float
// compares without branches first, then the whole key where a value of
// the warp passed), and the quad appends the few that
// pass to the row's candidate buffer in shared memory at places from a
// quad prefix sum (no atomics, so the buffer does not depend on timing).
// A row merges its buffer into its sorted list (topk_common.cuh:
// warp_merge, which sorts the batch and places every key by binary
// search) only when the next chunk would overflow it, and at the unit's
// end: the first tiles of a unit, where every column is a candidate,
// merge a buffer's worth at a time, later tiles rarely. A stale bound
// only lets more candidates in; the merge keeps the k smallest keys
// either way. The lists stay in shared memory beside the operand ring
// where they fit with a buffer of at least kMinCap keys a row (k <= 64 at
// 'high', k <= 128 at 'default'), else in the global scratch
// [splits][m][k], in L2. Tier 'highest' (no exact f32 tensor-core
// product) keeps common.cuh's CUDA-core FMA tile on a (query tile, split)
// grid, writing each tile to shared memory and merging each row's
// candidates tile by tile into the scratch lists.
// A second kernel merges each row's split lists into the output; the keys
// are exact, so the result does not depend on the splits or the grid.

#include "common.cuh"
#include "topk_common.cuh"
#include "wgmma_tile.cuh"

namespace raft_port {

constexpr int kTopkWarps = THREADS / kWarp;       // 8
constexpr int kRowsPerWarp = BM / kTopkWarps;     // 16
constexpr int kTileLd = BN + 1;                   // distance tile row stride
static_assert(BN <= kMergeBatch, "warp_merge takes a tile row's candidates");

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

// ---------------------------------------------------------------------------
// tiers 'default' and 'high': the wgmma tile, selection on the fragment
// ---------------------------------------------------------------------------

constexpr int kSmemMax = 232448;    // shared memory a block may opt into
constexpr int kChunkJ = 2;          // fragment column groups a chunk
constexpr int kChunkKeys = 8 * kChunkJ;   // a row's candidates a chunk, most
constexpr int kMinCap = 24;         // buffer keys a row beside on-chip lists
constexpr int kMaxCap = 128;        // a tile row: a larger batch buys nothing
static_assert(kMinCap >= kChunkKeys, "a merged row takes a whole chunk");
static_assert(kMaxCap <= kMergeBatch, "warp_merge takes the whole buffer");

// Shared memory of the wgmma route after the ring: the rows' candidate
// buffers [128][cap], the warps' merge scratch [8][k] and, when they fit
// with a buffer of at least kMinCap keys, the rows' lists [128][k].
struct SelectLayout {
  int cap;
  bool on_chip;
  int bytes;
};

template <int HALVES>
SelectLayout select_layout(int k) {
  const int ring = wg::Layout<HALVES>::kRingBytes + 1024;   // + alignment
  const int avail = kSmemMax - ring - kTopkWarps * k * 8;
  const int row_bytes = wg::kBM * 8;                   // a key for each row
  SelectLayout l;
  const int cap_on = (avail - row_bytes * k) / row_bytes;
  l.on_chip = cap_on >= kMinCap;
  const int cap = l.on_chip ? cap_on : avail / row_bytes;
  l.cap = cap < kMaxCap ? cap : kMaxCap;
  l.bytes = ring + kTopkWarps * k * 8 +
            row_bytes * (l.cap + (l.on_chip ? k : 0));
  return l;
}

// A thread's selection state for one of its two rows.
struct RowSel {
  uint64_t bound;   // the list's k-th key: kEmpty while a slot is free,
                    // 0 for a row past m (nothing enters)
  float thr;        // bound's value, a column's first and cheap test
  int cnt;          // keys in the row's candidate buffer

  __device__ void reset(uint64_t b) {
    bound = b;
    thr = b == kEmpty ? __int_as_float(0x7f800000) : key_value(b);
    cnt = 0;
  }
};

// A value that may enter the row: insertable and not above the bound's
// value (the whole key decides among equal values).
__device__ __forceinline__ unsigned first_test(float v, const RowSel& s) {
  return static_cast<unsigned>(insertable(v)) &
         static_cast<unsigned>(v <= s.thr);
}

__device__ __forceinline__ int quad_sum(int v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// v summed over the lanes of this thread's quad before it
__device__ __forceinline__ int quad_prefix(int v) {
  const int q = threadIdx.x & 3;
  int s = v;
  int o = __shfl_up_sync(0xffffffffu, s, 1, 4);
  if (q >= 1) s += o;
  o = __shfl_up_sync(0xffffffffu, s, 2, 4);
  if (q >= 2) s += o;
  return s - v;
}

template <int HALVES, int METRIC>
__global__ void __launch_bounds__(wg::kThreads, 1)
    fused_topk_wgmma(const uint16_t* x0, const uint16_t* x1, const float* xn,
                     int64_t ldx, const uint16_t* y0, const uint16_t* y1,
                     const float* yn, int64_t ldy, int m, int n, int kd,
                     int k, int tps, int cap, bool on_chip,
                     uint64_t* lists) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  wg::Pipe<HALVES, wg::kSplitWalk> pipe(x0, x1, ldx, y0, y1, ldy, m, n, kd,
                                        smem, tps);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int q = lane >> 2;                 // this quad's rows q, q + 8
  uint64_t* sel =
      reinterpret_cast<uint64_t*>(smem + wg::Layout<HALVES>::kRingBytes);
  uint64_t* cand = sel + warp * kRowsPerWarp * cap;    // row lr at lr cap
  uint64_t* tmp = sel + wg::kBM * cap + warp * k;
  uint64_t* chip_lists =
      sel + wg::kBM * cap + kTopkWarps * k + warp * kRowsPerWarp * k;
  float d[wg::kAcc];
  for (int u = blockIdx.x; u < pipe.units; u += gridDim.x) {
    const int row0 = pipe.unit_row0(u) + warp * kRowsPerWarp;  // warp's rows
    uint64_t* split_lists =
        lists + (static_cast<int64_t>(pipe.unit_split(u)) * m + row0) * k;
    uint64_t* own = on_chip ? chip_lists : split_lists;      // row lr at lr k
    for (int lr = 0; lr < kRowsPerWarp; ++lr)
      if (on_chip || row0 + lr < m)
        for (int e = lane; e < k; e += kWarp) own[lr * k + e] = kEmpty;
    const int r0 = row0 + q, r1 = r0 + 8;
    RowSel s0, s1;
    s0.reset(r0 < m ? kEmpty : 0);
    s1.reset(r1 < m ? kEmpty : 0);
    const float xt0 = r0 < m ? norm_term<METRIC>(xn, r0) : 0.f;
    const float xt1 = r1 < m ? norm_term<METRIC>(xn, r1) : 0.f;
    __syncwarp();

    // Merge the buffers of the rows whose quads vote need0 (row q) or
    // need1 (row q + 8), one row at a time across the warp.
    auto flush = [&](bool need0, bool need1) {
      const unsigned v0 = __ballot_sync(0xffffffffu, need0);
      const unsigned v1 = __ballot_sync(0xffffffffu, need1);
      unsigned rows = 0;                   // bit lr: the warp's row lr
#pragma unroll
      for (int rq = 0; rq < 8; ++rq)
        rows |= (v0 >> (4 * rq) & 1u) << rq | (v1 >> (4 * rq) & 1u) << (rq + 8);
      while (rows) {
        const int lr = __ffs(rows) - 1;
        rows &= rows - 1;
        const int c = __shfl_sync(0xffffffffu, lr < 8 ? s0.cnt : s1.cnt,
                                  4 * (lr & 7));
        const uint64_t b = warp_merge(own + lr * k, tmp, cand + lr * cap, c,
                                      k);
        if (q == (lr & 7)) {
          if (lr < 8) s0.reset(b);
          else s1.reset(b);
        }
      }
    };

    for (int ct = pipe.unit_first(u); ct < pipe.unit_end(u); ++ct) {
      const int col0 = ct * wg::kBN;
      float yt[wg::kBN / 4];        // in flight while the tensor cores run
      wg::col_terms<METRIC>(yt, col0, n, yn);
      pipe.cross(d);
#pragma unroll
      for (int jc = 0; jc < wg::kBN / 8; jc += kChunkJ) {
        // first test: float compares combined without branches; the
        // whole keys only when a lane of the warp has a value that passed
        float v0[2 * kChunkJ], v1[2 * kChunkJ];
        unsigned f0 = 0, f1 = 0;
#pragma unroll
        for (int b = 0; b < 2 * kChunkJ; ++b) {
          const int j = jc + b / 2, e = b % 2;
          const unsigned live = col0 + wg::frag_col(4 * j) + e < n;
          v0[b] = metric_value<METRIC>(d[4 * j + e], xt0, yt[2 * j + e]);
          v1[b] = metric_value<METRIC>(d[4 * j + 2 + e], xt1, yt[2 * j + e]);
          f0 |= (live & first_test(v0[b], s0)) << b;
          f1 |= (live & first_test(v1[b], s1)) << b;
        }
        if (!__any_sync(0xffffffffu, (f0 | f1) != 0)) continue;
        uint64_t key0[2 * kChunkJ], key1[2 * kChunkJ];
#pragma unroll
        for (int b = 0; b < 2 * kChunkJ; ++b) {
          const int c = col0 + wg::frag_col(4 * (jc + b / 2)) + b % 2;
          key0[b] = pack_key(v0[b], c);
          key1[b] = pack_key(v1[b], c);
          if (!(key0[b] < s0.bound)) f0 &= ~(1u << b);
          if (!(key1[b] < s1.bound)) f1 &= ~(1u << b);
        }
        int t0 = quad_sum(__popc(f0)), t1 = quad_sum(__popc(f1));
        const bool full0 = s0.cnt + t0 > cap, full1 = s1.cnt + t1 > cap;
        if (__any_sync(0xffffffffu, full0 || full1)) {
          flush(full0, full1);
          // a merged row's candidates face its new bound
#pragma unroll
          for (int b = 0; b < 2 * kChunkJ; ++b) {
            if (full0 && (f0 >> b & 1) && !(key0[b] < s0.bound))
              f0 &= ~(1u << b);
            if (full1 && (f1 >> b & 1) && !(key1[b] < s1.bound))
              f1 &= ~(1u << b);
          }
          t0 = quad_sum(__popc(f0));
          t1 = quad_sum(__popc(f1));
        }
        int p0 = s0.cnt + quad_prefix(__popc(f0));
        int p1 = s1.cnt + quad_prefix(__popc(f1));
#pragma unroll
        for (int b = 0; b < 2 * kChunkJ; ++b) {
          if (f0 >> b & 1) cand[q * cap + p0++] = key0[b];
          if (f1 >> b & 1) cand[(q + 8) * cap + p1++] = key1[b];
        }
        s0.cnt += t0;
        s1.cnt += t1;
      }
    }
    flush(s0.cnt > 0, s1.cnt > 0);
    if (on_chip) {
      for (int lr = 0; lr < kRowsPerWarp && row0 + lr < m; ++lr)
        for (int e = lane; e < k; e += kWarp)
          split_lists[lr * k + e] = own[lr * k + e];
      __syncwarp();
    }
  }
  pipe.drain();
}

template <int HALVES, int METRIC>
static cudaError_t launch_wgmma_metric(int grid, cudaStream_t st,
                                       const void* x0, const void* x1,
                                       const float* xn, int64_t ldx,
                                       const void* y0, const void* y1,
                                       const float* yn, int64_t ldy, int m,
                                       int n, int kd, int k, int tps,
                                       uint64_t* lists) {
  auto kern = fused_topk_wgmma<HALVES, METRIC>;
  const SelectLayout l = select_layout<HALVES>(k);
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, l.bytes);
  if (err != cudaSuccess) return err;
  kern<<<grid, wg::kThreads, l.bytes, st>>>(
      static_cast<const uint16_t*>(x0), static_cast<const uint16_t*>(x1), xn,
      ldx, static_cast<const uint16_t*>(y0),
      static_cast<const uint16_t*>(y1), yn, ldy, m, n, kd, k, tps, l.cap,
      l.on_chip, lists);
  return cudaSuccess;
}

template <int HALVES>
static cudaError_t launch_wgmma(int metric, int grid, cudaStream_t st,
                                const void* x0, const void* x1,
                                const float* xn, int64_t ldx, const void* y0,
                                const void* y1, const float* yn, int64_t ldy,
                                int m, int n, int kd, int k, int tps,
                                uint64_t* lists) {
  switch (metric) {
    case kMetricL2:
      return launch_wgmma_metric<HALVES, kMetricL2>(
          grid, st, x0, x1, xn, ldx, y0, y1, yn, ldy, m, n, kd, k, tps,
          lists);
    case kMetricCosine:
      return launch_wgmma_metric<HALVES, kMetricCosine>(
          grid, st, x0, x1, xn, ldx, y0, y1, yn, ldy, m, n, kd, k, tps,
          lists);
    default:
      return launch_wgmma_metric<HALVES, kMetricInner>(
          grid, st, x0, x1, xn, ldx, y0, y1, yn, ldy, m, n, kd, k, tps,
          lists);
  }
}

// ---------------------------------------------------------------------------
// tier 'highest': common.cuh's FMA tile
// ---------------------------------------------------------------------------

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

// Tier 'highest' (2) takes common.cuh's operands; tiers 'default' (0)
// and 'high' (1) wgmma_tile.cuh's: bf16 rows (at 'high' the hi and lo
// halves), kd, ldx and ldy multiples of 8, 16-byte aligned bases, zeros in
// the padded depth. lists: u64 scratch [splits][m][k]; splits must equal
// ceil(n_tiles / ceil(n_tiles / splits)) so that no split is empty. grid:
// the persistent blocks of the wgmma split walk (not read at 'highest',
// whose grid is query tiles x splits). Returns the CUDA error of the
// launches (0 on success).
extern "C" int raft_fused_topk(int tier, int metric, const void* x0,
                               const void* x1, const float* xn, int64_t ldx,
                               const void* y0, const void* y1,
                               const float* yn, int64_t ldy, int m, int n,
                               int kd, int k, int splits, int grid,
                               void* lists, float* out_v, int* out_i,
                               void* stream) {
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
  const int64_t tiles = static_cast<int64_t>((m + BM - 1) / BM) * n_tiles;
  if (tier != kTierHighest &&
      (grid < 1 ||
       !wg::operands_ok(tier == kTierHigh, kd, ldx, ldy, x0, x1, y0, y1) ||
       2 * tiles >= (int64_t(1) << 31)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint64_t* ls = static_cast<uint64_t*>(lists);
  cudaError_t err;
  if (tier == kTierDefault)
    err = launch_wgmma<1>(metric, grid, st, x0, x1, xn, ldx, y0, y1, yn,
                          ldy, m, n, kd, k, tps, ls);
  else if (tier == kTierHigh)
    err = launch_wgmma<2>(metric, grid, st, x0, x1, xn, ldx, y0, y1, yn,
                          ldy, m, n, kd, k, tps, ls);
  else
    err = launch<kTierHighest>(metric, dim3((m + BM - 1) / BM, splits), k,
                               st, x0, x1, xn, ldx, y0, y1, yn, ldy, m, n,
                               kd, tps, ls);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(merge_splits_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(merge_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_splits_kernel<<<m, 256, merge_smem, st>>>(ls, splits, m, k, out_v,
                                                  out_i);
  return static_cast<int>(cudaGetLastError());
}
