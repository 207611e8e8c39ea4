// One Lloyd data pass: per row of X the clamped min squared-L2 distance to
// the centroids Y and its first-min label, plus the per-centroid sums of
// the assigned rows [n, k] and their counts [n].
//
// Replaces raft_tpu/linalg/contractions.py:_lloyd_kernel (:931) and
// _lloyd_kernel_split (:963), launched by _fused_lloyd_padded (:1076) and
// _fused_lloyd_padded_split (:1030) — the k-means north-star kernel. As
// there, distances are taken as finite (k-means on non-finite data is
// undefined), rows >= m never count, and at tier 'high' the summed rows
// are the hi and lo halves (:996-1001): each row adds hi + lo, which f32
// holds exactly (lo is a multiple of the f32 row's last place). At tier
// 'default' the summed rows are the bf16-rounded ones, as the reference's
// one-pass one-hot product makes them. Counts are exact, and every result
// is bitwise the same from run to run and for every argmin grid.
//
// The hard part: the TPU accumulates sums and counts in an output block
// that a *sequential* grid revisits (:935-938, "arbitrary" semantics at
// :1064). Hopper blocks run in parallel in no order, and float atomics
// would make the sums change from run to run. Design, in two stages:
//
// 1. Argmin. Tiers 'default' and 'high' run wgmma_tile.cuh's tensor-core
//    tile (bf16, one pass or bf16x3, f32 accumulators) in its row-owning
//    walk: block b of G (one a multiprocessor) takes row tiles b, b + G,
//    ..., and inside each all its column tiles in order. The epilogue
//    works on the accumulator fragment in registers: it applies the L2
//    formula of pairwise_tile's epilogue and folds each of the thread's
//    two rows into a running (min, argmin) under common.cuh's strict
//    order (smaller value, then smaller index; wgmma_tile.cuh:fold_min),
//    across column tiles; at the row tile's end the four lanes of a quad
//    combine by two shuffles (quad_argmin) and write val (clamped at 0,
//    NaN kept) and idx. It reads the column norms after the product and
//    branches around columns past n: minonly.cu's branch-free form
//    (fold_l2_tile, the norms loaded before the product) measured 2-4%
//    slower on this row walk. Tier 'highest' (no
//    exact f32 tensor-core product) runs common.cuh's FMA block_argmin on
//    the same row walk. The order makes the labels independent of G.
// 2. Sums, from the labels alone (so they cannot depend on G either):
//    a. a stable counting sort groups the rows by label. A warp a chunk
//       of rows counts its labels (integer counts, any order), a scan over
//       (label, chunk) in a fixed order gives each (label, chunk) its
//       first slot, and the warp places each row at its label's slot plus
//       its rank among the chunk's earlier rows of that label
//       (__match_any_sync). The result is a CSR whose rows are clusters
//       and whose entries are data-row ids in ascending order; the
//       differences of its indptr are the counts.
//    b. segsum.cuh's split, shared with csr_spmm.cu, sums each cluster's
//       rows in that order: a group of lpe lanes takes a cluster's first
//       kSeg rows, each lane a 16-byte vector of the columns, eight rows
//       in flight (the groups launch first: theirs is the longer walk);
//       chunk warps take the rest, kSeg sorted entries each, into
//       partials; a fix-up, a warp a cluster, adds a long cluster's
//       partials in chunk order.
// No float atomics, no host sync; scratch is O(m + chunks (n + k)).
//
// Bound on an H100 SXM: operations. At 1M x 128, k = 1024, tier 'high' the
// distance is 8.1e11 bf16 products, three a pair (0.81 ms at 989 TFLOP/s);
// the sums read X's halves once more (0.5 GB, 0.16 ms at 3.35 TB/s).

#include "common.cuh"
#include "segsum.cuh"
#include "wgmma_tile.cuh"

namespace raft_port {

constexpr int kSeg = 256;        // sorted rows a warp of the sums takes
constexpr int kSumThreads = 256;
constexpr int kScanThreads = 1024;

// ---------------------------------------------------------------------------
// stage 1: argmin
// ---------------------------------------------------------------------------

__device__ __forceinline__ void write_min(float* val, int* idx, int r, int m,
                                          float bv, int bi) {
  if (r < m) {
    val[r] = bv < 0.f ? 0.f : bv;       // NaN stays NaN
    idx[r] = bi;
  }
}

template <int HALVES>
__global__ void __launch_bounds__(wg::kThreads, 1)
    lloyd_argmin_wgmma(const uint16_t* x0, const uint16_t* x1,
                       const float* xn, int64_t ldx, const uint16_t* y0,
                       const uint16_t* y1, const float* yn, int64_t ldy,
                       float* val, int* idx, int m, int n, int k) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  wg::Pipe<HALVES, wg::kRowWalk> pipe(x0, x1, ldx, y0, y1, ldy, m, n, k,
                                      smem);
  const int row_tiles = (m + wg::kBM - 1) / wg::kBM;
  const int rl = wg::frag_row(0);         // this thread's rows rl, rl + 8
  float d[wg::kAcc];
  for (int rt = blockIdx.x; rt < row_tiles; rt += gridDim.x) {
    const int row0 = rt * wg::kBM;
    const float xt0 = row0 + rl < m ? xn[row0 + rl] : 0.f;
    const float xt1 = row0 + rl + 8 < m ? xn[row0 + rl + 8] : 0.f;
    float bv0 = __int_as_float(0x7f800000), bv1 = bv0;   // +inf
    int bi0 = 0x7fffffff, bi1 = 0x7fffffff;
    for (int ct = 0; ct < pipe.tiles_n; ++ct) {
      pipe.cross(d);
      const int col0 = ct * wg::kBN;
#pragma unroll
      for (int j = 0; j < wg::kBN / 8; ++j) {
        const int c = col0 + wg::frag_col(4 * j);
        if (c < n) {
          const float yt = yn[c];
          wg::fold_min(metric_value<kMetricL2>(d[4 * j], xt0, yt), c, bv0,
                       bi0);
          wg::fold_min(metric_value<kMetricL2>(d[4 * j + 2], xt1, yt), c,
                       bv1, bi1);
        }
        if (c + 1 < n) {
          const float yt = yn[c + 1];
          wg::fold_min(metric_value<kMetricL2>(d[4 * j + 1], xt0, yt), c + 1,
                       bv0, bi0);
          wg::fold_min(metric_value<kMetricL2>(d[4 * j + 3], xt1, yt), c + 1,
                       bv1, bi1);
        }
      }
    }
    wg::quad_argmin(bv0, bi0, bv1, bi1);
    if ((threadIdx.x & 3) == 0) {
      write_min(val, idx, row0 + rl, m, bv0, bi0);
      write_min(val, idx, row0 + rl + 8, m, bv1, bi1);
    }
  }
  pipe.drain();
}

__global__ void __launch_bounds__(THREADS)
    lloyd_argmin_fma(const void* x0, const float* xn, int64_t ldx,
                     const void* y0, const float* yn, int64_t ldy,
                     float* val, int* idx, int m, int n, int k) {
  __shared__ TileSmem<kTierHighest> s;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int64_t tile = blockIdx.x; tile * BM < m; tile += gridDim.x) {
    const int row0 = static_cast<int>(tile * BM);
    float bv[TM];
    int bi[TM];
    block_argmin<kTierHighest, kMetricL2, true>(bv, bi, s, x0, nullptr, xn,
                                                ldx, row0, m, y0, nullptr,
                                                yn, ldy, n, k);
    if (tx == 0)
#pragma unroll
      for (int i = 0; i < TM; ++i)
        write_min(val, idx, row0 + sub_index(ty, i), m, bv[i], bi[i]);
  }
}

// ---------------------------------------------------------------------------
// stage 2a: the stable counting sort of the rows by label
// ---------------------------------------------------------------------------

// Label of row r for the sort; -1 (no cluster) past m or out of range.
__device__ __forceinline__ int sort_label(const int* idx, int64_t r,
                                          int64_t r1, int n) {
  const int lab = r < r1 ? idx[r] : -1;
  return static_cast<unsigned>(lab) < static_cast<unsigned>(n) ? lab : -1;
}

// Warp w counts the labels of rows [w chunk, (w + 1) chunk) into hist[w]:
// 32 rows a step, one read-modify-write a distinct label (its lowest lane).
__global__ void __launch_bounds__(kSumThreads)
    lloyd_hist(const int* idx, int* hist, int m, int n, int chunk,
               int chunks) {
  const int w = (blockIdx.x * kSumThreads + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (w >= chunks) return;
  int* h = hist + static_cast<int64_t>(w) * n;
  for (int c = lane; c < n; c += kWarp) h[c] = 0;
  __syncwarp();
  const int64_t r0 = static_cast<int64_t>(w) * chunk;
  const int64_t r1 = r0 + chunk < m ? r0 + chunk : m;
  for (int64_t r = r0; r < r1; r += kWarp) {
    const int lab = sort_label(idx, r + lane, r1, n);
    const unsigned peers = __match_any_sync(kFull, lab);
    if (lab >= 0 && lane == __ffs(peers) - 1) h[lab] += __popc(peers);
    __syncwarp();
  }
}

// In place, hist[ch][c] becomes the rows of label c in chunks before ch;
// total[c] the rows of label c. A block takes 32 labels (a lane each) and
// splits the chunks among its 32 warps.
__global__ void __launch_bounds__(kScanThreads)
    lloyd_scan_chunks(int* hist, int* total, int n, int chunks) {
  __shared__ int part[kWarp][kWarp + 1];
  const int lane = threadIdx.x % kWarp, q = threadIdx.x / kWarp;
  const int c = blockIdx.x * kWarp + lane;
  const int per = (chunks + kWarp - 1) / kWarp;
  const int ch0 = q * per, ch1 = ch0 + per < chunks ? ch0 + per : chunks;
  int s = 0;
  if (c < n)
    for (int ch = ch0; ch < ch1; ++ch)
      s += hist[static_cast<int64_t>(ch) * n + c];
  part[q][lane] = s;
  __syncthreads();
  int base = 0;
  for (int p = 0; p < q; ++p) base += part[p][lane];
  if (c >= n) return;
  for (int ch = ch0; ch < ch1; ++ch) {
    int* h = hist + static_cast<int64_t>(ch) * n + c;
    const int v = *h;
    *h = base;
    base += v;
  }
  if (q == kWarp - 1) total[c] = base;
}

// start[c] = the rows of labels below c, start[n] = all labelled rows;
// counts[c] = total[c]. One block: thread t takes a run of labels.
__global__ void __launch_bounds__(kScanThreads)
    lloyd_scan_labels(const int* total, int* start, float* counts, int n) {
  __shared__ int warp_sum[kScanThreads / kWarp];
  const int lane = threadIdx.x % kWarp, q = threadIdx.x / kWarp;
  const int per = (n + kScanThreads - 1) / kScanThreads;
  const int c0 = threadIdx.x * per;
  const int c1 = c0 + per < n ? c0 + per : n;
  int s = 0;
  for (int c = c0; c < c1; ++c) s += total[c];
  int incl = s;                                    // scan inside the warp
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == kWarp - 1) warp_sum[q] = incl;
  __syncthreads();
  int base = incl - s;
  for (int p = 0; p < q; ++p) base += warp_sum[p];
  for (int c = c0; c < c1; ++c) {
    start[c] = base;
    counts[c] = static_cast<float>(total[c]);
    base += total[c];
  }
  if (threadIdx.x == kScanThreads - 1) start[n] = base;
}

// Warp w places the rows of its chunk in order: row r of label c goes to
// order[start[c] + hist[w][c] + its rank among the step's rows of label
// c], and hist[w][c] advances past them.
__global__ void __launch_bounds__(kSumThreads)
    lloyd_place(const int* idx, int* hist, const int* start, int* order,
                int m, int n, int chunk, int chunks) {
  const int w = (blockIdx.x * kSumThreads + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (w >= chunks) return;
  int* h = hist + static_cast<int64_t>(w) * n;
  const int64_t r0 = static_cast<int64_t>(w) * chunk;
  const int64_t r1 = r0 + chunk < m ? r0 + chunk : m;
  for (int64_t r = r0; r < r1; r += kWarp) {
    const int lab = sort_label(idx, r + lane, r1, n);
    const unsigned peers = __match_any_sync(kFull, lab);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (lab >= 0 && lane == leader) {
      base = h[lab];
      h[lab] = base + __popc(peers);
    }
    base = __shfl_sync(kFull, base, leader);
    if (lab >= 0)
      order[start[lab] + base + __popc(peers & ((1u << lane) - 1))] =
          static_cast<int>(r + lane);
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// stage 2b: each cluster's rows summed in row order
// ---------------------------------------------------------------------------

// VW columns of one X row from column col, as f32: the bf16 value (HALVES
// 1), hi + lo (HALVES 2, exact in f32) or the f32 value; 16-byte loads
// where VW is 8 (bf16) or 4 (f32).
template <typename E, int HALVES, int VW>
__device__ __forceinline__ void load_row(float (&v)[VW], const E* x0,
                                         const E* x1, int64_t off) {
  if constexpr (sizeof(E) == 2) {
    static_assert(VW == 8, "bf16 rows are read 8 columns at a time");
    // element 2u of a 16-byte vector is the low half of its word u
    const uint4 h = __ldg(reinterpret_cast<const uint4*>(x0) + off / 8);
    const uint32_t hw[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v[2 * u] = __uint_as_float(hw[u] << 16);
      v[2 * u + 1] = __uint_as_float(hw[u] & 0xffff0000u);
    }
    if constexpr (HALVES == 2) {
      const uint4 l = __ldg(reinterpret_cast<const uint4*>(x1) + off / 8);
      const uint32_t lw[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[2 * u] += __uint_as_float(lw[u] << 16);
        v[2 * u + 1] += __uint_as_float(lw[u] & 0xffff0000u);
      }
    }
  } else {
    const float* p = reinterpret_cast<const float*>(x0) + off;
    if constexpr (VW == 4) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
    } else {
#pragma unroll
      for (int u = 0; u < VW; ++u) v[u] = __ldg(p + u);
    }
  }
}

// segsum.cuh's source for the sums: entry j of the cluster CSR is data row
// order[j], with no weight; its row is read as load_row gives it.
template <typename E, int HALVES, int VW>
struct ClusterRows {
  using T = float;
  using W = seg::Unit;
  static constexpr int kVW = VW;
  const int* order;
  const E* x0;
  const E* x1;
  int64_t ldx;

  __device__ __forceinline__ int id(int64_t j) const {
    return __ldg(order + j);
  }
  __device__ __forceinline__ seg::Unit weight(int64_t) const { return {}; }
  __device__ __forceinline__ void load(float (&v)[VW], int id,
                                       int col) const {
    load_row<E, HALVES, VW>(v, x0, x1, static_cast<int64_t>(id) * ldx + col);
  }
  __device__ __forceinline__ void store(float* dst, const float (&v)[VW],
                                        int col, int k) const {
#pragma unroll
    for (int u = 0; u < VW; ++u)
      if (col + u < k) dst[u] = v[u];
  }
};

// Warps [0, group_warps) are row groups of 32 / lpe clusters each (their
// walk of up to kSeg rows is the longer, so they start first), the rest
// chunk warps, one per kSeg sorted rows.
template <typename E, int HALVES, int VW>
__global__ void __launch_bounds__(kSumThreads)
    lloyd_sums(const int* __restrict__ start,
               ClusterRows<E, HALVES, VW> rows, float* __restrict__ sums,
               float* __restrict__ part, int64_t group_warps, int n, int k,
               int lpe) {
  const int64_t w =
      (static_cast<int64_t>(blockIdx.x) * kSumThreads + threadIdx.x) / kWarp;
  if (w < group_warps)
    seg::rows_sum(start, rows, sums, k, n, k, kSeg, w * (kWarp / lpe), lpe);
  else
    seg::chunk_sum(start, rows, part, n, k, kSeg, w - group_warps);
}

// sums[c] += the partials of a long cluster's chunks, in chunk order: a
// warp a cluster.
__global__ void __launch_bounds__(kSumThreads)
    lloyd_fixup(const int* __restrict__ start, float* __restrict__ sums,
                const float* __restrict__ part, int n, int k) {
  const int64_t c =
      (static_cast<int64_t>(blockIdx.x) * kSumThreads + threadIdx.x) / kWarp;
  if (c >= n) return;
  int64_t q0;
  int nq;
  seg::partial_chunks(start[c], start[c + 1], kSeg, q0, nq);
  if (nq > 0) seg::add_partials(sums + c * k, part, q0, nq, k);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

static int64_t blocks_for(int64_t warps) {
  constexpr int64_t per_block = kSumThreads / kWarp;
  return (warps + per_block - 1) / per_block;
}

template <typename E, int HALVES, int VW>
static void launch_sums(const int* start, const int* order, const void* x0,
                        const void* x1, int64_t ldx, float* sums,
                        float* part, int n_chunks, int n, int k,
                        cudaStream_t st) {
  const int lpe = seg::lanes_for(k < kWarp * VW ? k : kWarp * VW, VW);
  const int64_t group_warps = (n + kWarp / lpe - 1) / (kWarp / lpe);
  const ClusterRows<E, HALVES, VW> rows{order, static_cast<const E*>(x0),
                                        static_cast<const E*>(x1), ldx};
  lloyd_sums<E, HALVES, VW><<<blocks_for(group_warps + n_chunks),
                              kSumThreads, 0, st>>>(
      start, rows, sums, part, group_warps, n, k, lpe);
}

template <int HALVES>
static cudaError_t launch_argmin_wgmma(const void* x0, const void* x1,
                                       const float* xn, int64_t ldx,
                                       const void* y0, const void* y1,
                                       const float* yn, int64_t ldy,
                                       float* val, int* idx, int grid, int m,
                                       int n, int k, cudaStream_t st) {
  auto kern = lloyd_argmin_wgmma<HALVES>;
  constexpr int smem = wg::Layout<HALVES>::kRingBytes + 1024;  // + alignment
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, wg::kThreads, smem, st>>>(
      static_cast<const uint16_t*>(x0), static_cast<const uint16_t*>(x1), xn,
      ldx, static_cast<const uint16_t*>(y0),
      static_cast<const uint16_t*>(y1), yn, ldy, val, idx, m, n, k);
  return cudaSuccess;
}

}  // namespace raft_port

// Tiers 'default' (0) and 'high' (1) take bf16 rows (x0/y0; at 'high'
// also the lo halves x1/y1, laid out as x0/y0) with kd, ldx and ldy
// multiples of 8, 16-byte aligned bases and zeros in columns k .. kd;
// tier 'highest' (2) takes f32 rows (kd == k). kd: the argmin's depth; k:
// the sums' width. grid: the argmin's persistent blocks. iscr: int
// scratch of chunks x n + n + (n + 1) + m words, chunks = ceil(m /
// chunk); part: f32 scratch of (m / 256 + 1) x k. Returns the CUDA error
// of the launches (0 on success).
extern "C" int raft_fused_lloyd(int tier, const void* x0, const void* x1,
                                const float* xn, int64_t ldx, const void* y0,
                                const void* y1, const float* yn, int64_t ldy,
                                float* sums, float* counts, float* val,
                                int* idx, int* iscr, float* part, int grid,
                                int m, int n, int kd, int k, int chunk,
                                void* stream) {
  using namespace raft_port;
  const bool high = tier == kTierHigh;
  if (tier < 0 || tier > 2 || m < 1 || n < 1 || k < 1 || kd < k ||
      grid < 1 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = static_cast<int64_t>((m + wg::kBM - 1) / wg::kBM) *
                        ((n + wg::kBN - 1) / wg::kBN);
  if (tier != kTierHighest &&
      (!wg::operands_ok(high, kd, ldx, ldy, x0, x1, y0, y1) ||
       2 * tiles >= (int64_t(1) << 31)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (tier == kTierHighest)
    lloyd_argmin_fma<<<grid, THREADS, 0, st>>>(x0, xn, ldx, y0, yn, ldy, val,
                                               idx, m, n, k);
  else if (high)
    err = launch_argmin_wgmma<2>(x0, x1, xn, ldx, y0, y1, yn, ldy, val, idx,
                                 grid, m, n, kd, st);
  else
    err = launch_argmin_wgmma<1>(x0, x1, xn, ldx, y0, y1, yn, ldy, val, idx,
                                 grid, m, n, kd, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int chunks = (m + chunk - 1) / chunk;
  int* hist = iscr;
  int* total = hist + static_cast<int64_t>(chunks) * n;
  int* start = total + n;
  int* order = start + n + 1;
  lloyd_hist<<<blocks_for(chunks), kSumThreads, 0, st>>>(idx, hist, m, n,
                                                          chunk, chunks);
  lloyd_scan_chunks<<<(n + kWarp - 1) / kWarp, kScanThreads, 0, st>>>(
      hist, total, n, chunks);
  lloyd_scan_labels<<<1, kScanThreads, 0, st>>>(total, start, counts, n);
  lloyd_place<<<blocks_for(chunks), kSumThreads, 0, st>>>(
      idx, hist, start, order, m, n, chunk, chunks);
  const int n_chunks = m / kSeg + 1;
  if (tier == kTierHighest) {
    if (k % 4 == 0 && ldx % 4 == 0 && wg::aligned16(x0))
      launch_sums<float, 1, 4>(start, order, x0, x1, ldx, sums, part,
                               n_chunks, n, k, st);
    else
      launch_sums<float, 1, 1>(start, order, x0, x1, ldx, sums, part,
                               n_chunks, n, k, st);
  } else if (high) {
    launch_sums<uint16_t, 2, 8>(start, order, x0, x1, ldx, sums, part,
                                n_chunks, n, k, st);
  } else {
    launch_sums<uint16_t, 1, 8>(start, order, x0, x1, ldx, sums, part,
                                n_chunks, n, k, st);
  }
  lloyd_fixup<<<blocks_for(n), kSumThreads, 0, st>>>(start, sums, part, n,
                                                      k);
  return static_cast<int>(cudaGetLastError());
}
