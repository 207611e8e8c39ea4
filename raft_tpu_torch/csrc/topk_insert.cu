// Bound-gated sorted insertion over a materialised matrix: per row, the k
// smallest (value, column) pairs of v (or of -v for select_max), as
// (f32 value, int32 column), best-first, empty slots (+inf, 0).
//
// Replaces raft_tpu/matrix/topk_insert.py:_insert_kernel (:48), launched
// by _insert_padded (:76), whose body is the epilogue.insert_drain strip
// loop (matrix/epilogue.py:322). The reference pads rows and columns with
// NaN, which never inserts; here ragged edges are never read. The
// degenerate-row check and its re-answer stay outside the kernel, in
// raft_tpu_torch/matrix/topk_insert.py, as in the reference.
//
// Bound on an H100 SXM: bytes, one read of the matrix (the output is k
// columns a row). Design: one block a row; its 8 warps take 128-column
// batches of the row (4 coalesced loads a lane), keep the candidates below
// the filter bound, and merge each batch into the warp's sorted list in
// shared memory (topk_common.cuh:warp_merge). A batch with no candidate
// costs its loads and one compare a column, so the bound decides the cost,
// and it is made independent of the row's order from real keys alone:
// 1. A seed. The block first reads a sample of the row, 8 chunks of 32
//    columns spread evenly over it (coalesced, never overlapping), and
//    takes the k-th smallest insertable key of the sample: the k smallest
//    keys of any k real keys of the row bound its own k-th key from above,
//    so every key of the result is at or below it. A sample with fewer
//    than k insertable keys gives no seed. A warp sorts its chunk by
//    shuffles; a key's rank among the 256 is found by binary searches.
// 2. A shared bound. The block's bound starts just above the seed; a warp
//    whose own k-th key falls below it publishes it (an atomic min on the
//    64-bit key in shared memory), and every warp filters its batches
//    against the smaller of its own k-th key and the block's. Each warp's
//    list holds real keys, so its k-th key bounds the row's k-th key.
// 3. A two-ended walk. Visit t goes to batch t / 2 from the front (t even)
//    or from the back (t odd), warp w taking visits w, w + 8, ...: rows
//    sorted either way meet their smallest keys in the first round.
// Every key of the result passes every bound, so the result is exact. At
// the end the block merges its 8 lists into the output row.

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "topk_common.cuh"

namespace raft_port {

constexpr int kInsWarps = 8;
constexpr int kInsThreads = kInsWarps * kWarp;
constexpr int kInsPer = 4;                        // columns a lane loads
constexpr int kInsBatch = kInsPer * kWarp;        // columns a warp batch
static_assert(kInsBatch <= kMergeBatch, "warp_merge takes a whole batch");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// The key of column col (< len) of row rp, and whether it may enter.
template <typename T, bool MIN>
__device__ __forceinline__ bool column_key(const T* rp, int col,
                                           uint64_t& key) {
  const float x = to_f32(rp[col]);
  const float d = MIN ? x : -x;                // the drain extracts minima
  if (!insertable(d)) return false;
  key = pack_key(d, col);
  return true;
}

// The 32 keys of a warp, a key a lane, sorted ascending across the lanes
// (bitonic sort by shuffles).
__device__ __forceinline__ uint64_t warp_sort32(uint64_t key) {
  const int lane = threadIdx.x % kWarp;
#pragma unroll
  for (int size = 2; size <= kWarp; size <<= 1)
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      const uint64_t other = __shfl_xor_sync(0xffffffffu, key, stride);
      const bool low = ((lane & stride) == 0) == ((lane & size) == 0);
      key = (low == (other < key)) ? other : key;
    }
  return key;
}

// Thread p of the block holds entry p % 32 of list p / 32 of the
// kInsWarps sorted 32-key lists at lists[l * kInsBatch + e] (distinct
// real keys first, then kEmpty): the thread whose key has rank r in
// their union returns it, every other thread kEmpty.
__device__ __forceinline__ uint64_t block_rank_key(const uint64_t* lists,
                                                   int r) {
  const int l = threadIdx.x / kWarp, e = threadIdx.x % kWarp;
  const uint64_t key = lists[l * kInsBatch + e];
  if (key == kEmpty || e > r) return kEmpty;
  int rank = e;
  for (int o = 0; o < kInsWarps && rank <= r; ++o)
    if (o != l) rank += lower_bound(lists + o * kInsBatch, kWarp, key);
  return rank == r ? key : kEmpty;
}

template <typename T, bool MIN>
__global__ void __launch_bounds__(kInsThreads)
    topk_insert_kernel(const T* v, int64_t ld, int len, int k, float* out_v,
                       int* out_i) {
  extern __shared__ uint64_t smem[];
  __shared__ unsigned long long block_bound;   // exclusive
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int64_t row = blockIdx.x;
  uint64_t* lists = smem;                                  // [warps][k]
  uint64_t* best = lists + warp * k;
  uint64_t* tmp = smem + kInsWarps * k + warp * k;         // [warps][k]
  uint64_t* cand = smem + 2 * kInsWarps * k + warp * kInsBatch;
  const T* rp = v + row * ld;

  // 1. the seed: the k-th smallest key of the sample, one 32-column chunk
  // a warp, each chunk sorted in its warp and held in its candidate buffer
  const int chunks = min(kInsWarps, len / kWarp);
  for (int e = lane; e < k; e += kWarp) best[e] = kEmpty;
  if (threadIdx.x == 0) block_bound = kEmpty;
  uint64_t key = kEmpty;
  if (warp < chunks) column_key<T, MIN>(rp, warp * (len / chunks) + lane, key);
  cand[lane] = warp_sort32(key);
  __syncthreads();
  if (chunks * kWarp >= k) {
    const uint64_t seed = block_rank_key(smem + 2 * kInsWarps * k, k - 1);
    if (seed != kEmpty) block_bound = seed + 1;     // one thread at most
  }
  __syncthreads();

  // 2. the two-ended walk under the shared bound
  const int nb = (len + kInsBatch - 1) / kInsBatch;
  volatile unsigned long long* shared = &block_bound;
  uint64_t bound = kEmpty;
  for (int t = warp; t < nb; t += kInsWarps) {
    const int c0 = ((t & 1) ? nb - 1 - (t >> 1) : (t >> 1)) * kInsBatch;
    float x[kInsPer];
#pragma unroll
    for (int i = 0; i < kInsPer; ++i) {
      const int col = c0 + i * kWarp + lane;
      x[i] = col < len ? to_f32(rp[col]) : __int_as_float(0x7fc00000);
    }
    const uint64_t block = *shared;
    const uint64_t lim = block < bound ? block : bound;
    int count = 0;
#pragma unroll
    for (int i = 0; i < kInsPer; ++i) {
      const float d = MIN ? x[i] : -x[i];      // the drain extracts minima
      uint64_t key = 0;
      bool take = false;
      if (insertable(d)) {
        key = pack_key(d, c0 + i * kWarp + lane);
        take = key < lim;
      }
      count = warp_append(cand, count, take, key);
    }
    if (count) {
      bound = warp_merge(best, tmp, cand, count, k);
      if (lane == 0 && bound < lim) atomicMin(&block_bound, bound);
    }
  }
  __syncthreads();
  block_merge_lists(lists, kInsWarps, k, k, out_v + row * k, out_i + row * k);
}

template <typename T>
static void launch(int select_min, int rows, size_t smem, cudaStream_t st,
                   const void* v, int64_t ld, int len, int k, float* out_v,
                   int* out_i) {
  const T* p = static_cast<const T*>(v);
  if (select_min)
    topk_insert_kernel<T, true><<<rows, kInsThreads, smem, st>>>(
        p, ld, len, k, out_v, out_i);
  else
    topk_insert_kernel<T, false><<<rows, kInsThreads, smem, st>>>(
        p, ld, len, k, out_v, out_i);
}

}  // namespace raft_port

// dtype: 0 f32, 1 bf16, 2 f16. Returns the CUDA error of the launch.
extern "C" int raft_topk_insert(int dtype, int select_min, const void* v,
                                int64_t ld, int rows, int len, int k,
                                float* out_v, int* out_i, void* stream) {
  using namespace raft_port;
  if (dtype < 0 || dtype > 2 || rows < 1 || len < 1 || k < 1 ||
      k > kMaxTopK || k > len || ld < len)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (2 * kInsWarps * static_cast<size_t>(k) + kInsWarps * kInsBatch) *
      sizeof(uint64_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(select_min, rows, smem, st, v, ld, len, k, out_v, out_i);
  else if (dtype == 1)
    launch<__nv_bfloat16>(select_min, rows, smem, st, v, ld, len, k, out_v,
                          out_i);
  else
    launch<__half>(select_min, rows, smem, st, v, ld, len, k, out_v, out_i);
  return static_cast<int>(cudaGetLastError());
}
