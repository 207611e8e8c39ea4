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
// batches of the row in turn (4 coalesced loads a lane), keep the
// candidates below their own k-th key, and merge each batch into a sorted
// list in shared memory (topk_common.cuh:warp_merge). A batch with no
// candidate costs its loads and one compare a column; after the first few
// batches of a random row almost every batch is dead. A row sorted
// against the selection is the worst case: every batch merges. At the end
// the block merges its 8 lists into the output row.

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

template <typename T, bool MIN>
__global__ void __launch_bounds__(kInsThreads)
    topk_insert_kernel(const T* v, int64_t ld, int len, int k, float* out_v,
                       int* out_i) {
  extern __shared__ uint64_t smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int64_t row = blockIdx.x;
  uint64_t* lists = smem;                                  // [warps][k]
  uint64_t* best = lists + warp * k;
  uint64_t* tmp = smem + kInsWarps * k + warp * k;         // [warps][k]
  uint64_t* cand = smem + 2 * kInsWarps * k + warp * kInsBatch;
  for (int e = lane; e < k; e += kWarp) best[e] = kEmpty;
  __syncwarp();
  uint64_t bound = kEmpty;
  const T* rp = v + row * ld;
  for (int c0 = warp * kInsBatch; c0 < len; c0 += kInsWarps * kInsBatch) {
    float x[kInsPer];
#pragma unroll
    for (int t = 0; t < kInsPer; ++t) {
      const int col = c0 + t * kWarp + lane;
      x[t] = col < len ? to_f32(rp[col]) : __int_as_float(0x7fc00000);
    }
    int count = 0;
#pragma unroll
    for (int t = 0; t < kInsPer; ++t) {
      const float d = MIN ? x[t] : -x[t];      // the drain extracts minima
      uint64_t key = 0;
      bool take = false;
      if (insertable(d)) {
        key = pack_key(d, c0 + t * kWarp + lane);
        take = key < bound;
      }
      count = warp_append(cand, count, take, key);
    }
    if (count) bound = warp_merge(best, tmp, cand, count, k);
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
