// Shared insertion machinery of the port's top-k kernels (fused_topk.cu,
// topk_insert.cu): the packed (value, column) key, the warp-level merge of
// a candidate batch into a sorted best list, and the block-level merge of
// several sorted lists into one output row.
//
// Contract (raft_tpu matrix/epilogue.py:insert_drain): the result of a row
// is its k smallest candidates in (value, column) order, where values
// compare as IEEE floats (so -0.0 == +0.0 and the column decides). A NaN
// or +inf candidate never enters; slots left empty come out as (+inf, 0).
// The reference reaches that order by visiting columns in ascending order
// and inserting on a strict value compare; here blocks and warps visit
// columns in any order, so every compare is on the whole (value, column)
// key, and the result does not depend on the order or on the grid.
//
// Key: 64 bits, ascending key == ascending (value, column):
//   bits 63..32  the value's bits, order-folded (sign flipped for >= 0,
//                all bits flipped for < 0), with -0.0 folded onto +0.0
//   bits 31..1   the column (< 2^31)
//   bit  0       1 when the value was -0.0, so it comes back bit-exact
// kEmpty (all ones) marks an empty slot and is above every real key.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace raft_port {

constexpr uint64_t kEmpty = ~0ull;
constexpr int kWarp = 32;
constexpr int kMaxTopK = 256;     // raft_tpu epilogue.MAX_K

// false for NaN and +inf: such a candidate never enters a best list
__device__ __forceinline__ bool insertable(float v) {
  return v < __int_as_float(0x7f800000);
}

__device__ __forceinline__ uint64_t pack_key(float v, int col) {
  uint32_t b = __float_as_uint(v);
  const uint32_t negz = b == 0x80000000u;
  if (negz) b = 0u;
  const uint32_t ord = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<uint64_t>(ord) << 32) |
         (static_cast<uint64_t>(static_cast<uint32_t>(col)) << 1) | negz;
}

__device__ __forceinline__ float key_value(uint64_t key) {
  const uint32_t ord = static_cast<uint32_t>(key >> 32);
  uint32_t b = (ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord;
  if (key & 1ull) b = 0x80000000u;
  return __uint_as_float(b);
}

__device__ __forceinline__ int key_col(uint64_t key) {
  return static_cast<int>(static_cast<uint32_t>(key) >> 1);
}

// Append `key` (when `take`) to the warp's candidate batch at `count`, in
// lane order; returns the new count. Every lane of the warp must call it.
__device__ __forceinline__ int warp_append(uint64_t* cand, int count,
                                           bool take, uint64_t key) {
  const unsigned lane = threadIdx.x & (kWarp - 1);
  const unsigned mask = __ballot_sync(0xffffffffu, take);
  if (take) cand[count + __popc(mask & ((1u << lane) - 1u))] = key;
  return count + __popc(mask);
}

// Number of entries of the sorted list a[0, len) below key.
__device__ __forceinline__ int lower_bound(const uint64_t* a, int len,
                                           uint64_t key) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Merge a batch of c <= kMergeBatch candidates (distinct keys, below
// kEmpty, none already in the list) into the sorted list best[0, k),
// keeping the k smallest. The batch is first sorted in place: a key goes to
// its rank, the number of smaller keys in the batch. A key's place in the
// merged order is then its rank in its own sorted run plus the number of
// smaller keys in the other, found by binary search, so every slot has
// exactly one writer and the result is the same whatever order the batch
// came in. `best` may be in global or shared memory; `tmp` (k keys) and
// `cand` are shared, and cand comes back sorted. One warp calls it; it
// starts with a __syncwarp, so the lanes' earlier writes to cand and best
// are visible to every lane. Returns the new k-th key, the bound of the
// next batch.
constexpr int kMergeBatch = 4 * kWarp;

__device__ __forceinline__ uint64_t warp_merge(uint64_t* best, uint64_t* tmp,
                                               uint64_t* cand, int c, int k) {
  constexpr int kPer = kMergeBatch / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  __syncwarp();
  for (int e = lane; e < k; e += kWarp) tmp[e] = best[e];
  uint64_t key[kPer];
  int rank[kPer];
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int i = lane + t * kWarp;
    key[t] = i < c ? cand[i] : kEmpty;
    rank[t] = 0;
    if (i < c)
      for (int j = 0; j < c; ++j) rank[t] += cand[j] < key[t];
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    if (lane + t * kWarp >= c) break;
    cand[rank[t]] = key[t];
    const int r = rank[t] + lower_bound(tmp, k, key[t]);
    if (r < k) best[r] = key[t];
  }
  __syncwarp();
  for (int e = lane; e < k; e += kWarp) {
    const uint64_t old = tmp[e];
    const int r = e + lower_bound(cand, c, old);
    if (r < k) best[r] = old;
  }
  __syncwarp();
  return best[k - 1];
}

// The k smallest keys of nl sorted lists (lists[l * stride + e], e < k),
// written best-first to out_v/out_i (k each) as (value, column), with
// (+inf, 0) in the slots past the last real key. Real keys are distinct
// across lists; an entry's output slot is its index plus the number of
// smaller keys in every other list. Every thread of the block calls it.
__device__ __forceinline__ void block_merge_lists(const uint64_t* lists,
                                                  int nl, int stride, int k,
                                                  float* out_v, int* out_i) {
  int real = 0;
  for (int l = 0; l < nl; ++l)
    real += lower_bound(lists + static_cast<int64_t>(l) * stride, k, kEmpty);
  if (real > k) real = k;
  for (int p = threadIdx.x; p < nl * k; p += blockDim.x) {
    const int l = p / k, e = p % k;
    const uint64_t key = lists[static_cast<int64_t>(l) * stride + e];
    if (key == kEmpty) continue;
    int r = e;
    for (int o = 0; o < nl && r < k; ++o)
      if (o != l)
        r += lower_bound(lists + static_cast<int64_t>(o) * stride, k, key);
    if (r < k) {
      out_v[r] = key_value(key);
      out_i[r] = key_col(key);
    }
  }
  for (int r = real + threadIdx.x; r < k; r += blockDim.x) {
    out_v[r] = __int_as_float(0x7f800000);
    out_i[r] = 0;
  }
}

}  // namespace raft_port
