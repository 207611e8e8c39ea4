// Radix emit: per row of int32 sortable keys with threshold T and tie
// quota n_tie (radix_threshold.cu), the k winner columns: every key < T in
// column order in slots [0, k - n_tie), then the first n_tie keys == T in
// column order in slots [k - n_tie, k).
//
// Replaces raft_tpu/matrix/radix_select.py:_emit_kernel (:332) and its
// _emit_chunk_body (:393), launched by _radix_ranks (:524). The slot rule
// is _emit_chunk_body's (:421-425): rank = running strict count for a key
// below T, (k - n_tie) + running tie count for a tie that is still inside
// the quota. The reference builds the slots as one-hot contractions on the
// MXU and skips dead chunks from per-chunk counts made in XLA; here a
// count kernel makes those counts per block, and the emit kernel writes
// each winner's column straight to its slot.
//
// Bound on an H100 SXM: bytes, one read of the keys and one write of the
// k-wide output. Design: grid (rows, splits of the row). The count kernel
// gives each block its strict and tie counts; the emit kernel adds those
// of the blocks to its left for its starting ranks, returns at once when
// its span holds no winner, and otherwise walks the span in chunks of
// 1024 keys (4 a thread) with a block-wide exclusive scan of the two
// counts packed in one int. It stops when every winner of the row is out.

#include <cstdint>
#include <cuda_runtime.h>

namespace raft_port {

constexpr int kEmitThreads = 256;
constexpr int kEmitWarps = kEmitThreads / 32;
constexpr int kEmitPer = 4;
constexpr int kEmitChunk = kEmitThreads * kEmitPer;

__global__ void __launch_bounds__(kEmitThreads)
    radix_count_kernel(const int* keys, int64_t ld, int len, int span,
                       const int* t, int splits, int* cnt) {
  __shared__ int red[2][kEmitWarps];
  const int row = blockIdx.x;
  const int key_t = t[row];
  const int c0 = blockIdx.y * span, c1 = min(len, c0 + span);
  const int* rp = keys + static_cast<int64_t>(row) * ld;
  int lt = 0, eq = 0;
  for (int c = c0 + threadIdx.x; c < c1; c += kEmitThreads) {
    const int key = rp[c];
    lt += key < key_t;
    eq += key == key_t;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lt += __shfl_xor_sync(0xffffffffu, lt, off);
    eq += __shfl_xor_sync(0xffffffffu, eq, off);
  }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    red[0][warp] = lt;
    red[1][warp] = eq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    lt = eq = 0;
    for (int w = 0; w < kEmitWarps; ++w) {
      lt += red[0][w];
      eq += red[1][w];
    }
    const int64_t at = (static_cast<int64_t>(row) * splits + blockIdx.y) * 2;
    cnt[at] = lt;
    cnt[at + 1] = eq;
  }
}

__global__ void __launch_bounds__(kEmitThreads)
    radix_emit_kernel(const int* keys, int64_t ld, int len, int span, int k,
                      const int* t, const int* ntie_rows, int splits,
                      const int* cnt, int* out) {
  __shared__ int warp_tot[kEmitWarps];
  const int row = blockIdx.x, s = blockIdx.y;
  const int key_t = t[row];
  const int ntie = ntie_rows[row];
  const int less_total = k - ntie;
  const int* rc = cnt + static_cast<int64_t>(row) * splits * 2;
  int base_less = 0, base_tie = 0;
  for (int q = 0; q < s; ++q) {
    base_less += rc[2 * q];
    base_tie += rc[2 * q + 1];
  }
  if (rc[2 * s] == 0 && (rc[2 * s + 1] == 0 || base_tie >= ntie)) return;
  const int c0 = s * span, c1 = min(len, c0 + span);
  const int* rp = keys + static_cast<int64_t>(row) * ld;
  int* orow = out + static_cast<int64_t>(row) * k;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int base = c0; base < c1; base += kEmitChunk) {
    int key[kEmitPer];
    int packed = 0;                     // strict count | tie count << 16
#pragma unroll
    for (int e = 0; e < kEmitPer; ++e) {
      const int c = base + threadIdx.x * kEmitPer + e;
      key[e] = c < c1 ? rp[c] : 0;
      if (c < c1) packed += key[e] < key_t ? 1 : (key[e] == key_t ? 65536 : 0);
    }
    int incl = packed;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kEmitWarps; ++w) {
      if (w < warp) before += warp_tot[w];
      total += warp_tot[w];
    }
    const int excl = incl - packed + before;
    int nl = base_less + (excl & 0xffff);
    int nt = base_tie + (excl >> 16);
#pragma unroll
    for (int e = 0; e < kEmitPer; ++e) {
      const int c = base + threadIdx.x * kEmitPer + e;
      if (c >= c1) continue;
      if (key[e] < key_t) {
        if (nl < less_total) orow[nl] = c;
        ++nl;
      } else if (key[e] == key_t) {
        if (nt < ntie) orow[less_total + nt] = c;
        ++nt;
      }
    }
    base_less += total & 0xffff;
    base_tie += total >> 16;
    __syncthreads();                    // warp_tot is rewritten next chunk
    if (base_less >= less_total && base_tie >= ntie) break;
  }
}

}  // namespace raft_port

// keys: int32 [rows, >= len], row stride ld; t, ntie: int32 [rows] from
// raft_radix_threshold; cnt: int32 scratch [rows][splits][2]; out: int32
// [rows, k]. Returns the CUDA error of the launches (0 on success).
extern "C" int raft_radix_emit(const int* keys, int64_t ld, int rows, int len,
                               int k, const int* t, const int* ntie,
                               int splits, int* cnt, int* out, void* stream) {
  using namespace raft_port;
  if (rows < 1 || len < 1 || k < 1 || k > len || ld < len || splits < 1 ||
      splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int span = (len + splits - 1) / splits;
  span = (span + kEmitChunk - 1) / kEmitChunk * kEmitChunk;
  const int used = (len + span - 1) / span;
  const dim3 grid(rows, used);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  radix_count_kernel<<<grid, kEmitThreads, 0, st>>>(keys, ld, len, span, t,
                                                    used, cnt);
  radix_emit_kernel<<<grid, kEmitThreads, 0, st>>>(keys, ld, len, span, k, t,
                                                   ntie, used, cnt, out);
  return static_cast<int>(cudaGetLastError());
}
