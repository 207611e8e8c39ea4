// Radix threshold: per row of int32 sortable keys, the exact k-th smallest
// key T and its tie quota n_tie = k - #(keys < T), the number of keys
// equal to T that belong in the top k.
//
// Replaces raft_tpu/matrix/radix_select.py:_threshold_kernel (:235),
// launched by _radix_ranks (:489): the reference's four most-significant-
// digit passes of 8 bits over the biased key (key ^ INT32_MIN, so that
// signed order is unsigned digit order). Pass p histograms digit p of the
// keys whose higher digits equal the prefix decided so far, then narrows
// to the bin where the running count reaches the remaining rank `want`.
// After four passes the prefix is T and `want` is n_tie.
//
// Bound on an H100 SXM: bytes, one read of the keys. Design: four
// histogram launches, grid (rows, splits of the row), so that a few long
// rows still fill the card. Counts are shared-memory integer atomics
// (warp-aggregated with __match_any_sync, one sub-histogram a warp), added
// into a global per-row histogram [4][rows][256]: exact, so the result is
// deterministic. Each launch re-derives the prefix from the earlier
// passes' histograms (one warp, 256 bins), and a last launch publishes T
// and n_tie. The reference pads rows with INT32_MAX; the ragged edge is
// masked here instead. Each pass reads the whole row, four reads in all.

#include <cstdint>
#include <cuda_runtime.h>

namespace raft_port {

constexpr int kRadThreads = 256;
constexpr int kRadWarps = kRadThreads / 32;
constexpr int kBins = 256;
constexpr int kPasses = 4;

// Warp-collective: the bin of h[256] where the inclusive count first
// reaches want (>= 1), and the count strictly below that bin.
__device__ __forceinline__ void pick_bin(const unsigned* h, unsigned want,
                                         unsigned& bin, unsigned& below) {
  const int lane = threadIdx.x & 31;
  unsigned v[8], s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] = h[lane * 8 + i];
    s += v[i];
  }
  unsigned incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  const int first = __ffs(__ballot_sync(0xffffffffu, incl >= want)) - 1;
  unsigned b = 0, run = incl - s;
  if (lane == first) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (run + v[i] >= want) {
        b = lane * 8 + i;
        break;
      }
      run += v[i];
    }
  }
  bin = __shfl_sync(0xffffffffu, b, first);
  below = __shfl_sync(0xffffffffu, run, first);
}

// Warp-collective: (prefix, want) of row `row` after `passes` narrowings.
__device__ __forceinline__ void walk(const unsigned* hist, int rows, int row,
                                     int passes, int k, uint32_t& prefix,
                                     unsigned& want) {
  prefix = 0;
  want = static_cast<unsigned>(k);
  for (int p = 0; p < passes; ++p) {
    unsigned bin, below;
    pick_bin(hist + (static_cast<int64_t>(p) * rows + row) * kBins, want, bin,
             below);
    want -= below;
    prefix = (prefix << 8) | bin;
  }
}

__global__ void __launch_bounds__(kRadThreads)
    radix_hist_kernel(const int* keys, int64_t ld, int rows, int len,
                      int span, int k, int pass, unsigned* hist) {
  __shared__ unsigned h[kRadWarps][kBins];
  __shared__ uint32_t s_prefix;
  const int row = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < kRadWarps * kBins; i += kRadThreads)
    (&h[0][0])[i] = 0;
  if (warp == 0) {
    uint32_t prefix;
    unsigned want;
    walk(hist, rows, row, pass, k, prefix, want);
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();
  const uint32_t prefix = s_prefix;
  const int shift = 24 - 8 * pass;
  const int c0 = blockIdx.y * span;
  const int c1 = min(len, c0 + span);
  const int* rp = keys + static_cast<int64_t>(row) * ld;
  for (int base = c0; base < c1; base += kRadThreads) {
    const int c = base + threadIdx.x;
    int bin = -1;
    if (c < c1) {
      const uint32_t u = static_cast<uint32_t>(rp[c]) ^ 0x80000000u;
      if (pass == 0 || (u >> (shift + 8)) == prefix)
        bin = static_cast<int>((u >> shift) & (kBins - 1));
    }
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    if (bin >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&h[warp][bin], static_cast<unsigned>(__popc(peers)));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += kRadThreads) {
    unsigned s = 0;
#pragma unroll
    for (int w = 0; w < kRadWarps; ++w) s += h[w][b];
    if (s)
      atomicAdd(&hist[(static_cast<int64_t>(pass) * rows + row) * kBins + b],
                s);
  }
}

// One warp a row: T and n_tie from the four passes' histograms.
__global__ void __launch_bounds__(kRadThreads)
    radix_finish_kernel(const unsigned* hist, int rows, int k, int* t,
                        int* ntie) {
  const int row = blockIdx.x * kRadWarps + threadIdx.x / 32;
  if (row >= rows) return;
  uint32_t prefix;
  unsigned want;
  walk(hist, rows, row, kPasses, k, prefix, want);
  if ((threadIdx.x & 31) == 0) {
    t[row] = static_cast<int>(prefix ^ 0x80000000u);
    ntie[row] = static_cast<int>(want);
  }
}

}  // namespace raft_port

// keys: int32 [rows, >= len], row stride ld; hist: u32 scratch
// [4][rows][256] (zeroed here); splits: blocks a row. Returns the CUDA
// error of the launches (0 on success).
extern "C" int raft_radix_threshold(const int* keys, int64_t ld, int rows,
                                    int len, int k, int splits,
                                    unsigned* hist, int* t, int* ntie,
                                    void* stream) {
  using namespace raft_port;
  if (rows < 1 || len < 1 || k < 1 || k > len || ld < len || splits < 1 ||
      splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int span = (len + splits - 1) / splits;
  span = (span + kRadThreads - 1) / kRadThreads * kRadThreads;
  const dim3 grid(rows, (len + span - 1) / span);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      hist, 0, sizeof(unsigned) * kPasses * kBins * static_cast<size_t>(rows),
      st);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int p = 0; p < kPasses; ++p)
    radix_hist_kernel<<<grid, kRadThreads, 0, st>>>(keys, ld, rows, len, span,
                                                    k, p, hist);
  radix_finish_kernel<<<(rows + kRadWarps - 1) / kRadWarps, kRadThreads, 0,
                        st>>>(hist, rows, k, t, ntie);
  return static_cast<int>(cudaGetLastError());
}
