// Segment sums over a CSR-shaped list of entries, shared by csr_spmm.cu
// (the segments are matrix rows, an entry scales a row of B) and
// fused_lloyd.cu (the segments are clusters, an entry is a data row, its
// weight 1): out[s, :k] = the sum over entries j of segment s, in order,
// of w(j) * B[id(j), :k].
//
// The split: no warp walks more than seg_len entries of one segment,
// whatever the segment lengths.
// - Row groups (rows_sum): a group of lpe lanes takes a segment's first
//   seg_len entries, each lane a vector of VW columns, so short segments
//   fill the warp; a lane walks its entries in order, kBatch ids and
//   weights at a time, then their kBatch gathers in flight together.
// - Chunk warps (chunk_sum): chunk q covers the global entries
//   [q seg_len, (q + 1) seg_len) and takes those of them at offset >=
//   seg_len in their segment. Only the segment holding entry q seg_len
//   can have such entries in chunk q (a segment starting inside the chunk
//   reaches offset seg_len past its end), so the warp finds it by a 32-way
//   search of ptr and sums its entries 32 / lpe at a step, lpe lanes an
//   entry, the entry slots added by a fixed shuffle tree, into part[q].
// - Fix-up (add_partials): a long segment [s, e) adds the partials of its
//   chunks (s + seg_len) / seg_len .. (e - 1) / seg_len in chunk order.
// Every sum is taken in one fixed order and there are no float atomics,
// so two runs are bitwise equal. The caller's kernels decide which warps
// are row groups and which chunk warps, and how warps take the fix-up.
//
// A source (Src) gives the entries and the rows they gather:
//   using T = ...;                 // element and accumulator type
//   using W = ...;                 // weight type: T, or Unit
//   static constexpr int kVW;      // columns a load
//   int id(int64_t j) const;       // the row entry j gathers
//   W weight(int64_t j) const;     // its weight
//   void load(T (&v)[kVW], int id, int col) const;  // B[id, col:+kVW]
//   void store(T* dst, const T (&v)[kVW], int col, int k) const;
// (store writes out[s, col:+kVW], as far as column k). A Unit weight
// costs no load, no register and no multiply.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace raft_port {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

namespace seg {

// The weight of an entry that has none: w * v is v.
struct Unit {};

template <typename T>
__device__ __forceinline__ T operator*(Unit, T v) {
  return v;
}

template <typename T>
__device__ __forceinline__ T shfl(T v, int lane) {
  return __shfl_sync(kFull, v, lane);
}

__device__ __forceinline__ Unit shfl(Unit u, int) { return u; }

// Lanes an entry (row groups: lanes a segment) for a pass of `cols`
// columns: its vectors of vw rounded up to a power of two.
__host__ __device__ __forceinline__ int lanes_for(int cols, int vw) {
  const int vecs = (cols + vw - 1) / vw;
  int lpe = 1;
  while (lpe < vecs && lpe < kWarp) lpe <<= 1;
  return lpe;
}

// Row group: segments [r0, r0 + 32 / lpe), lpe lanes a segment, each lane
// kVW columns at a time over the segment's first seg_len entries; an
// empty segment writes its zeros. Columns [c0, min(c1, k)) only, so that
// several groups can share a segment's columns. No shuffles, so the
// groups may diverge.
template <class Src, class I>
__device__ __forceinline__ void rows_sum(const I* __restrict__ ptr,
                                         const Src& src,
                                         typename Src::T* __restrict__ out,
                                         int64_t ldo, int n_rows, int k,
                                         int seg_len, int64_t r0, int lpe,
                                         int c0 = 0, int c1 = 0x7fffffff) {
  using T = typename Src::T;
  using W = typename Src::W;
  constexpr int VW = Src::kVW;
  constexpr int kBatch = 8;
  const int lane = threadIdx.x % kWarp;
  const int64_t row = r0 + lane / lpe;
  if (row >= n_rows) return;
  const int64_t s = ptr[row];
  int64_t e = ptr[row + 1];
  if (e - s > seg_len) e = s + seg_len;
  const int cend = c1 < k ? c1 : k;
  for (int col = c0 + (lane % lpe) * VW; col < cend; col += lpe * VW) {
    T acc[VW];
#pragma unroll
    for (int u = 0; u < VW; ++u) acc[u] = 0;
    for (int64_t j = s; j < e; j += kBatch) {
      int id[kBatch];
      W w[kBatch];
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        id[t] = 0;
        w[t] = W{};
        if (j + t < e) {
          id[t] = src.id(j + t);
          w[t] = src.weight(j + t);
        }
      }
      T v[kBatch][VW];
#pragma unroll
      for (int t = 0; t < kBatch; ++t)
        if (j + t < e) src.load(v[t], id[t], col);
#pragma unroll
      for (int t = 0; t < kBatch; ++t)
        if (j + t < e)
#pragma unroll
          for (int u = 0; u < VW; ++u) acc[u] += w[t] * v[t][u];
    }
    src.store(out + row * ldo + col, acc, col, k);
  }
}

// dst[0:k] = the sum over entries [start, end) (zeros for an empty
// range), by one warp: per pass of 32 kVW columns, 32 / lpe entry slots
// of lpe lanes, slot i taking entries i, i + 32 / lpe, ... of each 32 in
// order, at most kBatch gathers a lane in flight; the slots added by a
// fixed tree.
template <class Src>
__device__ __forceinline__ void range_sum(const Src& src, int k,
                                          int64_t start, int64_t end,
                                          typename Src::T* __restrict__ dst) {
  using T = typename Src::T;
  using W = typename Src::W;
  constexpr int VW = Src::kVW;
  constexpr int kBatch = 8;
  const int lane = threadIdx.x % kWarp;
  constexpr int kPass = kWarp * VW;       // columns a pass
  for (int c0 = 0; c0 < k; c0 += kPass) {
    const int cols = k - c0 < kPass ? k - c0 : kPass;
    const int vecs = (cols + VW - 1) / VW;
    const int lpe = lanes_for(cols, VW);
    const int epi = kWarp / lpe;          // entries a step
    const int slot = lane / lpe, v = lane % lpe;
    const bool live = v < vecs;
    const int col = c0 + v * VW;
    T acc[VW];
#pragma unroll
    for (int u = 0; u < VW; ++u) acc[u] = 0;
    for (int64_t base = start; base < end; base += kWarp) {
      int id = 0;
      W w{};
      if (base + lane < end) {
        id = src.id(base + lane);
        w = src.weight(base + lane);
      }
      const int cnt = static_cast<int>(
          end - base < kWarp ? end - base : kWarp);
      // lpe steps of epi entries cover the 32 loaded, kBatch steps at a
      // time, so that their gathers can be in flight together
#pragma unroll 1
      for (int t0 = 0; t0 < lpe; t0 += kBatch) {
#pragma unroll
        for (int dt = 0; dt < kBatch; ++dt) {
          const int t = t0 + dt;
          if (t < lpe) {                  // warp-uniform
            const int src_lane = t * epi + slot;
            const int bi = __shfl_sync(kFull, id, src_lane);
            const W bw = shfl(w, src_lane);
            if (live && src_lane < cnt) {
              T bx[VW];
              src.load(bx, bi, col);
#pragma unroll
              for (int u = 0; u < VW; ++u) acc[u] += bw * bx[u];
            }
          }
        }
      }
    }
    // add the entry slots: lanes v, v + lpe, v + 2 lpe, ... by a fixed tree
    for (int off = kWarp / 2; off >= lpe; off >>= 1)
#pragma unroll
      for (int u = 0; u < VW; ++u)
        acc[u] += __shfl_xor_sync(kFull, acc[u], off);
    if (slot == 0 && live) src.store(dst + col, acc, col, k);
  }
}

// The last segment whose start is <= entry `first`: a 32-way search, one
// pivot a lane a round (four rounds over 2^20 segments).
template <typename I>
__device__ __forceinline__ int segment_of_entry(const I* __restrict__ ptr,
                                                int n_rows, int64_t first) {
  const int lane = threadIdx.x % kWarp;
  int lo = 0, hi = n_rows - 1;            // the answer lies in [lo, hi]
  while (lo < hi) {
    const int stride = (hi - lo + kWarp - 1) / kWarp;
    const int64_t p = lo + 1 + static_cast<int64_t>(lane) * stride;
    const bool ok = p <= hi && static_cast<int64_t>(ptr[p]) <= first;
    const int t = __popc(__ballot_sync(kFull, ok));  // ok is a prefix
    if (t == 0) {
      hi = lo;
    } else {
      const int64_t next = lo + 1 + static_cast<int64_t>(t) * stride;
      lo = lo + 1 + (t - 1) * stride;
      if (next - 1 < hi) hi = static_cast<int>(next - 1);
    }
  }
  return lo;
}

// Chunk warp q: its entries at offset >= seg_len in their segment, into
// part[q, 0:k] (nothing where it has none).
template <class Src, class I>
__device__ __forceinline__ void chunk_sum(const I* __restrict__ ptr,
                                          const Src& src,
                                          typename Src::T* __restrict__ part,
                                          int n_rows, int k, int seg_len,
                                          int64_t q) {
  const int64_t first = q * seg_len;
  if (first >= static_cast<int64_t>(ptr[n_rows])) return;
  const int r = segment_of_entry(ptr, n_rows, first);
  const int64_t s = ptr[r], e = ptr[r + 1];
  const int64_t a = first > s + seg_len ? first : s + seg_len;
  const int64_t z = first + seg_len < e ? first + seg_len : e;
  if (a < z) range_sum(src, k, a, z, part + q * k);
}

// The chunks of segment [s, e) that hold partials: [q0, q0 + nq), nq = 0
// for a segment of at most seg_len entries.
__device__ __forceinline__ void partial_chunks(int64_t s, int64_t e,
                                               int seg_len, int64_t& q0,
                                               int& nq) {
  q0 = 0;
  nq = 0;
  if (e - s > seg_len) {
    q0 = (s + seg_len) / seg_len;
    nq = static_cast<int>((e - 1) / seg_len + 1 - q0);
  }
}

// dst[0:k] += part[q0 .. q0 + nq) in chunk order, by one warp, lanes over
// columns, eight partials in flight.
template <typename T>
__device__ __forceinline__ void add_partials(T* __restrict__ dst,
                                             const T* __restrict__ part,
                                             int64_t q0, int nq, int k) {
  const int lane = threadIdx.x % kWarp;
  for (int col = lane; col < k; col += kWarp) {
    const T* pp = part + q0 * k + col;
    T acc = dst[col];
    int q = 0;
    for (; q + 8 <= nq; q += 8) {
      T t[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) t[u] = pp[static_cast<int64_t>(q + u) * k];
#pragma unroll
      for (int u = 0; u < 8; ++u) acc += t[u];
    }
    for (; q < nq; ++q) acc += pp[static_cast<int64_t>(q) * k];
    dst[col] = acc;
  }
}

}  // namespace seg
}  // namespace raft_port
