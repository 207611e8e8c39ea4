// The split of a walk over the stored entries of a CSR matrix's rows,
// shared by csr_spmv.cu (a row's fold is a sum) and mst_min_edge.cu (a
// lexicographic minimum), so that no warp walks more than seg_len entries
// of a row and short rows fill the warp.
//
// The entries are cut into chunks of seg_len, chunk c holding [c seg_len,
// (c + 1) seg_len). A row of at most seg_len entries is short; a long row's
// head runs from its start to the first chunk boundary at or after it
// (fewer than seg_len entries), its tail from there to its end.
// 1. Row groups: a group of lpe lanes takes a short row, or a long row's
//    head (32 / lpe rows a warp; the wrapper picks lpe from the mean
//    entries a row, host-known), a lane every lpe-th entry, kRowUnroll in
//    flight, the group's lanes folded by a fixed shuffle tree into the
//    row's result (an empty row or head stores the fold's identity).
// 2. Chunk warps: chunk c takes the entries of the row holding entry
//    c seg_len when they are a long row's tail. The plan names that row,
//    or -1, in owner[c] (grid_spmv.py:_spmv_owners, once per sparsity
//    pattern, on the device), so a chunk warp needs no search of indptr;
//    a lane every 32nd entry, kChunkUnroll in flight, folded by a fixed
//    tree into partial slot c. Chunk and row warps share one launch, so
//    the long rows' tails overlap the short rows.
// 3. A fix-up folds a long row's partials into its result in chunk order:
//    a thread a chunk; the first chunk of each tail (its owner differs
//    from the previous chunk's) walks the row's chunks up to the one
//    holding the row's last entry (from indptr), kFixFlight partials in
//    flight, the slots past the row's last chunk holding the fold's
//    neutral element.
// Both grids come from host-known numbers (n_rows, and the physical entry
// count / seg_len + 1 chunks), so the wrapper needs no sync. Entries past
// indptr[n_rows] (the padding of a bucketed CSR) are never read. Every
// fold is taken in one fixed order: two runs are bitwise equal, and so are
// int32 and int64 indptr.
//
// A fold (Op) gives the entries' work and where its results go:
//   using Acc = ...;                          // a row's running result
//   static constexpr int kMinBlocks;          // blocks an SM, or 0
//   Acc identity() const;                     // an empty row's result
//   Acc neutral() const;                      // fold(acc, neutral()) is acc,
//                                             // bit for bit
//   template <int kUnroll>                    // entries j, j + step, ...
//   void walk(int row, int64_t j, int64_t e, int step, Acc& acc) const;
//   void fold_xor(Acc& acc, int off) const;   // with lane ^ off, all lanes
//   void fold(Acc& acc, const Acc& p) const;  // acc then p, in that order
//   void store_row(int64_t row, const Acc& acc) const;
//   void store_part(int64_t c, const Acc& acc) const;
//   Acc load_row(int row) const;
//   Acc load_part(int64_t c) const;

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace raft_port {
namespace csr_split {

constexpr int kWarp = 32;
constexpr int kThreads = 256;                      // 8 warps a block
constexpr int kRowUnroll = 4;
constexpr int kChunkUnroll = 8;
constexpr int kFixFlight = 16;
constexpr unsigned kFull = 0xffffffffu;

// Row group: rows [r0, r0 + 32 / lpe), lpe lanes a row.
template <class Op, typename I>
__device__ __forceinline__ void group_rows(const Op& op,
                                           const I* __restrict__ indptr,
                                           int n_rows, int seg_len,
                                           int64_t r0, int lpe) {
  const int lane = threadIdx.x % kWarp;
  const int v = lane % lpe;
  const int64_t row = r0 + lane / lpe;
  int64_t s = 0, e = 0;
  if (row < n_rows) {
    s = indptr[row];
    e = indptr[row + 1];
    if (e - s > seg_len)                  // a long row: its head
      e = (s + seg_len - 1) / seg_len * seg_len;
  }
  typename Op::Acc acc = op.identity();
  op.template walk<kRowUnroll>(static_cast<int>(row), s + v, e, lpe, acc);
  // the group's lanes by a fixed tree (every lane of the warp takes part)
  for (int off = lpe / 2; off > 0; off >>= 1) op.fold_xor(acc, off);
  if (v == 0 && row < n_rows) op.store_row(row, acc);
}

// Warps [0, n_chunks) are chunk warps, the rest row groups of 32 / lpe
// rows each (the long chunk work starts first).
template <class Op, typename I>
__device__ __forceinline__ void walk_warp(const Op& op,
                                          const I* __restrict__ indptr,
                                          const int* __restrict__ owner,
                                          int64_t n_chunks, int n_rows,
                                          int seg_len, int lpe) {
  const int64_t w =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  if (w >= n_chunks) {
    group_rows<Op, I>(op, indptr, n_rows, seg_len,
                      (w - n_chunks) * (kWarp / lpe), lpe);
    return;
  }
  const int r = owner[w];
  if (r < 0) return;                      // no tail in this chunk
  const int64_t a = w * seg_len;          // the tail starts at a boundary
  const int64_t e = indptr[r + 1];
  const int64_t z = a + seg_len < e ? a + seg_len : e;
  const int lane = threadIdx.x % kWarp;
  typename Op::Acc acc = op.identity();
  op.template walk<kChunkUnroll>(r, a + lane, z, kWarp, acc);
  for (int off = kWarp / 2; off > 0; off >>= 1) op.fold_xor(acc, off);
  if (lane == 0) op.store_part(w, acc);
}

// The split, for a fold with no occupancy bound (Op::kMinBlocks 0). A
// bound of one block an SM is not the same: with it the compiler gave
// csr_spmv's f32 walk 56 registers, not 32, and six blocks an SM, not 8.
template <class Op, typename I>
__global__ void __launch_bounds__(kThreads)
    split_walk(const Op op, const I* __restrict__ indptr,
               const int* __restrict__ owner, int64_t n_chunks, int n_rows,
               int seg_len, int lpe) {
  walk_warp<Op, I>(op, indptr, owner, n_chunks, n_rows, seg_len, lpe);
}

// The split with at least Op::kMinBlocks blocks an SM.
template <class Op, typename I>
__global__ void __launch_bounds__(kThreads, Op::kMinBlocks > 0
                                                ? Op::kMinBlocks
                                                : 1)
    split_walk_bounded(const Op op, const I* __restrict__ indptr,
                       const int* __restrict__ owner, int64_t n_chunks,
                       int n_rows, int seg_len, int lpe) {
  walk_warp<Op, I>(op, indptr, owner, n_chunks, n_rows, seg_len, lpe);
}

// Folds a long row's partials into its result, in chunk order.
template <class Op, typename I>
__global__ void __launch_bounds__(kThreads)
    split_fixup(const Op op, const I* __restrict__ indptr,
                const int* __restrict__ owner, int64_t n_chunks,
                int seg_len) {
  const int64_t q0 =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (q0 >= n_chunks) return;
  const int r = owner[q0];
  if (r < 0 || (q0 > 0 && owner[q0 - 1] == r)) return;
  const int64_t q1 = (static_cast<int64_t>(indptr[r + 1]) - 1) / seg_len + 1;
  typename Op::Acc acc = op.load_row(r);
  for (int64_t q = q0; q < q1; q += kFixFlight) {
    typename Op::Acc p[kFixFlight];
#pragma unroll
    for (int u = 0; u < kFixFlight; ++u)
      p[u] = q + u < q1 ? op.load_part(q + u) : op.neutral();
#pragma unroll
    for (int u = 0; u < kFixFlight; ++u)   // unguarded: a guard per fold
      op.fold(acc, p[u]);                  // took a third more time
  }
  op.store_row(r, acc);
}

// The split and its fix-up on stream st.
template <class Op, typename I>
void launch(const Op& op, const I* indptr, const int* owner, int n_rows,
            int64_t n_chunks, int seg_len, int lpe, cudaStream_t st) {
  const int64_t rpw = kWarp / lpe;        // rows a row warp
  const int64_t warps = n_chunks + (n_rows + rpw - 1) / rpw;
  const int64_t per_block = kThreads / kWarp;
  const int64_t blocks = (warps + per_block - 1) / per_block;
  if constexpr (Op::kMinBlocks > 0)
    split_walk_bounded<Op, I><<<blocks, kThreads, 0, st>>>(
        op, indptr, owner, n_chunks, n_rows, seg_len, lpe);
  else
    split_walk<Op, I><<<blocks, kThreads, 0, st>>>(op, indptr, owner,
                                                   n_chunks, n_rows, seg_len,
                                                   lpe);
  split_fixup<Op, I><<<(n_chunks + kThreads - 1) / kThreads, kThreads, 0,
                       st>>>(op, indptr, owner, n_chunks, seg_len);
}

// The arguments every entry point checks: a working type code (0 f32,
// 1 f64), at least one row and chunk, lpe a power of two in [1, 32].
inline bool bad_args(int dtype, int n_rows, int64_t n_chunks, int seg_len,
                     int lpe) {
  return dtype < 0 || dtype > 1 || n_rows < 1 || n_chunks < 1 ||
         seg_len < 1 || lpe < 1 || lpe > kWarp || (lpe & (lpe - 1));
}

// f(T{}, I{}) for the working type (dtype 0 float, 1 double) and the
// indptr type (idx64: int64_t, else int).
template <class F>
void dispatch(int dtype, int idx64, F&& f) {
  if (dtype == 0 && idx64)
    f(float{}, int64_t{});
  else if (dtype == 0)
    f(float{}, int{});
  else if (idx64)
    f(double{}, int64_t{});
  else
    f(double{}, int{});
}

}  // namespace csr_split
}  // namespace raft_port
