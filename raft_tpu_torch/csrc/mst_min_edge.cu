// Borůvka E-stage: for each row u of a symmetric CSR graph, its cheapest
// cross edge under the round's coloring, the lexicographic minimum over
// the stored entries j of row u with colors[u] != colors[indices[j]] of
//   (data[j], key = min(u, v) * n_cols + max(u, v), j),   v = indices[j],
// or the identity (+inf, INT64_MAX, INT32_MAX) where row u has no cross
// entry. The key is the canonical undirected pair, so both directions of
// an edge share it and the order is strict on undirected edges; j, the
// CSR position, is the edge id. A self-loop is never a cross edge.
//
// Replaces raft_tpu/sparse/solver/mst_grid.py:_mst_scan_kernel (:139) and
// _mst_reduce_kernel (:217), with the grid_spmv._tree_gather_kernel reuse
// that gathers colors[dst] (launched at :266, :307 and :341). Those pack
// the edges into a (tile, sub-row, lane) slot grid, gather colors through
// a select tree and order undirected edges by a host-built rank array,
// because Mosaic's gathers are lane-local. The rank is the position of the
// canonical pair in sorted order, so comparing the int64 key gives the same
// order with no host pass; the kernel reads colors[u] and colors[v]
// straight from the CSR arrays.
//
// Bound on an H100 SXM: bytes. Each entry's index and weight are read
// once, indptr and colors once a row, the three outputs written once; an
// entry's color is gathered from L2 (colors is 4 MB at 2^20 rows), so it
// adds no HBM traffic.
//
// Design: csr_split.cuh's split of the work, shared with csr_spmv.cu, with
// the lexicographic minimum as the fold: lane groups take short rows and
// long rows' heads (the wrapper sizes lpe for the mean row, as
// csr_spmv's), chunk warps the tails named by the plan (grid_spmv.
// _spmv_owners, once per graph on MSTPlan), so a hub row's tail spreads
// over many warps beside the short rows, and the fix-up folds a tail's
// partials into its row's triple. A lane keeps an entry's index, weight
// and color loads in flight with those of the next three (row groups) or
// seven (chunk warps). A minimum under a strict total order is exact in
// any order, so the triples are bitwise those of any other walk.

#include <cstdint>
#include <cuda_runtime.h>

#include "csr_split.cuh"

namespace raft_port {

constexpr int64_t kKeyMax = 0x7fffffffffffffffLL;
constexpr int kEidMax = 0x7fffffff;

template <typename T>
struct Triple {
  T w;
  int64_t key;
  int eid;
};

// (w, key, eid) strictly before (bw, bkey, beid); a NaN weight never is.
template <typename T>
__device__ __forceinline__ bool before(const Triple<T>& a,
                                       const Triple<T>& b) {
  return a.w < b.w ||
         (a.w == b.w && (a.key < b.key || (a.key == b.key && a.eid < b.eid)));
}

// The E-stage as a csr_split fold: a row's least cross-edge triple. Five
// blocks an SM (at most 48 registers a thread, a few spilled): the walks
// are chains of dependent loads, so the warps in flight set the rate.
template <typename T>
struct MinEdge {
  using Acc = Triple<T>;
  static constexpr int kMinBlocks = 5;
  const int* indices;
  const T* data;
  const int* colors;
  int64_t n_cols;
  T* out_w;
  int64_t* out_key;
  int* out_eid;
  T* part_w;
  int64_t* part_key;
  int* part_eid;

  __device__ __forceinline__ Acc identity() const {
    return {static_cast<T>(__int_as_float(0x7f800000)), kKeyMax, kEidMax};
  }
  __device__ __forceinline__ Acc neutral() const { return identity(); }

  // Row u's entries j, j + step, ... below e. Entry positions are int32
  // edge ids, so they are walked in 32 unsigned bits; the key is formed
  // only for a weight that can win.
  template <int kUnroll>
  __device__ __forceinline__ void walk(int u, int64_t j64, int64_t e64,
                                       int step, Acc& best) const {
    if (j64 >= e64) return;
    const int cu = __ldg(colors + u);
    const unsigned e = static_cast<unsigned>(e64);
    for (unsigned j = static_cast<unsigned>(j64); j < e;
         j += kUnroll * step) {
      int v[kUnroll], cv[kUnroll];
      T w[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const unsigned jj = j + q * step;
        v[q] = jj < e ? __ldg(indices + jj) : u;
        w[q] = jj < e ? __ldg(data + jj) : T(0);
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q)
        cv[q] = j + q * step < e ? __ldg(colors + v[q]) : cu;
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        if (cv[q] == cu || w[q] > best.w) continue;  // same color, past e,
                                                      // or heavier
        const Acc c{w[q],
                    static_cast<int64_t>(min(u, v[q])) * n_cols +
                        max(u, v[q]),
                    static_cast<int>(j + q * step)};
        if (before(c, best)) best = c;
      }
    }
  }

  __device__ __forceinline__ void fold_xor(Acc& best, int off) const {
    const Acc o{__shfl_xor_sync(csr_split::kFull, best.w, off),
                __shfl_xor_sync(csr_split::kFull, best.key, off),
                __shfl_xor_sync(csr_split::kFull, best.eid, off)};
    if (before(o, best)) best = o;
  }
  __device__ __forceinline__ void fold(Acc& best, const Acc& p) const {
    if (before(p, best)) best = p;
  }
  __device__ __forceinline__ void store_row(int64_t row,
                                            const Acc& a) const {
    out_w[row] = a.w;
    out_key[row] = a.key;
    out_eid[row] = a.eid;
  }
  __device__ __forceinline__ void store_part(int64_t c, const Acc& a) const {
    part_w[c] = a.w;
    part_key[c] = a.key;
    part_eid[c] = a.eid;
  }
  __device__ __forceinline__ Acc load_row(int row) const {
    return {out_w[row], out_key[row], out_eid[row]};
  }
  __device__ __forceinline__ Acc load_part(int64_t c) const {
    return {part_w[c], part_key[c], part_eid[c]};
  }
};

}  // namespace raft_port

// dtype: 0 f32, 1 f64 (data, out_w and part_w); idx64: indptr is int64
// (else int32); indices and colors int32; out_key int64, out_eid int32,
// all [n_rows]. n_chunks: chunk warps, at least ceil(indptr[n_rows] /
// seg_len); owner: int32 [n_chunks], the row whose tail meets chunk c or -1
// (grid_spmv.py:_spmv_owners); part_w, part_key, part_eid: scratch of
// n_chunks elements each; lpe: lanes a row of the row groups, a power of
// two in [1, 32]. Edge ids are CSR positions and must fit int32. Returns
// the CUDA error of the launches.
extern "C" int raft_mst_min_edge(int dtype, int idx64, const void* indptr,
                                 const void* indices, const void* data,
                                 const void* colors, int64_t n_cols,
                                 void* out_w, void* out_key, void* out_eid,
                                 int n_rows, int64_t n_chunks, int seg_len,
                                 int lpe, const void* owner, void* part_w,
                                 void* part_key, void* part_eid,
                                 void* stream) {
  using namespace raft_port;
  if (csr_split::bad_args(dtype, n_rows, n_chunks, seg_len, lpe) ||
      n_cols < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  csr_split::dispatch(dtype, idx64, [&](auto t, auto i) {
    using T = decltype(t);
    using I = decltype(i);
    const MinEdge<T> op{static_cast<const int*>(indices),
                        static_cast<const T*>(data),
                        static_cast<const int*>(colors),
                        n_cols,
                        static_cast<T*>(out_w),
                        static_cast<int64_t*>(out_key),
                        static_cast<int*>(out_eid),
                        static_cast<T*>(part_w),
                        static_cast<int64_t*>(part_key),
                        static_cast<int*>(part_eid)};
    csr_split::launch(op, static_cast<const I*>(indptr),
                      static_cast<const int*>(owner), n_rows, n_chunks,
                      seg_len, lpe, static_cast<cudaStream_t>(stream));
  });
  return static_cast<int>(cudaGetLastError());
}
