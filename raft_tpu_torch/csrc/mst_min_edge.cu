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
// order with no host pass; a CUDA warp reads colors[u] and colors[v]
// straight from the CSR arrays.
//
// Bound on an H100 SXM: bytes. Each entry's index and weight are read
// once, its color gathered once (mostly from L2), indptr and colors once a
// row, the three outputs written once. Design: one warp a row, as in
// csr_spmv.cu. Lanes stride the row's entries, four at a time with their
// loads in flight together, each keeping its own minimum; the warp reduces
// the 32 triples by shuffles. A min under a strict total order is exact and
// order-free, so the result is bitwise repeatable. Entries past
// indptr[n_rows] (a bucketed CSR's pads) are never read. A hub row is one
// warp's serial walk, as in csr_spmv.cu.

#include <cstdint>
#include <cuda_runtime.h>

namespace raft_port {

constexpr int kMstWarp = 32;
constexpr int kMstThreads = 256;                   // 8 rows a block
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

template <typename T, typename I>
__global__ void __launch_bounds__(kMstThreads)
    mst_min_edge_kernel(const I* __restrict__ indptr,
                        const int* __restrict__ indices,
                        const T* __restrict__ data,
                        const int* __restrict__ colors, int64_t n_cols,
                        T* __restrict__ out_w, int64_t* __restrict__ out_key,
                        int* __restrict__ out_eid, int n_rows) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kMstThreads + threadIdx.x) /
      kMstWarp;
  const int lane = threadIdx.x % kMstWarp;
  if (row >= n_rows) return;
  const int64_t start = indptr[row], end = indptr[row + 1];
  const int cu = colors[row];
  const int u = static_cast<int>(row);
  Triple<T> best{static_cast<T>(__int_as_float(0x7f800000)), kKeyMax,
                 kEidMax};
  int64_t j = start + lane;
  // four of the lane's entries at a time, their index, weight and color
  // loads in flight together
  for (; j + 3 * kMstWarp < end; j += 4 * kMstWarp) {
    int v[4], cv[4];
    T w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = indices[j + q * kMstWarp];
      w[q] = data[j + q * kMstWarp];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) cv[q] = __ldg(colors + v[q]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (cv[q] == cu) continue;
      const Triple<T> c{w[q],
                        static_cast<int64_t>(min(u, v[q])) * n_cols +
                            max(u, v[q]),
                        static_cast<int>(j + q * kMstWarp)};
      if (before(c, best)) best = c;
    }
  }
  for (; j < end; j += kMstWarp) {
    const int v = indices[j];
    if (__ldg(colors + v) == cu) continue;
    const Triple<T> c{data[j],
                      static_cast<int64_t>(min(u, v)) * n_cols + max(u, v),
                      static_cast<int>(j)};
    if (before(c, best)) best = c;
  }
#pragma unroll
  for (int off = kMstWarp / 2; off > 0; off /= 2) {
    const Triple<T> o{__shfl_xor_sync(0xffffffffu, best.w, off),
                      __shfl_xor_sync(0xffffffffu, best.key, off),
                      __shfl_xor_sync(0xffffffffu, best.eid, off)};
    if (before(o, best)) best = o;
  }
  if (lane == 0) {
    out_w[row] = best.w;
    out_key[row] = best.key;
    out_eid[row] = best.eid;
  }
}

template <typename T>
static void launch(int idx64, const void* indptr, const int* indices,
                   const void* data, const int* colors, int64_t n_cols,
                   void* out_w, int64_t* out_key, int* out_eid, int n_rows,
                   cudaStream_t st) {
  const int64_t blocks =
      (static_cast<int64_t>(n_rows) * kMstWarp + kMstThreads - 1) /
      kMstThreads;
  const T* d = static_cast<const T*>(data);
  T* w = static_cast<T*>(out_w);
  if (idx64)
    mst_min_edge_kernel<T, int64_t><<<blocks, kMstThreads, 0, st>>>(
        static_cast<const int64_t*>(indptr), indices, d, colors, n_cols, w,
        out_key, out_eid, n_rows);
  else
    mst_min_edge_kernel<T, int><<<blocks, kMstThreads, 0, st>>>(
        static_cast<const int*>(indptr), indices, d, colors, n_cols, w,
        out_key, out_eid, n_rows);
}

}  // namespace raft_port

// dtype: 0 f32, 1 f64 (data and out_w); idx64: indptr is int64 (else
// int32); indices and colors int32; out_key int64, out_eid int32, all
// [n_rows]. Edge ids are CSR positions and must fit int32. Returns the
// CUDA error of the launch.
extern "C" int raft_mst_min_edge(int dtype, int idx64, const void* indptr,
                                 const void* indices, const void* data,
                                 const void* colors, int64_t n_cols,
                                 void* out_w, void* out_key, void* out_eid,
                                 int n_rows, void* stream) {
  using namespace raft_port;
  if (dtype < 0 || dtype > 1 || n_rows < 1 || n_cols < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ind = static_cast<const int*>(indices);
  const int* col = static_cast<const int*>(colors);
  int64_t* key = static_cast<int64_t*>(out_key);
  int* eid = static_cast<int*>(out_eid);
  if (dtype == 0)
    launch<float>(idx64, indptr, ind, data, col, n_cols, out_w, key, eid,
                  n_rows, st);
  else
    launch<double>(idx64, indptr, ind, data, col, n_cols, out_w, key, eid,
                   n_rows, st);
  return static_cast<int>(cudaGetLastError());
}
