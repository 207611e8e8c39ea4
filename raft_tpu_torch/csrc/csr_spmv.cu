// CSR sparse matrix times dense vector: y[r] = sum over the stored entries j
// of row r (indptr[r] <= j < indptr[r+1]) of data[j] * x[indices[j]], in
// f32 or f64.
//
// Replaces the three SpMV kernels of raft_tpu/sparse/grid_spmv.py:
// _tree_gather_kernel (:426), _segsum_kernel (:516) and _reduce_kernel
// (:521), launched at :575, :585 and :620. Those exist because Mosaic's
// gather is lane-local: x is cut into column shards, the entries are packed
// on the host into a slot grid, gathered by a select tree, summed by a
// segmented scan and accumulated into row-window planes. A CUDA thread reads
// x at any column, so these kernels compute what the three compute
// together, straight from the CSR arrays.
//
// Contract (grid_spmv.py:45-48): products and sums in the working type; a
// row's sum is over its own entries only; a stored zero against x = inf
// gives NaN (IEEE) and touches no other row; entries past indptr[n_rows]
// (the padding of a bucketed CSR) are never read; an empty row is exactly 0.
//
// Bound on an H100 SXM: bytes. Each entry's index and value are read once,
// x is gathered once an entry (mostly from L2 on a graph), indptr and y once
// a row.
//
// Design: the split of segsum.cuh (csr_spmm.cu, fused_lloyd.cu's sums)
// recast for k = 1, so that no warp walks more than seg_len entries of a
// row and short rows fill the warp. segsum.cuh's lanes split a row's
// columns; with one column that leaves one lane a row, a serial walk, so
// here a row group's lanes split its entries, and a chunk warp's row is
// read from the plan instead of searched for: csr_split.cuh's row groups,
// chunk warps and fix-up, shared with mst_min_edge.cu, with a sum as the
// fold. A lane adds its entries' products in entry order, four in flight
// in a row group and eight in a chunk warp (their indices and values, then
// their x); the lanes' sums meet by a fixed shuffle tree, a long row's
// partials are added in chunk order, and there are no float atomics: two
// runs are bitwise equal, and so are int32 and int64 indptr.

#include <cstdint>
#include <cuda_runtime.h>

#include "csr_split.cuh"

namespace raft_port {

// y = A x as a csr_split fold: a row's sum of data[j] * x[indices[j]].
template <typename T>
struct SpmvSum {
  using Acc = T;
  static constexpr int kMinBlocks = 0;     // 32 registers in f32
  const int* indices;
  const T* data;
  const T* x;
  T* y;
  T* part;

  __device__ __forceinline__ T identity() const { return T(0); }
  // acc + -0 is acc for every acc, +0 and -0 included (a NaN made by the
  // card is its one NaN either way)
  __device__ __forceinline__ T neutral() const { return -T(0); }

  template <int kUnroll>
  __device__ __forceinline__ void walk(int, int64_t j, int64_t e, int step,
                                       T& acc) const {
    for (; j < e; j += kUnroll * step) {
      int c[kUnroll];
      T d[kUnroll], xv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t q = j + static_cast<int64_t>(u) * step;
        c[u] = q < e ? __ldg(indices + q) : 0;
        d[u] = q < e ? __ldg(data + q) : T(0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (j + static_cast<int64_t>(u) * step < e) xv[u] = __ldg(x + c[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (j + static_cast<int64_t>(u) * step < e) acc += d[u] * xv[u];
    }
  }

  __device__ __forceinline__ void fold_xor(T& acc, int off) const {
    acc += __shfl_xor_sync(csr_split::kFull, acc, off);
  }
  __device__ __forceinline__ void fold(T& acc, const T& p) const {
    acc += p;
  }
  __device__ __forceinline__ void store_row(int64_t row, const T& acc) const {
    y[row] = acc;
  }
  __device__ __forceinline__ void store_part(int64_t c, const T& acc) const {
    part[c] = acc;
  }
  __device__ __forceinline__ T load_row(int row) const { return y[row]; }
  __device__ __forceinline__ T load_part(int64_t c) const { return part[c]; }
};

}  // namespace raft_port

// dtype: 0 f32, 1 f64 (data, x, y and the partials alike); idx64: indptr
// is int64 (else int32); indices are int32. n_chunks: chunk warps, at least
// ceil(indptr[n_rows] / seg_len); owner: int32 [n_chunks], the row whose
// tail meets chunk c or -1 (grid_spmv.py:_spmv_owners); part: scratch of
// n_chunks elements; lpe: lanes a row of the row groups, a power of two in
// [1, 32]. Returns the CUDA error of the launches.
extern "C" int raft_csr_spmv(int dtype, int idx64, const void* indptr,
                             const void* indices, const void* data,
                             const void* x, void* y, int n_rows,
                             int64_t n_chunks, int seg_len, int lpe,
                             const void* owner, void* part, void* stream) {
  using namespace raft_port;
  if (csr_split::bad_args(dtype, n_rows, n_chunks, seg_len, lpe))
    return static_cast<int>(cudaErrorInvalidValue);
  csr_split::dispatch(dtype, idx64, [&](auto t, auto i) {
    using T = decltype(t);
    using I = decltype(i);
    const SpmvSum<T> op{static_cast<const int*>(indices),
                        static_cast<const T*>(data),
                        static_cast<const T*>(x), static_cast<T*>(y),
                        static_cast<T*>(part)};
    csr_split::launch(op, static_cast<const I*>(indptr),
                      static_cast<const int*>(owner), n_rows, n_chunks,
                      seg_len, lpe, static_cast<cudaStream_t>(stream));
  });
  return static_cast<int>(cudaGetLastError());
}
