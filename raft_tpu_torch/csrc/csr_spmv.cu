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
// x at any column, so this one kernel computes what the three compute
// together, straight from the CSR arrays.
//
// Contract (grid_spmv.py:45-48): products and sums in the working type; a
// row's sum is over its own entries only; a stored zero against x = inf
// gives NaN (IEEE) and touches no other row; entries past indptr[n_rows]
// (the padding of a bucketed CSR) are never read; an empty row is exactly 0.
//
// Bound on an H100 SXM: bytes. Each entry's index and value are read once,
// x is gathered once an entry (mostly from L2 on a graph), indptr and y once
// a row. Design: one warp a row. Its lanes stride the row's entries, each
// keeping a partial sum in entry order; the warp adds the 32 partials with
// a fixed shuffle tree, and lane 0 writes y[row]. Every row is summed in the
// same order on every run (no atomics), so the result is bitwise
// repeatable. A hub row is one warp's serial loop (the tail PERF.md times);
// a block-per-row kernel for long rows is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace raft_port {

constexpr int kSpmvWarp = 32;
constexpr int kSpmvThreads = 256;                  // 8 rows a block

template <typename T, typename I>
__global__ void __launch_bounds__(kSpmvThreads)
    csr_spmv_kernel(const I* __restrict__ indptr,
                    const int* __restrict__ indices,
                    const T* __restrict__ data, const T* __restrict__ x,
                    T* __restrict__ y, int n_rows) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kSpmvThreads + threadIdx.x) /
      kSpmvWarp;
  const int lane = threadIdx.x % kSpmvWarp;
  if (row >= n_rows) return;
  const int64_t start = indptr[row], end = indptr[row + 1];
  T acc = 0;
  int64_t j = start + lane;
  // four of the lane's entries at a time, their loads in flight together;
  // the sum takes them in the same order as the plain loop below
  for (; j + 3 * kSpmvWarp < end; j += 4 * kSpmvWarp) {
    int c[4];
    T d[4], xv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      c[u] = indices[j + u * kSpmvWarp];
      d[u] = data[j + u * kSpmvWarp];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) xv[u] = __ldg(x + c[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) acc += d[u] * xv[u];
  }
  for (; j < end; j += kSpmvWarp) acc += data[j] * __ldg(x + indices[j]);
#pragma unroll
  for (int off = kSpmvWarp / 2; off > 0; off /= 2)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) y[row] = acc;
}

template <typename T>
static void launch(int idx64, const void* indptr, const void* indices,
                   const void* data, const void* x, void* y, int n_rows,
                   cudaStream_t st) {
  const int64_t blocks =
      (static_cast<int64_t>(n_rows) * kSpmvWarp + kSpmvThreads - 1) /
      kSpmvThreads;
  const int* ind = static_cast<const int*>(indices);
  const T* d = static_cast<const T*>(data);
  const T* xv = static_cast<const T*>(x);
  T* yv = static_cast<T*>(y);
  if (idx64)
    csr_spmv_kernel<T, int64_t><<<blocks, kSpmvThreads, 0, st>>>(
        static_cast<const int64_t*>(indptr), ind, d, xv, yv, n_rows);
  else
    csr_spmv_kernel<T, int><<<blocks, kSpmvThreads, 0, st>>>(
        static_cast<const int*>(indptr), ind, d, xv, yv, n_rows);
}

}  // namespace raft_port

// dtype: 0 f32, 1 f64 (data, x and y alike); idx64: indptr is int64 (else
// int32); indices are int32. Returns the CUDA error of the launch.
extern "C" int raft_csr_spmv(int dtype, int idx64, const void* indptr,
                             const void* indices, const void* data,
                             const void* x, void* y, int n_rows,
                             void* stream) {
  using namespace raft_port;
  if (dtype < 0 || dtype > 1 || n_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(idx64, indptr, indices, data, x, y, n_rows, st);
  else
    launch<double>(idx64, indptr, indices, data, x, y, n_rows, st);
  return static_cast<int>(cudaGetLastError());
}
