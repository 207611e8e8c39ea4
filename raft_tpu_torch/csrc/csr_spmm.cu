// CSR sparse matrix times dense matrix: C[r, q] = sum over the stored
// entries j of row r of data[j] * B[indices[j], q], for B row-major
// [n_cols, k] (k >= 2; k == 1 goes to csr_spmv.cu), in f32 or f64.
//
// Replaces the three k-batched SpMM kernels of raft_tpu/sparse/grid_spmv.py:
// _gather_kt_kernel (:653), _segsum_kt_kernel (:665) and _reduce_kt_kernel
// (:672), launched at :715, :730 and :773. Those run the slot-grid SpMV
// machinery (csr_spmv.cu says why it exists on the TPU) over groups of
// KT = 8 columns, a sublane choice with no meaning here; this kernel reads
// the CSR arrays and B directly.
//
// Contract: as csr_spmv.cu, per output column: sums over the row's own
// entries only, IEEE propagation of a stored zero against inf, padding past
// indptr[n_rows] never read, empty rows exactly 0.
//
// Bound on an H100 SXM: bytes. Each entry's index and value are read once,
// and each entry gathers one row of B (k values, from L2 on a graph), C is
// written once. Design: one warp a row, its lanes over 32 columns of B at a
// time (coalesced reads of a B row). The warp loads 32 of the row's entries
// at once, one a lane, and hands each to every lane by shuffle; each lane
// then adds the products to its column's sum in entry order. Every output
// is summed in one fixed order (no atomics): bitwise repeatable. k above 32
// takes several passes over the row's entries.

#include <cstdint>
#include <cuda_runtime.h>

namespace raft_port {

constexpr int kSpmmWarp = 32;
constexpr int kSpmmThreads = 256;                  // 8 rows a block

template <typename T, typename I>
__global__ void __launch_bounds__(kSpmmThreads)
    csr_spmm_kernel(const I* __restrict__ indptr,
                    const int* __restrict__ indices,
                    const T* __restrict__ data, const T* __restrict__ b,
                    int64_t ldb, T* __restrict__ c, int64_t ldc, int n_rows,
                    int k) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kSpmmThreads + threadIdx.x) /
      kSpmmWarp;
  const int lane = threadIdx.x % kSpmmWarp;
  if (row >= n_rows) return;
  const int64_t start = indptr[row], end = indptr[row + 1];
  for (int c0 = 0; c0 < k; c0 += kSpmmWarp) {
    const int col = c0 + lane;
    const bool live = col < k;
    T acc = 0;
    for (int64_t base = start; base < end; base += kSpmmWarp) {
      int idx = 0;
      T val = 0;
      if (base + lane < end) {
        idx = indices[base + lane];
        val = data[base + lane];
      }
      const int cnt = static_cast<int>(
          end - base < kSpmmWarp ? end - base : kSpmmWarp);
      // unrolled, so that the chunk's loads of B can be in flight together
#pragma unroll
      for (int t = 0; t < kSpmmWarp; ++t) {
        const int64_t bi = __shfl_sync(0xffffffffu, idx, t);
        const T bv = __shfl_sync(0xffffffffu, val, t);
        if (live && t < cnt) acc += bv * __ldg(b + bi * ldb + col);
      }
    }
    if (live) c[row * ldc + col] = acc;
  }
}

template <typename T>
static void launch(int idx64, const void* indptr, const void* indices,
                   const void* data, const void* b, int64_t ldb, void* c,
                   int64_t ldc, int n_rows, int k, cudaStream_t st) {
  const int64_t blocks =
      (static_cast<int64_t>(n_rows) * kSpmmWarp + kSpmmThreads - 1) /
      kSpmmThreads;
  const int* ind = static_cast<const int*>(indices);
  const T* d = static_cast<const T*>(data);
  const T* bm = static_cast<const T*>(b);
  T* cm = static_cast<T*>(c);
  if (idx64)
    csr_spmm_kernel<T, int64_t><<<blocks, kSpmmThreads, 0, st>>>(
        static_cast<const int64_t*>(indptr), ind, d, bm, ldb, cm, ldc,
        n_rows, k);
  else
    csr_spmm_kernel<T, int><<<blocks, kSpmmThreads, 0, st>>>(
        static_cast<const int*>(indptr), ind, d, bm, ldb, cm, ldc, n_rows,
        k);
}

}  // namespace raft_port

// dtype: 0 f32, 1 f64 (data, B and C alike); idx64: indptr is int64 (else
// int32); indices are int32; ldb/ldc: row strides of B and C in elements.
// Returns the CUDA error of the launch.
extern "C" int raft_csr_spmm(int dtype, int idx64, const void* indptr,
                             const void* indices, const void* data,
                             const void* b, int64_t ldb, void* c,
                             int64_t ldc, int n_rows, int k, void* stream) {
  using namespace raft_port;
  if (dtype < 0 || dtype > 1 || n_rows < 1 || k < 1 || ldb < k || ldc < k)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(idx64, indptr, indices, data, b, ldb, c, ldc, n_rows, k,
                  st);
  else
    launch<double>(idx64, indptr, indices, data, b, ldb, c, ldc, n_rows, k,
                   st);
  return static_cast<int>(cudaGetLastError());
}
