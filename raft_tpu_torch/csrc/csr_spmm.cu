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
// written once.
//
// Design: segsum.cuh's split (shared with fused_lloyd.cu's sums), its
// segments the rows, entry j scaling row indices[j] of B by data[j]. Row
// groups take each row's first seg_len (256) entries into C[r] (an empty
// row writes its zeros), a group of lpe lanes a row, each lane a 16-byte
// vector of the row's columns (lpe = the vectors of a 128-column f32 or
// 64-column f64 pass, rounded up to a power of two: 8 rows a warp at
// k = 16, 32 at k = 4), so short rows fill the warp. Where the row groups
// alone are fewer than the card holds (kFillWarps) and a row takes more
// than one pass of lpe vectors of its columns (a wide B, k = 1024 and
// more: the keyed sums of linalg.reduce, a few rows of many columns),
// the passes are shared out among up to that many groups a row, each
// output's sum in the same order. Chunk warps take the
// rest of the long rows, 256 entries of the entry array each, into [k]
// partials, and a second kernel adds a long row's partials to C[r] in
// chunk order, a warp 32 rows. A hub row of 44,835 entries is then one
// row group and about 175 chunk warps, not one warp's serial walk. Both
// grids come from host-known numbers (n_rows, and the physical entry
// count / seg_len + 1 chunks; chunks past indptr[n_rows] exit), so the
// wrapper needs no sync and no schedule arrays. Where k, ldb, ldc or a
// base is not 16-byte aligned (k = 31, 33), the same kernels read element
// by element. Every sum is taken in one fixed order and there are no
// float atomics: two runs are bitwise equal.

#include <cstdint>
#include <cuda_runtime.h>

#include "segsum.cuh"

namespace raft_port {

constexpr int kSpmmThreads = 256;                  // 8 warps a block
constexpr int64_t kFillWarps = 8192;   // about an H100's resident warps

__device__ __forceinline__ void load16(float (&v)[4], const float* p) {
  const float4 w = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
}

__device__ __forceinline__ void load16(double (&v)[2], const double* p) {
  const double2 w = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = w.x; v[1] = w.y;
}

__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// segsum.cuh's source: entry j scales row indices[j] of B by data[j]; VW
// elements a load (16 / sizeof(E), or 1 where B or C is not aligned).
template <typename E, int VW>
struct BRows {
  using T = E;
  using W = E;
  static constexpr int kVW = VW;
  const int* indices;
  const E* data;
  const E* b;
  int64_t ldb;

  __device__ __forceinline__ int id(int64_t j) const {
    return __ldg(indices + j);
  }
  __device__ __forceinline__ E weight(int64_t j) const {
    return __ldg(data + j);
  }
  __device__ __forceinline__ void load(E (&v)[VW], int id, int col) const {
    const E* p = b + static_cast<int64_t>(id) * ldb + col;
    if constexpr (VW == 1)
      v[0] = __ldg(p);
    else
      load16(v, p);
  }
  __device__ __forceinline__ void store(E* dst, const E (&v)[VW], int,
                                        int) const {
    if constexpr (VW == 1)
      dst[0] = v[0];
    else
      store16(dst, v);
  }
};

// Warps [0, n_chunks) are chunk warps, the rest row groups of 32 / lpe
// rows each, n_cb a group of rows, each taking cb_cols of the columns
// (the long chunk work starts first).
template <typename T, typename I, int VW>
__global__ void __launch_bounds__(kSpmmThreads)
    csr_spmm_split(const I* __restrict__ indptr, BRows<T, VW> rows,
                   T* __restrict__ c, int64_t ldc, T* __restrict__ part,
                   int64_t n_chunks, int n_rows, int k, int seg_len,
                   int lpe, int n_cb, int cb_cols) {
  const int64_t w =
      (static_cast<int64_t>(blockIdx.x) * kSpmmThreads + threadIdx.x) /
      kWarp;
  const int64_t g = w - n_chunks;
  if (g >= 0 && n_cb == 1) {
    seg::rows_sum(indptr, rows, c, ldc, n_rows, k, seg_len,
                  g * (kWarp / lpe), lpe);
  } else if (g >= 0) {
    const int c0 = static_cast<int>(g % n_cb) * cb_cols;
    seg::rows_sum(indptr, rows, c, ldc, n_rows, k, seg_len,
                  g / n_cb * (kWarp / lpe), lpe, c0, c0 + cb_cols);
  } else
    seg::chunk_sum(indptr, rows, part, n_rows, k, seg_len, w);
}

// C[r] += the partials of a long row's chunks, in chunk order. One warp
// takes 32 rows: it reads their extents, one a lane, then walks the long
// ones together, lanes over columns.
template <typename T, typename I>
__global__ void __launch_bounds__(kSpmmThreads)
    csr_spmm_fixup(const I* __restrict__ indptr, T* __restrict__ c,
                   int64_t ldc, const T* __restrict__ part, int n_rows,
                   int k, int seg_len) {
  const int64_t r0 =
      (static_cast<int64_t>(blockIdx.x) * kSpmmThreads + threadIdx.x) /
      kWarp * kWarp;
  const int lane = threadIdx.x % kWarp;
  if (r0 >= n_rows) return;
  const int64_t r = r0 + lane;
  int64_t q0 = 0;                         // the row's partial chunks
  int nq = 0;
  if (r < n_rows)
    seg::partial_chunks(indptr[r], indptr[r + 1], seg_len, q0, nq);
  unsigned longs = __ballot_sync(kFull, nq > 0);
  while (longs) {
    const int l = __ffs(longs) - 1;
    longs &= longs - 1;
    seg::add_partials(c + (r0 + l) * ldc, part, __shfl_sync(kFull, q0, l),
                      __shfl_sync(kFull, nq, l), k);
  }
}

template <typename T, typename I>
static void launch(const void* indptr, const void* indices, const void* data,
                   const void* b, int64_t ldb, void* c, int64_t ldc,
                   int n_rows, int k, int64_t n_chunks, int seg_len,
                   void* part, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const I* ip = static_cast<const I*>(indptr);
  const int* ind = static_cast<const int*>(indices);
  const T* d = static_cast<const T*>(data);
  const T* bm = static_cast<const T*>(b);
  T* cm = static_cast<T*>(c);
  T* pm = static_cast<T*>(part);
  const bool vec = k % kVec == 0 && ldb % kVec == 0 && ldc % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(part) % 16 == 0;
  const int vw = vec ? kVec : 1;
  const int lpe = seg::lanes_for(k < kWarp * vw ? k : kWarp * vw, vw);
  const int64_t rpw = kWarp / lpe;        // rows a row warp
  const int64_t row_warps = (n_rows + rpw - 1) / rpw;
  const int span = lpe * vw;              // columns a pass
  const int passes = (k + span - 1) / span;
  const int64_t want = kFillWarps / row_warps;  // groups to fill the card
  const int n_split = static_cast<int>(want < passes ? (want > 1 ? want : 1)
                                                     : passes);
  const int cb_cols = (passes + n_split - 1) / n_split * span;
  const int n_cb = (k + cb_cols - 1) / cb_cols;
  const int64_t warps = n_chunks + row_warps * n_cb;
  const int64_t per_block = kSpmmThreads / kWarp;
  const int64_t blocks = (warps + per_block - 1) / per_block;
  if (vec)
    csr_spmm_split<T, I, kVec><<<blocks, kSpmmThreads, 0, st>>>(
        ip, BRows<T, kVec>{ind, d, bm, ldb}, cm, ldc, pm, n_chunks, n_rows, k,
        seg_len, lpe, n_cb, cb_cols);
  else
    csr_spmm_split<T, I, 1><<<blocks, kSpmmThreads, 0, st>>>(
        ip, BRows<T, 1>{ind, d, bm, ldb}, cm, ldc, pm, n_chunks, n_rows, k,
        seg_len, lpe, n_cb, cb_cols);
  const int64_t fix_blocks =
      (static_cast<int64_t>(n_rows) + kSpmmThreads - 1) / kSpmmThreads;
  csr_spmm_fixup<T, I><<<fix_blocks, kSpmmThreads, 0, st>>>(
      ip, cm, ldc, pm, n_rows, k, seg_len);
}

}  // namespace raft_port

// dtype: 0 f32, 1 f64 (data, B, C and the partials alike); idx64: indptr
// is int64 (else int32); indices are int32; ldb/ldc: row strides of B and
// C in elements. n_chunks: chunk warps, at least ceil(indptr[n_rows] /
// seg_len); part: scratch of n_chunks x k elements. Returns the CUDA error
// of the launches.
extern "C" int raft_csr_spmm(int dtype, int idx64, const void* indptr,
                             const void* indices, const void* data,
                             const void* b, int64_t ldb, void* c,
                             int64_t ldc, int n_rows, int k,
                             int64_t n_chunks, int seg_len, void* part,
                             void* stream) {
  using namespace raft_port;
  if (dtype < 0 || dtype > 1 || n_rows < 1 || k < 1 || ldb < k || ldc < k ||
      n_chunks < 1 || seg_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && idx64)
    launch<float, int64_t>(indptr, indices, data, b, ldb, c, ldc, n_rows, k,
                           n_chunks, seg_len, part, st);
  else if (dtype == 0)
    launch<float, int>(indptr, indices, data, b, ldb, c, ldc, n_rows, k,
                       n_chunks, seg_len, part, st);
  else if (idx64)
    launch<double, int64_t>(indptr, indices, data, b, ldb, c, ldc, n_rows,
                            k, n_chunks, seg_len, part, st);
  else
    launch<double, int>(indptr, indices, data, b, ldb, c, ldc, n_rows, k,
                        n_chunks, seg_len, part, st);
  return static_cast<int>(cudaGetLastError());
}
