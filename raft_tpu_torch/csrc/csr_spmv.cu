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
// read from the plan instead of searched for. The entries are
// cut into chunks of seg_len, chunk c holding [c seg_len, (c + 1)
// seg_len). A row of at most seg_len entries is short; a long row's head
// runs from its start to the first chunk boundary at or after it (fewer
// than seg_len entries), its tail from there to its end.
// 1. Row groups: a group of lpe lanes takes a short row, or a long row's
//    head (32 / lpe rows a warp; the wrapper picks lpe from the mean
//    entries a row, host-known), a lane every lpe-th entry, four in
//    flight (their indices and values, then their x), the group's lanes
//    added by a fixed shuffle tree into y[row] (an empty row or head
//    writes its 0).
// 2. Chunk warps: chunk c takes the entries of the row holding entry
//    c seg_len when they are a long row's tail. The plan names that row,
//    or -1, in owner[c] (grid_spmv.py:_spmv_owners, once per sparsity
//    pattern, on the device), so a chunk warp needs no search of indptr;
//    it sums them, a lane every 32nd, eight in flight, by a fixed tree
//    into partial slot c. Chunk and row warps share one launch, so the
//    long rows' tails overlap the short rows.
// 3. A fix-up adds a long row's partials to y[row] in chunk order: a
//    thread a chunk, the first chunk of each tail doing the adding.
// Both grids come from host-known numbers (n_rows, and the physical entry
// count / seg_len + 1 chunks), so the wrapper needs no sync. Every sum is
// taken in one fixed order and there are no float atomics: two runs are
// bitwise equal, and so are int32 and int64 indptr.

#include <cstdint>
#include <cuda_runtime.h>

namespace raft_port {

constexpr int kWarp = 32;
constexpr int kSpmvThreads = 256;                  // 8 warps a block
constexpr unsigned kFull = 0xffffffffu;

// Row group: rows [r0, r0 + 32 / lpe), lpe lanes a row.
template <typename T, typename I>
__device__ __forceinline__ void group_rows_sum(
    const I* __restrict__ indptr, const int* __restrict__ indices,
    const T* __restrict__ data, const T* __restrict__ x, T* __restrict__ y,
    int n_rows, int seg_len, int64_t r0, int lpe) {
  constexpr int kUnroll = 4;
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
  T acc = 0;
  for (int64_t j = s + v; j < e; j += kUnroll * lpe) {
    int c[kUnroll];
    T d[kUnroll], xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t q = j + static_cast<int64_t>(u) * lpe;
      c[u] = q < e ? indices[q] : 0;
      d[u] = q < e ? data[q] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j + static_cast<int64_t>(u) * lpe < e) xv[u] = __ldg(x + c[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j + static_cast<int64_t>(u) * lpe < e) acc += d[u] * xv[u];
  }
  // the group's lanes by a fixed tree (every lane of the warp takes part)
  for (int off = lpe / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  if (v == 0 && row < n_rows) y[row] = acc;
}

// Warps [0, n_chunks) are chunk warps, the rest row groups of 32 / lpe
// rows each (the long chunk work starts first).
template <typename T, typename I>
__global__ void __launch_bounds__(kSpmvThreads)
    csr_spmv_split(const I* __restrict__ indptr,
                   const int* __restrict__ indices,
                   const T* __restrict__ data, const T* __restrict__ x,
                   T* __restrict__ y, T* __restrict__ part,
                   const int* __restrict__ owner, int64_t n_chunks,
                   int n_rows, int seg_len, int lpe) {
  constexpr int kUnroll = 8;
  const int64_t w =
      (static_cast<int64_t>(blockIdx.x) * kSpmvThreads + threadIdx.x) /
      kWarp;
  if (w >= n_chunks) {
    group_rows_sum<T, I>(indptr, indices, data, x, y, n_rows, seg_len,
                         (w - n_chunks) * (kWarp / lpe), lpe);
    return;
  }
  const int r = owner[w];
  if (r < 0) return;                      // no tail in this chunk
  const int64_t a = w * seg_len;          // the tail starts at a boundary
  const int64_t e = indptr[r + 1];
  const int64_t z = a + seg_len < e ? a + seg_len : e;
  const int lane = threadIdx.x % kWarp;
  T acc = 0;
  for (int64_t j = a + lane; j < z; j += kUnroll * kWarp) {
    int c[kUnroll];
    T d[kUnroll], xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t q = j + static_cast<int64_t>(u) * kWarp;
      c[u] = q < z ? indices[q] : 0;
      d[u] = q < z ? data[q] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j + static_cast<int64_t>(u) * kWarp < z) xv[u] = __ldg(x + c[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j + static_cast<int64_t>(u) * kWarp < z) acc += d[u] * xv[u];
  }
  for (int off = kWarp / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) part[w] = acc;
}

// y[r] += the partials of a long row's chunks, in chunk order: a thread a
// chunk; the first chunk of a tail (its owner differs from the previous
// chunk's) walks the row's chunks, eight partials in flight.
template <typename T>
__global__ void __launch_bounds__(kSpmvThreads)
    csr_spmv_fixup(T* __restrict__ y, const T* __restrict__ part,
                   const int* __restrict__ owner, int64_t n_chunks) {
  const int64_t q0 =
      static_cast<int64_t>(blockIdx.x) * kSpmvThreads + threadIdx.x;
  if (q0 >= n_chunks) return;
  const int r = owner[q0];
  if (r < 0 || (q0 > 0 && owner[q0 - 1] == r)) return;
  T acc = y[r];
  for (int64_t q = q0;; q += 8) {
    int o[8];
    T t[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      o[u] = q + u < n_chunks ? owner[q + u] : -1;
      t[u] = o[u] == r ? part[q + u] : T(0);
    }
    bool more = true;
#pragma unroll
    for (int u = 0; u < 8; ++u) {        // added in chunk order
      more = more && o[u] == r;
      if (more) acc += t[u];
    }
    if (!more) break;
  }
  y[r] = acc;
}

template <typename T, typename I>
static void launch(const void* indptr, const void* indices, const void* data,
                   const void* x, void* y, int n_rows, int64_t n_chunks,
                   int seg_len, int lpe, void* part, const int* owner,
                   cudaStream_t st) {
  const I* ip = static_cast<const I*>(indptr);
  T* yv = static_cast<T*>(y);
  T* pv = static_cast<T*>(part);
  const int64_t rpw = kWarp / lpe;        // rows a row warp
  const int64_t warps = n_chunks + (n_rows + rpw - 1) / rpw;
  const int64_t per_block = kSpmvThreads / kWarp;
  csr_spmv_split<T, I><<<(warps + per_block - 1) / per_block, kSpmvThreads,
                         0, st>>>(ip, static_cast<const int*>(indices),
                                  static_cast<const T*>(data),
                                  static_cast<const T*>(x), yv, pv, owner,
                                  n_chunks, n_rows, seg_len, lpe);
  csr_spmv_fixup<T><<<(n_chunks + kSpmvThreads - 1) / kSpmvThreads,
                      kSpmvThreads, 0, st>>>(yv, pv, owner, n_chunks);
}

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
  if (dtype < 0 || dtype > 1 || n_rows < 1 || n_chunks < 1 || seg_len < 1 ||
      lpe < 1 || lpe > kWarp || (lpe & (lpe - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* own = static_cast<const int*>(owner);
  if (dtype == 0 && idx64)
    launch<float, int64_t>(indptr, indices, data, x, y, n_rows, n_chunks,
                           seg_len, lpe, part, own, st);
  else if (dtype == 0)
    launch<float, int>(indptr, indices, data, x, y, n_rows, n_chunks,
                       seg_len, lpe, part, own, st);
  else if (idx64)
    launch<double, int64_t>(indptr, indices, data, x, y, n_rows, n_chunks,
                            seg_len, lpe, part, own, st);
  else
    launch<double, int>(indptr, indices, data, x, y, n_rows, n_chunks,
                        seg_len, lpe, part, own, st);
  return static_cast<int>(cudaGetLastError());
}
