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
// Design: no warp takes more than seg_len (256) entries of any row,
// whatever the row lengths. Row warps take each row's first seg_len
// entries into C[r] (an empty row writes its zeros), 32 / lpe rows a warp:
// a group of lpe lanes a row, each lane a 16-byte vector of the row's
// columns (lpe = the vectors of a 128-column f32 or 64-column f64 pass,
// rounded up to a power of two: 8 rows a warp at k = 16, 32 at k = 4), so
// short rows fill the warp; each group walks its entries in order, eight
// index loads and then eight gathers in flight. Chunk warps: chunk c
// covers the global entries [c seg_len, (c + 1) seg_len) and takes those
// of them at offset >= seg_len inside their row. Only the row holding
// entry c seg_len can have such entries in chunk c (a row starting inside
// the chunk reaches offset seg_len past its end), so a chunk warp finds
// its row by a 32-way search of indptr and sums its entries 32 / lpe at a
// step, lpe lanes an entry, the entry slots added by a fixed shuffle
// tree, into one [k] partial at slot c of a scratch buffer. A hub row of
// 44,835 entries is then one row group and about 175 chunk warps, not one
// warp's serial walk. A second kernel adds a long row's partials (chunks
// (s + seg_len) / seg_len .. (e - 1) / seg_len of a row [s, e)) to C[r]
// in chunk order. Both grids come from host-known numbers (n_rows, and
// the physical entry count / seg_len + 1 chunks; chunks past
// indptr[n_rows] exit), so the wrapper needs no sync and no schedule
// arrays. Where k, ldb, ldc or a base is not 16-byte aligned (k = 31, 33),
// the same kernels read element by element. Every sum is taken in one
// fixed order and there are no float atomics: two runs are bitwise equal.

#include <cstdint>
#include <cuda_runtime.h>

namespace raft_port {

constexpr int kWarp = 32;
constexpr int kSpmmThreads = 256;                  // 8 warps a block
constexpr unsigned kFull = 0xffffffffu;

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

// Lanes an entry (row warps: lanes a row) for a pass of `cols` columns:
// its 16-byte vectors (or elements) rounded up to a power of two.
__host__ __device__ __forceinline__ int lanes_for(int cols, int vw) {
  const int vecs = (cols + vw - 1) / vw;
  int lpe = 1;
  while (lpe < vecs && lpe < kWarp) lpe <<= 1;
  return lpe;
}

// dst[0:k] = the sum over entries [start, end) of data[j] * B[indices[j]]
// (zeros for an empty range), by one warp. VW: elements a load
// (16 / sizeof(T), or 1).
template <typename T, int VW>
__device__ __forceinline__ void warp_range_sum(
    const int* __restrict__ indices, const T* __restrict__ data,
    const T* __restrict__ b, int64_t ldb, int k, int64_t start,
    int64_t end, T* __restrict__ dst) {
  const int lane = threadIdx.x % kWarp;
  constexpr int kPass = kWarp * VW;       // columns a pass
  for (int c0 = 0; c0 < k; c0 += kPass) {
    const int vecs = ((k - c0 < kPass ? k - c0 : kPass) + VW - 1) / VW;
    const int lpe = lanes_for(k - c0 < kPass ? k - c0 : kPass, VW);
    const int epi = kWarp / lpe;          // entries a step
    const int slot = lane / lpe, v = lane % lpe;
    const bool live = v < vecs;
    const int col = c0 + v * VW;
    T acc[VW];
#pragma unroll
    for (int u = 0; u < VW; ++u) acc[u] = 0;
    for (int64_t base = start; base < end; base += kWarp) {
      int idx = 0;
      T val = 0;
      if (base + lane < end) {
        idx = indices[base + lane];
        val = data[base + lane];
      }
      const int cnt = static_cast<int>(
          end - base < kWarp ? end - base : kWarp);
      // lpe steps of epi entries cover the 32 loaded; unrolled, so that a
      // chunk's loads of B can be in flight together
#pragma unroll
      for (int t = 0; t < kWarp; ++t) {
        if (t < lpe) {                    // warp-uniform
          const int src = t * epi + slot;
          const int64_t bi = __shfl_sync(kFull, idx, src);
          const T bv = __shfl_sync(kFull, val, src);
          if (live && src < cnt) {
            const T* bp = b + bi * ldb + col;
            T bx[VW];
            if constexpr (VW == 1)
              bx[0] = __ldg(bp);
            else
              load16(bx, bp);
#pragma unroll
            for (int u = 0; u < VW; ++u) acc[u] += bv * bx[u];
          }
        }
      }
    }
    // add the entry slots: lanes v, v + lpe, v + 2 lpe, ... by a fixed tree
    for (int off = kWarp / 2; off >= lpe; off >>= 1)
#pragma unroll
      for (int u = 0; u < VW; ++u)
        acc[u] += __shfl_xor_sync(kFull, acc[u], off);
    if (slot == 0 && live) {
      if constexpr (VW == 1)
        dst[col] = acc[0];
      else
        store16(dst + col, acc);
    }
  }
}

// Row warp: rows [r0, r0 + 32 / lpe), a group of lpe lanes a row, each
// lane a column vector of it. A group walks its row's first seg_len
// entries in order, kUnroll at a time (their indices, then their B rows,
// in flight together); no shuffles, so the groups may diverge.
template <typename T, typename I, int VW>
__device__ __forceinline__ void warp_rows_sum(
    const I* __restrict__ indptr, const int* __restrict__ indices,
    const T* __restrict__ data, const T* __restrict__ b, int64_t ldb,
    T* __restrict__ c, int64_t ldc, int n_rows, int k, int seg_len,
    int64_t r0, int lpe) {
  constexpr int kUnroll = 8;
  const int lane = threadIdx.x % kWarp;
  const int64_t row = r0 + lane / lpe;
  if (row >= n_rows) return;
  const int64_t s = indptr[row];
  int64_t e = indptr[row + 1];
  if (e - s > seg_len) e = s + seg_len;
  for (int col = (lane % lpe) * VW; col < k; col += lpe * VW) {
    T acc[VW];
#pragma unroll
    for (int u = 0; u < VW; ++u) acc[u] = 0;
    for (int64_t j = s; j < e; j += kUnroll) {
      int idx[kUnroll];
      T val[kUnroll];
#pragma unroll
      for (int t = 0; t < kUnroll; ++t) {
        idx[t] = j + t < e ? indices[j + t] : 0;
        val[t] = j + t < e ? data[j + t] : T(0);
      }
      T bx[kUnroll][VW];
#pragma unroll
      for (int t = 0; t < kUnroll; ++t) {
        if (j + t < e) {
          const T* bp = b + static_cast<int64_t>(idx[t]) * ldb + col;
          if constexpr (VW == 1)
            bx[t][0] = __ldg(bp);
          else
            load16(bx[t], bp);
        }
      }
#pragma unroll
      for (int t = 0; t < kUnroll; ++t)
        if (j + t < e)
#pragma unroll
          for (int u = 0; u < VW; ++u) acc[u] += val[t] * bx[t][u];
    }
    T* dst = c + row * ldc + col;
    if constexpr (VW == 1)
      dst[0] = acc[0];
    else
      store16(dst, acc);
  }
}

// The last row whose start is <= entry `first`: a 32-way search, one pivot
// a lane a round (four rounds over 2^20 rows).
template <typename I>
__device__ __forceinline__ int row_of_entry(const I* __restrict__ indptr,
                                            int n_rows, int64_t first) {
  const int lane = threadIdx.x % kWarp;
  int lo = 0, hi = n_rows - 1;            // the answer lies in [lo, hi]
  while (lo < hi) {
    const int stride = (hi - lo + kWarp - 1) / kWarp;
    const int64_t p = lo + 1 + static_cast<int64_t>(lane) * stride;
    const bool ok = p <= hi && static_cast<int64_t>(indptr[p]) <= first;
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

// Warps [0, n_chunks) are chunk warps, the rest row warps of rpw rows each
// (the long chunk work starts first).
template <typename T, typename I, int VW>
__global__ void __launch_bounds__(kSpmmThreads)
    csr_spmm_split(const I* __restrict__ indptr,
                   const int* __restrict__ indices,
                   const T* __restrict__ data, const T* __restrict__ b,
                   int64_t ldb, T* __restrict__ c, int64_t ldc,
                   T* __restrict__ part, int64_t n_chunks, int n_rows, int k,
                   int seg_len, int lpe) {
  const int64_t w =
      (static_cast<int64_t>(blockIdx.x) * kSpmmThreads + threadIdx.x) /
      kWarp;
  if (w >= n_chunks) {
    warp_rows_sum<T, I, VW>(indptr, indices, data, b, ldb, c, ldc, n_rows,
                            k, seg_len, (w - n_chunks) * (kWarp / lpe), lpe);
    return;
  }
  const int64_t first = w * seg_len;
  if (first >= static_cast<int64_t>(indptr[n_rows])) return;
  const int r = row_of_entry(indptr, n_rows, first);
  const int64_t s = indptr[r], e = indptr[r + 1];
  const int64_t a = first > s + seg_len ? first : s + seg_len;
  const int64_t z = first + seg_len < e ? first + seg_len : e;
  if (a < z)
    warp_range_sum<T, VW>(indices, data, b, ldb, k, a, z, part + w * k);
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
  int64_t c_first = 0, c_end = 0;         // the row's chunks
  if (r < n_rows) {
    const int64_t s = indptr[r], e = indptr[r + 1];
    if (e - s > seg_len) {
      c_first = (s + seg_len) / seg_len;
      c_end = (e - 1) / seg_len + 1;
    }
  }
  unsigned longs = __ballot_sync(kFull, c_end > 0);
  while (longs) {
    const int l = __ffs(longs) - 1;
    longs &= longs - 1;
    const int64_t row = r0 + l;
    const int64_t c0 = __shfl_sync(kFull, c_first, l);
    const int n = static_cast<int>(__shfl_sync(kFull, c_end, l) - c0);
    for (int col = lane; col < k; col += kWarp) {
      T* cp = c + row * ldc + col;
      const T* pp = part + c0 * k + col;
      T acc = *cp;
      int q = 0;
      for (; q + 8 <= n; q += 8) {        // 8 loads in flight, added in order
        T t[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          t[u] = pp[static_cast<int64_t>(q + u) * k];
#pragma unroll
        for (int u = 0; u < 8; ++u) acc += t[u];
      }
      for (; q < n; ++q) acc += pp[static_cast<int64_t>(q) * k];
      *cp = acc;
    }
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
  const int lpe = lanes_for(k < kWarp * vw ? k : kWarp * vw, vw);
  const int64_t rpw = kWarp / lpe;        // rows a row warp
  const int64_t warps = n_chunks + (n_rows + rpw - 1) / rpw;
  const int64_t per_block = kSpmmThreads / kWarp;
  const int64_t blocks = (warps + per_block - 1) / per_block;
  if (vec)
    csr_spmm_split<T, I, kVec><<<blocks, kSpmmThreads, 0, st>>>(
        ip, ind, d, bm, ldb, cm, ldc, pm, n_chunks, n_rows, k, seg_len, lpe);
  else
    csr_spmm_split<T, I, 1><<<blocks, kSpmmThreads, 0, st>>>(
        ip, ind, d, bm, ldb, cm, ldc, pm, n_chunks, n_rows, k, seg_len, lpe);
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
