// Unexpanded pairwise metrics, the family with no GEMM form: out[i, j] =
// sum over depth c of f(x[i, c], y[j, c]), or the max for linf, as raw
// reductions (the caller applies lp's ^(1/p), hamming's /k, l2un's sqrt):
//   l1       |a - b|
//   linf     max |a - b|, NaN-propagating
//   canberra |a - b| / (|a| + |b|) where |a| + |b| > 0, else 0 (a NaN
//            denominator fails the test and gives 0)
//   lp       |a - b|^p
//   hamming  1 where a != b (NaN != NaN counts 1)
//   l2un     (a - b)^2
// in f32 or f64 (bf16 is cast to f32 by the wrapper, as the TPU kernel
// casts its blocks).
//
// Replaces raft_tpu/linalg/contractions.py:_unexpanded_tile_kernel (:525),
// launched by _unexpanded_padded (:583) from pairwise_unexpanded_pallas.
// The TPU kernel rides the depth axis on its sequential grid and
// accumulates the output tile across depth chunks in VMEM; it needs its
// operands transposed and zero-padded to (8, 128) tiles.
//
// Bound on an H100 SXM: operations. Each (i, j, c) element costs about two
// lane instructions (a subtract, then an add or max with |.| as a free
// operand modifier; about 12 for canberra's IEEE divide), at 132 SMs x 128
// lanes x 1.98 GHz = 33.5e12 a second, against m*n output bytes: at the
// kNN chunk (4096 x 32768 x 128) l1 is 1.03 ms of operations, 0.16 ms of
// output.
// Design: a CUDA-core tile of 64 x 64 outputs a block, 4 x 4 a thread
// (rows ty + 16 i, columns tx + 16 j, so a warp's shared-memory reads are
// broadcasts or consecutive words). Depth chunks of 32 of x and y are
// staged through shared memory transposed to [depth][row]. Each output
// accumulates its terms one depth at a time, in order, with rounded
// intrinsics (no FMA contraction), so the result is bitwise repeatable and
// equals the plain version's in-order sum; only lp's pow differs from
// PyTorch's by ulps. Rows >= m and columns >= n are staged as 0 and never
// written; depth past k is never reduced, so no padding is needed.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace raft_port {

enum UnexpandedMetric {
  kUnL1 = 0, kUnLinf = 1, kUnCanberra = 2, kUnLp = 3, kUnHamming = 4,
  kUnL2 = 5
};

constexpr int kUnBM = 64;
constexpr int kUnBN = 64;
constexpr int kUnKC = 32;
constexpr int kUnThreads = 256;   // 16 x 16, a 4 x 4 register tile each
constexpr int kUnT = 4;

template <typename T>
struct Ops;

template <>
struct Ops<float> {
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return __fdiv_rn(a, b);
  }
  static __device__ __forceinline__ float pw(float a, float p) {
    return powf(a, p);
  }
  static __device__ __forceinline__ float abs(float a) { return fabsf(a); }
};

template <>
struct Ops<double> {
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double div(double a, double b) {
    return __ddiv_rn(a, b);
  }
  static __device__ __forceinline__ double pw(double a, double p) {
    return pow(a, p);
  }
  static __device__ __forceinline__ double abs(double a) { return fabs(a); }
};

// One depth term f(a, b).
template <typename T, int METRIC>
__device__ __forceinline__ T term(T a, T b, T p) {
  using O = Ops<T>;
  if constexpr (METRIC == kUnL1 || METRIC == kUnLinf) return O::abs(a - b);
  if constexpr (METRIC == kUnL2) {
    const T d = a - b;
    return O::mul(d, d);
  }
  if constexpr (METRIC == kUnCanberra) {
    const T den = O::add(O::abs(a), O::abs(b));
    return den > T(0) ? O::div(O::abs(a - b), den) : T(0);
  }
  if constexpr (METRIC == kUnLp) return O::pw(O::abs(a - b), p);
  return a != b ? T(1) : T(0);     // hamming
}

// The running reduction: a sum in depth order, or linf's max, which keeps
// a NaN once it has one (fmax would drop it).
template <typename T, int METRIC>
__device__ __forceinline__ T fold(T acc, T v) {
  if constexpr (METRIC == kUnLinf) return (v > acc || v != v) ? v : acc;
  return Ops<T>::add(acc, v);
}

template <typename T, int ROWS>
__device__ __forceinline__ void stage_rows(T (&dst)[kUnKC][ROWS + 1],
                                           const T* src, int64_t ld,
                                           int row0, int rows, int k0,
                                           int k) {
  for (int e = threadIdx.x; e < ROWS * kUnKC; e += kUnThreads) {
    const int r = e / kUnKC, c = e % kUnKC;
    const int gr = row0 + r, gc = k0 + c;
    dst[c][r] = (gr < rows && gc < k)
                    ? src[static_cast<int64_t>(gr) * ld + gc]
                    : T(0);
  }
}

template <typename T, int METRIC>
__global__ void __launch_bounds__(kUnThreads)
    unexpanded_tile_kernel(const T* __restrict__ x, int64_t ldx,
                           const T* __restrict__ y, int64_t ldy,
                           T* __restrict__ out, int m, int n, int k, T p) {
  __shared__ T sa[kUnKC][kUnBM + 1];
  __shared__ T sb[kUnKC][kUnBN + 1];
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int col0 = blockIdx.x * kUnBN;
  // row tiles stride by the grid's height (at most 65,535)
  for (int row0 = blockIdx.y * kUnBM; row0 < m; row0 += gridDim.y * kUnBM) {
    T acc[kUnT][kUnT];
#pragma unroll
    for (int i = 0; i < kUnT; ++i)
#pragma unroll
      for (int j = 0; j < kUnT; ++j) acc[i][j] = T(0);
    for (int k0 = 0; k0 < k; k0 += kUnKC) {
      stage_rows<T, kUnBM>(sa, x, ldx, row0, m, k0, k);
      stage_rows<T, kUnBN>(sb, y, ldy, col0, n, k0, k);
      __syncthreads();
      const int kc = min(kUnKC, k - k0);
#pragma unroll 4
      for (int kk = 0; kk < kc; ++kk) {
        T a[kUnT], b[kUnT];
#pragma unroll
        for (int i = 0; i < kUnT; ++i) a[i] = sa[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kUnT; ++j) b[j] = sb[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kUnT; ++i)
#pragma unroll
          for (int j = 0; j < kUnT; ++j)
            acc[i][j] =
                fold<T, METRIC>(acc[i][j], term<T, METRIC>(a[i], b[j], p));
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kUnT; ++i) {
      const int r = row0 + ty + 16 * i;
      if (r >= m) continue;
#pragma unroll
      for (int j = 0; j < kUnT; ++j) {
        const int c = col0 + tx + 16 * j;
        if (c < n) out[static_cast<int64_t>(r) * n + c] = acc[i][j];
      }
    }
  }
}

template <typename T>
static void launch(int metric, dim3 grid, cudaStream_t st, const T* x,
                   int64_t ldx, const T* y, int64_t ldy, T* out, int m,
                   int n, int k, T p) {
  switch (metric) {
    case kUnL1:
      unexpanded_tile_kernel<T, kUnL1><<<grid, kUnThreads, 0, st>>>(
          x, ldx, y, ldy, out, m, n, k, p);
      break;
    case kUnLinf:
      unexpanded_tile_kernel<T, kUnLinf><<<grid, kUnThreads, 0, st>>>(
          x, ldx, y, ldy, out, m, n, k, p);
      break;
    case kUnCanberra:
      unexpanded_tile_kernel<T, kUnCanberra><<<grid, kUnThreads, 0, st>>>(
          x, ldx, y, ldy, out, m, n, k, p);
      break;
    case kUnLp:
      unexpanded_tile_kernel<T, kUnLp><<<grid, kUnThreads, 0, st>>>(
          x, ldx, y, ldy, out, m, n, k, p);
      break;
    case kUnHamming:
      unexpanded_tile_kernel<T, kUnHamming><<<grid, kUnThreads, 0, st>>>(
          x, ldx, y, ldy, out, m, n, k, p);
      break;
    default:
      unexpanded_tile_kernel<T, kUnL2><<<grid, kUnThreads, 0, st>>>(
          x, ldx, y, ldy, out, m, n, k, p);
  }
}

}  // namespace raft_port

// dtype: 0 f32, 1 f64 (x, y and out alike); metric: l1, linf, canberra,
// lp, hamming, l2un = 0..5; p_bits: the IEEE bits of lp's exponent as an
// f64 (a plain C interface passes no doubles here); out [m, n] contiguous.
// Returns the CUDA error of the launch.
extern "C" int raft_unexpanded_tile(int dtype, int metric, int64_t p_bits,
                                    const void* x, int64_t ldx,
                                    const void* y, int64_t ldy, void* out,
                                    int m, int n, int k, void* stream) {
  using namespace raft_port;
  if (dtype < 0 || dtype > 1 || metric < 0 || metric > 5 || m < 1 ||
      n < 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  double p;
  std::memcpy(&p, &p_bits, sizeof p);
  const dim3 grid((n + kUnBN - 1) / kUnBN,
                  std::min((m + kUnBM - 1) / kUnBM, 65535));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(metric, grid, st, static_cast<const float*>(x), ldx,
                  static_cast<const float*>(y), ldy, static_cast<float*>(out),
                  m, n, k, static_cast<float>(p));
  else
    launch<double>(metric, grid, st, static_cast<const double*>(x), ldx,
                   static_cast<const double*>(y), ldy,
                   static_cast<double*>(out), m, n, k, p);
  return static_cast<int>(cudaGetLastError());
}
