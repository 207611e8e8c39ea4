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
// Bound on an H100 SXM: operations, on the CUDA cores (no metric here is a
// product, so the tensor cores cannot help). Lane instructions an (i, j, c)
// element: l1 and linf 2 (a subtract, then an add or a NaN-propagating max
// with |.| as a free operand modifier), hamming 2 (a compare, a predicated
// add), l2un 3 (subtract, multiply, add: rounded apart, no FFMA), canberra
// about 12 (its IEEE divide), lp about 22 (powf); at 132 SMs x 128 lanes x
// 1.98 GHz = 33.5e12 a second. At the kNN chunk (4096 x 32768 x 128) l1 is
// 1.03 ms of operations against 0.16 ms of output bytes.
//
// Design: a register-blocked CUDA-core tile. f32: 64 x 128 outputs a
// block of 256 threads, 4 x 8 a thread (rows ty + 16 i, columns tx + 16 j);
// f64, canberra and lp: 64 x 64, 4 x 4 a thread. Depth chunks of 128 bytes
// of every row are staged in their natural [row][depth] layout by cp.async
// into two stages (the next chunk in flight while this one is reduced, one
// __syncthreads a chunk), each shared row padded by 16 bytes so that the
// 16-byte reads of a quarter warp (eight consecutive rows) hit all 32
// banks. A 16-byte read gives 4 (f32) depths of a row: x's feeds 8 outputs,
// y's 4, so one LDS.128 feeds 16 or 32 element-steps (canberra and lp,
// whose terms are long, read one depth at a time: one LDS feeds 4 of their
// 4 x 4). Staging is by 16-byte copies where both operands and both row
// strides are 16-byte aligned (chosen by the C entry point from the
// pointers and strides), else element by element (a row of 50 f32, a
// slice at any offset); rows >= m, columns >= n and depth past k are
// zero-filled, rows and columns past the edge never written, depth past k
// never reduced. Two blocks an SM, with no register spilled. Each output
// accumulates its terms one depth at a time, in order, with rounded
// intrinsics (no FFMA contraction), so the result is bitwise repeatable
// and equals the plain version's in-order sum; only lp's pow differs from
// PyTorch's by ulps. linf's f32 max is PTX max.NaN (one FMNMX.NAN); f64
// has no .NaN form and keeps a compare fold.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace raft_port {

enum UnexpandedMetric {
  kUnL1 = 0, kUnLinf = 1, kUnCanberra = 2, kUnLp = 3, kUnHamming = 4,
  kUnL2 = 5
};

constexpr int kUnThreads = 256;          // 16 x 16
constexpr int kUnChunkBytes = 128;       // depth a stage, bytes of each row

// canberra and lp: terms of many instructions, with branches (the IEEE
// divide's slow path, powf's special cases) that keep the compiler from
// interleaving the terms of many outputs
__host__ __device__ constexpr bool long_term(int metric) {
  return metric == kUnCanberra || metric == kUnLp;
}

// The block tile of a metric: 4 x 8 outputs a thread in f32, 64 x 128 a
// block (8 x 8 would need more than the 128 registers a thread that two
// blocks an SM leave, and spill); 4 x 4 in f64 and for the long terms,
// which want more warps an SM rather than more outputs a thread.
template <typename T, int METRIC>
struct Tile {
  static constexpr int RM = 4;                      // outputs a thread, down
  static constexpr int RN = sizeof(T) == 4 && !long_term(METRIC) ? 8 : 4;
  static constexpr int BM = 16 * RM;                // block tile, down
  static constexpr int BN = 16 * RN;                // block tile, across
  static constexpr int KC = kUnChunkBytes / sizeof(T);   // depth a chunk
  static constexpr int V = 16 / sizeof(T);          // depths a 16-byte read
  static constexpr int LD = KC + V;                 // padded shared row
  static constexpr int XS = BM * LD;                // x's tile, elements
  static constexpr int STAGE = (BM + BN) * LD;      // x's tile, then y's
  static constexpr int SMEM = 2 * STAGE * static_cast<int>(sizeof(T));
};

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static __device__ __forceinline__ float at(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
};
template <>
struct Vec<double> {
  using type = double2;
  static __device__ __forceinline__ double at(const double2& v, int i) {
    return i == 0 ? v.x : v.y;
  }
};

template <typename T>
struct Ops;

template <>
struct Ops<float> {
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
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
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
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

// acc + 1 where a != b (unordered: NaN != NaN), as a compare and a
// predicated add
__device__ __forceinline__ float count_ne(float acc, float a, float b) {
  asm("{\n .reg .pred ne;\n setp.neu.f32 ne, %1, %2;\n"
      " @ne add.rn.f32 %0, %0, 0f3F800000;\n}"
      : "+f"(acc)
      : "f"(a), "f"(b));
  return acc;
}
__device__ __forceinline__ double count_ne(double acc, double a, double b) {
  return a != b ? __dadd_rn(acc, 1.0) : acc;
}

// max that returns NaN if either operand is NaN (f32: one FMNMX.NAN)
__device__ __forceinline__ float max_nan(float acc, float v) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(acc), "f"(v));
  return r;
}
__device__ __forceinline__ double max_nan(double acc, double v) {
  return (v > acc || v != v) ? v : acc;
}

// acc folded with the depth term f(a, b): a sum in depth order, or linf's
// max, which keeps a NaN once it has one.
template <typename T, int METRIC>
__device__ __forceinline__ T step(T acc, T a, T b, T p) {
  using O = Ops<T>;
  if constexpr (METRIC == kUnL1) return O::add(acc, O::abs(O::sub(a, b)));
  if constexpr (METRIC == kUnLinf) return max_nan(acc, O::abs(O::sub(a, b)));
  if constexpr (METRIC == kUnL2) {
    const T d = O::sub(a, b);
    return O::add(acc, O::mul(d, d));
  }
  if constexpr (METRIC == kUnCanberra) {
    const T den = O::add(O::abs(a), O::abs(b));
    const T q = O::div(O::abs(O::sub(a, b)), den);
    return O::add(acc, den > T(0) ? q : T(0));
  }
  if constexpr (METRIC == kUnLp)
    return O::add(acc, O::pw(O::abs(O::sub(a, b)), p));
  return count_ne(acc, a, b);                          // hamming
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of BYTES (4, 8 or 16) with `valid` of them read, the rest
// zero-filled; an invalid copy never reads its source.
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int valid) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(valid)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(BYTES), "r"(valid)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copies depth [k0, k0 + KC) of rows [row0, row0 + BROWS) of src into the
// stage at shared address s: each thread the same piece (16 bytes, or one
// element) of N rows STEP apart. Rows past `rows` and depth past k are
// zero-filled and never read. Worked out anew every chunk, so that no
// register holds it across the chunk's arithmetic.
template <typename T, int METRIC, bool VEC, int BROWS>
__device__ __forceinline__ void stage(uint32_t s, const T* src, int64_t ld,
                                      int row0, int rows, int k0, int k) {
  using TL = Tile<T, METRIC>;
  constexpr int PIECE = VEC ? TL::V : 1;      // elements a copy
  constexpr int PIECES = TL::KC / PIECE;      // copies a row a chunk
  constexpr int STEP = kUnThreads / PIECES;   // rows between copies
  constexpr int BYTES = PIECE * static_cast<int>(sizeof(T));
  const int r0 = threadIdx.x / PIECES;
  const int piece = threadIdx.x % PIECES * PIECE;
  const int left = k - k0 - piece;
  const int valid =
      left <= 0 ? 0 : min(left, PIECE) * static_cast<int>(sizeof(T));
  const int64_t at = static_cast<int64_t>(row0 + r0) * ld + k0 + piece;
#pragma unroll
  for (int i = 0; i < BROWS / STEP; ++i) {
    const bool ok = row0 + r0 + i * STEP < rows && valid > 0;
    const int to = ((r0 + i * STEP) * TL::LD + piece) * sizeof(T);
    cp_async<BYTES>(s + to, ok ? src + at + i * STEP * ld : src,
                    ok ? valid : 0);
  }
}

// Depths [kv0, kv1) of the staged chunk, V at a time (kv0, kv1 multiples
// of V): 16-byte reads of x's R rows, then of y's rows one at a time.
template <typename T, int METRIC, int RM, int RN>
__device__ __forceinline__ void reduce_vectors(T (&acc)[RM][RN], const T* sx,
                                               const T* sy, int kv0, int kv1,
                                               T p) {
  using TL = Tile<T, METRIC>;
  using VT = typename Vec<T>::type;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 2
  for (int kv = kv0; kv < kv1; kv += TL::V) {
    VT a[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      a[i] = *reinterpret_cast<const VT*>(sx + (ty + 16 * i) * TL::LD + kv);
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const VT b =
          *reinterpret_cast<const VT*>(sy + (tx + 16 * j) * TL::LD + kv);
#pragma unroll
      for (int v = 0; v < TL::V; ++v)
#pragma unroll
        for (int i = 0; i < RM; ++i)
          acc[i][j] = step<T, METRIC>(acc[i][j], Vec<T>::at(a[i], v),
                                      Vec<T>::at(b, v), p);
    }
  }
}

// Depths [kk0, kk1) one at a time: the chunk's last few, or every depth of
// canberra and lp, whose long terms would make a 16-byte step's 256
// inlined copies too large a loop for the instruction cache.
template <typename T, int METRIC, int RM, int RN>
__device__ __forceinline__ void reduce_scalars(T (&acc)[RM][RN], const T* sx,
                                               const T* sy, int kk0, int kk1,
                                               T p) {
  using TL = Tile<T, METRIC>;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 1
  for (int kk = kk0; kk < kk1; ++kk) {
    T a[RM], b[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = sx[(ty + 16 * i) * TL::LD + kk];
#pragma unroll
    for (int j = 0; j < RN; ++j) b[j] = sy[(tx + 16 * j) * TL::LD + kk];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j)
        acc[i][j] = step<T, METRIC>(acc[i][j], a[i], b[j], p);
  }
}

template <typename T, int METRIC, bool VEC>
__global__ void __launch_bounds__(kUnThreads, 2)
    unexpanded_tile_kernel(const T* __restrict__ x, int64_t ldx,
                           const T* __restrict__ y, int64_t ldy,
                           T* __restrict__ out, int m, int n, int k, T p) {
  using TL = Tile<T, METRIC>;
  constexpr int RM = TL::RM, RN = TL::RN;
  constexpr int kStageBytes = TL::STAGE * static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const T* smem = reinterpret_cast<const T*>(smem_raw);
  const uint32_t sx0 = smem_u32(smem_raw);
  const uint32_t sy0 = sx0 + TL::XS * static_cast<int>(sizeof(T));
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int col0 = blockIdx.x * TL::BN;
  const int chunks = (k + TL::KC - 1) / TL::KC;
  // row tiles stride by the grid's height (at most 65,535)
  for (int row0 = blockIdx.y * TL::BM; row0 < m;
       row0 += gridDim.y * TL::BM) {
    T acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = T(0);
    stage<T, METRIC, VEC, TL::BM>(sx0, x, ldx, row0, m, 0, k);
    stage<T, METRIC, VEC, TL::BN>(sy0, y, ldy, col0, n, 0, k);
    cp_async_commit();
    for (int c = 0; c < chunks; ++c) {
      // chunk c has landed for every thread, and every thread is done with
      // chunk c - 1, whose stage the next copy overwrites
      cp_async_wait_all();
      __syncthreads();
      const int k0 = c * TL::KC;
      if (c + 1 < chunks) {
        const int next = ((c + 1) & 1) * kStageBytes;
        stage<T, METRIC, VEC, TL::BM>(sx0 + next, x, ldx, row0, m,
                                      k0 + TL::KC, k);
        stage<T, METRIC, VEC, TL::BN>(sy0 + next, y, ldy, col0, n,
                                      k0 + TL::KC, k);
        cp_async_commit();
      }
      const T* sx = smem + (c & 1) * TL::STAGE;
      const T* sy = sx + TL::XS;
      const int kc = min(TL::KC, k - k0);
      const int kv = long_term(METRIC) ? 0 : kc / TL::V * TL::V;
      reduce_vectors<T, METRIC, RM, RN>(acc, sx, sy, 0, kv, p);
      reduce_scalars<T, METRIC, RM, RN>(acc, sx, sy, kv, kc, p);
    }
    __syncthreads();   // the next row tile's first copy reuses stage 0
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = row0 + ty + 16 * i;
      if (r >= m) continue;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int c = col0 + tx + 16 * j;
        if (c < n) out[static_cast<int64_t>(r) * n + c] = acc[i][j];
      }
    }
  }
}

template <typename T, int METRIC, bool VEC>
static cudaError_t launch_one(cudaStream_t st, const T* x, int64_t ldx,
                              const T* y, int64_t ldy, T* out, int m, int n,
                              int k, T p) {
  using TL = Tile<T, METRIC>;
  auto kern = unexpanded_tile_kernel<T, METRIC, VEC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + TL::BN - 1) / TL::BN,
                  std::min((m + TL::BM - 1) / TL::BM, 65535));
  kern<<<grid, kUnThreads, TL::SMEM, st>>>(x, ldx, y, ldy, out, m, n, k, p);
  return cudaGetLastError();
}

template <typename T, bool VEC>
static cudaError_t launch(int metric, cudaStream_t st, const T* x,
                          int64_t ldx, const T* y, int64_t ldy, T* out, int m,
                          int n, int k, T p) {
  switch (metric) {
    case kUnL1:
      return launch_one<T, kUnL1, VEC>(st, x, ldx, y, ldy, out, m, n, k, p);
    case kUnLinf:
      return launch_one<T, kUnLinf, VEC>(st, x, ldx, y, ldy, out, m, n, k, p);
    case kUnCanberra:
      return launch_one<T, kUnCanberra, VEC>(st, x, ldx, y, ldy, out, m, n, k,
                                             p);
    case kUnLp:
      return launch_one<T, kUnLp, VEC>(st, x, ldx, y, ldy, out, m, n, k, p);
    case kUnHamming:
      return launch_one<T, kUnHamming, VEC>(st, x, ldx, y, ldy, out, m, n, k,
                                            p);
    default:
      return launch_one<T, kUnL2, VEC>(st, x, ldx, y, ldy, out, m, n, k, p);
  }
}

// Stages by 16-byte copies where x, y and both row strides are 16-byte
// aligned (config 1's rows of 50 f32 and slices at odd offsets are not),
// else element by element.
template <typename T>
static cudaError_t launch_dtype(int metric, cudaStream_t st, const void* x,
                                int64_t ldx, const void* y, int64_t ldy,
                                void* out, int m, int n, int k, double p) {
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                       ldx * static_cast<int64_t>(sizeof(T)) % 16 == 0 &&
                       ldy * static_cast<int64_t>(sizeof(T)) % 16 == 0;
  const T* xs = static_cast<const T*>(x);
  const T* ys = static_cast<const T*>(y);
  T* o = static_cast<T*>(out);
  const T pt = static_cast<T>(p);
  return aligned
             ? launch<T, true>(metric, st, xs, ldx, ys, ldy, o, m, n, k, pt)
             : launch<T, false>(metric, st, xs, ldx, ys, ldy, o, m, n, k, pt);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? launch_dtype<float>(metric, st, x, ldx, y, ldy, out, m, n, k, p)
          : launch_dtype<double>(metric, st, x, ldx, y, ldy, out, m, n, k, p);
  return static_cast<int>(err);
}
