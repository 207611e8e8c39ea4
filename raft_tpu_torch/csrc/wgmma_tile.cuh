// Tensor-core cross-product tile of the port's contraction kernels on
// Hopper (sm_90a): x·yᵀ for a 128 x 128 output tile, bf16 operands, f32
// accumulators, on wgmma.mma_async. pairwise_tile.cu, fused_argmin.cu,
// fused_lloyd.cu, fused_topk.cu and minonly.cu run their tiers 'default'
// and 'high' on it; common.cuh's CUDA-core tile serves 'highest' (there is
// no exact f32 tensor-core product).
//
// Operands: bf16 rows, x [m, >= k] and y [n, >= k], row strides ldx and
// ldy elements. k, ldx and ldy are multiples of 8 and the bases 16-byte
// aligned, so that every 16-byte chunk of a row is whole (the wrapper pads
// the depth with zero columns where they are not: zeros add exact zeros).
// HALVES == 1: one bf16 pass (tier 'default', operands rounded f32 -> bf16
// half to even outside). HALVES == 2: bf16x3 (tier 'high'), x1/y1 the lo
// halves of the same layout; each depth step issues hi·hi, hi·lo and lo·hi
// into one accumulator. A product of two bf16 values is exact in f32, so
// only the order of the f32 sums differs from the CUDA-core tile's.
//
// Pipeline: one block of two warpgroups a streaming multiprocessor walks
// the output tiles (row tile, column tile; column fastest) persistently,
// in one of three walks: the flat walk (block b takes the flattened tiles
// b, b + G, b + 2G, ...; pairwise_tile.cu), the row-owning walk (block b
// takes row tiles b, b + G, ... and inside each all its column tiles in
// order, so that a row's running reduction stays in registers;
// fused_lloyd.cu, and fused_argmin.cu where X has enough row tiles to
// fill the card) or the split walk (the column tiles cut into splits of
// tps tiles, the last one shorter; block b takes the work units (row
// tile, split) b, b + G, ..., unit u being row tile u / splits and split
// u % splits, and inside each the split's column tiles in order;
// fused_topk.cu, minonly.cu and fused_argmin.cu at few row tiles, which
// alone would leave most multiprocessors idle).
// Each tile's depth goes in stages of 64 (one 128-byte row of bf16 a tile
// row), two stages in a ring, filled by cp.async (zero-fill past m, n and
// k) into the 128-byte-swizzled layout wgmma reads: row r of a stage at
// byte 128 r, its 16-byte chunk c at chunk c ^ (r % 8), every operand tile
// 1024-byte aligned. All 256 threads load; each warpgroup then multiplies
// its 64 rows of x against all 128 rows of y (m64n128k16, four depth steps
// a stage). A stage is refilled, with the next stage of the walk (this
// tile's or the next tile's), as soon as both warpgroups are done with it,
// so the next tile's operands arrive while the caller runs its epilogue.
//
// Epilogue helpers: col_terms (a tile's column terms, loaded before its
// product), the first-min argmin on the accumulator fragment (fold_min
// and quad_argmin, under common.cuh's order with NaN never winning, as
// fused_lloyd.cu and minonly.cu fold, or NaN minimal, as fused_argmin.cu
// folds; minonly.cu's branch-free L2 tile fold fold_l2_tile), and the
// host check of the operand contract (operands_ok).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace raft_port {
namespace wg {

constexpr int kBM = 128;      // x rows a tile: two warpgroups of 64
constexpr int kBN = 128;      // y rows a tile: the wgmma N
constexpr int kBK = 64;       // depth a stage: 128 bytes of bf16
constexpr int kThreads = 256;
constexpr int kStages = 2;
constexpr int kOperandBytes = kBM * kBK * 2;     // 16 KB (kBM == kBN)
constexpr int kAcc = kBN / 2;                    // f32 accumulators a thread

template <int HALVES>
struct Layout {
  // a stage: x halves, then y halves
  static constexpr int kStageBytes = 2 * HALVES * kOperandBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// make this thread's shared-memory writes visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Shared-memory matrix descriptor of a K-major operand tile in the 128-byte
// swizzle: start address >> 4 (bits 0-13), leading byte offset 16 >> 4
// (unused by this layout), stride byte offset 1024 >> 4 (one 8-row swizzle
// atom to the next, bits 32-45), layout type 1 = 128-byte swizzle (bits
// 62-63). A depth step of 16 bf16 (32 bytes) inside the 128-byte row adds
// 2 to the start address field.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d (+)= A·Bᵀ for A 64 x 16 and B 128 x 16, both K-major bf16 in shared
// memory; scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[kAcc],
                                                 uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Stage rows [row0, row0 + 128) x depth [k0, k0 + 64) of a bf16 operand
// into the swizzled tile at shared address dst; chunks past rows or k are
// zero-filled (their source is never read).
__device__ __forceinline__ void load_tile(uint32_t dst, const uint16_t* p,
                                          int64_t ld, int row0, int rows,
                                          int k0, int k) {
#pragma unroll
  for (int i = 0; i < kBM * 8 / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e >> 3, ch = e & 7;
    const int gr = row0 + r, gc = k0 + ch * 8;
    const bool ok = gr < rows && gc < k;
    const uint16_t* src = ok ? p + static_cast<int64_t>(gr) * ld + gc : p;
    cp_async16(dst + r * 128 + ((ch ^ (r & 7)) << 4), src, ok);
  }
}

// Where accumulator i of this thread lies in the 128 x 128 tile: warpgroup
// w multiplies rows 64 w .. 64 w + 63; inside it, warp v of the group holds
// rows 16 v + lane / 4 (+ 8 for i % 4 >= 2) and columns 8 (i / 4) +
// 2 (lane % 4) + i % 2.
__device__ __forceinline__ int frag_row(int i) {
  const int t = threadIdx.x;
  return (t >> 7) * 64 + ((t >> 5) & 3) * 16 + ((t & 31) >> 2) +
         ((i >> 1) & 1) * 8;
}

__device__ __forceinline__ int frag_col(int i) {
  return (i >> 2) * 8 + 2 * (threadIdx.x & 3) + (i & 1);
}

enum Walk { kFlatWalk = 0, kRowWalk = 1, kSplitWalk = 2 };

// The persistent walk over output tiles with its two-stage operand ring.
// Every thread of the block constructs it and calls cross() once a tile,
// in the order of first() and next(); the block must have kThreads
// threads and Layout<HALVES>::kRingBytes of 1024-byte aligned shared
// memory at ring. The row-owning and split walks need 2 x tiles < 2^31;
// the split walk takes tps, the column tiles a split (>= 1).
template <int HALVES, int WALK = kFlatWalk>
struct Pipe {
  const uint16_t *x0, *x1, *y0, *y1;
  int64_t ldx, ldy;
  int m, n, k;
  uint32_t ring;
  int tiles_n, tiles, nk;
  int tps, splits, units;                  // the split walk's work units
  int ld_tile, ld_kc, stage;

  __device__ Pipe(const uint16_t* x0_, const uint16_t* x1_, int64_t ldx_,
                  const uint16_t* y0_, const uint16_t* y1_, int64_t ldy_,
                  int m_, int n_, int k_, void* ring_, int tps_ = 1)
      : x0(x0_), x1(x1_), y0(y0_), y1(y1_), ldx(ldx_), ldy(ldy_), m(m_),
        n(n_), k(k_), ring(smem_u32(ring_)),
        tiles_n((n_ + kBN - 1) / kBN),
        tiles(((m_ + kBM - 1) / kBM) * ((n_ + kBN - 1) / kBN)),
        nk((k_ + kBK - 1) / kBK), tps(tps_),
        splits((tiles_n + tps_ - 1) / tps_),
        units(((m_ + kBM - 1) / kBM) * splits), ld_tile(first()), ld_kc(0),
        stage(0) {
    issue(0);
    issue(1);
  }

  __device__ int row0(int tile) const { return (tile / tiles_n) * kBM; }
  __device__ int col0(int tile) const { return (tile % tiles_n) * kBN; }

  // split walk: unit u's row tile's first row, split and column tiles
  // [first, end)
  __device__ int unit_row0(int u) const { return (u / splits) * kBM; }
  __device__ int unit_split(int u) const { return u % splits; }
  __device__ int unit_first(int u) const { return (u % splits) * tps; }
  __device__ int unit_end(int u) const {
    return min(tiles_n, unit_first(u) + tps);
  }
  // the first tile of unit u, or tiles past the last unit
  __device__ int unit_tile(int u) const {
    return u < units ? (u / splits) * tiles_n + unit_first(u) : tiles;
  }

  // this block's first tile, and the tile after `tile`, of the walk
  __device__ int first() const {
    if constexpr (WALK == kSplitWalk)
      return unit_tile(static_cast<int>(blockIdx.x));
    return WALK == kRowWalk ? static_cast<int>(blockIdx.x) * tiles_n
                            : static_cast<int>(blockIdx.x);
  }
  __device__ int next(int tile) const {
    if constexpr (WALK == kSplitWalk) {
      const int ct = tile % tiles_n;
      if (ct + 1 < tiles_n && (ct + 1) % tps != 0) return tile + 1;
      return unit_tile((tile / tiles_n) * splits + ct / tps +
                       static_cast<int>(gridDim.x));
    }
    if constexpr (WALK == kRowWalk)
      return tile % tiles_n == tiles_n - 1
                 ? tile + 1 + (static_cast<int>(gridDim.x) - 1) * tiles_n
                 : tile + 1;
    return tile + static_cast<int>(gridDim.x);
  }

  // Load the next stage of the walk into ring slot s; commits a group even
  // when the walk is over, so that the group count stays uniform.
  __device__ void issue(int s) {
    if (ld_tile < tiles) {
      const uint32_t st = ring + s * Layout<HALVES>::kStageBytes;
      const int r0 = row0(ld_tile), c0 = col0(ld_tile), k0 = ld_kc * kBK;
      load_tile(st, x0, ldx, r0, m, k0, k);
      if constexpr (HALVES == 2)
        load_tile(st + kOperandBytes, x1, ldx, r0, m, k0, k);
      load_tile(st + HALVES * kOperandBytes, y0, ldy, c0, n, k0, k);
      if constexpr (HALVES == 2)
        load_tile(st + 3 * kOperandBytes, y1, ldy, c0, n, k0, k);
      if (++ld_kc == nk) {
        ld_kc = 0;
        ld_tile = next(ld_tile);
      }
    }
    cp_async_commit();
  }

  // d = the current tile's x·yᵀ over the whole depth. Synchronises the
  // block once before and once after each stage.
  __device__ void cross(float (&d)[kAcc]) {
    const uint32_t wg_rows = (threadIdx.x >> 7) * 64 * 128;
    for (int kc = 0; kc < nk; ++kc) {
      cp_async_wait<1>();             // this stage's group has landed
      fence_proxy_async();
      __syncthreads();
      const uint32_t st = ring + stage * Layout<HALVES>::kStageBytes;
      const uint64_t ah = desc_sw128(st + wg_rows);
      const uint64_t bh = desc_sw128(st + HALVES * kOperandBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const int scale = kc > 0 || kk > 0;
        if constexpr (HALVES == 2) {
          const uint64_t al = desc_sw128(st + kOperandBytes + wg_rows);
          const uint64_t bl = desc_sw128(st + 3 * kOperandBytes);
          wgmma_m64n128k16(d, ah + 2 * kk, bh + 2 * kk, scale);
          wgmma_m64n128k16(d, ah + 2 * kk, bl + 2 * kk, 1);
          wgmma_m64n128k16(d, al + 2 * kk, bh + 2 * kk, 1);
        } else {
          wgmma_m64n128k16(d, ah + 2 * kk, bh + 2 * kk, scale);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      __syncthreads();                // both warpgroups are done with it
      issue(stage);
      stage ^= 1;
    }
  }

  __device__ void drain() const { cp_async_wait<0>(); }
};

// The norm terms (common.cuh's norm_term) of this thread's 32 fragment
// columns of the tile at col0, yt[2 j + e] for column col0 + frag_col(4 j)
// + e, 0 past n. A caller may load them before cross(): they do not depend
// on the product.
template <int METRIC>
__device__ __forceinline__ void col_terms(float (&yt)[kBN / 4], int col0,
                                          int n, const float* yn) {
#pragma unroll
  for (int b = 0; b < kBN / 4; ++b) {
    const int c = col0 + frag_col(4 * (b / 2)) + b % 2;
    yt[b] = c < n ? norm_term<METRIC>(yn, c) : 0.f;
  }
}

// The first-min fold under common.cuh's strict order (the smaller value,
// then the smaller column; if FINITE a NaN never wins, else a NaN comes
// first): (bv, bi) takes (v, c) when it comes first.
template <bool FINITE = true>
__device__ __forceinline__ void fold_min(float v, int c, float& bv,
                                         int& bi) {
  if (before<FINITE>(v, c, bv, bi)) {
    bv = v;
    bi = c;
  }
}

// The L2 argmin epilogue on the accumulator fragment of the tile at col0:
// fold the squared L2 distance of each of this thread's 32 columns into
// the running (min, argmin) of its rows frag_row(0) (xt0, bv0, bi0) and
// frag_row(0) + 8 (xt1, bv1, bi1). yt comes from col_terms<kMetricL2>; a
// column past n folds as a NaN, which never wins, rather than being
// branched around.
__device__ __forceinline__ void fold_l2_tile(const float (&d)[kAcc],
                                             const float (&yt)[kBN / 4],
                                             int col0, int n, float xt0,
                                             float xt1, float& bv0, int& bi0,
                                             float& bv1, int& bi1) {
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int b = 0; b < kBN / 4; ++b) {
    const int j = b / 2, e = b % 2;
    const int c = col0 + frag_col(4 * j) + e;
    fold_min(c < n ? metric_value<kMetricL2>(d[4 * j + e], xt0, yt[b]) : nan,
             c, bv0, bi0);
    fold_min(c < n ? metric_value<kMetricL2>(d[4 * j + 2 + e], xt1, yt[b])
                   : nan, c, bv1, bi1);
  }
}

// The four lanes of a quad hold the same two rows: combine their running
// (min, argmin) by two shuffles, under fold_min<FINITE>'s order, after
// which every lane holds the rows'.
template <bool FINITE = true>
__device__ __forceinline__ void quad_argmin(float& bv0, int& bi0, float& bv1,
                                            int& bi1) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float v0 = __shfl_xor_sync(0xffffffffu, bv0, off);
    const int i0 = __shfl_xor_sync(0xffffffffu, bi0, off);
    const float v1 = __shfl_xor_sync(0xffffffffu, bv1, off);
    const int i1 = __shfl_xor_sync(0xffffffffu, bi1, off);
    fold_min<FINITE>(v0, i0, bv0, bi0);
    fold_min<FINITE>(v1, i1, bv1, bi1);
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Host check of the operand contract above: k, ldx and ldy multiples of
// 8, the bases 16-byte aligned, and at tier 'high' (high) the lo halves'
// too.
inline bool operands_ok(bool high, int64_t k, int64_t ldx, int64_t ldy,
                        const void* x0, const void* x1, const void* y0,
                        const void* y1) {
  return k % 8 == 0 && ldx % 8 == 0 && ldy % 8 == 0 && aligned16(x0) &&
         aligned16(y0) && (!high || (aligned16(x1) && aligned16(y1)));
}

}  // namespace wg
}  // namespace raft_port
