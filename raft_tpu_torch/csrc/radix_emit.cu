// Radix emit: per row of int32 sortable keys with threshold T and tie
// quota n_tie (radix_threshold.cu), the k winner columns: every key < T in
// column order in slots [0, k - n_tie), then the first n_tie keys == T in
// column order in slots [k - n_tie, k).
//
// Replaces raft_tpu/matrix/radix_select.py:_emit_kernel (:332) and its
// _emit_chunk_body (:393), launched by _radix_ranks (:524). The slot rule
// is _emit_chunk_body's (:421-425): rank = running strict count for a key
// below T, (k - n_tie) + running tie count for a tie that is still inside
// the quota. The reference builds the slots as one-hot contractions on the
// MXU and skips dead chunks from per-chunk counts made in XLA; here each
// winner's column is written straight to its slot.
//
// Bound on an H100 SXM: bytes, one read of the keys and one write of the
// k-wide output. Design: one kernel, each key read once.
//
// A block of 256 threads reads a chunk of keys at a time: warp w the w-th
// eighth of it, lane i the 16-byte group at 4i of each 128-key step
// (coalesced 512-byte loads, all of a whole chunk's in flight together;
// element loads where the C entry point finds the pointer or the row stride
// not 16-byte aligned, and guarded loads in a chunk cut by the row's end).
// A key's rank among the chunk's strict keys (and ties) is a warp scan a
// step of the lane's counts packed strict | tie << 16 (a warp's step has at
// most 128 of each), the steps' totals and the warps before it (through
// shared memory, double-buffered in the walk: one barrier a chunk).
//
// 1. One split a row (radix_select._emit_plan, where the rows alone fill
//    the card, as at the kNN chunks): a block walks its row, chunks of
//    4,096 keys, the next chunk's loads in flight while it ranks and writes
//    the current one, with running strict and tie ranks, and stops once
//    every winner of the row is out (a sorted row reads only its head). No
//    scratch.
// 2. Several splits a row (few rows, as at the select shape): a split is
//    one chunk of kEmitChunk keys, held in registers between its count and
//    its emission, in a single-pass chained scan with decoupled look-back.
//    Blocks go split-major over the rows, and a block takes its split from
//    a per-row atomic ticket, so that its predecessors are running. Once a
//    split's inclusive prefix holds every winner of the row, it sets the
//    ticket's top bit, and every block that then takes a ticket of the row
//    publishes a full prefix and returns unread (sorted rows). Else a block
//    reads its chunk, publishes its (strict, tie) aggregate, looks back
//    over its predecessors (a warp reads 32 at a time, summing aggregates
//    back to the first inclusive prefix), publishes its inclusive prefix
//    and emits. A published word is the flag and both counts (each < 2^31,
//    rows hold at most 2^24 keys) in 64 bits, stored with release and read
//    with acquire semantics.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace raft_port {

constexpr int kEmitThreads = 256;
constexpr int kEmitWarps = kEmitThreads / 32;
// 16-byte groups a lane a chunk: 4 in the walk (two chunks in flight, four
// blocks an SM), 8 in the look-back form (one chunk a block, three blocks
// an SM, no spill)
constexpr int kWalkVec = 4;
constexpr int kSplitVec = 8;
constexpr int kEmitChunk = kEmitThreads * 4 * kSplitVec;  // keys a split
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kRowDone = 0x80000000u;          // ticket: no winner left

// look-back word: flag (bits 62-63) | strict count << 31 | tie count
constexpr uint64_t kAggregate = 1ull << 62;
constexpr uint64_t kInclusive = 2ull << 62;
constexpr uint64_t kCountMask = (1ull << 31) - 1;

__device__ __forceinline__ uint64_t pack(uint64_t flag, int lt, int eq) {
  return flag | static_cast<uint64_t>(lt) << 31 | static_cast<uint64_t>(eq);
}
__device__ __forceinline__ void store_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}
__device__ __forceinline__ uint64_t load_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// One chunk of a block: the lane's keys and, a step each, the strict and
// tie keys of its warp before it in column order (packed).
template <int V>
struct EmitChunk {
  static constexpr int kKeys = kEmitThreads * 4 * V;
  int key[V][4];
  int before[V];
};

// The column of the lane's first key of step j in a chunk of V steps at c0.
template <int V>
__device__ __forceinline__ int step_col(int c0, int j) {
  return c0 + (threadIdx.x / 32) * (128 * V) + 128 * j +
         4 * (threadIdx.x % 32);
}

// The lane's keys of the chunk at c0. FULL: the whole chunk lies below
// c1, so no load is guarded (all of them in flight together).
template <bool VEC, bool FULL, int V>
__device__ __forceinline__ void load_chunk(const int* rp, int c0, int c1,
                                           EmitChunk<V>& ch) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = step_col<V>(c0, j);
    if (VEC && (FULL || c + 3 < c1)) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(rp + c));
      ch.key[j][0] = v.x;
      ch.key[j][1] = v.y;
      ch.key[j][2] = v.z;
      ch.key[j][3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ch.key[j][e] = FULL || c + e < c1 ? __ldg(rp + c + e) : 0;
    }
  }
}

// The warp scans of the lane's counts, step by step; returns the warp's
// packed total.
template <bool FULL, int V>
__device__ __forceinline__ int scan_chunk(int c0, int c1, int key_t,
                                          EmitChunk<V>& ch) {
  const int lane = threadIdx.x % 32;
  int run = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = step_col<V>(c0, j);
    int packed = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (FULL || c + e < c1)
        packed += ch.key[j][e] < key_t ? 1 : (ch.key[j][e] == key_t ? 65536
                                                                     : 0);
    int incl = packed;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    ch.before[j] = run + incl - packed;
    run += __shfl_sync(kFull, incl, 31);
  }
  return run;
}

// Writes the chunk's winners; base_lt / base_eq: the row's strict and tie
// keys before the lane's warp in this chunk.
template <bool FULL, int V>
__device__ __forceinline__ void emit_chunk(int c0, int c1, int key_t,
                                           int less_total, int ntie,
                                           int base_lt, int base_eq,
                                           const EmitChunk<V>& ch, int* orow) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = step_col<V>(c0, j);
    int nl = base_lt + (ch.before[j] & 0xffff);
    int nt = base_eq + (ch.before[j] >> 16);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!FULL && c + e >= c1) continue;
      if (ch.key[j][e] < key_t) {
        if (nl < less_total) orow[nl] = c + e;
        ++nl;
      } else if (ch.key[j][e] == key_t) {
        if (nt < ntie) orow[less_total + nt] = c + e;
        ++nt;
      }
    }
  }
}

// The packed keys of the warps before this one, and of all, in tot[].
__device__ __forceinline__ void block_prefix(const int* tot, int& before,
                                             int& total) {
  const int warp = threadIdx.x / 32;
  before = total = 0;
#pragma unroll
  for (int w = 0; w < kEmitWarps; ++w) {
    if (w < warp) before += tot[w];
    total += tot[w];
  }
}

// The walk's step over a loaded chunk: ranks, one barrier, winners; the
// row's running counts move past the chunk.
template <bool FULL, int V>
__device__ __forceinline__ void walk_step(EmitChunk<V>& ch, int c0, int c1,
                                          int key_t, int less_total,
                                          int ntie, int* tot, int& base_lt,
                                          int& base_eq, int* orow) {
  const int run = scan_chunk<FULL>(c0, c1, key_t, ch);
  if (threadIdx.x % 32 == 0) tot[threadIdx.x / 32] = run;
  __syncthreads();
  int before, total;
  block_prefix(tot, before, total);
  emit_chunk<FULL>(c0, c1, key_t, less_total, ntie,
                   base_lt + (before & 0xffff), base_eq + (before >> 16), ch,
                   orow);
  base_lt += total & 0xffff;
  base_eq += total >> 16;
}

// One split a row: block `row` walks the row, whole chunks then the last,
// cut one; tot is double-buffered, so one barrier a chunk suffices (a warp
// rewrites a buffer only past the next chunk's barrier, which every warp
// reaches after reading it).
template <bool VEC>
__global__ void __launch_bounds__(kEmitThreads, 4)
    radix_emit_walk(const int* __restrict__ keys, int64_t ld, int len, int k,
                    const int* __restrict__ t, const int* __restrict__ ntie_rows,
                    int* __restrict__ out) {
  __shared__ int tot[2][kEmitWarps];
  const int row = blockIdx.x;
  const int key_t = t[row], ntie = ntie_rows[row], less_total = k - ntie;
  const int* rp = keys + static_cast<int64_t>(row) * ld;
  int* orow = out + static_cast<int64_t>(row) * k;
  constexpr int kChunk = EmitChunk<kWalkVec>::kKeys;
  int base_lt = 0, base_eq = 0, buf = 0, c0 = 0;
  EmitChunk<kWalkVec> ch, next;
  if (kChunk <= len) load_chunk<VEC, true>(rp, 0, len, ch);
  for (; c0 + kChunk <= len; c0 += kChunk, buf ^= 1) {
    if (c0 + 2 * kChunk <= len)     // the next whole chunk, in flight now
      load_chunk<VEC, true>(rp, c0 + kChunk, len, next);
    walk_step<true>(ch, c0, len, key_t, less_total, ntie, tot[buf], base_lt,
                    base_eq, orow);
    if (base_lt >= less_total && base_eq >= ntie) return;
    ch = next;
  }
  if (c0 < len) {
    load_chunk<VEC, false>(rp, c0, len, ch);
    walk_step<false>(ch, c0, len, key_t, less_total, ntie, tot[buf], base_lt,
                     base_eq, orow);
  }
}

// Warp 0 of split s > 0: the strict and tie keys of the row before it,
// from its predecessors' published words st[0, s): 32 at a time, nearest
// first, each window read again until every word up to its nearest
// inclusive prefix is set (split 0 publishes one at once, and a lane
// before split 0 counts as an empty one).
__device__ __forceinline__ void look_back(const uint64_t* st, int s, int& lt,
                                          int& eq) {
  const int lane = threadIdx.x % 32;
  lt = eq = 0;
  for (int p = s - 1;; p -= 32) {
    const int q = p - lane;
    uint64_t w;
    unsigned inc, use;
    for (;;) {
      w = q >= 0 ? load_acquire(st + q) : kInclusive;
      inc = __ballot_sync(kFull, (w >> 62) == 2);
      const unsigned unset = __ballot_sync(kFull, (w >> 62) == 0);
      use = inc ? (inc ^ (inc - 1)) : kFull;    // lanes up to the nearest
      if (!(unset & use)) break;
    }
    const bool mine = (use >> lane) & 1;
    int a = mine ? static_cast<int>((w >> 31) & kCountMask) : 0;
    int b = mine ? static_cast<int>(w & kCountMask) : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(kFull, a, off);
      b += __shfl_xor_sync(kFull, b, off);
    }
    lt += a;
    eq += b;
    if (inc) return;
  }
}

// The look-back form's work on split s, one chunk at c0.
template <bool VEC, bool FULL>
__device__ __forceinline__ void lookback_split(
    const int* rp, int c0, int c1, int key_t, int less_total, int ntie,
    int s, uint64_t* st, unsigned* ticket, int* tot, int* sh, int* orow) {
  EmitChunk<kSplitVec> ch;
  load_chunk<VEC, FULL>(rp, c0, c1, ch);
  const int run = scan_chunk<FULL>(c0, c1, key_t, ch);
  if (threadIdx.x % 32 == 0) tot[threadIdx.x / 32] = run;
  __syncthreads();
  int before, total;
  block_prefix(tot, before, total);
  if (threadIdx.x < 32) {
    int lt = 0, eq = 0;
    if (s > 0) {
      if (threadIdx.x == 0)
        store_release(st + s, pack(kAggregate, total & 0xffff, total >> 16));
      look_back(st, s, lt, eq);
    }
    if (threadIdx.x == 0) {
      const int in_lt = lt + (total & 0xffff), in_eq = eq + (total >> 16);
      store_release(st + s, pack(kInclusive, in_lt, in_eq));
      if (in_lt >= less_total && in_eq >= ntie) atomicOr(ticket, kRowDone);
      sh[0] = lt;
      sh[1] = eq;
    }
  }
  __syncthreads();
  const int base_lt = sh[0], base_eq = sh[1];
  if (base_lt >= less_total && base_eq >= ntie) return;
  emit_chunk<FULL>(c0, c1, key_t, less_total, ntie,
                   base_lt + (before & 0xffff), base_eq + (before >> 16), ch,
                   orow);
}

// Several splits a row: a split a chunk, in ticket order, with look-back.
// Blocks go split-major over the rows (block b serves row b % rows), so
// that a row's later splits start after its first ones have published.
template <bool VEC>
__global__ void __launch_bounds__(kEmitThreads, 3)
    radix_emit_lookback(const int* __restrict__ keys, int64_t ld, int rows,
                        int len, int k, const int* __restrict__ t,
                        const int* __restrict__ ntie_rows, int splits,
                        uint64_t* __restrict__ state,
                        unsigned* __restrict__ ticket, int* __restrict__ out) {
  __shared__ int tot[kEmitWarps];
  __shared__ int sh[3];
  const int row = blockIdx.x % rows;
  const int key_t = t[row], ntie = ntie_rows[row], less_total = k - ntie;
  uint64_t* st = state + static_cast<int64_t>(row) * splits;
  if (threadIdx.x == 0) {
    const unsigned v = atomicAdd(ticket + row, 1u);
    const int s = static_cast<int>(v & ~kRowDone);
    // a split before this one already holds every winner of the row: pass
    // a full prefix on, unread
    if (v & kRowDone) store_release(st + s, pack(kInclusive, less_total,
                                                 ntie));
    sh[2] = v & kRowDone ? -1 : s;
  }
  __syncthreads();
  const int s = sh[2];
  if (s < 0) return;
  const int c0 = s * kEmitChunk;
  const int* rp = keys + static_cast<int64_t>(row) * ld;
  int* orow = out + static_cast<int64_t>(row) * k;
  if (c0 + kEmitChunk <= len)
    lookback_split<VEC, true>(rp, c0, len, key_t, less_total, ntie, s, st,
                              ticket + row, tot, sh, orow);
  else
    lookback_split<VEC, false>(rp, c0, len, key_t, less_total, ntie, s, st,
                               ticket + row, tot, sh, orow);
}

}  // namespace raft_port

// keys: int32 [rows, >= len], row stride ld; t, ntie: int32 [rows] from
// raft_radix_threshold; out: int32 [rows, k]. splits 1: a block walks each
// row (scratch unused); else splits must be ceil(len / kEmitChunk) and
// scratch holds rows * splits u64 look-back words, then rows u32 tickets,
// zeroed here on the stream. 16-byte loads where keys and ld * 4 are
// 16-byte aligned, element loads otherwise. Returns the CUDA error of the
// launches (0 on success).
extern "C" int raft_radix_emit(const int* keys, int64_t ld, int rows, int len,
                               int k, const int* t, const int* ntie,
                               int splits, void* scratch, int* out,
                               void* stream) {
  using namespace raft_port;
  if (rows < 1 || len < 1 || k < 1 || k > len || ld < len || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = reinterpret_cast<uintptr_t>(keys) % 16 == 0 &&
                   ld * static_cast<int64_t>(sizeof(int)) % 16 == 0;
  if (splits == 1) {
    if (vec)
      radix_emit_walk<true><<<rows, kEmitThreads, 0, st>>>(keys, ld, len, k,
                                                           t, ntie, out);
    else
      radix_emit_walk<false><<<rows, kEmitThreads, 0, st>>>(keys, ld, len, k,
                                                            t, ntie, out);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t blocks = static_cast<int64_t>(rows) * splits;
  if (scratch == nullptr ||
      splits != (len + kEmitChunk - 1) / kEmitChunk || blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  uint64_t* state = static_cast<uint64_t*>(scratch);
  unsigned* ticket = reinterpret_cast<unsigned*>(state + blocks);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(uint64_t) * blocks + sizeof(unsigned) * rows, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vec)
    radix_emit_lookback<true><<<blocks, kEmitThreads, 0, st>>>(
        keys, ld, rows, len, k, t, ntie, splits, state, ticket, out);
  else
    radix_emit_lookback<false><<<blocks, kEmitThreads, 0, st>>>(
        keys, ld, rows, len, k, t, ntie, splits, state, ticket, out);
  return static_cast<int>(cudaGetLastError());
}
