// Radix threshold: per row of int32 sortable keys, the exact k-th smallest
// key T and its tie quota n_tie = k - #(keys < T), the number of keys
// equal to T that belong in the top k.
//
// Replaces raft_tpu/matrix/radix_select.py:_threshold_kernel (:235),
// launched by _radix_ranks (:489): the reference's most-significant-digit
// passes over the biased key (key ^ INT32_MIN, so that signed order is
// unsigned digit order). A pass histograms the next digit of the keys
// whose higher bits equal the prefix decided so far, then narrows to the
// bin where the running count reaches the remaining rank `want`. When every
// bit is decided the prefix is T and `want` is n_tie. The histograms are
// integer counts (shared-memory atomics, then global integer atomics), so
// the result is exact and the same run to run; no float atomics. The
// reference pads rows with INT32_MAX; the ragged edge is masked here.
//
// Bound on an H100 SXM: bytes, one read of the keys. Two forms, chosen by
// the wrapper's plan (radix_select._threshold_plan) from the shapes:
//
// Row-resident (the row fits in the block's opt-in shared memory: up to
// 53,949 keys on an H100): one block of 512 threads a row, one launch, no
// global scratch. The block reads its row once with 16-byte loads (16 in
// flight a thread), stores it biased in shared memory and takes its min and
// max on the way. Every key shares the bits where min and max agree, so the
// passes start below that common prefix (distances' keys share their sign
// and most of their exponent), with 11-bit digits (2,048 bins): at most
// three passes, all out of shared memory. The first counts every key, a warp
// that holds 128 keys of one bin adding them with one atomic. The second
// counts the keys that match the prefix, skipping the others with no
// collective, and where the bin it narrows holds at most 2,048 keys keeps
// them in a candidate buffer (a shared counter gives the slots), so the
// third reads only those. A row of equal keys needs no pass. The load and
// the passes do not overlap (one 128 KB row an SM).
//
// Streaming (longer rows): grid (rows, splits of the row), three launches
// of 11-, 11- and 10-bit digits from the top, a histogram [3][rows][2048]
// in global memory, then one block a row publishes T and n_tie. Pass 0
// reads the row; pass 1 reads it again, counts the keys of pass 0's bin
// and, where that bin's exact count fits the candidate buffer [rows][cap],
// keeps them there (each warp stages them in shared memory and reserves
// global slots 128 at a time; one vote per 128 keys where no lane
// matches); pass 2 then reads only the candidates. A row whose bin does not
// fit (all-equal rows, a long tie run) reads the row a third time. Each
// launch re-derives the prefix from the earlier histograms.

#include <cstdint>
#include <cuda_runtime.h>

namespace raft_port {

constexpr int kDigitBits = 11;
constexpr int kBins = 1 << kDigitBits;
constexpr unsigned kBias = 0x80000000u;
constexpr int kRowThreads = 512;
constexpr int kStreamThreads = 256;
constexpr int kStreamPasses = 3;
constexpr int kStreamWarps = kStreamThreads / 32;
constexpr int kScratchWords = 64;
constexpr int kRowCand = 2048;      // the row form's candidate buffer, keys
constexpr int kWarpBuf = 256;       // the streaming form's staging, a warp
// shared memory of the row-resident form: histogram, scratch, candidate
// buffer, then the row. matrix/radix_select.py states this layout again
// (THRESHOLD_BINS, THRESHOLD_PASSES, ROW_FIXED_BYTES) to plan the form;
// tests/test_torch_radix_select.py holds the two equal.
constexpr int kRowFixedBytes = 4 * (kBins + kScratchWords + kRowCand);

// Streaming digits from the top: bits [shift - width, shift) of pass p.
__host__ __device__ constexpr int stream_width(int p) {
  return p < 2 ? kDigitBits : 32 - 2 * kDigitBits;
}
__host__ __device__ constexpr int stream_low(int p) {
  return p == 0 ? 32 - kDigitBits : p == 1 ? 32 - 2 * kDigitBits : 0;
}

// Block-collective: the bin of h[kBins] (16-byte aligned) where the
// inclusive count first reaches want (1 <= want <= total), the count
// strictly below that bin and the bin's own count. sc: kScratchWords words
// of shared scratch, which the caller must not write again before a
// __syncthreads.
template <int THREADS>
__device__ __forceinline__ void block_pick(const unsigned* h, unsigned want,
                                           unsigned* sc, unsigned& bin,
                                           unsigned& below, unsigned& count) {
  constexpr int B = kBins / THREADS;
  constexpr int W = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned v[B], s = 0;
#pragma unroll
  for (int i = 0; i < B; i += 4) {
    const uint4 q =
        reinterpret_cast<const uint4*>(h)[(threadIdx.x * B + i) / 4];
    v[i] = q.x;
    v[i + 1] = q.y;
    v[i + 2] = q.z;
    v[i + 3] = q.w;
  }
#pragma unroll
  for (int i = 0; i < B; ++i) s += v[i];
  unsigned incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) sc[warp] = incl;
  __syncthreads();
  // the warps' totals, scanned in every warp: this warp's exclusive prefix
  const unsigned tot = lane < W ? sc[lane] : 0u;
  unsigned scan = tot;
#pragma unroll
  for (int off = 1; off < W; off <<= 1) {
    const unsigned t = __shfl_up_sync(0xffffffffu, scan, off);
    if (lane >= off) scan += t;
  }
  unsigned run = __shfl_sync(0xffffffffu, scan - tot, warp) + incl - s;
  if (run < want && want <= run + s) {
#pragma unroll
    for (int i = 0; i < B; ++i) {
      if (run + v[i] >= want) {
        sc[W] = threadIdx.x * B + i;
        sc[W + 1] = run;
        sc[W + 2] = v[i];
        break;
      }
      run += v[i];
    }
  }
  __syncthreads();
  bin = sc[W];
  below = sc[W + 1];
  count = sc[W + 2];
}

// Visits the keys p[begin, end): vec(u, ok) for each 16-byte group of the
// aligned middle, UNROLL groups a thread in flight, in rounds that every
// thread of the block takes together (ok false where a thread has no
// group), so vec may use warp collectives; one(u) for each of the at most
// three keys before it and three after (no collectives). Keys are xor-ed
// with `fix` (kBias where p holds raw keys, 0 where they are biased).
template <int THREADS, int UNROLL, typename Vec, typename One>
__device__ __forceinline__ void visit_keys(const unsigned* p, int begin,
                                           int end, unsigned fix, Vec vec,
                                           One one) {
  if (begin >= end) return;
  const int mis = static_cast<int>(
      (reinterpret_cast<uintptr_t>(p + begin) >> 2) & 3);
  const int a0 = min(end, begin + ((4 - mis) & 3));
  const int a1 = a0 + ((end - a0) & ~3);
  const int t = threadIdx.x;
  if (t < a0 - begin) one(p[begin + t] ^ fix);
  if (t < end - a1) one(p[a1 + t] ^ fix);
  const uint4* v = reinterpret_cast<const uint4*>(p + a0);
  const int nv = (a1 - a0) >> 2;
  for (int base = 0; base < nv; base += THREADS * UNROLL) {
    uint4 r[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int i = base + j * THREADS + t;
      r[j] = i < nv ? v[i] : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      uint4 u = r[j];
      u.x ^= fix;
      u.y ^= fix;
      u.z ^= fix;
      u.w ^= fix;
      vec(u, base + j * THREADS + t < nv);
    }
  }
}

// The first pass's count: every key counts. A warp whose 128 keys of this
// round share one bin adds them with one atomic; otherwise each key adds 1.
__device__ __forceinline__ void count_all(unsigned* h, uint4 u, bool ok,
                                          int low, unsigned mask) {
  const unsigned d0 = (u.x >> low) & mask, d1 = (u.y >> low) & mask,
                 d2 = (u.z >> low) & mask, d3 = (u.w >> low) & mask;
  const unsigned lead = __shfl_sync(0xffffffffu, d0, 0);
  const bool same = ok && d0 == lead && d1 == lead && d2 == lead &&
                    d3 == lead;
  if (__all_sync(0xffffffffu, same)) {
    if ((threadIdx.x & 31) == 0) atomicAdd(&h[lead], 128u);
  } else if (ok) {
    atomicAdd(&h[d0], 1u);
    atomicAdd(&h[d1], 1u);
    atomicAdd(&h[d2], 1u);
    atomicAdd(&h[d3], 1u);
  }
}

// A later pass's count: keys whose bits from `shift` up equal the prefix.
__device__ __forceinline__ void count_match(unsigned* h, unsigned u,
                                            int shift, unsigned prefix,
                                            int low, unsigned mask) {
  if ((u >> shift) == prefix) atomicAdd(&h[(u >> low) & mask], 1u);
}

// ---------------------------------------------------------------------------
// row-resident form
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kRowThreads, 1)
    radix_row_kernel(const int* __restrict__ keys, int64_t ld, int len,
                     int k, int* t, int* ntie) {
  extern __shared__ __align__(16) unsigned smem[];
  unsigned* hist = smem;
  unsigned* sc = smem + kBins;
  unsigned* cand = sc + kScratchWords;
  unsigned* row = cand + kRowCand;                    // 16-byte aligned
  const unsigned* rp = reinterpret_cast<const unsigned*>(
      keys + static_cast<int64_t>(blockIdx.x) * ld);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // key c lies at row[c + off], so that 16-byte groups of the global row
  // land on 16-byte groups of the shared one
  const int off = static_cast<int>((reinterpret_cast<uintptr_t>(rp) >> 2) &
                                   3);
  for (int i = tid; i < kBins; i += kRowThreads) hist[i] = 0;

  // one read of the row: biased into shared memory, min and max on the way
  unsigned lo = 0xffffffffu, hi = 0;
  {
    const int a0 = min(len, (4 - off) & 3);
    const int nv = (len - a0) >> 2;
    const int a1 = a0 + 4 * nv;
    if (tid < a0) {
      const unsigned u = rp[tid] ^ kBias;
      row[off + tid] = u;
      lo = min(lo, u);
      hi = max(hi, u);
    }
    if (tid < len - a1) {
      const unsigned u = rp[a1 + tid] ^ kBias;
      row[off + a1 + tid] = u;
      lo = min(lo, u);
      hi = max(hi, u);
    }
    const uint4* src = reinterpret_cast<const uint4*>(rp + a0);
    uint4* dst = reinterpret_cast<uint4*>(row + off + a0);
    constexpr int U = 16;          // a 32,768-key row in flight at once
    for (int base = 0; base < nv; base += kRowThreads * U) {
      uint4 r[U];
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int i = base + j * kRowThreads + tid;
        if (i < nv) r[j] = __ldg(src + i);
      }
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int i = base + j * kRowThreads + tid;
        if (i < nv) {
          uint4 u = r[j];
          u.x ^= kBias;
          u.y ^= kBias;
          u.z ^= kBias;
          u.w ^= kBias;
          lo = min(min(lo, min(u.x, u.y)), min(u.z, u.w));
          hi = max(max(hi, max(u.x, u.y)), max(u.z, u.w));
          dst[i] = u;
        }
      }
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    sc[warp] = lo;
    sc[32 + warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    constexpr int W = kRowThreads / 32;
    lo = __reduce_min_sync(0xffffffffu, lane < W ? sc[lane] : 0xffffffffu);
    hi = __reduce_max_sync(0xffffffffu, lane < W ? sc[32 + lane] : 0u);
    if (lane == 0) {
      sc[W] = lo;
      sc[W + 1] = hi;
    }
  }
  __syncthreads();
  lo = sc[kRowThreads / 32];
  hi = sc[kRowThreads / 32 + 1];
  __syncthreads();   // block_pick reuses sc

  // the passes, below the bits that every key shares: the first counts
  // the whole row; a later one the keys that match the prefix, from the
  // candidate buffer once the keys of a bin were kept there (the first
  // filtered pass keeps them where the bin's count fits)
  const int common = __clz(lo ^ hi);                  // 32: all equal
  unsigned prefix = common == 0 ? 0u : lo >> (32 - common);
  int shift = 32 - common;
  unsigned want = static_cast<unsigned>(k);
  unsigned count = static_cast<unsigned>(len);       // keys matching prefix
  int kept = -1;                                      // keys in cand, or -1
  unsigned* fill = sc + kScratchWords - 1;
  for (bool first = true; shift > 0; first = false) {
    const int width = min(kDigitBits, shift), low = shift - width;
    const unsigned mask = (1u << width) - 1u;
    if (first) {
      visit_keys<kRowThreads, 4>(
          row, off, off + len, 0u,
          [&](uint4 u, bool ok) { count_all(hist, u, ok, low, mask); },
          [&](unsigned u) { atomicAdd(&hist[(u >> low) & mask], 1u); });
    } else {
      for (int i = tid; i < kBins; i += kRowThreads) hist[i] = 0;
      if (tid == 0) *fill = 0;
      __syncthreads();
      if (kept >= 0) {
        auto one = [&](unsigned u) {
          count_match(hist, u, shift, prefix, low, mask);
        };
        visit_keys<kRowThreads, 1>(cand, 0, kept, 0u,
                                   [&](uint4 u, bool ok) {
                                     if (!ok) return;
                                     one(u.x);
                                     one(u.y);
                                     one(u.z);
                                     one(u.w);
                                   },
                                   one);
      } else {
        const bool keep = count <= static_cast<unsigned>(kRowCand);
        auto one = [&](unsigned u) {
          if ((u >> shift) != prefix) return;
          atomicAdd(&hist[(u >> low) & mask], 1u);
          if (keep) cand[atomicAdd(fill, 1u)] = u;
        };
        visit_keys<kRowThreads, 4>(
            row, off, off + len, 0u,
            [&](uint4 u, bool ok) {
              // one branch for the four keys: few of them still match
              if (!ok || ((u.x >> shift) != prefix &&
                          (u.y >> shift) != prefix &&
                          (u.z >> shift) != prefix &&
                          (u.w >> shift) != prefix))
                return;
              one(u.x);
              one(u.y);
              one(u.z);
              one(u.w);
            },
            one);
        if (keep) kept = static_cast<int>(count);
      }
    }
    __syncthreads();
    unsigned bin, below;
    block_pick<kRowThreads>(hist, want, sc, bin, below, count);
    want -= below;
    prefix = (prefix << width) | bin;
    shift = low;
  }
  if (tid == 0) {
    t[blockIdx.x] = static_cast<int>(prefix ^ kBias);
    ntie[blockIdx.x] = static_cast<int>(want);
  }
}

// ---------------------------------------------------------------------------
// streaming form
// ---------------------------------------------------------------------------

// (prefix, want) of row `row` after `passes` passes, and the count of the
// keys that match pass 0's bin (count0). Block-collective.
__device__ __forceinline__ void stream_walk(const unsigned* hist, int rows,
                                            int row, int passes, int k,
                                            unsigned* sc, unsigned& prefix,
                                            unsigned& want,
                                            unsigned& count0) {
  prefix = 0;
  want = static_cast<unsigned>(k);
  count0 = 0;
  for (int p = 0; p < passes; ++p) {
    unsigned bin, below, count;
    block_pick<kStreamThreads>(
        hist + (static_cast<int64_t>(p) * rows + row) * kBins, want, sc, bin,
        below, count);
    want -= below;
    prefix = (prefix << stream_width(p)) | bin;
    if (p == 0) count0 = count;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kStreamThreads)
    radix_stream_kernel(const int* __restrict__ keys, int64_t ld, int rows,
                        int len, int span, int k, int pass, unsigned* hist,
                        unsigned* ccount, unsigned* cand, int cap) {
  __shared__ __align__(16) unsigned h[kBins];
  __shared__ unsigned sc[kScratchWords];
  __shared__ unsigned wbuf[kStreamWarps][kWarpBuf];
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kBins; i += kStreamThreads) h[i] = 0;
  unsigned prefix, want, count0;
  stream_walk(hist, rows, row, pass, k, sc, prefix, want, count0);
  __syncthreads();
  const int low = stream_low(pass), shift = low + stream_width(pass);
  const unsigned mask = (1u << stream_width(pass)) - 1u;
  const unsigned* rp = reinterpret_cast<const unsigned*>(
      keys + static_cast<int64_t>(row) * ld);
  const int c0 = blockIdx.y * span, c1 = min(len, c0 + span);
  unsigned* crow = cand + static_cast<int64_t>(row) * cap;
  const bool buffered = count0 <= static_cast<unsigned>(cap);

  if (pass == 0) {
    visit_keys<kStreamThreads, 4>(
        rp, c0, c1, kBias,
        [&](uint4 u, bool ok) { count_all(h, u, ok, low, mask); },
        [&](unsigned u) { atomicAdd(&h[(u >> low) & mask], 1u); });
  } else if (pass == 1 && buffered) {
    // count, and keep pass 0's bin in the candidate buffer: each warp
    // stages its keys in shared memory and reserves global slots 128 at a
    // time
    unsigned* wb = wbuf[threadIdx.x >> 5];
    unsigned fill = 0;                                  // warp-uniform
    auto stage = [&](unsigned u, bool hit) {
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (hit) {
        wb[fill + __popc(ballot & ((1u << lane) - 1u))] = u;
        atomicAdd(&h[(u >> low) & mask], 1u);
      }
      fill += __popc(ballot);
    };
    auto flush = [&](unsigned n) {
      __syncwarp();
      unsigned slot = 0;
      if (lane == 0 && n) slot = atomicAdd(&ccount[row], n);
      slot = __shfl_sync(0xffffffffu, slot, 0);
      for (unsigned i = lane; i < n; i += 32) crow[slot + i] = wb[i];
      __syncwarp();
      for (unsigned i = n + lane; i < fill; i += 32) wb[i - n] = wb[i];
      __syncwarp();
      fill -= n;
    };
    visit_keys<kStreamThreads, 4>(
        rp, c0, c1, kBias,
        [&](uint4 u, bool ok) {
          const bool h0 = ok && (u.x >> shift) == prefix,
                     h1 = ok && (u.y >> shift) == prefix,
                     h2 = ok && (u.z >> shift) == prefix,
                     h3 = ok && (u.w >> shift) == prefix;
          if (!__any_sync(0xffffffffu, h0 || h1 || h2 || h3)) return;
          stage(u.x, h0);
          stage(u.y, h1);
          stage(u.z, h2);
          stage(u.w, h3);
          if (fill >= kWarpBuf / 2) flush(kWarpBuf / 2);
        },
        [&](unsigned u) {
          if ((u >> shift) != prefix) return;
          crow[atomicAdd(&ccount[row], 1u)] = u;
          atomicAdd(&h[(u >> low) & mask], 1u);
        });
    flush(fill);
  } else {
    // pass 1 without room, or pass 2: from the candidates where pass 1
    // kept them, else from the row again
    auto one = [&](unsigned u) { count_match(h, u, shift, prefix, low, mask); };
    auto vec = [&](uint4 u, bool ok) {
      if (!ok || ((u.x >> shift) != prefix && (u.y >> shift) != prefix &&
                  (u.z >> shift) != prefix && (u.w >> shift) != prefix))
        return;
      one(u.x);
      one(u.y);
      one(u.z);
      one(u.w);
    };
    if (pass == 2 && buffered) {
      const int per = (static_cast<int>(count0) + gridDim.y - 1) / gridDim.y;
      const int step = (per + 3) & ~3;
      const int b0 = blockIdx.y * step;
      const int b1 = min(static_cast<int>(count0), b0 + step);
      visit_keys<kStreamThreads, 4>(crow, b0, b1, 0u, vec, one);
    } else {
      visit_keys<kStreamThreads, 4>(rp, c0, c1, kBias, vec, one);
    }
  }
  __syncthreads();
  unsigned* g = hist + (static_cast<int64_t>(pass) * rows + row) * kBins;
  for (int b = threadIdx.x; b < kBins; b += kStreamThreads)
    if (h[b]) atomicAdd(&g[b], h[b]);
}

// One block a row: T and n_tie from the three passes' histograms.
__global__ void __launch_bounds__(kStreamThreads)
    radix_finish_kernel(const unsigned* hist, int rows, int k, int* t,
                        int* ntie) {
  __shared__ unsigned sc[kScratchWords];
  unsigned prefix, want, count0;
  stream_walk(hist, rows, blockIdx.x, kStreamPasses, k, sc, prefix, want,
              count0);
  if (threadIdx.x == 0) {
    t[blockIdx.x] = static_cast<int>(prefix ^ kBias);
    ntie[blockIdx.x] = static_cast<int>(want);
  }
}

}  // namespace raft_port

// keys: int32 [rows, >= len], row stride ld. form 1: row-resident (span,
// hist, cand unused; len must fit in shared memory); form 0: streaming,
// a block for each `span` keys of a row (a multiple of 4), hist u32
// scratch [3][rows][2048] followed by [rows] candidate counters (zeroed
// here), cand u32 [rows][cap] (cap a multiple of 4). Writes t and ntie
// int32 [rows]. Returns the CUDA error of the launches (0 on success).
extern "C" int raft_radix_threshold(const int* keys, int64_t ld, int rows,
                                    int len, int k, int form, int span,
                                    unsigned* hist, unsigned* cand, int cap,
                                    int* t, int* ntie, void* stream) {
  using namespace raft_port;
  if (rows < 1 || len < 1 || k < 1 || k > len || ld < len || form < 0 ||
      form > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == 1) {
    const int64_t smem =
        kRowFixedBytes + 4 * ((static_cast<int64_t>(len) + 3 + 3) & ~3LL);
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(
        radix_row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    radix_row_kernel<<<rows, kRowThreads, static_cast<int>(smem), st>>>(
        keys, ld, len, k, t, ntie);
    return static_cast<int>(cudaGetLastError());
  }
  if (span < 4 || span % 4 != 0 || cap < 4 || cap % 4 != 0 ||
      hist == nullptr || cand == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t splits = (static_cast<int64_t>(len) + span - 1) / span;
  if (splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(rows, static_cast<unsigned>(splits));
  const size_t hist_words = static_cast<size_t>(kStreamPasses) * rows * kBins;
  cudaError_t err = cudaMemsetAsync(
      hist, 0, sizeof(unsigned) * (hist_words + rows), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned* ccount = hist + hist_words;
  for (int p = 0; p < kStreamPasses; ++p)
    radix_stream_kernel<<<grid, kStreamThreads, 0, st>>>(
        keys, ld, rows, len, span, k, p, hist, ccount, cand, cap);
  radix_finish_kernel<<<rows, kStreamThreads, 0, st>>>(hist, rows, k, t,
                                                       ntie);
  return static_cast<int>(cudaGetLastError());
}
