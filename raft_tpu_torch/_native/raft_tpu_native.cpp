// raft_tpu_torch native host runtime (C++17, no external deps).
//
// The host-side runtime pieces that are native code: a statistics-tracking
// host memory pool (optionally mmap-backed) with a notify hook, a
// background resource monitor writing CSV, the cooperative-cancellation
// token registry, the .npy writer/reader core, and a worker-pool executor
// for chunked host IO and copies.
//
// Exposed as a flat C ABI bound from Python with ctypes
// (raft_tpu_torch/_native/__init__.py).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <sys/mman.h>
#include <unistd.h>

#define RT_EXPORT extern "C" __attribute__((visibility("default")))

// ---------------------------------------------------------------------------
// Tracked host memory pool
// (ref: mr/statistics_adaptor.hpp — bytes/alloc counters wrapping an
//  upstream resource; mr/mmap_memory_resource.hpp — mmap-backed host
//  allocations; cpp/src/util/memory_pool.cpp — pool helper)
// ---------------------------------------------------------------------------

namespace {

struct PoolStats {
  std::atomic<int64_t> bytes_allocated{0};
  std::atomic<int64_t> peak_bytes{0};
  std::atomic<int64_t> n_allocations{0};
  std::atomic<int64_t> n_deallocations{0};
};

struct Pool {
  PoolStats stats;
  std::mutex lock;
  std::map<void*, size_t> live;  // ptr -> size
  bool use_mmap = false;
  // notifying_adaptor hook (ref: mr/notifying_adaptor.hpp:25,77):
  // called as fn(is_alloc, nbytes, user_data) after every event.
  void (*notify_cb)(int, int64_t, void*) = nullptr;
  void* notify_data = nullptr;
};

void bump_peak(PoolStats& s) {
  int64_t cur = s.bytes_allocated.load();
  int64_t prev = s.peak_bytes.load();
  while (cur > prev && !s.peak_bytes.compare_exchange_weak(prev, cur)) {
  }
}

}  // namespace

RT_EXPORT void* rt_pool_create(int use_mmap) {
  auto* p = new Pool();
  p->use_mmap = use_mmap != 0;
  return p;
}

RT_EXPORT void rt_pool_destroy(void* pool) {
  auto* p = static_cast<Pool*>(pool);
  std::lock_guard<std::mutex> g(p->lock);
  for (auto& kv : p->live) {
    if (p->use_mmap) {
      munmap(kv.first, kv.second);
    } else {
      std::free(kv.first);
    }
  }
  p->live.clear();
  delete p;
}

RT_EXPORT void* rt_pool_alloc(void* pool, int64_t nbytes) {
  auto* p = static_cast<Pool*>(pool);
  void* ptr = nullptr;
  if (p->use_mmap) {
    ptr = mmap(nullptr, static_cast<size_t>(nbytes), PROT_READ | PROT_WRITE,
               MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (ptr == MAP_FAILED) return nullptr;
  } else {
    ptr = std::malloc(static_cast<size_t>(nbytes));
    if (ptr == nullptr) return nullptr;
  }
  {
    std::lock_guard<std::mutex> g(p->lock);
    p->live[ptr] = static_cast<size_t>(nbytes);
  }
  p->stats.bytes_allocated += nbytes;
  p->stats.n_allocations += 1;
  bump_peak(p->stats);
  if (p->notify_cb) p->notify_cb(1, nbytes, p->notify_data);
  return ptr;
}

RT_EXPORT int rt_pool_dealloc(void* pool, void* ptr) {
  auto* p = static_cast<Pool*>(pool);
  size_t nbytes = 0;
  {
    std::lock_guard<std::mutex> g(p->lock);
    auto it = p->live.find(ptr);
    if (it == p->live.end()) return -1;
    nbytes = it->second;
    p->live.erase(it);
  }
  if (p->use_mmap) {
    munmap(ptr, nbytes);
  } else {
    std::free(ptr);
  }
  p->stats.bytes_allocated -= static_cast<int64_t>(nbytes);
  p->stats.n_deallocations += 1;
  if (p->notify_cb) p->notify_cb(0, static_cast<int64_t>(nbytes),
                                 p->notify_data);
  return 0;
}

RT_EXPORT void rt_pool_stats(void* pool, int64_t* out4) {
  auto* p = static_cast<Pool*>(pool);
  out4[0] = p->stats.bytes_allocated.load();
  out4[1] = p->stats.peak_bytes.load();
  out4[2] = p->stats.n_allocations.load();
  out4[3] = p->stats.n_deallocations.load();
}

RT_EXPORT void rt_pool_set_notify(void* pool,
                                  void (*cb)(int, int64_t, void*),
                                  void* user_data) {
  auto* p = static_cast<Pool*>(pool);
  p->notify_cb = cb;
  p->notify_data = user_data;
}

// ---------------------------------------------------------------------------
// Resource monitor: background sampler -> CSV
// (ref: mr/resource_monitor.hpp:29-66 — thread samples allocation stats on
//  an interval, each row tagged with the active trace range)
// ---------------------------------------------------------------------------

namespace {

struct Monitor {
  Pool* pool;
  std::FILE* out;
  int interval_ms;
  std::thread worker;
  std::atomic<bool> stop{false};
  std::mutex tag_lock;
  std::string tag;
};

}  // namespace

RT_EXPORT void* rt_monitor_start(void* pool, const char* csv_path,
                                 int interval_ms) {
  auto* m = new Monitor();
  m->pool = static_cast<Pool*>(pool);
  m->out = std::fopen(csv_path, "w");
  if (m->out == nullptr) {
    delete m;
    return nullptr;
  }
  std::fprintf(m->out, "timestamp_us,tag,bytes,peak_bytes,allocs,deallocs\n");
  m->interval_ms = interval_ms;
  m->worker = std::thread([m]() {
    while (!m->stop.load()) {
      int64_t s[4];
      rt_pool_stats(m->pool, s);
      auto now = std::chrono::duration_cast<std::chrono::microseconds>(
                     std::chrono::system_clock::now().time_since_epoch())
                     .count();
      std::string tag;
      {
        std::lock_guard<std::mutex> g(m->tag_lock);
        tag = m->tag;
      }
      std::fprintf(m->out, "%lld,%s,%lld,%lld,%lld,%lld\n",
                   static_cast<long long>(now), tag.c_str(),
                   static_cast<long long>(s[0]), static_cast<long long>(s[1]),
                   static_cast<long long>(s[2]), static_cast<long long>(s[3]));
      std::fflush(m->out);
      std::this_thread::sleep_for(std::chrono::milliseconds(m->interval_ms));
    }
  });
  return m;
}

RT_EXPORT void rt_monitor_set_tag(void* monitor, const char* tag) {
  auto* m = static_cast<Monitor*>(monitor);
  std::lock_guard<std::mutex> g(m->tag_lock);
  m->tag = tag ? tag : "";
}

RT_EXPORT void rt_monitor_stop(void* monitor) {
  auto* m = static_cast<Monitor*>(monitor);
  m->stop.store(true);
  if (m->worker.joinable()) m->worker.join();
  std::fclose(m->out);
  delete m;
}

// ---------------------------------------------------------------------------
// Cooperative cancellation registry
// (ref: core/interruptible.hpp:63-110 — one token per thread id,
//  cancel() flips it, synchronize() polls and throws)
// ---------------------------------------------------------------------------

namespace {
std::mutex g_tok_lock;
std::map<int64_t, std::atomic<int>*> g_tokens;

std::atomic<int>* token_for(int64_t tid) {
  std::lock_guard<std::mutex> g(g_tok_lock);
  auto it = g_tokens.find(tid);
  if (it == g_tokens.end()) {
    auto* t = new std::atomic<int>(0);
    g_tokens[tid] = t;
    return t;
  }
  return it->second;
}
}  // namespace

RT_EXPORT void rt_interruptible_cancel(int64_t tid) {
  token_for(tid)->store(1);
}

// Returns 1 and clears if the token was cancelled (flag-consuming check).
RT_EXPORT int rt_interruptible_check(int64_t tid) {
  return token_for(tid)->exchange(0);
}

RT_EXPORT int rt_interruptible_cancelled(int64_t tid) {
  return token_for(tid)->load();
}

// ---------------------------------------------------------------------------
// .npy serializer core
// (ref: core/detail/mdspan_numpy_serializer.hpp — header build/parse;
//  the heavy path, bulk IO, belongs in native code)
// ---------------------------------------------------------------------------

namespace {

std::string npy_header(const char* descr, const int64_t* shape, int ndim) {
  std::string dict = "{'descr': '";
  dict += descr;
  dict += "', 'fortran_order': False, 'shape': (";
  for (int i = 0; i < ndim; ++i) {
    dict += std::to_string(shape[i]);
    dict += (ndim == 1 || i + 1 < ndim) ? "," : "";
    if (i + 1 < ndim) dict += " ";
  }
  dict += "), }";
  // pad with spaces so total header size (magic 8 + 2 len + dict + \n) % 64 == 0
  size_t base = 10 + dict.size() + 1;
  size_t pad = (64 - base % 64) % 64;
  dict += std::string(pad, ' ');
  dict += '\n';
  std::string out = "\x93NUMPY";
  out += '\x01';
  out += '\x00';
  uint16_t hlen = static_cast<uint16_t>(dict.size());
  out += static_cast<char>(hlen & 0xff);
  out += static_cast<char>((hlen >> 8) & 0xff);
  out += dict;
  return out;
}

}  // namespace

RT_EXPORT int rt_npy_write(const char* path, const char* descr,
                           const int64_t* shape, int ndim, const void* data,
                           int64_t nbytes) {
  std::FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::string hdr = npy_header(descr, shape, ndim);
  if (std::fwrite(hdr.data(), 1, hdr.size(), f) != hdr.size()) {
    std::fclose(f);
    return -2;
  }
  if (nbytes > 0 &&
      std::fwrite(data, 1, static_cast<size_t>(nbytes), f) !=
          static_cast<size_t>(nbytes)) {
    std::fclose(f);
    return -3;
  }
  std::fclose(f);
  return 0;
}

// Parses the header; returns data offset, fills descr (caller buffer of 16),
// shape (caller buffer of 32), ndim and fortran_order. Returns <0 on error.
RT_EXPORT int64_t rt_npy_read_header(const char* path, char* descr,
                                     int64_t* shape, int* ndim,
                                     int* fortran_order) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  unsigned char magic[8];
  if (std::fread(magic, 1, 8, f) != 8 || std::memcmp(magic, "\x93NUMPY", 6)) {
    std::fclose(f);
    return -2;
  }
  unsigned char lenb[2];
  if (std::fread(lenb, 1, 2, f) != 2) {
    std::fclose(f);
    return -3;
  }
  size_t hlen = lenb[0] | (lenb[1] << 8);
  std::string dict(hlen, '\0');
  if (std::fread(dict.data(), 1, hlen, f) != hlen) {
    std::fclose(f);
    return -4;
  }
  std::fclose(f);
  *fortran_order = dict.find("'fortran_order': True") != std::string::npos;
  auto dpos = dict.find("'descr':");
  auto q1 = dict.find('\'', dpos + 8);
  auto q2 = dict.find('\'', q1 + 1);
  std::string d = dict.substr(q1 + 1, q2 - q1 - 1);
  std::snprintf(descr, 16, "%s", d.c_str());
  auto spos = dict.find("'shape':");
  auto p1 = dict.find('(', spos);
  auto p2 = dict.find(')', p1);
  std::string tup = dict.substr(p1 + 1, p2 - p1 - 1);
  int n = 0;
  const char* s = tup.c_str();
  while (*s && n < 32) {
    while (*s == ' ' || *s == ',') ++s;
    if (!*s) break;
    shape[n++] = std::strtoll(s, const_cast<char**>(&s), 10);
  }
  *ndim = n;
  return static_cast<int64_t>(10 + hlen);
}

RT_EXPORT int rt_npy_read_data(const char* path, int64_t offset, void* out,
                               int64_t nbytes) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  if (std::fseek(f, static_cast<long>(offset), SEEK_SET) != 0) {
    std::fclose(f);
    return -2;
  }
  size_t got = std::fread(out, 1, static_cast<size_t>(nbytes), f);
  std::fclose(f);
  return got == static_cast<size_t>(nbytes) ? 0 : -3;
}

// ---------------------------------------------------------------------------
// Worker-pool executor
// (stream-pool analogue for host jobs: core/resource/cuda_stream_pool.hpp;
//  submit(fn) → future-like handle; used for parallel chunked IO/copies)
// ---------------------------------------------------------------------------

namespace {

struct ThreadPool {
  std::vector<std::thread> workers;
  std::deque<std::function<void()>> jobs;
  std::mutex lock;
  std::condition_variable cv;
  std::condition_variable done_cv;
  std::atomic<int64_t> submitted{0};
  std::atomic<int64_t> completed{0};
  bool stop = false;

  explicit ThreadPool(int n) {
    for (int i = 0; i < n; ++i) {
      workers.emplace_back([this]() {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> g(lock);
            cv.wait(g, [this]() { return stop || !jobs.empty(); });
            if (stop && jobs.empty()) return;
            job = std::move(jobs.front());
            jobs.pop_front();
          }
          job();
          {
            // increment under the mutex or a waiter that just evaluated
            // the predicate could miss this notify (lost wakeup)
            std::lock_guard<std::mutex> g(lock);
            completed += 1;
          }
          done_cv.notify_all();
        }
      });
    }
  }

  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> g(lock);
      stop = true;
    }
    cv.notify_all();
    for (auto& w : workers) w.join();
  }

  void submit(std::function<void()> job) {
    {
      std::lock_guard<std::mutex> g(lock);
      jobs.push_back(std::move(job));
      // under the mutex, like `completed` — otherwise a waiter can observe
      // completed == submitted+1, re-sleep, and miss the final notify
      submitted += 1;
    }
    cv.notify_one();
  }

  void wait_all() {
    std::unique_lock<std::mutex> g(lock);
    done_cv.wait(g, [this]() { return completed.load() == submitted.load(); });
  }
};

}  // namespace

RT_EXPORT void* rt_threadpool_create(int n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  return new ThreadPool(n_threads);
}

RT_EXPORT void rt_threadpool_destroy(void* tp) {
  delete static_cast<ThreadPool*>(tp);
}

// Parallel memcpy: splits [nbytes] into chunks over the pool.
RT_EXPORT void rt_threadpool_memcpy(void* tp, void* dst, const void* src,
                                    int64_t nbytes, int64_t chunk) {
  auto* pool = static_cast<ThreadPool*>(tp);
  if (chunk <= 0) chunk = 8 << 20;
  for (int64_t off = 0; off < nbytes; off += chunk) {
    int64_t n = std::min(chunk, nbytes - off);
    char* d = static_cast<char*>(dst) + off;
    const char* s = static_cast<const char*>(src) + off;
    pool->submit([d, s, n]() { std::memcpy(d, s, static_cast<size_t>(n)); });
  }
  pool->wait_all();
}

// Generic job submission via C callback (for Python-driven pipelines).
RT_EXPORT void rt_threadpool_submit(void* tp, void (*fn)(void*), void* arg) {
  static_cast<ThreadPool*>(tp)->submit([fn, arg]() { fn(arg); });
}

RT_EXPORT void rt_threadpool_wait(void* tp) {
  static_cast<ThreadPool*>(tp)->wait_all();
}

RT_EXPORT int rt_version() { return 1; }
