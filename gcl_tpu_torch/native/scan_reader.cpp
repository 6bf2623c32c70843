// Native asynchronous scan prefetcher for the data-loader IO path (a copy
// of gcl_tpu/native/scan_reader.cpp, a source of gcl_tpu_torch).
//
// Disk reads of KITTI .bin scans (~2-8 MB each, 7 per colocation sample)
// would otherwise serialize with host-side sample assembly. This unit
// provides a C++ thread pool + ticket table: Python submits file paths
// ahead of time (gcl_tpu_torch/data/kitti_io.py hints each sample's
// scans), worker threads read and cache the float32 payloads, and the
// consumer copies a ready scan out without blocking on disk.
//
// Built by gcl_tpu_torch/native/__init__.py at first use, with
// voxel_ops.cpp, into build/native/.
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Entry {
  std::vector<float> data;  // raw float payload (xyzr quads)
  std::atomic<int> state{0};  // 0 = pending, 1 = ready, -1 = error
};

struct Reader {
  std::mutex mu;
  std::condition_variable cv_work;
  std::condition_variable cv_done;
  std::deque<std::string> queue;
  std::unordered_map<std::string, Entry*> table;
  std::vector<std::thread> threads;
  bool stop = false;
  size_t cache_cap;
  std::deque<std::string> lru;  // completed entries, eviction order

  explicit Reader(int n_threads, size_t cache_entries)
      : cache_cap(cache_entries) {
    for (int i = 0; i < n_threads; ++i) {
      threads.emplace_back([this] { worker(); });
    }
  }

  ~Reader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_work.notify_all();
    for (auto& t : threads) t.join();
    for (auto& kv : table) delete kv.second;
  }

  void worker() {
    for (;;) {
      std::string path;
      Entry* e;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [this] { return stop || !queue.empty(); });
        if (stop) return;
        path = std::move(queue.front());
        queue.pop_front();
        auto it = table.find(path);
        if (it == table.end()) continue;  // evicted before read
        e = it->second;
      }
      FILE* f = std::fopen(path.c_str(), "rb");
      if (!f) {
        e->state.store(-1);
        cv_done.notify_all();
        continue;
      }
      std::fseek(f, 0, SEEK_END);
      long sz = std::ftell(f);
      std::fseek(f, 0, SEEK_SET);
      e->data.resize(static_cast<size_t>(sz) / sizeof(float));
      size_t got = std::fread(e->data.data(), 1,
                              static_cast<size_t>(sz), f);
      std::fclose(f);
      e->data.resize(got / sizeof(float));
      e->state.store(1);
      cv_done.notify_all();
    }
  }

  void submit(const char* path) {
    std::lock_guard<std::mutex> lk(mu);
    std::string p(path);
    if (table.count(p)) return;  // already queued / cached
    table.emplace(p, new Entry());
    queue.push_back(p);
    lru.push_back(p);  // insertion order over every live entry
    // Evict oldest completed entries beyond capacity. Pending entries
    // (queued or mid-read — a worker may hold a raw pointer) are
    // requeued; names already claimed by fetch() just pop. Bounding the
    // scan keeps submit O(small) even when everything is pending.
    size_t scan = lru.size();
    while (table.size() > cache_cap && scan-- > 0 && !lru.empty()) {
      std::string victim = std::move(lru.front());
      lru.pop_front();
      auto it = table.find(victim);
      if (it == table.end()) continue;      // fetched and released
      if (it->second->state.load() == 0) {  // pending: keep
        lru.push_back(std::move(victim));
        continue;
      }
      delete it->second;
      table.erase(it);
    }
    cv_work.notify_one();
  }

  // Returns float count (>= 0), -1 if unknown path, -2 on read error.
  // When out != nullptr copies up to cap floats and RELEASES the entry.
  long fetch(const char* path, float* out, long cap) {
    std::string p(path);
    Entry* e;
    {
      std::unique_lock<std::mutex> lk(mu);
      auto it = table.find(p);
      if (it == table.end()) return -1;
      e = it->second;
      cv_done.wait(lk, [e] { return e->state.load() != 0; });
      if (e->state.load() < 0) {
        delete e;
        table.erase(p);
        return -2;
      }
      if (out == nullptr) {  // size query, keep entry (already in lru)
        return static_cast<long>(e->data.size());
      }
      table.erase(p);
    }
    long n = static_cast<long>(e->data.size());
    if (n > cap) n = cap;
    std::memcpy(out, e->data.data(), static_cast<size_t>(n)
                * sizeof(float));
    delete e;
    return n;
  }
};

}  // namespace

extern "C" {

void* gcl_reader_create(int n_threads, int cache_entries) {
  if (n_threads < 1) n_threads = 1;
  if (cache_entries < 4) cache_entries = 4;
  return new Reader(n_threads, static_cast<size_t>(cache_entries));
}

void gcl_reader_destroy(void* r) { delete static_cast<Reader*>(r); }

void gcl_reader_submit(void* r, const char* path) {
  static_cast<Reader*>(r)->submit(path);
}

long gcl_reader_fetch(void* r, const char* path, float* out, long cap) {
  return static_cast<Reader*>(r)->fetch(path, out, cap);
}

}  // extern "C"
