/* dataloader — native threaded input pipeline (the reference core ships
 * a native data path; SURVEY.md §2.2 native checklist).  In-memory
 * dataset, background worker threads fill a bounded ring of shuffled
 * batches so host batch assembly overlaps device compute.
 *
 * Concurrency design (three condition variables, one mutex):
 *   cv_work  — workers wait for an epoch's work (cursor < total)
 *   cv_space — producers wait for ring space
 *   cv_ready — the consumer waits for a ready batch
 * Workers snapshot their permutation indices UNDER the lock, then copy
 * sample bytes outside it, so the consumer's epoch rewind (reshuffle +
 * cursor reset) never races batch assembly.  Epoch boundaries are
 * accounted on the CONSUMER side by batch count — robust to workers
 * pushing out of order. */

#include "singa_core.h"

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstring>
#include <mutex>
#include <numeric>
#include <random>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Batch {
  std::vector<float> x;
  std::vector<int32_t> y;
  int64_t size = 0;
};

struct Loader {
  const float* x = nullptr;
  const int32_t* y = nullptr;
  int64_t n = 0, stride = 0, batch = 0;
  bool shuffle = false, drop_last = false;
  uint64_t seed = 0;

  // guarded by mu:
  std::vector<int64_t> perm;
  int64_t cursor = 0;
  int64_t epoch = 0;
  std::vector<Batch> ring;
  size_t head = 0, tail = 0, count = 0;
  int64_t consumed_this_epoch = 0;

  std::mutex mu;
  std::condition_variable cv_work, cv_space, cv_ready;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  int64_t batches_per_epoch() const {
    return drop_last ? n / batch : (n + batch - 1) / batch;
  }

  int64_t samples_per_epoch() const { return batches_per_epoch() * batch; }

  void reshuffle_locked() {
    perm.resize(n);
    std::iota(perm.begin(), perm.end(), 0);
    if (shuffle) {
      std::mt19937_64 rng(seed + static_cast<uint64_t>(epoch));
      std::shuffle(perm.begin(), perm.end(), rng);
    }
  }

  void worker_loop() {
    std::vector<int64_t> idx;
    while (true) {
      // claim a batch's worth of indices under the lock
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_work.wait(lock, [&] {
          return stop.load() || cursor < samples_per_epoch();
        });
        if (stop.load()) return;
        int64_t start = cursor;
        int64_t bsz = std::min(batch, n - start);
        cursor += batch;
        idx.resize(bsz);
        for (int64_t i = 0; i < bsz; ++i) idx[i] = perm[start + i];
      }
      // assemble outside the lock (perm snapshot taken; x is const)
      Batch b;
      b.size = static_cast<int64_t>(idx.size());
      b.x.resize(b.size * stride);
      b.y.resize(b.size);
      for (int64_t i = 0; i < b.size; ++i) {
        std::memcpy(b.x.data() + i * stride, x + idx[i] * stride,
                    stride * sizeof(float));
        b.y[i] = y ? y[idx[i]] : 0;
      }
      // publish
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_space.wait(lock,
                      [&] { return stop.load() || count < ring.size(); });
        if (stop.load()) return;
        ring[tail] = std::move(b);
        tail = (tail + 1) % ring.size();
        ++count;
      }
      cv_ready.notify_one();
    }
  }
};

std::mutex g_mu;
std::unordered_map<int64_t, Loader*> g_loaders;
int64_t g_next = 1;

Loader* get(int64_t h) {
  std::lock_guard<std::mutex> lock(g_mu);
  auto it = g_loaders.find(h);
  return it == g_loaders.end() ? nullptr : it->second;
}

}  // namespace

extern "C" {

int64_t sg_loader_new(const float* x, const int32_t* y,
                      int64_t n, int64_t x_stride, int64_t batch,
                      int shuffle, uint64_t seed, int drop_last,
                      int workers, int prefetch) {
  if (!x || n <= 0 || batch <= 0 || x_stride <= 0) return -1;
  auto* ld = new Loader();
  ld->x = x;
  ld->y = y;
  ld->n = n;
  ld->stride = x_stride;
  ld->batch = batch;
  ld->shuffle = shuffle != 0;
  ld->drop_last = drop_last != 0;
  ld->seed = seed;
  if (ld->batches_per_epoch() <= 0) {
    delete ld;
    return -1;  // drop_last with batch > n yields no batches
  }
  {
    std::lock_guard<std::mutex> lock(ld->mu);
    ld->reshuffle_locked();
  }
  ld->ring.resize(std::max(2, prefetch));
  int nw = std::max(1, workers);
  for (int i = 0; i < nw; ++i)
    ld->workers.emplace_back([ld] { ld->worker_loop(); });
  std::lock_guard<std::mutex> lock(g_mu);
  int64_t id = g_next++;
  g_loaders[id] = ld;
  return id;
}

int64_t sg_loader_next(int64_t h, float* x_out, int32_t* y_out) {
  Loader* ld = get(h);
  if (!ld) return -1;
  Batch b;
  bool rewound = false;
  {
    std::unique_lock<std::mutex> lock(ld->mu);
    ld->cv_ready.wait(lock, [&] { return ld->count > 0 || ld->stop.load(); });
    if (ld->stop.load()) return -1;
    b = std::move(ld->ring[ld->head]);
    ld->head = (ld->head + 1) % ld->ring.size();
    --ld->count;
    if (++ld->consumed_this_epoch >= ld->batches_per_epoch()) {
      // consumer-side epoch boundary: all of this epoch's batches are
      // consumed, workers are parked (cursor exhausted) — safe to rewind
      ld->consumed_this_epoch = 0;
      ld->epoch++;
      ld->reshuffle_locked();
      ld->cursor = 0;
      rewound = true;
    }
  }
  ld->cv_space.notify_one();
  if (rewound) ld->cv_work.notify_all();
  std::memcpy(x_out, b.x.data(), b.size * ld->stride * sizeof(float));
  if (y_out) std::memcpy(y_out, b.y.data(), b.size * sizeof(int32_t));
  return b.size;
}

int64_t sg_loader_batches_per_epoch(int64_t h) {
  Loader* ld = get(h);
  return ld ? ld->batches_per_epoch() : -1;
}

void sg_loader_free(int64_t h) {
  Loader* ld = nullptr;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    auto it = g_loaders.find(h);
    if (it == g_loaders.end()) return;
    ld = it->second;
    g_loaders.erase(it);
  }
  ld->stop.store(true);
  ld->cv_work.notify_all();
  ld->cv_space.notify_all();
  ld->cv_ready.notify_all();
  for (auto& t : ld->workers) t.join();
  delete ld;
}

}  // extern "C"
