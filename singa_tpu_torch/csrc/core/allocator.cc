/* allocator — size-bucketed host staging pool (parity: the reference
 * core's per-device memory pool; here it backs host-side staging for the
 * data pipeline and CppCPU replay buffers).  Freed blocks are cached by
 * size bucket and reused; sg_pool_trim() returns them to the OS. */

#include "singa_core.h"

#include <cstdlib>
#include <map>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

std::mutex g_mu;
std::multimap<size_t, void*> g_free;            // size -> block
std::unordered_map<void*, size_t> g_size_of;    // live + cached blocks
size_t g_in_use = 0;
size_t g_reserved = 0;

size_t round_up(size_t b) {
  // 64B alignment buckets; power-of-two above 4KB to bound fragmentation
  if (b <= 4096) return (b + 63) & ~size_t(63);
  size_t p = 4096;
  while (p < b) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

void* sg_pool_alloc(size_t bytes) {
  size_t sz = round_up(bytes ? bytes : 1);
  std::lock_guard<std::mutex> lock(g_mu);
  auto it = g_free.lower_bound(sz);
  if (it != g_free.end() && it->first == sz) {
    void* p = it->second;
    g_free.erase(it);
    g_in_use += sz;
    return p;
  }
  void* p = nullptr;
  if (posix_memalign(&p, 64, sz) != 0) return nullptr;
  g_size_of[p] = sz;
  g_in_use += sz;
  g_reserved += sz;
  return p;
}

void sg_pool_free(void* p) {
  if (!p) return;
  std::lock_guard<std::mutex> lock(g_mu);
  auto it = g_size_of.find(p);
  if (it == g_size_of.end()) {
    std::free(p);  // not ours; be permissive
    return;
  }
  g_in_use -= it->second;
  g_free.insert({it->second, p});
}

size_t sg_pool_bytes_in_use(void) {
  std::lock_guard<std::mutex> lock(g_mu);
  return g_in_use;
}

size_t sg_pool_bytes_reserved(void) {
  std::lock_guard<std::mutex> lock(g_mu);
  return g_reserved;
}

void sg_pool_trim(void) {
  std::lock_guard<std::mutex> lock(g_mu);
  for (auto& kv : g_free) {
    g_reserved -= kv.first;
    g_size_of.erase(kv.second);
    std::free(kv.second);
  }
  g_free.clear();
}

}  // extern "C"
