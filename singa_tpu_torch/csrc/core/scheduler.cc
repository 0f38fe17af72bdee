/* scheduler — native Graph/Scheduler (parity: BASELINE.json:5 "the
 * Graph/Scheduler that buffers singa.autograd ops"; reference lineage
 * keeps a Node/Edge graph, topo-sorts it and plans memory).
 *
 * In singa_tpu_torch the *device-side* schedule is the CUDA stream's (a
 * captured step replays as one CUDA graph); this native scheduler
 * provides the host-side equivalents the reference core had:
 *   - Kahn topological ordering of the captured op graph (with a
 *     deterministic tie-break so replays are reproducible),
 *   - liveness analysis + first-fit arena planning for buffer reuse
 *     (reports how much memory a serial replay needs — used by the
 *     Python CapturedGraph.schedule() and Schedule.replay),
 *   - FLOP accounting for MFU reporting.
 */

#include "singa_core.h"

#include <algorithm>
#include <cstring>
#include <map>
#include <mutex>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Node {
  std::string name;
  std::vector<int64_t> in_bufs;
  std::vector<int64_t> out_bufs;
  int64_t flops = 0;
};

struct Graph {
  std::vector<Node> nodes;
  std::unordered_map<int64_t, int64_t> buf_size;   // buffer id -> bytes
  std::unordered_map<int64_t, int64_t> producer;   // buffer id -> node id
};

std::mutex g_mu;
std::unordered_map<int64_t, Graph*> g_graphs;
int64_t g_next_id = 1;

Graph* get(int64_t h) {
  std::lock_guard<std::mutex> lock(g_mu);
  auto it = g_graphs.find(h);
  return it == g_graphs.end() ? nullptr : it->second;
}

}  // namespace

extern "C" {

int64_t sg_graph_new(void) {
  std::lock_guard<std::mutex> lock(g_mu);
  int64_t id = g_next_id++;
  g_graphs[id] = new Graph();
  return id;
}

void sg_graph_free(int64_t h) {
  std::lock_guard<std::mutex> lock(g_mu);
  auto it = g_graphs.find(h);
  if (it != g_graphs.end()) {
    delete it->second;
    g_graphs.erase(it);
  }
}

int64_t sg_graph_add_node(int64_t h, const char* name,
                          const int64_t* in_bufs, int64_t nin,
                          const int64_t* out_bufs, int64_t nout,
                          const int64_t* buf_sizes_out, int64_t flops) {
  Graph* g = get(h);
  if (!g) return -1;
  Node node;
  node.name = name ? name : "";
  node.in_bufs.assign(in_bufs, in_bufs + nin);
  node.out_bufs.assign(out_bufs, out_bufs + nout);
  node.flops = flops;
  int64_t id = static_cast<int64_t>(g->nodes.size());
  for (int64_t i = 0; i < nout; ++i) {
    g->buf_size[out_bufs[i]] = buf_sizes_out[i];
    g->producer[out_bufs[i]] = id;
  }
  g->nodes.push_back(std::move(node));
  return id;
}

int64_t sg_graph_toposort(int64_t h, int64_t* out, int64_t cap) {
  Graph* g = get(h);
  if (!g) return -1;
  int64_t n = static_cast<int64_t>(g->nodes.size());
  if (cap < n) return -1;
  std::vector<int64_t> indeg(n, 0);
  std::vector<std::vector<int64_t>> succ(n);
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t b : g->nodes[i].in_bufs) {
      auto it = g->producer.find(b);
      if (it != g->producer.end() && it->second != i) {
        succ[it->second].push_back(i);
        indeg[i]++;
      }
    }
  }
  // min-heap on node id: deterministic order among ready nodes
  std::priority_queue<int64_t, std::vector<int64_t>, std::greater<int64_t>> ready;
  for (int64_t i = 0; i < n; ++i)
    if (indeg[i] == 0) ready.push(i);
  int64_t cnt = 0;
  while (!ready.empty()) {
    int64_t u = ready.top();
    ready.pop();
    out[cnt++] = u;
    for (int64_t v : succ[u])
      if (--indeg[v] == 0) ready.push(v);
  }
  return cnt == n ? n : -1;  // -1: cycle
}

int64_t sg_graph_plan_memory(int64_t h, int64_t* offsets, int64_t cap) {
  Graph* g = get(h);
  if (!g) return -1;
  int64_t n = static_cast<int64_t>(g->nodes.size());
  std::vector<int64_t> order(n);
  if (sg_graph_toposort(h, order.data(), n) != n) return -1;

  // liveness: buffer live from producing step to last consuming step
  std::unordered_map<int64_t, int64_t> born, dies;
  for (int64_t step = 0; step < n; ++step) {
    const Node& node = g->nodes[order[step]];
    for (int64_t b : node.out_bufs)
      if (!born.count(b)) born[b] = step;
    for (int64_t b : node.in_bufs) dies[b] = step;
  }
  for (auto& kv : born)
    if (!dies.count(kv.first)) dies[kv.first] = n;  // graph outputs live to end

  // events sorted by birth; first-fit into a free-interval list
  struct Interval {
    int64_t off, size;
  };
  std::vector<std::pair<int64_t, int64_t>> by_birth;  // (birth, buf)
  for (auto& kv : born) by_birth.push_back({kv.second, kv.first});
  std::sort(by_birth.begin(), by_birth.end());

  std::map<int64_t, int64_t> free_list;  // offset -> size
  int64_t arena = 0;
  std::vector<std::pair<int64_t, std::pair<int64_t, int64_t>>> active;  // (death, (off,size))
  std::unordered_map<int64_t, int64_t> assigned;

  // Free only buffers whose last read is STRICTLY before step t: an
  // output born at step t must not alias a buffer the same node reads.
  auto release_until = [&](int64_t t) {
    for (auto it = active.begin(); it != active.end();) {
      if (it->first < t) {
        int64_t off = it->second.first, sz = it->second.second;
        // coalesce into free list
        auto nxt = free_list.lower_bound(off);
        if (nxt != free_list.end() && off + sz == nxt->first) {
          sz += nxt->second;
          free_list.erase(nxt);
        }
        if (!free_list.empty()) {
          auto prv = free_list.lower_bound(off);
          if (prv != free_list.begin()) {
            --prv;
            if (prv->first + prv->second == off) {
              off = prv->first;
              sz += prv->second;
              free_list.erase(prv);
            }
          }
        }
        free_list[off] = sz;
        it = active.erase(it);
      } else {
        ++it;
      }
    }
  };

  for (auto& bb : by_birth) {
    int64_t t = bb.first, buf = bb.second;
    release_until(t);
    int64_t need = (g->buf_size.count(buf) ? g->buf_size[buf] : 0);
    need = (need + 63) & ~63;  // 64B alignment
    int64_t off = -1;
    for (auto it = free_list.begin(); it != free_list.end(); ++it) {
      if (it->second >= need) {
        off = it->first;
        int64_t rem = it->second - need;
        int64_t ro = it->first + need;
        free_list.erase(it);
        if (rem > 0) free_list[ro] = rem;
        break;
      }
    }
    if (off < 0) {
      off = arena;
      arena += need;
    }
    assigned[buf] = off;
    active.push_back({dies[buf], {off, need}});
  }

  if (offsets) {
    for (auto& kv : assigned)
      if (kv.first >= 0 && kv.first < cap) offsets[kv.first] = kv.second;
  }
  return arena;
}

int64_t sg_graph_num_nodes(int64_t h) {
  Graph* g = get(h);
  return g ? static_cast<int64_t>(g->nodes.size()) : -1;
}

int64_t sg_graph_total_flops(int64_t h) {
  Graph* g = get(h);
  if (!g) return -1;
  int64_t total = 0;
  for (auto& node : g->nodes) total += node.flops;
  return total;
}

}  // extern "C"
