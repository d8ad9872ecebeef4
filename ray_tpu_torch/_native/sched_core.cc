// Scheduler core: fixed-point resource accounting + placement scoring.
//
// Analog of the reference's C++ scheduler substrate
// (src/ray/raylet/scheduling/: ClusterResourceScheduler/LocalResourceManager
// with FixedPoint arithmetic, fixed_point.h, and the hybrid/spread policies
// in policy/*.h). The Python raylet delegates the hot per-task math here:
//   - acquire/release on the node's main pool and placement-group bundle
//     pools (exact integer milli-units — no float drift after thousands of
//     fractional-resource acquire/release cycles),
//   - cluster-wide feasibility and best-node selection (hybrid pack /
//     spread scoring over the heartbeat-synced cluster view).
//
// Exposed as a plain C API for ctypes (no pybind11 in this image). One
// handle per raylet; all methods take an internal mutex — calls arrive from
// the raylet's event loop and state handlers.

#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// Milli-unit fixed point (reference fixed_point.h uses 1e-4; 1e-3 matches
// the Python side's 0.001-granular fractional resources).
constexpr int64_t kScale = 1000;

int64_t to_fp(double v) {
  return static_cast<int64_t>(v * kScale + (v >= 0 ? 0.5 : -0.5));
}
double from_fp(int64_t v) { return static_cast<double>(v) / kScale; }

using Vec = std::unordered_map<uint32_t, int64_t>;  // resource idx -> amount

bool fits(const Vec& avail, const Vec& demand) {
  for (const auto& [idx, amt] : demand) {
    auto it = avail.find(idx);
    if (amt > 0 && (it == avail.end() || it->second < amt)) return false;
  }
  return true;
}

void sub(Vec& avail, const Vec& demand) {
  for (const auto& [idx, amt] : demand) avail[idx] -= amt;
}

void add(Vec& avail, const Vec& demand) {
  for (const auto& [idx, amt] : demand) avail[idx] += amt;
}

struct Node {
  Vec total;
  Vec avail;
};

struct Core {
  std::mutex mu;
  std::unordered_map<std::string, uint32_t> intern;
  std::vector<std::string> names;
  std::map<std::string, Node> nodes;                 // node_id -> node view
  std::map<std::string, Vec> pools;                  // bundle pool -> avail
  std::map<std::string, Vec> pool_caps;              // bundle pool -> capacity
};

std::mutex g_mu;
std::vector<Core*> g_cores;

Core* core(int h) {
  std::lock_guard<std::mutex> g(g_mu);
  if (h < 0 || h >= static_cast<int>(g_cores.size())) return nullptr;
  return g_cores[h];
}

Vec make_vec(int n, const uint32_t* idx, const double* vals) {
  Vec v;
  for (int i = 0; i < n; i++) v[idx[i]] = to_fp(vals[i]);
  return v;
}

}  // namespace

extern "C" {

int sc_create() {
  std::lock_guard<std::mutex> g(g_mu);
  g_cores.push_back(new Core());
  return static_cast<int>(g_cores.size()) - 1;
}

void sc_destroy(int h) {
  std::lock_guard<std::mutex> g(g_mu);
  if (h >= 0 && h < static_cast<int>(g_cores.size()) && g_cores[h]) {
    delete g_cores[h];
    g_cores[h] = nullptr;
  }
}

uint32_t sc_intern(int h, const char* name) {
  Core* c = core(h);
  if (!c) return 0;
  std::lock_guard<std::mutex> g(c->mu);
  auto it = c->intern.find(name);
  if (it != c->intern.end()) return it->second;
  uint32_t idx = static_cast<uint32_t>(c->names.size());
  c->names.push_back(name);
  c->intern[name] = idx;
  return idx;
}

// Upsert a node's total+available view (heartbeat sync path).
void sc_node_upsert(int h, const char* node_id, int n, const uint32_t* idx,
                    const double* total, const double* avail) {
  Core* c = core(h);
  if (!c) return;
  std::lock_guard<std::mutex> g(c->mu);
  Node& node = c->nodes[node_id];
  node.total = make_vec(n, idx, total);
  node.avail = make_vec(n, idx, avail);
}

void sc_node_remove(int h, const char* node_id) {
  Core* c = core(h);
  if (!c) return;
  std::lock_guard<std::mutex> g(c->mu);
  c->nodes.erase(node_id);
}

// Acquire from a node's main pool. Returns 1 on success, 0 if insufficient.
int sc_try_acquire(int h, const char* node_id, int n, const uint32_t* idx,
                   const double* vals) {
  Core* c = core(h);
  if (!c) return 0;
  std::lock_guard<std::mutex> g(c->mu);
  auto it = c->nodes.find(node_id);
  if (it == c->nodes.end()) return 0;
  Vec demand = make_vec(n, idx, vals);
  if (!fits(it->second.avail, demand)) return 0;
  sub(it->second.avail, demand);
  return 1;
}

void sc_release(int h, const char* node_id, int n, const uint32_t* idx,
                const double* vals) {
  Core* c = core(h);
  if (!c) return;
  std::lock_guard<std::mutex> g(c->mu);
  auto it = c->nodes.find(node_id);
  if (it == c->nodes.end()) return;
  Vec demand = make_vec(n, idx, vals);
  add(it->second.avail, demand);
  // Clamp to capacity: a release after a concurrent view reset must not
  // inflate availability past the node's total.
  for (auto& [ridx, amt] : it->second.avail) {
    auto t = it->second.total.find(ridx);
    int64_t cap = t == it->second.total.end() ? 0 : t->second;
    if (amt > cap) amt = cap;
  }
}

// Bundle pools (placement groups): create with capacity, acquire/release.
void sc_pool_upsert(int h, const char* pool_key, int n, const uint32_t* idx,
                    const double* caps) {
  Core* c = core(h);
  if (!c) return;
  std::lock_guard<std::mutex> g(c->mu);
  Vec cap = make_vec(n, idx, caps);
  c->pool_caps[pool_key] = cap;
  c->pools[pool_key] = cap;
}

void sc_pool_remove(int h, const char* pool_key) {
  Core* c = core(h);
  if (!c) return;
  std::lock_guard<std::mutex> g(c->mu);
  c->pools.erase(pool_key);
  c->pool_caps.erase(pool_key);
}

int sc_pool_exists(int h, const char* pool_key) {
  Core* c = core(h);
  if (!c) return 0;
  std::lock_guard<std::mutex> g(c->mu);
  return c->pools.count(pool_key) ? 1 : 0;
}

int sc_pool_try_acquire(int h, const char* pool_key, int n, const uint32_t* idx,
                        const double* vals) {
  Core* c = core(h);
  if (!c) return 0;
  std::lock_guard<std::mutex> g(c->mu);
  auto it = c->pools.find(pool_key);
  if (it == c->pools.end()) return 0;
  Vec demand = make_vec(n, idx, vals);
  if (!fits(it->second, demand)) return 0;
  sub(it->second, demand);
  return 1;
}

void sc_pool_release(int h, const char* pool_key, int n, const uint32_t* idx,
                     const double* vals) {
  Core* c = core(h);
  if (!c) return;
  std::lock_guard<std::mutex> g(c->mu);
  auto it = c->pools.find(pool_key);
  if (it == c->pools.end()) return;
  Vec demand = make_vec(n, idx, vals);
  add(it->second, demand);
  auto cap = c->pool_caps.find(pool_key);
  if (cap != c->pool_caps.end()) {
    for (auto& [ridx, amt] : it->second) {
      auto t = cap->second.find(ridx);
      int64_t lim = t == cap->second.end() ? 0 : t->second;
      if (amt > lim) amt = lim;
    }
  }
}

// Read back a pool/node availability for one resource (view mirroring).
double sc_node_avail(int h, const char* node_id, uint32_t idx) {
  Core* c = core(h);
  if (!c) return 0;
  std::lock_guard<std::mutex> g(c->mu);
  auto it = c->nodes.find(node_id);
  if (it == c->nodes.end()) return 0;
  auto v = it->second.avail.find(idx);
  return v == it->second.avail.end() ? 0.0 : from_fp(v->second);
}

double sc_pool_avail(int h, const char* pool_key, uint32_t idx) {
  Core* c = core(h);
  if (!c) return 0;
  std::lock_guard<std::mutex> g(c->mu);
  auto it = c->pools.find(pool_key);
  if (it == c->pools.end()) return 0;
  auto v = it->second.find(idx);
  return v == it->second.end() ? 0.0 : from_fp(v->second);
}

// Cluster-wide feasibility: does any node's TOTAL hold the shape?
// Returns: 2 = fits-now somewhere, 1 = feasible (total) somewhere, 0 = no.
int sc_cluster_feasibility(int h, int n, const uint32_t* idx, const double* vals) {
  Core* c = core(h);
  if (!c) return 0;
  std::lock_guard<std::mutex> g(c->mu);
  Vec demand = make_vec(n, idx, vals);
  int best = 0;
  for (const auto& [nid, node] : c->nodes) {
    if (fits(node.avail, demand)) return 2;
    if (fits(node.total, demand)) best = 1;
  }
  return best;
}

// Best-node selection.
//   strategy 0 = hybrid (reference hybrid_scheduling_policy.h: prefer the
//     local node while it fits-now or is feasible, else the first feasible
//     peer — pack-then-spillback),
//   strategy 1 = spread (highest free-fraction score among feasible nodes).
// Writes the chosen node id into out; returns 1 if chosen, 0 if infeasible
// everywhere.
int sc_best_node(int h, int n, const uint32_t* idx, const double* vals,
                 int strategy, const char* local_node, char* out, int out_len) {
  Core* c = core(h);
  if (!c) return 0;
  std::lock_guard<std::mutex> g(c->mu);
  Vec demand = make_vec(n, idx, vals);

  auto emit = [&](const std::string& nid) {
    std::strncpy(out, nid.c_str(), out_len - 1);
    out[out_len - 1] = '\0';
    return 1;
  };

  if (strategy == 1) {  // SPREAD: max free-fraction over feasible-by-total
    const std::string* best = nullptr;
    double best_score = -1.0;
    for (const auto& [nid, node] : c->nodes) {
      if (!fits(node.total, demand)) continue;
      double score = 0.0;
      for (const auto& [ridx, tot] : node.total) {
        if (tot <= 0) continue;
        auto a = node.avail.find(ridx);
        score += a == node.avail.end() ? 0.0
                                       : static_cast<double>(a->second) / tot;
      }
      if (score > best_score) {
        best_score = score;
        best = &nid;
      }
    }
    return best ? emit(*best) : 0;
  }

  // Hybrid: local first (fits now, or at least feasible), then any
  // fits-now peer, then any feasible peer.
  auto local = c->nodes.find(local_node);
  if (local != c->nodes.end() && fits(local->second.avail, demand)) {
    return emit(local->first);
  }
  const std::string* feasible_peer = nullptr;
  for (const auto& [nid, node] : c->nodes) {
    if (nid == local_node) continue;
    if (fits(node.avail, demand)) return emit(nid);
    if (!feasible_peer && fits(node.total, demand)) feasible_peer = &nid;
  }
  if (local != c->nodes.end() && fits(local->second.total, demand)) {
    return emit(local->first);
  }
  return feasible_peer ? emit(*feasible_peer) : 0;
}

}  // extern "C"
