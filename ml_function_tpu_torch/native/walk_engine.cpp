// Native random-walk engine for graph-embedding pretraining.
//
// The reference generates walks one node at a time in pure Python
// (kon/model/embedding/walk_core_model.py:89-115) and precomputes a
// second-order alias table PER EDGE for node2vec (:47-85) — O(sum of
// destination degrees) memory. Here:
//   - per-NODE alias tables (Vose) built multithreaded: O(E) memory,
//     O(1) neighbor draws;
//   - DeepWalk walks fan out across threads, one splitmix64 stream per
//     walk (thread-count independent determinism);
//   - node2vec uses EXACT rejection sampling against the first-order
//     alias draw (accept prob = bias(x)/max_bias with bias 1/p | 1 | 1/q),
//     so the per-edge table build disappears entirely while the sampled
//     distribution stays exactly the paper's second-order walk.
//
// Exposed via ctypes from embedding_pretrain/native_walks.py (same build
// scheme as native/criteo_loader.cpp).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// --- splitmix64: tiny, seedable per-walk stream ---------------------------
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed) {}
  inline uint64_t next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  inline double uniform() {  // [0, 1)
    return (next() >> 11) * 0x1.0p-53;
  }
};

inline void run_threads(int n_threads, int64_t n_items,
                        const std::function<void(int64_t, int64_t)>& fn) {
  if (n_threads < 1) n_threads = 1;
  if (n_items <= 0) return;
  int nt = static_cast<int>(std::min<int64_t>(n_threads, n_items));
  std::vector<std::thread> pool;
  pool.reserve(nt);
  int64_t chunk = (n_items + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(lo + chunk, n_items);
    if (lo >= hi) break;
    pool.emplace_back(fn, lo, hi);
  }
  for (auto& th : pool) th.join();
}

// Vose alias construction over weights[lo:hi); prob/alias are slot-local.
void build_alias_one(const double* w, int64_t deg, float* prob,
                     int32_t* alias) {
  if (deg <= 0) return;
  double total = 0.0;
  for (int64_t i = 0; i < deg; ++i) total += (w[i] > 0 ? w[i] : 0.0);
  if (total <= 0.0) {  // degenerate: uniform
    for (int64_t i = 0; i < deg; ++i) { prob[i] = 1.0f; alias[i] = (int32_t)i; }
    return;
  }
  std::vector<double> scaled(deg);
  std::vector<int32_t> small, large;
  small.reserve(deg); large.reserve(deg);
  for (int64_t i = 0; i < deg; ++i) {
    scaled[i] = (w[i] > 0 ? w[i] : 0.0) * deg / total;
    (scaled[i] < 1.0 ? small : large).push_back((int32_t)i);
  }
  while (!small.empty() && !large.empty()) {
    int32_t s = small.back(); small.pop_back();
    int32_t l = large.back(); large.pop_back();
    prob[s] = (float)scaled[s];
    alias[s] = l;
    scaled[l] -= 1.0 - scaled[s];
    (scaled[l] < 1.0 ? small : large).push_back(l);
  }
  for (int32_t i : large) { prob[i] = 1.0f; alias[i] = i; }
  for (int32_t i : small) { prob[i] = 1.0f; alias[i] = i; }
}

inline int64_t alias_draw(Rng& rng, const float* prob, const int32_t* alias,
                          int64_t deg) {
  int64_t slot = (int64_t)(rng.uniform() * deg);
  if (slot >= deg) slot = deg - 1;
  return rng.uniform() < prob[slot] ? slot : alias[slot];
}

inline bool is_neighbor(const int64_t* indptr, const int32_t* indices,
                        int64_t u, int32_t x) {
  const int32_t* lo = indices + indptr[u];
  const int32_t* hi = indices + indptr[u + 1];
  return std::binary_search(lo, hi, x);  // requires sorted adjacency
}

}  // namespace

extern "C" {

// Flattened per-node alias tables: slots indptr[v]..indptr[v+1) of
// (prob, alias) are node v's table; alias holds LOCAL slot indices.
void mlf_build_node_alias(int64_t n_nodes, const int64_t* indptr,
                          const double* weights, float* prob, int32_t* alias,
                          int n_threads) {
  run_threads(n_threads, n_nodes, [&](int64_t lo, int64_t hi) {
    for (int64_t v = lo; v < hi; ++v) {
      int64_t b = indptr[v], deg = indptr[v + 1] - b;
      build_alias_one(weights + b, deg, prob + b, alias + b);
    }
  });
}

// First-order weighted walks (DeepWalk). walks_out is
// (n_starts, walk_length) row-major int32; dead ends repeat the node.
void mlf_deepwalk(int64_t n_nodes, const int64_t* indptr,
                  const int32_t* indices, const float* prob,
                  const int32_t* alias, int64_t n_starts,
                  const int32_t* starts, int walk_length, uint64_t seed,
                  int32_t* walks_out, int n_threads) {
  (void)n_nodes;
  run_threads(n_threads, n_starts, [&](int64_t lo, int64_t hi) {
    for (int64_t wi = lo; wi < hi; ++wi) {
      Rng rng(seed * 0x2545F4914F6CDD1DULL + (uint64_t)wi);
      int32_t cur = starts[wi];
      int32_t* row = walks_out + wi * walk_length;
      row[0] = cur;
      for (int t = 1; t < walk_length; ++t) {
        int64_t b = indptr[cur], deg = indptr[cur + 1] - b;
        if (deg > 0)
          cur = indices[b + alias_draw(rng, prob + b, alias + b, deg)];
        row[t] = cur;
      }
    }
  });
}

// node2vec p,q walks, exact rejection sampling. indices MUST be sorted
// within each node's slice (the Python wrapper guarantees it).
void mlf_node2vec(int64_t n_nodes, const int64_t* indptr,
                  const int32_t* indices, const float* prob,
                  const int32_t* alias, double p, double q, int64_t n_starts,
                  const int32_t* starts, int walk_length, uint64_t seed,
                  int32_t* walks_out, int n_threads) {
  (void)n_nodes;
  const double inv_p = 1.0 / p, inv_q = 1.0 / q;
  const double bmax = std::max({inv_p, 1.0, inv_q});
  run_threads(n_threads, n_starts, [&](int64_t lo, int64_t hi) {
    for (int64_t wi = lo; wi < hi; ++wi) {
      Rng rng(seed * 0x9E3779B97F4A7C15ULL + (uint64_t)wi);
      int32_t cur = starts[wi], prev = -1;
      int32_t* row = walks_out + wi * walk_length;
      row[0] = cur;
      for (int t = 1; t < walk_length; ++t) {
        int64_t b = indptr[cur], deg = indptr[cur + 1] - b;
        if (deg == 0) { row[t] = cur; continue; }  // dead end: stay
        int32_t nxt;
        if (prev < 0) {  // first hop: first-order draw
          nxt = indices[b + alias_draw(rng, prob + b, alias + b, deg)];
        } else {
          for (;;) {  // rejection against the first-order proposal
            int32_t x =
                indices[b + alias_draw(rng, prob + b, alias + b, deg)];
            double bias = (x == prev) ? inv_p
                          : (is_neighbor(indptr, indices, prev, x) ? 1.0
                                                                   : inv_q);
            if (rng.uniform() * bmax < bias) { nxt = x; break; }
          }
        }
        prev = cur;
        cur = nxt;
        row[t] = cur;
      }
    }
  });
}

}  // extern "C"
