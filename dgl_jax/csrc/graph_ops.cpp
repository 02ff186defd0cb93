// Native host-side graph runtime for dgl_jax.
//
// Equivalent of the C++ layer the reference suite exercises
// inside DGL (SURVEY §2.3): neighbor sampling (dgl.sampling.sample_neighbors),
// node-induced subgraph extraction with id compaction (dgl.node_subgraph),
// and graph partitioning (the METIS role). The Python layer
// (dgl_jax/csrc/native.py) binds these via ctypes and falls back to NumPy
// when the shared object is unavailable.
//
// All functions are thread-parallel with OpenMP and operate on int64 CSR
// arrays owned by the caller (NumPy buffers).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <random>
#include <utility>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// xorshift128+ per-thread RNG — fast, reproducible per (seed, thread chunk).
static inline uint64_t splitmix64(uint64_t &x) {
  uint64_t z = (x += 0x9e3779b97f4a7c15ull);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    uint64_t x = seed;
    s0 = splitmix64(x);
    s1 = splitmix64(x);
  }
  inline uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  // unbiased-enough bounded draw (rejection-free multiply-shift)
  inline uint64_t bounded(uint64_t n) {
    return (uint64_t)(((__uint128_t)next() * n) >> 64);
  }
};

// Sample `fanout` in-neighbors (with replacement) for each seed.
// out: (n_seeds * fanout) neighbor ids; zero-degree seeds yield themselves.
void sample_neighbors(const int64_t *indptr, const int64_t *indices,
                      const int64_t *seeds, int64_t n_seeds, int64_t fanout,
                      uint64_t seed, int64_t *out) {
#pragma omp parallel
  {
#ifdef _OPENMP
    int tid = omp_get_thread_num();
#else
    int tid = 0;
#endif
    Rng rng(seed * 0x9e3779b97f4a7c15ull + (uint64_t)tid + 1);
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n_seeds; ++i) {
      int64_t v = seeds[i];
      int64_t lo = indptr[v], hi = indptr[v + 1];
      int64_t deg = hi - lo;
      int64_t *dst = out + i * fanout;
      if (deg <= 0) {
        for (int64_t j = 0; j < fanout; ++j) dst[j] = v;
      } else {
        for (int64_t j = 0; j < fanout; ++j)
          dst[j] = indices[lo + (int64_t)rng.bounded((uint64_t)deg)];
      }
    }
  }
}

// Sample up to `fanout` DISTINCT in-neighbors per seed (DGL's
// without-replacement semantics, the MultiLayerNeighborSampler default in
// the reference reddit NS path). Distinct selection uses Robert Floyd's
// algorithm — O(fanout^2) per seed with fanout <= ~25, no allocation, no
// dependence on degree — so hub nodes cost the same as leaves. Seeds with
// deg < fanout take all deg distinct neighbors and fill the remaining
// slots cyclically from them (static output shape; the Python layer
// documents the resulting mean/sum weighting deviation). Zero-degree seeds
// yield themselves, as in sample_neighbors.
void sample_neighbors_noreplace(const int64_t *indptr, const int64_t *indices,
                                const int64_t *seeds, int64_t n_seeds,
                                int64_t fanout, uint64_t seed, int64_t *out) {
#pragma omp parallel
  {
#ifdef _OPENMP
    int tid = omp_get_thread_num();
#else
    int tid = 0;
#endif
    Rng rng(seed * 0x9e3779b97f4a7c15ull + (uint64_t)tid + 1);
    int64_t chosen[64];  // fanout is clamped to 64 by the Python wrapper
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n_seeds; ++i) {
      int64_t v = seeds[i];
      int64_t lo = indptr[v], hi = indptr[v + 1];
      int64_t deg = hi - lo;
      int64_t *dst = out + i * fanout;
      if (deg <= 0) {
        for (int64_t j = 0; j < fanout; ++j) dst[j] = v;
      } else if (deg <= fanout) {
        for (int64_t j = 0; j < fanout; ++j) dst[j] = indices[lo + j % deg];
      } else {
        // Floyd: k distinct draws from [0, deg)
        int64_t k = fanout;
        for (int64_t t = deg - k, m = 0; t < deg; ++t, ++m) {
          int64_t j = (int64_t)rng.bounded((uint64_t)(t + 1));
          bool dup = false;
          for (int64_t q = 0; q < m; ++q)
            if (chosen[q] == j) { dup = true; break; }
          chosen[m] = dup ? t : j;
        }
        for (int64_t m = 0; m < k; ++m) dst[m] = indices[lo + chosen[m]];
      }
    }
  }
}

// Node-induced subgraph: edges (by-src CSR) with both endpoints in `nodes`,
// relabelled to positions in `nodes`. Returns edge count written.
// mapping: caller-provided scratch of size num_nodes (int64).
// out_src/out_dst must have room for the total out-degree of `nodes`.
// Deterministic: edges are emitted grouped by sub-node index (CSR order
// within each node) via a count → exclusive-scan → write scheme, so the
// output is bit-identical across runs and thread counts (seeded cluster
// batches stay reproducible).
int64_t node_subgraph(const int64_t *indptr, const int64_t *indices,
                      int64_t num_nodes, const int64_t *nodes,
                      int64_t n_sub, int64_t *mapping, uint8_t *present,
                      int64_t *out_src, int64_t *out_dst) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_sub; ++i) {
    present[nodes[i]] = 1;
    mapping[nodes[i]] = i;
  }
  // pass 1: kept-edge count per sub node
  int64_t *offs = new int64_t[n_sub + 1];
  offs[0] = 0;
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t i = 0; i < n_sub; ++i) {
    int64_t u = nodes[i];
    int64_t c = 0;
    for (int64_t p = indptr[u]; p < indptr[u + 1]; ++p)
      c += present[indices[p]];
    offs[i + 1] = c;
  }
  for (int64_t i = 0; i < n_sub; ++i) offs[i + 1] += offs[i];
  // pass 2: write at deterministic offsets
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t i = 0; i < n_sub; ++i) {
    int64_t u = nodes[i];
    int64_t pos = offs[i];
    for (int64_t p = indptr[u]; p < indptr[u + 1]; ++p) {
      int64_t w = indices[p];
      if (present[w]) {
        out_src[pos] = i;
        out_dst[pos] = mapping[w];
        ++pos;
      }
    }
  }
  int64_t total = offs[n_sub];
  delete[] offs;
  // reset scratch for reuse
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_sub; ++i) present[nodes[i]] = 0;
  return total;
}

// Label-propagation partitioner (the METIS role): k seeds, iterative
// adoption over the edge list, then orphan round-robin. part: -1-initialized.
void partition_lp(const int64_t *src, const int64_t *dst, int64_t n_edges,
                  int64_t num_nodes, int64_t k, int64_t rounds, uint64_t seed,
                  int64_t *part) {
  Rng rng(seed + 1);
  for (int64_t i = 0; i < num_nodes; ++i) part[i] = -1;
  for (int64_t p = 0; p < k; ++p) {
    int64_t v = (int64_t)rng.bounded((uint64_t)num_nodes);
    if (part[v] < 0) part[v] = p;
  }
  for (int64_t r = 0; r < rounds; ++r) {
    std::atomic<int64_t> changed(0);
#pragma omp parallel for schedule(static)
    for (int64_t e = 0; e < n_edges; ++e) {
      int64_t s = src[e], d = dst[e];
      if (part[d] < 0 && part[s] >= 0) {
        part[d] = part[s];
        changed.fetch_add(1, std::memory_order_relaxed);
      } else if (part[s] < 0 && part[d] >= 0) {
        part[s] = part[d];
        changed.fetch_add(1, std::memory_order_relaxed);
      }
    }
    if (changed.load() == 0) break;
  }
  for (int64_t v = 0; v < num_nodes; ++v)
    if (part[v] < 0) part[v] = (int64_t)rng.bounded((uint64_t)k);
}

// ---------------------------------------------------------------------------
// Multilevel k-way partitioner (the METIS role, quality-focused).
//
// The reference suite depends on METIS for cluster-batched training
// (dgl.transform.metis_partition, cluster-sage/dgl/partition_utils.py:9-16).
// Plain label propagation recovers almost no community structure on
// homophilous graphs with random edges mixed in (measured: 76% sparse-tile
// remainder on reddit-like graphs vs 27% for a true community ordering), so
// this implements the standard multilevel scheme:
//   1. coarsen by heavy-edge matching (edge weights = contracted multiplicity)
//   2. greedy BFS region growing on the coarsest graph (balanced seeds)
//   3. uncoarsen with boundary refinement under a balance cap
// Serial per level (deterministic given the seed); levels are O(E).

namespace {

struct Csr {
  std::vector<int64_t> indptr, adj, w;
  int64_t n = 0;
};

// Build weighted CSR from an edge list, merging duplicate (u,v) pairs and
// dropping self-loops. Symmetrizes (adds both directions).
static Csr build_adj(const int64_t *src, const int64_t *dst, int64_t m,
                     int64_t n) {
  Csr g;
  g.n = n;
  g.indptr.assign(n + 1, 0);
  for (int64_t e = 0; e < m; ++e) {
    if (src[e] == dst[e]) continue;
    g.indptr[src[e] + 1]++;
    g.indptr[dst[e] + 1]++;
  }
  for (int64_t i = 0; i < n; ++i) g.indptr[i + 1] += g.indptr[i];
  std::vector<int64_t> cur(g.indptr.begin(), g.indptr.end() - 1);
  g.adj.resize(g.indptr[n]);
  for (int64_t e = 0; e < m; ++e) {
    if (src[e] == dst[e]) continue;
    g.adj[cur[src[e]]++] = dst[e];
    g.adj[cur[dst[e]]++] = src[e];
  }
  // sort+merge duplicates per row, accumulate weights
  g.w.assign(g.adj.size(), 1);
  std::vector<int64_t> new_indptr(n + 1, 0);
  int64_t write = 0;
  for (int64_t v = 0; v < n; ++v) {
    int64_t lo = g.indptr[v], hi = g.indptr[v + 1];
    std::sort(g.adj.begin() + lo, g.adj.begin() + hi);
    int64_t row_start = write;
    for (int64_t p = lo; p < hi;) {
      int64_t u = g.adj[p], cnt = 0;
      while (p < hi && g.adj[p] == u) { ++cnt; ++p; }
      g.adj[write] = u;
      g.w[write] = cnt;
      ++write;
    }
    new_indptr[v] = row_start;
  }
  new_indptr[n] = write;
  // repack (indptr currently holds row starts)
  for (int64_t v = 0; v < n; ++v) g.indptr[v] = new_indptr[v];
  g.indptr[n] = write;
  g.adj.resize(write);
  g.w.resize(write);
  return g;
}

// Weighted CSR coarsening via heavy-edge matching. Returns coarse graph and
// fills `cmap` (fine node -> coarse node).
static Csr coarsen(const Csr &g, const std::vector<int64_t> &vw,
                   std::vector<int64_t> &cvw, std::vector<int64_t> &cmap,
                   Rng &rng) {
  int64_t n = g.n;
  std::vector<int64_t> match(n, -1);
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  for (int64_t i = n - 1; i > 0; --i)
    std::swap(order[i], order[rng.bounded((uint64_t)(i + 1))]);
  for (int64_t oi = 0; oi < n; ++oi) {
    int64_t v = order[oi];
    if (match[v] >= 0) continue;
    int64_t best = -1, best_w = -1;
    for (int64_t p = g.indptr[v]; p < g.indptr[v + 1]; ++p) {
      int64_t u = g.adj[p];
      if (match[u] < 0 && g.w[p] > best_w) { best = u; best_w = g.w[p]; }
    }
    if (best >= 0) { match[v] = best; match[best] = v; }
    else match[v] = v;
  }
  cmap.assign(n, -1);
  int64_t nc = 0;
  for (int64_t v = 0; v < n; ++v) {
    if (cmap[v] >= 0) continue;
    cmap[v] = nc;
    cmap[match[v]] = nc;
    ++nc;
  }
  cvw.assign(nc, 0);
  for (int64_t v = 0; v < n; ++v) cvw[cmap[v]] += vw[v];
  // coarse edges: relabel + merge (reuse build_adj on the relabelled list)
  std::vector<int64_t> cs, cd, cw;
  cs.reserve(g.adj.size() / 2);
  cd.reserve(g.adj.size() / 2);
  cw.reserve(g.adj.size() / 2);
  for (int64_t v = 0; v < n; ++v)
    for (int64_t p = g.indptr[v]; p < g.indptr[v + 1]; ++p) {
      int64_t u = g.adj[p];
      if (u < v) continue;  // each undirected edge once
      int64_t a = cmap[v], b = cmap[u];
      if (a == b) continue;
      cs.push_back(a);
      cd.push_back(b);
      cw.push_back(g.w[p]);
    }
  // weighted build_adj: histogram, fill, sort+merge accumulating weights
  Csr c;
  c.n = nc;
  c.indptr.assign(nc + 1, 0);
  for (size_t e = 0; e < cs.size(); ++e) {
    c.indptr[cs[e] + 1]++;
    c.indptr[cd[e] + 1]++;
  }
  for (int64_t i = 0; i < nc; ++i) c.indptr[i + 1] += c.indptr[i];
  std::vector<int64_t> cur(c.indptr.begin(), c.indptr.end() - 1);
  c.adj.resize(c.indptr[nc]);
  c.w.resize(c.indptr[nc]);
  for (size_t e = 0; e < cs.size(); ++e) {
    c.adj[cur[cs[e]]] = cd[e];
    c.w[cur[cs[e]]++] = cw[e];
    c.adj[cur[cd[e]]] = cs[e];
    c.w[cur[cd[e]]++] = cw[e];
  }
  std::vector<int64_t> ptr2(nc + 1, 0);
  int64_t write = 0;
  for (int64_t v = 0; v < nc; ++v) {
    int64_t lo = c.indptr[v], hi = c.indptr[v + 1];
    // sort (adj, w) pairs by adj
    std::vector<std::pair<int64_t, int64_t>> row;
    row.reserve(hi - lo);
    for (int64_t p = lo; p < hi; ++p) row.emplace_back(c.adj[p], c.w[p]);
    std::sort(row.begin(), row.end());
    int64_t row_start = write;
    for (size_t p = 0; p < row.size();) {
      int64_t u = row[p].first, wsum = 0;
      while (p < row.size() && row[p].first == u) { wsum += row[p].second; ++p; }
      c.adj[write] = u;
      c.w[write] = wsum;
      ++write;
    }
    ptr2[v] = row_start;
  }
  ptr2[nc] = write;
  for (int64_t v = 0; v <= nc; ++v) c.indptr[v] = (v < nc) ? ptr2[v] : write;
  c.adj.resize(write);
  c.w.resize(write);
  return c;
}

// Greedy BFS region growing: balanced initial k-way partition by node weight.
static void grow_partition(const Csr &g, const std::vector<int64_t> &vw,
                           int64_t k, Rng &rng, std::vector<int64_t> &part) {
  int64_t n = g.n;
  part.assign(n, -1);
  int64_t total = 0;
  for (int64_t v = 0; v < n; ++v) total += vw[v];
  int64_t target = (total + k - 1) / k;
  std::vector<int64_t> frontier;
  int64_t next_unassigned = 0;
  for (int64_t p = 0; p < k; ++p) {
    // seed: first unassigned node (random probe first for variety)
    int64_t seed_v = -1;
    for (int t = 0; t < 4; ++t) {
      int64_t cand = (int64_t)rng.bounded((uint64_t)n);
      if (part[cand] < 0) { seed_v = cand; break; }
    }
    if (seed_v < 0) {
      while (next_unassigned < n && part[next_unassigned] >= 0) ++next_unassigned;
      if (next_unassigned >= n) break;
      seed_v = next_unassigned;
    }
    frontier.clear();
    frontier.push_back(seed_v);
    part[seed_v] = p;
    int64_t w_acc = vw[seed_v];
    size_t head = 0;
    while (w_acc < target && head < frontier.size()) {
      int64_t v = frontier[head++];
      for (int64_t q = g.indptr[v]; q < g.indptr[v + 1] && w_acc < target; ++q) {
        int64_t u = g.adj[q];
        if (part[u] < 0) {
          part[u] = p;
          w_acc += vw[u];
          frontier.push_back(u);
        }
      }
    }
  }
  // leftovers: attach to the LIGHTEST neighboring part (unweighted attach
  // here was the source of multi-x imbalance: when growth exhausts the k
  // seeds early, whole regions glommed onto one neighbor part), else the
  // globally lightest part
  std::vector<int64_t> pw(k, 0);
  for (int64_t v = 0; v < n; ++v)
    if (part[v] >= 0) pw[part[v]] += vw[v];
  for (int64_t v = 0; v < n; ++v) {
    if (part[v] >= 0) continue;
    int64_t best = -1;
    for (int64_t q = g.indptr[v]; q < g.indptr[v + 1]; ++q) {
      int64_t pu = part[g.adj[q]];
      if (pu >= 0 && (best < 0 || pw[pu] < pw[best])) best = pu;
    }
    if (best < 0)
      best = (int64_t)(std::min_element(pw.begin(), pw.end()) - pw.begin());
    part[v] = best;
    pw[best] += vw[v];
  }
}

// Boundary refinement: move nodes to the strongest-connected part when it
// reduces cut and respects the balance cap. A few deterministic passes.
static void refine(const Csr &g, const std::vector<int64_t> &vw, int64_t k,
                   std::vector<int64_t> &part, int passes, double imbalance) {
  int64_t n = g.n;
  std::vector<int64_t> pw(k, 0);
  int64_t total = 0;
  for (int64_t v = 0; v < n; ++v) { pw[part[v]] += vw[v]; total += vw[v]; }
  int64_t cap = (int64_t)((double)total / (double)k * imbalance) + 1;
  std::vector<int64_t> conn(k, 0), touched;
  for (int pass = 0; pass < passes; ++pass) {
    int64_t moves = 0;
    for (int64_t v = 0; v < n; ++v) {
      int64_t pv = part[v];
      touched.clear();
      for (int64_t q = g.indptr[v]; q < g.indptr[v + 1]; ++q) {
        int64_t pu = part[g.adj[q]];
        if (conn[pu] == 0) touched.push_back(pu);
        conn[pu] += g.w[q];
      }
      // over-cap parts must shed: accept the least-bad feasible move
      // (negative gain allowed) so refine also repairs imbalance instead
      // of only preserving it
      bool over = pw[pv] > cap;
      int64_t best = pv;
      int64_t best_gain = over ? INT64_MIN : 0;
      for (int64_t pu : touched) {
        if (pu == pv) continue;
        int64_t gain = conn[pu] - conn[pv];
        if (gain > best_gain && pw[pu] + vw[v] <= cap) { best = pu; best_gain = gain; }
      }
      if (over && best == pv) {
        int64_t lightest =
            (int64_t)(std::min_element(pw.begin(), pw.end()) - pw.begin());
        if (lightest != pv && pw[lightest] + vw[v] <= cap) best = lightest;
      }
      if (best != pv) {
        pw[pv] -= vw[v];
        pw[best] += vw[v];
        part[v] = best;
        ++moves;
      }
      for (int64_t pu : touched) conn[pu] = 0;
    }
    if (moves == 0) break;
  }
}

}  // namespace

// part: output (num_nodes). Returns the edge cut (directed edges crossing).
int64_t partition_multilevel(const int64_t *src, const int64_t *dst,
                             int64_t n_edges, int64_t num_nodes, int64_t k,
                             uint64_t seed, int64_t *part_out) {
  Rng rng(seed + 0x9e3779b9ull);
  std::vector<Csr> levels;
  std::vector<std::vector<int64_t>> vws, cmaps;
  levels.push_back(build_adj(src, dst, n_edges, num_nodes));
  vws.emplace_back(num_nodes, 1);
  int64_t coarse_stop = std::max<int64_t>(2 * k, 2048);
  while (levels.back().n > coarse_stop && levels.size() < 24) {
    std::vector<int64_t> cvw, cmap;
    Csr c = coarsen(levels.back(), vws.back(), cvw, cmap, rng);
    if (c.n >= levels.back().n * 95 / 100) break;  // matching stalled
    cmaps.push_back(std::move(cmap));
    levels.push_back(std::move(c));
    vws.push_back(std::move(cvw));
  }
  std::vector<int64_t> part;
  grow_partition(levels.back(), vws.back(), k, rng, part);
  refine(levels.back(), vws.back(), k, part, 4, 1.08);
  for (int64_t l = (int64_t)levels.size() - 2; l >= 0; --l) {
    std::vector<int64_t> fine(levels[l].n);
    for (int64_t v = 0; v < levels[l].n; ++v) fine[v] = part[cmaps[l][v]];
    part = std::move(fine);
    refine(levels[l], vws[l], k, part, l == 0 ? 2 : 3, 1.08);
  }
  int64_t cut = 0;
  for (int64_t e = 0; e < n_edges; ++e)
    if (part[src[e]] != part[dst[e]]) ++cut;
  std::memcpy(part_out, part.data(), num_nodes * sizeof(int64_t));
  return cut;
}

// Build CSR (indptr + permuted column array) from an edge list, sorted by
// `key` (counting sort — O(E), parallel histogram).
void build_csr(const int64_t *key, const int64_t *val, int64_t n_edges,
               int64_t num_nodes, int64_t *indptr, int64_t *out_val,
               int64_t *out_eid) {
  for (int64_t i = 0; i <= num_nodes; ++i) indptr[i] = 0;
  for (int64_t e = 0; e < n_edges; ++e) indptr[key[e] + 1]++;
  for (int64_t i = 0; i < num_nodes; ++i) indptr[i + 1] += indptr[i];
  // stable fill using a cursor copy
  int64_t *cursor = new int64_t[num_nodes];
  std::memcpy(cursor, indptr, num_nodes * sizeof(int64_t));
  for (int64_t e = 0; e < n_edges; ++e) {
    int64_t pos = cursor[key[e]]++;
    out_val[pos] = val[e];
    out_eid[pos] = e;
  }
  delete[] cursor;
}

}  // extern "C"
