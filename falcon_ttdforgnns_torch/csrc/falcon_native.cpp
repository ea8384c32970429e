// falcon_native — host-side native runtime of falcon_ttdforgnns_torch.
//
// A copy of falcon_ttdforgnns_tpu/csrc/falcon_native.cpp, byte for byte
// below this header, so that the two packages build the same CSR, draw the
// same samples and R-MAT edges, and find the same partitions for the same
// inputs and seeds.  It covers where the host bottlenecks: graph
// construction, neighbor sampling (the DGL CPU-worker role,
// `graphloader.py:237-275`), and METIS-style multilevel partitioning
// (`graphloader.py:399-454`).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image).
// All functions are thread-parallel with std::thread; RNG is xorshift128+
// per thread (counter-seeded, reproducible).  rmat_edges seeds each
// thread's chunk, so its edges depend on the host's core count; the
// sampler seeds each position and does not.
//
// Build: ops/_build.py build_host("falcon_native"), at first use, into
// falcon_ttdforgnns_torch/build/ (the host C++ compiler with
// csrc/Makefile's flags of the JAX package).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstdint>
#include <cstring>
#include <deque>
#include <numeric>
#include <queue>
#include <random>
#include <thread>
#include <vector>

namespace {

inline int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

// Split [0, n) into roughly equal chunks and run fn(begin, end) on each.
template <typename F>
void parallel_for(int64_t n, F fn, int max_threads = 0) {
  int nt = max_threads > 0 ? max_threads : hw_threads();
  if (n < 4096 || nt <= 1) {
    fn(0, n);
    return;
  }
  nt = static_cast<int>(std::min<int64_t>(nt, n));
  std::vector<std::thread> ts;
  ts.reserve(nt);
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t b = t * chunk, e = std::min(n, b + chunk);
    if (b >= e) break;
    ts.emplace_back([=] { fn(b, e); });
  }
  for (auto& t : ts) t.join();
}

struct XorShift128 {
  uint64_t s0, s1;
  explicit XorShift128(uint64_t seed) {
    // splitmix64 seeding
    auto mix = [](uint64_t& x) {
      x += 0x9E3779B97f4A7C15ull;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
      return z ^ (z >> 31);
    };
    uint64_t x = seed ? seed : 1;
    s0 = mix(x);
    s1 = mix(x);
  }
  inline uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  // unbiased-enough range map (Lemire)
  inline uint64_t bounded(uint64_t range) {
    return (static_cast<__uint128_t>(next()) * range) >> 64;
  }
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// CSR construction: counting sort of edges by dst (in-neighbor CSR).
// Replaces numpy add.at + argsort (graph/csr.py fallback) — O(E), threaded.
// ---------------------------------------------------------------------------
void build_csr(const int64_t* src, const int64_t* dst, int64_t num_edges,
               int64_t num_nodes, int add_reverse, int64_t* out_indptr,
               int32_t* out_indices) {
  const int64_t total = add_reverse ? 2 * num_edges : num_edges;
  std::vector<std::atomic<int64_t>> deg(num_nodes);
  for (auto& d : deg) d.store(0, std::memory_order_relaxed);

  parallel_for(num_edges, [&](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i) {
      deg[dst[i]].fetch_add(1, std::memory_order_relaxed);
      if (add_reverse) deg[src[i]].fetch_add(1, std::memory_order_relaxed);
    }
  });
  out_indptr[0] = 0;
  for (int64_t v = 0; v < num_nodes; ++v)
    out_indptr[v + 1] = out_indptr[v] + deg[v].load(std::memory_order_relaxed);

  std::vector<std::atomic<int64_t>> cursor(num_nodes);
  for (int64_t v = 0; v < num_nodes; ++v)
    cursor[v].store(out_indptr[v], std::memory_order_relaxed);

  parallel_for(num_edges, [&](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i) {
      int64_t p = cursor[dst[i]].fetch_add(1, std::memory_order_relaxed);
      out_indices[p] = static_cast<int32_t>(src[i]);
      if (add_reverse) {
        int64_t q = cursor[src[i]].fetch_add(1, std::memory_order_relaxed);
        out_indices[q] = static_cast<int32_t>(dst[i]);
      }
    }
  });
  // The atomic cursors scatter in thread-interleaving order — sort each
  // row so the CSR is deterministic run-to-run (seeded sampling reads
  // indices[lo + r]; a nondeterministic row order would break fixed-seed
  // reproducibility even with identical r draws).
  parallel_for(num_nodes, [&](int64_t b, int64_t e) {
    for (int64_t v = b; v < e; ++v)
      std::sort(out_indices + out_indptr[v], out_indices + out_indptr[v + 1]);
  });
  (void)total;
}

// ---------------------------------------------------------------------------
// Neighbor sampling with replacement (static fan-out; self-loop when
// isolated).  The native fast path behind graph/sampler.py.
// nodes: (M,) int64; out: (M*fanout,) int32, row-major.
// ---------------------------------------------------------------------------
void sample_neighbors(const int64_t* indptr, const int32_t* indices,
                      const int64_t* nodes, int64_t num_nodes_in,
                      int32_t fanout, uint64_t seed, int32_t* out) {
  parallel_for(num_nodes_in, [&](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i) {
      // counter-seeded PER POSITION, not per chunk: chunk bounds depend on
      // hardware_concurrency, so a per-chunk stream would give different
      // draws for the same seed on hosts with different core counts
      XorShift128 rng(seed * 0x9E3779B97f4A7C15ull + static_cast<uint64_t>(i) + 1);
      const int64_t u = nodes[i];
      const int64_t lo = indptr[u], hi = indptr[u + 1];
      const int64_t deg = hi - lo;
      int32_t* row = out + i * fanout;
      if (deg <= 0) {
        for (int f = 0; f < fanout; ++f) row[f] = static_cast<int32_t>(u);
      } else {
        for (int f = 0; f < fanout; ++f)
          row[f] = indices[lo + static_cast<int64_t>(rng.bounded(deg))];
      }
    }
  });
}

// Full multi-layer sampling in one call: expands the seed frontier through
// `num_layers` fanouts, writing each level's (B * prod(f)) block into `out`
// at the provided offsets.  Avoids Python-loop overhead per layer.
void sample_block_multi(const int64_t* indptr, const int32_t* indices,
                        const int64_t* seeds, int64_t batch,
                        const int32_t* fanouts, int32_t num_layers,
                        uint64_t seed, int32_t* out /* concat of levels */) {
  std::vector<int64_t> frontier(seeds, seeds + batch);
  int64_t off = 0;
  for (int32_t l = 0; l < num_layers; ++l) {
    const int32_t f = fanouts[l];
    const int64_t m = static_cast<int64_t>(frontier.size());
    int32_t* level_out = out + off;
    sample_neighbors(indptr, indices, frontier.data(), m, f,
                     seed + 0x51ed270bULL * static_cast<uint64_t>(l + 1),
                     level_out);
    off += m * f;
    frontier.assign(level_out, level_out + m * f);
    // no dedup by design: static shapes; duplicates feed TT group-dedup
  }
}

// ---------------------------------------------------------------------------
// Multilevel k-way partition (METIS-style): heavy-edge-matching coarsening,
// BFS-grown initial partition, greedy boundary refinement, projection.
// Replaces the numpy fallback in graph/reorder.py for big graphs.
// ---------------------------------------------------------------------------
namespace part {

// Non-owning view: level 0 aliases the caller's numpy buffers directly —
// copying the papers-scale input (1.67B-edge CSR) into owned vectors cost
// 7.4 GB of the 128 GB host budget for nothing.
struct GraphView {
  const int64_t* indptr;
  const int32_t* indices;
  const int32_t* ewgt;  // nullptr -> all edges weight 1
  const int32_t* vwgt;  // nullptr -> all nodes weight 1
  int64_t n_;
  int64_t n() const { return n_; }
  int64_t m() const { return indptr[n_]; }
  inline int32_t ew(int64_t j) const { return ewgt ? ewgt[j] : 1; }
  inline int32_t vw(int64_t v) const { return vwgt ? vwgt[v] : 1; }
};

struct Graph {
  std::vector<int64_t> indptr;
  std::vector<int32_t> indices;
  std::vector<int32_t> ewgt;  // edge weights (multi-edge multiplicity)
  std::vector<int32_t> vwgt;  // coarse node weights (collapsed count)
  int64_t n() const { return static_cast<int64_t>(indptr.size()) - 1; }
  GraphView view() const {
    return {indptr.data(), indices.data(),
            ewgt.empty() ? nullptr : ewgt.data(),
            vwgt.empty() ? nullptr : vwgt.data(), n()};
  }
};

Graph coarsen(const GraphView& g, std::vector<int32_t>& cmap, uint64_t seed,
              const int32_t* constraint = nullptr) {
  // ``constraint``: only match nodes in the same part (V-cycle coarsening —
  // keeps a projected partition valid at every level, so coarse-level
  // refinement can move whole fragments the fine-level greedy never can).
  const int64_t n = g.n();
  cmap.assign(n, -1);
  std::vector<int32_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  XorShift128 rng(seed);
  for (int64_t i = n - 1; i > 0; --i)
    std::swap(order[i], order[rng.bounded(i + 1)]);

  int32_t nxt = 0;
  for (int32_t u : order) {
    if (cmap[u] != -1) continue;
    int32_t mate = u;  // heavy-edge matching: heaviest unmatched neighbor
    int32_t best_w = -1;
    for (int64_t j = g.indptr[u]; j < g.indptr[u + 1]; ++j) {
      int32_t v = g.indices[j];
      if (cmap[v] == -1 && v != u && g.ew(j) > best_w &&
          (!constraint || constraint[v] == constraint[u])) {
        mate = v;
        best_w = g.ew(j);
      }
    }
    cmap[u] = nxt;
    if (mate != u) cmap[mate] = nxt;
    ++nxt;
  }
  // Build the coarse graph with a flat two-pass CSR (count, fill) and
  // in-place per-row dedup.  The old per-coarse-node vector-of-vectors
  // OOM-killed the papers-scale build (1.67B edges): 13 GB of pair
  // payload became >100 GB of small-allocation headers, growth doubling
  // and fragmentation across 27M vectors, times the retained levels.
  // Peak here is ~8 B per cross edge (4 B nbr + 4 B weight) and the
  // compacted arrays are moved, not copied, into the result.
  Graph cg;
  cg.vwgt.assign(nxt, 0);
  for (int64_t u = 0; u < n; ++u) cg.vwgt[cmap[u]] += g.vw(u);
  std::vector<int64_t> coff(nxt + 1, 0);
  for (int64_t u = 0; u < n; ++u) {
    const int32_t cu = cmap[u];
    for (int64_t j = g.indptr[u]; j < g.indptr[u + 1]; ++j)
      if (cmap[g.indices[j]] != cu) ++coff[cu + 1];
  }
  for (int32_t v = 0; v < nxt; ++v) coff[v + 1] += coff[v];
  const int64_t mm = coff[nxt];
  std::vector<int32_t> flat_nbr(mm);
  std::vector<int32_t> flat_w;  // only when the fine level is weighted
  if (g.ewgt) flat_w.resize(mm);
  {
    std::vector<int64_t> cur(coff.begin(), coff.end() - 1);
    for (int64_t u = 0; u < n; ++u) {
      const int32_t cu = cmap[u];
      for (int64_t j = g.indptr[u]; j < g.indptr[u + 1]; ++j) {
        const int32_t cv = cmap[g.indices[j]];
        if (cv == cu) continue;
        const int64_t at = cur[cu]++;
        flat_nbr[at] = cv;
        if (g.ewgt) flat_w[at] = g.ewgt[j];
      }
    }
  }
  cg.indptr.assign(nxt + 1, 0);
  std::vector<int32_t> wbuf;
  wbuf.reserve(mm / 2 + 16);
  std::vector<std::pair<int32_t, int32_t>> scratch;  // weighted rows only
  int64_t w = 0;  // global write cursor (w <= row start: compaction shrinks)
  for (int32_t v = 0; v < nxt; ++v) {
    const int64_t lo = coff[v], hi = coff[v + 1];
    if (g.ewgt == nullptr) {
      // unweighted fine level: sort the row in place; duplicate runs
      // become the coarse edge weights
      std::sort(flat_nbr.begin() + lo, flat_nbr.begin() + hi);
      for (int64_t r = lo; r < hi;) {
        const int32_t nbr = flat_nbr[r];
        int32_t sum = 0;
        while (r < hi && flat_nbr[r] == nbr) { ++sum; ++r; }
        flat_nbr[w++] = nbr;
        wbuf.push_back(sum);
      }
    } else {
      scratch.clear();
      for (int64_t r = lo; r < hi; ++r)
        scratch.push_back({flat_nbr[r], flat_w[r]});
      std::sort(scratch.begin(), scratch.end());
      for (size_t r = 0; r < scratch.size();) {
        const int32_t nbr = scratch[r].first;
        int32_t sum = 0;
        while (r < scratch.size() && scratch[r].first == nbr)
          sum += scratch[r++].second;
        flat_nbr[w++] = nbr;
        wbuf.push_back(sum);
      }
    }
    cg.indptr[v + 1] = w;
  }
  flat_nbr.resize(w);
  // resize() keeps the pre-dedup capacity and push_back growth doubles
  // wbuf past the dedup count — at papers scale (1.6B cross edges) that
  // slack alone is >10 GB per retained level; trade a transient
  // realloc+copy for exact-capacity buffers
  flat_nbr.shrink_to_fit();
  wbuf.shrink_to_fit();
  cg.indices = std::move(flat_nbr);
  cg.ewgt = std::move(wbuf);
  return cg;
}

void bfs_grow(const GraphView& g, int32_t k, uint64_t seed, std::vector<int32_t>& part) {
  const int64_t n = g.n();
  part.assign(n, -1);
  int64_t total_w = 0;
  for (int64_t v = 0; v < n; ++v) total_w += g.vw(v);
  const int64_t target = (total_w + k - 1) / k;
  std::vector<int64_t> size(k, 0);
  std::vector<std::deque<int32_t>> q(k);
  XorShift128 rng(seed);
  for (int32_t p = 0; p < k; ++p) {
    for (int attempts = 0; attempts < 64; ++attempts) {
      int32_t s = static_cast<int32_t>(rng.bounded(n));
      if (part[s] == -1) {
        part[s] = p;
        size[p] += g.vw(s);
        q[p].push_back(s);
        break;
      }
    }
  }
  bool active = true;
  while (active) {
    active = false;
    for (int32_t p = 0; p < k; ++p) {
      int budget = 256;
      while (!q[p].empty() && size[p] < target && budget > 0) {
        int32_t u = q[p].front();
        q[p].pop_front();
        for (int64_t j = g.indptr[u]; j < g.indptr[u + 1]; ++j) {
          int32_t v = g.indices[j];
          if (part[v] == -1) {
            part[v] = p;
            size[p] += g.vw(v);
            q[p].push_back(v);
            if (--budget <= 0 || size[p] >= target) break;
          }
        }
      }
      if (!q[p].empty() && size[p] < target) active = true;
    }
  }
  for (int64_t v = 0; v < n; ++v)
    if (part[v] == -1) {
      int32_t best = 0;
      for (int32_t p = 1; p < k; ++p)
        if (size[p] < size[best]) best = p;
      part[v] = best;
      size[best] += g.vw(v);
    }
}

// Greedy boundary refinement (KL/FM-style with balance guard).
// Boundary-only worklist + stamped sparse gain accumulation: each visit
// costs O(deg(u)) instead of O(deg(u) + k), and only boundary nodes (and
// neighbors of moved nodes) are revisited — makes many passes affordable
// at k=128 on multi-million-node graphs.
void refine(const GraphView& g, int32_t k, std::vector<int32_t>& part, int passes) {
  const int64_t n = g.n();
  std::vector<int64_t> size(k, 0);
  for (int64_t v = 0; v < n; ++v) size[part[v]] += g.vw(v);
  int64_t total_w = 0;
  for (auto s : size) total_w += s;
  const int64_t cap = total_w / k + total_w / (4 * k) + 1;  // 1.25x balance

  std::vector<int64_t> acc(k, 0);
  std::vector<int64_t> stamp(k, -1);
  std::vector<int32_t> touched;
  touched.reserve(256);
  std::vector<uint8_t> queued(n, 0);
  std::vector<int32_t> queue;
  queue.reserve(n / 8 + 16);
  for (int64_t u = 0; u < n; ++u)
    for (int64_t j = g.indptr[u]; j < g.indptr[u + 1]; ++j)
      if (part[g.indices[j]] != part[u]) {
        queue.push_back(static_cast<int32_t>(u));
        queued[u] = 1;
        break;
      }

  int64_t version = 0;
  std::vector<int32_t> next;
  for (int pass = 0; pass < passes && !queue.empty(); ++pass) {
    next.clear();
    int64_t moved = 0;
    for (int32_t u : queue) {
      queued[u] = 0;
      const int32_t pu = part[u];
      ++version;
      touched.clear();
      for (int64_t j = g.indptr[u]; j < g.indptr[u + 1]; ++j) {
        const int32_t p = part[g.indices[j]];
        if (stamp[p] != version) {
          stamp[p] = version;
          acc[p] = 0;
          touched.push_back(p);
        }
        acc[p] += g.ew(j);
      }
      const int64_t internal = (stamp[pu] == version) ? acc[pu] : 0;
      const int32_t w = g.vw(u);
      int32_t best = pu;
      int64_t best_gain = internal;
      for (int32_t p : touched)
        if (p != pu && acc[p] > best_gain && size[p] + w <= cap) {
          best = p;
          best_gain = acc[p];
        }
      if (best != pu) {
        part[u] = best;
        size[pu] -= w;
        size[best] += w;
        ++moved;
        // moved nodes change their neighbors' gains — revisit them
        for (int64_t j = g.indptr[u]; j < g.indptr[u + 1]; ++j) {
          const int32_t v = g.indices[j];
          if (!queued[v]) {
            queued[v] = 1;
            next.push_back(v);
          }
        }
        if (!queued[u]) {
          queued[u] = 1;
          next.push_back(u);
        }
      }
    }
    if (moved == 0) break;
    std::swap(queue, next);
  }
}

// Label-propagation clustering + LPT bin-packing initial partition: on
// graphs with community structure (the planted-partition family, real
// social/product graphs) weighted label propagation recovers the clusters
// almost exactly, and packing whole clusters into the k lightest parts
// yields an initial split already aligned with the communities — the
// failure mode of BFS growing (community fragments strewn across parts,
// unfixable by single-node refinement) never arises.  Clusters larger than
// the balance cap are split across parts in arrival order.
void lp_grow(const GraphView& g, int32_t k, uint64_t seed,
             std::vector<int32_t>& part) {
  const int64_t n = g.n();
  std::vector<int32_t> lbl(n);
  std::iota(lbl.begin(), lbl.end(), 0);
  std::vector<int32_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  XorShift128 rng(seed);
  for (int64_t i = n - 1; i > 0; --i)
    std::swap(order[i], order[rng.bounded(i + 1)]);
  std::vector<int64_t> acc(n, 0);
  std::vector<int64_t> stamp(n, -1);
  int64_t version = 0;
  for (int it = 0; it < 12; ++it) {
    int64_t changed = 0;
    for (int32_t u : order) {
      ++version;
      int32_t best = lbl[u];
      int64_t best_w = 0;
      for (int64_t j = g.indptr[u]; j < g.indptr[u + 1]; ++j) {
        const int32_t l = lbl[g.indices[j]];
        if (stamp[l] != version) { stamp[l] = version; acc[l] = 0; }
        acc[l] += g.ew(j);
        if (acc[l] > best_w || (acc[l] == best_w && l == lbl[u])) {
          best_w = acc[l];
          best = l;
        }
      }
      if (best != lbl[u]) { lbl[u] = best; ++changed; }
    }
    if (changed == 0) break;
  }
  // cluster weights
  std::vector<int64_t> cw(n, 0);
  int64_t total_w = 0;
  for (int64_t v = 0; v < n; ++v) {
    const int32_t w = g.vw(v);
    cw[lbl[v]] += w;
    total_w += w;
  }
  const int64_t cap = total_w / k + total_w / (4 * k) + 1;
  // LPT: heaviest cluster first into the lightest part
  std::vector<int32_t> clusters;
  for (int64_t c = 0; c < n; ++c)
    if (cw[c] > 0) clusters.push_back(static_cast<int32_t>(c));
  std::sort(clusters.begin(), clusters.end(),
            [&](int32_t a, int32_t b) { return cw[a] > cw[b]; });
  std::vector<int64_t> size(k, 0);
  std::vector<int32_t> cpart(n, -1);
  for (int32_t c : clusters) {
    int32_t lightest = 0;
    for (int32_t p = 1; p < k; ++p)
      if (size[p] < size[lightest]) lightest = p;
    if (size[lightest] + cw[c] <= cap) {
      cpart[c] = lightest;
      size[lightest] += cw[c];
    }  // oversized / cap-breaking clusters split per-node below
  }
  part.assign(n, -1);
  for (int64_t v = 0; v < n; ++v) {
    const int32_t c = lbl[v];
    if (cpart[c] >= 0) {
      part[v] = cpart[c];
    } else {
      const int32_t w = g.vw(v);
      int32_t lightest = 0;
      for (int32_t p = 1; p < k; ++p)
        if (size[p] < size[lightest]) lightest = p;
      part[v] = lightest;
      size[lightest] += w;
    }
  }
}


}  // namespace part

namespace part {

int64_t cut_weight(const GraphView& g, const std::vector<int32_t>& p) {
  int64_t cut = 0;
  for (int64_t u = 0; u < g.n(); ++u)
    for (int64_t j = g.indptr[u]; j < g.indptr[u + 1]; ++j)
      if (p[g.indices[j]] != p[u]) cut += g.ew(j);
  return cut;
}

// One multilevel pass over ``g0``: coarsen (optionally restricted to the
// parts of ``warm``), partition the coarsest (BFS multi-restart, or the
// projected ``warm`` partition), uncoarsen with per-level refinement.
// Levels with more edges than this are not kept for uncoarsening
// refinement: their owned buffers are FREED as soon as the next coarser
// level exists, and the upward pass projects through them without a
// refine step.  This is a memory SAFETY VALVE, not a tuning knob:
// skipping fine-level refinement costs real cut quality (measured at
// products scale: 0.19 -> 0.43 cut fraction when the top two levels
// skip), so the default cap (1.5B edges) is set to never trigger at the
// half-papers scale a 125 GB host can fit — the capacity fixes in
// coarsen() (shrink_to_fit; measured ~37 B/input-edge all-in peak) are
// what make that scale fit.  At FULL papers scale (3.3B directed edges)
// the first owned level (~2.6B edges, >20 GB) trips the cap and is
// projected through — the quality loss is the price of fitting at all.
// Override: FALCON_PART_MAX_REFINE_EDGES.
int64_t max_refine_edges() {
  if (const char* s = std::getenv("FALCON_PART_MAX_REFINE_EDGES"))
    return std::atoll(s);
  return 1500LL * 1000 * 1000;
}

std::vector<int32_t> ml_pass(const GraphView& g0, int32_t k, uint64_t seed,
                             const std::vector<int32_t>* warm) {
  std::vector<GraphView> levels{g0};
  std::vector<Graph> owned;  // inner heap buffers stay put if this grows
  owned.reserve(24);
  std::vector<std::vector<int32_t>> cmaps;
  std::vector<char> refinable{1};  // parallel to `levels`
  const int64_t refine_cap = max_refine_edges();
  refinable[0] = g0.m() <= refine_cap;
  const int64_t coarsen_to = std::max<int64_t>(4096, 8L * k);
  std::vector<int32_t> proj;  // warm partition projected to the coarsest
  if (warm) proj = *warm;
  while (levels.back().n() > coarsen_to && levels.size() < 24) {
    std::vector<int32_t> cmap;
    Graph cg = coarsen(levels.back(), cmap, seed + levels.size(),
                       warm ? proj.data() : nullptr);
    if (cg.n() >= levels.back().n() * 95 / 100) break;  // matching stalled
    if (warm) {
      std::vector<int32_t> cproj(cg.n());
      for (size_t v = 0; v < cmap.size(); ++v) cproj[cmap[v]] = proj[v];
      proj = std::move(cproj);
    }
    // the previous level's graph is no longer read once the coarser one
    // exists — if it is owned and over the refine cap, free it now (its
    // cmap, all the upward pass needs for projection, stays); null the
    // view too so any stray read of the freed level faults immediately
    // instead of chasing dangling pointers
    const size_t prev = levels.size() - 1;
    if (prev >= 1 && !refinable[prev]) {
      Graph& og = owned[prev - 1];
      og.indptr = std::vector<int64_t>();
      og.indices = std::vector<int32_t>();
      og.ewgt = std::vector<int32_t>();
      og.vwgt = std::vector<int32_t>();
      levels[prev] = GraphView{nullptr, nullptr, nullptr, nullptr, 0};
    }
    cmaps.push_back(std::move(cmap));
    owned.push_back(std::move(cg));
    levels.push_back(owned.back().view());
    refinable.push_back(
        static_cast<int64_t>(owned.back().indices.size()) <= refine_cap);
  }
  std::vector<int32_t> p;
  if (warm) {
    // V-cycle: start from the projected partition — at this level each
    // node is a same-part fragment, so refinement moves fragments wholesale
    p = std::move(proj);
    refine(levels.back(), k, p, 32);
  } else {
    // multi-restart initial split: BFS growing AND label-prop clustering
    // (the latter wins when the graph has community structure); keep the
    // best refined cut
    int64_t best_cut = -1;
    for (int trial = 0; trial < 4; ++trial) {
      std::vector<int32_t> cand;
      if (trial < 2)
        lp_grow(levels.back(), k, seed + 1000003ULL * trial, cand);
      else
        bfs_grow(levels.back(), k, seed + 1000003ULL * trial, cand);
      refine(levels.back(), k, cand, 16);
      int64_t cut = cut_weight(levels.back(), cand);
      if (best_cut < 0 || cut < best_cut) {
        best_cut = cut;
        p = std::move(cand);
      }
    }
  }
  // if the coarsening loop exited via the matching-stall break, the
  // coarsest owned level may itself be over the refine cap; it was needed
  // for the initial partition above but nothing reads it past this point
  // — free it so the safety valve caps memory on that path too
  if (!owned.empty() && !refinable.back()) {
    Graph& og = owned.back();
    og.indptr = std::vector<int64_t>();
    og.indices = std::vector<int32_t>();
    og.ewgt = std::vector<int32_t>();
    og.vwgt = std::vector<int32_t>();
    levels.back() = GraphView{nullptr, nullptr, nullptr, nullptr, 0};
  }
  for (int64_t l = static_cast<int64_t>(cmaps.size()) - 1; l >= 0; --l) {
    const auto& cmap = cmaps[l];
    std::vector<int32_t> fine(cmap.size());
    for (size_t v = 0; v < cmap.size(); ++v) fine[v] = p[cmap[v]];
    p = std::move(fine);
    // over-cap levels were freed on the way down (their views are nulled):
    // project through without a refine step
    if (refinable[l]) refine(levels[l], k, p, 8);
  }
  return p;
}

}  // namespace part

void partition_kway(const int64_t* indptr, const int32_t* indices,
                    int64_t num_nodes, int32_t k, uint64_t seed,
                    int32_t* out_part) {
  // zero-copy view over the caller's CSR (weights implicit 1)
  part::GraphView g{indptr, indices, nullptr, nullptr, num_nodes};

  const bool dbg = std::getenv("FALCON_PART_DEBUG") != nullptr;
  auto now = [] { return std::chrono::steady_clock::now(); };
  auto t0 = now();
  auto lap = [&](const char* tag) {
    if (!dbg) return;
    auto t1 = now();
    fprintf(stderr, "[part] %s: %.2fs\n", tag,
            std::chrono::duration<double>(t1 - t0).count());
    t0 = t1;
  };
  std::vector<int32_t> p = part::ml_pass(g, k, seed, nullptr);
  lap("cold ml_pass");
  int64_t best = part::cut_weight(g, p);
  // V-cycles (METIS-style multilevel refinement): re-coarsen with matching
  // restricted to the current parts so the projected partition stays valid
  // at every level, then refine coarse-to-fine — coarse moves relocate
  // whole community fragments the node-at-a-time greedy is blind to.
  // Each cycle re-coarsens the full graph (the dominant cost at products
  // scale), so continue only while a cycle buys a real improvement (>1%):
  // community graphs converge in one cycle; expanders (RMAT) stop
  // immediately instead of paying 3 passes for refinement jitter.
  // no-structure guard: if the best cut is already near random ((k-1)/k of
  // the edges; 0.8 covers k >= 8), the graph is expander-like and V-cycles
  // cannot help — skip them instead of paying a full re-coarsening
  const int64_t total_ew = g.m();
  for (int cycle = 0; cycle < 2 && best < total_ew * 4 / 5; ++cycle) {
    std::vector<int32_t> cand =
        part::ml_pass(g, k, seed + 7919ULL * (cycle + 1), &p);
    lap("vcycle");
    int64_t cut = part::cut_weight(g, cand);
    if (cut < best) {
      bool meaningful = cut < best - best / 100;
      best = cut;
      p = std::move(cand);
      if (!meaningful) break;
    } else {
      break;
    }
  }
  std::copy(p.begin(), p.end(), out_part);
}

// ---------------------------------------------------------------------------
// R-MAT edge generation (Graph500-style power-law graphs) — the numpy
// version needs minutes at products scale; this is seconds.
// ---------------------------------------------------------------------------
void rmat_edges(int64_t num_nodes, int64_t num_edges, uint64_t seed,
                double a, double b, double c, int64_t* out_src,
                int64_t* out_dst) {
  int scale = 1;
  while ((1LL << scale) < num_nodes) ++scale;
  parallel_for(num_edges, [&](int64_t lo, int64_t hi) {
    XorShift128 rng(seed * 0x2545F4914F6CDD1Dull + static_cast<uint64_t>(lo) + 1);
    const double ab = a + b, abc = a + b + c;
    for (int64_t i = lo; i < hi; ++i) {
      int64_t s = 0, d = 0;
      for (int l = 0; l < scale; ++l) {
        const double r = (rng.next() >> 11) * (1.0 / 9007199254740992.0);
        int sb, db;
        if (r < a) { sb = 0; db = 0; }
        else if (r < ab) { sb = 0; db = 1; }
        else if (r < abc) { sb = 1; db = 0; }
        else { sb = 1; db = 1; }
        s = (s << 1) | sb;
        d = (d << 1) | db;
      }
      s %= num_nodes;
      d %= num_nodes;
      if (s == d) d = (d + 1) % num_nodes;  // no self loops
      out_src[i] = s;
      out_dst[i] = d;
    }
  });
}

// ---------------------------------------------------------------------------
// Degree computation & misc helpers
// ---------------------------------------------------------------------------
void out_degrees(const int64_t* indptr, int64_t num_nodes, int64_t* out) {
  parallel_for(num_nodes, [&](int64_t b, int64_t e) {
    for (int64_t v = b; v < e; ++v) out[v] = indptr[v + 1] - indptr[v];
  });
}

int falcon_native_version() { return 1; }

}  // extern "C"
