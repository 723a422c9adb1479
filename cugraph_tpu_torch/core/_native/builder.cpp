// Host engines of the port's graph construction, core peel and community
// detection.
//
// A copy, function for function and byte for byte, of the parts of
// cugraph_tpu/core/_native/builder.cpp that cugraph_tpu_torch calls:
// mix64, renumber_edgelist64, rmat_edgelist, core_number_peel,
// dedupe_edges, louvain_sweep, leiden_refine_sweep, coarsen_edges and
// triangle_support.  Construction, the exact core peel, the Louvain/Leiden
// sweeps and the triangle wedge engine are host work on the card too: the
// device consumes the compressed graph.  Built with g++ at first use by
// cugraph_tpu_torch/core/native.py and loaded with ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {
static inline uint64_t mix64(uint64_t z) {
  z ^= z >> 30; z *= 0xBF58476D1CE4E5B9ull;
  z ^= z >> 27; z *= 0x94D049BB133111EBull;
  z ^= z >> 31;
  return z;
}
}  // namespace

extern "C" {

// Renumber: map arbitrary int64 vertex ids to dense [0, n) ids.
// Two-pass radix-hash: returns number of unique ids, fills id arrays.
// unique_out must have capacity m*2 (worst case); src_out/dst_out size m.
int64_t renumber_edgelist64(const int64_t* src, const int64_t* dst, int64_t m,
                            int64_t* unique_out, int32_t* src_out,
                            int32_t* dst_out) {
  // open-addressing hash table sized to next pow2 ≥ 4m
  int64_t cap = 4;
  while (cap < 2 * m + 1) cap <<= 1;
  std::vector<int64_t> keys(cap, INT64_MIN);
  std::vector<int32_t> vals(cap, -1);
  int64_t n = 0;
  int32_t min_sentinel_id = -1;  // INT64_MIN collides with the empty-slot
  //                                marker; intern it out-of-table
  auto intern = [&](int64_t k) -> int32_t {
    if (k == INT64_MIN) {
      if (min_sentinel_id < 0) {
        min_sentinel_id = (int32_t)n;
        unique_out[n++] = k;
      }
      return min_sentinel_id;
    }
    uint64_t h = (uint64_t)k * 0x9E3779B97F4A7C15ull;
    int64_t i = (int64_t)(h & (uint64_t)(cap - 1));
    while (true) {
      if (keys[i] == k) return vals[i];
      if (keys[i] == INT64_MIN) {
        keys[i] = k;
        vals[i] = (int32_t)n;
        unique_out[n++] = k;
        return vals[i];
      }
      i = (i + 1) & (cap - 1);
    }
  };
  for (int64_t e = 0; e < m; ++e) {
    src_out[e] = intern(src[e]);
    dst_out[e] = intern(dst[e]);
  }
  return n;
}



// ---------------------------------------------------------------------------
// R-MAT edge generation (generators/rmat._rmat_host hot path; reference
// cpp/src/generators/generate_rmat_edgelist.cuh).  Counter-based RNG: one
// splitmix64-finalized hash per (seed, edge, bit), so generation is
// order-independent and embarrassingly parallel across threads, and the
// NumPy fallback reproduces it bit-for-bit (tests/test_native.py).
// Quadrant semantics: a single uniform u per bit picks the quadrant jointly
// (u < a: (0,0); < a+b: (0,1); < a+b+c: (1,0); else (1,1)).
// ---------------------------------------------------------------------------

void rmat_edgelist(int64_t scale, int64_t m, double a, double b, double c,
                   uint64_t seed, int clip_and_flip, int n_threads,
                   int32_t* src_out, int32_t* dst_out) {
  const double ab = a + b, abc = a + b + c;
  const uint64_t s0 = seed * 0xD6E8FEB86659FD93ull;
  auto run = [&](int64_t lo, int64_t hi) {
    for (int64_t e = lo; e < hi; ++e) {
      const uint64_t ze = s0 + (uint64_t)e * 0x9E3779B97F4A7C15ull;
      int64_t s = 0, d = 0;
      for (int64_t bit = 0; bit < scale; ++bit) {
        uint64_t z = mix64(ze + (uint64_t)bit * 0xC2B2AE3D27D4EB4Full);
        double u = (double)(z >> 11) * 0x1.0p-53;
        int sb = u >= ab;
        int db = u >= (sb ? abc : a);
        s = (s << 1) | sb;
        d = (d << 1) | db;
      }
      if (clip_and_flip && d < s) { int64_t t = s; s = d; d = t; }
      src_out[e] = (int32_t)s;
      dst_out[e] = (int32_t)d;
    }
  };
  if (n_threads <= 1 || m < (1 << 16)) {
    run(0, m);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (m + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(m, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back(run, lo, hi);
  }
  for (auto& th : ts) th.join();
}



// Exact k-core peeling (Batagelj–Zaversnik bin sort, O(V+E); host analog
// of the Pallas peel in algos/cores.py; reference cores/core_number_impl.cuh
// frontier-bucket peeling).  deg_init holds the per-vertex degrees of the
// chosen degree_type; (row_off, adj) is the adjacency whose entries lose a
// degree when a vertex is removed (the same matrix for undirected graphs,
// the out-adjacency for incoming peeling, the in-adjacency for outgoing).
// Simple-graph precondition (no parallel edges in adj).
int core_number_peel(const int64_t* row_off, const int32_t* adj, int64_t n,
                     const int64_t* deg_init, int32_t* core_out) {
  if (n == 0) return 0;
  std::vector<int64_t> deg(deg_init, deg_init + n);
  int64_t md = 0;
  for (int64_t v = 0; v < n; ++v) md = std::max(md, deg[v]);
  std::vector<int64_t> bin(md + 2, 0), pos(n), vert(n);
  for (int64_t v = 0; v < n; ++v) bin[deg[v] + 1]++;
  for (int64_t d = 0; d <= md; ++d) bin[d + 1] += bin[d];
  std::vector<int64_t> cur(bin.begin(), bin.end() - 1);
  for (int64_t v = 0; v < n; ++v) {
    pos[v] = cur[deg[v]]++;
    vert[pos[v]] = v;
  }
  for (int64_t i = 0; i < n; ++i) {
    const int64_t v = vert[i];
    core_out[v] = (int32_t)deg[v];
    for (int64_t e = row_off[v]; e < row_off[v + 1]; ++e) {
      const int64_t u = adj[e];
      if (u == v || deg[u] <= deg[v]) continue;
      const int64_t du = deg[u], pu = pos[u], pw = bin[du], w = vert[pw];
      if (u != w) {
        vert[pu] = w;
        vert[pw] = u;
        pos[u] = pw;
        pos[w] = pu;
      }
      bin[du]++;
      deg[u]--;
    }
  }
  return 0;
}

// Duplicate-edge coalescing (host analog of core/preprocess.py
// remove_multi_edges; reference structure/remove_multi_edges_impl.cuh).
// Two stable counting sorts (by dst, then src) group duplicate pairs with
// ORIGINAL order preserved inside each run; per run the first original
// index is emitted (key order) plus, for modes > 0, the reduced weight
// (1 = sum, 2 = min, 3 = max).  Returns the unique-pair count.
int64_t dedupe_edges(const int32_t* src, const int32_t* dst, const float* w,
                     int64_t m, int64_t n, int mode, int64_t* keep_idx_out,
                     float* w_out) {
  if (m == 0) return 0;
  std::vector<int64_t> cnt(n + 1, 0);
  for (int64_t e = 0; e < m; ++e) cnt[dst[e] + 1]++;
  for (int64_t v = 0; v < n; ++v) cnt[v + 1] += cnt[v];
  std::vector<int64_t> ord1(m), cur(cnt.begin(), cnt.end() - 1);
  for (int64_t e = 0; e < m; ++e) ord1[cur[dst[e]]++] = e;
  std::fill(cnt.begin(), cnt.end(), 0);
  for (int64_t e = 0; e < m; ++e) cnt[src[e] + 1]++;
  for (int64_t v = 0; v < n; ++v) cnt[v + 1] += cnt[v];
  cur.assign(cnt.begin(), cnt.end() - 1);
  std::vector<int64_t> ord(m);
  for (int64_t i = 0; i < m; ++i) {
    int64_t e = ord1[i];
    ord[cur[src[e]]++] = e;
  }
  int64_t out = -1;
  int32_t ps = -1, pd = -1;
  double acc = 0.0;
  for (int64_t i = 0; i < m; ++i) {
    int64_t e = ord[i];
    if (src[e] != ps || dst[e] != pd) {
      if (out >= 0 && mode) w_out[out] = (float)acc;
      ++out;
      ps = src[e];
      pd = dst[e];
      keep_idx_out[out] = e;
      acc = mode == 2 ? HUGE_VAL : (mode == 3 ? -HUGE_VAL : 0.0);
    }
    if (mode == 1) acc += w ? w[e] : 1.0;
    else if (mode == 2) acc = std::min(acc, (double)(w ? w[e] : 1.0f));
    else if (mode == 3) acc = std::max(acc, (double)(w ? w[e] : 1.0f));
  }
  if (out >= 0 && mode) w_out[out] = (float)acc;
  return out + 1;
}


// One parallel Louvain local-moving sweep (threaded host analog of
// algos/community._louvain_move_sweep; reference
// community/detail/common_methods.cuh:340 update_by_delta_modularity).
// Inputs: COO sorted by src with row offsets (so each vertex's out-edges
// are contiguous), a cluster snapshot, and the sweep direction flag (the
// reference's up/down oscillation control).  All moves are evaluated
// against the SNAPSHOT (parallel-sweep semantics, matching the jitted
// XLA version); per-vertex neighbor-cluster aggregation sorts the row's
// cluster ids (no hash maps).  Returns 0; new_cluster[v] holds the result.
// ``rank`` (optional, may be NULL = identity) relabels the id ORDER used
// by the up/down direction filter and tie-breaking — running the sweep
// with a random rank is exactly the ensemble-diversity permutation of the
// reference's ECG without rebuilding/resorting the graph.
int louvain_sweep(const int32_t* dst, const float* w, int64_t m,
                  int64_t n, const int64_t* row_off,
                  const int32_t* cluster, const int32_t* rank, int up_down,
                  double resolution, int n_threads, int32_t* new_cluster) {
  std::vector<double> k(n, 0.0);
  for (int64_t v = 0; v < n; ++v)
    for (int64_t e = row_off[v]; e < row_off[v + 1]; ++e) k[v] += w[e];
  std::vector<double> sigma(n, 0.0);
  double m2 = 0.0;
  for (int64_t v = 0; v < n; ++v) { sigma[cluster[v]] += k[v]; m2 += k[v]; }
  if (m2 < 1e-30) m2 = 1e-30;
  const double inv_m2 = 1.0 / m2;

  int T = n_threads < 1 ? 1 : n_threads;
  if (m < (1 << 15)) T = 1;
  // balance threads by edge count
  auto run = [&](int64_t vlo, int64_t vhi) {
    std::vector<std::pair<int32_t, float>> row;
    auto rk = [&](int32_t c) { return rank ? rank[c] : c; };
    for (int64_t v = vlo; v < vhi; ++v) {
      const int64_t lo = row_off[v], hi = row_off[v + 1];
      const int32_t cur = cluster[v];
      new_cluster[v] = cur;
      if (hi == lo) continue;
      row.clear();
      for (int64_t e = lo; e < hi; ++e) {
        if (dst[e] == (int32_t)v) continue;  // self-loops excluded from W
        row.push_back({cluster[dst[e]], w[e]});
      }
      std::sort(row.begin(), row.end(),
                [](const auto& a, const auto& b) { return a.first < b.first; });
      const double kv = k[v];
      const int32_t rcur = rk(cur);
      double w_stay = 0.0, best_gain = -1e30;
      int32_t best_c = INT32_MAX, best_r = INT32_MAX;
      size_t i = 0;
      while (i < row.size()) {
        const int32_t c = row[i].first;
        double W = 0.0;
        while (i < row.size() && row[i].first == c) W += row[i++].second;
        if (c == cur) { w_stay = W; continue; }
        const int32_t rc = rk(c);
        if (up_down ? rc <= rcur : rc >= rcur) continue;
        const double gain = W - resolution * kv * sigma[c] * inv_m2;
        if (gain > best_gain || (gain == best_gain && rc < best_r)) {
          best_gain = gain;
          best_c = c;
          best_r = rc;
        }
      }
      const double f_stay =
          w_stay - resolution * kv * (sigma[cur] - kv) * inv_m2;
      if (best_c != INT32_MAX && best_gain > f_stay + 1e-9)
        new_cluster[v] = best_c;
    }
  };
  if (T == 1) {
    run(0, n);
  } else {
    // split vertices so each thread gets ~equal edges
    std::vector<int64_t> bounds(T + 1, n);
    bounds[0] = 0;
    for (int t = 1; t < T; ++t) {
      int64_t target = m * t / T;
      bounds[t] = std::lower_bound(row_off, row_off + n + 1, target)
                  - row_off;
    }
    std::vector<std::thread> ts;
    for (int t = 0; t < T; ++t)
      if (bounds[t] < bounds[t + 1])
        ts.emplace_back(run, bounds[t], bounds[t + 1]);
    for (auto& th : ts) th.join();
  }
  return 0;
}

// One randomized Leiden refinement sweep (threaded host analog of
// algos/community._leiden_refine_sweep; reference
// community/detail/refine_impl.cuh:152).  Singleton vertices merge into
// smaller-id sub-communities WITHIN their community, targets sampled
// ∝ exp(gain/θ) via Gumbel-max with a counter RNG (splitmix64 per
// (seed, v, target) — deterministic, order-independent), gated on the
// Leiden well-connectedness conditions for vertex and target.  Decreasing
// pointer chains are path-compressed before returning.
int leiden_refine_sweep(const int32_t* dst, const float* w, int64_t m,
                        int64_t n, const int64_t* row_off,
                        const int32_t* comm, const int32_t* refined_in,
                        double theta, double resolution, uint64_t seed,
                        int n_threads, int32_t* refined_out) {
  std::vector<double> k(n, 0.0), K_C(n, 0.0), sigma_r(n, 0.0);
  std::vector<int64_t> cnt_r(n, 0);
  for (int64_t v = 0; v < n; ++v)
    for (int64_t e = row_off[v]; e < row_off[v + 1]; ++e) k[v] += w[e];
  double m2 = 0.0;
  for (int64_t v = 0; v < n; ++v) {
    K_C[comm[v]] += k[v];
    sigma_r[refined_in[v]] += k[v];
    cnt_r[refined_in[v]]++;
    m2 += k[v];
  }
  if (m2 < 1e-30) m2 = 1e-30;
  const double inv_m2 = 1.0 / m2;

  std::vector<double> cut_v(n, 0.0), cut_R(n, 0.0);
  for (int64_t v = 0; v < n; ++v)
    for (int64_t e = row_off[v]; e < row_off[v + 1]; ++e) {
      const int32_t d = dst[e];
      if (d == (int32_t)v || comm[d] != comm[v]) continue;
      cut_v[v] += w[e];
      if (refined_in[d] != refined_in[v]) cut_R[refined_in[v]] += w[e];
    }
  std::vector<uint8_t> wc_v(n), wc_R(n);
  for (int64_t v = 0; v < n; ++v)
    wc_v[v] = cut_v[v] >=
              resolution * k[v] * (K_C[comm[v]] - k[v]) * inv_m2;
  for (int64_t r = 0; r < n; ++r)
    wc_R[r] = cut_R[r] >=
              resolution * sigma_r[r] * (K_C[comm[r]] - sigma_r[r]) * inv_m2;

  const double inv_theta = 1.0 / (theta > 1e-6 ? theta : 1e-6);
  int T = n_threads < 1 ? 1 : n_threads;
  if (m < (1 << 15)) T = 1;
  auto run = [&](int64_t vlo, int64_t vhi) {
    std::vector<std::pair<int32_t, float>> row;
    for (int64_t v = vlo; v < vhi; ++v) {
      refined_out[v] = refined_in[v];
      if (refined_in[v] != (int32_t)v || cnt_r[v] > 1 || !wc_v[v]) continue;
      row.clear();
      for (int64_t e = row_off[v]; e < row_off[v + 1]; ++e) {
        const int32_t d = dst[e];
        if (d == (int32_t)v || comm[d] != comm[v]) continue;
        const int32_t r = refined_in[d];
        if (r >= (int32_t)v) continue;  // smaller-id targets only
        if (!wc_R[r]) continue;
        row.push_back({r, w[e]});
      }
      if (row.empty()) continue;
      std::sort(row.begin(), row.end(),
                [](const auto& a, const auto& b) { return a.first < b.first; });
      const double kv = k[v];
      double best = -1e30;
      int32_t best_c = INT32_MAX;
      size_t i = 0;
      while (i < row.size()) {
        const int32_t c = row[i].first;
        double W = 0.0;
        while (i < row.size() && row[i].first == c) W += row[i++].second;
        const double gain = W - resolution * kv * sigma_r[c] * inv_m2;
        if (gain <= 1e-12) continue;
        uint64_t z = mix64(seed ^ ((uint64_t)v * 0x9E3779B97F4A7C15ull)
                           ^ ((uint64_t)(uint32_t)c * 0xC2B2AE3D27D4EB4Full));
        double u = ((double)(z >> 11) + 0.5) * 0x1.0p-53;
        const double score = gain * inv_theta - std::log(-std::log(u));
        if (score > best || (score == best && c < best_c)) {
          best = score;
          best_c = c;
        }
      }
      if (best_c != INT32_MAX) refined_out[v] = best_c;
    }
  };
  if (T == 1) {
    run(0, n);
  } else {
    std::vector<int64_t> bounds(T + 1, n);
    bounds[0] = 0;
    for (int t = 1; t < T; ++t)
      bounds[t] = std::lower_bound(row_off, row_off + n + 1, m * t / T)
                  - row_off;
    std::vector<std::thread> ts;
    for (int t = 0; t < T; ++t)
      if (bounds[t] < bounds[t + 1])
        ts.emplace_back(run, bounds[t], bounds[t + 1]);
    for (auto& th : ts) th.join();
  }
  // path-compress decreasing pointer chains
  bool changed = true;
  while (changed) {
    changed = false;
    for (int64_t v = 0; v < n; ++v) {
      int32_t r = refined_out[refined_out[v]];
      if (r != refined_out[v]) {
        refined_out[v] = r;
        changed = true;
      }
    }
  }
  return 0;
}

// Cluster-contraction edge aggregation (host analog of
// algos/community._coarsen; reference structure/coarsen_graph_impl.cuh):
// edges relabeled to cluster ids arrive as (cs, cd, w); aggregate parallel
// edges by two stable counting sorts (by cd, then cs — O(m + nc)) and a
// run merge.  Outputs are src-sorted, ready for the next level's sweep
// without re-sorting.  Returns the aggregated edge count.
int64_t coarsen_edges(const int32_t* cs, const int32_t* cd, const float* w,
                      int64_t m, int64_t nc, int32_t* out_src,
                      int32_t* out_dst, float* out_w) {
  if (m == 0) return 0;
  std::vector<int64_t> cnt(nc + 1, 0);
  for (int64_t e = 0; e < m; ++e) cnt[cd[e] + 1]++;
  for (int64_t c = 0; c < nc; ++c) cnt[c + 1] += cnt[c];
  std::vector<int64_t> ord1(m), cur(cnt.begin(), cnt.end() - 1);
  for (int64_t e = 0; e < m; ++e) ord1[cur[cd[e]]++] = e;
  std::fill(cnt.begin(), cnt.end(), 0);
  for (int64_t e = 0; e < m; ++e) cnt[cs[e] + 1]++;
  for (int64_t c = 0; c < nc; ++c) cnt[c + 1] += cnt[c];
  cur.assign(cnt.begin(), cnt.end() - 1);
  std::vector<int64_t> ord(m);
  for (int64_t i = 0; i < m; ++i) {
    int64_t e = ord1[i];
    ord[cur[cs[e]]++] = e;
  }
  int64_t out = -1;
  int32_t ps = -1, pd = -1;
  double acc = 0.0;
  for (int64_t i = 0; i < m; ++i) {
    int64_t e = ord[i];
    if (cs[e] != ps || cd[e] != pd) {
      if (out >= 0) out_w[out] = (float)acc;
      ++out;
      ps = cs[e];
      pd = cd[e];
      out_src[out] = ps;
      out_dst[out] = pd;
      acc = 0.0;
    }
    acc += w[e];
  }
  out_w[out] = (float)acc;
  return out + 1;
}

// Degree-oriented wedge triangle engine (threaded host analog of
// algos/_oriented_tri.py; reference community/triangle_count_impl.cuh:124
// orientation).  Inputs: UNIQUE undirected edges (u[i], v[i]) with no self
// loops, any per-pair order.  Outputs: tri int64[n] per-vertex counts and,
// when need_support, sup int64[M] per-input-edge triangle counts.
// Returns 0 on success, -1 on bad args.
int triangle_support(const int64_t* u, const int64_t* v, int64_t M,
                     int64_t n, int need_support, int n_threads,
                     int64_t* tri_out, int64_t* sup_out) {
  if (M < 0 || n < 0 || (need_support && sup_out == nullptr)) return -1;
  std::memset(tri_out, 0, sizeof(int64_t) * (size_t)n);
  if (need_support) std::memset(sup_out, 0, sizeof(int64_t) * (size_t)M);
  if (M == 0 || n == 0) return 0;

  // rank by (degree, id): counting degree + stable index sort
  std::vector<int64_t> deg(n, 0);
  for (int64_t e = 0; e < M; ++e) { deg[u[e]]++; deg[v[e]]++; }
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int64_t x, int64_t y) {
    return deg[x] != deg[y] ? deg[x] < deg[y] : x < y;
  });
  std::vector<int64_t> rk(n);
  for (int64_t i = 0; i < n; ++i) rk[order[i]] = i;

  // oriented CSR (low rank -> high rank) carrying the input edge id;
  // rows sorted by neighbor RANK so wedge slots j > i imply rk[w] > rk[b]
  std::vector<int64_t> dplus(n, 0);
  for (int64_t e = 0; e < M; ++e)
    dplus[rk[u[e]] < rk[v[e]] ? u[e] : v[e]]++;
  std::vector<int64_t> off(n + 1, 0);
  for (int64_t i = 0; i < n; ++i) off[i + 1] = off[i] + dplus[i];
  std::vector<int64_t> nbr(M), eid(M), cur(off.begin(), off.end() - 1);
  for (int64_t e = 0; e < M; ++e) {
    int64_t a = u[e], b = v[e];
    if (rk[a] > rk[b]) std::swap(a, b);
    int64_t p = cur[a]++;
    nbr[p] = b;
    eid[p] = e;
  }
  for (int64_t a = 0; a < n; ++a) {
    int64_t lo = off[a], hi = off[a + 1];
    // sort (nbr, eid) of the row by rank of nbr
    std::vector<std::pair<int64_t, int64_t>> row;
    row.reserve(hi - lo);
    for (int64_t p = lo; p < hi; ++p) row.push_back({rk[nbr[p]], p});
    std::sort(row.begin(), row.end());
    std::vector<int64_t> tn(hi - lo), te(hi - lo);
    for (size_t k = 0; k < row.size(); ++k) {
      tn[k] = nbr[row[k].second];
      te[k] = eid[row[k].second];
    }
    std::copy(tn.begin(), tn.end(), nbr.begin() + lo);
    std::copy(te.begin(), te.end(), eid.begin() + lo);
  }

  // balance threads by wedge count C(d+, 2)
  int T = n_threads < 1 ? 1 : n_threads;
  std::vector<int64_t> wcum(n + 1, 0);
  for (int64_t a = 0; a < n; ++a)
    wcum[a + 1] = wcum[a] + dplus[a] * (dplus[a] - 1) / 2;
  const int64_t total_w = wcum[n];
  if (total_w < (1 << 14)) T = 1;

  std::vector<std::vector<int64_t>> tri_loc(T), sup_loc(T);
  auto run = [&](int t) {
    int64_t wlo = total_w * t / T, whi = total_w * (t + 1) / T;
    int64_t a0 = std::upper_bound(wcum.begin(), wcum.end(), wlo)
                 - wcum.begin() - 1;
    int64_t a1 = std::upper_bound(wcum.begin(), wcum.end(), whi)
                 - wcum.begin() - 1;
    if (t == T - 1) a1 = n;
    auto& tri = tri_loc[t];
    tri.assign(n, 0);
    auto& sup = sup_loc[t];
    if (need_support) sup.assign(M, 0);
    for (int64_t a = a0; a < a1; ++a) {
      int64_t lo = off[a], hi = off[a + 1];
      for (int64_t i = lo; i < hi; ++i) {
        int64_t b = nbr[i];
        int64_t blo = off[b], bhi = off[b + 1];
        for (int64_t j = i + 1; j < hi; ++j) {
          int64_t w = nbr[j];
          // binary search rk[w] in row b (sorted by rank)
          int64_t lw = blo, hw = bhi;
          const int64_t rw = rk[w];
          while (lw < hw) {
            int64_t mid = (lw + hw) >> 1;
            if (rk[nbr[mid]] < rw) lw = mid + 1; else hw = mid;
          }
          if (lw < bhi && nbr[lw] == w) {
            tri[a]++; tri[b]++; tri[w]++;
            if (need_support) {
              sup[eid[i]]++; sup[eid[j]]++; sup[eid[lw]]++;
            }
          }
        }
      }
    }
  };
  if (T == 1) {
    run(0);
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < T; ++t) ts.emplace_back(run, t);
    for (auto& th : ts) th.join();
  }
  for (int t = 0; t < T; ++t) {
    for (int64_t i = 0; i < n; ++i) tri_out[i] += tri_loc[t][i];
    if (need_support)
      for (int64_t e = 0; e < M; ++e) sup_out[e] += sup_loc[t][e];
  }
  return 0;
}

}  // extern "C"
