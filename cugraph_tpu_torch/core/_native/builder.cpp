// Host engines of the port's graph construction and core peel.
//
// A copy, function for function and byte for byte, of the parts of
// cugraph_tpu/core/_native/builder.cpp that cugraph_tpu_torch calls:
// mix64, renumber_edgelist64, rmat_edgelist, core_number_peel and
// dedupe_edges.  Construction and the exact core peel are host work on the
// card too: the device consumes the compressed graph.  Built with g++ at
// first use by cugraph_tpu_torch/core/native.py and loaded with ctypes.

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

}  // extern "C"
