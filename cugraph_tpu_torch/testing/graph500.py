"""Graph500-style BFS parent-tree validation + TEPS accounting.

Mirrors the reference's graph500 harness
(cpp/tests/traversal/mg_graph500_bfs_test.cu): after each BFS it runs five
correctness checks over the (distance, predecessor) output —

  1. the starting vertex is its own parent            (`:784-817`)
  2. the parent pointers are acyclic                  (`:818-846`)
  3. distance(v) == distance(parent(v)) + 1           (`:847-882`)
  4. edge endpoints' distances are consistent         (`:883-923`)
  5. reachability matches the connected component     (`:924-944`)
  6. every (parent(v), v) is a real edge              (`:945-983`)

— and reports TEPS (traversed edges per second) with arithmetic and
harmonic means over the search keys (`:481-487,757-764,984-987`).

Everything here is host-side NumPy over the BFS OUTPUT (the validator must
not share code with the implementation under test).  Conventions follow the
C API: unreachable distance = 2**31-1, root/unreachable predecessor = -1
(bfs.pyx).  This module is the PyTorch port's own copy of
``cugraph_tpu.testing.graph500``, so that the port needs nothing of the JAX
package; the tests hold the two to the same verdicts.
"""

from __future__ import annotations

import numpy as np

__all__ = ["validate_bfs_tree", "validate_sssp_tree", "teps_summary"]

_UNREACHABLE = 2**31 - 1
_F32_MAX = np.float64(np.finfo(np.float32).max)


def _fail(ok, why):
    if not ok:
        raise AssertionError(f"graph500 BFS validation failed: {why}")
    return True


def validate_bfs_tree(src, dst, root, distances, predecessors, *,
                      directed=False, num_vertices=None, vertices=None):
    """Validate one BFS (distance, predecessor) tree against the edge list.

    ``src``/``dst`` are the graph's edges in the SAME id space as the BFS
    output (external ids); for an undirected graph pass each edge once in
    either orientation.  ``distances``/``predecessors`` are indexed by
    vertex id 0..n-1, or aligned with ``vertices`` when the id space is
    non-contiguous.  Raises AssertionError naming the violated rule;
    returns True when all checks pass.
    """
    src = np.asarray(src).astype(np.int64, copy=False)
    dst = np.asarray(dst).astype(np.int64, copy=False)
    dist = np.asarray(distances).astype(np.int64, copy=False)
    pred = np.asarray(predecessors).astype(np.int64, copy=False)
    root = int(root)
    if vertices is not None:
        # renumber an arbitrary external id space to positions
        ids = np.asarray(vertices).astype(np.int64, copy=False)
        order = np.argsort(ids, kind="stable")
        ids_sorted = ids[order]
        dist, pred = dist[order], pred[order]

        def _pos(x):
            p = np.searchsorted(ids_sorted, x)
            ok = (p < len(ids_sorted)) & (ids_sorted[np.minimum(
                p, len(ids_sorted) - 1)] == x)
            _fail(bool(np.all(ok)), "id outside the vertices array")
            return p

        src, dst, root = _pos(src), _pos(dst), int(_pos(np.int64(root)))
        keep = pred >= 0
        newpred = np.full(len(pred), -1, np.int64)
        newpred[keep] = _pos(pred[keep])
        pred = newpred
    n = int(num_vertices if num_vertices is not None else len(dist))

    reach = dist < _UNREACHABLE
    _fail(bool(reach[root]) and dist[root] == 0,
          f"root {root} must have distance 0")
    # 1. starting vertex's parent: itself, or the -1 sentinel convention
    _fail(pred[root] in (root, -1), "root's predecessor must be itself/-1")

    has_parent = reach & (pred >= 0)
    nonroot = reach.copy()
    nonroot[root] = False
    _fail(bool(np.all(has_parent[nonroot])),
          "every reached non-root vertex needs a predecessor")
    _fail(bool(np.all(pred[~reach] == -1)),
          "unreachable vertices must have predecessor -1")

    v = np.flatnonzero(nonroot)
    p = pred[v]
    _fail(bool(np.all((p >= 0) & (p < n))), "predecessor out of range")
    _fail(bool(np.all(reach[p])), "predecessor of a reached vertex unreached")
    # 3. distance(v) == distance(parent(v)) + 1 — this also implies 2.
    # (acyclicity): distances strictly decrease along any parent chain, so
    # no chain can revisit a vertex (the reference walks parents explicitly
    # at `:818`; the monotone-distance argument is equivalent)
    _fail(bool(np.all(dist[v] == dist[p] + 1)),
          "distance(v) != distance(parent(v)) + 1")

    # 4. edge endpoint distances; 5. component agreement
    su, sv = src, dst
    if directed:
        from_reach = reach[su]
        _fail(bool(np.all(reach[sv][from_reach])),
              "edge from a reached vertex to an unreached one")
        _fail(bool(np.all(dist[sv][from_reach] <= dist[su][from_reach] + 1)),
              "edge (u,v) with distance(v) > distance(u) + 1")
    else:
        _fail(bool(np.all(reach[su] == reach[sv])),
              "undirected edge with exactly one endpoint reached "
              "(BFS must cover the root's whole component)")
        both = reach[su]
        _fail(bool(np.all(np.abs(dist[su][both] - dist[sv][both]) <= 1)),
              "undirected edge endpoints' distances differ by more than 1")

    # 6. (parent(v), v) edges exist in the graph
    key = su * n + sv
    if not directed:
        key = np.concatenate([key, sv * n + su])
    key = np.sort(key)
    want = p * n + v
    found = np.searchsorted(key, want)
    found = (found < len(key)) & (key[np.minimum(found, len(key) - 1)] == want)
    _fail(bool(np.all(found)), "(parent(v), v) is not an edge of the graph")
    return True


def validate_sssp_tree(src, dst, weight, root, distances, predecessors, *,
                       directed=False, vertices=None, rtol=1e-4, atol=1e-5):
    """Validate one SSSP (distance, predecessor) tree against the weighted
    edge list — the weighted twin of ``validate_bfs_tree``, mirroring
    cpp/tests/traversal/mg_graph500_sssp_test.cu:763-1073:

      1. the starting vertex is its own parent              (`:763-780`)
      2. the parent pointers backtrace to the root          (`:790-808`)
      3. distance(v) == distance(parent(v)) + w(parent, v)  (`:819-968`)
      4. every edge (u,v) obeys dist(v) <= dist(u) + w      (`:982-1008`)
      5. reachability matches the connected component       (`:1026-1036`)
      6. every (parent(v), v) is a real edge                (`:1047-1073`)

    Unreachable distance = FLT_MAX (the sssp C-API convention); predecessor
    sentinel = -1.  Distance comparisons use rtol/atol (f32 accumulation).
    """
    src = np.asarray(src).astype(np.int64, copy=False)
    dst = np.asarray(dst).astype(np.int64, copy=False)
    w = np.asarray(weight).astype(np.float64, copy=False)
    dist = np.asarray(distances).astype(np.float64, copy=False)
    pred = np.asarray(predecessors).astype(np.int64, copy=False)
    root = int(root)
    if vertices is not None:
        ids = np.asarray(vertices).astype(np.int64, copy=False)
        order = np.argsort(ids, kind="stable")
        ids_sorted = ids[order]
        dist, pred = dist[order], pred[order]

        def _pos(x):
            p = np.searchsorted(ids_sorted, x)
            ok = (p < len(ids_sorted)) & (ids_sorted[np.minimum(
                p, len(ids_sorted) - 1)] == x)
            _fail(bool(np.all(ok)), "id outside the vertices array")
            return p

        src, dst, root = _pos(src), _pos(dst), int(_pos(np.int64(root)))
        keep = pred >= 0
        newpred = np.full(len(pred), -1, np.int64)
        newpred[keep] = _pos(pred[keep])
        pred = newpred
    n = len(dist)
    _fail(bool(np.all(w >= 0)), "SSSP validation requires nonneg weights")

    reach = dist < _F32_MAX
    _fail(bool(reach[root]) and dist[root] == 0,
          f"root {root} must have distance 0")
    _fail(pred[root] in (root, -1), "root's predecessor must be itself/-1")

    has_parent = reach & (pred >= 0)
    nonroot = reach.copy()
    nonroot[root] = False
    _fail(bool(np.all(has_parent[nonroot])),
          "every reached non-root vertex needs a predecessor")
    _fail(bool(np.all(pred[~reach] == -1)),
          "unreachable vertices must have predecessor -1")

    v = np.flatnonzero(nonroot)
    p = pred[v]
    _fail(bool(np.all((p >= 0) & (p < n))), "predecessor out of range")
    _fail(bool(np.all(reach[p])), "predecessor of a reached vertex unreached")

    # 2. explicit backtrace by pointer doubling (zero-weight edges defeat
    # the monotone-distance shortcut BFS can use; the reference jumps
    # parent→parent's-parent the same way, `:790-808`)
    par = np.arange(n, dtype=np.int64)
    par[v] = p
    for _ in range(max(1, int(np.ceil(np.log2(max(n, 2))))) + 1):
        par = par[par]
    _fail(bool(np.all(par[reach] == root)),
          "parent chain does not backtrace to the root (cycle)")

    # sorted (u, v) edge keys with weights — covers rules 3 and 6
    key = src * n + dst
    kw = w
    if not directed:
        key = np.concatenate([key, dst * n + src])
        kw = np.concatenate([kw, w])
    order = np.argsort(key, kind="stable")
    key, kw = key[order], kw[order]
    want = p * n + v
    lo = np.searchsorted(key, want, side="left")
    hi = np.searchsorted(key, want, side="right")
    _fail(bool(np.all(hi > lo)), "(parent(v), v) is not an edge of the graph")
    # 3. some parallel edge (parent, v) must realize the distance step; the
    # tree is acyclic because dist strictly increases along w>0 tree edges
    # and zero-weight chains still ground out at rule 4's global optimality
    need = dist[v] - dist[p]
    ok3 = np.zeros(len(v), bool)
    pend = np.arange(len(v))
    off = 0
    while len(pend):
        cur = lo[pend] + off
        alive = cur < hi[pend]
        pend = pend[alive]
        if not len(pend):
            break
        cur = cur[alive]
        ok3[pend] |= np.abs(kw[cur] - need[pend]) <= (
            atol + rtol * np.abs(dist[v[pend]]))
        pend = pend[~ok3[pend]]
        off += 1
    _fail(bool(np.all(ok3)),
          "distance(v) != distance(parent(v)) + w(parent, v)")

    # 4. relaxed-edge optimality; 5. component agreement
    def _relaxed(u, t):
        tol = atol + rtol * np.abs(dist[u])
        return dist[t] <= dist[u] + w + tol

    if directed:
        fr = reach[src]
        _fail(bool(np.all(reach[dst][fr])),
              "edge from a reached vertex to an unreached one")
        _fail(bool(np.all(_relaxed(src, dst)[fr])),
              "edge (u,v) with distance(v) > distance(u) + w")
    else:
        _fail(bool(np.all(reach[src] == reach[dst])),
              "undirected edge with exactly one endpoint reached")
        both = reach[src]
        _fail(bool(np.all(_relaxed(src, dst)[both])
                   and np.all(_relaxed(dst, src)[both])),
              "edge (u,v) with distance(v) > distance(u) + w")
    return True


def teps_summary(traversed_edges, seconds):
    """Arithmetic + harmonic mean TEPS over the per-root runs
    (mg_graph500_bfs_test.cu:984-987 prints both; graph500 reports the
    harmonic mean as the headline)."""
    te = np.asarray(traversed_edges, np.float64)
    t = np.asarray(seconds, np.float64)
    teps = te / t
    return {
        "teps_arithmetic_mean": float(np.mean(teps)),
        "teps_harmonic_mean": float(len(teps) / np.sum(1.0 / teps)),
        "num_search_keys": int(len(teps)),
    }
