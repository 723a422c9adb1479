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

from typing import NamedTuple

import numpy as np

__all__ = ["validate_bfs_tree", "validate_sssp_tree", "teps_summary"]

_UNREACHABLE = 2**31 - 1
_F32_MAX = np.float64(np.finfo(np.float32).max)


def _fail(ok, why):
    if not ok:
        raise AssertionError(f"graph500 BFS validation failed: {why}")
    return True


class _Edges(NamedTuple):
    """An edge list prepared once for the trees of many roots: endpoints
    as positions 0..n-1, the (u, v) keys u·n + v sorted (both orientations
    when undirected) and, for SSSP, the weights in key order."""

    src: np.ndarray
    dst: np.ndarray
    key: np.ndarray
    n: int
    ids: np.ndarray | None      # vertices sorted, where ids are not positions
    order: np.ndarray | None    # the stable argsort that sorts them
    weight: np.ndarray | None = None
    key_weight: np.ndarray | None = None


def _position(ids_sorted, x):
    """The index of each id ``x`` in ``ids_sorted``; fails when one is
    missing.  Distinct non-negative ids below 4·len + 1,024 (the common
    case: ids near 0..n-1) are looked up in a dense table, which is many
    times faster than a binary search for millions of endpoints; the
    indices are the same."""
    n = len(ids_sorted)
    if n and ids_sorted[0] >= 0 and ids_sorted[-1] < 4 * n + 1024 \
            and bool(np.all(ids_sorted[1:] > ids_sorted[:-1])):
        top = int(ids_sorted[-1])
        table = np.full(top + 2, -1, np.int64)
        table[ids_sorted] = np.arange(n)
        p = table[np.where((x >= 0) & (x <= top), x, top + 1)]
        _fail(bool(np.all(p >= 0)), "id outside the vertices array")
        return p
    p = np.searchsorted(ids_sorted, x)
    ok = (p < n) & (ids_sorted[np.minimum(p, n - 1)] == x)
    _fail(bool(np.all(ok)), "id outside the vertices array")
    return p


def _endpoints(src, dst, vertices):
    """(src, dst, ids, order): positions, and the sorted id space and its
    argsort when ``vertices`` names a non-contiguous one."""
    src = np.asarray(src).astype(np.int64, copy=False)
    dst = np.asarray(dst).astype(np.int64, copy=False)
    if vertices is None:
        return src, dst, None, None
    ids = np.asarray(vertices).astype(np.int64, copy=False)
    order = np.argsort(ids, kind="stable")
    ids = ids[order]
    return _position(ids, src), _position(ids, dst), ids, order


def _bfs_edges(src, dst, n, *, directed=False, vertices=None) -> _Edges:
    """The edge list of ``validate_bfs_tree``, prepared for ``_check_bfs``:
    one sort of the keys for every root."""
    src, dst, ids, order = _endpoints(src, dst, vertices)
    key = src * n + dst
    if not directed:
        key = np.concatenate([key, dst * n + src])
    return _Edges(src, dst, np.sort(key), int(n), ids, order)


def _sssp_edges(src, dst, weight, n, *, directed=False,
                vertices=None) -> _Edges:
    """The edge list of ``validate_sssp_tree``, prepared for
    ``_check_sssp``: one stable sort of the keys, weights alongside."""
    src, dst, ids, order = _endpoints(src, dst, vertices)
    w = np.asarray(weight).astype(np.float64, copy=False)
    key, kw = src * n + dst, w
    if not directed:
        key = np.concatenate([key, dst * n + src])
        kw = np.concatenate([kw, w])
    by_key = np.argsort(key, kind="stable")
    return _Edges(src, dst, key[by_key], int(n), ids, order, w, kw[by_key])


def _tree(edges: _Edges, root, distances, predecessors, dist_dtype):
    """(root, dist, pred) in positions, in the edge list's id space."""
    dist = np.asarray(distances).astype(dist_dtype, copy=False)
    pred = np.asarray(predecessors).astype(np.int64, copy=False)
    root = int(root)
    if edges.ids is not None:
        dist, pred = dist[edges.order], pred[edges.order]
        root = int(_position(edges.ids, np.int64(root)))
        keep = pred >= 0
        newpred = np.full(len(pred), -1, np.int64)
        newpred[keep] = _position(edges.ids, pred[keep])
        pred = newpred
    return root, dist, pred


def validate_bfs_tree(src, dst, root, distances, predecessors, *,
                      directed=False, num_vertices=None, vertices=None):
    """Validate one BFS (distance, predecessor) tree against the edge list.

    ``src``/``dst`` are the graph's edges in the SAME id space as the BFS
    output (external ids); for an undirected graph pass each edge once in
    either orientation.  ``distances``/``predecessors`` are indexed by
    vertex id 0..n-1, or aligned with ``vertices`` when the id space is
    non-contiguous.  Raises AssertionError naming the violated rule;
    returns True when all checks pass.  To check the trees of many roots
    over one edge list, prepare it once with ``_bfs_edges`` and call
    ``_check_bfs`` for each: the same checks in the same order.
    """
    n = int(num_vertices if num_vertices is not None else len(distances))
    edges = _bfs_edges(src, dst, n, directed=directed, vertices=vertices)
    return _check_bfs(edges, root, distances, predecessors,
                      directed=directed)


def _check_bfs(edges: _Edges, root, distances, predecessors, *,
               directed=False):
    """``validate_bfs_tree``'s checks of one tree over prepared edges."""
    root, dist, pred = _tree(edges, root, distances, predecessors, np.int64)
    n = edges.n

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
    su, sv = edges.src, edges.dst
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
    key = edges.key
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
    For the trees of many roots over one edge list, prepare it once with
    ``_sssp_edges`` and call ``_check_sssp`` for each.
    """
    edges = _sssp_edges(src, dst, weight, len(distances), directed=directed,
                        vertices=vertices)
    return _check_sssp(edges, root, distances, predecessors,
                       directed=directed, rtol=rtol, atol=atol)


def _check_sssp(edges: _Edges, root, distances, predecessors, *,
                directed=False, rtol=1e-4, atol=1e-5):
    """``validate_sssp_tree``'s checks of one tree over prepared edges."""
    root, dist, pred = _tree(edges, root, distances, predecessors,
                             np.float64)
    src, dst, w, n = edges.src, edges.dst, edges.weight, edges.n
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
    key, kw = edges.key, edges.key_weight
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
