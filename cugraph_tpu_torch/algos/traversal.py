"""Traversal: BFS, SSSP, k-hop neighbourhoods, BFS paths, and the
multi-source panels behind multi_source_bfs and od_shortest_distances.

Counterpart of ``cugraph_tpu.algos.traversal`` on its Pallas route
(reference bfs_impl.cuh:133-875, sssp_impl.cuh:571,
k_hop_nbrs_impl.cuh:220).  The heavy sweeps run in the hand-written
kernels: a dense BFS level is one K2 (max, left) launch over the CSC, a
dense SSSP relaxation one K2 (min, add) launch, and the predecessors of
either come from one K3 eqsel_rel launch after the loop: pred[v] is the
largest strictly closer in-neighbour u with dist[u] + w(u, v) == dist[v]
within a tolerance.  The JAX package drops "strictly closer", and on edges
lighter than the tolerance its parents can form cycles (its SSSP trees fail
the Graph500 validator on RMAT-16 with Graph500 weights); a vertex with no
strictly closer parent, reached over a zero weight, gets one on the host.  The sparse levels, a few thousand frontier vertices, gather
their out-edges in plain torch, as the JAX package leaves them to XLA.

The multi-source sweeps run 128 sources at once as [n, 128] panels
(reference od_shortest_distances_impl.cuh:426): a BFS level is one K4
launch over the CSC on the frontier masks, a Bellman-Ford round one K5
(min, add) launch; ``strategy="serial"`` runs one source at a time, one
K1 (mul) launch per level.

The JAX package picks each level's regime on the device inside
``lax.cond``.  Here the loop runs on the host, and each level reads back
one small tensor, the frontier's vertex count and out-edge count (SSSP adds
the pending count): one host sync per level, counted in ``LAST_RUN``.
Everything else in a level is queued without a sync; the sparse level
knows its sizes from that read-back.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from cugraph_tpu_torch.algos._utils import (normalize_start, panel_onehot,
                                            source_panels, unrenumber_column)
from cugraph_tpu_torch.core.structure import CsrMatrix
from cugraph_tpu_torch.kernels.semiring import BIG
from cugraph_tpu_torch.prims.frontier import frontier_expand_by_dst
from cugraph_tpu_torch.prims.vertex_edge import (select_by_major,
                                                 semiring_by_major,
                                                 spmm_by_major,
                                                 spmm_semiring_by_major,
                                                 spmv_pull)

INT32_INF = np.iinfo(np.int32).max
F32_INF = np.float32(np.finfo(np.float32).max)

# direction-optimizing caps (traversal.py:69-70 of the JAX package): a level
# goes top-down when the frontier has at most _TD_K vertices and at most
# _TD_E out-edges (the reference's m_f/m_u switch, bfs_impl.cuh:291-300)
_TD_K = 4096
_TD_E = 65536

# sssp calls whose K3 pass left a reached vertex without a parent, so that
# the host matcher ran instead (JAX traversal.py:479-481), since import
PRED_STRAGGLERS = 0
# what the last bfs, sssp, multi_source_bfs or od_shortest_distances call
# did: levels or iterations (by regime, or per panel), and host syncs
LAST_RUN: dict = {}


def _compact(mask: torch.Tensor, count: int) -> torch.Tensor:
    """The ids set in ``mask``, ascending, int64 [count], with no host sync:
    ``count`` is already known."""
    pos = torch.cumsum(mask, 0) - 1
    slot = torch.where(mask, pos, count)  # unset ids land in a spare slot
    out = torch.empty(count + 1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, slot, torch.arange(mask.shape[0], device=mask.device))
    return out[:count]


def _out_edges(csr: CsrMatrix, verts: torch.Tensor, num_edges: int):
    """(source vertex, edge position) of every out-edge of ``verts``,
    int64 [num_edges], with no host sync."""
    first = csr.offsets[verts].to(torch.int64)
    deg = csr.offsets[verts + 1].to(torch.int64) - first
    src = torch.repeat_interleave(verts, deg, output_size=num_edges)
    # each vertex's edges continue its CSR run from where its segment starts
    start = first - (torch.cumsum(deg, 0) - deg)
    eidx = torch.repeat_interleave(start, deg, output_size=num_edges) \
        + torch.arange(num_edges, device=verts.device)
    return src, eidx


def _counts(*tensors) -> list[int]:
    """Read several device scalars back in one sync."""
    return torch.stack([t.to(torch.int64) for t in tensors]).tolist()


# -- BFS --------------------------------------------------------------------

def _bfs_sparse_level(csr: CsrMatrix, mask, fcount, m_f, unvisited):
    """Top-down level: the frontier's out-edges, gathered and scattered."""
    _, eidx = _out_edges(csr, _compact(mask, fcount), m_f)
    dst = csr.indices[eidx].to(torch.int64)
    nxt = torch.zeros_like(mask)
    # every edge into one vertex carries the same value, so the scatter is
    # deterministic
    return nxt.scatter_(0, dst, unvisited[dst])


def _bfs_levels(g, source: int, depth_limit: int, stats: dict):
    """Direction-optimizing BFS (JAX ``_bfs_kernel_diropt``, :73-172);
    returns int32 distances, INT32_INF where unreached."""
    n = g.num_vertices
    deg = g.csr.degrees()
    dist = torch.full((n,), INT32_INF, dtype=torch.int32, device=g.device)
    dist[source] = 0
    mask = torch.zeros(n, dtype=torch.bool, device=g.device)
    mask[source] = True
    level = 0
    while level < depth_limit:
        fcount, m_f = _counts(mask.sum(), torch.where(mask, deg, 0).sum())
        stats["syncs"] += 1
        if fcount == 0:
            break
        unvisited = dist == INT32_INF
        if fcount <= _TD_K and m_f <= _TD_E:
            nxt = _bfs_sparse_level(g.csr, mask, fcount, m_f, unvisited)
            stats["sparse_levels"] += 1
        else:
            # the level's predecessors are dropped: one K3 pass recovers
            # them all after the loop, as on the JAX package's Pallas route
            nxt, _ = frontier_expand_by_dst(g, mask, unvisited)
            stats["dense_levels"] += 1
        dist = dist.masked_fill(nxt, level + 1)
        mask = nxt
        level += 1
    return dist


def bfs(G, start=None, depth_limit=None, source=None, return_distances=True,
        i_start=None, directed=None, return_predecessors=True):
    """BFS from ``start``; returns ['distance', 'vertex', 'predecessor'].

    Unreachable vertices get distance 2**31-1 and predecessor -1 (the
    reference C API).  A predecessor is the largest-id in-neighbour one
    level up."""
    if directed is not None:
        raise TypeError(
            "'directed' cannot be specified for a Graph-type input")
    if start is None:
        start = source if source is not None else i_start
    if start is None:
        raise ValueError("bfs requires a start vertex")
    s = int(normalize_start(G, start)[0])
    n = G.number_of_vertices()
    dl = int(depth_limit) if depth_limit is not None else n
    g = G.structure
    stats = {"algo": "bfs", "dense_levels": 0, "sparse_levels": 0,
             "syncs": 0}
    dist = _bfs_levels(g, s, dl, stats)
    if return_predecessors:
        # levels are integers, exact in f32 (unreached is 2^31); atol 0.25
        # is the JAX package's (:253)
        y = select_by_major(g.csc, dist.to(torch.float32), unit=True,
                            atol=0.25, rtol=0.0)
        good = (dist > 0) & (dist < INT32_INF) & (y >= 0)
        pred = torch.where(good, y, -1).cpu().numpy().astype(np.int64)
    else:  # the reference keeps the column and skips the work
        pred = np.full(n, -1, np.int64)
    LAST_RUN.clear()
    LAST_RUN.update(stats)
    return pd.DataFrame({
        "distance": dist.cpu().numpy(),
        "vertex": G.number_map.to_external(np.arange(n)),
        "predecessor": unrenumber_column(G, pred, sentinel=-1),
    })


# -- SSSP -------------------------------------------------------------------

def _sssp_nearfar(g, source: int, delta: np.float32, stats: dict):
    """Near/far delta-stepping (JAX ``_sssp_kernel_nearfar``, :274-387):
    a pending set and a moving threshold T; each iteration advances T,
    relaxes the active set's out-edges sparsely, or runs one dense K2
    (min, add) sweep.  Returns float32 distances, BIG where unreached."""
    n = g.num_vertices
    dev = g.device
    deg = g.csr.degrees()
    dist = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    dist[source] = 0.0
    pending = torch.zeros(n, dtype=torch.bool, device=dev)
    pending[source] = True
    delta_t = torch.tensor(delta, dtype=torch.float32, device=dev)
    T = torch.clamp(delta_t, min=1e-30)
    it = 0
    while it < 4 * n + 16:
        active = pending & (dist < T)
        n_pend, n_act, m_f = _counts(pending.sum(), active.sum(),
                                     torch.where(active, deg, 0).sum())
        stats["syncs"] += 1
        if n_pend == 0:
            break
        if n_act == 0:  # advance T past the nearest pending vertex
            T = torch.where(pending, dist, BIG).min() + delta_t
            stats["advances"] += 1
            it += 1
            continue
        if n_act <= _TD_K and m_f <= _TD_E:
            src, eidx = _out_edges(g.csr, _compact(active, n_act), m_f)
            cand = dist[src] + g.csr.weights[eidx]
            new = dist.scatter_reduce(0, g.csr.indices[eidx].to(torch.int64),
                                      cand, "amin", include_self=True)
            stats["sparse_iterations"] += 1
        else:
            x = torch.where(active, dist, BIG)
            new = torch.minimum(dist, semiring_by_major(g.csc, x, "min",
                                                        "add"))
            stats["dense_iterations"] += 1
        pending = (pending & ~active) | (new < dist)
        dist = new
        it += 1
    stats["iterations"] = it
    return dist


def _sssp_delta(G) -> float:
    """Reference delta heuristic (sssp_impl.cuh:233-247):
    delta = 32 · average_edge_weight / average_vertex_degree."""
    m = len(G.edgelist_arrays()[0])
    n = G.number_of_vertices()
    if m == 0 or n == 0:
        return 1.0
    avg_w = G.weight_summary()[1]  # computed once per graph
    d = 32.0 * avg_w / max(m / n, 1e-30)
    return d if d > 0 else 1.0


def _sssp_pred_host(G, dist32: np.ndarray, source: int, n: int) -> np.ndarray:
    """Predecessors from converged float32 distances on the host, for the
    vertices the K3 pass left without one: first the K3 test (the largest
    strictly closer in-neighbour u with |dist[u] + w - dist[v]| <= 1e-6 +
    2e-5·|dist[v]|); then, for a vertex reached only over a zero or
    sub-rounding weight (dist[u] == dist[v]), the largest such neighbour
    already in the tree, wave by wave, so that the parents stay a tree."""
    src, dst, w = G.edgelist_arrays()
    w = np.ones(len(src), np.float32) if w is None else w.astype(np.float32)
    ds = dist32[src]
    dd = dist32[dst]
    reach_e = (ds < F32_INF / 2) & (dd < F32_INF / 2)
    tol = 1e-6 + 2e-5 * np.abs(dd)
    match = reach_e & (np.abs(ds + w - dd) <= tol)
    pred = np.full(n, -1, np.int64)
    strict = match & (ds < dd)
    np.maximum.at(pred, dst[strict], src[strict])
    pred[source] = -1
    missing = (dist32[:n] < F32_INF / 2) & (pred < 0)
    missing[source] = False
    while missing.any():
        attach = match & ~missing[src] & missing[dst]
        if not attach.any():
            break
        np.maximum.at(pred, dst[attach], src[attach])
        missing = missing & (pred < 0)
    return pred


def sssp(G, source=None, method=None, directed=None,
         return_predecessors=None, unweighted=None, overwrite=None,
         indices=None, cutoff=None):
    """Single-source shortest paths (nonnegative weights).
    Returns ['distance', 'vertex', 'predecessor']; unreachable = FLT_MAX.
    ``directed``, ``unweighted``, ``overwrite`` and ``indices`` are the
    reference wrapper's legacy parameters."""
    global PRED_STRAGGLERS
    if directed is not None:
        raise TypeError(
            "'directed' cannot be specified for a Graph-type input")
    if method not in (None, "auto", "delta-stepping", "dijkstra", "bf"):
        raise ValueError(f"invalid sssp method: {method!r}")
    if source is None:
        source = indices  # legacy name
    if source is None:
        raise ValueError("sssp requires a source vertex")
    s = int(normalize_start(G, source)[0])
    n = G.number_of_vertices()
    if G.weight_summary()[0]:  # computed once per graph
        raise ValueError("sssp requires non-negative weights")
    g = G.structure
    stats = {"algo": "sssp", "advances": 0, "sparse_iterations": 0,
             "dense_iterations": 0, "syncs": 0}
    ddev = _sssp_nearfar(g, s, np.float32(_sssp_delta(G)), stats)
    # the forward sweeps are exact fp32, so the parent edge meets the test
    # with diff 0; the tolerances are the JAX package's (:468)
    y = select_by_major(g.csc, ddev, unit=False, atol=1e-6, rtol=2e-5)
    d32 = ddev.cpu().numpy()
    y = y.cpu().numpy()
    dist32 = np.where(d32 >= BIG / 2, F32_INF, d32).astype(np.float32)
    reached = dist32 < F32_INF / 2
    not_root = np.arange(n) != s
    good = reached & not_root & (y >= 0)
    pred = np.where(good, y, -1).astype(np.int64)
    if np.any(reached & not_root & ~good):
        PRED_STRAGGLERS += 1
        pred = _sssp_pred_host(G, dist32, s, n)
    dist = dist32.astype(np.float64)
    if cutoff is not None:
        over = dist > cutoff
        dist[over] = np.float64(F32_INF)
        pred[over] = -1
    LAST_RUN.clear()
    LAST_RUN.update(stats)
    return pd.DataFrame({
        "distance": dist,
        "vertex": G.number_map.to_external(np.arange(n)),
        "predecessor": unrenumber_column(G, pred, sentinel=-1),
    })


# -- the rest of the single-source surface ------------------------------------

def shortest_path_length(G, source, target=None):
    df = sssp(G, source) if G.is_weighted() else bfs(G, source)
    if target is not None:
        row = df[df["vertex"] == target]
        if row.empty:
            raise ValueError(f"target {target!r} not in graph")
        return float(row["distance"].iloc[0])
    return df[["vertex", "distance"]]


def filter_unreachable(df: pd.DataFrame) -> pd.DataFrame:
    """Drop the unreachable rows of a bfs or sssp frame."""
    d = df["distance"]
    if np.issubdtype(d.dtype, np.integer):
        return df[d != INT32_INF].reset_index(drop=True)
    return df[d < np.float64(F32_INF)].reset_index(drop=True)


def k_hop_neighbors(G, start, k: int):
    """The vertices within k hops of the start vertices, as a DataFrame
    ['vertex'].  The starts themselves are always excluded (the JAX
    package's contract, which diverges from the reference's exactly-k
    frontier, k_hop_nbrs_impl.cuh:220).  One K2 (max, left) launch over the
    CSC per hop."""
    g = G.structure
    n = G.number_of_vertices()
    seeds = normalize_start(G, start)
    reach = torch.zeros(n, dtype=torch.int32, device=g.device)
    reach[torch.as_tensor(seeds, dtype=torch.int64, device=g.device)] = 1
    for _ in range(int(k)):
        reach = torch.where(semiring_by_major(g.csc, reach, "max") > 0, 1,
                            reach)
    reach = reach.cpu().numpy() > 0
    reach[seeds] = False
    return pd.DataFrame({
        "vertex": G.number_map.to_external(np.flatnonzero(reach))})


def extract_bfs_paths(G, distances_df: pd.DataFrame, destinations):
    """Root-to-destination paths from a bfs or sssp frame (reference
    extract_bfs_paths_impl.cuh, a walk up the predecessor chain).  Returns
    (frame ['destination', 'path_offset'], flat vertex paths padded with
    -1, row width)."""
    df = distances_df.sort_values("vertex")
    vertices = df["vertex"].to_numpy()
    ids = vertices.tolist()
    lut_pred = dict(zip(ids, df["predecessor"].to_numpy().tolist()))
    lut_dist = dict(zip(ids, df["distance"].to_numpy().tolist()))

    def _reachable(dv):
        # bfs marks unreachable with INT32_MAX, sssp with FLT_MAX
        return (dv is not None and np.isfinite(dv) and 0 <= dv < INT32_INF
                and dv < np.float64(F32_INF) / 2)

    destinations = np.asarray(destinations).reshape(-1)
    # walk every chain first, then size the rows by the longest: the hop
    # count of an sssp frame is unrelated to its distances
    chains = [None] * len(destinations)
    cap = len(vertices) + 1
    for r, d in enumerate(destinations):
        if not _reachable(lut_dist.get(d)):
            continue
        cur, chain = d, []
        while cur is not None and cur != -1 and len(chain) <= cap:
            chain.append(cur)
            nxt = lut_pred.get(cur, -1)
            cur = None if nxt == -1 or nxt is None else nxt
        chains[r] = chain
    max_len = max((len(c) for c in chains if c is not None), default=1)
    paths = np.full((len(destinations), max_len), -1, dtype=np.int64)
    for r, chain in enumerate(chains):
        if chain is not None:
            paths[r, : len(chain)] = chain[::-1]
    return pd.DataFrame({
        "destination": destinations,
        "path_offset": np.arange(len(destinations)) * max_len,
    }), paths.reshape(-1), max_len


# -- multi-source panels ----------------------------------------------------

def _msbfs_panel(g, panel: np.ndarray, stats: dict) -> torch.Tensor:
    """Hop distances from a panel of sources, int32 [n, B], -1 where
    unreached or for a padding column: one K4 launch over the CSC on the
    frontier masks per level (JAX ``_msbfs_dist_batched_pallas``,
    traversal.py:628-650).  The sums of 0/1 masks are exact."""
    n = g.num_vertices
    dist = torch.where(panel_onehot(g, panel), 0, -1).to(torch.int32)
    level = 0
    while level < n:
        hit = spmm_by_major(g.csc, (dist == level).to(torch.float32),
                            unit=True)
        newly = (hit > 0) & (dist == -1)
        dist.masked_fill_(newly, level + 1)
        level += 1
        stats["syncs"] += 1
        if not bool(newly.any()):
            break
    stats["levels"].append(level)
    return dist


def _msbfs_serial(g, panel: np.ndarray, stats: dict) -> torch.Tensor:
    """The same distances one source at a time: one K1 (mul) launch over
    the CSC per level (JAX ``_msbfs_dist_serial_device``,
    traversal.py:653-695)."""
    n = g.num_vertices
    out = torch.full((n, len(panel)), -1, dtype=torch.int32, device=g.device)
    for b, root in enumerate(panel.tolist()):
        if root < 0:
            continue
        dist = out[:, b].clone()
        dist[root] = 0
        level = 0
        while level < n:
            hit = spmv_pull(g, (dist == level).to(torch.float32))
            newly = (hit > 0) & (dist == -1)
            dist.masked_fill_(newly, level + 1)
            level += 1
            stats["syncs"] += 1
            if not bool(newly.any()):
                break
        stats["levels"].append(level)
        out[:, b] = dist
    return out


def _mssssp_panel(g, panel: np.ndarray, stats: dict) -> torch.Tensor:
    """Weighted distances from a panel of sources, float32 [n, B], 1e30
    where unreached: batched Bellman-Ford, one K5 (min, add) launch over
    the CSC per round (JAX ``_mssssp_dist_batched``, traversal.py:698-724).
    K5 is exact, so the XLA route's stopping test ``new < dist`` holds, and
    not the Pallas route's ``new < dist - 1e-6·|dist|`` (:744), which its
    split precision needs."""
    n = g.num_vertices
    dist = torch.where(panel_onehot(g, panel), 0.0, BIG)
    it = 0
    while it < n:
        new = torch.minimum(dist, spmm_semiring_by_major(g.csc, dist, "min",
                                                         "add"))
        it += 1
        stats["syncs"] += 1
        improved = bool((new < dist).any())
        dist = new
        if not improved:
            break
    stats["iterations"].append(it)
    return dist


def od_shortest_distances(G, origins, destinations) -> pd.DataFrame:
    """All origin-to-destination shortest distances (reference
    traversal/od_shortest_distances_impl.cuh:426), in panels of 128
    origins: level BFS on K4 when the graph is unweighted, Bellman-Ford on
    K5 (min, add) when weighted.  Unreachable pairs get FLT_MAX.  Returns
    ['origin', 'destination', 'distance']."""
    origins = np.asarray(origins).reshape(-1)
    destinations = np.asarray(destinations).reshape(-1)
    weighted = G.is_weighted()
    o_int = normalize_start(G, origins)
    d_int = normalize_start(G, destinations)
    g = G.structure
    rows = torch.as_tensor(d_int, dtype=torch.int64, device=g.device)
    stats = {"algo": "od_shortest_distances", "panels": 0, "levels": [],
             "iterations": [], "syncs": 0}
    sweep = _mssssp_panel if weighted else _msbfs_panel
    cols = []
    for panel, _, count in source_panels(o_int):
        dist = sweep(g, panel, stats).index_select(0, rows)[:, :count]
        blk = dist.cpu().numpy().astype(np.float64)
        # unreachable = FLT_MAX (the sssp and C API convention)
        reached = blk < BIG / 2 if weighted else blk >= 0
        cols.append(np.where(reached, blk, F32_INF))
        stats["panels"] += 1
    LAST_RUN.clear()
    LAST_RUN.update(stats)
    dmat = (np.hstack(cols) if cols
            else np.zeros((len(d_int), 0), np.float64))
    return pd.DataFrame({
        "origin": np.repeat(origins, len(destinations)),
        "destination": np.tile(destinations, len(origins)),
        "distance": dmat.T.reshape(-1),
    })
