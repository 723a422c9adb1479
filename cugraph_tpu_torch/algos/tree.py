"""Minimum and maximum spanning tree (forest).

Counterpart of ``cugraph_tpu.algos.tree`` (reference legacy
cpp/src/tree/legacy/mst.cu, raft MST).  Borůvka's algorithm on the graph's
device: every component picks its cheapest outgoing edge under a
direction-agnostic tie-break (weight, then the smaller endpoint, then the
larger), so that equal-weight hooks can form only 2-cycles; components
merge by breaking those 2-cycles toward the smaller id and jumping
pointers.  The segment minima by component are ``scatter_reduce_``
"amin", which is order-independent, so repeated runs are bit-identical.
One host sync per round, to test whether any component changed.
"""

from __future__ import annotations

import numpy as np
import torch

from cugraph_tpu_torch.core.preprocess import unique_by_sort

_BIG_W = 3e38          # the weight of an edge inside a component
_POINTER_JUMPS = 32    # the JAX package's fixed count: depth up to 2^32


def _segment_min(values, seg, n, init):
    out = torch.full((n,), init, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, seg, values, "amin")


def _boruvka(g, weights=None, rank=None) -> torch.Tensor:
    """bool [num_edges] in CSR order: the edges of the minimum spanning
    forest (each undirected edge possibly from both sides) under
    ``weights`` (float32 [num_edges] in CSR order; the CSR's own when
    None), ties broken by the endpoints' ``rank`` (int64 [n]; the
    vertex ids when None)."""
    adj = g.csr
    n = g.num_vertices
    rows = adj.row_ids()
    cols = adj.indices.to(torch.int64)
    w = adj.weights if weights is None else weights
    ru, rv = (rows, cols) if rank is None else (rank[rows], rank[cols])
    lo = torch.minimum(ru, rv)
    hi = torch.maximum(ru, rv)
    ids = torch.arange(n, device=g.device)
    big = torch.iinfo(torch.int64).max
    comp = ids.clone()
    in_mst = torch.zeros(adj.num_edges, dtype=torch.bool, device=g.device)
    while True:
        cs = comp[rows]
        cd = comp[cols]
        cross = cs != cd
        keyw = torch.where(cross, w, torch.full_like(w, _BIG_W))
        best_w = _segment_min(keyw, cs, n, float("inf"))
        is_min_w = cross & (keyw <= best_w[cs])
        best_lo = _segment_min(torch.where(is_min_w, lo, big), cs, n, big)
        is_min_lo = is_min_w & (lo == best_lo[cs])
        best_hi = _segment_min(torch.where(is_min_lo, hi, big), cs, n, big)
        chosen = is_min_lo & (hi == best_hi[cs])
        in_mst |= chosen
        # hook each component to the other side of its chosen edge
        other = _segment_min(torch.where(chosen, cd, big), cs, n, big)
        parent = torch.where(best_hi < big, other, ids)
        # break 2-cycles: the smaller id stays a root
        parent = torch.where((parent[parent] == ids) & (parent < ids), ids,
                             parent)
        for _ in range(_POINTER_JUMPS):
            parent = parent[parent]
        new_comp = parent[comp]
        if not bool((new_comp != comp).any()):
            return in_mst
        comp = new_comp


def _forest_graph(G, weights=None, rank=None):
    """The spanning forest of ``G`` under ``weights`` and ``rank`` (see
    ``_boruvka``) as a Graph on G's device with every vertex of G, each
    edge with its weight under ``weights``."""
    from cugraph_tpu_torch.api.graph import Graph

    g = G.structure
    mask = _boruvka(g, weights, rank)
    src = g.csr.row_ids()[mask].cpu().numpy()
    dst = g.csr.indices[mask].cpu().numpy().astype(np.int64)
    w = (g.csr.weights if weights is None else weights)[mask].cpu().numpy()
    # either side may choose an undirected edge: keep one copy, in key
    # order, as np.unique's first index gives it
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    _, idx = unique_by_sort(lo * g.num_vertices + hi, G.device,
                            return_index=True)
    return Graph(device=G.device).from_edgelist(
        G.number_map.to_external(lo[idx]), G.number_map.to_external(hi[idx]),
        w[idx], vertices=G.nodes())


def minimum_spanning_tree(G, weight=None, algorithm="boruvka",
                          ignore_nan=False):
    """Minimum spanning tree or forest; returns a Graph on the input
    graph's device with every vertex of G (reference
    minimum_spanning_tree.pyx -> legacy/mst.cu)."""
    if G.is_directed():
        raise ValueError("MST requires an undirected graph")
    return _forest_graph(G)


def _rebuild_rank(G) -> torch.Tensor:
    """Each vertex's internal id in a Graph rebuilt from
    ``G.edgelist_arrays()`` in external ids: descending degree over that
    list, ties by external id (``renumber_edgelist``); vertices on no
    edge last."""
    src, dst, _ = G.edgelist_arrays()
    n = G.number_of_vertices()
    deg = np.bincount(src, minlength=n) + np.bincount(dst, minlength=n)
    order = np.lexsort((G.number_map.to_external(np.arange(n)), -deg))
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    return torch.from_numpy(rank).to(G.device)


def maximum_spanning_tree(G, weight=None, algorithm="boruvka",
                          ignore_nan=False):
    """Maximum spanning tree or forest: the minimum one of the same
    structure on the negated weights, its weights negated back.  No
    second graph is built: ties are broken by the ids such a rebuild from
    ``edgelist_arrays`` would give (``_rebuild_rank``), as the JAX
    package's rebuild breaks them."""
    if G.is_directed():
        raise ValueError("MST requires an undirected graph")
    from cugraph_tpu_torch.api.graph import Graph

    el = _forest_graph(G, -G.structure.csr.weights,
                       _rebuild_rank(G)).view_edge_list()
    return Graph(device=G.device).from_edgelist(
        el["src"].to_numpy(), el["dst"].to_numpy(),
        -el["weight"].to_numpy(), vertices=G.nodes())
