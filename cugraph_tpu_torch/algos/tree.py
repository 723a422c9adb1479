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


def _boruvka(g) -> torch.Tensor:
    """bool [num_edges] in CSR order: the edges of the spanning forest
    (each undirected edge possibly from both sides)."""
    adj = g.csr
    n = g.num_vertices
    rows = adj.row_ids()
    cols = adj.indices.to(torch.int64)
    w = adj.weights
    lo = torch.minimum(rows, cols)
    hi = torch.maximum(rows, cols)
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


def minimum_spanning_tree(G, weight=None, algorithm="boruvka",
                          ignore_nan=False):
    """Minimum spanning tree or forest; returns a Graph on the input
    graph's device with every vertex of G (reference
    minimum_spanning_tree.pyx -> legacy/mst.cu)."""
    if G.is_directed():
        raise ValueError("MST requires an undirected graph")
    from cugraph_tpu_torch.api.graph import Graph

    g = G.structure
    mask = _boruvka(g)
    src = g.csr.row_ids()[mask].cpu().numpy()
    dst = g.csr.indices[mask].cpu().numpy().astype(np.int64)
    w = g.csr.weights[mask].cpu().numpy()
    # either side may choose an undirected edge: keep one copy, in key
    # order, as np.unique's first index gives it
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    _, idx = unique_by_sort(lo * g.num_vertices + hi, G.device,
                            return_index=True)
    return Graph(device=G.device).from_edgelist(
        G.number_map.to_external(lo[idx]), G.number_map.to_external(hi[idx]),
        w[idx], vertices=G.nodes())


def maximum_spanning_tree(G, weight=None, algorithm="boruvka",
                          ignore_nan=False):
    """Maximum spanning tree or forest: the minimum one on the negated
    weights."""
    if G.is_directed():
        raise ValueError("MST requires an undirected graph")
    from cugraph_tpu_torch.api.graph import Graph

    src, dst, w = G.edgelist_arrays()
    if w is None:
        w = np.ones(len(src), np.float32)
    neg = Graph(device=G.device).from_edgelist(
        G.number_map.to_external(src), G.number_map.to_external(dst), -w)
    el = minimum_spanning_tree(neg).view_edge_list()
    return Graph(device=G.device).from_edgelist(
        el["src"].to_numpy(), el["dst"].to_numpy(),
        -el["weight"].to_numpy(), vertices=G.nodes())
