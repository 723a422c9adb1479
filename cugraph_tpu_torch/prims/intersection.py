"""Sorted-adjacency membership tests and neighbour enumeration.

Counterpart of three functions of ``cugraph_tpu.prims.intersection``
(reference nbr_intersection.cuh): the CSR keeps each row's indices sorted
(``core/structure.build_csr`` sorts by (major, minor)), so membership is a
branch-free 32-step binary search over torch tensors on the structure's
device, and enumerating a row is one gather.  The JAX package's neighbour
tables (``prims/neighbor_table.py``), a TPU workaround for element gathers,
have no counterpart: the card gathers elements.  The pair intersections
follow with the similarity algorithms.
"""

from __future__ import annotations

import torch

from cugraph_tpu_torch.core.structure import CsrMatrix


def lower_bound_rows(adj: CsrMatrix, rows, queries):
    """For each (row r, query q), the insertion position of q in the sorted
    adjacency list of r.  ``rows`` and ``queries`` broadcast together.
    Returns (found: bool, pos: int64 absolute index into ``adj.indices``)."""
    rows = torch.as_tensor(rows, device=adj.device).to(torch.int64)
    queries = torch.as_tensor(queries, device=adj.device)
    shape = torch.broadcast_shapes(rows.shape, queries.shape)
    offsets = adj.offsets.to(torch.int64)
    lo = offsets[rows].expand(shape)
    hi0 = offsets[rows + 1].expand(shape)
    if adj.num_edges == 0:
        return torch.zeros(shape, dtype=torch.bool, device=adj.device), lo
    last = adj.num_edges - 1
    hi = hi0
    # 32 iterations cover any row length representable in int32
    for _ in range(32):
        mid = (lo + hi) >> 1
        val = adj.indices[mid.clamp(0, last)]
        go_right = (val < queries) & (lo < hi)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right | (lo >= hi), hi, mid)
    val = adj.indices[lo.clamp(0, last)]
    return (lo < hi0) & (val == queries), lo


def enumerate_neighbors(adj: CsrMatrix, verts, max_deg: int):
    """[P] vertex ids -> ([P, max_deg] neighbour ids, [P, max_deg] valid
    mask, [P, max_deg] absolute edge index, clipped to the edge array).
    Rows shorter than ``max_deg`` are masked; longer rows must not occur."""
    verts = torch.as_tensor(verts, device=adj.device).to(torch.int64)
    offsets = adj.offsets.to(torch.int64)
    base = offsets[verts]
    deg = offsets[verts + 1] - base
    k = torch.arange(max_deg, dtype=torch.int64, device=adj.device)
    eidx = (base[:, None] + k[None, :]).clamp(0, max(adj.num_edges - 1, 0))
    valid = k[None, :] < deg[:, None]
    if adj.num_edges == 0:
        nbr = torch.zeros(eidx.shape, dtype=torch.int32, device=adj.device)
    else:
        nbr = adj.indices[eidx]
    return nbr, valid, eidx


def _host_csr(adj: CsrMatrix, weighted: bool):
    """Host copies of (offsets, indices, weights or None), made at the
    first call and kept on the CsrMatrix: the NumPy engines read them on
    every call."""
    cached = getattr(adj, "_host_csr_cache", None)
    if cached is None or (weighted and cached[2] is None):
        cached = (adj.offsets.cpu().numpy(), adj.indices.cpu().numpy(),
                  adj.weights.cpu().numpy() if weighted else None)
        object.__setattr__(adj, "_host_csr_cache", cached)
    return cached

