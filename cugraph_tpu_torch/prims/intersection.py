"""Sorted-adjacency membership tests, neighbour enumeration and pair
intersections.

Counterpart of ``cugraph_tpu.prims.intersection`` (reference
nbr_intersection.cuh): the CSR keeps each row's indices sorted
(``core/structure.build_csr`` sorts by (major, minor)), so membership is a
branch-free binary search over torch tensors on the structure's device,
and enumerating a row is one gather.  ``pair_intersection`` runs the JAX
package's min-degree probe (``_pair_minprobe_host``) on the structure's
device, in chunks of at most ``_PROBE_CHUNK`` queries.  The JAX package's
neighbour tables and its padded-table sort-merge routes
(``prims/neighbor_table.py``, ``_padded_adj_tables``,
``pair_intersection_bucketed``), TPU workarounds for element gathers, have
no counterpart: the card gathers elements.
"""

from __future__ import annotations

import numpy as np
import torch

from cugraph_tpu_torch.core.structure import CsrMatrix


def lower_bound_rows(adj: CsrMatrix, rows, queries, steps: int = 32):
    """For each (row r, query q), the insertion position of q in the sorted
    adjacency list of r.  ``rows`` and ``queries`` broadcast together.
    ``steps`` halvings must cover the longest row searched: 32 cover any
    int32 row, ``d.bit_length()`` a row of d edges.
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
    for _ in range(steps):
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


_PROBE_CHUNK = 1 << 25  # expanded membership queries per chunk at most


def pair_intersection(g, us, vs, weighted: bool = False):
    """Neighbour-set intersection statistics of the pairs (us[i], vs[i])
    over out-edges (symmetrized graphs give the undirected semantics of
    the similarity algorithms), on the structure's device.

    The JAX package's min-degree probe: for each pair, every neighbour of
    the endpoint of smaller degree is searched in the other endpoint's
    sorted row (``lower_bound_rows``), so a (30, 25,000)-degree pair costs
    30 searches.  The pairs are cut into chunks whose searches number at
    most ``_PROBE_CHUNK`` (a single pair above it forms a chunk alone).
    Per pair, the hits are counted exactly and the weighted sums taken in
    float64 in the order of the smaller endpoint's row
    (``segment_reduce``, no atomics) and rounded once, so two calls on the
    same pairs are bit-identical.

    Returns a dict of tensors on the structure's device: ``count``
    |N(u) ∩ N(v)|, ``deg_u``, ``deg_v`` (int32 [P]) and, when weighted,
    ``sum_min``/``sum_max`` (float32 [P], Σ min/max(w(u,x), w(v,x)) over
    the intersection) and ``wsum_u``/``wsum_v`` (the endpoints' weight
    sums, ``GraphStructure.out_weight_sums``) — the contract of the JAX package's
    ``pair_intersection_auto``."""
    adj = g.csr
    dev = adj.device
    us, vs = (torch.as_tensor(x if isinstance(x, torch.Tensor)
                              else np.asarray(x)).to(dev, torch.int64)
              for x in (us, vs))
    offsets = adj.offsets.to(torch.int64)
    deg = offsets[1:] - offsets[:-1]
    du, dv = deg[us], deg[vs]
    swap = du > dv
    small = torch.where(swap, vs, us)
    large = torch.where(swap, us, vs)
    ds = torch.minimum(du, dv)
    P = us.shape[0]
    csum = torch.zeros(P + 1, dtype=torch.int64, device=dev)
    torch.cumsum(ds, 0, out=csum[1:])
    csum_host = csum.cpu().numpy()
    steps = int(deg.max()).bit_length() if P and adj.num_edges else 0
    count = torch.zeros(P, dtype=torch.int32, device=dev)
    if weighted:
        smin = torch.zeros(P, dtype=torch.float32, device=dev)
        smax = torch.zeros(P, dtype=torch.float32, device=dev)
    chunk = _PROBE_CHUNK
    lo = 0
    while lo < P:
        hi = int(np.searchsorted(csum_host, csum_host[lo] + chunk,
                                 side="right")) - 1
        hi = min(max(hi, lo + 1), P)
        base = int(csum_host[lo])
        tot = int(csum_host[hi]) - base
        if tot:
            lens = ds[lo:hi]
            starts = csum[lo:hi] - base  # each pair's first query
            pid = torch.repeat_interleave(
                torch.arange(hi - lo, device=dev), lens, output_size=tot)
            flat = offsets[small[lo:hi]][pid] + (
                torch.arange(tot, device=dev) - starts[pid])
            found, pos = lower_bound_rows(adj, large[lo:hi][pid],
                                          adj.indices[flat], steps)
            hits = torch.zeros(tot + 1, dtype=torch.int64, device=dev)
            torch.cumsum(found, 0, out=hits[1:])
            count[lo:hi] = (hits[starts + lens] - hits[starts]).to(
                torch.int32)
            if weighted:
                w_s = adj.weights[flat]
                w_l = adj.weights[pos.clamp(max=adj.num_edges - 1)]
                zero = torch.zeros((), dtype=torch.float64, device=dev)
                for dest, pick in ((smin, torch.minimum),
                                   (smax, torch.maximum)):
                    vals = torch.where(found, pick(w_s, w_l).double(), zero)
                    dest[lo:hi] = torch.segment_reduce(
                        vals, "sum", lengths=lens).float()
        lo = hi
    out = {"count": count, "deg_u": du.to(torch.int32),
           "deg_v": dv.to(torch.int32)}
    if weighted:
        ws = g.out_weight_sums
        out.update(sum_min=smin, sum_max=smax, wsum_u=ws[us], wsum_v=ws[vs])
    return out
