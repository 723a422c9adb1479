"""Degree-oriented wedge engine for triangle counting and truss support.

Counterpart of ``cugraph_tpu.algos._oriented_tri`` (reference
triangle_count_impl.cuh:124, which orients every edge toward the
higher-(degree, id) endpoint before intersecting neighbour lists;
edge_triangle_count_impl.cuh and k_truss_impl.cuh:166 share the scheme).
Orientation bounds every list by the largest ORIENTED out-degree instead
of the hub's raw degree.

The engine is the threaded C++ ``triangle_support`` of
``core/_native/builder.cpp``, a byte-for-byte copy of the JAX package's; a
failed build or a nonzero return raises.  ``_oriented_wedge_counts_numpy``
is the JAX package's NumPy loop, kept as the plain version the tests hold
the engine against.  The unique undirected pairs come from a stable sort on
the graph's device (``preprocess.unique_by_sort``), where the JAX package
calls ``np.unique``: the same keys in the same order.
"""

from __future__ import annotations

import numpy as np

from cugraph_tpu_torch.core import native
from cugraph_tpu_torch.core.preprocess import unique_by_sort

_WEDGE_CHUNK = 32 * 1024 * 1024  # wedges materialized per vectorized step


def oriented_wedge_counts(u, v, n: int, need_edge_support: bool = False):
    """Triangle counts over UNIQUE undirected edges (u[i], v[i]), any
    per-pair order, self-loops excluded.  Returns
    (tri: int64[n] per-vertex counts,
     support: int64[len(u)] per-input-edge triangle counts or None)."""
    return native.triangle_support_native(u, v, n, need_edge_support)


def _oriented_wedge_counts_numpy(u, v, n: int,
                                 need_edge_support: bool = False):
    """The plain version: the JAX package's NumPy wedge loop
    (_oriented_tri.py:53-102).  Rank by (degree, id), orient each edge
    toward the larger rank, enumerate the wedges at each low vertex in
    rank order, close them by a search of the sorted oriented keys."""
    u = np.asarray(u, np.int64)
    v = np.asarray(v, np.int64)
    M = len(u)
    tri = np.zeros(n, np.int64)
    sup = np.zeros(M, np.int64) if need_edge_support else None
    if M == 0 or n == 0:
        return tri, sup
    deg = (np.bincount(u, minlength=n) + np.bincount(v, minlength=n))
    rk = np.empty(n, np.int64)
    rk[np.argsort(deg.astype(np.int64) * n + np.arange(n))] = np.arange(n)
    swap = rk[u] > rk[v]
    a = np.where(swap, v, u)
    b = np.where(swap, u, v)

    order = np.lexsort((rk[b], a))
    a_s, b_s = a[order], b[order]
    dplus = np.bincount(a_s, minlength=n)
    off = np.zeros(n + 1, np.int64)
    np.cumsum(dplus, out=off[1:])

    keys_o = a_s * n + b_s
    sortperm = np.argsort(keys_o)
    ek = keys_o[sortperm]
    sup_o = np.zeros(M, np.int64) if need_edge_support else None

    for d in np.unique(dplus):  # degree values, not edge keys
        if d < 2:
            continue
        verts = np.flatnonzero(dplus == d)
        ii, jj = np.triu_indices(int(d), 1)
        npairs = len(ii)
        step = max(1, _WEDGE_CHUNK // npairs)
        for s in range(0, len(verts), step):
            vs = verts[s:s + step]
            base = off[vs, None]
            rows = b_s[base + np.arange(d)]
            bb = rows[:, ii]
            ww = rows[:, jj]
            qk = (bb * n + ww).ravel()
            pos = np.searchsorted(ek, qk)
            pos_c = np.minimum(pos, len(ek) - 1)
            found = (ek[pos_c] == qk).reshape(bb.shape)
            tri[vs] += found.sum(axis=1)
            np.add.at(tri, bb[found], 1)
            np.add.at(tri, ww[found], 1)
            if need_edge_support:
                eid_ab = np.broadcast_to(base + ii, found.shape)[found]
                eid_aw = np.broadcast_to(base + jj, found.shape)[found]
                eid_bw = sortperm[pos_c.reshape(found.shape)[found]]
                np.add.at(sup_o, eid_ab, 1)
                np.add.at(sup_o, eid_aw, 1)
                np.add.at(sup_o, eid_bw, 1)

    if need_edge_support:
        sup[order] = sup_o
    return tri, sup


def _pair_keys(src, dst, n: int):
    """lo·n + hi of every non-loop edge, and the mask of those edges."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    keep = lo != hi
    return lo[keep] * n + hi[keep], keep


def directed_vertex_counts(src, dst, n: int, device):
    """Per-vertex triangle counts for a symmetrized edge list."""
    keys, _ = _pair_keys(src, dst, n)
    keys = unique_by_sort(keys, device)
    tri, _ = oriented_wedge_counts(keys // n, keys % n, n)
    return tri


def directed_edge_support(src, dst, n: int, device):
    """Per-DIRECTED-edge triangle support for a symmetrized edge list
    (each undirected edge in both directions, multi-edges allowed): the
    engine runs once over the unique undirected pairs, and every directed
    instance takes its pair's support.  Returns (tri int64[n], counts
    int64[len(src)])."""
    keys, keep = _pair_keys(src, dst, n)
    keys, inv = unique_by_sort(keys, device, return_inverse=True)
    tri, sup = oriented_wedge_counts(keys // n, keys % n, n,
                                     need_edge_support=True)
    counts = np.zeros(len(keep), np.int64)
    counts[keep] = sup[inv]
    return tri, counts
