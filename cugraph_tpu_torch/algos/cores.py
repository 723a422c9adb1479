"""Cores: core number (k-core decomposition) and k-core extraction.

Counterpart of ``cugraph_tpu.algos.cores`` (reference
core_number_impl.cuh:59, k_core_impl.cuh:23).  Core numbers come from the
exact Batagelj-Zaversnik peel of the native host library
(``core/native.py``), which the JAX package also takes first
(cores.py:176-180) and for every ``degree_type``; the structure's offsets
and indices are copied to the host for it.  The JAX package's XLA h-index
fixpoint and its Pallas peel serve only a missing toolchain there; the port
raises instead, so no card kernel runs here.
"""

from __future__ import annotations

import numpy as np

from cugraph_tpu_torch.algos._utils import vertex_frame
from cugraph_tpu_torch.api.graph import Graph
from cugraph_tpu_torch.core import native

DEGREE_TYPES = ("bidirectional", "incoming", "outgoing")


def _core_numbers(G, degree_type: str) -> np.ndarray:
    """int32 [n] (JAX ``_core_number_native``, cores.py:113-160).  Removing
    v must decrement the chosen degree of the right neighbours: for
    "incoming" its out-neighbours, for "outgoing" its in-neighbours, for
    "bidirectional" both; an undirected graph's storage already holds both
    directions."""
    g = G.structure
    n = g.num_vertices
    csr_off = g.csr.offsets.cpu().numpy().astype(np.int64)
    csr_adj = g.csr.indices.cpu().numpy()
    out_deg = np.diff(csr_off)
    if not G.is_directed():
        return native.core_number_peel_native(csr_off, csr_adj, out_deg)
    csc_off = g.csc.offsets.cpu().numpy().astype(np.int64)
    csc_adj = g.csc.indices.cpu().numpy()
    in_deg = np.diff(csc_off)
    if degree_type == "incoming":
        return native.core_number_peel_native(csr_off, csr_adj, in_deg)
    if degree_type == "outgoing":
        return native.core_number_peel_native(csc_off, csc_adj, out_deg)
    # bidirectional: each row holds the vertex's out-neighbours, then its
    # in-neighbours (a reciprocated pair appears twice, the reference's
    # doubling)
    m = len(csr_adj)
    deg = out_deg + in_deg
    row_off = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=row_off[1:])
    adj = np.empty(int(row_off[-1]), np.int32)
    adj[np.repeat(row_off[:-1], out_deg)
        + (np.arange(m) - np.repeat(csr_off[:-1], out_deg))] = csr_adj
    adj[np.repeat(row_off[:-1] + out_deg, in_deg)
        + (np.arange(m) - np.repeat(csc_off[:-1], in_deg))] = csc_adj
    return native.core_number_peel_native(row_off, adj, deg)


def core_number(G, degree_type: str = "bidirectional"):
    """Core number per vertex; returns ['vertex', 'core_number'].  As in
    the reference (core_number_impl.cuh) the graph is expected to be
    undirected; a directed graph peels the ``degree_type`` degrees."""
    if degree_type not in DEGREE_TYPES:
        raise ValueError(f"invalid degree_type {degree_type!r}")
    return vertex_frame(G, {"core_number": _core_numbers(G, degree_type)})


def k_core(G, k=None, core_number_df=None,
           degree_type: str = "bidirectional"):
    """The k-core subgraph (reference k_core_impl.cuh:23): a new Graph on
    the same device, on the vertices with core_number >= k (default: the
    largest core number).  Every qualifying vertex is in it, also one whose
    edges all leave the core (the reference's k_core.py:127-138 rebuilds
    from the edge list alone and drops such vertices; by the definition
    they belong, e.g. every isolated vertex at k = 0)."""
    df = (core_number_df if core_number_df is not None
          else core_number(G, degree_type))
    if k is None:
        k = int(df["core_number"].max())
    core = np.zeros(G.number_of_vertices(), np.int64)
    core[G.lookup_internal_vertex_id(df["vertex"].to_numpy())] = \
        df["core_number"].to_numpy()
    src, dst, w = G.edgelist_arrays()
    keep = (core[src] >= k) & (core[dst] >= k)
    verts = df["vertex"].to_numpy()[df["core_number"].to_numpy() >= k]
    out = Graph(directed=G.is_directed(), device=G.device)
    out.from_edgelist(G.number_map.to_external(src[keep]),
                      G.number_map.to_external(dst[keep]),
                      None if w is None else w[keep],
                      vertices=np.sort(verts))
    return out
