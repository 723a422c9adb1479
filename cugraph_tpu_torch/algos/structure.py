"""Structure transforms: symmetrize, induced subgraph, two-hop neighbours,
the edge-list utilities, weight sums and hypergraphs.

Counterpart of ``cugraph_tpu.algos.structure`` (reference
cpp/include/cugraph/graph_functions.hpp:366-1144,
cpp/src/structure/induced_subgraph_impl.cuh; python/cugraph/cugraph/
structure/), host NumPy and scipy as there.  ``count_multi_edges`` counts
by a sort where the JAX package calls ``np.unique``, and
``renumber_arbitrary_edgelist`` runs the native hash renumber, which
raises where the JAX package would fall back to NumPy.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from cugraph_tpu_torch.algos import traversal
from cugraph_tpu_torch.core import native, preprocess


def symmetrize(df_or_src, dst=None, weight=None, src_name="src",
               dst_name="dst", value_col=None):
    """Symmetrize an edge list (reference symmetrize.py,
    symmetrize_graph_impl.cuh): a frame in, a frame out; arrays in, a
    tuple (src, dst[, weight]) out.  Duplicate weights coalesce by min."""
    from cugraph_tpu_torch.api.graph import Graph

    if isinstance(df_or_src, pd.DataFrame):
        src = df_or_src[src_name].to_numpy()
        d = df_or_src[dst_name].to_numpy()
        if value_col is not None:
            w = df_or_src[value_col].to_numpy()
        else:
            # only a conventionally named column is a weight: an edge type
            # or time column would be min-coalesced as one
            wcols = [c for c in df_or_src.columns
                     if c not in (src_name, dst_name)
                     and str(c).lower() in Graph._WEIGHT_COL_NAMES]
            w = df_or_src[wcols[0]].to_numpy() if len(wcols) == 1 else None
    else:
        src, d, w = np.asarray(df_or_src), np.asarray(dst), weight
    # external ids may be sparse: make them dense first
    uniq, inv = np.unique(np.concatenate([src, d]), return_inverse=True)
    e = len(src)
    s2, d2, w2 = preprocess.symmetrize_edgelist(
        inv[:e].astype(np.int64), inv[e:].astype(np.int64),
        None if w is None else np.asarray(w))
    if not isinstance(df_or_src, pd.DataFrame):
        if w2 is not None:
            return uniq[s2], uniq[d2], w2
        return uniq[s2], uniq[d2]
    out = {src_name: uniq[s2], dst_name: uniq[d2]}
    if w2 is not None:
        out["weight"] = w2
    return pd.DataFrame(out)


def induced_subgraph(G, vertices):
    """The edges among ``vertices`` (reference induced_subgraph_impl.cuh):
    (DataFrame ['src', 'dst', 'weight'], offsets [0, edges])."""
    ids = G.lookup_internal_vertex_id(np.asarray(vertices))
    src, dst, w = G.edgelist_arrays()
    keep = np.isin(src, ids) & np.isin(dst, ids)
    if not G.is_directed():
        keep &= src <= dst
    out = pd.DataFrame({
        "src": G.number_map.to_external(src[keep]),
        "dst": G.number_map.to_external(dst[keep]),
        "weight": (w[keep] if w is not None
                   else np.ones(int(keep.sum()), np.float32)),
    })
    return out, np.array([0, len(out)])


def subgraph(G, vertices):
    """The induced subgraph as a new Graph on G's device (reference
    cugraph.subgraph)."""
    from cugraph_tpu_torch.api.graph import Graph

    df, _ = induced_subgraph(G, vertices)
    out = Graph(directed=G.is_directed(), device=G.device)
    return out.from_edgelist(df["src"].to_numpy(), df["dst"].to_numpy(),
                             df["weight"].to_numpy(),
                             vertices=np.asarray(vertices))


def two_hop_neighbors(G):
    """Every (first, second) pair joined by a path of two edges, first !=
    second, once per unordered pair when undirected (reference
    c_api/graph_functions.cpp:85): DataFrame ['first', 'second']."""
    import scipy.sparse as sp

    src, dst, _ = G.edgelist_arrays()
    n = G.number_of_vertices()
    A = sp.csr_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    P = (A @ A).tocoo()
    mask = P.row != P.col
    first, second = P.row[mask], P.col[mask]
    if not G.is_directed():
        keep = first < second
        first, second = first[keep], second[keep]
    return pd.DataFrame({
        "first": G.number_map.to_external(first.astype(np.int64)),
        "second": G.number_map.to_external(second.astype(np.int64)),
    })


def k_hop_neighbors(G, start, k):
    return traversal.k_hop_neighbors(G, start, k)


def decompress_to_edgelist(G) -> pd.DataFrame:
    """The stored edges in external ids, with the weight, edge_id and
    edge_type columns the graph has (graph_functions.hpp:366)."""
    src, dst, w = G.edgelist_arrays()
    nm = G.number_map
    out = {"src": nm.to_external(src), "dst": nm.to_external(dst)}
    if w is not None:
        out["weight"] = w
    if G.edge_ids is not None:
        out["edge_id"] = G.edge_ids
    if G.edge_types is not None:
        out["edge_type"] = G.edge_types
    return pd.DataFrame(out)


def replicate_edgelist(G) -> pd.DataFrame:
    """One device's copy of the edge list (the multi-device version
    gathers it, c_api/allgather.cpp)."""
    return decompress_to_edgelist(G)


def select_random_vertices(G, num_vertices: int,
                           random_state=None) -> np.ndarray:
    """Distinct vertices drawn uniformly (select_random_vertices_impl.hpp),
    by NumPy's generator as the JAX package draws them."""
    n = G.number_of_vertices()
    if num_vertices > n:
        raise ValueError("cannot select more vertices than the graph has")
    rng = np.random.default_rng(random_state)
    ids = rng.choice(n, size=num_vertices, replace=False).astype(np.int32)
    return G.number_map.to_external(ids)


def extract_vertex_list(G) -> np.ndarray:
    """Every vertex id, external (extract_vertex_list.pyx)."""
    return G.nodes()


def count_multi_edges(G) -> int:
    """The stored edges beyond the first of each parallel group
    (count_multi_edges.pyx): the edges less the distinct (src, dst) keys,
    counted by a sort on the graph's device."""
    src, dst, _ = G.edgelist_arrays()
    key = (src.astype(np.int64) << 32) | dst.astype(np.int64)
    return int(len(key) - len(preprocess.first_occurrences(key, G.device)))


def renumber_arbitrary_edgelist(src, dst):
    """Dense int32 ids for an edge list of arbitrary (64-bit) integer ids
    (renumber_arbitrary_edgelist.pyx), ids numbered in first-seen order by
    the native hash renumber.  Returns (src32, dst32, the id of each)."""
    uniq, s32, d32 = native.renumber_native(np.asarray(src, np.int64),
                                            np.asarray(dst, np.int64))
    return s32, d32, uniq


# -- weight sums (structure/graph_weight_utils_impl.cuh) ----------------------

def out_weight_sums(G) -> np.ndarray:
    src, _, w = G.edgelist_arrays()
    n = G.number_of_vertices()
    if w is None:
        w = np.ones(len(src), np.float32)
    return np.bincount(src, weights=w, minlength=n)[:n].astype(np.float32)


def in_weight_sums(G) -> np.ndarray:
    _, dst, w = G.edgelist_arrays()
    n = G.number_of_vertices()
    if w is None:
        w = np.ones(len(dst), np.float32)
    return np.bincount(dst, weights=w, minlength=n)[:n].astype(np.float32)


def total_edge_weight(G) -> float:
    _, _, w = G.edgelist_arrays()
    if w is None:
        return float(G.number_of_edges())
    return float(np.sum(w))


# -- hypergraphs (Python-only in the reference, structure/hypergraph.py) ------

def hypergraph(df: pd.DataFrame, columns=None, *, categorical_metadata=True,
               drop_edge_attrs=False, direct: bool = False, device=None):
    """A bipartite (entity, row-node) graph, or with ``direct`` a clique
    among each row's entities, from a frame's categorical columns.
    Returns (nodes_df, edges_df, G); G lives on ``device`` (None: the
    card)."""
    from cugraph_tpu_torch.api.graph import Graph

    if columns is None:
        columns = list(df.columns)
    ents = [c + "::" + df[c].astype(str) for c in columns]
    if direct:
        if len(columns) < 2:
            raise ValueError("direct hypergraph needs at least two columns")
        srcs, dsts = [], []
        for i in range(len(columns)):
            for j in range(i + 1, len(columns)):
                srcs.append(ents[i])
                dsts.append(ents[j])
        edges = pd.DataFrame({"src": pd.concat(srcs, ignore_index=True),
                              "dst": pd.concat(dsts, ignore_index=True)})
    else:
        row_nodes = pd.Series([f"rownode::{i}" for i in range(len(df))])
        edges = pd.DataFrame({
            "src": pd.concat([row_nodes] * len(columns), ignore_index=True),
            "dst": pd.concat(ents, ignore_index=True)})
    nodes = pd.DataFrame({"node": pd.unique(
        pd.concat([edges["src"], edges["dst"]], ignore_index=True))})
    G = Graph(device=device)
    G.from_edgelist(edges["src"].to_numpy(), edges["dst"].to_numpy(), None)
    return nodes, edges, G
