"""The top-level convenience surface (reference python/cugraph/cugraph/
__init__.py): the matrix and frame constructors and exporters
(structure/convert_matrix.py), the NetworkX-style predicates, the
traversal aliases (traversal/bfs.py:199 ``bfs_edges``, sssp.py:263
``shortest_path``), multi-source BFS (traversal/ms_bfs.py), the unified
homogeneous and heterogeneous sampling entry points
(sampling/homogeneous_neighbor_sample.py:44), ``symmetrize_df`` and the
similarity coefficient aliases.

Counterpart of ``cugraph_tpu.api.convenience``.  A constructor builds its
Graph on the device of a ``create_using`` instance (its class and
directedness too), or on the card for a class or None.
``to_numpy_array`` builds the dense matrix on the graph's device.  The
distances come from the panels of ``algos/traversal.py``; the
predecessors from the JAX package's pass over
the edge list (convenience.py:240-242), on the graph's device: for each
vertex, the last edge in edge-list order that comes from one level up, as
the JAX package's NumPy write ``pred[dst[ok]] = src[ok]`` leaves it.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from cugraph_tpu_torch.algos import (link_prediction, sampling, structure,
                                     traversal)
from cugraph_tpu_torch.algos._utils import (normalize_start, source_panels,
                                            unrenumber_column)


def _predecessors(src, dst, dist):
    """int64 [n]: for each vertex v the src of the last edge (src, v) with
    dist[src] >= 0 and dist[src] + 1 == dist[v], else -1; ``src``/``dst``
    int64 [m] and ``dist`` int64 [n] on one device.  The largest edge
    position per destination (``scatter_reduce`` "amax") is the edge the
    plain version ``_predecessors_numpy`` writes last."""
    ds = dist[src]
    ok = (ds >= 0) & (ds + 1 == dist[dst])
    pos = torch.where(ok, torch.arange(src.shape[0], device=src.device), -1)
    last = torch.full_like(dist, -1).scatter_reduce_(0, dst, pos, "amax")
    return torch.where(last >= 0, src[last.clamp(min=0)], -1)


def _predecessors_numpy(src, dst, dist):
    """The JAX package's host pass (convenience.py:240-242)."""
    ok = (dist[src] >= 0) & (dist[src] + 1 == dist[dst])
    pred = np.full(len(dist), -1, np.int64)
    pred[dst[ok]] = src[ok]
    return pred


def multi_source_bfs(G, sources, components=None, depth_limit=None,
                     offload=False, strategy: str = "auto"):
    """BFS from every vertex in ``sources`` (reference ms_bfs.py:172, a
    placeholder there).  ``strategy``: "auto" or "panel" runs 128 sources
    at once, one K4 launch per level; "serial" one source at a time, one
    K1 launch per level.  The JAX package's "auto" switches to its serial
    loop above 16 M edges, where its TPU tile plan fragments; the GPU
    kernel reads the CSR directly and has no such crossover.  The results
    are the same.  Returns ['vertex', 'distance_<s>', 'predecessor_<s>',
    ...]; unreachable vertices get distance 2**31-1 and predecessor -1."""
    if offload:
        raise NotImplementedError("offload not supported")
    if strategy not in ("auto", "panel", "serial"):
        raise ValueError(f"unknown multi_source_bfs strategy {strategy!r}")
    sources = np.asarray(sources).reshape(-1)
    s_int = normalize_start(G, sources)
    n = G.number_of_vertices()
    g = G.structure
    src_i, dst_i, _ = G.edgelist_arrays()
    src_t = torch.from_numpy(src_i.astype(np.int64)).to(g.device)
    dst_t = torch.from_numpy(dst_i.astype(np.int64)).to(g.device)
    sweep = (traversal._msbfs_serial if strategy == "serial"
             else traversal._msbfs_panel)
    stats = {"algo": "multi_source_bfs", "strategy": strategy, "panels": 0,
             "levels": [], "syncs": 0}
    dl = None if depth_limit is None else int(depth_limit)
    out = {"vertex": G.number_map.to_external(np.arange(n))}
    for panel, i, count in source_panels(s_int):
        dist = sweep(g, panel, stats)[:, :count].to(torch.int64)
        if dl is not None:
            dist = torch.where(dist > dl, -1, dist)
        stats["panels"] += 1
        # one contiguous host row per source: a strided column costs the
        # host framing several times more
        preds = torch.stack([_predecessors(src_t, dst_t, dist[:, b])
                             for b in range(count)]).cpu().numpy()
        dist = dist.T.contiguous().cpu().numpy()
        for b in range(count):
            s_ext = int(sources[i + b])
            out[f"distance_{s_ext}"] = np.where(
                dist[b] < 0, traversal.INT32_INF, dist[b]).astype(np.int32)
            out[f"predecessor_{s_ext}"] = unrenumber_column(G, preds[b])
    traversal.LAST_RUN.clear()
    traversal.LAST_RUN.update(stats)
    return pd.DataFrame(out)


def concurrent_bfs(Graphs, sources, depth_limit=None, offload=False):
    """``multi_source_bfs`` over a list of graphs (reference ms_bfs.py:97).
    Returns a list of frames, one per graph."""
    if len(Graphs) != len(sources):
        raise ValueError("Graphs and sources must have the same length")
    return [multi_source_bfs(g, s, depth_limit=depth_limit, offload=offload)
            for g, s in zip(Graphs, sources)]


def homogeneous_neighbor_sample(G, start_list,
                                starting_vertex_label_offsets=None,
                                fanout_vals=None, *, with_replacement=True,
                                with_biases=False, random_state=None, **kw):
    """``homogeneous_biased_neighbor_sample`` when ``with_biases``, else
    ``homogeneous_uniform_neighbor_sample``."""
    fn = (sampling.homogeneous_biased_neighbor_sample if with_biases
          else sampling.homogeneous_uniform_neighbor_sample)
    return fn(G, start_list, fanout_vals,
              with_replacement=with_replacement, random_state=random_state,
              **kw)


def heterogeneous_neighbor_sample(G, start_list,
                                  starting_vertex_label_offsets=None,
                                  fanout_vals=None, *, num_edge_types=1,
                                  with_replacement=True, with_biases=False,
                                  random_state=None, **kw):
    """``heterogeneous_biased_neighbor_sample`` when ``with_biases``, else
    ``heterogeneous_uniform_neighbor_sample``.  As in the JAX package, the
    default ``num_edge_types=1`` samples type 0 alone, and
    ``with_replacement`` is passed on and ignored."""
    fn = (sampling.heterogeneous_biased_neighbor_sample if with_biases
          else sampling.heterogeneous_uniform_neighbor_sample)
    return fn(G, start_list, fanout_vals, num_edge_types=num_edge_types,
              with_replacement=with_replacement, random_state=random_state,
              **kw)


# -- coefficient aliases (the reference exports both names) -------------------

def sorensen_coefficient(G, vertex_pair=None, use_weight=False):
    return link_prediction.sorensen(G, vertex_pair, use_weight)


def overlap_coefficient(G, vertex_pair=None, use_weight=False):
    return link_prediction.overlap(G, vertex_pair, use_weight)


def cosine_coefficient(G, vertex_pair=None, use_weight=False):
    return link_prediction.cosine(G, vertex_pair, use_weight)


def ego_graph(G, n, radius=1, center=True, undirected=None, distance=None):
    """cugraph.ego_graph (community/egonet.py:30): the induced subgraph of
    the vertices within ``radius`` of n, as a Graph of G's class,
    directedness and device; an isolated center gives a graph of that one
    vertex."""
    from cugraph_tpu_torch.algos.community import batched_ego_graphs

    df, _ = batched_ego_graphs(G, np.asarray([n]), radius)
    out = type(G)(directed=G.is_directed(), device=G.device)
    if len(df) == 0:
        empty = np.asarray([], dtype=np.int64)
        return out.from_edgelist(empty, empty, None, vertices=np.asarray([n]))
    return out.from_edgelist(df["src"].to_numpy(), df["dst"].to_numpy(),
                             df["weight"].to_numpy(np.float32))


# -- constructors (structure/convert_matrix.py) -------------------------------

def _new(create_using):
    """A fresh graph: ``Graph()`` for None, ``create_using()`` for a class,
    and for an instance one of its class, directedness and device."""
    from cugraph_tpu_torch.api.graph import Graph

    if create_using is None:
        return Graph()
    if isinstance(create_using, type):
        return create_using()
    return type(create_using)(directed=create_using.is_directed(),
                              device=create_using.device)


def from_edgelist(df, source="source", destination="destination",
                  edge_attr=None, create_using=None, renumber=True):
    """cugraph.from_edgelist (convert_matrix.py:20)."""
    G = _new(create_using)
    w = df[edge_attr].to_numpy(np.float32) if edge_attr else None
    return G.from_edgelist(df[source].to_numpy(), df[destination].to_numpy(),
                           w, renumber=renumber)


def from_pandas_edgelist(df, source="source", destination="destination",
                         edge_attr=None, create_using=None, renumber=True):
    return from_edgelist(df, source, destination, edge_attr, create_using,
                         renumber)


def from_cudf_edgelist(df, source="source", destination="destination",
                       edge_attr=None, create_using=None, renumber=True):
    """Any pandas frame stands for the cudf frame."""
    return from_edgelist(df, source, destination, edge_attr, create_using,
                         renumber)


def from_adjlist(offsets, indices, values=None, create_using=None):
    """cugraph.from_adjlist (convert_matrix.py:111): CSR arrays; every
    row is a vertex, zero-degree rows included."""
    return _new(create_using).from_cudf_adjlist(offsets, indices, values)


def from_numpy_array(A, create_using=None, vertices=None):
    """cugraph.from_numpy_array (convert_matrix.py:435): the values of
    ``A`` become the edge weights (``Graph.from_numpy_array``)."""
    return _new(create_using).from_numpy_array(np.asarray(A), nodes=vertices)


def from_numpy_matrix(A, create_using=None):
    return from_numpy_array(A, create_using)


def from_pandas_adjacency(df, create_using=None):
    """A labelled dense adjacency frame."""
    return from_numpy_array(df.to_numpy(), create_using,
                            vertices=np.asarray(df.columns))


# -- exporters ----------------------------------------------------------------

def to_pandas_edgelist(G, source="src", destination="dst",
                       weight="weights"):
    el = G.view_edge_list()
    out = pd.DataFrame({source: el["src"], destination: el["dst"]})
    if "weight" in el.columns:
        out[weight] = el["weight"]
    return out


def _positions(nodelist, ids):
    """The index in ``nodelist`` of each id, the last one where an id is
    listed twice (a dict built by enumeration keeps the last); KeyError
    for an id that is not listed."""
    order = np.argsort(nodelist, kind="stable")
    ordered = nodelist[order]
    at = np.searchsorted(ordered, ids, side="right") - 1
    missing = (at < 0) | (ordered[np.maximum(at, 0)] != ids)
    if missing.any():
        raise KeyError(ids[np.flatnonzero(missing)[0]].item())
    return order[at]


def to_numpy_array(G, nodelist=None, dtype=np.float32):
    """The dense adjacency in ``nodelist`` order (the sorted vertices with
    edges by default), built on the graph's device and copied to the host
    once.  As in the JAX package, where two edges land on one cell the
    later write in ``view_edge_list`` order wins, an undirected edge
    writing A[s, d] and then A[d, s]: write k goes to position k (2i and
    2i + 1 for edge i), each cell takes its largest position through an
    integer ``scatter_reduce_`` "amax" into an int64 [n·n] tracker, exact
    whatever the order of the scatter, and each cell is written once."""
    el = G.view_edge_list()
    src, dst = el["src"].to_numpy(), el["dst"].to_numpy()
    if nodelist is None:
        nodelist = np.unique(np.concatenate([src, dst]))
    nodelist = np.asarray(nodelist)
    n = len(nodelist)
    rows = torch.from_numpy(_positions(nodelist, src).astype(np.int64))
    cols = torch.from_numpy(_positions(nodelist, dst).astype(np.int64))
    if G.is_directed():
        cells = rows * n + cols
    else:
        cells = torch.stack([rows * n + cols, cols * n + rows], 1).reshape(-1)
    tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    w = (torch.from_numpy(el["weight"].to_numpy(copy=True))
         if "weight" in el.columns else torch.ones(len(el)))
    dev = G.device
    cells = cells.to(dev)
    writes = torch.arange(cells.shape[0], device=dev)
    last = torch.full((n * n,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, cells, writes, "amax")
    hit = torch.nonzero(last >= 0)[:, 0]
    edge = last[hit] // (1 if G.is_directed() else 2)
    A = torch.zeros(n * n, dtype=tdtype, device=dev)
    A[hit] = w.to(dev)[edge].to(tdtype)
    return A.reshape(n, n).cpu().numpy()


def to_numpy_matrix(G, nodelist=None, dtype=np.float32):
    return np.asmatrix(to_numpy_array(G, nodelist, dtype))


def to_pandas_adjacency(G, nodelist=None, dtype=np.float32):
    if nodelist is None:
        el = G.view_edge_list()
        nodelist = np.unique(np.concatenate([el["src"], el["dst"]]))
    A = to_numpy_array(G, nodelist, dtype)
    return pd.DataFrame(A, index=nodelist, columns=nodelist)


# -- predicates (NetworkX style) ----------------------------------------------

def is_directed(G):
    return G.is_directed()


def is_weighted(G):
    return G.is_weighted()


def is_multigraph(G):
    return getattr(G, "is_multigraph", lambda: False)()


def is_bipartite(G):
    return getattr(G, "is_bipartite", lambda: False)()


def is_multipartite(G):
    return getattr(G, "is_multipartite", lambda: False)()


# -- traversal aliases (traversal/bfs.py:199, sssp.py:263) --------------------

def bfs_edges(G, source, reverse=False, depth_limit=None,
              sort_neighbors=None):
    """``bfs`` under its NetworkX name; ``reverse`` and
    ``sort_neighbors`` are not implemented, as in the reference."""
    if reverse or sort_neighbors is not None:
        raise NotImplementedError("reverse/sort_neighbors not supported "
                                  "(matching the reference)")
    return traversal.bfs(G, source, depth_limit=depth_limit)


def shortest_path(G, source=None, method=None, directed=None,
                  return_predecessors=None, unweighted=None, overwrite=None,
                  indices=None):
    """``sssp`` under its NetworkX name; ``indices`` stands for ``source``
    when ``source`` is not given."""
    if source is None and indices is not None:
        source = indices
    return traversal.sssp(G, source)


# -- symmetrize (structure/symmetrize.py) -------------------------------------

def symmetrize_df(df, src_name="src", dst_name="dst", weight_name=None,
                  multi=False, symmetrize=True):
    if not symmetrize:
        return df
    return structure.symmetrize(df, src_name=src_name, dst_name=dst_name,
                                value_col=weight_name)


def symmetrize_ddf(df, src_name="src", dst_name="dst", weight_name=None,
                   multi=False, symmetrize=True):
    """The dask-frame variant: a pandas frame here, as ``symmetrize_df``."""
    return symmetrize_df(df, src_name, dst_name, weight_name, multi,
                         symmetrize)
