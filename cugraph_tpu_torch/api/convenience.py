"""Multi-source BFS entry points (reference traversal/ms_bfs.py), the
unified homogeneous and heterogeneous sampling entry points
(sampling/homogeneous_neighbor_sample.py:44) and the similarity
coefficient aliases.

Counterpart of ``multi_source_bfs``, ``concurrent_bfs``,
``homogeneous_neighbor_sample``, ``heterogeneous_neighbor_sample``,
``sorensen_coefficient``,
``overlap_coefficient``, ``cosine_coefficient`` and ``ego_graph`` in
``cugraph_tpu.api.convenience``.  The
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

from cugraph_tpu_torch.algos import link_prediction, sampling, traversal
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
