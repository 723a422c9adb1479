"""Multi-source BFS entry points (reference traversal/ms_bfs.py).

Counterpart of ``multi_source_bfs`` and ``concurrent_bfs`` in
``cugraph_tpu.api.convenience``.  The distances come from the panels of
``algos/traversal.py``; the predecessors from the JAX package's host pass
over the edge list (convenience.py:240-242), in the same edge order, so
that the same in-neighbour one level up wins.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from cugraph_tpu_torch.algos import traversal
from cugraph_tpu_torch.algos._utils import (normalize_start, source_panels,
                                            unrenumber_column)


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
    sweep = (traversal._msbfs_serial if strategy == "serial"
             else traversal._msbfs_panel)
    stats = {"algo": "multi_source_bfs", "strategy": strategy, "panels": 0,
             "levels": [], "syncs": 0}
    dl = None if depth_limit is None else int(depth_limit)
    out = {"vertex": G.number_map.to_external(np.arange(n))}
    for panel, i, count in source_panels(s_int):
        dist = sweep(g, panel, stats)[:, :count].cpu().numpy()
        stats["panels"] += 1
        for b in range(count):
            db = dist[:, b].astype(np.int64)
            if dl is not None:
                db = np.where(db > dl, -1, db)
            ok = (db[src_i] >= 0) & (db[src_i] + 1 == db[dst_i])
            pred = np.full(n, -1, np.int64)
            pred[dst_i[ok]] = src_i[ok]
            s_ext = int(sources[i + b])
            out[f"distance_{s_ext}"] = np.where(
                db < 0, traversal.INT32_INF, db).astype(np.int32)
            out[f"predecessor_{s_ext}"] = unrenumber_column(G, pred)
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
