"""DAG: topological sort.

Counterpart of ``cugraph_tpu.algos.dag`` (reference
cpp/src/dag/topological_sort_impl.cuh:39).  Kahn levels by dense in-degree
peeling: each level removes every vertex whose in-degree is zero at once,
and the in-degree decrement of the level, Σ over in-edges (u, v) of
removed[u], is one launch of the sum SpMV K1 in its "left" mode over the
CSC on the level's 0/1 mask (``kernels/csrc/spmv_csr.cu``).  K1 sums in
fp32, exact for counts below 2^24.  The loop stops as the JAX package's
``while_loop`` does, when no in-degree is zero or the level passes n: one
host sync per level.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from cugraph_tpu_torch.kernels.spmv import spmv_csr

_EXACT_COUNT = 1 << 24  # fp32 counts are exact below this


def _topo_levels(g) -> torch.Tensor:
    """int32 [n]: each vertex's Kahn level, or -1 on or behind a cycle."""
    n = g.num_vertices
    csc = g.csc
    indeg = csc.degrees()
    if n and int(indeg.max()) >= _EXACT_COUNT:
        raise ValueError(f"an in-degree of {_EXACT_COUNT} or more is not "
                         "exact in K1's fp32 sums")
    level = torch.full((n,), -1, dtype=torch.int32, device=g.device)
    zero = indeg == 0
    lvl = 0
    while lvl <= n and bool(zero.any()):
        level.masked_fill_(zero, lvl)
        dec = spmv_csr(csc.offsets, csc.indices, None, zero.float(), "left")
        indeg = torch.where(zero, -1, indeg - dec.to(torch.int32))
        zero = indeg == 0
        lvl += 1
    return level


def topological_sort(G):
    """Topological ordering of a DAG: ['vertex', 'level'] by level, ties
    by internal id.  Raises ValueError on a cycle or an undirected
    graph."""
    if not G.is_directed():
        raise ValueError("topological_sort requires a directed graph")
    n = G.number_of_vertices()
    level = _topo_levels(G.structure).cpu().numpy()
    if (level < 0).any():
        raise ValueError("graph contains a cycle")
    order = np.lexsort((np.arange(n), level))
    return pd.DataFrame({"vertex": G.number_map.to_external(order),
                         "level": level[order]})
