"""Components: weakly connected components.

Counterpart of ``cugraph_tpu.algos.components`` (reference
weakly_connected_components_impl.cuh:682-1037): min-label propagation with
pointer jumping.  A sweep takes each vertex's smallest neighbour label
through the min/max SpMV (kernel K2, int32 "left" under min): over the CSC
and over the CSR for a directed graph, whose edges count both ways, and
over the CSC alone for an undirected one, whose CSC already holds both
directions.  Labels are int32 vertex ids, so no float bound applies (the
JAX package's Pallas route refuses 2^24 vertices or more).  The loop reads
one flag back per sweep.  SCC, MIS and coloring are later slices
(``ROADMAP.md``).
"""

from __future__ import annotations

import torch

from cugraph_tpu_torch.algos._utils import vertex_frame
from cugraph_tpu_torch.prims.vertex_edge import semiring_by_major

# sweeps of the last weakly_connected_components call
LAST_SWEEPS = 0


def _wcc_labels(g, directed: bool) -> torch.Tensor:
    """The smallest internal id in each vertex's component, int32."""
    global LAST_SWEEPS
    label = torch.arange(g.num_vertices, dtype=torch.int32, device=g.device)
    sweeps, changed = 0, g.num_vertices > 0
    while changed:
        new = torch.minimum(label, semiring_by_major(g.csc, label, "min"))
        if directed:
            new = torch.minimum(new, semiring_by_major(g.csr, label, "min"))
        # pointer jumping: compress toward the root (components.py:79)
        new = torch.minimum(new, new[new.to(torch.int64)])
        changed = not torch.equal(new, label)
        label = new
        sweeps += 1
    LAST_SWEEPS = sweeps
    return label


def weakly_connected_components(G, directed=None, connection=None,
                                return_labels=None):
    """WCC; returns ['vertex', 'labels']: the label is the smallest internal
    vertex id in the component, mapped back to its external id (the
    reference returns arbitrary roots,
    weakly_connected_components_impl.cuh:1037)."""
    label = _wcc_labels(G.structure, G.is_directed()).cpu().numpy()
    return vertex_frame(G, {"labels": G.number_map.to_external(label)})


def connected_components(G, directed=None, connection="weak",
                         return_labels=None):
    if connection == "weak":
        return weakly_connected_components(G)
    if connection == "strong":
        raise NotImplementedError(
            "connection='strong' (SCC) is not ported yet: ROADMAP.md §1, "
            "item 11")
    raise ValueError(f"unknown connection type {connection!r}")
