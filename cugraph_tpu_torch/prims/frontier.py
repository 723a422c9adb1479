"""Frontier primitives: dense-bitmap frontiers and their expansion.

Counterpart of ``cugraph_tpu.prims.frontier`` (reference vertex_frontier.cuh
and transform_reduce_if_v_frontier_outgoing_e_by_dst.cuh:113-213).  A
frontier is a bool [num_vertices] tensor.  ``frontier_expand_by_dst`` is one
pull over the CSC through the min/max SpMV (kernel K2, int32 "left" under
max), so the predecessor ids it returns need no float bound.
"""

from __future__ import annotations

import torch

from cugraph_tpu_torch.core.structure import GraphStructure
from cugraph_tpu_torch.prims.vertex_edge import semiring_by_major


def bitmap_from_vertices(vertices: torch.Tensor,
                         num_vertices: int) -> torch.Tensor:
    """Bool [num_vertices] mask of a list of vertex ids.  Ids outside
    [0, num_vertices), such as the -1 sentinel, are dropped."""
    vertices = vertices.to(torch.int64)
    ok = (vertices >= 0) & (vertices < num_vertices)
    mask = torch.zeros(num_vertices + 1, dtype=torch.bool,
                       device=vertices.device)
    # out-of-range ids land in the extra slot, which is cut off
    mask.scatter_(0, torch.where(ok, vertices, num_vertices), True)
    return mask[:num_vertices]


def vertices_from_bitmap(mask: torch.Tensor, num_vertices: int) -> torch.Tensor:
    """The ids set in ``mask``, ascending (int64; syncs with the host)."""
    return torch.nonzero(mask[:num_vertices]).flatten()


def frontier_expand_by_dst(g: GraphStructure, frontier: torch.Tensor,
                           eligible: torch.Tensor):
    """One level of expansion along out-edges, deduplicated by destination.

    Returns (next frontier bool, predecessor int32): predecessor[v] is the
    largest-id frontier in-neighbour of a newly reached, eligible v, else
    -1 (the reference's reduce_op::any made deterministic, bfs_impl.cuh:
    449-466).  One K2 (max, left) launch over the CSC with x = the id on the
    frontier and -1 elsewhere; a row with no edges gets INT32_MIN."""
    ids = torch.arange(g.num_vertices, dtype=torch.int32, device=g.device)
    x = torch.where(frontier, ids, -1)
    pred = semiring_by_major(g.csc, x, "max")
    nxt = (pred >= 0) & eligible
    return nxt, torch.where(nxt, pred, -1)
