"""Kernel-level building blocks that algorithms share.

Counterpart of ``cugraph_tpu.kernels.dispatch``'s ``per_v_random_select``
(reference per_v_random_select_transform_outgoing_e.cuh): one uniformly
random out-neighbour per vertex in two launches over the CSR, the min/max
SpMV K2 in (max, right) over per-edge random priorities, then the argmax
select K3 in eqsel.  The JAX package's push plan, its ``split3``
precision and its float32 id reconstruction (hence its 2^24 vertex bound)
are TPU machinery: K3 carries int32 ids.

And of its spill helpers (``dispatch.py:35-73, 176-185``): the budget
above which a graph's edges stay on the host and stream through the card
(``kernels/spill.py``), the decision, the cached pull plan and the host
out-weights that route needs.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cugraph_tpu_torch.kernels.semiring import spmv_select, spmv_semiring
from cugraph_tpu_torch.kernels.spill import build_spilled_spmv_plan
from cugraph_tpu_torch.utils.memory import (device_memory_stats,
                                            estimate_graph_bytes)

# the priorities' range, as the JAX package draws them (dispatch.py:224)
PRIORITY_MIN = 1e-6


def priorities(num_edges: int, generator: torch.Generator,
               device) -> torch.Tensor:
    """float32 [num_edges], uniform in [1e-6, 1) from ``generator``."""
    u = torch.rand(num_edges, generator=generator, device=device)
    return torch.clamp(PRIORITY_MIN + (1.0 - PRIORITY_MIN) * u,
                       min=PRIORITY_MIN)


def _select_by_priority(csr, pri: torch.Tensor) -> torch.Tensor:
    """int32 [n]: for each row of ``csr``, the largest column id among the
    edges whose priority is the row's largest, -1 for a row with no edge.
    K2 (max, right) reads no x; K3 eqsel then takes, on row r, the largest
    ``indices[e]`` with pri[e] == y1[r]."""
    x = torch.zeros(csr.num_vertices, dtype=torch.float32, device=pri.device)
    y1 = spmv_semiring(csr.offsets, csr.indices, pri, x, "max", "right")
    return spmv_select(csr.offsets, csr.indices, pri, y1, "eqsel")


def per_v_random_select(G, generator: torch.Generator | None = None):
    """One uniformly random out-neighbour per vertex: int32 [n] on the
    graph's device, -1 where a vertex has no out-edge.  Parallel edges
    weigh by their multiplicity.  ``generator`` (a ``torch.Generator`` on
    the graph's device; None: one seeded with 0) gives the per-edge
    priorities, drawn over the CSR's edges in its order."""
    csr = G.structure.csr
    if generator is None:
        generator = torch.Generator(device=csr.device)
        generator.manual_seed(0)
    return _select_by_priority(
        csr, priorities(csr.num_edges, generator, csr.device))


# the smallest chunk of a spilled plan, whatever the budget
MIN_CHUNK_BYTES = 1 << 20


def spill_budget_bytes(device=None):
    """Device bytes a graph's structure may take before it spills:
    ``CUGRAPH_TPU_SPILL_BYTES`` (read per call), else half the card's
    memory, else None (a device with no counters, the CPU: no spill)."""
    v = os.environ.get("CUGRAPH_TPU_SPILL_BYTES")
    if v:
        return int(v)
    limit = device_memory_stats(device)["bytes_limit"]
    return limit // 2 if limit > 0 else None


def plan_needs_spill(G) -> bool:
    """Whether G's resident structure (both orientations,
    ``estimate_graph_bytes``) exceeds the budget of G's device."""
    budget = spill_budget_bytes(G.device)
    if budget is None:
        return False
    src, _, _ = G.edgelist_arrays()
    return estimate_graph_bytes(G.number_of_vertices(), len(src)) > budget


def get_pull_plan_spilled(G):
    """G's host CSC cut into chunks of a quarter of the budget (at least
    MIN_CHUNK_BYTES), built for G's device at first use and kept on G."""
    plan = G._spmv_plan_pull_spilled
    if plan is None:
        budget = spill_budget_bytes(G.device) or (256 << 20)
        src, dst, w = G.edgelist_arrays()
        plan = build_spilled_spmv_plan(
            src, dst, w, G.number_of_vertices(),
            max(budget // 4, MIN_CHUNK_BYTES), device=G.device)
        G._spmv_plan_pull_spilled = plan
    return plan


def out_weight_vectors(G):
    """(inv_out, is_dangling), NumPy [n]: each vertex's out-weight sum in
    float64 on the host (``np.bincount`` over the edge list), rounded once
    to float32, its float32 inverse (0 where the sum is not positive), and
    whether the sum is not positive."""
    src, _, w = G.edgelist_arrays()
    n = G.number_of_vertices()
    out_w = np.bincount(src, weights=w, minlength=n)[:n].astype(np.float32)
    inv_out = np.divide(np.float32(1.0), out_w, out=np.zeros_like(out_w),
                        where=out_w > 0)
    return inv_out, out_w <= 0
