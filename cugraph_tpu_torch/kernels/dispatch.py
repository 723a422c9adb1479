"""Kernel-level building blocks that algorithms share.

Counterpart of ``cugraph_tpu.kernels.dispatch``'s ``per_v_random_select``
(reference per_v_random_select_transform_outgoing_e.cuh): one uniformly
random out-neighbour per vertex in two launches over the CSR, the min/max
SpMV K2 in (max, right) over per-edge random priorities, then the argmax
select K3 in eqsel.  The JAX package's push plan, its ``split3``
precision and its float32 id reconstruction (hence its 2^24 vertex bound)
are TPU machinery: K3 carries int32 ids.
"""

from __future__ import annotations

import torch

from cugraph_tpu_torch.kernels.semiring import spmv_select, spmv_semiring

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
