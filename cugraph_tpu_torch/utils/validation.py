"""Expensive-check validation (the reference's ``do_expensive_check``
model: O(V+E) invariant checks behind flags threaded through the API,
e.g. pagerank_impl.cuh:347, utilities/validation_checks.hpp).

Counterpart of ``cugraph_tpu.utils.validation``.  The edge-list checks run
in NumPy on the host; ``validate_structure`` checks the port's unpadded
CSR and CSC on their own device, with one host read at the end.
``CUGRAPH_TPU_EXPENSIVE_CHECKS=1`` turns the checks on globally.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cugraph_tpu_torch.api.exceptions import InvalidInputError


def checks_enabled(flag: bool | None = None) -> bool:
    if flag is not None:
        return bool(flag)
    return bool(os.environ.get("CUGRAPH_TPU_EXPENSIVE_CHECKS"))


def validate_edgelist(src, dst, weight=None, num_vertices=None):
    """O(E) edge-list invariants (create_graph_from_edgelist's expensive
    checks): ids in range, no negatives, finite weights."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    if src.shape != dst.shape:
        raise InvalidInputError("src/dst length mismatch")
    if src.size:
        if src.min(initial=0) < 0 or dst.min(initial=0) < 0:
            raise InvalidInputError("negative vertex id in edge list")
        if num_vertices is not None:
            if (src.max(initial=-1) >= num_vertices
                    or dst.max(initial=-1) >= num_vertices):
                raise InvalidInputError("vertex id out of range")
    if weight is not None:
        w = np.asarray(weight)
        if w.shape != src.shape:
            raise InvalidInputError("weight length mismatch")
        if not np.all(np.isfinite(w)):
            raise InvalidInputError("non-finite edge weight")


def validate_structure(g) -> None:
    """O(V+E) invariants of both orientations of a ``GraphStructure``:
    offsets start at 0, never fall and end at the edge count; every index
    is a vertex; weights and the kept permutation have one entry per
    edge.  (The JAX package's structure also has padding and a
    ``majors`` array to check; the port's has neither.)"""
    for adj in (g.csr, g.csc):
        offs = adj.offsets.to(torch.int64)
        idx = adj.indices
        flags = torch.stack([
            offs[0] != 0 if offs.numel() else torch.tensor(True),
            (offs[1:] < offs[:-1]).any(),
            offs[-1] != idx.shape[0] if offs.numel() else torch.tensor(True),
            ((idx < 0) | (idx >= adj.num_vertices)).any()
            if idx.numel() else torch.tensor(False)]).cpu().tolist()
        for bad, why in zip(flags, ("CSR offsets do not start at 0",
                                    "CSR offsets not monotone",
                                    "CSR offsets do not cover the edge array",
                                    "CSR index out of range")):
            if bad:
                raise InvalidInputError(why)
        sizes = [adj.weights.shape[0]]
        if adj.perm is not None:
            sizes.append(adj.perm.shape[0])
        if any(s != idx.shape[0] for s in sizes):
            raise InvalidInputError("CSR edge arrays differ in length")


def validate_vertex_subset(G, vertices) -> np.ndarray:
    """Check every vertex exists; returns internal ids (raises otherwise)."""
    return G.lookup_internal_vertex_id(np.asarray(vertices))
