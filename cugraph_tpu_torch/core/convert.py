"""Carry a graph structure across from the JAX package.

``structure_from_jax_arrays`` takes the arrays of a ``cugraph_tpu``
``GraphStructure`` as NumPy (``np.asarray(G.structure.csc.offsets)`` and so
on), drops the sink row and the padding that XLA's static shapes need, and
returns this package's structure.  It imports nothing of JAX: the caller
does the conversion to NumPy, so both packages can be fed the same graph.
"""

from __future__ import annotations

import numpy as np
import torch

from cugraph_tpu_torch.core.structure import (CsrMatrix, GraphStructure,
                                              check_edge_count,
                                              resolve_device)


def _csr_from_padded(offsets, indices, weights, num_vertices: int,
                     num_edges: int, device) -> CsrMatrix:
    offsets = np.asarray(offsets)
    if offsets.shape[0] < num_vertices + 1 or \
            int(offsets[num_vertices]) != num_edges:
        raise ValueError("padded offsets do not hold num_vertices rows "
                         "covering num_edges edges")
    return CsrMatrix(
        offsets=torch.as_tensor(
            offsets[:num_vertices + 1].astype(np.int32), device=device),
        indices=torch.as_tensor(
            np.asarray(indices)[:num_edges].astype(np.int32), device=device),
        weights=torch.as_tensor(
            np.asarray(weights)[:num_edges].astype(np.float32),
            device=device))


def structure_from_jax_arrays(csr, csc, num_vertices: int, num_edges: int,
                              device=None) -> GraphStructure:
    """``csr`` and ``csc`` are (offsets, indices, weights) NumPy triples of
    the padded JAX orientation of the same name."""
    check_edge_count(num_edges)
    dev = resolve_device(device)
    return GraphStructure(
        csr=_csr_from_padded(*csr, num_vertices, num_edges, dev),
        csc=_csr_from_padded(*csc, num_vertices, num_edges, dev))
