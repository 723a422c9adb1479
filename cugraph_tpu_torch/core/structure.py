"""Device-resident graph containers: the CSR/CSC pair as torch tensors.

Counterpart of ``cugraph_tpu.core.structure`` (reference ``graph_t`` and
``graph_view_t``, cpp/include/cugraph/graph.hpp:68-269,
graph_view.hpp:373).  The JAX package pads every array for XLA's static
shapes (a sink row, ``V_ALIGN``/``E_ALIGN``); here vectors have length
exactly ``num_vertices`` and edge arrays length exactly ``num_edges``.

Both orientations stay resident: ``csr`` holds edges sorted by (src, dst)
for the push direction, ``csc`` edges sorted by (dst, src) for the pull
direction (PageRank, HITS; reference pagerank_impl.cuh:336 takes the
transposed view).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CUDA device without a card is an error."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def check_edge_count(num_edges: int) -> None:
    """int32 offsets are a design bound of this CSR (and of the kernels
    that read it): a cumulative count past 2^31 - 1 would wrap negative."""
    if num_edges >= (1 << 31):
        raise ValueError(
            f"edge count {num_edges} exceeds the int32 CSR offset bound "
            "(2^31-1 edges per structure)")


@dataclass(frozen=True)
class CsrMatrix:
    """One sort order of the edge list plus its compressed offsets.

    Row ``r`` holds edges ``offsets[r]:offsets[r+1]``; ``indices[e]`` is the
    opposite endpoint and ``weights[e]`` the weight (1.0 when unweighted).
    ``perm[e]``, where the matrix was built from an edge list, is the
    position in that list of the edge stored at ``e``: the map that puts
    per-edge properties in this order (the JAX package's ``_csr_perm``).
    """

    offsets: torch.Tensor  # int32 [num_vertices + 1]
    indices: torch.Tensor  # int32 [num_edges]
    weights: torch.Tensor  # float32 [num_edges]
    perm: torch.Tensor | None = None  # int32 [num_edges]

    @property
    def num_vertices(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def num_edges(self) -> int:
        return self.indices.shape[0]

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def degrees(self) -> torch.Tensor:
        return self.offsets[1:] - self.offsets[:-1]

    def row_ids(self) -> torch.Tensor:
        """int64 [num_edges]: the row of every edge (the JAX ``majors``)."""
        return torch.repeat_interleave(
            torch.arange(self.num_vertices, device=self.device),
            self.degrees().to(torch.int64), output_size=self.num_edges)

    @functools.cached_property
    def minor_layout(self):
        """(order, counts): the stable sort of ``indices`` and each column's
        edge count, kept at first use, so that per-column sums (the
        backward of a gather by ``indices``) run in a fixed order."""
        index = self.indices.to(torch.int64)
        return (torch.sort(index, stable=True).indices,
                torch.bincount(index, minlength=self.num_vertices))


def build_csr(major, minor, weight, num_vertices: int,
              device) -> CsrMatrix:
    """Compress a COO edge list, sorted lexicographically by (major, minor)
    with a stable sort, so parallel edges keep their input order: the
    sort's order is ``np.lexsort((minor, major))``, kept as ``perm``."""
    major = torch.as_tensor(np.asarray(major, np.int32), device=device)
    minor = torch.as_tensor(np.asarray(minor, np.int32), device=device)
    check_edge_count(major.shape[0])
    key = (major.to(torch.int64) << 32) | minor.to(torch.int64)
    order = torch.sort(key, stable=True).indices
    if weight is None:
        weights = torch.ones(major.shape[0], dtype=torch.float32,
                             device=device)
    else:
        weights = torch.as_tensor(np.asarray(weight, np.float32),
                                  device=device)[order]
    counts = torch.bincount(major, minlength=num_vertices)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return CsrMatrix(offsets=offsets.to(torch.int32),
                     indices=minor[order].contiguous(),
                     weights=weights.contiguous(),
                     perm=order.to(torch.int32))


@dataclass(frozen=True)
class GraphStructure:
    """Both orientations of one graph (reference ``graph_view_t``)."""

    csr: CsrMatrix  # edges sorted by src (push; out-edges contiguous)
    csc: CsrMatrix  # edges sorted by dst (pull; in-edges contiguous)

    @property
    def num_vertices(self) -> int:
        return self.csr.num_vertices

    @property
    def num_edges(self) -> int:
        return self.csr.num_edges

    @property
    def device(self) -> torch.device:
        return self.csr.device

    def out_degrees(self) -> torch.Tensor:
        return self.csr.degrees()

    def in_degrees(self) -> torch.Tensor:
        return self.csc.degrees()

    @functools.cached_property
    def out_weight_sums(self) -> torch.Tensor:
        """float32 [num_vertices]: the weighted out-degree, summed in
        float64 over the CSR's rows in edge order (no atomics) on the
        structure's device at first use, rounded once and kept."""
        return torch.segment_reduce(self.csr.weights.double(), "sum",
                                    lengths=self.csr.degrees()).float()

    @functools.cached_property
    def in_weight_sums(self) -> torch.Tensor:
        """float32 [num_vertices]: the weighted in-degree, summed in
        float64 over the CSC's rows in edge order (no atomics) on the
        structure's device at first use, rounded once and kept."""
        return torch.segment_reduce(self.csc.weights.double(), "sum",
                                    lengths=self.csc.degrees()).float()

    @functools.cached_property
    def loop_free(self) -> "GraphStructure":
        """The same graph without its self-loops, built on the device at
        first use and kept: the K2 sweeps of MIS and coloring take no edge
        mask, and a vertex must not be its own neighbour there."""
        return GraphStructure(csr=_drop_loops(self.csr),
                              csc=_drop_loops(self.csc))


def _drop_loops(adj: CsrMatrix) -> CsrMatrix:
    rows = adj.row_ids()
    keep = adj.indices.to(torch.int64) != rows
    counts = torch.zeros(adj.num_vertices, dtype=torch.int64,
                         device=adj.device)
    counts.index_add_(0, rows, keep.to(torch.int64))
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return CsrMatrix(offsets=offsets.to(torch.int32),
                     indices=adj.indices[keep].contiguous(),
                     weights=adj.weights[keep].contiguous())


def build_structure(src, dst, weight, num_vertices: int,
                    device) -> GraphStructure:
    dev = resolve_device(device)
    return GraphStructure(
        csr=build_csr(src, dst, weight, num_vertices, dev),
        csc=build_csr(dst, src, weight, num_vertices, dev))
