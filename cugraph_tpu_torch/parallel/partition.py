"""The 2D edge partition: rank and range math, and each rank's edge block.

Counterpart of ``cugraph_tpu/parallel/partition.py`` (reference
``partition_t``/``partition_manager``, graph_view.hpp:64-230).  The rank
and range math (``Partition2D``, ``V_ALIGN``) is a copy of the JAX
package's, so ``pad_v``, the owned ranges, ``src_loc`` and ``dst_loc`` are
the same numbers:

* the padded vertex space [0, P·Vc) is split into P ranges of Vc; rank
  (i, j) owns [(i·pmin + j)·Vc, +Vc);
* pull edge (src, dst) lives on rank (i, j) with i = src // B (B = pmin·Vc,
  the row block the "minor" gather reconstructs) and j = (dst // Vc) % pmin;
* ``src_loc = src − i·B`` ∈ [0, B) and ``dst_loc = (dst // B)·Vc + dst %
  Vc`` ∈ [0, pmaj·Vc), the slot order of the "major" reduce-scatter.

Where the JAX package stacks every rank's block, padded to one length
[pmaj, pmin, E_loc] with a ``valid`` mask, a rank here holds only its own
block, as a CSR over the dst slots (``EdgeBlocks``): no padding lanes, so
``valid`` and ``E_ALIGN`` have no counterpart.  Inside a block the edges
keep the JAX order, by dst_loc, then src_loc, then input order.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace

import numpy as np
import torch

from cugraph_tpu_torch.core.structure import CsrMatrix, check_edge_count
from cugraph_tpu_torch.parallel import prims

V_ALIGN = 8


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class Partition2D:
    """Pure rank/range math for the 2D partition (no device data)."""

    num_vertices: int
    pmaj: int
    pmin: int
    chunk: int  # Vc: vertices per rank

    @staticmethod
    def create(num_vertices: int, pmaj: int, pmin: int) -> "Partition2D":
        p = pmaj * pmin
        chunk = round_up(max(round_up(num_vertices, p) // p, 1), V_ALIGN)
        return Partition2D(num_vertices, pmaj, pmin, chunk)

    @property
    def num_devices(self) -> int:
        return self.pmaj * self.pmin

    @property
    def pad_v(self) -> int:
        """Global padded vertex count (= P · Vc)."""
        return self.num_devices * self.chunk

    @property
    def row_block(self) -> int:
        """B: vertices per mesh row (gather span along "minor")."""
        return self.pmin * self.chunk

    def owner(self, v: np.ndarray):
        """(i, j) mesh coordinates of the rank owning each vertex."""
        r = np.asarray(v) // self.chunk
        return r // self.pmin, r % self.pmin

    def owned_range(self, i: int, j: int):
        lo = (i * self.pmin + j) * self.chunk
        return lo, lo + self.chunk

    # -- pull-edge placement (src gathered, dst reduced) ---------------------
    def edge_device(self, src: np.ndarray, dst: np.ndarray):
        i = np.asarray(src) // self.row_block
        j = (np.asarray(dst) // self.chunk) % self.pmin
        return i, j

    def src_local(self, src: np.ndarray, i: np.ndarray):
        return np.asarray(src) - i * self.row_block

    def dst_local(self, dst: np.ndarray):
        d = np.asarray(dst)
        return (d // self.row_block) * self.chunk + d % self.chunk


def _pad_rows(offsets: torch.Tensor, rows: int) -> torch.Tensor:
    """``offsets`` extended with empty rows up to ``rows`` rows."""
    extra = rows + 1 - offsets.shape[0]
    return torch.cat([offsets, offsets[-1:].expand(extra)]) if extra else \
        offsets


def _offsets(keys: torch.Tensor, rows: int) -> torch.Tensor:
    counts = torch.bincount(keys, minlength=rows)
    out = torch.zeros(rows + 1, dtype=torch.int64, device=keys.device)
    torch.cumsum(counts, 0, out=out[1:])
    return out.to(torch.int32)


@dataclass
class EdgeBlocks:
    """This rank's block of one orientation: a CSR whose row r is dst slot
    r ∈ [0, pmaj·Vc) and whose indices are the int32 ``src_loc`` ∈ [0, B).

    The kernels take square CSRs (one x entry per row), and a block is
    square only when pmaj == pmin: ``square`` is the block with
    max(pmaj, pmin)·Vc rows, the rows past pmaj·Vc empty, and
    ``transposed_square`` its transpose, rows src_loc, indices dst_loc,
    the same size; callers zero-pad x to that length and slice y."""

    offsets: torch.Tensor           # int32 [pmaj·Vc + 1]
    indices: torch.Tensor           # int32 [E], src_loc
    weights: torch.Tensor           # float32 [E]
    num_cols: int                   # B
    etype: torch.Tensor | None = None  # int32, per-edge type
    etime: torch.Tensor | None = None  # float32, per-edge time
    eid: torch.Tensor | None = None    # int32, input-edge instance index

    @property
    def num_segments(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def e_local(self) -> int:
        return self.indices.shape[0]

    @property
    def side(self) -> int:
        """Rows (and x entries) of ``square`` and ``transposed_square``."""
        return max(self.num_segments, self.num_cols)

    @functools.cached_property
    def dst_loc(self) -> torch.Tensor:
        """int64 [E]: each edge's row, its dst slot."""
        return torch.repeat_interleave(
            torch.arange(self.num_segments, device=self.offsets.device),
            (self.offsets[1:] - self.offsets[:-1]).to(torch.int64),
            output_size=self.e_local)

    @functools.cached_property
    def square(self) -> CsrMatrix:
        return CsrMatrix(_pad_rows(self.offsets, self.side), self.indices,
                         self.weights)

    @functools.cached_property
    def transposed_square(self) -> CsrMatrix:
        src = self.indices.to(torch.int64)
        order = torch.sort(src, stable=True).indices
        return CsrMatrix(_offsets(src, self.side),
                         self.dst_loc[order].to(torch.int32),
                         self.weights[order])

    def to(self, device) -> "EdgeBlocks":
        def move(t):
            return None if t is None else t.to(device)

        return EdgeBlocks(move(self.offsets), move(self.indices),
                          move(self.weights), self.num_cols,
                          move(self.etype), move(self.etime), move(self.eid))


@dataclass(frozen=True)
class DistGraph:
    """This rank's part of a 2D-partitioned graph: its pull block (src
    gathered, dst reduced), its push block (the transpose orientation) or
    None, and the weighted degrees of its owned vertices [Vc]."""

    pull: EdgeBlocks
    push: EdgeBlocks | None
    out_degree: torch.Tensor   # float32 [Vc]
    in_degree: torch.Tensor    # float32 [Vc]
    num_vertices: int
    num_edges: int             # global
    pmaj: int
    pmin: int
    chunk: int
    i: int
    j: int

    @property
    def part(self) -> Partition2D:
        return Partition2D(self.num_vertices, self.pmaj, self.pmin,
                           self.chunk)

    @property
    def pad_v(self) -> int:
        return self.pmaj * self.pmin * self.chunk

    def to(self, device) -> "DistGraph":
        return replace(self, pull=self.pull.to(device),
                       push=None if self.push is None else self.push.to(
                           device),
                       out_degree=self.out_degree.to(device),
                       in_degree=self.in_degree.to(device))


def _local_block(part: Partition2D, src_loc, dst_loc, weight, etype=None,
                 etime=None, eid=None, *, device) -> EdgeBlocks:
    """The CSR of one rank's edges, given as host arrays (src_loc,
    dst_loc, ...): sorted on ``device`` by (dst_loc, src_loc, given
    order)."""
    check_edge_count(len(src_loc))
    nseg, B = part.pmaj * part.chunk, part.row_block
    sl = torch.as_tensor(np.asarray(src_loc, np.int64), device=device)
    dl = torch.as_tensor(np.asarray(dst_loc, np.int64), device=device)
    order = torch.sort(dl * B + sl, stable=True).indices

    def col(a, dtype):
        if a is None:
            return None
        return torch.as_tensor(np.asarray(a, dtype), device=device)[order]

    weights = (col(weight, np.float32) if weight is not None else
               torch.ones(len(order), dtype=torch.float32, device=device))
    return EdgeBlocks(_offsets(dl, nseg), sl[order].to(torch.int32),
                      weights, B, col(etype, np.int32),
                      col(etime, np.float32), col(eid, np.int32))


def _owned_edges(part: Partition2D, i: int, j: int, minor_end, major_end):
    """(mask, src_loc, dst_loc) of the edges whose 2D owner is (i, j)."""
    minor_end = np.asarray(minor_end, np.int64)
    major_end = np.asarray(major_end, np.int64)
    ei, ej = part.edge_device(minor_end, major_end)
    keep = (ei == i) & (ej == j)
    return (keep, part.src_local(minor_end[keep], i),
            part.dst_local(major_end[keep]))


def build_block(part: Partition2D, i: int, j: int, minor_end, major_end,
                weight, etype=None, etime=None, eid=None, *,
                device) -> EdgeBlocks:
    """Rank (i, j)'s block of the COO list on ``device``: the edges whose
    2D owner is (i, j), ``minor_end`` gathered (the pull orientation's
    src) and ``major_end`` reduced.  A pure function of the partition,
    (i, j) and the COO; ``device`` has no default, so the caller names
    the card or the CPU."""
    keep, sl, dl = _owned_edges(part, i, j, minor_end, major_end)

    def pick(a):
        return None if a is None else np.asarray(a)[keep]

    return _local_block(part, sl, dl, pick(weight), pick(etype), pick(etime),
                        pick(eid), device=device)


def owned_degrees(mesh, part: Partition2D, src_loc, dst_loc, weight):
    """(out_degree, in_degree) of this rank's owned vertices [Vc] from its
    pull edges (host arrays): float64 partial sums over the row block and
    the dst slots, then reduce-scattered along "minor" and "major"."""
    B, nseg = part.row_block, part.pmaj * part.chunk
    w = np.asarray(weight, np.float64)
    out_part = np.bincount(np.asarray(src_loc, np.int64), w, minlength=B)
    in_part = np.bincount(np.asarray(dst_loc, np.int64), w, minlength=nseg)

    def put(a):
        return torch.from_numpy(a.astype(np.float32)).to(mesh.device)

    return (prims.scatter_reduce_minor_sum(mesh, put(out_part)),
            prims.scatter_reduce_major_sum(mesh, put(in_part)))


def build_dist_graph(
    src: np.ndarray,
    dst: np.ndarray,
    weight: np.ndarray | None,
    num_vertices: int,
    mesh,
    *,
    store_push: bool = True,
    symmetrize: bool = False,
    edge_type: np.ndarray | None = None,
    edge_time: np.ndarray | None = None,
    drop_self_loops: bool = False,
    drop_multi_edges: bool = False,
    store_eid: bool | None = None,
) -> DistGraph:
    """COO edge list, the same on every rank → this rank's DistGraph on
    ``mesh.device``.  The JAX package's (pmaj, pmin) come from ``mesh``;
    the keywords are its own (``partition.py:336-433``): duplicates keep
    their first occurrence and go before symmetrization, and ``store_eid``
    (None: whenever push blocks exist and a per-edge property was given)
    keeps the input instance index on the push block.  Every rank of the
    mesh calls this (the degrees are reduce-scattered)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    m = src.shape[0]
    w = np.ones(m, np.float32) if weight is None else np.asarray(weight,
                                                                 np.float32)
    if store_eid is None:
        store_eid = store_push and (weight is not None
                                    or edge_type is not None
                                    or edge_time is not None)
    eid = np.arange(m, dtype=np.int32) if store_eid else None

    def _filter(keep_idx):
        nonlocal src, dst, w, edge_type, edge_time, eid
        src, dst, w = src[keep_idx], dst[keep_idx], w[keep_idx]
        if edge_type is not None:
            edge_type = np.asarray(edge_type)[keep_idx]
        if edge_time is not None:
            edge_time = np.asarray(edge_time)[keep_idx]
        if eid is not None:
            eid = eid[keep_idx]

    if drop_self_loops:
        _filter(src != dst)
    if drop_multi_edges:
        key = (src << 32) | dst.astype(np.uint32).astype(np.int64)
        _, idx = np.unique(key, return_index=True)
        idx.sort()
        _filter(idx)
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        w = np.concatenate([w, w])
        if edge_type is not None:
            edge_type = np.concatenate([edge_type, edge_type])
        if edge_time is not None:
            edge_time = np.concatenate([edge_time, edge_time])
        if eid is not None:
            eid = np.concatenate([eid, eid])

    part = Partition2D.create(num_vertices, mesh.pmaj, mesh.pmin)
    i, j = mesh.i, mesh.j
    keep, sl, dl = _owned_edges(part, i, j, src, dst)

    def pick(a):
        return None if a is None else np.asarray(a)[keep]

    pull = _local_block(part, sl, dl, w[keep], pick(edge_type),
                        pick(edge_time), device=mesh.device)
    out_deg, in_deg = owned_degrees(mesh, part, sl, dl, w[keep])
    push = build_block(part, i, j, dst, src, w, edge_type, edge_time, eid,
                       device=mesh.device) if store_push else None
    return DistGraph(pull=pull, push=push, out_degree=out_deg,
                     in_degree=in_deg, num_vertices=num_vertices,
                     num_edges=int(src.shape[0]), pmaj=mesh.pmaj,
                     pmin=mesh.pmin, chunk=part.chunk, i=i, j=j)
