"""Per-vertex / per-edge transform-reduce primitives (single device).

Counterpart of ``cugraph_tpu.prims.vertex_edge`` (reference
prims/per_v_transform_reduce_incoming_outgoing_e.cuh:402,
transform_reduce_e.cuh:670, transform_e.cuh, transform_reduce_v.cuh).
``spmv_pull``/``spmv_push`` run the hand-written sum SpMV
(kernels/spmv.py) over the CSC/CSR, ``semiring_by_major`` the min/max
SpMV and ``select_by_major`` the argmax select (kernels/semiring.py) over
either, ``spmm_by_major`` and ``spmm_semiring_by_major`` the sum and
min/max SpMM (kernels/spmm.py); the general primitives are plain torch, a
gather plus a segment reduction, as the JAX package leaves them to XLA.
Nothing is padded: vertex vectors are [num_vertices], edge vectors
[num_edges].
"""

from __future__ import annotations

import torch

from cugraph_tpu_torch.core.structure import CsrMatrix, GraphStructure
from cugraph_tpu_torch.kernels.semiring import spmv_select, spmv_semiring
from cugraph_tpu_torch.kernels.spmm import spmm_csr, spmm_semiring
from cugraph_tpu_torch.kernels.spmv import spmv_csr

_SCATTER_REDUCE = {"sum": "sum", "min": "amin", "max": "amax",
                   "prod": "prod"}


def _identity(op: str, dtype: torch.dtype):
    """The value a vertex with no edges gets (jax.ops.segment_* agree)."""
    if op == "sum":
        return 0
    if op == "prod":
        return 1
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def segment_reduce_by_major(adj: CsrMatrix, values: torch.Tensor,
                            op: str = "sum") -> torch.Tensor:
    """Reduce per-edge values [E, ...] to per-row values [V, ...].  A float
    sum or product runs over the CSR's rows in edge order
    (``torch.segment_reduce``, no float atomics: the card's result is the
    same on every run); integer sums and every min/max are exact in any
    order and scatter."""
    if op in ("sum", "prod") and values.dtype.is_floating_point:
        return torch.segment_reduce(values, op, lengths=adj.degrees(),
                                    axis=0)
    rows = adj.row_ids()
    out = torch.full((adj.num_vertices, *values.shape[1:]),
                     _identity(op, values.dtype), dtype=values.dtype,
                     device=values.device)
    index = rows.view(-1, *([1] * (values.dim() - 1))).expand_as(values)
    return out.scatter_reduce_(0, index, values, _SCATTER_REDUCE[op],
                               include_self=True)


class _GatherRows(torch.autograd.Function):
    """``x[index]`` whose backward sums each row's gradient in a fixed
    order: ``layout`` is (order, lengths), the stable sort of ``index``
    (None where ``index`` is already sorted) and the count of each row, so
    the backward is one ``segment_reduce`` where autograd's own would
    scatter with float atomics on the card."""

    @staticmethod
    def forward(ctx, x, index, layout):
        ctx.layout = layout
        return x[index]

    @staticmethod
    def backward(ctx, grad):
        order, lengths = ctx.layout
        if order is not None:
            grad = grad[order]
        return torch.segment_reduce(grad, "sum", lengths=lengths,
                                    axis=0), None, None


def gather_rows(x: torch.Tensor, index: torch.Tensor,
                layout) -> torch.Tensor:
    """``x[index]`` along dim 0, differentiable in a fixed order (see
    ``_GatherRows``): ``layout`` is (None, counts) for a sorted index, or
    (stable order, counts) as ``CsrMatrix.minor_layout`` gives it."""
    if not (x.requires_grad and x.dtype.is_floating_point):
        return x[index]
    return _GatherRows.apply(x, index, layout)


def gather_minor(adj: CsrMatrix, vertex_values: torch.Tensor) -> torch.Tensor:
    """Per-edge value of the minor endpoint (the column, ``indices``)."""
    index = adj.indices.to(torch.int64)
    if not vertex_values.requires_grad:
        return vertex_values[index]
    return gather_rows(vertex_values, index, adj.minor_layout)


def gather_major(adj: CsrMatrix, vertex_values: torch.Tensor) -> torch.Tensor:
    """Per-edge value of the major endpoint (the row)."""
    return gather_rows(vertex_values, adj.row_ids(), (None, adj.degrees()))


def _apply_e_op(adj: CsrMatrix, e_op, src_values, dst_values,
                incoming: bool):
    """e_op(src_val, dst_val, weight) per edge; for ``incoming`` the adj is
    the CSC (row = dst, index = src)."""
    src_of, dst_of = ((gather_minor, gather_major) if incoming
                      else (gather_major, gather_minor))
    s = None if src_values is None else src_of(adj, src_values)
    d = None if dst_values is None else dst_of(adj, dst_values)
    return e_op(s, d, adj.weights)


def per_v_transform_reduce_incoming_e(g: GraphStructure, e_op, *,
                                      src_values=None, dst_values=None,
                                      reduce_op: str = "sum") -> torch.Tensor:
    """y[v] = reduce over in-edges (u,v) of e_op(src_val[u], dst_val[v], w)."""
    vals = _apply_e_op(g.csc, e_op, src_values, dst_values, incoming=True)
    return segment_reduce_by_major(g.csc, vals, reduce_op)


def per_v_transform_reduce_outgoing_e(g: GraphStructure, e_op, *,
                                      src_values=None, dst_values=None,
                                      reduce_op: str = "sum") -> torch.Tensor:
    """y[u] = reduce over out-edges (u,v) of e_op(src_val[u], dst_val[v], w)."""
    vals = _apply_e_op(g.csr, e_op, src_values, dst_values, incoming=False)
    return segment_reduce_by_major(g.csr, vals, reduce_op)


def spmv_pull(g: GraphStructure, x: torch.Tensor) -> torch.Tensor:
    """y[v] = sum over in-edges (u,v) of w_uv * x[u]."""
    return spmv_csr(g.csc.offsets, g.csc.indices, g.csc.weights, x, "mul")


def spmv_push(g: GraphStructure, x: torch.Tensor) -> torch.Tensor:
    """y[u] = sum over out-edges (u,v) of w_uv * x[v]."""
    return spmv_csr(g.csr.offsets, g.csr.indices, g.csr.weights, x, "mul")


def semiring_by_major(adj: CsrMatrix, x: torch.Tensor, reduce: str,
                      combine: str = "left") -> torch.Tensor:
    """y[r] = min/max over row r of COMBINE(x[minor], w) (kernel K2); a row
    with no edges gets the identity.  Over the CSC it pulls from in-edges,
    over the CSR from out-edges."""
    w = None if combine == "left" else adj.weights
    return spmv_semiring(adj.offsets, adj.indices, w, x, reduce, combine)


def select_by_major(adj: CsrMatrix, x: torch.Tensor, *, unit: bool,
                    atol: float, rtol: float) -> torch.Tensor:
    """y[r] = the largest minor id u on row r with
    |x[u] + w - x[r]| <= atol + rtol·|x[r]| and x[u] < x[r] (strictly
    closer), else -1 (kernel K3, eqsel_rel); ``unit`` takes w = 1 and reads
    no weights."""
    return spmv_select(adj.offsets, adj.indices, None if unit else adj.weights,
                       x, "eqsel_rel", atol, rtol)


def spmm_by_major(adj: CsrMatrix, x: torch.Tensor, *,
                  unit: bool) -> torch.Tensor:
    """Y[r, :] = sum over row r of w·X[minor, :] for X [V, F] (kernel K4);
    ``unit`` takes w = 1 and reads no weights.  Over the CSC it pulls from
    in-edges, over the CSR from out-edges."""
    return spmm_csr(adj.offsets, adj.indices, None if unit else adj.weights,
                    x)


def spmm_semiring_by_major(adj: CsrMatrix, x: torch.Tensor, reduce: str,
                           combine: str) -> torch.Tensor:
    """Y[r, :] = min/max over row r of COMBINE(w, X[minor, :]) for X [V, F]
    (kernel K5); a row with no edges gets the identity, ±1e30."""
    w = None if combine == "left" else adj.weights
    return spmm_semiring(adj.offsets, adj.indices, w, x, reduce, combine)


def transform_reduce_e(g: GraphStructure, e_op, *, src_values=None,
                       dst_values=None, init=0.0) -> torch.Tensor:
    """Sum over all edges of e_op(src_val[u], dst_val[v], w), plus
    ``init`` (reference transform_reduce_e.cuh:670).  One ``torch.sum``
    over the per-edge values in the CSR's order: a fixed-order reduction,
    no atomics, so the card gives the same bits on every run.  The JAX
    package's padding edges add zeros; there are none here."""
    vals = _apply_e_op(g.csr, e_op, src_values, dst_values, incoming=False)
    return torch.sum(vals) + init


def transform_e(g: GraphStructure, e_op, *, src_values=None,
                dst_values=None) -> torch.Tensor:
    """e_op(src_val[u], dst_val[v], w) per edge in the CSR's (by-source)
    order, SDDMM-shaped (reference transform_e.cuh): [num_edges], the JAX
    package's [pad_e] result cut to its first num_edges entries."""
    return _apply_e_op(g.csr, e_op, src_values, dst_values, incoming=False)


def count_if_e(g: GraphStructure, pred, *, src_values=None,
               dst_values=None) -> torch.Tensor:
    """int32 count of the edges where pred(src_val[u], dst_val[v], w)."""
    mask = _apply_e_op(g.csr, pred, src_values, dst_values, incoming=False)
    return torch.sum(mask.to(torch.int32), dtype=torch.int32)


def transform_reduce_v(g: GraphStructure, v_op, values: torch.Tensor,
                       init=0.0) -> torch.Tensor:
    """Sum of v_op(value[v]) over the vertices, plus ``init``."""
    return torch.sum(v_op(values)) + init


def reduce_v(g: GraphStructure, values: torch.Tensor,
             init=0.0) -> torch.Tensor:
    return transform_reduce_v(g, lambda x: x, values, init)


def count_if_v(g: GraphStructure, pred, values: torch.Tensor) -> torch.Tensor:
    """int32 count of the vertices where pred(value[v])."""
    return torch.sum(pred(values).to(torch.int32), dtype=torch.int32)


def vertex_mask(g: GraphStructure) -> torch.Tensor:
    """bool [num_vertices], all True: every vertex here is real (the JAX
    package's [pad_v] mask cut to its first num_vertices entries)."""
    return torch.ones(g.num_vertices, dtype=torch.bool, device=g.device)
