"""Shard-level primitives of the multi-device layer, one process per rank.

Counterpart of ``cugraph_tpu/parallel/prims.py``, whose functions run
inside ``jax.shard_map`` and name the mesh axes.  Here each function runs
on one rank, takes the ``Mesh2D``, and issues ``torch.distributed``
collectives on its groups:

| JAX (``prims.py``) | here |
|---|---|
| ``gather_minor_block`` / ``gather_major_block`` (``all_gather``) | ``all_gather_into_tensor`` on the row / column group |
| ``scatter_reduce_major_sum`` / ``_minor_sum`` (``psum_scatter``) | ``reduce_scatter_tensor`` (SUM) on the column / row group |
| ``scatter_reduce_major`` min/max (``pmin``/``pmax``, then a slice) | ``all_reduce`` MIN/MAX on the column group, then the owned slice |
| ``psum_all`` | ``all_reduce`` (SUM) on the mesh's group |
| ``pull_spmv_systolic``'s ``ppermute`` ring | ``batch_isend_irecv`` around the row |

The gathers and reduce-scatters are autograd Functions, each the other's
transpose (a gather's backward reduce-scatters the gradient over the same
group, and the reverse), so the MG SpMM and the attention layers
differentiate through them.  ``pull_spmv`` runs K1 (``kernels/spmv``,
"mul") and ``pull_spmm`` K4 with its VJP (``kernels/spmm``) over the
rank's local CSR, where the JAX package reaches ``spmv_onehot`` and
``spmm_onehot`` through stacked TPU plans (``prims.py:115-118``,
``nn.py:55-106``).  Every rank joins every collective, a rank whose block
has no edges too.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from cugraph_tpu_torch.kernels.spmm import make_spmm_pair, spmm_csr
from cugraph_tpu_torch.kernels.spmv import spmv_csr

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


class _Gather(torch.autograd.Function):
    """Tiled all-gather along dim 0 over ``group`` (``size`` ranks); the
    backward reduce-scatters the gradient."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        x = x.contiguous()
        out = x.new_empty((size * x.shape[0],) + x.shape[1:])
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _ReduceScatter.apply(grad, ctx.group, ctx.size), None, None


class _ReduceScatter(torch.autograd.Function):
    """Tiled sum-reduce-scatter along dim 0 over ``group``; the backward
    all-gathers the gradient."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        x = x.contiguous()
        out = x.new_empty((x.shape[0] // size,) + x.shape[1:])
        dist.reduce_scatter_tensor(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _Gather.apply(grad, ctx.group, ctx.size), None, None


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group`` on every rank; so is the backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def my_coords(mesh):
    return mesh.i, mesh.j


def global_vertex_ids(mesh, chunk: int) -> torch.Tensor:
    """Global ids of this rank's owned vertex slots, int32 [chunk]."""
    base = mesh.rank * chunk
    return torch.arange(base, base + chunk, dtype=torch.int32,
                        device=mesh.device)


def gather_minor_block(mesh, x_own: torch.Tensor) -> torch.Tensor:
    """Owned slices [Vc, ...] → this mesh row's row block [B, ...]: the
    reference's minor-comm property broadcast
    (update_edge_src_dst_property.cuh:163-224)."""
    return _Gather.apply(x_own, mesh.minor, mesh.pmin)


def gather_major_block(mesh, x_own: torch.Tensor) -> torch.Tensor:
    """Owned slices [Vc, ...] → this mesh column's dst-slot space
    [pmaj·Vc, ...], in dst_loc order."""
    return _Gather.apply(x_own, mesh.major, mesh.pmaj)


def scatter_reduce_major_sum(mesh, part: torch.Tensor) -> torch.Tensor:
    """Per-dst partials [pmaj·Vc, ...] → summed owner slices [Vc, ...]:
    the reference's device_reduce to the vertex owner
    (detail/per_v_transform_reduce_e.cuh:3397)."""
    return _ReduceScatter.apply(part, mesh.major, mesh.pmaj)


def scatter_reduce_minor_sum(mesh, part: torch.Tensor) -> torch.Tensor:
    """Row-block partials [pmin·Vc, ...] → summed owner slices [Vc, ...]
    (the transpose of ``gather_minor_block``)."""
    return _ReduceScatter.apply(part, mesh.minor, mesh.pmin)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """A reduced copy of ``x`` over ``group`` (no gradient)."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_OPS[op], group=group)
    return out


def psum_major(mesh, x: torch.Tensor) -> torch.Tensor:
    """Sum over this mesh column, differentiable (``jax.lax.psum`` over
    "major")."""
    return _AllReduceSum.apply(x, mesh.major)


def scatter_reduce_major(mesh, part: torch.Tensor, chunk: int,
                         op: str) -> torch.Tensor:
    """Like ``scatter_reduce_major_sum`` for min/max: reduce fully along
    "major", then take the owned piece (``prims.py:67-87``)."""
    if op == "sum":
        return scatter_reduce_major_sum(mesh, part)
    if op not in ("min", "max"):
        raise ValueError(op)
    red = all_reduce(part, mesh.major, op)
    return red[mesh.i * chunk:(mesh.i + 1) * chunk]


def _identity(op: str, dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def block_segment_reduce(vals: torch.Tensor, dst_loc: torch.Tensor,
                         num_segments: int, op: str = "sum",
                         identity=None) -> torch.Tensor:
    """Per-segment sum/min/max of ``vals`` [E, ...] by ``dst_loc``; an empty
    segment gets 0 (sum) or ``identity`` (default the dtype's max for min,
    min for max, as ``jax.ops.segment_min``/``max``), which also bounds
    every min/max.

    A float sum is ``torch.segment_reduce`` over the runs of a sorted
    ``dst_loc`` (every caller passes a local CSR's): each segment adds its
    values in their order, with no atomics, so two runs on the card give
    the same bits, and on the CPU the bits of the sequential edge-order
    sum.  An unsorted ``dst_loc`` costs a stable sort first, which keeps
    the values' order within a segment.  Integer sums and every min/max
    are exact in any order and scatter."""
    shape = (num_segments,) + tuple(vals.shape[1:])
    idx = dst_loc.to(torch.int64)
    if op == "sum" and vals.dtype.is_floating_point:
        if idx.numel() > 1 and not bool((idx[1:] >= idx[:-1]).all()):
            order = torch.sort(idx, stable=True).indices
            idx, vals = idx[order], vals[order]
        return torch.segment_reduce(
            vals, "sum", lengths=torch.bincount(idx, minlength=num_segments),
            axis=0)
    if op == "sum":
        return vals.new_zeros(shape).index_add(0, idx, vals)
    if op not in ("min", "max"):
        raise ValueError(op)
    fill = _identity(op, vals.dtype) if identity is None else identity
    idx = idx.view((-1,) + (1,) * (vals.dim() - 1)).expand_as(vals)
    return vals.new_full(shape, fill).scatter_reduce(0, idx, vals, f"a{op}")


def all_gather_rows(mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` [n_r, ...] (n_r may differ) concatenated in mesh
    position order, on every rank: the counts first, then one padded
    all-gather."""
    n = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    counts = torch.empty(mesh.size, dtype=torch.int64, device=t.device)
    dist.all_gather_into_tensor(counts, n, group=mesh.world)
    counts = counts.tolist()
    top = max(counts)
    if top == 0:
        return t
    pad = t.new_zeros((top,) + tuple(t.shape[1:]))
    pad[:t.shape[0]] = t
    out = t.new_empty((mesh.size * top,) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, pad.contiguous(), group=mesh.world)
    return torch.cat([out[r * top:r * top + c]
                      for r, c in enumerate(counts)])


def psum_all(mesh, x: torch.Tensor) -> torch.Tensor:
    """Sum over the whole mesh (the reference's host_scalar_allreduce,
    utilities/host_scalar_comm.hpp), on the device."""
    return all_reduce(x, mesh.world, "sum")


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` [k, ...] zero-padded to ``rows`` rows."""
    extra = rows - x.shape[0]
    if not extra:
        return x
    return F.pad(x, (0, 0) * (x.dim() - 1) + (0, extra))


def pull_spmv(mesh, blocks, x_own: torch.Tensor) -> torch.Tensor:
    """y[dst] = Σ_{(src,dst)} w · x[src], x and y owned slices [Vc]: one
    gather along "minor", K1 (mul) over the local CSR, one reduce-scatter
    along "major" (the distributed per_v_transform_reduce_incoming_e)."""
    sq = blocks.square
    x_blk = pad_rows(gather_minor_block(mesh, x_own), blocks.side)
    part = spmv_csr(sq.offsets, sq.indices, sq.weights, x_blk, "mul")
    return scatter_reduce_major_sum(mesh, part[:blocks.num_segments])


def pull_spmm_unit(mesh, blocks, x_own: torch.Tensor) -> torch.Tensor:
    """Y[dst, :] = Σ_{(src,dst)} X[src, :] over owned slices [Vc, F], no
    gradient: the row block gathered, K4 with unit weights over the local
    CSR (it reads no weight array), the partials reduce-scattered along
    "major".  Integer-valued X gives exact counts."""
    sq = blocks.square
    x_blk = pad_rows(gather_minor_block(mesh, x_own), blocks.side)
    part = spmm_csr(sq.offsets, sq.indices, None, x_blk.contiguous())
    return scatter_reduce_major_sum(mesh, part[:blocks.num_segments])


def pull_spmm(mesh, blocks, x_own: torch.Tensor) -> torch.Tensor:
    """The feature-matrix pull, x_own [Vc, F] → y_own [Vc, F], and
    differentiable: forward, gather along "minor", K4 over the local CSR,
    reduce-scatter along "major"; backward, gather along "major" (the
    reduce-scatter's transpose), K4 over the transposed local CSR
    (``make_spmm_pair``), reduce-scatter along "minor"
    (``parallel/nn.py:66-78``)."""
    pair = make_spmm_pair(blocks.square, blocks.transposed_square)
    x_blk = pad_rows(gather_minor_block(mesh, x_own), blocks.side)
    return scatter_reduce_major_sum(mesh, pair(x_blk)[:blocks.num_segments])


def pull_spmv_systolic(mesh, blocks, x_own: torch.Tensor) -> torch.Tensor:
    """``pull_spmv`` without the row block: the owned slices rotate around
    the mesh row (``batch_isend_irecv``), and each of the pmin steps sums
    the edges whose sources the slice on hand covers (one
    ``segment_reduce`` over the CSR's rows, no atomics), so the gathered
    memory is O(Vc).  Plain torch, as the JAX package's is XLA."""
    chunk, pmin = x_own.shape[0], mesh.pmin
    src = blocks.indices.to(torch.int64)
    owner, rel = src // chunk, src % chunk
    part = x_own.new_zeros(blocks.num_segments)
    row = [mesh.ranks[mesh.i * pmin + k] for k in range(pmin)]
    x_rot = x_own.contiguous()
    for s in range(pmin):
        src_dev = (mesh.j + s) % pmin       # whose slice x_rot is
        vals = torch.where(owner == src_dev, blocks.weights * x_rot[rel],
                           0.0)
        part = part + torch.segment_reduce(vals, "sum",
                                           lengths=blocks.lengths)
        if s + 1 < pmin:
            nxt = torch.empty_like(x_rot)
            ops = [dist.P2POp(dist.isend, x_rot, row[(mesh.j - 1) % pmin]),
                   dist.P2POp(dist.irecv, nxt, row[(mesh.j + 1) % pmin])]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            x_rot = nxt
    return scatter_reduce_major_sum(mesh, part)


def pull_transform_reduce(mesh, blocks, x_own, e_op, *, op: str,
                          identity) -> torch.Tensor:
    """Per-dst reduce of ``e_op(x[src], edge_slot)`` over in-edges; an
    empty destination, and every min/max, is bounded by ``identity``."""
    x_blk = gather_minor_block(mesh, x_own)
    vals = e_op(x_blk[blocks.indices.to(torch.int64)],
                torch.arange(blocks.e_local, device=x_blk.device))
    part = block_segment_reduce(vals, blocks.dst_loc, blocks.num_segments,
                                op, None if op == "sum" else identity)
    return scatter_reduce_major(mesh, part, x_own.shape[0], op)
