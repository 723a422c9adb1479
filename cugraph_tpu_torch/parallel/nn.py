"""Distributed GNN layers and training over the 2D partition.

Counterpart of ``cugraph_tpu/parallel/nn.py``, the second half of
``BASELINE.json``'s multi-device configuration (edge-partitioned PageRank
+ GraphSAGE).  Vertex features are owned slices [Vc, F]; the neighbour
aggregation is ``prims.pull_spmm``: gather along "minor", K4 over the
rank's local CSR, reduce-scatter along "major", and backward the
transpose, gather along "major", K4 over the transposed local CSR,
reduce-scatter along "minor" (``nn.py:66-78``).  The dense transforms are
the single-device layers' own GEMMs (``nn/layers.py``) on the owned rows,
with the weights replicated; the training step sums the parameter
gradients over the ranks, where GSPMD inserts the psums in the JAX
package.  The attention layers' per-destination softmax runs in plain
torch, with a MAX (no gradient) and a differentiable SUM along "major"
(``nn.py:215-260``).  Parameters are the JAX package's dicts (dense
weights [in, out]).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from cugraph_tpu_torch.nn.layers import _mlp2, _w
from cugraph_tpu_torch.nn.models import _stack_apply, functional_step
from cugraph_tpu_torch.parallel import prims
from cugraph_tpu_torch.parallel.partition import DistGraph
from cugraph_tpu_torch.prims.vertex_edge import gather_rows


def mg_aggregate_sum(g: DistGraph, mesh, x: torch.Tensor) -> torch.Tensor:
    """Sum of in-neighbour features times the edge weights, owned slices
    [Vc, F] → [Vc, F]."""
    return prims.pull_spmm(mesh, g.pull, x)


def mg_aggregate_mean(g: DistGraph, mesh, x: torch.Tensor) -> torch.Tensor:
    """``mg_aggregate_sum`` over the weighted in-degree, clamped at 1e-12
    as the single-device layer's."""
    deg = torch.clamp(g.in_degree, min=1e-12)
    return mg_aggregate_sum(g, mesh, x) / deg[:, None]


def mg_sage_conv(params, g: DistGraph, mesh, x: torch.Tensor):
    """GraphSAGE, mean aggregator: x·W_self + mean(x[u])·W_nbr + b."""
    h_nbr = mg_aggregate_mean(g, mesh, x)
    return (F.linear(x, _w(params["w_self"]))
            + F.linear(h_nbr, _w(params["w_nbr"])) + params["b"])


def mg_graphsage_apply(params, g: DistGraph, mesh, x: torch.Tensor):
    """``mg_sage_conv`` per layer, ReLU between them; raw logits."""
    return _stack_apply(lambda p, g_, h: mg_sage_conv(p, g_, mesh, h),
                        F.relu, params, g, x)


def mg_masked_cross_entropy(logits, labels, mask, mesh):
    """This rank's share of the masked mean cross-entropy: Σ nll·m over its
    vertices / max(Σ m over every rank, 1), so the ranks' shares add up to
    the JAX package's value on the global arrays."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    m = mask.to(logits.dtype)
    count = prims.psum_all(mesh, m.sum())
    return torch.sum(nll * m) / torch.clamp(count, min=1.0)


def _summing_grads(mesh, optimizer):
    """``optimizer`` (a ``torch.optim`` factory) with a step pre-hook that
    sums every parameter's gradient over the ranks in one all-reduce."""
    def reduce(opt, args, kwargs):
        leaves = [p for grp in opt.param_groups for p in grp["params"]]
        flat = torch.cat([t.grad.reshape(-1) for t in leaves])
        dist.all_reduce(flat, group=mesh.world)
        off = 0
        for t in leaves:
            t.grad.copy_(flat[off:off + t.numel()].view_as(t.grad))
            off += t.numel()

    def factory(params):
        opt = optimizer(params)
        opt.register_step_pre_hook(reduce)
        return opt

    return factory


def make_mg_train_step(g: DistGraph, mesh, optimizer):
    """GraphSAGE training step over the mesh: ``step(params, opt_state,
    x, labels, mask) -> (params, opt_state, loss)`` on owned slices, as
    ``nn.make_train_step``'s functional form.  ``optimizer`` is a
    ``torch.optim`` factory (``lambda ps: torch.optim.Adam(ps, lr=1e-2)``)
    in optax's place; ``opt_state`` is None at the first step.  Each rank
    differentiates its share of the loss (``mg_masked_cross_entropy`` with
    the mesh), the parameter gradients are summed over the ranks before
    the update, so the replicated parameters stay equal, and the returned
    loss is the mesh-wide one."""
    def loss_fn(params, x, labels, mask):
        logits = mg_graphsage_apply(params, g, mesh, x)
        return mg_masked_cross_entropy(logits, labels, mask, mesh)

    step = functional_step(loss_fn, _summing_grads(mesh, optimizer))

    def train_step(params, opt_state, x, labels, mask):
        params, opt_state, share = step(params, opt_state, x, labels, mask)
        return params, opt_state, prims.psum_all(mesh, share)

    return train_step


def shard_vertex_data(mesh, *arrays):
    """Global vertex-indexed arrays [pad_v, ...] (NumPy or tensors) →
    this rank's owned slices on ``mesh.device``."""
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        vc = t.shape[0] // mesh.size
        out.append(t[mesh.rank * vc:(mesh.rank + 1) * vc].contiguous().to(
            mesh.device))
    return tuple(out) if len(out) > 1 else out[0]


def replicate(mesh, tree):
    """A pytree of dicts and lists of arrays → the same tree of tensors on
    ``mesh.device``, each broadcast from the mesh's first rank, so every
    rank holds the same values."""
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(mesh, v) for v in tree)
    t = torch.as_tensor(tree).to(mesh.device).contiguous()
    dist.broadcast(t, mesh.ranks[0], group=mesh.world)
    return t


def mg_gcn_conv(params, g: DistGraph, mesh, x: torch.Tensor):
    """Symmetric-normalised GCN with implicit self-loops:
    D̂^-1/2 Â D̂^-1/2 X W + b, D̂ the weighted in-degree + 1."""
    inv_sqrt = torch.rsqrt(g.in_degree + 1.0)[:, None]
    h = F.linear(x, _w(params["w"])) * inv_sqrt
    return (mg_aggregate_sum(g, mesh, h) + h) * inv_sqrt + params["b"]


def mg_gcn_apply(params, g: DistGraph, mesh, x: torch.Tensor):
    return _stack_apply(lambda p, g_, h: mg_gcn_conv(p, g_, mesh, h),
                        F.relu, params, g, x)


def _by_src(blocks, x_blk):
    """x_blk [B, ...] at each edge's source, its gradient summed per source
    in a fixed order (``gather_rows``)."""
    return gather_rows(x_blk, blocks.indices.to(torch.int64),
                       blocks.minor_layout)


def _by_slot(blocks, x_seg):
    """x_seg [pmaj·Vc, ...] at each edge's dst slot, likewise."""
    return gather_rows(x_seg, blocks.dst_loc, (None, blocks.lengths))


def _softmax_aggregate(mesh, blocks, logits, msgs):
    """Σ over in-edges of softmax(logits per dst, per head)·msgs: the local
    per-slot max and sum taken over the rank's edges, then the MAX (a
    constant shift, no gradient) and the SUM along "major", whose ranks
    hold the other in-edges of the same slots; the messages reduce-scattered
    to their owners.  ``logits`` [E, H], ``msgs`` [E, H, D]."""
    dl, nseg = blocks.dst_loc, blocks.num_segments
    mx = prims.all_reduce(
        prims.block_segment_reduce(logits.detach(), dl, nseg, "max"),
        mesh.major, "max")
    ex = torch.exp(logits - mx[dl])
    denom = prims.psum_major(
        mesh, prims.block_segment_reduce(ex, dl, nseg, "sum"))
    coef = ex / torch.clamp(_by_slot(blocks, denom), min=1e-16)
    part = prims.block_segment_reduce(msgs * coef[:, :, None], dl, nseg,
                                      "sum")
    return prims.scatter_reduce_major_sum(mesh, part)


def mg_gat_conv(params, g: DistGraph, mesh, x: torch.Tensor, *,
                negative_slope: float = 0.2):
    """Distributed ``gat_conv`` (multi-head, unweighted attention):
    logits LeakyReLU(a_src·h[u] + a_dst·h[v]) over v's in-edges."""
    heads, width = params["a_src"].shape
    h = F.linear(x, _w(params["w"])).view(x.shape[0], heads, width)
    a_s = torch.einsum("vhd,hd->vh", h, params["a_src"])
    a_d = torch.einsum("vhd,hd->vh", h, params["a_dst"])
    blocks = g.pull
    logits = F.leaky_relu(
        _by_src(blocks, prims.gather_minor_block(mesh, a_s))
        + _by_slot(blocks, prims.gather_major_block(mesh, a_d)),
        negative_slope)
    msgs = _by_src(blocks, prims.gather_minor_block(mesh, h))
    out = _softmax_aggregate(mesh, blocks, logits, msgs)
    return out.reshape(x.shape[0], heads * width) + params["b"]


def mg_gatv2_conv(params, g: DistGraph, mesh, x: torch.Tensor, *,
                  negative_slope: float = 0.2):
    """Distributed ``gatv2_conv``: e(u→v) = aᵀ·LeakyReLU(W_src·x[u] +
    W_dst·x[v]), aggregating W_src·x[u]."""
    heads, width = params["a"].shape
    hs = F.linear(x, _w(params["w_src"])).view(x.shape[0], heads, width)
    hd = F.linear(x, _w(params["w_dst"])).view(x.shape[0], heads, width)
    blocks = g.pull
    hs_e = _by_src(blocks, prims.gather_minor_block(mesh, hs))
    e = F.leaky_relu(hs_e + _by_slot(blocks, prims.gather_major_block(
        mesh, hd)), negative_slope)
    logits = torch.einsum("ehd,hd->eh", e, params["a"])
    out = _softmax_aggregate(mesh, blocks, logits, hs_e)
    return out.reshape(x.shape[0], heads * width) + params["b"]


def mg_gin_conv(params, g: DistGraph, mesh, x: torch.Tensor):
    """Distributed ``gin_conv``: MLP((1 + ε)·x + Σ in-neighbours' x)."""
    return _mlp2(params, (1.0 + params["eps"]) * x
                 + mg_aggregate_sum(g, mesh, x))


def mg_appnp_propagate(g: DistGraph, mesh, z: torch.Tensor, *,
                       alpha: float = 0.1, k: int = 10) -> torch.Tensor:
    """Distributed ``appnp_propagate``: k rounds of Z ← α·Z₀ + (1−α)·
    D̂^-1/2 Â D̂^-1/2·Z through the MG SpMM."""
    inv_sqrt = torch.rsqrt(g.in_degree + 1.0)[:, None]
    z0 = z
    for _ in range(k):
        hn = z * inv_sqrt
        z = alpha * z0 + (1.0 - alpha) * (
            (mg_aggregate_sum(g, mesh, hn) + hn) * inv_sqrt)
    return z
