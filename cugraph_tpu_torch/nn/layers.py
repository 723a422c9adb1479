"""Message-passing neural-network layers over the graph primitives.

Counterpart of ``cugraph_tpu.nn.layers``, as ``nn.Module``s.  Neighbour
aggregation "sum" and "mean" runs the sum SpMM K4 through
``kernels/spmm.make_spmm_pair``: K4 over the CSC forward, K4 over the CSR
(the transpose) backward, as the JAX package's ``_aggregate_pallas`` runs
its custom-VJP pair.  "max" and the attention softmax of GAT and GATv2
are plain torch (a gather plus ``scatter_reduce``), as the JAX package
leaves them to XLA.  The dense transforms are ``nn.Linear``; on the card
they are float32 GEMMs, and the port leaves PyTorch's default there
("highest", no TF32) as it is.

Weights are stored as PyTorch keeps them: a ``Linear.weight`` is [out,
in], the transpose of the JAX package's [in, out]; ``nn/convert.py``
carries weights between the two.  ``x`` is float32 [num_vertices, F]: the
port has no sink row and no padding.  Every layer takes a
``torch.Generator`` for its initial weights, and a ``device`` (None means
the card).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cugraph_tpu_torch.core.structure import (CsrMatrix, GraphStructure,
                                              resolve_device)
from cugraph_tpu_torch.kernels.spmm import get_structure_spmm_fn
from cugraph_tpu_torch.prims.vertex_edge import (gather_major, gather_minor,
                                                 segment_reduce_by_major)


def _glorot(shape, generator=None, dtype=torch.float32) -> torch.Tensor:
    """Uniform in ±sqrt(6 / (fan_in + fan_out)), fans from the JAX layout
    (``shape[0]`` in, ``shape[-1]`` out), on the CPU."""
    limit = math.sqrt(6.0 / (shape[0] + shape[-1]))
    return torch.empty(shape, dtype=dtype).uniform_(-limit, limit,
                                                    generator=generator)


def _linear(in_dim, out_dim, generator, device, bias=False) -> nn.Linear:
    """``nn.Linear`` with a Glorot weight drawn in the JAX layout [in, out]
    and stored transposed; the bias starts at 0."""
    lin = nn.Linear(in_dim, out_dim, bias=bias, device=device)
    with torch.no_grad():
        lin.weight.copy_(_glorot((in_dim, out_dim), generator).T)
        if bias:
            lin.bias.zero_()
    return lin


def _param(t: torch.Tensor, device) -> nn.Parameter:
    return nn.Parameter(t.to(device))


# ---------------------------------------------------------------------------
# aggregation primitives (SpMM-shaped)
# ---------------------------------------------------------------------------

def aggregate_neighbors(g: GraphStructure, x: torch.Tensor, *,
                        mode: str = "mean") -> torch.Tensor:
    """Per-vertex reduce of in-neighbour features: out[v] = op over (u, v)
    in E of w·x[u].  x: [num_vertices, F] float32 → out: the same shape.

    "sum" and "mean" are edge-weighted (mean divides by the weighted
    in-degree ``g.in_weight_sums``, at least 1e-12, summed once per
    structure on its device) and run K4 with its backward.  "max"
    ignores weights; a vertex with no in-edges, or whose maximum is at or
    below ``finfo.min``, gets 0 (the JAX package's convention)."""
    if mode in ("sum", "mean"):
        agg = get_structure_spmm_fn(g)(x)
        if mode == "mean":
            deg = g.in_weight_sums.to(x.dtype)
            agg = agg / torch.clamp(deg, min=1e-12)[:, None]
        return agg
    if mode == "max":
        agg = segment_reduce_by_major(g.csc, gather_minor(g.csc, x), "max")
        return torch.where(agg <= torch.finfo(x.dtype).min,
                           torch.zeros((), dtype=x.dtype, device=x.device),
                           agg)
    raise ValueError(f"unknown aggregation mode {mode!r}")


def _segment_softmax(adj: CsrMatrix, logits: torch.Tensor) -> torch.Tensor:
    """Numerically stable softmax of per-edge logits [m, H] over each
    major vertex's edge segment."""
    mx = segment_reduce_by_major(adj, logits, "max")
    ex = torch.exp(logits - gather_major(adj, mx))
    denom = segment_reduce_by_major(adj, ex, "sum")
    return ex / torch.clamp(gather_major(adj, denom), min=1e-16)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

class SAGEConv(nn.Module):
    """GraphSAGE, mean aggregator (Hamilton et al. 2017):
    h[v] = W_self·x[v] + W_nbr·mean over u→v of x[u] + b."""

    def __init__(self, in_dim: int, out_dim: int, *, generator=None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.w_self = _linear(in_dim, out_dim, generator, device)
        self.w_nbr = _linear(in_dim, out_dim, generator, device)
        self.b = _param(torch.zeros(out_dim), device)

    def forward(self, g: GraphStructure, x: torch.Tensor) -> torch.Tensor:
        h_nbr = aggregate_neighbors(g, x, mode="mean")
        return self.w_self(x) + self.w_nbr(h_nbr) + self.b


class GCNConv(nn.Module):
    """GCN (Kipf & Welling 2017): H' = D̂^-1/2 Â D̂^-1/2 H W + b with
    implicit self-loops (Â = A + I) and D̂ the weighted in-degree + 1."""

    def __init__(self, in_dim: int, out_dim: int, *, generator=None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.w = _linear(in_dim, out_dim, generator, device)
        self.b = _param(torch.zeros(out_dim), device)

    def forward(self, g: GraphStructure, x: torch.Tensor) -> torch.Tensor:
        inv_sqrt = torch.rsqrt(g.in_weight_sums + 1).to(x.dtype)
        h = self.w(x) * inv_sqrt[:, None]
        agg = aggregate_neighbors(g, h, mode="sum") + h
        return agg * inv_sqrt[:, None] + self.b


class GATConv(nn.Module):
    """GAT (Veličković et al. 2018), ``num_heads`` heads of width
    ``out_dim``, concatenated: logits a_src·h[u] + a_dst·h[v] through
    LeakyReLU, softmax over each vertex's in-edges."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int = 1, *,
                 negative_slope: float = 0.2, generator=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.negative_slope = negative_slope
        self.w = _linear(in_dim, num_heads * out_dim, generator, device)
        self.a_src = _param(_glorot((num_heads, out_dim), generator), device)
        self.a_dst = _param(_glorot((num_heads, out_dim), generator), device)
        self.b = _param(torch.zeros(num_heads * out_dim), device)

    def forward(self, g: GraphStructure, x: torch.Tensor) -> torch.Tensor:
        adj = g.csc
        heads, width = self.a_src.shape
        h = self.w(x).view(x.shape[0], heads, width)
        alpha_src = torch.einsum("vhd,hd->vh", h, self.a_src)
        alpha_dst = torch.einsum("vhd,hd->vh", h, self.a_dst)
        logits = F.leaky_relu(gather_minor(adj, alpha_src)
                              + gather_major(adj, alpha_dst),
                              self.negative_slope)
        coef = _segment_softmax(adj, logits)
        msgs = gather_minor(adj, h) * coef[:, :, None]
        out = segment_reduce_by_major(adj, msgs, "sum")
        return out.reshape(x.shape[0], heads * width) + self.b


class GATv2Conv(nn.Module):
    """GATv2 (Brody et al. 2022): e(u→v) = aᵀ·LeakyReLU(W_src·x[u] +
    W_dst·x[v]), softmax over v's in-edges, aggregating W_src·x[u]."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int = 1, *,
                 negative_slope: float = 0.2, generator=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.negative_slope = negative_slope
        self.w_src = _linear(in_dim, num_heads * out_dim, generator, device)
        self.w_dst = _linear(in_dim, num_heads * out_dim, generator, device)
        self.a = _param(_glorot((num_heads, out_dim), generator), device)
        self.b = _param(torch.zeros(num_heads * out_dim), device)

    def forward(self, g: GraphStructure, x: torch.Tensor) -> torch.Tensor:
        adj = g.csc
        heads, width = self.a.shape
        hs = self.w_src(x).view(x.shape[0], heads, width)
        hd = self.w_dst(x).view(x.shape[0], heads, width)
        hs_e = gather_minor(adj, hs)
        e = F.leaky_relu(hs_e + gather_major(adj, hd), self.negative_slope)
        coef = _segment_softmax(adj, torch.einsum("ehd,hd->eh", e, self.a))
        out = segment_reduce_by_major(adj, hs_e * coef[:, :, None], "sum")
        return out.reshape(x.shape[0], heads * width) + self.b


class GINConv(nn.Module):
    """GIN (Xu et al. 2019): h' = MLP((1 + ε)·h + sum over u→v of h[u]),
    a 2-layer MLP with ReLU; ε is learnable and starts at 0."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, *,
                 generator=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.eps = _param(torch.zeros(()), device)
        self.w1 = _linear(in_dim, hidden_dim, generator, device, bias=True)
        self.w2 = _linear(hidden_dim, out_dim, generator, device, bias=True)

    def forward(self, g: GraphStructure, x: torch.Tensor) -> torch.Tensor:
        h = (1.0 + self.eps) * x + aggregate_neighbors(g, x, mode="sum")
        return self.w2(F.relu(self.w1(h)))


def appnp_propagate(g: GraphStructure, z: torch.Tensor, *,
                    alpha: float = 0.1, k: int = 10) -> torch.Tensor:
    """APPNP (Gasteiger et al. 2019): Z ← α·Z₀ + (1−α)·D̂^-1/2 Â D̂^-1/2·Z,
    k times (Â = A + I), the symmetric-normalized SpMM of GCNConv."""
    inv_sqrt = torch.rsqrt(g.in_weight_sums + 1).to(z.dtype)[:, None]
    z0 = z
    for _ in range(k):
        hn = z * inv_sqrt
        z = alpha * z0 + (1.0 - alpha) * (
            (aggregate_neighbors(g, hn, mode="sum") + hn) * inv_sqrt)
    return z
