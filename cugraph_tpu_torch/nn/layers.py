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

Each layer is a pure function over a dict of tensors in the JAX
package's layout (``sage_conv(params, g, x)``; ``sage_init`` draws the
dict) and a module that holds the weights as PyTorch keeps them (a
``Linear.weight`` is [out, in], the transpose of the JAX package's [in,
out]) and whose ``forward`` calls the function on ``jax_params()``, views
of its own weights: one implementation for both.  ``nn/convert.py``
carries weights between the two packages.  ``x`` is float32
[num_vertices, F]: the port has no sink row and no padding.  Every layer
takes a ``torch.Generator`` for its initial weights, and a ``device``
(None means the card).
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
# the layers: each a pure function over the JAX package's parameter dict
# (dense weights [in, out]), and a module whose forward calls it
# ---------------------------------------------------------------------------

def _w(t: torch.Tensor) -> torch.Tensor:
    """A dense weight [in, out] as ``nn.Linear`` keeps it, [out, in] and
    contiguous: the module's own weight when ``t`` is its ``jax_params``
    view, so both routes make the same GEMM call."""
    return t.T.contiguous()


class _JaxLeaves:
    """``JAX_LEAVES``: (JAX leaf, ``state_dict`` key) for every parameter;
    ``nn/convert.py`` reads it too."""

    JAX_LEAVES: tuple = ()

    def jax_params(self) -> dict:
        """The parameters as the JAX package's dict: views that share
        storage and gradients with the module's, a ``Linear`` weight
        transposed to [in, out]."""
        out = {}
        for leaf, key in self.JAX_LEAVES:
            t = self.get_parameter(key)
            out[leaf] = t.T if key.endswith(".weight") else t
        return out


def params_of(module: nn.Module):
    """A module's (or a stack's) weights as the JAX package's pytree: fresh
    contiguous tensors, detached, dense weights [in, out]."""
    def fresh(params):
        return {k: v.detach().clone(memory_format=torch.contiguous_format)
                for k, v in params.items()}

    if isinstance(module, _JaxLeaves):
        return fresh(module.jax_params())
    return [fresh(layer.jax_params()) for layer in module.layers]


_MLP = (("w1", "w1.weight"), ("b1", "w1.bias"), ("w2", "w2.weight"),
        ("b2", "w2.bias"))


# sage_conv calls since import, by the order it took: aggregate the input
# and project the mean ("aggregate_first"), or project the input and
# aggregate at the narrower output width ("project_first")
SAGE_AGGREGATION_ORDER = {"aggregate_first": 0, "project_first": 0}


def sage_conv(params, g: GraphStructure, x: torch.Tensor) -> torch.Tensor:
    """GraphSAGE, mean aggregator (Hamilton et al. 2017):
    h[v] = W_self·x[v] + W_nbr·mean over u→v of x[u] + b.

    The mean is linear, so W_nbr·mean(x) = mean(W_nbr·x): where W_nbr
    narrows (out < in) the neighbours are aggregated after the projection,
    so K4 and its VJP gather out features per edge instead of in, as DGL's
    ``SAGEConv`` does; elsewhere, a tie included, the mean comes first.
    Only the rounding order differs.

    The projected width is padded to a multiple of 4 with zero rows of
    W_nbr, and the aggregate sliced back, so that K4 takes its float4
    path (``csrc/spmm_csr.cu`` needs F % 4 == 0).  At ogbn-products' 47
    classes over its ~124 M stored edges K4 took 18.82 ms forward and
    18.81 ms backward at 47 features (the scalar path) against 8.29 and
    8.34 ms at 48, and the training step 206.6 ms against 186.6 ms
    (NVIDIA H100 80GB HBM3, 700 W)."""
    in_dim, out_dim = params["w_nbr"].shape
    if out_dim < in_dim:
        SAGE_AGGREGATION_ORDER["project_first"] += 1
        w_nbr = F.pad(_w(params["w_nbr"]), (0, 0, 0, -out_dim % 4))
        h_nbr = aggregate_neighbors(g, F.linear(x, w_nbr), mode="mean")
        return (F.linear(x, _w(params["w_self"])) + h_nbr[:, :out_dim]
                + params["b"])
    SAGE_AGGREGATION_ORDER["aggregate_first"] += 1
    h_nbr = aggregate_neighbors(g, x, mode="mean")
    return (F.linear(x, _w(params["w_self"]))
            + F.linear(h_nbr, _w(params["w_nbr"])) + params["b"])


class SAGEConv(_JaxLeaves, nn.Module):
    """``sage_conv`` with its weights."""

    JAX_LEAVES = (("w_self", "w_self.weight"), ("w_nbr", "w_nbr.weight"),
                  ("b", "b"))

    def __init__(self, in_dim: int, out_dim: int, *, generator=None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.w_self = _linear(in_dim, out_dim, generator, device)
        self.w_nbr = _linear(in_dim, out_dim, generator, device)
        self.b = _param(torch.zeros(out_dim), device)

    def forward(self, g: GraphStructure, x: torch.Tensor) -> torch.Tensor:
        return sage_conv(self.jax_params(), g, x)


def gcn_conv(params, g: GraphStructure, x: torch.Tensor) -> torch.Tensor:
    """GCN (Kipf & Welling 2017): H' = D̂^-1/2 Â D̂^-1/2 H W + b with
    implicit self-loops (Â = A + I) and D̂ the weighted in-degree + 1."""
    inv_sqrt = torch.rsqrt(g.in_weight_sums + 1).to(x.dtype)
    h = F.linear(x, _w(params["w"])) * inv_sqrt[:, None]
    agg = aggregate_neighbors(g, h, mode="sum") + h
    return agg * inv_sqrt[:, None] + params["b"]


class GCNConv(_JaxLeaves, nn.Module):
    """``gcn_conv`` with its weights."""

    JAX_LEAVES = (("w", "w.weight"), ("b", "b"))

    def __init__(self, in_dim: int, out_dim: int, *, generator=None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.w = _linear(in_dim, out_dim, generator, device)
        self.b = _param(torch.zeros(out_dim), device)

    def forward(self, g: GraphStructure, x: torch.Tensor) -> torch.Tensor:
        return gcn_conv(self.jax_params(), g, x)


def gat_conv(params, g: GraphStructure, x: torch.Tensor, *,
             negative_slope: float = 0.2) -> torch.Tensor:
    """GAT (Veličković et al. 2018): heads of width ``a_src.shape[1]``,
    concatenated; logits a_src·h[u] + a_dst·h[v] through LeakyReLU,
    softmax over each vertex's in-edges."""
    adj = g.csc
    heads, width = params["a_src"].shape
    h = F.linear(x, _w(params["w"])).view(x.shape[0], heads, width)
    alpha_src = torch.einsum("vhd,hd->vh", h, params["a_src"])
    alpha_dst = torch.einsum("vhd,hd->vh", h, params["a_dst"])
    logits = F.leaky_relu(gather_minor(adj, alpha_src)
                          + gather_major(adj, alpha_dst), negative_slope)
    coef = _segment_softmax(adj, logits)
    msgs = gather_minor(adj, h) * coef[:, :, None]
    out = segment_reduce_by_major(adj, msgs, "sum")
    return out.reshape(x.shape[0], heads * width) + params["b"]


class GATConv(_JaxLeaves, nn.Module):
    """``gat_conv`` with its weights: ``num_heads`` heads of width
    ``out_dim``."""

    JAX_LEAVES = (("w", "w.weight"), ("a_src", "a_src"), ("a_dst", "a_dst"),
                  ("b", "b"))

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
        return gat_conv(self.jax_params(), g, x,
                        negative_slope=self.negative_slope)


def gatv2_conv(params, g: GraphStructure, x: torch.Tensor, *,
               negative_slope: float = 0.2) -> torch.Tensor:
    """GATv2 (Brody et al. 2022): e(u→v) = aᵀ·LeakyReLU(W_src·x[u] +
    W_dst·x[v]), softmax over v's in-edges, aggregating W_src·x[u]."""
    adj = g.csc
    heads, width = params["a"].shape
    hs = F.linear(x, _w(params["w_src"])).view(x.shape[0], heads, width)
    hd = F.linear(x, _w(params["w_dst"])).view(x.shape[0], heads, width)
    hs_e = gather_minor(adj, hs)
    e = F.leaky_relu(hs_e + gather_major(adj, hd), negative_slope)
    coef = _segment_softmax(adj, torch.einsum("ehd,hd->eh", e, params["a"]))
    out = segment_reduce_by_major(adj, hs_e * coef[:, :, None], "sum")
    return out.reshape(x.shape[0], heads * width) + params["b"]


class GATv2Conv(_JaxLeaves, nn.Module):
    """``gatv2_conv`` with its weights."""

    JAX_LEAVES = (("w_src", "w_src.weight"), ("w_dst", "w_dst.weight"),
                  ("a", "a"), ("b", "b"))

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
        return gatv2_conv(self.jax_params(), g, x,
                          negative_slope=self.negative_slope)


def _mlp2(params, h: torch.Tensor) -> torch.Tensor:
    """The 2-layer MLP of GIN, APPNP and the MLP decoder:
    W2·relu(W1·h + b1) + b2."""
    h = F.relu(F.linear(h, _w(params["w1"]), params["b1"]))
    return F.linear(h, _w(params["w2"]), params["b2"])


def gin_conv(params, g: GraphStructure, x: torch.Tensor) -> torch.Tensor:
    """GIN (Xu et al. 2019): h' = MLP((1 + ε)·h + sum over u→v of h[u]),
    a 2-layer MLP with ReLU; ε is learnable."""
    h = (1.0 + params["eps"]) * x + aggregate_neighbors(g, x, mode="sum")
    return _mlp2(params, h)


class GINConv(_JaxLeaves, nn.Module):
    """``gin_conv`` with its weights; ε starts at 0."""

    JAX_LEAVES = (("eps", "eps"),) + _MLP

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, *,
                 generator=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.eps = _param(torch.zeros(()), device)
        self.w1 = _linear(in_dim, hidden_dim, generator, device, bias=True)
        self.w2 = _linear(hidden_dim, out_dim, generator, device, bias=True)

    def forward(self, g: GraphStructure, x: torch.Tensor) -> torch.Tensor:
        return gin_conv(self.jax_params(), g, x)


def sage_init(generator, in_dim: int, out_dim: int, *, device=None):
    """``SAGEConv``'s initial weights as the JAX pytree (``generator`` in
    place of the JAX key; ``device`` None means the card)."""
    return params_of(SAGEConv(in_dim, out_dim, generator=generator,
                                device=device))


def gcn_init(generator, in_dim: int, out_dim: int, *, device=None):
    return params_of(GCNConv(in_dim, out_dim, generator=generator,
                               device=device))


def gat_init(generator, in_dim: int, out_dim: int, num_heads: int = 1, *,
             device=None):
    return params_of(GATConv(in_dim, out_dim, num_heads,
                               generator=generator, device=device))


def gatv2_init(generator, in_dim: int, out_dim: int, num_heads: int = 1, *,
               device=None):
    return params_of(GATv2Conv(in_dim, out_dim, num_heads,
                                 generator=generator, device=device))


def gin_init(generator, in_dim: int, hidden_dim: int, out_dim: int, *,
             device=None):
    return params_of(GINConv(in_dim, hidden_dim, out_dim,
                               generator=generator, device=device))


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
