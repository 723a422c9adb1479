"""Full GNN models and the training step.

Counterpart of ``cugraph_tpu.nn.models``: full-graph semi-supervised node
classification, as ``BASELINE.json``'s GNN configuration ("2-layer
GraphSAGE on ogbn-arxiv") runs it, with the JAX package's layer widths,
activations and head counts.  A model's ``forward(g, x)`` returns raw
logits [num_vertices, out_dim].  ``torch.optim.Adam`` takes optax's place
in ``make_train_step``: the same β, ε and bias correction.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cugraph_tpu_torch.core.structure import GraphStructure, resolve_device
from cugraph_tpu_torch.nn.layers import (GATConv, GATv2Conv, GCNConv,
                                         GINConv, SAGEConv, _linear,
                                         appnp_propagate)


def _dims(in_dim, hidden_dim, out_dim, num_layers):
    dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
    return list(zip(dims, dims[1:]))


class _Stack(nn.Module):
    """``layers`` applied in turn, ``act`` between them, raw logits out."""

    act = staticmethod(F.relu)

    def forward(self, g: GraphStructure, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i, layer in enumerate(self.layers):
            h = layer(g, h)
            if i + 1 < len(self.layers):
                h = self.act(h)
        return h


class GraphSAGE(_Stack):
    """``num_layers`` SAGEConv layers, ReLU between them."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 2, *, generator=None, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            SAGEConv(a, b, generator=generator, device=device)
            for a, b in _dims(in_dim, hidden_dim, out_dim, num_layers))


class GCN(_Stack):
    """``num_layers`` GCNConv layers, ReLU between them."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 2, *, generator=None, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            GCNConv(a, b, generator=generator, device=device)
            for a, b in _dims(in_dim, hidden_dim, out_dim, num_layers))


class GIN(_Stack):
    """``num_layers`` GINConv layers (MLP width max(in, out)), ReLU
    between them."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 2, *, generator=None, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            GINConv(a, max(a, b), b, generator=generator, device=device)
            for a, b in _dims(in_dim, hidden_dim, out_dim, num_layers))


def _attention_layers(conv, in_dim, hidden_dim, out_dim, num_layers,
                      num_heads, generator, device):
    """Hidden layers of ``num_heads`` heads (concatenated), one head out."""
    out, d = [], in_dim
    for i in range(num_layers):
        if i + 1 < num_layers:
            out.append(conv(d, hidden_dim, num_heads, generator=generator,
                            device=device))
            d = hidden_dim * num_heads
        else:
            out.append(conv(d, out_dim, 1, generator=generator,
                            device=device))
    return nn.ModuleList(out)


class GAT(_Stack):
    """``num_layers`` GATConv layers, ELU between them."""

    act = staticmethod(F.elu)

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 2, num_heads: int = 4, *, generator=None,
                 device=None):
        super().__init__()
        self.layers = _attention_layers(GATConv, in_dim, hidden_dim, out_dim,
                                        num_layers, num_heads, generator,
                                        device)


class GATv2(_Stack):
    """``num_layers`` GATv2Conv layers, ELU between them."""

    act = staticmethod(F.elu)

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 2, num_heads: int = 4, *, generator=None,
                 device=None):
        super().__init__()
        self.layers = _attention_layers(GATv2Conv, in_dim, hidden_dim,
                                        out_dim, num_layers, num_heads,
                                        generator, device)


class APPNP(nn.Module):
    """Predict, then propagate: a 2-layer MLP, then ``appnp_propagate``
    (which has no parameters)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, *,
                 alpha: float = 0.1, k: int = 10, generator=None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.alpha, self.k = alpha, k
        self.w1 = _linear(in_dim, hidden_dim, generator, device, bias=True)
        self.w2 = _linear(hidden_dim, out_dim, generator, device, bias=True)

    def forward(self, g: GraphStructure, x: torch.Tensor) -> torch.Tensor:
        z = self.w2(F.relu(self.w1(x)))
        return appnp_propagate(g, z, alpha=self.alpha, k=self.k)


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the vertices where ``mask`` is true.
    ``labels``: integer [num_vertices]; ``mask``: bool [num_vertices]."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    m = mask.to(logits.dtype)
    return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer):
    """``step(g, x, labels, mask)``: zero the gradients, forward, masked
    cross-entropy, backward, ``optimizer.step()``; returns the loss (a
    0-d tensor, on the model's device)."""

    def train_step(g, x, labels, mask):
        optimizer.zero_grad()
        loss = masked_cross_entropy(model(g, x), labels, mask)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(torch.float32)
    hit = (torch.argmax(logits, dim=-1) == labels).to(torch.float32)
    return torch.sum(hit * m) / torch.clamp(torch.sum(m), min=1.0)
