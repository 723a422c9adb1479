"""Full GNN models and the training step.

Counterpart of ``cugraph_tpu.nn.models``: full-graph semi-supervised node
classification, as ``BASELINE.json``'s GNN configuration ("2-layer
GraphSAGE on ogbn-arxiv") runs it, with the JAX package's layer widths,
activations and head counts.  Each model is a pure apply function over
the JAX package's parameter pytree (``graphsage_apply(params, g, x)``;
``graphsage_init`` draws it) and a module whose ``forward(g, x)`` calls
that function on its layers' weights; both return raw logits
[num_vertices, out_dim].  ``torch.optim.Adam`` takes optax's place in
``make_train_step``: the same β, ε and bias correction.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cugraph_tpu_torch.core.structure import GraphStructure, resolve_device
from cugraph_tpu_torch.nn.layers import (_MLP, GATConv, GATv2Conv,
                                         GCNConv, GINConv, SAGEConv,
                                         _JaxLeaves, _linear, _mlp2,
                                         appnp_propagate, gat_conv,
                                         gatv2_conv, gcn_conv, gin_conv,
                                         params_of, sage_conv)


def _dims(in_dim, hidden_dim, out_dim, num_layers):
    dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
    return list(zip(dims, dims[1:]))


def _stack_apply(conv, act, params, g, x):
    """``conv`` for each layer's dict in turn, ``act`` between them, raw
    logits out."""
    h = x
    for i, p in enumerate(params):
        h = conv(p, g, h)
        if i + 1 < len(params):
            h = act(h)
    return h


def graphsage_apply(params, g: GraphStructure, x: torch.Tensor):
    """``sage_conv`` per layer, ReLU between them."""
    return _stack_apply(sage_conv, F.relu, params, g, x)


def gcn_apply(params, g: GraphStructure, x: torch.Tensor):
    return _stack_apply(gcn_conv, F.relu, params, g, x)


def gin_apply(params, g: GraphStructure, x: torch.Tensor):
    return _stack_apply(gin_conv, F.relu, params, g, x)


def gat_apply(params, g: GraphStructure, x: torch.Tensor):
    """``gat_conv`` per layer, ELU between them."""
    return _stack_apply(gat_conv, F.elu, params, g, x)


def gatv2_apply(params, g: GraphStructure, x: torch.Tensor):
    return _stack_apply(gatv2_conv, F.elu, params, g, x)


class _Stack(nn.Module):
    """``layers`` through ``apply_fn`` over their ``jax_params()``: the
    model's forward is its functional apply."""

    def forward(self, g: GraphStructure, x: torch.Tensor) -> torch.Tensor:
        return self.apply_fn([layer.jax_params() for layer in self.layers],
                             g, x)


class GraphSAGE(_Stack):
    """``num_layers`` SAGEConv layers, ReLU between them."""

    apply_fn = staticmethod(graphsage_apply)

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 2, *, generator=None, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            SAGEConv(a, b, generator=generator, device=device)
            for a, b in _dims(in_dim, hidden_dim, out_dim, num_layers))


class GCN(_Stack):
    """``num_layers`` GCNConv layers, ReLU between them."""

    apply_fn = staticmethod(gcn_apply)

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 2, *, generator=None, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            GCNConv(a, b, generator=generator, device=device)
            for a, b in _dims(in_dim, hidden_dim, out_dim, num_layers))


class GIN(_Stack):
    """``num_layers`` GINConv layers (MLP width max(in, out)), ReLU
    between them."""

    apply_fn = staticmethod(gin_apply)

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

    apply_fn = staticmethod(gat_apply)

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 2, num_heads: int = 4, *, generator=None,
                 device=None):
        super().__init__()
        self.layers = _attention_layers(GATConv, in_dim, hidden_dim, out_dim,
                                        num_layers, num_heads, generator,
                                        device)


class GATv2(_Stack):
    """``num_layers`` GATv2Conv layers, ELU between them."""

    apply_fn = staticmethod(gatv2_apply)

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 2, num_heads: int = 4, *, generator=None,
                 device=None):
        super().__init__()
        self.layers = _attention_layers(GATv2Conv, in_dim, hidden_dim,
                                        out_dim, num_layers, num_heads,
                                        generator, device)


def appnp_apply(params, g: GraphStructure, x: torch.Tensor, *,
                alpha: float = 0.1, k: int = 10) -> torch.Tensor:
    """Predict with the 2-layer MLP, then ``appnp_propagate``."""
    return appnp_propagate(g, _mlp2(params, x), alpha=alpha, k=k)


class APPNP(_JaxLeaves, nn.Module):
    """``appnp_apply`` with the MLP's weights (propagation has none)."""

    JAX_LEAVES = _MLP

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, *,
                 alpha: float = 0.1, k: int = 10, generator=None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.alpha, self.k = alpha, k
        self.w1 = _linear(in_dim, hidden_dim, generator, device, bias=True)
        self.w2 = _linear(hidden_dim, out_dim, generator, device, bias=True)

    def forward(self, g: GraphStructure, x: torch.Tensor) -> torch.Tensor:
        return appnp_apply(self.jax_params(), g, x, alpha=self.alpha,
                           k=self.k)


def graphsage_init(generator, in_dim: int, hidden_dim: int, out_dim: int,
                   num_layers: int = 2, *, device=None):
    """``GraphSAGE``'s initial weights as the JAX pytree, a list of layer
    dicts (``generator`` in place of the JAX key; ``device`` None means
    the card)."""
    return params_of(GraphSAGE(in_dim, hidden_dim, out_dim, num_layers,
                                 generator=generator, device=device))


def gcn_init(generator, in_dim: int, hidden_dim: int, out_dim: int,
             num_layers: int = 2, *, device=None):
    return params_of(GCN(in_dim, hidden_dim, out_dim, num_layers,
                         generator=generator, device=device))


def gin_model_init(generator, in_dim: int, hidden_dim: int, out_dim: int,
                   num_layers: int = 2, *, device=None):
    return params_of(GIN(in_dim, hidden_dim, out_dim, num_layers,
                           generator=generator, device=device))


def gat_init(generator, in_dim: int, hidden_dim: int, out_dim: int,
             num_layers: int = 2, num_heads: int = 4, *, device=None):
    return params_of(GAT(in_dim, hidden_dim, out_dim, num_layers,
                         num_heads, generator=generator, device=device))


def gatv2_model_init(generator, in_dim: int, hidden_dim: int, out_dim: int,
                     num_layers: int = 2, num_heads: int = 4, *,
                     device=None):
    return params_of(GATv2(in_dim, hidden_dim, out_dim, num_layers,
                             num_heads, generator=generator, device=device))


def appnp_init(generator, in_dim: int, hidden_dim: int, out_dim: int, *,
               device=None):
    """The MLP's weights: {"w1", "b1", "w2", "b2"}."""
    return params_of(APPNP(in_dim, hidden_dim, out_dim,
                             generator=generator, device=device))


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the vertices where ``mask`` is true.
    ``labels``: integer [num_vertices]; ``mask``: bool [num_vertices]."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    m = mask.to(logits.dtype)
    return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)


def _leaves(params) -> list:
    """The tensors of a pytree of dicts and lists, in a fixed order."""
    if isinstance(params, torch.Tensor):
        return [params]
    if isinstance(params, dict):
        return [t for k in sorted(params) for t in _leaves(params[k])]
    return [t for p in params for t in _leaves(p)]


def _rebuild(params, leaves):
    """``params``' structure with the tensors of the iterator ``leaves``."""
    if isinstance(params, torch.Tensor):
        return next(leaves)
    if isinstance(params, dict):
        return {k: _rebuild(params[k], leaves) for k in sorted(params)}
    return [_rebuild(p, leaves) for p in params]


def functional_step(loss_fn, optimizer):
    """The JAX package's step, ``step(params, opt_state, *args) ->
    (params, opt_state, loss)``, over ``loss_fn(params, *args)``.
    ``optimizer`` is a ``torch.optim`` factory (``lambda ps:
    torch.optim.Adam(ps, lr=1e-2)``), as optax's transformations are not
    there.  At the first step ``opt_state`` is None: the step copies the
    leaves of ``params`` into fresh tensors that require gradients and
    builds the optimizer over them, so the caller's tensors stay as they
    are.  Later steps take the ``params`` and ``opt_state`` the previous
    step returned; the optimizer updates those tensors in place."""

    def train_step(params, opt_state, *args):
        leaves = _leaves(params)
        if opt_state is None:
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in leaves]
            params = _rebuild(params, iter(leaves))
            opt_state = optimizer(leaves)
        else:
            held = [p for grp in opt_state.param_groups
                    for p in grp["params"]]
            if len(held) != len(leaves) or any(
                    a is not b for a, b in zip(held, leaves)):
                raise ValueError("params must be the ones the previous step "
                                 "returned with this opt_state")
        opt_state.zero_grad()
        loss = loss_fn(params, *args)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return train_step


def make_train_step(model, optimizer):
    """For an ``nn.Module`` and a ``torch.optim.Optimizer`` over its
    parameters: ``step(g, x, labels, mask)``, which zeroes the gradients,
    runs forward, the masked cross-entropy, backward and
    ``optimizer.step()``, and returns the loss (a 0-d tensor on the
    model's device).

    For an apply function (``graphsage_apply`` ...) and a ``torch.optim``
    factory: the JAX package's ``step(params, opt_state, g, x, labels,
    mask) -> (params, opt_state, loss)`` (``functional_step``)."""
    if not isinstance(model, nn.Module):
        return functional_step(
            lambda params, g, x, labels, mask: masked_cross_entropy(
                model(params, g, x), labels, mask), optimizer)

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
