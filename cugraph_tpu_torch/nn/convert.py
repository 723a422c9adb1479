"""Weights carried between the JAX package's parameter pytrees and the
port's ``state_dict``s.

The JAX package keeps a layer's parameters as a dict of arrays (a model's
as a list of them, one per layer, or one dict for APPNP and the MLP and
DistMult link-prediction decoders), with dense
weights [in, out]; the port keeps them in ``nn.Linear``s, [out, in].
Every leaf maps to one ``state_dict`` entry, transposed where that entry
is a ``Linear.weight``.  Arrays cross as numpy arrays (call
``np.asarray`` on the JAX side), so this module never sees JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from cugraph_tpu_torch.nn.layers import (GATConv, GATv2Conv, GCNConv,
                                         GINConv, SAGEConv)
from cugraph_tpu_torch.nn.linkpred import DistMultDecoder, MLPDecoder
from cugraph_tpu_torch.nn.models import APPNP

# per module type: (JAX leaf, state_dict key within the module)
_MLP = (("w1", "w1.weight"), ("b1", "w1.bias"), ("w2", "w2.weight"),
        ("b2", "w2.bias"))
_LEAVES = {
    SAGEConv: (("w_self", "w_self.weight"), ("w_nbr", "w_nbr.weight"),
               ("b", "b")),
    GCNConv: (("w", "w.weight"), ("b", "b")),
    GATConv: (("w", "w.weight"), ("a_src", "a_src"), ("a_dst", "a_dst"),
              ("b", "b")),
    GATv2Conv: (("w_src", "w_src.weight"), ("w_dst", "w_dst.weight"),
                ("a", "a"), ("b", "b")),
    GINConv: (("eps", "eps"),) + _MLP,
    APPNP: _MLP,
    MLPDecoder: _MLP,
    DistMultDecoder: (("rel", "rel"),),
}


def _modules(model):
    """(state_dict prefix, module, index into the pytree or None) for
    every module that holds leaves: a stack's layers, or the model."""
    if type(model) in _LEAVES:
        return [("", model, None)]
    return [(f"layers.{i}.", layer, i)
            for i, layer in enumerate(model.layers)]


def _flip(key, a):
    return a.T if key.endswith(".weight") else a


def state_dict_from_jax(model: torch.nn.Module, params) -> dict:
    """The ``state_dict`` of ``model`` that holds the JAX package's
    ``params`` (a pytree of numpy arrays, as the matching ``*_init`` of
    ``cugraph_tpu.nn`` builds it), on the model's device.  Raises when a
    leaf is missing or its shape differs."""
    want = model.state_dict()
    out = {}
    for prefix, module, i in _modules(model):
        leaves = params if i is None else params[i]
        for leaf, key in _LEAVES[type(module)]:
            name = prefix + key
            value = torch.tensor(_flip(key, np.asarray(leaves[leaf])))
            if value.shape != want[name].shape:
                raise ValueError(f"{name}: shape {tuple(value.shape)} from "
                                 f"leaf {leaf!r}, the model has "
                                 f"{tuple(want[name].shape)}")
            out[name] = value.to(want[name].dtype).to(
                want[name].device).contiguous()
    if set(out) != set(want):
        raise ValueError(f"no JAX leaf for {sorted(set(want) - set(out))}")
    return out


def jax_params_from_state_dict(model: torch.nn.Module):
    """The inverse: ``model``'s weights as the JAX package's pytree of
    numpy arrays, [in, out] dense weights."""
    state = model.state_dict()
    out = []
    for prefix, module, _ in _modules(model):
        out.append({leaf: _flip(key, state[prefix + key].detach().cpu()
                                .numpy()).copy()
                    for leaf, key in _LEAVES[type(module)]})
    return out[0] if type(model) in _LEAVES else out
