"""Weights carried between the JAX package's parameter pytrees and the
port's ``state_dict``s.

The JAX package keeps a layer's parameters as a dict of arrays (a model's
as a list of them, one per layer, or one dict for APPNP and the MLP and
DistMult link-prediction decoders), with dense
weights [in, out]; the port keeps them in ``nn.Linear``s, [out, in].
Every leaf maps to one ``state_dict`` entry (each module's
``JAX_LEAVES``), transposed where that entry is a ``Linear.weight``.
Arrays cross as numpy arrays (call ``np.asarray`` on the JAX side), so
this module never sees JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from cugraph_tpu_torch.nn.layers import _JaxLeaves, params_of


def _modules(model):
    """(state_dict prefix, module, index into the pytree or None) for
    every module that holds leaves: a stack's layers, or the model."""
    if isinstance(model, _JaxLeaves):
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
        for leaf, key in module.JAX_LEAVES:
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
    params = params_of(model)
    if isinstance(params, dict):
        return {k: v.cpu().numpy() for k, v in params.items()}
    return [{k: v.cpu().numpy() for k, v in p.items()} for p in params]
