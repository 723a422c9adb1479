"""Shared helpers for algorithm wrappers: device -> host result framing and
the renumbering glue (start vertices in, predecessor columns out)."""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch


def vertex_frame(G, values_by_name: dict) -> pd.DataFrame:
    """A DataFrame with a 'vertex' column (external ids) plus one column per
    entry of ``values_by_name`` (tensors on any device, or host arrays, of
    length V)."""
    n = G.number_of_vertices()
    out = {"vertex": G.number_map.to_external(np.arange(n))}
    for name, vals in values_by_name.items():
        out[name] = (vals.cpu().numpy() if isinstance(vals, torch.Tensor)
                     else np.asarray(vals))
    return pd.DataFrame(out)


def unrenumber_column(G, arr: np.ndarray, *, sentinel=-1, sentinel_value=-1):
    """Map internal ids back to external, keeping sentinel entries (a BFS
    predecessor of -1): ``sentinel_value`` for integer ids, None otherwise."""
    arr = np.asarray(arr)
    out = np.empty(arr.shape,
                   dtype=G.number_map.to_external(np.array([0])).dtype)
    mask = arr != sentinel
    out[mask] = G.number_map.to_external(arr[mask])
    if np.issubdtype(out.dtype, np.integer):
        out[~mask] = sentinel_value
    else:
        out = out.astype(object)
        out[~mask] = None
    return out


def normalize_start(G, start) -> np.ndarray:
    """Internal ids of one or more external start vertices."""
    return G.lookup_internal_vertex_id(np.atleast_1d(np.asarray(start)))
