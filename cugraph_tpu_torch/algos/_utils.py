"""Shared helpers for algorithm wrappers: device -> host result framing,
the renumbering glue (start vertices in, predecessor columns out) and the
128-source panels of the multi-source sweeps."""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from cugraph_tpu_torch.utils.profiling import span


def vertex_frame(G, values_by_name: dict) -> pd.DataFrame:
    """A DataFrame with a 'vertex' column (external ids) plus one column per
    entry of ``values_by_name`` (tensors on any device, or host arrays, of
    length V)."""
    with span("cugraph.vertex_frame"):
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


def source_panels(sources, width: int = 128):
    """Cut source ids into int32 panels of ``width``, padded with -1, for
    the batched multi-source sweeps (Brandes, multi-source BFS, OD panels).
    Yields (panel: np.int32[width], start: int, count: int), with
    panel[count:] = -1."""
    sources = np.asarray(sources)
    for i in range(0, len(sources), width):
        batch = sources[i:i + width]
        panel = np.full(width, -1, np.int32)
        panel[: len(batch)] = batch
        yield panel, i, len(batch)


def panel_onehot(g, panel: np.ndarray) -> torch.Tensor:
    """bool [n, B] on the graph's device: vertex v is the source of column
    b of ``panel`` (a padding column, -1, matches none)."""
    src = torch.as_tensor(panel, dtype=torch.int64, device=g.device)
    return torch.arange(g.num_vertices, device=g.device)[:, None] \
        == src[None, :]
