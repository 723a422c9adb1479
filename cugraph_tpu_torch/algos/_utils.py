"""Shared helpers for algorithm wrappers: device -> host result framing."""

from __future__ import annotations

import numpy as np
import pandas as pd


def vertex_frame(G, values_by_name: dict) -> pd.DataFrame:
    """A DataFrame with a 'vertex' column (external ids) plus one column per
    entry of ``values_by_name`` (tensors of length V, on any device)."""
    n = G.number_of_vertices()
    out = {"vertex": G.number_map.to_external(np.arange(n))}
    for name, vals in values_by_name.items():
        out[name] = vals.cpu().numpy()
    return pd.DataFrame(out)
