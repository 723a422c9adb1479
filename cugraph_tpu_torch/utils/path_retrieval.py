"""Traversed-cost retrieval over a BFS/SSSP predecessor tree.

Reference: python/cugraph/cugraph/utilities/path_retrieval.py
get_traversed_cost:12 (CUDA walk in path_retrieval_wrapper) — sums the
edge weights along each vertex's predecessor path back to the source.
Here the per-vertex path sums are computed by pointer doubling over the
predecessor forest: O(log depth) vectorized passes instead of a per-vertex
host walk.  The port's own copy of ``cugraph_tpu.utils.path_retrieval``
(NumPy on the host, over a result frame).
"""

from __future__ import annotations

import numpy as np
import pandas as pd


def get_traversed_cost(df, source, source_col, dest_col, value_col):
    """Sum ``value_col`` weights along each vertex's predecessor path.

    df: BFS/SSSP result with 'vertex', 'distance', 'predecessor'.
    source: source vertex id.  source_col/dest_col/value_col: edge arrays
    (symmetrized internally, matching the reference).  Returns
    ['vertex', 'info']; unreachable vertices carry the dtype max.
    """
    for col in ("vertex", "distance", "predecessor"):
        if col not in df.columns:
            raise ValueError(
                "DataFrame does not appear to be a BFS or "
                f"SSP result - '{col}' column missing")

    s = np.asarray(source_col)
    d = np.asarray(dest_col)
    w = np.asarray(value_col)
    # symmetrize the weight lookup (reference symmetrize() call)
    s2 = np.concatenate([s, d]).astype(np.int64)
    d2 = np.concatenate([d, s]).astype(np.int64)
    w2 = np.concatenate([w, w]).astype(np.float64)

    verts = np.asarray(df["vertex"])
    pred = np.asarray(df["predecessor"])
    n = len(verts)
    max_val = float(np.finfo(np.asarray(value_col).dtype).max
                    if np.issubdtype(np.asarray(value_col).dtype,
                                     np.floating) else np.finfo(np.float64).max)

    has_pred = pred >= 0
    is_src = verts == source

    # weight of the tree edge (pred[v], v) via sorted-key lookup
    mult = np.int64(max(int(d2.max()) + 1 if len(d2) else 1, 1))
    flat = s2 * mult + d2
    eorder = np.argsort(flat)
    flat_s, w_s = flat[eorder], w2[eorder]
    add = np.zeros(n, np.float64)
    if has_pred.any():
        q = pred[has_pred].astype(np.int64) * mult \
            + verts[has_pred].astype(np.int64)
        p = np.minimum(np.searchsorted(flat_s, q), max(len(flat_s) - 1, 0))
        hit = (len(flat_s) > 0) & (flat_s[p] == q)
        add[has_pred] = np.where(hit, w_s[p], max_val)

    # predecessor row pointers; roots (source / unreachable) self-loop
    vorder = np.argsort(verts)
    vs = verts[vorder]
    pp = np.minimum(np.searchsorted(vs, pred[has_pred]), n - 1)
    ok = vs[pp] == pred[has_pred]
    jump = np.arange(n)
    jump[np.flatnonzero(has_pred)[ok]] = vorder[pp[ok]]

    # pointer doubling: add accumulates the path sum, jump halves the depth
    self_rows = np.arange(n)
    for _ in range(max(1, int(np.ceil(np.log2(max(n, 2)))) + 1)):
        contrib = np.where(jump != self_rows, add[jump], 0.0)
        new_jump = jump[jump]
        if not contrib.any():
            break
        add = add + contrib
        jump = new_jump

    add[is_src] = 0.0
    add[~has_pred & ~is_src] = max_val
    return pd.DataFrame({"vertex": verts, "info": add})
