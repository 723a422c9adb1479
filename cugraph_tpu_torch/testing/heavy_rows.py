"""Edge lists whose rows sit on every boundary of the kernels' heavy-row
spans (``kernels/csrc/csr_spans.cuh``), scaled by the span.

Row r of the CSC (the in-edges of vertex r) has the r-th degree of
``heavy_row_degrees(span)``: degrees span − 1, span and span + 1; empty
rows; a light row that ends on a span boundary; two heavy rows back to
back, the first starting on a boundary; many empty rows between heavy
rows; a heavy row starting inside a span; and a heavy last row, with an
edge count that is not a multiple of the span.  Each row's sources are
half distinct (a star) and half drawn from three hub vertices (parallel
edges), so the CSR, whose rows are the sources, has heavy rows too.
``nan_and_signed_zeros`` puts NaNs and zeros of both signs among the edge
values of the min/max kernels' modes.
"""

from __future__ import annotations

import numpy as np


def heavy_row_degrees(span: int) -> list[int]:
    """In-degrees of vertices 0, 1, ... for a span of ``span`` >= 28 edges
    (smaller spans keep every case but the ragged last span)."""
    t = span
    degs = [t - 1, t, t + 1, 0, 0]
    degs.append(-sum(degs) % t)  # ends on a span boundary
    degs += [2 * t, 3 * t + 5]   # heavy, back to back, from a boundary
    degs += [0] * (3 * t)        # empty rows between heavy rows
    degs += [1, 7, 0, t + 3]     # heavy, starting inside a span
    degs += [2] * 5 + [2 * t + 1]  # a heavy last row
    return degs


def nan_and_signed_zeros(offsets, indices, x, w, combine):
    """Copies of ``x`` ([n] or [n, F]) and ``w`` (NumPy float32) that put
    special values among the edge values COMBINE(x[indices[e]], w[e]) of
    one CSR (NumPy ``offsets`` and ``indices``): the second heaviest row's
    values all zeros, -0.0 and +0.0 in turn by edge ("right") or by source
    vertex (so both signs when it has two sources), and a NaN on an edge
    of the heaviest row and on an edge of the lightest row that can take
    one, from the weight, or for "left" from x (its middle feature) at a
    vertex that feeds no zero.  Returns (x, w, (heaviest, light, zero
    row))."""
    def signs(k):
        return np.where(np.arange(k) % 2 == 0, -0.0, 0.0).astype(np.float32)

    degs = np.diff(offsets)
    order = np.argsort(-degs, kind="stable")
    heavy, zero_row = int(order[0]), int(order[1])
    x, w = x.copy(), w.copy()
    z = np.arange(offsets[zero_row], offsets[zero_row + 1])
    feeds_zero = np.zeros(len(x), bool)
    if combine == "right":
        w[z] = signs(len(z))
    else:
        src = np.unique(indices[z])
        feeds_zero[src] = True
        x[src] = signs(len(src)).reshape((-1,) + (1,) * (x.ndim - 1))
        if combine in ("add", "mul"):
            w[z] = -0.0 if combine == "add" else 1.0

    def nan_edge(row):  # from the middle edge on
        edges = np.roll(np.arange(offsets[row], offsets[row + 1]),
                        -(degs[row] // 2))
        return next((int(e) for e in edges if combine != "left"
                     or not feeds_zero[indices[e]]), None)

    picked = [(heavy, nan_edge(heavy))]
    picked.append(next((int(r), nan_edge(r)) for r in order[::-1]
                       if degs[r] > 0 and r not in (heavy, zero_row)
                       and nan_edge(r) is not None))
    for row, e in picked:
        if e is None:
            raise ValueError(f"every edge of row {row} feeds a zero")
        if combine == "left":
            x[(indices[e],) + (x.shape[-1] // 2,) * (x.ndim - 1)] = np.nan
        else:
            w[e] = np.nan
    return x, w, (heavy, picked[1][0], zero_row)


def heavy_row_edges(span: int, seed: int = 0):
    """(n, src, dst, w): the edges of ``heavy_row_degrees(span)`` as int64
    sources and destinations and float32 weights in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    degs = heavy_row_degrees(span)
    n = len(degs)
    src, dst = [], []
    for row, d in enumerate(degs):
        star = min(d // 2, n)
        src += [rng.permutation(n)[:star], rng.integers(0, 3, d - star)]
        dst.append(np.full(d, row))
    src = np.concatenate(src).astype(np.int64)
    dst = np.concatenate(dst).astype(np.int64)
    w = rng.uniform(0.5, 1.5, len(src)).astype(np.float32)
    return n, src, dst, w
