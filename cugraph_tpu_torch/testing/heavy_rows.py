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
