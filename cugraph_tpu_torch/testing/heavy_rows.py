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
values of the min/max kernels' modes, ``select_nan_and_signed_zeros``
among the inputs of the argmax select's, and ``hold_select_specials``
checks what the select must give on them.
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


def select_nan_and_signed_zeros(offsets, indices, x, w, mode):
    """Copies of ``x`` and ``w`` ([n] and [m], NumPy float32) that put NaNs
    and signed zeros among the inputs of one mode of the argmax select
    ("eqsel_rel_unit", "eqsel_rel" or "eqsel") over one CSR (NumPy
    ``offsets`` and ``indices``):

    - the second heaviest row ("zero row") gets x[r] = +0.0; under eqsel
      its weights are -0.0 and +0.0 in turn, so every edge passes
      (-0.0 == +0.0); under eqsel_rel its sources' x are -0.0 and +0.0 in
      turn and its weights -0.0, so none does (neither zero lies strictly
      below +0.0);
    - NaN in x[r] of the lightest other row with edges ("nan row"), which
      then selects nothing;
    - NaN in x[u] of a source of the heaviest row ("nan source") and,
      where the mode reads weights, in the weight of one of its edges
      ("nan edge"), one whose source appears on no other of its edges
      where there is one;
    - one other edge of the heaviest row made to pass ("pass edge"), so
      that the row selects an id.

    The nan row and source are taken among those that feed no zero-row
    edge where there are any.  Returns (x, w, where), ``where`` a dict of
    those rows, source and edges (the nan edge None at unit weight)."""
    degs = np.diff(offsets)
    order = np.argsort(-degs, kind="stable")
    heavy, zero_row = int(order[0]), int(order[1])
    x, w = x.copy(), w.copy()
    z = np.arange(offsets[zero_row], offsets[zero_row + 1])
    zero_src = np.unique(indices[z])
    signs = np.where(np.arange(len(z)) % 2 == 0, -0.0, 0.0).astype(np.float32)
    x[zero_row] = 0.0
    if mode == "eqsel":
        w[z] = signs
    else:
        x[zero_src] = signs[:len(zero_src)]
        w[z] = -0.0

    def first(cands):  # preferring one that feeds no zero-row edge
        cands = [int(c) for c in cands]
        return next((c for c in cands if c not in zero_src), cands[0])

    nan_row = first(r for r in order[::-1]
                    if degs[r] > 0 and r not in (heavy, zero_row))
    x[nan_row] = np.nan
    h = np.arange(offsets[heavy], offsets[heavy + 1])
    h = np.roll(h, -(len(h) // 2))  # from the middle edge on
    src = indices[h]
    nan_source = first(u for u in src if u not in (heavy, zero_row, nan_row))
    x[nan_source] = np.nan
    nan_edge = None
    if mode != "eqsel_rel_unit":
        once = np.bincount(src, minlength=len(x))[src] == 1
        nan_edge = int(h[np.argmax(once & (src != nan_source))])
        w[nan_edge] = np.nan
    pass_edge = int(h[np.argmax(~np.isin(
        src, [heavy, zero_row, nan_row, nan_source]) & (h != nan_edge))])
    if mode == "eqsel":
        w[pass_edge] = x[heavy]
    else:  # x[u] + w == x[r] exactly, and x[u] < x[r]
        x[indices[pass_edge]] = 0.5
        x[heavy] = np.float32(0.5) + (np.float32(1.0) if mode ==
                                      "eqsel_rel_unit" else w[pass_edge])
    return x, w, {"heavy": heavy, "nan_row": nan_row, "zero_row": zero_row,
                  "nan_source": nan_source, "nan_edge": nan_edge,
                  "pass_edge": pass_edge}


def hold_select_specials(y, offsets, indices, x, w, mode, where,
                         label=None):
    """Raise AssertionError unless the select's output ``y`` (NumPy int32)
    on the inputs of ``select_nan_and_signed_zeros`` holds what those
    inputs force: the NaNs are there (else the check is vacuous), the nan
    row selects nothing, the heaviest row selects at least its pass edge's
    source and neither the nan source (unread under eqsel) nor the nan
    edge's source (unless a parallel edge has it), and the zero row selects
    its largest source under eqsel and nothing under eqsel_rel.  Messages
    start with ``label`` (default: the mode)."""
    label = label or mode
    if not (np.isnan(x[where["nan_row"]]) and np.isnan(x[where["nan_source"]])
            and (where["nan_edge"] is None or np.isnan(w[where["nan_edge"]]))):
        raise AssertionError(f"{label}: no NaN where one was put; the check "
                             "is vacuous")
    if y[where["nan_row"]] != -1:
        raise AssertionError(f"{label}: the row whose x is NaN selected "
                             f"{y[where['nan_row']]}")
    heavy = where["heavy"]
    banned = set() if mode == "eqsel" else {where["nan_source"]}
    if where["nan_edge"] is not None:  # unless a parallel edge may pass
        u = indices[where["nan_edge"]]
        if (indices[offsets[heavy]:offsets[heavy + 1]] == u).sum() == 1:
            banned.add(int(u))
    if int(y[heavy]) in banned:
        raise AssertionError(f"{label}: the heaviest row selected "
                             f"{y[heavy]} across a NaN")
    if y[heavy] < indices[where["pass_edge"]]:
        raise AssertionError(f"{label}: the heaviest row selected "
                             f"{y[heavy]}, below its passing edge's source")
    r = where["zero_row"]
    want = int(indices[offsets[r]:offsets[r + 1]].max()) \
        if mode == "eqsel" else -1
    if y[r] != want:
        raise AssertionError(f"{label}: the zero row selected {y[r]}, not "
                             f"{want}")


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
