"""χ² statistics of repeated random out-neighbour picks (the draws of
``per_v_random_select`` or of a with-replacement sampler) over a CSR, in
NumPy on the host.  A parallel edge weights its neighbour by its
multiplicity, as the uniform law over the row's edges does.

``rows_chi2`` sums one χ² per row over many rows of moderate degree: a
pick that ignores part of a row's support, or favours some positions,
moves the sum by many standard deviations even where each row alone
would pass.  ``binned_chi2`` groups one long row's neighbours into
contiguous bins of its edge positions, so that a select confined to a
span of a heavy row shows with few draws."""

from __future__ import annotations

import numpy as np


def _host(a) -> np.ndarray:
    return np.asarray(a.cpu().numpy() if hasattr(a, "cpu") else a)


def rows_chi2(offsets, indices, rows, picks) -> tuple[float, int]:
    """(χ², degrees of freedom) summed over ``rows`` (int [R], each with
    an out-edge) for ``picks`` (int [C, R]: C draws of a neighbour id per
    row).  Each row's expected count of a distinct neighbour is C times
    its multiplicity over the row's degree.  Raises on a pick that is not
    one of its row's neighbours."""
    off = _host(offsets).astype(np.int64)
    ind = _host(indices).astype(np.int64)
    rows = _host(rows).astype(np.int64)
    picks = _host(picks).astype(np.int64)
    calls = picks.shape[0]
    deg = off[rows + 1] - off[rows]
    if (deg <= 0).any():
        raise ValueError("every row needs an out-edge")
    slot = np.repeat(np.arange(len(rows)), deg)
    pos = np.repeat(off[rows] - np.cumsum(deg) + deg, deg) \
        + np.arange(int(deg.sum()))
    width = int(max(ind.max(initial=0), picks.max(initial=0))) + 1
    keys, mult = np.unique(slot * width + ind[pos], return_counts=True)
    pk = (np.arange(len(rows))[None, :] * width + picks).reshape(-1)
    at = np.searchsorted(keys, pk)
    if not (at < len(keys)).all() or not (keys[np.minimum(
            at, len(keys) - 1)] == pk).all():
        raise AssertionError("a pick is not one of its row's neighbours")
    obs = np.bincount(at, minlength=len(keys))
    exp = calls * mult / deg[keys // width]
    return float(((obs - exp) ** 2 / exp).sum()), len(keys) - len(rows)


def binned_chi2(offsets, indices, row: int, picks,
                bins: int = 20) -> tuple[float, int]:
    """(χ², degrees of freedom) of ``picks`` (int [C], neighbour ids of
    ``row``) over ``bins`` groups of the row's edge positions: a distinct
    neighbour falls in the bin of its first position, and a bin expects C
    times its edges over the row's degree."""
    off = _host(offsets).astype(np.int64)
    nbr = _host(indices)[off[row]:off[row + 1]].astype(np.int64)
    picks = _host(picks).astype(np.int64).reshape(-1)
    d = len(nbr)
    uniq, first, mult = np.unique(nbr, return_index=True,
                                  return_counts=True)
    nbin = first * bins // d
    exp = len(picks) * np.bincount(nbin, weights=mult, minlength=bins) / d
    at = np.searchsorted(uniq, picks)
    if not (at < len(uniq)).all() or not (uniq[np.minimum(
            at, len(uniq) - 1)] == picks).all():
        raise AssertionError("a pick is not one of the row's neighbours")
    obs = np.bincount(nbin[at], minlength=bins)
    keep = exp > 0
    return (float(((obs[keep] - exp[keep]) ** 2 / exp[keep]).sum()),
            int(keep.sum()) - 1)
