"""The heavy-row span logic of ``kernels/csrc/csr_spans.cuh``, modelled in
NumPy step for step, so that its indexing is checked without a card.

The model replays what the two passes of K1, K2, K3, K4 and K5 do with
the header: the warp's 33-ary search (``search_round``,
``rows_of_edges``), the pieces of each span and their rows
(``heavy_pieces``) and the slot a row reads back (``slot_of``).  It
checks that every edge of a heavy row lies in exactly one piece and every
edge of a light row in none, that each piece's row holds its edges, that
a row pass reads only slots its own row wrote, and that the two passes
give each row's reduction: the sum (K1, K4), or min and max onto their
identity (K2, K5) over float values with NaNs on heavy and light rows,
and over int32 values, or K3's max over the ids of the edges that pass a
select mask onto -1 in int32.  Sums of small integers are exact in
float64, and min and max are exact, so every comparison is exact too (NaN
matching NaN).
"""

import numpy as np
import pytest

from cugraph_tpu_torch.testing.heavy_rows import (heavy_row_degrees,
                                                  heavy_row_edges)

WARP = 32


def search_round(offsets, e, lo, hi):
    """One round of the warp's search: lane i probes lo + (hi - lo)(i + 1)
    / 33, a ballot counts the probes at or below e."""
    q = [lo + (hi - lo) * (lane + 1) // 33 for lane in range(WARP)]
    k = sum(int(offsets[p] <= e) for p in q)
    if k > 0:
        lo = q[k - 1]
    if k < WARP:
        hi = q[k]
    return lo, hi


def rows_of_edges(offsets, a, b):
    n = len(offsets) - 1
    lo_a, hi_a, lo_b, hi_b = 0, n, 0, n
    rounds = 0
    while hi_a - lo_a > 1 or hi_b - lo_b > 1:
        lo_a, hi_a = search_round(offsets, a, lo_a, hi_a)
        lo_b, hi_b = search_round(offsets, b, lo_b, hi_b)
        rounds += 1
        assert rounds <= 64, "the search does not shrink"
    return lo_a, lo_b


def heavy_pieces(offsets, span, s):
    m = int(offsets[-1])
    e0 = s * span
    e1 = min(e0 + span, m)
    r0, r1 = rows_of_edges(offsets, e0, e1 - 1)
    end0, begin1 = int(offsets[r0 + 1]), int(offsets[r1])
    heavy0 = end0 - int(offsets[r0]) > span
    heavy1 = r1 != r0 and int(offsets[r1 + 1]) - begin1 > span
    return ((r0, e0, min(end0, e1)) if heavy0 else None,
            (r1, begin1, e1) if heavy1 else None)


def slot_of(begin, span, s):
    return 1 if s == begin // span and begin % span != 0 else 0


# (reduce, identity, dtype) by name: the sum of K1 and K4; the NaN-passing
# min and max of K2 and K5 in fp32, onto ±1e30; K2's int32 min and max;
# K3's max over selected ids, onto -1
REDUCTIONS = {
    "sum": (np.add, 0.0, np.float64),
    "min": (np.minimum, 1e30, np.float32),
    "max": (np.maximum, -1e30, np.float32),
    "min_i32": (np.minimum, np.iinfo(np.int32).max, np.int32),
    "max_i32": (np.maximum, np.iinfo(np.int32).min, np.int32),
    "select": (np.maximum, -1, np.int32),
}


def two_passes(offsets, values, span, op=np.add, identity=0.0):
    """Per-row reductions by ``op`` of ``values`` (one per edge) onto
    ``identity``, the way the kernels form them, with the checks on
    coverage and slot ownership."""
    n, m = len(offsets) - 1, int(offsets[-1])
    spans = -(-m // span)
    slots = np.zeros(2 * spans, values.dtype)
    owner = np.full(2 * spans, -1)
    covered = np.zeros(m, np.int64)
    for s in range(spans):
        for slot, piece in enumerate(heavy_pieces(offsets, span, s)):
            if piece is None:
                continue
            row, begin, end = piece
            assert offsets[row] <= begin < end <= offsets[row + 1]
            covered[begin:end] += 1
            slots[2 * s + slot] = op.reduce(values[begin:end],
                                            initial=identity)
            owner[2 * s + slot] = row
    y = np.full(n, identity, values.dtype)
    for row in range(n):
        begin, end = int(offsets[row]), int(offsets[row + 1])
        heavy = end - begin > span
        assert (covered[begin:end] == int(heavy)).all(), row
        if heavy:
            for s in range(begin // span, (end - 1) // span + 1):
                k = 2 * s + slot_of(begin, span, s)
                assert owner[k] == row, (row, s)
                y[row] = op(y[row], slots[k])
        else:
            y[row] = op.reduce(values[begin:end], initial=identity)
    return y


def _offsets(rows, n):
    return np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])


def _values(offsets, reduction, seed):
    """Small integers as the reduction's dtype, one per edge in CSR order;
    for the float min and max, a NaN on one edge of the heaviest row and
    on one edge of a light row with edges; for the select, the ids (in
    [0, 2^20)) of the edges a mask passes and -1 for the others, with the
    heaviest row's middle edge passed and a light row's edges all
    failed."""
    _, _, dtype = REDUCTIONS[reduction]
    m = int(offsets[-1])
    rng = np.random.default_rng(seed)
    values = rng.integers(-8, 9, m).astype(dtype)
    degs = np.diff(offsets)
    heavy = int(np.argmax(degs)) if m else 0
    light = np.flatnonzero((degs > 0) & (degs < degs[heavy]))
    mid = (offsets[heavy] + offsets[heavy + 1]) // 2
    if reduction in ("min", "max") and m:
        values[mid] = np.nan
        if len(light):
            values[offsets[light[-1]]] = np.nan
    if reduction == "select" and m:
        hit = rng.random(m) < 0.3
        hit[mid] = True
        if len(light):
            hit[offsets[light[-1]]:offsets[light[-1] + 1]] = False
        values = np.where(hit, rng.integers(0, 1 << 20, m), -1).astype(dtype)
    return values


def _skewed_rows(span, shuffled):
    """Power-law rows of 300 vertices, heaviest first with empty rows at
    both ends, or in shuffled order."""
    rng = np.random.default_rng(span)
    rows = np.minimum(rng.zipf(1.6, 4000), 300 - 20) + 9
    return rng.permutation(300)[rows] if shuffled else rows


EDGE_CASE_DEGREES = [[5], [0, 0, 9, 0], [4, 4], [9, 0, 0, 0],
                     [1] * 70 + [200]]


def _check(rows, n, span, seed, reduction="sum"):
    op, identity, _ = REDUCTIONS[reduction]
    order = np.argsort(rows, kind="stable")
    offsets = _offsets(rows, n)
    values = _values(offsets, reduction, seed)
    want = np.full(n, identity, values.dtype)
    with np.errstate(invalid="ignore"):  # NaN operands
        op.at(want, rows[order], values)
        got = two_passes(offsets, values, span, op, identity)
    np.testing.assert_array_equal(got, want)
    # rows with no edges keep the identity
    assert (got[np.diff(offsets) == 0] == identity).all()
    if reduction in ("min", "max"):
        assert np.isnan(got).any()
    if reduction == "select":  # the passed edge; a row of failed edges
        degs = np.diff(offsets)
        assert got[np.argmax(degs)] >= 0
        light = np.flatnonzero((degs > 0) & (degs < degs.max()))
        assert len(light) == 0 or got[light[-1]] == -1


@pytest.mark.parametrize("side", ["csc", "csr"])
@pytest.mark.parametrize("span", [1, 2, 3, 4, 8, 28, 32])
def test_two_passes_sum_every_row_of_the_heavy_row_graphs(span, side):
    n, src, dst, _ = heavy_row_edges(span, seed=span)
    _check(dst if side == "csc" else src, n, span, span)


@pytest.mark.parametrize("shuffled", [False, True])
@pytest.mark.parametrize("span", [1, 4, 16, 64])
def test_two_passes_sum_every_row_of_a_skewed_graph(span, shuffled):
    """Power-law rows, heaviest first with empty rows at both ends, or in
    shuffled order: correctness does not depend on the order of the
    rows."""
    _check(_skewed_rows(span, shuffled), 300, span, span + 1)


@pytest.mark.parametrize("degs", EDGE_CASE_DEGREES)
def test_two_passes_edge_cases(degs):
    """A single heavy row, heavy rows among empty ones, rows of exactly
    the span, and a heavy row after many light ones (a search of several
    rounds)."""
    rows = np.repeat(np.arange(len(degs)), degs)
    _check(rows, len(degs), 4, 0)


# the min/max reductions of K2 and K5: fp32 with NaNs, and K2's int32;
# K3's select
MIN_MAX = ["min", "max", "min_i32", "max_i32", "select"]


@pytest.mark.parametrize("reduction", MIN_MAX)
@pytest.mark.parametrize("side", ["csc", "csr"])
@pytest.mark.parametrize("span", [1, 2, 3, 4, 8, 28, 32])
def test_two_passes_min_max_every_row_of_the_heavy_row_graphs(span, side,
                                                              reduction):
    n, src, dst, _ = heavy_row_edges(span, seed=span)
    _check(dst if side == "csc" else src, n, span, span, reduction)


@pytest.mark.parametrize("reduction", MIN_MAX)
@pytest.mark.parametrize("shuffled", [False, True])
@pytest.mark.parametrize("span", [1, 4, 16, 64])
def test_two_passes_min_max_every_row_of_a_skewed_graph(span, shuffled,
                                                        reduction):
    _check(_skewed_rows(span, shuffled), 300, span, span + 1, reduction)


@pytest.mark.parametrize("reduction", MIN_MAX)
@pytest.mark.parametrize("degs", EDGE_CASE_DEGREES)
def test_two_passes_min_max_edge_cases(degs, reduction):
    rows = np.repeat(np.arange(len(degs)), degs)
    _check(rows, len(degs), 4, 0, reduction)


def test_search_finds_the_row_of_every_edge():
    """The 33-ary search gives, for every edge, the row that holds it, over
    rows with runs of empty rows."""
    degs = np.array(heavy_row_degrees(8) * 9)
    offsets = np.concatenate([[0], np.cumsum(degs)])
    rows = np.repeat(np.arange(len(degs)), degs)
    for e in range(0, int(offsets[-1]), 7):
        assert rows_of_edges(offsets, e, e) == (rows[e], rows[e])
