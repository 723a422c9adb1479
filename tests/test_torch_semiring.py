"""Kernels K2 and K3 of the PyTorch port: the min/max semiring SpMV and the
argmax select over one CSR.

On the CPU each wrapper takes its plain version, which must equal the TPU
kernel ``spmv_onehot`` run in interpret mode bit for bit: min, max and the
argmax are exact, and the TPU kernel's "highest" (or, for the id selects,
"split3") precision makes its one-hot selections exact too.  The heavy-row
graphs and the NaN and signed-zero cases hold the plain K2 against the
JAX package's XLA route (segment min/max of the clipped edge values),
bit for bit with NaN matching NaN.  The tests marked ``cuda`` hold the
hand-written kernels against the plain versions on the card and skip
without one.
"""

import contextlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cugraph_tpu.kernels.spmv_onehot import (SEMIRING_BIG, build_spmv_plan,
                                             spmv_onehot)

from cugraph_tpu_torch.core.structure import build_csr, build_structure
from cugraph_tpu_torch.kernels import semiring as sr
from cugraph_tpu_torch.kernels.semiring import (spmv_select,
                                                spmv_select_reference,
                                                spmv_semiring,
                                                spmv_semiring_reference)
from cugraph_tpu_torch.kernels.spmv import span_slots
from cugraph_tpu_torch.testing import bit_mismatches
from cugraph_tpu_torch.testing.heavy_rows import (hold_select_specials,
                                                  heavy_row_edges,
                                                  nan_and_signed_zeros,
                                                  select_nan_and_signed_zeros)

torch.set_num_threads(1)
REDUCES = ["min", "max"]
COMBINES = ["add", "left", "mul", "right"]


def _cases():
    """(name, n, src, dst, w): the shapes of the JAX kernel tests, plus a
    graph whose low ids have no in-edges (empty rows) and self-loops."""
    out = []
    for n, m in [(300, 2000), (9, 4)]:
        rng = np.random.default_rng(n + m)
        out.append((f"n{n}_m{m}", n, rng.integers(0, n, m),
                    rng.integers(0, n, m), rng.random(m).astype(np.float32)))
    rng = np.random.default_rng(5)
    out.append(("empty_rows", 60, rng.integers(0, 60, 400),
                rng.integers(20, 60, 400), rng.random(400).astype(np.float32)))
    out.append(("loops_multi", 3, np.array([0, 0, 0, 2, 2, 1]),
                np.array([1, 1, 0, 2, 2, 1]),
                np.array([1, 2, 3, 4, 5, 6], np.float32)))
    return out


CASES = _cases()
IDS = [c[0] for c in CASES]


def _plan_and_csc(case):
    _, n, src, dst, w = case
    return build_spmv_plan(src, dst, w, n), build_csr(dst, src, w, n, "cpu")


def _x(plan, seed):
    """x over the plan's padding, with some entries at the semiring's
    infinity (unreached vertices)."""
    rng = np.random.default_rng(seed)
    x = (rng.random(plan.pad_v) * 10).astype(np.float32)
    x[::7] = SEMIRING_BIG
    return x


def _jax_ids(y, n):
    """The TPU kernel's f32 ids (-BIG for none) as the port's int32 (-1)."""
    y = np.asarray(y)[:n]
    return np.where(y > -SEMIRING_BIG / 2, y, -1).astype(np.int32)


@pytest.mark.parametrize("combine", COMBINES)
@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_semiring_matches_pallas_interpret(case, reduce, combine):
    n = case[1]
    plan, csc = _plan_and_csc(case)
    x = _x(plan, n)
    want = np.asarray(spmv_onehot(plan, jnp.asarray(x), interpret=True,
                                  precision="highest", reduce=reduce,
                                  combine=combine))[:n]
    got = spmv_semiring(csc.offsets, csc.indices,
                        None if combine == "left" else csc.weights,
                        torch.from_numpy(x[:n]), reduce, combine)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_int32_left_matches_pallas_interpret(case, reduce):
    """int32 labels against the TPU kernel's f32 ones (exact below 2^24);
    the identities differ by type: INT32_MAX/MIN against ±1e30."""
    n = case[1]
    plan, csc = _plan_and_csc(case)
    labels = np.random.default_rng(n).permutation(plan.pad_v).astype(np.int32)
    want = np.asarray(spmv_onehot(plan, jnp.asarray(labels, jnp.float32),
                                  interpret=True, precision="highest",
                                  reduce=reduce, combine="left"))[:n]
    got = spmv_semiring(csc.offsets, csc.indices, None,
                        torch.from_numpy(labels[:n]), reduce).numpy()
    assert got.dtype == np.int32
    empty = np.abs(want) >= SEMIRING_BIG / 2
    ident = sr.semiring_identity(reduce, torch.int32)
    np.testing.assert_array_equal(got[empty], ident)
    np.testing.assert_array_equal(got[~empty], want[~empty].astype(np.int32))


def _distances(case, pad_v, unit):
    """float32 shortest-path distances from vertex 0 by Bellman-Ford, 1e30
    where unreached: the x that predecessor recovery is given."""
    _, n, src, dst, w = case
    w = np.ones(len(src), np.float32) if unit else w
    d = np.full(pad_v, SEMIRING_BIG, np.float32)
    d[0] = 0.0
    while True:
        cand = np.where(d[src] < SEMIRING_BIG / 2, d[src] + w, SEMIRING_BIG)
        new = d.copy()
        np.minimum.at(new, dst, cand.astype(np.float32))
        if np.array_equal(new, d):
            return d
        d = new


@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_eqsel_rel_matches_pallas_interpret(case, unit):
    """Predecessor recovery over converged distances, with unit weights as
    BFS passes them and with the graph's weights as SSSP does; a third of
    the weighted distances are nudged within the relative tolerance.  The
    port also requires x[u] < x[r]: it agrees on every reached row, and
    selects nothing on unreached rows, where the TPU kernel matches 1e30
    neighbours to each other."""
    _hold_eqsel_rel_against_pallas(case, unit)


@pytest.mark.parametrize("unit", [False, True])
def test_eqsel_rel_on_heavy_rows_matches_pallas_interpret(unit):
    """The same on the heavy-row graph at span 32 (114 vertices; rows of
    31 to 101 edges on and off the span boundaries), whose rows K3 splits
    at span 32."""
    n, src, dst, w = heavy_row_edges(32, seed=32)
    _hold_eqsel_rel_against_pallas(("heavy_rows_32", n, src, dst, w), unit)


def _hold_eqsel_rel_against_pallas(case, unit):
    import dataclasses

    n = case[1]
    plan, csc = _plan_and_csc(case)
    x = _distances(case, plan.pad_v, unit)
    if unit:
        plan = dataclasses.replace(plan, weight=jnp.where(
            jnp.isnan(plan.weight), jnp.nan, 1.0))
        atol, rtol = 0.25, 0.0
    else:
        x[1::3] = x[1::3] * np.float32(1 + 1e-5)
        atol, rtol = 1e-6, 2e-5
    want = spmv_onehot(plan, jnp.asarray(x), interpret=True,
                       precision="split3", reduce="max",
                       combine="eqsel_rel", eq_atol=atol, eq_rtol=rtol)
    got = spmv_select(csc.offsets, csc.indices,
                      None if unit else csc.weights,
                      torch.from_numpy(x[:n]), "eqsel_rel", atol, rtol)
    assert got.dtype == torch.int32
    got, want = got.numpy(), _jax_ids(want, n)
    reached = x[:n] < SEMIRING_BIG / 2
    np.testing.assert_array_equal(got[reached], want[reached])
    assert (got[~reached] == -1).all()
    # every reached vertex but the source has a parent
    assert int((got >= 0).sum()) == int(reached.sum()) - 1


def test_eqsel_rel_requires_a_strictly_closer_candidate():
    """Two vertices joined by an edge lighter than the tolerance pass the
    TPU kernel's test for each other; the port keeps only the closer one."""
    src = np.array([0, 1, 2])
    dst = np.array([1, 2, 1])
    w = np.array([1.0, 1e-6, 1e-6], np.float32)
    plan = build_spmv_plan(src, dst, w, 3)
    x = np.zeros(plan.pad_v, np.float32)
    x[:3] = [0.0, 1.0, np.float32(1.0) + np.float32(1e-6)]
    want = _jax_ids(spmv_onehot(plan, jnp.asarray(x), interpret=True,
                                precision="split3", reduce="max",
                                combine="eqsel_rel", eq_atol=1e-6,
                                eq_rtol=2e-5), 3)
    assert want.tolist() == [-1, 2, 1]  # 1 and 2 each other's parent
    csc = build_csr(dst, src, w, 3, "cpu")
    got = spmv_select(csc.offsets, csc.indices, csc.weights,
                      torch.from_numpy(x[:3]), "eqsel_rel", 1e-6, 2e-5)
    assert got.tolist() == [-1, 0, 1]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_eqsel_matches_pallas_interpret(case):
    """The random neighbour select's two passes: (max, right) gives each
    row's largest priority, eqsel the largest id whose edge carries it."""
    n = case[1]
    plan, csc = _plan_and_csc(case)
    zeros = np.zeros(plan.pad_v, np.float32)
    y1 = spmv_onehot(plan, jnp.asarray(zeros), interpret=True,
                     precision="split3", reduce="max", combine="right")
    want = spmv_onehot(plan, y1, interpret=True, precision="split3",
                       reduce="max", combine="eqsel", gather="dst")
    has = np.asarray(y1)[:n] > -SEMIRING_BIG / 2
    y1_t = spmv_semiring(csc.offsets, csc.indices, csc.weights,
                         torch.zeros(n), "max", "right")
    np.testing.assert_array_equal(y1_t.numpy(), np.asarray(y1)[:n])
    got = spmv_select(csc.offsets, csc.indices, csc.weights, y1_t, "eqsel")
    np.testing.assert_array_equal(got.numpy(),
                                  np.where(has, _jax_ids(want, n), -1))
    assert bool((got.numpy() >= 0).any()) or csc.num_edges == 0


def _numpy_select(offsets, indices, w, x, mode, atol, rtol):
    """The select written out in NumPy float32, each operation rounded
    once, independently of the port: the largest id whose edge passes,
    else -1."""
    n = len(offsets) - 1
    rows = np.repeat(np.arange(n), np.diff(offsets))
    xr = x[rows]
    with np.errstate(invalid="ignore"):  # NaN operands
        if mode == "eqsel":
            hit = w == xr
        else:
            xu = x[indices]
            ww = np.float32(1.0) if w is None else w
            tol = np.float32(atol) + np.float32(rtol) * np.abs(xr)
            hit = (np.abs(xu + ww - xr) <= tol) & (xu < xr)
    y = np.full(n, -1, np.int32)
    np.maximum.at(y, rows[hit], indices[hit])
    return y


# K3's modes as (chip_smoke key, wrapper mode, atol, rtol)
SELECT_MODES = [("eqsel_rel_unit", "eqsel_rel", 0.25, 0.0),
                ("eqsel_rel", "eqsel_rel", 1e-6, 2e-5),
                ("eqsel", "eqsel", 0.0, 0.0)]
SELECT_IDS = [k for k, *_ in SELECT_MODES]


def _select_x_w(adj, key, seed):
    """x and w (NumPy float32) for one K3 mode on one CSR: Bellman-Ford
    levels (unit) or distances from vertex 0 over the CSR's weights, or,
    for eqsel, random priorities and each row's largest."""
    off, idx = adj.offsets.numpy(), adj.indices.numpy()
    n, m = len(off) - 1, len(idx)
    rng = np.random.default_rng(seed)
    if key == "eqsel":
        w = rng.random(m).astype(np.float32)
        x = np.full(n, -SEMIRING_BIG, np.float32)
        np.maximum.at(x, np.repeat(np.arange(n), np.diff(off)), w)
        return x, w
    w = np.ones(m, np.float32) if key == "eqsel_rel_unit" \
        else adj.weights.numpy()
    rows = np.repeat(np.arange(n), np.diff(off))
    d = np.full(n, SEMIRING_BIG, np.float32)
    d[0] = 0.0
    while True:  # relax in-edges: row r pulls from its minor ids
        cand = np.where(d[idx] < SEMIRING_BIG / 2, d[idx] + w, SEMIRING_BIG)
        new = d.copy()
        np.minimum.at(new, rows, cand.astype(np.float32))
        if np.array_equal(new, d):
            return d, w
        d = new


@pytest.mark.parametrize("key", SELECT_IDS)
@pytest.mark.parametrize("case", ["heavy_rows_csc", "heavy_rows_csr",
                                  "n300_m2000"])
def test_select_never_selects_nan_and_takes_signed_zeros(case, key):
    """A NaN in x[u], in x[r] or in w fails the test, so the edge is never
    selected and a row whose x is NaN selects nothing; under eqsel
    w = -0.0 against x[r] = +0.0 is selected, and under eqsel_rel
    neither zero lies strictly below +0.0
    (``testing.heavy_rows.select_nan_and_signed_zeros``).  The plain K3
    equals a NumPy replay of the test bit for bit, on the heavy-row graph
    at span 8 (CSC and CSR) and on a random one."""
    _, mode, atol, rtol = dict(zip(SELECT_IDS, SELECT_MODES))[key]
    if case.startswith("heavy_rows"):
        n, src, dst, w = heavy_row_edges(8, seed=8)
    else:
        rng = np.random.default_rng(2300)
        n, src, dst = 300, rng.integers(0, 300, 2000), \
            rng.integers(0, 300, 2000)
        w = rng.uniform(0.5, 1.5, 2000).astype(np.float32)
    g = build_structure(src, dst, w, n, "cpu")
    adj = g.csr if case.endswith("csr") else g.csc
    off, idx = adj.offsets.numpy(), adj.indices.numpy()
    x, wv = _select_x_w(adj, key, n)
    x, wv, where = select_nan_and_signed_zeros(off, idx, x, wv, key)
    wt = None if key == "eqsel_rel_unit" else torch.from_numpy(wv)
    got = spmv_select(adj.offsets, adj.indices, wt, torch.from_numpy(x),
                      mode, atol, rtol).numpy()
    want = _numpy_select(off, idx, None if wt is None else wv, x, mode, atol,
                         rtol)
    np.testing.assert_array_equal(got, want)
    hold_select_specials(got, off, idx, x, wv, key, where)


def test_pallas_route_skips_a_nan_weight_as_the_port_fails_it():
    """The TPU kernel reads a NaN weight as a padding lane and skips the
    edge (``spmv_onehot.py:503``); the port's test fails on it.  Both give
    the same predecessors: the edge is never selected."""
    import dataclasses

    src = np.array([0, 1, 0, 2, 3])
    dst = np.array([1, 2, 2, 3, 2])
    w = np.array([1.0, 1.0, 777.0, 1.0, 1.0], np.float32)
    plan = build_spmv_plan(src, dst, w, 4)
    plan = dataclasses.replace(plan, weight=jnp.where(
        plan.weight == 777.0, jnp.nan, plan.weight))
    x = np.full(plan.pad_v, SEMIRING_BIG, np.float32)
    x[:4] = [0.0, 1.0, 2.0, 3.0]
    want = _jax_ids(spmv_onehot(plan, jnp.asarray(x), interpret=True,
                                precision="split3", reduce="max",
                                combine="eqsel_rel", eq_atol=1e-6,
                                eq_rtol=2e-5), 4)
    w[2] = np.nan
    csc = build_csr(dst, src, w, 4, "cpu")
    got = spmv_select(csc.offsets, csc.indices, csc.weights,
                      torch.from_numpy(x[:4]), "eqsel_rel", 1e-6, 2e-5)
    # vertex 2 is reached from 1 (1 + 1) and from 0 only across the NaN
    assert want.tolist() == [-1, 0, 1, 2]
    assert got.tolist() == want.tolist()


def test_eqsel_selects_across_signed_zeros_as_pallas():
    """w = -0.0 against x[r] = +0.0 passes eqsel on both packages, and a
    NaN x[r] selects nothing on either."""
    src = np.array([0, 1, 2, 0, 1])
    dst = np.array([3, 3, 3, 4, 4])
    w = np.array([-0.0, 0.0, 0.5, 0.25, 0.75], np.float32)
    plan = build_spmv_plan(src, dst, w, 5)
    x = np.zeros(plan.pad_v, np.float32)
    x[3], x[4] = 0.0, 0.75
    want = _jax_ids(spmv_onehot(plan, jnp.asarray(x), interpret=True,
                                precision="split3", reduce="max",
                                combine="eqsel", gather="dst"), 5)
    csc = build_csr(dst, src, w, 5, "cpu")
    got = spmv_select(csc.offsets, csc.indices, csc.weights,
                      torch.from_numpy(x[:5]), "eqsel")
    assert want.tolist() == [-1, -1, -1, 1, 1]
    assert got.tolist() == want.tolist()
    x[3] = np.nan
    got = spmv_select(csc.offsets, csc.indices, csc.weights,
                      torch.from_numpy(x[:5]), "eqsel")
    assert got.tolist() == [-1, -1, -1, -1, 1]


def test_min_add_with_big_distances():
    """Unreached sources carry 1e30 and must never win the min
    (tests/test_kernels.py's case, on both packages)."""
    src = np.array([0, 1, 2, 2])
    dst = np.array([3, 3, 3, 4])
    w = np.array([1.0, 2.0, 5.0, 1.5], np.float32)
    plan = build_spmv_plan(src, dst, w, 5)
    x = np.full(plan.pad_v, SEMIRING_BIG, np.float32)
    x[0] = 4.0  # only vertex 0 reached
    want = np.asarray(spmv_onehot(plan, jnp.asarray(x), interpret=True,
                                  reduce="min", combine="add"))[:5]
    csc = build_csr(dst, src, w, 5, "cpu")
    y = spmv_semiring(csc.offsets, csc.indices, csc.weights,
                      torch.from_numpy(x[:5]), "min", "add").numpy()
    np.testing.assert_array_equal(y, want)
    assert y[3] == 5.0 and y[4] == np.float32(sr.BIG)
    assert y[0] == np.float32(sr.BIG)


def test_empty_rows_get_the_identity():
    csc = build_csr(np.array([2, 2]), np.array([0, 1]),
                    np.array([2.0, 3.0], np.float32), 4, "cpu")
    x = torch.tensor([1.0, 5.0, 0.0, 0.0])
    args = (csc.offsets, csc.indices, csc.weights)
    assert spmv_semiring(*args, x, "min", "add").tolist() == \
        [np.float32(1e30), np.float32(1e30), 3.0, np.float32(1e30)]
    assert spmv_semiring(*args, x, "max", "mul").tolist() == \
        [np.float32(-1e30), np.float32(-1e30), 15.0, np.float32(-1e30)]
    xi = torch.tensor([7, 2, 0, 0], dtype=torch.int32)
    assert spmv_semiring(csc.offsets, csc.indices, None, xi, "min").tolist() \
        == [2**31 - 1, 2**31 - 1, 2, 2**31 - 1]
    assert spmv_semiring(csc.offsets, csc.indices, None, xi, "max").tolist() \
        == [-2**31, -2**31, 7, -2**31]
    # edge values clip to ±1e30 before the reduction, as the TPU kernel's
    big = torch.tensor([3e38, 0.0, 0.0, 0.0])
    assert spmv_semiring(*args, big, "max", "left")[2] == np.float32(1e30)
    dist = torch.tensor([1.0, 1.0, 2.0, 0.0])
    assert spmv_select(csc.offsets, csc.indices, None, dist).tolist() == \
        [-1, -1, 1, -1]
    empty = build_csr(np.zeros(0, int), np.zeros(0, int), None, 0, "cpu")
    assert spmv_semiring(empty.offsets, empty.indices, None,
                         torch.zeros(0), "min").shape == (0,)
    assert spmv_select(empty.offsets, empty.indices, None,
                       torch.zeros(0)).shape == (0,)


def test_cpu_tensors_never_count_a_launch():
    csc = build_csr(np.array([0, 1, 2]), np.array([1, 2, 0]), None, 3, "cpu")
    before = (dict(sr.SEMIRING_LAUNCHES), dict(sr.SELECT_LAUNCHES))
    spmv_semiring(csc.offsets, csc.indices, csc.weights, torch.ones(3),
                  "min", "add")
    spmv_semiring(csc.offsets, csc.indices, None,
                  torch.ones(3, dtype=torch.int32), "max")
    spmv_select(csc.offsets, csc.indices, None, torch.ones(3))
    assert (sr.SEMIRING_LAUNCHES, sr.SELECT_LAUNCHES) == before


def test_wrappers_reject_bad_inputs():
    csc = build_csr(np.array([0, 1, 2]), np.array([1, 2, 0]), None, 3, "cpu")
    o, i, w, x = csc.offsets, csc.indices, csc.weights, torch.ones(3)
    with pytest.raises(ValueError, match="reduce"):
        spmv_semiring(o, i, w, x, "sum", "add")
    with pytest.raises(ValueError, match="combine"):
        spmv_semiring(o, i, w, x, "min", "eqsel")
    with pytest.raises(ValueError, match="needs weights"):
        spmv_semiring(o, i, None, x, "min", "add")
    with pytest.raises(TypeError, match="combine='left' only"):
        spmv_semiring(o, i, w, x.to(torch.int32), "min", "add")
    with pytest.raises(TypeError, match="float32"):
        spmv_semiring(o, i, None, x.double(), "min")
    with pytest.raises(TypeError, match="int32"):
        spmv_semiring(o.long(), i, None, x, "min")
    with pytest.raises(ValueError, match="entries for"):
        spmv_semiring(o, i, None, torch.ones(4), "max")
    with pytest.raises(ValueError, match="contiguous"):
        spmv_semiring(o, i, None, torch.ones(6)[::2], "max")
    with pytest.raises(ValueError, match="no spmv_semiring for device"):
        spmv_semiring(o.to("meta"), i.to("meta"), None, x.to("meta"), "min")
    with pytest.raises(ValueError, match="mode"):
        spmv_select(o, i, w, x, "eqsel_abs")
    with pytest.raises(ValueError, match="needs weights"):
        spmv_select(o, i, None, x, "eqsel")
    with pytest.raises(TypeError, match="float32"):
        spmv_select(o, i, w, x.to(torch.int32))
    with pytest.raises(ValueError, match="differ in length"):
        spmv_select(o, i, w[:2], x)
    with pytest.raises(ValueError, match="no spmv_select for device"):
        spmv_select(o.to("meta"), i.to("meta"), None, x.to("meta"))


@pytest.mark.cuda
def test_kernels_match_reference_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name, n, src, dst, w in CASES:
        csc = build_csr(dst, src, w, n, "cuda")
        x = torch.rand(n, device="cuda") * 10
        labels = torch.randperm(n, device="cuda").to(torch.int32)
        for reduce in REDUCES:
            for combine in COMBINES:
                wt = None if combine == "left" else csc.weights
                y1 = spmv_semiring(csc.offsets, csc.indices, wt, x, reduce,
                                   combine)
                y2 = spmv_semiring(csc.offsets, csc.indices, wt, x, reduce,
                                   combine)
                ref = spmv_semiring_reference(csc.offsets, csc.indices, wt,
                                              x, reduce, combine)
                assert torch.equal(y1, y2), name
                assert bit_mismatches(y1, ref) == 0, name
            got = spmv_semiring(csc.offsets, csc.indices, None, labels,
                                reduce)
            ref = spmv_semiring_reference(csc.offsets, csc.indices, None,
                                          labels, reduce)
            assert bit_mismatches(got, ref) == 0, name
        dist = torch.randint(0, 4, (n,), device="cuda").to(torch.float32)
        for wt in (None, csc.weights):
            got = spmv_select(csc.offsets, csc.indices, wt, dist,
                              "eqsel_rel", 0.25, 0.0)
            ref = spmv_select_reference(csc.offsets, csc.indices, wt, dist,
                                        "eqsel_rel", 0.25, 0.0)
            assert torch.equal(got, ref), name
        y1 = spmv_semiring(csc.offsets, csc.indices, csc.weights, x, "max",
                           "right")
        got = spmv_select(csc.offsets, csc.indices, csc.weights, y1, "eqsel")
        ref = spmv_select_reference(csc.offsets, csc.indices, csc.weights,
                                    y1, "eqsel")
        torch.cuda.synchronize()
        assert torch.equal(got, ref), name


@pytest.mark.cuda
def test_kernels_count_launches_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    csc = build_csr(np.array([0, 1]), np.array([1, 0]), None, 2, "cuda")
    before = sr.SEMIRING_LAUNCHES["min_add"]
    spmv_semiring(csc.offsets, csc.indices, csc.weights,
                  torch.ones(2, device="cuda"), "min", "add")
    assert sr.SEMIRING_LAUNCHES["min_add"] == before + 1
    before = sr.SELECT_LAUNCHES["eqsel_rel_unit"]
    spmv_select(csc.offsets, csc.indices, None, torch.ones(2, device="cuda"))
    assert sr.SELECT_LAUNCHES["eqsel_rel_unit"] == before + 1
    with pytest.raises(ValueError, match="is on"):
        spmv_select(csc.offsets, csc.indices, None, torch.ones(2))


# every K2 mode as (reduce, combine, int32 x)
MODES = [(r, c, False) for r in REDUCES for c in COMBINES] \
    + [(r, "left", True) for r in REDUCES]
MODE_IDS = [f"{r}_{c}" + ("_i32" if i else "") for r, c, i in MODES]
# heavy-row graphs: small spans, and the wrapper's
HEAVY_SPANS = (4, 32, sr.SPMV_SEMIRING_SPAN)


def _heavy_case(span):
    """(n, port structure, JAX structure) of the heavy-row graph at
    ``span``."""
    from cugraph_tpu.core.structure import build_structure_host

    n, src, dst, w = heavy_row_edges(span, seed=span)
    return n, build_structure(src, dst, w, n, "cpu"), \
        build_structure_host(src, dst, w, n)


def _mode_x(n, is_int, seed):
    """x for one mode: ids with some -1 (int32), or values in [0, 10) with
    some 1e30 (unreached)."""
    rng = np.random.default_rng(seed)
    if is_int:
        x = rng.permutation(n).astype(np.int32)
        x[::3] = -1
        return x
    x = (rng.random(n) * 10).astype(np.float32)
    x[::7] = SEMIRING_BIG
    return x


def _xla_semiring(jadj, n, x, w, reduce, combine):
    """cugraph_tpu's XLA route over one orientation: gather the minor
    end's x, combine, clip in float32, segment min/max by major
    (``prims/vertex_edge.segment_reduce_by_major``); rows with no edges
    get the port's identity (segment_min/max give ±inf or the int32
    bounds)."""
    from cugraph_tpu.prims import vertex_edge as jve

    # both packages sort each orientation stably by (major, minor), so the
    # first m of the JAX arrays are the port's edges in the port's order
    xp = np.zeros(int(jadj.offsets.shape[0]) - 1, x.dtype)
    xp[:n] = x
    wp = np.asarray(jadj.weights).copy()
    wp[:len(w)] = w
    xe = jnp.asarray(xp)[jadj.indices]
    vals = {"left": lambda: xe, "right": lambda: jnp.asarray(wp),
            "add": lambda: xe + jnp.asarray(wp),
            "mul": lambda: xe * jnp.asarray(wp)}[combine]()
    if x.dtype == np.float32:
        vals = jnp.clip(vals, -SEMIRING_BIG, SEMIRING_BIG)
    y = np.array(jve.segment_reduce_by_major(jadj, vals, reduce))[:n]
    empty = np.diff(np.asarray(jadj.offsets))[:n] == 0
    y[empty] = sr.semiring_identity(reduce, torch.int32 if x.dtype == np.int32
                                    else torch.float32)
    return torch.from_numpy(np.ascontiguousarray(y))


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("side", ["csc", "csr"])
@pytest.mark.parametrize("span", HEAVY_SPANS)
def test_heavy_rows_match_jax_xla_route(span, side, mode):
    """The heavy-row graphs through the plain K2 against the XLA route,
    bit for bit."""
    reduce, combine, is_int = mode
    n, tg, jg = _heavy_case(span)
    adj, jadj = (tg.csc, jg.csc) if side == "csc" else (tg.csr, jg.csr)
    x = _mode_x(n, is_int, span)
    w = adj.weights.numpy()
    got = spmv_semiring(adj.offsets, adj.indices,
                        None if combine == "left" else adj.weights,
                        torch.from_numpy(x), reduce, combine)
    want = _xla_semiring(jadj, n, x, w, reduce, combine)
    assert bit_mismatches(got, want) == 0


@pytest.mark.parametrize("mode", MODES[:8], ids=MODE_IDS[:8])
@pytest.mark.parametrize("case", ["heavy_rows", "n300_m2000"])
def test_nan_and_signed_zeros_match_jax_xla_route(case, mode):
    """A NaN weight (for "left", a NaN in x) on the heaviest row and on a
    light row makes those rows NaN in both packages, and a row of -0.0 and
    +0.0 gives -0.0 for min and +0.0 for max in both.  The Pallas route
    differs on the NaN weight: it refuses one, and its kernel reads one as
    a padding lane and skips the edge (``spmv_onehot.py:231-233,503``; see
    test_pallas_route_refuses_and_skips_a_nan_weight)."""
    reduce, combine, _ = mode
    if case == "heavy_rows":
        n, tg, jg = _heavy_case(8)
    else:
        from cugraph_tpu.core.structure import build_structure_host

        rng = np.random.default_rng(2300)
        n, src, dst = 300, rng.integers(0, 300, 2000), \
            rng.integers(0, 300, 2000)
        w = rng.uniform(0.5, 1.5, 2000).astype(np.float32)
        tg, jg = build_structure(src, dst, w, n, "cpu"), \
            build_structure_host(src, dst, w, n)
    adj, jadj = tg.csc, jg.csc
    x, w, (heavy, light, zero_row) = nan_and_signed_zeros(
        adj.offsets.numpy(), adj.indices.numpy(), _mode_x(n, False, n),
        adj.weights.numpy(), combine)
    got = spmv_semiring(adj.offsets, adj.indices,
                        None if combine == "left" else torch.from_numpy(w),
                        torch.from_numpy(x), reduce, combine)
    want = _xla_semiring(jadj, n, x, w, reduce, combine)
    assert bool(torch.isnan(got[heavy])) and bool(torch.isnan(got[light]))
    assert got[zero_row] == 0
    assert bool(torch.signbit(got[zero_row])) == (reduce == "min")
    assert bit_mismatches(got, want) == 0


def test_pallas_route_refuses_and_skips_a_nan_weight():
    """A recorded divergence among the reference's own routes: the Pallas
    route's ``build_spmv_plan`` refuses a NaN weight
    (``spmv_onehot.py:231-233``), because its kernel reads a NaN weight as
    a padding lane and skips the edge (``:503``), as a plan whose weight is
    set to NaN afterwards shows; its XLA route and the port give NaN.  A
    NaN in x gives NaN on every route."""
    import dataclasses

    src, dst = np.array([0, 1, 2, 0]), np.array([3, 3, 3, 4])
    w = np.array([1.0, np.nan, 5.0, 1.5], np.float32)
    with pytest.raises(ValueError, match="finite"):
        build_spmv_plan(src, dst, w, 5)
    plan = build_spmv_plan(src, dst, np.nan_to_num(w, nan=777.0), 5)
    plan = dataclasses.replace(plan, weight=jnp.where(
        plan.weight == 777.0, jnp.nan, plan.weight))
    x = np.zeros(plan.pad_v, np.float32)
    x[:3] = [4.0, 1.0, 2.0]
    pallas = np.asarray(spmv_onehot(plan, jnp.asarray(x), interpret=True,
                                    reduce="min", combine="add"))[:5]
    assert pallas[3] == 5.0  # min(4 + 1, 2 + 5): the NaN edge skipped
    csc = build_csr(dst, src, w, 5, "cpu")
    got = spmv_semiring(csc.offsets, csc.indices, csc.weights,
                        torch.from_numpy(x[:5]), "min", "add")
    assert bool(torch.isnan(got[3])) and got[4] == 5.5
    x[1] = np.nan
    pallas = np.asarray(spmv_onehot(plan, jnp.asarray(x), interpret=True,
                                    reduce="min", combine="left"))[:5]
    got = spmv_semiring(csc.offsets, csc.indices, None,
                        torch.from_numpy(x[:5]), "min", "left")
    assert np.isnan(pallas[3]) and bool(torch.isnan(got[3]))


def test_launch_passes_scratch_and_span(monkeypatch):
    """The wrapper's side of one K2 launch, with the C entry point recorded
    instead of called: scratch of span_slots(m, span) elements of x's
    dtype (int32 for the int32 arm) sized from the shapes alone, the
    span, no weight pointer for "left" and no x pointer for "right", and
    one counted launch."""
    calls, scratch = [], []

    def fake(*args):
        calls.append(args)
        return 0

    real_empty = torch.empty

    def empty(*args, **kwargs):
        out = real_empty(*args, **kwargs)
        scratch.append((tuple(out.shape), out.dtype))
        return out

    monkeypatch.setattr(sr, "_fn", lambda *a: fake)
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 5})())
    n, src, dst, w = heavy_row_edges(8)
    csc = build_csr(dst, src, w, n, "cpu")
    m = len(src)
    for reduce, combine, is_int in MODES:
        for span in (sr.SPMV_SEMIRING_SPAN, 8):
            x = torch.ones(n, dtype=torch.int32 if is_int else torch.float32)
            key = sr.semiring_mode(reduce, combine, x.dtype)
            before = sr.SEMIRING_LAUNCHES[key]
            kwargs = {} if span == sr.SPMV_SEMIRING_SPAN else {"span": span}
            y = sr._launch_semiring(csc.offsets, csc.indices, csc.weights, x,
                                    reduce, combine, **kwargs)
            assert y.shape == (n,) and y.dtype == x.dtype
            assert scratch[-1] == ((span_slots(m, span),), x.dtype)
            args = calls[-1]
            assert args[6:] == (n, m, sr.REDUCES[reduce],
                                sr.COMBINES[combine], int(is_int), span, 5)
            assert (args[2] is None) == (combine == "left")
            assert (args[3] is None) == (combine == "right")
            assert sr.SEMIRING_LAUNCHES[key] == before + 1
    monkeypatch.setattr(sr, "_fn", lambda *a: lambda *b: 2)
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        sr._launch_semiring(csc.offsets, csc.indices, None, torch.ones(n),
                            "min", "left")


def test_select_launch_passes_scratch_and_span(monkeypatch):
    """The wrapper's side of one K3 launch, with the C entry point recorded
    instead of called: int32 scratch of span_slots(m, span) elements sized
    from the shapes alone, the mode code, the tolerances and the span, no
    weight pointer at unit weight, and one counted launch."""
    calls, scratch = [], []

    def fake(*args):
        calls.append(args)
        return 0

    real_empty = torch.empty

    def empty(*args, **kwargs):
        out = real_empty(*args, **kwargs)
        scratch.append((tuple(out.shape), out.dtype))
        return out

    monkeypatch.setattr(sr, "_fn", lambda *a: fake)
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 5})())
    n, src, dst, w = heavy_row_edges(8)
    csc = build_csr(dst, src, w, n, "cpu")
    m = len(src)
    for key, mode, atol, rtol in SELECT_MODES:
        wt = None if key == "eqsel_rel_unit" else csc.weights
        for span in (sr.SPMV_SELECT_SPAN, 8):
            before = sr.SELECT_LAUNCHES[key]
            kwargs = {} if span == sr.SPMV_SELECT_SPAN else {"span": span}
            y = sr._launch_select(csc.offsets, csc.indices, wt,
                                  torch.ones(n), mode, atol, rtol, **kwargs)
            assert y.shape == (n,) and y.dtype == torch.int32
            assert scratch[-1] == ((span_slots(m, span),), torch.int32)
            args = calls[-1]
            assert args[6:9] == (n, m, sr._SELECT_CODES[key])
            assert args[9:] == pytest.approx((atol, rtol, span, 5))
            assert (args[2] is None) == (key == "eqsel_rel_unit")
            assert sr.SELECT_LAUNCHES[key] == before + 1
    monkeypatch.setattr(sr, "_fn", lambda *a: lambda *b: 2)
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        sr._launch_select(csc.offsets, csc.indices, None, torch.ones(n),
                          "eqsel_rel", 0.25, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("span", [sr.SPMV_SELECT_SPAN, 32])
def test_select_heavy_rows_and_nan_on_the_card(span):
    """Every K3 mode on the heavy-row graph at the wrapper's span and at a
    small one, over the CSC and the CSR, with plain inputs and with the NaN
    and signed-zero ones, against the plain version bit for bit; two
    launches bit-identical, one counted launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, src, dst, w = heavy_row_edges(span, seed=span)
    g = build_structure(src, dst, w, n, "cpu")
    for adj in (g.csc, g.csr):
        off, idx = adj.offsets.numpy(), adj.indices.numpy()
        o, i = adj.offsets.cuda(), adj.indices.cuda()
        for key, mode, atol, rtol in SELECT_MODES:
            x, wv = _select_x_w(adj, key, span)
            specials = select_nan_and_signed_zeros(off, idx, x, wv, key)
            for xv, wv, where in ((x, wv, None), specials):
                wt = None if key == "eqsel_rel_unit" \
                    else torch.from_numpy(wv).cuda()
                args = (o, i, wt, torch.from_numpy(xv).cuda(), mode, atol,
                        rtol)
                before = sr.SELECT_LAUNCHES[key]
                y1 = sr._launch_select(*args, span=span)
                y2 = sr._launch_select(*args, span=span)
                want = spmv_select_reference(*args)
                torch.cuda.synchronize()
                assert sr.SELECT_LAUNCHES[key] == before + 2
                assert torch.equal(y1, y2), (key, span)
                assert torch.equal(y1, want), (key, span)
                assert bool((y1 >= 0).any()), (key, span)
                if where is not None:
                    hold_select_specials(y1.cpu().numpy(), off, idx, xv, wv,
                                         key, where)


@pytest.mark.cuda
@pytest.mark.parametrize("span", [sr.SPMV_SEMIRING_SPAN, 32])
def test_heavy_rows_and_nan_on_the_card(span):
    """Every K2 mode on the heavy-row graph at the wrapper's span and at a
    small one, over the CSC and the CSR, with plain inputs and (fp32) with
    the NaN and signed-zero values, against the plain version (NaN
    matching NaN); two launches bit-identical, one counted launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, src, dst, w = heavy_row_edges(span, seed=span)
    g = build_structure(src, dst, w, n, "cuda")
    for adj in (g.csc, g.csr):
        for i, (reduce, combine, is_int) in enumerate(MODES):
            x = _mode_x(n, is_int, i)
            inputs = [(x, adj.weights.cpu().numpy())]
            if not is_int:
                inputs.append(nan_and_signed_zeros(
                    adj.offsets.cpu().numpy(), adj.indices.cpu().numpy(), x,
                    adj.weights.cpu().numpy(), combine)[:2])
            for special, (xv, wv) in enumerate(inputs):
                xt = torch.from_numpy(xv).cuda()
                wt = None if combine == "left" else torch.from_numpy(wv).cuda()
                key = sr.semiring_mode(reduce, combine, xt.dtype)
                before = sr.SEMIRING_LAUNCHES[key]
                args = (adj.offsets, adj.indices, wt, xt, reduce, combine)
                y1 = sr._launch_semiring(*args, span=span)
                y2 = sr._launch_semiring(*args, span=span)
                want = spmv_semiring_reference(*args)
                torch.cuda.synchronize()
                assert sr.SEMIRING_LAUNCHES[key] == before + 2
                assert torch.equal(y1.view(torch.int32), y2.view(torch.int32))
                assert bit_mismatches(y1, want) == 0, (key, span)
                assert bool(torch.isnan(want).any()) == bool(special)
