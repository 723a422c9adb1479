"""Kernels K2 and K3 of the PyTorch port: the min/max semiring SpMV and the
argmax select over one CSR.

On the CPU each wrapper takes its plain version, which must equal the TPU
kernel ``spmv_onehot`` run in interpret mode bit for bit: min, max and the
argmax are exact, and the TPU kernel's "highest" (or, for the id selects,
"split3") precision makes its one-hot selections exact too.  The tests
marked ``cuda`` hold the hand-written kernels against the plain versions
on the card and skip without one.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cugraph_tpu.kernels.spmv_onehot import (SEMIRING_BIG, build_spmv_plan,
                                             spmv_onehot)

from cugraph_tpu_torch.core.structure import build_csr
from cugraph_tpu_torch.kernels import semiring as sr
from cugraph_tpu_torch.kernels.semiring import (spmv_select,
                                                spmv_select_reference,
                                                spmv_semiring,
                                                spmv_semiring_reference)

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
                assert torch.equal(y1, y2) and torch.equal(y1, ref), name
            got = spmv_semiring(csc.offsets, csc.indices, None, labels,
                                reduce)
            ref = spmv_semiring_reference(csc.offsets, csc.indices, None,
                                          labels, reduce)
            assert torch.equal(got, ref), name
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
