"""Kernels K4 and K5 of the PyTorch port: the sum SpMM and the min/max
semiring SpMM over one CSR, X and Y [n, F].

On the CPU each wrapper takes its plain version, which must match the TPU
kernel ``spmm_onehot`` run in interpret mode at "highest" precision (exact
one-hot selections).  K4 within rtol 1e-5: both sum in another order, the
plain version in float64, the TPU kernel in float32; the inputs are
positive, so no sum cancels.  K5 bit for bit: min and max are exact,
and each combine rounds once in both.  K4's VJP (``make_spmm_pair``: K4
over the CSC forward, over the CSR backward) must match the JAX package's
custom VJP over its pull and transposed plans within the same rtol.  On
the heavy-row graphs and with NaNs and signed zeros, the plain K5 must
equal the JAX package's XLA route (segment min/max of the clipped edge
values) bit for bit, NaN matching NaN.  The tests marked ``cuda`` hold
the hand-written kernels against the plain versions on the card (K4 and
its VJP, which sum in float64 too, within the same rtol) and skip without
one.
"""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cugraph_tpu.kernels.spmm_onehot import build_spmm_plan, spmm_onehot

from cugraph_tpu_torch.core.structure import build_csr, build_structure
from cugraph_tpu_torch.kernels import spmm
from cugraph_tpu_torch.kernels.spmm import (spmm_csr, spmm_csr_reference,
                                            spmm_semiring,
                                            spmm_semiring_reference)
from cugraph_tpu_torch.prims import vertex_edge as ve
from cugraph_tpu_torch.testing import bit_mismatches
from cugraph_tpu_torch.testing.heavy_rows import (heavy_row_edges,
                                                  nan_and_signed_zeros)

torch.set_num_threads(1)
RTOL = 1e-5
MODES = [(r, c) for r in ("min", "max") for c in ("add", "left", "mul")]


def _cases():
    """(name, n, F, src, dst, w): the shapes of the JAX kernel tests
    (tests/test_spmm.py:16-22), widths 1, 3 and 130, a graph whose low ids
    have no in-edges (empty rows), and self-loops with parallel edges."""
    out = []
    for n, m, f in [(300, 2000, 16), (300, 2000, 128), (5000, 20000, 8),
                    (7, 5, 4), (1, 0, 8), (200, 1200, 1), (200, 1200, 3),
                    (200, 1200, 130)]:
        rng = np.random.default_rng(n + m + f)
        out.append((f"n{n}_m{m}_f{f}", n, f, rng.integers(0, n, m),
                    rng.integers(0, n, m),
                    (rng.random(m) * 2 + 0.1).astype(np.float32)))
    rng = np.random.default_rng(5)
    out.append(("empty_rows", 60, 16, rng.integers(0, 60, 300),
                rng.integers(20, 60, 300),
                (rng.random(300) + 0.5).astype(np.float32)))
    out.append(("loops_multi", 3, 5, np.array([0, 0, 0, 2, 2, 1]),
                np.array([1, 1, 0, 2, 2, 1]),
                np.array([1, 2, 3, 4, 5, 6], np.float32)))
    return out


CASES = _cases()
IDS = [c[0] for c in CASES]
# an interpret-mode call costs seconds: every K5 mode on three cases (F
# 128, 3 and empty rows), (min, add), the mode on the OD path, on the rest
_FULL = {"n300_m2000_f128", "n200_m1200_f3", "empty_rows"}
SEMIRING_CASES = [(c, mode) for c in CASES for mode in MODES
                  if c[0] in _FULL or mode == ("min", "add")]


def _plan_csc_x(case, seed):
    """The TPU plan, the port's CSC (rows are destinations) and a positive
    X over the plan's padding."""
    _, n, f, src, dst, w = case
    plan = build_spmm_plan(src, dst, w, n)
    x = (np.random.default_rng(seed).random((plan.pad_v, f)) * 3
         + 0.1).astype(np.float32)
    return plan, build_csr(dst, src, w, n, "cpu"), x


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sum_matches_pallas_interpret(case):
    n, f = case[1], case[2]
    plan, csc, x = _plan_csc_x(case, n + f)
    want = np.asarray(spmm_onehot(plan, jnp.asarray(x), interpret=True,
                                  precision="highest"))[:n]
    got = spmm_csr(csc.offsets, csc.indices, csc.weights,
                   torch.from_numpy(x[:n]))
    assert got.dtype == torch.float32 and got.shape == (n, f)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("case", CASES[:2] + CASES[-2:], ids=IDS[:2]
                         + IDS[-2:])
def test_unit_sum_matches_pallas_interpret(case):
    """weights=None is the unweighted plan of the Brandes and BFS panels."""
    _, n, f, src, dst, _ = case
    plan = build_spmm_plan(src, dst, None, n)
    x = (np.random.default_rng(n).random((plan.pad_v, f)) + 0.5).astype(
        np.float32)
    want = np.asarray(spmm_onehot(plan, jnp.asarray(x), interpret=True,
                                  precision="highest"))[:n]
    csc = build_csr(dst, src, None, n, "cpu")
    got = spmm_csr(csc.offsets, csc.indices, None, torch.from_numpy(x[:n]))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("case,mode", SEMIRING_CASES,
                         ids=[f"{c[0]}-{r}_{m}"
                              for c, (r, m) in SEMIRING_CASES])
def test_semiring_matches_pallas_interpret(case, mode):
    reduce, combine = mode
    n, f = case[1], case[2]
    plan, csc, x = _plan_csc_x(case, 2 * n + f)
    x[::5] = 1e30  # unreached vertices; "add" and "mul" then clip
    want = np.asarray(spmm_onehot(plan, jnp.asarray(x), interpret=True,
                                  precision="highest", reduce=reduce,
                                  combine=combine))[:n]
    got = spmm_semiring(csc.offsets, csc.indices,
                        None if combine == "left" else csc.weights,
                        torch.from_numpy(x[:n]), reduce, combine)
    assert got.dtype == torch.float32 and got.shape == (n, f)
    np.testing.assert_array_equal(got.numpy(), want)


def test_empty_rows_get_the_identity():
    # in-edges 0->2 (w 2) and 1->2 (w 3): rows are destinations
    csc = build_csr(np.array([2, 2]), np.array([0, 1]),
                    np.array([2.0, 3.0], np.float32), 4, "cpu")
    x = torch.arange(8, dtype=torch.float32).view(4, 2) + 1
    y = spmm_csr(csc.offsets, csc.indices, csc.weights, x)
    assert y.tolist() == [[0, 0], [0, 0], [2 * 1 + 3 * 3, 2 * 2 + 3 * 4],
                          [0, 0]]
    assert spmm_csr(csc.offsets, csc.indices, None, x)[2].tolist() == [4, 6]
    y = spmm_semiring(csc.offsets, csc.indices, csc.weights, x, "min", "add")
    assert y[2].tolist() == [3.0, 4.0]
    big = float(np.float32(1e30))
    assert y[0].tolist() == [big, big] == y[3].tolist()
    y = spmm_semiring(csc.offsets, csc.indices, None, x, "max", "left")
    assert y[2].tolist() == [3.0, 4.0] and y[1].tolist() == [-big, -big]
    for f in (0, 3):
        empty = build_csr(np.zeros(0, int), np.zeros(0, int), None, 0, "cpu")
        assert spmm_csr(empty.offsets, empty.indices, None,
                        torch.zeros(0, f)).shape == (0, f)
        assert spmm_semiring(empty.offsets, empty.indices, None,
                             torch.zeros(0, f), "min", "left").shape == (0, f)
    assert spmm_csr(csc.offsets, csc.indices, None,
                    torch.zeros(4, 0)).shape == (4, 0)


def test_plain_versions_chunk_the_features(monkeypatch):
    """Feature chunks that bound the [m, F_chunk] temporary give the same
    result as one chunk."""
    rng = np.random.default_rng(3)
    n, m, f = 40, 300, 37
    csc = build_csr(rng.integers(0, n, m), rng.integers(0, n, m),
                    rng.random(m).astype(np.float32), n, "cpu")
    x = torch.from_numpy(rng.random((n, f)).astype(np.float32))
    args = (csc.offsets, csc.indices, csc.weights, x)
    whole = spmm_csr_reference(*args), spmm_semiring_reference(*args)
    monkeypatch.setattr(spmm, "_CHUNK_BYTES", 8 * m * 5)
    assert len(spmm._feature_chunks(f, m, 8)) == 8
    assert torch.equal(spmm_csr_reference(*args), whole[0])
    assert torch.equal(spmm_semiring_reference(*args), whole[1])


def test_cpu_tensors_never_count_a_launch():
    csc = build_csr(np.array([0, 1, 2]), np.array([1, 2, 0]), None, 3, "cpu")
    before = dict(spmm.SPMM_LAUNCHES), dict(spmm.SPMM_SEMIRING_LAUNCHES)
    x = torch.ones(3, 4)
    spmm_csr(csc.offsets, csc.indices, None, x)
    spmm_csr(csc.offsets, csc.indices, csc.weights, x)
    for r, c in MODES:
        spmm_semiring(csc.offsets, csc.indices, csc.weights, x, r, c)
    assert (spmm.SPMM_LAUNCHES, spmm.SPMM_SEMIRING_LAUNCHES) == before


def test_wrappers_reject_bad_inputs():
    csc = build_csr(np.array([0, 1, 2]), np.array([1, 2, 0]), None, 3, "cpu")
    o, i, w, x = csc.offsets, csc.indices, csc.weights, torch.ones(3, 2)
    for fn in (spmm_csr, lambda *a: spmm_semiring(*a, "min", "add")):
        with pytest.raises(TypeError, match="int32"):
            fn(o.long(), i, w, x)
        with pytest.raises(TypeError, match="float32"):
            fn(o, i, w, x.double())
        with pytest.raises(ValueError, match="entries for"):
            fn(o, i, w, torch.ones(4, 2))
        with pytest.raises(ValueError, match="differ in length"):
            fn(o, i, w[:2], x)
        with pytest.raises(ValueError, match="contiguous"):
            fn(o, i, w, torch.ones(3, 4)[:, ::2])
        with pytest.raises(ValueError, match="2-D"):
            fn(o, i, w, torch.ones(3))
        with pytest.raises(ValueError, match="no spmm"):
            fn(o.to("meta"), i.to("meta"), w.to("meta"), x.to("meta"))
    with pytest.raises(ValueError, match="reduce"):
        spmm_semiring(o, i, w, x, "sum", "add")
    with pytest.raises(ValueError, match="combine"):
        spmm_semiring(o, i, w, x, "min", "right")
    with pytest.raises(ValueError, match="needs weights"):
        spmm_semiring(o, i, None, x, "min", "mul")


def test_prims_run_the_spmm_over_either_orientation():
    rng = np.random.default_rng(4)
    n, m = 50, 300
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    w = rng.random(m).astype(np.float32)
    g = build_structure(src, dst, w, n, "cpu")
    x = rng.random((n, 6)).astype(np.float32)
    want = np.zeros((n, 6))
    np.add.at(want, dst, w[:, None].astype(np.float64) * x[src])
    got = ve.spmm_by_major(g.csc, torch.from_numpy(x), unit=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    want = np.zeros((n, 6))
    np.add.at(want, src, x[dst].astype(np.float64))
    got = ve.spmm_by_major(g.csr, torch.from_numpy(x), unit=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    want = np.full((n, 6), 1e30, np.float32)
    np.minimum.at(want, dst, x[src] + w[:, None])
    got = ve.spmm_semiring_by_major(g.csc, torch.from_numpy(x), "min", "add")
    np.testing.assert_array_equal(got.numpy(), want)


def _vjp_cases():
    """(name, n, F, src, dst, w), at most 60 vertices: a directed graph
    with self-loops and parallel edges (equal and unequal weights), and
    one whose vertices 0-19 have no in-edges and 40-59 no out-edges."""
    rng = np.random.default_rng(9)
    src, dst = rng.integers(0, 50, 240), rng.integers(0, 50, 240)
    src[:15] = dst[:15]
    src[15:45], dst[15:45] = src[45:75], dst[45:75]
    w = (rng.random(240) * 2 + 0.1).astype(np.float32)
    w[15:30] = w[45:60]
    out = [("loops_multi", 50, f, src, dst, w) for f in (1, 40)]
    rng = np.random.default_rng(10)
    out.append(("empty_rows", 60, 3, rng.integers(0, 40, 300),
                rng.integers(20, 60, 300),
                (rng.random(300) + 0.5).astype(np.float32)))
    # every heavy-row case at a span of 4 edges: 30 vertices, 71 edges
    out.append(("heavy_rows", *heavy_row_edges(4)[:1], 3,
                *heavy_row_edges(4)[1:]))
    return out


VJP_CASES = _vjp_cases()


@pytest.mark.parametrize("case", VJP_CASES,
                         ids=[f"{c[0]}_f{c[2]}" for c in VJP_CASES])
def test_vjp_matches_pallas_make_spmm_pair(case, monkeypatch):
    """The port's pair (K4 over the CSC, then over the CSR) against the
    JAX package's custom VJP over its pull and transposed plans, run as
    tests/test_spmm.py:61-92 runs it: Y and dX within rtol 1e-5 (positive
    inputs, so no sum cancels)."""
    import functools

    from cugraph_tpu.kernels import spmm_onehot as mod

    _, n, f, src, dst, w = case
    monkeypatch.setattr(mod, "spmm_onehot", functools.partial(
        mod.spmm_onehot, interpret=True, precision="highest"))
    plan_fwd = build_spmm_plan(src, dst, w, n)
    pair = mod.make_spmm_pair(plan_fwd, build_spmm_plan(dst, src, w, n))
    rng = np.random.default_rng(n + f)
    x = (rng.random((plan_fwd.pad_v, f)) + 0.1).astype(np.float32)
    gy = (rng.random((plan_fwd.pad_v, f)) + 0.1).astype(np.float32)
    y_j, vjp = jax.vjp(pair, jnp.asarray(x))
    (gx_j,) = vjp(jnp.asarray(gy))

    g = build_structure(src, dst, w, n, "cpu")
    xt = torch.from_numpy(x[:n]).requires_grad_(True)
    y = spmm.get_structure_spmm_fn(g)(xt)
    (gx,) = torch.autograd.grad(y, xt, torch.from_numpy(gy[:n]))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j)[:n],
                               rtol=RTOL, atol=0)
    np.testing.assert_allclose(gx.numpy(), np.asarray(gx_j)[:n], rtol=RTOL,
                               atol=0)


def test_vjp_is_k4_over_the_csr(monkeypatch):
    """The backward runs K4 over the CSR on a contiguous gradient (autograd
    hands ``sum()``'s expanded one over), and is not run when X needs no
    gradient."""
    _, n, f, src, dst, w = VJP_CASES[1]
    g = build_structure(src, dst, w, n, "cpu")
    calls = []
    real = spmm._spmm_csr

    def record(offsets, indices, weights, x, count_key):
        side = "csc" if offsets is g.csc.offsets else "csr"
        calls.append((count_key, side, x.is_contiguous()))
        return real(offsets, indices, weights, x, count_key)

    monkeypatch.setattr(spmm, "_spmm_csr", record)
    pair = spmm.make_spmm_pair(g.csc, g.csr)
    x = torch.rand(n, f, requires_grad=True)
    (gx,) = torch.autograd.grad(pair(x).sum(), x)
    want = np.zeros((n, f))
    np.add.at(want, src, w[:, None].astype(np.float64))
    np.testing.assert_allclose(gx.numpy(), want, rtol=RTOL)
    assert calls == [("weighted", "csc", True), ("weighted_vjp", "csr", True)]
    calls.clear()
    assert not pair(torch.rand(n, f)).requires_grad
    assert calls == [("weighted", "csc", True)]


# heavy-row graphs at small spans: every case of the card's spans, scaled
HEAVY_SPANS = (4, 8, 32)
HEAVY_WIDTHS = (1, 3, 40, 128, 130, 256)


@pytest.mark.parametrize("weighted", [True, False],
                         ids=["weighted", "unit"])
@pytest.mark.parametrize("side", ["csc", "csr"])
@pytest.mark.parametrize("span", HEAVY_SPANS)
def test_heavy_rows_match_jax_xla_route(span, side, weighted):
    """The heavy-row graphs through the port's CPU path against the JAX
    package's XLA route (segment sums of gathered rows over its CSC or
    CSR), at F = 40, GCN's second layer."""
    from cugraph_tpu.core.structure import build_structure_host
    from cugraph_tpu.prims import vertex_edge as jve

    n, src, dst, w = heavy_row_edges(span, seed=span)
    jg = build_structure_host(src, dst, w, n)
    tg = build_structure(src, dst, w, n, "cpu")
    x = np.zeros((jg.pad_v, 40), np.float32)
    x[:n] = np.random.default_rng(span).random((n, 40)) + 0.1
    adj = tg.csc if side == "csc" else tg.csr
    got = spmm_csr(adj.offsets, adj.indices,
                   adj.weights if weighted else None,
                   torch.from_numpy(x[:n]))

    def e_op(s, d, wt):
        v = s if side == "csc" else d
        return wt[:, None] * v if weighted else v

    if side == "csc":
        want = jve.per_v_transform_reduce_incoming_e(jg, e_op, src_values=x)
    else:
        want = jve.per_v_transform_reduce_outgoing_e(jg, e_op, dst_values=x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:n], rtol=RTOL,
                               atol=0)


@pytest.mark.parametrize("m,f,span,want", [
    (0, 256, 512, 0), (1, 1, 512, 2), (512, 3, 512, 6), (513, 40, 512, 160),
    (16_085_385, 256, 512, 2 * 31_417 * 256)])
def test_scratch_is_two_slots_per_span_and_feature(m, f, span, want):
    assert spmm.spmm_scratch_numel(m, f, span) == want


def test_launch_passes_scratch_and_span(monkeypatch):
    """The wrapper's side of one K4 call, with the C entry point recorded
    instead of called: float64 scratch of spmm_scratch_numel(m, F) sized
    from the shapes alone, the span and the unit flag."""
    calls = []

    def fake(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(spmm, "_fn", lambda *a: fake)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 9})())
    n, src, dst, w = heavy_row_edges(8)
    csc = build_csr(dst, src, w, n, "cpu")
    m = len(src)
    for weights, f, span in ((None, 40, spmm.SPMM_SPAN),
                             (csc.weights, 3, 8)):
        y = spmm._launch_sum(csc.offsets, csc.indices, weights,
                             torch.ones(n, f), span)
        assert y.shape == (n, f)
        args = calls[-1]
        assert args[6:] == (n, m, f, int(weights is None), span, 9)
    monkeypatch.setattr(spmm, "_fn", lambda *a: lambda *b: 2)
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        spmm._launch_sum(csc.offsets, csc.indices, None, torch.ones(n, 4),
                         spmm.SPMM_SPAN)


@pytest.mark.cuda
@pytest.mark.parametrize("f", HEAVY_WIDTHS)
def test_heavy_rows_match_plain_version_on_the_card(f):
    """K4 (unit and weighted; the float4 path, and the scalar path at F =
    1, 3 and 130) and its VJP on the heavy-row graphs at the wrapper's span
    and at a small one, over the CSC and the CSR, against the plain
    version; two launches bit-identical, one counted launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for span in (spmm.SPMM_SPAN, 32):
        n, src, dst, w = heavy_row_edges(span, seed=span)
        g = build_structure(src, dst, w, n, "cuda")
        for adj in (g.csc, g.csr):
            x = torch.rand(n, f, device="cuda") * 10
            for weights in (adj.weights, None):
                key = "unit" if weights is None else "weighted"
                want = spmm_csr_reference(adj.offsets, adj.indices, weights,
                                          x)
                before = spmm.SPMM_LAUNCHES[key]
                args = (adj.offsets, adj.indices, weights, x, key)
                y1 = spmm._spmm_csr(*args, span=span)
                y2 = spmm._spmm_csr(*args, span=span)
                torch.cuda.synchronize()
                assert spmm.SPMM_LAUNCHES[key] == before + 2
                assert torch.equal(y1.view(torch.int32), y2.view(torch.int32))
                torch.testing.assert_close(y1, want, rtol=RTOL, atol=0)
        xg = torch.rand(n, f, device="cuda", requires_grad=True)
        gy = torch.rand(n, f, device="cuda")
        pair = spmm.get_structure_spmm_fn(g)
        (gx1,) = torch.autograd.grad(pair(xg), xg, gy)
        (gx2,) = torch.autograd.grad(pair(xg), xg, gy)
        torch.cuda.synchronize()
        assert torch.equal(gx1.view(torch.int32), gx2.view(torch.int32))
        torch.testing.assert_close(
            gx1, spmm_csr_reference(g.csr.offsets, g.csr.indices,
                                    g.csr.weights, gy), rtol=RTOL, atol=0)


@pytest.mark.cuda
def test_vjp_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name, n, f, src, dst, w in VJP_CASES + CASES:
        g = build_structure(src, dst, w, n, "cuda")
        pair = spmm.get_structure_spmm_fn(g)
        x = torch.rand(n, f, device="cuda", requires_grad=True)
        gy = torch.rand(n, f, device="cuda") * 10
        before = spmm.SPMM_LAUNCHES["weighted_vjp"]
        (gx1,) = torch.autograd.grad(pair(x), x, gy)
        (gx2,) = torch.autograd.grad((pair(x) * gy).sum(), x)
        torch.cuda.synchronize()
        assert spmm.SPMM_LAUNCHES["weighted_vjp"] == \
            before + (2 if n and f else 0)
        assert torch.equal(gx1.view(torch.int32), gx2.view(torch.int32)), name
        want = spmm_csr_reference(g.csr.offsets, g.csr.indices,
                                  g.csr.weights, gy)
        torch.testing.assert_close(gx1, want, rtol=RTOL, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 3, 128, 130])
def test_kernels_match_plain_versions_on_the_card(f):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name, n, _, src, dst, w in CASES:
        csc = build_csr(dst, src, w, n, "cuda")
        x = torch.rand(n, f, device="cuda") * 10
        x[::7] = 1e30
        for weights in (csc.weights, None):
            before = dict(spmm.SPMM_LAUNCHES)
            y1 = spmm_csr(csc.offsets, csc.indices, weights, x)
            y2 = spmm_csr(csc.offsets, csc.indices, weights, x)
            torch.cuda.synchronize()
            key = "unit" if weights is None else "weighted"
            assert spmm.SPMM_LAUNCHES[key] == before[key] + (2 if n else 0)
            assert torch.equal(y1, y2), name
            want = spmm_csr_reference(csc.offsets, csc.indices, weights, x)
            torch.testing.assert_close(y1, want, rtol=RTOL, atol=0)
        for r, c in MODES:
            args = (csc.offsets, csc.indices, csc.weights, x, r, c)
            y1, y2 = spmm_semiring(*args), spmm_semiring(*args)
            want = spmm_semiring_reference(
                csc.offsets, csc.indices, None if c == "left" else csc.weights,
                x, r, c)
            torch.cuda.synchronize()
            assert torch.equal(y1.view(torch.int32), y2.view(torch.int32))
            assert bit_mismatches(y1, want) == 0, (name, r, c)


@pytest.mark.cuda
def test_kernels_reject_mixed_devices():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    csc = build_csr(np.array([0, 1]), np.array([1, 0]), None, 2, "cuda")
    with pytest.raises(ValueError, match="is on"):
        spmm_csr(csc.offsets, csc.indices, None, torch.ones(2, 4))


def _xla_semiring(jadj, n, x, w, reduce, combine):
    """cugraph_tpu's XLA route for K5 over one orientation: gather the
    minor end's rows of X, combine, clip, segment min/max by major
    (``prims/vertex_edge.segment_reduce_by_major``); rows with no edges
    get the port's identity (segment_min/max give ±inf).  Both packages
    sort each orientation stably by (major, minor), so the first m edges
    of the JAX arrays are the port's, in the port's order."""
    from cugraph_tpu.prims import vertex_edge as jve

    xp = np.zeros((int(jadj.offsets.shape[0]) - 1, x.shape[1]), np.float32)
    xp[:n] = x
    wp = np.asarray(jadj.weights).copy()
    wp[:len(w)] = w
    xe = jnp.asarray(xp)[jadj.indices]
    vals = {"left": lambda: xe, "add": lambda: xe + jnp.asarray(wp)[:, None],
            "mul": lambda: xe * jnp.asarray(wp)[:, None]}[combine]()
    vals = jnp.clip(vals, -1e30, 1e30)
    y = np.array(jve.segment_reduce_by_major(jadj, vals, reduce))[:n]
    y[np.diff(np.asarray(jadj.offsets))[:n] == 0] = \
        1e30 if reduce == "min" else -1e30
    return torch.from_numpy(np.ascontiguousarray(y))


def _semiring_x(n, f, seed):
    """X in [0, 10) with some rows at 1e30 (unreached vertices)."""
    x = (np.random.default_rng(seed).random((n, f)) * 10).astype(np.float32)
    x[::7] = 1e30
    return x


# heavy-row graphs for K5: small spans, and the wrapper's
SEMIRING_HEAVY_SPANS = (4, 32, spmm.SPMM_SEMIRING_SPAN)


@pytest.mark.parametrize("mode", MODES, ids=[f"{r}_{c}" for r, c in MODES])
@pytest.mark.parametrize("side", ["csc", "csr"])
@pytest.mark.parametrize("span", SEMIRING_HEAVY_SPANS)
def test_semiring_heavy_rows_match_jax_xla_route(span, side, mode):
    """The heavy-row graphs through the plain K5 against the XLA route at
    F = 3, bit for bit."""
    from cugraph_tpu.core.structure import build_structure_host

    reduce, combine = mode
    n, src, dst, w = heavy_row_edges(span, seed=span)
    tg, jg = build_structure(src, dst, w, n, "cpu"), \
        build_structure_host(src, dst, w, n)
    adj, jadj = (tg.csc, jg.csc) if side == "csc" else (tg.csr, jg.csr)
    x = _semiring_x(n, 3, span)
    got = spmm_semiring(adj.offsets, adj.indices,
                        None if combine == "left" else adj.weights,
                        torch.from_numpy(x), reduce, combine)
    want = _xla_semiring(jadj, n, x, adj.weights.numpy(), reduce, combine)
    assert bit_mismatches(got, want) == 0


@pytest.mark.parametrize("mode", MODES, ids=[f"{r}_{c}" for r, c in MODES])
@pytest.mark.parametrize("case", ["heavy_rows", "n300_m2000"])
def test_semiring_nan_and_signed_zeros_match_jax_xla_route(case, mode):
    """A NaN weight (for "left", a NaN in one feature of X) on the heaviest
    row and on a light row gives NaN in both packages, and a row of -0.0
    and +0.0 gives -0.0 for min and +0.0 for max in both, at F = 5.  The
    Pallas route differs on the NaN weight: it refuses one, and its kernel
    reads one as a padding lane and skips the edge
    (``spmm_onehot.py:125,368,379``; see
    test_semiring_pallas_route_refuses_and_skips_a_nan_weight)."""
    from cugraph_tpu.core.structure import build_structure_host

    reduce, combine = mode
    if case == "heavy_rows":
        n, src, dst, w = heavy_row_edges(8, seed=8)
    else:
        rng = np.random.default_rng(2300)
        n, src, dst = 300, rng.integers(0, 300, 2000), \
            rng.integers(0, 300, 2000)
        w = rng.uniform(0.5, 1.5, 2000).astype(np.float32)
    tg, jg = build_structure(src, dst, w, n, "cpu"), \
        build_structure_host(src, dst, w, n)
    adj, jadj = tg.csc, jg.csc
    x, w, (heavy, light, zero_row) = nan_and_signed_zeros(
        adj.offsets.numpy(), adj.indices.numpy(), _semiring_x(n, 5, n),
        adj.weights.numpy(), combine)
    got = spmm_semiring(adj.offsets, adj.indices,
                        None if combine == "left" else torch.from_numpy(w),
                        torch.from_numpy(x), reduce, combine)
    want = _xla_semiring(jadj, n, x, w, reduce, combine)
    assert bool(torch.isnan(got[heavy]).any())
    assert bool(torch.isnan(got[light]).any())
    assert bool((got[zero_row] == 0).all())
    assert bool((torch.signbit(got[zero_row]) == (reduce == "min")).all())
    assert bit_mismatches(got, want) == 0


def test_semiring_pallas_route_refuses_and_skips_a_nan_weight():
    """A recorded divergence among the reference's own routes: the Pallas
    SpMM's ``build_spmm_plan`` refuses a NaN weight
    (``spmm_onehot.py:125``), because its min/max kernel reads a NaN
    weight as a padding lane and skips the edge (``:368,379``), as a plan
    whose weight is set to NaN afterwards shows; its XLA route and the
    port give NaN."""
    import dataclasses

    src, dst = np.array([0, 1, 2, 0]), np.array([3, 3, 3, 4])
    w = np.array([1.0, np.nan, 5.0, 1.5], np.float32)
    with pytest.raises(ValueError, match="finite"):
        build_spmm_plan(src, dst, w, 5)
    plan = build_spmm_plan(src, dst, np.nan_to_num(w, nan=777.0), 5)
    plan = dataclasses.replace(plan, weight=jnp.where(
        plan.weight == 777.0, jnp.nan, plan.weight))
    x = np.zeros((plan.pad_v, 2), np.float32)
    x[:3] = [[4.0, 4.0], [1.0, 1.0], [2.0, 3.0]]
    pallas = np.asarray(spmm_onehot(plan, jnp.asarray(x), interpret=True,
                                    precision="highest", reduce="min",
                                    combine="add"))[:5]
    assert pallas[3].tolist() == [5.0, 5.0]  # the NaN edge skipped
    csc = build_csr(dst, src, w, 5, "cpu")
    got = spmm_semiring(csc.offsets, csc.indices, csc.weights,
                        torch.from_numpy(x[:5]), "min", "add")
    assert bool(torch.isnan(got[3]).all()) and got[4].tolist() == [5.5, 5.5]


def test_semiring_launch_passes_scratch_and_span(monkeypatch):
    """The wrapper's side of one K5 launch, with the C entry point recorded
    instead of called: float32 scratch of F slots per span,
    spmm_scratch_numel(m, F, span), sized from the shapes alone; the span;
    no weight pointer for "left"; one counted launch."""
    calls, scratch = [], []

    def fake(*args):
        calls.append(args)
        return 0

    real_empty = torch.empty

    def empty(*args, **kwargs):
        out = real_empty(*args, **kwargs)
        scratch.append((tuple(out.shape), out.dtype))
        return out

    monkeypatch.setattr(spmm, "_fn", lambda *a: fake)
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 3})())
    n, src, dst, w = heavy_row_edges(8)
    csc = build_csr(dst, src, w, n, "cpu")
    m = len(src)
    for reduce, combine in MODES:
        for f, span in ((40, spmm.SPMM_SEMIRING_SPAN), (3, 8)):
            key = f"{reduce}_{combine}"
            before = spmm.SPMM_SEMIRING_LAUNCHES[key]
            weights = None if combine == "left" else csc.weights
            kwargs = {} if span == spmm.SPMM_SEMIRING_SPAN else {"span": span}
            y = spmm._launch_semiring(csc.offsets, csc.indices, weights,
                                      torch.ones(n, f), reduce, combine,
                                      **kwargs)
            assert y.shape == (n, f)
            assert scratch[-1] == ((2 * -(-m // span) * f,), torch.float32)
            args = calls[-1]
            assert args[6:] == (n, m, f, spmm.REDUCES[reduce],
                                spmm.SPMM_COMBINES[combine], span, 3)
            assert (args[2] is None) == (combine == "left")
            assert spmm.SPMM_SEMIRING_LAUNCHES[key] == before + 1
    monkeypatch.setattr(spmm, "_fn", lambda *a: lambda *b: 2)
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        spmm._launch_semiring(csc.offsets, csc.indices, None,
                              torch.ones(n, 4), "min", "left")


@pytest.mark.cuda
@pytest.mark.parametrize("f", HEAVY_WIDTHS)
def test_semiring_heavy_rows_and_nan_on_the_card(f):
    """Every K5 mode on the heavy-row graph at the wrapper's span and at a
    small one, over the CSC and the CSR, with plain inputs and with the
    NaN and signed-zero values, against the plain version (NaN matching
    NaN); two launches bit-identical, one counted launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for span in (spmm.SPMM_SEMIRING_SPAN, 32):
        n, src, dst, w = heavy_row_edges(span, seed=span)
        g = build_structure(src, dst, w, n, "cuda")
        for adj in (g.csc, g.csr):
            wn = adj.weights.cpu().numpy()
            for reduce, combine in MODES:
                x = _semiring_x(n, f, f)
                special = nan_and_signed_zeros(
                    adj.offsets.cpu().numpy(), adj.indices.cpu().numpy(), x,
                    wn, combine)[:2]
                for xv, wv in ((x, wn), special):
                    key = f"{reduce}_{combine}"
                    before = spmm.SPMM_SEMIRING_LAUNCHES[key]
                    args = (adj.offsets, adj.indices,
                            None if combine == "left"
                            else torch.from_numpy(wv).cuda(),
                            torch.from_numpy(xv).cuda(), reduce, combine)
                    y1 = spmm._launch_semiring(*args, span=span)
                    y2 = spmm._launch_semiring(*args, span=span)
                    want = spmm_semiring_reference(*args)
                    torch.cuda.synchronize()
                    assert spmm.SPMM_SEMIRING_LAUNCHES[key] == before + 2
                    assert torch.equal(y1.view(torch.int32),
                                       y2.view(torch.int32))
                    assert bit_mismatches(y1, want) == 0, (key, span, f)
                    assert bool(torch.isnan(want).any()) == (xv is not x)
