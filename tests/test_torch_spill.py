"""The host-spill streamed SpMV (``cugraph_tpu_torch.kernels.spill``) and
PageRank's spilled route, against ``cugraph_tpu.kernels.spill`` and the
port's resident route, on the CPU.

The JAX side runs its Pallas kernel in interpret mode, as
``tests/test_spill.py`` does, at its own tolerance (rtol = atol = 1e-5 for
the SpMV; rtol 1e-4, atol 1e-7 for PageRank).  Against the port's resident
route the spilled results are equal bit for bit: a chunk holds whole rows,
and its device arrays start at a multiple of the kernels' span behind a
ghost row, so every heavy row keeps its global span boundaries (checked
with the NumPy model of ``csrc/csr_spans.cuh``).  The card cases are marked
``cuda``.
"""

import numpy as np
import pytest
import torch

import cugraph_tpu as ctpu
from cugraph_tpu.kernels import spill as jspill
from test_torch_csr_spans import heavy_pieces

import cugraph_tpu_torch as ct
from cugraph_tpu_torch.core.structure import build_csr
from cugraph_tpu_torch.kernels import dispatch, semiring, spill, spmv
from cugraph_tpu_torch.testing.heavy_rows import heavy_row_edges

torch.set_num_threads(1)
MODES = [("sum", "mul"), ("min", "add"), ("max", "left")]


def _edges(n=400, m=3000, seed=0, hub_sources=0, empty_tail=0):
    """(src, dst, w) from a NumPy seed over n vertices: m random edges,
    then ``hub_sources`` distinct in-edges of vertex 5 (a row longer than
    a small chunk), with the last ``empty_tail`` vertices and every odd one
    below 60 left without in-edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n - empty_tail, m)
    dst = np.where((dst < 60) & (dst % 2 == 1), dst - 1, dst)
    src = np.concatenate([src, np.arange(hub_sources)])
    dst = np.concatenate([dst, np.full(hub_sources, 5)])
    w = rng.uniform(0.5, 1.5, len(src)).astype(np.float32)
    return src, dst, w


def _resident(offsets, indices, weights, x, reduce, combine):
    if reduce == "sum":
        return spmv.spmv_csr(offsets, indices, weights, x, combine)
    return semiring.spmv_semiring(offsets, indices, weights, x, reduce,
                                  combine)


def _x(n, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).random(n)
                            .astype(np.float32) + 0.5)


@pytest.mark.parametrize("reduce,combine", MODES)
def test_spilled_matches_jax_spilled(reduce, combine):
    n = 400
    src, dst, w = _edges(n, hub_sources=380)
    plan = spill.build_spilled_spmv_plan(src, dst, w, n, 12_000,
                                         device="cpu")
    assert plan.num_chunks > 2
    jplan = jspill.build_spilled_spmv_plan(src, dst, w, n, yb_rows=64,
                                           max_chunk_bytes=1 << 19)
    x = _x(n)
    xj = np.zeros(jplan.pad_v, np.float32)
    xj[:n] = x.numpy()
    want = np.asarray(jspill.spmv_spilled(jplan, xj, interpret=True,
                                          reduce=reduce,
                                          combine=combine))[:n]
    got = spill.spmv_spilled(plan, x, reduce, combine)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reduce,combine", MODES + [("sum", "left"),
                                                    ("max", "right"),
                                                    ("min", "mul")])
def test_spilled_equals_resident_bit_for_bit(reduce, combine):
    """A hub longer than the chunk budget (a chunk of its own, the
    capacity grown to fit it), rows and a whole range without edges, and
    chunks that start inside a span: the same bits as the resident CSC."""
    n = 1500
    src, dst, w = _edges(n, m=4000, hub_sources=n - 1, empty_tail=1100)
    budget = 12_000
    plan = spill.build_spilled_spmv_plan(src, dst, w, n, budget,
                                         device="cpu")
    sizes = [e1 - e0 for e0, e1 in plan.edge_ranges]
    hub = next(i for i, (r0, r1) in enumerate(plan.ranges) if r0 <= 5 < r1)
    assert plan.ranges[hub] == (5, 6) and plan.capacity == max(sizes)
    # the hub's chunk alone outgrows the budget, and sizes the buffers
    hub_bytes = spill._layout(1, sizes[hub])[2]
    assert plan.chunk_bytes() == hub_bytes > budget
    assert all(spill._layout(r1 - r0, e1 - e0)[2] <= budget
               for i, ((r0, r1), (e0, e1)) in enumerate(zip(
                   plan.ranges, plan.edge_ranges)) if i != hub)
    empty = [i for i, (r0, r1) in enumerate(plan.ranges)
             if plan.offsets[r0] == plan.offsets[r1]]
    assert empty, "no range without edges"
    assert any(plan.offsets[r0] % spill.SPILL_ALIGN for r0, _ in plan.ranges)
    csc = build_csr(dst, src, w, n, "cpu")
    for seed in range(3):
        x = _x(n, seed)
        got = spill.spmv_spilled(plan, x, reduce, combine)
        want = _resident(csc.offsets, csc.indices, csc.weights, x, reduce,
                         combine)
        assert got.dtype == want.dtype
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    ident = 0.0 if reduce == "sum" else semiring.semiring_identity(
        reduce, torch.float32)
    for i in empty:
        r0, r1 = plan.ranges[i]
        assert torch.all(got[r0:r1] == ident)


@pytest.mark.parametrize("span", [8, spmv.SPMV_SPAN])
def test_chunks_keep_global_span_boundaries(span, monkeypatch):
    """Every chunk starts at a multiple of SPILL_ALIGN (set to the span)
    behind a ghost row of exactly o % span edges (o its first row's first
    edge), shorter than a span; the NumPy model of the kernels' span
    search gives each of the chunk's heavy rows the same pieces, in the
    same global spans, as over the whole CSC."""
    assert spill.SPILL_ALIGN == spmv.SPMV_SPAN == semiring.SPMV_SEMIRING_SPAN
    monkeypatch.setattr(spill, "SPILL_ALIGN", span)
    n, src, dst, w = heavy_row_edges(span, seed=span)
    budget = 8 * 5 * span
    plan = spill.build_spilled_spmv_plan(src, dst, w, n, budget,
                                         device="cpu")
    off = plan.offsets.numpy()
    m = int(off[-1])

    def pieces(offsets, first_span, spans, row_base, edge_base):
        got = {}
        for s in range(spans):
            for p in heavy_pieces(offsets, span, s):
                if p is not None:
                    row, b, e = p
                    got.setdefault(row + row_base, []).append(
                        (s + first_span, b + edge_base, e + edge_base))
        return got

    whole = pieces(off, 0, -(-m // span), 0, 0)
    mid_span = 0
    for i, (r0, r1) in enumerate(plan.ranges):
        o_loc, idx, _ = plan.materialize_chunk(i)
        e0, e1 = plan.edge_ranges[i]
        ghost = int(off[r0]) % span
        assert plan.align == span and e0 % span == 0
        assert int(off[r0]) - e0 == ghost < span
        assert o_loc[0] == 0 and o_loc[1] == ghost
        assert np.array_equal(o_loc.numpy()[1:], off[r0:r1 + 1] - e0)
        assert idx.shape[0] == e1 - e0 <= plan.capacity
        mid_span += ghost > 0
        if e1 == e0:
            continue
        local = pieces(o_loc.numpy(), e0 // span, -(-(e1 - e0) // span),
                       r0 - 1, e0)
        for row in range(r0, r1):
            assert local.get(row) == whole.get(row), (i, row)
    assert mid_span, "no chunk starts inside a span"


def test_plan_invariants():
    n = 500
    src, dst, w = _edges(n, m=4000, hub_sources=499, empty_tail=120)
    plan = spill.build_spilled_spmv_plan(src, dst, w, n, 12_000,
                                         device="cpu")
    assert plan.ranges[0][0] == 0 and plan.ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(plan.ranges, plan.ranges[1:]))
    assert all(r1 > r0 for r0, r1 in plan.ranges)
    assert plan.pad_v == plan.num_vertices == n
    assert plan.offsets.dtype == torch.int64 and plan.offsets.shape == (
        n + 1,) and int(plan.offsets[-1]) == len(src) == plan.num_edges
    for t, dtype in ((plan.indices, torch.int32),
                     (plan.weights, torch.float32),
                     (plan.chunk_offsets, torch.int32)):
        assert t.device.type == "cpu" and t.dtype == dtype
        assert not t.is_pinned()  # a CPU plan is not pinned
    assert not plan.pinned
    for (r0, r1), (e0, e1), c in zip(plan.ranges, plan.edge_ranges,
                                     plan.chunks):
        assert e1 - e0 <= plan.capacity
        assert c[0].shape[0] == r1 - r0 + 2
    assert plan.chunk_bytes() == max(
        spill._layout(r1 - r0, e1 - e0)[2]
        for (r0, r1), (e0, e1) in zip(plan.ranges, plan.edge_ranges))
    # build_csr's order: (dst, src), stable for parallel edges
    csc = build_csr(dst, src, w, n, "cpu")
    assert torch.equal(plan.offsets.to(torch.int32), csc.offsets)
    assert torch.equal(plan.indices, csc.indices)
    assert torch.equal(plan.weights, csc.weights)


def test_plan_offsets_are_int64():
    """The whole-graph offsets are int64, so a plan may hold more than
    2^31 edges; the rows are cut from them without wrapping, and each
    chunk is held to the int32 bound on its own."""
    src, dst, _ = _edges(50, m=300)
    plan = spill.build_spilled_spmv_plan(src, dst, None, 50, 2_000,
                                         device="cpu")
    assert plan.offsets.dtype == torch.int64
    assert torch.all(plan.weights == 1.0)
    big = np.array([0, 1 << 30, 1 << 31, 3 << 30, 1 << 32, (1 << 32) + 1],
                   np.int64)
    assert spill._row_ranges(big, 9 << 30, spill.SPILL_ALIGN) == [
        (0, 1), (1, 2), (2, 3), (3, 5)]
    assert spill._row_ranges(big, 17 << 30, 8) == [(0, 2), (2, 5)]
    with pytest.raises(ValueError, match="int32 CSR offset bound"):
        spill.check_edge_count(1 << 31)


def test_spilled_errors():
    src, dst, w = _edges(50, m=300)
    plan = spill.build_spilled_spmv_plan(src, dst, w, 50, 2_000,
                                         device="cpu")
    with pytest.raises(ValueError, match="reduce"):
        spill.spmv_spilled(plan, _x(50), "prod")
    with pytest.raises(ValueError, match="shape"):
        spill.spmv_spilled(plan, _x(49))
    with pytest.raises(ValueError, match="combine"):
        spill.spmv_spilled(plan, _x(50), "sum", "add")
    with pytest.raises(ValueError, match="positive"):
        spill.build_spilled_spmv_plan(src, dst, w, 50, 0, device="cpu")
    for s_bad, d_bad in ((src, dst + 2), (src + 1, dst), (src - 1, dst),
                         (src, dst - 1)):
        with pytest.raises(ValueError, match="outside"):
            spill.build_spilled_spmv_plan(s_bad, d_bad, w, 50, 2_000,
                                          device="cpu")
    with pytest.raises(ValueError, match="differ in length"):
        spill.build_spilled_spmv_plan(src, dst[:-1], w, 50, 2_000,
                                      device="cpu")
    # a plan built for the CPU never streams pageable memory to a card
    with pytest.raises(ValueError, match="not pinned"):
        spill._stream_chunks(plan, _x(50), torch.empty(50), None, True)


def test_rectangular_operand_check():
    """The chunk path's rows-versus-columns form: x has one entry per
    column; the square form still ties x's length to the rows."""
    csc = build_csr(np.array([0, 1, 2]), np.array([1, 0, 1]), None, 3, "cpu")
    off, idx = csc.offsets[:3], csc.indices[:int(csc.offsets[2])]
    x = _x(3)
    with pytest.raises(ValueError, match="entries for"):
        spmv.spmv_csr(off, idx, None, x, "left")
    with pytest.raises(ValueError, match="entries for"):
        semiring.spmv_semiring(off, idx, None, x, "max", "left")
    y = spmv.spmv_csr(off, idx, None, x, "left", square=False)
    z = semiring.spmv_semiring(off, idx, None, x, "max", "left",
                               square=False)
    full = spmv.spmv_csr(csc.offsets, csc.indices, None, x, "left")
    assert torch.equal(y, full[:2]) and z.shape == (2,)


def _pulls(call):
    """(call's result, the pulls it made): on the CPU every resident pull
    and every chunk of a spilled one is one call of K1's plain version."""
    real = spmv.spmv_csr_reference
    calls = [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    spmv.spmv_csr_reference = counted
    try:
        return call(), calls[0]
    finally:
        spmv.spmv_csr_reference = real


@pytest.mark.parametrize("case", ["plain", "personalization",
                                  "precomputed_out_weight", "nstart"])
def test_pagerank_spilled_equals_resident(case, monkeypatch):
    """Bit for bit the resident route with the same iteration count, over
    several chunks; the resident structure is never built."""
    src, dst, w = _edges(400, m=3000, hub_sources=380, seed=5)
    Gr = ct.Graph(directed=True, device="cpu").from_edgelist(src, dst, w)
    Gs = ct.Graph(directed=True, device="cpu").from_edgelist(src, dst, w)
    kw = {"tol": 1e-7, "fail_on_nonconvergence": False}
    if case == "personalization":
        kw["personalization"] = {int(v): float(i + 1)
                                 for i, v in enumerate(src[:16])}
    elif case == "precomputed_out_weight":
        nv = Gr.number_of_vertices()
        out = np.bincount(Gr.edgelist_arrays()[0], minlength=nv)
        kw["precomputed_vertex_out_weight"] = {
            int(e): float(out[i]) + 0.5 for i, e in enumerate(
                Gr.number_map.to_external(np.arange(nv)))}
    elif case == "nstart":
        kw["nstart"] = {int(v): 1.0 for v in dst[:32]}
    (want, conv_r), iters = _pulls(lambda: ct.pagerank(Gr, **kw))
    monkeypatch.setenv("CUGRAPH_TPU_SPILL_BYTES", "4096")
    monkeypatch.setattr(dispatch, "MIN_CHUNK_BYTES", 12_000)
    (got, conv_s), pulls = _pulls(lambda: ct.pagerank(Gs, **kw))
    assert Gs._structure is None and Gr._structure is not None
    chunks = Gs._spmv_plan_pull_spilled.num_chunks
    assert chunks > 2 and iters > 5 and conv_s == conv_r
    assert pulls == iters * chunks  # the same iteration count
    assert np.array_equal(got["vertex"].to_numpy(),
                          want["vertex"].to_numpy())
    a = got["pagerank"].to_numpy()
    b = want["pagerank"].to_numpy()
    assert np.array_equal(a.view(np.int32), b.view(np.int32))


def test_pagerank_spilled_matches_jax_spilled(monkeypatch):
    """The JAX package's spilled route (interpret mode) within its own
    test's tolerance."""
    monkeypatch.setenv("CUGRAPH_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("CUGRAPH_TPU_PALLAS_MIN_EDGES", "1")
    monkeypatch.setenv("CUGRAPH_TPU_SPILL_BYTES", "4096")
    src, dst, w = _edges(400, m=3000, seed=5)
    Gj = ctpu.Graph(directed=True)
    Gj.from_edgelist(src, dst, w)
    want = ctpu.pagerank(Gj, tol=1e-6)
    assert Gj._spmv_plan_pull_spilled is not None, "JAX spill not taken"
    G = ct.Graph(directed=True, device="cpu").from_edgelist(src, dst, w)
    got = ct.pagerank(G, tol=1e-6)
    assert G._structure is None and G._spmv_plan_pull_spilled is not None
    a = got.sort_values("vertex")["pagerank"].to_numpy()
    b = want.sort_values("vertex")["pagerank"].to_numpy()
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7)


def test_spill_helpers(monkeypatch):
    monkeypatch.delenv("CUGRAPH_TPU_SPILL_BYTES", raising=False)
    assert dispatch.spill_budget_bytes("cpu") is None
    src, dst, w = _edges(100, m=600)
    G = ct.Graph(directed=True, device="cpu").from_edgelist(src, dst, w)
    assert not dispatch.plan_needs_spill(G)
    monkeypatch.setenv("CUGRAPH_TPU_SPILL_BYTES", "4096")
    assert dispatch.spill_budget_bytes("cpu") == 4096
    assert dispatch.plan_needs_spill(G)
    monkeypatch.setenv("CUGRAPH_TPU_SPILL_BYTES", str(1 << 30))
    assert not dispatch.plan_needs_spill(G)
    assert G._spmv_plan_pull_spilled is None
    plan = dispatch.get_pull_plan_spilled(G)
    assert dispatch.get_pull_plan_spilled(G) is plan
    assert G._spmv_plan_pull_spilled is plan and not plan.pinned
    assert plan.num_chunks == 1  # a quarter of 1 GiB holds the graph
    G.clear()
    assert G._spmv_plan_pull_spilled is None
    # the host out-weights: float64 sums rounded once, their inverse
    G = ct.Graph(directed=True, device="cpu").from_edgelist(src, dst, w)
    inv, dang = dispatch.out_weight_vectors(G)
    s, _, ww = G.edgelist_arrays()
    ow = np.bincount(s, weights=ww, minlength=100).astype(np.float32)
    assert inv.dtype == np.float32 and np.array_equal(dang, ow <= 0)
    assert np.array_equal(inv[ow > 0], np.float32(1) / ow[ow > 0])
    assert np.all(inv[ow <= 0] == 0)
    assert torch.equal(G.structure.out_weight_sums, torch.from_numpy(ow))


@pytest.mark.cuda
@pytest.mark.parametrize("reduce,combine", MODES)
def test_spilled_equals_resident_on_the_card(reduce, combine):
    """Heavy rows at the kernels' span, chunks that start inside a span:
    the streamed kernels give the resident kernels' bits, one counted
    launch per chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, src, dst, w = heavy_row_edges(spmv.SPMV_SPAN, seed=3)
    plan = spill.build_spilled_spmv_plan(src, dst, w, n, 40_000)
    assert plan.pinned and plan.num_chunks > 2
    csc = build_csr(dst, src, w, n, "cuda")
    x = _x(n).cuda()
    before = (spmv.LAUNCHES, dict(semiring.SEMIRING_LAUNCHES))
    got = spill.spmv_spilled(plan, x, reduce, combine)
    if reduce == "sum":
        assert spmv.LAUNCHES == before[0] + plan.num_chunks
    else:
        key = semiring.semiring_mode(reduce, combine, x.dtype)
        assert semiring.SEMIRING_LAUNCHES[key] == before[1][key] \
            + plan.num_chunks
    want = _resident(csc.offsets, csc.indices, csc.weights, x, reduce,
                     combine)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
