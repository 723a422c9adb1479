"""Kernel K1 of the PyTorch port: the sum SpMV over one CSR.

On the CPU the wrapper takes its plain version, which must match the TPU
kernel ``spmv_onehot`` run in interpret mode at "highest" precision (an
exact one-hot selection).  Tolerance rtol 1e-5, atol 1e-6: both sum in a
different order, the plain version in float64, the TPU kernel in float32.
The tests marked ``cuda`` hold the hand-written kernel against the plain
version on the card and skip without one.
"""

import contextlib
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cugraph_tpu.kernels.spmv_onehot import build_spmv_plan, spmv_onehot

from cugraph_tpu_torch.core.structure import build_csr, build_structure
from cugraph_tpu_torch.kernels import _build, spmv
from cugraph_tpu_torch.kernels.spmv import spmv_csr, spmv_csr_reference
from cugraph_tpu_torch.prims import vertex_edge as ve
from cugraph_tpu_torch.testing.heavy_rows import (heavy_row_degrees,
                                                  heavy_row_edges)

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6


def _cases():
    """(name, n, src, dst, w): the cases of the JAX kernel tests, plus
    self-loops and parallel edges."""
    out = []
    for n, m, yb_rows in [(300, 2000, 8192), (40_000, 120_000, 128),
                          (7, 5, 8192), (1, 0, 8192)]:
        rng = np.random.default_rng(n + m)
        out.append((f"n{n}_m{m}", n, yb_rows, rng.integers(0, n, m),
                    rng.integers(0, n, m), rng.random(m).astype(np.float32)))
    out.append(("loops_multi", 3, 8192, np.array([0, 0, 0, 2, 2, 1]),
                np.array([1, 1, 0, 2, 2, 1]),
                np.array([1, 2, 3, 4, 5, 6], np.float32)))
    return out


CASES = _cases()


@pytest.mark.parametrize("combine", ["mul", "left"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_matches_pallas_interpret(case, combine):
    name, n, yb_rows, src, dst, w = case
    plan = build_spmv_plan(src, dst, w, n, yb_rows=yb_rows)
    rng = np.random.default_rng(7)
    x = rng.random(plan.pad_v).astype(np.float32)
    want = np.asarray(spmv_onehot(plan, jnp.asarray(x), interpret=True,
                                  precision="highest", combine=combine))[:n]
    csc = build_csr(dst, src, w, n, "cpu")
    got = spmv_csr(csc.offsets, csc.indices,
                   csc.weights if combine == "mul" else None,
                   torch.from_numpy(x[:n]), combine)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_zero_degree_rows_and_empty_graphs():
    # in-edges 0->2 (w 2) and 1->2 (w 3): rows are destinations
    csc = build_csr(np.array([2, 2]), np.array([0, 1]),
                    np.array([2.0, 3.0], np.float32), 5, "cpu")
    x = torch.arange(5, dtype=torch.float32) + 1
    y = spmv_csr(csc.offsets, csc.indices, csc.weights, x)
    assert y.tolist() == [0.0, 0.0, 2.0 * 1 + 3.0 * 2, 0.0, 0.0]
    assert spmv_csr(csc.offsets, csc.indices, None, x, "left").tolist() \
        == [0.0, 0.0, 3.0, 0.0, 0.0]
    empty = build_csr(np.zeros(0, int), np.zeros(0, int), None, 0, "cpu")
    y0 = spmv_csr(empty.offsets, empty.indices, empty.weights,
                  torch.zeros(0))
    assert y0.shape == (0,)


def test_cpu_tensors_never_count_a_launch():
    csc = build_csr(np.array([0, 1, 2]), np.array([1, 2, 0]), None, 3, "cpu")
    before = spmv.LAUNCHES
    spmv_csr(csc.offsets, csc.indices, csc.weights, torch.ones(3))
    assert spmv.LAUNCHES == before


def test_wrapper_rejects_bad_inputs():
    csc = build_csr(np.array([0, 1, 2]), np.array([1, 2, 0]), None, 3, "cpu")
    o, i, w, x = csc.offsets, csc.indices, csc.weights, torch.ones(3)
    with pytest.raises(ValueError, match="combine"):
        spmv_csr(o, i, w, x, "max")
    with pytest.raises(ValueError, match="needs weights"):
        spmv_csr(o, i, None, x, "mul")
    with pytest.raises(TypeError, match="int32"):
        spmv_csr(o.long(), i, w, x)
    with pytest.raises(TypeError, match="float32"):
        spmv_csr(o, i, w, x.double())
    with pytest.raises(ValueError, match="entries for"):
        spmv_csr(o, i, w, torch.ones(4))
    with pytest.raises(ValueError, match="differ in length"):
        spmv_csr(o, i, w[:2], x)
    with pytest.raises(ValueError, match="contiguous"):
        spmv_csr(o, i, w, torch.ones(6)[::2])
    with pytest.raises(ValueError, match="1-D"):
        spmv_csr(o, i, w, x.view(3, 1))
    with pytest.raises(ValueError, match="no spmv_csr for device"):
        spmv_csr(o.to("meta"), i.to("meta"), w.to("meta"), x.to("meta"))


def test_prims_match_jax_segment_reductions():
    """The plain-torch primitives against the JAX package's XLA ones."""
    from cugraph_tpu.core.structure import build_structure_host
    from cugraph_tpu.prims import vertex_edge as jve

    rng = np.random.default_rng(4)
    n, m = 50, 300
    src, dst = rng.integers(0, n, m), rng.integers(0, n - 5, m)
    w = rng.random(m).astype(np.float32)
    jg = build_structure_host(src, dst, w, n)
    tg = build_structure(src, dst, w, n, "cpu")
    xv = rng.random(n).astype(np.float32)
    xj = np.zeros(jg.pad_v, np.float32)
    xj[:n] = xv
    xt = torch.from_numpy(xv)
    np.testing.assert_allclose(ve.spmv_pull(tg, xt).numpy(),
                               np.asarray(jve.spmv_pull(jg, xj))[:n],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ve.spmv_push(tg, xt).numpy(),
                               np.asarray(jve.spmv_push(jg, xj))[:n],
                               rtol=RTOL, atol=ATOL)
    for op in ("sum", "min", "max"):
        def e_op(s, d, wt):
            return s * wt + d
        got = ve.per_v_transform_reduce_incoming_e(
            tg, e_op, src_values=xt, dst_values=xt, reduce_op=op)
        want = jve.per_v_transform_reduce_incoming_e(
            jg, e_op, src_values=xj, dst_values=xj, reduce_op=op)
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:n],
                                   rtol=RTOL, atol=ATOL)
        got = ve.per_v_transform_reduce_outgoing_e(
            tg, e_op, src_values=xt, dst_values=xt, reduce_op=op)
        want = jve.per_v_transform_reduce_outgoing_e(
            jg, e_op, src_values=xj, dst_values=xj, reduce_op=op)
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:n],
                                   rtol=RTOL, atol=ATOL)
    deg = ve.per_v_transform_reduce_incoming_e(
        tg, lambda s, d, wt: torch.ones_like(wt, dtype=torch.int32),
        reduce_op="min")
    assert deg[n - 5:].tolist() == [torch.iinfo(torch.int32).max] * 5
    assert float(ve.reduce_v(tg, xt, init=1.0)) == pytest.approx(
        float(jve.reduce_v(jg, xj, init=1.0)), rel=1e-6)
    assert float(ve.transform_reduce_v(tg, torch.square, xt)) == \
        pytest.approx(float(jve.transform_reduce_v(jg, jnp.square, xj)),
                      rel=1e-6)


# heavy-row graphs at small spans: every case of the card's spans, scaled
HEAVY_SPANS = (4, 8, 32)


@pytest.mark.parametrize("combine", ["mul", "left"])
@pytest.mark.parametrize("side", ["csc", "csr"])
@pytest.mark.parametrize("span", HEAVY_SPANS)
def test_heavy_rows_match_jax_xla_route(span, side, combine):
    """The heavy-row graphs through the port's CPU path against the JAX
    package's XLA route (segment sums over its CSC or CSR)."""
    from cugraph_tpu.core.structure import build_structure_host
    from cugraph_tpu.prims import vertex_edge as jve

    n, src, dst, w = heavy_row_edges(span, seed=span)
    jg = build_structure_host(src, dst, w, n)
    tg = build_structure(src, dst, w, n, "cpu")
    xv = np.random.default_rng(span).random(n).astype(np.float32)
    xj = np.zeros(jg.pad_v, np.float32)
    xj[:n] = xv
    adj = tg.csc if side == "csc" else tg.csr
    got = spmv_csr(adj.offsets, adj.indices,
                   adj.weights if combine == "mul" else None,
                   torch.from_numpy(xv), combine)
    if side == "csc":
        want = jve.per_v_transform_reduce_incoming_e(
            jg, (lambda s, d, wt: wt * s) if combine == "mul"
            else (lambda s, d, wt: s), src_values=xj)
    else:
        want = jve.per_v_transform_reduce_outgoing_e(
            jg, (lambda s, d, wt: wt * d) if combine == "mul"
            else (lambda s, d, wt: d), dst_values=xj)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:n], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("span", [4, 8, 28, 512])
def test_heavy_row_graph_has_every_case(span):
    """The generator's CSC rows cover the span's boundaries as documented:
    degrees span - 1, span, span + 1, 2 span, 3 span + 5 and a heavy last
    row; a heavy row that starts on a span boundary, one that starts inside
    a span, two back to back, empty rows between heavy rows, and (for spans
    of 28 or more) an edge count that is not a multiple of the span."""
    n, src, dst, _ = heavy_row_edges(span)
    degs = np.bincount(dst, minlength=n)
    assert degs.tolist() == heavy_row_degrees(span)
    offsets = np.concatenate([[0], np.cumsum(degs)])
    heavy = np.flatnonzero(degs > span)
    for d in (span - 1, span, span + 1, 2 * span, 3 * span + 5):
        assert d in degs
    assert degs[-1] > span
    starts = offsets[heavy] % span
    assert (starts == 0).any() and (starts != 0).any()
    assert (np.diff(heavy) == 1).any()
    assert (np.diff(heavy) > 1).any() and (degs[heavy[0]:] == 0).any()
    if span >= 28:
        assert len(src) % span != 0


@pytest.mark.parametrize("m,span,want", [(0, 1024, 0), (1, 1024, 2),
                                         (1024, 1024, 2), (1025, 1024, 4),
                                         (16_085_385, 1024, 31_418)])
def test_span_slots(m, span, want):
    assert spmv.span_slots(m, span) == want


def test_launch_passes_scratch_and_span(monkeypatch):
    """The wrapper's side of one launch, with the C entry point recorded
    instead of called: one call per spmv_csr launch, scratch of
    span_slots(m, SPMV_SPAN) floats, the span, and one counted launch."""
    calls = []

    def fake(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(spmv, "_kernel_fn", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 7})())
    n, src, dst, w = heavy_row_edges(8)
    csc = build_csr(dst, src, w, n, "cpu")
    before = dict(spmv.LAUNCHES_BY_COMBINE), spmv.LAUNCHES
    spmv._launch(csc.offsets, csc.indices, None, torch.ones(n), "left")
    (args,) = calls
    m = len(src)
    assert args[6:] == (n, m, spmv.COMBINES["left"], spmv.SPMV_SPAN, 7)
    assert args[2] is None
    assert spmv.LAUNCHES == before[1] + 1
    assert spmv.LAUNCHES_BY_COMBINE["left"] == before[0]["left"] + 1
    spmv._launch(csc.offsets, csc.indices, csc.weights, torch.ones(n),
                 "mul", span=4)
    assert calls[1][6:] == (n, m, 0, 4, 7)
    monkeypatch.setattr(spmv, "_kernel_fn", lambda: lambda *a: 1)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        spmv._launch(csc.offsets, csc.indices, None, torch.ones(n), "left")


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_BIN", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_names_library_by_content(monkeypatch, tmp_path):
    (tmp_path / "k.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    first = _build.library_path("k")
    (tmp_path / "k.cu").write_text("// two\n")
    second = _build.library_path("k")
    assert second != first
    # a shared header the source may include names the library too
    (tmp_path / "h.cuh").write_text("// header one\n")
    third = _build.library_path("k")
    (tmp_path / "h.cuh").write_text("// header two\n")
    assert len({second, third, _build.library_path("k")}) == 3
    assert _build.sources() == ["k"]


def _fake_nvcc(directory, body):
    nvcc = directory / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(0o755)


def test_build_publishes_or_raises(monkeypatch, tmp_path):
    """The build flow with a stand-in nvcc: a success is published under
    the content-hashed name, a failure raises with the compiler's output."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "k.cu").write_text("// k\n")
    monkeypatch.setattr(_build, "CSRC", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    _fake_nvcc(tmp_path, 'echo "ptxas info"; for a; do o=$a; done; '
               ': > "$o"\n')
    _build.build(["k"])
    assert (tmp_path / "build").exists()
    assert os.path.exists(_build.library_path("k"))
    assert "sm_90a" in _build.BUILD_LOG["k"]
    (src / "k.cu").write_text("// k changed\n")
    _fake_nvcc(tmp_path, 'echo "k.cu(1): error"; exit 1\n')
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build(["k"])
    leftovers = [f for f in os.listdir(tmp_path / "build")
                 if f.endswith(".tmp")]
    assert leftovers == []


def _cuda_cases():
    for name, n, _, src, dst, w in CASES:
        yield name, build_csr(dst, src, w, n, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("combine", ["mul", "left"])
def test_kernel_matches_reference_on_the_card(combine):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name, csc in _cuda_cases():
        x = torch.rand(csc.num_vertices, device="cuda")
        before = spmv.LAUNCHES
        y1 = spmv_csr(csc.offsets, csc.indices, csc.weights, x, combine)
        y2 = spmv_csr(csc.offsets, csc.indices, csc.weights, x, combine)
        torch.cuda.synchronize()
        assert spmv.LAUNCHES == before + (2 if csc.num_vertices else 0)
        assert torch.equal(y1.view(torch.int32), y2.view(torch.int32)), name
        want = spmv_csr_reference(csc.offsets, csc.indices, csc.weights, x,
                                  combine)
        torch.testing.assert_close(y1, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("combine", ["mul", "left"])
def test_kernel_on_heavy_rows_on_the_card(combine):
    """The heavy-row graphs at the span the wrapper uses, and at smaller
    ones through the sweep's entry, over the CSC and the CSR, against the
    plain version; two launches bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for span in (spmv.SPMV_SPAN, 32):
        n, src, dst, w = heavy_row_edges(span, seed=span)
        g = build_structure(src, dst, w, n, "cuda")
        for adj in (g.csc, g.csr):
            x = torch.rand(n, device="cuda")
            args = (adj.offsets, adj.indices, adj.weights, x, combine)
            y1 = spmv._launch(*args, span=span)
            y2 = spmv._launch(*args, span=span)
            torch.cuda.synchronize()
            assert torch.equal(y1.view(torch.int32), y2.view(torch.int32))
            torch.testing.assert_close(y1, spmv_csr_reference(*args),
                                       rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_kernel_rejects_mixed_devices():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    csc = build_csr(np.array([0, 1]), np.array([1, 0]), None, 2, "cuda")
    with pytest.raises(ValueError, match="is on"):
        spmv_csr(csc.offsets, csc.indices, csc.weights, torch.ones(2))
