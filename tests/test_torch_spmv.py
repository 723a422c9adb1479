"""Kernel K1 of the PyTorch port: the sum SpMV over one CSR.

On the CPU the wrapper takes its plain version, which must match the TPU
kernel ``spmv_onehot`` run in interpret mode at "highest" precision (an
exact one-hot selection).  Tolerance rtol 1e-5, atol 1e-6: both sum in a
different order, the plain version in float64, the TPU kernel in float32.
The tests marked ``cuda`` hold the hand-written kernel against the plain
version on the card and skip without one.
"""

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
    assert _build.library_path("k") != first
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
def test_kernel_rejects_mixed_devices():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    csc = build_csr(np.array([0, 1]), np.array([1, 0]), None, 2, "cuda")
    with pytest.raises(ValueError, match="is on"):
        spmv_csr(csc.offsets, csc.indices, csc.weights, torch.ones(2))
