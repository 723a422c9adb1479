"""The port's native host engines (cugraph_tpu_torch/core/native.py) against
their NumPy plain versions and against cugraph_tpu.core.native.

R-MAT generation, renumbering and duplicate-edge removal must give the same
edges, the same NumberMap and the same kept parallel edge, bit for bit; the
core peel the same core numbers; the Louvain sweep, the Leiden refinement
sweep and the cluster contraction (byte-for-byte copies of the JAX
package's engines) the same clusters and edges; the triangle engine, also
a byte-for-byte copy, is held bit for bit in test_torch_triangles.py.  A
failed build or a nonzero return raises and never falls back to NumPy or
XLA.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import cugraph_tpu.core.native as jnative
from cugraph_tpu.core import preprocess as jpre
from cugraph_tpu.core.renumber import renumber_edgelist as j_renumber

import cugraph_tpu_torch as ct
from cugraph_tpu_torch.core import native, preprocess, renumber
from cugraph_tpu_torch.generators import rmat as trmat

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("scale,m,clip,seed", [
    (10, 16 << 10, False, 7), (12, 3 << 12, True, 3), (1, 5, False, 0),
    (16, 70000, True, 2**63 + 5)])
def test_rmat_native_matches_numpy_and_jax_native(scale, m, clip, seed):
    args = (scale, m, 0.57, 0.19, 0.19, seed, clip)
    got = trmat._rmat_host(*args)
    want = trmat._rmat_numpy(*args)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got, jnative.rmat_native(*args)):
        np.testing.assert_array_equal(g, w)


def _renumber_cases():
    rng = np.random.default_rng(3)
    ids = rng.choice(10**12, 400, replace=False).astype(np.int64)
    yield "sparse", ids[rng.integers(0, 400, 2000)], \
        ids[rng.integers(0, 400, 2000)], None
    yield "vertices", ids[rng.integers(0, 100, 300)], \
        ids[rng.integers(0, 100, 300)], np.concatenate(
            [ids[:5], [10**12 + 3, 10**12 + 1]])
    yield "mixed_width", np.array([0, 1, 2], np.int32), \
        np.array([2**40, 1, 0], np.int64), None
    yield "int64_min", np.array([np.iinfo(np.int64).min, 5, 7], np.int64), \
        np.array([5, 7, np.iinfo(np.int64).min], np.int64), None
    yield "dense_ties", rng.integers(0, 50, 500), rng.integers(0, 50, 500), \
        None
    yield "floats", rng.random(50), rng.random(50), None


@pytest.mark.parametrize("sort_by_degree", [True, False])
@pytest.mark.parametrize("case", [c[0] for c in _renumber_cases()])
def test_renumber_native_matches_numpy_and_jax(case, sort_by_degree,
                                               monkeypatch):
    _, src, dst, vertices = next(c for c in _renumber_cases()
                                 if c[0] == case)
    kw = dict(sort_by_degree=sort_by_degree, vertices=vertices)
    got = renumber.renumber_edgelist(src, dst, **kw)
    want = j_renumber(src, dst, **kw)
    monkeypatch.setattr(renumber, "_dense_ids", renumber._dense_ids_numpy)
    plain = renumber.renumber_edgelist(src, dst, **kw)
    for other in (want, plain):
        np.testing.assert_array_equal(got[0], other[0])
        np.testing.assert_array_equal(got[1], other[1])
        n = other[2].num_vertices
        assert got[2].num_vertices == n
        e_got = got[2].to_external(np.arange(n))
        e_want = other[2].to_external(np.arange(n))
        assert e_got.dtype == e_want.dtype
        np.testing.assert_array_equal(e_got, e_want)


def test_renumber_takes_the_native_path_for_integer_ids(monkeypatch):
    calls = []
    real = native.renumber_native
    monkeypatch.setattr(native, "renumber_native",
                        lambda s, d: calls.append(len(s)) or real(s, d))
    renumber.renumber_edgelist(np.array([5, 9]), np.array([9, 2]))
    renumber.renumber_edgelist(np.array([0.5]), np.array([1.5]))
    assert calls == [2]


def _dedupe_cases():
    rng = np.random.default_rng(11)
    src = rng.integers(0, 40, 600).astype(np.int32)
    dst = rng.integers(0, 40, 600).astype(np.int32)
    w = rng.random(600).astype(np.float32)
    yield "dense", src, dst, w
    w_specials = w.copy()
    w_specials[:40] = 0.0
    w_specials[40:80] = -0.0
    yield "signed_zeros", src, dst, w_specials
    w_nan = w.copy()
    w_nan[::7] = np.nan
    yield "nan", src, dst, w_nan
    yield "sparse_ids", (src.astype(np.int64) * 10**6), dst.astype(np.int64), w
    yield "loops_int64", src.astype(np.int64), src.astype(np.int64) % 3, w


@pytest.mark.parametrize("keep", ["first", "sum", "min", "max"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", [c[0] for c in _dedupe_cases()])
def test_dedupe_matches_numpy_and_jax_bitwise(case, weighted, keep):
    _, src, dst, w = next(c for c in _dedupe_cases() if c[0] == case)
    w = w if weighted else None
    got = preprocess.remove_multi_edges(src, dst, w, keep=keep)
    plain = preprocess._remove_multi_edges_numpy(src, dst, w, keep=keep)
    want = jpre.remove_multi_edges(src, dst, w, keep=keep)
    # the JAX package's native min/max drop a NaN and keep the first of
    # -0.0 and +0.0; the port takes NumPy's path there, as before
    jax_differs = case in ("nan", "signed_zeros") and keep in ("min", "max")
    for other in (plain,) if jax_differs else (plain, want):
        for g, x in zip(got, other):
            if g is None:
                assert x is None
                continue
            assert g.dtype == x.dtype
            np.testing.assert_array_equal(g.view(np.uint8), x.view(np.uint8))


def test_dedupe_keeps_the_first_parallel_edge_and_input_order():
    src = np.array([3, 1, 3, 0, 1, 3], np.int32)
    dst = np.array([2, 2, 2, 0, 2, 2], np.int32)
    w = np.arange(6, dtype=np.float32)
    s, d, ww = preprocess.remove_multi_edges(src, dst, w)
    np.testing.assert_array_equal(s, [3, 1, 0])
    np.testing.assert_array_equal(d, [2, 2, 0])
    np.testing.assert_array_equal(ww, [0, 1, 3])
    s, d, ww = preprocess.remove_multi_edges(src, dst, w, keep="sum")
    np.testing.assert_array_equal(s, [0, 1, 3])  # key order
    np.testing.assert_array_equal(ww, [3, 5, 7])


def test_dedupe_native_matches_jax_native_directly():
    rng = np.random.default_rng(2)
    src = rng.integers(0, 100, 3000).astype(np.int32)
    dst = rng.integers(0, 100, 3000).astype(np.int32)
    w = rng.random(3000).astype(np.float32)
    for mode in range(4):
        got = native.dedupe_edges_native(src, dst, w, 100, mode)
        want = jnative.dedupe_edges_native(src, dst, w, 100, mode)
        np.testing.assert_array_equal(got[0], want[0])
        if mode:
            np.testing.assert_array_equal(got[1], want[1])


def test_core_peel_matches_jax_native():
    rng = np.random.default_rng(4)
    n = 300
    src = rng.integers(0, n, 2000)
    dst = rng.integers(0, n, 2000)
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    off = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=off[1:])
    deg = np.diff(off)
    got = native.core_number_peel_native(off, dst.astype(np.int32), deg)
    want = jnative.core_number_peel_native(off, dst.astype(np.int32), deg)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("weighted,directed", [(False, True), (True, False)])
def test_graph_on_native_engines_equals_graph_on_numpy(weighted, directed,
                                                       monkeypatch):
    e = ct.rmat(11, 16 << 11, seed=5, scramble_vertex_ids=True,
                include_edge_weights=weighted)
    w = e["weights"].to_numpy() if weighted else None
    got = ct.Graph(directed=directed, device="cpu").from_edgelist(
        e["src"].to_numpy(), e["dst"].to_numpy(), w)
    monkeypatch.setattr(renumber, "_dense_ids", renumber._dense_ids_numpy)
    monkeypatch.setattr(preprocess, "remove_multi_edges",
                        preprocess._remove_multi_edges_numpy)
    want = ct.Graph(directed=directed, device="cpu").from_edgelist(
        e["src"].to_numpy(), e["dst"].to_numpy(), w)
    for g, x in zip(got.edgelist_arrays(), want.edgelist_arrays()):
        np.testing.assert_array_equal(g, x)
    n = want.number_of_vertices()
    np.testing.assert_array_equal(got.number_map.to_external(np.arange(n)),
                                  want.number_map.to_external(np.arange(n)))


def test_library_is_built_into_build_native_by_hash():
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "build", "native")
    native.get_lib()
    assert os.path.exists(path)
    assert os.path.basename(path).startswith("builder_")


def test_failed_build_raises_and_does_not_fall_back(monkeypatch):
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ["-DNO_SUCH_BUILD",
                                            "-fno-such-flag-at-all"])
    with pytest.raises(RuntimeError, match="no-such-flag"):
        native.get_lib()
    with pytest.raises(RuntimeError, match="no-such-flag"):
        ct.rmat(8, 100)
    assert not os.path.exists(native.library_path())
    leftovers = [f for f in os.listdir(native.BUILD_DIR)
                 if f.endswith(".tmp") and str(os.getpid()) in f]
    assert leftovers == []
    monkeypatch.setattr(native, "CXX", "no-such-compiler-g++")
    with pytest.raises(RuntimeError, match="cannot run"):
        native.get_lib()


def test_import_builds_nothing_and_needs_no_compiler():
    """With no compiler on PATH, every module imports; the first native
    call raises (on a library not yet built)."""
    code = ("import importlib, pkgutil, cugraph_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, "
            "'cugraph_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "from cugraph_tpu_torch.core import native\n"
            "native.CXX_FLAGS = native.CXX_FLAGS + ['-DIMPORT_PROBE']\n"
            "try:\n"
            "    p.rmat(6, 10)\n"
            "except RuntimeError as e:\n"
            "    print('raised', e)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env={**os.environ, "PATH": ""})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "raised cannot run g++" in out.stdout


# -- the community engines: louvain_sweep, leiden_refine_sweep, coarsen_edges,
# and the triangle engine triangle_support

ENGINES = ("louvain_sweep", "leiden_refine_sweep", "coarsen_edges",
           "triangle_support")


def _engine_source(path, name):
    """The text of one engine: its comment block and its body."""
    with open(path) as f:
        lines = f.read().split("\n")
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith(("int ", "int64_t ")) and f" {name}(" in ln)
    while start > 0 and lines[start - 1].startswith("//"):
        start -= 1
    end = next(i for i in range(start, len(lines)) if lines[i] == "}")
    return "\n".join(lines[start:end + 1])


@pytest.mark.parametrize("name", ENGINES)
def test_community_engines_are_byte_for_byte_copies(name):
    theirs = os.path.join(ROOT, "cugraph_tpu", "core", "_native",
                          "builder.cpp")
    got = _engine_source(native.SRC, name)
    assert got == _engine_source(theirs, name)
    assert len(got.split("\n")) > 40


def _community_graph(seed, n=400, m=5000, loops=True, weights="float"):
    """A graph sorted by source with row offsets, as the sweeps take it."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    if loops:
        dst = np.where(rng.random(m) < 0.05, src, dst)
    w = (rng.random(m) if weights == "float"
         else rng.integers(1, 5, m)).astype(np.float32)
    s, d, w = native.coarsen_edges_native(src, dst, w, n)
    row_off = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(s, minlength=n), out=row_off[1:])
    return s, d, w, row_off, n, rng


@pytest.mark.parametrize("ranked", [False, True])
@pytest.mark.parametrize("up_down", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_louvain_sweep_matches_jax_native(seed, up_down, ranked):
    s, d, w, row_off, n, rng = _community_graph(seed)
    cluster = rng.integers(0, n // 3, n).astype(np.int32)
    rank = rng.permutation(n).astype(np.int32) if ranked else None
    for res in (1.0, 0.3):
        got = native.louvain_sweep_native(d, w, row_off, cluster, up_down,
                                          res, rank=rank)
        want = jnative.louvain_sweep_native(d, w, row_off, cluster, up_down,
                                            res, rank=rank)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert not np.array_equal(got, cluster)


@pytest.mark.parametrize("seed", [0, 3, 2**40 + 9])
def test_leiden_refine_sweep_matches_jax_native(seed):
    s, d, w, row_off, n, rng = _community_graph(2, weights="int")
    comm = rng.integers(0, 12, n).astype(np.int32)
    refined = np.arange(n, dtype=np.int32)
    for i in range(3):
        got = native.leiden_refine_sweep_native(d, w, row_off, comm, refined,
                                                1.0, 1.0, seed + i)
        want = jnative.leiden_refine_sweep_native(d, w, row_off, comm,
                                                  refined, 1.0, 1.0, seed + i)
        np.testing.assert_array_equal(got, want)
        refined = got
    assert not np.array_equal(refined, np.arange(n))
    assert np.all(comm[refined] == comm) and np.all(refined[refined] ==
                                                    refined)


@pytest.mark.parametrize("weights", ["int", "float"])
def test_coarsen_edges_matches_jax_native_and_numpy(weights):
    from cugraph_tpu_torch.algos import community

    rng = np.random.default_rng(21)
    m, n = 5000, 300
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    w = (rng.random(m) if weights == "float"
         else rng.integers(1, 9, m) / 4.0).astype(np.float32)
    labels = rng.integers(0, 40, n)
    a = community._coarsen(src, dst, w, labels)
    b = community._coarsen_numpy(src, dst, w, labels)
    assert a[3] == b[3]
    np.testing.assert_array_equal(a[4], b[4])
    np.testing.assert_array_equal(a[0], b[0])   # both sorted by (src, dst)
    np.testing.assert_array_equal(a[1], b[1])
    if weights == "int":
        np.testing.assert_array_equal(a[2], b[2])
    else:   # float64 run sums rounded once against float32 reduceat
        np.testing.assert_allclose(a[2], b[2], rtol=1e-6)
    cs, cd = a[4][src], a[4][dst]
    for got, want in zip(native.coarsen_edges_native(cs, cd, w, a[3]),
                         jnative.coarsen_edges_native(cs, cd, w, a[3])):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("engine", ENGINES)
def test_community_engine_nonzero_return_raises(engine, monkeypatch):
    lib = native.get_lib()

    class Failing:
        def __getattr__(self, name):
            return (lambda *a: 1 if engine != "coarsen_edges" else -1) \
                if name == engine else getattr(lib, name)

    s, d, w, row_off, n, _ = _community_graph(0, n=50, m=300)
    cl = np.arange(n, dtype=np.int32)
    monkeypatch.setattr(native, "get_lib", lambda: Failing())
    call = {"louvain_sweep": lambda: native.louvain_sweep_native(
                d, w, row_off, cl, True, 1.0),
            "leiden_refine_sweep": lambda: native.leiden_refine_sweep_native(
                d, w, row_off, cl, cl, 1.0, 1.0, 0),
            "coarsen_edges": lambda: native.coarsen_edges_native(
                s, d, w, n),
            "triangle_support": lambda: native.triangle_support_native(
                s, d, n, True)}[engine]
    with pytest.raises(RuntimeError, match=engine):
        call()
