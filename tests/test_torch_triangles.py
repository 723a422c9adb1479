"""The port's triangle counts, per-edge triangle counts and k-truss against
cugraph_tpu on the CPU.

Both packages count with the same wedge engine: the JAX package's native
``triangle_support`` (or, with ``cugraph_tpu.core.native`` returning None,
its NumPy loop) and the port's byte-for-byte copy of it.  Counts are
integers, so every frame and every k-truss edge set must be equal bit for
bit.  The native engine is also held against the port's plain version,
``_oriented_wedge_counts_numpy``, and the sort that replaces ``np.unique``
against ``np.unique`` itself.
"""

import os

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import torch

import cugraph_tpu as ctpu
import cugraph_tpu.core.native as jnative

import cugraph_tpu_torch as ct
from cugraph_tpu_torch.algos import _oriented_tri
from cugraph_tpu_torch.core import native
from cugraph_tpu_torch.core.preprocess import unique_by_sort

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cugraph_tpu", "datasets", "data")
KINDS = ["karate", "dolphins", "netscience", "rmat10", "rmat12", "loops"]


def _edges(kind):
    """(src, dst, weights or None) of an undirected test graph."""
    if kind == "karate":
        e = np.array(list(nx.karate_club_graph().edges()))
        return e[:, 0], e[:, 1], None
    if kind in ("dolphins", "netscience"):
        a = np.loadtxt(os.path.join(DATA, f"{kind}.csv"))
        return a[:, 0].astype(np.int64), a[:, 1].astype(np.int64), a[:, 2]
    if kind.startswith("rmat"):
        scale = int(kind[4:])
        e = ctpu.rmat(scale, 8 << scale, seed=4)
        w = np.random.default_rng(scale).integers(1, 9, len(e)) / 4.0
        return e["src"].to_numpy(), e["dst"].to_numpy(), w
    # "loops": dense random edges with self-loops and parallel edges
    rng = np.random.default_rng(5)
    s = rng.integers(0, 60, 900)
    d = np.where(rng.random(900) < 0.1, s, rng.integers(0, 60, 900))
    return s, d, rng.integers(1, 5, 900).astype(np.float32)


def _pair(kind, directed=False):
    s, d, w = _edges(kind)
    return (ctpu.Graph(directed=directed).from_edgelist(s, d, w),
            ct.Graph(directed=directed, device="cpu").from_edgelist(s, d, w))


@pytest.fixture(params=["native", "numpy"])
def jax_engine(request, monkeypatch):
    """The JAX package's native engine as is, or its NumPy loop."""
    if request.param == "numpy":
        monkeypatch.setattr(jnative, "triangle_support_native",
                            lambda *a, **k: None)
    return request.param


@pytest.mark.parametrize("kind", KINDS)
def test_triangle_count_matches_jax_bitwise(kind, jax_engine):
    Gj, Gt = _pair(kind)
    want = ctpu.triangle_count(Gj)
    got = ct.triangle_count(Gt)
    pd.testing.assert_frame_equal(got, want)
    assert got["counts"].sum() > 0
    some = want["vertex"].to_numpy()[::3]
    pd.testing.assert_frame_equal(ct.triangle_count(Gt, start_list=some),
                                  ctpu.triangle_count(Gj, start_list=some))


def test_triangle_count_matches_networkx():
    Gj, Gt = _pair("karate")
    got = ct.triangle_count(Gt)
    want = nx.triangles(nx.karate_club_graph())
    for v, c in zip(got["vertex"], got["counts"]):
        assert c == want[v]


@pytest.mark.parametrize("kind", KINDS)
def test_edge_triangle_count_matches_jax_bitwise(kind, jax_engine):
    Gj, Gt = _pair(kind)
    got = ct.edge_triangle_count(Gt)
    pd.testing.assert_frame_equal(got, ctpu.edge_triangle_count(Gj))
    # each undirected edge is listed twice, each triangle has three edges
    assert got["counts"].sum() == 2 * ct.triangle_count(Gt)["counts"].sum()


def _graph_arrays(G):
    s, d, w = G.edgelist_arrays()
    ext = G.number_map.to_external(np.arange(G.number_of_vertices()))
    return s, d, w, ext


@pytest.mark.parametrize("k", [3, 4, 5, 7])
@pytest.mark.parametrize("kind", KINDS)
def test_k_truss_matches_jax_bitwise(kind, k, jax_engine):
    Gj, Gt = _pair(kind)
    got = ct.k_truss(Gt, k)
    want = ctpu.k_truss(Gj, k)
    assert got.device == Gt.device and not got.is_directed()
    for g, w in zip(_graph_arrays(got), _graph_arrays(want)):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # every kept edge closes k - 2 triangles inside the truss
    if got.number_of_edges():
        assert ct.edge_triangle_count(got)["counts"].min() >= k - 2


def test_k_truss_of_a_triangle_free_graph_is_empty():
    G = ct.Graph(device="cpu").from_edgelist(np.arange(5), np.arange(1, 6))
    out = ct.ktruss_subgraph(G, 3)
    assert out.number_of_edges() == 0


@pytest.mark.parametrize("fn", [ct.triangle_count, ct.edge_triangle_count,
                                lambda G: ct.k_truss(G, 3)])
def test_directed_graph_raises(fn):
    _, Gt = _pair("karate", directed=True)
    if fn is ct.edge_triangle_count:  # the JAX package counts it anyway
        Gj, _ = _pair("karate", directed=True)
        pd.testing.assert_frame_equal(fn(Gt), ctpu.edge_triangle_count(Gj))
        return
    with pytest.raises(ValueError):
        fn(Gt)


def _unique_pairs(seed, n, m):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n, m)
    b = rng.integers(0, n, m)
    keep = a != b
    key = np.unique(np.minimum(a, b)[keep] * n + np.maximum(a, b)[keep])
    u, v = key // n, key % n
    flip = rng.random(len(u)) < 0.5  # any order within a pair
    return np.where(flip, v, u), np.where(flip, u, v)


@pytest.mark.parametrize("need_support", [False, True])
@pytest.mark.parametrize("seed,n,m", [(0, 50, 600), (1, 300, 4000),
                                      (2, 2000, 30000), (3, 5, 3)])
def test_native_engine_matches_numpy_and_jax(seed, n, m, need_support):
    u, v = _unique_pairs(seed, n, m)
    got = native.triangle_support_native(u, v, n, need_support)
    plain = _oriented_tri._oriented_wedge_counts_numpy(u, v, n, need_support)
    want = jnative.triangle_support_native(u, v, n, need_support)
    for other in (plain, want):
        np.testing.assert_array_equal(got[0], other[0])
        if need_support:
            np.testing.assert_array_equal(got[1], other[1])
        else:
            assert got[1] is None and other[1] is None
    assert got[0].dtype == np.int64
    if need_support:
        assert got[0].sum() == got[1].sum()


def test_engine_on_no_edges():
    tri, sup = _oriented_tri.oriented_wedge_counts([], [], 4, True)
    np.testing.assert_array_equal(tri, np.zeros(4, np.int64))
    assert sup.shape == (0,)


def test_engine_nonzero_return_raises(monkeypatch):
    lib = native.get_lib()

    class Failing:
        def __getattr__(self, name):
            return (lambda *a: -1) if name == "triangle_support" else \
                getattr(lib, name)

    monkeypatch.setattr(native, "get_lib", lambda: Failing())
    with pytest.raises(RuntimeError, match="triangle_support"):
        ct.triangle_count(_pair("karate")[1])


@pytest.mark.parametrize("size,span", [(0, 5), (1, 5), (1000, 7),
                                       (20000, 10**12)])
def test_unique_by_sort_matches_np_unique(size, span):
    key = np.random.default_rng(size).integers(-span, span, size)
    want = np.unique(key, return_index=True, return_inverse=True)
    got = unique_by_sort(key, "cpu", return_index=True, return_inverse=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.ravel())
    np.testing.assert_array_equal(unique_by_sort(key, "cpu"), want[0])


@pytest.mark.cuda
def test_triangles_on_the_card_match_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    s, d, w = _edges("rmat12")
    Gc = ct.Graph(device="cpu").from_edgelist(s, d, w)
    Gg = ct.Graph().from_edgelist(s, d, w)
    pd.testing.assert_frame_equal(ct.triangle_count(Gg),
                                  ct.triangle_count(Gc))
    pd.testing.assert_frame_equal(ct.edge_triangle_count(Gg),
                                  ct.edge_triangle_count(Gc))
    out = ct.k_truss(Gg, 5)
    assert out.device.type == "cuda"
    for g, c in zip(_graph_arrays(out), _graph_arrays(ct.k_truss(Gc, 5))):
        np.testing.assert_array_equal(g, c)
