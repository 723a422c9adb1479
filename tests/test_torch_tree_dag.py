"""The port's spanning trees, topological sort, approximate weighted
matching and egonets against cugraph_tpu on the CPU.

Every result here is discrete, so each is held bit for bit: the spanning
forests' edge lists and vertex maps (Borůvka with the same weight, lo, hi
tie-break) on graphs with tied weights; the topological frames, with the
K1 "left" decrement against a plain ``scatter_add`` one; the matching's
partners and total, from the port's locally-dominant rounds, against the
JAX package's serial loop and the port's copy of it, on tied weights and
signed zeros; the egonet frames and offsets at radius 1 and 2.
"""

import os

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse import csgraph

import cugraph_tpu as ctpu

import cugraph_tpu_torch as ct
from cugraph_tpu_torch.algos import community as tcom
from cugraph_tpu_torch.algos import dag as tdag
from cugraph_tpu_torch.kernels import spmv

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cugraph_tpu", "datasets", "data")


def _edges(kind):
    """(src, dst, weights or None) with many tied weights."""
    rng = np.random.default_rng(len(kind))
    if kind.startswith("karate"):
        e = np.array(list(nx.karate_club_graph().edges()))
        w = (None if kind == "karate" else
             rng.integers(1, 4, len(e)).astype(np.float32))
        return e[:, 0], e[:, 1], w
    if kind == "netscience":
        a = np.loadtxt(os.path.join(DATA, "netscience.csv"))
        return a[:, 0].astype(np.int64), a[:, 1].astype(np.int64), a[:, 2]
    if kind.startswith("rmat"):
        scale = int(kind[4:6])
        e = ctpu.rmat(scale, 8 << scale, seed=4)
        w = rng.integers(1, 5, len(e)).astype(np.float32)
        return e["src"].to_numpy(), e["dst"].to_numpy(), w
    if kind == "zeros":  # signed zeros tie in the serial loop's order
        s = rng.integers(0, 40, 300)
        d = rng.integers(0, 40, 300)
        w = rng.choice(np.array([0.0, -0.0, 1.0, 2.0], np.float32), 300)
        return s, d, w
    # "forest": three components with loops, string-free sparse ids
    s = np.array([10, 11, 12, 10, 20, 21, 22, 30, 30, 31, 40])
    d = np.array([11, 12, 10, 10, 21, 22, 20, 31, 32, 32, 40])
    return s, d, np.array([2, 2, 1, 5, 3, 3, 3, 1, 1, 1, 7], np.float32)


def _pair(kind, directed=False):
    s, d, w = _edges(kind)
    return (ctpu.Graph(directed=directed).from_edgelist(s, d, w),
            ct.Graph(directed=directed, device="cpu").from_edgelist(s, d, w))


def _graph_arrays(G):
    s, d, w = G.edgelist_arrays()
    ext = G.number_map.to_external(np.arange(G.number_of_vertices()))
    return s, d, w, ext


def _assert_same_graph(got, want):
    assert got.is_directed() == want.is_directed()
    for g, w in zip(_graph_arrays(got), _graph_arrays(want)):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# -- spanning trees -----------------------------------------------------------

TREE_KINDS = ["karate", "karate_w", "netscience", "rmat10", "forest"]


@pytest.mark.parametrize("kind", TREE_KINDS)
def test_minimum_spanning_tree_matches_jax_bitwise(kind):
    Gj, Gt = _pair(kind)
    got = ct.minimum_spanning_tree(Gt)
    assert got.device == Gt.device
    _assert_same_graph(got, ctpu.minimum_spanning_tree(Gj))
    # a forest of n - #components edges, of scipy's total weight
    s, d, w = Gt.edgelist_arrays()
    n = Gt.number_of_vertices()
    w64 = np.ones(len(s)) if w is None else w.astype(np.float64)
    A = sp.csr_matrix((w64, (s, d)), shape=(n, n))
    n_comp = csgraph.connected_components(A, directed=False)[0]
    assert got.number_of_edges() == n - n_comp
    assert got.number_of_vertices() == n
    el = got.view_edge_list()
    want = csgraph.minimum_spanning_tree(A).sum()
    np.testing.assert_allclose(el["weight"].astype(np.float64).sum(), want,
                               rtol=1e-12)


@pytest.mark.parametrize("kind", TREE_KINDS)
def test_maximum_spanning_tree_matches_jax_bitwise(kind):
    Gj, Gt = _pair(kind)
    got = ct.maximum_spanning_tree(Gt)
    _assert_same_graph(got, ctpu.maximum_spanning_tree(Gj))
    pd.testing.assert_frame_equal(got.view_edge_list(),
                                  ctpu.maximum_spanning_tree(
                                      Gj).view_edge_list())


def test_spanning_tree_of_a_directed_graph_raises():
    _, Gt = _pair("karate", directed=True)
    for fn in (ct.minimum_spanning_tree, ct.maximum_spanning_tree):
        with pytest.raises(ValueError):
            fn(Gt)


@pytest.mark.parametrize("directed", [False, True])
def test_view_edge_list_and_edges_match_jax(directed):
    Gj, Gt = _pair("rmat10", directed)
    pd.testing.assert_frame_equal(Gt.view_edge_list(), Gj.view_edge_list())
    pd.testing.assert_frame_equal(Gt.edges(), Gj.edges())
    Gj, Gt = _pair("karate", directed)
    pd.testing.assert_frame_equal(Gt.view_edge_list(), Gj.view_edge_list())


# -- topological sort ---------------------------------------------------------

def _dag_edges(kind):
    s, d, _ = _edges(kind)
    keep = s < d
    return s[keep], d[keep]


def _plain_decrement(offsets, indices, weights, x, combine):
    """The in-degree decrement as a ``scatter_add`` over the CSC."""
    assert combine == "left" and weights is None
    rows = torch.repeat_interleave(
        torch.arange(offsets.shape[0] - 1),
        (offsets[1:] - offsets[:-1]).to(torch.int64))
    out = torch.zeros(offsets.shape[0] - 1, dtype=torch.float32)
    return out.scatter_add_(0, rows, x[indices.to(torch.int64)])


@pytest.mark.parametrize("kind", ["karate", "netscience", "rmat10",
                                  "rmat12"])
def test_topological_sort_matches_jax_bitwise(kind, monkeypatch):
    s, d = _dag_edges(kind)
    Gj = ctpu.Graph(directed=True).from_edgelist(s, d)
    Gt = ct.Graph(directed=True, device="cpu").from_edgelist(s, d)
    got = ct.topological_sort(Gt)
    pd.testing.assert_frame_equal(got, ctpu.topological_sort(Gj))
    # every edge goes up a level; a level is 1 + the largest below it
    lvl = dict(zip(got["vertex"], got["level"]))
    ls, ld = np.array([lvl[v] for v in s]), np.array([lvl[v] for v in d])
    assert (ls < ld).all()
    best = {}
    for a, b in zip(ls, d):
        best[b] = max(best.get(b, -1), a)
    assert all(lvl[v] == best.get(v, -1) + 1 for v in lvl)
    # one K1 "left" call per level, and the plain decrement agrees
    calls = []
    monkeypatch.setattr(tdag, "spmv_csr", lambda *a: calls.append(1) or
                        spmv.spmv_csr(*a))
    ct.topological_sort(Gt)
    assert len(calls) == got["level"].max() + 1
    monkeypatch.setattr(tdag, "spmv_csr", _plain_decrement)
    pd.testing.assert_frame_equal(ct.topological_sort(Gt), got)


def test_topological_sort_errors():
    s, d, _ = _edges("karate")
    cyc = ct.Graph(directed=True, device="cpu").from_edgelist(
        np.r_[s, [33]], np.r_[d, [0]])
    with pytest.raises(ValueError, match="cycle"):
        ct.topological_sort(cyc)
    loop = ct.Graph(directed=True, device="cpu").from_edgelist(
        np.array([0, 1]), np.array([1, 1]))
    with pytest.raises(ValueError, match="cycle"):
        ct.topological_sort(loop)
    with pytest.raises(ValueError, match="directed"):
        ct.topological_sort(_pair("karate")[1])


# -- approximate weighted matching ---------------------------------------------

MATCH_KINDS = ["karate", "karate_w", "netscience", "rmat10", "rmat12",
               "zeros", "forest"]


@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("kind", MATCH_KINDS)
def test_matching_matches_jax_and_the_serial_loop(kind, directed):
    Gj, Gt = _pair(kind, directed)
    got, total = ct.approx_weighted_matching(Gt)
    want, want_total = ctpu.approx_weighted_matching(Gj)
    pd.testing.assert_frame_equal(got, want)
    assert total == want_total  # float64, summed in the same order
    s, d, w = Gt.edgelist_arrays()
    w = np.ones(len(s), np.float32) if w is None else w
    partner, plain_total = tcom._approx_weighted_matching_serial(
        s, d, w, Gt.number_of_vertices())
    np.testing.assert_array_equal(
        Gt.lookup_internal_vertex_id(got["partner"].to_numpy()[partner >= 0]),
        partner[partner >= 0])
    assert (got["partner"].to_numpy()[partner < 0] == -1).all()
    assert total == plain_total
    assert (partner >= 0).any()


def test_matching_rounds_on_a_path_of_rising_weights():
    """Each round matches only the heaviest free edge of a path whose
    weights rise along it: the rounds must still end with the serial
    loop's matching."""
    n = 40
    G = ct.Graph(device="cpu").from_edgelist(
        np.arange(n - 1), np.arange(1, n), np.arange(1, n, dtype=np.float32))
    got, total = ct.approx_weighted_matching(G)
    s, d, w = G.edgelist_arrays()
    partner, plain = tcom._approx_weighted_matching_serial(s, d, w, n)
    np.testing.assert_array_equal(
        G.lookup_internal_vertex_id(got["partner"].to_numpy()), partner)
    assert total == plain == sum(range(n - 1, 0, -2))


# -- egonets ------------------------------------------------------------------

@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("kind", ["karate", "netscience", "rmat12"])
def test_egonets_match_jax_bitwise(kind, directed, radius):
    Gj, Gt = _pair(kind, directed)
    seeds = Gt.nodes()[np.random.default_rng(1).choice(
        Gt.number_of_vertices(), 6, replace=False)]
    got, offs = ct.batched_ego_graphs(Gt, seeds, radius=radius)
    want, want_offs = ctpu.batched_ego_graphs(Gj, seeds, radius=radius)
    pd.testing.assert_frame_equal(got, want)
    np.testing.assert_array_equal(offs, want_offs)
    assert offs[-1] == len(got) > 0
    g2, o2 = ct.egonet(Gt, seeds[:2], radius)
    pd.testing.assert_frame_equal(g2, want.iloc[:want_offs[2]])


@pytest.mark.parametrize("directed", [False, True])
def test_ego_graph_matches_jax(directed):
    Gj, Gt = _pair("karate_w", directed)
    for center in (0, 33):
        for radius in (1, 2):
            got = ct.ego_graph(Gt, center, radius)
            assert got.device == Gt.device
            _assert_same_graph(got, ctpu.ego_graph(Gj, center, radius))
    lone = ct.Graph(device="cpu").from_edgelist(
        np.array([0, 1]), np.array([1, 2]), vertices=np.array([0, 1, 2, 7]))
    out = ct.ego_graph(lone, 7)
    assert out.number_of_vertices() == 1 and out.number_of_edges() == 0


@pytest.mark.cuda
def test_tree_dag_matching_egonets_on_the_card_match_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    s, d, w = _edges("rmat12")
    Gc = ct.Graph(device="cpu").from_edgelist(s, d, w)
    Gg = ct.Graph().from_edgelist(s, d, w)
    _assert_same_graph(ct.minimum_spanning_tree(Gg),
                       ct.minimum_spanning_tree(Gc))
    a, ta = ct.approx_weighted_matching(Gg)
    b, tb = ct.approx_weighted_matching(Gc)
    pd.testing.assert_frame_equal(a, b)
    assert ta == tb
    seeds = Gc.nodes()[:8]
    for x, y in zip(ct.batched_ego_graphs(Gg, seeds, 2),
                    ct.batched_ego_graphs(Gc, seeds, 2)):
        if isinstance(x, pd.DataFrame):
            pd.testing.assert_frame_equal(x, y)
        else:
            np.testing.assert_array_equal(x, y)
    keep = s < d
    Dg = ct.Graph(directed=True).from_edgelist(s[keep], d[keep])
    Dc = ct.Graph(directed=True, device="cpu").from_edgelist(s[keep],
                                                             d[keep])
    before = spmv.LAUNCHES_BY_COMBINE["left"]
    got = ct.topological_sort(Dg)
    assert spmv.LAUNCHES_BY_COMBINE["left"] - before == \
        got["level"].max() + 1
    pd.testing.assert_frame_equal(got, ct.topological_sort(Dc))
