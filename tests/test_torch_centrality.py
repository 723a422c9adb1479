"""The port's centrality against cugraph_tpu, on the same graphs, on the
CPU: katz_centrality and eigenvector_centrality within atol 1e-6 of the
JAX package's XLA route and of its Pallas route in interpret mode (both
iterate in float32 and sum in other orders), degree_centrality exactly,
and betweenness_centrality and edge_betweenness_centrality from the same
sources.

Against the JAX package's XLA route the values agree within rtol 1e-5:
sigma counts paths, exact in float32 in any order, and delta is a sum of
positive fractions taken in another order (the port's plain K4 sums in
float64, XLA's segment_sum in float32).  The Pallas route runs in
interpret mode on graphs of at most 60 vertices, as the JAX package's own
tests run it; its split precision costs about 2^-16, so both packages are
held within atol 1e-4 of networkx there, as tests/test_centrality.py
holds the JAX package.
"""

import os

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import torch

import cugraph_tpu as ctpu

import cugraph_tpu_torch as ct
from cugraph_tpu_torch.algos import centrality
from cugraph_tpu_torch.kernels import spmm, spmv

torch.set_num_threads(1)
RTOL = 1e-5
NX_ATOL = 1e-4
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cugraph_tpu", "datasets", "data")


def _edges(kind):
    """(src, dst, weights or None, directed)."""
    if kind == "karate":
        e = np.array(list(nx.karate_club_graph().edges()))
        return e[:, 0], e[:, 1], None, False
    if kind == "netscience":
        a = np.loadtxt(os.path.join(DATA, "netscience.csv"))
        return (a[:, 0].astype(np.int64), a[:, 1].astype(np.int64),
                a[:, 2].astype(np.float32), False)
    # "random<n>": a directed graph of 4n edges without self-loops; 150
    # vertices need two 128-source panels
    n = int(kind[len("random"):])
    rng = np.random.default_rng(n)
    src, dst = rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n)
    keep = src != dst
    return src[keep], dst[keep], None, True


def _pair(kind):
    src, dst, w, directed = _edges(kind)
    Gj = ctpu.Graph(directed=directed).from_edgelist(src, dst, w)
    Gt = ct.Graph(directed=directed, device="cpu").from_edgelist(src, dst, w)
    return Gj, Gt


def _assert_vertex_close(got, want, rtol=RTOL, atol=0.0):
    got = got.sort_values("vertex").reset_index(drop=True)
    want = want.sort_values("vertex").reset_index(drop=True)
    assert list(got.columns) == list(want.columns)
    np.testing.assert_array_equal(got["vertex"], want["vertex"])
    col = "betweenness_centrality"
    assert got[col].dtype == want[col].dtype
    np.testing.assert_allclose(got[col], want[col], rtol=rtol, atol=atol)


def _assert_edge_close(got, want, rtol=RTOL, atol=0.0):
    got = got.sort_values(["src", "dst"]).reset_index(drop=True)
    want = want.sort_values(["src", "dst"]).reset_index(drop=True)
    pd.testing.assert_frame_equal(got[["src", "dst"]], want[["src", "dst"]])
    col = "betweenness_centrality"
    assert got[col].dtype == want[col].dtype
    np.testing.assert_allclose(got[col], want[col], rtol=rtol, atol=atol)


OPTIONS = {"default": {}, "unnormalized": dict(normalized=False),
           "endpoints": dict(endpoints=True),
           "k_sampled": dict(k=20, seed=3),
           "k_random_state": dict(k=12, random_state=5),
           "k_list": dict(k=[0, 2, 4, 6, 8, 10, 12])}


@pytest.mark.parametrize("opt", list(OPTIONS))
@pytest.mark.parametrize("kind", ["karate", "netscience", "random80",
                                  "random150"])
def test_betweenness_matches_jax_xla_route(kind, opt):
    Gj, Gt = _pair(kind)
    kw = OPTIONS[opt]
    _assert_vertex_close(ct.betweenness_centrality(Gt, **kw),
                         ctpu.betweenness_centrality(Gj, **kw))
    run = centrality.LAST_RUN
    if "k" not in kw:
        assert run["panels"] == -(-Gt.number_of_vertices() // 128)
    assert run["syncs"] == sum(run["levels"])


@pytest.mark.parametrize("opt", ["default", "unnormalized", "k_sampled",
                                 "k_list"])
@pytest.mark.parametrize("kind", ["karate", "netscience", "random80",
                                  "random150"])
def test_edge_betweenness_matches_jax_xla_route(kind, opt):
    Gj, Gt = _pair(kind)
    kw = {k: v for k, v in OPTIONS[opt].items() if k != "random_state"}
    _assert_edge_close(ct.edge_betweenness_centrality(Gt, **kw),
                       ctpu.edge_betweenness_centrality(Gj, **kw))


def _small_directed(n, m, seed):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    Gnx = nx.DiGraph()
    Gnx.add_nodes_from(np.unique(np.concatenate([src, dst])).tolist())
    Gnx.add_edges_from(zip(src.tolist(), dst.tolist()))
    return src, dst, Gnx


def test_match_jax_pallas_interpret_and_networkx(monkeypatch):
    """The Pallas route of the JAX package (interpreted SpMM, split
    precision) and the port agree with networkx within atol 1e-4, on the
    graphs of tests/test_centrality.py:131-163."""
    monkeypatch.setenv("CUGRAPH_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("CUGRAPH_TPU_PALLAS_MIN_EDGES", "1")
    src, dst, Gnx = _small_directed(60, 240, 11)
    Gj = ctpu.Graph(directed=True).from_edgelist(src, dst, None)
    Gt = ct.Graph(directed=True, device="cpu").from_edgelist(src, dst, None)
    got = ct.betweenness_centrality(Gt)
    _assert_vertex_close(got, ctpu.betweenness_centrality(Gj), rtol=0,
                         atol=NX_ATOL)
    ref = nx.betweenness_centrality(Gnx, normalized=True)
    for v, val in zip(got["vertex"], got["betweenness_centrality"]):
        assert abs(val - ref[v]) < NX_ATOL

    src, dst, Gnx = _small_directed(50, 200, 4)
    Gj = ctpu.Graph(directed=True).from_edgelist(src, dst, None)
    Gt = ct.Graph(directed=True, device="cpu").from_edgelist(src, dst, None)
    got = ct.edge_betweenness_centrality(Gt)
    _assert_edge_close(got, ctpu.edge_betweenness_centrality(Gj), rtol=0,
                       atol=NX_ATOL)
    ref = nx.edge_betweenness_centrality(Gnx, normalized=True)
    assert len(got) == len(ref)
    for s, d, val in zip(got["src"], got["dst"],
                         got["betweenness_centrality"]):
        assert abs(val - ref[(s, d)]) < NX_ATOL


def test_undirected_matches_networkx():
    e = np.array(list(nx.karate_club_graph().edges()))
    Gt = ct.Graph(device="cpu").from_edgelist(e[:, 0], e[:, 1], None)
    Gnx = nx.Graph()
    Gnx.add_edges_from(e.tolist())
    for kw in ({}, dict(normalized=False), dict(endpoints=True)):
        got = ct.betweenness_centrality(Gt, **kw)
        ref = nx.betweenness_centrality(Gnx, **kw)
        for v, val in zip(got["vertex"], got["betweenness_centrality"]):
            # float32 values: 1e-5 relative to the larger of 1 and the value
            assert abs(val - ref[v]) < 1e-5 * max(1.0, ref[v]), (kw, v)
    got = ct.edge_betweenness_centrality(Gt, normalized=False)
    ref = nx.edge_betweenness_centrality(Gnx, normalized=False)
    ref = {tuple(sorted(e)): v for e, v in ref.items()}
    assert len(got) == len(ref)
    for s, d, val in zip(got["src"], got["dst"],
                         got["betweenness_centrality"]):
        assert abs(val - ref[(s, d)]) < 1e-3


def test_weight_raises_like_jax():
    Gj, Gt = _pair("karate")
    for pkg, G in ((ct, Gt), (ctpu, Gj)):
        with pytest.raises(NotImplementedError, match="weighted"):
            pkg.betweenness_centrality(G, weight="weight")
        with pytest.raises(NotImplementedError, match="weighted"):
            pkg.edge_betweenness_centrality(G, weight="weight")


def test_cpu_run_counts_no_launch_and_one_sync_per_level():
    _, Gt = _pair("random80")
    before = dict(spmm.SPMM_LAUNCHES)
    ct.betweenness_centrality(Gt, k=[0, 1, 2])
    assert spmm.SPMM_LAUNCHES == before
    run = dict(centrality.LAST_RUN)
    assert run["panels"] == 1 and run["syncs"] == run["levels"][0] >= 2


@pytest.mark.cuda
def test_slice_on_the_card_matches_cpu_and_counts_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    src, dst, w, directed = _edges("random150")
    Gc = ct.Graph(directed=directed, device="cpu").from_edgelist(src, dst, w)
    Gg = ct.Graph(directed=directed).from_edgelist(src, dst, w)
    before = spmm.SPMM_LAUNCHES["unit"]
    got = ct.betweenness_centrality(Gg)
    levels = centrality.LAST_RUN["levels"]
    # one pull per forward level and one push per backward level
    assert spmm.SPMM_LAUNCHES["unit"] - before == 2 * sum(levels)
    _assert_vertex_close(got, ct.betweenness_centrality(Gc))
    _assert_edge_close(ct.edge_betweenness_centrality(Gg),
                       ct.edge_betweenness_centrality(Gc))


# -- Katz, eigenvector, degree ------------------------------------------------

POWER_ATOL = 1e-6


def _power_edges(kind):
    if kind in ("karate", "netscience"):
        return _edges(kind)
    if kind == "email-Eu-core":
        a = np.loadtxt(os.path.join(DATA, "email-Eu-core.csv"))
        return a[:, 0].astype(np.int64), a[:, 1].astype(np.int64), None, True
    if kind == "rmat12":
        e = ctpu.rmat(12, 16 << 12, seed=12)
        return e["src"].to_numpy(), e["dst"].to_numpy(), None, True
    return _edges(kind)  # "random<n>": directed, 4n edges


def _power_pair(kind, directed=None):
    src, dst, w, d = _power_edges(kind)
    d = d if directed is None else directed
    return (ctpu.Graph(directed=d).from_edgelist(src, dst, w),
            ct.Graph(directed=d, device="cpu").from_edgelist(src, dst, w))


def _assert_values_close(got, want, col, atol=POWER_ATOL):
    got = got.sort_values("vertex").reset_index(drop=True)
    want = want.sort_values("vertex").reset_index(drop=True)
    assert list(got.columns) == list(want.columns) == ["vertex", col]
    np.testing.assert_array_equal(got["vertex"], want["vertex"])
    assert got[col].dtype == want[col].dtype
    np.testing.assert_allclose(got[col], want[col], rtol=0, atol=atol)


@pytest.mark.parametrize("kind", ["karate", "netscience", "email-Eu-core",
                                  "rmat12", "random80"])
def test_katz_and_eigenvector_match_jax_xla_route(kind):
    Gj, Gt = _power_pair(kind)
    _assert_values_close(ct.katz_centrality(Gt), ctpu.katz_centrality(Gj),
                         "katz_centrality")
    assert centrality.LAST_RUN["algo"] == "katz"
    kw = dict(max_iter=1000) if kind == "random80" else {}
    _assert_values_close(ct.eigenvector_centrality(Gt, **kw),
                         ctpu.eigenvector_centrality(Gj, **kw),
                         "eigenvector_centrality")
    # undirected: the eigenvector of the symmetric CSC
    Gj, Gt = _power_pair(kind, directed=False)
    _assert_values_close(ct.eigenvector_centrality(Gt),
                         ctpu.eigenvector_centrality(Gj),
                         "eigenvector_centrality")


def test_katz_options_match_jax():
    Gj, Gt = _power_pair("email-Eu-core")
    n = Gt.number_of_vertices()
    rng = np.random.default_rng(1)
    beta = rng.uniform(0.5, 1.5, n).astype(np.float32)
    nstart = pd.DataFrame({"vertex": Gt.number_map.to_external(np.arange(n)),
                           "values": rng.random(n).astype(np.float32)})
    for kw in (dict(alpha=0.002), dict(beta=0.5), dict(beta=beta),
               dict(beta=beta[:n // 2]), dict(nstart=nstart),
               dict(normalized=False, tol=1e-7), dict(precision="fast")):
        _assert_values_close(ct.katz_centrality(Gt, **kw),
                             ctpu.katz_centrality(Gj, **kw),
                             "katz_centrality")


def test_power_methods_raise_like_jax():
    Gj, Gt = _power_pair("karate")
    for fn in ("katz_centrality", "eigenvector_centrality"):
        with pytest.raises(ct.FailedToConvergeError):
            getattr(ct, fn)(Gt, max_iter=2)
        with pytest.raises(ctpu.FailedToConvergeError):
            getattr(ctpu, fn)(Gj, max_iter=2)
        with pytest.raises(ValueError, match="precision"):
            getattr(ct, fn)(Gt, precision="double")
    ct.katz_centrality(Gt, max_iter=50)
    assert 2 < centrality.LAST_RUN["iterations"] <= 50


@pytest.mark.parametrize("kind", ["karate", "random80"])
def test_katz_and_eigenvector_match_jax_pallas_interpret(kind, monkeypatch):
    monkeypatch.setenv("CUGRAPH_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("CUGRAPH_TPU_PALLAS_MIN_EDGES", "1")
    Gj, Gt = _power_pair(kind)
    _assert_values_close(ct.katz_centrality(Gt), ctpu.katz_centrality(Gj),
                         "katz_centrality")
    Gj, Gt = _power_pair(kind, directed=False)
    _assert_values_close(ct.eigenvector_centrality(Gt),
                         ctpu.eigenvector_centrality(Gj),
                         "eigenvector_centrality")


@pytest.mark.parametrize("kind", ["karate", "netscience", "email-Eu-core",
                                  "random80"])
def test_degree_centrality_and_degrees_match_jax_exactly(kind):
    Gj, Gt = _power_pair(kind)
    for normalized in (True, False):
        pd.testing.assert_frame_equal(
            ct.degree_centrality(Gt, normalized=normalized),
            ctpu.degree_centrality(Gj, normalized=normalized))
    ids = Gt.number_map.to_external(np.arange(5))
    for fn in ("in_degree", "out_degree", "degree"):
        pd.testing.assert_frame_equal(getattr(Gt, fn)(), getattr(Gj, fn)())
        pd.testing.assert_frame_equal(getattr(Gt, fn)(ids),
                                      getattr(Gj, fn)(ids))


def test_undirected_self_loop_counts_once_as_in_jax():
    src, dst = np.array([0, 0, 1]), np.array([0, 1, 2])
    Gt = ct.Graph(device="cpu").from_edgelist(src, dst)
    Gj = ctpu.Graph().from_edgelist(src, dst)
    deg = Gt.degree().set_index("vertex")["degree"]
    assert deg.to_dict() == {0: 2, 1: 2, 2: 1}
    pd.testing.assert_frame_equal(Gt.degree(), Gj.degree())


@pytest.mark.cuda
def test_power_methods_on_the_card_match_cpu_and_count_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    src, dst, w, directed = _power_edges("rmat12")
    Gc = ct.Graph(directed=directed, device="cpu").from_edgelist(src, dst)
    Gg = ct.Graph(directed=directed).from_edgelist(src, dst)
    before = spmv.LAUNCHES_BY_COMBINE["mul"]
    got = ct.katz_centrality(Gg)
    assert spmv.LAUNCHES_BY_COMBINE["mul"] - before == \
        centrality.LAST_RUN["iterations"]
    _assert_values_close(got, ct.katz_centrality(Gc), "katz_centrality")
    Gc = ct.Graph(device="cpu").from_edgelist(src, dst)
    Gg = ct.Graph().from_edgelist(src, dst)
    before = spmv.LAUNCHES_BY_COMBINE["mul"]
    got = ct.eigenvector_centrality(Gg)
    assert spmv.LAUNCHES_BY_COMBINE["mul"] - before == \
        centrality.LAST_RUN["iterations"]
    _assert_values_close(got, ct.eigenvector_centrality(Gc),
                         "eigenvector_centrality")
