"""The port's core_number and k_core against cugraph_tpu on the CPU.

Core numbers come from the same exact peel in both packages, so they must
be equal as integers, for every degree_type on directed graphs and on
undirected ones, and equal to the JAX package's XLA h-index fixpoint
(its route without the native library) where that fixpoint agrees with
the peel: on graphs without self-loops.  k_core must give the same edges
and the same vertex set, edgeless qualifying vertices included.
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
from cugraph_tpu_torch.algos import cores

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cugraph_tpu", "datasets", "data")


def _edges(kind):
    """(src, dst, directed)."""
    if kind == "karate":
        e = np.array(list(nx.karate_club_graph().edges()))
        return e[:, 0], e[:, 1], False
    if kind in ("netscience", "email-Eu-core"):
        a = np.loadtxt(os.path.join(DATA, f"{kind}.csv"))
        return (a[:, 0].astype(np.int64), a[:, 1].astype(np.int64),
                kind == "email-Eu-core")
    if kind.startswith("rmat"):
        e = ctpu.rmat(int(kind[4:]), 8 << int(kind[4:]), seed=4)
        return e["src"].to_numpy(), e["dst"].to_numpy(), True
    rng = np.random.default_rng(13)   # "random_loops": self-loops too
    src = rng.integers(0, 120, 900)
    dst = np.where(rng.random(900) < 0.05, src, rng.integers(0, 120, 900))
    return src, dst, kind.endswith("directed")


def _pair(kind, directed=None):
    src, dst, d = _edges(kind)
    d = d if directed is None else directed
    return (ctpu.Graph(directed=d).from_edgelist(src, dst),
            ct.Graph(directed=d, device="cpu").from_edgelist(src, dst))


def _without_native(fn):
    saved = jnative._lib, jnative._tried
    jnative._lib, jnative._tried = None, True
    try:
        return fn()
    finally:
        jnative._lib, jnative._tried = saved


@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("kind", ["karate", "netscience", "email-Eu-core",
                                  "rmat11", "random_loops"])
def test_core_number_matches_jax_every_degree_type(kind, directed):
    Gj, Gt = _pair(kind, directed)
    for dt in cores.DEGREE_TYPES:
        got = ct.core_number(Gt, degree_type=dt)
        want = ctpu.core_number(Gj, degree_type=dt)
        pd.testing.assert_frame_equal(got, want)
        assert got["core_number"].dtype == np.int32


@pytest.mark.parametrize("kind", ["karate", "netscience", "rmat10"])
def test_core_number_matches_jax_h_index_route(kind):
    """Without self-loops the JAX package's XLA fixpoint gives the same
    numbers as the peel: undirected, and directed "incoming"/"outgoing"."""
    src, dst, directed = _edges(kind)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    Gt = ct.Graph(directed=directed, device="cpu").from_edgelist(src, dst)
    Gj = ctpu.Graph(directed=directed).from_edgelist(src, dst)
    for dt in (("incoming", "outgoing") if directed else ("bidirectional",)):
        want = _without_native(lambda: ctpu.core_number(Gj, degree_type=dt))
        pd.testing.assert_frame_equal(ct.core_number(Gt, degree_type=dt),
                                      want)


def test_core_number_matches_networkx():
    Gnx = nx.karate_club_graph()
    e = np.array(list(Gnx.edges()))
    Gt = ct.Graph(device="cpu").from_edgelist(e[:, 0], e[:, 1])
    got = ct.core_number(Gt).set_index("vertex")["core_number"].to_dict()
    assert got == nx.core_number(Gnx)
    with pytest.raises(ValueError, match="degree_type"):
        ct.core_number(Gt, degree_type="sideways")


def _edge_set(G):
    s, d, w = G.edgelist_arrays()
    ext = G.number_map.to_external
    order = np.lexsort((ext(d), ext(s)))
    return (ext(s)[order], ext(d)[order],
            None if w is None else w[order])


@pytest.mark.parametrize("k", [None, 0, 2, 4])
@pytest.mark.parametrize("kind", ["karate", "netscience", "rmat10"])
def test_k_core_matches_jax(kind, k):
    Gj, Gt = _pair(kind)
    got = ct.k_core(Gt, k=k)
    want = ctpu.k_core(Gj, k=k)
    assert got.device == Gt.device and got.is_directed() == Gt.is_directed()
    assert got.number_of_vertices() == want.number_of_vertices()
    assert got.number_of_edges() == want.number_of_edges()
    for g, w in zip(_edge_set(got), _edge_set(want)):
        np.testing.assert_array_equal(g, w)
    n = want.number_of_vertices()
    np.testing.assert_array_equal(
        np.sort(got.number_map.to_external(np.arange(n))),
        np.sort(want.number_map.to_external(np.arange(n))))


def test_k_core_keeps_edgeless_qualifying_vertices():
    G = ct.Graph(device="cpu").from_edgelist(
        np.array([0]), np.array([1]), vertices=np.array([0, 1, 2]))
    out = ct.k_core(G, k=0)
    assert out.number_of_vertices() == 3 and out.number_of_edges() == 1
    out1 = ct.k_core(G, k=1)
    assert out1.number_of_vertices() == 2 and out1.number_of_edges() == 1
    # a weighted triangle with a pendant: the 2-core keeps the weights
    G = ct.Graph(device="cpu").from_edgelist(
        np.array([0, 1, 2, 2]), np.array([1, 2, 0, 3]),
        np.array([1.5, 2.5, 3.5, 4.5], np.float32))
    out = ct.k_core(G, core_number_df=ct.core_number(G))
    assert sorted(out.number_map.to_external(
        np.arange(out.number_of_vertices())).tolist()) == [0, 1, 2]
    _, _, w = _edge_set(out)
    assert sorted(set(w.tolist())) == [1.5, 2.5, 3.5]


@pytest.mark.cuda
def test_cores_on_the_card_match_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    src, dst, directed = _edges("rmat11")
    Gc = ct.Graph(device="cpu").from_edgelist(src, dst)
    Gg = ct.Graph().from_edgelist(src, dst)
    pd.testing.assert_frame_equal(ct.core_number(Gg), ct.core_number(Gc))
    out = ct.k_core(Gg)
    assert out.device.type == "cuda"
    for g, w in zip(_edge_set(out), _edge_set(ct.k_core(Gc))):
        np.testing.assert_array_equal(g, w)
