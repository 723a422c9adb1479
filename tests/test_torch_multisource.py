"""The port's multi-source slice end to end: multi_source_bfs,
concurrent_bfs and od_shortest_distances in cugraph_tpu_torch against
cugraph_tpu, on the same graphs, on the CPU.

BFS distances and predecessors must be equal on both of the JAX package's
routes: the distances are integers from 0/1 masks, and the predecessors
come from the same pass over the same edge order (the port's on the
graph's device, held bit for bit against the JAX package's NumPy write,
parallel edges included).  The OD distances
must be equal to the XLA route's when unweighted (integers) and when
weighted: both run the same Jacobi Bellman-Ford rounds, min is exact, and
each candidate is one float32 sum.  The Pallas route stops its weighted
rounds at a relative improvement of 1e-6 because its split precision is
inexact, so there the weighted distances are held within rtol 2^-15.
The Pallas route runs in interpret mode on graphs of at most 60 vertices.
"""

import os

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import torch

import cugraph_tpu as ctpu

import cugraph_tpu_torch as ct
from cugraph_tpu_torch.algos import traversal
from cugraph_tpu_torch.api import convenience
from cugraph_tpu_torch.kernels import spmm, spmv

torch.set_num_threads(1)
PALLAS_OD_RTOL = 2.0 ** -15
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cugraph_tpu", "datasets", "data")


def _edges(kind):
    """(src, dst, weights, directed)."""
    if kind == "karate":
        e = np.array(list(nx.karate_club_graph().edges()))
        w = np.random.default_rng(1).uniform(0.5, 2.0, len(e))
        return e[:, 0], e[:, 1], w.astype(np.float32), False
    if kind in ("netscience", "email-Eu-core"):
        a = np.loadtxt(os.path.join(DATA, f"{kind}.csv"))
        return (a[:, 0].astype(np.int64), a[:, 1].astype(np.int64),
                a[:, 2].astype(np.float32), kind == "email-Eu-core")
    # "random<n>": directed, weighted, 3n edges, so that many pairs are
    # unreachable
    n = int(kind[len("random"):])
    rng = np.random.default_rng(n)
    src, dst = rng.integers(0, n, 3 * n), rng.integers(0, n, 3 * n)
    keep = src != dst
    w = (0.25 + rng.random(keep.sum())).astype(np.float32)
    return src[keep], dst[keep], w, True


def _pair(kind, weighted=False):
    src, dst, w, directed = _edges(kind)
    w = w if weighted else None
    Gj = ctpu.Graph(directed=directed).from_edgelist(src, dst, w)
    Gt = ct.Graph(directed=directed, device="cpu").from_edgelist(src, dst, w)
    return Gj, Gt


def _sources(G, k):
    """k external ids spread over the id range."""
    verts = G.number_map.to_external(np.arange(G.number_of_vertices()))
    return verts[::max(1, len(verts) // k)][:k]


@pytest.mark.parametrize("depth_limit", [None, 2])
@pytest.mark.parametrize("kind", ["karate", "email-Eu-core", "netscience",
                                  "random300"])
def test_multi_source_bfs_matches_jax_xla_route(kind, depth_limit):
    Gj, Gt = _pair(kind)
    sources = _sources(Gt, 5)
    got = ct.multi_source_bfs(Gt, sources, depth_limit=depth_limit)
    pd.testing.assert_frame_equal(got, ctpu.multi_source_bfs(
        Gj, sources, depth_limit=depth_limit, strategy="panel"))
    run = traversal.LAST_RUN
    assert run["panels"] == 1 and run["syncs"] == run["levels"][0]


@pytest.mark.parametrize("kind", ["karate", "random300"])
def test_strategies_give_the_same_frame(kind):
    """"serial" (K1, one source at a time) and "auto" (the K4 panel) give
    the same frames, weighted or not, over more than one panel."""
    for weighted in (False, True):
        _, Gt = _pair(kind, weighted)
        sources = _sources(Gt, 130 if kind == "random300" else 6)
        auto = ct.multi_source_bfs(Gt, sources)
        assert traversal.LAST_RUN["panels"] == -(-len(sources) // 128)
        serial = ct.multi_source_bfs(Gt, sources, strategy="serial")
        assert len(traversal.LAST_RUN["levels"]) == len(sources)
        pd.testing.assert_frame_equal(serial, auto)
        pd.testing.assert_frame_equal(
            ct.multi_source_bfs(Gt, sources, depth_limit=1,
                                strategy="serial"),
            ct.multi_source_bfs(Gt, sources, depth_limit=1,
                                strategy="panel"))


def test_multi_source_bfs_errors_match_jax():
    Gj, Gt = _pair("karate")
    for pkg, G in ((ct, Gt), (ctpu, Gj)):
        with pytest.raises(ValueError, match="strategy"):
            pkg.multi_source_bfs(G, [0], strategy="bidirectional")
        with pytest.raises(NotImplementedError, match="offload"):
            pkg.multi_source_bfs(G, [0], offload=True)
        with pytest.raises(ValueError, match="not in graph"):
            pkg.multi_source_bfs(G, [1000])
        with pytest.raises(ValueError, match="same length"):
            pkg.concurrent_bfs([G, G], [[0]])


def test_concurrent_bfs_matches_jax():
    Gj1, Gt1 = _pair("karate")
    Gj2, Gt2 = _pair("random300")
    sources = [[0, 5], _sources(Gt2, 3)]
    got = ct.concurrent_bfs([Gt1, Gt2], sources, depth_limit=3)
    want = ctpu.concurrent_bfs([Gj1, Gj2], sources, depth_limit=3)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        pd.testing.assert_frame_equal(a, b)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", ["karate", "email-Eu-core", "random300"])
def test_od_matches_jax_xla_route(kind, weighted):
    Gj, Gt = _pair(kind, weighted)
    origins = _sources(Gt, 7)
    dests = _sources(Gt, 11)[::-1]
    got = ct.od_shortest_distances(Gt, origins, dests)
    pd.testing.assert_frame_equal(
        got, ctpu.od_shortest_distances(Gj, origins, dests))
    run = traversal.LAST_RUN
    assert run["syncs"] == sum(run["iterations" if weighted else "levels"])
    if kind == "random300":
        assert (got["distance"] == np.float32(np.finfo(np.float32).max)).any()


def test_od_over_several_panels():
    Gj, Gt = _pair("random300", weighted=True)
    origins = _sources(Gt, 140)
    dests = _sources(Gt, 9)
    got = ct.od_shortest_distances(Gt, origins, dests)
    assert traversal.LAST_RUN["panels"] == 2
    pd.testing.assert_frame_equal(
        got, ctpu.od_shortest_distances(Gj, origins, dests))


def _small(weighted):
    """A directed graph of 60 vertices and ~180 edges, with unreachable
    pairs."""
    rng = np.random.default_rng(60)
    src, dst = rng.integers(0, 60, 180), rng.integers(0, 60, 180)
    keep = src != dst
    w = (0.25 + rng.random(keep.sum())).astype(np.float32) if weighted \
        else None
    return (ctpu.Graph(directed=True).from_edgelist(src[keep], dst[keep], w),
            ct.Graph(directed=True, device="cpu").from_edgelist(
                src[keep], dst[keep], w))


def test_match_jax_pallas_interpret(monkeypatch):
    monkeypatch.setenv("CUGRAPH_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("CUGRAPH_TPU_PALLAS_MIN_EDGES", "1")
    Gj, Gt = _small(weighted=False)
    sources = _sources(Gt, 4)
    for dl in (None, 2):
        pd.testing.assert_frame_equal(
            ct.multi_source_bfs(Gt, sources, depth_limit=dl),
            ctpu.multi_source_bfs(Gj, sources, depth_limit=dl,
                                  strategy="panel"))
    dests = _sources(Gt, 10)
    got = ct.od_shortest_distances(Gt, sources, dests)
    pd.testing.assert_frame_equal(
        got, ctpu.od_shortest_distances(Gj, sources, dests))
    f32_max = np.float32(np.finfo(np.float32).max)
    assert (got["distance"] == f32_max).any()

    Gj, Gt = _small(weighted=True)
    got = ct.od_shortest_distances(Gt, sources, dests)
    want = ctpu.od_shortest_distances(Gj, sources, dests)
    pd.testing.assert_frame_equal(got.drop(columns="distance"),
                                  want.drop(columns="distance"))
    unreached = got["distance"] == f32_max
    np.testing.assert_array_equal(unreached, want["distance"] == f32_max)
    np.testing.assert_allclose(got["distance"][~unreached],
                               want["distance"][~unreached],
                               rtol=PALLAS_OD_RTOL)


def test_ids_past_two_to_the_sixteen():
    """A star of 70,000 leaves with a tail, on the XLA route only: the
    hub's id and the leaves' predecessors come back exactly."""
    leaves, hub = 70_000, 5_000_000
    src = np.concatenate([np.full(leaves, hub), np.arange(leaves),
                          [leaves - 1, leaves + 1]])
    dst = np.concatenate([np.arange(leaves), np.full(leaves, hub),
                          [leaves + 1, leaves + 2]])
    Gj = ctpu.Graph(directed=True).from_edgelist(src, dst, None)
    Gt = ct.Graph(directed=True, device="cpu").from_edgelist(src, dst, None)
    sources = [17, hub]
    got = ct.multi_source_bfs(Gt, sources)
    pd.testing.assert_frame_equal(
        got, ctpu.multi_source_bfs(Gj, sources, strategy="panel"))
    row = got.set_index("vertex")
    assert row.loc[leaves + 2, "predecessor_17"] == leaves + 1
    assert row.loc[12_345, "predecessor_17"] == hub
    assert row.loc[leaves + 2, f"distance_{hub}"] == 3
    dests = [hub, 12_345, leaves + 2]
    pd.testing.assert_frame_equal(
        ct.od_shortest_distances(Gt, sources, dests),
        ctpu.od_shortest_distances(Gj, sources, dests))


def test_cpu_runs_count_no_launch():
    _, Gt = _pair("karate", weighted=True)
    before = (dict(spmm.SPMM_LAUNCHES), dict(spmm.SPMM_SEMIRING_LAUNCHES),
              spmv.LAUNCHES)
    ct.multi_source_bfs(Gt, [0, 1])
    ct.multi_source_bfs(Gt, [0, 1], strategy="serial")
    ct.od_shortest_distances(Gt, [0, 1], [2, 3])
    assert (spmm.SPMM_LAUNCHES, spmm.SPMM_SEMIRING_LAUNCHES,
            spmv.LAUNCHES) == before


@pytest.mark.cuda
def test_slice_on_the_card_matches_cpu_and_counts_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    src, dst, w, directed = _edges("random300")
    Gc = ct.Graph(directed=directed, device="cpu").from_edgelist(src, dst, w)
    Gg = ct.Graph(directed=directed).from_edgelist(src, dst, w)
    sources = _sources(Gc, 20)
    before = dict(spmm.SPMM_LAUNCHES), dict(spmm.SPMM_SEMIRING_LAUNCHES)
    got = ct.multi_source_bfs(Gg, sources)
    assert spmm.SPMM_LAUNCHES["unit"] - before[0]["unit"] == \
        traversal.LAST_RUN["levels"][0]
    pd.testing.assert_frame_equal(got, ct.multi_source_bfs(Gc, sources))
    got = ct.od_shortest_distances(Gg, sources, sources)
    assert spmm.SPMM_SEMIRING_LAUNCHES["min_add"] - before[1]["min_add"] == \
        traversal.LAST_RUN["iterations"][0]
    pd.testing.assert_frame_equal(
        got, ct.od_shortest_distances(Gc, sources, sources))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_predecessor_pass_keeps_the_last_edge_as_numpy(seed):
    """The device pass (scatter_reduce "amax" of edge positions, then a
    gather of src) equals the NumPy write pred[dst[ok]] = src[ok], which
    keeps the last matching edge: on edge lists with parallel edges,
    several parents one level up, unreached vertices and self-loops."""
    rng = np.random.default_rng(seed)
    n, m = 60, 400
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    src = np.concatenate([src, src[:50], dst[:10]])  # parallel edges
    dst = np.concatenate([dst, dst[:50], dst[:10]])  # and self-loops
    dist = rng.integers(-1, 4, n)
    got = convenience._predecessors(torch.from_numpy(src),
                                    torch.from_numpy(dst),
                                    torch.from_numpy(dist))
    want = convenience._predecessors_numpy(src, dst, dist)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 10


def test_multi_source_bfs_predecessors_equal_the_numpy_pass():
    _, Gt = _pair("email-Eu-core")
    sources = _sources(Gt, 5)
    df = ct.multi_source_bfs(Gt, sources)
    src, dst, _ = Gt.edgelist_arrays()
    for s in sources:
        dist = df[f"distance_{s}"].to_numpy().astype(np.int64)
        dist = np.where(dist == traversal.INT32_INF, -1, dist)
        want = convenience._predecessors_numpy(src.astype(np.int64),
                                               dst.astype(np.int64), dist)
        got = Gt.lookup_internal_vertex_id(
            df[f"predecessor_{s}"].to_numpy()[want >= 0])
        np.testing.assert_array_equal(got, want[want >= 0])
        assert (df[f"predecessor_{s}"].to_numpy()[want < 0] == -1).all()
