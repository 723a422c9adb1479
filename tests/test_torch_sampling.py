"""The port's neighbour sampling, its primitives and ``negative_sampling``
against cugraph_tpu on the CPU.

Fed the JAX package's own draws (``tests/torch_port_draws.py``), the
port's cores give its arrays and frames bit for bit: ``_sample_neighbors``
in all four (replacement x bias) cases, the NumPy engines, the frontier
rules and every sampler flag, and ``negative_sampling``.  The JAX package
is called with its neighbour tables off (``_fetch_tables`` -> None), so
both walk the CSR; its own tests show that the table routes agree.  The
per-edge sorted route of sampling without replacement is held against
the NumPy engine's sort path with the same per-edge keys, bit for bit.
``per_v_random_select`` is held against a NumPy argmax per row when its
priorities are fed, and with the port's own draws by validity, a χ²
test on the hub, a χ² summed over many rows and one over bins of the
hub's edges (``cugraph_tpu_torch.testing.picks``, whose power against a
select confined to part of a row is checked too); the JAX package's
interpret-mode picks pass the same validity check.  The bulk route is
checked the same ways and is never taken by the samplers.  The port's own generator is checked distributionally: a
χ² test of uniform picks, a frequency test of weight-proportional picks,
distinct picks without replacement.
"""

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import cugraph_tpu as ctpu
from cugraph_tpu.algos import _frontier as jfrontier
from cugraph_tpu.algos import sampling as jS
from cugraph_tpu.prims import intersection as jI

import cugraph_tpu_torch as ct
from cugraph_tpu_torch.algos import _frontier as tfrontier
from cugraph_tpu_torch.algos import sampling as tS
from cugraph_tpu_torch.kernels import dispatch
from cugraph_tpu_torch.prims import intersection as tI
from cugraph_tpu_torch.testing import picks as picks_chi2
from torch_port_draws import CpuDraws, JaxDraws, JaxKeyDraws

torch.set_num_threads(1)


def _rmat_like(scale, m, seed):
    """R-MAT quadrant recursion (a, b, c = .57, .19, .19) in NumPy."""
    rng = np.random.default_rng(seed)
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for bit in range(scale):
        r = rng.random(m)
        src |= (r >= 0.76).astype(np.int64) << bit
        dst |= (((r >= 0.57) & (r < 0.76)) | (r >= 0.95)).astype(np.int64) \
            << bit
    return src, dst


def _graph(kind):
    """(src, dst, weights or None, directed), external ids."""
    if kind == "karate":
        e = np.array(list(nx.karate_club_graph().edges()))
        return e[:, 0], e[:, 1], None, False
    if kind == "rmat10w":
        src, dst = _rmat_like(10, 8000, 3)
        w = np.random.default_rng(4).uniform(0.1, 3.0, len(src))
        w[::17] = 0.0  # zero-weight edges are never picked when biased
        return src * 3 + 5, dst * 3 + 5, w.astype(np.float32), True
    if kind == "rmat12":
        src, dst = _rmat_like(12, 40000, 5)
        w = np.random.default_rng(6).uniform(0.5, 2.0, len(src))
        return src, dst, w.astype(np.float32), True
    raise KeyError(kind)


def _pair(kind, weighted=True):
    src, dst, w, directed = _graph(kind)
    w = w if weighted else None
    return (ctpu.Graph(directed=directed).from_edgelist(src, dst, w),
            ct.Graph(directed=directed, device="cpu").from_edgelist(src, dst,
                                                                    w))


@pytest.fixture
def no_tables(monkeypatch):
    """The JAX package walks its CSR, as the port always does."""
    monkeypatch.setattr(jS, "_fetch_tables", lambda *a, **k: None)


def _max_deg(Gt):
    return tS._max_out_degree(Gt.structure)


# -- prims/intersection -------------------------------------------------------

@pytest.mark.parametrize("kind", ["karate", "rmat10w"])
def test_lower_bound_rows_matches_jax(kind):
    Gj, Gt = _pair(kind)
    n = Gt.number_of_vertices()
    rng = np.random.default_rng(1)
    rows = rng.integers(0, n, 3000).astype(np.int32)
    src, dst, _ = Gt.edgelist_arrays()
    queries = rng.integers(0, n, 3000).astype(np.int32)
    queries[:1000] = dst[rng.integers(0, len(dst), 1000)]
    rows[:1000] = src[np.searchsorted(dst, queries[:1000]) % len(src)]
    e = rng.integers(0, len(src), 500)
    rows[1000:1500] = src[e]           # every query an edge
    queries[1000:1500] = dst[e]
    fj, pj = jI.lower_bound_rows(Gj.structure.csr, jnp.asarray(rows),
                                 jnp.asarray(queries))
    ft, pt = tI.lower_bound_rows(Gt.structure.csr, torch.from_numpy(rows),
                                 torch.from_numpy(queries))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert ft.numpy()[1000:1500].all() and not ft.numpy().all()


@pytest.mark.parametrize("kind", ["karate", "rmat10w"])
def test_enumerate_neighbors_matches_jax(kind):
    Gj, Gt = _pair(kind)
    n = Gt.number_of_vertices()
    verts = np.random.default_rng(2).integers(0, n, 200).astype(np.int32)
    verts[0] = n - 1
    D = _max_deg(Gt)
    nj, vj, ej = jI.enumerate_neighbors(Gj.structure.csr, jnp.asarray(verts),
                                        D)
    nt, vt, et = tI.enumerate_neighbors(Gt.structure.csr,
                                        torch.from_numpy(verts), D)
    valid = np.asarray(vj)
    np.testing.assert_array_equal(vt.numpy(), valid)
    np.testing.assert_array_equal(nt.numpy()[valid], np.asarray(nj)[valid])
    np.testing.assert_array_equal(et.numpy()[valid], np.asarray(ej)[valid])


def test_host_csr_is_cached_and_matches_jax():
    Gj, Gt = _pair("rmat10w")
    off_j, ind_j, w_j = jI._host_csr(Gj.structure.csr, True)
    got = tI._host_csr(Gt.structure.csr, False)
    assert got[2] is None
    got = tI._host_csr(Gt.structure.csr, True)
    assert tI._host_csr(Gt.structure.csr, True) is got
    m, n = len(got[1]), Gt.number_of_vertices()
    np.testing.assert_array_equal(got[0], off_j[:n + 1])
    np.testing.assert_array_equal(got[1], ind_j[:m])
    np.testing.assert_array_equal(got[2], w_j[:m])


# -- algos/_frontier ----------------------------------------------------------

@pytest.mark.parametrize("behavior", ["default", "carry_over", "carryover",
                                      "exclude"])
@pytest.mark.parametrize("dedupe", [False, True])
def test_frontier_state_matches_jax(behavior, dedupe):
    rng = np.random.default_rng(3)
    v0 = rng.integers(0, 40, 12).astype(np.int32)
    b0 = rng.integers(0, 3, 12).astype(np.int32)
    states = [mod.FrontierState(v0, b0, 40, prior_sources_behavior=behavior,
                                dedupe_sources=dedupe)
              for mod in (jfrontier, tfrontier)]
    for _ in range(4):
        hops = [s.begin_hop() for s in states]
        for a, b in zip(*hops):
            np.testing.assert_array_equal(a, b)
        nv = rng.integers(0, 40, 30).astype(np.int32)
        nb = rng.integers(0, 3, 30).astype(np.int32)
        for s in states:
            s.advance(nv, nb)
        assert len(states[0]) == len(states[1])


def test_frontier_flags_and_temporal_helpers_match_jax():
    for mod in (jfrontier, tfrontier):
        with pytest.raises(ValueError, match="unknown prior_sources"):
            mod.FrontierState([1], [0], 4, prior_sources_behavior="bogus")
        with pytest.raises(ValueError, match="batch_id_list"):
            mod.FrontierState([1, 2], [0, 0], 4, batch_id_list=[0])
        with pytest.raises(ValueError, match="temporal_sampling"):
            mod.resolve_temporal_comparison("sideways")
    for kw in ({}, {"dedupe_sources": True}, {"deduplicate_sources": True},
               {"dedupe_sources": None, "deduplicate_sources": False}):
        assert tfrontier.pop_dedupe_sources(dict(kw)) == \
            jfrontier.pop_dedupe_sources(dict(kw))
    t = np.array([0.5, 1.0, 1.5, 2.0], np.float32)
    for c in tfrontier.TEMPORAL_COMPARISONS:
        assert tfrontier.resolve_temporal_comparison(c) == c
        np.testing.assert_array_equal(
            tfrontier.temporal_eligible(t, 1.0, c),
            jfrontier.temporal_eligible(t, 1.0, c))
    # temporal + dedupe keeps the earliest arrival per (batch, vertex)
    sj = jfrontier.FrontierState([3, 3, 4], [0, 0, 0], 8, dedupe_sources=True,
                                 times=[2.0, 1.0, 5.0])
    st = tfrontier.FrontierState([3, 3, 4], [0, 0, 0], 8, dedupe_sources=True,
                                 times=[2.0, 1.0, 5.0])
    for a, b in zip(sj.begin_hop(), st.begin_hop()):
        np.testing.assert_array_equal(a, b)


def test_sampling_flags_match_jax():
    for kw in ({}, {"dedupe_sources": False}, {"deduplicate_sources": True},
               {"prior_sources_behavior": "exclude", "return_hops": False,
                "batch_id_list": [0, 1], "unknown_kw": 3},
               {"prior_sources_behavior": None}):
        assert tS._sampling_flags(kw) == jS._sampling_flags(kw)
    tS._check_disjoint({"disjoint_sampling": False}, temporal=False)
    with pytest.raises(ValueError, match="disjoint"):
        tS._check_disjoint({"disjoint_sampling": False}, temporal=True)


# -- the sampling cores, fed the JAX package's draws --------------------------

def test_row_cumweights_matches_jax():
    Gj, Gt = _pair("rmat10w")
    want = np.asarray(jS._row_cumweights(Gj.structure))
    got = tS._row_cumweights(Gt.structure).numpy()
    np.testing.assert_array_equal(got, want[:len(got)])
    assert tS._cached_cumweights(Gt) is tS._cached_cumweights(Gt)


def _frontier(Gt, size, seed):
    """Vertices with repeats, a sink when there is one, and the hub."""
    n = Gt.number_of_vertices()
    deg = Gt.structure.out_degrees().numpy()
    fr = np.random.default_rng(seed).integers(0, n, size).astype(np.int32)
    fr[0] = int(np.argmax(deg))
    fr[1] = fr[2]
    if (deg == 0).any():
        fr[3] = int(np.flatnonzero(deg == 0)[0])
    return fr


@pytest.mark.parametrize("kind", ["karate", "rmat10w"])
@pytest.mark.parametrize("with_replacement", [True, False])
@pytest.mark.parametrize("biased", [False, True])
def test_sample_neighbors_matches_jax(kind, with_replacement, biased):
    """The four laws, bit for bit: floor(u·deg), the inverse CDF's 32-step
    search, and Gumbel top-k (uniform and log-weight shifted), on the
    reference's own u [F, k] and Gumbel tile."""
    Gj, Gt = _pair(kind)
    if biased and not Gt.is_weighted():
        Gj, Gt = _pair("rmat10w")
    fr = _frontier(Gt, 60, 7)
    D = _max_deg(Gt)
    k = 5
    key = jax.random.PRNGKey(11)
    cumw_j = jS._row_cumweights(Gj.structure) if biased else None
    cumw_t = tS._row_cumweights(Gt.structure) if biased else None
    dj, ej, vj = jS._sample_neighbors(Gj.structure, jnp.asarray(fr), key, k,
                                      with_replacement, biased, D, cumw_j,
                                      None)
    dt, et, vt = tS._sample_neighbors(Gt.structure,
                                      torch.from_numpy(fr.astype(np.int64)),
                                      JaxKeyDraws(key), k, with_replacement,
                                      biased, D, cumw_t)
    valid = np.asarray(vj)
    np.testing.assert_array_equal(vt.numpy(), valid)
    np.testing.assert_array_equal(dt.numpy()[valid], np.asarray(dj)[valid])
    np.testing.assert_array_equal(et.numpy()[valid], np.asarray(ej)[valid])
    assert valid.sum() > 100


@pytest.mark.parametrize("biased", [False, True])
def test_host_sample_without_replacement_matches_jax(biased):
    """The NumPy engine given the JAX package's seed: its sort path and,
    uniform, its shortcut for rows of degree >= max(4k², 2k)."""
    Gj, Gt = _pair("rmat12")
    fr = _frontier(Gt, 300, 8)
    deg = Gt.structure.out_degrees().numpy()
    k = 3
    assert (deg[fr] >= 4 * k * k).sum() >= 5    # the shortcut's rows
    key = jax.random.PRNGKey(5)
    want = jS._host_sample_without_replacement(Gj.structure, fr, key, k,
                                               biased)
    got = tS._host_sample_without_replacement(Gt.structure, fr,
                                              JaxKeyDraws(key).seed(), k,
                                              biased)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["karate", "rmat10w"])
@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("k", [1, 4, 50])
def test_sorted_route_matches_numpy_engine(kind, biased, k):
    """The per-edge sorted route on torch against the NumPy engine's sort
    path, the same float64 keys fed to both: identical arrays."""
    _, Gt = _pair(kind)
    if biased and not Gt.is_weighted():
        _, Gt = _pair("rmat10w")
    off, ind, w = tI._host_csr(Gt.structure.csr, True)
    fr = _frontier(Gt, 80, 9)
    total = int((off[fr + 1] - off[fr]).sum())
    keys = np.random.default_rng(13).gumbel(size=total)
    keys[::7] = keys[1::7][: len(keys[::7])]     # ties within rows
    want = tS._host_sample_wr_sorted(off, ind, w, fr, k, biased, 0,
                                     keys=keys)
    got = tS._sample_without_replacement_sorted(
        Gt.structure.csr, torch.from_numpy(fr.astype(np.int64)),
        torch.from_numpy(keys), k, biased)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


def test_host_sort_path_draws_the_jax_package_keys():
    """With no keys the sort path draws default_rng((seed0, 2)).gumbel, as
    the JAX package's does."""
    Gj, Gt = _pair("karate")
    off, ind, w = tI._host_csr(Gt.structure.csr, True)
    fr = np.arange(34, dtype=np.int32)
    want = jS._host_sample_wr_sorted(off, ind, w, fr, 3, False, 77)
    got = tS._host_sample_wr_sorted(off, ind, w, fr, 3, False, 77)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("with_rng", [False, True])
def test_eidx_lookup_matches_jax(with_rng):
    Gj, Gt = _pair("rmat10w")
    src, dst, _ = Gt.edgelist_arrays()
    pick = np.random.default_rng(4).integers(0, len(src), 500)
    rng = (lambda: np.random.default_rng(9)) if with_rng else (lambda: None)
    want = jS._eidx_lookup(Gj.structure, src[pick], dst[pick], rng=rng())
    got = tS._eidx_lookup(Gt.structure, src[pick], dst[pick], rng=rng())
    np.testing.assert_array_equal(got, want)
    ind = Gt.structure.csr.indices.numpy()
    np.testing.assert_array_equal(ind[got], dst[pick])


# -- whole frames -------------------------------------------------------------

FRAME_CASES = {
    "uniform_wr": ("karate", dict(with_replacement=True), [3, 2]),
    "uniform_wor": ("karate", dict(with_replacement=False), [4, 3]),
    "uniform_wor_rmat": ("rmat10w", dict(with_replacement=False), [5, 2]),
    "all_neighbours": ("karate", dict(), [2, -1]),
    "no_hops": ("rmat10w", dict(return_hops=False), [3, 3]),
    "batches": ("karate", dict(batch_id_list="two"), [3, 3]),
    "carry_over_dedupe": ("rmat10w", dict(prior_sources_behavior="carry_over",
                                          dedupe_sources=True), [2, 2, 2]),
    "exclude": ("karate", dict(prior_sources_behavior="exclude",
                               deduplicate_sources=True), [3, 3, 3]),
    "biased_wr": ("rmat10w", dict(biased=True), [4, 3]),
    "biased_wor": ("rmat10w", dict(biased=True, with_replacement=False),
                   [4, 3]),
}


@pytest.mark.parametrize("case", list(FRAME_CASES))
def test_neighbor_sample_frame_matches_jax(case, no_tables):
    kind, kw, fanouts = FRAME_CASES[case]
    kw = dict(kw)
    Gj, Gt = _pair(kind)
    seeds = Gt.nodes()[np.random.default_rng(2).integers(
        0, Gt.number_of_vertices(), 8)]
    if kw.get("batch_id_list") == "two":
        kw["batch_id_list"] = np.arange(8) % 2
    biased = kw.pop("biased", False)
    fn = (ctpu.homogeneous_biased_neighbor_sample if biased
          else ctpu.uniform_neighbor_sample)
    want = fn(Gj, seeds, fanouts, random_state=21, **kw)
    wr = kw.pop("with_replacement", True)
    got = tS._neighbor_sample(Gt, seeds, fanouts, wr, biased, 21,
                              draws=JaxDraws(21), **tS._sampling_flags(kw))
    assert len(want) > 10
    pd.testing.assert_frame_equal(got, want)


def test_public_samplers_agree_with_their_cores():
    _, Gt = _pair("rmat10w")
    seeds = Gt.nodes()[:6]
    a = ct.uniform_neighbor_sample(Gt, seeds, [3, 2], random_state=4)
    pd.testing.assert_frame_equal(
        a, tS._neighbor_sample(Gt, seeds, [3, 2], True, False, 4))
    pd.testing.assert_frame_equal(
        a, ct.homogeneous_uniform_neighbor_sample(Gt, seeds, [3, 2],
                                                  random_state=4))
    pd.testing.assert_frame_equal(
        a, ct.homogeneous_neighbor_sample(Gt, seeds, None, [3, 2],
                                          random_state=4))
    b = ct.homogeneous_biased_neighbor_sample(Gt, seeds, [3, 2],
                                              with_replacement=False,
                                              random_state=4)
    pd.testing.assert_frame_equal(
        b, ct.homogeneous_neighbor_sample(Gt, seeds, None, [3, 2],
                                          with_replacement=False,
                                          with_biases=True, random_state=4))
    c = ct.uniform_neighbor_sample(Gt, seeds, [3, 2],
                                   with_edge_properties=True, random_state=4)
    pd.testing.assert_frame_equal(a, c)
    _, Gu = _pair("karate")
    with pytest.raises(ValueError, match="edge weights"):
        ct.homogeneous_biased_neighbor_sample(Gu, [0], [2])
    empty = ct.uniform_neighbor_sample(Gt, seeds, [], random_state=4)
    assert list(empty.columns) == ["sources", "destinations", "weight",
                                   "hop_id", "batch_id"]


# -- the sorted and bulk routes, and the port's own draws ---------------------

def _valid_edges(G, df):
    src, dst, _ = G.edgelist_arrays()
    edges = set(zip(G.number_map.to_external(src).tolist(),
                    G.number_map.to_external(dst).tolist()))
    return all((s, d) in edges for s, d in zip(df["sources"].tolist(),
                                               df["destinations"].tolist()))


@pytest.mark.parametrize("biased", [False, True])
def test_without_replacement_routes_pick_distinct_edges(biased, monkeypatch):
    """Both routes without replacement (the tile; the per-edge sort, with
    its threshold at 0): min(k, deg) distinct picks per seed, all edges,
    never a zero-weight edge when biased."""
    _, Gt = _pair("rmat10w")
    seeds = Gt.nodes()[:200]
    k = 6
    deg = Gt.out_degree().set_index("vertex")["degree"]
    w_src, w_dst, w = Gt.edgelist_arrays()
    for threshold in (tS._TILE_FALLBACK_ENTRIES, 0):
        monkeypatch.setattr(tS, "_TILE_FALLBACK_ENTRIES", threshold)
        fn = (ct.homogeneous_biased_neighbor_sample if biased
              else ct.uniform_neighbor_sample)
        df = fn(Gt, seeds, [k], with_replacement=False, random_state=3)
        assert _valid_edges(Gt, df)
        per = df.groupby("batch_id")["destinations"]
        assert (per.nunique() == per.size()).all()
        expect = np.minimum(k, deg.loc[seeds].to_numpy())
        if biased:
            assert (df["weight"] > 0).all()
            nz = pd.Series(w > 0).groupby(w_src).sum()
            expect = np.minimum(k, nz.reindex(
                Gt.lookup_internal_vertex_id(seeds), fill_value=0).to_numpy())
        got = per.size().reindex(np.arange(len(seeds)), fill_value=0)
        np.testing.assert_array_equal(got.to_numpy(), expect)


def test_bulk_route_samples_out_neighbours(monkeypatch):
    """The per_v_random_select rounds (``_bulk_sample_with_replacement``):
    every pick an out-neighbour, each edge index that pick's edge, -1 and
    invalid for a sink; the sampler never takes the route, not even on a
    frontier of every vertex, each once."""
    _, Gt = _pair("rmat10w")
    g = Gt.structure
    fr = np.unique(_frontier(Gt, 300, 4))
    dst, eidx, valid = tS._bulk_sample_with_replacement(
        Gt, g, fr, tS.Draws(1, "cpu"), 4)
    deg = g.out_degrees().numpy()[fr]
    np.testing.assert_array_equal(valid, np.repeat(deg[:, None] > 0, 4, 1))
    assert (dst[~valid] == -1).all()
    ind = g.csr.indices.numpy()
    off = g.csr.offsets.numpy()
    np.testing.assert_array_equal(ind[eidx[valid]], dst[valid])
    rows = np.repeat(fr[:, None], 4, 1)[valid]
    assert ((eidx[valid] >= off[rows]) & (eidx[valid] < off[rows + 1])).all()
    calls = []
    real = tS._bulk_sample_with_replacement
    monkeypatch.setattr(tS, "_bulk_sample_with_replacement",
                        lambda *a: calls.append(1) or real(*a))
    df = ct.uniform_neighbor_sample(Gt, Gt.nodes(), [3], random_state=2)
    assert _valid_edges(Gt, df) and calls == []


def test_bulk_route_picks_chi_square():
    """The hub of a star with 20 leaves, 2,000 rounds of the bulk route
    from the port's generator: χ² (19 dof) below 43.8, the 0.999
    quantile."""
    G = ct.Graph(directed=True, device="cpu").from_edgelist(
        np.zeros(20, np.int64), np.arange(1, 21))
    g = G.structure
    hub = G.lookup_internal_vertex_id(np.array([0]))
    dst, _, valid = tS._bulk_sample_with_replacement(
        G, g, hub.astype(np.int32), tS.Draws(5, "cpu"), 2000)
    assert valid.all()
    ext = G.number_map.to_external(dst.reshape(-1))
    counts = np.bincount(ext, minlength=21)[1:]
    assert ((counts - 100.0) ** 2 / 100.0).sum() < 43.8


def test_uniform_picks_chi_square():
    """One seed, the hub of a star with 20 leaves, 4,000 picks with
    replacement from the port's generator: χ² (19 dof) below 43.8, the
    0.999 quantile."""
    G = ct.Graph(directed=True, device="cpu").from_edgelist(
        np.zeros(20, np.int64), np.arange(1, 21))
    df = ct.uniform_neighbor_sample(G, [0], [4000], random_state=5)
    counts = np.bincount(df["destinations"].to_numpy(), minlength=21)[1:]
    chi2 = ((counts - 200.0) ** 2 / 200.0).sum()
    assert chi2 < 43.8


def test_biased_picks_follow_weights():
    """Weights 1, 2, 3, 4 out of one vertex, 10,000 biased picks: each
    frequency within 5 standard deviations of w / 10; a zero weight is
    never picked."""
    G = ct.Graph(directed=True, device="cpu").from_edgelist(
        np.zeros(5, np.int64), np.arange(1, 6),
        np.array([1, 2, 3, 4, 0], np.float32))
    df = ct.homogeneous_biased_neighbor_sample(G, [0], [10000],
                                               random_state=6)
    counts = np.bincount(df["destinations"].to_numpy(), minlength=6)[1:]
    p = np.array([0.1, 0.2, 0.3, 0.4, 0.0])
    sd = np.sqrt(10000 * p * (1 - p))
    assert (np.abs(counts - 10000 * p) <= 5 * sd + 1e-9).all()


# -- per_v_random_select ------------------------------------------------------

def _select_edges(seed=0):
    """300 vertices, 2,400 edges; the vertices past 260 are sinks."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 260, 2400), rng.integers(0, 300, 2400)


def _select_graph(seed=0):
    return ct.Graph(directed=True, device="cpu").from_edgelist(
        *_select_edges(seed))


def test_select_with_fed_priorities_is_row_argmax():
    """K2 (max, right) then K3 eqsel on priorities quantized to 16 levels
    (so that rows tie) against a float64 NumPy argmax per row that takes
    the largest id among ties; -1 for rows with no edge."""
    G = _select_graph()
    csr = G.structure.csr
    rng = np.random.default_rng(3)
    pri = (rng.integers(1, 17, csr.num_edges) / 16.0).astype(np.float32)
    got = dispatch._select_by_priority(csr, torch.from_numpy(pri)).numpy()
    off, ind = csr.offsets.numpy(), csr.indices.numpy()
    want = np.full(csr.num_vertices, -1, np.int64)
    for r in range(csr.num_vertices):
        p = pri[off[r]:off[r + 1]].astype(np.float64)
        if len(p):
            want[r] = ind[off[r]:off[r + 1]][p == p.max()].max()
    np.testing.assert_array_equal(got, want)
    assert (got == -1).any()


def _out_sets(G):
    src, dst, _ = G.edgelist_arrays()
    adj = {}
    for u, v in zip(src.tolist(), dst.tolist()):
        adj.setdefault(u, set()).add(v)
    return adj


def _assert_valid_picks(sel, adj, n):
    for v in range(n):
        if v in adj:
            assert sel[v] in adj[v]
        else:
            assert sel[v] == -1


def test_select_own_draws_valid_and_uniform():
    """Every pick an out-neighbour, -1 at sinks; on the hub, 200 draws
    from one generator pass the χ² bound of tests/test_kernels.py:352-365
    (< 4·deg)."""
    G = _select_graph()
    adj = _out_sets(G)
    n = G.number_of_vertices()
    gen = torch.Generator().manual_seed(0)
    sel = ct.per_v_random_select(G, gen).numpy()
    assert sel.dtype == np.int32
    _assert_valid_picks(sel, adj, n)
    np.testing.assert_array_equal(ct.per_v_random_select(G).numpy(),
                                  ct.per_v_random_select(G).numpy())
    u0 = max(adj, key=lambda u: len(adj[u]))
    d0 = len(adj[u0])
    counts = {}
    for _ in range(200):
        s = int(ct.per_v_random_select(G, gen)[u0])
        counts[s] = counts.get(s, 0) + 1
    exp = 200 / d0
    chi2 = sum((c - exp) ** 2 / exp for c in counts.values()) \
        + (d0 - len(counts)) * exp
    assert chi2 < 4 * d0


# |χ² - dof| within 6 standard deviations (sqrt(2·dof)); the 0.9999
# quantile of χ² with 19 dof
ROWS_CHI2_SD, BINNED_CHI2_19 = 6.0, 50.8


def _select_rows_and_hub(G, calls, seed):
    """``calls`` picks of ``per_v_random_select`` on the rows of out-degree
    5-40 and on the hub: (csr, rows, picks [calls, R], hub, hub picks)."""
    csr = G.structure.csr
    deg = G.structure.out_degrees().numpy()
    rows = np.flatnonzero((deg >= 5) & (deg <= 40))
    hub = int(np.argmax(deg))
    gen = torch.Generator().manual_seed(seed)
    sel = np.stack([ct.per_v_random_select(G, gen).numpy()
                    for _ in range(calls)])
    return csr, rows, sel[:, rows], hub, sel[:, hub]


def test_select_own_draws_uniform_over_many_rows_and_hub_bins():
    """200 calls on an R-MAT graph: the χ² summed over every row of
    out-degree 5-40 (5-40 expected picks per neighbour) within 6 standard
    deviations of its degrees of freedom, and the hub's picks over 20 bins
    of its edge positions below the 0.9999 quantile."""
    _, Gt = _pair("rmat10w")
    csr, rows, picks, hub, hub_picks = _select_rows_and_hub(Gt, 200, 2)
    assert len(rows) >= 100
    stat, dof = picks_chi2.rows_chi2(csr.offsets, csr.indices, rows, picks)
    assert abs(stat - dof) < ROWS_CHI2_SD * np.sqrt(2 * dof)
    stat, dof = picks_chi2.binned_chi2(csr.offsets, csr.indices, hub,
                                       hub_picks)
    assert dof == 19 and stat < BINNED_CHI2_19


def test_pick_statistics_flag_a_narrowed_select():
    """The statistics of the test above see a select that keeps to part of
    a row: uniform over the first half of each row's edges, or over the
    first tenth of the hub's (the span of one heavy-row piece), fails
    them; 200 uniform draws over each whole row pass."""
    _, Gt = _pair("rmat10w")
    csr = Gt.structure.csr
    off, ind = csr.offsets.numpy(), csr.indices.numpy()
    deg = np.diff(off)
    rows = np.flatnonzero((deg >= 5) & (deg <= 40))
    hub = int(np.argmax(deg))
    rng = np.random.default_rng(0)

    def draw(r, frac):
        cut = np.maximum((np.asarray(deg[r]) * frac).astype(np.int64), 1)
        return ind[off[r] + (rng.random((200,) + np.shape(r)) * cut)
                   .astype(np.int64)]

    for frac, ok in ((1.0, True), (0.5, False)):
        stat, dof = picks_chi2.rows_chi2(off, ind, rows, draw(rows, frac))
        assert (abs(stat - dof) < ROWS_CHI2_SD * np.sqrt(2 * dof)) == ok
    for frac, ok in ((1.0, True), (0.1, False)):
        stat, _ = picks_chi2.binned_chi2(off, ind, hub, draw(hub, frac))
        assert (stat < BINNED_CHI2_19) == ok
    with pytest.raises(AssertionError):
        picks_chi2.rows_chi2(off, ind, rows[:1],
                             np.full((3, 1), ind[off[rows[0] + 1]] + 10**6))


def test_jax_interpret_picks_pass_the_same_check():
    """One call of the JAX package's Pallas route in interpret mode (its
    first call costs ~40 s on the CPU, nearly all of it the interpreter's
    set-up)."""
    from cugraph_tpu.kernels.dispatch import per_v_random_select

    src, dst = _select_edges()
    Gj = ctpu.Graph(directed=True).from_edgelist(src, dst, None)
    Gt = ct.Graph(directed=True, device="cpu").from_edgelist(src, dst)
    sel = np.asarray(per_v_random_select(Gj, jax.random.key(0),
                                         interpret=True))
    _assert_valid_picks(sel, _out_sets(Gt), Gt.number_of_vertices())


def test_priorities_range():
    p = dispatch.priorities(100000, torch.Generator().manual_seed(1), "cpu")
    assert p.dtype == torch.float32
    assert float(p.min()) >= 1e-6 and float(p.max()) < 1.0


# -- negative sampling --------------------------------------------------------

NEG_CASES = {
    "uniform": dict(),
    "biased": dict(src_bias="deg", dst_bias="deg"),
    "src_biased": dict(src_bias="deg"),
    "vertices": dict(vertices="some"),
    "vertices_biased": dict(vertices="some", dst_bias="some"),
    "keep_duplicates": dict(remove_duplicates=False,
                            remove_existing_edges=False),
}


@pytest.mark.parametrize("case", list(NEG_CASES))
@pytest.mark.parametrize("kind", ["karate", "rmat10w"])
def test_negative_sampling_matches_jax(case, kind):
    Gj, Gt = _pair(kind)
    kw = dict(NEG_CASES[case])
    nodes = Gt.nodes()
    some = nodes[::3]
    deg = np.bincount(Gt.edgelist_arrays()[0],
                      minlength=len(nodes)).astype(np.float64) + 1.0
    for name in ("src_bias", "dst_bias"):
        if kw.get(name) == "deg":
            kw[name] = deg
        elif kw.get(name) == "some":
            kw[name] = np.arange(1, len(some) + 1, dtype=np.float64)
    if kw.get("vertices") == "some":
        kw["vertices"] = some
    want = ctpu.negative_sampling(Gj, 200, random_state=8, **kw)
    args = {"vertices": None, "src_bias": None, "dst_bias": None,
            "remove_duplicates": True, "remove_existing_edges": True,
            "exact_number_of_samples": False, **kw}
    got = tS._negative_sampling(Gt, 200, seed0=8, draws=JaxDraws(8), **args)
    pd.testing.assert_frame_equal(got, want)
    assert len(got) > 100
    if args["remove_existing_edges"]:
        src, dst, _ = Gt.edgelist_arrays()
        edges = set(zip(nodes[src].tolist(), nodes[dst].tolist()))
        assert not any((s, d) in edges for s, d in zip(got["src"].tolist(),
                                                       got["dst"].tolist()))
        assert (got["src"] != got["dst"]).all()


def test_negative_sampling_own_draws_and_errors():
    _, Gt = _pair("karate")
    df = ct.negative_sampling(Gt, 100, random_state=2)
    assert len(df) == 100 and not df.duplicated().any()
    pd.testing.assert_frame_equal(df, ct.negative_sampling(Gt, 100,
                                                           random_state=2))
    with pytest.raises(ValueError, match="src_bias must have length"):
        ct.negative_sampling(Gt, 10, src_bias=np.ones(3))
    tiny = ct.Graph(directed=True, device="cpu").from_edgelist(
        np.array([0, 1]), np.array([1, 0]))
    with pytest.raises(RuntimeError, match="could not draw"):
        ct.negative_sampling(tiny, 10, exact_number_of_samples=True)


def test_nodes_match_jax_on_a_renumbered_graph():
    src = np.array([40, 7, 7, 1000, 3])
    dst = np.array([7, 1000, 3, 40, 40])
    for directed in (True, False):
        Gj = ctpu.Graph(directed=directed).from_edgelist(src, dst, None)
        Gt = ct.Graph(directed=directed, device="cpu").from_edgelist(src, dst)
        np.testing.assert_array_equal(Gt.nodes(), Gj.nodes())
    with pytest.raises(ct.InvalidInputError):
        ct.Graph(device="cpu").nodes()


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
def test_frames_on_the_card_match_the_cpu():
    """The same fed draws give the same frames on the card (K2/K3-free
    gathers, searches and sorts) as on the CPU, at RMAT-12, every route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    src, dst, w, directed = _graph("rmat12")
    seeds = np.unique(src)[:64]
    for biased, wr, threshold in ((False, True, None), (True, True, None),
                                  (False, False, None), (True, False, None),
                                  (False, False, 0), (True, False, 0)):
        frames = []
        for dev in ("cpu", "cuda"):
            G = ct.Graph(directed=directed, device=dev).from_edgelist(
                src, dst, w)
            saved = tS._TILE_FALLBACK_ENTRIES
            if threshold is not None:
                tS._TILE_FALLBACK_ENTRIES = threshold
            try:
                frames.append(tS._neighbor_sample(
                    G, seeds, [10, 10], wr, biased, 3,
                    draws=CpuDraws(3, dev)))
            finally:
                tS._TILE_FALLBACK_ENTRIES = saved
        pd.testing.assert_frame_equal(frames[1], frames[0])

