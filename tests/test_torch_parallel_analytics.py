"""The multi-device port's analytics against ``cugraph_tpu.parallel``:
similarity, negative sampling, cores, betweenness, SCC, triangles,
k-truss and the neighbourhood extractions.

Each world (2×2, 2×1 and 1×2 gloo processes) runs
``torch_port_mg_analytics.analytics_body`` once in a module-scoped
fixture on ``torch_port_mg``'s graphs (the skewed one included); each
case compares one result with the JAX package's on a mesh of the same
shape over ``jax.devices()[:P]``, one cached JAX run per (graph, mesh
shape).

Bounds: bit for bit the intersection counts, the set out-degrees, the
coefficients (float64 division of equal integers), the all-pairs frames,
the negative samples (the same NumPy draws), the core numbers (and each
sweep's iterate against a NumPy run of the JAX package's threshold
sweep), the SCC labels, the triangle counts and the k-hop sets; the
edge lists of the k-core, the egonets, the induced subgraph, the k-truss
and the two-hop pairs after a lexsort (the port's blocks order a dst
slot's edges by source, the JAX package's keep input order); vertex and
edge betweenness within rtol 1e-5 (float32 path counts and dependencies
summed in another order and other panels).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from cugraph_tpu import parallel as jp
from cugraph_tpu.parallel import algos as ja

from torch_port_mg import GRAPHS, WORLDS, run_worlds
from torch_port_mg_analytics import (ANALYTIC_NAMES, analytics_body,
                                     bc_sources, induced, pairs, seeds,
                                     sym_graph, two_hop_starts)

torch.set_num_threads(1)
BC_RTOL = 1e-5
KINDS = ("jaccard", "sorensen", "overlap", "cosine")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return run_worlds(tmp_path_factory.mktemp("analytics"), analytics_body,
                      {shape: (ANALYTIC_NAMES,) for shape in WORLDS})


@pytest.fixture(params=[(w, name) for w in WORLDS for name in ANALYTIC_NAMES],
                ids=[f"{a}x{b}-{name}" for a, b in WORLDS
                     for name in ANALYTIC_NAMES])
def case(request, worlds):
    (pmaj, pmin), name = request.param
    res = worlds[(pmaj, pmin)]
    return name, {k[len(name) + 1:]: v for k, v in res.items()
                  if k.startswith(name + "/")}, _jax(name, pmaj, pmin)


def _frame(df, cols):
    return [df[c].to_numpy() for c in cols]


@functools.lru_cache(maxsize=None)
def _jax(name, pmaj, pmin):
    """Every JAX result of one (graph, mesh shape), computed once."""
    src, dst, w, n = GRAPHS[name]
    mesh = jp.make_mesh_2d(pmaj, pmin, jax.devices()[:pmaj * pmin])
    g = jp.build_dist_graph(src, dst, w, n, pmaj, pmin, store_push=True)
    f, s = pairs(name)
    ctx = ja._mg_intersect_ctx(g)
    nbr, off = np.asarray(ctx.nbr), np.asarray(ctx.offsets)
    # each slot's u by its row bounds, then the port body's mask
    u = np.stack([[np.searchsorted(off[i, j], np.arange(ctx.e_blk),
                                   side="right") - 1
                   for j in range(pmin)] for i in range(pmaj)])
    alive = np.asarray(ctx.alive_all) & ((u + nbr) % 3 != 0)
    out = {"cn": ja._mg_common_neighbors(g, mesh, f, s),
           "cn_alive": ja._mg_common_neighbors(g, mesh, f, s,
                                               alive=jax.numpy.asarray(
                                                   alive)),
           "out_counts": ja._mg_out_degree_counts(g),
           "cn_rows": np.asarray(ja._mg_cn_rows(g, mesh, [0, 3, 5]))}
    for kind in KINDS:
        out[kind] = getattr(jp, f"mg_{kind}_coefficients")(g, mesh, f, s)
        out[f"all_pairs_{kind}"] = _frame(
            jp.mg_all_pairs_similarity(g, mesh, kind,
                                       vertices=np.arange(12)),
            ["first", "second", f"{kind}_coeff"])
    out["all_pairs_top"] = _frame(jp.all_pairs_jaccard(g, mesh, topk=7,
                                                       batch=50),
                                  ["first", "second", "jaccard_coeff"])
    for label, kw in (("neg", {}),
                      ("neg_exact", {"exact_number_of_samples": True,
                                     "remove_duplicates": True}),
                      ("neg_cand", {"vertices": np.arange(0, n, 2)})):
        out[label] = _frame(jp.mg_negative_sampling(g, mesh, 60, seed=4,
                                                    **kw), ["src", "dst"])
    for dt in ("incoming", "outgoing", "bidirectional"):
        out[f"core_{dt}"] = np.asarray(jp.mg_core_number(g, mesh,
                                                         degree_type=dt))
    out["k_core"] = jp.mg_k_core(g, mesh)
    out["k_core2"] = jp.mg_k_core(g, mesh, k=2, degree_type="bidirectional")
    srcs = bc_sources(name)
    out["bc"] = jp.mg_betweenness_centrality(g, mesh, sources=srcs)
    out["bc_all_ends"] = jp.mg_betweenness_centrality(
        g, mesh, endpoints=True, normalized=False)
    out["bc_k"] = jp.mg_betweenness_centrality(g, mesh, k=25, seed=2,
                                               directed=False,
                                               normalized=False)
    cols = ["src", "dst", "betweenness_centrality"]
    out["ebc"] = _frame(jp.mg_edge_betweenness_centrality(
        g, mesh, sources=srcs), cols)
    out["ebc_u"] = _frame(jp.mg_edge_betweenness_centrality(
        g, mesh, k=30, seed=1, directed=False), cols)
    out["scc"] = jp.mg_strongly_connected_components(g, mesh)
    out["k_hop"] = jp.mg_k_hop_nbrs(g, mesh, seeds(name)[0], 2)
    out["egonet"] = jp.mg_egonet(g, mesh, seeds(name), radius=2)
    out["induced"] = jp.mg_induced_subgraph(g, mesh, induced(name))
    out["two_hop"] = jp.mg_two_hop_neighbors(g, mesh, two_hop_starts(name))
    out["two_hop_all"] = jp.mg_two_hop_neighbors(g, mesh)
    ss, sd, _, _ = sym_graph(name)
    gs = jp.build_dist_graph(ss, sd, None, n, pmaj, pmin, store_push=True)
    out["triangles"] = jp.mg_triangle_count(gs, mesh)
    out["k_truss"] = jp.mg_k_truss(gs, mesh, 4)
    return out


def _edges(got, key, k=3):
    return [got[f"{key}/{i}"] for i in range(k)]


def _same_edge_set(got, want):
    """Two (src, dst, w, ...) edge lists equal after a lexsort."""
    def rows(arrs):
        s, d, w = (np.asarray(a) for a in arrs[:3])
        o = np.lexsort((w, d, s))
        return s[o].astype(np.int64), d[o].astype(np.int64), w[o]

    for a, b in zip(rows(got), rows(want)):
        np.testing.assert_array_equal(a, b)


def test_intersections(case):
    name, got, want = case
    np.testing.assert_array_equal(got["cn"], want["cn"])
    np.testing.assert_array_equal(got["cn_alive"], want["cn_alive"])
    assert (got["cn_alive"] <= got["cn"]).all()
    np.testing.assert_array_equal(got["out_counts"], want["out_counts"])
    np.testing.assert_array_equal(got["cn_rows"], want["cn_rows"])


@pytest.mark.parametrize("kind", KINDS)
def test_coefficients(case, kind):
    name, got, want = case
    np.testing.assert_array_equal(got[kind], want[kind])
    for a, c in zip(want[f"all_pairs_{kind}"],
                    ("first", "second", f"{kind}_coeff")):
        np.testing.assert_array_equal(got[f"all_pairs_{kind}/{c}"], a)


def test_all_pairs_topk(case):
    name, got, want = case
    for a, c in zip(want["all_pairs_top"], ("first", "second",
                                            "jaccard_coeff")):
        np.testing.assert_array_equal(got[f"all_pairs_top/{c}"], a)


@pytest.mark.parametrize("label", ["neg", "neg_exact", "neg_cand"])
def test_negative_sampling(case, label):
    name, got, want = case
    np.testing.assert_array_equal(got[f"{label}/src"], want[label][0])
    np.testing.assert_array_equal(got[f"{label}/dst"], want[label][1])


def _threshold_sweeps(src, dst, n, pad_v, max_core, use_pull, use_push):
    """NumPy run of the JAX package's fixpoint (``algos.py:1660-1682``):
    per sweep, for t = 1..max_core, the count of neighbours with core >= t
    (in-neighbours, out-neighbours or both), H the largest t with count >=
    t, core ← min(core, H); every sweep's vector."""
    core = np.zeros(pad_v, np.int64)
    core[:n] = max_core
    out = []
    while True:
        best = np.zeros(pad_v, np.int64)
        for t in range(1, max_core + 1):
            cnt = np.zeros(pad_v, np.int64)
            if use_pull:
                cnt += np.bincount(dst, weights=core[src] >= t,
                                   minlength=pad_v).astype(np.int64)
            if use_push:
                cnt += np.bincount(src, weights=core[dst] >= t,
                                   minlength=pad_v).astype(np.int64)
            best = np.where(cnt >= t, np.maximum(best, t), best)
        new = np.minimum(core, best)
        out.append(new)
        if np.array_equal(new, core) or len(out) >= n:
            return out
        core = new


@pytest.mark.parametrize("dt", ["incoming", "outgoing", "bidirectional"])
def test_core_number(case, dt):
    name, got, want = case
    np.testing.assert_array_equal(got[f"core_{dt}"], want[f"core_{dt}"])
    src, dst, _, n = GRAPHS[name]
    trace = got[f"core_{dt}/trace"]
    pad_v = trace.shape[1]
    # the cap: the h-index of the edge-count degree sequence
    deg = (np.bincount(dst, minlength=pad_v) * (dt != "outgoing")
           + np.bincount(src, minlength=pad_v) * (dt != "incoming"))
    ds = np.sort(deg)[::-1]
    cap = max(int(np.count_nonzero(ds >= np.arange(1, pad_v + 1))), 1)
    assert int(got[f"core_{dt}/max_core"]) == cap
    ref = _threshold_sweeps(src, dst, n, pad_v, cap, dt != "outgoing",
                            dt != "incoming")
    assert len(trace) == len(ref) == int(got[f"core_{dt}/sweeps"])
    for a, b in zip(trace, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(trace[-1], got[f"core_{dt}"])


@pytest.mark.parametrize("label", ["k_core", "k_core2"])
def test_k_core(case, label):
    name, got, want = case
    _same_edge_set(_edges(got, label), want[label])
    np.testing.assert_array_equal(got[f"{label}/3"], np.asarray(
        want[label][3]))


@pytest.mark.parametrize("label", ["bc", "bc_all_ends", "bc_k"])
def test_betweenness(case, label):
    name, got, want = case
    w = np.asarray(want[label])
    np.testing.assert_allclose(got[label], w, rtol=BC_RTOL,
                               atol=1e-9 * np.abs(w).max())


@pytest.mark.parametrize("label", ["ebc", "ebc_u"])
def test_edge_betweenness(case, label):
    name, got, want = case
    g_s, g_d, g_v = (got[f"{label}/{c}"] for c in
                     ("src", "dst", "betweenness_centrality"))
    w_s, w_d, w_v = want[label]
    og, ow = np.lexsort((g_d, g_s)), np.lexsort((w_d, w_s))
    np.testing.assert_array_equal(g_s[og], w_s[ow])
    np.testing.assert_array_equal(g_d[og], w_d[ow])
    np.testing.assert_allclose(g_v[og], w_v[ow], rtol=BC_RTOL,
                               atol=1e-9 * np.abs(w_v).max())


def test_scc(case):
    name, got, want = case
    np.testing.assert_array_equal(got["scc"], want["scc"])


def test_neighbourhoods(case):
    name, got, want = case
    np.testing.assert_array_equal(got["k_hop"], want["k_hop"])
    off = got["egonet/3"]
    np.testing.assert_array_equal(off, want["egonet"][3])
    for a, b in zip(off[:-1], off[1:]):
        _same_edge_set([x[a:b] for x in _edges(got, "egonet")],
                       [np.asarray(x)[a:b] for x in want["egonet"][:3]])
    _same_edge_set(_edges(got, "induced"), want["induced"])
    for label in ("two_hop", "two_hop_all"):
        for k in range(2):
            np.testing.assert_array_equal(got[f"{label}/{k}"],
                                          want[label][k])


def test_triangles(case):
    name, got, want = case
    np.testing.assert_array_equal(got["triangles"], want["triangles"])
    _same_edge_set(_edges(got, "k_truss"), want["k_truss"])
