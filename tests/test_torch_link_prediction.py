"""The port's Jaccard family and pair intersections against cugraph_tpu on
the CPU.

Counts, degrees and unweighted coefficients are integers or ratios of
integers and must match exactly; the weighted sums are float64 sums rounded
once in the port and float32 sums in the JAX package, so the weighted
coefficients match within rtol 1e-6 where the JAX package's own float32
error allows it, and are held against a float64 oracle beyond that.
"""

import os

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import cugraph_tpu as ctpu
from cugraph_tpu.prims import intersection as jint

import cugraph_tpu_torch as ct
from cugraph_tpu_torch.prims import intersection as tint

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cugraph_tpu", "datasets", "data")
KINDS = ["karate", "dolphins", "netscience", "rmat10", "rmat12"]
COEFFS = ["jaccard", "sorensen", "overlap", "cosine"]
WEIGHTED_RTOL = 1e-6


def _edges(kind):
    """(src, dst, weights) of an undirected test graph; karate's weights
    are ones, the RMAT graphs' uniform in [0, 1)."""
    if kind == "karate":
        e = np.array(list(nx.karate_club_graph().edges()))
        return e[:, 0], e[:, 1], np.ones(len(e), np.float32)
    if kind in ("dolphins", "netscience"):
        a = np.loadtxt(os.path.join(DATA, f"{kind}.csv"))
        return a[:, 0].astype(np.int64), a[:, 1].astype(np.int64), a[:, 2]
    scale = int(kind[4:])
    e = ctpu.rmat(scale, 8 << scale, seed=4)
    s, d = e["src"].to_numpy(), e["dst"].to_numpy()
    return s, d, np.random.default_rng(scale).random(len(s)).astype(
        np.float32)


_GRAPHS = {}


def _pair(kind, weighted=True):
    key = (kind, weighted)
    if key not in _GRAPHS:
        s, d, w = _edges(kind)
        w = w if weighted else None
        _GRAPHS[key] = (ctpu.Graph().from_edgelist(s, d, w),
                        ct.Graph(device="cpu").from_edgelist(s, d, w))
    return _GRAPHS[key]


def _hub_pairs(G, count=300, seed=0):
    """External-id pairs: the top-degree vertex against many others, the
    top few against each other, random pairs (mostly non-edges), a vertex
    with itself."""
    deg = G.degree().sort_values("degree", ascending=False, kind="stable")
    top = deg["vertex"].to_numpy()[:5]
    nodes = G.nodes()
    rng = np.random.default_rng(seed)
    first = np.concatenate([np.full(count // 2, top[0]), top[:-1],
                            rng.choice(nodes, count // 2), nodes[:1]])
    second = np.concatenate([rng.choice(nodes, count // 2), top[1:],
                             rng.choice(nodes, count // 2), nodes[:1]])
    return pd.DataFrame({"first": first, "second": second})


def _hold_frames(got, want, col, weighted):
    pd.testing.assert_frame_equal(got[["first", "second"]],
                                  want[["first", "second"]])
    if weighted:
        np.testing.assert_allclose(got[col].to_numpy(), want[col].to_numpy(),
                                   rtol=WEIGHTED_RTOL, atol=0)
    else:
        pd.testing.assert_series_equal(got[col], want[col])


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", ["karate", "dolphins", "netscience",
                                  "rmat10"])
@pytest.mark.parametrize("coeff", COEFFS)
def test_coefficients_match_jax_over_the_default_pairs(coeff, kind,
                                                       weighted):
    Gj, Gt = _pair(kind)
    want = getattr(ctpu, coeff)(Gj, use_weight=weighted)
    got = getattr(ct, coeff)(Gt, use_weight=weighted)
    assert len(got) == Gt.number_of_edges() - int(np.sum(
        Gt.edgelist_arrays()[0] == Gt.edgelist_arrays()[1]))
    _hold_frames(got, want, f"{coeff}_coeff", weighted)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", ["karate", "netscience", "rmat10"])
@pytest.mark.parametrize("coeff", COEFFS)
def test_coefficients_match_jax_over_hub_pairs(coeff, kind, weighted):
    Gj, Gt = _pair(kind)
    vp = _hub_pairs(Gt)
    want = getattr(ctpu, coeff)(Gj, vp, use_weight=weighted)
    got = getattr(ct, coeff)(Gt, vp, use_weight=weighted)
    _hold_frames(got, want, f"{coeff}_coeff", weighted)


@pytest.mark.parametrize("coeff", COEFFS)
def test_unweighted_graph_matches_jax_over_rmat12(coeff):
    Gj, Gt = _pair("rmat12", weighted=False)
    want = getattr(ctpu, coeff)(Gj)
    got = getattr(ct, coeff)(Gt)
    _hold_frames(got, want, f"{coeff}_coeff", False)


def _float64_jaccard(G, df):
    s, d, w = G.edgelist_arrays()
    n = G.number_of_vertices()
    A = sp.csr_matrix((w.astype(np.float64), (s, d)), shape=(n, n))
    us = G.lookup_internal_vertex_id(df["first"].to_numpy())
    vs = G.lookup_internal_vertex_id(df["second"].to_numpy())
    inter = np.asarray(A[us].minimum(A[vs]).sum(axis=1)).ravel()
    ws = np.asarray(A.sum(axis=1)).ravel()
    return inter / (ws[us] + ws[vs] - inter)


def test_weighted_jaccard_against_float64_at_rmat12():
    """At RMAT-12 with weights uniform in [0, 1) the JAX package's float32
    sums drift past 1e-6 of float64 (ROADMAP §3); the port's sums are
    float64 rounded once and stay within 2e-7."""
    Gj, Gt = _pair("rmat12")
    got = ct.jaccard(Gt, use_weight=True)
    want = ctpu.jaccard(Gj, use_weight=True)
    pd.testing.assert_frame_equal(got[["first", "second"]],
                                  want[["first", "second"]])
    ref = _float64_jaccard(Gt, got)
    ok = ref > 0
    err_port = np.abs(got["jaccard_coeff"].to_numpy() - ref)[ok] / ref[ok]
    err_jax = np.abs(want["jaccard_coeff"].to_numpy() - ref)[ok] / ref[ok]
    assert err_port.max() <= 2e-7
    assert err_port.max() < err_jax.max()
    assert np.all(got["jaccard_coeff"].to_numpy()[~ok] == 0)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", ["karate", "netscience", "rmat10"])
def test_pair_intersection_matches_jax_binary_search(kind, weighted,
                                                     monkeypatch):
    """Against the JAX package's jitted [P, max_deg] binary search, with
    chunks small enough to split the pairs (and single pairs larger than a
    chunk); the chunks never expand more queries than the bound, except a
    pair alone."""
    import jax.numpy as jnp

    Gj, Gt = _pair(kind)
    vp = _hub_pairs(Gt, seed=4)
    us = Gt.lookup_internal_vertex_id(vp["first"].to_numpy())
    vs = Gt.lookup_internal_vertex_id(vp["second"].to_numpy())
    max_deg = int(np.asarray(Gj.structure.out_degrees()).max())
    want = jint.pair_intersection(Gj.structure, jnp.asarray(us),
                                  jnp.asarray(vs), max_deg, weighted)
    chunk = 40
    sizes = []
    real = tint.lower_bound_rows

    def counting(adj, rows, queries, steps=32):
        sizes.append(rows.numel())
        return real(adj, rows, queries, steps)

    monkeypatch.setattr(tint, "_PROBE_CHUNK", chunk)
    monkeypatch.setattr(tint, "lower_bound_rows", counting)
    got = tint.pair_intersection(Gt.structure, us, vs, weighted=weighted)
    assert len(sizes) > 3
    deg = np.diff(Gt.structure.csr.offsets.numpy())
    single = np.minimum(deg[us], deg[vs]).max()
    assert max(sizes) <= max(chunk, single)
    assert sum(sizes) == np.minimum(deg[us], deg[vs]).sum()
    assert set(got) == set(want)
    for key in ("count", "deg_u", "deg_v"):
        assert got[key].dtype == torch.int32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    for key in ("sum_min", "sum_max", "wsum_u", "wsum_v"):
        if weighted:
            assert got[key].dtype == torch.float32
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), rtol=1e-6)


@pytest.mark.parametrize("chunk", [1, 7, 1 << 25])
def test_pair_intersection_repeats_bit_for_bit_at_any_chunk(chunk,
                                                            monkeypatch):
    """Each pair's sums run in the order of its smaller row, so the chunk
    size changes nothing, and two calls are bit-identical."""
    Gt = _pair("rmat10")[1]
    vp = _hub_pairs(Gt, seed=6)
    us = Gt.lookup_internal_vertex_id(vp["first"].to_numpy())
    vs = Gt.lookup_internal_vertex_id(vp["second"].to_numpy())
    base = tint.pair_intersection(Gt.structure, us, vs, weighted=True)
    monkeypatch.setattr(tint, "_PROBE_CHUNK", chunk)
    for _ in range(2):
        again = tint.pair_intersection(Gt.structure, torch.from_numpy(us),
                                       vs, weighted=True)
        for key in base:
            assert torch.equal(again[key], base[key]), key


def test_pair_intersection_of_no_pairs_and_isolated_vertices():
    Gt = ct.Graph(device="cpu").from_edgelist(
        np.array([0, 1]), np.array([1, 2]), np.array([2.0, 3.0]),
        vertices=np.array([0, 1, 2, 7]))
    out = tint.pair_intersection(Gt.structure, [], [], weighted=True)
    assert all(v.shape == (0,) for v in out.values())
    v0, v1, v2, iso = Gt.lookup_internal_vertex_id(np.array([0, 1, 2, 7]))
    out = tint.pair_intersection(Gt.structure, [iso, v0, v1], [v1, v2, iso],
                                 weighted=True)
    assert out["count"].tolist() == [0, 1, 0]
    assert out["sum_min"].tolist() == [0.0, 2.0, 0.0]
    assert out["sum_max"].tolist() == [0.0, 3.0, 0.0]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("coeff", COEFFS)
@pytest.mark.parametrize("kind", ["karate", "netscience"])
def test_all_pairs_match_jax(kind, coeff, weighted):
    """Unweighted: the frames equal.  Weighted: the sort puts pairs whose
    coefficients tie within float32 rounding (many at 1.0) in an order
    that follows the last bits, so the frames hold the same coefficients
    in order within rtol 1e-6, and each pair the port lists scores within
    rtol 1e-6 of the JAX package's score of that pair."""
    Gj, Gt = _pair(kind)
    fn = f"all_pairs_{coeff}"
    col = f"{coeff}_coeff"
    verts = Gt.nodes()[::7]
    for kw in (dict(vertices=verts, topk=40), dict(topk=100),
               dict(vertices=verts[:3])):
        want = getattr(ctpu, fn)(Gj, use_weight=weighted, **kw)
        got = getattr(ct, fn)(Gt, use_weight=weighted, **kw)
        assert len(got) == len(want) > 0
        if not weighted:
            _hold_frames(got, want, col, False)
            continue
        np.testing.assert_allclose(got[col].to_numpy(), want[col].to_numpy(),
                                   rtol=WEIGHTED_RTOL, atol=0)
        assert np.all(np.diff(got[col].to_numpy()) <= 0)
        same = getattr(ctpu, coeff)(Gj, got[["first", "second"]],
                                    use_weight=True)
        _hold_frames(got, same, col, True)


def test_two_hop_candidates_match_jax():
    from cugraph_tpu.algos import link_prediction as jlp

    from cugraph_tpu_torch.algos import link_prediction as tlp

    for directed in (False, True):
        s, d, _ = _edges("rmat10")
        Gj = ctpu.Graph(directed=directed).from_edgelist(s, d)
        Gt = ct.Graph(directed=directed, device="cpu").from_edgelist(s, d)
        for ids in (None, np.array([0, 3, 17])):
            for a, b in zip(tlp._two_hop_candidates(Gt, ids),
                            jlp._two_hop_candidates(Gj, ids)):
                np.testing.assert_array_equal(a, b)


def test_jaccard_coefficient_and_aliases_match_jax():
    Gj, Gt = _pair("karate")
    ebunch = [(0, 1), (0, 33), (5, 6), (2, 2)]
    pd.testing.assert_frame_equal(ct.jaccard_coefficient(Gt, ebunch),
                                  ctpu.jaccard_coefficient(Gj, ebunch))
    pd.testing.assert_frame_equal(ct.jaccard_coefficient(Gt),
                                  ct.jaccard(Gt))
    vp = _hub_pairs(Gt, count=40)
    for name, base in (("sorensen_coefficient", ct.sorensen),
                       ("overlap_coefficient", ct.overlap),
                       ("cosine_coefficient", ct.cosine)):
        for w in (False, True):
            got = getattr(ct, name)(Gt, vp, w)
            pd.testing.assert_frame_equal(got, base(Gt, vp, use_weight=w))
            _hold_frames(got, getattr(ctpu, name)(Gj, vp, w),
                         f"{name.split('_')[0]}_coeff", w)


def test_errors_and_empty_frames_as_jax():
    Gj, Gt = _pair("karate", weighted=False)
    for G, pkg in ((Gj, ctpu), (Gt, ct)):
        with pytest.raises(ValueError, match="weighted"):
            pkg.jaccard(G, use_weight=True)
    empty = pd.DataFrame({"first": np.array([], np.int64),
                          "second": np.array([], np.int64)})
    pd.testing.assert_frame_equal(ct.overlap(Gt, empty),
                                  ctpu.overlap(Gj, empty))


@pytest.mark.cuda
def test_pair_intersection_on_the_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    s, d, w = _edges("rmat12")
    cpu = ct.Graph(device="cpu").from_edgelist(s, d, w)
    gpu = ct.Graph().from_edgelist(s, d, w)
    for weighted in (False, True):
        a = ct.jaccard(cpu, use_weight=weighted)
        b = ct.jaccard(gpu, use_weight=weighted)
        pd.testing.assert_frame_equal(a, b)
        vp = _hub_pairs(cpu)
        us = cpu.lookup_internal_vertex_id(vp["first"].to_numpy())
        vs = cpu.lookup_internal_vertex_id(vp["second"].to_numpy())
        x = tint.pair_intersection(cpu.structure, us, vs, weighted)
        y = tint.pair_intersection(gpu.structure, us, vs, weighted)
        for key in x:
            assert y[key].is_cuda
            assert torch.equal(x[key], y[key].cpu()), key
