"""Edge properties, MultiGraph, the edge-id lookup and the structure ops of
the PyTorch port against cugraph_tpu on the CPU.

The same inputs, made from numpy seeds, go through both packages: the
path that keeps every edge (``edge_id``/``edge_type``/``edge_time`` and
``MultiGraph``) must store the same edges with the same properties in the
same order; the CSR's kept sort permutation must be ``np.lexsort``'s; the
lookup table and every function of ``algos/structure.py`` must give the
JAX package's results exactly (the weight sums within float32 rounding,
which both packages do in float64 and round once).
"""

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import torch

import cugraph_tpu as ctpu
from cugraph_tpu.algos import sampling as jS
from cugraph_tpu.algos import structure as jstruct

import cugraph_tpu_torch as ct
from cugraph_tpu_torch.algos import sampling as tS
from cugraph_tpu_torch.core import preprocess as tpre

torch.set_num_threads(1)


def _edges(kind, seed=0):
    """(src, dst, weight) external ids: ``dups`` repeats pairs in both
    orders and has self-loops; ``sparse`` has huge ids; ``karate``."""
    rng = np.random.default_rng(seed)
    if kind == "karate":
        e = np.array(list(nx.karate_club_graph().edges()))
        src, dst = e[:, 0], e[:, 1]
    elif kind == "dups":
        src = rng.integers(0, 40, 600)
        dst = rng.integers(0, 40, 600)
        src[:30] = dst[:30]                      # self-loops
        src[30:60], dst[30:60] = dst[60:90], src[60:90]   # reversed pairs
        src[90:120], dst[90:120] = src[120:150], dst[120:150]  # parallel
    elif kind == "sparse":
        src = rng.integers(0, 60, 500) * 1_000_003 + 7
        dst = rng.integers(0, 60, 500) * 1_000_003 + 7
    else:
        raise KeyError(kind)
    w = rng.uniform(0.1, 2.0, len(src)).astype(np.float32)
    return src, dst, w


def _props(m, seed, which):
    rng = np.random.default_rng(seed + 100)
    out = {}
    if "id" in which:
        out["edge_id"] = rng.permutation(m).astype(np.int64) + 10
    if "type" in which:
        out["edge_type"] = rng.integers(0, 3, m).astype(np.int32)
    if "time" in which:
        out["edge_time"] = rng.integers(0, 100, m).astype(np.float32)
    return out


def _pair(cls, directed, src, dst, w, **props):
    gj = getattr(ctpu, cls)(directed=directed).from_edgelist(src, dst, w,
                                                              **props)
    gt = getattr(ct, cls)(directed=directed, device="cpu").from_edgelist(
        src, dst, w, **props)
    return gj, gt


def _assert_same_graph(gj, gt):
    for a, b in zip(gt.edgelist_arrays(), gj.edgelist_arrays()):
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for name in ("edge_ids", "edge_types", "edge_times"):
        a, b = getattr(gt, name), getattr(gj, name)
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(gt.nodes(), gj.nodes())
    assert gt.is_multigraph() == gj.is_multigraph()
    assert gt.number_of_edges() == gj.number_of_edges()


# -- the path that keeps edges ------------------------------------------------

@pytest.mark.parametrize("cls,which", [
    ("Graph", ("id",)), ("Graph", ("id", "type", "time")),
    ("MultiGraph", ()), ("MultiGraph", ("id", "type", "time"))])
@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("kind", ["dups", "karate", "sparse"])
def test_edges_and_properties_match_jax(cls, directed, kind, which):
    src, dst, w = _edges(kind)
    props = _props(len(src), 1, which)
    gj, gt = _pair(cls, directed, src, dst, w, **props)
    _assert_same_graph(gj, gt)
    if cls == "Graph":
        assert gt.density() == gj.density()
    else:
        with pytest.raises(TypeError, match="Multigraph"):
            gt.density()


@pytest.mark.parametrize("directed", [False, True])
def test_unweighted_and_renumber_false_keep_edges(directed):
    src, dst, _ = _edges("dups", 3)
    props = _props(len(src), 3, ("id", "type"))
    for kw in (dict(), dict(renumber=False)):
        gj = ctpu.Graph(directed=directed).from_edgelist(src, dst, None,
                                                         **props, **kw)
        gt = ct.Graph(directed=directed, device="cpu").from_edgelist(
            src, dst, None, **props, **kw)
        _assert_same_graph(gj, gt)
    df = pd.DataFrame({"s": src, "d": dst})
    gj = ctpu.MultiGraph(directed=directed).from_edgelist(df, "s", "d")
    gt = ct.MultiGraph(directed=directed, device="cpu").from_edgelist(
        df, "s", "d")
    _assert_same_graph(gj, gt)


def test_property_length_is_checked():
    src, dst, w = _edges("karate")
    for name in ("edge_id", "edge_type", "edge_time"):
        with pytest.raises(ct.InvalidInputError, match=name):
            ct.Graph(device="cpu").from_edgelist(src, dst, w,
                                                 **{name: np.arange(3)})
    G = ct.Graph(device="cpu").from_edgelist(src, dst, w)
    assert G.edge_ids is None and G.edge_types is None
    assert G.edge_times is None and not G.is_multigraph()
    assert ct.DiGraph(device="cpu").from_edgelist(src, dst).density() == \
        ctpu.DiGraph().from_edgelist(src, dst).density()


@pytest.mark.parametrize("size,high", [(0, 1), (1, 1), (1000, 10),
                                       (5000, 1 << 40), (20000, 300)])
def test_first_occurrences_equal_np_unique(size, high):
    key = np.random.default_rng(size).integers(0, high, size, dtype=np.int64)
    _, want = np.unique(key, return_index=True)
    got = tpre.first_occurrences(key, "cpu")
    np.testing.assert_array_equal(got, np.sort(want))


# -- the CSR's permutation and properties in CSR order -----------------------

@pytest.mark.parametrize("cls,directed", [("Graph", True), ("Graph", False),
                                          ("MultiGraph", False),
                                          ("MultiGraph", True)])
def test_csr_perm_is_lexsort_and_props_follow_it(cls, directed):
    src, dst, w = _edges("dups", 5)
    props = _props(len(src), 5, ("id", "type", "time"))
    gj, gt = _pair(cls, directed, src, dst, w, **props)
    s, d, _ = gt.edgelist_arrays()
    csr = gt.structure.csr
    np.testing.assert_array_equal(csr.perm.numpy(), np.lexsort((d, s)))
    np.testing.assert_array_equal(csr.perm.numpy(), jS._csr_perm(gj))
    m = csr.num_edges
    for name, attr in (("edge_id", "edge_ids"), ("edge_type", "edge_types"),
                       ("edge_time", "edge_times")):
        got = tS._csr_prop(gt, name).numpy()
        want = jS._csr_prop(gj, getattr(gj, attr))[:m]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # the CSC's permutation too: (dst, src) order
    np.testing.assert_array_equal(gt.structure.csc.perm.numpy(),
                                  np.lexsort((s, d)))


def test_rmat_accepts_the_id_and_type_keywords():
    kw = dict(seed=4, include_edge_weights=True, include_edge_ids=True,
              include_edge_types=True, min_edge_type_value=1,
              max_edge_type_value=5)
    want = ctpu.rmat(9, 16 << 9, **kw)
    got = ct.rmat(9, 16 << 9, **kw)
    pd.testing.assert_frame_equal(got, want)
    assert list(got.columns) == ["src", "dst", "weights"]
    gj = ctpu.rmat(8, 1 << 11, create_using=ctpu.MultiGraph, **kw)
    gt = ct.rmat(8, 1 << 11, create_using=ct.MultiGraph(device="cpu"), **kw)
    _assert_same_graph(gj, gt)


# -- the edge-id lookup ------------------------------------------------------

@pytest.mark.parametrize("directed", [True, False])
@pytest.mark.parametrize("typed", [True, False])
def test_lookup_matches_jax(directed, typed):
    src, dst, w = _edges("sparse", 7)
    props = _props(len(src), 7, ("id", "type") if typed else ("id",))
    gj, gt = _pair("Graph", directed, src, dst, w, **props)
    tj, tt = ctpu.EdgeIdLookupTable(gj), ct.edge_id_lookup_table(gt)
    rng = np.random.default_rng(8)
    ids = np.concatenate([props["edge_id"][rng.integers(0, len(src), 200)],
                          rng.integers(-5, 600, 200),     # misses
                          [-1, 0, 509, 510, 1 << 40]])    # out of range
    for etype in (0, 1, 2, 7):
        want = tj.lookup_vertex_ids(ids, etype)
        got = tt.lookup_vertex_ids(ids, etype)
        pd.testing.assert_frame_equal(got, want)
        hits = (got["src"] != -1).any()
        assert (got["src"] == -1).any() and hits == (etype in (
            (0, 1, 2) if typed else (0,)))
    # a hit is the stored edge with that (type, id)
    s, d, _ = gt.edgelist_arrays()
    ext_s = gt.number_map.to_external(s)
    ext_d = gt.number_map.to_external(d)
    types = gt.edge_types if typed else np.zeros(len(s), np.int32)
    for etype in (0, 1):
        got = tt.lookup_vertex_ids(gt.edge_ids, etype)
        mine = types == etype
        first = {}
        for i in np.flatnonzero(mine):
            first.setdefault(int(gt.edge_ids[i]), i)
        rows = got[mine]
        exp = np.array([first[int(e)] for e in rows["edge_id"]], np.int64)
        np.testing.assert_array_equal(rows["src"].to_numpy(), ext_s[exp])
        np.testing.assert_array_equal(rows["dst"].to_numpy(), ext_d[exp])


def test_lookup_errors_and_empty():
    src, dst, w = _edges("karate")
    with pytest.raises(ValueError, match="edge_id"):
        ct.EdgeIdLookupTable(ct.Graph(device="cpu").from_edgelist(src, dst))
    e = np.array([], np.int64)
    gj, gt = _pair("Graph", True, e, e, None, edge_id=e)
    pd.testing.assert_frame_equal(
        ct.EdgeIdLookupTable(gt).lookup_vertex_ids([1, 2]),
        ctpu.EdgeIdLookupTable(gj).lookup_vertex_ids([1, 2]))


# -- algos/structure.py ------------------------------------------------------

@pytest.fixture(params=[("karate", False), ("dups", True), ("dups", False),
                        ("sparse", True)])
def graphs(request):
    kind, directed = request.param
    src, dst, w = _edges(kind, 9)
    return _pair("Graph", directed, src, dst, w), src, dst, w


def test_symmetrize_matches_jax(graphs):
    _, src, dst, w = graphs
    for args in ((src, dst), (src, dst, w)):
        got = ct.symmetrize(*args)
        want = ctpu.symmetrize(*args)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    df = pd.DataFrame({"src": src, "dst": dst, "wgt": w,
                       "edge_type": np.arange(len(src)) % 3})
    pd.testing.assert_frame_equal(ct.symmetrize(df), ctpu.symmetrize(df))
    pd.testing.assert_frame_equal(ct.symmetrize(df, value_col="edge_type"),
                                  ctpu.symmetrize(df, value_col="edge_type"))


def test_induced_subgraph_and_subgraph_match_jax(graphs):
    (gj, gt), src, _, _ = graphs
    verts = np.unique(src)[::2]
    a, oa = ct.induced_subgraph(gt, verts)
    b, ob = ctpu.induced_subgraph(gj, verts)
    pd.testing.assert_frame_equal(a, b)
    np.testing.assert_array_equal(oa, ob)
    _assert_same_graph(ctpu.subgraph(gj, verts), ct.subgraph(gt, verts))
    assert ct.subgraph(gt, verts).device == gt.device


def test_two_and_k_hop_neighbors_match_jax(graphs):
    (gj, gt), src, _, _ = graphs
    pd.testing.assert_frame_equal(ct.two_hop_neighbors(gt),
                                  ctpu.two_hop_neighbors(gj))
    pd.testing.assert_frame_equal(ct.k_hop_neighbors(gt, src[:3], 2),
                                  jstruct.k_hop_neighbors(gj, src[:3], 2))


def test_edge_list_utilities_match_jax(graphs):
    (gj, gt), _, _, _ = graphs
    for fn in ("decompress_to_edgelist", "replicate_edgelist"):
        pd.testing.assert_frame_equal(getattr(ct, fn)(gt),
                                      getattr(ctpu, fn)(gj))
    np.testing.assert_array_equal(ct.extract_vertex_list(gt),
                                  ctpu.extract_vertex_list(gj))
    for seed in (None, 0, 5):
        n = min(7, gt.number_of_vertices())
        if seed is None:
            assert len(np.unique(ct.select_random_vertices(gt, n))) == n
        else:
            np.testing.assert_array_equal(
                ct.select_random_vertices(gt, n, random_state=seed),
                ctpu.select_random_vertices(gj, n, random_state=seed))
    with pytest.raises(ValueError):
        ct.select_random_vertices(gt, gt.number_of_vertices() + 1)
    assert ct.count_multi_edges(gt) == ctpu.count_multi_edges(gj) == 0


def test_weight_sums_match_jax(graphs):
    (gj, gt), src, dst, _ = graphs
    for fn in ("out_weight_sums", "in_weight_sums"):
        a, b = getattr(ct, fn)(gt), getattr(ctpu, fn)(gj)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert ct.total_edge_weight(gt) == ctpu.total_edge_weight(gj)
    uj, ut = _pair("Graph", gt.is_directed(), src, dst, None)
    np.testing.assert_array_equal(ct.out_weight_sums(ut),
                                  ctpu.out_weight_sums(uj))
    assert ct.total_edge_weight(ut) == ctpu.total_edge_weight(uj)


@pytest.mark.parametrize("directed", [False, True])
def test_multigraph_edge_frames_match_jax(directed):
    src, dst, w = _edges("dups", 11)
    props = _props(len(src), 11, ("id", "type"))
    gj, gt = _pair("MultiGraph", directed, src, dst, w, **props)
    assert ct.count_multi_edges(gt) == ctpu.count_multi_edges(gj) > 0
    pd.testing.assert_frame_equal(ct.decompress_to_edgelist(gt),
                                  ctpu.decompress_to_edgelist(gj))
    s, d, _ = gt.edgelist_arrays()
    key = s.astype(np.int64) * gt.number_of_vertices() + d
    assert ct.count_multi_edges(gt) == len(key) - len(np.unique(key))


def test_renumber_arbitrary_edgelist_matches_jax():
    rng = np.random.default_rng(12)
    src = rng.integers(-(1 << 40), 1 << 40, 300)
    dst = np.concatenate([src[100:], rng.integers(0, 1 << 62, 100)])
    for a, b in zip(ct.renumber_arbitrary_edgelist(src, dst),
                    ctpu.renumber_arbitrary_edgelist(src, dst)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("direct", [False, True])
def test_hypergraph_matches_jax(direct):
    rng = np.random.default_rng(13)
    df = pd.DataFrame({"a": rng.integers(0, 5, 30), "b": rng.choice(
        ["x", "y", "z"], 30), "c": rng.integers(0, 3, 30)})
    nt, et, gt = ct.hypergraph(df, direct=direct, device="cpu")
    nj, ej, gj = ctpu.hypergraph(df, direct=direct)
    pd.testing.assert_frame_equal(nt, nj)
    pd.testing.assert_frame_equal(et, ej)
    _assert_same_graph(gj, gt)
    with pytest.raises(ValueError):
        ct.hypergraph(df, columns=["a"], direct=True, device="cpu")
