"""The Graph and API long tail of the PyTorch port against ``cugraph_tpu``:
Graph's remaining members, ``Tree``, ``BiPartiteGraph`` and
``NPartiteGraph``, the constructors and exporters of
``api/convenience.py``, the predicates, ``generators.simple``,
``bfs_edges``, ``shortest_path`` and ``symmetrize_df``; and the ``dir()``
parity of both packages and both ``Graph`` classes.

Every comparison is exact: frames equal (``pd.testing.assert_frame_equal``
after the same sort), generated frames bit for bit (both draw from one
``np.random.default_rng(seed)`` stream), ``to_numpy_array`` bit for bit,
including where the JAX package's loop overwrites a cell (a MultiGraph's
parallel edges, an undirected graph's edge listed in both directions).
"""

import json
import subprocess
import sys
import types

import numpy as np
import pandas as pd
import pytest
import torch

import cugraph_tpu as jt
import cugraph_tpu_torch as ct
from cugraph_tpu.generators import simple as jsimple
from cugraph_tpu_torch.generators import simple as tsimple

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _graphs(cls_j, cls_t, *args, directed=False, **kw):
    """The same edge list in a JAX graph and in a port graph on the CPU."""
    gj = cls_j(directed=directed)
    gt = cls_t(directed=directed, device="cpu")
    return gj.from_edgelist(*args, **kw), gt.from_edgelist(*args, **kw)


def _edges(seed=0, n=30, m=90, weighted=True):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m) * 3 + 100  # sparse, non-contiguous ids
    dst = rng.integers(0, n, m) * 3 + 100
    src[:5] = dst[:5]  # self-loops
    src[5:10], dst[5:10] = dst[10:15], src[10:15]  # reversed repeats
    w = rng.uniform(0.1, 2.0, m).astype(np.float32) if weighted else None
    return src, dst, w


def _frame(G):
    el = G.view_edge_list()
    return el.sort_values(list(el.columns)).reset_index(drop=True)


def _same(gj, gt):
    pd.testing.assert_frame_equal(_frame(gt), _frame(gj))
    np.testing.assert_array_equal(np.sort(gt.nodes()), np.sort(gj.nodes()))
    assert gt.is_directed() == gj.is_directed()
    assert gt.number_of_edges() == gj.number_of_edges()


# -- dir() parity ------------------------------------------------------------

def _public(obj):
    return {n for n in dir(obj) if not n.startswith("_")
            and not isinstance(getattr(obj, n), types.ModuleType)}


def test_dir_parity_of_the_packages_and_the_graphs():
    """Every public name of cugraph_tpu has a counterpart; every member of
    cugraph_tpu.Graph has one.  The packages' names are read in a fresh
    interpreter: importing a subpackage adds its name to the package."""
    code = ("import json, cugraph_tpu as j, cugraph_tpu_torch as t; "
            "print(json.dumps([[n for n in dir(m) if not n.startswith('_')]"
            " for m in (j, t)]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    top_j, top_t = map(set, json.loads(out.stdout.strip().splitlines()[-1]))
    assert top_j - top_t == set()
    assert len(top_j) == 140
    assert _public(jt.Graph) <= _public(ct.Graph)
    assert len(_public(jt.Graph)) == 45
    for name in ("Tree", "MultiGraph", "DiGraph", "BiPartiteGraph",
                 "NPartiteGraph"):
        assert _public(getattr(jt, name)) <= _public(getattr(ct, name))


SUBPACKAGES = ["centrality", "community", "components", "cores", "datasets",
               "etl", "experimental", "generators", "internals", "layout",
               "linear_assignment", "link_analysis", "link_prediction", "nn",
               "sampling", "structure", "testing", "traversal", "tree",
               "utilities", "utils", "utils.memory", "utils.profiling",
               "utils.validation", "utils.path_retrieval",
               "datasets.readers", "generators.simple"]
# names with no counterpart yet (none: the multi-device names are ported)
LATER = {}


@pytest.mark.parametrize("name", SUBPACKAGES)
def test_dir_parity_of_the_subpackages(name):
    import importlib

    mj = importlib.import_module(f"cugraph_tpu.{name}")
    mt = importlib.import_module(f"cugraph_tpu_torch.{name}")
    assert _public(mj) - _public(mt) == LATER.get(name, set())
    for attr in _public(mt) & _public(mj):
        value = getattr(mt, attr)
        owner = getattr(value, "__module__", None) or ""
        assert not owner.startswith("cugraph_tpu."), (attr, owner)


# -- Graph's members ---------------------------------------------------------

@pytest.mark.parametrize("cls", ["Graph", "DiGraph", "MultiGraph", "Tree"])
def test_clear_keeps_class_directedness_and_device(cls):
    G = getattr(ct, cls)(device="cpu")
    directed = G.is_directed()
    G.from_edgelist(np.array([1, 2]), np.array([2, 3]))
    G.clear()
    assert type(G).__name__ == cls and G.device == CPU
    assert G.is_directed() == directed
    with pytest.raises(ct.InvalidInputError):
        G.number_of_vertices()
    G.from_edgelist(np.array([5]), np.array([6]))
    assert G.number_of_vertices() == 2
    if cls == "Tree":
        assert G.tree


@pytest.mark.parametrize("renumber", [True, False])
def test_add_nodes_from_keeps_isolated_vertices(renumber):
    out = []
    for Graph, kw in ((jt.Graph, {}), (ct.Graph, {"device": "cpu"})):
        G = Graph(**kw)
        G.add_nodes_from([0, 7, 9])
        G.add_nodes_from([9, 12])  # accumulates
        G.from_edgelist(np.array([0, 1]), np.array([1, 2]),
                        renumber=renumber)
        out.append(G)
        # consumed by that build: the next graph starts without them
        assert G._pending_nodes is None
    gj, gt = out
    np.testing.assert_array_equal(np.sort(gt.nodes()), np.sort(gj.nodes()))
    want = 6 if renumber else 13
    assert gt.number_of_nodes() == gj.number_of_nodes() == want
    assert gt.has_isolated_vertices() and gj.has_isolated_vertices()
    assert gt.is_renumbered() == gj.is_renumbered() == renumber


def test_graph_predicates_and_aliases():
    src, dst, w = _edges()
    gj, gt = _graphs(jt.Graph, ct.Graph, src, dst, w)
    for name in ("is_bipartite", "is_multipartite", "is_remote",
                 "is_multi_gpu", "is_renumbered", "has_isolated_vertices",
                 "number_of_nodes", "is_weighted", "is_multigraph",
                 "is_directed"):
        assert getattr(gt, name)() == getattr(gj, name)(), name
    np.testing.assert_array_equal(gt.vertices(), gt.nodes())
    for v in (100, 101, 103):
        assert gt.has_node(v) == gj.has_node(v)


def _adj_inputs():
    offsets = np.array([0, 2, 2, 5, 5, 6])  # rows 1 and 3 have no edges
    indices = np.array([1, 4, 0, 1, 4, 2])
    values = np.arange(1, 7, dtype=np.float32)
    return offsets, indices, values


@pytest.mark.parametrize("method", [
    "from_cudf_edgelist", "from_dask_cudf_edgelist", "from_cudf_adjlist",
    "from_numpy_array", "from_numpy_array_nodes", "from_numpy_matrix",
    "from_pandas_adjacency"])
@pytest.mark.parametrize("directed", [False, True])
def test_graph_construction_aliases(method, directed):
    src, dst, w = _edges(1)
    df = pd.DataFrame({"source": src, "destination": dst, "wt": w})
    A = np.zeros((6, 6), np.float32)
    A[[0, 1, 1, 3, 5], [1, 0, 2, 3, 1]] = [1.5, 2.0, 0.5, 4.0, 3.0]
    args = {
        "from_cudf_edgelist": ((df,), {"edge_attr": "wt"}),
        "from_dask_cudf_edgelist": ((df,), {"edge_attr": "wt"}),
        "from_cudf_adjlist": (_adj_inputs(), {}),
        "from_numpy_array": ((A,), {}),
        "from_numpy_array_nodes": ((A,), {"nodes": np.arange(6) * 10}),
        "from_numpy_matrix": ((np.asmatrix(A),), {}),
        "from_pandas_adjacency": ((pd.DataFrame(
            A, index=np.arange(6) + 50, columns=np.arange(6) + 50),), {}),
    }[method]
    name = method.replace("_nodes", "")
    gj = getattr(jt.Graph(directed=directed), name)(*args[0], **args[1])
    gt = getattr(ct.Graph(directed=directed, device="cpu"), name)(
        *args[0], **args[1])
    _same(gj, gt)
    assert gt.number_of_vertices() == gj.number_of_vertices()


@pytest.mark.parametrize("cls", ["Graph", "MultiGraph"])
@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("to", ["to_directed", "to_undirected"])
def test_to_directed_and_undirected(cls, directed, to):
    src, dst, w = _edges(2)
    src = np.concatenate([src, src[:4]])  # parallel edges
    dst = np.concatenate([dst, dst[:4]])
    w = np.concatenate([w, w[:4] + 1])
    gj, gt = _graphs(getattr(jt, cls), getattr(ct, cls), src, dst, w,
                     directed=directed)
    hj, ht = getattr(gj, to)(), getattr(gt, to)()
    assert type(ht) is type(gt) and ht.device == CPU
    _same(hj, ht)
    assert ht.is_multigraph() == hj.is_multigraph()


@pytest.mark.parametrize("ids", ["int", "str"])
def test_unrenumber_and_internal_ids(ids):
    src, dst, w = _edges(3)
    if ids == "str":
        src, dst = src.astype(str), dst.astype(str)
    gj, gt = _graphs(jt.Graph, ct.Graph, src, dst, w)
    n = gt.number_of_vertices()
    col = np.array([0, n - 1, -1, 3, -5, 2])
    df = pd.DataFrame({"v": col, "x": np.arange(6)})
    pd.testing.assert_frame_equal(gt.unrenumber(df, "v"),
                                  gj.unrenumber(df, "v"))
    pos = pd.DataFrame({"v": col[col >= 0]})
    pd.testing.assert_frame_equal(gt.unrenumber_frame(pos, "v"),
                                  gj.unrenumber_frame(pos, "v"))
    ext = pd.DataFrame({"e": gt.nodes()[[1, 0, 4]], "y": [1, 2, 3]})
    for drop in (True, False):
        pd.testing.assert_frame_equal(
            gt.add_internal_vertex_id(ext, "id", "e", drop=drop),
            gj.add_internal_vertex_id(ext, "id", "e", drop=drop))


def test_tree_class():
    src, dst, w = _edges(4)
    gj, gt = _graphs(jt.Tree, ct.Tree, src, dst, w)
    assert gt.tree and gj.tree
    _same(gj, gt)


# -- BiPartiteGraph and NPartiteGraph ----------------------------------------

def test_bipartite_graph_sets_and_isolated_partition_members():
    top, bottom = np.arange(6), np.arange(6, 10)
    src, dst = np.array([0, 1, 2, 2]), np.array([6, 7, 7, 9])
    out = []
    for cls, kw in ((jt.BiPartiteGraph, {}),
                    (ct.BiPartiteGraph, {"device": "cpu"})):
        B = cls(**kw)
        B.add_nodes_from(top, bipartite="top")
        B.add_nodes_from(bottom, bipartite=1)
        B.from_edgelist(src, dst)
        out.append(B)
    bj, bt = out
    for a, b in zip(bt.sets(), bj.sets()):
        np.testing.assert_array_equal(a, b)
    _same(bj, bt)
    assert bt.number_of_vertices() == bj.number_of_vertices() == 10
    assert bt.is_bipartite() and bt.is_multipartite()
    assert ct.is_bipartite(bt) and ct.is_multipartite(bt)
    with pytest.raises(TypeError):
        bt.add_nodes_from([1], multipartite="x")


def test_npartite_graph_and_its_errors():
    for cls, kw in ((jt.NPartiteGraph, {}),
                    (ct.NPartiteGraph, {"device": "cpu"})):
        N = cls(**kw)
        with pytest.raises(TypeError):
            N.add_nodes_from([1, 2], bipartite="top")
        with pytest.raises(TypeError):
            N.add_nodes_from([1, 2])
        with pytest.raises(RuntimeError):
            N.sets()
        N.add_nodes_from([1, 2], multipartite="a")
        N.add_nodes_from([3], multipartite="b")
        assert sorted(N.sets()) == ["a", "b"]
        assert N.is_multipartite() and not N.is_bipartite()
        N.from_edgelist(np.array([1]), np.array([3]))
        assert N.number_of_vertices() == 3
    B = ct.NPartiteGraph(bipartite=True, device="cpu")
    B.add_nodes_from([1], bipartite=0)
    assert B.is_bipartite()


# -- constructors and exporters ----------------------------------------------

class _CpuDiGraph(ct.DiGraph):
    """A class to pass as ``create_using``: a DiGraph on the CPU."""

    def __init__(self, directed=True, device="cpu"):
        super().__init__(directed=directed, device=device)


@pytest.mark.parametrize("fn", ["from_edgelist", "from_pandas_edgelist",
                                "from_cudf_edgelist"])
@pytest.mark.parametrize("create_using", ["none", "class", "instance"])
def test_frame_constructors(fn, create_using):
    src, dst, w = _edges(5)
    df = pd.DataFrame({"source": src, "destination": dst, "w": w})
    cu_j = {"none": None, "class": jt.DiGraph,
            "instance": jt.Graph(directed=True)}[create_using]
    cu_t = {"none": ct.Graph(device="cpu"),  # None means the card
            "class": _CpuDiGraph,
            "instance": ct.Graph(directed=True, device="cpu")}[create_using]
    gj = getattr(jt, fn)(df, edge_attr="w", create_using=cu_j)
    gt = getattr(ct, fn)(df, edge_attr="w", create_using=cu_t)
    _same(gj, gt)
    assert gt.device == CPU


def test_constructors_default_to_the_card():
    df = pd.DataFrame({"source": [0, 1], "destination": [1, 2]})
    if torch.cuda.is_available():
        assert ct.from_edgelist(df).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ct.from_edgelist(df)


@pytest.mark.parametrize("fn", ["from_adjlist", "from_numpy_array",
                                "from_numpy_matrix", "from_pandas_adjacency"])
def test_matrix_constructors(fn):
    A = np.zeros((7, 7), np.float32)
    A[[0, 0, 2, 4, 4, 6], [1, 3, 2, 5, 0, 6]] = [1, 2, 3, 4, 5, 6]
    args = {"from_adjlist": _adj_inputs(), "from_numpy_array": (A,),
            "from_numpy_matrix": (np.asmatrix(A),),
            "from_pandas_adjacency": (pd.DataFrame(
                A, index=np.arange(7) * 2, columns=np.arange(7) * 2),)}[fn]
    for directed in (False, True):
        gj = getattr(jt, fn)(*args, create_using=jt.Graph(directed=directed))
        gt = getattr(ct, fn)(*args, create_using=ct.Graph(directed=directed,
                                                           device="cpu"))
        _same(gj, gt)
        assert gt.number_of_vertices() == gj.number_of_vertices()
    gj = jt.from_numpy_array(A, vertices=np.arange(7) + 3)
    gt = ct.from_numpy_array(A, create_using=ct.Graph(device="cpu"),
                             vertices=np.arange(7) + 3)
    _same(gj, gt)


def _dense_case(case):
    """(JAX graph, port graph, nodelist or None)."""
    src, dst, w = _edges(6)
    if case == "directed":
        return (*_graphs(jt.Graph, ct.Graph, src, dst, w, directed=True),
                None)
    if case == "undirected":
        return (*_graphs(jt.Graph, ct.Graph, src, dst, w), None)
    if case == "undirected_repeat":
        # (a, b) then (b, a) with another weight: the stored pair keeps the
        # first, and the listed edge writes A[a, b] and A[b, a]
        s = np.array([1, 2, 3, 2, 5, 5])
        d = np.array([2, 1, 4, 3, 5, 1])
        ww = np.array([1, 2, 3, 4, 5, 6], np.float32)
        return (*_graphs(jt.Graph, ct.Graph, s, d, ww), None)
    if case == "multigraph":
        s = np.concatenate([src, src[:8], dst[8:12]])
        d = np.concatenate([dst, dst[:8], src[8:12]])
        ww = np.concatenate([w, w[:8] * 3, w[8:12] + 1])
        return (*_graphs(jt.MultiGraph, ct.MultiGraph, s, d, ww), None)
    if case == "multigraph_directed":
        s = np.concatenate([src, src[:8]])
        d = np.concatenate([dst, dst[:8]])
        ww = np.concatenate([w, w[:8] * 3])
        return (*_graphs(jt.MultiGraph, ct.MultiGraph, s, d, ww,
                         directed=True), None)
    if case == "unweighted_nodelist":
        gj, gt = _graphs(jt.Graph, ct.Graph, src, dst)
        nodes = np.concatenate([gt.nodes()[::-1], [999, 100]])  # 100 twice
        return gj, gt, nodes
    raise ValueError(case)


DENSE = ["directed", "undirected", "undirected_repeat", "multigraph",
         "multigraph_directed", "unweighted_nodelist"]


@pytest.mark.parametrize("case", DENSE)
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_to_numpy_array_bit_for_bit(case, dtype):
    gj, gt, nodes = _dense_case(case)
    want = jt.to_numpy_array(gj, nodes, dtype)
    got = ct.to_numpy_array(gt, nodes, dtype)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("case", DENSE)
def test_dense_exporters(case):
    gj, gt, nodes = _dense_case(case)
    m_t, m_j = ct.to_numpy_matrix(gt, nodes), jt.to_numpy_matrix(gj, nodes)
    assert isinstance(m_t, np.matrix)
    np.testing.assert_array_equal(m_t, m_j)
    pd.testing.assert_frame_equal(ct.to_pandas_adjacency(gt, nodes),
                                  jt.to_pandas_adjacency(gj, nodes))
    pd.testing.assert_frame_equal(
        ct.to_pandas_edgelist(gt).sort_values(["src", "dst"]).reset_index(
            drop=True),
        jt.to_pandas_edgelist(gj).sort_values(["src", "dst"]).reset_index(
            drop=True))


def test_to_numpy_array_missing_vertex_raises_key_error():
    gj, gt, _ = _dense_case("directed")
    nodes = gt.nodes()[1:]
    with pytest.raises(KeyError):
        jt.to_numpy_array(gj, nodes)
    with pytest.raises(KeyError):
        ct.to_numpy_array(gt, nodes)


@pytest.mark.parametrize("case", ["directed", "multigraph"])
def test_predicates(case):
    gj, gt, _ = _dense_case(case)
    for name in ("is_directed", "is_weighted", "is_multigraph",
                 "is_bipartite", "is_multipartite"):
        assert getattr(ct, name)(gt) == getattr(jt, name)(gj), name


# -- generators ---------------------------------------------------------------

GENERATORS = [
    ("path_graph", (7,), {}), ("path_graph", (5,), {"base": 3}),
    ("complete_graph", (6,), {}), ("complete_graph", (4,), {"base": 2}),
    ("star_graph", (6,), {}), ("star_graph", (5,), {"center": 2}),
    ("mesh_2d_graph", (4, 5), {}), ("mesh_3d_graph", (3, 4, 5), {}),
    ("mesh_3d_graph", (8, 8, 8), {}),
    ("erdos_renyi_gnp", (60, 0.1), {}),
    ("erdos_renyi_gnp", (60, 0.1), {"seed": 3, "directed": True}),
    ("erdos_renyi_gnm", (80, 300), {}),
    ("erdos_renyi_gnm", (20, 1000), {"seed": 5}),  # m > n(n-1)/2
    ("erdos_renyi_gnm", (2000, 3000), {"seed": 6}),  # the oversample path
    ("bipartite_rmat", (8, 6, 3000), {}),
    ("bipartite_rmat", (5, 9, 2000), {"seed": 11}),
]


@pytest.mark.parametrize("name,args,kw", GENERATORS)
def test_generators_bit_for_bit(name, args, kw):
    want = getattr(jsimple, name)(*args, **kw)
    got = getattr(tsimple, name)(*args, **kw)
    pd.testing.assert_frame_equal(got, want)


def test_sample_distinct_is_the_jax_draw():
    for total, m in ((100, 30), (1 << 22, 5000), (1 << 24, 1 << 18)):
        a = jsimple._sample_distinct(np.random.default_rng(1), total, m)
        b = tsimple._sample_distinct(np.random.default_rng(1), total, m)
        assert a.dtype == b.dtype and np.array_equal(a, b)


# -- traversal aliases and symmetrize ----------------------------------------

@pytest.mark.parametrize("directed", [False, True])
def test_bfs_edges_and_shortest_path(directed):
    src, dst, w = _edges(7)
    gj, gt = _graphs(jt.Graph, ct.Graph, src, dst, w, directed=directed)
    s = int(gt.nodes()[3])
    for depth in (None, 2):
        pd.testing.assert_frame_equal(
            ct.bfs_edges(gt, s, depth_limit=depth),
            jt.bfs_edges(gj, s, depth_limit=depth), check_dtype=False)
    pd.testing.assert_frame_equal(ct.shortest_path(gt, s),
                                  jt.shortest_path(gj, s), check_dtype=False)
    pd.testing.assert_frame_equal(ct.shortest_path(gt, indices=s),
                                  jt.shortest_path(gj, indices=s),
                                  check_dtype=False)
    for kw in ({"reverse": True}, {"sort_neighbors": "x"}):
        with pytest.raises(NotImplementedError):
            ct.bfs_edges(gt, s, **kw)


@pytest.mark.parametrize("fn", ["symmetrize_df", "symmetrize_ddf"])
@pytest.mark.parametrize("weight", [None, "w"])
def test_symmetrize_df(fn, weight):
    src, dst, w = _edges(8)
    df = pd.DataFrame({"src": src, "dst": dst, "w": w})
    got = getattr(ct, fn)(df, weight_name=weight)
    want = getattr(jt, fn)(df, weight_name=weight)
    key = list(got.columns)
    pd.testing.assert_frame_equal(
        got.sort_values(key).reset_index(drop=True),
        want.sort_values(key).reset_index(drop=True))
    assert getattr(ct, fn)(df, symmetrize=False) is df
