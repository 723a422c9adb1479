"""Host layer of the PyTorch port (cugraph_tpu_torch) against cugraph_tpu.

The same inputs, made from numpy seeds, go through both packages on the
CPU; generation, renumbering, de-duplication and the CSR/CSC build must
agree exactly.
"""

import subprocess
import sys

import networkx as nx
import numpy as np
import pytest
import torch

import cugraph_tpu as ctpu
from cugraph_tpu.core import preprocess as jpre
from cugraph_tpu.core.renumber import renumber_edgelist as j_renumber
from cugraph_tpu.core.structure import build_structure_host

import cugraph_tpu_torch as ct
from cugraph_tpu_torch.core import preprocess as tpre
from cugraph_tpu_torch.core.convert import structure_from_jax_arrays
from cugraph_tpu_torch.core.renumber import renumber_edgelist as t_renumber
from cugraph_tpu_torch.core.structure import (build_structure,
                                              check_edge_count)

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.mark.parametrize("scale,clip,scramble,weights", [
    (10, False, False, False),
    (10, True, False, True),
    (11, False, True, False),
    (12, True, True, True),
])
def test_rmat_bit_identical(scale, clip, scramble, weights):
    kw = dict(seed=scale + 3, clip_and_flip=clip,
              scramble_vertex_ids=scramble, include_edge_weights=weights)
    want = ctpu.rmat(scale, 16 << scale, **kw)
    got = ct.rmat(scale, 16 << scale, **kw)
    assert list(got.columns) == list(want.columns)
    for col in want.columns:
        assert got[col].dtype == want[col].dtype
        np.testing.assert_array_equal(got[col].to_numpy(),
                                      want[col].to_numpy())


def test_rmat_graph500_parameters_and_batch():
    a, b, c = 0.57, 0.19, 0.19
    want = ctpu.rmat(11, 1 << 14, a=a, b=b, c=c, seed=7)
    got = ct.generate_rmat_edgelist(11, 1 << 14, a=a, b=b, c=c, seed=7)
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())
    for g, w in zip(ct.generate_rmat_edgelists(3, 8, 10, seed=5),
                    ctpu.generate_rmat_edgelists(3, 8, 10, seed=5)):
        np.testing.assert_array_equal(g.to_numpy(), w.to_numpy())
    with pytest.raises(ValueError):
        ct.rmat(8, 100, a=0.6, b=0.3, c=0.3)
    with pytest.raises(ValueError, match="int32"):
        ct.rmat(32, 10)


@pytest.mark.parametrize("sort_by_degree", [True, False])
@pytest.mark.parametrize("with_vertices", [False, True])
def test_renumber_matches_exactly(sort_by_degree, with_vertices):
    rng = np.random.default_rng(3)
    # sparse external ids and many equal degrees: ties decide the order
    ids = rng.choice(10**9, 300, replace=False).astype(np.int64)
    src = ids[rng.integers(0, 300, 900)]
    dst = ids[rng.integers(0, 300, 900)]
    vertices = (np.concatenate([ids[:5], [10**9 + 1, 10**9 + 7]])
                if with_vertices else None)
    s_j, d_j, m_j = j_renumber(src, dst, sort_by_degree=sort_by_degree,
                               vertices=vertices)
    s_t, d_t, m_t = t_renumber(src, dst, sort_by_degree=sort_by_degree,
                               vertices=vertices)
    np.testing.assert_array_equal(s_t, s_j)
    np.testing.assert_array_equal(d_t, d_j)
    assert s_t.dtype == np.int32
    n = m_j.num_vertices
    assert m_t.num_vertices == n
    np.testing.assert_array_equal(m_t.to_external(np.arange(n)),
                                  m_j.to_external(np.arange(n)))
    probe = np.concatenate([ids[:10], [-5, 10**9 + 1]])
    np.testing.assert_array_equal(m_t.contains(probe), m_j.contains(probe))
    np.testing.assert_array_equal(m_t.to_internal(ids[:10]),
                                  m_j.to_internal(ids[:10]))
    with pytest.raises(ValueError, match="not in graph"):
        m_t.to_internal(np.array([-5]))


def _number_maps(ids_kind):
    """(src, dst, JAX NumberMap, port NumberMap) of one edge list over
    int64 ids with gaps, or strings."""
    rng = np.random.default_rng(21)
    ids = rng.choice(10**12, 40, replace=False).astype(np.int64)
    if ids_kind == "str":
        ids = np.array([f"v{i}" for i in ids], dtype=object)
    src = ids[rng.integers(0, 40, 120)]
    dst = ids[rng.integers(0, 40, 120)]
    _, _, m_j = j_renumber(src, dst)
    _, _, m_t = t_renumber(src, dst)
    return src, dst, m_j, m_t


@pytest.mark.parametrize("ids_kind", ["int64", "str"])
def test_number_map_frame_methods_match(ids_kind):
    import pandas as pd

    from cugraph_tpu.core.renumber import NumberMap as JMap
    from cugraph_tpu_torch.core.renumber import NumberMap as TMap

    src, dst, m_j, m_t = _number_maps(ids_kind)
    n = m_j.num_vertices
    present = m_j.to_external(np.arange(n))
    ext = pd.DataFrame({"a": present[::-1], "b": np.roll(present, 7)})
    # to_internal_vertex_id: a frame column (str or list), a Series, an array
    for args in ((ext, "a"), (ext, ["b"]), (ext["a"], None),
                 (present[5:9], None)):
        np.testing.assert_array_equal(m_t.to_internal_vertex_id(*args),
                                      m_j.to_internal_vertex_id(*args))
    internal = pd.DataFrame({"id": np.arange(n)[::-1].astype(np.int32),
                             "x": np.arange(n, dtype=np.float64)})
    # from_internal_vertex_id: the "0" default, named columns, drop
    for kw in ({}, {"internal_column_name": "id"},
               {"external_column_names": "ext"},
               {"external_column_names": ["ext"], "drop": True},
               {"internal_column_name": "id", "drop": True}):
        pd.testing.assert_frame_equal(m_t.from_internal_vertex_id(internal,
                                                                  **kw),
                                      m_j.from_internal_vertex_id(internal,
                                                                  **kw))
    np.testing.assert_array_equal(
        m_t.from_internal_vertex_id(np.arange(n)[::2]),
        m_j.from_internal_vertex_id(np.arange(n)[::2]))
    # add_internal_vertex_id and unrenumber
    for col_names, drop in (("a", False), (["b"], True)):
        pd.testing.assert_frame_equal(
            m_t.add_internal_vertex_id(ext, "id", col_names, drop=drop),
            m_j.add_internal_vertex_id(ext, "id", col_names, drop=drop))
    pd.testing.assert_frame_equal(m_t.unrenumber(internal, "id"),
                                  m_j.unrenumber(internal, "id"))
    assert m_t.vertex_column_size() == m_j.vertex_column_size() == 1
    # the static renumber, on a frame with an extra column
    df = pd.DataFrame({"s": src, "w": np.linspace(0.0, 1.0, len(src)),
                       "d": dst})
    for cols in (("s", "d"), (["s"], ["d"])):
        got, gmap = TMap.renumber(df, *cols)
        want, wmap = JMap.renumber(df, *cols)
        pd.testing.assert_frame_equal(got, want)
        assert list(got.columns) == ["src", "dst", "w"]
        assert isinstance(gmap, TMap)
        np.testing.assert_array_equal(gmap.to_external(np.arange(n)),
                                      wmap.to_external(np.arange(n)))


def _edge_set(src, dst, w):
    order = np.lexsort((dst, src))
    return (src[order], dst[order], None if w is None else w[order])


@pytest.mark.parametrize("weighted", [False, True])
def test_preprocess_matches(weighted):
    rng = np.random.default_rng(11)
    src = rng.integers(0, 40, 400).astype(np.int32)
    dst = rng.integers(0, 40, 400).astype(np.int32)
    w = rng.random(400).astype(np.float32) if weighted else None
    got = tpre.remove_multi_edges(src, dst, w)
    want = jpre.remove_multi_edges(src, dst, w)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)
    got = _edge_set(*tpre.symmetrize_edgelist(src, dst, w))
    want = _edge_set(*jpre.symmetrize_edgelist(src, dst, w))
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)
    for keep in ("sum", "min", "max"):
        if weighted:
            got = _edge_set(*tpre.remove_multi_edges(src, dst, w, keep=keep))
            want = _edge_set(*jpre.remove_multi_edges(src, dst, w, keep=keep))
            for g, x in zip(got, want):
                np.testing.assert_allclose(g, x, rtol=1e-6)


def _graph_inputs(kind):
    rng = np.random.default_rng(5)
    if kind == "karate":
        e = np.array(list(nx.karate_club_graph().edges()))
        return e[:, 0], e[:, 1], None, False
    if kind == "directed_weighted":
        src = rng.integers(0, 60, 500)
        dst = rng.integers(0, 60, 500)
        return src, dst, rng.random(500).astype(np.float32), True
    if kind == "undirected_weighted_loops":
        src = rng.integers(0, 30, 200)
        dst = np.where(rng.random(200) < 0.1, src, rng.integers(0, 30, 200))
        return src, dst, rng.random(200).astype(np.float32), False
    e = ctpu.rmat(10, 1 << 14, seed=1)
    return e["src"].to_numpy(), e["dst"].to_numpy(), None, True


def _assert_structure_equal(got, want_csr, want_csc, n, m):
    for ours, theirs in ((got.csr, want_csr), (got.csc, want_csc)):
        assert ours.offsets.dtype == torch.int32
        assert ours.indices.dtype == torch.int32
        assert ours.weights.dtype == torch.float32
        np.testing.assert_array_equal(ours.offsets.numpy(),
                                      np.asarray(theirs.offsets)[:n + 1])
        np.testing.assert_array_equal(ours.indices.numpy(),
                                      np.asarray(theirs.indices)[:m])
        np.testing.assert_array_equal(ours.weights.numpy(),
                                      np.asarray(theirs.weights)[:m])


@pytest.mark.parametrize("kind", ["karate", "directed_weighted",
                                  "undirected_weighted_loops", "rmat10"])
def test_graph_structure_matches_jax(kind):
    src, dst, w, directed = _graph_inputs(kind)
    Gj = ctpu.Graph(directed=directed).from_edgelist(src, dst, w)
    Gt = ct.Graph(directed=directed, device="cpu").from_edgelist(src, dst, w)
    n, m = Gj.number_of_vertices(), int(Gj.edgelist_arrays()[0].shape[0])
    assert Gt.number_of_vertices() == n
    assert Gt.number_of_edges() == Gj.number_of_edges()
    assert Gt.is_directed() == directed
    assert Gt.is_weighted() == (w is not None)
    got = Gt.structure
    assert got.num_vertices == n and got.num_edges == m
    assert got.device == CPU
    js = Gj.structure
    _assert_structure_equal(got, js.csr, js.csc, n, m)
    # the same structure built from the JAX graph's own edge list
    s, d, ww = Gj.edgelist_arrays()
    want = build_structure_host(s, d, ww, n)
    _assert_structure_equal(build_structure(s, d, ww, n, "cpu"),
                            want.csr, want.csc, n, m)
    # carried across from the JAX arrays, sink row and padding dropped
    conv = structure_from_jax_arrays(
        tuple(np.asarray(a) for a in (js.csr.offsets, js.csr.indices,
                                      js.csr.weights)),
        tuple(np.asarray(a) for a in (js.csc.offsets, js.csc.indices,
                                      js.csc.weights)),
        n, m, device="cpu")
    for a, b in ((conv.csr, got.csr), (conv.csc, got.csc)):
        for x, y in ((a.offsets, b.offsets), (a.indices, b.indices),
                     (a.weights, b.weights)):
            assert torch.equal(x, y)
    np.testing.assert_array_equal(got.out_degrees().numpy(),
                                  np.asarray(js.out_degrees())[:n])
    np.testing.assert_array_equal(got.in_degrees().numpy(),
                                  np.asarray(js.in_degrees())[:n])
    np.testing.assert_array_equal(got.csc.row_ids().numpy(),
                                  np.asarray(js.csc.majors)[:m])
    with pytest.raises(ValueError, match="padded offsets"):
        structure_from_jax_arrays(
            (np.asarray(js.csr.offsets), np.asarray(js.csr.indices),
             np.asarray(js.csr.weights)),
            (np.asarray(js.csc.offsets), np.asarray(js.csc.indices),
             np.asarray(js.csc.weights)), n, m + 1, device="cpu")


def test_graph_surface_matches_jax():
    import pandas as pd

    rng = np.random.default_rng(8)
    ids = rng.choice(10**6, 40, replace=False)
    df = pd.DataFrame({"a": ids[rng.integers(0, 40, 150)],
                       "b": ids[rng.integers(0, 40, 150)],
                       "weight": rng.random(150).astype(np.float32)})
    Gj = ctpu.Graph(directed=True).from_edgelist(df, "a", "b")
    Gt = ct.DiGraph(device="cpu").from_edgelist(df, "a", "b")
    assert Gt.is_directed() and Gt.is_weighted()
    for x, y in zip(Gt.edgelist_arrays(), Gj.edgelist_arrays()):
        np.testing.assert_array_equal(x, y)
    pd.testing.assert_frame_equal(Gt.degrees(), Gj.degrees())
    pd.testing.assert_frame_equal(Gt.degrees(ids[:5]), Gj.degrees(ids[:5]))
    np.testing.assert_array_equal(Gt.lookup_internal_vertex_id(ids[:7]),
                                  Gj.lookup_internal_vertex_id(ids[:7]))
    assert Gt.has_vertex(ids[0]) and not Gt.has_vertex(-1)
    pf = df.rename(columns={"a": "source", "b": "destination"})
    Hj = ctpu.Graph().from_pandas_edgelist(pf, edge_attr="weight")
    Ht = ct.Graph(device="cpu").from_pandas_edgelist(pf, edge_attr="weight")
    s_t, d_t, w_t = _edge_set(*Ht.edgelist_arrays())
    s_j, d_j, w_j = _edge_set(*Hj.edgelist_arrays())
    np.testing.assert_array_equal(s_t, s_j)
    np.testing.assert_array_equal(d_t, d_j)
    np.testing.assert_array_equal(w_t, w_j)
    G0 = ct.Graph(device="cpu").from_edgelist(np.array([0, 5]),
                                              np.array([5, 9]),
                                              renumber=False)
    assert G0.number_of_vertices() == 10
    with pytest.raises(ct.InvalidInputError):
        G0.from_edgelist(np.array([1]), np.array([2]))
    with pytest.raises(ct.InvalidInputError):
        ct.Graph(device="cpu").from_edgelist(np.array([1, 2]), np.array([2]))
    with pytest.raises(ct.InvalidInputError):
        ct.Graph(device="cpu").number_of_vertices()


def test_graph_device_defaults_to_the_card():
    if torch.cuda.is_available():
        assert ct.Graph().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ct.Graph()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ct.DiGraph()


def test_int32_edge_bound():
    check_edge_count((1 << 31) - 1)
    with pytest.raises(ValueError, match="int32"):
        check_edge_count(1 << 31)


def test_import_leaves_jax_out():
    """Every submodule of the port, found by walking the package, imports
    without bringing in jax, optax or cugraph_tpu; the package itself does
    not import its multi-device layer (``parallel``)."""
    code = ("import importlib, pkgutil, sys, cugraph_tpu_torch as p; "
            "assert 'cugraph_tpu_torch.parallel' not in sys.modules; "
            "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
            "'cugraph_tpu_torch.')]; "
            "[importlib.import_module(m) for m in names]; "
            "want = {'cugraph_tpu_torch.testing.graph500', "
            "'cugraph_tpu_torch.testing.heavy_rows', "
            "'cugraph_tpu_torch.testing.bits', "
            "'cugraph_tpu_torch.testing.picks', "
            "'cugraph_tpu_torch.kernels.spmm', "
            "'cugraph_tpu_torch.algos.centrality', "
            "'cugraph_tpu_torch.api.convenience', "
            "'cugraph_tpu_torch.nn.layers', 'cugraph_tpu_torch.nn.models', "
            "'cugraph_tpu_torch.nn.convert', "
            "'cugraph_tpu_torch.core.native', "
            "'cugraph_tpu_torch.algos.cores', "
            "'cugraph_tpu_torch.algos.community', "
            "'cugraph_tpu_torch.algos.link_prediction', "
            "'cugraph_tpu_torch.algos.components', "
            "'cugraph_tpu_torch.algos.sampling', "
            "'cugraph_tpu_torch.algos.sampling_post', "
            "'cugraph_tpu_torch.algos._frontier', "
            "'cugraph_tpu_torch.prims.intersection', "
            "'cugraph_tpu_torch.kernels.dispatch', "
            "'cugraph_tpu_torch.kernels.spill', "
            "'cugraph_tpu_torch.nn.minibatch', "
            "'cugraph_tpu_torch.nn.linkpred', "
            "'cugraph_tpu_torch.algos.lookup', "
            "'cugraph_tpu_torch.algos.structure', "
            "'cugraph_tpu_torch.algos._oriented_tri', "
            "'cugraph_tpu_torch.algos.dag', "
            "'cugraph_tpu_torch.algos.tree', "
            "'cugraph_tpu_torch.algos.layout', "
            "'cugraph_tpu_torch.algos.linear_assignment', "
            "'cugraph_tpu_torch.experimental', "
            "'cugraph_tpu_torch.experimental.bicliques', "
            "'cugraph_tpu_torch.api.bipartite', "
            "'cugraph_tpu_torch.generators.simple', "
            "'cugraph_tpu_torch.datasets', "
            "'cugraph_tpu_torch.datasets.readers', "
            "'cugraph_tpu_torch.utils', "
            "'cugraph_tpu_torch.utils.path_retrieval', "
            "'cugraph_tpu_torch.utils.validation', "
            "'cugraph_tpu_torch.utils.profiling', "
            "'cugraph_tpu_torch.utils.memory', "
            "'cugraph_tpu_torch.etl', 'cugraph_tpu_torch.internals', "
            "'cugraph_tpu_torch.testing', "
            "'cugraph_tpu_torch.centrality', 'cugraph_tpu_torch.community', "
            "'cugraph_tpu_torch.components', 'cugraph_tpu_torch.cores', "
            "'cugraph_tpu_torch.layout', "
            "'cugraph_tpu_torch.linear_assignment', "
            "'cugraph_tpu_torch.link_analysis', "
            "'cugraph_tpu_torch.link_prediction', "
            "'cugraph_tpu_torch.sampling', 'cugraph_tpu_torch.structure', "
            "'cugraph_tpu_torch.traversal', 'cugraph_tpu_torch.tree', "
            "'cugraph_tpu_torch.utilities', "
            "'cugraph_tpu_torch.plc', 'cugraph_tpu_torch.plc.graphs', "
            "'cugraph_tpu_torch.plc.algorithms', "
            "'cugraph_tpu_torch.plc.internal_types', "
            "'cugraph_tpu_torch.plc.internal_types.coo', "
            "'cugraph_tpu_torch.plc.internal_types.sampling_result', "
            "'cugraph_tpu_torch.plc.internal_types.edge_id_lookup_result', "
            "'cugraph_tpu_torch.parallel', 'cugraph_tpu_torch.parallel.mesh', "
            "'cugraph_tpu_torch.parallel.partition', "
            "'cugraph_tpu_torch.parallel.prims', "
            "'cugraph_tpu_torch.parallel.algos', "
            "'cugraph_tpu_torch.parallel.louvain', "
            "'cugraph_tpu_torch.parallel.nn', "
            "'cugraph_tpu_torch.parallel.shuffle', "
            "'cugraph_tpu_torch.parallel.sampling_mg', "
            "'cugraph_tpu_torch.parallel.construct', "
            "'cugraph_tpu_torch.parallel.lookup', "
            "'cugraph_tpu_torch.parallel.kvcache', "
            "'cugraph_tpu_torch.plc.comms', "
            "'cugraph_tpu_torch.plc.comms.comms_wrapper', "
            "'cugraph_tpu_torch.plc.comms.cugraph_comms', "
            "'cugraph_tpu_torch.dask', 'cugraph_tpu_torch.mtmg'}; "
            "assert want <= set(names), names; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'optax', 'cugraph_tpu')]; "
            "print(len(names), bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.cuda
def test_structure_on_the_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    src, dst, w, directed = _graph_inputs("directed_weighted")
    cpu = ct.Graph(directed=directed, device="cpu").from_edgelist(src, dst, w)
    gpu = ct.Graph(directed=directed).from_edgelist(src, dst, w)
    for a, b in ((cpu.structure.csr, gpu.structure.csr),
                 (cpu.structure.csc, gpu.structure.csc)):
        assert b.offsets.is_cuda
        for x, y in ((a.offsets, b.offsets), (a.indices, b.indices),
                     (a.weights, b.weights)):
            assert torch.equal(x, y.cpu())
