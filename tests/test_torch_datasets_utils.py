"""The port's datasets, readers, utils, etl, testing, internals and the
13 import-path subpackages against ``cugraph_tpu``'s, one parametrised
test per family so each case counts.

Every comparison is exact (frames equal, the same verdicts and
exceptions), but for ``get_traversed_cost``'s float64 sums, held within
rtol 1e-12, and the ForceAtlas2 positions, which only need to be the
ones the call returns.
"""

import gzip
import os
import warnings

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import cugraph_tpu as jt
import cugraph_tpu.datasets as jds
import cugraph_tpu.etl as jetl
import cugraph_tpu.testing as jtesting
import cugraph_tpu.utils as jutils
import cugraph_tpu_torch as ct
import cugraph_tpu_torch.datasets as tds
import cugraph_tpu_torch.etl as tetl
import cugraph_tpu_torch.testing as ttesting
import cugraph_tpu_torch.utils as tutils
from cugraph_tpu.internals import GraphBasedDimRedCallback as JCallback
from cugraph_tpu_torch.core.structure import build_structure
from cugraph_tpu_torch.internals import GraphBasedDimRedCallback
from cugraph_tpu_torch.utils import memory, validation

torch.set_num_threads(1)

NAMES = [ds.name for ds in jds.get_all_datasets()]


def _sorted(df):
    return df.sort_values(list(df.columns)).reset_index(drop=True)


# -- datasets ------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_dataset_matches_jax(name):
    dj = next(d for d in jds.get_all_datasets() if d.name == name)
    dt = next(d for d in tds.get_all_datasets() if d.name == name)
    pd.testing.assert_frame_equal(dt.get_edgelist(), dj.get_edgelist())
    pd.testing.assert_frame_equal(dt.get_dask_edgelist(),
                                  dj.get_dask_edgelist())
    for attr in ("description", "_weighted"):
        assert getattr(dt, attr) == getattr(dj, attr)
    for m in ("is_directed", "is_multigraph", "is_symmetric",
              "number_of_nodes", "number_of_vertices", "number_of_edges"):
        assert getattr(dt, m)() == getattr(dj, m)(), m
    pj, pt = dj.get_path(), dt.get_path()
    assert (pt is None) == (pj is None)
    if pt is not None:  # the port's own copy: the same name and bytes
        assert os.path.samefile(os.path.dirname(pt), tds.DATA_DIR)
        assert os.path.basename(pt) == os.path.basename(pj)
        with open(pt, "rb") as a, open(pj, "rb") as b:
            assert a.read() == b.read()
    for ignore in (False, True):
        gj = dj.get_graph(ignore_weights=ignore)
        gt = dt.get_graph(create_using=ct.Graph(directed=dj.is_directed(),
                                                device="cpu"),
                          ignore_weights=ignore)
        assert gt.device.type == "cpu"
        pd.testing.assert_frame_equal(_sorted(gt.view_edge_list()),
                                      _sorted(gj.view_edge_list()))
    dt.unload()
    assert dt._edgelist is None


def test_dataset_registry(tmp_path):
    assert [d.name for d in tds.get_all_datasets()] == NAMES
    assert tds.karate_undirected is tds.karate
    # the port's own copy of the JAX package's bundled CSVs
    assert os.path.samefile(tds.get_download_dir(), tds.DATA_DIR)
    assert sorted(os.listdir(tds.get_download_dir())) == \
        sorted(os.listdir(jds.get_download_dir()))
    tds.set_download_dir(str(tmp_path))
    try:
        assert tds.get_download_dir() == str(tmp_path)
    finally:
        tds.set_download_dir(None)
    tds.download_all()
    assert all(d._edgelist is not None for d in tds.get_all_datasets())
    tds.download_all(force=True)
    if torch.cuda.is_available():
        assert tds.karate.get_graph().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tds.karate.get_graph()


# -- readers -------------------------------------------------------------------

def _write_mtx(path, banner, rows, opener=open):
    with opener(path, "wt") as f:
        f.write(banner + "\n% a comment\n")
        f.write(" ".join(map(str, rows[0])) + "\n")
        for r in rows[1:]:
            f.write(" ".join(map(str, r)) + "\n")


READERS = ["csv_space", "csv_comma_extra", "mtx_general", "mtx_symmetric",
           "mtx_pattern", "mtx_gz", "mtx_empty", "write_csv"]


@pytest.mark.parametrize("case", READERS)
def test_readers_match_jax(case, tmp_path):
    from cugraph_tpu.datasets import readers as jr
    from cugraph_tpu_torch.datasets import readers as tr

    path = str(tmp_path / "g")
    if case == "csv_space":
        path = tds.netscience.get_path()
        got, want = tr.read_csv_edgelist(path), jr.read_csv_edgelist(path)
    elif case == "csv_comma_extra":
        pd.DataFrame({"a": [1, 2, 3], "b": [2, 3, 1], "c": [.5, 1., 2.],
                      "d": [7, 8, 9]}).to_csv(path, header=False,
                                               index=False)
        kw = dict(delimiter=",", dtype={"src": np.int32})
        got, want = tr.read_csv_edgelist(path, **kw), \
            jr.read_csv_edgelist(path, **kw)
    elif case.startswith("mtx"):
        opener = gzip.open if case == "mtx_gz" else open
        if case == "mtx_gz":
            path += ".gz"
        banner = {"mtx_general": "%%MatrixMarket matrix coordinate real "
                                 "general",
                  "mtx_symmetric": "%%MatrixMarket matrix coordinate real "
                                   "symmetric",
                  "mtx_pattern": "%%MatrixMarket matrix coordinate pattern "
                                 "general",
                  "mtx_gz": "%%MatrixMarket matrix coordinate integer "
                            "general",
                  "mtx_empty": "%%MatrixMarket matrix coordinate real "
                               "general"}[case]
        rows = [(4, 4, 4), (1, 2, 0.5), (2, 3, 1.5), (3, 3, 2.0),
                (4, 1, 3.0)]
        if case == "mtx_pattern":
            rows = [r[:2] if i else r for i, r in enumerate(rows)]
        if case == "mtx_empty":
            rows = [(4, 4, 0)]
        _write_mtx(path, banner, rows, opener)
        got, want = tr.read_mtx(path), jr.read_mtx(path)
    else:
        src, dst = np.array([3, 5, 7]), np.array([5, 7, 9])
        w = np.array([1, 2, 3], np.float32)
        gj = jt.Graph().from_edgelist(src, dst, w)
        gt = ct.Graph(device="cpu").from_edgelist(src, dst, w)
        tr.write_csv_edgelist(gt, path + ".t")
        jr.write_csv_edgelist(gj, path + ".j")
        with open(path + ".t") as a, open(path + ".j") as b:
            assert a.read() == b.read()
        return
    pd.testing.assert_frame_equal(got, want)


def test_read_mtx_refuses_other_files(tmp_path):
    from cugraph_tpu_torch.datasets import readers as tr

    path = tmp_path / "x.mtx"
    path.write_text("1 2\n")
    with pytest.raises(ValueError, match="MatrixMarket"):
        tr.read_mtx(str(path))


# -- utils -----------------------------------------------------------------------

def _bfs_pair():
    src = np.array([0, 0, 1, 2, 3, 5])
    dst = np.array([1, 2, 3, 3, 4, 6])
    w = np.array([1.0, 2.5, 0.5, 1.0, 4.0, 1.0], np.float32)
    gj = jt.Graph().from_edgelist(src, dst, w)
    gt = ct.Graph(device="cpu").from_edgelist(src, dst, w)
    return gj, gt, src, dst, w


def _utils_case(case, tmp_path):
    """(the port's result, the JAX package's result) of one utils case."""
    gj, gt, src, dst, w = _bfs_pair()
    if case == "get_traversed_cost":
        df = jt.sssp(gj, 0)
        return (tutils.get_traversed_cost(df, 0, src, dst, w),
                jutils.get_traversed_cost(df, 0, src, dst, w))
    if case == "get_traversed_path":
        df = jt.bfs(gj, 0)
        return (tutils.get_traversed_path(df, 4),
                jutils.get_traversed_path(df, 4))
    if case == "get_traversed_path_list":
        df = jt.bfs(gj, 0)
        return (tutils.get_traversed_path_list(df, 4),
                jutils.get_traversed_path_list(df, 4))
    if case == "ensure_cugraph_obj:graph":
        return tutils.ensure_cugraph_obj(gt)[0] is gt, True
    if case.startswith("ensure_cugraph_obj"):
        kind = case.split(":")[1]
        Gnx = nx.karate_club_graph()
        obj = {"nx": Gnx, "nx_directed": nx.DiGraph(Gnx),
               "nx_unweighted": nx.path_graph(6),
               "scipy": sp.random(8, 8, density=0.3, random_state=1,
                                  format="csr", dtype=np.float32),
               "numpy": nx.to_numpy_array(nx.path_graph(5))}[kind]
        gt_, tt = tutils.ensure_cugraph_obj(obj, directed=True,
                                            device="cpu")
        gj_, tj = jutils.ensure_cugraph_obj(obj, directed=True)
        assert gt_.device.type == "cpu" and tt.__name__ == tj.__name__
        return _sorted(gt_.view_edge_list()), _sorted(gj_.view_edge_list())
    if case == "import_optional":
        assert tutils.import_optional("numpy") is np
        missing = tutils.import_optional("no_such_module_here")
        assert isinstance(missing, tutils.MissingModule)
        with pytest.raises(ModuleNotFoundError):
            missing.anything
        return True, True
    if case == "matrix_types":
        got = [f(t) for f in (tutils.is_cp_matrix_type,
                              tutils.is_sp_matrix_type, tutils.is_matrix_type)
               for t in (sp.csr_matrix, sp.coo_matrix, np.ndarray)]
        want = [f(t) for f in (jutils.is_cp_matrix_type,
                               jutils.is_sp_matrix_type,
                               jutils.is_matrix_type)
                for t in (sp.csr_matrix, sp.coo_matrix, np.ndarray)]
        assert tutils.is_cugraph_graph_type(ct.MultiGraph)
        assert not tutils.is_cugraph_graph_type(jt.Graph)
        return got, want
    if case == "ensure_valid_dtype":
        pairs = pd.DataFrame({"first": np.array([0, 1], np.int32),
                              "second": np.array([2, 3], np.int32)})
        with pytest.warns(UserWarning):
            got = tutils.ensure_valid_dtype(gt, pairs)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = jutils.ensure_valid_dtype(gj, pairs)
        return got, want
    if case == "renumber_vertex_pair":
        pairs = pd.DataFrame({"first": [0, 3, 6], "second": [1, 4, 5]})
        return (tutils.renumber_vertex_pair(gt, pairs),
                jutils.renumber_vertex_pair(gj, pairs))
    if case == "create_random_bipartite":
        np.random.seed(3)
        vt, gt2, at = tutils.create_random_bipartite(4, 5, 10, np.float32,
                                                     device="cpu")
        np.random.seed(3)
        vj, gj2, aj = jutils.create_random_bipartite(4, 5, 10, np.float32)
        pd.testing.assert_series_equal(vt, vj)
        np.testing.assert_array_equal(at, aj)
        return _sorted(gt2.view_edge_list()), _sorted(gj2.view_edge_list())
    if case == "sample_groups":
        df = pd.DataFrame({"g": np.arange(40) % 4, "v": np.arange(40)})
        np.random.seed(5)
        got = tutils.sample_groups(df, "g", 3)
        np.random.seed(5)
        return got, jutils.sample_groups(df, "g", 3)
    if case == "create_directory_with_overwrite":
        d = tmp_path / "d"
        d.mkdir()
        (d / "old").write_text("x")
        tutils.create_directory_with_overwrite(str(d))
        return os.listdir(d), []
    if case == "validate_edgelist":
        verdicts = []
        for args in (([0, 1], [1, 2], None, 3), ([0, -1], [1, 2]),
                     ([0, 1], [1, 5], None, 3), ([0, 1], [1, 2], [1.0]),
                     ([0, 1], [1, 2], [1.0, np.nan]), ([0], [1, 2])):
            out = []
            for fn, err in ((validation.validate_edgelist,
                             ct.InvalidInputError),
                            (jutils.validate_edgelist,
                             jt.InvalidInputError)):
                try:
                    fn(*args)
                    out.append("ok")
                except err as e:
                    out.append(str(e))
            verdicts.append(tuple(out))
        return [v[0] for v in verdicts], [v[1] for v in verdicts]
    if case == "validate_structure":
        g = gt.structure
        validation.validate_structure(g)
        from dataclasses import replace

        bad = replace(g, csr=replace(g.csr, indices=g.csr.indices + 100))
        with pytest.raises(ct.InvalidInputError, match="out of range"):
            validation.validate_structure(bad)
        off = g.csc.offsets.clone()
        off[1] = off[2] + 1
        with pytest.raises(ct.InvalidInputError, match="monotone"):
            validation.validate_structure(replace(g, csc=replace(
                g.csc, offsets=off)))
        assert tutils.checks_enabled(True) and not tutils.checks_enabled(
            False)
        return (list(tutils.validate_vertex_subset(gt, [0, 6])),
                list(jutils.validate_vertex_subset(gj, [0, 6])))
    if case == "profiling":
        t = tutils.HighResTimer()
        with t.range("a"):
            torch.ones(3).sum()
        t.start("b")
        assert t.stop("b", block_on=torch.ones(2)) >= 0
        t.start("b")
        t.stop("b", block_on=[torch.ones(2)])
        tutils.device_sync(torch.ones(1), np.ones(1))
        with open(os.devnull, "w") as null:
            assert "a: " in t.display(file=null)
        totals = {k: c for k, (_, c) in t.totals().items()}
        t.reset()
        assert t.totals() == {}
        log = tmp_path / "trace"
        with tutils.profile_trace(str(log)):
            with tutils.trace_annotation("region"):
                torch.ones(8) @ torch.ones(8)
        assert any(f.endswith(".json") for f in os.listdir(log))
        return totals, {"a": 1, "b": 2}
    if case == "memory":
        g = build_structure(src, dst, w, 7, "cpu")
        held = sum(t.numel() * t.element_size()
                   for adj in (g.csr, g.csc)
                   for t in (adj.offsets, adj.indices, adj.weights,
                             adj.perm))
        assert memory.estimate_graph_bytes(7, len(src)) == held
        assert memory.estimate_graph_bytes(
            7, len(src), both_orientations=False) == held // 2
        assert memory.device_memory_stats("cpu") == {
            "bytes_in_use": -1, "bytes_limit": -1, "peak_bytes_in_use": -1}
        assert memory.fits_on_device(10, 100, device="cpu")
        buf = memory.HostStagingBuffer(np.arange(6, dtype=np.int32))
        on = buf.to_device("cpu")
        assert buf.to_device("cpu") is on and buf.nbytes == 24
        buf.release()
        assert buf._device is None
        return on.tolist(), list(range(6))
    raise ValueError(case)


UTILS = ["get_traversed_cost", "get_traversed_path",
         "get_traversed_path_list", "ensure_cugraph_obj:nx",
         "ensure_cugraph_obj:nx_directed", "ensure_cugraph_obj:nx_unweighted",
         "ensure_cugraph_obj:scipy", "ensure_cugraph_obj:numpy",
         "ensure_cugraph_obj:graph", "import_optional", "matrix_types",
         "ensure_valid_dtype", "renumber_vertex_pair",
         "create_random_bipartite", "sample_groups",
         "create_directory_with_overwrite", "validate_edgelist",
         "validate_structure", "profiling", "memory"]


@pytest.mark.parametrize("case", UTILS)
def test_utils_match_jax(case, tmp_path):
    got, want = _utils_case(case, tmp_path)
    if isinstance(want, pd.DataFrame):
        if case == "get_traversed_cost":
            pd.testing.assert_frame_equal(got, want, rtol=1e-12)
        else:
            pd.testing.assert_frame_equal(got, want)
    else:
        assert got == want


def test_ensure_cugraph_obj_refuses_other_types():
    with pytest.raises(TypeError):
        tutils.ensure_cugraph_obj("not a graph", device="cpu")


# -- etl ---------------------------------------------------------------------------

ETL = ["strings", "strings_na", "multi_columns", "multi_columns_dtypes"]


@pytest.mark.parametrize("case", ETL)
def test_etl_matches_jax(case):
    if case.startswith("strings"):
        df = pd.DataFrame({"a": ["x", "y", "z", "x"],
                           "b": ["y", "w", None if case == "strings_na"
                                 else "x", "q"]})
        got, want = (tetl.renumber_strings(df, "a", "b"),
                     jetl.renumber_strings(df, "a", "b"))
    else:
        df = pd.DataFrame({"s1": [1, 2, 1, 3], "s2": ["a", "b", "a", "c"],
                           "d1": [2, 1, 3, 3], "d2": ["b", "b", "c", "c"]})
        if case == "multi_columns_dtypes":
            df["s1"] = df["s1"].astype(np.int32)
        got, want = (tetl.renumber_multi_columns(df, ["s1", "s2"],
                                                 ["d1", "d2"]),
                     jetl.renumber_multi_columns(df, ["s1", "s2"],
                                                 ["d1", "d2"]))
    for a, b in zip(got, want):
        pd.testing.assert_frame_equal(a, b)


# -- testing -----------------------------------------------------------------------

ORACLES = [("pagerank", {"dataset": "karate"}),
           ("bfs_distances", {"dataset": "dolphins", "source": 0}),
           ("sssp_distances", {"dataset": "karate", "source": 3}),
           ("wcc", {"dataset": "karate_disjoint"}),
           ("wcc", {"dataset": "email_Eu_core", "directed": True}),
           ("core_number", {"dataset": "netscience"}),
           ("triangle_count", {"dataset": "polbooks"})]


@pytest.mark.parametrize("category,params", ORACLES)
def test_resultsets_match_jax(category, params, tmp_path, monkeypatch):
    monkeypatch.setenv("CUGRAPH_TPU_RESULTSET_CACHE", str(tmp_path / "t"))
    monkeypatch.setattr(jtesting, "_CACHE_DIR", str(tmp_path / "j"))
    got = ttesting.get_resultset(category, **params)
    assert got == jtesting.get_resultset(category, **params)
    assert ttesting.get_resultset(category, **params) == got  # cached
    assert len(os.listdir(tmp_path / "t")) == 1
    assert ttesting.results_dir() == str(tmp_path / "t")
    assert ttesting.load_resultset("x") == str(tmp_path / "t")
    assert ttesting.default_resultset_download_dir() == str(tmp_path / "t")


def test_testing_surface(tmp_path, monkeypatch):
    monkeypatch.setenv("CUGRAPH_TPU_RESULTSET_CACHE", str(tmp_path))
    for name in ("UNDIRECTED_DATASETS", "SMALL_DATASETS",
                 "WEIGHTED_DATASETS", "ALL_DATASETS"):
        assert [d.name for d in getattr(ttesting, name)] == \
            [d.name for d in getattr(jtesting, name)]
        assert all(isinstance(d, tds.Dataset)
                   for d in getattr(ttesting, name))
    assert ttesting.DEFAULT_DATASETS == jtesting.DEFAULT_DATASETS
    assert os.path.samefile(ttesting.RAPIDS_DATASET_ROOT_DIR, tds.DATA_DIR)
    assert sorted(os.listdir(ttesting.RAPIDS_DATASET_ROOT_DIR)) == \
        sorted(os.listdir(jtesting.RAPIDS_DATASET_ROOT_DIR))
    assert ttesting.RAPIDS_DATASET_ROOT_DIR_PATH == \
        ttesting.RAPIDS_DATASET_ROOT_DIR
    data = {"vertex": [0, 1], "x": [0.5, 1.5]}
    pd.testing.assert_frame_equal(
        ttesting.Resultset(data).get_cudf_dataframe(),
        jtesting.Resultset(data).get_cudf_dataframe())
    with pytest.raises(KeyError):
        ttesting.get_resultset("no_such_category")
    a = pd.DataFrame({"vertex": [1, 0], "x": [1.5, 0.5]})
    b = pd.DataFrame({"vertex": [0, 1], "x": [0.5, 1.5 + 1e-7]})
    ttesting.assert_frame_allclose(a, b)
    with pytest.raises(AssertionError):
        ttesting.assert_frame_allclose(a, b.assign(x=[0.5, 2.0]))


# -- internals ---------------------------------------------------------------------

class _Hooks(GraphBasedDimRedCallback):
    def __init__(self):
        self.calls = []

    def on_preprocess_end(self, positions):
        self.calls.append(("pre", positions.shape))

    def on_epoch_end(self, positions):
        self.calls.append(("epoch", positions.shape))
        self.last = positions

    def on_train_end(self, positions):
        self.calls.append(("end", positions.shape))
        self.final = positions


class _JHooks(JCallback):
    def __init__(self):
        self.calls = []

    def on_preprocess_end(self, positions):
        self.calls.append(("pre", np.asarray(positions).shape))

    def on_epoch_end(self, positions):
        self.calls.append(("epoch", np.asarray(positions).shape))

    def on_train_end(self, positions):
        self.calls.append(("end", np.asarray(positions).shape))


@pytest.mark.parametrize("max_iter", [1, 4])
def test_force_atlas2_calls_the_port_callback(max_iter):
    gt = tds.karate.get_graph(create_using=ct.Graph(device="cpu"))
    gj = jds.karate.get_graph()
    hooks, jhooks = _Hooks(), _JHooks()
    out = ct.force_atlas2(gt, max_iter=max_iter, callback=hooks)
    jt.force_atlas2(gj, max_iter=max_iter, callback=jhooks)
    assert hooks.calls == jhooks.calls
    assert hooks.calls == ([("pre", (34, 2))] + [("epoch", (34, 2))]
                           * max_iter + [("end", (34, 2))])
    np.testing.assert_array_equal(hooks.final[:, 0], out["x"].to_numpy())
    np.testing.assert_array_equal(hooks.last, hooks.final)
    base = GraphBasedDimRedCallback()
    for hook in ("on_preprocess_end", "on_epoch_end", "on_train_end"):
        assert getattr(base, hook)(np.zeros((2, 2))) is None


# -- the import-path subpackages -----------------------------------------------

IMPORT_PATHS = ["centrality", "community", "components", "cores", "layout",
                "linear_assignment", "link_analysis", "link_prediction",
                "sampling", "structure", "traversal", "tree", "utilities"]


@pytest.mark.parametrize("name", IMPORT_PATHS)
def test_import_path_subpackage(name):
    import importlib

    mj = importlib.import_module(f"cugraph_tpu.{name}")
    mt = importlib.import_module(f"cugraph_tpu_torch.{name}")
    names = {n for n in dir(mj) if not n.startswith("_")
             and callable(getattr(mj, n))}
    assert names <= set(dir(mt))
    home = tutils if name == "utilities" else ct
    for n in names:
        value = getattr(mt, n)
        if hasattr(home, n):
            assert value is getattr(home, n), n
        assert value.__module__.startswith("cugraph_tpu_torch"), n
    if name == "structure":
        df = pd.DataFrame({"a": [1]})
        assert mt.replicate_cudf_dataframe(df) is df
        col = df["a"]
        assert mt.replicate_cudf_series(col) is col
        from cugraph_tpu_torch.core.renumber import NumberMap

        assert mt.NumberMap is NumberMap
