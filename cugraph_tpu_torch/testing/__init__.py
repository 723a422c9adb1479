"""Testing utilities: the Graph500 tree validators and TEPS summary, the
NaN-aware bit comparison of a kernel with its plain version, and the
golden result sets (reference python/cugraph/cugraph/testing/: resultset.py,
the dataset lists of testing/__init__.py:14-60, utils.py's
RAPIDS_DATASET_ROOT_DIR).

Counterpart of ``cugraph_tpu.testing``: the result sets are NetworkX
oracles computed on demand and cached on disk, under
``CUGRAPH_TPU_RESULTSET_CACHE`` when it is set, else under the
repository's ``build/resultsets``.  ``make_test_mesh`` is the CPU mesh
of the multi-device tests: gloo over an initialised process group.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from cugraph_tpu_torch.datasets import (DATA_DIR, dolphins, email_Eu_core,
                                        karate, karate_disjoint, netscience,
                                        polbooks, small_line, small_tree,
                                        toy_graph, toy_graph_undirected)
from cugraph_tpu_torch.testing.bits import bit_mismatches
from cugraph_tpu_torch.testing.graph500 import (teps_summary,
                                                validate_bfs_tree,
                                                validate_sssp_tree)

DEFAULT_DATASETS = ["karate", "les_miserables", "small_rmat"]
UNDIRECTED_DATASETS = [karate, dolphins]
SMALL_DATASETS = [karate, dolphins, polbooks]
WEIGHTED_DATASETS = [dolphins, karate, karate_disjoint, netscience,
                     polbooks, small_line, small_tree]
ALL_DATASETS = [dolphins, karate, karate_disjoint, polbooks, netscience,
                small_line, small_tree, email_Eu_core, toy_graph,
                toy_graph_undirected]

# the bundled data stands for the downloaded tarball's root
RAPIDS_DATASET_ROOT_DIR = DATA_DIR
RAPIDS_DATASET_ROOT_DIR_PATH = RAPIDS_DATASET_ROOT_DIR

_DEFAULT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "resultsets")


class Resultset:
    """A golden result (reference resultset.py:15)."""

    def __init__(self, data_dictionary):
        self._data_dictionary = data_dictionary

    def get_cudf_dataframe(self):
        import pandas as pd

        return pd.DataFrame(self._data_dictionary)


def results_dir():
    """The result-set cache directory, made if missing."""
    path = os.environ.get("CUGRAPH_TPU_RESULTSET_CACHE", _DEFAULT_CACHE)
    os.makedirs(path, exist_ok=True)
    return path


def default_resultset_download_dir():
    return results_dir()


def load_resultset(resultset_name, resultset_download_url=None):
    """Reference resultset.py load_resultset fetches a tarball; here the
    results are computed on demand, so this only makes the cache
    directory."""
    return results_dir()


def get_resultset(category: str, **params):
    """The golden result of ``category`` for ``params``: read from the
    cache, else the NetworkX oracle, computed and cached."""
    key = category + "__" + "__".join(f"{k}={params[k]}" for k in sorted(params))
    path = os.path.join(results_dir(), key.replace("/", "_") + ".pkl")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    result = _compute_oracle(category, **params)
    with open(path, "wb") as f:
        pickle.dump(result, f)
    return result


def _nx_graph(dataset: str, directed: bool):
    import networkx as nx

    from cugraph_tpu_torch import datasets

    df = getattr(datasets, dataset).get_edgelist()
    cls = nx.DiGraph if directed else nx.Graph
    return nx.from_pandas_edgelist(df, "src", "dst",
                                   edge_attr="wgt" if "wgt" in df else None,
                                   create_using=cls)


def _compute_oracle(category: str, *, dataset="karate", directed=False, **kw):
    import networkx as nx

    G = _nx_graph(dataset, directed)
    if category == "pagerank":
        return nx.pagerank(G, weight=kw.get("weight"))
    if category == "bfs_distances":
        return nx.single_source_shortest_path_length(G, kw["source"])
    if category == "sssp_distances":
        return nx.single_source_dijkstra_path_length(G, kw["source"])
    if category == "wcc":
        return [sorted(c) for c in
                nx.weakly_connected_components(G)] if directed else \
               [sorted(c) for c in nx.connected_components(G)]
    if category == "core_number":
        H = G.copy()
        H.remove_edges_from(nx.selfloop_edges(H))
        return nx.core_number(H)
    if category == "triangle_count":
        return nx.triangles(G)
    raise KeyError(f"no oracle for category {category!r}")


def make_test_mesh(pmaj: int = 4, pmin: int = 2):
    """A pmaj × pmin gloo ``parallel.Mesh2D`` on the CPU over the
    initialised default process group of pmaj·pmin ranks (the
    testing/mg_utils.py:21 start_dask_client analog); it raises as
    ``make_mesh_2d`` does without a group, over another number of ranks
    or over NCCL.  Every rank calls it."""
    from cugraph_tpu_torch.parallel.mesh import make_mesh_2d

    return make_mesh_2d(pmaj, pmin, device="cpu")


def assert_frame_allclose(a, b, on="vertex", rtol=1e-4, atol=1e-6):
    """Order-insensitive frame comparison: floats within the tolerance,
    other columns equal."""
    a = a.sort_values(on).reset_index(drop=True)
    b = b.sort_values(on).reset_index(drop=True)
    assert list(a.columns) == list(b.columns)
    for c in a.columns:
        if np.issubdtype(a[c].dtype, np.floating):
            np.testing.assert_allclose(a[c], b[c], rtol=rtol, atol=atol)
        else:
            np.testing.assert_array_equal(a[c], b[c])


__all__ = [
    "ALL_DATASETS", "DEFAULT_DATASETS", "RAPIDS_DATASET_ROOT_DIR",
    "RAPIDS_DATASET_ROOT_DIR_PATH", "Resultset", "SMALL_DATASETS",
    "UNDIRECTED_DATASETS", "WEIGHTED_DATASETS", "assert_frame_allclose",
    "bit_mismatches", "default_resultset_download_dir", "dolphins",
    "email_Eu_core", "get_resultset", "karate", "karate_disjoint",
    "load_resultset", "make_test_mesh", "netscience", "polbooks",
    "results_dir", "small_line", "small_tree", "teps_summary", "toy_graph",
    "toy_graph_undirected", "validate_bfs_tree", "validate_sssp_tree",
]
