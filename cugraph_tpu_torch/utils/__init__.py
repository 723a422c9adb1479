"""Utility layer: profiling, validation, memory and optional-import
helpers, and the reference's utilities/utils.py long tail (utils.py:46-458:
``ensure_cugraph_obj`` :212, ``import_optional`` :323).

Counterpart of ``cugraph_tpu.utils``.  A function here that builds a Graph
takes a ``device`` (None means the card).
"""

from __future__ import annotations

import importlib

import numpy as np

from cugraph_tpu_torch.utils.path_retrieval import get_traversed_cost  # noqa
from cugraph_tpu_torch.utils.profiling import (HighResTimer, device_sync,
                                               profile_trace, reset_spans,
                                               span, span_totals,
                                               trace_annotation)
from cugraph_tpu_torch.utils.validation import (checks_enabled,
                                                validate_edgelist,
                                                validate_structure,
                                                validate_vertex_subset)


class MissingModule:
    """Stands for a module that is not installed; raises on first use
    (reference import_optional)."""

    def __init__(self, name):
        self._name = name

    def __getattr__(self, item):
        raise ModuleNotFoundError(f"optional dependency {self._name!r} "
                                  "is not installed")


def import_optional(name: str):
    """The module, or a ``MissingModule`` that raises on use when it is not
    installed (python/cugraph/cugraph/utilities/utils.py:323)."""
    try:
        return importlib.import_module(name)
    except ImportError:
        return MissingModule(name)


def ensure_cugraph_obj(obj, *, directed: bool = False, device=None):
    """A networkx graph, a scipy sparse matrix or a dense NumPy adjacency as
    a ``Graph`` on ``device`` (utilities/utils.py:212); a ``Graph`` is
    returned as it is.  Returns (Graph, the input's type)."""
    from cugraph_tpu_torch.api.graph import Graph

    if isinstance(obj, Graph):
        return obj, Graph

    nx = import_optional("networkx")
    if not isinstance(nx, MissingModule) and isinstance(obj, nx.Graph):
        G = Graph(directed=obj.is_directed(), device=device)
        edges = list(obj.edges(data=True))
        src = np.array([u for u, v, _ in edges])
        dst = np.array([v for u, v, _ in edges])
        w = np.array([d.get("weight", 1.0) for _, _, d in edges], np.float32)
        weighted = any("weight" in d for _, _, d in edges)
        G.from_edgelist(src, dst, w if weighted else None)
        return G, type(obj)

    sp = import_optional("scipy.sparse")
    if not isinstance(sp, MissingModule) and sp.issparse(obj):
        coo = obj.tocoo()
        G = Graph(directed=directed, device=device)
        G.from_edgelist(coo.row, coo.col, coo.data.astype(np.float32),
                        renumber=False)
        return G, type(obj)

    if isinstance(obj, np.ndarray) and obj.ndim == 2:
        G = Graph(directed=directed, device=device)
        G.from_numpy_array(obj)
        return G, np.ndarray

    raise TypeError(f"cannot convert {type(obj)!r} to a cugraph_tpu_torch "
                    "Graph")


cupy_package = None  # no cupy; scipy covers the matrix types


def is_cp_matrix_type(m):
    """Reference utils.py:269: there is no cupy, so never."""
    return False


def is_sp_matrix_type(m):
    from scipy.sparse import coo_matrix, csc_matrix, csr_matrix

    return m in (coo_matrix, csr_matrix, csc_matrix)


def is_matrix_type(m):
    return is_cp_matrix_type(m) or is_sp_matrix_type(m)


def is_cugraph_graph_type(g):
    from cugraph_tpu_torch.api.graph import Graph, MultiGraph

    return g in (Graph, MultiGraph)


def _check_bfs_frame(df):
    for col in ("vertex", "distance", "predecessor"):
        if col not in df.columns:
            raise ValueError(
                "DataFrame does not appear to be a BFS or "
                f"SSP result - '{col}' column missing")


def get_traversed_path(df, id):
    """The rows of a BFS/SSSP frame on the path from ``id`` back to the
    root (reference utils.py:46)."""
    import pandas as pd

    _check_bfs_frame(df)
    rows = []
    cur = id
    while True:
        row = df[df["vertex"] == cur]
        if len(row) == 0:
            raise ValueError(f"The vertex {cur} is not in the result set")
        rows.append(row)
        cur = row["predecessor"].iloc[0]
        if cur == -1:
            break
    return pd.concat(rows, ignore_index=True)


def get_traversed_path_list(df, id):
    """The vertex ids on the path from ``id`` back to the root
    (reference utils.py:119)."""
    _check_bfs_frame(df)
    answer = [id]
    cur = id
    while True:
        row = df[df["vertex"] == cur]
        if len(row) == 0:
            raise ValueError(f"The vertex {cur} is not in the result set")
        pred = row["predecessor"].iloc[0]
        if pred == -1:
            break
        answer.append(pred)
        cur = pred
    return answer


def ensure_valid_dtype(input_graph, vertex_pair):
    """Reference utils.py:189: warn and cast the pair columns to the
    graph's vertex dtype."""
    import warnings

    vdt = np.asarray(input_graph.nodes()).dtype
    if any(vertex_pair[c].dtype != vdt for c in vertex_pair.columns):
        warnings.warn(
            "'vertex_pair' does not match the graph's vertex type "
            f"({vdt}); casting.", UserWarning)
        vertex_pair = vertex_pair.astype(vdt)
    return vertex_pair


def renumber_vertex_pair(input_graph, vertex_pair):
    """Reference utils.py:288: the pair columns in internal ids."""
    out = vertex_pair.copy()
    for col in out.columns:
        out[col] = input_graph.lookup_internal_vertex_id(
            np.asarray(out[col]))
    return out


def create_random_bipartite(v1, v2, size, dtype, *, device=None):
    """A complete bipartite graph with random integer weights (reference
    utils.py:370, the assignment tests' harness), drawn from NumPy's global
    generator.  Returns (the left vertices, the Graph on ``device``, the
    [v1, v2] weight matrix)."""
    import pandas as pd

    from cugraph_tpu_torch.api.graph import Graph

    src = np.repeat(np.arange(v1), v2)
    dst = np.tile(np.arange(v1, v1 + v2), v1)
    a = np.random.randint(1, high=size, size=(v1, v2)).astype(dtype)
    g = Graph(device=device)
    g.from_edgelist(src, dst, a.reshape(-1).astype(np.float32),
                    renumber=False)
    return pd.Series(np.arange(v1)), g, a


def sample_groups(df, by, n_samples):
    """n_samples random rows per group (reference utils.py:398)."""
    df = df.sample(frac=1).reset_index(drop=True)
    if n_samples == -1:
        return df
    return df.groupby(by, group_keys=False).head(n_samples)


def create_directory_with_overwrite(directory):
    """Reference utils.py:458: the directory, made anew and empty."""
    import os
    import shutil

    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.makedirs(directory)
