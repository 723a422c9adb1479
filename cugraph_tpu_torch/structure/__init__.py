"""Import-path parity: ``cugraph.structure``
(python/cugraph/cugraph/structure/__init__.py), as
``cugraph_tpu.structure``.  Re-exports of ``cugraph_tpu_torch.api``,
``core`` and ``algos``, and the two dask replication functions, which are
the identity on one host."""

from cugraph_tpu_torch import (  # noqa: F401
    BiPartiteGraph,
    DiGraph,
    Graph,
    MultiGraph,
    NPartiteGraph,
    Tree,
    from_adjlist,
    from_cudf_edgelist,
    from_edgelist,
    from_numpy_array,
    from_numpy_matrix,
    from_pandas_adjacency,
    from_pandas_edgelist,
    hypergraph,
    is_bipartite,
    is_directed,
    is_multigraph,
    is_multipartite,
    is_weighted,
    replicate_edgelist,
    symmetrize,
    symmetrize_df,
    symmetrize_ddf,
    to_numpy_array,
    to_numpy_matrix,
    to_pandas_adjacency,
    to_pandas_edgelist,
)
from cugraph_tpu_torch.core.renumber import NumberMap  # noqa: F401


def replicate_cudf_dataframe(df):
    """Reference replicate_edgelist.py:233 copies a frame to every dask
    worker; with one host it is the identity."""
    return df


def replicate_cudf_series(series):
    """Reference replicate_edgelist.py:284; the identity here."""
    return series
