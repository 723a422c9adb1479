"""Import-path parity subpackage: mirrors `cugraph.dask`
(python/cugraph/cugraph/dask/__init__.py), every MG algorithm under its
SG name.  Counterpart of ``cugraph_tpu.dask``: the implementations are
the port's multi-device layer, ``cugraph_tpu_torch.parallel`` (dask and
its comms replaced by ``torch.distributed`` and a 2D process mesh); this
module re-exports parallel's reference-named alias surface, so
``import cugraph_tpu_torch.dask as dcg`` works like ``import
cugraph.dask``.  Each function takes (g: DistGraph, mesh, ...)."""

from cugraph_tpu_torch.parallel import *  # noqa: F401,F403
from cugraph_tpu_torch.parallel import (  # noqa: F401
    all_pairs_cosine,
    all_pairs_jaccard,
    all_pairs_overlap,
    all_pairs_sorensen,
    bfs,
    betweenness_centrality,
    core_number,
    cosine,
    ecg,
    edge_betweenness_centrality,
    ego_graph,
    eigenvector_centrality,
    hits,
    induced_subgraph,
    jaccard,
    k_core,
    katz_centrality,
    ktruss_subgraph,
    leiden,
    louvain,
    overlap,
    pagerank,
    sorensen,
    sssp,
    strongly_connected_components,
    triangle_count,
    uniform_random_walks,
    weakly_connected_components,
)
