"""Import-path parity: ``cugraph.community``
(python/cugraph/cugraph/community/__init__.py), as ``cugraph_tpu.community``.
The functions live in ``cugraph_tpu_torch.algos``; this module only
re-exports them."""

from cugraph_tpu_torch import (  # noqa: F401
    louvain,
    leiden,
    ecg,
    spectralBalancedCutClustering,
    spectralModularityMaximizationClustering,
    analyzeClustering_modularity,
    analyzeClustering_edge_cut,
    analyzeClustering_ratio_cut,
    induced_subgraph,
    triangle_count,
    ktruss_subgraph,
    k_truss,
    ego_graph,
    batched_ego_graphs,
    subgraph,
)
