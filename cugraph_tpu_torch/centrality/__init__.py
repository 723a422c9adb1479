"""Import-path parity: ``cugraph.centrality``
(python/cugraph/cugraph/centrality/__init__.py), as ``cugraph_tpu.centrality``.
The functions live in ``cugraph_tpu_torch.algos``; this module only
re-exports them."""

from cugraph_tpu_torch import (  # noqa: F401
    betweenness_centrality,
    edge_betweenness_centrality,
    katz_centrality,
    degree_centrality,
    eigenvector_centrality,
)
