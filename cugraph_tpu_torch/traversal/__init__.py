"""Import-path parity: ``cugraph.traversal``
(python/cugraph/cugraph/traversal/__init__.py), as ``cugraph_tpu.traversal``.
The functions live in ``cugraph_tpu_torch.algos``; this module only
re-exports them."""

from cugraph_tpu_torch import (  # noqa: F401
    bfs,
    bfs_edges,
    sssp,
    shortest_path,
    filter_unreachable,
    shortest_path_length,
    concurrent_bfs,
    multi_source_bfs,
)
