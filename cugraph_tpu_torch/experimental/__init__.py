"""cugraph.experimental namespace (reference
python/cugraph/cugraph/experimental/__init__.py), as in
``cugraph_tpu.experimental``: ``strong_connected_component`` (the legacy
SCC entry) and ``find_bicliques``, with ``renumber_arbitrary_edgelist``,
``multi_source_bfs`` and ``concurrent_bfs`` re-exported for import
compatibility."""

from cugraph_tpu_torch.algos.structure import \
    renumber_arbitrary_edgelist  # noqa: F401
from cugraph_tpu_torch.api.convenience import (  # noqa: F401
    concurrent_bfs, multi_source_bfs)
from cugraph_tpu_torch.experimental.bicliques import \
    find_bicliques  # noqa: F401


def strong_connected_component(G):
    """Reference experimental/components/scc.py, the legacy SCC entry: the
    stable strongly connected components."""
    from cugraph_tpu_torch.algos.components import \
        strongly_connected_components

    return strongly_connected_components(G)
