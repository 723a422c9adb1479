"""Import-path parity: ``cugraph.link_analysis``
(python/cugraph/cugraph/link_analysis/__init__.py), as ``cugraph_tpu.link_analysis``.
The functions live in ``cugraph_tpu_torch.algos``; this module only
re-exports them."""

from cugraph_tpu_torch import (  # noqa: F401
    pagerank,
    hits,
)
