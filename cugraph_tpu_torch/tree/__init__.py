"""Import-path parity: ``cugraph.tree``
(python/cugraph/cugraph/tree/__init__.py), as ``cugraph_tpu.tree``.
The functions live in ``cugraph_tpu_torch.algos``; this module only
re-exports them."""

from cugraph_tpu_torch import (  # noqa: F401
    minimum_spanning_tree,
    maximum_spanning_tree,
)
