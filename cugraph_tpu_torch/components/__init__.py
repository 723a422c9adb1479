"""Import-path parity: ``cugraph.components``
(python/cugraph/cugraph/components/__init__.py), as ``cugraph_tpu.components``.
The functions live in ``cugraph_tpu_torch.algos``; this module only
re-exports them."""

from cugraph_tpu_torch import (  # noqa: F401
    connected_components,
    weakly_connected_components,
    strongly_connected_components,
)
