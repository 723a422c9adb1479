"""Import-path parity: ``cugraph.layout``
(python/cugraph/cugraph/layout/__init__.py), as ``cugraph_tpu.layout``.
The functions live in ``cugraph_tpu_torch.algos``; this module only
re-exports them."""

from cugraph_tpu_torch import (  # noqa: F401
    force_atlas2,
)
