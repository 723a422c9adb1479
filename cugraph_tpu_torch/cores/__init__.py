"""Import-path parity: ``cugraph.cores``
(python/cugraph/cugraph/cores/__init__.py), as ``cugraph_tpu.cores``.
The functions live in ``cugraph_tpu_torch.algos``; this module only
re-exports them."""

from cugraph_tpu_torch import (  # noqa: F401
    core_number,
    k_core,
)
