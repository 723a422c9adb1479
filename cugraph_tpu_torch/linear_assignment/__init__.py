"""Import-path parity: ``cugraph.linear_assignment``
(python/cugraph/cugraph/linear_assignment/__init__.py), as ``cugraph_tpu.linear_assignment``.
The functions live in ``cugraph_tpu_torch.algos``; this module only
re-exports them."""

from cugraph_tpu_torch import (  # noqa: F401
    hungarian,
    dense_hungarian,
)
