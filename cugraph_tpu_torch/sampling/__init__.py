"""Import-path parity: ``cugraph.sampling``
(python/cugraph/cugraph/sampling/__init__.py), as ``cugraph_tpu.sampling``.
The functions live in ``cugraph_tpu_torch.algos``; this module only
re-exports them."""

from cugraph_tpu_torch import (  # noqa: F401
    uniform_random_walks,
    biased_random_walks,
    node2vec_random_walks,
    homogeneous_neighbor_sample,
    heterogeneous_neighbor_sample,
    random_walks,
    node2vec,
    uniform_neighbor_sample,
)
