"""Import-path parity: ``cugraph.link_prediction``
(python/cugraph/cugraph/link_prediction/__init__.py), as ``cugraph_tpu.link_prediction``.
The functions live in ``cugraph_tpu_torch.algos``; this module only
re-exports them."""

from cugraph_tpu_torch import (  # noqa: F401
    jaccard,
    jaccard_coefficient,
    all_pairs_jaccard,
    sorensen,
    sorensen_coefficient,
    all_pairs_sorensen,
    overlap,
    overlap_coefficient,
    all_pairs_overlap,
    cosine,
    cosine_coefficient,
    all_pairs_cosine,
)
