"""Testing utilities: the Graph500 tree validators and TEPS summary
(counterpart of ``cugraph_tpu.testing``'s graph500 re-exports), and the
NaN-aware bit comparison of a kernel with its plain version."""

from cugraph_tpu_torch.testing.bits import bit_mismatches
from cugraph_tpu_torch.testing.graph500 import (teps_summary,
                                                validate_bfs_tree,
                                                validate_sssp_tree)

__all__ = ["bit_mismatches", "teps_summary", "validate_bfs_tree",
           "validate_sssp_tree"]
