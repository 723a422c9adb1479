"""pylibcugraph.internal_types parity (python/pylibcugraph/pylibcugraph/
internal_types/: sampling_result.pyx, coo.pyx, edge_id_lookup_result.pyx).

The port's own copy of ``cugraph_tpu.plc.internal_types``: NumPy accessor
classes, the same field tables and accessors; absent fields are None."""

from cugraph_tpu_torch.plc.internal_types.sampling_result import SamplingResult
from cugraph_tpu_torch.plc.internal_types.coo import COO
from cugraph_tpu_torch.plc.internal_types.edge_id_lookup_result import (
    EdgeIdLookupResult,
)

__all__ = ["SamplingResult", "COO", "EdgeIdLookupResult"]
