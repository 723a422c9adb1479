"""Graph message-passing primitives: the contract every algorithm is
written against.

Counterpart of ``cugraph_tpu.prims`` (reference
cpp/include/cugraph/prims/*.cuh): each primitive is a function over the
CSR/CSC pair of ``core/structure.py``.  The sum SpMVs and the min/max,
select and SpMM forms run the hand-written kernels on the card; the rest
is a gather plus a fixed-order reduction in plain torch.
"""

from cugraph_tpu_torch.prims.frontier import (bitmap_from_vertices,
                                              frontier_expand_by_dst,
                                              vertices_from_bitmap)
from cugraph_tpu_torch.prims.vertex_edge import (
    count_if_e, count_if_v, gather_minor, per_v_transform_reduce_incoming_e,
    per_v_transform_reduce_outgoing_e, reduce_v, segment_reduce_by_major,
    select_by_major, semiring_by_major, spmm_by_major,
    spmm_semiring_by_major, spmv_pull, spmv_push, transform_e,
    transform_reduce_e, transform_reduce_v, vertex_mask)

__all__ = [
    "per_v_transform_reduce_incoming_e", "per_v_transform_reduce_outgoing_e",
    "transform_reduce_e", "transform_e", "count_if_e", "transform_reduce_v",
    "count_if_v", "reduce_v", "spmv_pull", "spmv_push",
    "segment_reduce_by_major", "gather_minor", "frontier_expand_by_dst",
    "bitmap_from_vertices", "vertices_from_bitmap",
    # the port's own: the kernels' forms
    "semiring_by_major", "select_by_major", "spmm_by_major",
    "spmm_semiring_by_major",
]
