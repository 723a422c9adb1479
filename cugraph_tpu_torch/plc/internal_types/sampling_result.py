"""SamplingResult — accessor-object view of sampler outputs.

Mirrors pylibcugraph.internal_types.sampling_result (sampling_result.pyx:39):
the reference wraps the C `cugraph_sample_result_t` in a class exposing one
``get_*`` accessor per field (majors/minors/weights/ids/types/times, the
label/hop offset arrays, and the renumber maps).  External GNN stacks
(cugraph-pyg/dgl) consume samplers through this surface.

Here the samplers return either a pandas frame (plain COO mode) or the
renumber-and-compress dict (renumber=True) — ``SamplingResult`` adapts both
to the reference's accessor names.  Absent fields return None, exactly like
the pyx (each accessor NULL-checks the C pointer and returns None).
"""

from __future__ import annotations

import numpy as np

__all__ = ["SamplingResult"]

# frame column → canonical field
_FRAME_FIELDS = {
    "majors": ("sources", "majors"),
    "minors": ("destinations", "minors"),
    "weight": ("weight", "edge_weight", "weights"),
    "edge_id": ("edge_id", "edge_ids", "indices"),
    "edge_type": ("edge_type", "edge_types"),
    "hop": ("hop", "hop_id"),
    "batch_id": ("batch_id", "batch", "start_labels"),
    "edge_start_time": ("edge_start_time", "start_time", "time"),
    "edge_end_time": ("edge_end_time", "end_time"),
}


def _col(frame, names):
    for n in names:
        if n in frame:
            v = frame[n]
            return v.to_numpy() if hasattr(v, "to_numpy") else np.asarray(v)
    return None


class SamplingResult:
    """Array-accessor view over a sampler output (frame or compressed dict)."""

    def __init__(self, output=None):
        self._fields = {}
        if output is None:
            return
        if isinstance(output, dict):
            self._fields = dict(output)
        else:  # pandas frame (plain COO output)
            for field, names in _FRAME_FIELDS.items():
                v = _col(output, names)
                if v is not None:
                    self._fields[field] = v

    # -- construction parity with set_ptr (sampling_result.pyx:85) ---------
    @classmethod
    def from_sampler_output(cls, output):
        return cls(output)

    def _get(self, *names):
        for n in names:
            v = self._fields.get(n)
            if v is not None:
                return np.asarray(v)
        return None

    # -- accessors (names per sampling_result.pyx:88-480) ------------------
    def get_major_offsets(self):
        return self._get("major_offsets")

    def get_majors(self):
        return self._get("majors")

    def get_minors(self):
        return self._get("minors")

    def get_label_hop_offsets(self):
        return self._get("label_hop_offsets")

    def get_label_type_hop_offsets(self):
        return self._get("label_type_hop_offsets")

    def get_sources(self):
        # deprecated alias of get_majors (sampling_result.pyx:167)
        return self.get_majors()

    def get_destinations(self):
        # deprecated alias of get_minors (sampling_result.pyx:194)
        return self.get_minors()

    def get_edge_weights(self):
        return self._get("weight", "edge_weight")

    def get_indices(self):
        # deprecated alias of get_edge_weights (sampling_result.pyx:248)
        return self.get_edge_weights()

    def get_edge_ids(self):
        return self._get("edge_id")

    def get_edge_types(self):
        return self._get("edge_type")

    def get_edge_start_time(self):
        return self._get("edge_start_time")

    def get_edge_end_time(self):
        return self._get("edge_end_time")

    def get_batch_ids(self):
        return self._get("batch_id")

    def get_start_labels(self):
        return self.get_batch_ids()

    def get_hop(self):
        # deprecated (sampling_result.pyx:23); hop boundaries now live in
        # label_hop_offsets
        return self._get("hop")

    def get_offsets(self):
        # deprecated alias of label_hop_offsets
        return self.get_label_hop_offsets()

    def get_renumber_map(self):
        return self._get("renumber_map")

    def get_renumber_map_offsets(self):
        return self._get("renumber_map_offsets")

    def get_edge_renumber_map(self):
        return self._get("edge_renumber_map")

    def get_edge_renumber_map_offsets(self):
        return self._get("edge_renumber_map_offsets")
