"""Edge (id, type) -> (src, dst) lookup container.

Counterpart of ``cugraph_tpu.algos.lookup`` (reference
cpp/src/lookup/lookup_src_dst_impl.cuh, a cuco hash map per edge type;
pylibcugraph edge_id_lookup_table.pyx), copied: sorted keys and a
vectorised binary search on the host, O(log E) per probe.  Lookups feed
sampling pipelines, which frame their results on the host.
"""

from __future__ import annotations

import numpy as np
import pandas as pd


class EdgeIdLookupTable:
    """Built once from a graph with edge_id (and optionally edge_type)."""

    def __init__(self, G):
        if G.edge_ids is None:
            raise ValueError("graph has no edge_id property")
        src, dst, _ = G.edgelist_arrays()
        eid = np.asarray(G.edge_ids, np.int64)
        etp = (np.zeros(len(eid), np.int32) if G.edge_types is None
               else np.asarray(G.edge_types, np.int32))
        self._id_base = int(eid.max()) + 1 if len(eid) else 1
        key = etp.astype(np.int64) * self._id_base + eid
        order = np.argsort(key, kind="stable")
        self._G = G
        self._key = key[order]
        self._src = np.asarray(src)[order]
        self._dst = np.asarray(dst)[order]

    def lookup_vertex_ids(self, edge_ids, edge_type=0) -> pd.DataFrame:
        """DataFrame ['edge_id', 'src', 'dst']; a missing id gets -1
        endpoints (the C API's not-found convention)."""
        edge_ids = np.asarray(edge_ids, np.int64)
        if len(self._key) == 0:
            ids = np.full(len(edge_ids), -1, np.int64)
            return pd.DataFrame({"edge_id": edge_ids, "src": ids, "dst": ids})
        # ids outside [0, id_base) would alias into another type's keys
        in_range = (edge_ids >= 0) & (edge_ids < self._id_base)
        key = np.int64(edge_type) * self._id_base \
            + np.where(in_range, edge_ids, 0)
        pos = np.clip(np.searchsorted(self._key, key), 0, len(self._key) - 1)
        hit = in_range & (self._key[pos] == key)
        src = np.where(hit, self._src[pos], -1)
        dst = np.where(hit, self._dst[pos], -1)
        nm = self._G.number_map
        ext_src = np.where(src >= 0, nm.to_external(np.maximum(src, 0)), -1)
        ext_dst = np.where(dst >= 0, nm.to_external(np.maximum(dst, 0)), -1)
        return pd.DataFrame({"edge_id": edge_ids, "src": ext_src,
                             "dst": ext_dst})


def edge_id_lookup_table(G) -> EdgeIdLookupTable:
    return EdgeIdLookupTable(G)
