"""COO — accessor-object view of an edge list (internal_types/coo.pyx:21).

The reference wraps `cugraph_coo_t` (RMAT generator outputs) in a class with
one ``get_*`` accessor per column; absent columns return None.
"""

from __future__ import annotations

import numpy as np

__all__ = ["COO"]


class COO:
    def __init__(self, sources, destinations, edge_ids=None, edge_types=None,
                 edge_weights=None):
        self._sources = np.asarray(sources)
        self._destinations = np.asarray(destinations)
        self._edge_ids = None if edge_ids is None else np.asarray(edge_ids)
        self._edge_types = (None if edge_types is None
                            else np.asarray(edge_types))
        self._edge_weights = (None if edge_weights is None
                              else np.asarray(edge_weights))

    def get_sources(self):
        return self._sources

    def get_destinations(self):
        return self._destinations

    def get_edge_ids(self):
        return self._edge_ids

    def get_edge_types(self):
        return self._edge_types

    def get_edge_weights(self):
        return self._edge_weights
