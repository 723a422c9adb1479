"""EdgeIdLookupResult (internal_types/edge_id_lookup_result.pyx:30).

Wraps an edge-id→(src,dst) lookup result with the reference's accessors.
"""

from __future__ import annotations

import numpy as np

__all__ = ["EdgeIdLookupResult"]


class EdgeIdLookupResult:
    def __init__(self, sources, destinations):
        self._sources = np.asarray(sources)
        self._destinations = np.asarray(destinations)

    def get_sources(self):
        return self._sources

    def get_destinations(self):
        return self._destinations
