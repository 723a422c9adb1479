"""N-partite and bipartite graph classes (reference structure/
graph_classes.py NPartiteGraph:877, BiPartiteGraph:1045): Graphs that
record vertex partitions.

Counterpart of ``cugraph_tpu.api.bipartite``.  As in the reference, the
algorithms treat them as plain graphs.
"""

from __future__ import annotations

import numpy as np

from cugraph_tpu_torch.api.graph import Graph


class NPartiteGraph(Graph):
    """A graph with named vertex partitions."""

    def __init__(self, bipartite: bool = False, directed: bool = False,
                 device=None):
        super().__init__(directed=directed, device=device)
        self._bipartite = bool(bipartite)
        self._partitions: dict = {}

    def add_nodes_from(self, nodes, bipartite=None, multipartite=None):
        """Record a partition: ``bipartite`` (0/"top" or 1/"bottom"; the
        graph must be bipartite) or ``multipartite`` (any name).  Its
        members are registered for the next construction, as
        ``Graph.add_nodes_from`` does, so isolated ones are kept."""
        nodes = np.asarray(list(nodes))
        if bipartite is not None:
            if not self._bipartite:
                raise TypeError("Graph is not bipartite; use multipartite=")
            key = 0 if bipartite in (0, "top") else 1
        elif multipartite is not None:
            key = multipartite
        else:
            raise TypeError("specify bipartite= or multipartite=")
        self._partitions[key] = nodes
        super().add_nodes_from(nodes)

    def sets(self):
        if not self._partitions:
            raise RuntimeError("partition sets not set; call add_nodes_from")
        return self._partitions

    def is_multipartite(self):
        return True

    def is_bipartite(self):
        return self._bipartite


class BiPartiteGraph(NPartiteGraph):
    def __init__(self, directed: bool = False, device=None):
        super().__init__(bipartite=True, directed=directed, device=device)

    def add_nodes_from(self, nodes, bipartite=None, multipartite=None):
        """Record one of the two partitions ("top"/"bottom" or 0/1; 0 when
        not given)."""
        if multipartite is not None:
            raise TypeError("BiPartiteGraph takes bipartite=, not "
                            "multipartite=")
        if bipartite is None:
            bipartite = 0
        super().add_nodes_from(nodes, bipartite=bipartite)

    def sets(self):
        parts = super().sets()
        return parts.get(0), parts.get(1)

    def is_bipartite(self):
        return True
