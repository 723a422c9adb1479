"""Stable-layer graph containers (pylibcugraph graphs.pyx analog).

Counterpart of ``cugraph_tpu.plc.graphs``' single-device half.
``SGGraph`` (reference graphs.pyx:42) takes plain arrays, the reference's
calling convention, and wraps a port ``Graph`` or ``MultiGraph`` on the
handle's device.  ``ResourceHandle`` (resource_handle.pyx:15) carries that
device: ``None`` means the card.
"""

from __future__ import annotations

import numpy as np

from cugraph_tpu_torch.core.structure import resolve_device


class ResourceHandle:
    """Device handle (the raft-handle analog; resource_handle.pyx:15).

    ``ResourceHandle()`` is the card; ``ResourceHandle(device="cpu")`` runs
    the graphs built on it, and the wrappers called on them, on the CPU."""

    def __init__(self, handle=None, *, device=None):
        self.device = resolve_device(device)


def handle_device(resource_handle):
    """The device of ``resource_handle``; the card when it is None."""
    if resource_handle is None:
        return resolve_device(None)
    return resource_handle.device


class GraphProperties:
    """reference graph_properties.pyx: is_symmetric / is_multigraph flags."""

    def __init__(self, is_symmetric: bool = False,
                 is_multigraph: bool = False):
        self.is_symmetric = bool(is_symmetric)
        self.is_multigraph = bool(is_multigraph)


class SGGraph:
    """Single-device graph from arrays (reference graphs.pyx:42).

    Parameters mirror the reference signature; ``store_transposed`` is
    accepted for parity (both orientations are built on the device).
    """

    def __init__(self, resource_handle=None, graph_properties=None,
                 src_or_offset_array=None, dst_or_index_array=None,
                 weight_array=None, *, store_transposed=False, renumber=True,
                 do_expensive_check=False, edge_id_array=None,
                 edge_type_array=None, edge_start_time_array=None,
                 input_array_format="COO", vertices_array=None,
                 symmetrize=False, **kwargs):
        from cugraph_tpu_torch.api.graph import Graph, MultiGraph

        props = graph_properties or GraphProperties()
        cls = MultiGraph if props.is_multigraph else Graph
        if input_array_format != "COO":
            raise ValueError("only COO input is supported")
        # reference contract (graphs.pyx:133,169): a symmetric graph's COO
        # already holds both directions UNLESS symmetrize=True is passed.
        # Build in as-is (directed) mode when not symmetrizing so multigraph
        # parallel edges survive; flag undirected afterwards.
        g = cls(directed=not symmetrize,
                device=handle_device(resource_handle))
        g.from_edgelist(
            np.asarray(src_or_offset_array),
            np.asarray(dst_or_index_array),
            None if weight_array is None else np.asarray(weight_array),
            renumber=renumber,
            vertices=vertices_array,
            edge_id=edge_id_array,
            edge_type=edge_type_array,
            edge_time=edge_start_time_array,
        )
        if props.is_symmetric and not symmetrize:
            g._directed = False  # semantic flag only; edges stored as-is
        self._graph = g
        self.properties = props
        self.weighted = weight_array is not None

    def graph(self):
        return self._graph

    def number_of_vertices(self):
        return self._graph.number_of_vertices()

    def number_of_edges(self):
        return self._graph.number_of_edges()
