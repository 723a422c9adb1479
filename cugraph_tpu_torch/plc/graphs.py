"""Stable-layer graph containers (pylibcugraph graphs.pyx analog).

Counterpart of ``cugraph_tpu.plc.graphs``.  ``SGGraph`` (reference
graphs.pyx:42) takes plain arrays, the reference's calling convention,
and wraps a port ``Graph`` or ``MultiGraph`` on the handle's device.
``MGGraph`` (graphs.pyx:357) wraps this rank's ``DistGraph`` of the
multi-device layer (``cugraph_tpu_torch.parallel``), one process per
device, every rank calling it alike.  ``ResourceHandle``
(resource_handle.pyx:15) carries the device and, for MG graphs, the 2D
mesh: a device of ``None`` means the card.
"""

from __future__ import annotations

import numpy as np
import torch

from cugraph_tpu_torch.core.structure import resolve_device


class ResourceHandle:
    """Device and mesh handle (the raft-handle analog;
    resource_handle.pyx:15).

    ``ResourceHandle()`` is the card; ``ResourceHandle(device="cpu")`` runs
    the graphs built on it, and the wrappers called on them, on the CPU.
    ``ResourceHandle(mesh=mesh)`` carries a ``parallel.Mesh2D`` for MG
    graphs, and its device is the mesh's (replaces the reference's raft
    subcomm bootstrap, dask/comms/comms.py:82)."""

    def __init__(self, handle=None, *, device=None, mesh=None):
        self.mesh = mesh
        self._device_arg = mesh.device if mesh is not None else device
        self.device = resolve_device(self._device_arg)

    def get_mesh(self):
        """The handle's mesh; without one, ``parallel.make_mesh_2d`` over
        the initialised default process group on the handle's device (it
        raises as ``make_mesh_2d`` does when there is no group)."""
        if self.mesh is None:
            from cugraph_tpu_torch.parallel.mesh import make_mesh_2d

            self.mesh = make_mesh_2d(device=self._device_arg)
            self.device = self.mesh.device
        return self.mesh


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


DENSE_ID_FLOOR = 1 << 24


def check_id_space(num_vertices: int, num_distinct: int) -> None:
    """Raise when the dense id space [0, ``num_vertices``) is sparse: more
    than four times the ``num_distinct`` endpoint ids it holds, above
    2^24 ids.  The host MGGraph build sizes its vertex arrays by the id
    space, so a sparse one (2^33-scale ids) would allocate for minutes;
    it goes through ``build="sharded"``, which renumbers.  (The JAX
    package compares the id space with the edge count, and so also
    rejects a dense space of average degree below 0.25.)"""
    if num_vertices > max(4 * num_distinct, DENSE_ID_FLOOR):
        raise ValueError(
            f"vertex id space [0, {num_vertices}) is sparse relative to "
            f"its {num_distinct} distinct endpoint ids; the host MGGraph "
            "build takes dense internal ids — renumber first, or use "
            "build='sharded' (hash-renumbered distributed ingest)")


def _dense_id_space(src: np.ndarray, dst: np.ndarray) -> int:
    """The id space [0, n) of a COO, checked by ``check_id_space``; the
    distinct ids are counted only past the 2^24 floor."""
    n = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
    if n > DENSE_ID_FLOOR:
        check_id_space(n, len(np.unique(np.concatenate([src, dst]))))
    return n


def _cat(a):
    """A per-worker chunk list concatenated; an array as it is."""
    if isinstance(a, (list, tuple)):
        return np.concatenate([np.asarray(x) for x in a])
    return a if a is None else np.asarray(a)


class MGGraph:
    """Multi-device graph over the handle's 2D mesh (reference
    graphs.pyx:357): this rank's ``DistGraph`` on ``mesh.device``.

    SPMD: every rank of the mesh builds it with the same arguments.  The
    host build (``build="host"``) takes the full COO on every rank (or
    the per-worker chunk lists, concatenated) and each rank builds its
    own blocks with ``parallel.build_dist_graph``; ``build="sharded"``
    takes this rank's entry of a list of ``mesh.size`` chunks (a plain
    array is ``array_split`` the same way) and builds through
    ``build_dist_graph_from_chunks``, which renumbers (``number_map``)
    and keeps ``build_stats``.  ``is_symmetric`` describes the input;
    only ``symmetrize=True`` adds the reverse edges.  The edge ids, types
    and the id table stay on the host in full on every rank, as the JAX
    package's single controller holds them."""

    def __init__(self, resource_handle, graph_properties=None,
                 src_array=None, dst_array=None, weight_array=None, *,
                 store_transposed=False, num_arrays=1,
                 do_expensive_check=False, symmetrize=False,
                 edge_id_array=None, edge_type_array=None,
                 edge_start_time_array=None, drop_self_loops=False,
                 drop_multi_edges=False, build="host", **kwargs):
        from cugraph_tpu_torch.parallel import build_dist_graph

        if resource_handle is None:
            resource_handle = ResourceHandle()
        mesh = resource_handle.get_mesh()
        self.mesh = mesh
        self.properties = graph_properties or GraphProperties()
        if build == "sharded":
            self._init_sharded(
                mesh, src_array, dst_array, weight_array,
                symmetrize=symmetrize, edge_id_array=edge_id_array,
                edge_type_array=edge_type_array,
                edge_start_time_array=edge_start_time_array,
                drop_self_loops=drop_self_loops,
                drop_multi_edges=drop_multi_edges)
            return
        if build != "host":
            raise ValueError(f"unknown build {build!r}: 'host' or 'sharded'")
        src = np.asarray(_cat(src_array), np.int64)
        dst = np.asarray(_cat(dst_array), np.int64)
        weight, ids = _cat(weight_array), _cat(edge_id_array)
        etype, etime = _cat(edge_type_array), _cat(edge_start_time_array)
        n = _dense_id_space(src, dst)
        g = build_dist_graph(
            src, dst, weight, n, mesh, store_push=True,
            symmetrize=bool(symmetrize), edge_type=etype, edge_time=etime,
            drop_self_loops=bool(drop_self_loops),
            drop_multi_edges=bool(drop_multi_edges))
        self._graph = g
        # edge ids kept on the host for lookup and post-processing; the
        # sorted (src, dst)-key table lets the MG samplers attach sampled
        # edge ids (the reference returns them via
        # gather_sampled_properties.cuh)
        self.edge_ids = ids
        self.edge_types = etype
        self._edge_id_table = self._build_edge_id_table(
            src, dst, ids, g.pad_v, symmetrize=bool(symmetrize),
            device=mesh.device)
        self._edge_endpoints = None if ids is None else (src, dst)

    @staticmethod
    def _build_edge_id_table(src, dst, ids, pad_v, *, symmetrize,
                             device="cpu"):
        """Sorted (src,dst)-key → edge id table, on the host; the stable
        sort runs on ``device``.  With ``symmetrize`` the graph also
        stores mirrored edges, which inherit the input edge's id (the
        sampler may traverse either direction)."""
        if ids is None:
            return None
        if symmetrize:
            src, dst = (np.concatenate([src, dst]),
                        np.concatenate([dst, src]))
            ids = np.concatenate([ids, ids])
        key = src * pad_v + dst
        order = torch.sort(torch.from_numpy(key).to(device),
                           stable=True).indices.cpu().numpy()
        return key[order], ids[order]

    def lookup_edge_ids(self, sources, destinations):
        """Edge ids for (src, dst) pairs (first match on multi-edges)."""
        if self._edge_id_table is None:
            return None
        keys, ids = self._edge_id_table
        q = np.asarray(sources, np.int64) * self._graph.pad_v \
            + np.asarray(destinations, np.int64)
        pos = np.clip(np.searchsorted(keys, q), 0, max(len(keys) - 1, 0))
        if len(keys) == 0 or not (keys[pos] == q).all():
            raise ValueError("edge id lookup: pair not in graph")
        return ids[pos]

    def _init_sharded(self, mesh, src_array, dst_array, weight_array, *,
                      symmetrize, edge_id_array, edge_type_array,
                      edge_start_time_array, drop_self_loops,
                      drop_multi_edges):
        from cugraph_tpu_torch.parallel import build_dist_graph_from_chunks

        def mine(a):
            if a is None:
                return None
            if isinstance(a, (list, tuple)):
                if len(a) != mesh.size:
                    raise ValueError(f"sharded build needs {mesh.size} "
                                     f"chunks, got {len(a)}")
                return np.asarray(a[mesh.rank])
            return np.array_split(np.asarray(a), mesh.size)[mesh.rank]

        g, nmap, stats = build_dist_graph_from_chunks(
            mesh, mine(src_array), mine(dst_array), mine(weight_array),
            renumber=True, store_push=True, symmetrize=bool(symmetrize),
            drop_self_loops=bool(drop_self_loops),
            drop_multi_edges=bool(drop_multi_edges),
            edge_type_chunks=mine(edge_type_array),
            edge_time_chunks=mine(edge_start_time_array))
        self._graph = g
        self.number_map = nmap
        self.build_stats = stats
        self.edge_ids = _cat(edge_id_array)
        self.edge_types = _cat(edge_type_array)
        self._edge_endpoints = None
        self._edge_id_table = None
        if self.edge_ids is not None:
            # id keys in INTERNAL id space (the samplers' output space);
            # every rank probes the full endpoint arrays (collective)
            s_full = _cat(src_array).astype(np.int64)
            d_full = _cat(dst_array).astype(np.int64)
            self._edge_endpoints = (s_full, d_full)
            si = nmap.to_internal(s_full).astype(np.int64)
            di = nmap.to_internal(d_full).astype(np.int64)
            self._edge_id_table = self._build_edge_id_table(
                si, di, self.edge_ids, g.pad_v, symmetrize=bool(symmetrize),
                device=mesh.device)

    def edge_endpoints_external(self):
        """(src, dst) endpoint arrays aligned with ``edge_ids``, in the
        graph's OUTPUT id space (external ids for sharded builds)."""
        if self._edge_endpoints is None:
            raise ValueError("graph has no edge_id property")
        return self._edge_endpoints

    def graph(self):
        return self._graph
