"""User-facing Graph classes (cuGraph-compatible surface).

Counterpart of ``cugraph_tpu.api.graph`` (reference ``cugraph.Graph``,
python/cugraph/cugraph/structure/graph_classes.py:30).  The edge list and
the vertex map live on the host; the CSR/CSC structure is built on the
graph's device at first use.  ``device=None`` means the card.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from cugraph_tpu_torch.api.exceptions import InvalidInputError
from cugraph_tpu_torch.core import preprocess
from cugraph_tpu_torch.core.renumber import NumberMap, renumber_edgelist
from cugraph_tpu_torch.core.structure import (GraphStructure,
                                              build_structure,
                                              resolve_device)
from cugraph_tpu_torch.utils.profiling import span


class Graph:
    """A graph holding one edge list; undirected by default.  Undirected
    construction symmetrizes the edge list exactly like the reference."""

    _WEIGHT_COL_NAMES = ("weight", "weights", "wgt", "w", "value")
    _multi = False

    def __init__(self, directed: bool = False, device=None):
        self._directed = bool(directed)
        self._device = resolve_device(device)
        self._src: np.ndarray | None = None  # internal int32 ids
        self._dst: np.ndarray | None = None
        self._weight: np.ndarray | None = None
        self._edge_id: np.ndarray | None = None
        self._edge_type: np.ndarray | None = None
        self._edge_time: np.ndarray | None = None
        self._number_map: NumberMap | None = None
        self._structure: GraphStructure | None = None
        self._spmv_plan_pull_spilled = None  # kernels/dispatch.py, host CSC
        self._weight_summary: tuple[bool, float] | None = None
        self._csr_props: dict = {}  # edge properties in CSR order, on device
        self._renumbered = False
        self._pending_nodes: np.ndarray | None = None  # add_nodes_from

    # -- construction ---------------------------------------------------------

    def from_edgelist(self, source, destination=None, weight=None,
                      weight_col=None, *, vertices=None, renumber: bool = True,
                      edge_id=None, edge_type=None, edge_time=None,
                      store_transposed: bool = False) -> "Graph":
        """``from_edgelist(df, 'src', 'dst', 'wgt')`` or
        ``from_edgelist(src_array, dst_array, weight_array)``
        (reference graph_classes.py:119,238).  ``store_transposed`` is
        accepted for parity: both orientations are always built."""
        if isinstance(source, pd.DataFrame):
            df = source
            src_col = destination if destination is not None else "src"
            dst_col = weight if weight is not None else "dst"
            if not isinstance(src_col, str) or not isinstance(dst_col, str):
                raise InvalidInputError("column names must be strings")
            src = df[src_col].to_numpy()
            dst = df[dst_col].to_numpy()
            w = None
            if weight_col is not None:
                w = df[weight_col].to_numpy().astype(np.float32)
            else:
                # only a conventionally named column is taken as weights
                wcols = [c for c in df.columns
                         if c not in (src_col, dst_col)
                         and str(c).lower() in self._WEIGHT_COL_NAMES]
                if len(wcols) == 1:
                    w = df[wcols[0]].to_numpy().astype(np.float32)
        else:
            src = np.asarray(source)
            dst = np.asarray(destination)
            w = None if weight is None else np.asarray(weight, np.float32)
        return self._from_arrays(src, dst, w, renumber=renumber,
                                 vertices=vertices, edge_id=edge_id,
                                 edge_type=edge_type, edge_time=edge_time)

    def from_pandas_edgelist(self, df, source="source",
                             destination="destination",
                             edge_attr=None, renumber=True) -> "Graph":
        # frames using the src/dst convention keep working when the
        # reference's source/destination defaults were not overridden
        if source == "source" and source not in df.columns \
                and {"src", "dst"} <= set(df.columns):
            source, destination = "src", "dst"
        src = df[source].to_numpy()
        dst = df[destination].to_numpy()
        w = (None if edge_attr is None
             else df[edge_attr].to_numpy().astype(np.float32))
        return self._from_arrays(src, dst, w, renumber=renumber)

    def _from_arrays(self, src, dst, weight, *, renumber=True,
                     vertices=None, edge_id=None, edge_type=None,
                     edge_time=None) -> "Graph":
        if self._src is not None:
            raise InvalidInputError("graph already has an edge list")
        if src.shape != dst.shape:
            raise InvalidInputError("source/destination length mismatch")
        if weight is not None and weight.shape != src.shape:
            raise InvalidInputError("weight length mismatch")
        extras = {}
        for name, arr in (("edge_id", edge_id), ("edge_type", edge_type),
                          ("edge_time", edge_time)):
            if arr is not None:
                arr = np.asarray(arr)
                if arr.shape != src.shape:
                    raise InvalidInputError(f"{name} length mismatch")
                extras[name] = arr
        if vertices is None:
            vertices = self._pending_nodes
            self._pending_nodes = None  # consumed by this build only
        if renumber:
            with span("cugraph.graph.renumber"):
                src_i, dst_i, nmap = renumber_edgelist(src, dst,
                                                       vertices=vertices)
        else:
            if (not np.issubdtype(src.dtype, np.integer)
                    or not np.issubdtype(dst.dtype, np.integer)):
                raise InvalidInputError("renumber=False requires integer ids")
            if src.size and (src.min() < 0 or dst.min() < 0):
                raise InvalidInputError(
                    "renumber=False requires non-negative ids")
            n = int(max(src.max(), dst.max())) + 1 if src.size else 0
            if vertices is not None:  # may add isolated ids
                n = max(n, int(np.asarray(vertices).max(initial=-1)) + 1)
            src_i, dst_i = src.astype(np.int32), dst.astype(np.int32)
            nmap = NumberMap(np.arange(n))
        if extras or self._multi:
            with span("cugraph.graph.dedupe"):
                src_i, dst_i, weight, extras = self._keep_edges(
                    src_i, dst_i, weight, extras)
        else:
            with span("cugraph.graph.dedupe"):
                src_i, dst_i, weight = preprocess.remove_multi_edges(
                    src_i, dst_i, weight)
            if not self._directed:
                with span("cugraph.graph.symmetrize"):
                    src_i, dst_i, weight = preprocess.symmetrize_edgelist(
                        src_i, dst_i, weight)
        self._src, self._dst, self._weight = src_i, dst_i, weight
        self._edge_id = extras.get("edge_id")
        self._edge_type = extras.get("edge_type")
        self._edge_time = extras.get("edge_time")
        self._number_map = nmap
        self._renumbered = renumber
        return self

    def _keep_edges(self, src_i, dst_i, weight, extras):
        """The path of a graph with edge properties or parallel edges (JAX
        api/graph.py:164-187): every edge is kept with its properties;
        unless multi, the first of each pair (unordered when undirected)
        in input order; when undirected, the reverse of every non-loop
        edge is stored after them with the same properties."""
        if not self._multi:
            a, b = ((src_i, dst_i) if self._directed else
                    (np.minimum(src_i, dst_i), np.maximum(src_i, dst_i)))
            key = (a.astype(np.int64) << 32) | b.astype(np.int64)
            idx = preprocess.first_occurrences(key, self._device)
            src_i, dst_i = src_i[idx], dst_i[idx]
            weight = None if weight is None else weight[idx]
            extras = {k: v[idx] for k, v in extras.items()}
        if not self._directed:
            rev = src_i != dst_i
            src_i, dst_i = (np.concatenate([src_i, dst_i[rev]]),
                            np.concatenate([dst_i, src_i[rev]]))
            if weight is not None:
                weight = np.concatenate([weight, weight[rev]])
            extras = {k: np.concatenate([v, v[rev]])
                      for k, v in extras.items()}
        return src_i, dst_i, weight, extras

    # -- edge properties ------------------------------------------------------

    @property
    def edge_ids(self):
        return self._edge_id

    @property
    def edge_types(self):
        return self._edge_type

    @property
    def edge_times(self):
        return self._edge_time

    # -- properties -----------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self._device

    def is_directed(self) -> bool:
        return self._directed

    def is_weighted(self) -> bool:
        return self._weight is not None

    def is_multigraph(self) -> bool:
        return self._multi

    @property
    def number_map(self) -> NumberMap:
        self._check_built()
        return self._number_map

    def number_of_vertices(self) -> int:
        self._check_built()
        return self._number_map.num_vertices

    number_of_nodes = number_of_vertices

    def number_of_edges(self) -> int:
        """Edge count with NetworkX semantics (an undirected edge counts
        once)."""
        self._check_built()
        e = int(self._src.shape[0])
        if self._directed:
            return e
        n_loops = int(np.sum(self._src == self._dst))
        return (e - n_loops) // 2 + n_loops

    def density(self) -> float:
        """Edges present against the most possible (reference
        graph_classes.py:801): m/(n(n-1)) directed, 2m/(n(n-1))
        undirected."""
        n = self.number_of_vertices()
        if n < 2:
            return 0.0
        factor = 1 if self._directed else 2
        return factor * self.number_of_edges() / (n * (n - 1))

    def has_vertex(self, v) -> bool:
        self._check_built()
        return bool(self._number_map.contains(np.asarray([v]))[0])

    has_node = has_vertex

    def nodes(self) -> np.ndarray:
        """External vertex ids in internal-id order (reference
        graph_classes.py nodes)."""
        self._check_built()
        return self._number_map.to_external(
            np.arange(self.number_of_vertices()))

    def vertices(self) -> np.ndarray:
        return self.nodes()

    def edges(self) -> pd.DataFrame:
        return self.view_edge_list()

    def view_edge_list(self) -> pd.DataFrame:
        """The edge list in external ids, ['src', 'dst'] plus 'weight' when
        weighted; an undirected graph lists each edge once, src <= dst
        (reference decompress_to_edgelist, graph_functions.hpp:366)."""
        self._check_built()
        src, dst, w = self._src, self._dst, self._weight
        if not self._directed:
            keep = src <= dst
            src, dst = src[keep], dst[keep]
            w = None if w is None else w[keep]
        out = {"src": self._number_map.to_external(src),
               "dst": self._number_map.to_external(dst)}
        if w is not None:
            out["weight"] = w
        return pd.DataFrame(out)

    def edgelist_arrays(self):
        """(src, dst, weight) internal int32 host arrays, symmetrized if
        undirected."""
        self._check_built()
        return self._src, self._dst, self._weight

    def weight_summary(self) -> tuple[bool, float]:
        """(whether any edge weight is negative, the mean weight: float32
        ``np.mean``, 1.0 when unweighted or edgeless), computed at the
        first call and kept: ``sssp`` reads both on every call."""
        self._check_built()
        if self._weight_summary is None:
            w = self._weight
            if w is None or len(w) == 0:
                self._weight_summary = (False, 1.0)
            else:
                self._weight_summary = (bool(np.any(w < 0)),
                                        float(np.mean(w)))
        return self._weight_summary

    @property
    def structure(self) -> GraphStructure:
        """CSR/CSC tensors on the graph's device (built at first use)."""
        self._check_built()
        if self._structure is None:
            with span("cugraph.graph.structure"):
                self._structure = build_structure(
                    self._src, self._dst, self._weight,
                    self.number_of_vertices(), self._device)
        return self._structure

    def degrees(self, vertex_subset=None) -> pd.DataFrame:
        self._check_built()
        n = self.number_of_vertices()
        df = pd.DataFrame({
            "vertex": self._number_map.to_external(np.arange(n)),
            "in_degree": np.bincount(self._dst, minlength=n),
            "out_degree": np.bincount(self._src, minlength=n),
        })
        if vertex_subset is None:
            return df
        keep = df["vertex"].isin(np.asarray(vertex_subset))
        return df[keep].reset_index(drop=True)

    def in_degree(self, vertex_subset=None) -> pd.DataFrame:
        df = self.degrees(vertex_subset)[["vertex", "in_degree"]]
        return df.rename(columns={"in_degree": "degree"})

    def out_degree(self, vertex_subset=None) -> pd.DataFrame:
        df = self.degrees(vertex_subset)[["vertex", "out_degree"]]
        return df.rename(columns={"out_degree": "degree"})

    def degree(self, vertex_subset=None) -> pd.DataFrame:
        """in + out degree when directed; for an undirected graph the
        symmetrized list already counts each non-loop edge at both ends.
        As in the JAX package, an undirected self-loop is stored once and
        adds 1 here, where ``nx.degree`` adds 2."""
        d = self.degrees(vertex_subset)
        deg = (d["in_degree"] + d["out_degree"] if self._directed
               else d["out_degree"])
        return pd.DataFrame({"vertex": d["vertex"], "degree": deg})

    def lookup_internal_vertex_id(self, external, column_name=None):
        self._check_built()
        if column_name is not None:
            external = external[column_name]
        return self._number_map.to_internal(np.asarray(external))

    def add_internal_vertex_id(self, df, internal_column_name,
                               external_column_name, drop=True,
                               preserve_order=False):
        """``df`` with a column of internal ids for an external-id column
        (reference Graph.add_internal_vertex_id); the external column is
        dropped unless ``drop`` is False."""
        out = df.copy()
        out[internal_column_name] = self.lookup_internal_vertex_id(
            np.asarray(df[external_column_name]))
        if drop:
            out = out.drop(columns=[external_column_name])
        return out

    def unrenumber(self, df, column_name, preserve_order=False,
                   get_column_names=False):
        """``df`` with ``column_name`` mapped from internal to external ids
        (reference Graph.unrenumber).  A negative id stays as it is when
        the external ids are integers, and becomes None (object dtype)
        otherwise."""
        out = df.copy()
        arr = np.asarray(df[column_name])
        mask = arr >= 0
        ext_dt = self._number_map.to_external(np.array([0])).dtype
        ext = np.empty(len(arr), dtype=ext_dt)
        ext[mask] = self._number_map.to_external(arr[mask])
        if np.issubdtype(ext_dt, np.integer):
            ext[~mask] = arr[~mask]
        else:
            ext = ext.astype(object)
            ext[~mask] = None
        out[column_name] = ext
        return out

    def unrenumber_frame(self, df: pd.DataFrame, col: str) -> pd.DataFrame:
        """``df`` with ``col`` mapped from internal to external ids."""
        self._check_built()
        df = df.copy()
        df[col] = self._number_map.to_external(df[col].to_numpy())
        return df

    def _check_built(self):
        if self._src is None:
            raise InvalidInputError("graph has no edge list; call from_edgelist")

    def clear(self):
        """Drop the edge list and everything built from it; the graph keeps
        its class, directedness and device."""
        self.__init__(directed=self._directed, device=self._device)

    # -- reference-name construction aliases (graph_classes.py:104-528;
    #    any pandas frame stands for a cudf or dask frame) -------------------

    def from_cudf_edgelist(self, df, source="source",
                           destination="destination", edge_attr=None,
                           weight=None, renumber=True,
                           store_transposed=False, symmetrize=None):
        """Reference Graph.from_cudf_edgelist (graph_classes.py:104).
        ``store_transposed`` is moot (both orientations are built);
        ``symmetrize`` follows the directedness, as in the reference."""
        attr = edge_attr if edge_attr is not None else weight
        w = df[attr].to_numpy(np.float32) if attr is not None else None
        return self.from_edgelist(df[source].to_numpy(),
                                  df[destination].to_numpy(), w,
                                  renumber=renumber)

    def from_dask_cudf_edgelist(self, df, source="source",
                                destination="destination", edge_attr=None,
                                renumber=True, store_transposed=False):
        """Reference Graph.from_dask_cudf_edgelist (graph_classes.py:270):
        the frame is ingested into this one-device graph."""
        return self.from_cudf_edgelist(df, source, destination, edge_attr,
                                       renumber=renumber)

    def from_cudf_adjlist(self, offset_col, index_col, value_col=None,
                          renumber=True):
        """Reference Graph.from_cudf_adjlist (graph_classes.py:376): CSR
        arrays; every CSR row is a vertex, zero-degree rows included."""
        offsets = np.asarray(offset_col)
        indices = np.asarray(index_col)
        deg = np.diff(offsets)
        src = np.repeat(np.arange(len(deg)), deg)
        w = None if value_col is None else np.asarray(value_col, np.float32)
        return self.from_edgelist(src, indices, w, renumber=renumber,
                                  vertices=np.arange(len(deg)))

    def from_pandas_adjacency(self, pdf):
        """A labelled dense matrix: the values become weights, the column
        labels the vertices."""
        return self.from_numpy_array(pdf.to_numpy(),
                                     nodes=np.asarray(pdf.columns))

    def from_numpy_array(self, A, nodes=None):
        """Reference graph_classes.py:493: an edge per nonzero of ``A`` in
        row-major order, its value the weight.  With ``nodes``, every
        labelled vertex is kept, isolated ones included; without it, only
        the vertices that have edges."""
        A = np.asarray(A)
        if A.ndim != 2:
            raise ValueError("np_array is not a 2D matrix")
        src, dst = np.nonzero(A)
        w = A[src, dst].astype(np.float32)
        verts = None
        if nodes is not None:
            nodes = np.asarray(nodes)
            src, dst = nodes[src], nodes[dst]
            verts = nodes
        return self.from_edgelist(src, dst, w, vertices=verts)

    def from_numpy_matrix(self, A):
        return self.from_numpy_array(np.asarray(A))

    # -- predicates and bookkeeping (graph_classes.py:690-800) --------------

    def is_renumbered(self) -> bool:
        return self._renumbered

    def is_bipartite(self) -> bool:
        return False

    def is_multipartite(self) -> bool:
        return False

    def is_remote(self) -> bool:
        return False

    def is_multi_gpu(self) -> bool:
        return False

    def has_isolated_vertices(self) -> bool:
        """Whether some vertex has no incident edge (possible with
        ``renumber=False``, ``vertices=`` or ``add_nodes_from``): one
        ``bincount`` of the edge ends on the graph's device."""
        self._check_built()
        ends = torch.from_numpy(np.concatenate([self._src, self._dst]))
        counts = torch.bincount(ends.to(self._device),
                                minlength=self.number_of_vertices())
        return bool((counts == 0).any())

    def add_nodes_from(self, nodes):
        """Register vertices, isolated ones included, for the next
        construction; repeated calls accumulate."""
        nodes = np.asarray(list(nodes))
        if self._pending_nodes is not None:
            nodes = np.unique(np.concatenate([self._pending_nodes, nodes]))
        self._pending_nodes = nodes

    def _rebuilt(self, directed: bool) -> "Graph":
        """A graph of this class on this device, built from the stored
        edges in external ids (a MultiGraph keeps its parallel edges)."""
        src, dst, w = self.edgelist_arrays()
        g = type(self)(directed=directed, device=self._device)
        return g.from_edgelist(self._number_map.to_external(src),
                               self._number_map.to_external(dst), w)

    def to_directed(self) -> "Graph":
        return self._rebuilt(True)

    def to_undirected(self) -> "Graph":
        return self._rebuilt(False)


class MultiGraph(Graph):
    """A graph that keeps parallel edges (reference graph_classes.py
    MultiGraph): every construction takes the path that keeps edges."""

    _multi = True

    def density(self):
        """Undefined with parallel edges (reference graph_classes.py:853)."""
        raise TypeError("The density function is not support on a Multigraph.")


class Tree(Graph):
    """A Graph marked as a tree (reference graph_classes.py:867)."""

    def __init__(self, directed: bool = False, device=None):
        super().__init__(directed=directed, device=device)
        self.tree = True


class DiGraph(Graph):
    def __init__(self, directed: bool = True, device=None):
        super().__init__(directed=True, device=device)
