"""Vertex renumbering: arbitrary external ids -> dense internal int32 ids.

NumPy counterpart of ``cugraph_tpu.core.renumber`` (reference NumberMap,
python/cugraph/cugraph/structure/number_map.py, and the C++
renumber_edgelist, cpp/src/structure/renumber_edgelist_impl.cuh:95-318).
Internal ids are assigned in descending order of total degree, ties broken by
external id, so internal id 0 is the highest-degree vertex: the heavy rows of
the CSR/CSC sit together at the low ids.  Integer ids go through the native
hash renumber (``core/native.py``), which gives ids in first-seen order that
the degree sort then puts in the same order as ``np.unique`` would; other ids,
and the plain version ``_dense_ids_numpy``, take ``np.unique``.
"""

from __future__ import annotations

import numpy as np

from cugraph_tpu_torch.core import native


class NumberMap:
    """Bidirectional map external vertex ids <-> internal [0, V) int32 ids."""

    def __init__(self, internal_to_external: np.ndarray):
        # internal_to_external[i] = external id of internal vertex i
        self._i2e = internal_to_external
        self._sorter = np.argsort(internal_to_external, kind="stable")
        self._sorted_ext = internal_to_external[self._sorter]

    @property
    def num_vertices(self) -> int:
        return int(self._i2e.shape[0])

    def _positions(self, external: np.ndarray):
        pos = np.searchsorted(self._sorted_ext, external)
        pos = np.clip(pos, 0, self._sorted_ext.shape[0] - 1)
        return pos, self._sorted_ext[pos] == external

    def to_internal(self, external: np.ndarray) -> np.ndarray:
        external = np.asarray(external)
        if self._sorted_ext.shape[0] == 0:
            if external.size:
                raise ValueError(f"vertex ids not in graph: {external[:10]!r}")
            return np.empty(0, np.int32)
        pos, found = self._positions(external)
        if not np.all(found):
            raise ValueError(
                f"vertex ids not in graph: {external[~found][:10]!r}")
        return self._sorter[pos].astype(np.int32)

    def to_external(self, internal: np.ndarray) -> np.ndarray:
        return self._i2e[np.asarray(internal)]

    def contains(self, external: np.ndarray) -> np.ndarray:
        external = np.asarray(external)
        if self._sorted_ext.shape[0] == 0:
            return np.zeros(external.shape, bool)
        return self._positions(external)[1]

    # -- the reference NumberMap's frame methods (number_map.py:310-599) --

    def to_internal_vertex_id(self, df, col_names=None):
        """Internal ids of an external-id column, Series or array; a frame
        takes its ``col_names`` column (the first of a list)."""
        if col_names is not None:
            df = df[_first(col_names)]
        return self.to_internal(np.asarray(df))

    def from_internal_vertex_id(self, df, internal_column_name=None,
                                external_column_names=None, drop=False):
        """A frame gets the external ids of its internal-id column
        (``internal_column_name``, else its first) as a new column,
        ``external_column_names`` (the first of a list) or "0"; ``drop``
        removes the internal column.  An array or Series maps to an
        array."""
        import pandas as pd

        if not isinstance(df, pd.DataFrame):
            return self.to_external(np.asarray(df))
        col = (internal_column_name if internal_column_name is not None
               else df.columns[0])
        out = df.copy()
        name = (external_column_names[0]
                if isinstance(external_column_names, list)
                else external_column_names or "0")
        out[name] = self.to_external(np.asarray(df[col]))
        return out.drop(columns=[col]) if drop else out

    def add_internal_vertex_id(self, df, id_column_name, col_names,
                               drop=False, preserve_order=False):
        """A copy of ``df`` with the internal ids of its ``col_names``
        column as ``id_column_name``; ``drop`` removes the external
        column.  Rows keep their order."""
        col = _first(col_names)
        out = df.copy()
        out[id_column_name] = self.to_internal(np.asarray(df[col]))
        return out.drop(columns=[col]) if drop else out

    @staticmethod
    def renumber(df, src_col_names, dst_col_names, preserve_order=False,
                 store_transposed=False):
        """(frame ['src', 'dst', ...the other columns], NumberMap): the
        endpoint columns through ``renumber_edgelist``."""
        src_col, dst_col = _first(src_col_names), _first(dst_col_names)
        s, d, nmap = renumber_edgelist(df[src_col].to_numpy(),
                                       df[dst_col].to_numpy())
        out = df.drop(columns=[src_col, dst_col]).copy()
        out.insert(0, "src", s)
        out.insert(1, "dst", d)
        return out, nmap

    def unrenumber(self, df, column_name, preserve_order=False,
                   get_column_names=False):
        """A copy of ``df`` whose ``column_name`` holds external ids."""
        out = df.copy()
        out[column_name] = self.to_external(np.asarray(df[column_name]))
        return out

    def vertex_column_size(self):
        """External ids are one column."""
        return 1


def _first(col_names):
    """A column name, or the first of a list of them."""
    return col_names[0] if isinstance(col_names, list) else col_names


def _dense_ids_numpy(src, dst, vertices):
    """(unique ids sorted, src int64, dst int64) through ``np.unique``."""
    pool = [src, dst]
    if vertices is not None:
        pool.append(np.asarray(vertices))
    uniq, inv_all = np.unique(np.concatenate(pool), return_inverse=True)
    e = src.shape[0]
    return (uniq, inv_all[:e].astype(np.int64),
            inv_all[e:2 * e].astype(np.int64))


def _dense_ids(src, dst, vertices):
    """(unique ids, src int64, dst int64): the native hash renumber for
    integer ids (the JAX package's condition, renumber.py:145-170), ids in
    first-seen order with ``vertices``' new ids after them; otherwise
    ``_dense_ids_numpy``."""
    if not (len(src) and np.issubdtype(src.dtype, np.integer)
            and np.issubdtype(dst.dtype, np.integer)):
        return _dense_ids_numpy(src, dst, vertices)
    uniq, src_i, dst_i = native.renumber_native(src.astype(np.int64),
                                                dst.astype(np.int64))
    out_dt = np.result_type(src.dtype, dst.dtype)
    if vertices is not None:
        extra = np.setdiff1d(np.asarray(vertices, np.int64), uniq)
        uniq = np.concatenate([uniq, extra])
        out_dt = np.result_type(out_dt, np.asarray(vertices).dtype)
    return uniq.astype(out_dt), src_i.astype(np.int64), dst_i.astype(np.int64)


def renumber_edgelist(
    src: np.ndarray,
    dst: np.ndarray,
    *,
    sort_by_degree: bool = True,
    vertices: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, NumberMap]:
    """Renumber an edge list to dense int32 ids; returns (src', dst', map).

    With ``sort_by_degree`` internal ids follow descending total degree (ties
    by external id); otherwise ascending external id.  ``vertices`` adds
    isolated vertices that no edge touches.
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    uniq, src_i, dst_i = _dense_ids(src, dst, vertices)
    n = uniq.shape[0]
    if sort_by_degree and n > 0:
        deg = np.bincount(src_i, minlength=n) + np.bincount(dst_i, minlength=n)
        # by -degree; ties in external-id order
        order = np.lexsort((uniq, -deg))
    else:
        order = np.argsort(uniq, kind="stable")
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n)
    return (rank[src_i].astype(np.int32), rank[dst_i].astype(np.int32),
            NumberMap(uniq[order]))
