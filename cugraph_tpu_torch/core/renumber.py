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
