"""Distributed edge (id, type) → (src, dst) lookup container.

Counterpart of ``cugraph_tpu/parallel/lookup.py`` (reference
cpp/src/lookup/lookup_src_dst_mg.cu + lookup_src_dst_impl.cuh: the MG
build shuffles (edge_id, type, src, dst) tuples to hash owners
(edge_id % P), and lookups shuffle query ids to the same owners, resolve
them in the per-owner map and shuffle the endpoints back).

Each rank takes its ``array_split`` share of the tuples (of the queries)
and routes it with ``construct._Router``: one count exchange, then one
``all_to_all_single`` per field, int64 as it is (the JAX package splits
every int64 into two int32 limbs, which jax's default int32 mode needs).
Each owner keeps its sorted key table on its device (no hash map, the
JAX package's stance); a lookup is the request/reply exchange pair, then
one all-gather so that every rank returns the whole frame.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from cugraph_tpu_torch.parallel.construct import _Router
from cugraph_tpu_torch.parallel.prims import all_gather_rows


def _share(mesh, n: int) -> np.ndarray:
    """This rank's ``array_split`` share of [0, n)."""
    return np.array_split(np.arange(n), mesh.size)[mesh.rank]


def _owner(ids: np.ndarray, P: int) -> np.ndarray:
    return (ids % P + P) % P


class MGEdgeIdLookupTable:
    """MG analog of ``algos.lookup.EdgeIdLookupTable``
    (lookup_src_dst_mg.cu).

    Built, collectively, from a ``plc.MGGraph`` carrying edge ids: the
    (key = type·base + id, src, dst) tuples go to their id-hash owner,
    which keeps them sorted by key on its device; every lookup runs the
    request/reply exchange pair (queries to owners, endpoints back)."""

    def __init__(self, mg_graph):
        if getattr(mg_graph, "edge_ids", None) is None:
            raise ValueError("graph has no edge_id property")
        mesh = mg_graph.mesh
        self.mesh = mesh
        self.P = mesh.size
        eid = np.asarray(mg_graph.edge_ids, np.int64)
        src, dst = mg_graph.edge_endpoints_external()
        etp = (np.zeros(len(eid), np.int64)
               if getattr(mg_graph, "edge_types", None) is None
               else np.asarray(mg_graph.edge_types, np.int64))
        self._id_base = int(eid.max()) + 1 if len(eid) else 1
        key = etp * self._id_base + eid
        mine = _share(mesh, len(eid))
        router = _Router(mesh, _owner(eid[mine], self.P))
        k, s, t = (torch.from_numpy(a).to(mesh.device) for a in
                   router.exchange(key[mine],
                                   np.asarray(src, np.int64)[mine],
                                   np.asarray(dst, np.int64)[mine]))
        self.keys, order = torch.sort(k, stable=True)
        self.src, self.dst = s[order], t[order]

    def _resolve(self, q: np.ndarray) -> tuple:
        """(src, dst) of the keys ``q`` this rank owns; -1 where absent."""
        q = torch.from_numpy(q).to(self.mesh.device)
        if not len(self.keys):
            miss = torch.full_like(q, -1)
            return miss.cpu().numpy(), miss.cpu().numpy()
        pos = torch.clamp(torch.searchsorted(self.keys, q), max=len(
            self.keys) - 1)
        hit = self.keys[pos] == q
        return (torch.where(hit, self.src[pos], -1).cpu().numpy(),
                torch.where(hit, self.dst[pos], -1).cpu().numpy())

    def lookup_vertex_ids(self, edge_ids, edge_type=0) -> pd.DataFrame:
        """DataFrame ['edge_id', 'src', 'dst']; missing or out-of-range
        ids get -1 endpoints (the C API's not-found convention), the same
        frame on every rank.  Collective: every rank passes the same
        queries."""
        edge_ids = np.asarray(edge_ids, np.int64).reshape(-1)
        in_range = (edge_ids >= 0) & (edge_ids < self._id_base)
        safe = np.where(in_range, edge_ids, 0)
        qkey = np.int64(edge_type) * self._id_base + safe
        mine = _share(self.mesh, len(edge_ids))
        router = _Router(self.mesh, _owner(safe[mine], self.P))
        (q,) = router.exchange(qkey[mine])
        s, t = self._resolve(q)
        both = np.stack([router.reply(s), router.reply(t)], axis=1)
        both = all_gather_rows(self.mesh, torch.from_numpy(both).to(
            self.mesh.device)).cpu().numpy()
        out_s = np.where(in_range, both[:, 0], -1)
        out_d = np.where(in_range, both[:, 1], -1)
        return pd.DataFrame({"edge_id": edge_ids, "src": out_s,
                             "dst": out_d})


def mg_edge_id_lookup_table(mg_graph) -> MGEdgeIdLookupTable:
    return MGEdgeIdLookupTable(mg_graph)
