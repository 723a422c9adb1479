"""Sharded graph construction: each rank's COO chunk → its DistGraph, with
no rank ever holding the whole edge list.

Counterpart of ``cugraph_tpu/parallel/construct.py`` (reference
``shuffle_ext_edges``, c_api/graph_mg.cpp:140; renumber_edgelist_impl.cuh:
95-318; create_graph_from_edgelist_impl.cuh):

* ``renumber_edgelist_sharded``: each rank's distinct external ids and
  their counts go to their hash owner (ext % P); each owner sums the
  degrees and orders its ids by (−global degree, ext id) into a
  contiguous range, the ranges in owner order; edge endpoints are resolved
  by a request/reply exchange.  The internal ids are the JAX package's.
* ``build_dist_graph_sharded``: every edge goes to its 2D owner, one
  exchange per orientation, and each rank builds the CSR of its arrivals
  (``partition._local_block``) and its owned degrees.

Work on the chunks is NumPy on the host, as the JAX package's; the
exchanges are ``all_to_all_single`` calls after a count exchange, where the
JAX package pads every exchange to a fixed capacity.  Every function is
collective: each rank passes its own chunk (or the list of every rank's
chunks, of which it takes its own entry) and gets its own part back.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from cugraph_tpu_torch.parallel.partition import (DistGraph, Partition2D,
                                                  _local_block,
                                                  owned_degrees)
from cugraph_tpu_torch.parallel.shuffle import all_to_all, exchange_counts


def _own(mesh, chunks):
    """This rank's entry of a list of every rank's chunks, or ``chunks``
    itself when it is one chunk."""
    if isinstance(chunks, (list, tuple)) and len(chunks) == mesh.size and \
            all(np.ndim(c) >= 1 for c in chunks):
        return chunks[mesh.rank]
    return chunks


def allgather_scalars(mesh, values) -> np.ndarray:
    """One int per rank (this rank's, or the list of every rank's) →
    every rank's, int64 [P], on every rank (host_scalar_comm.hpp)."""
    mine = values[mesh.rank] if np.ndim(values) else values
    x = torch.tensor([int(mine)], dtype=torch.int64, device=mesh.device)
    out = x.new_empty(mesh.size)
    dist.all_gather_into_tensor(out, x, group=mesh.world)
    return out.cpu().numpy()


def _max_over_ranks(mesh, value: int) -> int:
    x = torch.tensor([int(value)], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.world)
    return int(x.item())


class _Router:
    """One exchange of this rank's tuples to explicit target ranks: the
    arrivals come grouped by sender position, each sender's in its own
    order; ``reply`` sends one value per arrival back and puts the
    answers in the order of this rank's tuples."""

    def __init__(self, mesh, targets):
        self.mesh = mesh
        self.targets = np.asarray(targets, np.int64)
        self.order = np.argsort(self.targets, kind="stable")
        send = np.bincount(self.targets, minlength=mesh.size)
        recv = exchange_counts(mesh, torch.from_numpy(send).to(mesh.device))
        self.send, self.recv = send.tolist(), recv.cpu().tolist()

    def footprint(self, n_fields: int) -> int:
        """Elements of send and receive buffers live at once."""
        return n_fields * (sum(self.send) + sum(self.recv))

    def _move(self, values, send, recv):
        t = torch.from_numpy(np.ascontiguousarray(values)).to(
            self.mesh.device)
        return all_to_all(self.mesh, t, send, recv).cpu().numpy()

    def exchange(self, *fields):
        """Per field (an array aligned with the targets), the arrivals."""
        return [self._move(np.asarray(f)[self.order], self.send, self.recv)
                for f in fields]

    def reply(self, values):
        """``values`` aligned with the arrivals → the answers aligned with
        this rank's tuples."""
        back = self._move(values, self.recv, self.send)
        out = np.empty(len(self.targets), back.dtype)
        out[self.order] = back
        return out


class DistNumberMap:
    """Distributed external ↔ internal id map (renumber_edgelist_impl.cuh:
    95-318).  Each rank holds its own table, the ids of which it is the
    hash owner (ext % P) sorted by external id with their internal ids,
    and ``bases`` [P+1], each owner's contiguous internal range.  The
    lookups are collective: every rank calls them, with its own queries,
    and they exchange requests and replies as the build does."""

    def __init__(self, mesh, bases, table):
        self.mesh = mesh
        self.P = mesh.size
        self.bases = bases      # int64 [P+1]
        self.table = table      # (ext sorted, int32 internal ids)

    @property
    def num_vertices(self) -> int:
        return int(self.bases[-1])

    def _probe(self, external):
        """(found, internal id) of each external id, by its owner."""
        ext = np.asarray(external, np.int64).reshape(-1)
        r = _Router(self.mesh, (ext % self.P + self.P) % self.P)
        (q,) = r.exchange(ext)
        tab_ext, tab_int = self.table
        pos = np.clip(np.searchsorted(tab_ext, q), 0,
                      max(len(tab_ext) - 1, 0))
        found = (tab_ext[pos] == q) if len(tab_ext) else np.zeros(len(q),
                                                                   bool)
        ids = r.reply(np.where(found, tab_int[pos] if len(tab_ext) else -1,
                               -1).astype(np.int32))
        return ids >= 0, ids

    def contains(self, external):
        return self._probe(external)[0]

    def to_internal(self, external):
        found, ids = self._probe(external)
        if _max_over_ranks(self.mesh, int((~found).sum())):
            bad = np.asarray(external, np.int64).reshape(-1)[~found]
            raise ValueError(f"vertex ids not in graph: {bad[:10]!r}")
        return ids

    def to_external(self, internal):
        ids = np.asarray(internal, np.int64).reshape(-1)
        bad = (ids < 0) | (ids >= self.num_vertices)
        if _max_over_ranks(self.mesh, int(bad.sum())):
            raise ValueError(
                f"internal id(s) out of range [0, {self.num_vertices}): "
                f"{ids[bad][:5].tolist()}")
        r = _Router(self.mesh, np.searchsorted(self.bases, ids,
                                               side="right") - 1)
        (q,) = r.exchange(ids)
        tab_ext, tab_int = self.table
        inv = np.empty(len(tab_int), np.int64)
        inv[tab_int.astype(np.int64) - self.bases[self.mesh.rank]] = tab_ext
        return r.reply(inv[q - self.bases[self.mesh.rank]])


def renumber_edgelist_sharded(mesh, src_chunks, dst_chunks, *,
                              sort_by_degree: bool = True):
    """Distributed renumbering of this rank's external-id COO chunk:
    returns its int32 internal-id (src, dst) and the ``DistNumberMap``.
    Internal ids are contiguous [0, V): owner d (ext % P) assigns [bases[d],
    bases[d+1]) in (−global degree, ext id) order."""
    P = mesh.size
    src = np.asarray(_own(mesh, src_chunks), np.int64)
    dst = np.asarray(_own(mesh, dst_chunks), np.int64)

    u, c = np.unique(np.concatenate([src, dst]), return_counts=True)
    r = _Router(mesh, (u % P + P) % P)
    ext_a, cnt_a = r.exchange(u, c.astype(np.int64))
    ext, inv = np.unique(ext_a, return_inverse=True)
    deg = np.zeros(len(ext), np.int64)
    np.add.at(deg, inv, cnt_a)
    order = np.lexsort((ext, -deg)) if sort_by_degree else np.arange(len(ext))
    ns = allgather_scalars(mesh, len(ext))
    bases = np.concatenate([[0], np.cumsum(ns)]).astype(np.int64)
    ranked = ext[order]
    ids = bases[mesh.rank] + np.arange(len(ranked), dtype=np.int64)
    o = np.argsort(ranked, kind="stable")
    table = (ranked[o], ids[o].astype(np.int32))
    nmap = DistNumberMap(mesh, bases, table)

    def lookup(chunk):
        found, got = nmap._probe(chunk)
        if _max_over_ranks(mesh, int((~found).sum())):
            raise ValueError("edge endpoint missing from renumber map")
        return got

    return lookup(src), lookup(dst), nmap


def build_dist_graph_sharded(
    mesh,
    src_chunks,
    dst_chunks,
    weight_chunks=None,
    *,
    num_vertices: int,
    store_push: bool = True,
    symmetrize: bool = False,
    drop_self_loops: bool = False,
    drop_multi_edges: bool = False,
    edge_type_chunks=None,
    edge_time_chunks=None,
) -> tuple[DistGraph, dict]:
    """This rank's internal-id COO chunk → its DistGraph: the arrays of
    ``build_dist_graph``, but each edge reaches its 2D owner by one
    exchange per orientation, so no rank holds more than its arrivals.
    ``drop_multi_edges`` routes by the pull owner first (a pair's copies
    meet there) and keeps the first in (sender, input) order, before
    ``symmetrize`` mirrors the chunk, as the host build does.

    Returns (graph, stats); ``stats["max_device_buffer_elems"]`` is the
    largest number of elements live at once on any rank: all fields' send
    and receive buffers of the widest exchange, or the largest block."""
    pmaj, pmin = mesh.pmaj, mesh.pmin
    part = Partition2D.create(num_vertices, pmaj, pmin)
    s = np.asarray(_own(mesh, src_chunks), np.int64)
    t = np.asarray(_own(mesh, dst_chunks), np.int64)
    w = (np.ones(len(s), np.float32) if weight_chunks is None
         else np.asarray(_own(mesh, weight_chunks), np.float32))
    extra = {}
    if edge_type_chunks is not None:
        extra["etype"] = np.asarray(_own(mesh, edge_type_chunks), np.int32)
    if edge_time_chunks is not None:
        extra["etime"] = np.asarray(_own(mesh, edge_time_chunks), np.float32)
    footprint = 0

    def route(minor, major, w, extra):
        nonlocal footprint
        i, j = part.edge_device(minor, major)
        r = _Router(mesh, i * pmin + j)
        fields = r.exchange(minor, major, w, *extra.values())
        footprint = max(footprint, r.footprint(len(fields)))
        return fields[0], fields[1], fields[2], dict(zip(extra, fields[3:]))

    if drop_self_loops:
        keep = s != t
        s, t, w = s[keep], t[keep], w[keep]
        extra = {k: v[keep] for k, v in extra.items()}
    if drop_multi_edges:
        s, t, w, extra = route(s, t, w, extra)
        order = np.lexsort((np.arange(len(s)), t, s))
        s, t = s[order], t[order]
        first = np.ones(len(s), bool)
        first[1:] = (s[1:] != s[:-1]) | (t[1:] != t[:-1])
        s, t, w = s[first], t[first], w[order][first]
        extra = {k: v[order][first] for k, v in extra.items()}
    if symmetrize:
        s, t = np.concatenate([s, t]), np.concatenate([t, s])
        w = np.concatenate([w, w])
        extra = {k: np.concatenate([v, v]) for k, v in extra.items()}

    def orientation(minor, major):
        mn, mj, ww, ex = route(minor, major, w, extra)
        sl = part.src_local(mn, mesh.i)
        dl = part.dst_local(mj)
        blocks = _local_block(part, sl, dl, ww, ex.get("etype"),
                              ex.get("etime"), device=mesh.device)
        return blocks, (sl, dl, ww)

    pull, pull_edges = orientation(s, t)
    push = orientation(t, s)[0] if store_push else None
    counts = allgather_scalars(mesh, pull.e_local)
    out_deg, in_deg = owned_degrees(mesh, part, *pull_edges)
    stats = {"max_device_buffer_elems": _max_over_ranks(
        mesh, max(footprint, int(counts.max(initial=0))))}
    g = DistGraph(pull=pull, push=push, out_degree=out_deg,
                  in_degree=in_deg, num_vertices=num_vertices,
                  num_edges=int(counts.sum()), pmaj=pmaj, pmin=pmin,
                  chunk=part.chunk, i=mesh.i, j=mesh.j)
    return g, stats


def build_dist_graph_from_chunks(mesh, src_chunks, dst_chunks,
                                 weight_chunks=None, *, renumber=True,
                                 **kwargs):
    """Distributed renumbering (optional) + the sharded build of this
    rank's chunk.  Returns (DistGraph, DistNumberMap | None, stats)."""
    nmap = None
    if renumber:
        src_chunks, dst_chunks, nmap = renumber_edgelist_sharded(
            mesh, src_chunks, dst_chunks)
        kwargs.setdefault("num_vertices", nmap.num_vertices)
    g, stats = build_dist_graph_sharded(mesh, src_chunks, dst_chunks,
                                        weight_chunks, **kwargs)
    return g, nmap, stats
