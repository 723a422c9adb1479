"""Distributed Louvain and Leiden over the 2D partition, one process per
rank.

Counterpart of ``cugraph_tpu/parallel/louvain.py`` (reference
louvain_impl.cuh:339 and coarsen_graph_impl.cuh).  Each sweep of the move
phase:

1. each rank aggregates its push block (rows: sources u, indices:
   destinations) to (u, cluster[dst], ΣW) runs;
2. ``shuffle_to_owners`` takes the runs to u's owner;
3. the owner merges them, each u's runs in the senders' mesh position
   order (the JAX package's concatenation order), and applies the move
   rule (snapshot parallel sweep, up/down direction filter, min-c tie
   break, gain > f_stay + 1e-9);
4. one all-gather makes the cluster vector replicated, as the JAX
   package's host ``cl`` is.

Two engines, as in the JAX package, chosen by ``engine`` or
``CUGRAPH_TPU_MG_SWEEP_ENGINE``:

* ``"host"`` (the default): the runs and the owner merge are the native
  ``coarsen_edges`` (``core/_native/builder.cpp``, sums in double, rounded
  once), the move rule float64 NumPy; modularity from float32 per-rank
  intra-weight partials (NumPy's sum over the block, as the JAX package's
  per-block sum) added in mesh position order, and σ from the replicated
  cluster and degree vectors.  The JAX package's NumPy fallback of
  ``_agg_pairs`` (``louvain.py:215-233``) is not ported: a missing g++
  raises.
* ``"device"``: the card route, the JAX package's shard_map path: a
  per-rank ``torch.sort`` by (u, c), run sums by ``segment_reduce`` (a
  fixed order, no atomics), the owner-side merge and move in float32 as
  ``_merge_move_kernel``, σ by ``shuffle_reduce_by_key``.  Cluster ids
  ride the shuffle in a float64 payload, exact to 2^53, so the JAX
  package's 2^24 guard (``louvain.py:318-323``) has no counterpart.

``mg_coarsen`` contracts the pull blocks to the coarse COO: per-rank runs
merged at the owners of the coarse source ids, then all-gathered in key
order, the same on every rank.  Every function is collective and returns
host NumPy results, the same on every rank.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cugraph_tpu_torch.core import native
from cugraph_tpu_torch.parallel import prims
from cugraph_tpu_torch.parallel.algos import LAST_RUN, all_gather_vertex
from cugraph_tpu_torch.parallel.partition import (DistGraph, Partition2D,
                                                  build_dist_graph,
                                                  filter_block, local_coo,
                                                  local_push_coo)
from cugraph_tpu_torch.parallel.shuffle import (shuffle_reduce_by_key,
                                                shuffle_to_owners)

# distributed levels below this edge count drop to the single-device cascade
_SG_CASCADE_EDGES = 2_000_000
_BIG = 2 ** 30


def _engine(engine):
    if engine is None:
        engine = os.environ.get("CUGRAPH_TPU_MG_SWEEP_ENGINE", "host")
    if engine not in ("host", "device"):
        raise ValueError(f"engine must be 'host' or 'device', got "
                         f"{engine!r}")
    return engine


def _rank_sum(mesh, value: float) -> float:
    """Σ of a per-rank float over the ranks, added in mesh position order
    (the JAX package's Python sum over its blocks): the same bits on every
    rank."""
    t = torch.tensor([float(value)], dtype=torch.float64, device=mesh.device)
    got = all_gather_vertex(mesh, t).cpu().numpy()
    return sum(float(v) for v in got)


def _host_block(g: DistGraph, which: str):
    """(src int32, dst int32, w float32) NumPy of this rank's pull or push
    block, global ids, cached on the DistGraph (``_blocks_host``'s role,
    for this rank's block only)."""
    key = f"_host_{which}"
    cached = g.__dict__.get(key)
    if cached is None:
        src, dst = local_coo(g) if which == "pull" else local_push_coo(g)
        b = g.pull if which == "pull" else g.push
        cached = (src.cpu().numpy().astype(np.int32),
                  dst.cpu().numpy().astype(np.int32), b.weights.cpu().numpy())
        object.__setattr__(g, key, cached)
    return cached


def _agg_pairs(u, c, w, n_keys: int):
    """(u, c) → ΣW by the native counting sorts (``coarsen_edges``):
    (u, c, W) sorted by (u, c), the kv-store role of the reference's
    per_v_transform_reduce_dst_key_aggregated_outgoing_e."""
    if len(u) == 0:
        z = np.zeros(0, np.int32)
        return z, z.copy(), np.zeros(0, np.float32)
    return native.coarsen_edges_native(u, c, w, n_keys)


def _to_owners_host(mesh, part, keys, cols, w, by_sender=False):
    """Ship host runs (keys, cols, w) to the owners of ``keys`` and return
    the arrivals as NumPy (keys int32, cols int32, w float32).  Each run
    rides as one int64, the column in the high word and the weight's bits
    in the low one.  ``shuffle_to_owners`` delivers the senders of one
    mesh column in row order, column by column; ``by_sender`` puts every
    arrival in the senders' mesh position order instead (a key whose runs
    come from several columns)."""
    packed = (np.asarray(cols, np.int64) << 32) | np.asarray(
        w, np.float32).view(np.uint32).astype(np.int64)
    if by_sender:
        packed = np.stack([packed, np.full(len(packed), mesh.rank)], 1)
    ko, po = shuffle_to_owners(mesh, part,
                               torch.from_numpy(np.asarray(keys, np.int64)),
                               torch.from_numpy(packed))
    ko, po = ko.cpu().numpy(), po.cpu().numpy()
    if by_sender:
        order = np.argsort(po[:, 1], kind="stable")
        ko, po = ko[order], po[order, 0]
    return (ko.astype(np.int32), (po >> 32).astype(np.int32),
            (po & 0xFFFFFFFF).astype(np.uint32).view(np.float32))


def _best_per_key(u, c, gain):
    """For runs sorted by (u, c): per u, the highest gain and, among ties,
    the smallest c (the JAX package's lexsort by u, descending gain,
    ascending c, first per u).  Returns the selected run positions."""
    starts = np.flatnonzero(np.r_[True, u[1:] != u[:-1]])
    run = np.repeat(np.arange(len(starts)), np.diff(np.r_[starts, len(u)]))
    best = np.flatnonzero(gain == np.maximum.reduceat(gain, starts)[run])
    return best[np.r_[True, run[best][1:] != run[best][:-1]]]


def _move_phase_host(g: DistGraph, mesh, resolution: float,
                     max_sweeps: int):
    """The host engine's distributed local moving (``louvain.py:236-303``):
    returns (cluster int32 [pad_v], Q), the same on every rank."""
    n, pad_v, chunk = g.num_vertices, g.pad_v, g.chunk
    u, gdst, w = _host_block(g, "push")
    not_loop = u != gdst
    k = all_gather_vertex(mesh, g.out_degree).cpu().numpy().astype(np.float64)
    m2 = max(float(k.sum()), 1e-30)
    lo = mesh.rank * chunk
    part = g.part
    cluster = np.arange(pad_v, dtype=np.int32)

    def sigma_of(cl):
        return np.bincount(cl[:n], weights=k[:n], minlength=pad_v)

    def modularity(cl):
        intra = _rank_sum(mesh, float(w[cl[gdst] == cl[u]].sum()))
        sig = sigma_of(cl)
        return intra / m2 - resolution * float(np.sum((sig / m2) ** 2))

    def move_once(cl, sigma, up_down):
        pu, pc, pw = _agg_pairs(u[not_loop], cl[gdst[not_loop]],
                                w[not_loop], pad_v)
        # a source's push edges all lie in its owner's mesh column
        mu, mc, mW = _agg_pairs(*_to_owners_host(mesh, part, pu, pc, pw),
                                pad_v)
        new_own = cl[lo:lo + chunk].copy()
        cur = cl[mu]
        ku = k[mu]
        stay = mc == cur
        w_stay = np.zeros(chunk, np.float64)
        w_stay[mu[stay] - lo] = mW[stay]       # unique per u post-merge
        dir_ok = (mc > cur) if up_down else (mc < cur)
        cand = dir_ok & ~stay
        moved = 0
        if cand.any():
            cu_, cc_ = mu[cand], mc[cand]
            cg_ = mW[cand] - resolution * ku[cand] * sigma[cc_] / m2
            sel = _best_per_key(cu_, cc_, cg_)
            bu, bc, bg = cu_[sel], cc_[sel], cg_[sel]
            f_stay = w_stay[bu - lo] - resolution * k[bu] * (
                sigma[cl[bu]] - k[bu]) / m2
            improve = (bg > f_stay + 1e-9) & (bu < n)
            new_own[bu[improve] - lo] = bc[improve]
            moved = int(improve.sum())
        moved = int(prims.psum_all(mesh, torch.tensor(
            moved, dtype=torch.int64, device=mesh.device)).item())
        new_cl = all_gather_vertex(mesh, torch.from_numpy(new_own).to(
            mesh.device)).cpu().numpy()
        return new_cl, moved

    best_q = modularity(cluster)
    up_down = True
    for sweep in range(max_sweeps):
        sigma = sigma_of(cluster)
        cand, moved = move_once(cluster, sigma, up_down)
        up_down = not up_down
        q = modularity(cand)
        if q > best_q + 1e-9:
            best_q, cluster = q, cand
        elif moved == 0 or sweep >= 1:
            break
    return cluster, best_q


def _runs(keys: torch.Tensor, vals: torch.Tensor):
    """Runs of equal ``keys`` after a stable sort: (run keys, the sums of
    ``vals`` over each run in the given order, by ``segment_reduce``)."""
    if keys.numel() == 0:
        return keys, vals
    order = torch.sort(keys, stable=True).indices
    uk, counts = torch.unique_consecutive(keys[order], return_counts=True)
    return uk, torch.segment_reduce(vals[order], "sum", lengths=counts)


def _move_phase_device(g: DistGraph, mesh, resolution: float,
                       max_sweeps: int):
    """The device engine (``louvain.py:58-180, 371-414``): returns (cluster
    int32 [pad_v], Q), the same on every rank."""
    dev = mesh.device
    n, pad_v, chunk = g.num_vertices, g.pad_v, g.chunk
    part = g.part
    src, dst = local_push_coo(g)
    w = g.push.weights
    wmove = torch.where(src != dst, w, 0.0)   # self-loops move nothing
    k_full = all_gather_vertex(mesh, g.out_degree)
    m2 = float(max(k_full.cpu().numpy().sum(), 1e-30))
    res32 = torch.tensor(np.float32(resolution), device=dev)
    m2_32 = torch.clamp(torch.tensor(np.float32(m2), device=dev), min=1e-30)
    base = mesh.rank * chunk
    gidx = base + torch.arange(chunk, device=dev)
    k_own = g.out_degree
    keys_real = gidx < n
    cluster = torch.arange(pad_v, dtype=torch.int64, device=dev)

    def sigma_of(cl):
        keys = torch.where(keys_real, cl[base:base + chunk], -1)
        return all_gather_vertex(mesh, shuffle_reduce_by_key(mesh, part, keys,
                                                       k_own, "sum"))

    def modularity(cl):
        intra = prims.psum_all(mesh, torch.where(cl[src] == cl[dst], w,
                                                 0.0).sum()).item()
        sig = sigma_of(cl)
        return float(intra) / m2 - resolution * float(
            ((sig / m2) ** 2).sum().item())

    def move_once(cl, sig, up_down):
        # per-rank runs (u, cluster[dst]) → ΣW
        rk, rw = _runs(src * pad_v + cl[dst], wmove)
        payload = torch.stack([(rk % pad_v).double(), rw.double()], 1)
        ku, po = shuffle_to_owners(mesh, part, rk // pad_v, payload)
        # owner-side merge, in arrival order within a (u, c) run
        mk, W = _runs((ku - base) * pad_v + po[:, 0].to(torch.int64),
                      po[:, 1].float())
        u_loc, run_c = mk // pad_v, mk % pad_v
        run_u = u_loc + base
        ku_deg = k_full[run_u]
        cur = cl[run_u]
        sig_adj = sig[run_c] - torch.where(run_c == cur, ku_deg, 0.0)
        gain = W - res32 * ku_deg * sig_adj / m2_32
        lengths = torch.bincount(u_loc, minlength=chunk)
        w_stay = torch.segment_reduce(torch.where(run_c == cur, W, 0.0),
                                      "sum", lengths=lengths)
        c_own = cl[base:base + chunk]
        sig_cur = sig[c_own]
        f_stay = w_stay - res32 * k_own * (sig_cur - k_own) / m2_32
        direction_ok = (run_c > cur) if up_down else (run_c < cur)
        cand = direction_ok & (run_c != cur)
        g_m = torch.where(cand, gain, -1e30)
        best_gain = prims.block_segment_reduce(g_m, u_loc, chunk, "max",
                                               identity=-1e30)
        is_best = cand & (g_m >= best_gain[u_loc])
        best_c = prims.block_segment_reduce(
            torch.where(is_best, run_c, _BIG), u_loc, chunk, "min",
            identity=_BIG)
        improve = (best_gain > f_stay + 1e-9) & (best_c < _BIG) & keys_real
        new_own = torch.where(improve, best_c, c_own)
        moved = int(prims.psum_all(mesh, improve.sum()).item())
        return all_gather_vertex(mesh, new_own), moved

    best_q = modularity(cluster)
    up_down = True
    for sweep in range(max_sweeps):
        sigma = sigma_of(cluster)
        cand, moved = move_once(cluster, sigma, up_down)
        up_down = not up_down
        q = modularity(cand)
        if q > best_q + 1e-9:
            best_q, cluster = q, cand
        elif moved == 0 or sweep >= 1:
            break
    return cluster.cpu().numpy().astype(np.int32), best_q


def mg_louvain_move_phase(g: DistGraph, mesh, resolution: float = 1.0,
                          max_sweeps: int = 20, engine: str | None = None):
    """Distributed local moving; returns (cluster int32 [pad_v] NumPy, Q),
    the same on every rank.  ``engine``: "host" (default) or "device", or
    ``CUGRAPH_TPU_MG_SWEEP_ENGINE``.  Needs push blocks."""
    if g.push is None:
        raise ValueError("mg_louvain needs push blocks (store_push=True)")
    if _engine(engine) == "host":
        return _move_phase_host(g, mesh, resolution, max_sweeps)
    return _move_phase_device(g, mesh, resolution, max_sweeps)


def _coarsen_device(g: DistGraph, mesh, lab: np.ndarray, nc: int, cpart):
    """Per-rank runs (c_src, c_dst) → ΣW on the device (float32 in block
    order), merged at the owners in float64 in the senders' mesh position
    order and rounded once (the JAX package's host merge)."""
    dev = mesh.device
    src, dst = local_coo(g)
    lab_t = torch.from_numpy(lab.astype(np.int64)).to(dev)
    rk, rw = _runs(lab_t[src] * nc + lab_t[dst], g.pull.weights)
    payload = torch.stack([(rk % nc).double(), rw.double(),
                           torch.full_like(rw, mesh.rank, dtype=torch.float64)
                           ], 1)
    ko, po = shuffle_to_owners(mesh, cpart, rk // nc, payload)
    by_sender = torch.sort(po[:, 2], stable=True).indices
    mk, mw = _runs(ko[by_sender] * nc + po[by_sender, 0].to(torch.int64),
                   po[by_sender, 1])
    return mk // nc, mk % nc, mw.float()


def mg_coarsen(g: DistGraph, mesh, labels_full: np.ndarray,
               engine: str | None = None):
    """Distributed contraction: compact labels [pad_v] → the coarse COO
    (cu int64, cd int64, cw float32, nc), sorted by (cu, cd), the same on
    every rank.  Each rank compresses its pull block to distinct (c_src,
    c_dst, ΣW) runs first (native on the host, or on the device), the runs
    go to the owners of c_src under the coarse partition, and the merged
    runs come back by one all-gather in key order."""
    lab = np.asarray(labels_full, np.int32)
    nc = int(lab.max()) + 1
    cpart = Partition2D.create(nc, mesh.pmaj, mesh.pmin)
    dev = mesh.device
    if _engine(engine) == "host":
        src, dst, w = _host_block(g, "pull")
        pu, pc, pw = _agg_pairs(lab[src], lab[dst], w, nc)
        mu, mc, mw = _agg_pairs(*_to_owners_host(mesh, cpart, pu, pc, pw,
                                                 by_sender=True), nc)
        mu, mc, mw = (torch.from_numpy(a).to(dev) for a in (mu, mc, mw))
    else:
        mu, mc, mw = _coarsen_device(g, mesh, lab, nc, cpart)
    cu, cd, cw = (prims.all_gather_rows(mesh, t).cpu().numpy()
                  for t in (mu, mc, mw))
    return cu.astype(np.int64), cd.astype(np.int64), \
        cw.astype(np.float32), nc


def mg_louvain(g: DistGraph, mesh, max_level: int = 100,
               resolution: float = 1.0, threshold: float = 1e-7,
               sg_threshold_edges: int = _SG_CASCADE_EDGES):
    """Distributed Louvain (``louvain.py:463-517``): returns (labels int32
    [num_vertices], modularity), the same on every rank.  Each level runs
    the distributed move phase and ``mg_coarsen`` while the coarse graph
    has more than ``sg_threshold_edges`` edges (each coarse level a
    ``build_dist_graph(..., mesh, store_push=True)`` of the replicated
    coarse COO); the rest of the cascade runs the single-device port's
    native levels.  Records in ``algos.LAST_RUN`` the coarse DistGraphs'
    edge counts (one per distributed level past the first) and the
    single-device levels."""
    from cugraph_tpu_torch.algos.community import (_coarsen,
                                                   _louvain_one_level)

    n = g.num_vertices
    cluster, q_prev = mg_louvain_move_phase(g, mesh, resolution)
    _, compact = np.unique(cluster[:n], return_inverse=True)
    cur = compact.astype(np.int32)
    g_cur = g
    cur_full = np.zeros(g_cur.pad_v, np.int32)
    cur_full[:n] = cur
    level = 1
    coarse_edges, sg_levels = [], 0

    def record():
        LAST_RUN.clear()
        LAST_RUN.update(algo="louvain", coarse_edges=coarse_edges,
                        distributed_levels=len(coarse_edges),
                        single_device_levels=sg_levels)

    csrc, cdst, cw, nc = mg_coarsen(g_cur, mesh, cur_full)
    while level < max_level and len(csrc) > sg_threshold_edges and nc > 1:
        coarse_edges.append(len(csrc))
        g_c = build_dist_graph(csrc, cdst, cw, nc, mesh, store_push=True)
        cl_c, q = mg_louvain_move_phase(g_c, mesh, resolution)
        if q <= q_prev + threshold:
            record()
            return cur, q_prev
        _, cc = np.unique(cl_c[:nc], return_inverse=True)
        cur = cc.astype(np.int32)[cur]
        q_prev = q
        g_cur = g_c
        cur_full = np.zeros(g_cur.pad_v, np.int32)
        cur_full[:nc] = cc
        level += 1
        csrc, cdst, cw, nc = mg_coarsen(g_cur, mesh, cur_full)

    for _ in range(level, max_level):
        cl, q = _louvain_one_level(csrc, cdst, cw, nc, resolution)
        sg_levels += 1
        if q <= q_prev + threshold:
            break
        # _coarsen's ``compact`` maps current-level vertex → coarse id,
        # which ``cur`` is composed with
        csrc, cdst, cw, nc, compact = _coarsen(csrc, cdst, cw, cl)
        cur = compact[cur]
        q_prev = q
        if nc <= 1:
            break
    record()
    return cur, q_prev


def _mask_intra(g: DistGraph, labels_full: np.ndarray) -> DistGraph:
    """``g`` with only the edges whose endpoints share a label, in both
    blocks (``_mask_blocks_intra``, ``louvain.py:543-558``): each rank
    filters its own CSRs into new blocks; degrees stay ``g``'s."""
    from dataclasses import replace

    lab = torch.from_numpy(np.asarray(labels_full, np.int64)).to(
        g.pull.offsets.device)

    def masked(block, coo):
        s, d = coo(g)
        return filter_block(block, lab[s] == lab[d])

    return replace(g, pull=masked(g.pull, local_coo),
                   push=masked(g.push, local_push_coo))


def mg_leiden(g: DistGraph, mesh, max_level: int = 100,
              resolution: float = 1.0, threshold: float = 1e-7):
    """Distributed Leiden (``louvain.py:562-600``): ``mg_louvain``, then each
    community split into its weakly connected components over the
    intra-community edges (``mg_wcc``, K2 (min, left) int32, on the masked
    blocks), so no community is disconnected.  Returns (labels int32
    [num_vertices], the refined partition's modularity), the same on every
    rank; the modularity from float32 per-rank intra partials added in
    mesh position order and a float64 σ."""
    from cugraph_tpu_torch.parallel.algos import mg_wcc

    if g.push is None:
        raise ValueError("mg_leiden needs push blocks (store_push=True)")
    labels, _ = mg_louvain(g, mesh, max_level=max_level,
                           resolution=resolution, threshold=threshold)
    n, pad_v = g.num_vertices, g.pad_v
    lab_full = np.zeros(pad_v, np.int64)
    lab_full[:n] = labels
    cc = all_gather_vertex(mesh, mg_wcc(_mask_intra(g, lab_full), mesh))
    _, refined = np.unique(cc.cpu().numpy()[:n], return_inverse=True)
    refined = refined.astype(np.int32)

    k = all_gather_vertex(mesh, g.out_degree).cpu().numpy().astype(np.float64)
    m2 = max(float(k.sum()), 1e-30)
    ref_full = np.zeros(pad_v, np.int32)
    ref_full[:n] = refined
    u, gdst, w = _host_block(g, "push")
    intra = _rank_sum(mesh, float(w[ref_full[gdst] == ref_full[u]].sum()))
    sigma = np.bincount(refined, weights=k[:n], minlength=n)
    q_ref = intra / m2 - resolution * float(np.sum((sigma / m2) ** 2))
    return refined, q_ref
