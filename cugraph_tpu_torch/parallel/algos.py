"""Vertex-program algorithms over the 2D partition, one process per rank.

Counterpart of the power methods and traversals of
``cugraph_tpu/parallel/algos.py`` (``:57-507``).  The JAX package runs
each as one jitted ``shard_map`` program with the loop on the device; here
each rank runs the loop in Python, each iteration one kernel over the
rank's local CSR plus collectives:

- ``mg_pagerank``, ``mg_katz_centrality``, ``mg_hits`` (pull, then push),
  ``mg_eigenvector_centrality``: K1 (mul) through ``prims.pull_spmv``;
- ``mg_bfs``: K2 (max, left) int32 over the frontier's global ids + 1;
- ``mg_sssp``: K2 (min, add) float32, and plain-torch predecessor passes;
- ``mg_wcc``: K2 (min, left) int32 over the pull, then the push block.

A loop's test reads one all-reduced scalar per iteration on the host, so
every rank leaves it together, at the same iteration as the JAX
package's on-device ``while_loop`` up to float32 rounding of the test
value.  Each function returns this rank's owned slice [Vc] on
``mesh.device`` where the JAX package returns the global owner-sharded
[pad_v] array; ``all_gather_vertex`` gives that array on every rank.
Scalars (err, iterations) are Python numbers, the same on every rank.

The rest of the module is the JAX module's sampler half (``:503-1213``:
the one-hop engine, the fused samplers, the walks, ``mg_has_edge``) and
its analytics half (``:1214-2291``): similarity over owner-sharded
neighbour lists, negative sampling, ECG, core numbers, betweenness (K4
unit), SCC (K2 (max, left) int32), triangles, k-truss and the
neighbourhood extractions; those return host results, the same on every
rank, as the JAX package's do.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from cugraph_tpu_torch.core.structure import CsrMatrix
from cugraph_tpu_torch.kernels.semiring import BIG, spmv_semiring
from cugraph_tpu_torch.parallel import prims
from cugraph_tpu_torch.parallel.partition import (DistGraph, gathered_coo,
                                                  local_coo, local_push_coo)

INT_INF = int(np.iinfo(np.int32).max)


def all_gather_vertex(mesh, x_own: torch.Tensor) -> torch.Tensor:
    """Owned slices [Vc, ...] → the global [pad_v, ...] tensor, in owner
    order, on every rank (what the JAX package's ``mg_*`` return)."""
    return prims._Gather.apply(x_own, mesh.world, mesh.size)


def _own(mesh, g: DistGraph, full: np.ndarray) -> torch.Tensor:
    """This rank's slice [Vc, ...] of a host array [pad_v, ...]."""
    lo = mesh.rank * g.chunk
    return torch.from_numpy(np.ascontiguousarray(full[lo:lo + g.chunk])).to(
        mesh.device)


def _real(mesh, g: DistGraph):
    gidx = prims.global_vertex_ids(mesh, g.chunk)
    return gidx, gidx < g.num_vertices


def _scalar(mesh, x: torch.Tensor):
    """The mesh-wide sum of a local scalar, read on the host."""
    return prims.psum_all(mesh, x).item()


def _semiring_pull(mesh, blocks, x_own, weights, reduce, combine):
    """REDUCE over in-edges of COMBINE(x[src], w) for the owned slots: the
    row block gathered, K2 over the local CSR, the partials reduced along
    "major" to their owners."""
    sq = blocks.square
    x_blk = prims.pad_rows(prims.gather_minor_block(mesh, x_own), blocks.side)
    part = spmv_semiring(sq.offsets, sq.indices, weights, x_blk, reduce,
                         combine)[:blocks.num_segments]
    return prims.scatter_reduce_major(mesh, part, x_own.shape[0], reduce)


# ---------------------------------------------------------------------------
# power methods
# ---------------------------------------------------------------------------

def mg_pagerank(g: DistGraph, mesh, alpha: float = 0.85, tol: float = 1e-5,
                max_iter: int = 100, personalization=None, nstart=None):
    """Distributed PageRank (reference pagerank_impl.cuh:224-330).  The
    dangling mass is spread over the reset vector, as the JAX package's
    (``algos.py:153-166``).  ``personalization`` and ``nstart`` are dense
    vectors by vertex id, normalised to sum 1.  Returns (p_own, err,
    iterations)."""
    n, pad_v = g.num_vertices, g.pad_v

    def vec(x, default):
        v = np.zeros(pad_v, np.float32)
        if x is None:
            v[:n] = default
        else:
            v[: len(x)] = np.asarray(x, np.float32)
            v /= v.sum()
        return _own(mesh, g, v)

    reset = vec(personalization, 1.0 / n)
    p = vec(nstart, 1.0 / n)
    _, real = _real(mesh, g)
    out_deg = g.out_degree
    inv_out = torch.where(out_deg > 0, 1.0 / out_deg, 0.0)
    is_dangling = real & (out_deg <= 0)
    alpha32 = np.float32(alpha)
    teleport = float(np.float32(1.0) - alpha32) * reset
    tol = float(np.float32(tol))
    err, it = float("inf"), 0
    while err >= tol and it < max_iter:
        dang_sum = prims.psum_all(mesh, torch.where(is_dangling, p, 0.0).sum())
        pulled = prims.pull_spmv(mesh, g.pull, p * inv_out)
        p_new = float(alpha32) * (pulled + dang_sum * reset) + teleport
        p_new = torch.where(real, p_new, 0.0)
        err = _scalar(mesh, torch.abs(p_new - p).sum())
        p, it = p_new, it + 1
    return p, err, it


def mg_katz_centrality(g: DistGraph, mesh, alpha: float = 0.1,
                       beta: float = 1.0, tol: float = 1e-6,
                       max_iter: int = 100, normalized: bool = True):
    """Distributed Katz (reference katz_centrality_impl.cuh:32-187):
    c ← alpha·Aᵀc + beta from 0 until the L1 change is below ``tol``;
    L2-normalised when ``normalized``.  Returns (c_own, err,
    iterations)."""
    _, real = _real(mesh, g)
    alpha, beta = float(np.float32(alpha)), float(np.float32(beta))
    c = torch.zeros(g.chunk, dtype=torch.float32, device=mesh.device)
    tol = float(np.float32(tol))
    err, it = float("inf"), 0
    while err >= tol and it < max_iter:
        pulled = prims.pull_spmv(mesh, g.pull, c)
        c_new = torch.where(real, alpha * pulled + beta, 0.0)
        err = _scalar(mesh, torch.abs(c_new - c).sum())
        c, it = c_new, it + 1
    if normalized:
        norm = torch.sqrt(prims.psum_all(mesh, (c * c).sum()))
        c = c / torch.clamp(norm, min=1e-30)
    return c, err, it


def mg_degrees(g: DistGraph, mesh):
    """(in_degree, out_degree) of the owned vertices (built with the
    graph)."""
    return g.in_degree, g.out_degree


def mg_hits(g: DistGraph, mesh, tol: float = 1e-5, max_iter: int = 100,
            normalized: bool = True, nstart=None):
    """Distributed HITS (reference hits_impl.cuh:47-194); needs push
    blocks.  Authorities by the pull block, hubs by the push block; each
    scaled by the mesh-wide sum of the ranks' largest magnitudes, as the
    JAX package's ``norm_inf`` does (``algos.py:406-408``; one rank: the
    max).  ``nstart`` is a dense initial hubs vector by vertex id.
    Returns (hubs_own, authorities_own, err, iterations)."""
    if g.push is None:
        raise ValueError("mg_hits needs push blocks (store_push=True)")
    h0 = np.zeros(g.pad_v, np.float32)
    if nstart is None:
        h0[: g.num_vertices] = 1.0 / max(g.num_vertices, 1)
    else:
        v = np.asarray(nstart, np.float32).reshape(-1)
        h0[: len(v)] = v
        s = h0.sum()
        if s > 0:
            h0 /= s
    h = _own(mesh, g, h0)
    a = torch.zeros_like(h)
    _, real = _real(mesh, g)

    def norm_inf(x):
        m = prims.psum_all(mesh, torch.abs(x).max())
        return x / torch.clamp(m, min=1e-30)

    tol = float(np.float32(tol))
    err, it = float("inf"), 0
    while err >= tol and it < max_iter:
        a = norm_inf(torch.where(real, prims.pull_spmv(mesh, g.pull, h), 0.0))
        h_new = norm_inf(torch.where(real, prims.pull_spmv(mesh, g.push, a),
                                     0.0))
        err = _scalar(mesh, torch.abs(h_new - h).sum())
        h, it = h_new, it + 1
    if normalized:
        h = h / torch.clamp(prims.psum_all(mesh, torch.where(real, h, 0.0)
                                           .sum()), min=1e-30)
        a = a / torch.clamp(prims.psum_all(mesh, torch.where(real, a, 0.0)
                                           .sum()), min=1e-30)
    return h, a, err, it


def mg_eigenvector_centrality(g: DistGraph, mesh, tol: float = 1e-6,
                              max_iter: int = 100):
    """Distributed eigenvector centrality (reference
    eigenvector_centrality_impl.cuh:161): the shifted iteration (A+I)x,
    L2-normalised, from 1/sqrt(n) until the L1 change is below tol·n.
    Returns (c_own, err, iterations)."""
    n = g.num_vertices
    c0 = np.zeros(g.pad_v, np.float32)
    c0[:n] = 1.0 / max(np.sqrt(n), 1.0)
    c = _own(mesh, g, c0)
    _, real = _real(mesh, g)
    bound = float(np.float32(tol) * np.float32(n))
    err, it = float("inf"), 0
    while err >= bound and it < max_iter:
        c_new = torch.where(real, prims.pull_spmv(mesh, g.pull, c) + c, 0.0)
        norm = torch.sqrt(prims.psum_all(mesh, (c_new * c_new).sum()))
        c_new = c_new / torch.clamp(norm, min=1e-30)
        err = _scalar(mesh, torch.abs(c_new - c).sum())
        c, it = c_new, it + 1
    return c, err, it


# ---------------------------------------------------------------------------
# traversals
# ---------------------------------------------------------------------------

def mg_bfs(g: DistGraph, mesh, source, depth_limit: int | None = None):
    """Distributed BFS from one root or a list of roots, as one
    traversal.  Each level gathers x = global id + 1 of the frontier's
    vertices (0 elsewhere), takes K2 (max, left) int32 over the local CSR
    (INT32_MIN, no in-edge, becomes 0) and the MAX along "major": the
    predecessor is the largest frontier in-neighbour.  Returns (distance,
    predecessor) owned slices; unreached: INT32_MAX and -1."""
    max_depth = (int(depth_limit) if depth_limit is not None
                 else g.num_vertices)
    roots = torch.as_tensor(np.asarray(source, np.int32).reshape(-1),
                            device=mesh.device)
    gidx, _ = _real(mesh, g)
    f = ((gidx[:, None] == roots[None, :]) & (roots[None, :] >= 0)).any(1)
    dist = torch.where(f, 0, INT_INF).to(torch.int32)
    pred = torch.full_like(dist, -1)
    level, cnt = 0, 1
    while cnt > 0 and level < max_depth:
        x = torch.where(f, gidx + 1, 0).to(torch.int32)
        red = _semiring_pull(mesh, g.pull, x, None, "max", "left")
        red = torch.clamp(red, min=0)
        f = (red > 0) & (dist == INT_INF)
        dist = torch.where(f, level + 1, dist).to(torch.int32)
        pred = torch.where(f, red - 1, pred)
        cnt = _scalar(mesh, f.sum())
        level += 1
    return dist, pred


def mg_sssp(g: DistGraph, mesh, source: int, cutoff: float = np.inf):
    """Distributed SSSP: Bellman-Ford rounds of K2 (min, add) float32 over
    the local CSR, MIN along "major"; a result of +1e30 (no in-edge, or
    only unreached sources, which K2 clips) is unreached, and one past
    ``cutoff`` too.  Returns (distance, predecessor) owned slices;
    unreached: inf and -1.

    The predecessor is the largest global src u with d[u] + w == d[v]
    exactly and d[u] < d[v]; a vertex reached only over zero or
    sub-rounding weights (d[u] == d[v]) is then attached wave by wave to
    the largest in-neighbour already in the tree, so the parents form a
    tree (the single-device ``_sssp_pred_host`` rule, with the exact
    test).  The JAX package takes the largest u of the equality test
    alone, which can point parents around a zero-weight cycle.  Each pass
    is a block segment max and a MAX along "major", plain torch (K3 takes
    one vector for rows and columns, and the row block and the dst slots
    differ), and each wave reads one all-reduced count."""
    n, chunk = g.num_vertices, g.chunk
    cutoff = float(np.float32(cutoff))
    gidx, _ = _real(mesh, g)
    inf = float("inf")
    dist = torch.where(gidx == int(source), 0.0, inf).to(torch.float32)
    blocks = g.pull
    it, changed = 0, 1
    while changed > 0 and it < n:
        red = _semiring_pull(mesh, blocks, dist, blocks.weights, "min", "add")
        red = torch.where((red < BIG) & (red <= cutoff), red, inf)
        new = torch.minimum(dist, red)
        changed = _scalar(mesh, (new < dist).sum())
        dist, it = new, it + 1

    d_blk = prims.gather_minor_block(mesh, dist)
    d_seg = prims.gather_major_block(mesh, dist)
    src = blocks.indices.to(torch.int64)
    d_src, d_dst = d_blk[src], d_seg[blocks.dst_loc]
    match = torch.isfinite(d_src) & (d_src + blocks.weights == d_dst)
    gsrc1 = (mesh.i * blocks.num_cols + src + 1).to(torch.int32)

    def largest(ok):
        part = prims.block_segment_reduce(torch.where(ok, gsrc1, 0),
                                          blocks.dst_loc, blocks.num_segments,
                                          "max", identity=0)
        return prims.scatter_reduce_major(mesh, part, chunk, "max")

    is_source = gidx == int(source)
    reached = torch.isfinite(dist)
    red = largest(match & (d_src < d_dst))
    pred = torch.where((red > 0) & ~is_source & reached, red - 1, -1)
    missing = reached & ~is_source & (pred < 0)
    while True:
        flag = missing.to(torch.uint8)
        red = largest(match
                      & (prims.gather_minor_block(mesh, flag)[src] == 0)
                      & (prims.gather_major_block(mesh, flag)[
                          blocks.dst_loc] == 1))
        attach = missing & (red > 0)
        if _scalar(mesh, attach.sum()) == 0:
            break
        pred = torch.where(attach, red - 1, pred)
        missing = missing & ~attach
    return dist, pred


def mg_wcc(g: DistGraph, mesh):
    """Distributed weakly connected components: label = the smallest
    vertex id of the component, by K2 (min, left) int32 over the pull and
    then the push block each round (INT32_MAX: no in-edge).  Needs push
    blocks."""
    if g.push is None:
        raise ValueError("mg_wcc needs push blocks (store_push=True)")
    gidx, real = _real(mesh, g)
    lab = torch.where(real, gidx, INT_INF).to(torch.int32)
    it, changed = 0, 1
    while changed > 0 and it < g.num_vertices:
        new = torch.minimum(lab, _semiring_pull(mesh, g.pull, lab, None,
                                                "min", "left"))
        new = torch.minimum(new, _semiring_pull(mesh, g.push, new, None,
                                                "min", "left"))
        changed = _scalar(mesh, (new < lab).sum())
        lab, it = new, it + 1
    return lab


# ---------------------------------------------------------------------------
# sampling: k random-priority argmax rounds per frontier vertex over the
# push block (``algos.py:503-1053``), and the walks on top of them
# ---------------------------------------------------------------------------

F32_BIG = 3.0e38     # "no time" in the per-round time minimum
BIGT = 3.0e38        # "no arrival time" in the fused sampler's time planes
_ROUND_SALT = (7919, 131)   # round r on rank (i, j): r·7919 + i·131 + j
_LAYER_SALT = 131           # occurrence layer r of a hop: seed + r·131
_HOP_SALT = 1009            # hop h of a multi-hop call: seed + h·1009


def _i32(x) -> int:
    """``x`` as the JAX package carries a seed (``jnp.int32(x)``): an int32,
    and OverflowError past its range."""
    x = int(x)
    if not -2**31 <= x < 2**31:
        raise OverflowError(f"Python integer {x} out of bounds for int32")
    return x


def _wrap32(x) -> int:
    """int32 arithmetic as the JAX kernels do it on a traced seed: the
    two's-complement wrap of ``x``."""
    return (int(x) + 2**31) % 2**32 - 2**31


def _mix64(z: int) -> int:
    """splitmix64's finalizer (the native library's ``mix64``)."""
    mask = 2**64 - 1
    z &= mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return z ^ (z >> 31)


class MGDraws:
    """The MG hop's per-edge random numbers: one stream per (seed, round,
    rank), keyed as the JAX package keys them, ``fold_in(fold_in(
    PRNGKey(0), seed), r·7919 + i·131 + j)`` (``algos.py:546-557``).  Each
    key seeds a ``torch.Generator`` on ``device`` with a splitmix64 mix of
    (seed, salt), so a round's numbers depend on nothing but its key; the
    tests put a class here that replays the JAX package's numbers, as
    ``algos/sampling.Draws`` is replaced for the single-device samplers.
    ``n`` is the rank's push-block edge count, and number e belongs to its
    edge e."""

    def __init__(self, device):
        self.device = torch.device(device)

    def _generator(self, seed, r, i, j):
        salt = _wrap32(r * _ROUND_SALT[0] + i * _ROUND_SALT[1] + j)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_mix64(((seed & 0xFFFFFFFF) << 32)
                               | (salt & 0xFFFFFFFF)) >> 1)
        return gen

    def edge_uniform(self, seed, r, i, j, n, low, high):
        """float32 [n], uniform in [low, high)."""
        u = torch.rand(n, generator=self._generator(seed, r, i, j),
                       device=self.device)
        return torch.clamp(low + (high - low) * u, min=low)

    def edge_gumbel(self, seed, r, i, j, n):
        """float32 [n] Gumbel noise, -log(-log(u)) with u uniform in
        [1e-20, 1)."""
        return -torch.log(-torch.log(self.edge_uniform(seed, r, i, j, n,
                                                       1e-20, 1.0)))


def _flags(mesh, g: DistGraph, flags_own: torch.Tensor) -> torch.Tensor:
    """Owned vertex flags [Vc] → the push block's dst slots [pmaj·Vc]."""
    return prims.gather_major_block(mesh, flags_own.to(torch.uint8)) > 0


def _sample_hop(g: DistGraph, mesh, f_own, seed: int, k: int, *,
                with_replacement: bool, biased: bool, temporal: bool,
                comparison, f_time=None, edge_ok=None, with_eid=False,
                draws=None):
    """One sampling hop (``_sample_hop_device``, ``algos.py:510-606``): k
    random-priority argmax rounds per frontier vertex over this rank's
    push block, whose rows are the sources' slots (pmaj·Vc) and whose
    indices are the destinations in the row block.

    Each round scores the eligible edges (uniform priorities in [1e-6, 1),
    or log(w) + Gumbel noise when ``biased``, or the raw edge time under
    "last"; −1, or −inf for those two, where an edge is not eligible),
    takes each source's highest score by K2 (max, right) over the block's
    ``square`` CSR with the scores as the weights (``dispatch.
    _select_by_priority``'s first launch; K2 clips to ±1e30, and a row
    with no edge gets −1e30, where the JAX package's segment max has −inf:
    no eligible score is at or below either, so the winners are the same)
    and the MAX along "major"; among the edges at that score the smallest
    global destination wins, then the smallest time and edge instance
    among the chosen edges (``scatter_reduce_`` amin, exact in any order,
    and the MIN along "major").  An edge time beyond ±1e30 ties with the
    others there under "last".  Without replacement, and always under
    "last", a round excludes the edges taken before.  Returns owned panels
    [Vc, k]: global destinations (−1: none), times (0 where none) and
    edge instances (−1), the last None without ``with_eid``."""
    from cugraph_tpu_torch.algos._frontier import temporal_eligible

    blocks, chunk = g.push, g.chunk
    dev = mesh.device
    nseg = g.pmaj * chunk
    draws = MGDraws(dev) if draws is None else draws
    last_mode = temporal and comparison == "last"
    neg = float("-inf") if (biased or last_mode) else -1.0
    red = blocks.dst_loc
    e_local = blocks.e_local
    gdst = mesh.i * blocks.num_cols + blocks.indices
    et = blocks.etime if blocks.etime is not None else blocks.weights
    elig0 = _flags(mesh, g, f_own)[red]
    if edge_ok is not None:
        elig0 = elig0 & edge_ok
    if temporal:
        lim = prims.gather_major_block(mesh, f_time)[red]
        elig0 = elig0 & temporal_eligible(et, lim, comparison)
    w_ok = logw = None
    if biased and not last_mode:
        w_ok = blocks.weights > 0
        logw = torch.log(torch.clamp(blocks.weights, min=1e-30))
    exclude_taken = (not with_replacement) or last_mode
    sq = blocks.square
    x0 = torch.zeros(blocks.side, dtype=torch.float32, device=dev)
    taken = torch.zeros(e_local, dtype=torch.bool, device=dev)
    out_dst = torch.full((chunk, k), -1, dtype=torch.int32, device=dev)
    out_time = torch.zeros((chunk, k), dtype=torch.float32, device=dev)
    out_eid = torch.full_like(out_dst, -1) if with_eid else None
    for r in range(k):
        if last_mode:
            score = et
        elif biased:
            score = logw + draws.edge_gumbel(seed, r, mesh.i, mesh.j,
                                             e_local)
        else:
            score = draws.edge_uniform(seed, r, mesh.i, mesh.j, e_local,
                                       1e-6, 1.0)
        elig = elig0 & ~taken if exclude_taken else elig0
        score = torch.where(elig if w_ok is None else elig & w_ok, score,
                            neg)
        part = spmv_semiring(sq.offsets, sq.indices, score, x0, "max",
                             "right")[:nseg]
        mx = prims.scatter_reduce_major(mesh, torch.clamp(part, min=neg),
                                        chunk, "max")
        win = elig & (torch.clamp(score, -BIG, BIG)
                      == prims.gather_major_block(mesh, mx)[red]) \
            & (score > neg)
        cand = torch.where(win, gdst, INT_INF)
        sel = prims.scatter_reduce_major(
            mesh, prims.block_segment_reduce(cand, red, nseg, "min"), chunk,
            "min")
        out_dst[:, r] = torch.where(sel == INT_INF, -1, sel)
        chosen = win & (gdst == prims.gather_major_block(mesh, sel)[red])
        t_sel = prims.scatter_reduce_major(
            mesh, prims.block_segment_reduce(
                torch.where(chosen, et, F32_BIG), red, nseg, "min",
                identity=F32_BIG), chunk, "min")
        out_time[:, r] = torch.where(t_sel >= F32_BIG / 2, 0.0, t_sel)
        if with_eid:
            e_sel = prims.scatter_reduce_major(
                mesh, prims.block_segment_reduce(
                    torch.where(chosen, blocks.eid, INT_INF), red, nseg,
                    "min"), chunk, "min")
            out_eid[:, r] = torch.where(e_sel == INT_INF, -1, e_sel)
        taken |= chosen
    return out_dst, out_time, out_eid


def mg_sample_one_hop(g: DistGraph, mesh, frontier, k: int, seed: int = 0,
                      with_replacement: bool = False, biased: bool = False,
                      edge_ok=None, frontier_times=None, strict: bool = True,
                      temporal_sampling_comparison: str | None = None):
    """One hop of distributed uniform/biased sampling: k out-neighbours per
    frontier vertex (global ids, the same on every rank).  Returns this
    rank's owned panels on ``mesh.device``: dst int32 [Vc, k] (−1: none),
    time float32 [Vc, k] and eid int32 [Vc, k] (the traversed edge
    instance, where the push block keeps them) or None; the JAX package
    returns them owner-sharded over [pad_v, k].  ``edge_ok`` (this rank's
    bool [E] over its push block) restricts eligibility;
    ``frontier_times`` (host float32 [pad_v]) turns on the temporal
    regime.  The draws come from ``MGDraws``."""
    from cugraph_tpu_torch.algos._frontier import resolve_temporal_comparison

    if g.push is None:
        raise ValueError("sampling needs push blocks (store_push=True)")
    temporal = frontier_times is not None
    if temporal and g.push.etime is None:
        raise ValueError("temporal sampling requires edge_time blocks "
                         "(build_dist_graph(edge_time=...))")
    f = np.zeros(g.pad_v, bool)
    f[np.asarray(frontier, np.int64)] = True
    ft = (_own(mesh, g, np.asarray(frontier_times, np.float32))
          if temporal else None)
    comparison = resolve_temporal_comparison(temporal_sampling_comparison,
                                             strict)
    return _sample_hop(g, mesh, _own(mesh, g, f), _i32(seed), int(k),
                       with_replacement=bool(with_replacement),
                       biased=bool(biased), temporal=temporal,
                       comparison=comparison, f_time=ft, edge_ok=edge_ok,
                       with_eid=g.push.eid is not None)


def sample_panel_rows(mesh, panels, verts):
    """Rows ``verts`` (global ids, the same on every rank) of owned panels
    [Vc, k]: one array or a tuple; returns NumPy array(s) [len(verts), k],
    the same on every rank.  Each rank fills the rows it owns and one
    all-reduce (MAX over a float64 stack, which holds int32 and float32
    exactly) assembles them, so only the asked-for rows cross ranks, as the
    reference ships only the sampled rows (gather_sampled_properties.cuh)."""
    verts = np.asarray(verts, np.int64)
    single = not isinstance(panels, (tuple, list))
    ps = (panels,) if single else tuple(panels)
    widths = [p.shape[1] for p in ps]
    chunk = ps[0].shape[0]
    v = torch.from_numpy(verts).to(mesh.device)
    mine = (v // chunk) == mesh.rank
    rows = (v - mesh.rank * chunk)[mine]
    stack = torch.full((len(verts), sum(widths)), float("-inf"),
                       dtype=torch.float64, device=mesh.device)
    stack[mine] = torch.cat([p[rows].to(torch.float64) for p in ps], 1)
    stack = prims.all_reduce(stack, mesh.world, "max").cpu().numpy()
    outs, off = [], 0
    for p, w in zip(ps, widths):
        dtype = np.int32 if p.dtype == torch.int32 else np.float32
        outs.append(stack[:, off:off + w].astype(dtype))
        off += w
    return outs[0] if single else tuple(outs)


def _frontier_union(mesh, g: DistGraph, dst: torch.Tensor) -> torch.Tensor:
    """Owned flags [Vc] of the global ids in ``dst`` (−1 skipped), from
    every rank: a dense float32 [pad_v] MAX over the mesh, then the owned
    slice (the single-batch kernel's pmax, ``algos.py:747-758``)."""
    flat = dst.reshape(-1).to(torch.int64)
    mask = torch.zeros(g.pad_v, dtype=torch.float32, device=mesh.device)
    mask[flat.clamp(0, g.pad_v - 1)[flat >= 0]] = 1.0
    mask = prims.all_reduce(mask, mesh.world, "max")
    return mask[mesh.rank * g.chunk:(mesh.rank + 1) * g.chunk] > 0.5


def mg_sample_multihop_device(g: DistGraph, mesh, start_list, fanout_vals,
                              seed: int = 0, with_replacement: bool = False,
                              biased: bool = False):
    """The single-batch fused sampler (``algos.py:717-786``): set semantics,
    the default prior-source behaviour, not temporal; the frontier stays
    on the device between hops.  Returns this rank's panels int32
    [n_hops, Vc, kmax] (row v of hop h: v's samples if v was in hop h's
    frontier, else −1), where the JAX package returns [n_hops, pad_v,
    kmax] owner-sharded.  Requires pad_v <= 2^24, as the JAX package."""
    if g.push is None:
        raise ValueError("sampling needs push blocks (store_push=True)")
    if g.pad_v > (1 << 24):
        raise ValueError("device multihop sampler needs pad_v <= 2^24")
    f = np.zeros(g.pad_v, bool)
    f[np.asarray(start_list, np.int64)] = True
    f_own = _own(mesh, g, f)
    ks = [int(k) for k in fanout_vals]
    kmax = max(ks)
    draws = MGDraws(mesh.device)
    outs = []
    for hop, k in enumerate(ks):
        out_dst, _, _ = _sample_hop(
            g, mesh, f_own, _wrap32(_i32(seed) + hop * _HOP_SALT), k,
            with_replacement=with_replacement, biased=biased,
            temporal=False, comparison=None, draws=draws)
        if k < kmax:
            out_dst = torch.nn.functional.pad(out_dst, (0, kmax - k),
                                              value=-1)
        outs.append(out_dst)
        if hop + 1 < len(ks):
            f_own = _frontier_union(mesh, g, out_dst[:, :k])
    return torch.stack(outs, 0)


# -- the generalized fused sampler (``algos.py:789-1053``) -------------------

def _pack_bits(dense: torch.Tensor) -> torch.Tensor:
    """[NB, pad_v] bool → [NB, pad_v / 32] int32 words, vertex 32·w + b at
    bit b of word w (int32, as NCCL and gloo carry it; bit 31 is the
    sign)."""
    nb = dense.shape[0]
    bits = dense.reshape(nb, -1, 32).to(torch.int32)
    shifts = torch.arange(31, dtype=torch.int32, device=dense.device)
    low = (bits[:, :, :31] << shifts).sum(2, dtype=torch.int32)
    return torch.where(bits[:, :, 31] > 0, low | torch.iinfo(torch.int32).min,
                       low)


def _unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """The inverse of ``_pack_bits``: [NB, W] int32 → [NB, 32·W] bool."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return (((words[:, :, None] >> shifts) & 1) > 0).reshape(
        words.shape[0], -1)


def _dense_planes(g: DistGraph, panel: torch.Tensor) -> torch.Tensor:
    """[NB, Vc, k] global ids (−1: none) → flat [NB·pad_v] int64 positions
    plane·pad_v + id of the valid ones, and the mask of those."""
    nb = panel.shape[0]
    flat = panel.reshape(nb, -1).to(torch.int64)
    ok = flat >= 0
    plane = torch.arange(nb, device=panel.device)[:, None] * g.pad_v
    return (plane + flat.clamp(0, g.pad_v - 1)), ok


def _sample_hop_batched(g: DistGraph, mesh, masks, prior, lbase, times,
                        seed: int, k: int, *, with_replacement, biased,
                        behavior, with_eid, temporal, comparison, draws):
    """One hop of the generalized fused sampler
    (``_mg_sample_hop_batched_kernel``, ``algos.py:797-956``), on NB batch
    planes of this rank's owned vertices, masks [NB, Vc]:

    * a (batch, vertex) pair's occurrence layer is the count of the
      batches before it that hold the vertex, plus ``lbase`` (the count in
      earlier groups of 16 planes), the rank the layered path gives it
      under dedupe, so each layer r samples with seed + r·131 as there;
      the populated layers [R0, L) are one MAX all-reduce, read once;
    * prior_sources_behavior "default", "carry_over" and "exclude" are mask
      algebra on the planes;
    * the next frontiers' union rides bit-packed int32 words through one
      all-gather, OR-ed, then each rank keeps its slice;
    * ``temporal``: arrival-time planes [NB, Vc] ride beside the masks;
      the next arrival is the MIN sampled-edge time per (batch, dst), a
      dense float32 [NB, pad_v] MIN over the mesh.

    Returns (panel, epanel, tpanel, next masks, next prior, next times)."""
    nb, chunk = masks.shape
    dev = mesh.device
    cnt = torch.cumsum(masks.to(torch.int32), 0)
    layer = lbase[None, :] + cnt - 1
    big = 1 << 30
    bounds = torch.stack([torch.where(masks, layer + 1, 0).max(),
                          -torch.where(masks, layer, big).min()])
    hi, lo = prims.all_reduce(bounds, mesh.world, "max").tolist()
    panel = torch.full((nb, chunk, k), -1, dtype=torch.int32, device=dev)
    epanel = panel.clone()
    tpanel = torch.zeros((nb, chunk, k), dtype=torch.float32, device=dev)
    for r in range(-lo, hi):
        sel_r = masks & (layer == r)
        f_t = (torch.where(sel_r, times, 0.0).sum(0) if temporal else None)
        out_dst, out_t, out_eid = _sample_hop(
            g, mesh, sel_r.any(0), _wrap32(seed + r * _LAYER_SALT), k,
            with_replacement=with_replacement, biased=biased,
            temporal=temporal, comparison=comparison, f_time=f_t,
            with_eid=with_eid, draws=draws)
        here = sel_r[:, :, None]
        panel = torch.where(here, out_dst[None], panel)
        if temporal:
            tpanel = torch.where(here, out_t[None], tpanel)
        if with_eid:
            epanel = torch.where(here, out_eid[None], epanel)

    pos, ok = _dense_planes(g, panel)
    dense = torch.zeros(nb * g.pad_v, dtype=torch.bool, device=dev)
    dense[pos[ok]] = True
    words = _pack_bits(dense.view(nb, g.pad_v)).contiguous()
    gathered = torch.empty((mesh.size * nb, words.shape[1]),
                           dtype=words.dtype, device=dev)
    dist.all_gather_into_tensor(gathered, words, group=mesh.world)
    gathered = gathered.view(mesh.size, nb, -1)
    union = gathered[0]
    for t in range(1, mesh.size):
        union = union | gathered[t]
    base = mesh.rank * chunk
    dst_own = _unpack_bits(union)[:, base:base + chunk]
    if behavior == "carry_over":
        nmask, nprior = masks | dst_own, prior
    elif behavior == "exclude":
        nprior = prior | masks
        nmask = dst_own & ~nprior
    else:
        nmask, nprior = dst_own, prior
    if temporal:
        narr = torch.full((nb * g.pad_v,), BIGT, dtype=torch.float32,
                          device=dev)
        narr.scatter_reduce_(0, pos[ok], tpanel.reshape(nb, -1)[ok], "amin")
        narr = prims.all_reduce(narr.view(nb, g.pad_v), mesh.world, "min")
        narr = narr[:, base:base + chunk]
        if behavior == "carry_over":
            narr = torch.minimum(torch.where(masks, times, BIGT), narr)
        ntimes = torch.where(nmask, narr, BIGT)
    else:
        ntimes = times
    return panel, epanel, tpanel, nmask, nprior, ntimes


def _compact_hop(g: DistGraph, mesh, panel, epanel, tpanel, masks):
    """This rank's part of a hop's compacted frontier (``_compact_hop_fn``,
    ``algos.py:959-978``): keys plane·pad_v + global vertex of its set mask
    bits, in key order, and their sampled rows."""
    b, v = torch.nonzero(masks, as_tuple=True)
    keys = b * g.pad_v + mesh.rank * g.chunk + v
    return keys, panel[b, v], epanel[b, v], tpanel[b, v]


def _plane_count(lbase, masks):
    """Per-vertex batch count of a plane stack added to ``lbase``
    (``_plane_count_fn``: the running layer base across groups)."""
    return lbase + masks.to(torch.int32).sum(0, dtype=torch.int32)


def mg_sample_multihop_batched_device(g: DistGraph, mesh, masks0, fanouts,
                                      caps, *, seed: int,
                                      with_replacement: bool = False,
                                      biased: bool = False,
                                      behavior: str = "default",
                                      temporal: bool = False,
                                      seed_time: float = 0.0,
                                      comparison: str =
                                      "strictly_increasing"):
    """All hops of the generalized fused sampler
    (``algos.py:991-1053``).  ``masks0``: [NB, pad_v] bool host planes in
    canonical batch order, or a list of them (groups of up to 16 planes,
    run hop-synchronised so that ``lbase`` carries the layer offsets
    across groups); ``caps``: per-hop frontier capacities (a list per
    group), which bound the compacted rows as in the JAX package.
    Returns per group a list of per-hop (keys, rows, eid_rows or None,
    time_rows or None) NumPy arrays, the same on every rank: keys
    plane·pad_v + vertex in key order.  The rows cross ranks once, after
    the last hop."""
    if g.push is None:
        raise ValueError("sampling needs push blocks (store_push=True)")
    if g.pad_v > (1 << 27):
        raise ValueError("fused batched sampler needs pad_v <= 2^27")
    if g.pad_v % 32:
        raise ValueError("fused batched sampler needs 32-divisible pad_v")
    if temporal and g.push.etime is None:
        raise ValueError("temporal fused sampling requires edge_time blocks")
    single = not isinstance(masks0, (list, tuple))
    groups = [masks0] if single else list(masks0)
    gcaps = [caps] if single else list(caps)
    dev = mesh.device
    masks = [_own(mesh, g, np.asarray(m, bool).T).T.contiguous()
             for m in groups]
    prior = [torch.zeros_like(m) for m in masks]
    times = [torch.where(m, float(np.float32(seed_time)), BIGT)
             for m in masks]
    with_eid = g.push.eid is not None
    draws = MGDraws(dev)
    zero_base = torch.zeros(g.chunk, dtype=torch.int32, device=dev)
    local = [[] for _ in groups]
    for hop, k in enumerate(fanouts):
        lbase = zero_base
        hop_seed = _i32(seed + hop * _HOP_SALT)
        for gi in range(len(groups)):
            panel, epanel, tpanel, nmask, nprior, ntimes = \
                _sample_hop_batched(
                    g, mesh, masks[gi], prior[gi], lbase, times[gi],
                    hop_seed, int(k), with_replacement=bool(with_replacement),
                    biased=bool(biased), behavior=behavior,
                    with_eid=with_eid, temporal=bool(temporal),
                    comparison=comparison, draws=draws)
            local[gi].append(_compact_hop(g, mesh, panel, epanel, tpanel,
                                          masks[gi]))
            if gi + 1 < len(groups):
                lbase = _plane_count(lbase, masks[gi])
            masks[gi], prior[gi], times[gi] = nmask, nprior, ntimes
    outs = []
    for gi, hops in enumerate(local):
        per_hop = []
        for hop, parts in enumerate(hops):
            keys, rows, erows, trows = (prims.all_gather_rows(mesh, t)
                                        for t in parts)
            order = torch.sort(keys).indices[:int(gcaps[gi][hop])]
            per_hop.append((keys[order].cpu().numpy(),
                            rows[order].cpu().numpy(),
                            erows[order].cpu().numpy() if with_eid else None,
                            trows[order].cpu().numpy() if temporal
                            else None))
        outs.append(per_hop)
    return outs[0] if single else outs


# -- the walks (``algos.py:1058-1213``) ---------------------------------------

def _walker_columns(inv, counts):
    """Walker i at its vertex takes column (its rank among that vertex's
    walkers)."""
    order = np.argsort(inv, kind="stable")
    col = np.empty(len(inv), np.int64)
    col[order] = np.arange(len(inv)) - np.concatenate(
        [[0], np.cumsum(counts)])[inv[order]]
    return col


def mg_uniform_random_walks(g: DistGraph, mesh, start_vertices,
                            max_depth: int, seed: int = 0,
                            biased: bool = False):
    """Uniform random walks over the 2D partition: int64 [n_walks,
    max_depth + 1], −1 after a walk ends, the same on every rank.  Each
    step samples k = (the most walkers on one vertex) with replacement
    per frontier vertex, seed·1000003 + step, and hands one sample to each
    walker, so co-located walkers stay independent (reference
    random_walks_impl.cuh:894, MG path)."""
    starts = np.asarray(start_vertices, np.int64)
    paths = np.full((len(starts), max_depth + 1), -1, np.int64)
    paths[:, 0] = starts
    cur = starts.copy()
    for step in range(max_depth):
        alive = cur >= 0
        if not alive.any():
            break
        frontier, inv, counts = np.unique(cur[alive], return_inverse=True,
                                          return_counts=True)
        samp, _, _ = mg_sample_one_hop(g, mesh, frontier, int(counts.max()),
                                       seed * 1000003 + step,
                                       with_replacement=True, biased=biased)
        rows = sample_panel_rows(mesh, samp, frontier)
        nxt = np.full(len(cur), -1, np.int64)
        nxt[alive] = rows[inv, _walker_columns(inv, counts)]
        paths[:, step + 1] = nxt
        cur = nxt
    return paths


def mg_biased_random_walks(g: DistGraph, mesh, start_vertices,
                           max_depth: int, seed: int = 0):
    """Edge-weight-biased distributed walks: the uniform walks' stepping
    with the Gumbel weighted argmax per step."""
    return mg_uniform_random_walks(g, mesh, start_vertices, max_depth,
                                   seed=seed, biased=True)


def _host_edge_key_sorted(g: DistGraph) -> torch.Tensor:
    """This rank's sorted (src·pad_v + dst) int64 keys, on its device
    (``partition.edge_table``): owner-local, where the JAX package
    decompresses every block on its single controller."""
    from cugraph_tpu_torch.parallel.partition import edge_table

    return edge_table(g)["keys"]


def mg_has_edge(g: DistGraph, mesh, ss, dd) -> np.ndarray:
    """Membership of the pairs (ss → dd) (host arrays, the same on every
    rank; a −1 entry is False) in the distributed edge list.  Every
    instance of a pair lies in one pull block, so each rank searches its
    own sorted keys (``torch.searchsorted``) and one all-reduce MAX of the
    hit flags answers: O(E/P) memory per rank, where the JAX package
    holds all O(E) keys on its host."""
    ss = torch.from_numpy(np.array(ss, np.int64)).to(mesh.device)
    dd = torch.from_numpy(np.array(dd, np.int64)).to(mesh.device)
    keys = _host_edge_key_sorted(g)
    live = (ss >= 0) & (dd >= 0)
    want = torch.where(live, ss * g.pad_v + dd, -1)
    hit = torch.zeros(want.shape, dtype=torch.int32, device=mesh.device)
    if keys.numel():
        pos = torch.searchsorted(keys, want).clamp(max=keys.numel() - 1)
        hit = (keys[pos] == want).to(torch.int32)
    hit = prims.all_reduce(hit, mesh.world, "max")
    return ((hit > 0) & live).cpu().numpy()


def mg_node2vec_random_walks(g: DistGraph, mesh, start_vertices,
                             max_depth: int, p: float = 1.0, q: float = 1.0,
                             seed: int = 0, max_reject_rounds: int = 8):
    """Distributed node2vec by bounded rejection (``algos.py:1110-1176``):
    each step proposes a uniform neighbour (``mg_sample_one_hop`` with
    replacement, seed·1000003 + step·131 + round) and accepts with
    probability bias / max_bias, bias 1/p (return), 1 (a neighbour of the
    previous vertex, ``mg_has_edge``) or 1/q; NumPy ``default_rng(seed)``
    draws the acceptances, as the JAX package.  Walkers still pending
    after ``max_reject_rounds`` keep their last proposal (exact for p = q
    = 1)."""
    starts = np.asarray(start_vertices, np.int64)
    n_walks = len(starts)
    paths = np.full((n_walks, max_depth + 1), -1, np.int64)
    paths[:, 0] = starts
    rng = np.random.default_rng(seed)
    max_bias = max(1.0, 1.0 / p, 1.0 / q)
    prev = np.full(n_walks, -1, np.int64)
    cur = starts.copy()
    for step in range(max_depth):
        alive = cur >= 0
        if not alive.any():
            break
        accepted = np.full(n_walks, -1, np.int64)
        cand = np.full(n_walks, -1, np.int64)
        pending = alive.copy()
        for r in range(max_reject_rounds):
            if not pending.any():
                break
            frontier, inv, counts = np.unique(cur[pending],
                                              return_inverse=True,
                                              return_counts=True)
            samp, _, _ = mg_sample_one_hop(
                g, mesh, frontier, int(counts.max()),
                seed * 1000003 + step * 131 + r, with_replacement=True)
            rows = sample_panel_rows(mesh, samp, frontier)
            cand = np.full(n_walks, -1, np.int64)
            cand[pending] = rows[inv, _walker_columns(inv, counts)]
            bias = np.full(n_walks, 1.0 / q)
            has_prev = prev >= 0
            back = has_prev & (cand == prev)
            nbr = has_prev & ~back & mg_has_edge(g, mesh, prev, cand)
            bias[back] = 1.0 / p
            bias[nbr] = 1.0
            bias[~has_prev] = 1.0   # first step: plain uniform
            acc = pending & (cand >= 0) & \
                (rng.random(n_walks) < bias / max_bias)
            accepted[acc] = cand[acc]
            dead = pending & (cand < 0)     # no out-neighbour: walk ends
            pending &= ~acc & ~dead
        still = pending & (cand >= 0)
        accepted[still] = cand[still]
        prev = np.where(accepted >= 0, cur, -1)
        cur = accepted
        paths[:, step + 1] = cur
    return paths


# ---------------------------------------------------------------------------
# the analytics (``algos.py:1214-2291``): similarity, negative sampling,
# ECG, cores, betweenness, SCC, triangles and the neighbourhoods.  Where the
# JAX package returns host arrays or frames, every rank returns the same
# full host result; ``mg_core_number`` returns the owned slice [Vc].
# ---------------------------------------------------------------------------

# per-call statistics of the last core, betweenness, SCC, Louvain or ECG
# run (sweeps, binary-search steps, levels per panel, rounds, the Louvain
# cascade's levels, ECG's reweighted push weights), read by chip_smoke.py
LAST_RUN: dict = {}


def _replicated_np(mesh, x_own: torch.Tensor) -> np.ndarray:
    """Owned slices → the [pad_v] host array, the same on every rank."""
    return all_gather_vertex(mesh, x_own.detach()).cpu().numpy()


def _gather_edges(mesh, g: DistGraph, src, dst, keep):
    """The kept pull edges of every rank, (src int64, dst int64, w
    float32) NumPy in mesh position order, the same on every rank."""
    return (prims.all_gather_rows(mesh, src[keep]).cpu().numpy(),
            prims.all_gather_rows(mesh, dst[keep]).cpu().numpy(),
            prims.all_gather_rows(mesh, g.pull.weights[keep]).cpu().numpy())


def _mg_out_degree_counts(g: DistGraph, mesh) -> np.ndarray:
    """Unweighted out-degrees as neighbour-set sizes (parallel edges
    counted once), float64 [pad_v], cached on the DistGraph
    (``algos.py:1225-1243``).  Every instance of a pair lies in one pull
    block, so each rank deduplicates its own keys, counts their sources,
    and one all-reduce adds the counts."""
    cached = g.__dict__.get("_out_counts")
    if cached is not None:
        return cached
    src, dst = local_coo(g)
    keys = torch.unique(src * g.pad_v + dst)
    counts = torch.bincount(keys // g.pad_v, minlength=g.pad_v)
    counts = prims.all_reduce(counts, mesh.world, "sum").cpu().numpy() \
        .astype(np.float64)
    object.__setattr__(g, "_out_counts", counts)
    return counts


def _mg_intersect_ctx(g: DistGraph, mesh) -> CsrMatrix:
    """This rank's neighbour shard (``algos.py:1258-1299``): the
    deduplicated pull edges (u, k) with k % P == its mesh position, moved
    there by one ``all_to_all``, as a CSR over u [pad_v] with each row's
    k sorted; cached on the DistGraph.  Hub adjacency lists split over
    every rank."""
    from cugraph_tpu_torch.parallel.partition import _offsets
    from cugraph_tpu_torch.parallel.shuffle import all_to_all, exchange_counts

    cached = g.__dict__.get("_isect_ctx")
    if cached is not None:
        return cached
    pad_v = g.pad_v
    src, dst = local_coo(g)
    key = torch.unique(src * pad_v + dst)
    target = (key % pad_v) % mesh.size
    order = torch.sort(target, stable=True).indices
    send = torch.bincount(target, minlength=mesh.size)
    recv = exchange_counts(mesh, send)
    got = all_to_all(mesh, key[order], send.tolist(), recv.tolist())
    got = torch.sort(got).values
    u = got // pad_v
    adj = CsrMatrix(_offsets(u, pad_v), (got % pad_v).to(torch.int32),
                    torch.ones(got.shape[0], dtype=torch.float32,
                               device=got.device))
    object.__setattr__(g, "_isect_ctx", adj)
    return adj


def _mg_common_neighbors(g: DistGraph, mesh, firsts, seconds, alive=None):
    """|N(u) ∩ N(v)| over out-neighbours for each pair, float64 [P]
    (exact counts): each rank counts within its shard by the port's
    min-degree probe (``prims/intersection.pair_intersection``, the
    binary search ``lower_bound_rows``), and one all-reduce SUM adds the
    shards.  ``alive`` (bool over the shard's edges) drops edges first,
    as the JAX package's mask (``algos.py:1351-1374``)."""
    from types import SimpleNamespace

    from cugraph_tpu_torch.prims.intersection import pair_intersection

    adj = _mg_intersect_ctx(g, mesh)
    if alive is not None:
        from cugraph_tpu_torch.parallel.partition import _offsets

        alive = torch.as_tensor(alive, device=adj.device)
        adj = CsrMatrix(_offsets(adj.row_ids()[alive], adj.num_vertices),
                        adj.indices[alive], adj.weights[alive])
    firsts = np.asarray(firsts, np.int64).reshape(-1)
    seconds = np.asarray(seconds, np.int64).reshape(-1)
    cnt = pair_intersection(SimpleNamespace(csr=adj), firsts, seconds)[
        "count"].to(torch.int64)
    cnt = prims.all_reduce(cnt, mesh.world, "sum")
    return cnt.cpu().numpy().astype(np.float64)


def _pair_coefficients(kind, g, mesh, firsts, seconds):
    from cugraph_tpu_torch.algos.link_prediction import _coefficients

    cn = _mg_common_neighbors(g, mesh, firsts, seconds)
    deg = _mg_out_degree_counts(g, mesh)
    return _coefficients(kind, cn, deg[np.asarray(firsts)],
                         deg[np.asarray(seconds)])


def mg_jaccard_coefficients(g: DistGraph, mesh, firsts, seconds):
    """Jaccard over out-neighbourhoods for vertex pairs (reference
    link_prediction/jaccard_impl.cuh MG path): float64 [P], the same on
    every rank."""
    return _pair_coefficients("jaccard", g, mesh, firsts, seconds)


def mg_sorensen_coefficients(g: DistGraph, mesh, firsts, seconds):
    return _pair_coefficients("sorensen", g, mesh, firsts, seconds)


def mg_overlap_coefficients(g: DistGraph, mesh, firsts, seconds):
    return _pair_coefficients("overlap", g, mesh, firsts, seconds)


def mg_cosine_coefficients(g: DistGraph, mesh, firsts, seconds):
    return _pair_coefficients("cosine", g, mesh, firsts, seconds)


def _mg_cn_rows(g: DistGraph, mesh, u_batch) -> np.ndarray:
    """CN(v, u) for a batch of u against every vertex v, float32 [pad_v,
    len(u_batch)], the same on every rank (``algos.py:1420-1441``): the
    one-hot panel of the batch, K4 unit over the pull square (Z[w, p] =
    edges u_p → w), Z > 0, then K4 unit over the push square (Y[v, p] =
    Σ_{v→w} Z[w, p]); each between a row-block gather and a reduce-scatter
    along "major" (``prims.pull_spmm_unit``).  Counts are exact."""
    if g.push is None:
        raise ValueError("all-pairs similarity needs push blocks "
                         "(store_push=True)")
    u = torch.as_tensor(np.asarray(u_batch, np.int64), device=mesh.device)
    gidx, _ = _real(mesh, g)
    onehot = (gidx.to(torch.int64)[:, None] == u[None, :]).to(torch.float32)
    z = prims.pull_spmm_unit(mesh, g.pull, onehot)
    y = prims.pull_spmm_unit(mesh, g.push, (z > 0).to(torch.float32))
    return _replicated_np(mesh, y)


def mg_all_pairs_similarity(g: DistGraph, mesh, kind: str = "jaccard",
                            vertices=None, topk: int | None = None,
                            batch: int = 128):
    """All-pairs similarity with optional global top-k
    (``algos.py:1444-1475``): a frame ['first', 'second', '<kind>_coeff']
    sorted by the coefficient, descending, the same on every rank."""
    import pandas as pd

    from cugraph_tpu_torch.algos.link_prediction import _coefficients

    n = g.num_vertices
    deg = _mg_out_degree_counts(g, mesh)
    verts = (np.arange(n, dtype=np.int64) if vertices is None
             else np.asarray(vertices, np.int64))
    rows = []
    for lo in range(0, len(verts), batch):
        u = verts[lo: lo + batch]
        Y = _mg_cn_rows(g, mesh, u)[:n]
        for p, up in enumerate(u):
            cn = Y[:, p]
            sel = np.nonzero(cn > 0)[0]
            sel = sel[sel != up]
            if not len(sel):
                continue
            coeff = _coefficients(kind, cn[sel].astype(np.float64),
                                  deg[up], deg[sel])
            rows.append(pd.DataFrame({"first": up, "second": sel,
                                      "coefficient": coeff}))
        if topk is not None and len(rows) > 1:
            acc = pd.concat(rows, ignore_index=True)
            rows = [acc.nlargest(int(topk), "coefficient")]
    if not rows:
        return pd.DataFrame(columns=["first", "second", f"{kind}_coeff"])
    out = pd.concat(rows, ignore_index=True).sort_values(
        "coefficient", ascending=False, kind="stable").reset_index(drop=True)
    if topk is not None:
        out = out.head(int(topk)).reset_index(drop=True)
    return out.rename(columns={"coefficient": f"{kind}_coeff"})


def mg_negative_sampling(g: DistGraph, mesh, num_samples: int,
                         seed: int = 0, remove_duplicates: bool = True,
                         remove_existing_edges: bool = True,
                         src_bias=None, dst_bias=None, batch: int = 4096,
                         vertices=None,
                         exact_number_of_samples: bool = False):
    """Distributed negative sampling (``algos.py:1477-1541``, reference
    sampling/negative_sampling_impl.cuh:270): weighted-degree-biased
    endpoint draws from NumPy ``default_rng(seed)``, as the JAX package
    draws them, self-pairs dropped, existing edges dropped by
    ``mg_has_edge`` (owner-local), duplicates by a sort, in up to 8 rounds
    (32 with ``exact_number_of_samples``).  Returns a frame ['src',
    'dst'], the same on every rank."""
    import pandas as pd

    del batch
    n = g.num_vertices
    rng = np.random.default_rng(seed)
    cand = None if vertices is None else np.asarray(vertices, np.int64)
    ncand = n if cand is None else len(cand)
    deg_all_s = _replicated_np(mesh, g.out_degree).astype(np.float64)
    deg_all_d = _replicated_np(mesh, g.in_degree).astype(np.float64)
    deg_s = (np.asarray(src_bias, np.float64) if src_bias is not None
             else (deg_all_s[:n] if cand is None else deg_all_s[cand]))
    deg_d = (np.asarray(dst_bias, np.float64) if dst_bias is not None
             else (deg_all_d[:n] if cand is None else deg_all_d[cand]))
    if len(deg_s) != ncand or len(deg_d) != ncand:
        raise ValueError("src/dst bias length must match the candidate set")
    ps = deg_s / deg_s.sum() if deg_s.sum() > 0 else None
    pd_ = deg_d / deg_d.sum() if deg_d.sum() > 0 else None

    out_s, out_d = [], []
    have = 0
    rounds = 32 if exact_number_of_samples else 8
    for _ in range(rounds):
        want = max(num_samples - have, 0)
        if want == 0:
            break
        draw = int(want * 1.5) + 16
        s = rng.choice(ncand, size=draw, p=ps)
        d = rng.choice(ncand, size=draw, p=pd_)
        if cand is not None:
            s, d = cand[s], cand[d]
        ok = s != d
        s, d = s[ok], d[ok]
        if remove_existing_edges and len(s):
            exists = mg_has_edge(g, mesh, s, d)
            s, d = s[~exists], d[~exists]
        out_s.append(s)
        out_d.append(d)
        ss = np.concatenate(out_s)
        dd = np.concatenate(out_d)
        if remove_duplicates:
            uniq = np.unique(ss.astype(np.int64) * n + dd)
            ss, dd = uniq // n, uniq % n
        out_s, out_d = [ss], [dd]
        have = len(ss)
    ss, dd = out_s[0], out_d[0]
    if len(ss) > num_samples:
        # the sort put the survivors in (src, dst) order: a random subset,
        # not the lowest ids
        sel = np.random.default_rng(seed + 1).choice(
            len(ss), num_samples, replace=False)
        ss, dd = ss[sel], dd[sel]
    return pd.DataFrame({"src": ss, "dst": dd})


def _ecg_factor(s, d, member: int) -> np.ndarray:
    """ECG's per-edge jitter factor (``algos.py:1570-1582``): a 64-bit hash
    of the undirected endpoints and the member, exp((u − 0.5)·0.6) with u
    uniform in [0, 1), float32."""
    lo = np.minimum(s, d).astype(np.uint64)
    hi = np.maximum(s, d).astype(np.uint64)
    h = (lo * np.uint64(0x9E3779B97F4A7C15)
         ^ hi * np.uint64(0xC2B2AE3D27D4EB4F)
         ^ np.uint64(member * 0x165667B1 + 0x27D4EB2F))
    u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    return np.exp((u - 0.5) * 0.6).astype(np.float32)


def _owned_sums(mesh, b, w: torch.Tensor, by: str) -> torch.Tensor:
    """float32 owned sums [Vc] of per-edge ``w`` (block order) by the
    block's rows ("major": reduce-scattered along "major") or by its
    indices ("minor"), each partial a float64 ``segment_reduce`` in a
    fixed order (no atomics), rounded once after the reduce-scatter."""
    w64 = w.to(torch.float64)
    if by == "major":
        part = torch.segment_reduce(w64, "sum", lengths=b.lengths)
        return prims.scatter_reduce_major_sum(mesh, part).float()
    order, counts = b.minor_layout
    part = torch.segment_reduce(w64[order], "sum", lengths=counts)
    return prims.scatter_reduce_minor_sum(mesh, part).float()


def mg_ecg(g: DistGraph, mesh, min_weight: float = 0.05,
           ensemble_size: int = 8, max_level: int = 10,
           resolution: float = 1.0, threshold: float = 1e-7, seed: int = 0):
    """Distributed ECG (``algos.py:1544-1632``, reference
    community/ecg_impl.cuh:148): an ensemble of distributed move phases
    (two sweeps each), member e on the push weights jittered by
    ``_ecg_factor(·, seed·131 + e)`` with the out-degrees recomputed from
    them; each rank counts per local edge the members that co-cluster its
    endpoints; the final ``mg_louvain`` runs on weights (min_weight + (1 −
    min_weight)·votes/size)·w.  The move phase reads only the push block
    and the out-degrees, so the pull block is not jittered.  Returns
    (labels int32 [num_vertices], modularity), the same on every rank; the
    modularity is the reweighted graph's, whose push weights (in
    ``local_push_coo`` order) stay in ``LAST_RUN["push_weights"]``."""
    from dataclasses import replace

    from cugraph_tpu_torch.parallel.louvain import (mg_louvain,
                                                    mg_louvain_move_phase)

    if g.push is None:
        raise ValueError("mg_ecg needs push blocks (store_push=True)")
    dev = mesh.device
    ps, pd_ = (t.cpu().numpy() for t in local_coo(g))
    qs, qd = (t.cpu().numpy() for t in local_push_coo(g))
    wp, wq = g.pull.weights.cpu().numpy(), g.push.weights.cpu().numpy()
    votes_pull = np.zeros(len(ps), np.float64)
    votes_push = np.zeros(len(qs), np.float64)
    for e in range(ensemble_size):
        wj = torch.from_numpy(wq * _ecg_factor(qs, qd, seed * 131 + e)).to(
            dev)
        gj = replace(g, push=replace(g.push, weights=wj),
                     out_degree=_owned_sums(mesh, g.push, wj, "major"))
        lab, _ = mg_louvain_move_phase(gj, mesh, resolution, max_sweeps=2)
        votes_pull += lab[ps] == lab[pd_]
        votes_push += lab[qs] == lab[qd]

    def reweighted(w, votes):
        frac = min_weight + (1.0 - min_weight) * votes / ensemble_size
        return torch.from_numpy((frac * w).astype(np.float32)).to(dev)

    wp_new, wq_new = reweighted(wp, votes_pull), reweighted(wq, votes_push)
    new_g = replace(g, pull=replace(g.pull, weights=wp_new),
                    push=replace(g.push, weights=wq_new),
                    out_degree=_owned_sums(mesh, g.push, wq_new, "major"),
                    in_degree=_owned_sums(mesh, g.push, wq_new, "minor"))
    labels, q = mg_louvain(new_g, mesh, max_level=max_level,
                           resolution=resolution, threshold=threshold)
    # the final Louvain's levels stay; its graph's push weights join them
    LAST_RUN.update(algo="ecg", push_weights=wq_new)
    return labels, q


# -- cores --------------------------------------------------------------------

def _threshold_counts(mesh, blocks, core_blk, t_own):
    """Per owned vertex, the count of its block neighbours (the gathered
    end) whose core is >= the vertex's threshold: ``core_blk`` is the
    row block's core gathered by source, the threshold is gathered by dst
    slot; an integer segment sum, reduce-scattered along "major"."""
    t_seg = prims.gather_major_block(mesh, t_own)[blocks.dst_loc]
    ind = (core_blk >= t_seg).to(torch.int32)
    part = prims.block_segment_reduce(ind, blocks.dst_loc,
                                      blocks.num_segments, "sum")
    return prims.scatter_reduce_major_sum(mesh, part)


def _core_blocks(g: DistGraph, degree_type: str):
    """The blocks whose gathered ends are the neighbours counted under
    ``degree_type``: the pull block (in-neighbours) and/or the push block
    (out-neighbours)."""
    if degree_type not in ("incoming", "outgoing", "bidirectional"):
        raise ValueError(f"unknown degree_type {degree_type!r}")
    use_pull = degree_type in ("incoming", "bidirectional")
    use_push = degree_type in ("outgoing", "bidirectional")
    if use_push and g.push is None:
        raise ValueError("need push blocks for this degree_type")
    return ([g.pull] if use_pull else []) + ([g.push] if use_push else [])


def _core_sweep(mesh, blocks, core, max_core: int):
    """One sweep of the fixpoint: core ← min(core, H(core)), H(v) the
    largest t in [0, max_core] with at least t counted neighbours of core
    >= t, by a per-vertex binary search (the count falls as t rises, so
    "count >= t" holds up to H and fails above): max_core.bit_length()
    steps, each one integer segment sum per block."""
    c_blk = [prims.gather_minor_block(mesh, core)[b.indices.to(torch.int64)]
             for b in blocks]
    lo = torch.zeros_like(core)
    hi = torch.full_like(core, max_core + 1)
    for _ in range(max_core.bit_length()):
        mid = (lo + hi) // 2
        ok = sum(_threshold_counts(mesh, b, cb, mid)
                 for b, cb in zip(blocks, c_blk)) >= mid
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid)
    return torch.minimum(core, lo)


def mg_core_number(g: DistGraph, mesh, degree_type: str = "bidirectional",
                   max_core: int | None = None):
    """Distributed core numbers by the h-index fixpoint
    (``algos.py:1641-1716``; Lü et al. 2016): core ← min(core, H(core))
    from ``max_core`` on every real vertex until no vertex changes, H(v)
    the h-index of v's neighbours' cores over the chosen directions
    ("incoming": in-neighbours by the pull block; "outgoing": out-
    neighbours by the push block; "bidirectional": both).  ``max_core``
    defaults to the h-index of the edge-count degree sequence, which
    bounds every core number.  The JAX package finds H(v) by ``max_core``
    threshold counts per sweep, here a binary search finds it
    (``_core_sweep``); the iterates are the JAX package's.  Returns this
    rank's owned core numbers, int32 [Vc]."""
    blocks = _core_blocks(g, degree_type)
    if max_core is None:
        deg = sum(prims.scatter_reduce_major_sum(mesh, b.lengths)
                  for b in blocks)
        ds = np.sort(_replicated_np(mesh, deg))[::-1]
        h = int(np.count_nonzero(ds >= np.arange(1, len(ds) + 1)))
        max_core = max(h, 1)
    max_core = int(max_core)
    _, real = _real(mesh, g)
    core = torch.where(real, max_core, 0).to(torch.int32)
    sweeps, changed = 0, 1
    while changed > 0 and sweeps < g.num_vertices:
        new = _core_sweep(mesh, blocks, core, max_core)
        changed = _scalar(mesh, (new != core).sum())
        core = new
        sweeps += 1
    LAST_RUN.clear()
    LAST_RUN.update(algo="core_number", max_core=max_core, sweeps=sweeps,
                    steps_per_sweep=max_core.bit_length())
    return core


def mg_k_core(g: DistGraph, mesh, k: int | None = None,
              degree_type: str = "incoming"):
    """Distributed k-core (``algos.py:1719-1746``, reference
    cores/k_core_impl.cuh:23): ``mg_core_number``, then each rank keeps
    its pull edges whose endpoints both have core >= k (k: the largest
    core by default) and one all-gather joins them.  Returns (src, dst, w,
    core [pad_v]) NumPy, the same on every rank."""
    core_own = mg_core_number(g, mesh, degree_type=degree_type)
    core = all_gather_vertex(mesh, core_own)
    if k is None:
        k = int(core.max().item())
    src, dst = local_coo(g)
    keep = (core[src] >= k) & (core[dst] >= k)
    s, d, w = _gather_edges(mesh, g, src, dst, keep)
    return s, d, w, core.cpu().numpy()


# -- betweenness --------------------------------------------------------------

_MG_BRANDES_PANEL = 128      # sources per panel of the vertex version
_MG_EDGE_BRANDES_PANEL = 32  # the JAX package's panel for edge betweenness


def _sources(n, k, sources, seed):
    if sources is not None:
        return np.asarray(sources)
    if k is None:
        return np.arange(n)
    return np.random.default_rng(seed).choice(n, size=min(k, n),
                                              replace=False)


def _brandes_panel(g: DistGraph, mesh, panel, endpoints: bool, edep=None):
    """One panel of sources (−1: padding), distributed (JAX
    ``_mg_brandes_kernel_pl``, ``algos.py:1855-1924``): forward σ by K4 unit
    over the pull square per level, backward y = (1 + δ)/σ on ring ℓ + 1 by
    K4 unit over the push square, masked by dist == ℓ.  ``edep`` (float32
    over the push block) takes the per-edge dependencies σ[u]·y[w] of the
    tree edges u → w (the single-device port's chunked row dot).  Returns
    (the panel's owned δ sums float32 [Vc], forward levels)."""
    from cugraph_tpu_torch.algos.centrality import _edge_dependencies

    n = g.num_vertices
    gidx, _ = _real(mesh, g)
    srcs = torch.as_tensor(np.asarray(panel, np.int64), device=mesh.device)
    is_src = gidx.to(torch.int64)[:, None] == srcs[None, :]
    dist_ = torch.where(is_src, 0, INT_INF).to(torch.int32)
    sigma = is_src.to(torch.float32)
    level, cnt = 0, 1
    while cnt > 0 and level < n:
        pulled = prims.pull_spmm_unit(mesh, g.pull, torch.where(
            dist_ == level, sigma, 0.0))
        newly = (pulled > 0) & (dist_ == INT_INF)
        dist_ = torch.where(newly, level + 1, dist_).to(torch.int32)
        sigma = torch.where(newly, pulled, sigma)
        cnt = _scalar(mesh, newly.sum())
        level += 1
    delta = torch.zeros_like(sigma)
    sigma_safe = torch.clamp(sigma, min=1e-30)
    if edep is not None:
        push = g.push
        rows, cols = push.dst_loc, push.indices.to(torch.int64)
    for lv in range(level - 1, -1, -1):
        y = torch.where((dist_ == lv + 1) & (sigma > 0),
                        (1.0 + delta) / sigma_safe, 0.0)
        acc = prims.pull_spmm_unit(mesh, g.push, y)
        a = torch.where(dist_ == lv, sigma, 0.0)
        if edep is not None:
            _edge_dependencies(rows, cols, prims.gather_major_block(mesh, a),
                               prims.gather_minor_block(mesh, y), edep)
        delta = torch.where(dist_ == lv, sigma * acc, delta)
    reached = ~is_src & (dist_ < INT_INF)
    bc = torch.where(reached, delta, 0.0).sum(1)
    if endpoints:
        r = reached.to(torch.float32)
        per_src = prims.psum_all(mesh, r.sum(0))
        bc = bc + r.sum(1) + torch.where(is_src, per_src[None, :], 0.0).sum(1)
    return bc, level


def mg_betweenness_centrality(g: DistGraph, mesh, k: int | None = None,
                              sources=None, normalized: bool = True,
                              directed: bool = True, seed: int = 0,
                              endpoints: bool = False):
    """Distributed Brandes betweenness (``algos.py:1927-1971``): ``k``
    sources drawn by ``default_rng(seed).choice`` (every vertex when k and
    ``sources`` are None), in panels of 128 (K4 unit keeps no per-edge
    panel, so the JAX package's 32 of its XLA route does not apply); the
    single-device scale.  Returns float64 [pad_v] NumPy, the same on
    every rank.  Needs push blocks."""
    from cugraph_tpu_torch.algos._utils import source_panels

    if g.push is None:
        raise ValueError("mg_betweenness needs push blocks "
                         "(store_push=True)")
    n = g.num_vertices
    sources = _sources(n, k, sources, seed)
    bc = torch.zeros(g.chunk, dtype=torch.float64, device=mesh.device)
    levels = []
    for panel, _, _ in source_panels(sources, _MG_BRANDES_PANEL):
        part, lv = _brandes_panel(g, mesh, panel, endpoints)
        bc += part.to(torch.float64)
        levels.append(lv)
    LAST_RUN.clear()
    LAST_RUN.update(algo="betweenness", levels=levels)
    if normalized:
        if endpoints:
            scale = 1.0 / (n * (n - 1)) if n > 1 else 1.0
        else:
            scale = 1.0 / ((n - 1) * (n - 2)) if n > 2 else 1.0
    else:
        scale = 1.0 if directed else 0.5
    if len(sources) < n:
        scale *= n / len(sources)
    return _replicated_np(mesh, bc) * scale


def mg_edge_betweenness_centrality(g: DistGraph, mesh, k: int | None = None,
                                   sources=None, normalized: bool = True,
                                   directed: bool = True, seed: int = 0):
    """Distributed edge betweenness (``algos.py:1974-2047``): the Brandes
    backward levels add each tree edge's dependency over the push block,
    in panels of 32 sources.  Returns a frame ['src', 'dst',
    'betweenness_centrality'] over the push edges in mesh position order,
    each undirected pair once as (min, max) when not ``directed``, the
    same on every rank."""
    import pandas as pd

    from cugraph_tpu_torch.algos._utils import source_panels

    if g.push is None:
        raise ValueError("mg_edge_betweenness needs push blocks "
                         "(store_push=True)")
    n = g.num_vertices
    sources = _sources(n, k, sources, seed)
    eacc = torch.zeros(g.push.e_local, dtype=torch.float64,
                       device=mesh.device)
    levels = []
    for panel, _, _ in source_panels(sources, _MG_EDGE_BRANDES_PANEL):
        edep = torch.zeros(g.push.e_local, dtype=torch.float32,
                           device=mesh.device)
        _, lv = _brandes_panel(g, mesh, panel, False, edep)
        eacc += edep.to(torch.float64)
        levels.append(lv)
    LAST_RUN.clear()
    LAST_RUN.update(algo="edge_betweenness", levels=levels)
    if normalized:
        scale = 1.0 / (n * (n - 1)) if n > 1 else 1.0
        if not directed:
            scale *= 2.0
    else:
        scale = 1.0
    if len(sources) < n:
        scale *= n / len(sources)
    src, dst = local_push_coo(g)
    src_g, dst_g, vals = (prims.all_gather_rows(mesh, t).cpu().numpy()
                          for t in (src, dst, eacc))
    vals = vals * scale
    if directed:
        return pd.DataFrame({"src": src_g, "dst": dst_g,
                             "betweenness_centrality": vals})
    df = pd.DataFrame({"src": np.minimum(src_g, dst_g),
                       "dst": np.maximum(src_g, dst_g),
                       "betweenness_centrality": vals})
    df = df.groupby(["src", "dst"], as_index=False).sum()
    df["betweenness_centrality"] /= 2.0
    return df


# -- strongly connected components --------------------------------------------

def _any_active(mesh, blocks, x_own):
    """Owned flags: some edge of ``blocks`` brings a set flag to the vertex
    (K2 (max, left) int32 over x ∈ {0, 1}; no edge gives INT32_MIN)."""
    return _semiring_pull(mesh, blocks, x_own.to(torch.int32), None, "max",
                          "left") > 0


def mg_strongly_connected_components(g: DistGraph, mesh,
                                     max_rounds: int | None = None):
    """Distributed SCC labels, each the smallest member id
    (``algos.py:2050-2158``): forward-backward with trimming.  Trimming
    drops the active vertices with no active in-neighbour or no active
    out-neighbour (each one K2 (max, left) int32 over the pull or the push
    square, x = active) until none goes, and each trimmed vertex is its
    own SCC; then the pivot, the smallest active id (one all-reduce MIN),
    reaches forward over the pull and backward over the push block (K2
    (max, left) over x = reach, then & active), and FW ∩ BW is one SCC.
    Returns int64 [pad_v] NumPy (−1 on padding), the same on every rank.
    Needs push blocks."""
    if g.push is None:
        raise ValueError("mg_scc needs push blocks (store_push=True)")
    gidx, real = _real(mesh, g)
    gidx = gidx.to(torch.int64)
    labels = torch.full((g.chunk,), -1, dtype=torch.int64,
                        device=mesh.device)
    active = real.clone()
    rounds = trims = reaches = 0
    limit = max_rounds if max_rounds is not None else g.num_vertices + 1
    while rounds < limit and _scalar(mesh, active.sum()) > 0:
        removed = 1
        while removed > 0:
            keep = active & _any_active(mesh, g.pull, active) \
                & _any_active(mesh, g.push, active)
            gone = active & ~keep
            labels = torch.where(gone, gidx, labels)
            removed = _scalar(mesh, gone.sum())
            active = keep
            trims += 1
        if _scalar(mesh, active.sum()) == 0:
            break
        pivot = int(prims.all_reduce(
            torch.where(active, gidx, INT_INF).min(), mesh.world,
            "min").item())
        scc = None
        for blocks in (g.pull, g.push):
            reach = (gidx == pivot) & active
            grew = 1
            while grew > 0:
                new = reach | (_any_active(mesh, blocks, reach) & active)
                grew = _scalar(mesh, (new & ~reach).sum())
                reach = new
                reaches += 1
            scc = reach if scc is None else scc & reach
        labels = torch.where(scc, pivot, labels)
        active = active & ~scc
        rounds += 1
    LAST_RUN.clear()
    LAST_RUN.update(algo="scc", rounds=rounds, trim_sweeps=trims,
                    reach_sweeps=reaches)
    return _replicated_np(mesh, labels)


# -- triangles and k-truss (on the gathered COO) ------------------------------

def mg_triangle_count(g: DistGraph, mesh, batch: int = 4096):
    """Per-vertex triangle counts of a symmetrized distributed graph
    (``algos.py:2160-2180``): the COO all-gathered to every rank
    (``partition.gathered_coo``, O(E) per rank) and counted by the port's
    native degree-oriented wedge engine.  Returns int64 [pad_v] NumPy, the
    same on every rank."""
    from cugraph_tpu_torch.algos._oriented_tri import directed_vertex_counts

    del batch
    src, dst, _ = gathered_coo(g, mesh)
    counts = np.zeros(g.pad_v, np.int64)
    if len(src):
        tri = directed_vertex_counts(src, dst, int(g.pad_v), mesh.device)
        counts[: len(tri)] = tri
    return counts


def mg_k_truss(g: DistGraph, mesh, k: int, batch: int = 4096,
               max_rounds: int = 50):
    """Distributed k-truss (``algos.py:2183-2213``): on the gathered COO,
    the unique undirected pairs (src < dst, first instance) peeled while
    some pair has support < k − 2, recounting the survivors each round.
    Returns (src, dst, w) NumPy, the same on every rank."""
    from cugraph_tpu_torch.algos._oriented_tri import oriented_wedge_counts

    del batch
    src, dst, w = gathered_coo(g, mesh)
    keep_pair = src < dst
    su, du, wu = src[keep_pair], dst[keep_pair], w[keep_pair]
    _, uidx = np.unique(su.astype(np.int64) * int(g.pad_v) + du,
                        return_index=True)
    su, du, wu = su[uidx], du[uidx], wu[uidx]
    alive = np.ones(len(su), bool)
    for _ in range(max_rounds):
        if not alive.any():
            break
        _, sup = oriented_wedge_counts(su[alive], du[alive], int(g.pad_v),
                                       need_edge_support=True)
        drop = sup < (k - 2)
        if not drop.any():
            break
        idx = np.flatnonzero(alive)
        alive[idx[drop]] = False
    return su[alive], du[alive], wu[alive]


# -- neighbourhoods -----------------------------------------------------------

def mg_k_hop_nbrs(g: DistGraph, mesh, start: int, k: int):
    """Vertices within k hops of ``start``, itself excluded
    (``algos.py:2216-2221``, reference k_hop_nbrs_impl.cuh:220): a
    depth-limited ``mg_bfs``.  Returns int64 NumPy ids, the same on every
    rank."""
    dist_, _ = mg_bfs(g, mesh, int(start), depth_limit=int(k))
    d = _replicated_np(mesh, dist_)[: g.num_vertices]
    return np.nonzero((d > 0) & (d <= k))[0]


def mg_egonet(g: DistGraph, mesh, seeds, radius: int = 1):
    """Induced ego subgraphs (``algos.py:2224-2246``, reference
    community/egonet_impl.cuh:212): per seed, ``mg_bfs`` to ``radius``,
    then each rank keeps its pull edges with both ends inside and one
    all-gather joins them.  Returns (src, dst, w, offsets) NumPy, the
    seeds' edge lists concatenated with CSR-style offsets, the same on
    every rank."""
    src, dst = local_coo(g)
    outs, outd, outw, offsets = [], [], [], [0]
    for s in np.asarray(seeds).reshape(-1):
        dist_, _ = mg_bfs(g, mesh, int(s), depth_limit=int(radius))
        inside = all_gather_vertex(mesh, (dist_ <= radius).to(torch.uint8)) \
            > 0
        es, ed, ew = _gather_edges(mesh, g, src, dst,
                                   inside[src] & inside[dst])
        outs.append(es)
        outd.append(ed)
        outw.append(ew)
        offsets.append(offsets[-1] + len(es))
    return (np.concatenate(outs) if outs else np.empty(0, np.int64),
            np.concatenate(outd) if outd else np.empty(0, np.int64),
            np.concatenate(outw) if outw else np.empty(0, np.float32),
            np.asarray(offsets))


def mg_induced_subgraph(g: DistGraph, mesh, vertices):
    """Distributed induced subgraph (``algos.py:2249-2264``): each rank
    keeps its pull edges with both ends in ``vertices`` and one all-gather
    joins them.  Returns (src, dst, w) NumPy, the same on every rank."""
    member = torch.zeros(g.pad_v, dtype=torch.bool, device=mesh.device)
    member[torch.as_tensor(np.asarray(vertices, np.int64).reshape(-1),
                           device=mesh.device)] = True
    src, dst = local_coo(g)
    return _gather_edges(mesh, g, src, dst, member[src] & member[dst])


def mg_two_hop_neighbors(g: DistGraph, mesh, start_vertices=None):
    """All (first, second) pairs two hops apart (``algos.py:2267-2291``):
    scipy's A·A over the gathered COO, the start rows sliced before the
    product.  Returns (first, second) int64 NumPy sorted by (first,
    second), the same on every rank."""
    import scipy.sparse as sp

    src, dst, _ = gathered_coo(g, mesh)
    n = g.num_vertices
    A = sp.csr_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    if start_vertices is not None:
        sv = np.asarray(start_vertices, np.int64).reshape(-1)
        P2 = (A[sv] @ A).tocoo()
        first = sv[P2.row]
        second = P2.col
    else:
        P2 = (A @ A).tocoo()
        first, second = P2.row, P2.col
    mask = first != second
    first, second = first[mask], second[mask]
    order = np.lexsort((second, first))
    return first[order].astype(np.int64), second[order].astype(np.int64)
