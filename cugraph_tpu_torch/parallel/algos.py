"""Vertex-program algorithms over the 2D partition, one process per rank.

Counterpart of the power methods and traversals of
``cugraph_tpu/parallel/algos.py`` (``:57-507``).  The JAX package runs
each as one jitted ``shard_map`` program with the loop on the device; here
each rank runs the loop in Python, each iteration one kernel over the
rank's local CSR plus collectives:

- ``mg_pagerank``, ``mg_katz_centrality``, ``mg_hits`` (pull, then push),
  ``mg_eigenvector_centrality``: K1 (mul) through ``prims.pull_spmv``;
- ``mg_bfs``: K2 (max, left) int32 over the frontier's global ids + 1;
- ``mg_sssp``: K2 (min, add) float32, and one plain-torch predecessor pass;
- ``mg_wcc``: K2 (min, left) int32 over the pull, then the push block.

A loop's test reads one all-reduced scalar per iteration on the host, so
every rank leaves it together, at the same iteration as the JAX
package's on-device ``while_loop`` up to float32 rounding of the test
value.  Each function returns this rank's owned slice [Vc] on
``mesh.device`` where the JAX package returns the global owner-sharded
[pad_v] array; ``all_gather_vertex`` gives that array on every rank.
Scalars (err, iterations) are Python numbers, the same on every rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from cugraph_tpu_torch.kernels.semiring import BIG, spmv_semiring
from cugraph_tpu_torch.parallel import prims
from cugraph_tpu_torch.parallel.partition import DistGraph

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
    ``cutoff`` too.  The predecessor is the JAX package's exact test,
    d[src] + w == d[dst], with the largest global src: one plain-torch
    pass (K3 takes one vector for rows and columns, and the row block and
    the dst slots differ).  Returns (distance, predecessor) owned slices;
    unreached: inf and -1."""
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
    d_src = d_blk[src]
    ok = torch.isfinite(d_src) & (d_src + blocks.weights
                                  == d_seg[blocks.dst_loc])
    gsrc1 = (mesh.i * blocks.num_cols + src + 1).to(torch.int32)
    part = prims.block_segment_reduce(torch.where(ok, gsrc1, 0),
                                      blocks.dst_loc, blocks.num_segments,
                                      "max", identity=0)
    red = prims.scatter_reduce_major(mesh, part, chunk, "max")
    pred = torch.where((red > 0) & (gidx != int(source))
                       & torch.isfinite(dist), red - 1, -1)
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


def _all_gather_rows(mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` [n_r, ...] (n_r may differ) concatenated in rank
    order, on every rank."""
    n = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    counts = torch.empty(mesh.size, dtype=torch.int64, device=t.device)
    dist.all_gather_into_tensor(counts, n, group=mesh.world)
    counts = counts.tolist()
    top = max(counts)
    if top == 0:
        return t
    pad = t.new_zeros((top,) + tuple(t.shape[1:]))
    pad[:t.shape[0]] = t
    out = t.new_empty((mesh.size * top,) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, pad.contiguous(), group=mesh.world)
    return torch.cat([out[r * top:r * top + c]
                      for r, c in enumerate(counts)])


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
            keys, rows, erows, trows = (_all_gather_rows(mesh, t)
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
