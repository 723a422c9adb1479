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

from cugraph_tpu_torch.kernels.semiring import BIG, spmv_semiring
from cugraph_tpu_torch.parallel import prims
from cugraph_tpu_torch.parallel.partition import DistGraph

INT_INF = int(np.iinfo(np.int32).max)


def all_gather_vertex(mesh, x_own: torch.Tensor) -> torch.Tensor:
    """Owned slices [Vc, ...] → the global [pad_v, ...] tensor, in owner
    order, on every rank (what the JAX package's ``mg_*`` return)."""
    return prims._Gather.apply(x_own, mesh.world, mesh.size)


def _own(mesh, g: DistGraph, full: np.ndarray) -> torch.Tensor:
    """This rank's slice of a host vector [pad_v]."""
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
