"""ForceAtlas2 graph layout.

Counterpart of ``cugraph_tpu.algos.layout`` (reference legacy
cpp/src/layout/legacy/{force_atlas2.cu, barnes_hut.cuh, exact_fa2.cuh};
Jacomy et al. 2014), on the graph's device in float32, with two
repulsion engines:

* exact: the [V, V] pairwise force with d² = |x_i|² + |x_j|² - 2·x_i·x_j,
  the product a plain ``torch.matmul``;
* particle-mesh (``barnes_hut_optimize=True``, and always above
  ``_PM_AUTO_V`` vertices), the Barnes-Hut analog: vertices binned into a
  2^k × 2^k grid, an exact near field over a window of the Morton-sorted
  vertices, and a far field against every cell's centroid with the
  near cells' residual masses.  The JAX package bins by one-hot matmuls,
  because XLA's scatter runs element by element on the TPU
  (layout.py:89-90); here the binning is a segmented sum per cell in
  Morton order.

Attraction sums each vertex's edges in a fixed order, a segmented sum over
the CSR rows (and over the CSC rows for a directed graph's second
endpoint), so repeated runs are bit-identical.
"""

from __future__ import annotations

import math

import numpy as np
import pandas as pd
import torch

_PM_CHUNK = 1024  # vertices per dense tile in the particle-mesh passes
_PM_AUTO_V = 32768  # above this the exact [V, V] pass switches to PM
_PM_HALO = 512  # Morton-window halo on each side of a chunk (near field)
_MORTON_KEYS = 1 << 16  # two 8-bit cell coordinates


def _exact_repulsion(pos, deg, scaling_ratio):
    """Exact pairwise repulsion (exact_fa2.cuh analog):
    F_i = Σ_j kr·m_i·m_j / d_ij² · (pos_i - pos_j)."""
    sq = torch.sum(pos * pos, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (pos @ pos.T)
    d2 = torch.clamp(d2, min=1e-9)
    f = scaling_ratio * (deg[:, None] * deg[None, :]) / d2
    f.fill_diagonal_(0.0)
    return pos * torch.sum(f, dim=1, keepdim=True) - f @ pos


def _pm_grid_dim(n: int, theta: float) -> int:
    """Grid resolution from vertex count and theta: ~16 vertices per cell
    at theta=0.5, doubled for each halving of theta; a power of two in
    [16, 128] (C = 16,384 cells at most: the force pass keeps several
    [chunk, C] tiles live)."""
    target = math.sqrt(max(n, 1) / 16.0) * (0.5 / max(theta, 0.05))
    return int(min(128, max(16, 2 ** round(math.log2(max(target, 1))))))


def _morton16(cx, cy):
    """Interleave two 8-bit coordinates into a 16-bit Z-order key."""
    def spread(v):
        v = (v | (v << 4)) & 0x0F0F
        v = (v | (v << 2)) & 0x3333
        v = (v | (v << 1)) & 0x5555
        return v

    return spread(cx) | (spread(cy) << 1)


def _pm_repulsion(pos, deg, grid_dim: int, scaling_ratio):
    """Particle-mesh repulsion (barnes_hut.cuh analog), as the JAX
    package's ``_pm_repulsion`` over unpadded vertices:

    1. binning: per cell [mass, mass·x, mass·y], a segmented sum of the
       Morton-sorted vertices (one segment per cell);
    2. near field, exact: each chunk of the Morton order against a window
       of chunk + 2·halo vertices, over pairs in adjacent cells;
    3. far field: each chunk against all C cell centroids, the adjacent
       cells by their residual mass (total minus what the window held,
       per 3×3 offset), so nothing counts twice and a window overflow
       falls back to the centroid.
    """
    n = pos.shape[0]
    dev = pos.device
    G = grid_dim
    C = G * G
    xy_min = pos.min(dim=0).values
    xy_max = pos.max(dim=0).values
    h = torch.clamp((xy_max - xy_min) / G, min=1e-6)
    cxy = torch.clamp(torch.floor((pos - xy_min[None, :]) / h[None, :]),
                      0, G - 1).to(torch.int64)
    cx, cy = cxy[:, 0], cxy[:, 1]
    key = _morton16(cx, cy)
    order = torch.sort(key, stable=True).indices
    sx, sy, sm = pos[order, 0], pos[order, 1], deg[order]
    scx, scy = cx[order], cy[order]

    # binning: the cells are runs of the Morton order
    vals = torch.stack([sm, sm * sx, sm * sy], dim=1)
    by_key = torch.segment_reduce(
        vals, "sum", lengths=torch.bincount(key, minlength=_MORTON_KEYS),
        axis=0)
    iota_c = torch.arange(C, device=dev)
    ccx = iota_c % G
    ccy = iota_c // G
    cell = by_key[_morton16(ccx, ccy)]
    Mc, Sx, Sy = cell[:, 0], cell[:, 1], cell[:, 2]
    ok = Mc[None, :] > 1e-9
    inv = torch.where(ok, 1.0 / torch.clamp(Mc[None, :], min=1e-9), 0.0)
    cent_x = Sx[None, :] * inv
    cent_y = Sy[None, :] * inv

    chunk = min(_PM_CHUNK, n, max(256, (1 << 22) // C))
    n_chunks = -(-n // chunk)
    halo = _PM_HALO
    right = n_chunks * chunk - n + halo  # chunk padding + halo

    def padv(a, fill):
        return torch.nn.functional.pad(a, (halo, right), value=fill)

    wx, wy, wm = padv(sx, 0.0), padv(sy, 0.0), padv(sm, 0.0)
    # padding: cell coordinates far outside every window
    wcx, wcy = padv(scx, -1000), padv(scy, -1000)
    W = chunk + 2 * halo
    notself = (torch.arange(W, device=dev)[None, :] - halo
               != torch.arange(chunk, device=dev)[:, None])

    out = []
    for i in range(n_chunks):
        s = i * chunk
        mine = slice(s + halo, s + halo + chunk)
        win = slice(s, s + W)
        px, py, pm, pcx, pcy = (wx[mine], wy[mine], wm[mine], wcx[mine],
                                wcy[mine])
        nx, ny, nm, ncx, ncy = wx[win], wy[win], wm[win], wcx[win], wcy[win]

        # exact near field over the Morton window; offsets (v - u) match
        # the far tile's (cell - u) buckets
        du = ncx[None, :] - pcx[:, None]
        dv = ncy[None, :] - pcy[:, None]
        pair = (du.abs() <= 1) & (dv.abs() <= 1) & notself
        dx = px[:, None] - nx[None, :]
        dy = py[:, None] - ny[None, :]
        d2 = torch.clamp(dx * dx + dy * dy, min=1e-9)
        f = torch.where(pair, scaling_ratio * pm[:, None] * nm[None, :] / d2,
                        0.0)
        fx = torch.sum(f * dx, dim=1)
        fy = torch.sum(f * dy, dim=1)
        # mass captured per 3x3 neighbour offset o = (dv+1)*3 + (du+1)
        omap = torch.where(pair, (dv + 1) * 3 + (du + 1), -1)
        capt = torch.stack(
            [torch.sum(torch.where(omap == o, nm[None, :], 0.0), dim=1)
             for o in range(9)], dim=1)

        # far field against every cell; adjacent cells by residual mass
        cdu = ccx[None, :] - pcx[:, None]
        cdv = ccy[None, :] - pcy[:, None]
        cnear = (cdu.abs() <= 1) & (cdv.abs() <= 1)
        comap = (cdv + 1) * 3 + (cdu + 1)
        capt_c = torch.where(cnear, capt.gather(1, comap.clamp(0, 8)), 0.0)
        own = cnear & (comap == 4)
        meff = Mc[None, :] - capt_c - torch.where(own, pm[:, None], 0.0)
        meff = torch.clamp(meff, min=0.0)  # f32 cancellation guard
        gx = px[:, None] - cent_x
        gy = py[:, None] - cent_y
        g2 = torch.clamp(gx * gx + gy * gy, min=1e-9)
        fc = torch.where(ok, scaling_ratio * pm[:, None] * meff / g2, 0.0)
        out.append(torch.stack([fx + torch.sum(fc * gx, dim=1),
                                fy + torch.sum(fc * gy, dim=1)], dim=1))
    rep = torch.empty_like(pos)
    rep[order] = torch.cat(out)[:n]
    return rep


class _Attraction:
    """Per-edge endpoints and weights of the attraction pass, and the
    segmented sums over the CSR rows (and the CSC rows for both
    endpoints)."""

    def __init__(self, g, edge_weight_influence: float, both_endpoints):
        csr = g.csr
        self.src = csr.row_ids()
        self.dst = csr.indices.to(torch.int64)
        w = csr.weights
        self.w = torch.where(w > 0, w ** float(edge_weight_influence), 0.0)
        self.out_len = csr.degrees()
        self.in_order = None
        if both_endpoints:
            # the CSR position of each CSC edge, through the edge list
            at = torch.empty_like(csr.perm)
            at[csr.perm.to(torch.int64)] = torch.arange(
                csr.num_edges, dtype=at.dtype, device=at.device)
            self.in_order = at[g.csc.perm.to(torch.int64)].to(torch.int64)
            self.in_len = g.csc.degrees()

    def __call__(self, pos, deg, lin_log_mode, outbound):
        pd_ = pos[self.src] - pos[self.dst]
        dist = torch.sqrt(torch.clamp(torch.sum(pd_ * pd_, dim=1),
                                      min=1e-18))
        fa = torch.log1p(dist) / dist if lin_log_mode else \
            torch.ones_like(dist)
        if outbound:
            fa = fa / torch.clamp(deg[self.src], min=1.0)
        contrib = -(fa * self.w)[:, None] * pd_
        att = torch.segment_reduce(contrib, "sum", lengths=self.out_len,
                                   axis=0)
        if self.in_order is not None:
            att = att + torch.segment_reduce(
                -contrib[self.in_order], "sum", lengths=self.in_len, axis=0)
        return att


def _fa2_steps(pos, force, speed_eff, deg, attraction, iters, *,
               jitter_tolerance, scaling_ratio, gravity, outbound,
               lin_log_mode, strong_gravity_mode, pm_grid_dim):
    """``iters`` FA2 steps from the state (pos, force, speed_eff) (JAX
    ``_fa2_kernel``); returns the new state."""
    for _ in range(iters):
        if pm_grid_dim:
            rep = _pm_repulsion(pos, deg, pm_grid_dim, scaling_ratio)
        else:
            rep = _exact_repulsion(pos, deg, scaling_ratio)
        att = attraction(pos, deg, lin_log_mode, outbound)
        if strong_gravity_mode:
            grav = -gravity * deg[:, None] * pos
        else:
            pnorm = torch.sqrt(torch.clamp(torch.sum(pos * pos, dim=1),
                                           min=1e-18))
            grav = -gravity * deg[:, None] * pos / pnorm[:, None]
        new_force = rep + att + grav
        # adaptive speed (swing/traction), one global speed
        swing = torch.sum(deg * torch.sqrt(
            torch.sum((new_force - force) ** 2, dim=1)))
        traction = torch.sum(deg * 0.5 * torch.sqrt(
            torch.sum((new_force + force) ** 2, dim=1)))
        speed_eff = torch.clamp(
            jitter_tolerance * jitter_tolerance * traction
            / torch.clamp(swing, min=1e-9), max=10.0)
        fnorm = torch.sqrt(torch.clamp(torch.sum(new_force * new_force,
                                                 dim=1), min=1e-18))
        factor = speed_eff / (1.0 + torch.sqrt(speed_eff * fnorm))
        pos = pos + new_force * factor[:, None]
        force = new_force
    return pos, force, speed_eff


def force_atlas2(G, max_iter: int = 500, pos_list=None,
                 outbound_attraction_distribution: bool = True,
                 lin_log_mode: bool = False,
                 prevent_overlapping: bool = False,
                 edge_weight_influence: float = 1.0,
                 jitter_tolerance: float = 1.0,
                 barnes_hut_optimize: bool = False,
                 barnes_hut_theta: float = 0.5, scaling_ratio: float = 2.0,
                 strong_gravity_mode: bool = False, gravity: float = 1.0,
                 verbose: bool = False, callback=None,
                 random_state: int = 42):
    """ForceAtlas2 layout on the graph's device; returns ['vertex', 'x',
    'y'] (reference force_atlas2.pyx / layout/legacy/force_atlas2.cu).

    ``barnes_hut_optimize=True`` selects the particle-mesh engine, which is
    always taken above ``_PM_AUTO_V`` vertices; ``barnes_hut_theta`` sets
    its grid (smaller theta, finer grid).  ``callback`` follows the
    reference's GraphBasedDimRedCallback protocol: ``on_preprocess_end``,
    ``on_epoch_end`` after each iteration, ``on_train_end``, each with the
    [n, 2] positions."""
    g = G.structure
    n = G.number_of_vertices()
    dev = g.device
    use_pm = bool(barnes_hut_optimize) or n > _PM_AUTO_V
    pm_grid_dim = _pm_grid_dim(n, barnes_hut_theta) if use_pm else 0
    pos = np.zeros((n, 2), np.float32)
    if pos_list is not None:
        ids = G.lookup_internal_vertex_id(pos_list["vertex"].to_numpy())
        pos[ids, 0] = pos_list["x"].to_numpy()
        pos[ids, 1] = pos_list["y"].to_numpy()
    else:
        rng = np.random.default_rng(random_state)
        pos[:] = rng.uniform(-100, 100, (n, 2)).astype(np.float32)
    deg = (g.csr.degrees() + 1).to(torch.float32)  # mass = degree + 1
    attraction = _Attraction(g, edge_weight_influence, G.is_directed())
    kw = dict(jitter_tolerance=float(jitter_tolerance),
              scaling_ratio=float(scaling_ratio), gravity=float(gravity),
              outbound=bool(outbound_attraction_distribution),
              lin_log_mode=bool(lin_log_mode),
              strong_gravity_mode=bool(strong_gravity_mode),
              pm_grid_dim=pm_grid_dim)
    state = (torch.as_tensor(pos, device=dev),
             torch.zeros((n, 2), dtype=torch.float32, device=dev),
             torch.tensor(1.0, device=dev))
    if callback is None:
        state = _fa2_steps(*state, deg, attraction, int(max_iter), **kw)
    else:
        callback.on_preprocess_end(pos)
        for _ in range(int(max_iter)):
            state = _fa2_steps(*state, deg, attraction, 1, **kw)
            callback.on_epoch_end(state[0].cpu().numpy())
        callback.on_train_end(state[0].cpu().numpy())
    out = state[0].cpu().numpy()
    return pd.DataFrame({"vertex": G.number_map.to_external(np.arange(n)),
                         "x": out[:, 0], "y": out[:, 1]})
