"""Centrality: Katz, eigenvector, degree, and a batched multi-source
Brandes for betweenness.

Counterpart of ``cugraph_tpu.algos.centrality`` (reference
katz_centrality_impl.cuh:32-187, eigenvector_centrality_impl.cuh:161).
Katz and eigenvector are power iterations, one sum SpMV (kernel K1, mul)
over the CSC per iteration, with the update, the norm and the L1 change in
plain torch and one read-back of the change per iteration, as the port's
``pagerank``.  Degree centrality is the host degrees.

The Brandes part follows the JAX package's Pallas route (reference
betweenness_centrality_impl.cuh:1636,1649).  A batch of 128 sources runs
at once as [n, 128] sigma and delta panels: every forward level is one K4
launch over the CSC at unit weight (path counts, so edge weights never
enter), every backward level one K4 launch over the CSR.  The edge
dependencies of ``edge_betweenness_centrality``, the row dot sum over b
of a[src_e, b]·y[dst_e, b], are plain torch over chunks of edges, as the
JAX package leaves them to XLA.

The forward loop reads one flag back per level, whether any vertex was
reached: one host sync per level, counted in ``LAST_RUN``.  The backward
loop knows its level count and queues with no sync.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from cugraph_tpu_torch.algos._utils import (normalize_start, panel_onehot,
                                            source_panels, vertex_frame)
from cugraph_tpu_torch.algos.link_analysis import _check_precision
from cugraph_tpu_torch.api.exceptions import FailedToConvergeError
from cugraph_tpu_torch.prims.vertex_edge import spmm_by_major, spmv_pull

BATCH = 128  # sources per panel
# edges per chunk of the edge-dependency row dot: two [2^20, 128] float32
# gathers, 512 MB each, where one [m, 128] gather is 8 GB at RMAT-20
EDGE_CHUNK = 1 << 20
# what the last call did: iterations and the last L1 change (Katz,
# eigenvector), or panels, forward levels per panel and host syncs
# (betweenness)
LAST_RUN: dict = {}


def _power_iteration(step, x, tol: float, max_iter: int, algo: str):
    """x <- step(x) until the L1 change is below ``tol`` (compared in
    float32, as the JAX loop does) or ``max_iter`` steps; returns (x, the
    last change)."""
    tol32 = float(np.float32(tol))
    err, it = float("inf"), 0
    while err >= tol32 and it < max_iter:
        x_new = step(x)
        err = torch.sum(torch.abs(x_new - x)).item()
        x = x_new
        it += 1
    LAST_RUN.clear()
    LAST_RUN.update(algo=algo, iterations=it, err=err)
    return x, err


def _l2_normalized(x):
    return x / torch.clamp(torch.sqrt(torch.sum(x * x)), min=1e-30)


def katz_centrality(G, alpha=None, beta=1.0, max_iter: int = 100,
                    tol: float = 1.0e-6, nstart=None, normalized: bool = True,
                    precision: str = "exact"):
    """Katz centrality (reference katz_centrality_impl.cuh:32-187): x <-
    alpha·Aᵀx + beta from x = 0 (or ``nstart``, a ['vertex', 'values']
    frame) until the L1 change is below n·tol.  ``alpha`` defaults to
    1/(max in-degree + 1); ``beta`` is a scalar or a vector by internal id
    (the reference's ``betas``).  Returns ['vertex', 'katz_centrality'],
    L2-normalised when ``normalized``.  ``precision`` is "exact" or
    "fast"; both run the same fp32 kernel here (see pagerank)."""
    _check_precision(precision)
    g = G.structure
    n = G.number_of_vertices()
    if alpha is None:
        dmax = int(g.in_degrees().max()) if n else 1
        alpha = 1.0 / (dmax + 1)
    x0 = np.zeros(n, dtype=np.float32)
    if nstart is not None:
        ids = G.lookup_internal_vertex_id(nstart["vertex"].to_numpy())
        x0[ids] = nstart["values"].to_numpy()
    if np.ndim(beta) == 0:
        beta_t = float(np.float32(beta))
    else:
        bv = np.zeros(n, np.float32)
        b = np.asarray(beta, np.float32)[:n]
        bv[: len(b)] = b
        beta_t = torch.from_numpy(bv).to(g.device)
    alpha32 = float(np.float32(alpha))
    x, err = _power_iteration(
        lambda x: alpha32 * spmv_pull(g, x) + beta_t,
        torch.from_numpy(x0).to(g.device), n * tol, max_iter, "katz")
    if normalized:
        x = _l2_normalized(x)
    if not err < n * tol:
        raise FailedToConvergeError(
            f"katz failed to converge in {max_iter} iters")
    return vertex_frame(G, {"katz_centrality": x})


def eigenvector_centrality(G, max_iter: int = 100, tol: float = 1.0e-6,
                           precision: str = "exact"):
    """Eigenvector centrality (reference
    eigenvector_centrality_impl.cuh:161), as networkx: the shifted
    iteration y = Aᵀx + x, L2-normalised, from x = 1/sqrt(n), until the L1
    change is below n·tol.  Returns ['vertex', 'eigenvector_centrality'].
    ``precision``: see katz_centrality."""
    _check_precision(precision)
    g = G.structure
    n = G.number_of_vertices()
    x0 = torch.full((n,), float(np.float32(1.0 / np.sqrt(max(n, 1)))),
                    dtype=torch.float32, device=g.device)
    x, err = _power_iteration(
        lambda x: _l2_normalized(spmv_pull(g, x) + x), x0, n * tol,
        max_iter, "eigenvector")
    if not err < n * tol:
        raise FailedToConvergeError(
            f"eigenvector failed to converge in {max_iter} iters")
    return vertex_frame(G, {"eigenvector_centrality": x})


def degree_centrality(G, normalized: bool = True):
    """Degree over n - 1 (``Graph.degree``: in + out when directed).
    Returns ['vertex', 'degree_centrality'], float64."""
    df = G.degree()
    n = G.number_of_vertices()
    vals = df["degree"].to_numpy().astype(np.float64)
    if normalized and n > 1:
        vals = vals / (n - 1)
    return pd.DataFrame({"vertex": df["vertex"], "degree_centrality": vals})


def _edge_dependencies(csr_rows, csr_cols, a, y, edep):
    """edep[e] += sum over b of a[src_e, b]·y[dst_e, b], in edge chunks."""
    for e0 in range(0, csr_cols.shape[0], EDGE_CHUNK):
        au = a.index_select(0, csr_rows[e0:e0 + EDGE_CHUNK])
        au.mul_(y.index_select(0, csr_cols[e0:e0 + EDGE_CHUNK]))
        edep[e0:e0 + EDGE_CHUNK] += au.sum(1)


def _brandes_panel(g, panel: np.ndarray, edges: bool, endpoints: bool,
                   stats: dict):
    """Forward sigma and backward delta for one panel of sources (JAX
    ``_brandes_sweep_batched``, centrality.py:253-327).  ``panel`` holds
    internal ids, -1 for a padding column, which contributes nothing.
    Returns (delta summed over the panel [n], edge dependencies [m] in CSR
    order or None)."""
    n, dev = g.num_vertices, g.device
    src1h = panel_onehot(g, panel)
    dist = torch.where(src1h, 0, -1).to(torch.int32)
    sigma = src1h.to(torch.float32)
    level = 0
    while level < n:
        sig_in = spmm_by_major(g.csc, torch.where(dist == level, sigma, 0.0),
                               unit=True)
        newly = (dist == -1) & (sig_in > 0)
        dist.masked_fill_(newly, level + 1)
        sigma.add_(torch.where(newly, sig_in, 0.0))
        level += 1
        stats["syncs"] += 1
        if not bool(newly.any()):
            break
    stats["levels"].append(level)

    delta = torch.zeros_like(sigma)
    edep = None
    if edges:
        edep = torch.zeros(g.num_edges, dtype=torch.float32, device=dev)
        csr_rows, csr_cols = g.csr.row_ids(), g.csr.indices.to(torch.int64)
    sigma_safe = torch.clamp(sigma, min=1e-30)
    for lv in range(level - 1, -1, -1):
        # y[w] = (1 + delta[w]) / sigma[w] on ring lv + 1; s[u] sums y over
        # u's out-neighbours; the tree-edge test (d[u] == lv and d[w] ==
        # lv + 1) factors into the two masks
        y = torch.where(dist == lv + 1, (1.0 + delta) / sigma_safe, 0.0)
        a = torch.where(dist == lv, sigma, 0.0)
        delta.add_(a * spmm_by_major(g.csr, y, unit=True))
        if edges:
            _edge_dependencies(csr_rows, csr_cols, a, y, edep)
    delta.masked_fill_(src1h, 0.0)
    if endpoints:
        # every reached vertex but the source gets +1, and the source the
        # number it reached (padding columns reach nothing)
        reached = (dist >= 0) & ~src1h
        per_src = reached.sum(0).to(torch.float32)
        delta = delta + reached + torch.where(src1h, per_src[None, :], 0.0)
    return delta.sum(1), edep


def _bc_batched(G, sources: np.ndarray, edges: bool = False,
                endpoints: bool = False):
    """(Vertex, edge) betweenness summed over the sources in panels of 128:
    (bc [n] float32, edge dependencies [m] float32 in CSR order or None),
    on the host."""
    g = G.structure
    stats = {"algo": "betweenness", "panels": 0, "levels": [], "syncs": 0}
    bc = torch.zeros(g.num_vertices, dtype=torch.float32, device=g.device)
    ebc = (torch.zeros(g.num_edges, dtype=torch.float32, device=g.device)
           if edges else None)
    for panel, _, _ in source_panels(sources, BATCH):
        d, ed = _brandes_panel(g, panel, edges, endpoints, stats)
        bc += d
        if edges:
            ebc += ed
        stats["panels"] += 1
    LAST_RUN.clear()
    LAST_RUN.update(stats)
    return bc.cpu().numpy(), (ebc.cpu().numpy() if edges else None)


def _bc_scale(G, k, normalized, n, endpoints=False):
    """The JAX package's scale (centrality.py:431-447): networkx's
    normalisation, halved for undirected graphs when not normalised, and
    n/k when k sources stand for all n."""
    directed = G.is_directed()
    if normalized:
        # raw sums count each unordered pair twice for undirected graphs
        # over all sources, which is the networkx and cuGraph convention;
        # with endpoints the pairs include the endpoints: 1/(n(n-1))
        if endpoints:
            scale = 1.0 / (n * (n - 1)) if n > 1 else 1.0
        else:
            scale = 1.0 / ((n - 1) * (n - 2)) if n > 2 else 1.0
    else:
        scale = 1.0 if directed else 0.5
    if k is not None and k < n:
        scale *= n / k
    return scale


def _sources(G, k, seed):
    """All vertices (k None), k sampled with numpy's default_rng(seed), or
    the listed vertices, as internal ids."""
    n = G.number_of_vertices()
    if k is None:
        return np.arange(n, dtype=np.int32)
    if np.isscalar(k):
        rng = np.random.default_rng(seed)
        return rng.choice(n, size=int(k), replace=False).astype(np.int32)
    return normalize_start(G, k)


def betweenness_centrality(G, k=None, normalized: bool = True, weight=None,
                           endpoints: bool = False, seed=None,
                           random_state=None):
    """Vertex betweenness (reference betweenness_centrality_impl.cuh:1636).
    ``k``: None for every source, a number of sources sampled from
    ``seed`` (or ``random_state``), or a list of source vertices.  Returns
    ['vertex', 'betweenness_centrality']."""
    if weight is not None:
        raise NotImplementedError("weighted betweenness not yet supported")
    n = G.number_of_vertices()
    sources = _sources(G, k, seed if seed is not None else random_state)
    bc, _ = _bc_batched(G, sources, endpoints=endpoints)
    # list-form k gets the same n/|sources| extrapolation as scalar k
    nsrc = len(sources) if (k is not None and len(sources) < n) else None
    scale = _bc_scale(G, nsrc, normalized, n, endpoints=endpoints)
    return vertex_frame(G, {"betweenness_centrality": bc * scale})


def edge_betweenness_centrality(G, k=None, normalized: bool = True,
                                weight=None, seed=None):
    """Edge betweenness (reference betweenness_centrality_impl.cuh:1649).
    Returns ['src', 'dst', 'betweenness_centrality'], in CSR order; an
    undirected graph reports each edge once, as (min, max)."""
    if weight is not None:
        raise NotImplementedError(
            "weighted edge betweenness not yet supported")
    n = G.number_of_vertices()
    sources = _sources(G, k, seed)
    _, ebc = _bc_batched(G, sources, edges=True)

    if normalized:
        scale = 1.0 / (n * (n - 1)) if n > 1 else 1.0
        if not G.is_directed():
            scale *= 2.0
    else:
        # the undirected double count is halved after the groupby below
        scale = 1.0
    if k is not None and not np.isscalar(k):
        k = len(np.asarray(k).reshape(-1))
    if k is not None and k < n:
        scale *= n / len(sources)

    csr = G.structure.csr
    src = csr.row_ids().cpu().numpy()
    dst = csr.indices.cpu().numpy()
    vals = ebc * scale
    df = pd.DataFrame({
        "src": G.number_map.to_external(src),
        "dst": G.number_map.to_external(dst),
        "betweenness_centrality": vals,
    })
    if not G.is_directed():
        # each undirected edge once, its two halves summed, as the reference
        lo = np.minimum(df["src"].to_numpy(), df["dst"].to_numpy())
        hi = np.maximum(df["src"].to_numpy(), df["dst"].to_numpy())
        df = pd.DataFrame({"src": lo, "dst": hi,
                           "betweenness_centrality": vals})
        df = df.groupby(["src", "dst"], as_index=False).sum()
        df["betweenness_centrality"] /= 2.0
    return df
