"""Components: WCC, SCC, maximal independent set and vertex coloring.

Counterpart of ``cugraph_tpu.algos.components`` (reference
weakly_connected_components_impl.cuh:682-1037,
strongly_connected_components_impl.cuh:2370, mis_impl.cuh:315,
vertex_coloring_impl.cuh:151).  Every sweep is the min/max SpMV (kernel
K2) over int32 values, "left" (the neighbour's value alone), and each loop
reads one flag back per sweep or round:

- WCC: min-label propagation with pointer jumping, K2 (min) over the CSC
  and, for a directed graph, whose edges count both ways, over the CSR;
  an undirected graph's CSC already holds both directions.  Labels are
  int32 vertex ids, so no float bound applies (the JAX package's Pallas
  route refuses 2^24 vertices or more).  ``CUGRAPH_TPU_WCC_HYBRID=1``, read
  per call as in the JAX package, takes the Afforest-style hybrid instead:
  0/1 mask sweeps from the top-degree vertex in K2 (max) float32, then a
  host min-label pass over the edges left; the labels are the same.
- SCC: Orzan rounds.  Forward, K2 (max) over the CSC spreads the largest
  active id that reaches each vertex; backward, K2 (min) over the CSR
  confirms the vertices that reach their colour's root inside the colour.
- MIS: Luby rounds of random priorities, K2 (max) over the self-loop-free
  CSC (and CSR when directed); coloring is iterated MIS.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd
import torch

from cugraph_tpu_torch.algos._utils import vertex_frame
from cugraph_tpu_torch.kernels.semiring import INT32_MAX
from cugraph_tpu_torch.prims.vertex_edge import semiring_by_major

# sweeps of the last weakly_connected_components call (label propagation)
LAST_SWEEPS = 0
# the last SCC, MIS, coloring or hybrid WCC call: its rounds and sweeps
LAST_RUN: dict = {}


def _wcc_labels(g, directed: bool) -> torch.Tensor:
    """The smallest internal id in each vertex's component, int32."""
    global LAST_SWEEPS
    label = torch.arange(g.num_vertices, dtype=torch.int32, device=g.device)
    sweeps, changed = 0, g.num_vertices > 0
    while changed:
        new = torch.minimum(label, semiring_by_major(g.csc, label, "min"))
        if directed:
            new = torch.minimum(new, semiring_by_major(g.csr, label, "min"))
        # pointer jumping: compress toward the root (components.py:79)
        new = torch.minimum(new, new[new.to(torch.int64)])
        changed = not torch.equal(new, label)
        label = new
        sweeps += 1
    LAST_SWEEPS = sweeps
    return label


def _reached_from(g, seed: int, directed: bool):
    """(bool [n], sweeps): the vertices joined to ``seed`` by edges taken
    either way, by 0/1 frontier sweeps in K2 (max, left) float32 (JAX
    ``_wcc_mask_kernel``, components.py:89-113), and the sweeps taken."""
    reach = torch.zeros(g.num_vertices, dtype=torch.bool, device=g.device)
    reach[seed] = True
    frontier, sweeps = reach.clone(), 0
    while True:
        x = frontier.to(torch.float32)
        y = semiring_by_major(g.csc, x, "max")
        if directed:
            y = torch.maximum(y, semiring_by_major(g.csr, x, "max"))
        frontier = (y > 0.5) & ~reach
        reach |= frontier
        sweeps += 1
        if not bool(frontier.any()):
            return reach, sweeps


def _wcc_hybrid(G) -> np.ndarray:
    """Afforest-style WCC (JAX ``_wcc_hybrid``, components.py:116-150): the
    mask sweeps claim the top-degree vertex's component, then a host
    min-label pass with pointer jumping finishes the edges with neither end
    in it (a component is closed, so no edge has one end in it).  int32
    labels equal to ``_wcc_labels``'."""
    n = G.number_of_vertices()
    src, dst, _ = G.edgelist_arrays()
    deg = np.bincount(src, minlength=n) + np.bincount(dst, minlength=n)
    seed = int(deg.argmax())
    reach, sweeps = _reached_from(G.structure, seed, G.is_directed())
    reached = reach.cpu().numpy()
    label = np.arange(n, dtype=np.int64)
    hit = np.flatnonzero(reached)
    if len(hit):
        label[reached] = hit.min()
    resid = ~reached[src]
    rs, rd = src[resid], dst[resid]
    passes = 0
    while True:
        before = label
        label = label.copy()
        np.minimum.at(label, rd, label[rs])
        np.minimum.at(label, rs, label[rd])
        label = np.minimum(label, label[label])   # pointer jumping
        passes += 1
        if np.array_equal(label, before):
            break
    LAST_RUN.clear()
    LAST_RUN.update(algo="wcc_hybrid", seed=seed, mask_sweeps=sweeps,
                    reached=int(reached.sum()), residual_edges=len(rs),
                    host_passes=passes)
    return label.astype(np.int32)


def weakly_connected_components(G, directed=None, connection=None,
                                return_labels=None):
    """WCC; returns ['vertex', 'labels']: the label is the smallest internal
    vertex id in the component, mapped back to its external id (the
    reference returns arbitrary roots,
    weakly_connected_components_impl.cuh:1037).  CUGRAPH_TPU_WCC_HYBRID=1
    takes the mask hybrid, with the same labels."""
    if G.number_of_vertices() and \
            os.environ.get("CUGRAPH_TPU_WCC_HYBRID") == "1":
        label = _wcc_hybrid(G)
    else:
        label = _wcc_labels(G.structure, G.is_directed()).cpu().numpy()
    return vertex_frame(G, {"labels": G.number_map.to_external(label)})


def connected_components(G, directed=None, connection="weak",
                         return_labels=None):
    if connection == "weak":
        return weakly_connected_components(G)
    if connection == "strong":
        return strongly_connected_components(G)
    raise ValueError(f"unknown connection type {connection!r}")


# -- SCC ----------------------------------------------------------------------

def _scc_round(g, active: torch.Tensor, stats: dict):
    """One Orzan round (JAX ``_scc_round``, components.py:184-220): returns
    (confirmed bool [n], colour int32 [n]).

    Forward: colour[v] = the largest active id with a path to v through
    active vertices, K2 (max) over the CSC (an inactive vertex's colour
    stays -1).
    At the fixpoint colour[v] >= colour[u] on every edge u->v between
    active vertices, so the JAX package's backward sweep over edges of
    equal colour needs no edge mask: with x = where(reached, colour,
    INT32_MAX), u has a reached out-neighbour of its own colour exactly
    when K2 (min) over the CSR gives colour[u].  The reached vertices are
    the SCCs of this round's roots (colour[v] == v)."""
    ids = torch.arange(g.num_vertices, dtype=torch.int32, device=g.device)
    color = torch.where(active, ids, -1)
    while True:
        m = semiring_by_major(g.csc, color, "max")
        new = torch.where(active, torch.maximum(color, m), color)
        stats["forward_sweeps"] += 1
        if torch.equal(new, color):
            break
        color = new
    reach = (color == ids) & active
    while True:
        y = semiring_by_major(g.csr, torch.where(reach, color, INT32_MAX),
                              "min")
        new = reach | ((y == color) & active)
        stats["backward_sweeps"] += 1
        if torch.equal(new, reach):
            break
        reach = new
    return reach, color


def _scc_labels(g, stats: dict) -> torch.Tensor:
    """int32 [n]: each vertex's SCC root, the largest internal id in it."""
    n = g.num_vertices
    active = torch.ones(n, dtype=torch.bool, device=g.device)
    scc = torch.full((n,), -1, dtype=torch.int32, device=g.device)
    while bool(active.any()):
        confirmed, color = _scc_round(g, active, stats)  # within active
        scc = torch.where(confirmed, color, scc)
        active &= ~confirmed
        stats["rounds"] += 1
    return scc


def strongly_connected_components(G):
    """SCC labels; returns ['vertex', 'labels']: the label is the largest
    internal id in the SCC, mapped back to its external id."""
    stats = {"algo": "scc", "rounds": 0, "forward_sweeps": 0,
             "backward_sweeps": 0}
    scc = _scc_labels(G.structure, stats).cpu().numpy()
    LAST_RUN.clear()
    LAST_RUN.update(stats)
    return vertex_frame(G, {"labels": G.number_map.to_external(scc)})


# -- MIS and coloring ---------------------------------------------------------

def _neighbour_max(lf, directed: bool, vals: torch.Tensor) -> torch.Tensor:
    """max over each vertex's neighbours, both ways, of ``vals`` (int32);
    INT32_MIN where there is none.  ``lf`` has no self-loops, so a vertex
    never compares with itself (JAX components.py:250-262: a loop vertex
    could never win and the rounds would not end)."""
    y = semiring_by_major(lf.csc, vals, "max")
    if directed:
        y = torch.maximum(y, semiring_by_major(lf.csr, vals, "max"))
    return y


def _mis_rounds(lf, directed: bool, eligible: torch.Tensor, draw,
                stats: dict) -> torch.Tensor:
    """Luby's rounds (JAX ``_mis_kernel``, components.py:244-287) from the
    ``eligible`` vertices: ``draw()`` gives each round's priorities, a
    permutation of [0, n) as int32 [n]; a vertex wins when its priority
    beats every eligible neighbour's, and winners and their neighbours
    leave.  Returns the set, bool [n]."""
    in_set = torch.zeros_like(eligible)
    eligible = eligible.clone()
    while bool(eligible.any()):
        pri = torch.where(eligible, draw(), -1)
        winner = eligible & (pri > _neighbour_max(lf, directed, pri))
        in_set |= winner
        nbr_win = _neighbour_max(lf, directed, winner.to(torch.int32)) > 0
        eligible &= ~winner & ~nbr_win
        stats["luby_rounds"] += 1
    return in_set


def _permutations(n: int, seed: int, device):
    """Priorities for ``_mis_rounds``: ``torch.randperm`` from a generator
    seeded with ``seed`` on ``device`` (the JAX package draws
    ``jax.random.permutation``; the two never agree bit for bit)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return lambda: torch.randperm(n, generator=gen, device=device,
                                  dtype=torch.int32)


def maximal_independent_set(G, seed: int = 0):
    """Returns ['vertex'] rows forming a maximal independent set."""
    g = G.structure
    stats = {"algo": "mis", "luby_rounds": 0}
    eligible = torch.ones(g.num_vertices, dtype=torch.bool, device=g.device)
    mis = _mis_rounds(g.loop_free, G.is_directed(), eligible,
                      _permutations(g.num_vertices, seed, g.device), stats)
    LAST_RUN.clear()
    LAST_RUN.update(stats)
    verts = np.flatnonzero(mis.cpu().numpy())
    return pd.DataFrame({"vertex": G.number_map.to_external(verts)})


def _coloring(lf, directed: bool, limit: int, draws,
              stats: dict) -> torch.Tensor:
    """Iterated MIS (JAX ``vertex_coloring``, components.py:290-316): colour
    c is an MIS of the vertices left, up to ``limit`` colours; the rest
    keep -1.  ``draws()`` gives the ``draw`` of each colour's MIS.  int32
    [n]."""
    n = lf.num_vertices
    eligible = torch.ones(n, dtype=torch.bool, device=lf.device)
    colors = torch.full((n,), -1, dtype=torch.int32, device=lf.device)
    c = 0
    while c < limit and bool(eligible.any()):
        mis = _mis_rounds(lf, directed, eligible, draws(), stats)
        colors = torch.where(mis & eligible, c, colors)
        eligible &= ~mis
        c += 1
    stats["colors"] = c
    return colors


def vertex_coloring(G, seed: int = 0, max_colors: int | None = None):
    """Greedy coloring by iterated MIS (reference
    vertex_coloring_impl.cuh:151).  Returns ['vertex', 'color'].  When
    ``max_colors`` stops the loop before every vertex is colored, the
    leftovers carry the sentinel color -1: check for it before using the
    result as a proper coloring (without a cap every vertex gets one)."""
    g = G.structure
    n = g.num_vertices
    stats = {"algo": "coloring", "luby_rounds": 0}
    limit = max_colors if max_colors is not None else n
    draw = _permutations(n, seed, g.device)
    colors = _coloring(g.loop_free, G.is_directed(), limit, lambda: draw,
                       stats)
    LAST_RUN.clear()
    LAST_RUN.update(stats)
    return vertex_frame(G, {"color": colors})
