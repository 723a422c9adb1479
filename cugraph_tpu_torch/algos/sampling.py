"""Sampling: uniform/biased neighbour sampling, heterogeneous and temporal
neighbour sampling, random walks (uniform, biased, node2vec), negative
sampling.

Counterpart of ``cugraph_tpu.algos.sampling``
(reference cpp/src/sampling/: neighbor_sampling_impl.cuh:166,
temporal_sampling_impl.cuh,
random_walks_impl.cuh:894-933, negative_sampling_impl.cuh:270).  Every
draw comes from one ``torch.Generator`` on the graph's device, seeded with
``random_state`` (None: 0) and read in a fixed order (``Draws``): torch's
Philox never agrees with the JAX package's threefry, so each sampler's
core takes its draws from the caller, and the tests hand it the JAX
package's own draws and compare bit for bit.  The NumPy engines
(``_host_sample_without_replacement``, ``_eidx_lookup`` with a NumPy
``Generator``, the biased endpoint draws of ``negative_sampling``) take
their seeds from the same stream and draw as the JAX package does.

The laws are the JAX package's.  Uniform selection with replacement is
``floor(u * degree)`` into the CSR row; biased selection searches the
row's cumulative weights (``_row_cumweights``) in 32 steps; without
replacement, Gumbel top-k over a [frontier, max_deg] tile while that tile
has at most ``_TILE_FALLBACK_ENTRIES`` entries, and beyond it the same law
over the frontier's edges alone: a Gumbel key per edge, a sort by (row,
-key), and the first min(k, degree) of each row
(``_sample_without_replacement_sorted``, the NumPy engine's algorithm on
the graph's device).  The heterogeneous and temporal samplers restrict
the same Gumbel top-k to the edges of each type that pass the temporal
test (``_masked_neighbor_sample``); beyond the tile they sort the
frontier's eligible edges once per hop for every type together.  Each hop
crosses to the host once for its frame, and once per edge property.

The JAX package's neighbour tables (``_fetch_tables``, ``_DENSE_CDF_MAX``,
``prims/neighbor_table.py``) are row-gather machinery for the TPU and have
no counterpart: the port always walks the CSR.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from cugraph_tpu_torch.algos._frontier import (FrontierState,
                                               pop_dedupe_sources,
                                               resolve_temporal_comparison,
                                               temporal_eligible)
from cugraph_tpu_torch.algos._utils import normalize_start, unrenumber_column
from cugraph_tpu_torch.kernels.dispatch import per_v_random_select
from cugraph_tpu_torch.prims.intersection import (_host_csr,
                                                  enumerate_neighbors,
                                                  lower_bound_rows)

_SENTINEL = -1


class Draws:
    """The samplers' random numbers: one ``torch.Generator`` on ``device``,
    seeded with ``random_state`` (None: 0).  ``split()`` gives one hop's
    draws, where the JAX package splits its key once per hop; here the
    generator just carries on.  A test hands the cores an object with the
    same methods that replays the JAX package's ``jax.random`` draws."""

    def __init__(self, random_state, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(
            0 if random_state is None else int(random_state))

    def split(self) -> "Draws":
        return self

    def uniform(self, shape, low: float = 0.0,
                high: float = 1.0) -> torch.Tensor:
        """float32, uniform in [low, high), as ``jax.random.uniform``."""
        u = torch.rand(shape, generator=self.generator, device=self.device)
        if low == 0.0 and high == 1.0:
            return u
        return torch.clamp(low + (high - low) * u, min=low)

    def gumbel(self, shape) -> torch.Tensor:
        """float32 Gumbel noise, -log(-log(u)) with u in [1e-20, 1), as the
        JAX package's tile route draws it (sampling.py:124-125)."""
        return -torch.log(-torch.log(self.uniform(shape, 1e-20, 1.0)))

    def edge_gumbel(self, n: int) -> torch.Tensor:
        """float64 Gumbel keys, numpy's formula -log(-log(1 - u))."""
        u = torch.rand(n, generator=self.generator, device=self.device,
                       dtype=torch.float64)
        return -torch.log(-torch.log1p(-u))

    def seed(self) -> int:
        """A seed for the NumPy engines."""
        return int(torch.randint(0, 2**31 - 1, (1,), generator=self.generator,
                                 device=self.device).item())

    def randint_pair(self, m: int, high: int):
        """Two int64 host arrays of ``m`` draws in [0, high)."""
        pair = torch.randint(0, high, (2, m), generator=self.generator,
                             device=self.device)
        s, d = pair.cpu().numpy()
        return s, d


def _at(values: torch.Tensor, eidx: torch.Tensor) -> torch.Tensor:
    """values[eidx] for clipped edge positions; zeros on an edgeless
    structure, where every position is masked."""
    if values.shape[0] == 0:
        return torch.zeros(eidx.shape, dtype=values.dtype,
                           device=values.device)
    return values[eidx]


def _row_bounds(adj, frontier: torch.Tensor):
    offsets = adj.offsets.to(torch.int64)
    base = offsets[frontier]
    return base, offsets[frontier + 1] - base


def _search_cumweights(cumw, lo, hi, tgt, last: int):
    """The first position in [lo, hi) with cumw >= tgt, by the JAX
    package's 32-step search (sampling.py:83-95), clipped to the edges."""
    for _ in range(32):
        mid = (lo + hi) >> 1
        val = cumw[mid.clamp(0, last)]
        right = (val < tgt) & (lo < hi)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(right | (lo >= hi), hi, mid)
    return lo.clamp(0, last)


def _sample_neighbors(g, frontier: torch.Tensor, draws, k: int,
                      with_replacement: bool, biased: bool, max_deg: int,
                      cumw: torch.Tensor | None = None):
    """For each frontier vertex draw k out-neighbours.
    Returns (dst [F, k], edge_idx [F, k], valid [F, k]) on the graph's
    device.  ``draws`` gives u [F, k] with replacement, the Gumbel tile
    [F, max_deg] without."""
    adj = g.csr
    F = frontier.shape[0]
    last = max(adj.num_edges - 1, 0)
    base, deg = _row_bounds(adj, frontier)

    if with_replacement:
        u = draws.uniform((F, k))
        if biased:
            wtot = _at(cumw, (base + deg.clamp(min=1) - 1).clamp(0, last))
            tgt = u * wtot[:, None]
            eidx = _search_cumweights(cumw, base[:, None].expand(F, k),
                                      (base + deg)[:, None].expand(F, k),
                                      tgt, last)
        else:
            off = torch.floor(u * deg[:, None]).to(torch.int64)
            off = torch.minimum(off, (deg[:, None] - 1).clamp(min=0))
            eidx = (base[:, None] + off).clamp(0, last)
        valid = (deg > 0)[:, None].expand(F, k)
        return _at(adj.indices, eidx), eidx, valid

    # without replacement: Gumbel top-k over the neighbour tile, k capped
    # at max_deg (every neighbour when the fanout exceeds it)
    return _sample_neighbors_masked(g, frontier, draws, k, max_deg,
                                    biased=biased)


def _row_cumweights(g) -> torch.Tensor:
    """Per-row cumulative edge weights of the CSR (resetting at each row
    start): a float64 cumsum on the host, then float32, exactly as the JAX
    package (sampling.py:164-172); on the structure's device."""
    off, _, w = _host_csr(g.csr, True)
    c = np.cumsum(np.asarray(w, dtype=np.float64))
    rowstart_cum = c[np.maximum(off[:-1] - 1, 0)] * (off[:-1] > 0)
    per_edge_rowstart = np.repeat(rowstart_cum, np.diff(off))
    return torch.as_tensor((c - per_edge_rowstart).astype(np.float32),
                           device=g.device)


def _cached_cumweights(G) -> torch.Tensor:
    """``_row_cumweights`` of G, computed at the first call and kept."""
    cumw = getattr(G, "_cumw_cache", None)
    if cumw is None:
        cumw = _row_cumweights(G.structure)
        G._cumw_cache = cumw
    return cumw


def _max_out_degree(g) -> int:
    n = g.num_vertices
    return max(int(g.out_degrees().max()), 1) if n else 1


# --------------------------------------------------------------------------
# Neighbour sampling (cugraph uniform_neighbor_sample API)
# --------------------------------------------------------------------------

# beyond this many tile entries (F × max_deg) sampling without replacement
# takes the per-edge sorted route (the JAX package's threshold for its host
# engine, sampling.py:246)
_TILE_FALLBACK_ENTRIES = 4_000_000


def _eidx_lookup(g, srcs, dsts, rng=None):
    """CSR edge index of each (src, dst) pair: a vectorized binary search
    within row spans over the host CSR (NumPy).  Default: the FIRST
    parallel instance.  With ``rng`` (a NumPy Generator): a UNIFORM draw
    among the parallel instances, the conditional law of the bulk
    with-replacement route, whose per-edge iid priorities make the winning
    instance uniform given its endpoint (a copy of the JAX package's)."""
    off, ind, _ = _host_csr(g.csr, False)
    lo = off[srcs].astype(np.int64)
    hi = off[srcs + 1].astype(np.int64)
    last = max(len(ind) - 1, 0)
    up = None
    if rng is not None:
        up = hi.copy()          # upper_bound search runs alongside
    for _ in range(34):
        mid = (lo + hi) >> 1
        v = ind[np.clip(mid, 0, last)]
        go = (v < dsts) & (lo < hi)
        lo = np.where(go, mid + 1, lo)
        hi = np.where(go | (lo >= hi), hi, mid)
    if up is None:
        return lo
    lo2 = lo.copy()
    for _ in range(34):
        mid = (lo2 + up) >> 1
        v = ind[np.clip(mid, 0, last)]
        go = (v <= dsts) & (lo2 < up)
        lo2 = np.where(go, mid + 1, lo2)
        up = np.where(go | (lo2 >= up), up, mid)
    count = np.maximum(lo2 - lo, 1)
    return lo + (rng.random(len(lo)) * count).astype(np.int64)


def _host_sample_without_replacement(g, frontier, seed0, k, biased):
    """The JAX package's host Gumbel-top-k engine (sampling.py:249-320), in
    NumPy over the host CSR, seeded with ``seed0``: per-edge keys, one
    lexsort by (row, -key), rank-within-row < min(k, deg); uniform rows of
    degree >= max(4k², 2k) take the first k distinct of 2k iid draws
    instead.  The plain version of ``_sample_without_replacement_sorted``,
    and given the JAX package's seed the same arrays as its engine."""
    off, ind, w = _host_csr(g.csr, biased)
    F = len(frontier)
    deg = (off[frontier + 1] - off[frontier]).astype(np.int64)
    kk = int(k)
    dst = np.full((F, kk), -1, np.int64)
    eidx = np.zeros((F, kk), np.int64)
    valid = np.zeros((F, kk), bool)
    if kk == 0 or not len(frontier):
        return dst, eidx, valid
    rows_idx = np.arange(F)
    if not biased and kk >= 1:
        big = deg >= max(4 * kk * kk, 2 * kk)
        B = int(big.sum())
        if B:
            m = 2 * kk
            rngb = np.random.default_rng((seed0, 1))
            u = rngb.random((B, m))
            db = deg[big][:, None]
            cand = np.minimum((u * db).astype(np.int64), db - 1)
            acc = np.full((B, kk), -1, np.int64)
            cnt = np.zeros(B, np.int64)
            for j in range(m):
                cj = cand[:, j]
                dup = (acc == cj[:, None]).any(axis=1)
                take = (~dup) & (cnt < kk)
                acc[take, cnt[take]] = cj[take]
                cnt = cnt + take
            done = cnt >= kk
            rb = rows_idx[big][done]
            e_acc = off[frontier[big][done]].astype(np.int64)[:, None] \
                + acc[done]
            eidx[rb] = e_acc
            dst[rb] = ind[e_acc]
            valid[rb] = True
            # under-filled big rows (astronomically rare) join the sort path
            sort_rows = ~big
            sort_rows[rows_idx[big][~done]] = True
        else:
            sort_rows = ~big
        if not sort_rows.any():
            return dst, eidx, valid
        d_s, e_s, v_s = _host_sample_wr_sorted(off, ind, w,
                                               frontier[sort_rows],
                                               kk, biased, seed0)
        dst[sort_rows] = d_s
        eidx[sort_rows] = e_s
        valid[sort_rows] = v_s
        return dst, eidx, valid
    return _host_sample_wr_sorted(off, ind, w, frontier, kk, biased, seed0)


def _host_sample_wr_sorted(off, ind, w, frontier, kk, biased, seed0,
                           keys=None):
    """Lexsort Gumbel-top-k core over the given rows (see caller); the
    per-edge ``keys`` (float64, one per edge of the rows in order) default
    to the JAX package's draw ``default_rng((seed0, 2)).gumbel``."""
    F = len(frontier)
    deg = (off[frontier + 1] - off[frontier]).astype(np.int64)
    total = int(deg.sum())
    dst = np.full((F, kk), -1, np.int64)
    eidx = np.zeros((F, kk), np.int64)
    valid = np.zeros((F, kk), bool)
    if total == 0:
        return dst, eidx, valid
    rowptr = np.concatenate([[0], np.cumsum(deg)])
    rows = np.repeat(np.arange(F), deg)
    pos = np.arange(total) - np.repeat(rowptr[:-1], deg)
    e = np.repeat(off[frontier].astype(np.int64), deg) + pos
    if keys is None:
        keys = np.random.default_rng((seed0, 2)).gumbel(size=total)
    if biased:
        wf = w[e].astype(np.float64)
        keys = np.where(wf > 0, keys + np.log(np.maximum(wf, 1e-300)),
                        -np.inf)
    order = np.lexsort((-keys, rows))
    rank = pos          # post-lexsort index within each row == slot offset
    rs, es, ks = rows[order], e[order], keys[order]
    take = (rank < kk) & (ks > -np.inf)
    rr, cc = rs[take], rank[take]
    eidx[rr, cc] = es[take]
    dst[rr, cc] = ind[es[take]]
    valid[rr, cc] = True
    return dst, eidx, valid


def _frontier_edges(adj, frontier: torch.Tensor, total: int | None = None):
    """The out-edges of the frontier's rows in CSR order: (row, the
    position in ``frontier``; pos, the rank within the row; e, the CSR
    position), int64 [total].  ``total`` (deg.sum()) costs a sync when not
    given."""
    dev = adj.device
    base, deg = _row_bounds(adj, frontier)
    if total is None:
        total = int(deg.sum())
    rows = torch.repeat_interleave(torch.arange(frontier.shape[0], device=dev),
                                   deg, output_size=total)
    pos = torch.arange(total, device=dev) - (torch.cumsum(deg, 0) - deg)[rows]
    return rows, pos, base[rows] + pos


def _log_weight_keys(keys: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """float64 keys shifted by log w, -inf where w <= 0: Gumbel top-k
    then picks without replacement in proportion to w."""
    wf = w.to(torch.float64)
    return torch.where(wf > 0, keys + torch.log(torch.clamp(wf, min=1e-300)),
                       -torch.inf)


def _order_by_group_then_key(group: torch.Tensor,
                             keys: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts by (group, -key), equal keys in the given
    order (two stable sorts)."""
    order = torch.sort(-keys, stable=True).indices
    return order[torch.sort(group[order], stable=True).indices]


def _sample_without_replacement_sorted(adj, frontier: torch.Tensor,
                                       keys: torch.Tensor, k: int,
                                       biased: bool):
    """``_host_sample_wr_sorted``'s algorithm on the structure's device:
    ``keys`` (float64, one per edge of the frontier's rows in order: the
    caller draws deg.sum() of them) are log-weight shifted when
    ``biased``, two stable sorts order the edges by (row, -key), and each
    row keeps its first min(k, deg).  Returns (dst [F, k] int64, -1 where
    nothing was picked; eidx [F, k]; valid [F, k]); the same arrays as
    the NumPy engine's sort path given the same keys."""
    F = frontier.shape[0]
    dev = adj.device
    total = keys.shape[0]
    dst = torch.full((F, k), -1, dtype=torch.int64, device=dev)
    eidx = torch.zeros((F, k), dtype=torch.int64, device=dev)
    valid = torch.zeros((F, k), dtype=torch.bool, device=dev)
    if total == 0 or k == 0:
        return dst, eidx, valid
    rows, pos, e = _frontier_edges(adj, frontier, total)
    if biased:
        keys = _log_weight_keys(keys, adj.weights[e])
    order = _order_by_group_then_key(rows, keys)
    es, ks = e[order], keys[order]
    take = (pos < k) & (ks > -torch.inf)   # pos is the rank after the sort
    rr, cc, et = rows[take], pos[take], es[take]
    eidx[rr, cc] = et
    dst[rr, cc] = adj.indices[et].to(torch.int64)
    valid[rr, cc] = True
    return dst, eidx, valid


def _bulk_sample_with_replacement(G, g, frontier, draws, k):
    """Fanout-k uniform sampling WITH replacement by k rounds of
    ``per_v_random_select`` (K2 (max, right), then K3 eqsel) over the whole
    graph, for a frontier of distinct vertices.  For parallel edges the
    sampled NEIGHBOUR is multiplicity-weighted as on the gather route, and
    the edge is a uniform draw among the parallel instances, the rounds'
    exact conditional law (``_eidx_lookup``).  Returns (dst [F, k],
    eidx [F, k], valid [F, k]) as host arrays.

    ``_neighbor_sample`` does not take this route, which the JAX package
    takes for large distinct frontiers.  On the H100 it loses to the
    gather route at every frontier up to n: k rounds over all 2·E edges
    and a host edge lookup per pick, against one gather per pick
    (chip_smoke.py's ``bulk crossover`` line)."""
    fr = torch.as_tensor(frontier, dtype=torch.int64, device=g.device)
    cols = [per_v_random_select(G, draws.generator)[fr]
            for _ in range(int(k))]
    dst = torch.stack(cols, dim=1).cpu().numpy()
    valid = dst >= 0
    srcs_rep = np.repeat(frontier, int(k)).reshape(len(frontier), int(k))
    eidx = np.zeros_like(dst, dtype=np.int64)
    if valid.any():
        eidx[valid] = _eidx_lookup(g, srcs_rep[valid], dst[valid],
                                   rng=np.random.default_rng(draws.seed()))
    return dst, eidx, valid


def _to_host(csr, dst, eidx, valid):
    """One hop's (dst, weight, valid) on the host by one copy: an int32
    [3, F·k] of the destination, the float32 weight's bits and the mask."""
    packed = torch.stack([
        torch.as_tensor(dst, device=csr.device).reshape(-1).to(torch.int32),
        _at(csr.weights, torch.as_tensor(eidx, device=csr.device)
            .reshape(-1)).view(torch.int32),
        torch.as_tensor(valid, device=csr.device).reshape(-1)
        .to(torch.int32)]).cpu().numpy()
    return packed[0], packed[1].view(np.float32), packed[2].astype(bool)


def _neighbor_sample(G, start_list, fanout_vals, with_replacement, biased,
                     random_state, with_edge_properties=False, *,
                     prior_sources_behavior="default",
                     dedupe_sources=False, return_hops=True,
                     batch_id_list=None, draws=None):
    """Multi-hop sampling core with the reference's ``sampling_flags_t``
    semantics (sampling_functions.hpp:36-76), as the JAX package's:

    * frontiers are PER BATCH (label) and carry multiplicity — a vertex
      reached twice in one batch is passed twice to the next hop unless
      ``dedupe_sources``; two batches reaching the same vertex each sample
      independently;
    * ``prior_sources_behavior``: "default" (next frontier = sampled
      destinations), "carry_over" (+ all prior sources of the batch),
      "exclude" (drop destinations already used as a source in the batch);
    * ``return_hops`` controls the hop_id column;
    * ``batch_id_list`` labels each seed (defaults to one batch per seed).

    ``draws`` (default ``Draws(random_state, device)``) gives each hop's
    random numbers.  ``with_edge_properties`` adds the graph's edge_id,
    edge_type and edge_time columns of each sampled edge (none on a graph
    without them)."""
    g = G.structure
    csr = g.csr
    seeds = normalize_start(G, start_list).astype(np.int32)
    if draws is None:
        draws = Draws(random_state, g.device)
    max_deg = _max_out_degree(g)
    cumw = _cached_cumweights(G) if biased else None
    state = FrontierState(seeds, np.arange(len(seeds), dtype=np.int32),
                          G.number_of_vertices(),
                          prior_sources_behavior=prior_sources_behavior,
                          dedupe_sources=dedupe_sources,
                          batch_id_list=batch_id_list)
    frames = []
    for hop, k in enumerate(fanout_vals):
        if len(state) == 0:
            break
        frontier, batch_ids, _ = state.begin_hop()
        sub = draws.split()
        F = len(frontier)
        fr = torch.as_tensor(frontier.astype(np.int64), device=g.device)
        if int(k) < 0:
            # k == -1 means "all neighbours" in the reference API
            dst, valid, eidx = enumerate_neighbors(csr, fr, max_deg)
        elif not with_replacement and F * max_deg > _TILE_FALLBACK_ENTRIES:
            _, deg = _row_bounds(csr, fr)
            dst, eidx, valid = _sample_without_replacement_sorted(
                csr, fr, sub.edge_gumbel(int(deg.sum())), int(k),
                bool(biased))
        else:
            dst, eidx, valid = _sample_neighbors(
                g, fr, sub, int(k), bool(with_replacement), bool(biased),
                max_deg, cumw)
        kk = dst.shape[1]
        flat_dst, w, flat_val = _to_host(csr, dst, eidx, valid)
        bats = np.repeat(batch_ids, kk)
        fr_df = pd.DataFrame({
            "sources": np.repeat(frontier, kk)[flat_val],
            "destinations": flat_dst[flat_val],
            "weight": w[flat_val],
            "hop_id": np.int32(hop),
            "batch_id": bats[flat_val],
        })
        if with_edge_properties:
            _attach_edge_props(G, fr_df, eidx.reshape(-1)[valid.reshape(-1)])
        frames.append(fr_df)
        # next frontier (prepare_next_frontier_impl.cuh): per-batch sampled
        # destinations WITH multiplicity; prior-source handling per flag
        state.advance(fr_df["destinations"].to_numpy().astype(np.int32),
                      fr_df["batch_id"].to_numpy())

    cols = ["sources", "destinations", "weight", "hop_id", "batch_id"]
    if not frames:
        return pd.DataFrame(columns=[c for c in cols
                                     if return_hops or c != "hop_id"])
    out = pd.concat(frames, ignore_index=True)
    out["sources"] = unrenumber_column(G, out["sources"].to_numpy())
    out["destinations"] = unrenumber_column(G, out["destinations"].to_numpy())
    if not return_hops:
        out = out.drop(columns=["hop_id"])
    return out


def _sampling_flags(kwargs: dict) -> dict:
    """Extract the reference sampling_flags_t knobs from a kwargs dict
    (sampling_functions.hpp:36-76); other reference-parity kwargs are
    accepted and ignored.  ``deduplicate_sources`` is the pyx spelling of
    dedupe_sources."""
    out = {}
    kw2 = dict(kwargs)
    dedupe = pop_dedupe_sources(kw2)
    if dedupe or "dedupe_sources" in kwargs or \
            "deduplicate_sources" in kwargs:
        out["dedupe_sources"] = dedupe
    for name in ("prior_sources_behavior", "return_hops", "batch_id_list"):
        if name in kwargs and kwargs[name] is not None:
            out[name] = kwargs[name]
    return out


def _check_disjoint(kw, temporal: bool):
    """disjoint_sampling acceptance: per-batch frontiers are disjoint by
    construction; temporal sampling REQUIRES it (the reference raises on
    False — heterogeneous_*_temporal pyx:214-217)."""
    v = kw.get("disjoint_sampling")
    if temporal and v is False:
        raise ValueError("temporal sampling requires disjoint sampling")


def uniform_neighbor_sample(G, start_list, fanout_vals,
                            with_replacement: bool = True,
                            with_edge_properties: bool = False,
                            random_state=None, **kwargs):
    """Multi-hop uniform neighbour sampling (reference
    homogeneous_uniform_neighbor_sample, sampling_functions.hpp:505).
    Returns ['sources','destinations','weight','hop_id','batch_id']."""
    return _neighbor_sample(G, start_list, fanout_vals, with_replacement,
                            biased=False, random_state=random_state,
                            with_edge_properties=with_edge_properties,
                            **_sampling_flags(kwargs))


def homogeneous_uniform_neighbor_sample(G, start_list, fanout_vals, **kw):
    return uniform_neighbor_sample(G, start_list, fanout_vals, **kw)


def homogeneous_biased_neighbor_sample(G, start_list, fanout_vals,
                                       with_replacement: bool = True,
                                       random_state=None, **kw):
    """Edge-weight-biased sampling (reference
    homogeneous_biased_neighbor_sample)."""
    if not G.is_weighted():
        raise ValueError("biased sampling requires edge weights")
    return _neighbor_sample(
        G, start_list, fanout_vals, with_replacement, biased=True,
        random_state=random_state,
        with_edge_properties=bool(kw.get("with_edge_properties", False)),
        **_sampling_flags(kw))


# --------------------------------------------------------------------------
# Edge properties, heterogeneous and temporal sampling (reference: the 8
# neighbour-sample variants, sampling_functions.hpp:505+,
# temporal_sampling_impl.cuh; one fanout per edge type when heterogeneous)
# --------------------------------------------------------------------------

_EDGE_PROPS = ("edge_id", "edge_type", "edge_time")


def _csr_prop(G, name: str) -> torch.Tensor:
    """G's edge property ``name`` (one of ``_EDGE_PROPS``) in CSR order on
    the graph's device: a gather by the CSR's ``perm`` (the JAX package's
    ``_csr_prop``, with no padding), made at the first call and kept."""
    prop = G._csr_props.get(name)
    if prop is None:
        csr = G.structure.csr
        host = getattr(G, name + "s")
        prop = torch.as_tensor(host, device=csr.device)[csr.perm.to(
            torch.int64)]
        G._csr_props[name] = prop
    return prop


def _attach_edge_props(G, frame: pd.DataFrame, eidx: torch.Tensor):
    """Add the edge_id, edge_type and edge_time columns the graph has, at
    the CSR positions ``eidx`` (one per row of ``frame``)."""
    for name in _EDGE_PROPS:
        if getattr(G, name + "s") is not None:
            frame[name] = _csr_prop(G, name)[eidx].cpu().numpy()
    return frame


def _sample_neighbors_masked(g, frontier: torch.Tensor, draws, k: int,
                             max_deg: int, type_key=None, types=None,
                             seed_times=None, edge_times=None,
                             comparison: str = "strictly_increasing",
                             biased: bool = False):
    """Gumbel top-k over the [F, max_deg] neighbour tile, restricted to the
    eligible edges: of type ``type_key`` when ``types`` (the CSR-order
    types) is given, and passing the temporal test against ``seed_times``
    [F] when ``edge_times`` (CSR order, float32) is; ``biased`` adds
    log(weight) to the scores and makes w <= 0 ineligible.  Under
    ``comparison="last"`` with times the score is the edge time: the k most
    recent eligible edges, no draw.  The JAX package's tile
    (sampling.py:903-965), on ``draws.gumbel``; returns (dst, eidx,
    picked) [F, min(k, max_deg)] in descending score order, the lower
    tile index first among equals."""
    adj = g.csr
    _, ok, eidx_tile = enumerate_neighbors(adj, frontier, max_deg)
    if types is not None:
        ok = ok & (_at(types, eidx_tile) == type_key)
    t = None
    if edge_times is not None:
        t = _at(edge_times, eidx_tile)
        ok = ok & temporal_eligible(t, seed_times[:, None], comparison)
    if comparison == "last" and t is not None:
        score = torch.where(ok, t, -torch.inf)
    else:
        gumbel = draws.gumbel((frontier.shape[0], max_deg))
        if biased:
            wts = _at(adj.weights, eidx_tile)
            ok = ok & (wts > 0)
            gumbel = torch.log(torch.clamp(wts, min=1e-30)) + gumbel
        score = torch.where(ok, gumbel, -torch.inf)
    # lax.top_k's order: descending, the lower index first among equals
    top = torch.sort(score, dim=1, descending=True,
                     stable=True).indices[:, :min(k, max_deg)]
    picked = score.gather(1, top) > -torch.inf
    eidx = eidx_tile.gather(1, top)
    return _at(adj.indices, eidx), eidx, picked


def _sample_masked_sorted(adj, frontier: torch.Tensor, fanouts, draws,
                          types=None, seed_times=None, edge_times=None,
                          comparison: str = "strictly_increasing",
                          biased: bool = False):
    """One hop of masked sampling over the frontier's edges alone, every
    (type, fanout) of ``fanouts`` in one pass: each eligible edge gets a
    key (a Gumbel draw, log-weight shifted when ``biased``; its time under
    "last"), the edges sort by (type slot, row, -key) with ties to the
    lower CSR position, and each (slot, row) keeps its first min(k,
    eligible), all of them for k < 0.  The law of the tile route
    (``_sample_neighbors_masked``, bit for bit under "last"), without its
    [F, max_deg] tile.  Returns (row in ``frontier``, CSR position) of the
    picks in the frame's order: type-major, then frontier position, then
    descending key."""
    F = frontier.shape[0]
    dev = adj.device
    rows, _, e = _frontier_edges(adj, frontier)
    ok = torch.ones(e.shape, dtype=torch.bool, device=dev)
    slot = torch.zeros(e.shape, dtype=torch.int64, device=dev)
    if types is not None:
        keys_t = torch.tensor([t for t, _ in fanouts], dtype=types.dtype,
                              device=dev)
        te = types[e]
        slot = torch.searchsorted(keys_t, te).clamp(max=len(fanouts) - 1)
        ok = keys_t[slot] == te
    t = None
    if edge_times is not None:
        t = edge_times[e]
        ok = ok & temporal_eligible(t, seed_times[rows], comparison)
    if comparison == "last" and t is not None:
        keys = t.to(torch.float64)
    else:
        keys = draws.edge_gumbel(e.shape[0])
        if biased:
            keys = _log_weight_keys(keys, adj.weights[e])
    sel = torch.nonzero(ok & (keys > -torch.inf)).flatten()
    rows, e, slot, keys = rows[sel], e[sel], slot[sel], keys[sel]
    group = slot * F + rows
    order = _order_by_group_then_key(group, keys)
    gs = group[order]
    rank = torch.arange(gs.shape[0], device=dev) - torch.searchsorted(gs, gs)
    cap = torch.tensor([k if k >= 0 else 1 << 62 for _, k in fanouts],
                       device=dev)
    take = order[rank < cap[slot[order]]]
    return rows[take], e[take]


def _masked_hop(g, frontier: torch.Tensor, fanouts, draws, max_deg: int,
                types, seed_times, edge_times, comparison: str,
                biased: bool):
    """(row in ``frontier``, CSR position) of one hop's picks in frame
    order.  The tile route while F x max_deg <= _TILE_FALLBACK_ENTRIES,
    one ``draws.split()`` per (type, fanout) as the JAX package splits its
    key (sampling.py:1043); beyond it, the per-edge route, one split per
    hop."""
    F = frontier.shape[0]
    if F * max_deg > _TILE_FALLBACK_ENTRIES:
        return _sample_masked_sorted(g.csr, frontier, fanouts, draws.split(),
                                     types, seed_times, edge_times,
                                     comparison, biased)
    rows, eidx = [], []
    for type_key, k in fanouts:
        kk = max_deg if k < 0 else k
        _, e, picked = _sample_neighbors_masked(
            g, frontier, draws.split(), kk, max_deg, type_key, types,
            seed_times, edge_times, comparison, biased)
        nz = torch.nonzero(picked)
        rows.append(nz[:, 0])
        eidx.append(e[picked])
    return torch.cat(rows), torch.cat(eidx)


def _masked_neighbor_sample(G, start_list, fanouts_per_hop, *, types=None,
                            random_state=None, seed_time=None, strict=True,
                            biased=False, prior_sources_behavior="default",
                            dedupe_sources=False, return_hops=True,
                            batch_id_list=None,
                            temporal_sampling_comparison=None, draws=None):
    """The heterogeneous and temporal samplers' multi-hop loop (the JAX
    package's, sampling.py:977-1085): per hop, per (type, fanout) of
    ``fanouts_per_hop`` (a list per hop of (type, k)), masked sampling of
    the edges of that type (``types``: the CSR-order edge types; None
    makes every edge type 0).  With ``seed_time`` and edge times, an edge
    is eligible by the temporal comparison against its source's time, and
    each sampled vertex carries the traversed edge's float32 time into the
    next hop.  The flags are ``_neighbor_sample``'s.  The frame has the
    graph's edge_id, edge_type and edge_time columns."""
    g = G.structure
    csr = g.csr
    seeds = normalize_start(G, start_list).astype(np.int32)
    if draws is None:
        draws = Draws(random_state, g.device)
    max_deg = _max_out_degree(g)
    comparison = resolve_temporal_comparison(temporal_sampling_comparison,
                                             strict)
    edge_times = times = None
    if G.edge_times is not None and seed_time is not None:
        edge_times = _csr_prop(G, "edge_time").to(torch.float32)
        times = np.broadcast_to(np.asarray(seed_time, np.float32),
                                (len(seeds),)).astype(np.float32)
    state = FrontierState(seeds, np.arange(len(seeds), dtype=np.int32),
                          G.number_of_vertices(),
                          prior_sources_behavior=prior_sources_behavior,
                          dedupe_sources=dedupe_sources, times=times,
                          batch_id_list=batch_id_list)
    frames = []
    for hop, fanouts in enumerate(fanouts_per_hop):
        if len(state) == 0:
            break
        frontier, batch_ids, times = state.begin_hop()
        fanouts = [(t, int(k)) for t, k in fanouts if int(k) != 0]
        if not fanouts:
            break
        fr = torch.as_tensor(frontier.astype(np.int64), device=g.device)
        lim = (None if times is None else
               torch.as_tensor(times, device=g.device))
        rows, eidx = _masked_hop(g, fr, fanouts, draws, max_deg, types, lim,
                                 edge_times, comparison, biased)
        packed = torch.stack([rows.to(torch.int32),
                              csr.indices[eidx],
                              csr.weights[eidx].view(torch.int32)])
        r, d, w = packed.cpu().numpy()
        fr_df = pd.DataFrame({
            "sources": frontier[r],
            "destinations": d,
            "weight": w.view(np.float32),
            "hop_id": np.int32(hop),
            "batch_id": batch_ids[r],
        })
        frames.append(_attach_edge_props(G, fr_df, eidx))
        # next frontier: per-batch destinations with multiplicity, each
        # carrying its traversed edge's time on the temporal path
        state.advance(d, batch_ids[r],
                      None if times is None else
                      fr_df["edge_time"].to_numpy().astype(np.float32))
    cols = ["sources", "destinations", "weight", "hop_id", "batch_id"]
    if not frames:
        return pd.DataFrame(columns=[c for c in cols
                                     if return_hops or c != "hop_id"])
    out = pd.concat(frames, ignore_index=True)
    out["sources"] = unrenumber_column(G, out["sources"].to_numpy())
    out["destinations"] = unrenumber_column(G, out["destinations"].to_numpy())
    if not return_hops:
        out = out.drop(columns=["hop_id"])
    return out


def _type_masks(G):
    """(the CSR-order edge types on the graph's device, the distinct types
    as a sorted host array): the JAX package's per-type masks
    (sampling.py:1088-1099) as one array of types."""
    if G.edge_types is None:
        raise ValueError(
            "heterogeneous sampling requires edge_type on the graph")
    types = _csr_prop(G, "edge_type")
    return types, torch.unique(types).cpu().numpy()


def _het_fanouts(G, fanout_vals, num_edge_types):
    """(CSR-order types, fanouts per hop): ``fanout_vals`` is flattened
    [hop0_type0, hop0_type1, ..., hop1_type0, ...], and slot t applies to
    edge type t (reference h_fanout[hop * num_edge_types + edge_type]);
    types absent from the graph are skipped."""
    types, present = _type_masks(G)
    ntypes = num_edge_types or int(present.max()) + 1
    fv = list(fanout_vals)
    if len(fv) % ntypes != 0:
        raise ValueError("fanout_vals must be hops × num_edge_types "
                         f"(got {len(fv)} for {ntypes} edge types)")
    present = set(present.tolist())
    return types, [[(t, k) for t, k in enumerate(fv[i:i + ntypes])
                    if t in present] for i in range(0, len(fv), ntypes)]


def _check_weighted(G):
    if not G.is_weighted():
        raise ValueError("biased sampling requires edge weights")


def _check_times(G, kw):
    if G.edge_times is None:
        raise ValueError("temporal sampling requires edge_time on the graph")
    _check_disjoint(kw, temporal=True)


def heterogeneous_uniform_neighbor_sample(G, start_list, fanout_vals,
                                          num_edge_types: int | None = None,
                                          random_state=None, **kw):
    """One fanout per edge type (reference
    heterogeneous_uniform_neighbor_sample.pyx): ``fanout_vals`` is
    flattened [hop0_type0, hop0_type1, ..., hop1_type0, ...].  Sampling is
    without replacement, whatever ``with_replacement`` says (the JAX
    package ignores it)."""
    types, fanouts = _het_fanouts(G, fanout_vals, num_edge_types)
    return _masked_neighbor_sample(G, start_list, fanouts, types=types,
                                   random_state=random_state,
                                   **_sampling_flags(kw))


def heterogeneous_biased_neighbor_sample(G, start_list, fanout_vals,
                                         num_edge_types: int | None = None,
                                         random_state=None, **kw):
    """One fanout per edge type, picks within each type in proportion to
    the edge weight (reference heterogeneous_biased_neighbor_sample.pyx)."""
    _check_weighted(G)
    types, fanouts = _het_fanouts(G, fanout_vals, num_edge_types)
    return _masked_neighbor_sample(G, start_list, fanouts, types=types,
                                   random_state=random_state, biased=True,
                                   **_sampling_flags(kw))


def homogeneous_uniform_temporal_neighbor_sample(
        G, start_list, fanout_vals, seed_time=0.0, strict: bool = True,
        random_state=None, **kw):
    """Temporal sampling: an edge is eligible when its time passes the
    comparison against its source's time (> when ``strict``, >= otherwise,
    unless ``temporal_sampling_comparison`` names one), and a sampled
    vertex takes the traversed edge's time (reference
    temporal_sampling_impl.cuh, sampling_functions.hpp:75)."""
    _check_times(G, kw)
    return _masked_neighbor_sample(
        G, start_list, [[(0, k)] for k in fanout_vals],
        random_state=random_state, seed_time=seed_time, strict=strict,
        temporal_sampling_comparison=kw.get("temporal_sampling_comparison"),
        **_sampling_flags(kw))


def homogeneous_biased_temporal_neighbor_sample(
        G, start_list, fanout_vals, seed_time=0.0, strict: bool = True,
        random_state=None, **kw):
    """Temporal eligibility, picks in proportion to the edge weight
    (reference temporal_sampling_impl.cuh, biased)."""
    _check_weighted(G)
    _check_times(G, kw)
    return _masked_neighbor_sample(
        G, start_list, [[(0, k)] for k in fanout_vals],
        random_state=random_state, seed_time=seed_time, strict=strict,
        biased=True,
        temporal_sampling_comparison=kw.get("temporal_sampling_comparison"),
        **_sampling_flags(kw))


def heterogeneous_uniform_temporal_neighbor_sample(
        G, start_list, fanout_vals, num_edge_types: int | None = None,
        seed_time=0.0, strict: bool = True, random_state=None, **kw):
    """One fanout per edge type and temporal eligibility."""
    _check_times(G, kw)
    types, fanouts = _het_fanouts(G, fanout_vals, num_edge_types)
    return _masked_neighbor_sample(
        G, start_list, fanouts, types=types, random_state=random_state,
        seed_time=seed_time, strict=strict,
        temporal_sampling_comparison=kw.get("temporal_sampling_comparison"),
        **_sampling_flags(kw))


def heterogeneous_biased_temporal_neighbor_sample(
        G, start_list, fanout_vals, num_edge_types: int | None = None,
        seed_time=0.0, strict: bool = True, random_state=None, **kw):
    """One fanout per edge type, weight-biased picks and temporal
    eligibility: the reference's eighth variant."""
    _check_weighted(G)
    _check_times(G, kw)
    types, fanouts = _het_fanouts(G, fanout_vals, num_edge_types)
    return _masked_neighbor_sample(
        G, start_list, fanouts, types=types, random_state=random_state,
        seed_time=seed_time, strict=strict, biased=True,
        temporal_sampling_comparison=kw.get("temporal_sampling_comparison"),
        **_sampling_flags(kw))


# --------------------------------------------------------------------------
# Random walks
# --------------------------------------------------------------------------

def _walk_kernel(g, starts: torch.Tensor, u: torch.Tensor, depth: int,
                 biased: bool, cumw: torch.Tensor | None):
    """Uniform or weight-biased first-order walks from ``starts`` (int64
    [W]), step i drawing with ``u[i]`` (float32 [depth, W]).  Returns
    (paths [W, depth+1] int64, edge weights [W, depth] float32); -1 after
    a sink, weight 0 there."""
    adj = g.csr
    n = g.num_vertices
    last = max(adj.num_edges - 1, 0)
    cur, tail, wsteps = starts, [], []
    for i in range(depth):
        safe = cur.clamp(0, max(n - 1, 0))
        base, deg = _row_bounds(adj, safe)
        if biased:
            wtot = _at(cumw, (base + deg.clamp(min=1) - 1).clamp(0, last))
            off = _search_cumweights(cumw, base, base + deg, u[i] * wtot,
                                     last) - base
        else:
            off = torch.minimum(torch.floor(u[i] * deg).to(torch.int64),
                                (deg - 1).clamp(min=0))
        eidx = (base + off).clamp(0, last)
        dead = (deg <= 0) | (cur == _SENTINEL)
        nxt = torch.where(dead, _SENTINEL, _at(adj.indices, eidx).to(
            torch.int64))
        tail.append(nxt)
        wsteps.append(torch.where(dead, 0.0, _at(adj.weights, eidx)))
        cur = nxt
    paths = torch.stack([starts] + tail, dim=1)
    w = (torch.stack(wsteps, dim=1) if wsteps else
         torch.zeros((starts.shape[0], 0), device=starts.device))
    return paths, w


def _walk_frames(G, paths, wsteps, max_depth):
    vp = unrenumber_column(G, paths.cpu().numpy().reshape(-1),
                           sentinel=_SENTINEL)
    return (pd.Series(vp), pd.Series(wsteps.cpu().numpy().reshape(-1)),
            int(max_depth))


def _walk_starts(G, start_vertices) -> torch.Tensor:
    starts = normalize_start(G, start_vertices).astype(np.int64)
    return torch.as_tensor(starts, device=G.structure.device)


def random_walks(G, start_vertices, max_depth: int, use_padding: bool = True,
                 legacy_result_type=None, random_state=None):
    """Uniform random walks (reference uniform_random_walks,
    random_walks_impl.cuh:894).  Returns (vertex_paths, edge_weight_paths,
    max_path_length) in the reference's padded layout: -1 marks early
    termination at a sink vertex."""
    g = G.structure
    starts = _walk_starts(G, start_vertices)
    u = Draws(random_state, g.device).uniform((int(max_depth),
                                               starts.shape[0]))
    paths, wsteps = _walk_kernel(g, starts, u, int(max_depth), False, None)
    return _walk_frames(G, paths, wsteps, max_depth)


def uniform_random_walks(G, start_vertices, max_depth: int, random_state=None):
    return random_walks(G, start_vertices, max_depth,
                        random_state=random_state)


def biased_random_walks(G, start_vertices, max_depth: int, random_state=None):
    """Edge-weight-biased walks (reference biased_random_walks)."""
    if not G.is_weighted():
        raise ValueError("biased walks require edge weights")
    g = G.structure
    starts = _walk_starts(G, start_vertices)
    u = Draws(random_state, g.device).uniform((int(max_depth),
                                               starts.shape[0]))
    paths, wsteps = _walk_kernel(g, starts, u, int(max_depth), True,
                                 _cached_cumweights(G))
    return _walk_frames(G, paths, wsteps, max_depth)


def _node2vec_scores(adj, cur, prev, p: float, q: float, max_deg: int):
    """One node2vec step's tile (JAX sampling.py:711-734): the candidates of
    ``cur`` re-weighted 1/p (back to prev), 1 (a neighbour of prev) or 1/q
    (distance 2); 1 everywhere for a walk with no prev.  Returns (eidx
    [W, max_deg], factor [W, max_deg], score [W, max_deg], the float32
    cumsum of score along the row [W, max_deg])."""
    n = adj.num_vertices
    nbr, valid, eidx = enumerate_neighbors(adj, cur.clamp(0, n - 1), max_deg)
    w = _at(adj.weights, eidx)
    is_back = nbr.to(torch.int64) == prev[:, None]
    near, _ = lower_bound_rows(adj, prev.clamp(0, n - 1)[:, None], nbr)
    factor = torch.where(is_back, 1.0 / p,
                         torch.where(near, 1.0, 1.0 / q)).to(torch.float32)
    factor = torch.where((prev >= 0)[:, None], factor, 1.0)
    score = torch.where(valid, w * factor, 0.0)
    return eidx, factor, score, torch.cumsum(score, dim=1)


def _node2vec_step(adj, cur, prev, u, p: float, q: float, max_deg: int):
    """One step of every walk: (next vertex, the edge's weight), -1 and 0
    for a walk that is dead or has no candidate."""
    eidx, _, score, cdf = _node2vec_scores(adj, cur, prev, p, q, max_deg)
    tot = score.sum(dim=1)
    pick = (cdf < (u * tot)[:, None]).sum(dim=1).clamp(max=max_deg - 1)
    e_pick = eidx.gather(1, pick[:, None])[:, 0]
    dead = (tot <= 0) | (cur == _SENTINEL)
    nxt = torch.where(dead, _SENTINEL, _at(adj.indices, e_pick).to(
        torch.int64))
    return nxt, torch.where(dead, 0.0, _at(adj.weights, e_pick))


def _node2vec_kernel(g, starts: torch.Tensor, u: torch.Tensor, depth: int,
                     p: float, q: float, max_deg: int):
    """Second-order biased walks (Grover & Leskovec), step i drawing with
    ``u[i]`` (float32 [depth, W]) over the candidates' CDF."""
    cur = starts
    prev = torch.full_like(starts, _SENTINEL)
    tail, wsteps = [], []
    for i in range(depth):
        nxt, wstep = _node2vec_step(g.csr, cur, prev, u[i], p, q, max_deg)
        tail.append(nxt)
        wsteps.append(wstep)
        cur, prev = nxt, cur   # prev <- cur after the move
    paths = torch.stack([starts] + tail, dim=1)
    w = (torch.stack(wsteps, dim=1) if wsteps else
         torch.zeros((starts.shape[0], 0), device=starts.device))
    return paths, w


def node2vec_random_walks(G, start_vertices, max_depth: int, p: float = 1.0,
                          q: float = 1.0, random_state=None):
    """node2vec walks (reference node2vec_random_walks,
    random_walks_impl.cuh:933)."""
    g = G.structure
    starts = _walk_starts(G, start_vertices)
    u = Draws(random_state, g.device).uniform((int(max_depth),
                                               starts.shape[0]))
    paths, wsteps = _node2vec_kernel(g, starts, u, int(max_depth), float(p),
                                     float(q), _max_out_degree(g))
    return _walk_frames(G, paths, wsteps, max_depth)


def node2vec(G, start_vertices, max_depth: int, compress_result=False,
             p: float = 1.0, q: float = 1.0):
    return node2vec_random_walks(G, start_vertices, max_depth, p=p, q=q)


# --------------------------------------------------------------------------
# Negative sampling
# --------------------------------------------------------------------------

def negative_sampling(G, num_samples: int, vertices=None, src_bias=None,
                      dst_bias=None, remove_duplicates: bool = True,
                      remove_existing_edges: bool = True,
                      exact_number_of_samples: bool = False,
                      random_state=None):
    """Sample (src, dst) pairs that are NOT edges (reference
    negative_sampling_impl.cuh:270: biased draws + dedup + edge exclusion).
    Uniform endpoint draws when src_bias/dst_bias are None; biases pair
    with ``vertices`` when given, else with G.nodes() external order, and
    draw with NumPy as the JAX package does.  Edges are excluded by
    ``lower_bound_rows`` over the CSR on the graph's device.  Returns
    ['src', 'dst'] in external ids."""
    seed0 = int(random_state) if random_state is not None else 0
    return _negative_sampling(
        G, num_samples, vertices, src_bias, dst_bias, remove_duplicates,
        remove_existing_edges, exact_number_of_samples, seed0,
        Draws(seed0, G.structure.device))


def _negative_sampling(G, num_samples, vertices, src_bias, dst_bias,
                       remove_duplicates, remove_existing_edges,
                       exact_number_of_samples, seed0, draws):
    """``negative_sampling``'s core: each attempt takes its uniform draws
    from ``draws.randint_pair`` and its biased ones from NumPy generators
    seeded with (seed0, attempt[, 99])."""
    g = G.structure
    n = G.number_of_vertices()
    want = int(num_samples)
    out_s, out_d = [], []
    have = 0
    attempt = 0
    sb = None if src_bias is None else np.asarray(src_bias, np.float64)
    db = None if dst_bias is None else np.asarray(dst_bias, np.float64)
    cand = None if vertices is None else np.asarray(
        G.lookup_internal_vertex_id(np.asarray(vertices)), np.int32)
    # bias arrays pair with the CANDIDATE list when given (reference
    # negative_sampling contract), else with G.nodes() external order —
    # never raw internal ids (renumbering would scramble the pairing)
    for name, b in (("src_bias", sb), ("dst_bias", db)):
        if b is not None:
            expect = len(cand) if cand is not None else n
            if len(b) != expect:
                raise ValueError(
                    f"{name} must have length {expect} (one entry per "
                    f"{'candidate vertex' if cand is not None else 'vertex'})")
    if cand is None and (sb is not None or db is not None):
        # align external-node-order biases with internal ids
        order = np.asarray(G.lookup_internal_vertex_id(G.nodes()))
        if sb is not None:
            t = np.zeros(n); t[order] = sb; sb = t
        if db is not None:
            t = np.zeros(n); t[order] = db; db = t
    while have < want and attempt < 16:
        m = max(2 * (want - have), 1024)
        us, ud = draws.randint_pair(m, n if cand is None else len(cand))
        if sb is None:
            s = us.astype(np.int32) if cand is None else cand[us]
        elif cand is None:
            s = np.random.default_rng((seed0, attempt)).choice(
                n, m, p=sb / sb.sum()).astype(np.int32)
        else:
            pick = np.random.default_rng((seed0, attempt)).choice(
                len(cand), m, p=sb / sb.sum())
            s = cand[pick]
        if db is None:
            d = ud.astype(np.int32) if cand is None else cand[ud]
        elif cand is None:
            d = np.random.default_rng((seed0, attempt, 99)).choice(
                n, m, p=db / db.sum()).astype(np.int32)
        else:
            pick = np.random.default_rng((seed0, attempt, 99)).choice(
                len(cand), m, p=db / db.sum())
            d = cand[pick]
        if remove_existing_edges:
            found, _ = lower_bound_rows(
                g.csr, torch.as_tensor(s, device=g.device),
                torch.as_tensor(d, device=g.device))
            mask = ~found.cpu().numpy()
        else:
            mask = np.ones(m, bool)
        mask &= s != d
        out_s.append(s[mask]); out_d.append(d[mask])
        have = sum(len(x) for x in out_s)
        attempt += 1
        if remove_duplicates:
            ss = np.concatenate(out_s); dd = np.concatenate(out_d)
            key64 = ss.astype(np.int64) * n + dd
            _, idx = np.unique(key64, return_index=True)
            out_s = [ss[np.sort(idx)]]; out_d = [dd[np.sort(idx)]]
            have = len(out_s[0])
    ss = np.concatenate(out_s)[:want]
    dd = np.concatenate(out_d)[:want]
    if exact_number_of_samples and len(ss) < want:
        raise RuntimeError(
            f"could not draw {want} negative samples (got {len(ss)}) — "
            "candidate space too small after dedup/exclusion")
    return pd.DataFrame({
        "src": G.number_map.to_external(ss),
        "dst": G.number_map.to_external(dd),
    })
