"""Distributed multi-hop neighbour sampling: the MG GNN feed path.

Counterpart of ``cugraph_tpu/parallel/sampling_mg.py`` (reference
sampling/neighbor_sampling_impl.cuh:166's per-hop loop,
prepare_next_frontier_impl.cuh and sampling_functions.hpp:36-76's
``sampling_flags_t``).  The one-hop engine (``algos.mg_sample_one_hop``)
draws k out-neighbours per graph VERTEX into owned [Vc, k] panels; the
reference samples per (vertex, label) key, which occurrence layering
recovers: the frontier's (vertex, batch) pairs are ranked per vertex, and
layer r (every vertex's r-th occurrence) runs one hop with its own seed.
With ``dedupe_sources`` and a frontier that fits ``_plan_fused``'s gate
the whole walk runs instead in the fused sampler
(``algos.mg_sample_multihop_batched_device``), on batch mask planes, with
the same seeds per row, so both routes give the same rows (in another
order).

Every rank runs the same host logic on replicated frontiers and returns
the same full frame, as the JAX package's replicated outputs; only the
sampled rows cross ranks (one all-reduce per hop and type, or one
all-gather per hop of the fused route).  Per-edge properties come from
owner-local tables (``partition.edge_table``, ``_host_eprop_by_eid``):
each rank answers the rows whose edge it holds and one all-reduce
combines them.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from cugraph_tpu_torch.parallel import prims
from cugraph_tpu_torch.parallel.partition import DistGraph, edge_table

# the fused route's gate, as the JAX package sizes it for a TPU
# (``sampling_mg.py:341-347``): kept, because the route decides the
# frames' row order
MAX_FUSED_BATCHES = 16          # static in-kernel layer unroll bound
MAX_FUSED_CAP = 1 << 22         # per-hop compacted-frontier capacity
MAX_FUSED_PANEL_BYTES = 256 << 20   # per-device [NB, pad_v/P, k] budget
MAX_FUSED_PANEL_TOTAL = 2 << 30


def _host_eprop_table(g: DistGraph) -> dict:
    """This rank's sorted (src·pad_v + dst) key table with weight, edge
    type and time (``partition.edge_table``), and the ambiguity mask of
    ``_attach_props``, cached with it."""
    tab = edge_table(g)
    if "ambiguous" not in tab:
        ks = tab["keys"]
        amb = torch.zeros(ks.shape, dtype=torch.bool, device=ks.device)
        if ks.numel():
            same = ks[1:] == ks[:-1]
            for name in ("weight", "etype", "etime"):
                col = tab[name]
                if col is not None:
                    d = same & (col[1:] != col[:-1])
                    amb[1:] |= d
                    amb[:-1] |= d
            # every slot of a run of equal keys flags when any adjacent
            # pair of it differs
            grp = torch.cumsum(torch.cat([same.new_ones(1), ~same]).to(
                torch.int64), 0) - 1
            hit = torch.zeros(int(grp[-1]) + 1, dtype=torch.int32,
                              device=ks.device).scatter_reduce_(
                0, grp, amb.to(torch.int32), "amax")
            amb = hit[grp] > 0
        tab["ambiguous"] = amb
    return tab


def _host_eprop_by_eid(g: DistGraph) -> dict:
    """This rank's push edges by sorted instance id (``eid``), with their
    weight, type and time, cached on the DistGraph: the owner-local
    counterpart of the JAX package's instance-indexed host arrays
    (``sampling_mg.py:75-100``).  An instance lies in one push block (two,
    with the same properties, on a symmetrized graph)."""
    cached = g.__dict__.get("_eid_table")
    if cached is not None:
        return cached
    b = g.push
    eid = b.eid.to(torch.int64)
    order = torch.sort(eid, stable=True).indices
    table = {"keys": eid[order], "weight": b.weights[order],
             "etype": None if b.etype is None else b.etype[order],
             "etime": None if b.etime is None else b.etime[order]}
    object.__setattr__(g, "_eid_table", table)
    return table


def _lookup(mesh, tab, query: np.ndarray, flags=()):
    """Each rank's answer for the queries it holds, combined by one
    all-reduce MAX of a float64 stack [Q, 1 + len(flags) + 3] (hit, the
    flag columns, weight, type, time; −inf where a rank has no match):
    returns the combined host stack."""
    dev = mesh.device
    ks = tab["keys"]
    q = torch.from_numpy(np.array(query, np.int64)).to(dev)
    cols = ["weight", "etype", "etime"]
    out = torch.full((q.shape[0], 1 + len(flags) + len(cols)),
                     float("-inf"), dtype=torch.float64, device=dev)
    if ks.numel() and q.numel():
        pos = torch.searchsorted(ks, q).clamp(max=ks.numel() - 1)
        hit = ks[pos] == q
        vals = [torch.ones_like(q, dtype=torch.float64)]
        vals += [tab[f][pos].to(torch.float64) for f in flags]
        vals += [(tab[c][pos].to(torch.float64) if tab[c] is not None
                  else torch.zeros_like(q, dtype=torch.float64))
                 for c in cols]
        out[hit] = torch.stack(vals, 1)[hit]
    return prims.all_reduce(out, mesh.world, "max").cpu().numpy()


def _attach_props(g: DistGraph, mesh, frame: pd.DataFrame) -> pd.DataFrame:
    """Sampled rows' weight (and edge type and time, where the graph has
    them and the frame does not): by the traversed instance when the
    sampler returned ``_eid``, else by the (src, dst) key's first match,
    refusing a pair whose instances carry distinct properties (the
    reference gathers per instance, gather_one_hop_impl.cuh)."""
    if "_eid" in frame and g.push is not None and g.push.eid is not None:
        e = frame["_eid"].to_numpy()
        if (e < 0).any():
            raise RuntimeError("sampled row without an edge instance id")
        tab = _host_eprop_by_eid(g)
        got = _lookup(mesh, tab, e)
    else:
        tab = _host_eprop_table(g)
        key = frame["sources"].to_numpy().astype(np.int64) * g.pad_v \
            + frame["destinations"].to_numpy().astype(np.int64)
        got = _lookup(mesh, tab, key, flags=("ambiguous",))
        if not bool((got[:, 0] > 0).all()):
            raise RuntimeError("sampled edge missing from property table")
        if bool((got[:, 1] > 0).any()):
            raise ValueError(
                "sampled a parallel edge whose instances carry distinct "
                "properties; rebuild with store_eid=True (build_dist_graph "
                "default when properties are given) for instance-exact "
                "sampled properties")
        got = np.concatenate([got[:, :1], got[:, 2:]], 1)
    frame["weight"] = got[:, 1].astype(np.float32)
    if tab["etype"] is not None and "edge_type" not in frame:
        frame["edge_type"] = got[:, 2].astype(np.int32)
    if tab["etime"] is not None and "edge_time" not in frame:
        frame["edge_time"] = got[:, 3].astype(np.float32)
    return frame


def _occurrence_rank(v: np.ndarray, tiebreak: np.ndarray | None = None
                     ) -> np.ndarray:
    """occ[i] = rank of row i among rows with the same vertex: in arrival
    order (a stable sort), or with ``tiebreak`` (the batch ids) in batch
    order, the canonical rank the fused route's planes reproduce."""
    order = (np.argsort(v, kind="stable") if tiebreak is None
             else np.lexsort((tiebreak, v)))
    vs = v[order]
    first = np.zeros(len(v), bool)
    if len(v):
        first[0] = True
        first[1:] = vs[1:] != vs[:-1]
    run_start = np.maximum.accumulate(np.where(first, np.arange(len(v)), 0))
    occ = np.empty(len(v), np.int64)
    occ[order] = np.arange(len(v)) - run_start
    return occ


def _mg_neighbor_sample_core(
    g: DistGraph, mesh, start_list, hop_plans, *, seed: int,
    with_replacement: bool, biased: bool, masks=None,
    temporal: bool = False, seed_time: float = 0.0, strict: bool = True,
    temporal_sampling_comparison=None,
    prior_sources_behavior: str = "default", dedupe_sources: bool = False,
    return_hops: bool = True, with_edge_properties: bool = False,
    batch_id_list=None,
):
    """The layered multi-hop loop.  ``hop_plans``: per hop, a list of
    (type or None, fanout) pairs; ``masks``: type → this rank's push-block
    eligibility [E]."""
    from cugraph_tpu_torch.algos._frontier import FrontierState
    from cugraph_tpu_torch.parallel.algos import (mg_sample_one_hop,
                                                  sample_panel_rows)

    fv0 = np.asarray(start_list, np.int64)
    pad = g.pad_v
    state = FrontierState(
        fv0, np.arange(len(fv0), dtype=np.int32), pad,
        prior_sources_behavior=prior_sources_behavior,
        dedupe_sources=dedupe_sources, batch_id_list=batch_id_list,
        times=(np.broadcast_to(
            np.asarray(seed_time, np.float32), (len(fv0),)).copy()
            if temporal else None))

    frames = []
    for hop, fanouts in enumerate(hop_plans):
        if len(state) == 0:
            break
        fv, fb, ft = state.begin_hop()
        occ = _occurrence_rank(fv, tiebreak=fb if dedupe_sources else None)
        hop_frames = []
        n_layers = int(occ.max()) + 1 if len(fv) else 0
        for r in range(n_layers):
            sel = occ == r
            verts = fv[sel]
            bats = fb[sel]
            vt = None
            if temporal:
                vt = np.zeros(pad, np.float32)
                vt[verts] = ft[sel]
            for tk, k in fanouts:
                if int(k) < 0:
                    raise ValueError(
                        "fanout -1 (all neighbors) is not supported on the "
                        "MG sampler — the one-hop engine needs a static k; "
                        "pass the max degree instead")
                if int(k) == 0 or (masks is not None and tk not in masks):
                    continue
                samp, st, sei = mg_sample_one_hop(
                    g, mesh, verts, int(k),
                    seed + hop * 1009 + r * 131 + (0 if tk is None else tk) * 7,
                    with_replacement, biased,
                    edge_ok=None if masks is None else masks[tk],
                    frontier_times=vt, strict=strict,
                    temporal_sampling_comparison=temporal_sampling_comparison)
                panels = [samp] + ([st] if temporal else []) \
                    + ([sei] if sei is not None else [])
                got = list(sample_panel_rows(mesh, tuple(panels), verts))
                sub = got.pop(0)                                 # [F, k]
                st_rows = got.pop(0) if temporal else None
                ei_rows = got.pop(0) if sei is not None else None
                flat = (sub >= 0).reshape(-1)
                kk = sub.shape[1]
                row = {
                    "sources": np.repeat(verts, kk)[flat],
                    "destinations": sub.reshape(-1)[flat],
                    "hop_id": np.int32(hop),
                    "batch_id": np.repeat(bats, kk)[flat],
                }
                if ei_rows is not None:
                    row["_eid"] = ei_rows.reshape(-1)[flat].astype(np.int64)
                if temporal:
                    row["edge_time"] = st_rows.reshape(-1)[flat]
                if tk is not None:
                    row["edge_type"] = np.int32(tk)
                hop_frames.append(pd.DataFrame(row))
        if not hop_frames:
            break
        hf = pd.concat(hop_frames, ignore_index=True)
        frames.append(hf)
        # next frontier: per-batch destinations WITH multiplicity
        # (prepare_next_frontier_impl.cuh)
        state.advance(hf["destinations"].to_numpy().astype(np.int64),
                      hf["batch_id"].to_numpy(),
                      hf["edge_time"].to_numpy().astype(np.float32)
                      if temporal else None)

    cols = ["sources", "destinations", "hop_id", "batch_id"]
    if temporal:
        cols.insert(2, "edge_time")
    if masks is not None:
        cols.insert(2, "edge_type")
    if not frames:
        return pd.DataFrame(columns=[c for c in cols
                                     if return_hops or c != "hop_id"])
    out = pd.concat(frames, ignore_index=True)
    if with_edge_properties:
        out = _attach_props(g, mesh, out)
    if "_eid" in out:
        out = out.drop(columns=["_eid"])
    if not return_hops:
        out = out.drop(columns=["hop_id"])
    return out


def _flag_kwargs(kw):
    from cugraph_tpu_torch.algos._frontier import pop_dedupe_sources

    dedupe = pop_dedupe_sources(kw)
    return dict(
        prior_sources_behavior=kw.pop("prior_sources_behavior", "default"),
        dedupe_sources=bool(dedupe),
        return_hops=bool(kw.pop("return_hops", True)),
        with_edge_properties=bool(kw.pop("with_edge_properties", False)),
        batch_id_list=kw.pop("batch_id_list", None),
    )


def mg_uniform_neighbor_sample(g: DistGraph, mesh, start_list, fanout_vals,
                               with_replacement: bool = False, seed: int = 0,
                               biased: bool = False, **kw):
    """Multi-hop distributed uniform neighbour sampling (reference MG
    homogeneous_uniform_neighbor_sample): ['sources', 'destinations',
    'hop_id', 'batch_id'] (+ 'weight'/'edge_type'/'edge_time' with
    ``with_edge_properties=True``), the same frame on every rank; batches
    keep independent frontiers with multiplicity per sampling_flags_t."""
    kw.pop("disjoint_sampling", None)  # per-batch frontiers are disjoint
    kw.pop("temporal_sampling_comparison", None)  # temporal-only knob
    flags = _flag_kwargs(kw)
    if kw:
        raise TypeError(f"unknown sampler kwargs: {sorted(kw)}")
    if g.push is None:
        raise ValueError("sampling needs push blocks (store_push=True)")
    bl = flags["batch_id_list"]
    if bl is not None and len(np.asarray(bl).reshape(-1)) != \
            len(np.asarray(start_list).reshape(-1)):
        raise ValueError("batch_id_list must align with start_list")
    plan = _plan_fused(g, mesh, start_list, fanout_vals, flags)
    if plan is not None:
        return _mg_sample_device_path(g, mesh, plan, seed=seed,
                                      biased=biased,
                                      with_replacement=with_replacement,
                                      **flags)
    plans = [[(None, int(k))] for k in fanout_vals]
    return _mg_neighbor_sample_core(
        g, mesh, start_list, plans, seed=seed,
        with_replacement=with_replacement, biased=biased, **flags)


def _plan_fused(g, mesh, start_list, fanout_vals, flags, temporal=False):
    """The fused route's gate and static plan (``sampling_mg.py:350-411``):
    dedupe_sources (mask planes carry no multiplicity), homogeneous, any
    prior_sources_behavior and batch count (groups of up to 16 planes),
    pad_v <= 2^27 and 32-divisible, the panels and capacities within the
    budgets above; temporal under pad_v <= 2^22 and edge times.  None
    routes the layered path."""
    ks = [int(k) for k in fanout_vals]
    if not (flags["dedupe_sources"] and ks and min(ks) > 0):
        return None
    if g.pad_v > (1 << 27) or g.pad_v % 32:
        return None
    if temporal and (g.pad_v > (1 << 22) or g.push is None
                     or g.push.etime is None):
        return None
    behavior = (flags["prior_sources_behavior"] or "default").lower()
    if behavior == "carryover":
        behavior = "carry_over"
    if behavior not in ("default", "carry_over", "exclude"):
        return None
    sv = np.asarray(start_list, np.int64).reshape(-1)
    bl = flags["batch_id_list"]
    # no batch ids: each seed is its own batch (FrontierState's default)
    b = (np.asarray(bl, np.int32).reshape(-1) if bl is not None
         else np.arange(len(sv), dtype=np.int32))
    labels = np.unique(b)
    NB = max(len(labels), 1)
    P_ = max(mesh.size, 1)
    gNB = min(NB, MAX_FUSED_BATCHES)
    panel_bytes = gNB * g.pad_v * max(ks) * 4
    if panel_bytes // P_ > MAX_FUSED_PANEL_BYTES \
            or panel_bytes > MAX_FUSED_PANEL_TOTAL:
        return None
    groups = []
    grow = 1 if behavior == "carry_over" else 0
    for lo in range(0, max(len(labels), 1), MAX_FUSED_BATCHES):
        labs = labels[lo:lo + MAX_FUSED_BATCHES]
        nbg = max(len(labs), 1)
        masks0 = np.zeros((nbg, g.pad_v), bool)
        fb = np.zeros(nbg, np.int64)
        for pi, lab in enumerate(labs):
            vs = np.unique(sv[b == lab])
            masks0[pi, vs] = True
            fb[pi] = len(vs)
        # static per-hop frontier capacity from the growth bound
        # (carry_over also keeps the current frontier)
        caps = []
        for k in ks:
            tot = int(min(fb.sum(), nbg * g.pad_v))
            caps.append(max(8, 1 << (max(tot, 1) - 1).bit_length()))
            fb = np.minimum(g.num_vertices, fb * (k + grow))
        if max(caps) > MAX_FUSED_CAP:
            return None
        groups.append({"masks0": masks0, "labels": labs, "caps": caps})
    return {"groups": groups, "ks": ks, "behavior": behavior}


def _mg_sample_device_path(g, mesh, plan, *, seed, biased, with_replacement,
                           prior_sources_behavior, dedupe_sources,
                           return_hops, with_edge_properties, batch_id_list,
                           temporal=False, seed_time=0.0,
                           comparison="strictly_increasing"):
    """The fused route (``sampling_mg.py:414-490``): every hop on the
    device, the compacted (frontier key, sampled row) pairs read once at
    the end; the same seeds per row as the layered route, so the same rows
    in hop, batch and vertex order."""
    from cugraph_tpu_torch.parallel.algos import \
        mg_sample_multihop_batched_device

    pad = g.pad_v
    groups = plan["groups"]
    host = mg_sample_multihop_batched_device(
        g, mesh, [grp["masks0"] for grp in groups], plan["ks"],
        [grp["caps"] for grp in groups], seed=seed,
        with_replacement=with_replacement, biased=biased,
        behavior=plan["behavior"], temporal=temporal, seed_time=seed_time,
        comparison=comparison)
    frames = []
    for grp, ghost in zip(groups, host):
        labels = grp["labels"]
        for hop, (keys, rows, erows, trows) in enumerate(ghost):
            if not len(keys):
                continue
            v = (keys % pad).astype(np.int64)
            plane = (keys // pad).astype(np.int64)
            ridx, cidx = np.nonzero(rows >= 0)
            if not len(ridx):
                continue
            fr = pd.DataFrame({
                "sources": v[ridx],
                "destinations": rows[ridx, cidx].astype(np.int64),
                "hop_id": np.int32(hop),
                "batch_id": labels[plane[ridx]].astype(np.int32)
                if len(labels) else np.int32(0),
            })
            if erows is not None:
                fr["_eid"] = erows[ridx, cidx].astype(np.int64)
            if trows is not None:
                fr["edge_time"] = trows[ridx, cidx].astype(np.float32)
            frames.append(fr)
    cols_out = ["sources", "destinations", "hop_id", "batch_id"]
    if temporal:
        cols_out.insert(2, "edge_time")
    if not frames:
        return pd.DataFrame(columns=[c for c in cols_out
                                     if return_hops or c != "hop_id"])
    out = pd.concat(frames, ignore_index=True)
    if len(groups) > 1:
        # group-major assembly → the hop-major row order of one group
        out = out.sort_values("hop_id", kind="stable", ignore_index=True)
    if with_edge_properties:
        out = _attach_props(g, mesh, out)
    if "_eid" in out:
        out = out.drop(columns=["_eid"])
    if temporal:
        rest = [c for c in out.columns if c not in cols_out]
        out = out[cols_out + rest]
    if not return_hops:
        out = out.drop(columns=["hop_id"])
    return out


def mg_biased_neighbor_sample(g: DistGraph, mesh, start_list, fanout_vals,
                              with_replacement: bool = False, seed: int = 0,
                              **kw):
    """Weight-biased distributed neighbour sampling
    (homogeneous_biased_neighbor_sample's MG role)."""
    return mg_uniform_neighbor_sample(g, mesh, start_list, fanout_vals,
                                      with_replacement=with_replacement,
                                      seed=seed, biased=True, **kw)


def _het_masks_plans(g: DistGraph, mesh, fanout_vals, num_edge_types):
    """Per-type eligibility of this rank's push edges and the per-hop
    (type, fanout) plans.  The types present are the mesh's (one MAX
    all-reduce of a presence vector), so every rank runs the same plans."""
    et = g.push.etype
    local = torch.unique(et) if et.numel() else et[:0]
    top = prims.all_reduce(torch.tensor(
        [int(local.max()) if local.numel() else -1], dtype=torch.int64,
        device=mesh.device), mesh.world, "max").item()
    present = torch.zeros(top + 1, dtype=torch.int32, device=mesh.device)
    present[local.to(torch.int64)] = 1
    types = torch.nonzero(prims.all_reduce(present, mesh.world, "max"))[
        :, 0].tolist()
    ntypes = num_edge_types or (max(types) + 1 if types else 1)
    fvs = list(fanout_vals)
    if len(fvs) % ntypes:
        raise ValueError("fanout_vals must be hops × num_edge_types")
    hops = [fvs[i:i + ntypes] for i in range(0, len(fvs), ntypes)]
    masks = {int(t): et == t for t in types}
    plans = [[(t, int(k)) for t, k in enumerate(hop_fans)]
             for hop_fans in hops]
    return masks, plans


def mg_heterogeneous_neighbor_sample(g: DistGraph, mesh, start_list,
                                     fanout_vals, num_edge_types=None,
                                     seed: int = 0, biased: bool = False,
                                     with_replacement: bool = False, **kw):
    """Distributed per-edge-type neighbour sampling (reference MG
    heterogeneous_{uniform,biased}_neighbor_sample): ``fanout_vals`` is
    flattened [hop0_type0, hop0_type1, ...]."""
    kw.pop("disjoint_sampling", None)  # per-batch frontiers are disjoint
    kw.pop("temporal_sampling_comparison", None)  # temporal-only knob
    flags = _flag_kwargs(kw)
    if kw:
        raise TypeError(f"unknown sampler kwargs: {sorted(kw)}")
    if g.push is None or g.push.etype is None:
        raise ValueError("heterogeneous MG sampling requires push blocks "
                         "built with edge_type")
    masks, plans = _het_masks_plans(g, mesh, fanout_vals, num_edge_types)
    return _mg_neighbor_sample_core(
        g, mesh, start_list, plans, seed=seed,
        with_replacement=with_replacement, biased=biased, masks=masks,
        **flags)


def mg_temporal_neighbor_sample(g: DistGraph, mesh, start_list, fanout_vals,
                                seed_time: float = 0.0, strict: bool = True,
                                seed: int = 0, biased: bool = False,
                                with_replacement: bool = False, **kw):
    """Distributed temporal neighbour sampling (reference MG
    homogeneous_{uniform,biased}_temporal): an eligible edge's time is past
    the frontier vertex's arrival time; a sampled vertex arrives at the
    traversed edge's time (each (vertex, batch) pair carries its own)."""
    from cugraph_tpu_torch.algos._frontier import resolve_temporal_comparison

    comparison = kw.pop("temporal_sampling_comparison", None)
    if kw.pop("disjoint_sampling", True) is False:
        raise ValueError("temporal sampling requires disjoint sampling "
                         "(reference contract, sampling_functions.hpp:80)")
    flags = _flag_kwargs(kw)
    if kw:
        raise TypeError(f"unknown sampler kwargs: {sorted(kw)}")
    if g.push is None or g.push.etime is None:
        raise ValueError("temporal MG sampling requires push blocks built "
                         "with edge_time")
    plan = (_plan_fused(g, mesh, start_list, fanout_vals, flags,
                        temporal=True)
            if np.ndim(seed_time) == 0 else None)
    if plan is not None:
        return _mg_sample_device_path(
            g, mesh, plan, seed=seed, biased=biased,
            with_replacement=with_replacement, temporal=True,
            seed_time=float(seed_time),
            comparison=resolve_temporal_comparison(comparison, strict),
            **flags)
    plans = [[(None, int(k))] for k in fanout_vals]
    return _mg_neighbor_sample_core(
        g, mesh, start_list, plans, seed=seed,
        with_replacement=with_replacement, biased=biased,
        temporal=True, seed_time=seed_time, strict=strict,
        temporal_sampling_comparison=comparison, **flags)


def mg_heterogeneous_temporal_neighbor_sample(
        g: DistGraph, mesh, start_list, fanout_vals, num_edge_types=None,
        seed_time: float = 0.0, strict: bool = True, seed: int = 0,
        biased: bool = False, with_replacement: bool = False, **kw):
    """Distributed per-edge-type temporal sampling (reference MG
    heterogeneous_{uniform,biased}_temporal_neighbor_sample.pyx): the
    per-type masks and the arrival-time regime in one hop."""
    comparison = kw.pop("temporal_sampling_comparison", None)
    if kw.pop("disjoint_sampling", True) is False:
        raise ValueError("temporal sampling requires disjoint sampling "
                         "(reference contract, sampling_functions.hpp:80)")
    flags = _flag_kwargs(kw)
    if kw:
        raise TypeError(f"unknown sampler kwargs: {sorted(kw)}")
    if g.push is None or g.push.etype is None or g.push.etime is None:
        raise ValueError("heterogeneous temporal MG sampling requires push "
                         "blocks built with edge_type and edge_time")
    masks, plans = _het_masks_plans(g, mesh, fanout_vals, num_edge_types)
    return _mg_neighbor_sample_core(
        g, mesh, start_list, plans, seed=seed,
        with_replacement=with_replacement, biased=biased, masks=masks,
        temporal=True, seed_time=seed_time, strict=strict,
        temporal_sampling_comparison=comparison, **flags)
