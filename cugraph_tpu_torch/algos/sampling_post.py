"""Sampling post-processing: per-batch renumber + compress to CSR/CSC.

Reference: cpp/src/sampling/sampling_post_processing_impl.cuh ("renumber
sampled edge list and compress to (D)CSR/CSC", sampling_functions.hpp) and
python/cugraph/cugraph/sampling/sampling_utilities.py — the step that turns
raw sampled COO frames into the per-batch tensors GNN dataloaders consume.

Outputs are dense NumPy arrays (the cugraph-pyg/DGL role is played by
``cugraph_tpu_torch.nn.minibatch``, which consumes exactly these).  A copy
of ``cugraph_tpu.algos.sampling_post``, which is NumPy and pandas only: the
port keeps its own so that it never imports the JAX package."""

from __future__ import annotations

import numpy as np
import pandas as pd


def renumber_sampled_edgelist(df: pd.DataFrame, batch_col: str = "batch_id"):
    """Per-batch dense renumbering of a sampled edge frame.

    Vertices are numbered in first-appearance order walking hops in order —
    sources of hop 0 first (the seeds), then destinations of hop 0, then
    hop 1, … matching the reference's renumbering so layer-wise GNN code can
    slice seed rows as [0, num_seeds) (sampling_post_processing_impl.cuh).

    Returns (renumbered_df, maps) where maps[batch] is the int array whose
    i-th entry is the original vertex id of renumbered id i.
    """
    out_src = np.empty(len(df), np.int64)
    out_dst = np.empty(len(df), np.int64)
    maps = {}
    pos = np.arange(len(df))
    for b, grp in df.groupby(batch_col, sort=True):
        rows = grp.index.to_numpy()
        # first-appearance order walking hops: ALL sources of hop h before
        # any destination of hop h (vectorized via a (hop, src/dst) sort
        # key); frames without hop_id (return_hops=False samplers emit
        # them) renumber as a single hop
        hops = (grp["hop_id"].to_numpy() if "hop_id" in grp
                else np.zeros(len(grp), np.int64))
        allv = np.concatenate([grp["sources"].to_numpy(),
                               grp["destinations"].to_numpy()])
        keys = np.concatenate([hops * 2, hops * 2 + 1])
        stream = allv[np.argsort(keys, kind="stable")]
        uniq, first = np.unique(stream, return_index=True)
        appearance = np.argsort(first, kind="stable")
        vmap = uniq[appearance]                       # id → original vertex
        maps[b] = vmap
        sel = pos[df.index.get_indexer(rows)] if not df.index.equals(
            pd.RangeIndex(len(df))) else rows
        # vectorized rank lookup (the _renumber_one_label pattern below) —
        # the per-edge dict comprehension it replaces was interpreter-speed
        sorter = np.argsort(vmap, kind="stable")
        vs = vmap[sorter]
        out_src[sel] = sorter[np.searchsorted(
            vs, df["sources"].to_numpy()[sel])]
        out_dst[sel] = sorter[np.searchsorted(
            vs, df["destinations"].to_numpy()[sel])]
    out = df.copy()
    out["sources"] = out_src
    out["destinations"] = out_dst
    return out, maps


def compress_per_hop_csr(renumbered: pd.DataFrame, maps: dict,
                         batch_col: str = "batch_id"):
    """Compress a renumbered sampled frame to per-(batch, hop) CSR arrays.

    Returns {batch: {"map": ids, "hops": [{"offsets", "indices", "weight"}]}}
    — offsets over the batch's renumbered source space, the (D)CSR shape the
    reference emits for GNN consumption.
    """
    out = {}
    for b, grp in renumbered.groupby(batch_col, sort=True):
        n_local = len(maps[b])
        hops = []
        hop_vals = (sorted(grp["hop_id"].unique()) if "hop_id" in grp
                    else [0])
        for hop in hop_vals:
            h = grp[grp["hop_id"] == hop] if "hop_id" in grp else grp
            s = h["sources"].to_numpy()
            d = h["destinations"].to_numpy()
            w = h["weight"].to_numpy() if "weight" in h else np.ones(len(h))
            order = np.lexsort((d, s))
            s, d, w = s[order], d[order], w[order]
            offsets = np.zeros(n_local + 1, np.int64)
            np.add.at(offsets, s + 1, 1)
            np.cumsum(offsets, out=offsets)
            hops.append({"offsets": offsets, "indices": d, "weight": w})
        out[b] = {"map": maps[b], "hops": hops}
    return out


def sampling_results_to_batches(df: pd.DataFrame):
    """One-call convenience: raw sampled frame → per-batch compressed CSR."""
    renum, maps = renumber_sampled_edgelist(df)
    return compress_per_hop_csr(renum, maps)


# ---------------------------------------------------------------------------
# Full compression matrix (reference renumber_and_compress_sampled_edgelist,
# sampling_functions.hpp:900-1015 + sampling_post_processing_impl.cuh):
# per-label renumber by min (hop, major<minor) pair, sort by (hop, major,
# minor), compress to CSR/CSC (src_is_major) or DCSR/DCSC (doubly_compress),
# per-hop or whole-label (compress_per_hop), with edge weight/id/type
# carried through and the reference's offsets-array bookkeeping
# (label_hop_offsets, renumber_map, renumber_map_offsets).
# ---------------------------------------------------------------------------

_EDGE_PROP_COLS = ("weight", "edge_id", "edge_type", "edge_time")


def _renumber_one_label(grp: pd.DataFrame, major_col: str, minor_col: str,
                        seed_vertices=None):
    """Renumber map for one label: vertices ordered by their minimum
    (hop, flag) pair, flag=major(0) < minor(1); seed vertices count as
    (hop 0, major) so isolated seeds still get ids (reference rule 1)."""
    hops = (grp["hop_id"].to_numpy() if "hop_id" in grp
            else np.zeros(len(grp), np.int64))
    majors = grp[major_col].to_numpy()
    minors = grp[minor_col].to_numpy()
    vs, keys = [majors, minors], [hops * 2, hops * 2 + 1]
    if seed_vertices is not None and len(seed_vertices):
        vs.insert(0, np.asarray(seed_vertices))
        keys.insert(0, np.full(len(seed_vertices), -1, np.int64))
    allv = np.concatenate(vs)
    allk = np.concatenate(keys)
    order = np.argsort(allk, kind="stable")
    stream = allv[order]
    uniq, first = np.unique(stream, return_index=True)
    vmap = uniq[np.argsort(first, kind="stable")]
    sorter = np.argsort(vmap, kind="stable")

    def rank_of(vals):
        """vectorized vmap-position lookup (the per-edge hot path)."""
        vals = np.asarray(vals)
        return sorter[np.searchsorted(vmap, vals, sorter=sorter)]

    return vmap, rank_of


def renumber_and_compress_sampled_edgelist(
    df: pd.DataFrame,
    *,
    src_is_major: bool = True,
    compress_per_hop: bool = False,
    doubly_compress: bool = False,
    batch_col: str = "batch_id",
    seed_vertices_per_label: dict | None = None,
) -> dict:
    """Sampled edge frame → the reference's compressed GNN-feed tensors.

    Returns a dict mirroring the reference output tuple / the pyx result
    names (sampling_utilities.py): ``major_offsets`` (all (label, hop-group)
    offset arrays concatenated), ``majors`` (DCSR/DCSC nonzero-major ids, or
    None when ``doubly_compress=False``), ``minors``, per-edge property
    columns present in ``df`` (weight / edge_id / edge_type / edge_time,
    sorted consistently), ``label_hop_offsets`` (start of each (label, hop)
    segment in ``major_offsets``; one segment per label when hops are
    compressed together), ``renumber_map`` and ``renumber_map_offsets``.

    ``compress_per_hop=True`` requires hop ids and (per reference) excludes
    ``doubly_compress``.
    """
    if compress_per_hop and doubly_compress:
        raise ValueError("compress_per_hop requires doubly_compress=False "
                         "(reference contract)")
    if compress_per_hop and "hop_id" not in df:
        raise ValueError("compress_per_hop requires hop ids")
    major_col, minor_col = (("sources", "destinations") if src_is_major
                            else ("destinations", "sources"))
    has_hops = "hop_id" in df
    labels = (np.unique(df[batch_col].to_numpy()) if batch_col in df
              else np.array([0]))
    if seed_vertices_per_label:
        # a label whose seeds produced NO edges still gets a renumber-map
        # segment (the retain_seeds contract)
        labels = np.unique(np.concatenate(
            [labels, np.fromiter(seed_vertices_per_label, np.int64)]))
    prop_cols = [c for c in _EDGE_PROP_COLS if c in df]
    num_hops = int(df["hop_id"].max()) + 1 if has_hops and len(df) else 1

    all_offsets, nzd_majors, minors_out = [], [], []
    props_out = {c: [] for c in prop_cols}
    label_hop_offsets = [0]
    renumber_map, renumber_map_offsets = [], [0]

    groups = (dict(tuple(df.groupby(batch_col, sort=True)))
              if batch_col in df else {0: df})
    empty = df.iloc[:0]
    for lab in labels:
        grp = groups.get(lab, empty)
        seeds = (None if seed_vertices_per_label is None
                 else seed_vertices_per_label.get(int(lab)))
        vmap, rank_of = _renumber_one_label(grp, major_col, minor_col, seeds)
        renumber_map.append(vmap)
        renumber_map_offsets.append(renumber_map_offsets[-1] + len(vmap))

        maj = rank_of(grp[major_col].to_numpy()).astype(np.int64)
        mnr = rank_of(grp[minor_col].to_numpy()).astype(np.int64)
        hops = (grp["hop_id"].to_numpy().astype(np.int64) if has_hops
                else np.zeros(len(grp), np.int64))
        # per-hop compression keeps the reference's (hop, major, minor)
        # order; whole-label compression sorts by (major, minor, hop) so the
        # CSR rows align even when the reference's majors-monotone-in-hop
        # precondition (sampling_functions.hpp:931-935) does not hold
        order = (np.lexsort((mnr, maj, hops)) if compress_per_hop
                 else np.lexsort((hops, mnr, maj)))
        maj, mnr, hops = maj[order], mnr[order], hops[order]
        for c in prop_cols:
            props_out[c].append(grp[c].to_numpy()[order])
        minors_out.append(mnr)

        if compress_per_hop:
            # reference size rule: hop h's offsets cover the larger of this
            # hop's max major and the max vertex id of all PREVIOUS hops'
            # edges (seeds count as hop-0 majors)
            prev_max = -1
            if seeds is not None and len(seeds):
                prev_max = int(rank_of(np.asarray(seeds)).max())
            for h in range(num_hops):
                sel = hops == h
                hm = maj[sel]
                hi = int(hm.max()) if len(hm) else -1
                n_rows = max(hi, prev_max) + 1
                prev_max = max(prev_max, hi,
                               int(mnr[sel].max(initial=-1)))
                offs = np.zeros(n_rows + 1, np.int64)
                np.add.at(offs, hm + 1, 1)
                np.cumsum(offs, out=offs)
                all_offsets.append(offs)
        else:
            # retained seeds that produced no edges still need their CSR
            # row (the per-hop branch's prev_max handling covers them; the
            # whole-label branch must too)
            n_rows = int(maj.max()) + 1 if len(maj) else 0
            if seeds is not None and len(seeds):
                n_rows = max(n_rows,
                             int(rank_of(np.asarray(seeds)).max()) + 1)
            if n_rows == 0:
                n_rows = len(vmap)
            offs = np.zeros(n_rows + 1, np.int64)
            np.add.at(offs, maj + 1, 1)
            np.cumsum(offs, out=offs)
            if doubly_compress:
                nz = np.flatnonzero(np.diff(offs) > 0)
                nzd_majors.append(nz)
                d_offs = np.concatenate([[0], np.cumsum(np.diff(offs)[nz])])
                all_offsets.append(d_offs)
            else:
                all_offsets.append(offs)

    # label_hop_offsets: start index of each (label[, hop]) offsets segment
    # in the concatenated major_offsets array
    seg_lens = [len(o) for o in all_offsets]
    label_hop_offsets = np.concatenate([[0], np.cumsum(seg_lens)])

    out = {
        "major_offsets": (np.concatenate(all_offsets)
                          if all_offsets else np.zeros(1, np.int64)),
        "majors": (np.concatenate(nzd_majors) if doubly_compress else None),
        "minors": (np.concatenate(minors_out)
                   if minors_out else np.zeros(0, np.int64)),
        "label_hop_offsets": label_hop_offsets,
        "renumber_map": (np.concatenate(renumber_map)
                         if renumber_map else np.zeros(0, np.int64)),
        "renumber_map_offsets": np.asarray(renumber_map_offsets, np.int64),
    }
    for c in prop_cols:
        out[c] = np.concatenate(props_out[c]) if props_out[c] else \
            np.zeros(0)
    return out


def heterogeneous_renumber_and_sort_sampled_edgelist(
    df: pd.DataFrame,
    *,
    vertex_type_offsets,
    num_edge_types: int | None = None,
    src_is_major: bool = True,
    batch_col: str = "batch_id",
    seed_vertices_per_label: dict | None = None,
) -> dict:
    """Heterogeneous sampled-edge post-processing
    (reference heterogeneous_renumber_and_sort_sampled_edgelist,
    sampling_functions.hpp:1214 + sampling_post_processing_impl.cuh).

    * Vertices renumber PER (label, vertex type): within a label, vertices
      are ordered by their minimum (hop, flag) pair (flag major=0 < minor=1;
      seeds count as (hop 0, major)), then each vertex TYPE's vertices map to
      consecutive ids starting from 0 — ``vertex_type_offsets`` (size
      num_vertex_types + 1) segments the ORIGINAL id range by type.
    * Edge ids renumber per (label, edge type) by minimum hop, consecutive
      from 0.
    * Edges sort by ((edge type), (hop), major, minor) within each label.

    Returns a dict with the reference tuple's fields (pyx accessor names):
    ``majors``/``minors`` (renumbered, TYPE-LOCAL ids — the reference
    omits explicit endpoint types because an edge's type determines them),
    per-edge property columns, renumbered ``edge_id``,
    ``label_type_hop_offsets`` ([num_labels·num_edge_types·num_hops + 1]
    edge offsets), ``renumber_map`` + ``renumber_map_offsets``
    ([num_labels·num_vertex_types + 1] segment offsets), and
    ``edge_renumber_map`` + ``edge_renumber_map_offsets``
    ([num_labels·num_edge_types + 1]).
    """
    vto = np.asarray(vertex_type_offsets, np.int64)
    if len(vto) < 2 or (np.diff(vto) < 0).any():
        raise ValueError("vertex_type_offsets must be a nondecreasing array "
                         "of size num_vertex_types + 1")
    n_vt = len(vto) - 1
    major_col, minor_col = (("sources", "destinations") if src_is_major
                            else ("destinations", "sources"))
    has_hops = "hop_id" in df
    num_hops = int(df["hop_id"].max()) + 1 if has_hops and len(df) else 1
    has_etype = "edge_type" in df
    has_eid = "edge_id" in df
    T = int(num_edge_types if num_edge_types is not None else
            (int(df["edge_type"].max()) + 1 if has_etype and len(df) else 1))
    labels = (np.unique(df[batch_col].to_numpy()) if batch_col in df
              else np.array([0]))
    if seed_vertices_per_label:
        labels = np.unique(np.concatenate(
            [labels, np.fromiter(seed_vertices_per_label, np.int64)]))
    L = len(labels)
    prop_cols = [c for c in _EDGE_PROP_COLS
                 if c in df and c not in ("edge_id", "edge_type")]

    def vtype_of(v):
        t = np.searchsorted(vto, np.asarray(v), side="right") - 1
        if len(t) and ((t < 0).any() or (t >= n_vt).any()):
            raise ValueError("vertex id outside vertex_type_offsets range")
        return t

    maj_out, mnr_out, et_out, hop_out, bat_out = [], [], [], [], []
    eid_out = []
    props_out = {c: [] for c in prop_cols}
    rmap, rmap_off = [], [0]
    emap, emap_off = [], [0]
    lth_counts = np.zeros(L * T * num_hops, np.int64)
    groups = (dict(tuple(df.groupby(batch_col, sort=True)))
              if batch_col in df else {0: df})
    empty = df.iloc[:0]
    for li, lab in enumerate(labels):
        grp = groups.get(lab, empty)
        seeds = (None if seed_vertices_per_label is None
                 else seed_vertices_per_label.get(int(lab)))
        # global (hop, flag) appearance order, then segmented per type
        vmap_all, _ = _renumber_one_label(grp, major_col, minor_col, seeds)
        tv = vtype_of(vmap_all)
        counts = np.bincount(tv, minlength=n_vt)
        starts = np.zeros(n_vt, np.int64)
        starts[1:] = np.cumsum(counts)[:-1]
        # type-local rank, preserving the (hop, flag) appearance order
        # within each type segment
        by_type = np.argsort(tv, kind="stable")
        ranks = np.empty(len(vmap_all), np.int64)
        ranks[by_type] = np.arange(len(vmap_all)) - np.repeat(starts, counts)
        for t in range(n_vt):
            rmap.append(vmap_all[tv == t])
            rmap_off.append(rmap_off[-1] + int(counts[t]))
        sorter = np.argsort(vmap_all, kind="stable")

        def rank_of(vals):
            vals = np.asarray(vals)
            return ranks[sorter[np.searchsorted(vmap_all, vals,
                                                sorter=sorter)]]

        maj = rank_of(grp[major_col].to_numpy()).astype(np.int64)
        mnr = rank_of(grp[minor_col].to_numpy()).astype(np.int64)
        hops = (grp["hop_id"].to_numpy().astype(np.int64) if has_hops
                else np.zeros(len(grp), np.int64))
        et = (grp["edge_type"].to_numpy().astype(np.int64) if has_etype
              else np.zeros(len(grp), np.int64))
        # an out-of-range type would index the NEXT label's offset segment
        # and leave np.empty garbage in the renumbered edge ids — fail loud
        if has_etype and len(et) and (et.min() < 0 or et.max() >= T):
            raise ValueError(
                f"edge_type values span [{et.min()}, {et.max()}] but "
                f"num_edge_types={T}")
        # reference sort key: ((edge type), (hop), major, minor)
        order = np.lexsort((mnr, maj, hops, et))
        maj, mnr, hops, et = maj[order], mnr[order], hops[order], et[order]
        maj_out.append(maj)
        mnr_out.append(mnr)
        et_out.append(et)
        hop_out.append(hops)
        bat_out.append(np.full(len(maj), lab))
        for c in prop_cols:
            props_out[c].append(grp[c].to_numpy()[order])
        np.add.at(lth_counts, (li * T + et) * num_hops + hops, 1)

        if has_eid:
            ids = grp["edge_id"].to_numpy().astype(np.int64)[order]
            new_ids = np.empty(len(ids), np.int64)
            for t in range(T):
                sel = et == t
                ids_t, hops_t = ids[sel], hops[sel]
                # min-hop-first appearance order (rule: smaller hop values
                # renumber first; arbitrary within (edge type, hop))
                o2 = np.lexsort((ids_t, hops_t))
                stream = ids_t[o2]
                uniq, first = np.unique(stream, return_index=True)
                m = uniq[np.argsort(first, kind="stable")]
                s2 = np.argsort(m, kind="stable")
                new_ids[sel] = s2[np.searchsorted(m, ids_t, sorter=s2)]
                emap.append(m)
                emap_off.append(emap_off[-1] + len(m))
            eid_out.append(new_ids)

    def _cat(parts, dtype=np.int64):
        return (np.concatenate(parts) if parts else np.zeros(0, dtype))

    out = {
        "majors": _cat(maj_out),
        "minors": _cat(mnr_out),
        "edge_type": (_cat(et_out) if has_etype else None),
        "hop": (_cat(hop_out) if has_hops else None),
        "batch_id": _cat(bat_out),
        "edge_id": (_cat(eid_out) if has_eid else None),
        "label_type_hop_offsets": np.concatenate(
            [[0], np.cumsum(lth_counts)]).astype(np.int64),
        "renumber_map": _cat(rmap),
        "renumber_map_offsets": np.asarray(rmap_off, np.int64),
        "edge_renumber_map": (_cat(emap) if has_eid else None),
        "edge_renumber_map_offsets": (np.asarray(emap_off, np.int64)
                                      if has_eid else None),
    }
    for c in prop_cols:
        out[c] = _cat(props_out[c], np.float64)
    return out
