"""The multi-device samplers' cases and the body the gloo worlds run.

``CASES`` lists every call the tests make, each on one of ``GRAPHS``;
``run_case`` makes one through a port module or the JAX package's (the
caller passes the module set), so both sides read one list.  The worlds'
ranks replay the JAX package's draws: ``ReplayDraws`` takes the place of
``cugraph_tpu_torch.parallel.algos.MGDraws`` and hands out, for each
(seed, round, rank) key, the uniforms or the Gumbel noise that the JAX
hop draws at that key over its padded block, put in the port block's edge
order (``perm``); it raises on a key it was not given.  ``sampling_body``
runs every case on every rank and returns each result by case, with a
flag saying whether every rank returned the same.  This module imports
only torch, NumPy, pandas and the port (``run_case`` takes the JAX
modules from its caller).
"""

from __future__ import annotations

import hashlib

import numpy as np
import pandas as pd
import torch
import torch.distributed as dist

from torch_port_mg import random_coo, skew_coo


def typed_coo(n=90, m=700, seed=4):
    """Parallel edges included: 3 edge types, float times in [0, 100),
    weights in [0.5, 2.0]."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = src != dst
    src, dst = src[keep].astype(np.int64), dst[keep].astype(np.int64)
    w = rng.uniform(0.5, 2.0, len(src)).astype(np.float32)
    et = ((src * 7 + dst) % 3).astype(np.int32)
    tm = np.round(rng.uniform(0.0, 100.0, len(src))).astype(np.float32)
    return src, dst, w, n, dict(edge_type=et, edge_time=tm)


def multi_coo():
    """Each of the random graph's first 40 edges twice, the copies with
    other weights; no instance ids, so properties go by (src, dst) key."""
    src, dst, w, n = random_coo(seed=1)
    s = np.concatenate([src, src[:40]])
    d = np.concatenate([dst, dst[:40]])
    ww = np.concatenate([w, w[:40] + 1.0])
    return s, d, ww, n, dict(store_eid=False)


def shuffled_coo():
    """The random graph's edges in a shuffled order: the JAX package's
    native ``build_blocks_2d`` keeps input order within a dst slot, so its
    push slots are then not the port's edge order."""
    src, dst, w, n = random_coo(seed=1)
    order = np.random.default_rng(9).permutation(len(src))
    return src[order], dst[order], w[order], n


def _with(coo, **kw):
    src, dst, w, n = coo
    return src, dst, w, n, kw


# name → (src, dst, weights, n, build_dist_graph keywords)
GRAPHS = {
    "weighted": _with(random_coo(seed=1)),
    "noeid": _with(random_coo(seed=1), store_eid=False),
    "shuffled": _with(shuffled_coo()),
    "unweighted": _with(random_coo(seed=2, weighted=False)),
    "skew": _with(skew_coo()),
    "typed": typed_coo(),
    "typed_noeid": (*typed_coo()[:4], dict(typed_coo()[4], store_eid=False)),
    "multi": multi_coo(),
}

SEEDS = [0, 5, 9, 13, 5, 20, 0, 77]
SKEW_SEEDS = [1, 4, 9, 30, 79, 150, 200, 4]
TYPED_SEEDS = [0, 3, 8, 8, 21, 40, 55, 3]
# 40 seeds in 20 batches, repeats across batches: more than 16 batches,
# so the fused route runs two groups and carries ``lbase``
FUSED_SEEDS = [int(v) for v in (np.arange(40) * 37) % 150]
FUSED_BATCHES = [int(b) for b in np.arange(40) % 20]
COMPARISONS = ["strictly_increasing", "monotonically_increasing",
               "strictly_decreasing", "monotonically_decreasing", "last"]


def _case(fn, graph, *args, **kw):
    return {"fn": fn, "graph": graph, "args": args, "kw": kw}


def _cases():
    c = {
        "uniform": _case("uniform", "weighted", SEEDS, [3, 2], seed=3),
        "uniform_wr": _case("uniform", "weighted", SEEDS, [3, 2], seed=4,
                            with_replacement=True),
        "biased": _case("biased", "weighted", SEEDS, [3, 2], seed=5),
        "biased_wr": _case("biased", "weighted", SEEDS, [4, 3], seed=6,
                           with_replacement=True),
        "skew": _case("uniform", "skew", SKEW_SEEDS, [4, 3], seed=7),
        "shuffled": _case("uniform", "shuffled", SEEDS, [3, 2], seed=3),
        "shuffled_biased_props": _case(
            "biased", "shuffled", SEEDS, [3, 2], seed=5,
            with_edge_properties=True),
        "unweighted_batches": _case(
            "uniform", "unweighted", SEEDS, [2, 2, 2], seed=8,
            batch_id_list=[0, 0, 1, 1, 2, 2, 3, 3], return_hops=False),
        "props_eid": _case("uniform", "weighted", SEEDS, [3, 2], seed=9,
                           with_edge_properties=True),
        "props_key": _case("uniform", "noeid", SEEDS, [3, 2], seed=9,
                           with_edge_properties=True),
        "props_typed_key": _case("uniform", "typed_noeid", TYPED_SEEDS,
                                 [2, 2], seed=10,
                                 with_edge_properties=True),
        "ambiguous": _case("uniform", "multi", list(range(40)), [6], seed=1,
                           with_edge_properties=True),
        "het": _case("het", "typed", TYPED_SEEDS, [2, 1, 3] * 2,
                     num_edge_types=3, seed=11),
        "het_biased": _case("het", "typed", TYPED_SEEDS, [2, 1, 2] * 2,
                            num_edge_types=3, seed=12, biased=True,
                            with_replacement=True),
        "het_temporal": _case("het_temporal", "typed", TYPED_SEEDS,
                              [2, 1, 2] * 2, num_edge_types=3, seed=13,
                              seed_time=10.0),
        "het_temporal_last": _case(
            "het_temporal", "typed", TYPED_SEEDS, [2, 2, 1] * 2,
            num_edge_types=3, seed=14, seed_time=90.0,
            temporal_sampling_comparison="last"),
        "walks": _case("walk_uniform", "weighted", SEEDS, 5, seed=2),
        "walks_biased": _case("walk_biased", "weighted", SEEDS, 5, seed=3),
        "node2vec": _case("node2vec", "weighted", SEEDS, 4, p=0.5, q=2.0,
                          seed=4),
        "node2vec_skew": _case("node2vec", "skew", SKEW_SEEDS, 4, p=2.0,
                               q=0.5, seed=5),
        "has_edge": _case("has_edge", "typed"),
        "multihop": _case("multihop", "weighted", SEEDS, [3, 2], seed=15),
        "multihop_biased": _case("multihop", "weighted", SEEDS, [2, 2],
                                 seed=16, biased=True,
                                 with_replacement=True),
        "one_hop_temporal": _case("one_hop", "typed", TYPED_SEEDS, 3,
                                  seed=17),
    }
    for cmp in COMPARISONS:
        c[f"temporal_{cmp}"] = _case(
            "temporal", "typed", TYPED_SEEDS, [2, 2], seed=20,
            seed_time=50.0, temporal_sampling_comparison=cmp)
    for behavior in ("default", "carry_over", "exclude"):
        kw = dict(dedupe_sources=True, batch_id_list=FUSED_BATCHES,
                  prior_sources_behavior=behavior, seed=21)
        c[f"fused_{behavior}"] = _case("uniform", "weighted", FUSED_SEEDS,
                                       [3, 2], **kw)
        c[f"layered_{behavior}"] = _case("core", "weighted", FUSED_SEEDS,
                                         [3, 2], **kw)
    c["fused_biased_props"] = _case(
        "biased", "weighted", FUSED_SEEDS, [2, 2], dedupe_sources=True,
        batch_id_list=FUSED_BATCHES, seed=22, with_edge_properties=True)
    c["fused_temporal"] = _case(
        "temporal", "typed", TYPED_SEEDS, [2, 2], seed=23, seed_time=30.0,
        dedupe_sources=True, batch_id_list=[0, 0, 1, 1, 2, 2, 3, 3])
    c["layered_temporal"] = _case(
        "core", "typed", TYPED_SEEDS, [2, 2], seed=23, seed_time=30.0,
        temporal=True, dedupe_sources=True,
        batch_id_list=[0, 0, 1, 1, 2, 2, 3, 3])
    return c


CASES = _cases()


def build(pkg, name, where):
    """``pkg.build_dist_graph`` of graph ``name`` with its push blocks: the
    port's on mesh ``where``, the JAX package's on a (pmaj, pmin) tuple."""
    src, dst, w, n, kw = GRAPHS[name]
    if isinstance(where, tuple):
        return pkg.build_dist_graph(src, dst, w, n, *where, store_push=True,
                                    **kw)
    return pkg.build_dist_graph(src, dst, w, n, where, store_push=True, **kw)


def _frame(df):
    return {f"col/{c}": df[c].to_numpy() for c in df.columns} | {
        "cols": np.array(list(df.columns))}


def run_case(case, g, mesh, mods, gather):
    """One case through ``mods`` (a dict: "pkg" the parallel package,
    "sampling_mg" its module, "has_edge" a function (ss, dd) → bool,
    "rows" its ``sample_panel_rows``) on graph ``g``; returns a dict of
    arrays.  ``gather`` turns owned panels into global [pad_v, ...] NumPy
    arrays (identity for the JAX package)."""
    pkg, fn, args, kw = mods["pkg"], case["fn"], case["args"], dict(
        case["kw"])
    if fn in ("uniform", "biased", "het", "temporal", "het_temporal"):
        call = {"uniform": pkg.mg_uniform_neighbor_sample,
                "biased": pkg.mg_biased_neighbor_sample,
                "het": pkg.mg_heterogeneous_neighbor_sample,
                "temporal": pkg.mg_temporal_neighbor_sample,
                "het_temporal":
                    pkg.mg_heterogeneous_temporal_neighbor_sample}[fn]
        seeds, fanouts = args
        kw["batch_id_list"] = (None if "batch_id_list" not in kw
                               else np.asarray(kw["batch_id_list"], np.int32))
        try:
            return _frame(call(g, mesh, np.asarray(seeds), fanouts, **kw))
        except ValueError as e:
            return {"raised": np.array(str(e))}
    if fn == "core":
        seeds, fanouts = args
        sm = mods["sampling_mg"]
        flags = dict(prior_sources_behavior=kw.pop("prior_sources_behavior",
                                                   "default"),
                     dedupe_sources=kw.pop("dedupe_sources"),
                     batch_id_list=np.asarray(kw.pop("batch_id_list"),
                                              np.int32))
        return _frame(sm._mg_neighbor_sample_core(
            g, mesh, np.asarray(seeds), [[(None, k)] for k in fanouts],
            with_replacement=False, biased=False, **flags, **kw))
    if fn in ("walk_uniform", "walk_biased", "node2vec"):
        seeds, depth = args
        call = {"walk_uniform": pkg.mg_uniform_random_walks,
                "walk_biased": pkg.mg_biased_random_walks,
                "node2vec": pkg.mg_node2vec_random_walks}[fn]
        return {"paths": np.asarray(call(g, mesh, np.asarray(seeds), depth,
                                         **kw))}
    if fn == "has_edge":
        src, dst, _, n, _ = GRAPHS[case["graph"]]
        rng = np.random.default_rng(3)
        ss = np.concatenate([src, rng.integers(-1, n, 400)])
        dd = np.concatenate([dst, rng.integers(-1, n, 400)])
        return {"hits": np.asarray(mods["has_edge"](ss, dd))}
    if fn == "multihop":
        seeds, fanouts = args
        return {"panels": gather(pkg.mg_sample_multihop_device(
            g, mesh, np.asarray(seeds), fanouts, **kw))}
    if fn == "one_hop":
        seeds, k = args
        n = GRAPHS[case["graph"]][3]
        times = np.zeros(g.pad_v, np.float32)
        times[:n] = np.arange(n, dtype=np.float32) % 60
        frontier = np.unique(seeds)
        out = pkg.mg_sample_one_hop(g, mesh, frontier, k, frontier_times=times,
                                    **kw)
        rows = mods["rows"](mesh, tuple(p for p in out if p is not None),
                            frontier)
        return {f"rows/{i}": np.asarray(r) for i, r in enumerate(rows)}
    raise ValueError(fn)


class ReplayDraws:
    """``MGDraws`` replaying the JAX package's numbers.  ``tables`` maps a
    graph to its draws: "u" and "g" each ({(seed, salt): row}, [K, E_pad]
    float32), and "perm", this rank's JAX slot of each port edge;
    ``current`` names the graph of the running case."""

    tables: dict = {}
    current: str | None = None

    def __init__(self, device):
        self.device = torch.device(device)

    def _get(self, kind, seed, r, i, j, n):
        from cugraph_tpu_torch.parallel.algos import _ROUND_SALT, _wrap32

        tab = self.tables[self.current]
        salt = _wrap32(r * _ROUND_SALT[0] + i * _ROUND_SALT[1] + j)
        index, values = tab[kind]
        row = index.get((int(seed), salt))
        if row is None:
            raise KeyError(f"no {kind} draws were given for seed {seed}, "
                           f"round {r}, rank ({i}, {j})")
        perm = tab["perm"]
        if len(perm) != n:
            raise ValueError(f"{n} edges asked, the block has {len(perm)}")
        return torch.from_numpy(values[row][perm]).to(self.device)

    def edge_uniform(self, seed, r, i, j, n, low, high):
        if (low, high) != (1e-6, 1.0):
            raise ValueError(f"no replay of uniforms in [{low}, {high})")
        return self._get("u", seed, r, i, j, n)

    def edge_gumbel(self, seed, r, i, j, n):
        return self._get("g", seed, r, i, j, n)


def load_tables(path, rank):
    """``ReplayDraws.tables`` from the parent's ``.npz``: per graph the
    keys and values of both kinds and this rank's perm."""
    tables = {}
    with np.load(path) as z:
        for name in GRAPHS:
            if f"{name}/perm/{rank}" not in z:
                continue
            tab = {"perm": z[f"{name}/perm/{rank}"]}
            for kind in ("u", "g"):
                keys = z[f"{name}/{kind}_keys"]
                tab[kind] = ({(int(s), int(t)): k for k, (s, t) in
                              enumerate(keys)}, z[f"{name}/{kind}"])
            tables[name] = tab
    return tables


def _digest(out):
    h = hashlib.sha256()
    for k in sorted(out):
        h.update(k.encode())
        h.update(np.ascontiguousarray(out[k]).tobytes())
    return h.hexdigest()


def sampling_body(mesh, draws_path, names):
    """Every case of ``names`` on this rank, with the JAX package's draws
    replayed; returns "case/key" arrays and "case/same" (every rank's
    result the same)."""
    from cugraph_tpu_torch import parallel as tp
    from cugraph_tpu_torch.parallel import algos as palgos
    from cugraph_tpu_torch.parallel import sampling_mg as psm

    ReplayDraws.tables = load_tables(draws_path, mesh.rank)
    palgos.MGDraws = ReplayDraws
    graphs = {}
    out = {}

    def gather(panels):
        t = panels.permute(1, 0, 2).contiguous()
        full = tp.all_gather_vertex(mesh, t)
        return full.permute(1, 0, 2).numpy()

    for name in names:
        case = CASES[name]
        if case["graph"] not in graphs:
            graphs[case["graph"]] = build(tp, case["graph"], mesh)
        g = graphs[case["graph"]]
        ReplayDraws.current = case["graph"]
        mods = {"pkg": tp, "sampling_mg": psm, "rows": tp.sample_panel_rows,
                "has_edge": lambda ss, dd: tp.mg_has_edge(g, mesh, ss, dd)}
        res = run_case(case, g, mesh, mods, gather)
        got = [None] * mesh.size
        dist.all_gather_object(got, _digest(res), group=mesh.world)
        out[f"{name}/same"] = np.array(len(set(got)) == 1)
        out.update({f"{name}/{k}": v for k, v in res.items()})
    return out
