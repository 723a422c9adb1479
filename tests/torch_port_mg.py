"""gloo worlds for the multi-device port's tests, and the bodies they run.

``run_worlds`` spawns one process per rank (the ``spawn`` context) for
each world, every world at once; each brings up a gloo group over a file
store in the test's directory (no port, safe under xdist), builds a
``make_mesh_2d(pmaj, pmin, device="cpu")`` and runs one body on every
rank; rank 0 writes the body's arrays to an ``.npz``, which the
parametrised tests then read.  A body gathers what it returns
(``all_gather_vertex``), so every array is the JAX package's global
[pad_v] layout.  Every world has a join deadline and a gloo timeout, and a
failed or late world kills its ranks and raises with their tracebacks.

The graphs are ``tests/test_parallel.py``'s (``_random_coo``, n = 150,
m = 900, weighted and not; the dangling star of ``:88-99``) and
``tests/_mp_worker.py``'s skewed graph, whose edges lie in the first
third of the ids, so that ranks hold empty blocks.  This module imports
only torch, NumPy and the port.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import time
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist

WORLDS = [(2, 2), (2, 1), (1, 2)]
JOIN_SECONDS = 120
GLOO_TIMEOUT = datetime.timedelta(seconds=60)


# ---------------------------------------------------------------------------
# the graphs
# ---------------------------------------------------------------------------

def random_coo(n=150, m=900, seed=0, weighted=True):
    """``tests/test_parallel.py::_random_coo``: no self-loops, no
    multi-edges, weights in [0.5, 2.0]."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int64)
    dst = rng.integers(0, n, m).astype(np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    uniq = np.unique(src * n + dst)
    src, dst = (uniq // n).astype(np.int64), (uniq % n).astype(np.int64)
    w = (rng.uniform(0.5, 2.0, len(src)).astype(np.float32) if weighted
         else None)
    return src, dst, w, n


def star_coo():
    """A star and a chain with dangling ends; vertex 7 isolated."""
    return (np.array([0, 0, 0, 1, 2, 5], np.int64),
            np.array([1, 2, 3, 4, 4, 6], np.int64), None, 8)


def skew_coo(n=240, m=2000, seed=0):
    """``_mp_worker.py``'s skewed graph: every edge among the first n // 3
    ids, weights in [0.5, 2.0]."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n // 3, m)
    dst = rng.integers(0, n // 3, m)
    keep = src != dst
    key = np.unique(src[keep] * n + dst[keep])
    src, dst = (key // n).astype(np.int64), (key % n).astype(np.int64)
    w = rng.uniform(0.5, 2.0, len(src)).astype(np.float32)
    return src, dst, w, n


def symmetric(src, dst, n):
    """Both directions of every pair, each once (eigenvector's graph)."""
    key = np.unique(np.concatenate([src * n + dst, dst * n + src]))
    return key // n, key % n


def prims_inputs(pad_v, pmaj, pmin):
    """Global arrays for the prims cases, rank r taking its P-th: x
    [pad_v], x2 [pad_v, 3], a dst-slot partial [P·pmaj·Vc] and a
    row-block partial [P·pmin·Vc]."""
    p, chunk = pmaj * pmin, pad_v // (pmaj * pmin)
    x = np.sin(np.arange(pad_v, dtype=np.float32))
    x2 = np.stack([x, np.cos(x), 2 * x], axis=1)
    part = np.cos(np.arange(p * pmaj * chunk, dtype=np.float32))
    part2 = np.sin(np.arange(p * pmin * chunk, dtype=np.float32) * 0.7)
    return x, x2, part, part2


# 0 -> 1 (w 1) and a zero-weight cycle 1 <-> 2, then 2 -> 3 (w 0) and
# 3 -> 4 (w 1): the largest-u rule of the exact test alone makes 1 and 2
# each other's parent
CYCLE = (np.array([0, 1, 2, 2, 3], np.int64),
         np.array([1, 2, 1, 3, 4], np.int64),
         np.array([1.0, 0.0, 0.0, 0.0, 1.0], np.float32), 5)

GRAPHS = {
    "weighted": random_coo(seed=1),
    "unweighted": random_coo(seed=2, weighted=False),
    "star": star_coo(),
    "skew": skew_coo(),
}


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------

def _rank_main(rank, world, store, pmaj, pmin, body, args, out_dir):
    try:
        warnings.filterwarnings("ignore", category=FutureWarning)
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                timeout=GLOO_TIMEOUT)
        from cugraph_tpu_torch.parallel import make_mesh_2d

        mesh = make_mesh_2d(pmaj, pmin, device="cpu")
        out = body(mesh, *args)
        if rank == 0:
            np.savez(os.path.join(out_dir, "result.npz"),
                     **{k: np.asarray(v) for k, v in out.items()})
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def run_worlds(out_dir, body, jobs) -> dict:
    """Runs ``body(mesh, *args)`` on a pmaj × pmin gloo world of spawned
    processes for each ``(pmaj, pmin): args`` of ``jobs``, every world's
    ranks started together; returns each world's rank-0 arrays by shape.
    ``body`` and ``args`` must pickle (a module-level function of this
    module)."""
    ctx = multiprocessing.get_context("spawn")
    started = []
    for (pmaj, pmin), args in jobs.items():
        run_dir = os.path.join(str(out_dir), f"{pmaj}x{pmin}")
        os.makedirs(run_dir)
        procs = [ctx.Process(target=_rank_main, args=(
            r, pmaj * pmin, os.path.join(run_dir, "store"), pmaj, pmin, body,
            args, run_dir)) for r in range(pmaj * pmin)]
        for p in procs:
            p.start()
        started.append(((pmaj, pmin), run_dir, procs))
    deadline = time.monotonic() + JOIN_SECONDS
    procs = [p for *_, ps in started for p in ps]
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.1))
    finally:
        late = [p for p in procs if p.is_alive()]
        for p in late:
            p.kill()
            p.join(10)
    errors = []
    for (pmaj, pmin), run_dir, ps in started:
        for r, p in enumerate(ps):
            path = os.path.join(run_dir, f"error_{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"{pmaj}x{pmin} rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                errors.append(f"{pmaj}x{pmin} rank {r}: exit code "
                              f"{p.exitcode}")
    if late or errors:
        raise RuntimeError(f"{len(late)} rank(s) past the {JOIN_SECONDS} s "
                           "deadline\n" + "\n".join(errors))
    out = {}
    for shape, run_dir, _ in started:
        with np.load(os.path.join(run_dir, "result.npz")) as z:
            out[shape] = {k: z[k] for k in z.files}
    return out


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


# ---------------------------------------------------------------------------
# bodies: each runs on every rank and returns the arrays to compare
# ---------------------------------------------------------------------------

def mesh_body(mesh):
    """Each rank's coordinates, position and group memberships."""
    from cugraph_tpu_torch.parallel.prims import all_reduce

    me = torch.tensor([mesh.i, mesh.j, mesh.rank, dist.get_rank()],
                      dtype=torch.int64)
    out = me.new_empty(4 * mesh.size)
    dist.all_gather_into_tensor(out, me, group=mesh.world)
    one = torch.ones(1, dtype=torch.int64)
    return {"coords": out.view(mesh.size, 4),
            "row_size": all_reduce(one, mesh.minor),
            "col_size": all_reduce(one, mesh.major)}


def algos_body(mesh, graphs):
    """Every vertex program on every graph, gathered, and every shard
    primitive on ``prims_inputs``."""
    from cugraph_tpu_torch.parallel import (all_gather_vertex,
                                            build_dist_graph, mg_bfs,
                                            mg_degrees,
                                            mg_eigenvector_centrality,
                                            mg_hits, mg_katz_centrality,
                                            mg_pagerank, mg_sssp, mg_wcc,
                                            prims)

    out = {}

    def keep(name, *values):
        for k, v in enumerate(values):
            out[f"{name}/{k}"] = _np(all_gather_vertex(mesh, v)
                                     if isinstance(v, torch.Tensor) else v)

    for name, (src, dst, w, n) in graphs.items():
        g = build_dist_graph(src, dst, w, n, mesh, store_push=True)
        keep(f"{name}/pagerank", *mg_pagerank(g, mesh, tol=1e-6,
                                              max_iter=200))
        keep(f"{name}/katz", *mg_katz_centrality(g, mesh, alpha=0.01,
                                                 tol=1e-5, max_iter=500))
        keep(f"{name}/hits", *mg_hits(g, mesh, tol=1e-4, max_iter=300))
        keep(f"{name}/degrees", *mg_degrees(g, mesh))
        keep(f"{name}/bfs", *mg_bfs(g, mesh, int(src[0])))
        keep(f"{name}/sssp", *mg_sssp(g, mesh, int(src[0])))
        keep(f"{name}/wcc", mg_wcc(g, mesh))
        x, x2, part, part2 = (
            torch.from_numpy(a[mesh.rank * len(a) // mesh.size:
                               (mesh.rank + 1) * len(a) // mesh.size])
            for a in prims_inputs(g.pad_v, mesh.pmaj, mesh.pmin))
        keep(f"{name}/spmv", prims.pull_spmv(mesh, g.pull, x),
             prims.pull_spmv_systolic(mesh, g.pull, x),
             prims.pull_transform_reduce(
                 mesh, g.pull, x, lambda xs, e: xs * g.pull.weights[e],
                 op="max", identity=-5.0),
             prims.pull_spmm(mesh, g.pull, x2),
             prims.gather_minor_block(mesh, x),
             prims.gather_major_block(mesh, x),
             prims.scatter_reduce_major_sum(mesh, part),
             prims.scatter_reduce_major(mesh, part, g.chunk, "min"),
             prims.scatter_reduce_major(mesh, part, g.chunk, "max"),
             prims.scatter_reduce_minor_sum(mesh, part2),
             prims.global_vertex_ids(mesh, g.chunk),
             prims.psum_all(mesh, torch.tensor(mesh.rank + 1.0)).item())
        s2, d2 = symmetric(src, dst, n)
        gs = build_dist_graph(s2, d2, None, n, mesh, store_push=False)
        keep(f"{name}/eigenvector", *mg_eigenvector_centrality(
            gs, mesh, tol=1e-6, max_iter=500))
    src, dst, w, n = graphs["weighted"]
    g = build_dist_graph(src, dst, w, n, mesh, store_push=True)
    pers = np.zeros(n, np.float32)
    pers[[3, 7, 11]] = [1.0, 2.0, 3.0]
    keep("options/pagerank", *mg_pagerank(
        g, mesh, alpha=0.7, tol=1e-6, personalization=pers,
        nstart=np.linspace(1.0, 2.0, n)))
    keep("options/hits", *mg_hits(g, mesh, tol=1e-4, normalized=False,
                                  nstart=np.linspace(1.0, 2.0, n)))
    keep("options/katz", *mg_katz_centrality(g, mesh, alpha=0.01,
                                             normalized=False))
    keep("options/bfs", *mg_bfs(g, mesh, [int(src[0]), int(dst[5]), -1],
                                depth_limit=2))
    keep("options/sssp", *mg_sssp(g, mesh, int(src[0]), cutoff=2.5))
    # zero-weight edges: the port's tree rule, not the JAX package's
    # exact-equality one
    wz = w.copy()
    wz[::3] = 0.0
    gz = build_dist_graph(src, dst, wz, n, mesh, store_push=True)
    keep("zero/sssp", *mg_sssp(gz, mesh, int(src[0])))
    cs, cd, cw, cn = CYCLE
    gc = build_dist_graph(cs, cd, cw, cn, mesh, store_push=True)
    keep("cycle/sssp", *mg_sssp(gc, mesh, 0))
    return out


def _pad(a, rows):
    out = np.zeros((rows,) + a.shape[1:], a.dtype)
    out[:len(a)] = a
    return out


def nn_body(mesh, graphs, x, labels, mask, params, steps):
    """Per graph: the GNN layers' forward passes on owned slices
    (``x`` [n, F], ``labels`` and ``mask`` [n], zero-padded to pad_v),
    gathered; ``steps`` MG GraphSAGE Adam steps from ``params["sage"]``;
    and the input gradient of a squared GAT output."""
    from cugraph_tpu_torch.parallel import all_gather_vertex, \
        build_dist_graph
    from cugraph_tpu_torch.parallel import nn as pnn
    from cugraph_tpu_torch.parallel.prims import all_reduce

    out = {}
    ps = pnn.replicate(mesh, params)
    for name, (src, dst, w, n) in graphs.items():
        g = build_dist_graph(src, dst, w, n, mesh, store_push=False)
        xo, lo, mo = pnn.shard_vertex_data(
            mesh, _pad(x[:n], g.pad_v), _pad(labels[:n], g.pad_v),
            _pad(mask[:n], g.pad_v))

        def keep(key, t):
            out[f"{name}/{key}"] = _np(all_gather_vertex(mesh, t))

        keep("sage", pnn.mg_graphsage_apply(ps["sage"], g, mesh, xo))
        keep("gcn", pnn.mg_gcn_apply(ps["gcn"], g, mesh, xo))
        keep("gat", pnn.mg_gat_conv(ps["gat"], g, mesh, xo))
        keep("gatv2", pnn.mg_gatv2_conv(ps["gatv2"], g, mesh, xo))
        keep("gin", pnn.mg_gin_conv(ps["gin"], g, mesh, xo))
        keep("appnp", pnn.mg_appnp_propagate(g, mesh, xo, alpha=0.15, k=4))
        keep("mean", pnn.mg_aggregate_mean(g, mesh, xo))
        keep("sum", pnn.mg_aggregate_sum(g, mesh, xo))
        keep("sage_conv", pnn.mg_sage_conv(ps["sage"][0], g, mesh, xo))
        keep("gcn_conv", pnn.mg_gcn_conv(ps["gcn"][0], g, mesh, xo))
        logits = pnn.mg_graphsage_apply(ps["sage"], g, mesh, xo)
        out[f"{name}/ce"] = np.array(all_reduce(
            pnn.mg_masked_cross_entropy(logits, lo, mo, mesh),
            mesh.world).item())

        step = pnn.make_mg_train_step(
            g, mesh, lambda leaves: torch.optim.Adam(leaves, lr=1e-2))
        p, opt, losses = ps["sage"], None, []
        for _ in range(steps):
            p, opt, loss = step(p, opt, xo, lo, mo)
            losses.append(float(loss))
        out[f"{name}/losses"] = np.array(losses)
        for k, layer in enumerate(p):
            for key, t in layer.items():
                out[f"{name}/weights/{k}/{key}"] = _np(t)
        xg = xo.clone().requires_grad_(True)
        pnn.mg_gat_conv(ps["gat"], g, mesh, xg).square().sum().backward()
        keep("gat_grad", xg.grad)
    return out


def construct_body(mesh, cases, rn, ing, shuffle_cases):
    """The sharded build and renumbering of each case's chunks (every
    rank's block gathered by position), the lookups, and the shuffle."""
    from cugraph_tpu_torch.parallel import (all_gather_vertex,
                                            build_dist_graph,
                                            build_dist_graph_from_chunks,
                                            build_dist_graph_sharded,
                                            mg_pagerank,
                                            renumber_edgelist_sharded,
                                            shuffle_reduce_by_key,
                                            shuffle_to_owners)
    from cugraph_tpu_torch.parallel.partition import Partition2D

    from cugraph_tpu_torch.parallel import allgather_scalars

    out = {f"mesh/{k}": v for k, v in mesh_body(mesh).items()}
    out["allgather_scalars"] = allgather_scalars(mesh, (mesh.rank + 1) << 33)

    def blocks(name, b):
        for field in ("offsets", "indices", "weights", "etype", "etime"):
            t = getattr(b, field)
            if t is None:
                continue
            got = [None] * mesh.size
            dist.all_gather_object(got, _np(t), group=mesh.world)
            for r, a in enumerate(got):
                out[f"{name}/{r}/{field}"] = a

    for name, (chunks, n, flags) in cases.items():
        g, stats = build_dist_graph_sharded(
            mesh, chunks["src"], chunks["dst"], chunks.get("w"),
            num_vertices=n, store_push=True,
            edge_type_chunks=chunks.get("etype"),
            edge_time_chunks=chunks.get("etime"), **flags)
        blocks(f"{name}/pull", g.pull)
        blocks(f"{name}/push", g.push)
        out[f"{name}/out_degree"] = _np(all_gather_vertex(mesh, g.out_degree))
        out[f"{name}/in_degree"] = _np(all_gather_vertex(mesh, g.in_degree))
        out[f"{name}/meta"] = np.array([g.num_edges, g.chunk, stats[
            "max_device_buffer_elems"]])

    # renumbering: this rank's chunk of the pooled external ids
    si, di, nmap = renumber_edgelist_sharded(mesh, rn["src"], rn["dst"])
    pos = mesh.rank
    out["renumber/src"] = np.concatenate(_all(mesh, si))
    out["renumber/dst"] = np.concatenate(_all(mesh, di))
    out["renumber/n"] = np.array(nmap.num_vertices)
    out["renumber/to_external"] = np.concatenate(_all(mesh, np.concatenate(
        [nmap.to_external(si), nmap.to_external(di)])))
    out["renumber/to_internal"] = np.concatenate(_all(
        mesh, nmap.to_internal(rn["src"][pos])))
    out["renumber/contains"] = nmap.contains(
        np.array([rn["src"][0][0], 1 << 60])) if len(rn["src"][0]) else \
        np.array([True, False])
    for label, call in (("to_internal", lambda: nmap.to_internal(
            np.array([1 << 60]))),
            ("to_external", lambda: nmap.to_external(
                np.array([nmap.num_vertices])))):
        try:
            call()
            out[f"renumber/raises/{label}"] = np.array(False)
        except ValueError:
            out[f"renumber/raises/{label}"] = np.array(True)

    # the whole ingest: external ids → renumber → build → PageRank
    g, nm, _ = build_dist_graph_from_chunks(
        mesh, ing["src"], ing["dst"], ing["w"], store_push=True)
    pr, _, _ = mg_pagerank(g, mesh)
    out["ingest/pagerank"] = _np(all_gather_vertex(mesh, pr))
    ext = np.sort(np.unique(np.concatenate(ing["src"] + ing["dst"])))
    out["ingest/ids"] = nm.to_internal(ext)

    # the shuffle, each rank its contiguous slice of the global keys
    for name, (keys, payload, n, op) in shuffle_cases.items():
        part = Partition2D.create(n, mesh.pmaj, mesh.pmin)
        per = len(keys) // mesh.size
        mine = slice(mesh.rank * per, (mesh.rank + 1) * per)
        if op is None:
            ko, po = shuffle_to_owners(mesh, part, keys[mine],
                                       payload[mine], capacity=8)
            got = [None] * mesh.size
            dist.all_gather_object(got, (_np(ko), _np(po)), group=mesh.world)
            for r, (k, p) in enumerate(got):
                out[f"shuffle/{name}/{r}/keys"] = k
                out[f"shuffle/{name}/{r}/payload"] = p
        else:
            red = shuffle_reduce_by_key(mesh, part, keys[mine],
                                        payload[mine], op=op)
            out[f"shuffle/{name}"] = _np(all_gather_vertex(mesh, red))
    # the host build on the same mesh, for the replicated-input path
    src, dst, w, n = GRAPHS["skew"]
    g = build_dist_graph(src, dst, w, n, mesh)
    blocks("host_skew/pull", g.pull)
    return out


def _all(mesh, a):
    got = [None] * mesh.size
    dist.all_gather_object(got, np.asarray(a), group=mesh.world)
    return got
