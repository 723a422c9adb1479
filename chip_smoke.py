#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cugraph_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
In order, and any failure exits non-zero:

1. prints the card (``nvidia-smi`` name and power limit, torch's name and
   device count);
2. builds every kernel under ``cugraph_tpu_torch/kernels/csrc`` with nvcc,
   one process per source, all started together;
3. holds each kernel against its plain PyTorch version on the card, on
   small edge cases and on the RMAT-20 CSC/CSR, and checks that two launches
   are bit-identical;
4. runs the main path through the public entry points: RMAT-20 edge factor
   16 (the graph of ``bench.py``) into ``Graph(directed=True)``, then
   ``pagerank`` twice and ``hits``, counting kernel launches, and checks the
   results against a float64 scipy.sparse power iteration;
5. times the power iteration, each kernel, its plain version and a PyTorch
   library call for the same product (CUDA events, after a warm-up), beside
   the least time the card could take for the same bytes and operations;
6. prints one ``{"kernels": [...]}`` line, then, last,
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of ``cugraph_tpu``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

SCALE = 20
EDGE_FACTOR = 16
RMAT_ABC = (0.57, 0.19, 0.19)
SEED = 7
# tolerances: the kernel sums in fp32 over a fixed order, the plain version
# in float64; the power iterations are held to a float64 reference
RTOL, ATOL_REL = 1e-5, 1e-6
L1_TOL = 1e-5
HITS_ITERS = 20
PAGERANK_TIMED_ITERS = 200  # N; N and 2N iterations are timed
TIMED_PAIRS = 5
KERNEL_TIMED_LAUNCHES = 100
# NVIDIA H100 SXM data sheet: HBM3 rate and fp32 rate outside tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
SOURCE = "cugraph_tpu_torch/kernels/csrc/spmv_csr.cu"
REPLACES = "cugraph_tpu/kernels/spmv_onehot.py:398"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def build_kernels():
    from cugraph_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    names = _build.sources()
    _build.build(names)
    print(f"built {names} in {time.perf_counter() - t0:.2f} s")
    for name in names:
        print(_build.BUILD_LOG.get(name, f"{name}: already built").strip())
        cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()),
                                 "cuobjdump")
        if os.path.exists(cuobjdump):
            elf = subprocess.run([cuobjdump, "--list-elf",
                                  _build.library_path(name)],
                                 capture_output=True, text=True, timeout=60)
            print(elf.stdout.strip())


# -- phase 3: each kernel against its plain version --------------------------

def _csr_case(n, src, dst, w, device):
    from cugraph_tpu_torch.core.structure import build_csr

    return build_csr(dst, src, w, n, device)


def small_cases(device):
    """(name, CsrMatrix) edge cases: self-loops and parallel edges,
    isolated vertices, no edges, no vertices."""
    rng = np.random.default_rng(0)
    n_iso = 50
    src_iso = rng.integers(0, 10, 200)
    dst_iso = rng.integers(0, 10, 200)
    return [
        ("tiny", _csr_case(3, np.array([0, 0, 0, 2, 2, 1]),
                           np.array([1, 1, 0, 2, 2, 1]),
                           np.arange(1, 7, dtype=np.float32), device)),
        ("isolated", _csr_case(n_iso, src_iso, dst_iso,
                               rng.random(200).astype(np.float32), device)),
        ("random", _csr_case(300, rng.integers(0, 300, 2000),
                             rng.integers(0, 300, 2000),
                             rng.random(2000).astype(np.float32), device)),
        ("empty", _csr_case(7, np.zeros(0, np.int64), np.zeros(0, np.int64),
                            None, device)),
        ("no_vertices", _csr_case(0, np.zeros(0, np.int64),
                                  np.zeros(0, np.int64), None, device)),
    ]


def check_kernel(name, adj, combine, weights=None, seed=0):
    """Kernel vs plain version on the card; returns the max abs error."""
    import torch

    from cugraph_tpu_torch.kernels.spmv import spmv_csr, spmv_csr_reference

    w = adj.weights if weights is None else weights
    x = torch.from_numpy(np.random.default_rng(seed).random(
        adj.num_vertices, dtype=np.float32)).to(adj.device)
    y1 = spmv_csr(adj.offsets, adj.indices, w, x, combine)
    y2 = spmv_csr(adj.offsets, adj.indices, w, x, combine)
    ref = spmv_csr_reference(adj.offsets, adj.indices, w, x, combine)
    torch.cuda.synchronize()
    if not torch.equal(y1.view(torch.int32), y2.view(torch.int32)):
        raise AssertionError(f"{name}/{combine}: two launches differ")
    if y1.shape != ref.shape or not bool(torch.isfinite(y1).all()):
        raise AssertionError(f"{name}/{combine}: bad output")
    err = (y1 - ref).abs()
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    bad = err > RTOL * ref.abs() + ATOL_REL * scale
    if bool(bad.any()):
        raise AssertionError(
            f"{name}/{combine}: {int(bad.sum())} rows off, max err "
            f"{float(err.max()):.3e} (max|y| {scale:.3e})")
    max_err = float(err.max()) if err.numel() else 0.0
    print(f"kernel check {name:>12s} {combine:4s}: n={adj.num_vertices} "
          f"m={adj.num_edges} max_abs_err={max_err:.3e} "
          f"(rtol {RTOL}, atol {ATOL_REL}*max|y|={ATOL_REL * scale:.3e}), "
          "two launches bit-identical")
    return max_err


# -- phase 4: the main path and its float64 reference ------------------------

def build_graph(device):
    from cugraph_tpu_torch import Graph, rmat

    t0 = time.perf_counter()
    a, b, c = RMAT_ABC
    edges = rmat(SCALE, EDGE_FACTOR << SCALE, a=a, b=b, c=c, seed=SEED)
    t1 = time.perf_counter()
    G = Graph(directed=True, device=device)
    G.from_edgelist(edges, "src", "dst")
    t2 = time.perf_counter()
    g = G.structure
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    print(f"RMAT-{SCALE} ef{EDGE_FACTOR} seed {SEED}: n={g.num_vertices} "
          f"m={g.num_edges} max in-degree {int(g.in_degrees().max())}; "
          f"host set-up: rmat {t1 - t0:.1f} s, Graph {t2 - t1:.1f} s, "
          f"CSR/CSC on {device} {t3 - t2:.1f} s")
    return G


def reference_matrix(G):
    import scipy.sparse as sp

    src, dst, w = G.edgelist_arrays()
    n = G.number_of_vertices()
    vals = np.ones(len(src)) if w is None else w.astype(np.float64)
    return sp.csr_matrix((vals, (src, dst)), shape=(n, n))


def pagerank_reference(A, max_iter, tol, alpha=0.85):
    """float64 power iteration with pagerank's loop and stopping rule;
    returns (p, iterations)."""
    n = A.shape[0]
    At = A.T.tocsr()
    out_w = np.asarray(A.sum(axis=1)).ravel()
    dangling = out_w <= 0
    inv_out = np.divide(1.0, out_w, out=np.zeros(n), where=~dangling)
    reset = np.full(n, 1.0 / n)
    p, err, it = reset.copy(), np.inf, 0
    while err >= tol and it < max_iter:
        p_new = alpha * (At @ (p * inv_out) + p[dangling].sum() * reset) \
            + (1 - alpha) * reset
        err = np.abs(p_new - p).sum()
        p, it = p_new, it + 1
    return p, it


def hits_reference(A, max_iter, tol):
    n = A.shape[0]
    At = A.T.tocsr()
    h, a = np.full(n, 1.0 / n), np.zeros(n)
    err, it = np.inf, 0
    while err >= tol and it < max_iter:
        a = At @ h
        a /= max(np.abs(a).max(), 1e-30)
        h_new = A @ a
        h_new /= max(np.abs(h_new).max(), 1e-30)
        err = np.abs(h_new - h).sum()
        h, it = h_new, it + 1
    return h / max(h.sum(), 1e-30), a / max(a.sum(), 1e-30), it


def _by_internal_id(G, df, col):
    out = np.zeros(G.number_of_vertices())
    out[G.lookup_internal_vertex_id(df["vertex"].to_numpy())] = \
        df[col].to_numpy()
    return out


def _hold(label, got, want):
    l1 = float(np.abs(got - want).sum())
    if not (np.isfinite(got).all() and l1 <= L1_TOL):
        raise AssertionError(f"{label}: L1 {l1:.3e} > {L1_TOL}")
    print(f"{label}: L1 vs float64 reference {l1:.3e} (<= {L1_TOL}), "
          f"sum {got.sum():.7f}")
    return l1


def main_path(G):
    """Runs pagerank twice and hits, with the launch counts set to 0 just
    before and read just after; returns the counts by combine mode."""
    from cugraph_tpu_torch import hits, pagerank
    from cugraph_tpu_torch.kernels import spmv

    spmv.LAUNCHES = 0
    spmv.LAUNCHES_BY_COMBINE.update(mul=0, left=0)
    pr_default = pagerank(G)
    k_default = spmv.LAUNCHES
    pr_100, converged = pagerank(G, max_iter=100, tol=0.0,
                                 fail_on_nonconvergence=False)
    k_100 = spmv.LAUNCHES - k_default
    # tol=0 fixes the iteration count: at this size the float32 L1 change
    # of the max-normalized hubs stays above the default tol of 1e-5
    hub_auth = hits(G, max_iter=HITS_ITERS, tol=0.0)
    k_hits = spmv.LAUNCHES - k_default - k_100
    counts = dict(spmv.LAUNCHES_BY_COMBINE)

    A = reference_matrix(G)
    p_ref, it_ref = pagerank_reference(A, 100, float(np.float32(1e-5)))
    if k_default != it_ref:
        raise AssertionError(f"pagerank(G): {k_default} launches, the "
                             f"reference converged in {it_ref} iterations")
    pr = _by_internal_id(G, pr_default, "pagerank")
    _hold(f"pagerank(G) default tol, {k_default} iterations = launches",
          pr, p_ref)
    if abs(pr.sum() - 1.0) > L1_TOL:
        raise AssertionError(f"pagerank sums to {pr.sum()}")
    if k_100 != 100 or converged:
        raise AssertionError(f"pagerank(max_iter=100, tol=0): {k_100} "
                             f"launches, converged={converged}")
    p_ref, _ = pagerank_reference(A, 100, 0.0)
    _hold("pagerank(G, max_iter=100, tol=0), 100 iterations = launches",
          _by_internal_id(G, pr_100, "pagerank"), p_ref)
    h_ref, a_ref, it_h = hits_reference(A, HITS_ITERS, 0.0)
    if k_hits != 2 * it_h:
        raise AssertionError(f"hits: {k_hits} launches for {it_h} "
                             "iterations, expected 2 per iteration")
    _hold(f"hits(G, max_iter={HITS_ITERS}, tol=0) hubs, {it_h} iterations, "
          f"{k_hits} launches", _by_internal_id(G, hub_auth, "hubs"), h_ref)
    _hold("hits authorities", _by_internal_id(G, hub_auth, "authorities"),
          a_ref)
    print(f"main-path launches by mode: {counts} "
          f"(pagerank {k_default} + {k_100}, hits {k_hits})")
    return counts


# -- phase 5: timing -----------------------------------------------------------

def _cuda_ms(fn, repeats):
    """Mean ms of ``fn`` over ``repeats`` calls, CUDA events, after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def time_power_iteration(G, card):
    from cugraph_tpu_torch import pagerank

    n_it = PAGERANK_TIMED_ITERS
    m = G.number_of_edges()

    def run(iters):
        return lambda: pagerank(G, max_iter=iters, tol=0.0,
                                fail_on_nonconvergence=False)

    # the difference cancels the per-call set-up; the median of the pairs
    # resists the host's jitter, which the per-iteration .item() exposes
    diffs = []
    for _ in range(TIMED_PAIRS):
        t1 = _cuda_ms(run(n_it), 1)
        t2 = _cuda_ms(run(2 * n_it), 1)
        diffs.append((t2 - t1) / n_it)
    per_iter = float(np.median(diffs))
    row = {"metric": f"pagerank_rmat{SCALE}_ef{EDGE_FACTOR}_ms_per_iteration",
           "ms_per_iteration": per_iter, "ms_per_iteration_runs": diffs,
           "edges_per_s": m / (per_iter * 1e-3),
           "generated_edges_per_s": (EDGE_FACTOR << SCALE) / (per_iter * 1e-3),
           "n": G.number_of_vertices(), "m": m, "card": card}
    print(json.dumps(row))
    return row


def _device_ms_by_name(G, iters):
    """Device time of one pagerank call by kernel name (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cugraph_tpu_torch import pagerank

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pagerank(G, max_iter=iters, tol=0.0, fail_on_nonconvergence=False)
        torch.cuda.synchronize()
    by_name = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            key = evt.name[:60]
            by_name[key] = by_name.get(key, 0.0) + \
                evt.time_range.elapsed_us() / 1e3
    return by_name


def profile_power_iteration(G, card, ms_per_iteration):
    """Device time per power iteration by kernel name, as the difference of
    a 2N- and an N-iteration call (which cancels the per-call set-up), and
    the device's idle share against the unprofiled iteration time."""
    n_it = 20
    _device_ms_by_name(G, 2)  # warm-up
    one = _device_ms_by_name(G, n_it)
    two = _device_ms_by_name(G, 2 * n_it)
    per_iter = {k: (two.get(k, 0.0) - one.get(k, 0.0)) / n_it
                for k in set(one) | set(two)}
    busy = sum(per_iter.values())
    top = dict(sorted(per_iter.items(), key=lambda kv: -kv[1])[:8])
    seen = bool(one and two)
    row = {"profile": f"pagerank_rmat{SCALE}_ef{EDGE_FACTOR}",
           "iterations": [n_it, 2 * n_it],
           "device_ms_per_iteration": busy if seen else "not measured",
           "device_ms_per_iteration_by_kernel": top,
           "ms_per_iteration_unprofiled": ms_per_iteration,
           "device_idle_share": (1 - busy / ms_per_iteration) if seen
           else "not measured", "card": card}
    print(json.dumps(row))
    return row


def bound_ms(n, m, combine):
    """Least time for one launch: each input read once and the output
    written once at the HBM rate, or the flops at the fp32 rate."""
    bytes_moved = (8 if combine == "mul" else 4) * m + 12 * n
    flops = (2 if combine == "mul" else 1) * m
    return max(bytes_moved / PEAK_BYTES_PER_S, flops / PEAK_FP32_PER_S) * 1e3


def time_kernel(adj, combine, card):
    import torch

    from cugraph_tpu_torch.kernels.spmv import spmv_csr, spmv_csr_reference

    n, m = adj.num_vertices, adj.num_edges
    x = torch.from_numpy(np.random.default_rng(1).random(
        n, dtype=np.float32)).to(adj.device)
    w = adj.weights if combine == "mul" else None
    ms = _cuda_ms(lambda: spmv_csr(adj.offsets, adj.indices, w, x, combine),
                  KERNEL_TIMED_LAUNCHES)
    plain_ms = _cuda_ms(lambda: spmv_csr_reference(
        adj.offsets, adj.indices, adj.weights, x, combine), 10)
    values = adj.weights if combine == "mul" else torch.ones_like(adj.weights)
    with warnings.catch_warnings():  # "beta" and invariant-check notices
        warnings.simplefilter("ignore", UserWarning)
        A = torch.sparse_csr_tensor(adj.offsets, adj.indices, values, (n, n),
                                    check_invariants=False)
    library_ms = _cuda_ms(lambda: A @ x, KERNEL_TIMED_LAUNCHES)
    row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms(n, m, combine),
           "bound_by": "bytes", "library_ms": library_ms}
    print(f"spmv_csr_sum_{combine} at the pull shape n={n} m={m}: "
          + json.dumps(row) + f" [{card}]")
    return row


def time_kernel_without_heaviest(adj, card):
    """Diagnostic for the tail: K1 on the same CSC with its k heaviest rows
    (the lowest ids, after degree-descending renumbering) emptied."""
    import torch

    from cugraph_tpu_torch.kernels.spmv import spmv_csr

    n, m = adj.num_vertices, adj.num_edges
    x = torch.rand(n, device=adj.device)
    for k in (1, 32, 1024):
        start = int(adj.offsets[k])
        offsets = torch.cat([torch.zeros(k, dtype=torch.int32,
                                         device=adj.device),
                             adj.offsets[k:] - start])
        indices = adj.indices[start:]
        weights = adj.weights[start:]
        ms = _cuda_ms(lambda: spmv_csr(offsets, indices, weights, x, "mul"),
                      KERNEL_TIMED_LAUNCHES)
        print(json.dumps({"diagnostic": "spmv_csr_sum_mul without the "
                          f"{k} heaviest rows", "ms": ms,
                          "edges_left": m - start,
                          "bound_ms": bound_ms(n, m - start, "mul"),
                          "card": card}))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from cugraph_tpu_torch.kernels import spmv

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(card)
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); "
          f"device 0: {kind}; device count {count}")
    device = torch.device("cuda")

    build_kernels()

    for name, adj in small_cases(device):
        for combine in ("mul", "left"):
            check_kernel(name, adj, combine)

    G = build_graph(device)
    g = G.structure
    max_err = {}
    for combine in ("mul", "left"):
        max_err[combine] = check_kernel(f"rmat{SCALE} csc", g.csc, combine)
        check_kernel(f"rmat{SCALE} csr", g.csr, combine)
    w_rand = torch.from_numpy(np.random.default_rng(2).uniform(
        0.5, 1.5, g.num_edges).astype(np.float32)).to(device)
    check_kernel(f"rmat{SCALE} csc w", g.csc, "mul", weights=w_rand)

    counts = main_path(G)
    if counts["mul"] == 0:
        raise AssertionError("the main path launched spmv_csr_sum_mul no time")

    per_iter = time_power_iteration(G, card)["ms_per_iteration"]
    profile_power_iteration(G, card, per_iter)
    kernels = []
    for combine in ("mul", "left"):
        row = time_kernel(g.csc, combine, card)
        kernels.append({"name": f"spmv_csr_sum_{combine}", "route": "cuda",
                        "source": SOURCE, "replaces": REPLACES,
                        "launches": counts[combine],
                        "max_abs_err": max_err[combine], **row})
    time_kernel_without_heaviest(g.csc, card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
