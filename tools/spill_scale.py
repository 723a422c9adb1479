#!/usr/bin/env python3
"""The host-spill streamed SpMV (``kernels/spill.py``) at a size that needs it.

    python3 tools/spill_scale.py [scale] [budget_bytes] [--resident]

Run from the repository root on a machine with a CUDA card and g++ (the
native R-MAT generator builds at first use).  Generates the R-MAT edge list
at ``scale`` (26 by default; edge factor 16, a/b/c .57/.19/.19, seed 7, as
``chip_smoke.py``), unweighted, and builds the spilled plan straight from
it: 2^scale vertices, no renumbering, duplicate edges kept.  The chunks
are a quarter of ``budget_bytes`` (default: ``kernels/dispatch``'s, half
the card's memory), at least 1 MiB.  Then runs ``ITERS`` PageRank power
iterations (alpha 0.85, tol 0) whose pull is ``spmv_spilled``, timed with
CUDA events after one warm-up iteration, and reads the peak device memory
above the loop's start.  With ``--resident`` it also builds the CSC on the
card (``core/structure.build_csr``) and holds one spilled SpMV against the
resident K1 bit for bit, and times K1 there.

Before it generates anything it reads MemAvailable from /proc/meminfo and
stops (exit 3) when the host's estimated peak, HOST_BYTES_PER_EDGE bytes an
edge, does not fit in 90 % of it.  Prints the card, the host memory, and
one JSON line with the plan build seconds, the pinned GB, the chunks, ms
per iteration, the stream's GB/s, the peak device memory and the
process's peak resident host memory.
"""

import json
import os
import resource
import sys
import time

import numpy as np

ITERS = 10
ALPHA = 0.85
# the host's peak while the plan is built, per generated edge: the int32
# edge list (8), the int64 key and its sorted copy and order (24), the
# sort's scratch (16) and the pinned CSC (8)
HOST_BYTES_PER_EDGE = 56


def _mem_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def _cuda_ms(torch, fn, repeats):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("spill_scale: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs

    from cugraph_tpu_torch.core.structure import build_csr
    from cugraph_tpu_torch.generators.rmat import _rmat_host
    from cugraph_tpu_torch.kernels import dispatch, spmv
    from cugraph_tpu_torch.kernels.spill import (build_spilled_spmv_plan,
                                                 spmv_spilled)

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    resident = "--resident" in sys.argv
    scale = int(args[0]) if args else 26
    device = torch.device("cuda")
    budget = int(args[1]) if len(args) > 1 else \
        dispatch.spill_budget_bytes(device)
    card = cs.card_line()
    print(card, flush=True)
    m_gen = cs.EDGE_FACTOR << scale
    need, avail = m_gen * HOST_BYTES_PER_EDGE, _mem_available()
    print(f"RMAT-{scale}: {m_gen} generated edges; host peak estimate "
          f"{need / 1e9:.1f} GB, MemAvailable {avail / 1e9:.1f} GB; budget "
          f"{budget} bytes", flush=True)
    if need > 0.9 * avail:
        print(f"spill_scale: RMAT-{scale} needs ~{need / 1e9:.1f} GB of host "
              f"memory, more than 90 % of the {avail / 1e9:.1f} GB "
              "available; not run", flush=True)
        return 3

    t0 = time.perf_counter()
    a, b, c = cs.RMAT_ABC
    src, dst = _rmat_host(scale, m_gen, a, b, c, cs.SEED, False)
    t1 = time.perf_counter()
    n = 1 << scale
    plan = build_spilled_spmv_plan(
        src, dst, None, n, max(budget // 4, dispatch.MIN_CHUNK_BYTES),
        device=device)
    t2 = time.perf_counter()
    pinned = (plan.indices.numel() + plan.weights.numel()
              + plan.chunk_offsets.numel()) * 4
    print(f"generated in {t1 - t0:.1f} s; plan of {plan.num_edges} edges in "
          f"{plan.num_chunks} chunks of {plan.chunk_bytes()} device bytes "
          f"built in {t2 - t1:.1f} s, {pinned / 1e9:.2f} GB pinned",
          flush=True)

    out_w = np.bincount(src, minlength=n).astype(np.float32)
    inv_out = torch.from_numpy(np.divide(
        np.float32(1), out_w, out=np.zeros_like(out_w),
        where=out_w > 0)).to(device)
    dangling = torch.from_numpy(out_w <= 0).to(device)
    del out_w
    p = torch.full((n,), 1.0 / n, device=device)

    def iteration():
        nonlocal p
        scaled = p * inv_out
        dangling_sum = torch.where(dangling, p, 0.0).sum()
        pulled = spmv_spilled(plan, scaled)
        p = ALPHA * (pulled + dangling_sum / n) + (1 - ALPHA) / n

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    iteration()  # warm-up
    before = spmv.LAUNCHES
    ms = _cuda_ms(torch, iteration, ITERS)
    if spmv.LAUNCHES - before != ITERS * plan.num_chunks:
        raise AssertionError(f"{spmv.LAUNCHES - before} launches for "
                             f"{ITERS} iterations x {plan.num_chunks} chunks")
    peak = torch.cuda.max_memory_allocated() - base
    h2d = cs._h2d_bytes(plan)
    if not torch.isfinite(p).all() or abs(float(p.sum()) - 1.0) > 1e-3:
        raise AssertionError(f"the iterate sums to {float(p.sum())}")
    row = {"metric": f"spill_scale_rmat{scale}_ef{cs.EDGE_FACTOR}",
           "vertices": n, "edges": plan.num_edges, "budget_bytes": budget,
           "chunks": plan.num_chunks, "chunk_bytes": plan.chunk_bytes(),
           "generate_s": t1 - t0, "plan_build_s": t2 - t1,
           "pinned_gb": pinned / 1e9, "iterations": ITERS,
           "ms_per_iteration": ms, "h2d_bytes_per_iteration": h2d,
           "gb_per_s": h2d / ms / 1e6, "peak_device_bytes_above_start": peak,
           "copy_bound_ms": cs._pinned_copy_ms(h2d, device)}
    row["copy_gb_per_s"] = h2d / row["copy_bound_ms"] / 1e6
    del p, inv_out, dangling

    if resident:
        t3 = time.perf_counter()
        csc = build_csr(dst, src, None, n, device)
        torch.cuda.synchronize()
        row["resident_build_s"] = time.perf_counter() - t3
        x = torch.rand(n, generator=torch.Generator(device=device)
                       .manual_seed(cs.SEED), device=device)
        got = spmv_spilled(plan, x)
        want = spmv.spmv_csr(csc.offsets, csc.indices, csc.weights, x, "mul")
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError("the spilled SpMV differs from the resident "
                                 "K1")
        row["resident_k1_ms"] = _cuda_ms(torch, lambda: spmv.spmv_csr(
            csc.offsets, csc.indices, csc.weights, x, "mul"), 10)
        row["spilled_equals_resident_bit_for_bit"] = True
        print(f"spmv_spilled equals the resident K1 bit for bit over "
              f"{plan.num_edges} edges", flush=True)
    # ru_maxrss is in KiB on Linux
    row["host_peak_gb"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
    row["card"] = card
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
