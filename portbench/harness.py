"""One run of one cell: set-up, the measured window, the judge, the metrics.

The run finds its cards or exits 2 with no result; it never falls back to
the CPU.  ``setup_s`` runs from the start of ``run.py`` to the start of the
window.  After the window: the peak device memory is read, the program's
state is freed, the plain reference judges what the window produced, each
metric's reader reads the run, and the process is searched for JAX and the
JAX package (exit 3, no result, if either is loaded).
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time
from dataclasses import dataclass

from portbench import device as devmod
from portbench import trace as tracemod
from portbench.registry import Bench
from portbench.window import Reservoir, closed_loop, percentile

FORBIDDEN = ("jax", "jaxlib", "flax", "cugraph_tpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Context:
    """What an entry's set-up is given."""
    config: dict
    traffic: dict
    workload: dict
    seed: int
    device: object
    clock: object = time.perf_counter

    def sync(self) -> None:
        devmod.synchronize(self.device)


@dataclass
class Run:
    """What a metric's reader reads."""
    setup_s: float
    graph_build_s: float
    window: object
    stats: dict
    counters: dict
    config: dict
    trace: object = None


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that a run may not hold, compared
    whole (``cugraph_tpu_torch`` is not ``cugraph_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def host_use(before, after, window) -> dict:
    """What the process took of the host in the window: CPU seconds, and
    page faults and context switches per call (involuntary switches mean
    another thread or tenant held the core)."""
    calls = max(window.calls, 1)
    return {"user_s": after.ru_utime - before.ru_utime,
            "sys_s": after.ru_stime - before.ru_stime,
            "minor_faults_per_call":
                (after.ru_minflt - before.ru_minflt) / calls,
            "major_faults": after.ru_majflt - before.ru_majflt,
            "voluntary_switches_per_call":
                (after.ru_nvcsw - before.ru_nvcsw) / calls,
            "involuntary_switches_per_call":
                (after.ru_nivcsw - before.ru_nivcsw) / calls}


def _say(*parts) -> None:
    print(*parts, flush=True)


def main(argv=None, *, t0: float | None = None, root: str = ROOT) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    bench = Bench(root)
    cell = bench.cell(args.workload)
    chips = int(cell["chips"])
    try:
        dev = devmod.require(chips)
    except devmod.NoCard as e:
        print(f"portbench: {e}; no result", file=sys.stderr)
        return 2
    import torch

    # the configurations state float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    workload = bench.workload(args.workload)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    entry = bench.module("entries", traffic["entry"])
    reference = bench.module("reference", workload["reference"])
    info = devmod.describe(dev, chips)
    ctx = Context(config, traffic, workload, args.seed, dev)

    session = entry.setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t0
    kept = Reservoir(workload.get("sample_calls", 0), args.seed)
    before = session.counters()

    def run_window(span=None):
        return closed_loop(session.call, args.seconds, traffic, ctx.sync,
                           keep=kept.offer, span=span)

    trace = None
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    if args.trace:
        window, trace = tracemod.profiled(run_window)
    else:
        window = run_window()
    host = host_use(ru0, resource.getrusage(resource.RUSAGE_SELF), window)
    after = session.counters()
    counters = {k: after[k] - before.get(k, 0) for k in after}
    info["memory_peak_bytes"] = devmod.peak_bytes(dev, chips)
    judged = session.judged(kept.items)
    stats = session.stats
    run = Run(setup_s=setup_s, graph_build_s=session.graph_build_s,
              window=window, stats=stats, counters=counters, config=config,
              trace=trace)
    session.close()
    del session
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    got = reference.readings(reference.reference(judged, dev),
                             reference.program_outputs(judged))
    del judged
    checks = {k: {"value": v, "limit": workload["limits"][k]}
              for k, v in got.items()}
    correct = window.failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in bench.metrics(args.workload, bool(args.trace)):
        value = bench.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    lat = window.latencies_s
    _say("device:", json.dumps(info))
    _say("graph:", json.dumps(stats), f"graph_build_s {run.graph_build_s}")
    _say(f"window: {window.calls} calls in {window.seconds} s, "
         f"{window.failed} failed; call ms median "
         f"{percentile(lat, 50) * 1e3} p95 {percentile(lat, 95) * 1e3}; "
         f"setup_s {setup_s}")
    _say("host in the window:", json.dumps(host))
    _say("launches per call:", json.dumps(
        {k: v / window.calls for k, v in counters.items() if v}))
    if window.first_error:
        print(window.first_error, file=sys.stderr)
    result = {"correct": bool(correct), "attempted": window.calls,
              "failed": window.failed, "metrics": metrics, "device": info}
    if trace is not None:
        info["busy_s"] = trace.busy_s / chips
        info["window_s"] = trace.window_s
        result["breakdown"] = trace.breakdown()
    result["checks"] = checks
    for name, c in checks.items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr, flush=True)
    _say(json.dumps(result))
    return 0
