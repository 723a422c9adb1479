"""Readings that set a cell's limits: the program's, the control's and the
faults', each seed in turn in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,... \\
        [--control-seeds 11,12,13] [--out chiprun_out/calibrate.jsonl]

For every seed it makes the cell's set-up as a run does (the same entry,
inputs and warm-up), drives one more call of the timed path, and compares
what that path produced with the plain reference; for the control seeds it
also reads the control (the reference in the precision below the
configuration's) and each fault the reference module plants, under its
own name.  Where the reference module has ``detail``, each row also says
what every number is made of.  One JSON line per seed.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import device as devmod  # noqa: E402
from portbench.harness import Context  # noqa: E402
from portbench.registry import Bench  # noqa: E402


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def calibrate(bench: Bench, cell_name: str, seed: int, device,
              control: bool) -> dict:
    import torch

    cell = bench.cell(cell_name)
    workload = bench.workload(cell_name)
    traffic = bench.traffic(cell["traffic"])
    entry = bench.module("entries", traffic["entry"])
    reference = bench.module("reference", workload["reference"])
    ctx = Context(bench.config(cell["config"]), traffic, workload, seed,
                  device)
    t = time.perf_counter()
    session = entry.setup(ctx)
    setup_s = time.perf_counter() - t
    out = session.call()
    ctx.sync()
    judged = session.judged([out])
    row = {"workload": cell_name, "seed": seed, "setup_s": setup_s,
           "graph_build_s": session.graph_build_s, "stats": session.stats,
           "memory_peak_bytes": devmod.peak_bytes(device, 1)}
    session.close()
    del session
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = reference.reference(judged, device)
    row["reference_s"] = time.perf_counter() - t
    outputs = {"program": reference.program_outputs(judged)}
    if control:
        outputs["control"] = reference.control_outputs(judged, device)
        outputs.update({f"fault.{k}": v for k, v in
                        reference.fault_outputs(judged, device).items()})
    for name, out in outputs.items():
        row[name] = reference.readings(ref, out)
        if hasattr(reference, "detail"):
            row[f"detail.{name}"] = reference.detail(ref, out)
    return row


def main(argv=None, root: str = ROOT) -> int:
    p = argparse.ArgumentParser(prog="portbench/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = Bench(root)
    device = devmod.require(int(bench.cell(args.workload)["chips"]))
    control = set(_seeds(args.control_seeds))
    for seed in _seeds(args.seeds):
        row = calibrate(bench, args.workload, seed, device, seed in control)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
