#!/usr/bin/env python3
"""``chip_smoke.py``'s multi-device community check (d) at another scale.

    python3 tools/mg_community_scale.py [scale]

Run from the repository root on a machine with a CUDA card and g++ (the
native library builds at first use).  ``chip_smoke.py`` runs its check
(d) on the Graph500 construction at RMAT-16; this script runs the same
function, with all its checks, on the one at RMAT-``scale`` (18 by
default, the single-device community phase's scale) over a one-rank NCCL
mesh, to show what that cut saves.  Prints the card, one line per call
with its launches, the check's summary and one JSON metric line per call.
"""

import json
import os
import sys
import time


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mg_community_scale: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs

    import cugraph_tpu_torch as ct

    scale = int(sys.argv[1]) if len(sys.argv) > 1 else 18
    card = cs.card_line()
    print(card, flush=True)
    device = torch.device("cuda")
    a, b, c = cs.RMAT_ABC
    G = cs.build_graph500_graph(ct.rmat(scale, cs.EDGE_FACTOR << scale, a=a,
                                        b=b, c=c, seed=cs.SEED), device,
                                scale)[0]
    counts, secs = {}, {}
    with cs.nccl_mesh(device) as mesh:
        t0 = time.perf_counter()
        cs._mga_community(mesh, G, counts, secs, scale)
        print(f"check (d) at RMAT-{scale}: {time.perf_counter() - t0:.1f} s "
              "with its checks", flush=True)
    for label, sec in secs.items():
        print(json.dumps({"metric": f"mg {label} rmat{scale}",
                          "ms_per_call": sec * 1e3, "runs": 1,
                          "mesh": "1x1 nccl", "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
