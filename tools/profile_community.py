#!/usr/bin/env python3
"""Host profile of the port's community detection and all-pairs
similarity at RMAT-20, on the machine of one NVIDIA card.

    python3 tools/profile_community.py

Run from the repository root on a machine with a CUDA card, after
``chip_smoke.py`` has built the native library or with g++ present.
Prints the card and the host's core count, the seconds NumPy takes to sort
and to ``np.unique`` 31 M random int64 keys (the size of the Graph500
RMAT-20 edge-key array), then a cProfile by function (tottime) of one
``all_pairs_jaccard`` (64 seeds, top 1,000) and one ``louvain`` on the
Graph500 undirected RMAT-20 that ``chip_smoke.py`` builds.  Both calls run
on the host apart from the graph's structure, which lives on the card.
"""

import cProfile
import os
import pstats
import sys
import time

import numpy as np


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_community: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs

    import cugraph_tpu_torch as ct

    print(cs.card_line(), "cpu_count", os.cpu_count(), "affinity",
          len(os.sched_getaffinity(0)), "torch threads",
          torch.get_num_threads())
    keys = np.random.default_rng(0).integers(0, 2**40, 31_000_000)
    for name, fn in (("np.sort", np.sort), ("np.unique", np.unique)):
        t0 = time.perf_counter()
        fn(keys)
        print(f"{name} of 31 M int64: {time.perf_counter() - t0:.3f} s")
    device = torch.device("cuda")
    G, edges = cs.build_graph(device)
    del G
    Gu = cs.build_graph500_graph(edges, device)[0]
    seeds = cs._seeds_with_out_edges(Gu, cs.ALL_PAIRS_SEEDS, 0)
    for name, fn in (
            ("all_pairs_jaccard", lambda: ct.all_pairs_jaccard(
                Gu, vertices=seeds, topk=cs.ALL_PAIRS_TOPK)),
            ("louvain", lambda: ct.louvain(Gu))):
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.runcall(fn)
        print(f"{name}: {time.perf_counter() - t0:.3f} s", flush=True)
        pstats.Stats(prof).sort_stats("tottime").print_stats(14)
    return 0


if __name__ == "__main__":
    sys.exit(main())
