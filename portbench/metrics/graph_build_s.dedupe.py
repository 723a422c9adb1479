"""graph_build_s.dedupe (s, program span): host seconds per
``cugraph.graph.dedupe`` span of the program's graph build (total over
count, from its span accumulator)."""

from portbench.spans import mean_s


def read(run):
    return mean_s("cugraph.graph.dedupe")
