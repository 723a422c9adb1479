"""graph_build_s.renumber (s, program span): host seconds per
``cugraph.graph.renumber`` span of the program's graph build (total over
count, from its span accumulator)."""

from portbench.spans import mean_s


def read(run):
    return mean_s("cugraph.graph.renumber")
