"""setup_s (s, host clock): from the start of run.py to the start of the
window: imports, the edge list, the graph build, inputs and weights, and
the warm-up of the cell's own call."""


def read(run):
    return run.setup_s
