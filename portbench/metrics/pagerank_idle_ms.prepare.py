"""pagerank_idle_ms.prepare (ms a call, device trace): the device's idle time
inside the program's ``cugraph.pagerank.prepare`` spans in the traced
window, over the calls of the window."""

from portbench.spans import idle_ms_per_call


def read(run):
    return idle_ms_per_call(run, "cugraph.pagerank.prepare")
