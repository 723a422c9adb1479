"""pagerank_idle_ms.frame (ms a call, device trace): the device's idle time
inside the program's ``cugraph.vertex_frame`` spans (the result frame) in
the traced window, over the calls of the window."""

from portbench.spans import idle_ms_per_call


def read(run):
    return idle_ms_per_call(run, "cugraph.vertex_frame")
