"""train_step_mfu.gat (%, device trace): the GAT step's least time
(``roofline_gat.gat_step_least_s``: GEMMs at the float32 rate, K6 at its
bound) times the steps, over the traced window."""

from portbench.roofline_gat import gat_step_least_s


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    least = gat_step_least_s(run.stats["n"], run.stats["stored_edges"],
                             run.config)
    return 100.0 * least * run.window.calls / run.trace.window_s
