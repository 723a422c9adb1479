"""train_step_mfu (%, device trace): the step's least time
(``roofline.sage_step_least_s``: GEMMs at the float32 rate, aggregations
and their VJPs at the HBM rate) times the steps, over the traced window."""

from portbench.roofline import sage_step_least_s


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    c = run.config
    least = sage_step_least_s(run.stats["n"], run.stats["stored_edges"],
                              c["in_dim"], c["hidden_dim"], c["out_dim"],
                              c["num_layers"])
    return 100.0 * least * run.window.calls / run.trace.window_s
