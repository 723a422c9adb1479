"""k4_spmm_roofline (%, device trace): K4's least time over the window's
aggregations and VJPs (``roofline.spmm_least_s`` at each layer's width),
over the device time of K4's two kernels (``spmm_span_pass``,
``spmm_row_pass``) in the traced window.  Read only where the launches
are the model's: one forward per layer and one VJP per layer but the
first, each step."""

from portbench.roofline import sage_aggregations, spmm_least_s

KERNELS = ("spmm_span_pass", "spmm_row_pass")


def read(run):
    if run.trace is None:
        return None
    c = run.config
    fwd, vjp = sage_aggregations(c["in_dim"], c["hidden_dim"], c["out_dim"],
                                 c["num_layers"])
    steps = run.window.calls
    if (run.counters.get("spmm.weighted", 0) != steps * len(fwd)
            or run.counters.get("spmm.weighted_vjp", 0) != steps * len(vjp)):
        return None
    kernel_s = run.trace.device_seconds(KERNELS)
    if kernel_s <= 0:
        return None
    n, m = run.stats["n"], run.stats["stored_edges"]
    least = steps * sum(spmm_least_s(n, m, f) for f in fwd + vjp)
    return 100.0 * least / kernel_s
