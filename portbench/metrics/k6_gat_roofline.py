"""k6_gat_roofline (%, device trace): K6's least time over the window's
steps (``roofline_gat.gat_k6_least_s``: a forward and a backward a
layer), over the device time of K6's kernels by name (``gat_fwd_*``,
``gat_bwd_*``) in the traced window.  Read only where the launches are
the model's: one forward and one backward a layer, each step."""

from portbench.roofline_gat import gat_k6_least_s

KERNELS = ("gat_fwd_", "gat_bwd_")


def read(run):
    if run.trace is None:
        return None
    c = run.config
    steps = run.window.calls
    want = steps * c["num_layers"]
    if (run.counters.get("gat.forward", 0) != want
            or run.counters.get("gat.backward", 0) != want):
        return None
    kernel_s = run.trace.device_seconds(KERNELS)
    if kernel_s <= 0:
        return None
    least = steps * gat_k6_least_s(run.stats["n"], run.stats["stored_edges"],
                                   c)
    return 100.0 * least / kernel_s
