"""k1_spmv_roofline (%, device trace): K1's least time per launch over
the CSC (``roofline.spmv_least_s``) times its launches, over the device
time of K1's two kernels (``spmv_span_pass``, ``spmv_row_pass``) in the
traced window."""

from portbench.roofline import spmv_least_s

KERNELS = ("spmv_span_pass", "spmv_row_pass")


def read(run):
    launches = run.counters.get("spmv.mul", 0)
    if run.trace is None or not launches:
        return None
    kernel_s = run.trace.device_seconds(KERNELS)
    if kernel_s <= 0:
        return None
    least = launches * spmv_least_s(run.stats["n"], run.stats["stored_edges"])
    return 100.0 * least / kernel_s
