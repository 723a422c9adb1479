"""device_idle_share.gnn (%, device trace): 1 - (union of kernel and copy
intervals) / window, over the traced window of training steps."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * run.trace.idle_share()
