"""device_idle_share.analytics (%, device trace): 1 - (union of kernel and
copy intervals) / window, over the traced window of PageRank calls."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * run.trace.idle_share()
