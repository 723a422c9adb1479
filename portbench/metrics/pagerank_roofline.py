"""pagerank_roofline (%, device trace): the least time of the window's
pulls (each K1 launch's CSC bytes read once at the HBM rate) over the
device's busy time in the same traced window: the share of a PageRank
call's device time that its unavoidable memory traffic accounts for,
whatever kernel does the work."""

from portbench.roofline import spmv_least_s


def read(run):
    pulls = run.counters.get("spmv.mul", 0)
    if run.trace is None or not pulls or run.trace.busy_s <= 0:
        return None
    least = pulls * spmv_least_s(run.stats["n"], run.stats["stored_edges"])
    return 100.0 * least / run.trace.busy_s
