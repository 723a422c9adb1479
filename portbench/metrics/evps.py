"""evps (EVPS, host clock): LDBC Graphalytics' edges plus vertices per
second, (n + undirected pairs, each once) x calls completed / window
seconds; the call in flight at the deadline is counted and ends the
window."""


def read(run):
    return ((run.stats["n"] + run.stats["pairs"]) * run.window.calls
            / run.window.seconds)
