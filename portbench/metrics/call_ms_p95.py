"""call_ms_p95 (ms, host clock): the 95th percentile of the latency of
every call in the window, issue to synchronised end, frame included."""

from portbench.window import percentile


def read(run):
    return 1e3 * percentile(run.window.latencies_s, 95)
