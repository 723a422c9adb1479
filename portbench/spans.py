"""Readers of the program's own spans (``cugraph.*``, from
``cugraph_tpu_torch.utils.profiling.span``).

In a traced window each span is a host event on the kernels' clock: the
device's idle time inside the union of one name's events is read against
``Trace.busy``.  Out of any trace, the program's accumulator gives each
name's host seconds and count.  Both give None where the span never
appears, as it never does in a program that has no such span.
"""

from __future__ import annotations

from portbench.trace import _union


def _clipped_union(trace, name):
    ws, we = trace.window
    return _union([(max(s, ws), min(e, we)) for n, s, e in trace.host
                   if n == name and e > ws and s < we])


def _overlap_s(a, b) -> float:
    """Seconds that two sorted lists of disjoint intervals (microseconds)
    share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total / 1e6


def idle_s(trace, name: str):
    """Device-idle seconds inside the union of the host events ``name``,
    clipped to the window; None without a trace, without device activity
    (a run on the CPU) or without such an event."""
    if trace is None or trace.busy_s <= 0:
        return None
    spans = _clipped_union(trace, name)
    if not spans:
        return None
    return sum(e - s for s, e in spans) / 1e6 - _overlap_s(spans, trace.busy)


def idle_ms_per_call(run, name: str):
    """``idle_s`` in milliseconds per call of the window."""
    idle = idle_s(run.trace, name)
    if idle is None or not run.window.calls:
        return None
    return 1e3 * idle / run.window.calls


def mean_s(name: str, totals=None):
    """Host seconds per span ``name`` (total over count) from the
    program's accumulator (``totals``: its ``span_totals()``, read here
    where not given); None where the program has none or no such span
    closed."""
    if totals is None:
        try:
            from cugraph_tpu_torch.utils.profiling import span_totals
        except ImportError:  # a program without spans
            return None
        totals = span_totals()
    seconds, count = totals.get(name, (0.0, 0))
    return seconds / count if count else None
