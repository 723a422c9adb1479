"""The traced run: ``torch.profiler`` over the whole window, reduced.

Busy time is the union of every device interval (kernels, copies, sets)
inside the window; an idle gap is a stretch of the window with none, named
by the innermost host operation running at its middle (``portbench.call``
where the host ran no torch operation: Python, pandas or NumPy work).
"""

from __future__ import annotations

import bisect
from collections import defaultdict

WINDOW = "portbench.window"
CALL = "portbench.call"
_SCAN = 4096  # host events looked at, backwards, to name one gap


def profiled(run_window):
    """``run_window(span)`` under the profiler (CPU and CUDA activity),
    inside a ``portbench.window`` span; returns (its result, a Trace)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            result = run_window(record_function)
    return result, Trace.from_events(_rows(prof.profiler.kineto_results))


def _rows(results):
    """(name, device type, start, end in microseconds) of every event the
    profiler kept, read straight from its results: ``prof.events()`` would
    first build a tree of Python objects, minutes for a window of a million
    events."""
    base = results.trace_start_ns()
    for evt in results.events():
        if getattr(evt, "is_hidden_event", lambda: False)():
            continue
        yield (evt.name(), evt.device_type(), (evt.start_ns() - base) / 1e3,
               (evt.end_ns() - base) / 1e3)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """Device and host intervals of one traced window, in microseconds."""

    def __init__(self, window, device, host):
        self.window = window            # (start, end)
        ws, we = window
        self.device = [(n, max(s, ws), min(e, we)) for n, s, e in device
                       if e > ws and s < we]
        self.host = sorted((h for h in host if h[0] != CALL),
                           key=lambda x: x[1])
        self._starts = [s for _, s, _ in self.host]
        self.calls = _union([(s, e) for n, s, e in host if n == CALL])
        self._call_starts = [s for s, _ in self.calls]
        self.busy = _union([(s, e) for _, s, e in self.device])

    @classmethod
    def from_events(cls, events):
        """``events``: (name, device type, start, end) rows."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        device, host, window = [], [], None
        for name, device_type, start, end in events:
            if name in (WINDOW, CALL) and device_type == cuda:
                continue  # the spans' shadows on the device timeline
            if device_type == cuda:
                device.append((name, start, end))
            elif name == WINDOW:
                window = (start, end)
            else:
                host.append((name, start, end))
        if window is None:
            raise RuntimeError("the profiler recorded no window span")
        return cls(window, device, host)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def device_seconds(self, names) -> float:
        """Device time of the operations whose name holds any of
        ``names``."""
        return sum(e - s for n, s, e in self.device
                   if any(k in n for k in names)) / 1e6

    def device_ops(self, top: int = 10):
        by_name = defaultdict(float)
        for n, s, e in self.device:
            by_name[n[:120]] += (e - s) / 1e6
        return sorted(([k, v] for k, v in by_name.items()),
                      key=lambda kv: -kv[1])[:top]

    def _host_at(self, t: float) -> str:
        """The innermost host operation running at ``t``; else whether a
        call was running (its span is looked up apart, since a long call
        starts more than ``_SCAN`` host events back)."""
        i = bisect.bisect_right(self._starts, t) - 1
        for j in range(i, max(-1, i - _SCAN), -1):
            name, s, e = self.host[j]
            if e >= t:
                return name
        k = bisect.bisect_right(self._call_starts, t) - 1
        if k >= 0 and self.calls[k][1] >= t:
            return "host, no torch op"
        return "host, outside the calls"

    def idle_gaps(self, top: int = 10):
        """Idle seconds by what the host was doing, largest first."""
        by_name = defaultdict(float)
        edge = self.window[0]
        for s, e in self.busy + [[self.window[1], self.window[1]]]:
            if s > edge:
                by_name[self._host_at((edge + s) / 2)[:120]] += (s - edge) / 1e6
            edge = max(edge, e)
        return sorted(([k, v] for k, v in by_name.items()),
                      key=lambda kv: -kv[1])[:top]

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops(),
                "idle_gaps": self.idle_gaps()}
