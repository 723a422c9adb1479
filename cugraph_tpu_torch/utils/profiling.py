"""Tracing and profiling utilities.

Counterpart of ``cugraph_tpu.utils.profiling`` (reference posture,
SURVEY.md §5: a labelled-region host timer, utilities/high_res_timer.hpp:
25-40, plus an external profiler), in PyTorch's idiom: the timer waits
for the card with ``torch.cuda.synchronize``, a region is a
``torch.profiler.record_function`` and a trace is a
``torch.profiler.profile``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class HighResTimer:
    """Labelled-region accumulator timer (high_res_timer.hpp analog).

    >>> t = HighResTimer()
    >>> with t.range("spmv"):
    ...     work()
    >>> t.display()
    """

    def __init__(self):
        self._totals = defaultdict(float)
        self._counts = defaultdict(int)
        self._starts = {}

    def start(self, label: str):
        self._starts[label] = time.perf_counter()

    def stop(self, label: str, *, block_on=None):
        """Seconds since ``start(label)``; with ``block_on`` (a tensor or a
        sequence of them), after the card has finished their work."""
        if block_on is not None:
            device_sync(*(block_on if isinstance(block_on, (list, tuple))
                          else (block_on,)))
        dt = time.perf_counter() - self._starts.pop(label)
        self._totals[label] += dt
        self._counts[label] += 1
        return dt

    @contextlib.contextmanager
    def range(self, label: str, *, annotate: bool = True):
        """A timed region, also a named range in profiler traces."""
        cm = trace_annotation(label) if annotate else contextlib.nullcontext()
        with cm:
            self.start(label)
            try:
                yield self
            finally:
                self.stop(label)

    def totals(self) -> dict:
        return {k: (self._totals[k], self._counts[k]) for k in self._totals}

    def display(self, file=None) -> str:
        lines = [f"{k}: {tot * 1e3:.2f} ms over {cnt} call(s)"
                 for k, (tot, cnt) in sorted(self.totals().items())]
        out = "\n".join(lines)
        print(out, file=file)
        return out

    def reset(self):
        self._totals.clear()
        self._counts.clear()
        self._starts.clear()


def trace_annotation(label: str):
    """A named range in the profiler's trace (the NVTX-range analog)."""
    return torch.profiler.record_function(label)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace the enclosed region, on the host and, where there is a card,
    on the card, into a Chrome trace file in ``log_dir``:

    >>> with profile_trace("build/trace"):
    ...     cugraph_tpu_torch.pagerank(G)
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(log_dir))):
        yield


def device_sync(*arrays):
    """Wait until the card has finished the work that produces ``arrays``
    (the cudaStreamSynchronize analog for fair timing); a CPU tensor needs
    no wait."""
    for a in arrays:
        if isinstance(a, torch.Tensor) and a.device.type == "cuda":
            torch.cuda.synchronize(a.device)
