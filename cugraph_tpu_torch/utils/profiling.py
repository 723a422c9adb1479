"""Tracing and profiling utilities.

Counterpart of ``cugraph_tpu.utils.profiling`` (reference posture,
SURVEY.md §5: a labelled-region host timer, utilities/high_res_timer.hpp:
25-40, plus an external profiler), in PyTorch's idiom: the timer waits
for the card with ``torch.cuda.synchronize`` and a trace is a
``torch.profiler.profile``.

A region (``span``, ``trace_annotation``, ``HighResTimer.range``) is a
host-only profiler event, of kind ``cpu_op``, emitted only while a profiler
records: it sits in the profiler's results on the kernels' clock and adds
nothing to the device timeline (a ``record_function`` is a user annotation,
which the profiler mirrors onto the device timeline while it traces CUDA).

The program's own spans (``span``, every name ``cugraph.*``) also add
their host seconds to one process-wide accumulator, read by
``span_totals()`` and cleared by ``reset_spans()``.  They mark phases of a
call, never a step of a per-iteration or per-launch loop:

    cugraph.pagerank, cugraph.pagerank.prepare, cugraph.pagerank.loop
    cugraph.vertex_frame (the result frame of every algorithm that has one)
    cugraph.graph.renumber, cugraph.graph.dedupe, cugraph.graph.symmetrize
    cugraph.graph.structure (the CSR and CSC at a graph's first use)
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast


class _HostEvent:
    """A host-only profiler event named ``name`` while a profiler records;
    otherwise nothing but that check."""

    __slots__ = ("name", "_event")

    def __init__(self, name: str):
        self.name = name
        self._event = None

    def __enter__(self):
        if _profiler_enabled():
            self._event = _RecordFunctionFast(self.name)
            self._event.__enter__()
        return self

    def __exit__(self, *exc):
        if self._event is not None:
            self._event.__exit__(*exc)
            self._event = None
        return False


class HighResTimer:
    """Labelled-region accumulator timer (high_res_timer.hpp analog);
    ``add``, ``totals`` and ``reset`` are safe across threads.

    >>> t = HighResTimer()
    >>> with t.range("spmv"):
    ...     work()
    >>> t.display()
    """

    def __init__(self):
        self._acc = defaultdict(lambda: [0.0, 0])  # label -> [s, count]
        self._starts = {}
        self._lock = threading.Lock()

    def start(self, label: str):
        self._starts[label] = time.perf_counter()

    def stop(self, label: str, *, block_on=None):
        """Seconds since ``start(label)``; with ``block_on`` (a tensor or a
        sequence of them), after the card has finished their work."""
        if block_on is not None:
            device_sync(*(block_on if isinstance(block_on, (list, tuple))
                          else (block_on,)))
        dt = time.perf_counter() - self._starts.pop(label)
        self.add(label, dt)
        return dt

    def add(self, label: str, seconds: float):
        """Count one region of ``seconds`` under ``label``."""
        with self._lock:
            acc = self._acc[label]
            acc[0] += seconds
            acc[1] += 1

    @contextlib.contextmanager
    def range(self, label: str, *, annotate: bool = True):
        """A timed region with its own start (ranges of one label may nest
        or overlap), also a host event in profiler traces."""
        cm = trace_annotation(label) if annotate else contextlib.nullcontext()
        with cm:
            t = time.perf_counter()
            try:
                yield self
            finally:
                self.add(label, time.perf_counter() - t)

    def totals(self) -> dict:
        with self._lock:
            return {k: (tot, cnt) for k, (tot, cnt) in self._acc.items()}

    def display(self, file=None) -> str:
        lines = [f"{k}: {tot * 1e3:.2f} ms over {cnt} call(s)"
                 for k, (tot, cnt) in sorted(self.totals().items())]
        out = "\n".join(lines)
        print(out, file=file)
        return out

    def reset(self):
        with self._lock:
            self._acc.clear()
            self._starts.clear()


_SPANS = HighResTimer()


class span(_HostEvent):
    """A phase of the program: ``with span("cugraph.pagerank.loop"): ...``
    adds its host seconds to ``span_totals()`` (also when the body raises)
    and, while a profiler records, is a host event of that name."""

    __slots__ = ("_start",)

    def __enter__(self):
        # _HostEvent's two methods inlined: a span's whole cost is these
        if _profiler_enabled():
            self._event = _RecordFunctionFast(self.name)
            self._event.__enter__()
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self._start
        if self._event is not None:
            self._event.__exit__(*exc)
            self._event = None
        _SPANS.add(self.name, seconds)
        return False


def span_totals() -> dict:
    """{name: (seconds, count)} of the spans closed since the process
    began or the last ``reset_spans()``."""
    return _SPANS.totals()


def reset_spans() -> None:
    _SPANS.reset()


def trace_annotation(label: str):
    """A named range in the profiler's trace (the NVTX-range analog): a
    host-only event, as a span's, that keeps no time."""
    return _HostEvent(label)


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
