"""The one traffic generator: a closed loop that drives an entry's call.

A traffic mix is a data file (``traffic/<mix>.json``) that names the entry
and its parameters; this loop reads ``loop`` and ``clients`` from it.  One
client issues each call when the previous one has ended (synchronised), for
``seconds``; the call in flight at the deadline is finished and counted,
and the window ends when it does.  A call that raises is counted as failed
and the loop goes on.
"""

from __future__ import annotations

import contextlib
import math
import random
import time
import traceback
from dataclasses import dataclass, field


@dataclass
class Window:
    start: float
    end: float
    latencies_s: list = field(default_factory=list)
    failed: int = 0
    first_error: str = ""

    @property
    def calls(self) -> int:
        """Calls completed, the failed ones included."""
        return len(self.latencies_s)

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Reservoir:
    """A uniform sample of ``k`` of the outputs offered, drawn from the
    seed (reservoir sampling), so that the judge sees calls from all over
    the window whatever their number."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        elif self.k:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


def closed_loop(call, seconds: float, traffic: dict, sync, *,
                keep=None, span=None, clock=time.perf_counter) -> Window:
    """Drive ``call()`` back to back for ``seconds``; ``sync()`` ends each
    call on the device; ``keep(output)`` sees every output; ``span(name)``,
    where given, wraps each call in a named profiler span."""
    if traffic.get("loop", "closed") != "closed" or traffic.get(
            "clients", 1) != 1:
        raise ValueError("the generator drives one closed-loop client; the "
                         f"mix asks for {traffic.get('loop')!r} with "
                         f"{traffic.get('clients')} clients")
    span = span or (lambda name: contextlib.nullcontext())
    win = Window(start=clock(), end=0.0)
    deadline = win.start + seconds
    while True:
        t = clock()
        try:
            with span("portbench.call"):
                out = call()
                sync()
        except Exception:  # a failed call is counted, the window goes on
            win.failed += 1
            win.first_error = win.first_error or traceback.format_exc()
            out = None
        end = clock()
        win.latencies_s.append(end - t)
        if out is not None and keep is not None:
            keep(out)
        if end >= deadline:
            win.end = end
            return win


def percentile(values, q: float) -> float:
    """The ``q``-th percentile with linear interpolation between the
    nearest ranks (numpy's default)."""
    v = sorted(values)
    k = (len(v) - 1) * q / 100.0
    lo = math.floor(k)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (k - lo)
