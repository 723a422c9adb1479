"""The window's arithmetic: every call counted, the one in flight at the
deadline finished and counted, and the end-to-end metrics over all of
them."""

import pytest

from portbench.harness import Run
from portbench.registry import Bench
from portbench.tests.conftest import ROOT
from portbench.window import Reservoir, closed_loop, percentile


class FakeClock:
    """Each call takes the next of ``durations`` seconds."""

    def __init__(self, durations):
        self.t = 100.0
        self.durations = list(durations)
        self.calls = 0

    def __call__(self):
        return self.t

    def call(self):
        self.t += self.durations[self.calls]
        self.calls += 1
        return self.calls


def _window(durations, seconds):
    clock = FakeClock(durations)
    kept = []
    win = closed_loop(clock.call, seconds, {"loop": "closed", "clients": 1},
                      lambda: None, keep=kept.append, clock=clock)
    return win, kept


def test_call_in_flight_at_the_deadline_is_counted_and_ends_the_window():
    win, kept = _window([0.4, 0.4, 0.4, 0.4, 0.4], seconds=1.0)
    # calls end at 0.4, 0.8, 1.2: the third crosses the deadline
    assert win.calls == 3 and kept == [1, 2, 3]
    assert win.seconds == pytest.approx(1.2)
    assert win.latencies_s == pytest.approx([0.4, 0.4, 0.4])


def test_failed_calls_are_counted_and_the_window_goes_on():
    clock = FakeClock([0.3] * 6)

    def call():
        n = clock.call()
        if n == 2:
            raise RuntimeError("boom")
        return n

    win = closed_loop(call, 1.0, {}, lambda: None, clock=clock)
    assert win.calls == 4 and win.failed == 1
    assert "boom" in win.first_error


def test_only_one_closed_loop_client():
    with pytest.raises(ValueError):
        closed_loop(lambda: 1, 1.0, {"loop": "open"}, lambda: None)
    with pytest.raises(ValueError):
        closed_loop(lambda: 1, 1.0, {"clients": 4}, lambda: None)


def _read(name, run):
    return Bench(ROOT).module("metrics", name).read(run)


def _run(win, **stats):
    return Run(setup_s=12.5, graph_build_s=7.0, window=win, stats=stats,
               counters={}, config={})


def test_end_to_end_metrics_over_all_calls():
    durations = [0.1] * 18 + [0.5, 0.9]
    win, _ = _window(durations, seconds=2.5)
    assert win.calls == 20 and win.seconds == pytest.approx(3.2)
    run = _run(win, n=1000, pairs=4000, stored_edges=8000)
    assert _read("evps", run) == pytest.approx(5000 * 20 / 3.2)
    assert _read("train_step_ms", run) == pytest.approx(3200 / 20)
    # numpy's linear rank: 0.95 * 19 = 18.05 -> 0.5 + 0.05 * 0.4
    assert _read("call_ms_p95", run) == pytest.approx(520.0)
    assert _read("setup_s", run) == 12.5
    assert _read("graph_build_s", run) == 7.0


def test_percentile_matches_numpy():
    np = pytest.importorskip("numpy")
    values = [3.0, 1.0, 4.0, 1.5, 9.0, 2.6, 5.3]
    for q in (0, 50, 95, 100):
        assert percentile(values, q) == pytest.approx(np.percentile(values, q))


def test_reservoir_keeps_k_drawn_from_the_seed():
    a, b = Reservoir(3, 7), Reservoir(3, 7)
    for i in range(1000):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items and len(a.items) == 3
    assert max(a.items) >= 3  # not just the first three
    none = Reservoir(0, 7)
    none.offer(1)
    assert none.items == []
