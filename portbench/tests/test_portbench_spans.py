"""The readers of the program's spans (``portbench/spans.py`` and the
``pagerank_idle_ms.*`` and ``graph_build_s.*`` metrics), on a hand-made
trace (microseconds) and hand-made span totals."""

import pytest
import torch

from portbench import spans
from portbench.harness import Run
from portbench.registry import Bench
from portbench.tests.conftest import ROOT
from portbench.trace import CALL, WINDOW, Trace
from portbench.window import Window

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU

PREPARE = "cugraph.pagerank.prepare"
LOOP = "cugraph.pagerank.loop"
FRAME = "cugraph.vertex_frame"


def _trace():
    """Window [0, 200]; device busy [20, 40], [60, 100], [150, 210]."""
    return Trace.from_events([
        (WINDOW, CPU, 0, 200),
        (CALL, CPU, 0, 200),
        ("cugraph.pagerank", CPU, 0, 200),
        (PREPARE, CPU, 10, 30),        # idle [10, 20]: 10
        (LOOP, CPU, 50, 90),           # idle [50, 60]: 10
        (LOOP, CPU, 80, 120),          # overlaps the first: [50, 120]
        (FRAME, CPU, -20, 5),          # crosses the window's start
        (FRAME, CPU, 190, 230),        # crosses its end; busy there
        ("k", CUDA, 20, 40),
        ("k", CUDA, 60, 100),
        ("k", CUDA, 150, 210),
    ])


def test_idle_inside_a_span():
    assert spans.idle_s(_trace(), PREPARE) == pytest.approx(10e-6)


def test_overlapping_spans_of_one_name_count_once():
    # union [50, 120] less busy [60, 100]: 30, not 20 + 20 + ...
    assert spans.idle_s(_trace(), LOOP) == pytest.approx(30e-6)


def test_spans_are_clipped_to_the_window():
    # [0, 5] idle, [190, 200] busy; nothing outside [0, 200]
    assert spans.idle_s(_trace(), FRAME) == pytest.approx(5e-6)


def test_a_span_the_trace_lacks_reads_none():
    assert spans.idle_s(_trace(), "cugraph.no_such_span") is None
    assert spans.idle_s(None, PREPARE) is None
    outside = Trace.from_events([(WINDOW, CPU, 0, 100), ("k", CUDA, 0, 50),
                                 (PREPARE, CPU, 150, 160)])
    assert spans.idle_s(outside, PREPARE) is None


def test_a_trace_without_device_activity_reads_none():
    cpu_only = Trace.from_events([(WINDOW, CPU, 0, 100),
                                  (PREPARE, CPU, 10, 20)])
    assert spans.idle_s(cpu_only, PREPARE) is None


def test_overlap_of_interval_lists():
    a = [[0, 10], [20, 30], [40, 50]]
    b = [[5, 25], [28, 45]]
    # [5,10] + [20,25] + [28,30] + [40,45] = 5 + 5 + 2 + 5
    assert spans._overlap_s(a, b) == pytest.approx(17e-6)
    assert spans._overlap_s(a, []) == 0.0


def _run(trace, calls=4):
    return Run(setup_s=1.0, graph_build_s=0.5,
               window=Window(start=0.0, end=1.0, latencies_s=[0.25] * calls),
               stats={}, counters={}, config={}, trace=trace)


def _read(name, run):
    return Bench(ROOT).module("metrics", name).read(run)


def test_idle_metrics_are_ms_a_call():
    run = _run(_trace(), calls=4)
    assert _read("pagerank_idle_ms.prepare", run) == pytest.approx(
        10e-3 / 4)
    assert _read("pagerank_idle_ms.loop", run) == pytest.approx(30e-3 / 4)
    assert _read("pagerank_idle_ms.frame", run) == pytest.approx(5e-3 / 4)
    assert _read("pagerank_idle_ms.loop", _run(None)) is None


def test_build_metrics_are_seconds_a_span(monkeypatch):
    totals = {"cugraph.graph.renumber": (6.0, 2),
              "cugraph.graph.dedupe": (1.5, 1),
              "cugraph.graph.symmetrize": (0.0, 0),
              "cugraph.graph.structure": (9.0, 3)}
    assert spans.mean_s("cugraph.graph.renumber", totals) == 3.0
    assert spans.mean_s("cugraph.graph.symmetrize", totals) is None
    assert spans.mean_s("cugraph.graph.missing", totals) is None

    from cugraph_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "span_totals", lambda: totals)
    run = _run(None)
    assert _read("graph_build_s.renumber", run) == 3.0
    assert _read("graph_build_s.dedupe", run) == 1.5
    assert _read("graph_build_s.structure", run) == 3.0
    assert _read("graph_build_s.symmetrize", run) is None
    # a program without spans (the parent of the spans' change)
    monkeypatch.delattr(profiling, "span_totals")
    assert _read("graph_build_s.renumber", run) is None


def test_build_metrics_read_the_program_s_own_spans():
    import numpy as np

    from cugraph_tpu_torch import Graph
    from cugraph_tpu_torch.utils import reset_spans

    reset_spans()
    try:
        G = Graph(device="cpu").from_edgelist(np.array([0, 1, 2, 2]),
                                              np.array([1, 2, 0, 0]))
        G.structure
        for phase in ("renumber", "dedupe", "symmetrize", "structure"):
            assert _read(f"graph_build_s.{phase}", _run(None)) > 0
    finally:
        reset_spans()
