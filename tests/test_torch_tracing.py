"""The port's span primitive (``utils/profiling.py``): host-only profiler
events of kind ``cpu_op``, recorded only while a profiler records, and a
process-wide accumulator of host seconds per name; and the spans that the
port's PageRank and graph build carry.

No JAX here: the card test runs in the same file.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cugraph_tpu_torch as ct
from cugraph_tpu_torch.utils import profiling
from cugraph_tpu_torch.utils.profiling import (HighResTimer, reset_spans,
                                               span, span_totals,
                                               trace_annotation)

torch.set_num_threads(1)

PAGERANK_PHASES = ("cugraph.pagerank.prepare", "cugraph.pagerank.loop",
                   "cugraph.vertex_frame")
BUILD_PHASES = ("cugraph.graph.renumber", "cugraph.graph.dedupe",
                "cugraph.graph.symmetrize", "cugraph.graph.structure")


def _kind(e) -> str:
    """The event's activity type; a torch without ``activity_type()``
    (2.11) tells only whether it is a user annotation."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    return "user_annotation" if e.is_user_annotation() else "not user"


def _events(prof, prefix=""):
    """(name, kind, device type, start ns, end ns) of the events the
    profiler kept whose name starts with ``prefix``."""
    return [(e.name(), _kind(e), e.device_type(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(prefix)]


@pytest.fixture
def no_carry_over():
    reset_spans()
    yield
    reset_spans()


def test_without_a_profiler_a_span_emits_no_event_and_counts(
        no_carry_over, monkeypatch):
    made = []

    class Recorder:
        def __init__(self, name):
            made.append(name)

    monkeypatch.setattr(profiling, "_RecordFunctionFast", Recorder)
    assert not torch._C._autograd._profiler_enabled()
    for _ in range(3):
        with span("cugraph.test.off"):
            time.sleep(0.001)
    with trace_annotation("plain"):
        pass
    with HighResTimer().range("timed"):
        pass
    assert made == []
    seconds, count = span_totals()["cugraph.test.off"]
    assert count == 3 and seconds >= 0.003


@pytest.mark.parametrize("kind", ["span", "trace_annotation",
                                  "HighResTimer.range"])
def test_under_the_profiler_every_region_is_a_cpu_op(kind, no_carry_over):
    name = f"cugraph.test.{kind}"
    region = {"span": span, "trace_annotation": trace_annotation,
              "HighResTimer.range": HighResTimer().range}[kind]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with region(name):
                torch.ones(16).sum()
    got = _events(prof, name)
    assert len(got) == 2
    assert {kind_ for _, kind_, _, _, _ in got} == {"cpu_op"}
    assert all(dev == torch.autograd.DeviceType.CPU for _, _, dev, _, _
               in got)
    # record_function's kind, which the profiler mirrors onto the device
    # timeline, is not used
    assert not any(k == "user_annotation" for _, k, _, _, _ in _events(prof))
    assert (name in span_totals()) == (kind == "span")


def test_a_span_closes_and_counts_when_its_body_raises(no_carry_over):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError, match="boom"):
            with span("cugraph.test.raises"):
                torch.ones(4).sum()
                raise ValueError("boom")
        with span("cugraph.test.after"):
            pass
    assert span_totals()["cugraph.test.raises"][1] == 1
    (_, _, _, s, e), = _events(prof, "cugraph.test.raises")
    (_, _, _, s2, _), = _events(prof, "cugraph.test.after")
    assert s < e <= s2


def test_nested_spans_of_one_name_keep_their_own_starts(no_carry_over):
    with span("cugraph.test.nest"):
        time.sleep(0.02)
        with span("cugraph.test.nest"):
            time.sleep(0.001)
    seconds, count = span_totals()["cugraph.test.nest"]
    assert count == 2
    # outer ~21 ms + inner ~1 ms; a shared start would lose the outer's
    # first 20 ms
    assert seconds >= 0.021 + 0.001


def test_threads_lose_no_span(no_carry_over):
    """More threads than cores, switching often: every span counts."""
    threads, per_thread = 32, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per_thread):
                with span("cugraph.test.threads"):
                    pass

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    assert span_totals()["cugraph.test.threads"][1] == threads * per_thread


def test_reset_spans_clears_the_totals(no_carry_over):
    with span("cugraph.test.reset"):
        pass
    assert "cugraph.test.reset" in span_totals()
    reset_spans()
    assert span_totals() == {}


def test_pagerank_phases_nest_inside_the_call(no_carry_over):
    G = ct.datasets.karate.get_graph(create_using=ct.Graph(device="cpu"))
    G.structure
    reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ct.pagerank(G)
    got = {n: (s, e) for n, _, _, s, e in _events(prof, "cugraph.")}
    assert set(got) == {"cugraph.pagerank", *PAGERANK_PHASES}
    outer_s, outer_e = got["cugraph.pagerank"]
    edges = [got[n] for n in PAGERANK_PHASES]
    for s, e in edges:
        assert outer_s <= s < e <= outer_e
    # prepare, then the loop, then the frame, none overlapping
    assert all(a[1] <= b[0] for a, b in zip(edges, edges[1:]))
    totals = span_totals()
    assert {n: c for n, (_, c) in totals.items()} == {
        "cugraph.pagerank": 1, **{n: 1 for n in PAGERANK_PHASES}}


def test_an_undirected_build_records_its_four_phases_once(no_carry_over):
    rng = np.random.default_rng(7)
    src, dst = rng.integers(0, 50, 300), rng.integers(0, 50, 300)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        G = ct.Graph(device="cpu").from_edgelist(src, dst)
        G.structure
        G.structure  # built once
    assert {n: c for n, (_, c) in span_totals().items()} == {
        n: 1 for n in BUILD_PHASES}
    got = [n for n, _, _, _, _ in sorted(_events(prof, "cugraph."),
                                         key=lambda r: r[3])]
    assert got == list(BUILD_PHASES)


def test_a_directed_build_has_no_symmetrize_span(no_carry_over):
    G = ct.Graph(directed=True, device="cpu").from_edgelist(
        np.array([0, 1, 1]), np.array([1, 2, 2]))
    G.structure
    assert set(span_totals()) == set(BUILD_PHASES) - {
        "cugraph.graph.symmetrize"}


@pytest.mark.cuda
def test_spans_add_nothing_to_the_device_timeline(no_carry_over):
    """Traced with CUDA activity, a span around kernel launches is a host
    event only; a record_function's annotation would be mirrored."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with span("cugraph.test.card"):
            for _ in range(4):
                x = x * 1.5
            torch.cuda.synchronize()
        with trace_annotation("cugraph.test.annotation"):
            (x + 1).sum().item()
    cuda = torch.autograd.DeviceType.CUDA
    got = _events(prof, "cugraph.test.")
    assert sorted(n for n, _, _, _, _ in got) == [
        "cugraph.test.annotation", "cugraph.test.card"]
    assert all(k in ("cpu_op", "not user") and d != cuda
               for _, k, d, _, _ in got)
    assert any(d == cuda for _, _, d, _, _ in _events(prof))  # kernels seen
