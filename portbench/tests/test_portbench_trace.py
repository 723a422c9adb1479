"""The traced window's reduction and the readers of the device trace, on
synthetic intervals (microseconds)."""

import pytest
import torch

from portbench import roofline
from portbench.harness import Run
from portbench.registry import Bench
from portbench.tests.conftest import ROOT
from portbench.trace import CALL, WINDOW, Trace
from portbench.window import Window

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU

def _evt(name, start, end, device_type):
    return name, device_type, start, end

def _trace():
    return Trace.from_events([
        _evt(WINDOW, 0, 100, CPU),
        _evt(CALL, 0, 100, CPU),
        _evt(CALL, 0, 100, CUDA),   # a span's shadow on the device
        _evt("aten::item", 40, 55, CPU),
        _evt("cudaMemGetInfo", 75, 90, CPU),
        _evt("spmv_row_pass<true>", 10, 30, CUDA),
        _evt("spmv_span_pass<true>", 25, 40, CUDA),
        _evt("Memcpy HtoD", 60, 70, CUDA),
        _evt("late kernel", 95, 120, CUDA),  # clipped at the window's end
    ])

def test_busy_is_the_union_inside_the_window():
    t = _trace()
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(45e-6)      # [10,40] [60,70] [95,100]
    assert t.idle_share() == pytest.approx(0.55)
    assert t.device_seconds(("spmv_row_pass", "spmv_span_pass")) == \
        pytest.approx(35e-6)

def test_idle_gaps_are_named_by_the_host():
    gaps = dict(_trace().idle_gaps())
    assert gaps == pytest.approx({"host, no torch op": 10e-6,
                                  "aten::item": 20e-6,
                                  "cudaMemGetInfo": 25e-6})
    ops = dict(_trace().device_ops())
    assert CALL not in ops and ops["late kernel"] == pytest.approx(5e-6)

def test_a_gap_late_in_a_long_call_is_the_call_s():
    """A call of many host operations: a gap after all of them is still
    inside the call, however far back the call's span starts."""
    host = [_evt(f"aten::op{i}", 2 * i, 2 * i + 1, CPU) for i in range(5000)]
    t = Trace.from_events([_evt(WINDOW, 0, 20000, CPU),
                           _evt(CALL, 0, 19000, CPU), *host,
                           _evt("k", 0, 10000, CUDA),
                           _evt("k", 18000, 20000, CUDA)])
    assert dict(t.idle_gaps()) == pytest.approx(
        {"host, no torch op": 8000e-6})

def _read(name, run):
    return Bench(ROOT).module("metrics", name).read(run)

def test_trace_readers_by_hand():
    n, m = 1000, 8000
    t = _trace()
    run = Run(setup_s=1.0, graph_build_s=0.5,
              window=Window(start=0.0, end=2.0, latencies_s=[1.0, 1.0]),
              stats={"n": n, "pairs": m // 2, "stored_edges": m},
              counters={"spmv.mul": 40, "spmm.weighted": 6,
                        "spmm.weighted_vjp": 4},
              config={"in_dim": 4, "hidden_dim": 8, "out_dim": 3,
                      "num_layers": 3}, trace=t)
    assert _read("device_idle_share.analytics", run) == pytest.approx(55.0)
    least = roofline.spmv_least_s(n, m)
    assert _read("pagerank_roofline", run) == pytest.approx(
        100 * 40 * least / 45e-6)
    assert _read("k1_spmv_roofline", run) == pytest.approx(
        100 * 40 * least / 35e-6)
    step = roofline.sage_step_least_s(n, m, 4, 8, 3, 3)
    assert _read("train_step_mfu", run) == pytest.approx(
        100 * 2 * step / 100e-6)
    # no K4 kernel in this trace: its reader finds nothing
    assert _read("k4_spmm_roofline", run) is None
    # launches that are not the model's: nothing either
    run.counters["spmm.weighted"] = 5
    assert _read("k4_spmm_roofline", run) is None
    run.trace = None
    for name in ("device_idle_share.gnn", "pagerank_roofline",
                 "k1_spmv_roofline", "train_step_mfu"):
        assert _read(name, run) is None
