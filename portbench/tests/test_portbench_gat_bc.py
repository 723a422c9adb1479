"""The GAT and betweenness cells: K6's counts by hand, the readers of
``k6_gat_roofline`` and ``train_step_mfu.gat`` on a synthetic run, and
the comparisons that decide ``correct`` failing what they must at a tiny
size on the CPU (the GAT reference's planted faults, each cell's control,
the program broken underneath)."""

import numpy as np
import pytest
import torch

from portbench import calibrate, roofline
from portbench import roofline_gat as rg
from portbench.harness import Run
from portbench.registry import Bench
from portbench.tests.conftest import ROOT, run_cell
from portbench.trace import WINDOW, Trace
from portbench.window import Window

BW, FL = 3.35e12, 67e12
GAT = "products.gat3_fullbatch"
BC = "g500s22.bc128"
CONFIG = {"in_dim": 6, "hidden_dim": 4, "num_heads": 2, "out_heads": 2,
          "concat_out": False, "out_dim": 3, "num_layers": 3,
          "add_self_loops": True}


def test_k6_bytes_and_flops_by_hand():
    # n=3, m=5, H=2, D=4: offsets 16 B, indices 20 B, x and y 2·96 B, the
    # logits in and the statistics out 4·24 B
    assert rg.k6_forward_bytes(3, 5, 2, 4) == 16 + 20 + 192 + 96
    # both orders' offsets and indices, x, dy and dx, six [n, H] arrays
    assert rg.k6_backward_bytes(3, 5, 2, 4) == 32 + 40 + 288 + 144
    fwd, bwd = rg.k6_least_s(3, 5, 2, 4)
    assert fwd == pytest.approx(max(324 / BW, 2 * 8 * 8 / FL))
    assert bwd == pytest.approx(max(504 / BW, 4 * 8 * 8 / FL))
    fwd, _ = rg.k6_least_s(3, 5, 2, 4, self_loops=False)
    assert fwd == pytest.approx(max(324 / BW, 2 * 5 * 8 / FL))
    # the published size: the forward of a 4 x 128 layer moves ~10.4 GB
    assert rg.k6_forward_bytes(2_376_186, 123_832_218, 4, 128) == \
        pytest.approx(10.4e9, rel=0.01)


def test_gat_step_by_hand():
    n, m = 4, 6
    layers = rg.gat_layers(CONFIG)
    assert layers == [(6, 2, 4, 8), (8, 2, 4, 8), (8, 2, 3, 3)]
    k6 = sum(sum(rg.k6_least_s(n, m, h, d)) for _, h, d, _ in layers)
    assert rg.gat_k6_least_s(n, m, CONFIG) == pytest.approx(k6)
    g = roofline.gemm_least_s
    gemm = 2 * (g(n, 6, 8) + g(6, n, 8))                   # W, skip
    gemm += 2 * (g(n, 8, 8) + g(8, n, 8) + g(n, 8, 8))
    gemm += g(n, 8, 6) + g(8, n, 6) + g(n, 6, 8)          # W 8 -> 2 x 3
    gemm += g(n, 8, 3) + g(8, n, 3) + g(n, 3, 8)          # skip 8 -> 3
    # W and skip weights, a_src and a_dst, the two biases
    params = (48 + 48 + 16 + 16) + (64 + 64 + 16 + 16) + (48 + 24 + 12 + 6)
    assert rg.gat_step_least_s(n, m, CONFIG) == pytest.approx(
        k6 + gemm + 28 * params / BW)


def _read(name, run):
    return Bench(ROOT).module("metrics", name).read(run)


def _run(counters, trace=True):
    cuda = torch.autograd.DeviceType.CUDA
    cpu = torch.autograd.DeviceType.CPU
    t = Trace.from_events([
        (WINDOW, cpu, 0, 100),
        ("void (anonymous namespace)::gat_fwd_row_pass(Shape)", cuda, 10, 30),
        ("gat_bwd_dst_row_pass", cuda, 30, 50),
        ("gat_bwd_src_span_pass", cuda, 50, 60),
        ("spmm_row_pass<true, true>", cuda, 60, 70),
        ("Memcpy HtoD", cuda, 80, 90)]) if trace else None
    return Run(setup_s=1.0, graph_build_s=0.5,
               window=Window(start=0.0, end=2.0, latencies_s=[1.0, 1.0]),
               stats={"n": 1000, "pairs": 4000, "stored_edges": 8000},
               counters=counters, config=CONFIG, trace=t)


def test_k6_readers_by_hand():
    run = _run({"gat.forward": 6, "gat.backward": 6})
    least = rg.gat_k6_least_s(1000, 8000, CONFIG)
    assert _read("k6_gat_roofline", run) == pytest.approx(
        100 * 2 * least / 50e-6)
    step = rg.gat_step_least_s(1000, 8000, CONFIG)
    assert _read("train_step_mfu.gat", run) == pytest.approx(
        100 * 2 * step / 100e-6)


@pytest.mark.parametrize("counters", [
    {"gat.forward": 5, "gat.backward": 6}, {"gat.forward": 6},
    {"spmm.weighted": 6}], ids=["short_forward", "no_backward", "no_k6"])
def test_k6_roofline_reads_nothing_off_the_model_s_launches(counters):
    assert _read("k6_gat_roofline", _run(counters)) is None


def test_the_gat_readers_read_nothing_untraced():
    run = _run({"gat.forward": 6, "gat.backward": 6}, trace=False)
    assert _read("k6_gat_roofline", run) is None
    assert _read("train_step_mfu.gat", run) is None


@pytest.mark.parametrize("cell", [GAT, BC])
def test_the_control_is_not_correct(cell, tiny_root):
    """The program passes, and the control and every planted fault fail
    one of the cell's limits, on every seed."""
    bench = Bench(tiny_root)
    limits = bench.workload(cell)["limits"]
    for seed in (1, 2, 3):
        row = calibrate.calibrate(bench, cell, seed, torch.device("cpu"),
                                  control=True)
        assert all(v <= limits[k] for k, v in row["program"].items()), row
        assert any(v > limits[k] for k, v in row["control"].items()), row
        faults = [k for k in row if k.startswith("fault.")]
        assert len(faults) == (3 if cell == GAT else 0)
        for name in faults:
            assert any(v > limits[k] for k, v in row[name].items()), name


def _break_gat(monkeypatch, fault):
    """The program's GAT broken underneath: a step that updates nothing,
    half of the batch left out of the loss, the self-loops dropped from
    every layer, or the attention's output altered in one row."""
    import cugraph_tpu_torch.nn as tnn
    from cugraph_tpu_torch.nn import layers, models
    from portbench.tests.test_portbench_faults import (_half_batch_loss,
                                                       _step_without_update)

    if fault == "state_unchanged":
        monkeypatch.setattr(tnn, "make_train_step", _step_without_update)
        return
    if fault == "half_batch":
        monkeypatch.setattr(models, "masked_cross_entropy",
                            _half_batch_loss(models.masked_cross_entropy))
        return
    real = layers.gat_attention

    def broken(g, x, s, t, *, self_loops=False, negative_slope=0.2):
        if fault == "no_self_loops":
            self_loops = False
        out = real(g, x, s, t, self_loops=self_loops,
                   negative_slope=negative_slope)
        if fault == "altered":
            scale = torch.ones(out.shape[0], 1, 1, dtype=out.dtype)
            scale[0] = 2.0
            out = out * scale
        return out

    monkeypatch.setattr(layers, "gat_attention", broken)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "no_self_loops", "altered"])
def test_gat_faults_are_not_correct(fault, tiny_root, on_cpu, capsys,
                                    monkeypatch):
    _break_gat(monkeypatch, fault)
    rc, result, err = run_cell(tiny_root, GAT, capsys)
    assert rc == 0 and result["correct"] is False, err


def _bc_frames(monkeypatch, change):
    from cugraph_tpu_torch.algos import centrality

    real = centrality.vertex_frame
    monkeypatch.setattr(centrality, "vertex_frame",
                        lambda G, values: change(real(G, values)))


def _half(df):
    return df.iloc[::2].reset_index(drop=True)


def _altered(df):
    values = df["betweenness_centrality"].to_numpy().copy()
    values[np.argmax(values)] *= 1.01
    return df.assign(betweenness_centrality=values)


def _unscaled(df):
    return df.assign(betweenness_centrality=df["betweenness_centrality"]
                     * 128 / len(df))


@pytest.mark.parametrize("fault", [_half, _altered, _unscaled],
                         ids=["half_the_vertices", "altered", "unscaled"])
def test_bc_faults_are_not_correct(fault, tiny_root, on_cpu, capsys,
                                   monkeypatch):
    _bc_frames(monkeypatch, fault)
    rc, result, err = run_cell(tiny_root, BC, capsys)
    assert rc == 0 and result["correct"] is False, err
