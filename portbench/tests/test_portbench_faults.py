"""The comparison that decides ``correct`` fails what it must: whole runs on
the CPU with the timed path broken underneath, once for each fault a cell
can have on one card, and each cell's control at a tiny size.

The faults: a call or step that leaves its state unchanged; half of the
batch left out, the mean over the rest; an answer altered where it is
produced.  (The exchange between cards is not a fault of a one-card cell.)
"""

import numpy as np
import pytest
import torch

from portbench import calibrate
from portbench.registry import Bench
from portbench.tests.conftest import run_cell

PAGERANK = "g500s22.pagerank"
SAGE = "products.sage3_fullbatch"


def _frames(monkeypatch, change):
    """Every frame ``pagerank`` returns, passed through ``change``."""
    from cugraph_tpu_torch.algos import link_analysis

    real = link_analysis.vertex_frame

    def broken(G, values):
        return change(real(G, values))

    monkeypatch.setattr(link_analysis, "vertex_frame", broken)


def _unchanged(df):
    return df.assign(pagerank=np.float32(1.0 / len(df)))


def _half(df):
    kept = df.iloc[::2].reset_index(drop=True)
    return kept.assign(pagerank=kept["pagerank"] / kept["pagerank"].sum())


def _altered(df):
    values = df["pagerank"].to_numpy().copy()
    values[len(values) // 2] *= 1.5
    return df.assign(pagerank=values)


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["state_unchanged", "half_batch", "altered"])
def test_pagerank_faults_are_not_correct(fault, tiny_root, on_cpu, capsys,
                                         monkeypatch):
    _frames(monkeypatch, fault)
    rc, result, err = run_cell(tiny_root, PAGERANK, capsys)
    assert rc == 0 and result["correct"] is False, err
    assert "FAILS" in err


def _step_without_update(model, optimizer):
    from cugraph_tpu_torch.nn.models import masked_cross_entropy

    def step(g, x, labels, mask):
        optimizer.zero_grad()
        loss = masked_cross_entropy(model(g, x), labels, mask)
        loss.backward()
        return loss.detach()

    return step


def _half_batch_loss(real):
    def loss(logits, labels, mask):
        rows = torch.nonzero(mask)[:, 0]
        half = mask.clone()
        half[rows[1::2]] = False
        return real(logits, labels, half)

    return loss


def _altered_aggregation(real):
    def aggregate(g, x, *, mode="mean"):
        out = real(g, x, mode=mode)
        scale = torch.ones(out.shape[0], 1, dtype=out.dtype,
                           device=out.device)
        scale[0] = 2.0
        return out * scale

    return aggregate


def _break_sage(monkeypatch, fault):
    import cugraph_tpu_torch.nn as tnn
    from cugraph_tpu_torch.nn import layers, models

    if fault == "state_unchanged":
        monkeypatch.setattr(tnn, "make_train_step", _step_without_update)
    elif fault == "half_batch":
        monkeypatch.setattr(models, "masked_cross_entropy",
                            _half_batch_loss(models.masked_cross_entropy))
    else:
        monkeypatch.setattr(layers, "aggregate_neighbors",
                            _altered_aggregation(layers.aggregate_neighbors))


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "altered"])
def test_training_faults_are_not_correct(fault, tiny_root, on_cpu, capsys,
                                         monkeypatch):
    _break_sage(monkeypatch, fault)
    rc, result, err = run_cell(tiny_root, SAGE, capsys)
    assert rc == 0 and result["correct"] is False, err


@pytest.mark.parametrize("cell", [PAGERANK, SAGE])
def test_the_control_is_not_correct(cell, tiny_root):
    """The reference in the precision below the configuration's, in the
    program's place, fails one of the cell's limits on every seed."""
    bench = Bench(tiny_root)
    limits = bench.workload(cell)["limits"]
    for seed in (1, 2, 3):
        row = calibrate.calibrate(bench, cell, seed, torch.device("cpu"),
                                  control=True)
        assert all(v <= limits[k] for k, v in row["program"].items()), row
        assert any(v > limits[k] for k, v in row["control"].items()), row
        for name in (k for k in row if k.startswith("fault.")):
            assert any(v > limits[k] for k, v in row[name].items()), name


def test_a_call_that_raises_is_failed_and_not_correct(tiny_root, on_cpu,
                                                      capsys, monkeypatch):
    from cugraph_tpu_torch.algos import link_analysis

    calls = {"n": 0}
    real = link_analysis.vertex_frame

    def sometimes(G, values):
        calls["n"] += 1
        if calls["n"] == 3:  # the warm-up makes 2; the window always a 3rd
            raise RuntimeError("lost answer")
        return real(G, values)

    monkeypatch.setattr(link_analysis, "vertex_frame", sometimes)
    rc, result, err = run_cell(tiny_root, PAGERANK, capsys)
    assert rc == 0 and result["correct"] is False
    assert result["failed"] == 1 and "lost answer" in err

