"""Fixtures of the harness's CPU tests: a checkout of tiny cells.

The card tests carry the ``cuda`` marker and decide inside the test body
whether there is a card.
"""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {"scale": 10, "requested_edges": 12000}
TINY_SAGE = {"in_dim": 12, "hidden_dim": 16, "out_dim": 5,
             "train_vertices": 200}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


def write_tiny_root(path) -> str:
    """A checkout holding ``BENCHMARK.json`` and the data files of every
    cell, each configuration cut to scale 10 (and narrow widths), so that a
    whole run takes about a second on the CPU; the code is found beside the
    harness."""
    root = str(path)
    for kind in ("traffic", "workloads"):
        shutil.copytree(os.path.join(ROOT, "portbench", kind),
                        os.path.join(root, "portbench", kind))
    os.makedirs(os.path.join(root, "portbench", "configs"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        cfg.update(TINY)
        if "in_dim" in cfg:
            cfg.update(TINY_SAGE)
        with open(os.path.join(root, c["file"]), "w") as f:
            json.dump(cfg, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return write_tiny_root(tmp_path)


@pytest.fixture
def on_cpu(monkeypatch):
    """Skip the harness's look for a card: the run drives the CPU."""
    import torch

    from portbench import device

    monkeypatch.setattr(device, "require",
                        lambda chips: torch.device("cpu"))


def run_cell(root, cell, capsys, seed=20240611, seconds=0.2, trace=0):
    """(exit code, the result line as a dict or None, standard error)."""
    from portbench import harness

    rc = harness.main(["--workload", cell, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      root=root)
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    result = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, result, err
