"""Whole runs of the harness on the CPU at a tiny size: discovery by name,
the refusal without a card, and what a run may import."""

import json
import os
import subprocess
import sys

import pytest

from portbench.registry import Bench
from portbench.tests.conftest import ROOT, run_cell

CELLS = [w["name"] for w in Bench(ROOT).spec["workloads"]]


def test_every_name_in_the_benchmark_finds_its_files():
    b = Bench(ROOT)
    for w in b.spec["workloads"]:
        workload = b.workload(w["name"])
        traffic = b.traffic(w["traffic"])
        assert b.config(w["config"])["name"] == w["config"]
        assert hasattr(b.module("entries", traffic["entry"]), "setup")
        ref = b.module("reference", workload["reference"])
        for fn in ("reference", "readings", "program_outputs",
                   "control_outputs", "fault_outputs"):
            assert hasattr(ref, fn)
        for trace in (False, True):
            for m in b.metrics(w["name"], trace):
                assert hasattr(b.module("metrics", m["name"]), "read")
    with pytest.raises(KeyError):
        b.cell("no.such_cell")
    with pytest.raises(ValueError):
        b.module("metrics", "../run")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_whole_run_on_the_cpu(cell, trace, tiny_root, on_cpu, capsys):
    rc, result, err = run_cell(tiny_root, cell, capsys, trace=trace)
    assert rc == 0 and result["correct"] is True, err
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    b = Bench(tiny_root)
    want = {m["name"] for m in b.metrics(cell, bool(trace))}
    # readers of the card's trace and counters find nothing on the CPU
    assert set(result["metrics"]) <= want
    if not trace:
        assert set(result["metrics"]) == want
        assert all(v["value"] > 0 for v in result["metrics"].values())
    for name in result["checks"]:
        assert f"check {name} " in err


def test_a_cell_added_as_files_only(tiny_root, on_cpu, capsys):
    """A new configuration, traffic mix, cell and per-layer metric: new
    files and new entries in BENCHMARK.json, nothing edited."""
    pb = os.path.join(tiny_root, "portbench")
    with open(os.path.join(pb, "configs", "graph500_22.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny_kron", scale=9, requested_edges=5000)
    with open(os.path.join(pb, "configs", "tiny_kron.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "traffic", "pagerank_5.json"), "w") as f:
        json.dump({"entry": "pagerank", "loop": "closed", "clients": 1,
                   "warmup_calls": 1,
                   "call": {"alpha": 0.5, "max_iter": 5, "tol": 0.0,
                            "fail_on_nonconvergence": False}}, f)
    with open(os.path.join(pb, "workloads", "tiny.pr5.json"), "w") as f:
        json.dump({"reference": "pagerank", "sample_calls": 2,
                   "limits": {"vertex_mismatch": 0,
                              "pagerank_max_rel_err": 1e-4}}, f)
    os.makedirs(os.path.join(pb, "metrics"))
    with open(os.path.join(pb, "metrics", "calls.tiny.py"), "w") as f:
        f.write("def read(run):\n    return run.window.calls\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny_kron", "source": "test",
                            "file": "portbench/configs/tiny_kron.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny.pr5", "config": "tiny_kron",
                              "traffic": "pagerank_5", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "calls.tiny", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "evps",
                              "workloads": ["tiny.pr5"]})
    for m in spec["end_to_end"]:
        if m["name"] == "evps":
            m["workloads"].append("tiny.pr5")
    with open(path, "w") as f:
        json.dump(spec, f)
    rc, result, err = run_cell(tiny_root, "tiny.pr5", capsys, trace=1)
    assert rc == 0 and result["correct"] is True, err
    assert result["metrics"]["calls.tiny"]["value"] == result["attempted"]
    rc, result, err = run_cell(tiny_root, "tiny.pr5", capsys, trace=0)
    assert {"setup_s", "evps"} <= set(result["metrics"])


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "no result" in proc.stderr


_RUN_AND_LIST = """
import json, sys, tempfile
sys.path.insert(0, {root!r})
import torch
from portbench import device, harness, calibrate
from portbench.tests.conftest import write_tiny_root
device.require = lambda chips: torch.device("cpu")
root = write_tiny_root(tempfile.mkdtemp())
for cell in {cells!r}:
    for trace in ("0", "1"):
        assert harness.main(["--workload", cell, "--seed", "3", "--seconds",
                             "0.1", "--trace", trace], root=root) == 0
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_REFERENCE_ONLY = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from portbench.reference import pagerank, sage_fullbatch, graph
s = torch.tensor([0, 1, 2, 3]); d = torch.tensor([1, 2, 3, 0])
ids, ss, dd = graph.undirected(s, d)
pagerank.pagerank(ss, dd, 4, 0.85, 3)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_modules(code):
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    names = _top_level_modules(_RUN_AND_LIST.format(root=ROOT, cells=CELLS))
    assert "cugraph_tpu_torch" in names and "portbench" in names
    for banned in ("jax", "jaxlib", "flax", "cugraph_tpu", "bench",
                   "benchmarks", "chip_smoke"):
        assert banned not in names


def test_the_reference_imports_nothing_of_the_port():
    names = _top_level_modules(_REFERENCE_ONLY.format(root=ROOT))
    assert "cugraph_tpu_torch" not in names and "cugraph_tpu" not in names


def test_the_harness_refuses_a_run_that_loaded_jax(tiny_root, on_cpu,
                                                    capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", object())
    rc, result, err = run_cell(tiny_root, CELLS[0], capsys)
    assert rc == 3 and result is None and "jax" in err


@pytest.mark.cuda
def test_a_whole_run_on_the_card(tiny_root, capsys):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for cell in CELLS:
        rc, result, err = run_cell(tiny_root, cell, capsys, seconds=1,
                                   trace=1)
        assert rc == 0 and result["correct"] is True, err
        assert result["device"]["platform"] == "gpu"
        assert result["device"]["busy_s"] > 0
