"""Find a cell's files by the names in ``BENCHMARK.json``.

Data files (``workloads/``, ``traffic/``, configurations) are read from the
checkout the run is given; code (``entries/``, ``reference/``,
``metrics/``) is looked for first in that checkout's ``portbench/`` and
then beside this file.  So a later cell, traffic mix, configuration or
metric is a new file and a new entry in ``BENCHMARK.json``, never an edit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class Bench:
    """``BENCHMARK.json`` of one checkout, with lookups by cell name."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        path = os.path.join(self.root, "BENCHMARK.json")
        with open(path) as f:
            self.spec = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return read_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def _data(self, kind: str, name: str) -> dict:
        return read_json(os.path.join(self.root, "portbench", kind,
                                      f"{_checked(name)}.json"))

    def workload(self, name: str) -> dict:
        return self._data("workloads", name)

    def traffic(self, name: str) -> dict:
        return self._data("traffic", name)

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics (``trace`` False) or per-layer
        metrics (True): those whose ``workloads`` list the cell, and those
        without the key."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.spec[kind]
                if cell in m.get("workloads", [cell])]

    def module(self, kind: str, name: str):
        """``<kind>/<name>.py``, from the checkout or beside this file."""
        _checked(name)
        for base in (os.path.join(self.root, "portbench"), HERE):
            path = os.path.join(base, kind, f"{name}.py")
            if os.path.isfile(path):
                return load_module(path, f"portbench_{kind}_{name}")
        raise FileNotFoundError(f"no {kind}/{name}.py")


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, label: str):
    """Import a file by path: metric names hold dots, which ``import``
    cannot spell."""
    spec = importlib.util.spec_from_file_location(
        re.sub(r"[^A-Za-z0-9_]", "_", label), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _checked(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"{name!r} is not a benchmark name")
    return name
