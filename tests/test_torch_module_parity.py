"""Module-by-module parity of the port with the JAX package.

Reads the sources of ``cugraph_tpu`` and ``cugraph_tpu_torch`` with
``ast`` (JAX is never imported) and holds three things:

(a) every ``cugraph_tpu/**/*.py`` has a port file at the same relative
    path, apart from ``NO_PORT_FILE``;
(b) every public top-level function, class or assignment of a JAX module,
    and every name a JAX package's ``__init__.py`` re-exports from the
    package, is defined or imported in its port module (a submodule of
    the port package counts for a package);
(c) every public method of a JAX class is held by the port's class of the
    same name: ``dir()`` of the imported port class, so inherited members
    count (``MultiGraph.is_multigraph``).

Exceptions live in ``BY_DESIGN``, keyed by module, then by name
(``Class.member`` for a member), each with a one-line reason that points
at ROADMAP §2 ("Not kernels"), §3 or the ground rules.  An entry is stale,
and fails, when the JAX module no longer defines the name or the port now
has it.  Signature differences that are PyTorch idiom (``key`` ->
``generator``, ``apply_fn`` -> ``model``, a ``device`` argument) are out
of this test's scope: the parity tests of each layer hold the behaviour.
"""

from __future__ import annotations

import ast
import functools
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX = ROOT / "cugraph_tpu"
PORT = ROOT / "cugraph_tpu_torch"

TILING = ("ROADMAP §2 'Not kernels': a TPU tile plan; the card's kernels "
          "read the CSR itself")
PADDING = ("ROADMAP §3 'Structure layout': the port has no sink row and no "
           "padding")
HOST_BUILD = ("ROADMAP §3 'Structure layout': the port builds its CSR/CSC "
              "on the device (core.structure.build_csr/build_structure)")
CARD_RUNS_IT = ("ROADMAP §2 'Not kernels': host code whose algorithm the "
                "card runs")
PALLAS = ("ROADMAP §2 'Not kernels': a Pallas switch; on the card a CUDA "
          "tensor always reaches its kernel (ground rules: no fallback, no "
          "edge-count threshold)")
SHARDING = ("ROADMAP §3 'Multi-device divergences': a JAX sharding "
            "spec; the port's ranks hold local CSR blocks")
NEIGHBOR_TABLE = ("ROADMAP §2 'Not kernels': the padded [V, D] neighbour "
                  "tables and the sort-merge intersections")

NO_PORT_FILE = {
    "kernels/spmv_onehot.py": "ROADMAP §2: the Pallas SpMV, ported as "
                              "K1-K3 under kernels/csrc/",
    "kernels/spmm_onehot.py": "ROADMAP §2: the Pallas SpMM, ported as K4, "
                              "K4's VJP and K5 under kernels/csrc/",
    "parallel/kernels.py": "ROADMAP §2 'Not kernels': the stacked TPU "
                           "plans of the multi-device layer",
    "prims/neighbor_table.py": NEIGHBOR_TABLE,
    "utils/benchcache.py": "ROADMAP §2 'Not kernels': benchmark plumbing, "
                           "not a public API",
}

BY_DESIGN = {
    "core/native.py": {
        "spmv_plan_native": TILING,
        "spmv_plan_count_native": TILING,
        "build_blocks_2d_native": TILING,
        "coo_to_csr_native": HOST_BUILD,
        "degrees_native": HOST_BUILD,
        "bfs_pred_from_dist_native": CARD_RUNS_IT,
        "pair_probe_native": CARD_RUNS_IT,
    },
    "core/structure.py": {
        "V_ALIGN": PADDING,
        "E_ALIGN": PADDING,
        "round_up": PADDING,
        "padded_vertex_count": PADDING,
        "build_csr_host": HOST_BUILD,
        "build_structure_host": HOST_BUILD,
        "CsrMatrix.pad_v": PADDING,
        "CsrMatrix.pad_e": PADDING,
        "CsrMatrix.sink": PADDING,
        "GraphStructure.pad_v": PADDING,
    },
    "kernels/__init__.py": {
        "SpmvPlan": TILING,
        "build_spmv_plan": TILING,
        "spmv_onehot": "ROADMAP §2: the Pallas SpMV, ported as K1-K3",
        "spmv_available": PALLAS,
    },
    "kernels/dispatch.py": {
        "PALLAS_MIN_EDGES": PALLAS,
        "pallas_min_edges": PALLAS,
        "pallas_enabled": PALLAS,
        "use_pallas": PALLAS,
        "AUTOTUNE_MIN_EDGES": TILING,
        "get_pull_plan": TILING,
        "get_push_plan": TILING,
        "get_sym_pull_plan": TILING,
    },
    "parallel/construct.py": {"BOTH": SHARDING},
    "parallel/mesh.py": {"vertex_spec": SHARDING, "edge_spec": SHARDING},
    "parallel/nn.py": {
        "mg_spmm_pallas_fn": "ROADMAP §2 'Not kernels': the stacked TPU "
                             "plans' SpMM (nn.mg_spmm_pallas_fn)",
        "mg_spmm_pallas_arg_fn": "ROADMAP §2 'Not kernels': the stacked "
                                 "TPU plans' SpMM (nn.mg_spmm_pallas_fn)",
    },
    "parallel/partition.py": {"E_ALIGN": PADDING},
    "parallel/prims.py": {"MAJOR": SHARDING, "MINOR": SHARDING},
    "prims/intersection.py": {
        "intersection_table_entries": NEIGHBOR_TABLE,
        "pair_intersection_auto": NEIGHBOR_TABLE,
        "pair_intersection_bucketed": NEIGHBOR_TABLE,
        "pair_intersection_sorted": NEIGHBOR_TABLE,
    },
}


def _rel(path: pathlib.Path) -> str:
    return path.relative_to(JAX).as_posix()


JAX_FILES = sorted(_rel(p) for p in JAX.rglob("*.py"))
PORTED = [f for f in JAX_FILES if f not in NO_PORT_FILE]


def _body(tree):
    """Top-level statements, with those inside top-level if/try blocks."""
    out = []
    for node in tree.body:
        out.append(node)
        if isinstance(node, (ast.If, ast.Try)):
            for block in (node.body, getattr(node, "orelse", []),
                          getattr(node, "finalbody", []),
                          *[h.body for h in getattr(node, "handlers", [])]):
                out.extend(_body(ast.Module(body=block, type_ignores=[])))
    return out


def _targets(node):
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    for t in targets:
        for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
            if isinstance(e, ast.Name):
                yield e.id


def _internal_import(node: ast.ImportFrom) -> bool:
    return bool(node.level) or (node.module or "").split(".")[0] == \
        "cugraph_tpu"


@functools.lru_cache(maxsize=None)
def _parse(rel: str, root: pathlib.Path):
    return ast.parse((root / rel).read_text(), filename=rel)


def jax_public(tree, is_package: bool):
    """The public names a JAX module defines, and for a package the names
    its ``__init__`` re-exports from the JAX package."""
    names = set()
    for node in _body(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            names.update(_targets(node))
        elif (is_package and isinstance(node, ast.ImportFrom)
              and _internal_import(node)):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def port_names(rel: str, tree):
    """Every name a port module binds at the top level (defined or
    imported), and for a package its submodules."""
    names = set()
    for node in _body(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            names.update(_targets(node))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    if rel.endswith("__init__.py"):
        here = (PORT / rel).parent
        names.update(p.stem for p in here.glob("*.py"))
        names.update(p.name for p in here.iterdir()
                     if (p / "__init__.py").exists())
    return names


def jax_methods(tree):
    """{public class: its public methods (properties and static methods
    included)} of a JAX module."""
    out = {}
    for node in _body(tree):
        if isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out[node.name] = {
                m.name for m in node.body
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                and not m.name.startswith("_")}
    return out


def _port_module(rel: str) -> str:
    parts = pathlib.PurePosixPath(rel).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(("cugraph_tpu_torch",) + parts)


def _allowed(rel):
    return BY_DESIGN.get(rel, {})


# -- (a) a port file for every JAX file ---------------------------------------

@pytest.mark.parametrize("rel", JAX_FILES)
def test_every_jax_file_has_a_port_file(rel):
    if rel in NO_PORT_FILE:
        assert not (PORT / rel).exists(), \
            f"{rel} is ported: take it out of NO_PORT_FILE"
    else:
        assert (PORT / rel).exists(), f"cugraph_tpu_torch/{rel} is missing"


def test_no_port_file_entries_are_current():
    for rel, reason in NO_PORT_FILE.items():
        assert (JAX / rel).exists(), f"stale NO_PORT_FILE entry {rel}"
        assert "ROADMAP" in reason, rel


# -- (b) every public top-level name ------------------------------------------

@pytest.mark.parametrize("rel", PORTED)
def test_public_names_have_counterparts(rel):
    want = jax_public(_parse(rel, JAX), rel.endswith("__init__.py"))
    have = port_names(rel, _parse(rel, PORT))
    missing = {n for n in want - have if n not in _allowed(rel)}
    assert not missing, f"cugraph_tpu_torch/{rel} lacks {sorted(missing)}"


# -- (c) every public method of every public class ----------------------------

CLASS_MODULES = [rel for rel in PORTED
                 if jax_methods(_parse(rel, JAX))]


@pytest.mark.parametrize("rel", CLASS_MODULES)
def test_class_members_have_counterparts(rel):
    module = importlib.import_module(_port_module(rel))
    allowed = _allowed(rel)
    for cls, methods in jax_methods(_parse(rel, JAX)).items():
        if cls in allowed:
            continue
        assert hasattr(module, cls), f"{_port_module(rel)} lacks {cls}"
        have = set(dir(getattr(module, cls)))
        missing = {m for m in methods - have
                   if f"{cls}.{m}" not in allowed}
        assert not missing, f"{_port_module(rel)}.{cls} lacks " \
                            f"{sorted(missing)}"


# -- the exceptions: each with a reason, none stale ----------------------------

@pytest.mark.parametrize("rel", sorted(BY_DESIGN))
def test_by_design_entries_are_current(rel):
    jtree = _parse(rel, JAX)
    public = jax_public(jtree, rel.endswith("__init__.py"))
    methods = jax_methods(jtree)
    have = port_names(rel, _parse(rel, PORT))
    module = importlib.import_module(_port_module(rel))
    for name, reason in BY_DESIGN[rel].items():
        assert reason.startswith("ROADMAP"), (rel, name)
        cls, _, member = name.partition(".")
        if member:
            assert member in methods.get(cls, ()), \
                f"stale: cugraph_tpu/{rel} has no method {name}"
            assert not hasattr(getattr(module, cls), member), \
                f"stale: the port's {name} exists now"
        else:
            assert name in public, \
                f"stale: cugraph_tpu/{rel} no longer defines {name}"
            assert name not in have, \
                f"stale: cugraph_tpu_torch/{rel} has {name} now"


# -- the port stands alone: its own datasets, no path into cugraph_tpu/ -------

DATA = "datasets/data"


@pytest.mark.parametrize("name", sorted(p.name for p in (JAX / DATA).iterdir()))
def test_dataset_copy_is_byte_identical(name):
    assert (PORT / DATA / name).read_bytes() == \
        (JAX / DATA / name).read_bytes()


def test_the_port_ships_every_dataset():
    assert sorted(p.name for p in (PORT / DATA).iterdir()) == \
        sorted(p.name for p in (JAX / DATA).iterdir())


PATH_CALLS = {"join", "Path", "PurePath", "PosixPath", "open"}


def _names_jax_dir(node) -> bool:
    return (isinstance(node, ast.Constant) and isinstance(node.value, str)
            and "cugraph_tpu" in node.value.replace("\\", "/").split("/"))


def jax_paths(tree):
    """Line numbers where a path is built with a "cugraph_tpu" component:
    ``os.path.join``, ``pathlib.Path`` (and ``/``) or ``open``.  A string
    that only names a JAX file:line for a reader (a docstring, a
    ``REPLACES`` constant, a message) builds no path and passes."""
    lines = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", None)
            if name in PATH_CALLS and any(
                    _names_jax_dir(a) for a in [*node.args, *[
                        k.value for k in node.keywords]]):
                lines.append(node.lineno)
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            if _names_jax_dir(node.left) or _names_jax_dir(node.right):
                lines.append(node.lineno)
    return lines


def test_no_port_file_builds_a_path_into_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    found = {str(p.relative_to(ROOT)): jax_paths(ast.parse(p.read_text()))
             for p in files}
    assert {k: v for k, v in found.items() if v} == {}
    # the check finds the form the datasets used before they shipped here
    assert jax_paths(ast.parse(
        'os.path.join(root, "cugraph_tpu", "datasets", "data")')) == [1]
    assert jax_paths(ast.parse('open("cugraph_tpu/datasets/data/x.csv")'))
    assert not jax_paths(ast.parse(
        'REPLACES = "cugraph_tpu/kernels/spmv_onehot.py:398"'))
