"""The multi-device port's Louvain, Leiden, ECG and contraction against
``cugraph_tpu.parallel``.

Each world (2×2, 2×1 and 1×2 gloo processes) runs
``torch_port_mg_analytics.community_body`` once in a module-scoped
fixture on the community graphs (``torch_port_mg``'s weighted, skewed and
star graphs and the 48-vertex three-blob graph, each symmetrized at the
build); each case compares one result with the JAX package's on a mesh
of the same shape over ``jax.devices()[:P]``, one cached JAX run per
(graph, mesh shape).

Bounds: the host engine's partitions, the coarse ids of either engine,
the host contraction's weights (sums of the same float32 values in
double), and Louvain's, Leiden's and ECG's labels bit for bit; their
modularity within 1e-9 relative (the port adds its float32 per-rank intra
partials in mesh position order as the JAX package adds its per-block
sums), except where a weighted graph's degrees enter: the port's
``build_dist_graph`` sums them in float64 per rank and rounds, the JAX
package in float32 in input order, a few ulps apart, which moves the
modularity by up to ~3.4e-8 (the move phase and the distributed levels
of the weighted graphs; the skewed graph's q is 0.005, so this is 6e-6
of it); there it is held within 1e-7 absolute, and the partitions stay
bit for bit.  ECG recomputes its degrees from the
jittered weights as the JAX package does, and the single-device cascade
takes its own, so both stay at 1e-9.  The device engine's partitions bit
for bit with its float32 modularity within 1e-5, and its contraction's
weights (float32 run sums in another order) within 1e-6; the JAX
package's own engine check, host against device modularity within 5e-4
and equal coarse COOs (ids exactly, weights within 1e-6).
"""

import functools
import importlib

import jax
import numpy as np
import pytest
import torch

from cugraph_tpu import parallel as jp


from torch_port_mg import WORLDS, run_worlds
from torch_port_mg_analytics import COMMUNITY, ECG_SIZE, community_body

# the module, not the package's ``louvain`` alias of mg_louvain
jl = importlib.import_module("cugraph_tpu.parallel.louvain")
torch.set_num_threads(1)
NAMES = sorted(COMMUNITY)
Q_RTOL = 1e-9
# the modularity read through a weighted graph's degrees (see above)
Q_ATOL_DEGREES = 1e-7
W_RTOL = 1e-6


def _q_bound(name, label):
    """(rtol, atol) of a modularity case."""
    weighted = COMMUNITY[name][2] is not None
    if weighted and label in ("move_host", "louvain_mg", "leiden"):
        return 0.0, Q_ATOL_DEGREES
    return Q_RTOL, 0.0


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return run_worlds(tmp_path_factory.mktemp("community"), community_body,
                      {shape: (COMMUNITY,) for shape in WORLDS})


@pytest.fixture(params=[(w, name) for w in WORLDS for name in NAMES],
                ids=[f"{a}x{b}-{name}" for a, b in WORLDS for name in NAMES])
def case(request, worlds):
    (pmaj, pmin), name = request.param
    res = worlds[(pmaj, pmin)]
    return name, {k[len(name) + 1:]: v for k, v in res.items()
                  if k.startswith(name + "/")}, _jax(name, pmaj, pmin)


@functools.lru_cache(maxsize=None)
def _jax(name, pmaj, pmin):
    """Every JAX result of one (graph, mesh shape), computed once."""
    src, dst, w, n = COMMUNITY[name]
    mesh = jp.make_mesh_2d(pmaj, pmin, jax.devices()[:pmaj * pmin])
    g = jp.build_dist_graph(src, dst, w, n, pmaj, pmin, store_push=True,
                            symmetrize=True)
    out = {}
    for engine in ("host", "device"):
        out[f"move_{engine}"] = jl.mg_louvain_move_phase(g, mesh,
                                                         engine=engine)
    lab_full = np.zeros(g.pad_v, np.int32)
    _, lab_full[:n] = np.unique(out["move_host"][0][:n],
                                return_inverse=True)
    out["lab_full"] = lab_full
    for engine in ("host", "device"):
        out[f"coarsen_{engine}"] = jl.mg_coarsen(g, mesh, lab_full,
                                                 engine=engine)
    out["louvain"] = jl.mg_louvain(g, mesh)
    out["louvain_mg"] = jl.mg_louvain(g, mesh, sg_threshold_edges=0)
    out["leiden"] = jl.mg_leiden(g, mesh)
    out["ecg"] = jp.mg_ecg(g, mesh, ensemble_size=ECG_SIZE, seed=3)
    return out


def _q(got, want, rtol, atol=0.0):
    assert abs(float(got) - float(want)) <= atol + rtol * abs(float(want)), \
        (float(got), float(want))


def test_move_phase_host_engine(case):
    name, got, want = case
    cl, q = want["move_host"]
    np.testing.assert_array_equal(got["move_host/cluster"], cl)
    _q(got["move_host/q"], q, *_q_bound(name, "move_host"))


def test_move_phase_device_engine(case):
    name, got, want = case
    cl, q = want["move_device"]
    np.testing.assert_array_equal(got["move_device/cluster"], cl)
    _q(got["move_device/q"], q, 1e-5)


def test_engines_agree(case):
    """The JAX package's own check (tests/test_parallel_kernels.py:
    200-235) on the port: host against device modularity within 5e-4, and
    the two contractions give equal coarse COOs."""
    name, got, _ = case
    assert abs(float(got["move_host/q"]) - float(got["move_device/q"])) \
        <= 5e-4
    for k in (0, 1, 3):
        np.testing.assert_array_equal(got[f"coarsen_host/{k}"],
                                      got[f"coarsen_device/{k}"])
    np.testing.assert_allclose(got["coarsen_device/2"],
                               got["coarsen_host/2"], rtol=W_RTOL)


@pytest.mark.parametrize("engine", ["host", "device"])
def test_coarsen(case, engine):
    name, got, want = case
    for k, a in enumerate(want[f"coarsen_{engine}"]):
        if k == 2 and engine == "device":
            np.testing.assert_allclose(got[f"coarsen_{engine}/{k}"],
                                       np.asarray(a), rtol=W_RTOL)
        else:
            np.testing.assert_array_equal(got[f"coarsen_{engine}/{k}"],
                                          np.asarray(a))


@pytest.mark.parametrize("algo", ["louvain", "louvain_mg", "leiden", "ecg"])
def test_levels(case, algo):
    """Louvain with the single-device cascade after the first level, with
    every level distributed (sg_threshold_edges=0), Leiden and ECG."""
    name, got, want = case
    labels, q = want[algo]
    np.testing.assert_array_equal(got[f"{algo}/labels"], labels)
    _q(got[f"{algo}/q"], q, *_q_bound(name, algo))


def test_louvain_records_its_levels(case):
    """``LAST_RUN`` after mg_louvain: with every level distributed, the
    first coarse DistGraph is the first contraction's COO (the same
    partition as the host move phase) unless that has one cluster; the
    small graphs never pass the default threshold, so their cascade is
    all single-device."""
    name, got, want = case
    edges = got["louvain_mg/coarse_edges"]
    cu, nc = np.asarray(want["coarsen_host"][0]), int(want["coarsen_host"][3])
    if nc > 1:
        assert edges[0] == len(cu)
    else:
        assert len(edges) == 0
    assert len(got["louvain/coarse_edges"]) == 0
    assert int(got["louvain/single_device_levels"]) >= 1


def _modularity_f64(s, d, w, lab):
    """float64 modularity of ``lab``: k the weighted out-degree, every
    stored edge once."""
    w = w.astype(np.float64)
    m2 = w.sum()
    k = np.bincount(s, weights=w, minlength=len(lab))
    sigma = np.bincount(lab, weights=k)
    return w[lab[s] == lab[d]].sum() / m2 - np.sum((sigma / m2) ** 2)


def test_ecg_modularity_on_its_weights(case):
    """ECG's q is the float64 modularity of its labels on the reweighted
    graph that ``LAST_RUN`` keeps, and each of that graph's weights is the
    input's times min_weight + (1 − min_weight)·votes/size for a whole
    vote count in [0, size]."""
    name, got, _ = case
    s, d, w = got["ecg/src"], got["ecg/dst"], got["ecg/w"]
    _q(got["ecg/q"], _modularity_f64(s, d, w, got["ecg/labels"]), 1e-6)
    frac = (w / got["ecg/w0"]).astype(np.float64)
    votes = np.rint((frac - 0.05) / 0.95 * ECG_SIZE)
    assert votes.min() >= 0 and votes.max() <= ECG_SIZE
    np.testing.assert_allclose(frac, 0.05 + 0.95 * votes / ECG_SIZE,
                               rtol=1e-6)


def test_engine_flag(monkeypatch):
    """An unknown engine raises; the variable picks the engine as the JAX
    package reads it."""
    from cugraph_tpu_torch.parallel.louvain import _engine

    monkeypatch.setenv("CUGRAPH_TPU_MG_SWEEP_ENGINE", "device")
    assert _engine(None) == "device"
    monkeypatch.delenv("CUGRAPH_TPU_MG_SWEEP_ENGINE")
    assert _engine(None) == "host"
    with pytest.raises(ValueError):
        _engine("gpu")
