"""The port's ``plc.comms``, ``mtmg``, ``dask`` and the multi-device
long-tail names (``testing.make_test_mesh``,
``utils.memory.estimate_dist_graph_bytes``, ``HostStagingBuffer``'s mesh
placement) against the JAX package's.

The one-process cases bring up a gloo group of one rank in this process
and destroy it before they end; the two-process ``cugraph_comms_init``
world meets over a ``TCPStore`` on 127.0.0.1 (spawned processes,
``torch_port_plc_mg.run_comms_world``); the long-tail names run in
``torch_port_mg``'s 2×2, 2×1 and 1×2 gloo worlds.  PageRank is held
within rtol 1e-5, atol 1e-7 of the JAX package's on a mesh of the same
shape (the MG power-method bound); the estimate within 10 % of the built
bytes.
"""

import contextlib
import threading

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from cugraph_tpu import plc as jplc
from cugraph_tpu.parallel.mesh import make_mesh_2d as jax_mesh
from cugraph_tpu_torch import plc
from cugraph_tpu_torch.plc import comms

from torch_port_mg import WORLDS, run_worlds
from torch_port_plc_mg import coo, longtail_body, run_comms_world

torch.set_num_threads(1)
POWER = dict(rtol=1e-5, atol=1e-7)


@contextlib.contextmanager
def one_rank_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _jax_pagerank(pmaj, pmin):
    src, dst, w, _, _ = coo()
    h = jplc.ResourceHandle(mesh=jax_mesh(pmaj, pmin,
                                          jax.devices()[:pmaj * pmin]))
    return jplc.pagerank(h, jplc.MGGraph(h, None, src, dst, w),
                         epsilon=1e-6, max_iterations=200)[1]


def test_get_2d_div_is_the_jax_one():
    from cugraph_tpu.plc.comms.cugraph_comms import _get_2D_div as jdiv
    from cugraph_tpu_torch.plc.comms.cugraph_comms import _get_2D_div

    for n in range(1, 65):
        assert _get_2D_div(n) == jdiv(n), n


def test_names_match_jax():
    from cugraph_tpu.plc import comms as jcomms

    assert set(comms.__all__) == set(jcomms.__all__)
    assert comms.cugraph_nccl_comms is comms.cugraph_comms
    uid = comms.cugraph_comms_create_unique_id(host="127.0.0.1")
    host, port = uid.rsplit(":", 1)
    assert host == "127.0.0.1" and 0 < int(port) < 65536


def test_init_one_process():
    """A world of one over a HashStore: the handle's 1×1 gloo mesh on the
    CPU, a second init refused, PageRank on an MGGraph of the handle
    against the JAX package's, and a shutdown that ends the group it
    started."""
    assert not dist.is_initialized()
    h = comms.cugraph_comms_init(0, 1, device="cpu")
    try:
        m = h.get_mesh()
        assert (m.pmaj, m.pmin, m.device.type) == (1, 1, "cpu")
        assert comms.cugraph_comms_get_raft_handle() is h
        with pytest.raises(RuntimeError, match="already been initialized"):
            comms.cugraph_comms_init(0, 1, device="cpu")
        src, dst, w, _, _ = coo()
        g = plc.MGGraph(h, None, src, dst, w)
        np.testing.assert_allclose(
            plc.pagerank(h, g, epsilon=1e-6, max_iterations=200)[1],
            _jax_pagerank(1, 1), **POWER)
    finally:
        comms.cugraph_comms_shutdown()
    assert not dist.is_initialized()
    assert comms.cugraph_comms_get_raft_handle() is None


def test_init_needs_the_uid_and_keeps_a_callers_group():
    with pytest.raises(ValueError, match="unique id"):
        comms.cugraph_comms_init(0, 2, device="cpu")
    assert not dist.is_initialized()
    with one_rank_group():
        h = comms.cugraph_comms_init(0, 1, device="cpu")
        comms.cugraph_comms_shutdown()
        assert dist.is_initialized()       # the caller's group stays
        assert h.mesh.size == 1


def test_init_subcomms():
    with pytest.raises(RuntimeError, match="not initialised"):
        comms.init_subcomms(plc.ResourceHandle(device="cpu"), 1)
    with one_rank_group():
        h = comms.init_subcomms(plc.ResourceHandle(device="cpu"), 1)
        assert (h.mesh.pmaj, h.mesh.pmin) == (1, 1)
        with pytest.raises(ValueError, match="does not divide"):
            comms.init_subcomms(plc.ResourceHandle(device="cpu"), 2)
        # get_mesh without init_subcomms: make_mesh_2d over the group
        assert plc.ResourceHandle(device="cpu").get_mesh().size == 1
    with pytest.raises(RuntimeError, match="not initialised"):
        plc.ResourceHandle(device="cpu").get_mesh()


def test_init_two_processes(tmp_path):
    """Two spawned ranks meet at the uid's store: the 1×2 mesh of
    ``_get_2D_div(2)``, a second init refused, PageRank equal on both and
    within the bound of the JAX package's on a 1×2 mesh, and shutdown."""
    ranks = run_comms_world(tmp_path, 2)
    want = _jax_pagerank(1, 2)
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["mesh"], [1, 2, 0, r])
        assert bool(res["again"]) and bool(res["handle"])
        assert bool(res["down"])
        np.testing.assert_array_equal(res["pagerank"], ranks[0]["pagerank"])
        np.testing.assert_allclose(res["pagerank"], want, **POWER)


# -- mtmg ---------------------------------------------------------------------

def _chunks():
    """``tests/test_mtmg_etl.py``'s four chunks."""
    rng = np.random.default_rng(0)
    return [(rng.integers(0, 64, 200), rng.integers(0, 64, 200))
            for _ in range(4)]


def _threaded_edgelist(mod, im):
    el = mod.PerThreadEdgelist()

    def worker(c):
        h = im.get_handle()
        assert h.device is not None
        h.sync()
        s, d = c
        el.append(s[:100], d[:100])
        el.append(s[100:], d[100:])
        el.flush()

    threads = [threading.Thread(target=worker, args=(c,))
               for c in _chunks()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return el


def test_mtmg_threaded_build_and_pagerank():
    """``tests/test_mtmg_etl.py:25``: four threads append chunks, one
    DistGraph is built (here over this process's one-rank group, equal to
    a direct build of the consolidated list), and its MG PageRank is held
    against the JAX package's run on its 4×2 mesh."""
    from cugraph_tpu import mtmg as jm
    from cugraph_tpu.parallel import mg_pagerank as jpr
    from cugraph_tpu_torch import mtmg
    from cugraph_tpu_torch.parallel import (all_gather_vertex,
                                            build_dist_graph, mg_pagerank)

    rm = mtmg.ResourceManager()
    rm.register_local_gpu(0, "cpu")
    im = rm.create_instance_manager()
    el = _threaded_edgelist(mtmg, im)
    src, dst, w = el.consolidate()
    assert len(src) == 800 and w is None
    with one_rank_group():
        g, mesh = mtmg.GraphHandle(im).create_graph(el, num_vertices=64)
        direct = build_dist_graph(src, dst, None, 64, mesh, store_push=True)
        for a, b in ((g.pull, direct.pull), (g.push, direct.push)):
            assert torch.equal(a.offsets, b.offsets)
            assert torch.equal(a.indices, b.indices)
        p, _, _ = mg_pagerank(g, mesh, tol=1e-7, max_iter=100)
        p = all_gather_vertex(mesh, p).numpy()[:64]

    jrm = jm.ResourceManager()
    for r in range(8):
        jrm.register_local_gpu(r, jax.devices()[r])
    jim = jrm.create_instance_manager()
    jg, jmesh = jm.GraphHandle(jim).create_graph(
        _threaded_edgelist(jm, jim), num_vertices=64)
    want = np.asarray(jpr(jg, jmesh, tol=1e-7, max_iter=100)[0])[:64]
    np.testing.assert_allclose(p, want, **POWER)
    np.testing.assert_allclose(p.sum(), 1.0, atol=1e-3)


def test_mtmg_devices_and_one_device_per_process():
    from cugraph_tpu_torch import mtmg

    rm = mtmg.ResourceManager()
    rm.register_local_gpu(3)
    rm.register_local_device(1, "cpu")
    assert rm.registered_ranks() == [1, 3]
    assert rm.devices() == [torch.device("cpu"), torch.device("cuda:3")]
    assert rm.create_instance_manager(ranks=[1]).size() == 1
    im = rm.create_instance_manager()
    assert [im.get_handle().get_rank() for _ in range(3)] == [0, 1, 0]
    with pytest.raises(ValueError, match="one process per device"):
        mtmg.GraphHandle(im).create_graph(mtmg.PerThreadEdgelist())
    with pytest.raises(ValueError, match="no devices"):
        mtmg.InstanceManager([])


# -- dask -----------------------------------------------------------------------

def test_dask_names_match_jax():
    import cugraph_tpu.dask as jd
    import cugraph_tpu_torch.dask as td
    from cugraph_tpu_torch import parallel as tp

    def public(m):
        # submodules are attributes once imported anywhere: left out
        return {n for n in dir(m) if not n.startswith("_")
                and not isinstance(getattr(m, n), type(np))}

    assert public(jd) <= public(td)
    assert public(td) - public(jd) <= public(tp)
    for name in ("pagerank", "bfs", "louvain", "all_pairs_jaccard",
                 "weakly_connected_components", "uniform_random_walks"):
        assert getattr(td, name) is getattr(tp, name)


# -- the long-tail names ----------------------------------------------------------

def test_make_test_mesh_raises_without_a_fitting_group():
    from cugraph_tpu_torch.testing import make_test_mesh

    with pytest.raises(RuntimeError, match="not initialised"):
        make_test_mesh()
    with one_rank_group():
        with pytest.raises(ValueError, match="4x2 mesh over 1 ranks"):
            make_test_mesh()
        assert make_test_mesh(1, 1).device.type == "cpu"


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return run_worlds(tmp_path_factory.mktemp("longtail"), longtail_body,
                      {shape: () for shape in WORLDS})


@pytest.mark.parametrize("shape", WORLDS, ids=[f"{a}x{b}" for a, b in
                                               WORLDS])
def test_longtail_in_a_world(worlds, shape):
    from cugraph_tpu_torch.utils.memory import estimate_dist_graph_bytes

    res = worlds[shape]
    pmaj, pmin = shape
    np.testing.assert_array_equal(res["test_mesh"], [pmaj, pmin, 0, 0, 1])
    n, m = res["graph_shape"]
    est = estimate_dist_graph_bytes(int(n), int(m), pmaj, pmin)
    assert abs(est - int(res["graph_bytes"])) <= 0.1 * int(
        res["graph_bytes"]), (est, int(res["graph_bytes"]))
    rows = np.arange(pmaj * pmin * 6 * 3, dtype=np.float32).reshape(-1, 3)
    np.testing.assert_array_equal(res["staged"], rows)
    assert bool(res["staged_device"])
