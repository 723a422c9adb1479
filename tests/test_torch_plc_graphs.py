"""The port's plc containers and internal types against ``cugraph_tpu.plc``
on the CPU: ``SGGraph`` (flags, counts, the stored edges, symmetric input
with and without ``symmetrize``, multigraphs, edge properties),
``ResourceHandle``'s device, ``CuGraphRandomState``'s seeds, ``COO``,
``SamplingResult`` and ``EdgeIdLookupResult``, and the ``dir()`` parity of
the two ``plc`` packages.  Every comparison is exact.
"""

import json
import subprocess
import sys
import types

import numpy as np
import pandas as pd
import pytest
import torch

import cugraph_tpu.plc as jp

import cugraph_tpu_torch as tt
import cugraph_tpu_torch.plc as tp

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _edges(seed=3, n=30, m=120):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, m) * 5 + 11, rng.integers(0, n, m) * 5 + 11
    src[:4] = dst[:4]                                   # self-loops
    src[4:10], dst[4:10] = src[10:16], dst[10:16]       # repeated pairs
    src[16:20], dst[16:20] = dst[20:24], src[20:24]     # reversed pairs
    w = rng.uniform(0.5, 2.0, m).astype(np.float32)
    return src, dst, w


def _pair(props_kw, *arrays, **kw):
    ht = tp.ResourceHandle(device="cpu")
    hj = jp.ResourceHandle()
    return (tp.SGGraph(ht, tp.GraphProperties(**props_kw), *arrays, **kw),
            jp.SGGraph(hj, jp.GraphProperties(**props_kw), *arrays, **kw))


def _stored(G):
    """The stored edge list in external ids, sorted, with every column."""
    src, dst, w = G.edgelist_arrays()
    cols = {"src": G.number_map.to_external(src),
            "dst": G.number_map.to_external(dst)}
    if w is not None:
        cols["w"] = w
    for name in ("edge_ids", "edge_types", "edge_times"):
        if getattr(G, name) is not None:
            cols[name] = np.asarray(getattr(G, name))
    df = pd.DataFrame(cols)
    return df.sort_values(list(df.columns)).reset_index(drop=True)


def _same_graph(gt, gj):
    Gt, Gj = gt.graph(), gj.graph()
    assert gt.number_of_vertices() == gj.number_of_vertices()
    assert gt.number_of_edges() == gj.number_of_edges()
    assert gt.weighted == gj.weighted
    assert gt.properties.is_symmetric == gj.properties.is_symmetric
    assert gt.properties.is_multigraph == gj.properties.is_multigraph
    assert Gt.is_directed() == Gj.is_directed()
    assert Gt.is_multigraph() == Gj.is_multigraph()
    assert type(Gt).__name__ == type(Gj).__name__
    assert Gt.device == CPU
    np.testing.assert_array_equal(np.sort(Gt.nodes()), np.sort(Gj.nodes()))
    pd.testing.assert_frame_equal(_stored(Gt), _stored(Gj))


GRAPHS = {
    "directed": ({}, (), {}),
    "unweighted": ({}, (), dict(weighted=False)),
    "symmetric_as_is": (dict(is_symmetric=True), (), {}),
    "symmetric_symmetrize": (dict(is_symmetric=True), (),
                             dict(symmetrize=True)),
    "multigraph": (dict(is_multigraph=True), (), {}),
    "multigraph_symmetrize": (dict(is_multigraph=True, is_symmetric=True),
                              (), dict(symmetrize=True)),
    "properties": ({}, (), dict(props=True)),
    "no_renumber": ({}, (), dict(renumber=False,
                                 vertices_array=np.arange(200))),
}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_sggraph_matches_jax(name):
    props_kw, _, opts = GRAPHS[name]
    opts = dict(opts)
    src, dst, w = _edges()
    if not opts.pop("weighted", True):
        w = None
    if opts.pop("props", False):
        m = len(src)
        opts.update(edge_id_array=np.arange(m, dtype=np.int64) * 2,
                    edge_type_array=(np.arange(m) % 4).astype(np.int32),
                    edge_start_time_array=np.linspace(0, 9, m)
                    .astype(np.float32))
    gt, gj = _pair(props_kw, src, dst, w, **opts)
    _same_graph(gt, gj)


def test_symmetric_flag_is_semantic():
    """A symmetric COO holds both directions: the graph is undirected,
    stores the edges as given, and counts each pair once."""
    src, dst = np.array([0, 1, 1, 2]), np.array([1, 0, 2, 1])
    gt, gj = _pair(dict(is_symmetric=True), src, dst, None)
    _same_graph(gt, gj)
    assert not gt.graph().is_directed()
    assert gt.number_of_edges() == 2
    assert len(gt.graph().edgelist_arrays()[0]) == 4
    st, sj = _pair(dict(is_symmetric=True), src[::2], dst[::2], None,
                   symmetrize=True)
    _same_graph(st, sj)
    assert len(st.graph().edgelist_arrays()[0]) == 4


def test_only_coo_input():
    for P in (tp, jp):
        h = P.ResourceHandle(device="cpu") if P is tp else P.ResourceHandle()
        with pytest.raises(ValueError, match="COO"):
            P.SGGraph(h, None, np.array([0, 1]), np.array([1, 2]), None,
                      input_array_format="CSR")


def test_resource_handle_device():
    h = tp.ResourceHandle(device="cpu")
    assert h.device == CPU
    G = tp.SGGraph(h, None, np.array([0, 1]), np.array([1, 2]), None)
    assert G.graph().device == CPU
    assert G.graph().structure.csr.offsets.device == CPU
    G2 = tp.SGGraph(tp.ResourceHandle(device=torch.device("cpu")), None,
                    np.array([0]), np.array([1]), None)
    assert G2.graph().device == CPU
    # the legacy CSR input of wcc builds its graph on the handle's device
    v, lab = tp.weakly_connected_components(h, None, np.array([0, 1, 1]),
                                            np.array([1]))
    np.testing.assert_array_equal(lab, [0, 0])


def test_default_handle_is_the_card():
    """``ResourceHandle()`` and a None handle mean the card: without one
    they raise, as ``Graph()`` does."""
    if torch.cuda.is_available():
        assert tp.ResourceHandle().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.ResourceHandle()
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.SGGraph(None, None, np.array([0]), np.array([1]), None)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.CuGraphRandomState(None, 3).next_key()


@pytest.mark.parametrize("seed", [None, 0, 7, 2**40 + 3])
def test_random_state_seeds_match_jax(seed):
    st = tp.CuGraphRandomState(tp.ResourceHandle(device="cpu"), seed)
    sj = jp.CuGraphRandomState(jp.ResourceHandle(), seed)
    assert [st.next_seed() for _ in range(6)] == \
        [sj.next_seed() for _ in range(6)]


def test_random_state_keys():
    """``next_key`` is a generator seeded with the next seed of the same
    sequence, on the handle's device; it advances the count as a seed
    does, as the JAX key does."""
    h = tp.ResourceHandle(device="cpu")
    st, ref = tp.CuGraphRandomState(h, 11), tp.CuGraphRandomState(h, 11)
    sj = jp.CuGraphRandomState(jp.ResourceHandle(), 11)
    for _ in range(3):
        g = st.next_key()
        sj.next_key()
        assert isinstance(g, torch.Generator) and g.device == CPU
        assert g.initial_seed() == ref.next_seed()
    assert st.next_seed() == sj.next_seed() == ref.next_seed()
    a = torch.rand(4, generator=tp.CuGraphRandomState(h, 11).next_key())
    b = torch.rand(4, generator=tp.CuGraphRandomState(h, 11).next_key())
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_seed_resolution_matches_jax():
    from cugraph_tpu.plc import algorithms as ja
    from cugraph_tpu_torch.plc import algorithms as ta

    for rs in (None, 0, 5, np.int64(9), "label", (1, 2)):
        assert ta._seed(rs) == ja._seed(rs)


# -- internal types -------------------------------------------------------------

def _small_graph():
    src = np.array([0, 0, 1, 1, 2, 3, 3, 4], np.int64)
    dst = np.array([1, 2, 2, 3, 4, 4, 0, 1], np.int64)
    kw = dict(weight_array=np.arange(1, 9, dtype=np.float32),
              edge_id_array=np.arange(8, dtype=np.int64),
              edge_type_array=np.zeros(8, np.int32))
    return tp.SGGraph(tp.ResourceHandle(device="cpu"), tp.GraphProperties(),
                      src, dst, **kw)


ACCESSORS = [n for n in dir(jp.SamplingResult) if n.startswith("get_")]


def test_sampling_result_frame_accessors():
    G = _small_graph()
    out = tp.homogeneous_uniform_neighbor_sample(
        None, G, np.array([0, 1]), h_fan_out=np.array([2, 2]),
        with_replacement=False, random_state=7, with_edge_properties=True,
        return_hops=True)
    res = tp.SamplingResult(out)
    majors, minors = res.get_majors(), res.get_minors()
    assert majors is not None and minors is not None
    assert len(majors) == len(minors) > 0
    np.testing.assert_array_equal(res.get_sources(), majors)
    np.testing.assert_array_equal(res.get_destinations(), minors)
    assert res.get_edge_weights() is not None
    np.testing.assert_array_equal(res.get_indices(), res.get_edge_weights())
    assert res.get_hop() is not None
    assert res.get_renumber_map() is None
    assert res.get_major_offsets() is None
    # the JAX class reads the same fields from the same frame
    ref = jp.SamplingResult(out)
    for name in ACCESSORS:
        a, b = getattr(res, name)(), getattr(ref, name)()
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_sampling_result_renumbered_accessors():
    G = _small_graph()
    out = tp.homogeneous_uniform_neighbor_sample(
        None, G, np.array([0, 1]), h_fan_out=np.array([2, 2]),
        with_replacement=False, random_state=7, with_edge_properties=True,
        renumber=True, compression="CSR", batch_id_list=np.array([0, 0]))
    res = tp.SamplingResult.from_sampler_output(out)
    assert res.get_major_offsets() is not None
    assert res.get_minors() is not None
    assert res.get_renumber_map() is not None
    assert res.get_renumber_map_offsets() is not None
    assert res.get_label_hop_offsets() is not None
    np.testing.assert_array_equal(res.get_offsets(),
                                  res.get_label_hop_offsets())
    ref = jp.SamplingResult(out)
    for name in ACCESSORS:
        a, b = getattr(res, name)(), getattr(ref, name)()
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert tp.SamplingResult().get_minors() is None


def test_coo_and_lookup_result_types():
    coo = tp.COO(np.array([0, 1]), np.array([1, 2]),
                 edge_ids=np.array([5, 6]))
    np.testing.assert_array_equal(coo.get_sources(), [0, 1])
    np.testing.assert_array_equal(coo.get_destinations(), [1, 2])
    np.testing.assert_array_equal(coo.get_edge_ids(), [5, 6])
    assert coo.get_edge_types() is None and coo.get_edge_weights() is None
    full = tp.COO([0], [1], [2], [3], [0.5])
    np.testing.assert_array_equal(full.get_edge_types(), [3])
    np.testing.assert_array_equal(full.get_edge_weights(), [0.5])

    r = tp.EdgeIdLookupResult(np.array([3]), np.array([4]))
    np.testing.assert_array_equal(r.get_sources(), [3])
    np.testing.assert_array_equal(r.get_destinations(), [4])


# -- the package --------------------------------------------------------------

def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def test_dir_parity_of_plc():
    """Every public name of cugraph_tpu.plc (the multi-device ones,
    ``MGGraph`` and ``comms``, too), and no other; each an object of the
    port."""
    code = ("import json, cugraph_tpu.plc as j, cugraph_tpu_torch.plc as t; "
            "print(json.dumps([[n for n in dir(m) if not n.startswith('_')]"
            " for m in (j, t)]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    names_j, names_t = map(set, json.loads(out.stdout.strip()
                                           .splitlines()[-1]))
    assert names_j - names_t == set()
    assert names_t <= names_j
    for name in _public(tp):
        value = getattr(tp, name)
        owner = (value.__name__ if isinstance(value, types.ModuleType)
                 else getattr(value, "__module__", None) or "")
        assert not owner.startswith("cugraph_tpu."), (name, owner)
    assert tp.exceptions is tt.exceptions
    assert tp.EdgeIdLookupTable is tt.EdgeIdLookupTable
    assert tt.plc is tp


def test_version_and_git_commit():
    assert tp.__version__ == jp.__version__ == "0.1.0"
    commit = tp.__git_commit__
    assert isinstance(commit, str)
    assert commit == "" or len(commit) == 40
    with pytest.raises(AttributeError):
        tp.__no_such_name__
