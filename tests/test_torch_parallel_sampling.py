"""The multi-device samplers and walks against ``cugraph_tpu.parallel``.

For each world (2×2, 2×1 and 1×2 gloo processes) the parent runs every
case of ``torch_port_mg_sampling.CASES`` once through the JAX package on a
mesh of the same shape over ``jax.devices()[:P]``, recording the seed and
fanout of each hop it samples (the one-hop engine, the fused sampler and
the single-batch fused sampler are wrapped for that).  It then computes
the JAX hop's draws for exactly those keys, the uniforms in [1e-6, 1) or
the Gumbel noise over the block's padded length, with one vmapped call per
graph, and ships them in an ``.npz``; the ranks replay them
(``ReplayDraws``, which raises on a key it was not given) in their push
block's edge order.  Each case's result is then compared with the JAX
package's row for row.

Bounds: every frame, walk, panel and membership bit for bit, columns and
dtypes included.  The biased cases take the port's own float32
``log(w)``, which differs from XLA's in the last bit on some weights
(``test_biased_log_is_the_ports_own``): a pick would differ only where two
scores lie within an ulp, and none does on these graphs.
"""

import functools
import inspect
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cugraph_tpu import parallel as jp
from cugraph_tpu.parallel import algos as jalgos
from cugraph_tpu.parallel import sampling_mg as jsm

from torch_port_mg import WORLDS, run_worlds
from torch_port_mg_sampling import (CASES, GRAPHS, ReplayDraws, build,
                                    load_tables, run_case, sampling_body)

torch.set_num_threads(1)
NAMES = sorted(CASES)
# the rectangular worlds (which catch a "major"/"minor" mix-up a square
# one hides) run a cut of the cases, one per route and option family, to
# keep the JAX compiles few
RECT = sorted(["uniform", "biased_wr", "skew", "shuffled", "props_key",
               "het", "temporal_strictly_increasing", "temporal_last",
               "walks", "node2vec", "has_edge", "multihop",
               "one_hop_temporal", "fused_default", "layered_default"])
WORLD_CASES = {(2, 2): NAMES, (2, 1): RECT, (1, 2): RECT}
PAIRS = [(shape, name) for shape, names in WORLD_CASES.items()
         for name in names]
_KEY_CHUNK = 256


@functools.lru_cache(maxsize=None)
def _mesh(pmaj, pmin):
    return jp.make_mesh_2d(pmaj, pmin, jax.devices()[:pmaj * pmin])


def _wrap32(x):
    return (int(x) + 2**31) % 2**32 - 2**31


def _round_keys(seed, k, pmaj, pmin):
    return {(_wrap32(seed), _wrap32(r * 7919 + i * 131 + j))
            for r in range(k) for i in range(pmaj) for j in range(pmin)}


class _Recorder:
    """Wraps the JAX package's hop entry points and records, per kind
    ("u": uniforms, "g": Gumbel noise), the (seed, salt) keys their hops
    draw: the one-hop engine's k rounds; the fused sampler's k rounds of
    every layer a call can populate (as many as its batches) per hop."""

    def __init__(self, pmaj, pmin):
        self.pmaj, self.pmin = pmaj, pmin
        self.keys = {"u": set(), "g": set()}

    def _add(self, biased, seed, k):
        self.keys["g" if biased else "u"] |= _round_keys(seed, k, self.pmaj,
                                                         self.pmin)

    def one_hop(self, fn):
        sig = inspect.signature(fn)

        def wrapped(*a, **kw):
            b = sig.bind(*a, **kw)
            b.apply_defaults()
            self._add(b.arguments["biased"], b.arguments["seed"],
                      int(b.arguments["k"]))
            return fn(*a, **kw)
        return wrapped

    def batched(self, fn):
        def wrapped(g, mesh, masks0, fanouts, caps, **kw):
            groups = masks0 if isinstance(masks0, (list, tuple)) else [masks0]
            layers = sum(np.asarray(m).shape[0] for m in groups)
            for hop, k in enumerate(fanouts):
                for r in range(layers):
                    self._add(kw.get("biased", False),
                              _wrap32(kw["seed"] + hop * 1009) + r * 131,
                              int(k))
            return fn(g, mesh, masks0, fanouts, caps, **kw)
        return wrapped

    def multihop(self, fn):
        sig = inspect.signature(fn)

        def wrapped(*a, **kw):
            b = sig.bind(*a, **kw)
            b.apply_defaults()
            for hop, k in enumerate(b.arguments["fanout_vals"]):
                self._add(b.arguments["biased"],
                          b.arguments["seed"] + hop * 1009, int(k))
            return fn(*a, **kw)
        return wrapped


@functools.partial(jax.jit, static_argnums=(2, 3))
def _draws(seeds, salts, e, gumbel):
    """The JAX hop's numbers at keys (seed, salt) over e slots
    (``algos.py:546-557``)."""
    def one(s, t):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), s),
                                 t)
        if gumbel:
            return -jnp.log(-jnp.log(jax.random.uniform(
                key, (e,), jnp.float32, 1e-20, 1.0)))
        return jax.random.uniform(key, (e,), jnp.float32, 1e-6, 1.0)
    return jax.vmap(one)(seeds, salts)


def _draw_table(keys, e, gumbel):
    keys = sorted(keys)
    if not keys:
        return np.zeros((0, 2), np.int64), np.zeros((0, e), np.float32)
    arr = np.asarray(keys, np.int64)
    out = []
    for lo in range(0, len(arr), _KEY_CHUNK):
        part = np.zeros((_KEY_CHUNK, 2), np.int32)
        chunk = arr[lo:lo + _KEY_CHUNK]
        part[:len(chunk)] = chunk
        vals = _draws(jnp.asarray(part[:, 0]), jnp.asarray(part[:, 1]), e,
                      gumbel)
        out.append(np.asarray(vals)[:len(chunk)])
    return arr, np.concatenate(out)


def push_perm(jg, i, j):
    """The JAX push block (i, j)'s slot of each port edge: its valid
    lanes put in (dst_loc, src_loc, slot) order, the port block's order."""
    valid = np.asarray(jg.push.valid)[i, j]
    slots = np.nonzero(valid)[0]
    dl = np.asarray(jg.push.dst_loc)[i, j][slots]
    sl = np.asarray(jg.push.src_loc)[i, j][slots]
    return slots[np.lexsort((sl, dl))]


def _jax_mods(g, mesh):
    return {"pkg": jp, "sampling_mg": jsm, "rows": jalgos.sample_panel_rows,
            "has_edge": lambda ss, dd: jalgos.mg_has_edge(g, ss, dd)}


def _jax_world(pmaj, pmin, out_dir):
    """The world's cases through the JAX package, and the draws file for
    the world's ranks."""
    mesh = _mesh(pmaj, pmin)
    want, graphs, rec = {}, {}, {}
    for name in WORLD_CASES[(pmaj, pmin)]:
        case = CASES[name]
        gname = case["graph"]
        if gname not in graphs:
            graphs[gname] = build(jp, gname, (pmaj, pmin))
            rec[gname] = _Recorder(pmaj, pmin)
        g, r = graphs[gname], rec[gname]
        with mock.patch.object(jalgos, "mg_sample_one_hop",
                               r.one_hop(jalgos.mg_sample_one_hop)), \
                mock.patch.object(jp, "mg_sample_one_hop",
                                  r.one_hop(jp.mg_sample_one_hop)), \
                mock.patch.object(
                    jalgos, "mg_sample_multihop_batched_device",
                    r.batched(jalgos.mg_sample_multihop_batched_device)), \
                mock.patch.object(jp, "mg_sample_multihop_device",
                                  r.multihop(jp.mg_sample_multihop_device)):
            want[name] = run_case(case, g, mesh, _jax_mods(g, mesh),
                                  np.asarray)
    arrays = {}
    for gname, jg in graphs.items():
        e = int(jg.push.src_loc.shape[2])
        for kind in ("u", "g"):
            keys, vals = _draw_table(rec[gname].keys[kind], e, kind == "g")
            arrays[f"{gname}/{kind}_keys"] = keys
            arrays[f"{gname}/{kind}"] = vals
        for i in range(pmaj):
            for j in range(pmin):
                arrays[f"{gname}/perm/{i * pmin + j}"] = push_perm(jg, i, j)
    path = out_dir / f"draws_{pmaj}x{pmin}.npz"
    np.savez(path, **arrays)
    return want, str(path)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("sampling")
    want, jobs = {}, {}
    for shape in WORLDS:
        want[shape], path = _jax_world(*shape, out_dir)
        jobs[shape] = (path, WORLD_CASES[shape])
    got = run_worlds(out_dir, sampling_body, jobs)
    return {shape: (want[shape], got[shape]) for shape in WORLDS}


@pytest.fixture
def square(worlds):
    return worlds[(2, 2)]


def _got(got, name):
    prefix = f"{name}/"
    return {k[len(prefix):]: v for k, v in got.items()
            if k.startswith(prefix) and k != f"{name}/same"}


def _hold(got, want, label):
    assert sorted(got) == sorted(want), (label, sorted(got), sorted(want))
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype, (label, key, g.dtype, w.dtype)
        assert np.array_equal(g, w), (label, key)


@pytest.mark.parametrize("shape,name", PAIRS,
                         ids=[f"{a}x{b}-{n}" for (a, b), n in PAIRS])
def test_case_matches_jax(worlds, shape, name):
    """The case's frame (columns, order, dtypes), walk, panel or
    membership equals the JAX package's, on every rank."""
    want, got = worlds[shape]
    assert bool(got[f"{name}/same"]), f"{name}: the ranks differ"
    _hold(_got(got, name), {k: np.asarray(v) for k, v in
                            want[name].items()}, name)


def _rows(res):
    cols = [str(c) for c in res["cols"]]
    keys = [c for c in ("hop_id", "batch_id", "sources", "destinations",
                        "edge_time") if c in cols]
    table = np.stack([res[f"col/{c}"].astype(np.float64) for c in keys])
    return table[:, np.lexsort(table[::-1])]


ROUTE_PAIRS = [(shape, b) for shape, names in WORLD_CASES.items()
               for b in ("default", "carry_over", "exclude")
               if f"fused_{b}" in names]


@pytest.mark.parametrize("shape,behavior", ROUTE_PAIRS,
                         ids=[f"{a}x{b}-{c}" for (a, b), c in ROUTE_PAIRS])
def test_fused_and_layered_routes_give_the_same_rows(worlds, shape,
                                                     behavior):
    """Under dedupe_sources the fused route and the layered one give the
    same sorted (hop, batch, src, dst) rows (``tests/test_sampling_flags.
    py:183-220``)."""
    _, got = worlds[shape]
    fused = _got(got, f"fused_{behavior}")
    assert np.array_equal(_rows(fused), _rows(_got(got,
                                                   f"layered_{behavior}")))
    assert len(fused["col/sources"]) > 0


def test_fused_temporal_matches_the_layered_route(square):
    _, got = square
    assert np.array_equal(_rows(_got(got, "fused_temporal")),
                          _rows(_got(got, "layered_temporal")))


def test_the_fused_cases_route_as_expected():
    """The fused cases pass ``_plan_fused``'s gate (40 seeds in 20
    batches: two groups of planes) and the plain ones do not."""
    from cugraph_tpu_torch.parallel import sampling_mg as psm

    class Mesh:
        size = 4

    src, dst, w, n, _ = GRAPHS["weighted"]
    g = type("G", (), {"pad_v": 160, "num_vertices": n, "push": object()})()
    for name in ("fused_default", "fused_biased_props", "uniform"):
        kw = dict(CASES[name]["kw"])
        flags = dict(prior_sources_behavior=kw.get(
            "prior_sources_behavior", "default"),
            dedupe_sources=kw.get("dedupe_sources", False),
            batch_id_list=kw.get("batch_id_list"))
        plan = psm._plan_fused(g, Mesh(), CASES[name]["args"][0],
                               CASES[name]["args"][1], flags)
        want = jsm._plan_fused(g, type("M", (), {"devices": np.zeros(4)})(),
                               CASES[name]["args"][0],
                               CASES[name]["args"][1], flags)
        assert (plan is None) == (want is None) == (name == "uniform")
        if plan is not None:
            assert len(plan["groups"]) == 2
            for a, b in zip(plan["groups"], want["groups"]):
                assert np.array_equal(a["masks0"], b["masks0"])
                assert a["caps"] == b["caps"]


def test_the_ambiguous_pair_is_refused(square):
    """A sampled parallel edge whose instances carry distinct weights,
    without instance ids: the same ValueError as the JAX package's."""
    want, got = square
    assert "raised" in want["ambiguous"]
    assert str(got["ambiguous/raised"]) == str(want["ambiguous"]["raised"])


@pytest.mark.parametrize("shape", [(2, 2), (2, 1), (1, 2), (1, 1)])
@pytest.mark.parametrize("name", ["weighted", "typed", "skew", "shuffled"])
def test_push_block_edges_are_the_jax_slots(name, shape):
    """The port's push block holds the JAX block's valid lanes, edge e at
    slot ``push_perm[e]``.  With edge types and times the JAX build sorts
    in NumPy by (dst_loc, src_loc, input order), the port's order, so the
    map is the identity; without them its native ``build_blocks_2d``
    keeps input order within a dst slot, which is the port's order for an
    input sorted by (src, dst) as the random graphs are, and not for a
    shuffled one: there the map reorders each slot's edges (and the
    replayed draws go through it, ``CASES["shuffled"]``)."""
    from cugraph_tpu_torch.parallel import Partition2D, build_block

    pmaj, pmin = shape
    src, dst, w, n, kw = GRAPHS[name]
    jg = build(jp, name, shape)
    part = Partition2D.create(n, pmaj, pmin)
    eid = np.arange(len(src), dtype=np.int32)
    identity = True
    for i in range(pmaj):
        for j in range(pmin):
            b = build_block(part, i, j, dst, src, w, kw.get("edge_type"),
                            kw.get("edge_time"), eid, device="cpu")
            perm = push_perm(jg, i, j)
            assert np.array_equal(np.sort(perm), np.arange(len(perm)))
            for got, field in ((b.dst_loc.numpy(), "dst_loc"),
                               (b.indices.numpy(), "src_loc"),
                               (b.weights.numpy(), "weight"),
                               (b.eid.numpy(), "eid")):
                assert np.array_equal(
                    got, np.asarray(getattr(jg.push, field))[i, j][perm])
            identity &= bool(np.array_equal(perm, np.arange(len(perm))))
    assert identity == (name != "shuffled")


def test_replay_raises_on_a_key_it_was_not_given(tmp_path):
    keys = np.array([[3, 0]], np.int64)
    np.savez(tmp_path / "d.npz", **{
        "weighted/u_keys": keys, "weighted/u": np.ones((1, 4), np.float32),
        "weighted/g_keys": np.zeros((0, 2), np.int64),
        "weighted/g": np.zeros((0, 4), np.float32),
        "weighted/perm/0": np.arange(4)})
    ReplayDraws.tables = load_tables(tmp_path / "d.npz", 0)
    ReplayDraws.current = "weighted"
    d = ReplayDraws("cpu")
    assert d.edge_uniform(3, 0, 0, 0, 4, 1e-6, 1.0).tolist() == [1.0] * 4
    with pytest.raises(KeyError, match="seed 3, round 1"):
        d.edge_uniform(3, 1, 0, 0, 4, 1e-6, 1.0)
    with pytest.raises(KeyError, match="no g draws"):
        d.edge_gumbel(3, 0, 0, 0, 4)


def test_biased_log_is_the_ports_own():
    """The biased score log(max(w, 1e-30)) + G takes torch's float32 log,
    which differs from XLA's in the last bit on some of these weights
    (never by more); the biased cases still match the JAX package's
    picks, since no two competing scores lie within an ulp."""
    w = GRAPHS["weighted"][2]
    mine = torch.log(torch.clamp(torch.from_numpy(w), min=1e-30)).numpy()
    xla = np.asarray(jnp.log(jnp.maximum(jnp.asarray(w), 1e-30)))
    ulps = np.abs(mine.view(np.int32).astype(np.int64)
                  - xla.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    assert (ulps == 1).sum() > 0


def test_the_sampler_names_and_aliases():
    """This slice's names and the walk aliases, as in the JAX package
    (``cugraph_tpu/parallel/__init__.py:41-70, 92-95``)."""
    import cugraph_tpu_torch.parallel as tp

    for name in ("mg_sample_one_hop", "mg_sample_multihop_device",
                 "mg_uniform_random_walks", "mg_biased_random_walks",
                 "mg_node2vec_random_walks", "mg_uniform_neighbor_sample",
                 "mg_biased_neighbor_sample",
                 "mg_heterogeneous_neighbor_sample",
                 "mg_temporal_neighbor_sample",
                 "mg_heterogeneous_temporal_neighbor_sample"):
        assert hasattr(jp, name) and hasattr(tp, name), name
    for alias in ("uniform_random_walks", "random_walks",
                  "biased_random_walks", "node2vec_random_walks"):
        assert getattr(tp, alias).__name__ == getattr(jp, alias).__name__


@pytest.fixture
def one_rank(tmp_path):
    import datetime

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def _round_reference(push, u, elig, w, neg, taken):
    """One round as the JAX hop takes it (``algos.py:558-577``): scores
    ``u`` where eligible (and w > 0 when biased), else ``neg``; a segment
    max with −inf for a row with no edge; the min destination among the
    winners, −1 for none."""
    off = push.offsets.numpy().astype(np.int64)
    dst = push.indices.numpy().astype(np.int64)
    ok = elig & ~taken & (w > 0 if neg == -np.inf else True)
    score = np.where(ok, u, neg)
    out = np.full(len(off) - 1, -1)
    chosen = np.zeros(len(u), bool)
    for v in range(len(off) - 1):
        lo, hi = off[v], off[v + 1]
        mx = max(score[lo:hi].max(initial=-np.inf), neg)
        win = (elig & ~taken)[lo:hi] & (score[lo:hi] == mx) \
            & (score[lo:hi] > neg)
        if win.any():
            out[v] = dst[lo:hi][win].min()
            chosen[lo:hi] |= win & (dst[lo:hi] == out[v])
    return out, chosen


@pytest.mark.parametrize("biased", [False, True])
def test_k2_round_winners_match_the_segment_max(one_rank, biased):
    """K2 (max, right) gives a row with no edge −1e30 and clips a masked
    −inf to −1e30, where the JAX hop's segment max has −inf; a masked
    uniform edge scores −1.  With an empty row (4), a row whose only edge
    is masked (2), a zero-weight edge (0→2) and ties broken to the
    smallest destination, the hop's picks equal the segment-max
    reference round by round, without replacement."""
    from cugraph_tpu_torch.parallel import algos as palgos
    from cugraph_tpu_torch.parallel import build_dist_graph, make_mesh_2d

    mesh = make_mesh_2d(1, 1, device="cpu")
    src = np.array([0, 0, 0, 0, 1, 1, 2, 3, 5])
    dst = np.array([1, 2, 3, 5, 2, 6, 3, 0, 1])
    w = np.array([1.0, 0.0, 2.0, 0.5, 1.0, 1.0, 3.0, 1.0, 1.0], np.float32)
    g = build_dist_graph(src, dst, w, 8, mesh)
    push = g.push
    edge_ok = ~((push.dst_loc == 2) & (push.indices == 3))
    f_own = torch.zeros(g.chunk, dtype=torch.bool)
    f_own[[0, 1, 2, 4]] = True
    seed, k = 7, 3
    got, _, _ = palgos._sample_hop(
        g, mesh, f_own, seed, k, with_replacement=False, biased=biased,
        temporal=False, comparison=None, edge_ok=edge_ok)
    draws = palgos.MGDraws("cpu")
    elig = (f_own[push.dst_loc] & edge_ok).numpy()
    taken = np.zeros(push.e_local, bool)
    logw = torch.log(torch.clamp(push.weights, min=1e-30)).numpy()
    for r in range(k):
        if biased:
            u = logw + draws.edge_gumbel(seed, r, 0, 0, push.e_local).numpy()
        else:
            u = draws.edge_uniform(seed, r, 0, 0, push.e_local, 1e-6,
                                   1.0).numpy()
        want, chosen = _round_reference(
            push, u, elig, push.weights.numpy(),
            -np.inf if biased else -1.0, taken)
        assert np.array_equal(got[:, r].numpy(), want), r
        taken |= chosen
    assert (got[4] == -1).all() and (got[2] == -1).all()
