"""The prims contract and the last public stragglers of the port against
cugraph_tpu on the CPU.

The same small weighted graphs (directed and undirected, with self-loops
and isolated vertices), made from numpy seeds, go through both packages'
primitives: ``count_if_e``, ``count_if_v`` and ``vertex_mask`` (its first
n entries) exactly, ``transform_e`` (its first m entries) bit for bit,
``transform_reduce_e`` within rtol 1e-6 (``jnp.sum`` and ``torch.sum`` may
order the sum differently).  Also: ``cugraph_tpu_torch.prims`` exports the
JAX package's fifteen names, ``core.preprocess.remove_self_loops``,
``GraphStructure.out_weight_sums`` (rtol 1e-6 of the JAX sums' first n
rows) and ``nn.models.gcn_init``/``gat_init``.
"""

import numpy as np
import pytest
import torch

import cugraph_tpu.nn.models as jmodels
import cugraph_tpu.prims as jprims
from cugraph_tpu.core import preprocess as jpre
from cugraph_tpu.core.structure import build_structure_host
from cugraph_tpu.prims import vertex_edge as jve

import cugraph_tpu_torch.nn as tnn
import cugraph_tpu_torch.prims as tprims
from cugraph_tpu_torch.core import preprocess as tpre
from cugraph_tpu_torch.core.structure import build_structure
from cugraph_tpu_torch.nn import layers as tlayers
from cugraph_tpu_torch.nn import models as tmodels
from cugraph_tpu_torch.prims import frontier as tfrontier
from cugraph_tpu_torch.prims import vertex_edge as tve

torch.set_num_threads(1)

JAX_EXPORTS = [
    "per_v_transform_reduce_incoming_e", "per_v_transform_reduce_outgoing_e",
    "transform_reduce_e", "transform_e", "count_if_e", "transform_reduce_v",
    "count_if_v", "reduce_v", "spmv_pull", "spmv_push",
    "segment_reduce_by_major", "gather_minor", "frontier_expand_by_dst",
    "bitmap_from_vertices", "vertices_from_bitmap"]


def _edges(kind):
    """(src, dst, w, n): internal ids, self-loops, parallel edges and a tail
    of isolated vertices; undirected kinds carry both directions."""
    rng = np.random.default_rng({"directed": 1, "undirected": 2,
                                 "directed_hub": 3}[kind])
    n = 80
    m = 600
    src = rng.integers(0, n - 12, m)
    dst = np.where(rng.random(m) < 0.08, src, rng.integers(0, n - 12, m))
    if kind == "directed_hub":  # one row far longer than the rest
        src[: m // 3] = 5
    w = rng.uniform(0.0, 1.0, m).astype(np.float32)
    if kind == "undirected":
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        w = np.concatenate([w, w])
    return src, dst, w, n


KINDS = ["directed", "undirected", "directed_hub"]


def _both(kind):
    src, dst, w, n = _edges(kind)
    gj = build_structure_host(src, dst, w, n)
    gt = build_structure(src, dst, w, n, "cpu")
    return gj, gt, n, len(src)


def _values(n, pad_v, seed, low=-1.0):
    """A float32 vertex vector [n] for the port and its [pad_v] zero-padded
    copy for the JAX package."""
    x = np.random.default_rng(seed).uniform(low, 1.0, n).astype(np.float32)
    return np.pad(x, (0, pad_v - n)), torch.from_numpy(x)


E_OPS = {
    "w_times_s": (lambda s, d, w: w * s, True, False),
    "w_times_d": (lambda s, d, w: w * d, False, True),
    "w_s_d": (lambda s, d, w: w * s * d, True, True),
    "w_only": (lambda s, d, w: w * w, False, False),
}


def _kwargs(jx, tx, jy, ty, use_s, use_d):
    kj, kt = {}, {}
    if use_s:
        kj["src_values"], kt["src_values"] = jx, tx
    if use_d:
        kj["dst_values"], kt["dst_values"] = jy, ty
    return kj, kt


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("op", sorted(E_OPS))
def test_transform_e_bit_for_bit(kind, op):
    gj, gt, n, m = _both(kind)
    jx, tx = _values(n, gj.pad_v, 4)
    jy, ty = _values(n, gj.pad_v, 5)
    e_op, use_s, use_d = E_OPS[op]
    kj, kt = _kwargs(jx, tx, jy, ty, use_s, use_d)
    want = np.asarray(jve.transform_e(gj, e_op, **kj))[:m]
    got = tve.transform_e(gt, e_op, **kt)
    assert got.shape == (m,) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("op", sorted(E_OPS))
@pytest.mark.parametrize("init", [0.0, 1.5])
def test_transform_reduce_e(kind, op, init):
    """Non-negative terms, so rtol bounds the effect of the summation
    order; signed terms against float64 within the order's error bound,
    m·2^-24·Σ|term|, for both packages."""
    gj, gt, n, m = _both(kind)
    jx, tx = _values(n, gj.pad_v, 6, low=0.0)
    jy, ty = _values(n, gj.pad_v, 7, low=0.0)
    e_op, use_s, use_d = E_OPS[op]
    kj, kt = _kwargs(jx, tx, jy, ty, use_s, use_d)
    want = float(jve.transform_reduce_e(gj, e_op, init=init, **kj))
    got = tve.transform_reduce_e(gt, e_op, init=init, **kt)
    assert got.dim() == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    # one fixed-order sum: a repeat gives the same bits
    again = tve.transform_reduce_e(gt, e_op, init=init, **kt)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))

    jx, tx = _values(n, gj.pad_v, 6)
    jy, ty = _values(n, gj.pad_v, 7)
    kj, kt = _kwargs(jx, tx, jy, ty, use_s, use_d)
    terms = tve.transform_e(gt, e_op, **kt).double()
    exact = float(terms.sum()) + init
    bound = m * 2.0 ** -24 * float(terms.abs().sum()) + 2.0 ** -24 * abs(
        exact)
    for total in (tve.transform_reduce_e(gt, e_op, init=init, **kt),
                  jve.transform_reduce_e(gj, e_op, init=init, **kj)):
        assert abs(float(total) - exact) <= bound


PREDS = {
    "heavy": (lambda s, d, w: w > 0.5, False, False),
    "s_above_d": (lambda s, d, w: s > d, True, True),
    "positive_s": (lambda s, d, w: (s > 0) & (w > 0.25), True, False),
}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("pred", sorted(PREDS))
def test_count_if_e_exact(kind, pred):
    gj, gt, n, m = _both(kind)
    jx, tx = _values(n, gj.pad_v, 8)
    jy, ty = _values(n, gj.pad_v, 9)
    fn, use_s, use_d = PREDS[pred]
    kj, kt = _kwargs(jx, tx, jy, ty, use_s, use_d)
    want = int(jve.count_if_e(gj, fn, **kj))
    got = tve.count_if_e(gt, fn, **kt)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == want


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("threshold", [-2.0, 0.0, 0.3])
def test_count_if_v_and_vertex_mask_exact(kind, threshold):
    gj, gt, n, _ = _both(kind)
    jx, tx = _values(n, gj.pad_v, 10)
    want = int(jve.count_if_v(gj, lambda v: v > threshold, jx))
    got = tve.count_if_v(gt, lambda v: v > threshold, tx)
    assert got.dtype == torch.int32 and int(got) == want
    mask = tve.vertex_mask(gt)
    assert mask.dtype == torch.bool and mask.shape == (n,)
    np.testing.assert_array_equal(mask.numpy(),
                                  np.asarray(jve.vertex_mask(gj))[:n])


FRONTIER = {"frontier_expand_by_dst", "bitmap_from_vertices",
            "vertices_from_bitmap"}


def test_prims_exports_the_jax_names():
    ns = {}
    exec("from cugraph_tpu_torch.prims import *", ns)
    assert set(JAX_EXPORTS) <= set(ns)
    jax_names = {k for k, v in vars(jprims).items()
                 if not k.startswith("_") and callable(v)}
    assert jax_names == set(JAX_EXPORTS)
    from cugraph_tpu_torch.prims import spmv_pull, vertex_mask

    assert spmv_pull is tve.spmv_pull and vertex_mask is tve.vertex_mask


@pytest.mark.parametrize("name", tprims.__all__)
def test_prims_export_is_the_module_callable(name):
    home = tfrontier if name in FRONTIER else tve
    assert getattr(tprims, name) is getattr(home, name)


@pytest.mark.parametrize("weighted", [False, True])
def test_remove_self_loops(weighted):
    rng = np.random.default_rng(12)
    src = rng.integers(0, 20, 300).astype(np.int32)
    dst = np.where(rng.random(300) < 0.2, src,
                   rng.integers(0, 20, 300)).astype(np.int32)
    w = rng.random(300).astype(np.float32) if weighted else None
    got = tpre.remove_self_loops(src, dst, w)
    want = jpre.remove_self_loops(src, dst, w)
    assert (got[2] is None) == (want[2] is None) == (not weighted)
    for g, x in zip(got, want):
        if x is not None:
            assert g.dtype == x.dtype
            np.testing.assert_array_equal(g, x)
    assert len(got[0]) < len(src)


@pytest.mark.parametrize("kind", KINDS)
def test_out_weight_sums(kind):
    gj, gt, n, _ = _both(kind)
    got = gt.out_weight_sums
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(gj.out_weight_sums())[:n],
                               rtol=1e-6)
    assert gt.out_weight_sums is got  # kept after the first call
    # the float64 sum per row, rounded once
    src, _, w, _ = _edges(kind)
    want = np.bincount(src, weights=w.astype(np.float64),
                       minlength=n).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_model_inits_under_their_module_names(name):
    """``nn.models.gcn_init``/``gat_init`` are the functions ``nn`` exports
    as ``gcn_model_init``/``gat_model_init`` (``nn``'s own ``gcn_init`` and
    ``gat_init`` are the layer inits, as in cugraph_tpu.nn), and give the
    JAX package's layout: the same layer dicts and shapes."""
    import jax

    init = getattr(tmodels, f"{name}_init")
    assert getattr(tnn, f"{name}_model_init") is init
    assert getattr(tnn, f"{name}_init") is getattr(tlayers, f"{name}_init")
    got = init(torch.Generator().manual_seed(0), 8, 16, 3, device="cpu")
    jp = getattr(jmodels, f"{name}_init")(jax.random.PRNGKey(0), 8, 16, 3)
    assert [sorted(layer) for layer in got] == [sorted(layer) for layer in jp]
    for layer_t, layer_j in zip(got, jp):
        for k in layer_j:
            assert tuple(layer_t[k].shape) == tuple(np.shape(layer_j[k])), k
