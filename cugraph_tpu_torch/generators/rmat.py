"""RMAT recursive-matrix graph generator.

Counterpart of ``cugraph_tpu.generators.rmat`` and bit-identical to it for
the same arguments (reference cpp/src/generators/generate_rmat_edgelist.cuh,
Graph500 parameters a=0.57 b=0.19 c=0.19, and the scramble.cuh vertex id
scrambler).  Generation is host work: the threaded C++ generator of
``core/_native/builder.cpp`` (``rmat_edgelist``), whose NumPy counterpart
``_rmat_numpy`` stays here as its plain version; the device consumes the
compressed graph.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from cugraph_tpu_torch.core import native


def _counter_uniform(seed: int, num_edges: int, bit: int) -> np.ndarray:
    """splitmix64-finalized counter RNG: one u64 hash per (seed, edge, bit),
    mapped to [0, 1)."""
    with np.errstate(over="ignore"):
        z = (np.uint64((seed * 0xD6E8FEB86659FD93) % 2**64)
             + np.arange(num_edges, dtype=np.uint64)
             * np.uint64(0x9E3779B97F4A7C15)
             + np.uint64(bit) * np.uint64(0xC2B2AE3D27D4EB4F))
        z ^= z >> np.uint64(30)
        z *= np.uint64(0xBF58476D1CE4E5B9)
        z ^= z >> np.uint64(27)
        z *= np.uint64(0x94D049BB133111EB)
        z ^= z >> np.uint64(31)
    return (z >> np.uint64(11)).astype(np.float64) * 2.0**-53


def _rmat_host(scale: int, num_edges: int, a: float, b: float, c: float,
               seed: int, clip_and_flip: bool):
    """RMAT edge list as int32 (src, dst), from the native generator."""
    if scale > 31:
        # vertex ids are int32 throughout; beyond 2^31 they would wrap
        raise ValueError(
            f"scale={scale} exceeds the int32 vertex-id range (max 31)")
    return native.rmat_native(scale, num_edges, a, b, c, seed, clip_and_flip)


def _rmat_numpy(scale: int, num_edges: int, a: float, b: float, c: float,
                seed: int, clip_and_flip: bool):
    """The plain version of ``_rmat_host``: one quadrant draw per bit over
    the same counter RNG, bit-identical."""
    src = np.zeros(num_edges, np.int64)
    dst = np.zeros(num_edges, np.int64)
    for bit in range(scale):
        u = _counter_uniform(seed, num_edges, bit)
        src_bit = (u >= a + b).astype(np.int64)
        thresh_dst = np.where(src_bit == 1, a + b + c, a)
        dst_bit = (u >= thresh_dst).astype(np.int64)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    if clip_and_flip:
        src, dst = np.minimum(src, dst), np.maximum(src, dst)
    return src.astype(np.int32), dst.astype(np.int32)


def _scramble(ids: np.ndarray, scale: int) -> np.ndarray:
    """Bijective xor-multiply-shift mix confined to ``scale`` bits (the
    uint32 arithmetic of the JAX scrambler, in int64: the products stay
    below 2^48, and masking keeps exactly the low bits uint32 keeps)."""
    x = ids.astype(np.int64)
    mask = (1 << scale) - 1
    x = (x ^ (x >> 8)) & mask
    x = (x * 0x9E3B) & mask
    x = (x ^ (x >> 4)) & mask
    x = (x * 0x85EB) & mask
    x = (x ^ (x >> 7)) & mask
    return x.astype(np.int32)


def rmat(scale: int, num_edges: int, a: float = 0.57, b: float = 0.19,
         c: float = 0.19, seed: int = 42, clip_and_flip: bool = False,
         scramble_vertex_ids: bool = False, create_using=None,
         mg: bool = False, include_edge_weights: bool = False,
         minimum_weight=0.0, maximum_weight=1.0, dtype=np.float32,
         include_edge_ids: bool = False, include_edge_types: bool = False,
         min_edge_type_value=0, max_edge_type_value=0):
    """Generate an RMAT edge list or Graph (reference rmat.py).
    ``create_using=None`` returns a DataFrame ['src', 'dst'(, 'weights')];
    a Graph class or instance gets the edges loaded into it.  The four
    edge id and type keywords are accepted and ignored, as the JAX
    package does (its rmat.py:95-121 builds no such column)."""
    if a + b + c > 1.0:
        raise ValueError("a + b + c must be <= 1.0")
    src, dst = _rmat_host(int(scale), int(num_edges), float(a), float(b),
                          float(c), int(seed), bool(clip_and_flip))
    if scramble_vertex_ids:
        src = _scramble(src, int(scale))
        dst = _scramble(dst, int(scale))
    cols = {"src": src, "dst": dst}
    if include_edge_weights:
        w = np.random.default_rng(seed + 1).uniform(
            minimum_weight, maximum_weight, num_edges)
        cols["weights"] = w.astype(dtype)
    df = pd.DataFrame(cols)
    if create_using is None:
        return df
    G = create_using() if isinstance(create_using, type) else create_using
    G.from_edgelist(src, dst, cols.get("weights"))
    return G


def generate_rmat_edgelist(*args, **kwargs):
    return rmat(*args, **kwargs)


def generate_rmat_edgelists(n_edgelists: int, min_scale: int, max_scale: int,
                            edge_factor: int = 16, seed: int = 42, **kw):
    """Batch RMAT generation (reference generate_rmat_edgelists.pyx)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_edgelists):
        s = int(rng.integers(min_scale, max_scale + 1))
        out.append(rmat(s, (2 ** s) * edge_factor, seed=seed + i, **kw))
    return out
