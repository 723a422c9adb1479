"""Mini-batch GNN training from neighbour-sampling output.

Counterpart of ``cugraph_tpu.nn.minibatch`` (the cugraph-pyg/cugraph-dgl
role: consuming the sampler's per-batch compressed CSR, SURVEY.md §3.5
steps 3-4).  A sampled neighbourhood becomes a ``GraphStructure`` over the
batch's local vertices, built on the device with ``build_structure``: the
port's structures carry no padding, so batches of different sizes need no
common static shape, and the JAX package's pad sizes only bound a batch
(``pad_vertices``/``pad_edges`` raise when it is larger).  A model runs
over ``batch.g`` as over a whole graph: K4 over its CSC forward and over
its CSR backward.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cugraph_tpu_torch.algos.sampling import uniform_neighbor_sample
from cugraph_tpu_torch.algos.sampling_post import sampling_results_to_batches
from cugraph_tpu_torch.core.structure import GraphStructure, build_structure


@dataclass(frozen=True)
class SampledBatch:
    """One sampled neighbourhood as a device subgraph.

    ``g`` is a GraphStructure over the batch-local (renumbered) vertex
    space; ``global_ids[i]`` maps local vertex i to its global id;
    ``seed_mask`` marks the seed rows (the first vertices of the renumber
    map, per the post-processing convention)."""

    g: GraphStructure
    global_ids: torch.Tensor   # int32 [n_local]
    seed_mask: torch.Tensor    # bool  [n_local]
    num_seeds: int


def batch_from_sampling(pack: dict, *, pad_vertices: int, pad_edges: int,
                        num_seeds: int, device=None) -> SampledBatch:
    """Build a SampledBatch from one entry of
    ``sampling_results_to_batches`` output, on ``device`` (None: the
    card).  Raises ValueError when the batch has more than
    ``pad_vertices`` vertices or ``pad_edges`` edges."""
    vmap = np.asarray(pack["map"])
    n_local = len(vmap)
    if n_local > pad_vertices:
        raise ValueError(f"batch has {n_local} vertices > pad {pad_vertices}")
    srcs, dsts, ws = [], [], []
    for hop in pack["hops"]:
        offs, idx = hop["offsets"], hop["indices"]
        srcs.append(np.repeat(np.arange(len(offs) - 1), np.diff(offs)))
        dsts.append(idx)
        ws.append(hop.get("weight", np.ones(len(idx))))
    src = np.concatenate(srcs) if srcs else np.empty(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.empty(0, np.int64)
    w = np.concatenate(ws).astype(np.float32) if ws else None
    if len(src) > pad_edges:
        raise ValueError(f"batch has {len(src)} edges > pad {pad_edges}")

    # message flow: aggregate from the sampled neighbour (dst) INTO the
    # seed-side vertex (src), so the structure's edges run dst -> src and
    # a vertex's CSC in-edges are its sampled neighbours
    g = build_structure(dst, src, w, n_local, device)
    seed = torch.zeros(n_local, dtype=torch.bool, device=g.device)
    seed[:num_seeds] = True
    return SampledBatch(
        g=g,
        global_ids=torch.as_tensor(vmap.astype(np.int32), device=g.device),
        seed_mask=seed,
        num_seeds=num_seeds,
    )


def _seeds_first(vmap: np.ndarray, batch_seeds) -> tuple[np.ndarray,
                                                         np.ndarray, int]:
    """(the map with the batch's seeds leading, each in its map order;
    remap[i] = the new position of vmap[i]; the number of seeds in it),
    the JAX package's list comprehensions in NumPy."""
    is_seed = np.isin(vmap, np.asarray(batch_seeds))
    order = np.concatenate([np.flatnonzero(is_seed),
                            np.flatnonzero(~is_seed)])
    remap = np.empty(len(vmap), np.int64)
    remap[order] = np.arange(len(vmap))
    return vmap[order], remap, int(is_seed.sum())


def make_batches(G, seeds, fanouts, *, batch_size: int = 32,
                 features=None, random_state=0):
    """Epoch iterator: sample per seed batch (without replacement,
    ``random_state + offset``) and yield (SampledBatch, features_local
    [n_local, F] or None) on G's device.  ``features`` is indexed by
    global (external) id: a NumPy array, or a tensor that is indexed where
    it lies."""
    seeds = np.asarray(seeds)
    k_prod = 1
    n_max = batch_size
    for k in fanouts:
        k_prod *= max(int(k), 1)
        n_max += batch_size * k_prod
    pad_v = max(64, int(1.2 * n_max))
    pad_e = max(128, int(1.5 * (n_max - batch_size)))

    for lo in range(0, len(seeds), batch_size):
        batch_seeds = seeds[lo: lo + batch_size]
        df = uniform_neighbor_sample(G, batch_seeds, list(fanouts),
                                     with_replacement=False,
                                     random_state=random_state + lo)
        df = df.assign(batch_id=0)  # one combined neighbourhood per call
        packs = sampling_results_to_batches(df)
        if 0 not in packs:
            continue
        pack = packs[0]
        vmap, remap, num_seeds = _seeds_first(np.asarray(pack["map"]),
                                              batch_seeds)
        pack = {
            "map": vmap,
            "hops": [_remap_hop(h, remap, len(vmap)) for h in pack["hops"]],
        }
        b = batch_from_sampling(pack, pad_vertices=pad_v, pad_edges=pad_e,
                                num_seeds=num_seeds, device=G.device)
        if features is None:
            yield b, None
        elif isinstance(features, torch.Tensor):
            yield b, features[b.global_ids.to(features.device,
                                              torch.int64)].to(G.device)
        else:
            yield b, torch.as_tensor(
                np.asarray(features[vmap], np.float32), device=G.device)


def _remap_hop(hop, remap, n_local):
    """Rebuild one hop's CSR consistently after the seed-first reordering."""
    offs, idx = hop["offsets"], hop["indices"]
    s = np.repeat(np.arange(n_local), np.diff(offs))
    s2 = remap[s]
    order = np.argsort(s2, kind="stable")
    counts = np.bincount(s2, minlength=n_local)
    out_offs = np.zeros(n_local + 1, np.int64)
    np.cumsum(counts, out=out_offs[1:])
    w = hop.get("weight")
    return {
        "offsets": out_offs,
        "indices": remap[idx][order],
        "weight": w[order] if w is not None else None,
    }


def sage_minibatch_forward(model, batch: SampledBatch, x: torch.Tensor):
    """GraphSAGE (``model``, an ``nn.GraphSAGE``) forward over a sampled
    batch; returns the logits of every local row (the caller selects the
    seed rows with ``batch.seed_mask``)."""
    return model(batch.g, x)
