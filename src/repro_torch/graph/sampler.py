"""Fan-out neighbor sampler (GraphSAGE-style) — real, host-side, vectorized.

Produces fixed-shape sampled blocks for the ``minibatch_lg`` regime
(batch_nodes=1024, fanout 15-10): seed nodes, per-hop padded neighbor tables
and the union node set, ready to feed the GNN ``train_step``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.csr import CSRGraph


@dataclasses.dataclass
class SampledBlock:
    """Fixed-shape minibatch: ``nodes`` is the union (padded with -1 → relabeled
    to the sentinel row); ``hops[k]`` is an (n_k, fanout_k) int32 table of
    *positions into* ``nodes`` (sentinel = len(nodes))."""

    nodes: np.ndarray  # (cap,) original node ids, -1 padded
    n_valid: int
    hops: list  # list[(n_k, fanout_k) int32] position tables
    hop_masks: list  # list[(n_k, fanout_k) bool]
    seeds_pos: np.ndarray  # (batch,) positions of the seed nodes in `nodes`


class NeighborSampler:
    def __init__(self, g: CSRGraph, fanouts: tuple[int, ...], seed: int = 0):
        self.g = g
        self.fanouts = tuple(fanouts)
        self.rng = np.random.default_rng(seed)
        # capacity: batch * prod(1 + fanouts) upper bound, computed per batch.

    def capacity(self, batch: int) -> int:
        cap = batch
        layer = batch
        for f in self.fanouts:
            layer *= f
            cap += layer
        return cap

    def sample(self, seeds: np.ndarray) -> SampledBlock:
        g, rng = self.g, self.rng
        seeds = np.asarray(seeds, dtype=np.int64)
        frontier = seeds
        all_nodes = [seeds]
        raw_hops = []  # neighbor node-ids per hop, sentinel -1
        deg = g.degrees()
        for f in self.fanouts:
            n_f = len(frontier)
            d = deg[frontier]  # (n_f,)
            # sample f slots per frontier node: random offsets modulo degree
            offs = rng.integers(0, 1 << 30, size=(n_f, f))
            has = d > 0
            safe_d = np.maximum(d, 1)
            slot = offs % safe_d[:, None]
            nbrs = g.indices[g.indptr[frontier][:, None] + slot]  # (n_f, f)
            nbrs = np.where(has[:, None], nbrs, -1).astype(np.int64)
            raw_hops.append(nbrs)
            frontier = nbrs[nbrs >= 0].ravel()
            all_nodes.append(np.unique(frontier))
        uniq = np.unique(np.concatenate(all_nodes))
        uniq = uniq[uniq >= 0]
        cap = self.capacity(len(seeds))
        n_valid = len(uniq)
        assert n_valid <= cap, (n_valid, cap)
        nodes = np.full(cap, -1, dtype=np.int64)
        nodes[:n_valid] = uniq
        # position lookup (original id -> position in `nodes`, sentinel=cap)
        lut = np.full(g.num_nodes + 1, cap, dtype=np.int64)
        lut[uniq] = np.arange(n_valid)
        hops, hop_masks = [], []
        for nbrs in raw_hops:
            m = nbrs >= 0
            pos = lut[np.where(m, nbrs, 0)]
            hops.append(np.where(m, pos, cap).astype(np.int32))
            hop_masks.append(m)
        seeds_pos = lut[seeds].astype(np.int32)
        return SampledBlock(
            nodes=nodes, n_valid=n_valid, hops=hops, hop_masks=hop_masks,
            seeds_pos=seeds_pos,
        )
