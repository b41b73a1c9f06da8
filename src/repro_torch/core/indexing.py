"""Stage 1 of the RGL pipeline: indexing.

Vector indexes over node embeddings (paper §2.1.2):

* :class:`BruteIndex` — exact scoring of every node; its hot loop is the
  fused similarity→top-k kernel (:mod:`repro_torch.kernels.topk_sim`).
* :class:`IVFIndex` — k-means coarse quantizer with padded inverted lists;
  probes ``nprobe`` lists per query and scores their members with the
  :mod:`repro_torch.kernels.ivf_scan` kernel.
* ``ShardedIndex`` (:mod:`repro_torch.core.sharding`) — row-partitions
  either scan into logical shards and merges the per-shard top-k.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.kernels.ivf_scan import ops as ivf_ops
from repro_torch.kernels.topk_sim import ops as topk_ops
from repro_torch.kernels.topk_sim.ref import stable_topk


def l2_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)) + eps)


@dataclasses.dataclass
class BruteIndex:
    emb: torch.Tensor  # (N, D) float32, rows may be L2-normalized
    normalized: bool = True

    @staticmethod
    def build(emb, normalize: bool = True, *, device="cuda") -> "BruteIndex":
        emb = torch.as_tensor(emb, dtype=torch.float32, device=resolve_device(device))
        if normalize:
            emb = l2_normalize(emb)
        return BruteIndex(emb=emb.contiguous(), normalized=normalize)

    def search(self, queries, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Return (scores, ids) of the top-k most similar nodes, (Q, k)."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.emb.device)
        if self.normalized:
            q = l2_normalize(q)
        return topk_ops.topk_similarity(q, self.emb, k)


def _lloyd(x: torch.Tensor, cent: torch.Tensor, n_iter: int):
    """Lloyd iterations from the initial centroids ``cent`` (C, D): returns
    (centroids (C, D) float32, the last iteration's assignment (N,)).

    Distances and cluster sums are taken in float64 and the centroids kept
    in float32, as the reference keeps them.  The cluster sums are a dense
    one-hot product (C, N) @ (N, D) — a cuBLAS DGEMM on the card, which gives
    the same bits on every run on one card — and not ``index_add_``, whose
    atomics add in a different order each run.  In float64 the card's and
    the CPU's assignments can part only where two distances agree to about
    1e-15.  An empty cluster keeps its centroid; ties go to the lower
    cluster."""
    c = cent.shape[0]
    x64 = x.double()
    xx = torch.sum(x64 * x64, dim=1, keepdim=True)
    assign = None
    for _ in range(n_iter):
        c64 = cent.double()
        d = xx - 2.0 * (x64 @ c64.T) + torch.sum(c64 * c64, dim=1)[None, :]
        assign = torch.argmin(d, dim=1)
        sums = F.one_hot(assign, c).double().T @ x64
        counts = torch.bincount(assign, minlength=c)
        new = (sums / counts.clamp(min=1)[:, None].double()).float()
        cent = torch.where(counts[:, None] > 0, new, cent)
    return cent, assign


def kmeans(x: torch.Tensor, n_clusters: int, n_iter: int = 10, seed: int = 0):
    """Lloyd's algorithm.  Returns (centroids (C, D), assignment (N,)).

    The initial centroids are ``n_clusters`` rows drawn by NumPy from
    ``seed`` (with replacement when ``n_clusters > n``: duplicate centroids
    yield empty clusters, which stay frozen).  The reference draws them with
    ``jax.random.choice``, which no other generator reproduces."""
    n = x.shape[0]
    init = np.random.default_rng(seed).choice(n, size=n_clusters, replace=n_clusters > n)
    return _lloyd(x, x[torch.from_numpy(init).to(x.device)], n_iter)


def build_inverted_lists(
    assign: np.ndarray, n: int, n_clusters: int, min_pad: int = 8
) -> tuple[np.ndarray, np.ndarray]:
    """Padded inverted lists from a cluster assignment — vectorized scatter.

    Returns (lists (C, L) int32 with sentinel n, mask (C, L) bool).  A
    member's rank within its cluster is its position in the stable argsort
    minus the cluster's start offset (cumcount)."""
    assign = np.asarray(assign)
    counts = np.bincount(assign, minlength=n_clusters)
    pad = max(min_pad, int(counts.max()) if n else min_pad)
    lists = np.full((n_clusters, pad), n, dtype=np.int32)
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ranks = np.arange(n) - starts[sorted_assign]
    lists[sorted_assign, ranks] = order
    return lists, lists < n


@dataclasses.dataclass
class IVFIndex:
    """Inverted-file index: coarse centroids + padded member lists."""

    emb: torch.Tensor  # (N, D)
    centroids: torch.Tensor  # (C, D)
    lists: torch.Tensor  # (C, L) int32 member ids, sentinel = N
    list_mask: torch.Tensor  # (C, L) bool
    nprobe: int = 4

    @staticmethod
    def build(
        emb, n_clusters: int = 64, nprobe: int = 4, n_iter: int = 10,
        normalize: bool = True, seed: int = 0, *, device="cuda",
    ) -> "IVFIndex":
        dev = resolve_device(device)
        emb = torch.as_tensor(emb, dtype=torch.float32, device=dev)
        if normalize:
            emb = l2_normalize(emb)
        n = emb.shape[0]
        n_clusters = max(1, min(n_clusters, n))
        cent, assign = kmeans(emb, n_clusters, n_iter=n_iter, seed=seed)
        lists, mask = build_inverted_lists(assign.cpu().numpy(), n, n_clusters)
        return IVFIndex(
            emb=emb.contiguous(), centroids=cent.contiguous(),
            lists=torch.from_numpy(lists).to(dev), list_mask=torch.from_numpy(mask).to(dev),
            nprobe=min(nprobe, n_clusters),
        )

    def search(self, queries, k: int):
        q = l2_normalize(torch.as_tensor(queries, dtype=torch.float32, device=self.emb.device))
        return ivf_probe_scan(self.emb, self.centroids, self.lists, self.list_mask, q,
                              min(self.nprobe, self.centroids.shape[0]), k)


def ivf_candidates(centroids, lists, list_mask, q, nprobe: int):
    """Score the centroids, pick ``nprobe`` lists per query (ties to the
    lower list, as ``lax.top_k``) and gather their member ids: (cand, cmask),
    each (Q, nprobe * L), sentinel-padded."""
    _, probe = stable_topk(q @ centroids.T, nprobe)  # (Q, P)
    return (lists[probe].reshape(q.shape[0], -1),  # int32 ids
            list_mask[probe].reshape(q.shape[0], -1))


def ivf_probe_scan(emb, centroids, lists, list_mask, q, nprobe: int, k: int):
    """The IVF search (also run per shard): probe, then scan the candidates
    (:func:`repro_torch.kernels.ivf_scan.ops.ivf_candidate_scan`)."""
    cand, cmask = ivf_candidates(centroids, lists, list_mask, q, nprobe)
    return ivf_ops.ivf_candidate_scan(q, emb, cand, cmask, k)


def build_index(emb, kind: str = "brute", **kw):
    if kind == "brute":
        return BruteIndex.build(emb, **kw)
    if kind == "ivf":
        return IVFIndex.build(emb, **kw)
    if kind in ("sharded", "sharded_ivf"):
        from repro_torch.core.sharding import ShardedIndex  # local: avoid cycle

        inner = "ivf" if kind == "sharded_ivf" else "brute"
        return ShardedIndex.build(emb, inner=inner, **kw)
    raise ValueError(f"unknown index kind: {kind}")
