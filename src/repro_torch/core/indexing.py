"""Stage 1 of the RGL pipeline: indexing.

Vector indexes over node embeddings (paper §2.1.2):

* :class:`BruteIndex` — exact scoring of every node; its hot loop is the
  fused similarity→top-k kernel (:mod:`repro_torch.kernels.topk_sim`).
* :class:`IVFIndex` — k-means coarse quantizer with padded inverted lists;
  probes ``nprobe`` lists per query and scores their members with the
  :mod:`repro_torch.kernels.ivf_scan` kernel.
* ``ShardedIndex`` (:mod:`repro_torch.core.sharding`) — row-partitions
  either scan into shards laid over the host's cards and merges the
  per-shard top-k.
* :class:`MutableBruteIndex` / :class:`MutableIVFIndex` — the online
  mutation tier's capacity-padded indexes (:mod:`repro_torch.core.mutation`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.graph.delta import SlackOverflow
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


def ivf_probe_scan(emb, centroids, lists, list_mask, q, nprobe: int, k: int, *,
                   use_kernel=None):
    """The IVF search (also run per shard): probe, then scan the candidates
    (:func:`repro_torch.kernels.ivf_scan.ops.ivf_candidate_scan`, to which
    ``use_kernel`` is passed)."""
    cand, cmask = ivf_candidates(centroids, lists, list_mask, q, nprobe)
    return ivf_ops.ivf_candidate_scan(q, emb, cand, cmask, k, use_kernel=use_kernel)


# ---- mutable tier (online insert/delete; see repro_torch.core.mutation) ----
#
# The frozen indexes above assume the corpus is complete before build.  The
# mutable variants serve a corpus that changes while the engine runs:
# capacity-padded embedding rows with a ``valid`` bitmap (deletes are masked
# at scan time), and, for IVF, a **frozen coarse quantizer**: new embeddings
# are assigned to the nearest existing centroid into per-list append slack,
# and compaction rebuilds only the list layout (never the centroids).  Both
# the incremental path and a rebuild assign with :func:`assign_to_centroids`,
# so post-compaction state is bitwise equal to a from-scratch build.


def assign_to_centroids(embn: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid assignment in fp32, the reference's distance form
    ``|e|^2 - 2 e.c + |c|^2``, ties to the lower centroid (``argmin`` takes
    the first).  The one assignment that activation, incremental adds and
    compaction all use: the bitwise rebuild parity rests on it."""
    d = (torch.sum(embn * embn, dim=1)[:, None] - 2.0 * (embn @ centroids.T)
         + torch.sum(centroids * centroids, dim=1)[None, :])
    return torch.argmin(d, dim=1)


def build_inverted_lists_slack(
    assign: np.ndarray, ids: np.ndarray, capacity: int, n_clusters: int,
    slack: int, min_pad: int = 8,
) -> tuple[np.ndarray, np.ndarray]:
    """Padded inverted lists over ``ids`` only, with ``slack`` spare slots a
    list for future appends.  Returns (lists (C, L) int32 with sentinel
    ``capacity``, counts (C,) int32).  Members are stored in ascending id
    order (``ids`` must be sorted), the canonical layout compaction
    re-creates."""
    assign = np.asarray(assign)
    ids = np.asarray(ids, dtype=np.int32)
    counts = np.bincount(assign, minlength=n_clusters).astype(np.int32)
    width = int(counts.max()) + slack if ids.size else slack
    width = max(min_pad, -(-width // min_pad) * min_pad)
    lists = np.full((n_clusters, width), capacity, dtype=np.int32)
    order = np.argsort(assign, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ranks = np.arange(ids.size) - starts[assign[order]]
    lists[assign[order], ranks] = ids[order]
    return lists, counts


@dataclasses.dataclass
class MutableBruteIndex:
    """Exact scan over capacity-padded rows; deletes masked to ``-inf``.

    The reference scores this index in XLA (``q @ emb.T``, a mask, then
    ``lax.top_k``), outside its Pallas kernel, so the port runs a plain
    ``torch.matmul`` and a stable top-k (lowest id first among ties, dead
    rows last): an active brute store launches no ``topk_sim``."""

    emb: torch.Tensor  # (capacity, D) L2-normalized; dead rows are zero
    valid: torch.Tensor  # (capacity,) bool

    def search(self, queries, k: int):
        q = l2_normalize(torch.as_tensor(queries, dtype=torch.float32, device=self.emb.device))
        scores = torch.where(self.valid[None, :], q @ self.emb.T,
                             torch.full((), float("-inf"), device=q.device))
        s, i = stable_topk(scores, k)
        return s, i.to(torch.int32)


class MutableIVFIndex:
    """IVF with a frozen coarse quantizer and per-list append slack.

    ``h_lists`` / ``h_counts`` are host mirrors; the device copies are
    re-uploaded lazily after a mutation.  An append that would overflow a
    list raises :class:`repro_torch.graph.delta.SlackOverflow`, which the
    owning store answers with a compaction.  The search probes with
    :func:`ivf_candidates` and masks deleted rows out of the candidates
    (``valid[min(cand, N - 1)]``) before the ``ivf_scan`` kernel scores them.
    """

    def __init__(self, emb, centroids, h_lists, h_counts, valid, nprobe: int = 4,
                 slack: int = 8):
        self.emb = emb  # (capacity, D) normalized, on the device
        self.centroids = centroids  # (C, D) on the device, frozen
        self.h_lists = h_lists  # (C, L) int32, sentinel = capacity
        self.h_counts = h_counts  # (C,) int32
        self.valid = valid  # (capacity,) bool, on the device
        self.nprobe = int(nprobe)
        self.slack = int(slack)
        self._dev = None  # cached (lists, mask) device pair

    @property
    def n_clusters(self) -> int:
        return int(self.h_lists.shape[0])

    def add(self, ids: np.ndarray) -> np.ndarray:
        """Append ``ids`` (already written into ``emb``) to their nearest
        list.  Returns the cluster assignment; raises on slack overflow."""
        ids = np.asarray(ids, dtype=np.int32)
        if ids.size == 0:
            return ids
        at = torch.from_numpy(ids.astype(np.int64)).to(self.emb.device)
        assign = assign_to_centroids(self.emb[at], self.centroids).cpu().numpy()
        width = self.h_lists.shape[1]
        for i, c in zip(ids, assign):
            cnt = int(self.h_counts[c])
            if i in self.h_lists[c, :cnt]:
                continue  # already indexed (e.g. by a compaction rebuild)
            if cnt >= width:
                raise SlackOverflow(f"IVF list {int(c)}: {width} slots full; compact")
            self.h_lists[c, cnt] = i
            self.h_counts[c] = cnt + 1
        self._dev = None
        return assign

    def _device_lists(self):
        if self._dev is None:
            mask = np.arange(self.h_lists.shape[1])[None, :] < self.h_counts[:, None]
            dev = self.emb.device
            self._dev = (torch.from_numpy(self.h_lists.copy()).to(dev),
                         torch.from_numpy(mask).to(dev))
        return self._dev

    def search(self, queries, k: int):
        q = l2_normalize(torch.as_tensor(queries, dtype=torch.float32, device=self.emb.device))
        lists, mask = self._device_lists()
        cand, cmask = ivf_candidates(self.centroids, lists, mask, q,
                                     min(self.nprobe, self.n_clusters))
        cmask = cmask & self.valid[cand.clamp(max=self.emb.shape[0] - 1)]  # scan-time deletes
        return ivf_ops.ivf_candidate_scan(q, self.emb, cand, cmask, k)


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
