"""Sharded vector index: row-partitioned scan + hierarchical top-k merge.

``ShardedIndex`` splits the node-embedding matrix into ``n_shards`` row
blocks.  Each shard is scanned with the single-index machinery (the
``topk_sim`` kernel for brute scans, the IVF probe and ``ivf_scan`` kernel
for IVF), its local row ids become global ids by the shard's offset, and a
hierarchical (binary-tree) top-k merge takes the (S, Q, kk) candidates down
to the (Q, k) contract of ``BruteIndex.search``.

* **Logical shards.**  The reference lays the shards over a device mesh
  whose size is the largest divisor of ``n_shards`` that fits the devices
  (``_mesh_size``); on one device that is 1 and the device sweeps all its
  shards in turn.  The port runs on one card, so the shards are a loop on
  that card: no ``torch.distributed``, no mesh.
* **Exactness under padding.**  The last shard's tail is zero-padded
  (< n_shards rows).  Zero rows score 0.0 and could displace negative-scoring
  real rows from a shard's top-k, so each shard returns ``kk = k + n_pad``
  candidates and padded ids are masked to (-inf, INT32_MAX) before the merge.
* **Tie-breaking.**  The pairwise merge orders by (score desc, global id
  asc), the order ``lax.top_k`` applies over the unsharded scores, so sharded
  brute ids equal ``BruteIndex.search``'s, duplicate-score ties included.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core import indexing as _ix
from repro_torch.kernels.topk_sim import ops as topk_ops
from repro_torch.kernels.topk_sim.ref import lex_order

_I32_MAX = torch.iinfo(torch.int32).max


# --------------------------------------------------------------------------
# hierarchical top-k merge
# --------------------------------------------------------------------------
def _sorted_top(s, i, k: int):
    order = lex_order(s, i)[..., :k]
    return torch.gather(s, -1, order), torch.gather(i, -1, order)


def _merge_pair(sa, ia, sb, ib, k: int):
    """Merge two candidate lists along the last axis, keep the top k."""
    return _sorted_top(torch.cat([sa, sb], -1), torch.cat([ia, ib], -1), k)


def hierarchical_topk_merge(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """(S, Q, w) per-shard candidates -> exact (Q, k) via a binary tree.

    log2(S) rounds of pairwise merges; an odd level is padded with a
    (-inf, INT32_MAX) shard.  Selection of the k least elements under the
    total order (-score, id) is associative, so truncating to k at every
    node is exact."""
    if scores.shape[0] == 1:  # degenerate tree: sort + truncate directly
        return _sorted_top(scores[0], ids[0], min(k, scores.shape[-1]))
    while scores.shape[0] > 1:
        if scores.shape[0] % 2:
            scores = torch.cat([scores, torch.full_like(scores[:1], float("-inf"))])
            ids = torch.cat([ids, torch.full_like(ids[:1], _I32_MAX)])
        kk = min(k, 2 * scores.shape[-1])
        scores, ids = _merge_pair(scores[0::2], ids[0::2], scores[1::2], ids[1::2], kk)
    return scores[0], ids[0]


# --------------------------------------------------------------------------
# per-shard scans (one launch of the shard's kernel each) and the merge
# --------------------------------------------------------------------------
def _global(s, lid, si: int, rows: int, n_total: int):
    """Local ids of shard ``si`` -> global ids; the local sentinel (``rows``)
    and padded rows become (-inf, INT32_MAX)."""
    gid = lid + si * rows
    ok = (lid < rows) & (gid < n_total)
    return (torch.where(ok, s, float("-inf")),
            torch.where(ok, gid, _I32_MAX).to(torch.int32))


def _sharded_brute_search(emb_shards, q, k: int, n_total: int, rows: int):
    s, np_, _ = emb_shards.shape
    kk = min(k + s * np_ - n_total, np_)
    out = [_global(*topk_ops.topk_similarity(q, emb_shards[si], kk), si, rows, n_total)
           for si in range(s)]
    return hierarchical_topk_merge(torch.stack([o[0] for o in out]),
                                   torch.stack([o[1] for o in out]), k)


def _sharded_ivf_search(emb_shards, centroids, lists, list_mask, q, k: int, n_total: int,
                        rows: int, nprobe: int):
    out = [_global(*_ix.ivf_probe_scan(emb_shards[si], centroids[si], lists[si],
                                       list_mask[si], q, nprobe, k), si, rows, n_total)
           for si in range(emb_shards.shape[0])]
    return hierarchical_topk_merge(torch.stack([o[0] for o in out]),
                                   torch.stack([o[1] for o in out]), k)


@dataclasses.dataclass
class ShardedIndex:
    """Row-partitioned vector index over logical shards on one device.

    ``inner="brute"`` is exact (the ids of ``BruteIndex``); ``inner="ivf"``
    builds an independent IVF structure per shard and is approximate in the
    same way single-index IVF is.
    """

    emb_shards: torch.Tensor  # (S, Np, D); last shard zero-padded at the tail
    n_total: int
    rows_per_shard: int
    normalized: bool = True
    inner: str = "brute"  # brute | ivf
    # per-shard IVF state, stacked over shards (inner == "ivf" only)
    centroids: Optional[torch.Tensor] = None  # (S, C, D)
    lists: Optional[torch.Tensor] = None  # (S, C, L) local ids, sentinel = Np
    list_mask: Optional[torch.Tensor] = None  # (S, C, L)
    nprobe: int = 4

    @property
    def n_shards(self) -> int:
        return self.emb_shards.shape[0]

    @staticmethod
    def build(
        emb,
        n_shards: Optional[int] = None,
        inner: str = "brute",
        normalize: bool = True,
        n_clusters: int = 64,
        nprobe: int = 4,
        n_iter: int = 10,
        seed: int = 0,
        *,
        device="cuda",
    ) -> "ShardedIndex":
        """``n_shards=None`` is one shard per device, as in the reference:
        one, since the port runs on one card."""
        emb = torch.as_tensor(emb, dtype=torch.float32, device=resolve_device(device))
        if normalize:
            emb = _ix.l2_normalize(emb)  # full-matrix, before partitioning
        n, d = emb.shape
        n_shards = max(1, min(int(n_shards or 1), n))
        rows = -(-n // n_shards)
        pad = n_shards * rows - n
        shards = F.pad(emb, (0, 0, 0, pad)).reshape(n_shards, rows, d).contiguous()
        idx = ShardedIndex(emb_shards=shards, n_total=n, rows_per_shard=rows,
                           normalized=normalize, inner=inner)
        if inner == "ivf":
            idx._build_shard_ivf(n_clusters, nprobe, n_iter, seed)
        elif inner != "brute":
            raise ValueError(f"unknown inner scan: {inner}")
        return idx

    def _build_shard_ivf(self, n_clusters: int, nprobe: int, n_iter: int, seed: int) -> None:
        """Per-shard k-means + inverted lists over each shard's real rows."""
        s, rows, d = self.emb_shards.shape
        dev = self.emb_shards.device
        per_cent, per_lists, per_mask = [], [], []
        c_eff = max(1, min(n_clusters, rows))
        for si in range(s):
            # ceil-partitioning can leave trailing shards with no real rows
            n_local = max(0, min(rows, self.n_total - si * rows))
            if n_local == 0:
                per_cent.append(torch.zeros((c_eff, d), device=dev))
                per_lists.append(np.full((c_eff, 8), rows, np.int32))
                per_mask.append(np.zeros((c_eff, 8), bool))
                continue
            c_s = max(1, min(c_eff, n_local))
            cent, assign = _ix.kmeans(self.emb_shards[si, :n_local], c_s, n_iter=n_iter,
                                      seed=seed + si)
            lists, mask = _ix.build_inverted_lists(assign.cpu().numpy(), n_local, c_s)
            lists = np.where(mask, lists, rows)  # local sentinel n_local -> rows
            if c_s < c_eff:  # pad the cluster axis; extra lists are all sentinel
                cent = F.pad(cent, (0, 0, 0, c_eff - c_s))
                lists = np.pad(lists, ((0, c_eff - c_s), (0, 0)), constant_values=rows)
                mask = np.pad(mask, ((0, c_eff - c_s), (0, 0)), constant_values=False)
            per_cent.append(cent)
            per_lists.append(lists)
            per_mask.append(mask)
        pad_l = max(a.shape[1] for a in per_lists)
        per_lists = [np.pad(a, ((0, 0), (0, pad_l - a.shape[1])), constant_values=rows)
                     for a in per_lists]
        per_mask = [np.pad(a, ((0, 0), (0, pad_l - a.shape[1])), constant_values=False)
                    for a in per_mask]
        self.centroids = torch.stack(per_cent).contiguous()
        self.lists = torch.from_numpy(np.stack(per_lists).astype(np.int32)).to(dev)
        self.list_mask = torch.from_numpy(np.stack(per_mask)).to(dev)
        self.nprobe = min(nprobe, c_eff)

    def search(self, queries, k: int):
        """(Q, D) queries -> exact-contract (scores (Q, k), ids (Q, k))."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.emb_shards.device)
        if q.ndim == 1:
            q = q[None]
        if self.normalized:
            q = _ix.l2_normalize(q)
        k = min(k, self.n_total)
        if self.inner == "brute":
            return _sharded_brute_search(self.emb_shards, q, k, self.n_total,
                                         self.rows_per_shard)
        return _sharded_ivf_search(self.emb_shards, self.centroids, self.lists, self.list_mask,
                                   q, k, self.n_total, self.rows_per_shard,
                                   min(self.nprobe, self.centroids.shape[1]))
