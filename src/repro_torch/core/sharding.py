"""Sharded vector index: row-partitioned scan + hierarchical top-k merge.

``ShardedIndex`` splits the node-embedding matrix into ``n_shards`` row
blocks laid out over a 1-D mesh of devices, the twin of the reference's
``"shards"`` mesh.  Each mesh position scans only its block(s) with the
single-index machinery (the ``topk_sim`` kernel for brute scans, the IVF
probe and ``ivf_scan`` kernel for IVF) on its own card, translates local row
ids to global ids by shard offset, and emits a per-shard ``(Q, kk)``
candidate list.  A hierarchical (binary-tree) top-k merge on the home
device then takes the ``(S, Q, kk)`` candidates down to the exact
``(Q, k)`` contract of ``BruteIndex.search``.

* **Shards vs devices.**  ``n_shards`` is a layout property; the mesh uses
  the largest divisor of ``n_shards`` that fits the devices
  (``_mesh_size``), and each position sweeps its ``n_shards / m`` local
  shards in turn.  Position ``p``'s block is put on ``devices[p]`` once, at
  build time, and stays there; with ``inner="ivf"`` so do its centroids,
  lists and masks, and each shard's k-means runs on the card that holds it.
  ``devices=None`` is every visible card, in index order (the reference's
  ``jax.devices()``).  The reference's ``shard_map`` runs under one
  controller over the devices of one host, and so does this: one process
  drives every card, queries go out and candidates come back by
  device-to-device copies (NVLink on a multi-card host).  A device may be
  named more than once: several mesh positions on one card, as the
  reference's tests force several host devices on one CPU.  Results are
  bit-identical for any mesh at a fixed ``n_shards``.
* **Exactness under padding.**  The last shard's tail is zero-padded
  (< n_shards rows).  Zero rows score 0.0 and could displace negative-scoring
  real rows from a shard's top-k, so each shard returns ``kk = k + n_pad``
  candidates and padded ids are masked to (-inf, INT32_MAX) before the merge.
* **Tie-breaking.**  The pairwise merge orders by (score desc, global id
  asc), the order ``lax.top_k`` applies over the unsharded scores, so sharded
  brute ids equal ``BruteIndex.search``'s, duplicate-score ties included.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core import indexing as _ix
from repro_torch.kernels.topk_sim import ops as topk_ops
from repro_torch.kernels.topk_sim.ref import lex_order

_I32_MAX = torch.iinfo(torch.int32).max


def _mesh_size(n_shards: int, n_devices: int) -> int:
    """Largest divisor of n_shards that is <= n_devices (each device must
    own a whole number of logical shards).  Warns when that collapses the
    mesh well below the available devices — e.g. 7 shards on 8 devices run
    on a single device; pick a shard count that shares a factor."""
    best = 1
    for m in range(min(n_shards, n_devices), 0, -1):
        if n_shards % m == 0:
            best = m
            break
    if best < min(n_shards, n_devices):
        warnings.warn(
            f"n_shards={n_shards} is coprime-ish to the {n_devices} available "
            f"devices; using a {best}-device mesh. Choose n_shards as a "
            f"multiple of the device count for full parallelism.",
            stacklevel=3,
        )
    return best


def _concrete(dev: torch.device) -> torch.device:
    """A CUDA device with its index (the current card for bare ``cuda``)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def mesh_devices(devices, home: torch.device) -> list:
    """The mesh positions' devices: ``devices`` resolved (raising for a card
    that is not there), or, for ``None``, every visible card in index order
    when ``home`` is a CUDA device and ``[home]`` otherwise."""
    if devices is None:
        if home.type == "cuda":
            return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return [home]
    out = [_concrete(resolve_device(d)) for d in devices]
    if not out:
        raise ValueError("a mesh needs at least one device")
    return out


def _on(dev: torch.device):
    """Make ``dev`` the current card (a no-op for the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


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
# per-position scans (one device, s_local shards; one launch of the shard's
# kernel each)
# --------------------------------------------------------------------------
def _global(s, lid, si: int, rows: int, n_total: int):
    """Local ids of shard ``si`` -> global ids; the local sentinel (``rows``)
    and padded rows become (-inf, INT32_MAX)."""
    gid = lid + si * rows
    ok = (lid < rows) & (gid < n_total)
    return (torch.where(ok, s, float("-inf")),
            torch.where(ok, gid, _I32_MAX).to(torch.int32))


def _stacked(out: list):
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])


def _brute_shard_fn(emb_block, q, p: int, *, kk: int, n_total: int, rows_per_shard: int,
                    use_kernel: Optional[bool]):
    """Position ``p``'s shards -> (s_local, Q, kk) candidates, global ids."""
    s_local = emb_block.shape[0]
    return _stacked([_global(*topk_ops.topk_similarity(q, emb_block[li], kk,
                                                       use_kernel=use_kernel),
                             p * s_local + li, rows_per_shard, n_total)
                     for li in range(s_local)])


def _ivf_shard_fn(emb_block, cent_block, lists_block, mask_block, q, p: int, *, k: int,
                  n_total: int, rows_per_shard: int, nprobe: int, use_kernel: Optional[bool]):
    s_local = emb_block.shape[0]
    return _stacked([_global(*_ix.ivf_probe_scan(emb_block[li], cent_block[li], lists_block[li],
                                                 mask_block[li], q, nprobe, k,
                                                 use_kernel=use_kernel),
                             p * s_local + li, rows_per_shard, n_total)
                     for li in range(s_local)])


@dataclasses.dataclass
class ShardedIndex:
    """Row-partitioned vector index over a 1-D mesh of devices.

    ``inner="brute"`` is exact (the ids of ``BruteIndex``); ``inner="ivf"``
    builds an independent IVF structure per shard and is approximate in the
    same way single-index IVF is.  Every list below has one entry a mesh
    position, on that position's device.
    """

    emb_blocks: list  # (s_local, Np, D) each; the last shard zero-padded at the tail
    n_total: int
    rows_per_shard: int
    devices: list  # the mesh positions' devices, in order
    device: torch.device  # home: queries come in and merged results go out here
    normalized: bool = True
    inner: str = "brute"  # brute | ivf
    use_kernel: Optional[bool] = None  # passthrough to the scan ops
    # per-shard IVF state (inner == "ivf" only)
    cent_blocks: Optional[list] = None  # (s_local, C, D)
    list_blocks: Optional[list] = None  # (s_local, C, L) local ids, sentinel = Np
    mask_blocks: Optional[list] = None  # (s_local, C, L)
    nprobe: int = 4

    @property
    def mesh_size(self) -> int:
        return len(self.devices)

    @property
    def n_shards(self) -> int:
        return sum(b.shape[0] for b in self.emb_blocks)

    def _home(self, blocks: Optional[list]):
        return None if blocks is None else torch.cat([b.to(self.device) for b in blocks])

    # the reference's stacked (S, ...) arrays, gathered on the home device
    @property
    def emb_shards(self):
        return self._home(self.emb_blocks)

    @property
    def centroids(self):
        return self._home(self.cent_blocks)

    @property
    def lists(self):
        return self._home(self.list_blocks)

    @property
    def list_mask(self):
        return self._home(self.mask_blocks)

    @staticmethod
    def build(
        emb,
        n_shards: Optional[int] = None,
        inner: str = "brute",
        normalize: bool = True,
        use_kernel: Optional[bool] = None,
        devices=None,
        n_clusters: int = 64,
        nprobe: int = 4,
        n_iter: int = 10,
        seed: int = 0,
        *,
        device="cuda",
    ) -> "ShardedIndex":
        """``n_shards=None`` is one shard per device of the mesh."""
        if inner not in ("brute", "ivf"):
            raise ValueError(f"unknown inner scan: {inner}")
        home = _concrete(resolve_device(device))
        devices = mesh_devices(devices, home)
        emb = torch.as_tensor(emb, dtype=torch.float32, device=home)
        if normalize:
            emb = _ix.l2_normalize(emb)  # full-matrix, before partitioning
        n, d = emb.shape
        if n_shards is None:
            n_shards = len(devices)
        n_shards = max(1, min(int(n_shards), n))
        rows = -(-n // n_shards)
        pad = n_shards * rows - n
        shards = F.pad(emb, (0, 0, 0, pad)).reshape(n_shards, rows, d)
        idx = ShardedIndex.from_shards(shards, n, rows, normalized=normalize, inner=inner,
                                       use_kernel=use_kernel, devices=devices, device=home)
        if inner == "ivf":
            idx._build_shard_ivf(n_clusters, nprobe, n_iter, seed)
        return idx

    @staticmethod
    def from_shards(emb_shards, n_total: int, rows_per_shard: int, *, normalized: bool = True,
                    inner: str = "brute", use_kernel: Optional[bool] = None, centroids=None,
                    lists=None, list_mask=None, nprobe: int = 4, devices=None,
                    device="cuda") -> "ShardedIndex":
        """An index over given (S, Np, D) shards (and, for IVF, their stacked
        (S, C, D) centroids and (S, C, L) lists and masks) laid over the mesh:
        its size is ``_mesh_size(S, len(devices))``, and position p holds
        shards [p S / m, (p + 1) S / m) on ``devices[p]``."""
        home = _concrete(resolve_device(device))
        devices = mesh_devices(devices, home)
        m = _mesh_size(emb_shards.shape[0], len(devices))
        devices = devices[:m]
        lay = lambda a: None if a is None else _place(  # noqa: E731
            torch.as_tensor(a).to(home), devices)
        return ShardedIndex(
            emb_blocks=lay(torch.as_tensor(emb_shards, dtype=torch.float32)), n_total=n_total,
            rows_per_shard=rows_per_shard, devices=devices, device=home, normalized=normalized,
            inner=inner, use_kernel=use_kernel, cent_blocks=lay(centroids), list_blocks=lay(lists),
            mask_blocks=lay(list_mask), nprobe=nprobe)

    def to(self, device, devices=None) -> "ShardedIndex":
        """This index with ``device`` as its home, laid over ``devices``
        (default: as ``build`` picks them for that home)."""
        return ShardedIndex.from_shards(
            self.emb_shards, self.n_total, self.rows_per_shard, normalized=self.normalized,
            inner=self.inner, use_kernel=self.use_kernel, centroids=self.centroids,
            lists=self.lists, list_mask=self.list_mask, nprobe=self.nprobe, devices=devices,
            device=device)

    def _build_shard_ivf(self, n_clusters: int, nprobe: int, n_iter: int, seed: int) -> None:
        """Per-shard k-means + inverted lists over each shard's real rows,
        each on the card that holds the shard."""
        rows, d = self.rows_per_shard, self.emb_blocks[0].shape[2]
        c_eff = max(1, min(n_clusters, rows))
        per_cent, per_lists, per_mask = [], [], []
        for p, block in enumerate(self.emb_blocks):
            s_local = block.shape[0]
            with _on(block.device):
                for li in range(s_local):
                    si = p * s_local + li
                    # ceil-partitioning can leave trailing shards with no real rows
                    n_local = max(0, min(rows, self.n_total - si * rows))
                    if n_local == 0:
                        per_cent.append(torch.zeros((c_eff, d), device=block.device))
                        per_lists.append(np.full((c_eff, 8), rows, np.int32))
                        per_mask.append(np.zeros((c_eff, 8), bool))
                        continue
                    c_s = max(1, min(c_eff, n_local))
                    cent, assign = _ix.kmeans(block[li, :n_local], c_s, n_iter=n_iter,
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
        s_local = self.emb_blocks[0].shape[0]
        self.cent_blocks, self.list_blocks, self.mask_blocks = [], [], []
        for p, dev in enumerate(self.devices):
            part = slice(p * s_local, (p + 1) * s_local)
            self.cent_blocks.append(torch.stack(per_cent[part]).contiguous())
            self.list_blocks.append(
                torch.from_numpy(np.stack(per_lists[part]).astype(np.int32)).to(dev))
            self.mask_blocks.append(torch.from_numpy(np.stack(per_mask[part])).to(dev))
        self.nprobe = min(nprobe, c_eff)

    def search(self, queries, k: int):
        """(Q, D) queries -> exact-contract (scores (Q, k), ids (Q, k)) on the
        home device.  Every position's scans are launched before any of its
        candidates is copied back, so that on several cards they overlap."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        if q.ndim == 1:
            q = q[None]
        if self.normalized:
            q = _ix.l2_normalize(q)
        k = min(k, self.n_total)
        rows = self.rows_per_shard
        if self.inner == "brute":
            s_local, np_ = self.emb_blocks[0].shape[:2]
            kk = min(k + self.n_shards * np_ - self.n_total, np_)
            scan = lambda p, qp: _brute_shard_fn(  # noqa: E731
                self.emb_blocks[p], qp, p, kk=kk, n_total=self.n_total, rows_per_shard=rows,
                use_kernel=self.use_kernel)
        else:
            nprobe = min(self.nprobe, self.cent_blocks[0].shape[1])
            scan = lambda p, qp: _ivf_shard_fn(  # noqa: E731
                self.emb_blocks[p], self.cent_blocks[p], self.list_blocks[p],
                self.mask_blocks[p], qp, p, k=k, n_total=self.n_total, rows_per_shard=rows,
                nprobe=nprobe, use_kernel=self.use_kernel)
        out = []
        for p, dev in enumerate(self.devices):
            with _on(dev):
                out.append(scan(p, q.to(dev)))
        ss = torch.cat([s.to(self.device) for s, _ in out])
        ii = torch.cat([i.to(self.device) for _, i in out])
        return hierarchical_topk_merge(ss, ii, k)


def _place(stacked: torch.Tensor, devices: list) -> list:
    """(S, ...) shards -> one contiguous (S / m, ...) block a position, on
    its device.  Positions that all share one device keep views of
    ``stacked``; on several devices every block is a copy, so that no card
    keeps the whole array alive."""
    m = len(devices)
    s_local = stacked.shape[0] // m
    spread = len(set(devices)) > 1
    return [stacked[p * s_local:(p + 1) * s_local].to(dev, copy=spread).contiguous()
            for p, dev in enumerate(devices)]
