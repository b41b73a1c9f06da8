"""Delta tier over a frozen ELL graph: streaming edge/node mutation.

The frozen formats (:class:`~repro_torch.graph.csr.CSRGraph` on the host,
:class:`~repro_torch.graph.ell.ELLGraph` on the device) are compact for scans
but immutable.  :class:`DeltaGraph` adds the mutable half: a **base** ELL
block frozen at the last compaction, plus

* per-node **append slack**: ``extra_deg`` spare neighbour slots a row for
  edges added since the last compaction,
* a **kill bitmap** over base slots: deleting a base edge masks its slot,
* a **tombstone bitmap** over nodes: deleting a node masks the node and
  every edge into it at fold time (node ids are never reused, so cached
  retrievals and prompts that name old ids stay coherent).

The mirrors are host NumPy (mutation is a host-side event at the serving
loop's rate); :meth:`DeltaGraph.merged` folds them into one device
``ELLGraph`` of shape ``(capacity, K + extra_deg)`` whose ``num_nodes`` and
sentinel are ``capacity``, which every reader (dense BFS, the compact
workset, every subgraph strategy) consumes unchanged.

**Fresh tensors every fold.**  A fold allocates new ``nbr`` / ``nbr_mask``
tensors and never writes into ones handed out earlier, so a retrieval
queued on another stream completes against the snapshot it was launched on,
as long as the launcher holds that snapshot's tensors until its work is
done (:mod:`repro_torch.serving.prefetch`).

**Resident fold inputs.**  The reference uploads every mirror on every fold
(the base slots alone are ``capacity * K * 5`` bytes).  Here the base
neighbour ids are uploaded once per :class:`DeltaGraph` (they change only
at compaction), and the live-slot mask, slack ids and slack counts stay on
the device too: a fold uploads only the rows a mutation touched since the
last fold (``_dirty``) and the tombstone bitmap, then runs the same concat
and masks.  Those inputs are read only by folds, on the current stream, so
updating them in place is ordered with every fold that reads them.

Compaction is not done here: :class:`repro_torch.core.mutation.MutableGraphStore`
rebuilds a canonical base from :meth:`DeltaGraph.live_edge_list`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.graph.ell import ELLGraph


class SlackOverflow(RuntimeError):
    """A per-row append buffer is full — compact to fold slack into base."""


class CapacityOverflow(RuntimeError):
    """No free node rows left — compact with a larger capacity."""


def _fold_merged(base_nbr, base_live, extra_nbr, extra_mask, tomb, *, capacity: int):
    """Concat base + slack slots and mask kills/tombstones: the reference's
    ``_fold_merged`` in plain PyTorch.  Returns fresh (nbr, mask)."""
    nbr = torch.cat([base_nbr, extra_nbr], dim=1)
    mask = torch.cat([base_live, extra_mask], dim=1)
    # sentinel id == capacity: give the tombstone gather a neutral last row
    tomb_ext = torch.cat([tomb, tomb.new_zeros(1)])
    into_dead = torch.index_select(tomb_ext, 0, nbr.clamp(max=capacity).view(-1))
    mask &= ~into_dead.view(nbr.shape)  # edges INTO dead
    mask &= ~tomb[:, None]  # rows OF dead
    nbr = torch.where(mask, nbr, torch.full((), capacity, dtype=nbr.dtype, device=nbr.device))
    return nbr, mask


def upload(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A device copy of the host array ``x`` that never shares its memory
    (``from_numpy(...).to("cpu")`` would alias the mirror)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(dev) if dev.type != "cpu" else t.clone()


class DeltaGraph:
    """Mutable graph = frozen base ELL + slack/kill/tombstone overlays.

    ``capacity`` rows are pre-allocated; logical node ids are
    ``0 .. n_nodes-1`` and grow by :meth:`add_node` (never reused).  The
    device-facing sentinel is ``capacity`` throughout.  ``device`` is where
    :meth:`merged` puts the fold.
    """

    def __init__(self, base_nbr: np.ndarray, base_mask: np.ndarray, n_nodes: int,
                 capacity: int, extra_deg: int = 16, *, device="cuda"):
        n, k = base_mask.shape
        if n > capacity:
            raise ValueError(f"base has {n} rows > capacity {capacity}")
        if n_nodes < n:
            raise ValueError("n_nodes must cover every base row")
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.extra_deg = int(extra_deg)
        self.n_nodes = int(n_nodes)
        self.base_deg = int(k)
        # base slots, remapped to the capacity sentinel and capacity rows
        self.h_base_nbr = np.full((capacity, k), capacity, dtype=np.int32)
        self.h_base_nbr[:n] = np.where(base_mask, base_nbr, capacity)
        self.h_base_mask = np.zeros((capacity, k), dtype=bool)
        self.h_base_mask[:n] = base_mask
        self.h_kill = np.zeros((capacity, k), dtype=bool)
        self.h_extra = np.full((capacity, extra_deg), capacity, dtype=np.int32)
        self.h_extra_cnt = np.zeros(capacity, dtype=np.int32)
        self.tomb = np.zeros(capacity, dtype=bool)
        self._merged: Optional[ELLGraph] = None  # cached device fold
        self._dev: Optional[dict] = None  # resident fold inputs, made at the first fold
        self._dirty: set = set()  # rows whose kills or slack changed since the last fold

    # ---- mutation ops (host mirrors; device fold is rebuilt lazily) -----
    def _check_id(self, u: int) -> None:
        if not (0 <= u < self.n_nodes):
            raise ValueError(f"node id {u} out of range [0, {self.n_nodes})")
        if self.tomb[u]:
            raise ValueError(f"node id {u} is tombstoned")

    def _touch(self, u: int) -> None:
        self._dirty.add(u)
        self._merged = None

    def add_node(self) -> int:
        if self.n_nodes >= self.capacity:
            raise CapacityOverflow(f"capacity {self.capacity} exhausted; compact with headroom")
        u = self.n_nodes
        self.n_nodes += 1
        self._merged = None
        return u

    def add_edge(self, u: int, v: int) -> bool:
        """Add directed edge u->v.  Returns False if it already exists."""
        self._check_id(u)
        self._check_id(v)
        row_live = self.h_base_mask[u] & ~self.h_kill[u]
        if np.any(row_live & (self.h_base_nbr[u] == v)):
            return False
        # resurrect a killed base slot before consuming slack
        killed = self.h_base_mask[u] & self.h_kill[u] & (self.h_base_nbr[u] == v)
        if np.any(killed):
            self.h_kill[u, int(np.argmax(killed))] = False
            self._touch(u)
            return True
        c = int(self.h_extra_cnt[u])
        if np.any(self.h_extra[u, :c] == v):
            return False
        if c >= self.extra_deg:
            raise SlackOverflow(f"node {u}: {self.extra_deg} slack slots full; compact")
        self.h_extra[u, c] = v
        self.h_extra_cnt[u] = c + 1
        self._touch(u)
        return True

    def del_edge(self, u: int, v: int) -> bool:
        """Delete directed edge u->v.  Returns False if absent."""
        self._check_id(u)
        base = self.h_base_mask[u] & ~self.h_kill[u] & (self.h_base_nbr[u] == v)
        if np.any(base):
            self.h_kill[u, int(np.argmax(base))] = True
            self._touch(u)
            return True
        c = int(self.h_extra_cnt[u])
        hit = np.flatnonzero(self.h_extra[u, :c] == v)
        if hit.size:
            i = int(hit[0])  # shift left: keeps insertion order deterministic
            self.h_extra[u, i:c - 1] = self.h_extra[u, i + 1:c]
            self.h_extra[u, c - 1] = self.capacity
            self.h_extra_cnt[u] = c - 1
            self._touch(u)
            return True
        return False

    def del_node(self, u: int) -> None:
        self._check_id(u)
        self.tomb[u] = True
        self._merged = None

    # ---- host views -----------------------------------------------------
    def _extra_mask_host(self) -> np.ndarray:
        return np.arange(self.extra_deg)[None, :] < self.h_extra_cnt[:, None]

    def neighbors_live(self, u: int) -> np.ndarray:
        """Live out-neighbours of ``u`` (tombstoned targets excluded)."""
        row_live = self.h_base_mask[u] & ~self.h_kill[u]
        c = int(self.h_extra_cnt[u])
        nbrs = np.concatenate([self.h_base_nbr[u][row_live], self.h_extra[u, :c]])
        return nbrs[~self.tomb[nbrs]]

    def live_edge_list(self) -> tuple[np.ndarray, np.ndarray]:
        """All surviving directed edges among non-tombstoned nodes."""
        nbr = np.concatenate([self.h_base_nbr, self.h_extra], axis=1)
        mask = np.concatenate([self.h_base_mask & ~self.h_kill, self._extra_mask_host()], axis=1)
        mask &= ~self.tomb[:, None]
        mask &= ~self.tomb[np.minimum(nbr, self.capacity - 1)]
        src, slot = np.nonzero(mask)
        return src.astype(np.int64), nbr[src, slot].astype(np.int64)

    def merged_host(self) -> tuple[np.ndarray, np.ndarray]:
        """NumPy oracle of the merged view (tests compare the device fold)."""
        nbr = np.concatenate([self.h_base_nbr, self.h_extra], axis=1)
        mask = np.concatenate([self.h_base_mask & ~self.h_kill, self._extra_mask_host()], axis=1)
        tomb_ext = np.concatenate([self.tomb, [False]])
        mask = mask & ~tomb_ext[np.minimum(nbr, self.capacity)]
        mask = mask & ~self.tomb[:, None]
        nbr = np.where(mask, nbr, self.capacity).astype(np.int32)
        return nbr, mask

    # ---- device view ----------------------------------------------------
    def _fold_inputs(self) -> dict:
        """The resident fold inputs, brought up to date with the mirrors:
        the first call uploads everything, later ones the dirty rows only."""
        dev = self.device
        if self._dev is None:
            self._dev = {"base_nbr": upload(self.h_base_nbr, dev),
                         "live": upload(self.h_base_mask & ~self.h_kill, dev),
                         "extra": upload(self.h_extra, dev),
                         "extra_cnt": upload(self.h_extra_cnt, dev)}
        elif self._dirty:
            rows = np.fromiter(sorted(self._dirty), dtype=np.int64, count=len(self._dirty))
            at = upload(rows, dev)
            d = self._dev
            d["live"][at] = upload(self.h_base_mask[rows] & ~self.h_kill[rows], dev)
            d["extra"][at] = upload(self.h_extra[rows], dev)
            d["extra_cnt"][at] = upload(self.h_extra_cnt[rows], dev)
        self._dirty.clear()
        return self._dev

    def merged(self) -> ELLGraph:
        """Device merged view; cached until the next mutation.

        The fold allocates fresh device tensors, so ``ELLGraph`` snapshots
        handed out earlier stay valid for work still queued on them.
        """
        if self._merged is None:
            d = self._fold_inputs()
            extra_mask = (torch.arange(self.extra_deg, device=self.device)[None, :]
                          < d["extra_cnt"][:, None])
            nbr, mask = _fold_merged(d["base_nbr"], d["live"], d["extra"], extra_mask,
                                     upload(self.tomb, self.device), capacity=self.capacity)
            self._merged = ELLGraph(nbr=nbr, nbr_mask=mask, num_nodes=self.capacity,
                                    node_feat=None)
        return self._merged
