"""Online corpus mutation: one store owning graph + index + embeddings.

``MutableGraphStore`` is the write path of the serving stack.  It composes

* a :class:`~repro_torch.graph.delta.DeltaGraph` (frozen base ELL + append
  slack + kill/tombstone bitmaps, folded into a merged device view),
* a mutable vector index (:class:`~repro_torch.core.indexing.MutableBruteIndex`
  or :class:`~repro_torch.core.indexing.MutableIVFIndex` with a frozen
  coarse quantizer and per-list append slack),
* capacity-padded node embeddings and text with an ``alive`` bitmap,

and keeps every attached :class:`~repro_torch.core.pipeline.RGLPipeline`
pointed at the current merged snapshot.  Three invariants carry it:

**Zero-mutation parity.**  A freshly built store is *pristine*: it hands
out the exact frozen objects (``ELLGraph``, ``BruteIndex`` / ``IVFIndex``,
the embedding tensor) a mutation-free setup builds, so a serve that never
mutates runs the same kernels on the same tensors as one without the store.
The first ``apply()`` activates the delta tier (a capacity-padded rebuild).

**Snapshot functionality.**  ``apply()`` builds *new* device tensors and
re-points the attached pipelines between engine steps; tensors handed to
an already-dispatched retrieval are never written.  On the card that is not
enough by itself: the retrieval may still be queued on another stream when
the pipeline lets go of the old tensors, and the caching allocator would
then hand their memory to the next allocation on the current stream.  The
admission prefetcher therefore holds every pipeline tensor a wave reads
until the wave's event completes (:mod:`repro_torch.serving.prefetch`).

**Rebuild parity.**  ``compact()`` derives the merged logical corpus
(surviving edges, alive bitmap, zeroed dead rows) from the host mirrors and
feeds it through the *same* canonical build (edge canonicalization ->
``CSRGraph.from_edges`` -> ELL -> ``assign_to_centroids`` list layout) that
``build(..., alive=...)`` uses for a from-scratch construction, so the
state after a compaction is bitwise equal to a rebuild on the same corpus.
For IVF the comparator shares the frozen quantizer.

Node ids are stable forever: tombstoned ids keep their (empty) rows and are
never reused, so cached retrievals, prompts and region keys stay coherent.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import indexing
from repro_torch.core.pipeline import PipelineConfig, RGLPipeline
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.delta import CapacityOverflow, DeltaGraph, SlackOverflow, upload
from repro_torch.graph.ell import csr_to_ell, ell_arrays


@dataclasses.dataclass
class MutationBatch:
    """One atomic corpus change set.

    ``add_edges`` may name nodes added in the same batch: new ids are
    assigned in order from the store's current ``n_nodes``.
    ``symmetric=True`` (default) inserts/deletes both arc directions: the
    retrieval tier's BFS pulls over a symmetrized graph.
    """

    add_node_feat: Optional[np.ndarray] = None  # (A, D) float32
    add_node_text: Optional[list] = None  # len A (defaults to "")
    add_edges: tuple = ()  # iterable of (u, v)
    del_edges: tuple = ()
    del_nodes: tuple = ()
    symmetric: bool = True

    @property
    def n_added_nodes(self) -> int:
        if self.add_node_feat is None:
            return 0
        return int(np.asarray(self.add_node_feat).shape[0])

    @property
    def is_empty(self) -> bool:
        # len(), not truthiness: edge fields are commonly NumPy arrays,
        # whose bool() raises for more than one element
        return (self.n_added_nodes == 0 and len(self.add_edges) == 0
                and len(self.del_edges) == 0 and len(self.del_nodes) == 0)


@dataclasses.dataclass
class MutationReport:
    """What one ``apply()`` did; the cache's invalidation reads it."""

    epoch: int
    touched: np.ndarray  # node ids whose adjacency or liveness changed
    added_nodes: tuple = ()
    compactions: int = 0  # overflow-triggered compactions during the apply
    edges_added: int = 0
    edges_deleted: int = 0
    nodes_deleted: int = 0


class MutableGraphStore:
    """Corpus that changes while the engine serves (see the module docstring)."""

    MUTABLE_INDEX_KINDS = ("brute", "ivf")

    def __init__(self, *, csr: CSRGraph, node_emb: np.ndarray, node_text: Optional[list],
                 index_kind: str, index_kw: dict, headroom: int, extra_deg: int,
                 ivf_slack: int, max_deg: Optional[int], pad_to_multiple: int,
                 centroids=None, device="cuda"):
        if index_kind not in self.MUTABLE_INDEX_KINDS:
            raise ValueError(f"mutable store supports index kinds "
                             f"{self.MUTABLE_INDEX_KINDS}, got {index_kind!r}")
        self.device = dev = resolve_device(device)
        self.index_kind = index_kind
        self.index_kw = dict(index_kw)
        self.headroom = int(headroom)
        self.extra_deg = int(extra_deg)
        self.ivf_slack = int(ivf_slack)
        self.max_deg = max_deg
        self.pad_to_multiple = int(pad_to_multiple)

        self.epoch = 0
        self.compactions = 0
        self.mutations_since_compact = 0
        self.batches_applied = 0
        self._pipelines: list = []  # weak references to the attached pipelines

        # pristine tier: the exact objects a frozen-corpus setup builds
        self._pristine_csr = csr
        self._pristine_ell = csr_to_ell(csr, max_deg=max_deg, pad_to_multiple=pad_to_multiple,
                                        device=dev)
        self._pristine_emb = torch.as_tensor(np.asarray(node_emb, np.float32), device=dev)
        if index_kind == "ivf" and centroids is not None:
            self._pristine_index = self._ivf_over(centroids)
        else:
            self._pristine_index = indexing.build_index(self._pristine_emb, kind=index_kind,
                                                        device=dev, **self.index_kw)
        self._h_feat0 = np.asarray(node_emb, dtype=np.float32)
        self.node_text = list(node_text) if node_text is not None else None
        self._active = False
        # active-tier state, set by _build_active()
        self.delta: Optional[DeltaGraph] = None
        self.h_feat: Optional[np.ndarray] = None
        self._emb_dev = None
        self._index = None

    def _ivf_over(self, centroids) -> indexing.IVFIndex:
        """The pristine IVF index over a given quantizer: every row assigned
        with :func:`~repro_torch.core.indexing.assign_to_centroids`, lists
        in id order.  The reference ignores ``centroids`` on a pristine store
        and runs kmeans, whose ``jax.random.choice`` initialization the port
        cannot reproduce; a test hands both stores the same quantizer."""
        cent = torch.as_tensor(np.asarray(centroids, np.float32), device=self.device)
        embn = indexing.l2_normalize(self._pristine_emb)
        n, c = embn.shape[0], cent.shape[0]
        assign = indexing.assign_to_centroids(embn, cent).cpu().numpy()
        lists, mask = indexing.build_inverted_lists(assign, n, c)
        return indexing.IVFIndex(
            emb=embn.contiguous(), centroids=cent.contiguous(),
            lists=torch.from_numpy(lists).to(self.device),
            list_mask=torch.from_numpy(mask).to(self.device),
            nprobe=min(self.index_kw.get("nprobe", 4), c))

    # ---- construction ---------------------------------------------------
    @classmethod
    def build(cls, csr: CSRGraph, *, node_emb=None, node_text=None, index_kind: str = "brute",
              index_kw: Optional[dict] = None, headroom: int = 64, extra_deg: int = 16,
              ivf_slack: int = 8, max_deg: Optional[int] = None, pad_to_multiple: int = 8,
              alive: Optional[np.ndarray] = None, active: bool = False,
              device="cuda") -> "MutableGraphStore":
        """Build a store over ``csr`` on ``device``.

        Default is the pristine (bitwise-frozen) tier.  ``active=True``,
        optionally with an ``alive`` bitmap, builds the capacity-padded
        active tier directly: the from-scratch comparator of the rebuild
        parity checks.  For IVF, ``index_kw['centroids']`` is the frozen
        quantizer, on a pristine store as on an active one.
        """
        if node_emb is None:
            node_emb = csr.node_feat
        if node_text is None:
            node_text = csr.node_text
        kw = dict(index_kw or {})
        centroids = kw.pop("centroids", None)
        store = cls(csr=csr, node_emb=node_emb, node_text=node_text, index_kind=index_kind,
                    index_kw=kw, headroom=headroom, extra_deg=extra_deg, ivf_slack=ivf_slack,
                    max_deg=max_deg, pad_to_multiple=pad_to_multiple, centroids=centroids,
                    device=device)
        if active or alive is not None:
            n = csr.num_nodes
            a = np.ones(n, bool) if alive is None else np.asarray(alive, bool).copy()
            src, dst = csr.edge_list()
            feat = store._h_feat0 * a[:, None]
            text = list(store.node_text) if store.node_text is not None else None
            store._build_active(n, a, src.astype(np.int64), dst.astype(np.int64), feat, text,
                                centroids=centroids)
        return store

    # ---- views (what pipelines consume) ---------------------------------
    @property
    def active(self) -> bool:
        return self._active

    @property
    def n_nodes(self) -> int:
        return self.delta.n_nodes if self._active else self._pristine_csr.num_nodes

    @property
    def capacity(self) -> int:
        return self.delta.capacity if self._active else self._pristine_csr.num_nodes

    @property
    def alive(self) -> np.ndarray:
        """Host bitmap over logical ids [0, n_nodes)."""
        if not self._active:
            return np.ones(self.n_nodes, bool)
        return ~self.delta.tomb[: self.n_nodes]

    @property
    def graph(self):
        return self.delta.merged() if self._active else self._pristine_ell

    @property
    def index(self):
        return self._index if self._active else self._pristine_index

    @property
    def node_emb(self):
        return self._emb_dev if self._active else self._pristine_emb

    def make_pipeline(self, *, tokenizer=None, generator=None,
                      config: Optional[PipelineConfig] = None) -> RGLPipeline:
        # the pipeline attaches itself (RGLPipeline.__post_init__), as does
        # every copy made of it with dataclasses.replace
        return RGLPipeline(graph=self.graph, index=self.index, node_emb=self.node_emb,
                           tokenizer=tokenizer, generator=generator, node_text=self.node_text,
                           config=config or PipelineConfig(), device=self.device,
                           mutation_store=self)

    def attach(self, pipeline: RGLPipeline) -> None:
        """Adopt a pipeline: it is re-pointed on every apply from now on.
        Held weakly, so a discarded copy does not keep old snapshots alive."""
        pipeline.mutation_store = self
        if not any(ref() is pipeline for ref in self._pipelines):
            self._pipelines.append(weakref.ref(pipeline))
        self._sync_pipelines()

    def _sync_pipelines(self) -> None:
        self._pipelines = [ref for ref in self._pipelines if ref() is not None]
        for ref in self._pipelines:
            p = ref()
            p.graph = self.graph
            p.index = self.index
            p.node_emb = self.node_emb
            p.node_text = self.node_text

    # ---- canonical active-tier build (apply/compact/from-scratch) -------
    def _build_active(self, n: int, alive: np.ndarray, src: np.ndarray, dst: np.ndarray,
                      feat: np.ndarray, text: Optional[list], *, centroids=None,
                      min_capacity: int = 0) -> None:
        """Rebuild the capacity-padded tier from a logical corpus.

        Every path into the active tier (first activation, compaction and
        the from-scratch comparator) goes through this one function: the
        same corpus in gives the same arrays out.
        """
        keep = alive[src] & alive[dst]
        src, dst = src[keep], dst[keep]
        order = np.lexsort((dst, src))
        src, dst = src[order], dst[order]
        if src.size:
            dup = np.concatenate([[False], (src[1:] == src[:-1]) & (dst[1:] == dst[:-1])])
            src, dst = src[~dup], dst[~dup]
        csr = CSRGraph.from_edges(src, dst, n)
        nbr, mask = ell_arrays(csr, self.max_deg, pad_to_multiple=self.pad_to_multiple)
        capacity = max(n + self.headroom, min_capacity)
        self.delta = DeltaGraph(nbr, mask, n, capacity, extra_deg=self.extra_deg,
                                device=self.device)
        self.delta.tomb[:n] = ~alive

        self.h_feat = np.zeros((capacity, feat.shape[1]), np.float32)
        self.h_feat[:n] = feat * alive[:, None]
        self.node_text = None if text is None else [t if a else "" for t, a in zip(text, alive)]
        self._emb_dev = upload(self.h_feat, self.device)
        self._rebuild_index(centroids=centroids)
        self._active = True

    def _alive_cap(self) -> np.ndarray:
        a = np.zeros(self.delta.capacity, bool)
        a[: self.delta.n_nodes] = ~self.delta.tomb[: self.delta.n_nodes]
        return a

    def _rebuild_index(self, *, centroids=None) -> None:
        embn = indexing.l2_normalize(self._emb_dev)
        alive_cap = self._alive_cap()
        valid = upload(alive_cap, self.device)
        if self.index_kind == "brute":
            self._index = indexing.MutableBruteIndex(emb=embn * valid[:, None], valid=valid)
            return
        if centroids is None:
            src = self._index if self._index is not None else self._pristine_index
            centroids = src.centroids  # the frozen quantizer
        centroids = torch.as_tensor(centroids, dtype=torch.float32, device=self.device)
        ids = np.flatnonzero(alive_cap).astype(np.int32)
        at = torch.from_numpy(ids.astype(np.int64)).to(self.device)
        assign = indexing.assign_to_centroids(embn[at], centroids).cpu().numpy()
        lists, counts = indexing.build_inverted_lists_slack(
            assign, ids, self.delta.capacity, int(centroids.shape[0]), self.ivf_slack)
        nprobe = self.index_kw.get("nprobe", getattr(self._pristine_index, "nprobe", 4))
        self._index = indexing.MutableIVFIndex(
            emb=embn * valid[:, None], centroids=centroids, h_lists=lists, h_counts=counts,
            valid=valid, nprobe=nprobe, slack=self.ivf_slack)

    def _activate(self) -> None:
        csr = self._pristine_csr
        n = csr.num_nodes
        src, dst = csr.edge_list()
        text = list(self.node_text) if self.node_text is not None else None
        self._build_active(n, np.ones(n, bool), src.astype(np.int64), dst.astype(np.int64),
                           self._h_feat0.copy(), text)

    # ---- the write path -------------------------------------------------
    def apply(self, batch: MutationBatch) -> MutationReport:
        """Apply one mutation batch; bumps the epoch, re-points pipelines.

        Call it between engine steps (never concurrently with a dispatch);
        snapshots already handed out stay readable.  Slack or capacity
        overflow triggers an inline compaction and the apply proceeds:
        mutations never fail for layout reasons.
        """
        if not self._active:
            self._activate()
        report_compactions = self.compactions
        touched: set = set()
        added: list = []

        n_add = batch.n_added_nodes
        if self.delta.n_nodes + n_add > self.delta.capacity:
            self._compact(min_capacity=self.delta.n_nodes + n_add + self.headroom)
        if n_add:
            feats = np.asarray(batch.add_node_feat, np.float32)
            texts = batch.add_node_text or [""] * n_add
            for i in range(n_add):
                u = self.delta.add_node()
                self.h_feat[u] = feats[i]
                if self.node_text is not None:
                    self.node_text.append(texts[i])
                added.append(u)
                touched.add(u)
        # Any compaction from here on rebuilds the index over all alive ids,
        # the just-added nodes included: _refresh_device must then skip the
        # incremental add or the IVF lists hold them twice.
        compactions_after_adds = self.compactions

        edges_added = edges_deleted = 0
        for u, v in batch.add_edges:
            for a, b in ((u, v), (v, u)) if batch.symmetric else ((u, v),):
                try:
                    done = self.delta.add_edge(int(a), int(b))
                except (SlackOverflow, CapacityOverflow):
                    self._compact()
                    done = self.delta.add_edge(int(a), int(b))
                if done:
                    edges_added += 1
                    touched.update((int(a), int(b)))
        for u, v in batch.del_edges:
            for a, b in ((u, v), (v, u)) if batch.symmetric else ((u, v),):
                if self.delta.del_edge(int(a), int(b)):
                    edges_deleted += 1
                    touched.update((int(a), int(b)))
        deleted = []
        for u in batch.del_nodes:
            u = int(u)
            touched.add(u)
            touched.update(int(v) for v in self.delta.neighbors_live(u))
            self.delta.del_node(u)
            self.h_feat[u] = 0.0
            if self.node_text is not None:
                self.node_text[u] = ""
            deleted.append(u)

        self.epoch += 1
        self.batches_applied += 1
        self.mutations_since_compact += 1
        already_indexed = self.compactions != compactions_after_adds
        self._refresh_device([] if already_indexed else added, added + deleted)
        self._sync_pipelines()
        return MutationReport(
            epoch=self.epoch, touched=np.array(sorted(touched), dtype=np.int64),
            added_nodes=tuple(added), compactions=self.compactions - report_compactions,
            edges_added=edges_added, edges_deleted=edges_deleted,
            nodes_deleted=len(batch.del_nodes))

    def _refresh_device(self, added_ids: list, changed_rows: list) -> None:
        """New device embeddings and index after an apply.  The reference
        re-uploads the whole host embedding table; here the resident table
        is copied on the device and only ``changed_rows`` (the batch's added
        and deleted nodes) are uploaded into the copy, the same values.
        The copy is fresh: a snapshot handed out earlier is never written."""
        emb = self._emb_dev.clone()
        if changed_rows:
            rows = np.asarray(changed_rows, np.int64)
            emb[upload(rows, self.device)] = upload(self.h_feat[rows], self.device)
        self._emb_dev = emb
        embn = indexing.l2_normalize(emb)
        valid = upload(self._alive_cap(), self.device)
        if self.index_kind == "brute":
            self._index = indexing.MutableBruteIndex(emb=embn * valid[:, None], valid=valid)
            return
        idx = self._index
        idx.emb = embn * valid[:, None]
        idx.valid = valid
        idx._dev = None
        if added_ids:
            try:
                idx.add(np.asarray(added_ids, np.int32))
            except SlackOverflow:
                self._compact()

    # ---- compaction -----------------------------------------------------
    def compact(self) -> None:
        """Fold the delta into a fresh canonical base (see the module doc)."""
        if not self._active:
            return
        self._compact()
        self._sync_pipelines()

    def _compact(self, min_capacity: int = 0) -> None:
        n = self.delta.n_nodes
        alive = ~self.delta.tomb[:n]
        src, dst = self.delta.live_edge_list()
        text = list(self.node_text) if self.node_text is not None else None
        centroids = self._index.centroids if self.index_kind == "ivf" else None
        self._build_active(n, alive, src, dst, self.h_feat[:n].copy(), text,
                           centroids=centroids, min_capacity=min_capacity)
        self.compactions += 1
        self.mutations_since_compact = 0

    # ---- introspection --------------------------------------------------
    def stats(self) -> dict:
        return {
            "epoch": self.epoch,
            "active": self._active,
            "n_nodes": self.n_nodes,
            "capacity": self.capacity,
            "alive_nodes": int(self.alive.sum()),
            "batches_applied": self.batches_applied,
            "compactions": self.compactions,
            "mutations_since_compact": self.mutations_since_compact,
        }
