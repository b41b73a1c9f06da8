"""The end-to-end RGL pipeline (paper Fig. 1): index -> node retrieval ->
graph retrieval -> dynamic filtering -> tokenization -> generation.

``RGLPipeline`` is the OOP API; every stage is also a function in its own
module.  A pipeline over a frozen corpus has no mutation store and serves
epoch 0 forever; one attached to a
:class:`~repro_torch.core.mutation.MutableGraphStore` is re-pointed to the
store's current snapshot on every mutation and reports its epoch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import filters, graph_retrieval, node_retrieval, tokenization
from repro_torch.core.graph_retrieval import Subgraph
from repro_torch.core.indexing import build_index
from repro_torch.graph.ell import ELLGraph
from repro_torch.tracing import span

# the pipeline's retrieval counters (``RGLPipeline.stats()``): subgraph
# batches, their query rows (padding included) and the real ones, compact
# passes, ``auto``'s dense re-runs after them, and the queries that
# overflowed the workset (read where ``auto`` checks the overflow)
RETRIEVAL_COUNTERS = ("batches", "rows", "valid_rows", "compact_runs", "dense_reruns",
                      "overflowed_queries")


@dataclasses.dataclass
class PipelineConfig:
    strategy: str = "bfs"  # bfs | dense | steiner | ppr
    k_seeds: int = 4
    max_hops: int = 3
    max_nodes: int = 64
    filter_budget: int = 32  # dynamic node filter budget (<= max_nodes)
    max_prompt_len: int = 512
    node_token_budget: int = 48
    # stage-1 vector index: brute | ivf | sharded | sharded_ivf
    index_kind: str = "brute"
    index_shards: Optional[int] = None  # sharded kinds; None = one per device
    # stage-3 subgraph construction backend: dense | compact | auto
    retrieval_mode: str = "auto"
    workset_cap: int = 2048  # compact backend candidate capacity per query


@dataclasses.dataclass(frozen=True)
class RetrievalResult:
    """Typed result of :meth:`RGLPipeline.retrieve` / ``retrieve_many``.
    ``sub``/``seeds`` are device tensors (the card's work may still be in
    flight); only the first ``n_valid`` rows are meaningful."""

    sub: Subgraph
    seeds: torch.Tensor  # (Q, k_seeds) node ids
    n_valid: int = 1
    epoch: int = 0

    @property
    def nodes(self):
        return self.sub.nodes

    @property
    def mask(self):
        return self.sub.mask

    @property
    def dist(self):
        return self.sub.dist

    @property
    def overflow(self):
        return self.sub.overflow


def index_from_config(emb, config: PipelineConfig, **kw):
    """Build the stage-1 index named by ``config.index_kind`` (the sharded
    kinds with ``config.index_shards`` shards, over ``devices=`` when given:
    ``kw`` goes to ``build_index``)."""
    if config.index_kind in ("sharded", "sharded_ivf"):
        kw.setdefault("n_shards", config.index_shards)
    return build_index(emb, kind=config.index_kind, **kw)


@dataclasses.dataclass
class RGLPipeline:
    graph: ELLGraph
    index: object  # BruteIndex | IVFIndex | ShardedIndex
    node_emb: torch.Tensor  # (N, D) embeddings used for filtering scores
    tokenizer: Optional[tokenization.GraphTokenizer] = None
    generator: Optional[object] = None
    node_text: Optional[list] = None
    config: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)
    device: object = "cuda"  # where the graph, index and embeddings live
    # set by MutableGraphStore.make_pipeline / attach; a frozen-corpus
    # pipeline leaves it None (epoch stays 0 forever)
    mutation_store: Optional[object] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        for name, t in (("graph.nbr", self.graph.nbr), ("node_emb", self.node_emb)):
            if t.device.type != self.device.type:
                raise ValueError(f"{name} lives on {t.device}, the pipeline on {self.device}")
        if self.mutation_store is not None:
            # a store re-points only the pipelines attached to it, so every
            # copy (dataclasses.replace runs this too) attaches itself
            self.mutation_store.attach(self)
        # each copy counts its own retrievals
        self.counters = dict.fromkeys(RETRIEVAL_COUNTERS, 0)

    @property
    def epoch(self) -> int:
        """Monotonic graph mutation epoch this pipeline currently serves."""
        store = self.mutation_store
        return 0 if store is None else int(store.epoch)

    @property
    def n_valid_nodes(self) -> int:
        """Upper bound (exclusive) on the node ids a retrieval may return:
        with a mutation store the tensors are capacity-padded, so the logical
        node count, not the tensor length, bounds the valid ids."""
        store = self.mutation_store
        if store is not None:
            return int(store.n_nodes)
        return int(self.node_emb.shape[0])

    # ---- functional stages --------------------------------------------------
    def retrieve_seeds(self, query_emb, encoder=None):
        return node_retrieval.retrieve_nodes(
            self.index, query_emb, self.config.k_seeds, encoder=encoder
        )

    def retrieve_subgraph(self, seeds) -> Subgraph:
        return graph_retrieval.retrieve_subgraph(
            self.graph,
            seeds,
            self.config.strategy,
            mode=self.config.retrieval_mode,
            workset_cap=self.config.workset_cap,
            max_hops=self.config.max_hops,
            max_nodes=self.config.max_nodes,
            counters=self.counters,
        )

    def filter(self, sub: Subgraph, query_emb, seeds) -> Subgraph:
        scores = filters.similarity_scores(self.node_emb, query_emb)
        return filters.dynamic_filter(sub, scores, seeds, budget=self.config.filter_budget)

    def retrieve(self, query_emb, encoder=None) -> RetrievalResult:
        """Stages 2+3+filter — the sub-pipeline completion tasks use."""
        return self._retrieve(query_emb, encoder, None)

    def _retrieve(self, query_emb, encoder, n_valid: Optional[int]) -> RetrievalResult:
        """``retrieve`` of a batch whose first ``n_valid`` rows are real
        queries (None: every row)."""
        with span("rgl.retrieve"):
            q = torch.as_tensor(query_emb, dtype=torch.float32)
            if self.device.type == "cuda" and q.device.type == "cpu":
                # from pinned memory the copy is queued on the current stream; a
                # pageable copy would first wait for everything queued there
                # (the admission prefetcher's side stream included)
                q = q.pin_memory().to(self.device, non_blocking=True)
            q = q.to(self.device)
            with span("rgl.retrieve.seeds"):
                _, seeds = self.retrieve_seeds(q, encoder=encoder)
            with span("rgl.retrieve.subgraph"):
                sub = self.retrieve_subgraph(seeds)
            with span("rgl.retrieve.filter"):
                sub = self.filter(sub, q, seeds)
        if n_valid is None:
            n_valid = 1 if q.ndim == 1 else int(q.shape[0])
        self.counters["valid_rows"] += n_valid
        return RetrievalResult(sub=sub, seeds=seeds, n_valid=n_valid, epoch=self.epoch)

    def retrieve_many(self, query_embs, *, batch_size: Optional[int] = None,
                      encoder=None) -> RetrievalResult:
        """Fixed-shape batched retrieval for serving admission: the query
        batch is zero-padded to ``batch_size`` rows; every stage is
        row-independent, so padding rows never perturb real results.  Only
        the first ``n_valid`` rows of the result are meaningful."""
        q = np.asarray(query_embs, np.float32)
        if q.ndim == 1:
            q = q[None]
        n_valid = q.shape[0]
        bs = batch_size or n_valid
        if n_valid > bs:
            raise ValueError(f"{n_valid} queries > batch_size {bs}")
        if n_valid < bs:
            q = np.concatenate([q, np.zeros((bs - n_valid, q.shape[1]), np.float32)], axis=0)
        return self._retrieve(q, encoder, n_valid)

    def stats(self) -> dict:
        """A copy of the retrieval counters (``RETRIEVAL_COUNTERS``)."""
        return dict(self.counters)

    def tokenize(self, query_texts, sub: Subgraph):
        if self.tokenizer is None or self.node_text is None:
            raise ValueError("tokenize needs a pipeline with a tokenizer and node_text")
        texts = tokenization.subgraph_texts(sub, self.node_text)
        return self.tokenizer.batch_linearize(query_texts, texts)

    # ---- OOP API ------------------------------------------------------------
    def run(self, query_emb, query_texts, max_new_tokens: int = 0) -> dict:
        res = self.retrieve(query_emb)
        sub, seeds = res.sub, res.seeds
        ids, mask = self.tokenize(query_texts, sub)
        outputs = None
        if self.generator is not None:
            outputs = self.generator.generate(ids, mask, max_new_tokens)
        return {
            "seeds": seeds.cpu().numpy(),
            "subgraph": sub,
            "prompt_ids": ids,
            "prompt_mask": mask,
            "outputs": outputs,
        }
