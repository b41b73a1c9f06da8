"""Fused retrieval-to-generation serving: the RGL "unified system" front-end.

``RAGServeEngine`` takes a raw ``(query_emb, query_text)`` request through

    index -> seed retrieval -> subgraph construction -> dynamic filter
          -> tokenization -> batched prefill -> continuous-batching decode

inside one engine.  Every admission wave runs ONE batched
``RGLPipeline.retrieve_many`` call over its cache misses (padded to a fixed
shape), and a policy-driven :class:`~repro_torch.serving.cache.RetrievalCache`
keyed on quantized query embeddings lets repeated queries skip retrieval.
Generation rides the slot-based :class:`~repro_torch.serving.engine.ServeEngine`
over a contiguous or paged KV arena; with ``prefix_share`` a cache entry
pins its prefilled prompt's blocks and a later identical prompt aliases them.

This port runs the sync schedule, with **wave** admission (one retrieval
launch and collect a wave) or **continuous** admission (one launch and
collect per free slot, single-request waves), and either decode mode of
the slot engine (one-token, or self-speculative with ``spec_decode``).
Several engines may share one retrieval tier: pass the same
``retrieval_cache=`` to each.  Async prefetch, fault tolerance (retries,
timeouts, deadlines, shedding) and online mutation are not ported yet;
asking for them raises.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.pipeline import RGLPipeline
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.serving.cache import RetrievalCache
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.prefetch import AdmissionPrefetcher
from repro_torch.serving.stats import flatten_stats

# ServingConfig fields whose non-default values this port does not serve
# yet, each with its ROADMAP Queue 1 item
_NOT_PORTED = {
    "prefetch": (False, "12 (async prefetch)"),
    "retrieval_timeout_s": (None, "12 (fault tolerance)"),
    "max_retries": (0, "12 (fault tolerance)"),
    "max_pending": (0, "12 (load shedding)"),
    "default_deadline_s": (None, "12 (deadlines)"),
    "replicas": (1, "12 (replica router)"),
    "mutation": (False, "13 (online mutation)"),
    "compact_every": (0, "13 (online mutation)"),
}


@dataclasses.dataclass
class RAGRequest:
    """A raw serving request: query embedding + query text, no tokens yet."""

    uid: int
    query_emb: np.ndarray  # (D,) float32
    query_text: str
    max_new_tokens: int = 32
    out_tokens: list = dataclasses.field(default_factory=list)
    prompt_ids: Optional[np.ndarray] = None  # filled at admission
    retrieved_nodes: Optional[np.ndarray] = None  # filtered subgraph members
    cache_hit: bool = False
    done: bool = False
    # retired early by KV exhaustion: out_tokens is shorter than
    # max_new_tokens with no EOS
    truncated: bool = False
    failed: bool = False  # the engine was aborted; ``error`` says why
    error: Optional[str] = None


class RAGServeEngine:
    """End-to-end RAG server: retrieval-batched admission over a decode arena.

    Usage::

        eng = RAGServeEngine(pipe, params, cfg, slots=8, cache_len=256)
        eng.submit(RAGRequest(uid=0, query_emb=emb, query_text="..."))
        finished = eng.run_to_completion()   # .out_tokens per request

    ``pipe`` must carry a tokenizer and node_text.  Serving knobs resolve
    through :class:`ServingConfig` (explicit kwarg > ``RGL_*`` env >
    default), as in the reference.  ``retrieval_cache`` is used as given
    (never re-created from ``cache_capacity`` / ``quant_eps`` /
    ``cache_policy``), so engines handed one instance share its entries
    and counters.
    """

    def __init__(self, pipeline: RGLPipeline, params, cfg: TransformerConfig, *,
                 config: Optional[ServingConfig] = None,
                 retrieval_cache: Optional[RetrievalCache] = None, device="cuda",
                 **overrides):
        if pipeline.tokenizer is None or pipeline.node_text is None:
            raise ValueError("the pipeline needs a tokenizer and node_text")
        self.device = resolve_device(device)
        self.config = resolved = ServingConfig.resolve(config, **overrides)
        for field, (default, item) in _NOT_PORTED.items():
            if getattr(resolved, field) != default:
                raise NotImplementedError(
                    f"{field}={getattr(resolved, field)!r} is not ported yet: "
                    f"ROADMAP Queue 1 item {item}"
                )
        if pipeline.tokenizer.max_len >= resolved.cache_len:
            raise ValueError(
                f"tokenizer.max_len={pipeline.tokenizer.max_len} must be < "
                f"cache_len={resolved.cache_len} so every prompt fits the KV arena"
            )
        self.pipeline = pipeline
        self.slots = resolved.slots
        self.engine = ServeEngine(
            params, cfg, slots=resolved.slots, cache_len=resolved.cache_len,
            eos_id=resolved.eos_id, spec_decode=resolved.spec_decode,
            draft_window=resolved.draft_window, paged_kv=resolved.paged_kv,
            block_size=resolved.kv_block_size, pool_blocks=resolved.kv_pool_blocks,
            prefix_share=resolved.prefix_share, device=self.device,
        )
        self.cache = retrieval_cache if retrieval_cache is not None else RetrievalCache(
            capacity=resolved.cache_capacity, quant_eps=resolved.quant_eps,
            policy=resolved.cache_policy, ttl=resolved.cache_ttl)
        if self.engine.prefix_share:
            # pins attach only to entries still resident, and pool pressure
            # releases this engine's pins before it truncates a live request
            self.engine.kv_pin_gate = self.cache.is_resident
            self.engine.kv_pin_reclaim = lambda n: self.cache.reclaim_kv(n, owner=self.engine)
        self.admission = resolved.admission
        # continuous admission launches single-request waves, so retrieval
        # pads to 1 row instead of `slots` (rows are independent: same results)
        self.prefetcher = AdmissionPrefetcher(
            pipeline, self.cache,
            wave_size=1 if self.admission == "continuous" else resolved.slots)
        self.pending: deque = deque()
        self._inflight: dict = {}  # admission ticket -> RAGRequest
        self._next_ticket = 0

    # -- counters -------------------------------------------------------------
    @property
    def cache_hits(self) -> int:
        return self.cache.hits

    @property
    def cache_misses(self) -> int:
        return self.cache.misses

    @property
    def retrieval_batches(self) -> int:
        return self.prefetcher.batches

    @property
    def retrieved_queries(self) -> int:
        return self.prefetcher.queries

    @property
    def retrieval_seconds(self) -> float:
        p = self.prefetcher
        return p.launch_seconds + p.block_seconds

    # -- admission ------------------------------------------------------------
    def _validate(self, req: RAGRequest) -> None:
        """Reject malformed requests before any queue or dispatch sees them."""
        q = np.asarray(req.query_emb, np.float32)
        if q.ndim != 1:
            raise ValueError(f"request {req.uid}: query_emb must be 1-D, got shape {tuple(q.shape)}")
        if q.shape[0] != self.pipeline.node_emb.shape[1]:
            raise ValueError(
                f"request {req.uid}: query_emb dim {q.shape[0]} != node "
                f"embedding dim {self.pipeline.node_emb.shape[1]}"
            )
        if not np.isfinite(q).all():
            raise ValueError(f"request {req.uid}: query_emb contains NaN/Inf")
        if not str(req.query_text).strip():
            raise ValueError(f"request {req.uid}: empty query_text")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.uid}: max_new_tokens must be >= 1, got {req.max_new_tokens}")

    def submit(self, req: RAGRequest) -> bool:
        """Validate and enqueue; malformed requests raise ``ValueError``."""
        self._validate(req)
        self.pending.append(req)
        return True

    def _take_wave(self, limit: Optional[int] = None) -> list:
        cap = self.slots if limit is None else limit
        return [self.pending.popleft() for _ in range(min(cap, len(self.pending)))]

    def _tokenize_and_admit(self, resolved: list) -> None:
        """Stage 4+5 handoff: linearize each resolved request's retrieved
        context and hand the prompt to the decode engine under a fresh
        admission ticket."""
        tok = self.pipeline.tokenizer
        node_text = self.pipeline.node_text
        for r, e, _ in resolved:
            texts = [node_text[int(v)] for v, m in zip(e.nodes, e.mask) if m]
            r.retrieved_nodes = e.nodes[e.mask].copy()
            ids, mask = tok.linearize(r.query_text, texts)
            r.prompt_ids = ids[mask]
            inner = Request(uid=r.uid, prompt_ids=r.prompt_ids,
                            max_new_tokens=r.max_new_tokens, ticket=self._next_ticket)
            if self.engine.prefix_share:
                # donor side: a fresh admission pins its prompt blocks to the
                # entry; consumer side when the entry already pins this pool's
                # blocks (admission re-validates the exact prompt)
                inner.pin_to = e
                if e.kv_blocks is not None and e.kv_owner is self.engine:
                    inner.shared_prefix = e
            self._inflight[inner.ticket] = r
            self._next_ticket += 1
            self.engine.submit(inner)

    def _admit_sync(self) -> None:
        """Launch one wave and collect it immediately; continuous admission
        does so one request per free slot."""
        if self.admission == "continuous":
            while self.engine.free_slots > 0 and self.pending:
                self.prefetcher.launch(self._take_wave(1))
                self._tokenize_and_admit(self.prefetcher.collect())
            return
        reqs = self._take_wave()
        if reqs:
            self.prefetcher.launch(reqs)
            self._tokenize_and_admit(self.prefetcher.collect())

    # -- stepping -------------------------------------------------------------
    def step(self) -> list:
        """One engine step: admission + one decode step.  Returns the
        RAG requests that finished this step."""
        self._admit_sync()
        finished_inner = self.engine.step()
        out = []
        for inner in finished_inner:
            r = self._inflight.pop(inner.ticket)
            r.out_tokens = inner.out_tokens
            r.truncated = inner.truncated
            r.done = True
            out.append(r)
        return out

    def _drained(self) -> bool:
        return (not self.pending and not self.prefetcher.in_flight
                and not self.engine.queue and not self.engine.live.any())

    def run_to_completion(self, max_steps: int = 10_000) -> list:
        done = []
        for _ in range(max_steps):
            done.extend(self.step())
            if self._drained():
                return done
        raise RuntimeError(
            f"run_to_completion: work still pending after {max_steps} steps "
            f"({len(self.pending)} pending, {len(self.engine.queue)} queued, "
            f"{int(self.engine.live.sum())} live slots)"
        )

    def abort(self, reason: str = "aborted") -> list:
        """Fail every outstanding request (pending, queued and live) and
        leave the engine reusable.  Returns them, each exactly once."""
        out = []
        while self.pending:
            r = self.pending.popleft()
            r.failed, r.error = True, f"aborted before admission: {reason}"
            out.append(r)
        for inner in self.engine.abort(reason=reason):
            r = self._inflight.pop(inner.ticket)
            r.out_tokens = inner.out_tokens
            r.failed, r.error = True, inner.error
            out.append(r)
        return out

    def drain(self, max_steps: int = 10_000) -> list:
        """``run_to_completion`` that never raises: stragglers after
        ``max_steps`` are aborted and returned with the completed requests."""
        done = []
        for _ in range(max_steps):
            done.extend(self.step())
            if self._drained():
                return done
        done.extend(self.abort(reason=f"drain gave up after {max_steps} steps"))
        return done

    def stats_ns(self) -> dict:
        """Namespaced stats, one sub-dict per serving layer."""
        return {
            "cache": self.cache.stats(),
            "engine": {
                "retrieval_batches": self.retrieval_batches,
                "retrieved_queries": self.retrieved_queries,
                "retrieval_seconds": self.retrieval_seconds,
                "prefetch": False,
                "admission": self.admission,
            },
            "prefetch": self.prefetcher.stats(),
            "decode": self.engine.decode_stats(),
        }

    def stats(self) -> dict:
        return flatten_stats(self.stats_ns())
