"""Fused retrieval-to-generation serving: the RGL "unified system" front-end.

``RAGServeEngine`` takes a raw ``(query_emb, query_text)`` request through

    index -> seed retrieval -> subgraph construction -> dynamic filter
          -> tokenization -> batched prefill -> continuous-batching decode

inside one engine.  Three amortization mechanisms drive throughput:

* **Batched admission retrieval** — every admission wave runs ONE
  ``RGLPipeline.retrieve_many`` call over its cache misses (padded to a
  fixed shape).
* **Retrieval caching** — a policy-driven
  :class:`~repro_torch.serving.cache.RetrievalCache` keyed on quantized
  query embeddings lets repeated queries skip retrieval.
* **Async admission prefetch** (``prefetch=True`` or ``RGL_PREFETCH=1``) —
  wave *i+1*'s retrieval is *launched* on a side CUDA stream while wave
  *i*'s decode steps run on the current one, and *collected* only once
  decode slots free up (:class:`~repro_torch.serving.prefetch.AdmissionPrefetcher`).
  The sync schedule runs the same launch/collect code back to back, so the
  two schedules give identical outputs.

Two admission granularities sit on either schedule (``admission=`` /
``RGL_ADMISSION``): **wave** admission retrieves and admits whole waves;
**continuous** admission launches one retrieval per request and, under
prefetch, collects whichever request's retrieval is ready
(``AdmissionPrefetcher.ready_index``).  Generation rides the slot-based
:class:`~repro_torch.serving.engine.ServeEngine` over a contiguous or paged
KV arena, in one-token or self-speculative decode; with ``prefix_share`` a
cache entry pins its prefilled prompt's blocks and a later identical prompt
aliases them.  Over a pipeline built on a
:class:`~repro_torch.core.mutation.MutableGraphStore`,
:meth:`RAGServeEngine.apply_mutations` changes the corpus between steps and
invalidates the cache entries whose region it touched.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.pipeline import RGLPipeline
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.serving.cache import RetrievalCache
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.prefetch import AdmissionPrefetcher, device_error
from repro_torch.serving.stats import flatten_stats
from repro_torch.tracing import span, uids

# the times to first token kept, newest last: those of the last TTFT_KEEP
# requests served
TTFT_KEEP = 1 << 16


@dataclasses.dataclass
class RAGRequest:
    """A raw serving request: query embedding + query text, no tokens yet.

    Terminal states (exactly one holds when the engine hands the request
    back): ``done`` (served, possibly ``stale`` or ``degraded``),
    ``failed`` (retrieval faults exhausted the degradation ladder, or the
    engine was aborted; ``error`` says why), or ``shed`` (refused by
    overload control or expired past its deadline before admission).
    """

    uid: int
    query_emb: np.ndarray  # (D,) float32
    query_text: str
    max_new_tokens: int = 32
    # seconds of deadline budget from submit; None falls back to the
    # engine's default_deadline_s (None = no deadline)
    deadline_s: Optional[float] = None
    out_tokens: list = dataclasses.field(default_factory=list)
    prompt_ids: Optional[np.ndarray] = None  # filled at admission
    retrieved_nodes: Optional[np.ndarray] = None  # filtered subgraph members
    cache_hit: bool = False
    done: bool = False
    # retired early by KV exhaustion: out_tokens is shorter than
    # max_new_tokens with no EOS
    truncated: bool = False
    stale: bool = False  # served from a TTL-expired cache entry
    degraded: bool = False  # served retrieval-free (query-only prompt)
    failed: bool = False
    shed: bool = False
    error: Optional[str] = None  # reason for failed / shed
    deadline_at: Optional[float] = None  # absolute deadline, set at submit
    # the engine's clock (``now_fn``) at submit, at the hand-off to a
    # retrieval wave, at prefill start, when the first token reached the
    # host, and when the request came back done
    t_submit: Optional[float] = None
    t_dispatched: Optional[float] = None
    t_admitted: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None


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
    ``cache_policy``), so engines handed one instance share its entries,
    counters and in-flight registry (single flight across replicas).

    **Fault tolerance.**  Retrieval faults are data-plane events:
    ``step()`` never raises for one.  A failed miss-group (dispatch raise,
    force raise, timeout after ``retrieval_timeout_s``, or a corrupt
    result) is retried alone up to ``max_retries`` times
    (``retry_backoff_s`` exponential backoff); then the request walks the
    degradation ladder: **stale** (a resident, possibly TTL-expired cache
    entry; ``stale_served``), **degraded** (a query-only prompt;
    ``degraded``, off with ``degraded_mode=False``), **failed** (that
    request alone).  A CUDA error is not a data-plane fault and raises.

    **Overload control.**  ``max_pending`` bounds the pending queue (0 =
    unbounded); on overflow ``shed_policy`` refuses the newcomer
    (``"reject"``) or sheds the oldest pending request
    (``"evict-oldest"``).  Deadlines (``deadline_s``, or
    ``default_deadline_s``) are checked at every launch / collect / admit
    boundary; an expired request is shed, never dispatched.  Shed requests
    come back through ``step()`` like finished ones.

    ``now_fn`` / ``sleep_fn`` drive deadlines, timeouts, retry backoff and
    readiness polling (a virtual clock in tests).  ``abort()`` fails all
    outstanding work and reconciles every layer; ``drain()`` is
    ``run_to_completion`` that aborts stragglers instead of raising;
    :meth:`health` is the snapshot a :class:`~repro_torch.serving.router.ReplicaRouter`
    scores.
    """

    def __init__(self, pipeline: RGLPipeline, params, cfg: TransformerConfig, *,
                 config: Optional[ServingConfig] = None,
                 retrieval_cache: Optional[RetrievalCache] = None, device="cuda",
                 now_fn=time.monotonic, sleep_fn=time.sleep, **overrides):
        if pipeline.tokenizer is None or pipeline.node_text is None:
            raise ValueError("the pipeline needs a tokenizer and node_text")
        self.device = resolve_device(device)
        self.config = resolved = ServingConfig.resolve(config, **overrides)
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
            prefix_share=resolved.prefix_share, device=self.device, now_fn=now_fn,
        )
        self.cache = retrieval_cache if retrieval_cache is not None else RetrievalCache(
            capacity=resolved.cache_capacity, quant_eps=resolved.quant_eps,
            policy=resolved.cache_policy, ttl=resolved.cache_ttl,
            region_bucket=resolved.region_bucket, mutation_flush=resolved.mutation_flush)
        if self.engine.prefix_share:
            # pins attach only to entries still resident, and pool pressure
            # releases this engine's pins before it truncates a live request
            self.engine.kv_pin_gate = self.cache.is_resident
            self.engine.kv_pin_reclaim = lambda n: self.cache.reclaim_kv(n, owner=self.engine)
        self.prefetch = resolved.prefetch
        self.admission = resolved.admission
        depth = resolved.prefetch_depth
        if depth is None:
            # continuous admission launches single-request waves, so the
            # window holds one a slot; wave admission double-buffers
            depth = resolved.slots if self.admission == "continuous" else 1
        self.degraded_mode = resolved.degraded_mode
        self.max_pending = resolved.max_pending  # 0 = unbounded
        self.shed_policy = resolved.shed_policy
        self.default_deadline_s = resolved.default_deadline_s
        self.compact_every = resolved.compact_every  # 0 = manual compaction only
        self._now = now_fn
        # continuous admission pads retrieval to 1 row instead of `slots`
        # (rows are independent: same results); the prefetcher shares the
        # engine's clock pair
        self.prefetcher = AdmissionPrefetcher(
            pipeline, self.cache, wave_size=self._launch_unit, depth=depth,
            retrieval_timeout_s=resolved.retrieval_timeout_s,
            max_retries=resolved.max_retries, retry_backoff_s=resolved.retry_backoff_s,
            now_fn=now_fn, sleep_fn=sleep_fn)
        self.pending: deque = deque()
        self._inflight: dict = {}  # admission ticket -> RAGRequest
        self._next_ticket = 0
        self._step_no = 0
        # requests that went terminal outside decode (shed / failed); step()
        # hands them back exactly once
        self._terminal: list = []
        # every submitted request lands in exactly one of done, failed, shed
        # (stale and degraded refine done)
        self.shed_count = 0
        self.failed_count = 0
        self.degraded_count = 0
        self.stale_served = 0
        self.mutation_batches = 0  # apply_mutations calls
        self.mutation_invalidated = 0  # cache entries they dropped
        # requests served (done), on now_fn's clock: queue_seconds sums
        # t_admitted - t_submit, latency_seconds t_done - t_submit, and
        # ttft_s keeps each one's t_first_token - t_submit
        self.finished_count = 0
        self.queue_seconds = 0.0
        self.latency_seconds = 0.0
        self.ttft_s: deque = deque(maxlen=TTFT_KEEP)

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

    # -- terminal bookkeeping -------------------------------------------------
    def _shed(self, req: RAGRequest, reason: str) -> None:
        req.shed = True
        req.error = reason
        self.shed_count += 1
        self._terminal.append(req)

    def _fail(self, req: RAGRequest, reason: str) -> None:
        req.failed = True
        req.error = reason
        self.failed_count += 1
        self._terminal.append(req)

    def _expired(self, req: RAGRequest) -> bool:
        return req.deadline_at is not None and self._now() > req.deadline_at

    # -- admission ------------------------------------------------------------
    def _validate(self, req: RAGRequest) -> None:
        """Reject malformed requests before any queue or dispatch sees them."""
        q = np.asarray(req.query_emb, np.float32)
        if q.ndim != 1:
            raise ValueError(f"request {req.uid}: query_emb must be 1-D, got shape {tuple(q.shape)}")
        node_emb = getattr(self.pipeline, "node_emb", None)
        if node_emb is not None and q.shape[0] != node_emb.shape[1]:
            raise ValueError(
                f"request {req.uid}: query_emb dim {q.shape[0]} != node "
                f"embedding dim {node_emb.shape[1]}"
            )
        if not np.isfinite(q).all():
            raise ValueError(f"request {req.uid}: query_emb contains NaN/Inf")
        if not str(req.query_text).strip():
            raise ValueError(f"request {req.uid}: empty query_text")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.uid}: max_new_tokens must be >= 1, got {req.max_new_tokens}")
        if req.deadline_s is not None and req.deadline_s <= 0:
            raise ValueError(f"request {req.uid}: deadline_s must be > 0, got {req.deadline_s}")

    def submit(self, req: RAGRequest) -> bool:
        """Validate and enqueue.  Returns False if overload control shed the
        request on arrival (``shed_policy="reject"`` with a full queue; the
        next ``step()`` hands it back).  Malformed requests raise."""
        self._validate(req)
        if req.deadline_at is None:
            # a request arriving with deadline_at pinned (a router failover
            # re-dispatch) keeps it: re-submitting never restarts the budget
            deadline = req.deadline_s if req.deadline_s is not None else self.default_deadline_s
            if deadline is not None:
                req.deadline_at = self._now() + float(deadline)
        if req.t_submit is None:  # a failover re-dispatch keeps its first submit
            req.t_submit = self._now()
        if self.max_pending and len(self.pending) >= self.max_pending:
            if self.shed_policy == "reject":
                self._shed(req, "queue full (shed_policy=reject)")
                return False
            self._shed(self.pending.popleft(), "queue full (shed_policy=evict-oldest)")
        self.pending.append(req)
        return True

    def _take_wave(self, limit: Optional[int] = None) -> list:
        cap = self.slots if limit is None else limit
        out: list = []
        now = self._now()
        while self.pending and len(out) < cap:
            r = self.pending.popleft()
            if self._expired(r):
                # deadline boundary 1: never dispatch retrieval for it
                self._shed(r, "deadline expired before retrieval dispatch")
                continue
            r.t_dispatched = now
            out.append(r)
        return out

    @property
    def _launch_unit(self) -> int:
        """Requests per retrieval launch: a wave, or one under continuous
        admission."""
        return 1 if self.admission == "continuous" else self.slots

    def _tokenize_and_admit(self, resolved: list) -> None:
        """Stage 4+5 handoff: linearize each ``(request, entry, error)``
        triple and hand the prompt to the decode engine under a fresh
        admission ticket.  This is where the degradation ladder runs, one
        request at a time, and where an expired request is shed (deadline
        boundary 3)."""
        with span("rgl.serve.tokenize", args=uids([r for r, _, _ in resolved])):
            self._tokenize_and_admit_inner(resolved)

    def _tokenize_and_admit_inner(self, resolved: list) -> None:
        tok = self.pipeline.tokenizer
        node_text = self.pipeline.node_text
        for r, e, err in resolved:
            if self._expired(r):
                self._shed(r, "deadline expired before admission")
                continue
            if e is None:
                stale = self.cache.peek_stale(r.query_emb)
                if stale is not None:  # rung 1: the resident (maybe expired) entry
                    e = stale
                    r.stale = True
                    self.stale_served += 1
                elif self.degraded_mode:  # rung 2: query-only prompt
                    r.degraded = True
                    self.degraded_count += 1
                else:  # rung 3: fail this request alone
                    self._fail(r, err or "retrieval failed")
                    continue
            ticket = None
            try:
                if e is not None:
                    texts = [node_text[int(v)] for v, m in zip(e.nodes, e.mask) if m]
                    r.retrieved_nodes = e.nodes[e.mask].copy()
                else:
                    texts = []
                    r.retrieved_nodes = np.empty(0, np.int32)
                ids, mask = tok.linearize(r.query_text, texts)
                r.prompt_ids = ids[mask]
                inner = Request(uid=r.uid, prompt_ids=r.prompt_ids,
                                max_new_tokens=r.max_new_tokens, ticket=self._next_ticket)
                if self.engine.prefix_share and e is not None:
                    # donor side: a fresh admission pins its prompt blocks to
                    # the entry; consumer side when the entry already pins
                    # this pool's blocks (admission re-validates the prompt)
                    inner.pin_to = e
                    if e.kv_blocks is not None and e.kv_owner is self.engine:
                        inner.shared_prefix = e
                ticket = inner.ticket
                self._inflight[ticket] = r
                self._next_ticket += 1
                self.engine.submit(inner)
            except Exception as exc:
                # a bad entry fails its own request, not the engine
                if device_error(exc):
                    raise
                if ticket is not None:
                    self._inflight.pop(ticket, None)
                self._fail(r, f"admission: {exc}")

    def _admit_sync(self) -> None:
        """Sync schedule: launch one wave and collect it at once; continuous
        admission does so one request per free slot."""
        if self.admission == "continuous":
            while self.engine.free_slots > 0 and self.pending:
                reqs = self._take_wave(1)
                if not reqs:  # everything left was past its deadline
                    continue
                tok = self.engine.emitted_tokens
                self.prefetcher.launch(reqs, step=self._step_no, tokens=tok)
                self._tokenize_and_admit(self.prefetcher.collect(
                    step=self._step_no, tokens=tok, sync=True))
            return
        reqs = self._take_wave()
        if not reqs:
            return
        tok = self.engine.emitted_tokens
        self.prefetcher.launch(reqs, step=self._step_no, tokens=tok)
        self._tokenize_and_admit(self.prefetcher.collect(step=self._step_no, tokens=tok, sync=True))

    def _launch_pending(self) -> None:
        while self.pending and self.prefetcher.can_launch():
            reqs = self._take_wave(self._launch_unit)
            if not reqs:  # everything left was past its deadline
                continue
            self.prefetcher.launch(reqs, step=self._step_no, tokens=self.engine.emitted_tokens)

    def _admit_prefetch(self) -> None:
        """Prefetch schedule: collect waves as decode slots free up and
        launch the next wave(s) so their retrieval overlaps this step's
        decode.  The launch sits between a wave's collect (whose puts the
        next lookup sees) and its tokenize/admit, so the admission work runs
        inside the next wave's overlap window too."""
        while self.prefetcher.launched_before(self._step_no) and self.engine.free_slots > 0:
            # never collect a wave in the step it launched (that forfeits
            # its overlap), except on the idle arena below
            resolved = self.prefetcher.collect(step=self._step_no,
                                               tokens=self.engine.emitted_tokens)
            self._launch_pending()
            self._tokenize_and_admit(resolved)
        self._launch_pending()
        if not self.engine.live.any() and not self.engine.queue and self.prefetcher.in_flight:
            # idle arena: nothing to overlap with, don't stall a step
            self._tokenize_and_admit(self.prefetcher.collect(
                step=self._step_no, tokens=self.engine.emitted_tokens))

    def _admit_continuous(self) -> None:
        """Continuous + prefetch: per-request launches, out-of-FIFO collect.
        Each free slot collects whichever in-flight single-request wave is
        ready (``ready_index`` / ``collect_at``), so one slow retrieval row
        delays only its own request."""
        self._launch_pending()
        while self.engine.free_slots > 0 and self.prefetcher.in_flight:
            idx = self.prefetcher.ready_index()
            if idx is None:
                break
            resolved = self.prefetcher.collect_at(idx, step=self._step_no,
                                                  tokens=self.engine.emitted_tokens)
            self._launch_pending()
            self._tokenize_and_admit(resolved)
        if not self.engine.live.any() and not self.engine.queue and self.prefetcher.in_flight:
            # idle arena with nothing ready: block on the oldest wave (oldest
            # first keeps deferred owners resolving before their dependents)
            self._tokenize_and_admit(self.prefetcher.collect(
                step=self._step_no, tokens=self.engine.emitted_tokens))
            self._launch_pending()

    # -- stepping -------------------------------------------------------------
    def step(self) -> list:
        """One engine step: admission (sync or prefetched, wave or
        continuous) + one decode step.  Returns the requests that finished
        or went terminal this step."""
        with span("rgl.serve.step"):
            if not self.prefetch:
                self._admit_sync()
            elif self.admission == "continuous":
                self._admit_continuous()
            else:
                self._admit_prefetch()
            finished_inner = self.engine.step()
        self._step_no += 1
        out = []
        now = self._now()
        for inner in finished_inner:
            r = self._inflight.pop(inner.ticket)
            r.out_tokens = inner.out_tokens
            r.truncated = inner.truncated
            r.done = True
            r.t_admitted, r.t_first_token, r.t_done = inner.t_admitted, inner.t_first_token, now
            self._count_finished(r)
            out.append(r)
        if self._terminal:
            out.extend(self._terminal)
            self._terminal.clear()
        return out

    def _count_finished(self, r: RAGRequest) -> None:
        self.finished_count += 1
        self.queue_seconds += r.t_admitted - r.t_submit
        self.latency_seconds += r.t_done - r.t_submit
        self.ttft_s.append(r.t_first_token - r.t_submit)

    def _drained(self) -> bool:
        return (not self.pending and not self.prefetcher.in_flight
                and not self.engine.queue and not self.engine.live.any()
                and not self._terminal)

    def run_to_completion(self, max_steps: int = 10_000) -> list:
        done = []
        for _ in range(max_steps):
            done.extend(self.step())
            if self._drained():
                return done
        raise RuntimeError(
            f"run_to_completion: work still pending after {max_steps} steps "
            f"({len(self.pending)} pending, {self.prefetcher.in_flight} in-flight waves, "
            f"{len(self.engine.queue)} queued, {int(self.engine.live.sum())} live slots)"
        )

    def abort(self, reason: str = "aborted") -> list:
        """Terminate every outstanding request and reconcile every layer:
        pending requests are shed, in-flight waves dropped (their cache keys
        released), live slots retired (paged blocks returned) and stranded
        tickets cleared.  The engine is reusable.  Returns every request
        that went terminal, each exactly once."""
        while self.pending:
            self._shed(self.pending.popleft(), f"shed: {reason}")
        for r in self.prefetcher.abort():
            self._fail(r, f"aborted before admission: {reason}")
        for inner in self.engine.abort(reason=reason):
            r = self._inflight.pop(inner.ticket, None)
            if r is None:
                continue
            r.out_tokens = inner.out_tokens
            r.truncated = inner.truncated
            self._fail(r, inner.error or reason)
        for ticket in list(self._inflight):  # reconciled defensively
            self._fail(self._inflight.pop(ticket), f"stranded: {reason}")
        out = list(self._terminal)
        self._terminal.clear()
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

    # -- online mutation ------------------------------------------------------
    def apply_mutations(self, batch):
        """Apply a :class:`repro_torch.core.mutation.MutationBatch` to the
        live graph and index between engine steps, then drop every cache
        entry whose region the batch touched (releasing its KV pins);
        compact every ``compact_every`` batches.  Returns the store's
        ``MutationReport``.

        Safe to interleave with :meth:`step`: the store builds *new* device
        tensors and re-points the pipeline, a wave already dispatched keeps
        (through the prefetcher) the tensors of its launch-time snapshot and
        completes against them, and the cache's epoch put-gate refuses its
        superseded results.  Nothing here waits on the device.  Call it
        between steps, not from another thread.
        """
        store = getattr(self.pipeline, "mutation_store", None)
        if store is None:
            raise RuntimeError("apply_mutations needs a pipeline built on a "
                               "MutableGraphStore (see repro_torch.core.mutation)")
        report = store.apply(batch)
        self.mutation_batches += 1
        self.mutation_invalidated += self.cache.invalidate_regions(report.touched, report.epoch)
        if self.compact_every and store.mutations_since_compact >= self.compact_every:
            store.compact()
        return report

    def health(self) -> dict:
        """Health and load snapshot for a fronting router: the fault
        counters are cumulative (the router scores their deltas), the load
        signals instantaneous."""
        p = self.prefetcher
        return {
            "retries": p.retries,
            "timeouts": p.timeouts,
            "retrieval_failures": p.failures,
            "failed": self.failed_count,
            "degraded": self.degraded_count,
            "stale_served": self.stale_served,
            "shed": self.shed_count,
            "pending": len(self.pending),
            "inflight_waves": p.in_flight,
            "inflight_requests": p.in_flight_requests,
            "admitted": len(self._inflight),
            "live_slots": int(self.engine.live.sum()),
            "free_slots": self.engine.free_slots,
            "queued": len(self.engine.queue),
        }

    def stats_ns(self) -> dict:
        """Namespaced stats, one sub-dict per serving layer (``cache``,
        ``engine``, ``prefetch``, ``decode``, ``mutation``, ``retrieval``:
        the pipeline's counters, ``requests``: the served requests' times).
        Every value is a copy: a snapshot does not move."""
        ns = {
            "cache": self.cache.stats(),
            "engine": {
                "retrieval_batches": self.retrieval_batches,
                "retrieved_queries": self.retrieved_queries,
                "retrieval_seconds": self.retrieval_seconds,
                "prefetch": self.prefetch,
                "admission": self.admission,
                "shed": self.shed_count,
                "failed": self.failed_count,
                "degraded": self.degraded_count,
                "stale_served": self.stale_served,
                "degraded_mode": self.degraded_mode,
            },
            "prefetch": self.prefetcher.stats(),
            "decode": self.engine.decode_stats(),
        }
        store = getattr(self.pipeline, "mutation_store", None)
        mut = dict(store.stats()) if store is not None else {}
        mut["batches"] = self.mutation_batches
        mut["invalidated"] = self.mutation_invalidated
        ns["mutation"] = mut
        counters = getattr(self.pipeline, "stats", None)  # a duck-typed pipeline may have none
        ns["retrieval"] = counters() if counters is not None else {}
        ns["requests"] = {
            "finished": self.finished_count,
            "queue_seconds": self.queue_seconds,
            "latency_seconds": self.latency_seconds,
            "ttft_s": list(self.ttft_s),
        }
        return ns

    def stats(self) -> dict:
        return flatten_stats(self.stats_ns())
