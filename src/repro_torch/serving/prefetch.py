"""Double-buffered async admission retrieval for the fused RAG engine.

The sync schedule retrieves at wave boundaries: every admission wave
dispatches one ``retrieve_many`` and immediately forces the result to the
host, so the decode arena idles for the whole retrieval of every wave.
:class:`AdmissionPrefetcher` splits that into two phases so wave *i+1*'s
retrieval overlaps wave *i*'s decode steps:

* **launch** — cache lookup + intra-wave dedupe + ONE
  ``RGLPipeline.retrieve_many`` call, queued on the prefetcher's **side
  CUDA stream**, followed on that stream by non-blocking copies of the
  result into pinned host buffers and one recorded ``torch.cuda.Event``.
  The call returns while the side stream still works, so retrieval runs
  beside whatever the engine queues next on the current stream: the decode
  steps of the previous wave.
* **collect** — wait on the wave's event (the only host sync), insert the
  finished entries into the :class:`~repro_torch.serving.cache.RetrievalCache`
  and hand ``(request, entry, error)`` triples back for tokenization and
  admission.  The engine collects only once decode slots free up.

Readiness is ``event.query()`` and the force is ``event.synchronize()``
followed by reading the host buffers (:class:`_Landed`), so
``_wave_ready`` / ``_wait_ready`` poll one ``is_ready()`` and force with
``np.asarray`` exactly as the reference does over its lazy device arrays.
A CPU pipeline has no stream and its results are ready at once; simulator
results (:mod:`repro_torch.serving.simulate`) keep their own ``is_ready()``
and ``__array__``.

**Stream hazards**, and what the design does about each:

* *Memory across streams.*  Everything the side stream computes is
  allocated under ``torch.cuda.stream(side)``, so the caching allocator
  files it with the side stream and reuses it only in that stream's order;
  the device results are read only there (by the copies) and are held by
  the wave until its event completes, so no ``Tensor.record_stream`` is
  needed.  The pipeline's own tensors (graph, index, embeddings) were made
  on the current stream and live as long as the pipeline; the side stream
  waits on the current stream (``side.wait_stream(cur)``) before it reads
  them.  The kernels launch on the current stream, which is the side stream
  inside the context (``kernels/bfs_frontier/kernel.py``,
  ``frontier_expand/kernel.py``, ``topk_sim/kernel.py``,
  ``ivf_scan/kernel.py``), and the one module-level scratch, ``topk_merge``'s
  zeroed workspace, is keyed by (device, stream).
* *Pinned buffers.*  Each launch allocates fresh pinned buffers; the host
  reads one only after its event completed.  A wave abandoned by a timeout,
  a failure or ``abort`` keeps its buffers, device results and event in
  ``_abandoned`` until ``event.query()`` turns true, so no later launch can
  be handed memory that a copy still in flight will write.
* *No device-wide sync.*  Nothing here calls ``torch.cuda.synchronize()``:
  it would wait on the side stream and erase the overlap.  The engine's
  per-step token syncs are ``.cpu()`` on the current stream and wait for
  that stream only.
* *Host syncs inside retrieval.*  ``retrieval_mode="auto"`` checks the
  compact wave's overflow on the host (``core/graph_retrieval.py``, as the
  reference does), so under ``auto`` the host waits out the compact hops
  inside ``launch``; only the dense re-run and the copies run behind
  decode.  ``"dense"`` has no host sync in ``launch``.  The query batch is
  copied to the card from pinned memory (``RGLPipeline.retrieve``), since a
  pageable copy would sync the side stream.
* *No fallback.*  A CUDA error in a stream, event, copy or kernel raises
  (:func:`device_error`); the fault ladder contains only the reference's
  data-plane faults: a dispatch raise, a force raise, a timeout or an
  out-of-range row.

Between launch and collect every miss key is marked in flight on the cache,
so a later launch never re-dispatches a query that is retrieved but not yet
collected: the request **defers** to the owning wave and resolves,
including its cache-hit accounting, at its own wave's collect.  ``depth``
bounds the launched-but-uncollected waves (1: one wave decoding, one
retrieving).

**Parity scope.**  At ``depth=1`` every launch follows all earlier
collects, so cache state is step for step the sync schedule's.  At
``depth >= 2`` wave *i+1*'s lookups run before wave *i*'s puts; outputs
stay identical and hit/miss totals match except under capacity pressure,
where reordered recency updates may pick other eviction victims (as in the
reference).

Telemetry (merged into ``RAGServeEngine.stats()``): ``waves`` /
``batches`` / ``queries``; ``launch_seconds`` / ``block_seconds`` (host
time in dispatch and in the collect-phase force); ``overlap_seconds`` (per
wave, wall time from launch return to collect start: an upper bound on the
retrieval hidden behind decode); ``overlap_steps`` / ``overlap_tokens``
(engine steps run and tokens committed in that window); ``hidden_frac`` =
overlap / (overlap + block).

**Fault tolerance** (all off by default): a wave not ready
``retrieval_timeout_s`` after dispatch is timed out instead of waited on; a
failed wave — dispatch raise, force raise, timeout, or a row whose node ids
fail validation — relaunches only its failed miss-groups, each as its own
size-1 dispatch, up to ``max_retries`` times with exponential
``retry_backoff_s`` backoff; a group that exhausts its retries fails
closed (``entry=None`` plus a reason) and the engine's degradation ladder
takes over.  ``collect`` never raises for a data-plane fault, and a wave's
in-flight keys are always released.  Counters: ``retries``, ``timeouts``,
``failures``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.serving.cache import CachedRetrieval, RetrievalCache


def device_error(exc: BaseException) -> bool:
    """True for a CUDA runtime error (a failed kernel, stream, event or
    copy).  Such an error is not a data-plane fault: it raises through the
    prefetcher's retries, the engine's ladder and the router's failover."""
    accel = getattr(torch, "AcceleratorError", None)
    return (isinstance(accel, type) and isinstance(exc, accel)) or "CUDA error" in str(exc)


class _Landed:
    """One retrieval field on its way to the host: ``host`` is the pinned
    buffer a side-stream copy fills (or, for a CPU pipeline, the result
    itself), ``event`` the event recorded after the wave's copies (None:
    ready at once).  ``src`` holds the device result until the copy is done."""

    __slots__ = ("host", "event", "src")

    def __init__(self, host: torch.Tensor, event=None, src=None):
        self.host, self.event, self.src = host, event, src

    def is_ready(self) -> bool:
        return self.event is None or self.event.query()

    def __array__(self, dtype=None, copy=None):
        if self.event is not None:
            self.event.synchronize()  # this wave's copies only, not the card
        a = self.host.numpy()
        return a.astype(dtype) if dtype is not None else a


def _land(res, stream) -> tuple:
    """The four fields a collect forces — (nodes, mask, dist, seeds) — as
    handles with ``is_ready()`` and ``__array__``.  On a CUDA stream: one
    pinned buffer each, filled by non-blocking copies queued on ``stream``
    (the current stream here) and one event recorded after them."""
    fields = (res.sub.nodes, res.sub.mask, res.sub.dist, res.seeds)
    if not isinstance(res.seeds, torch.Tensor):
        return fields  # a simulator's lazy host arrays
    if stream is None:
        return tuple(_Landed(a) for a in fields)
    bufs = [torch.empty(a.shape, dtype=a.dtype, pin_memory=True) for a in fields]
    for b, a in zip(bufs, fields):
        b.copy_(a, non_blocking=True)
    event = torch.cuda.Event()
    event.record(stream)
    return tuple(_Landed(b, event, a) for b, a in zip(bufs, fields))


@dataclasses.dataclass
class PrefetchWave:
    """One launched admission wave: requests + the uncollected results."""

    reqs: list  # RAGRequest, arrival order
    entry_for: list  # per request: CachedRetrieval | None until resolved
    miss_groups: dict  # key -> [request indices], intra-wave dedupe
    deferred: list  # (request idx, key, owner wave's entries_by_key dict)
    arrs: Optional[tuple] = None  # (nodes, mask, dist, seeds) handles when misses exist
    epoch: int = 0  # graph epoch the retrieval was launched against
    launched_at: float = 0.0  # clock at dispatch return
    launch_step: int = 0  # engine step counter at launch
    launch_tokens: int = 0  # engine emitted-token counter at launch
    entries_by_key: dict = dataclasses.field(default_factory=dict)
    launch_error: Optional[str] = None  # the batched dispatch itself raised
    error_for: list = dataclasses.field(default_factory=list)  # per request

    @property
    def has_misses(self) -> bool:
        return bool(self.miss_groups)


class AdmissionPrefetcher:
    """Launch/collect state machine over at most ``depth`` in-flight waves.

    The same code drives both admission schedules: sync mode collects right
    after launching (zero overlap by definition), prefetch mode leaves the
    wave in flight until the engine has free slots.
    """

    def __init__(
        self,
        pipeline,
        cache: RetrievalCache,
        *,
        wave_size: int,
        depth: int = 1,
        retrieval_timeout_s: Optional[float] = None,
        max_retries: int = 0,
        retry_backoff_s: float = 0.0,
        now_fn: Callable[[], float] = time.perf_counter,
        sleep_fn: Callable[[float], None] = time.sleep,
    ):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        if retrieval_timeout_s is not None and retrieval_timeout_s <= 0:
            raise ValueError(f"retrieval_timeout_s must be > 0, got {retrieval_timeout_s}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.pipeline = pipeline
        self.cache = cache
        self.wave_size = wave_size
        self.depth = depth
        self.retrieval_timeout_s = retrieval_timeout_s
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self._now = now_fn
        self._sleep = sleep_fn
        self._waves: deque[PrefetchWave] = deque()
        self._streams: dict = {}  # device index -> side stream
        self._abandoned: list = []  # landed handles whose copies may still run
        # telemetry
        self.waves = 0  # async-collected waves (prefetch schedule only)
        self.batches = 0  # retrieval dispatches (both schedules)
        self.queries = 0  # deduped queries retrieved
        self.launch_seconds = 0.0
        self.block_seconds = 0.0
        self.overlap_seconds = 0.0
        self.overlap_steps = 0
        self.overlap_tokens = 0
        self.retries = 0  # size-1 relaunches of failed miss-groups
        self.timeouts = 0  # waits that hit retrieval_timeout_s
        self.failures = 0  # groups that exhausted retries (ladder-bound)

    @property
    def _n_nodes(self) -> Optional[int]:
        """Node-id validation bound for corrupt-result detection (None skips
        the check), read per use."""
        n = getattr(self.pipeline, "n_valid_nodes", None)
        if n is not None:
            return int(n)
        emb = getattr(self.pipeline, "node_emb", None)
        return int(emb.shape[0]) if emb is not None else None

    @property
    def in_flight(self) -> int:
        return len(self._waves)

    @property
    def in_flight_requests(self) -> int:
        """Requests inside launched-but-uncollected waves (a load signal of
        the replica router's health snapshot)."""
        return sum(len(w.reqs) for w in self._waves)

    def can_launch(self) -> bool:
        return len(self._waves) < self.depth

    def launched_before(self, step: int) -> bool:
        """Whether the oldest in-flight wave was launched before ``step``:
        collecting a wave in the step it launched forfeits its overlap."""
        return bool(self._waves) and self._waves[0].launch_step < step

    def _owner_entries(self, key: bytes) -> Optional[dict]:
        """The in-flight owner wave's (still empty) entries_by_key dict,
        filled in place at that wave's collect."""
        for w in self._waves:
            if key in w.miss_groups:
                return w.entries_by_key
        return None

    # -- the side stream ------------------------------------------------------
    def side_stream(self) -> Optional[torch.cuda.Stream]:
        """The stream retrieval runs on when the pipeline lives on a card
        (one per device, made on first use); None for a CPU pipeline."""
        dev = getattr(self.pipeline, "device", None)
        if dev is None or torch.device(dev).type != "cuda":
            return None
        dev = torch.device(dev)
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        stream = self._streams.get(index)
        if stream is None:
            stream = self._streams[index] = torch.cuda.Stream(device=index)
        return stream

    def _prune_abandoned(self) -> None:
        self._abandoned = [arrs for arrs in self._abandoned
                           if not all(a.is_ready() for a in arrs)]

    def _drop(self, arrs) -> None:
        """Let go of a wave's handles; landed copies still in flight are kept
        (buffers, device results, event) until their event completes."""
        if arrs and isinstance(arrs[0], _Landed) and not arrs[0].is_ready():
            self._abandoned.append(arrs)

    def _dispatch(self, qe: np.ndarray, batch_size: int):
        """One ``retrieve_many`` call (on the side stream for a CUDA
        pipeline) and its landing.  Returns (result, handles, error): a
        data-plane raise comes back as ``error``; a CUDA error raises."""
        self._prune_abandoned()
        stream = self.side_stream()
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            try:
                res = self.pipeline.retrieve_many(qe, batch_size=batch_size)
            except Exception as exc:
                if device_error(exc):
                    raise
                return None, None, f"dispatch: {exc}"
            return res, _land(res, stream), None

    # -- launch ---------------------------------------------------------------
    def launch(self, reqs: list, *, step: int = 0, tokens: int = 0) -> PrefetchWave:
        """Dispatch one admission wave without waiting for its results.

        Cache lookups and hit/miss accounting happen here, request for
        request as in the sync schedule: hits attach at once, misses dedupe
        into one ``retrieve_many`` row per quantized key (every duplicate
        still counts its own miss), and keys already in flight defer to the
        owning wave with no counter touched until that wave collects.
        """
        cache = self.cache
        t0 = self._now()
        wave = PrefetchWave(reqs=reqs, entry_for=[None] * len(reqs), miss_groups={},
                            deferred=[], launch_step=step, launch_tokens=tokens)
        for j, r in enumerate(reqs):
            k = cache.key(r.query_emb)
            if k in wave.miss_groups:  # intra-wave dup: its own miss, one row
                cache.get(r.query_emb)
                wave.miss_groups[k].append(j)
                continue
            if cache.is_inflight(k):  # owned by an earlier uncollected wave
                # ours, or another replica's prefetcher sharing this cache
                # (it registered its entries_by_key at mark_inflight)
                owner_entries = self._owner_entries(k)
                if owner_entries is None:
                    owner_entries = cache.inflight_entries(k)
                if owner_entries is not None:
                    wave.deferred.append((j, k, owner_entries))
                    continue
                # a marker with no registered owner anywhere (a dead
                # engine's leftover): re-dispatch as an ordinary miss
            e = cache.get(r.query_emb)
            if e is not None:
                wave.entry_for[j] = e
                r.cache_hit = True
            else:
                wave.miss_groups[k] = [j]

        if wave.miss_groups:
            qe = np.stack([reqs[idxs[0]].query_emb for idxs in wave.miss_groups.values()]
                          ).astype(np.float32)
            res, wave.arrs, wave.launch_error = self._dispatch(qe, self.wave_size)
            if res is not None:
                wave.epoch = res.epoch
                # mark only after a successful dispatch, so a raise never
                # leaves keys poisoned in the in-flight set
                for k in wave.miss_groups:
                    cache.mark_inflight(k, wave.entries_by_key)
                self.batches += 1
                self.queries += res.n_valid
        wave.launched_at = self._now()
        self.launch_seconds += wave.launched_at - t0
        self._waves.append(wave)
        return wave

    # -- collect --------------------------------------------------------------
    @staticmethod
    def _arr_ready(a) -> bool:
        """True once forcing ``a`` would not block (arrays without the
        method are always ready)."""
        is_ready = getattr(a, "is_ready", None)
        return bool(is_ready()) if callable(is_ready) else True

    def _wave_ready(self, wave: PrefetchWave) -> bool:
        """Collectable without blocking: the results landed and every
        deferred request's owner has collected.  A wave whose dispatch
        raised, or whose wait outlived ``retrieval_timeout_s``, is ready
        too: collecting it runs the retry/failure path."""
        for _, k, owner_entries in wave.deferred:
            if owner_entries is not None and k not in owner_entries \
                    and self.cache.is_inflight(k):
                return False
        if not wave.has_misses or wave.launch_error is not None:
            return True
        if self.retrieval_timeout_s is not None and \
                self._now() >= wave.launched_at + self.retrieval_timeout_s:
            return True
        return all(self._arr_ready(a) for a in wave.arrs)

    def ready_index(self) -> Optional[int]:
        """Index of the oldest in-flight wave that can be collected without
        blocking, or None (continuous admission's out-of-order hook)."""
        for i, w in enumerate(self._waves):
            if self._wave_ready(w):
                return i
        return None

    def collect(self, *, step: int = 0, tokens: int = 0, sync: bool = False) -> list:
        """Block on the oldest wave and return ``(request, entry, error)``
        triples in arrival order (``entry`` is None exactly when ``error`` is
        set).  ``sync=True`` marks launch-then-collect: no overlap accrues."""
        wave = self._waves.popleft()
        return self._collect(wave, step=step, tokens=tokens, sync=sync)

    def collect_at(self, index: int, *, step: int = 0, tokens: int = 0) -> list:
        """Collect the wave at ``index`` (from :meth:`ready_index`) out of
        FIFO order."""
        wave = self._waves[index]
        del self._waves[index]
        return self._collect(wave, step=step, tokens=tokens, sync=False)

    # -- fault containment ----------------------------------------------------
    def _wait_ready(self, arrs, deadline: Optional[float]) -> bool:
        """Poll until every array is ready or ``deadline`` passes.  With no
        deadline, return at once and let the force block."""
        if deadline is None:
            return True
        while not all(self._arr_ready(a) for a in arrs):
            now = self._now()
            if now >= deadline:
                return False
            self._sleep(min(1e-3, max(deadline - now, 1e-6)))
        return True

    @staticmethod
    def _force(arrs):
        """The host arrays of ``arrs``, or the data-plane fault's reason."""
        try:
            return tuple(np.asarray(a) for a in arrs), None
        except Exception as exc:
            if device_error(exc):
                raise
            return None, f"force: {exc}"

    def _validate_row(self, nodes, mask) -> Optional[str]:
        """Corrupt-result check: every node id under the valid mask must be
        a real node.  Returns an error reason, or None when clean."""
        if self._n_nodes is None:
            return None
        ids = np.asarray(nodes)[np.asarray(mask, bool)]
        if ids.size and (int(ids.min()) < 0 or int(ids.max()) >= self._n_nodes):
            return (f"corrupt: node id out of range [0, {self._n_nodes}) "
                    f"(min {int(ids.min())}, max {int(ids.max())})")
        return None

    def _retrieve_once(self, emb) -> tuple:
        """One isolated size-1 dispatch + bounded wait + force + validate.
        Returns ``(entry, None)`` or ``(None, reason)``."""
        t0 = self._now()
        res, arrs, err = self._dispatch(np.asarray(emb, np.float32)[None], 1)
        if err is not None:
            return None, err
        self.batches += 1
        self.queries += 1
        try:
            deadline = None if self.retrieval_timeout_s is None else \
                t0 + self.retrieval_timeout_s
            if not self._wait_ready(arrs, deadline):
                self.timeouts += 1
                return None, f"timeout: not ready in {self.retrieval_timeout_s}s"
            host, err = self._force(arrs)
            if err is not None:
                return None, err
        finally:
            self._drop(arrs)
        nodes, mask, dist, seeds = host
        err = self._validate_row(nodes[0], mask[0])
        if err is not None:
            return None, err
        return CachedRetrieval(nodes=nodes[0].copy(), mask=mask[0].copy(), dist=dist[0].copy(),
                               seeds=seeds[0].copy(), epoch=res.epoch), None

    def _retry_group(self, emb, failed_attempts: int, last_reason: str) -> tuple:
        """Relaunch one failed miss-group (size-1 dispatches) until it
        succeeds or the retry budget is spent.  ``failed_attempts`` counts
        the dispatches already charged (the batched launch counts one; an
        orphaned deferral starts at zero)."""
        reason = last_reason
        while failed_attempts <= self.max_retries:
            if failed_attempts > 0:
                if self.retry_backoff_s > 0:
                    self._sleep(self.retry_backoff_s * (2 ** (failed_attempts - 1)))
                self.retries += 1
            entry, reason = self._retrieve_once(emb)
            if entry is not None:
                return entry, None
            failed_attempts += 1
        self.failures += 1
        return None, reason

    def _resolve_misses(self, wave: PrefetchWave, entries: dict, failures: dict) -> None:
        """Materialize every miss-group of ``wave`` into ``entries`` (key ->
        CachedRetrieval) or ``failures`` (key -> reason), from the batched
        results when healthy and through the per-group retries when not."""
        groups = list(wave.miss_groups.items())  # row order == launch order
        todo: dict = {}  # key -> last failure reason (needs retry)
        if wave.launch_error is not None:
            todo = {k: wave.launch_error for k, _ in groups}
        else:
            deadline = None if self.retrieval_timeout_s is None else \
                wave.launched_at + self.retrieval_timeout_s
            if not self._wait_ready(wave.arrs, deadline):
                self.timeouts += 1
                reason = f"timeout: not ready in {self.retrieval_timeout_s}s"
                todo = {k: reason for k, _ in groups}
            else:
                host, err = self._force(wave.arrs)
                if err is not None:
                    todo = {k: err for k, _ in groups}
                else:
                    nodes, mask, dist, seeds = host
                    for row, (k, _) in enumerate(groups):
                        err = self._validate_row(nodes[row], mask[row])
                        if err is not None:
                            todo[k] = err
                            continue
                        entries[k] = CachedRetrieval(
                            nodes=nodes[row].copy(), mask=mask[row].copy(),
                            dist=dist[row].copy(), seeds=seeds[row].copy(), epoch=wave.epoch)
        for k, idxs in groups:
            if k not in todo:
                continue
            entry, reason = self._retry_group(wave.reqs[idxs[0]].query_emb, 1, todo[k])
            if entry is not None:
                entries[k] = entry
            else:
                failures[k] = reason

    def _collect(self, wave: PrefetchWave, *, step: int, tokens: int, sync: bool) -> list:
        cache = self.cache
        t0 = self._now()
        wave.error_for = [None] * len(wave.reqs)
        if not sync and wave.has_misses:
            # overlap accrues only for waves that dispatched a retrieval
            self.waves += 1
            self.overlap_seconds += max(0.0, t0 - wave.launched_at)
            self.overlap_steps += max(0, step - wave.launch_step)
            self.overlap_tokens += max(0, tokens - wave.launch_tokens)
        entries: dict = {}
        failures: dict = {}
        try:
            if wave.has_misses:
                self._resolve_misses(wave, entries, failures)
                self.block_seconds += self._now() - t0

            # deferred first (cache hits on earlier waves' keys, resolved
            # before this wave's own puts as in sync get-then-put order)
            for j, k, owner_entries in wave.deferred:
                r = wave.reqs[j]
                e = cache.get(r.query_emb)  # counts the hit, bumps recency
                if e is not None:
                    r.cache_hit = True
                elif owner_entries is not None:
                    # the owner's entry was evicted or expired between its
                    # collect and ours: the get counted the miss (as sync
                    # would), and the owner's result is served and put back
                    # as sync's re-retrieval would (one dispatch fewer)
                    e = owner_entries.get(k)
                    if e is not None:
                        cache.put(r.query_emb, e)
                if e is None:
                    # orphaned deferral: the owner's group failed or was
                    # aborted; adopt the key as our own size-1 miss
                    e, reason = self._retry_group(r.query_emb, 0, "orphaned")
                    if e is not None:
                        cache.put(r.query_emb, e)
                    else:
                        wave.error_for[j] = reason
                wave.entry_for[j] = e
            for k, idxs in wave.miss_groups.items():
                entry = entries.get(k)
                if entry is None:
                    for j in idxs:
                        wave.error_for[j] = failures.get(k, "unknown fault")
                    continue
                cache.put(wave.reqs[idxs[0]].query_emb, entry)
                wave.entries_by_key[k] = entry
                for j in idxs:
                    wave.entry_for[j] = entry
        finally:
            # the keys leave the in-flight set whatever happened, so later
            # launches re-dispatch instead of deferring to a dead wave
            for k in wave.miss_groups:
                cache.release_inflight(k)
            self._drop(wave.arrs)
            wave.arrs = None
        return list(zip(wave.reqs, wave.entry_for, wave.error_for))

    def abort(self) -> list:
        """Discard every in-flight wave: release its in-flight cache keys and
        hand back the never-resolved requests."""
        orphans = []
        while self._waves:
            w = self._waves.popleft()
            for k in w.miss_groups:
                self.cache.release_inflight(k)
            self._drop(w.arrs)
            w.arrs = None
            orphans.extend(w.reqs)
        return orphans

    def stats(self) -> dict:
        denom = self.overlap_seconds + self.block_seconds
        return {
            "prefetch_waves": self.waves,
            "overlap_seconds": self.overlap_seconds,
            "overlap_steps": self.overlap_steps,
            "overlap_tokens": self.overlap_tokens,
            "launch_seconds": self.launch_seconds,
            "collect_block_seconds": self.block_seconds,
            "hidden_frac": self.overlap_seconds / denom if denom > 0 else 0.0,
            "retries": self.retries,
            "timeouts": self.timeouts,
            "retrieval_failures": self.failures,
        }

    def stats_ns(self) -> dict:
        """Namespaced stats: the prefetcher's counters under ``prefetch.*``."""
        return {"prefetch": self.stats()}
