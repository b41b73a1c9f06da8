"""Admission retrieval for the fused RAG engine, in its sync schedule.

Each admission wave runs two phases back to back:

* **launch** — cache lookup + intra-wave dedupe + ONE batched
  ``RGLPipeline.retrieve_many`` call over the wave's misses.  Duplicates
  inside a wave each count their own miss but share one retrieval row.
* **collect** — copy the wave's results to the host (the one sync), insert
  the finished entries into the :class:`RetrievalCache`, and hand
  ``(request, entry, error)`` triples back for tokenization and admission.

Miss keys are marked in flight between the two phases.  The async schedule
(retrieval of wave *i+1* overlapping decode of wave *i*, on CUDA streams)
and the fault-containment layer (timeouts, retries) are not ported yet:
ROADMAP Queue 1 item 12.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional

import numpy as np

from repro_torch.serving.cache import CachedRetrieval, RetrievalCache

_FAULTS = "ROADMAP Queue 1 item 12 (fault tolerance and async prefetch)"


@dataclasses.dataclass
class PrefetchWave:
    """One launched admission wave: requests + the uncollected device tensors."""

    reqs: list  # RAGRequest, arrival order
    entry_for: list  # per request: CachedRetrieval | None until resolved
    miss_groups: dict  # key -> [request indices], intra-wave dedupe
    sub: object = None  # Subgraph of device tensors when misses exist
    seeds: object = None
    epoch: int = 0

    @property
    def has_misses(self) -> bool:
        return bool(self.miss_groups)


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


class AdmissionPrefetcher:
    """Launch/collect state machine; the sync schedule collects each wave
    right after launching it."""

    def __init__(self, pipeline, cache: RetrievalCache, *, wave_size: int,
                 depth: int = 1, retrieval_timeout_s: Optional[float] = None,
                 max_retries: int = 0, now_fn: Callable[[], float] = time.perf_counter):
        if depth != 1 or retrieval_timeout_s is not None or max_retries:
            raise NotImplementedError(f"prefetch depth, timeouts and retries: {_FAULTS}")
        self.pipeline = pipeline
        self.cache = cache
        self.wave_size = wave_size
        self._now = now_fn
        self._waves: deque[PrefetchWave] = deque()
        self.batches = 0  # retrieval dispatches
        self.queries = 0  # deduped queries retrieved
        self.launch_seconds = 0.0
        self.block_seconds = 0.0

    @property
    def in_flight(self) -> int:
        return len(self._waves)

    def launch(self, reqs: list) -> PrefetchWave:
        """Look every request up in the cache and dispatch one batched
        retrieval for the wave's distinct misses (device work may still be in
        flight when this returns)."""
        cache = self.cache
        t0 = self._now()
        wave = PrefetchWave(reqs=reqs, entry_for=[None] * len(reqs), miss_groups={})
        for j, r in enumerate(reqs):
            k = cache.key(r.query_emb)
            if k in wave.miss_groups:  # intra-wave duplicate: its own miss, one row
                cache.get(r.query_emb)
                wave.miss_groups[k].append(j)
                continue
            e = cache.get(r.query_emb)
            if e is not None:
                wave.entry_for[j] = e
                r.cache_hit = True
            else:
                wave.miss_groups[k] = [j]
        if wave.miss_groups:
            qe = np.stack([reqs[idxs[0]].query_emb for idxs in wave.miss_groups.values()])
            res = self.pipeline.retrieve_many(qe.astype(np.float32), batch_size=self.wave_size)
            wave.sub, wave.seeds, wave.epoch = res.sub, res.seeds, res.epoch
            for k in wave.miss_groups:
                cache.mark_inflight(k)
            self.batches += 1
            self.queries += res.n_valid
        self.launch_seconds += self._now() - t0
        self._waves.append(wave)
        return wave

    def collect(self) -> list:
        """Block on the oldest wave and return ``(request, entry, error)``
        triples in arrival order (``error`` is always None here: a retrieval
        fault raises)."""
        wave = self._waves.popleft()
        t0 = self._now()
        try:
            if wave.has_misses:
                nodes, mask, dist, seeds = (
                    _host(a) for a in (wave.sub.nodes, wave.sub.mask, wave.sub.dist, wave.seeds)
                )
                self.block_seconds += self._now() - t0
                for row, (k, idxs) in enumerate(wave.miss_groups.items()):
                    entry = CachedRetrieval(
                        nodes=nodes[row].copy(), mask=mask[row].copy(),
                        dist=dist[row].copy(), seeds=seeds[row].copy(), epoch=wave.epoch,
                    )
                    self.cache.put(wave.reqs[idxs[0]].query_emb, entry)
                    for j in idxs:
                        wave.entry_for[j] = entry
        finally:
            for k in wave.miss_groups:
                self.cache.release_inflight(k)
            wave.sub = wave.seeds = None
        return [(r, e, None) for r, e in zip(wave.reqs, wave.entry_for)]

    def stats(self) -> dict:
        """The reference's keys; the async-overlap and fault counters stay 0
        in the sync schedule."""
        return {
            "prefetch_waves": 0,
            "overlap_seconds": 0.0,
            "overlap_steps": 0,
            "overlap_tokens": 0,
            "launch_seconds": self.launch_seconds,
            "collect_block_seconds": self.block_seconds,
            "hidden_frac": 0.0,
            "retries": 0,
            "timeouts": 0,
            "retrieval_failures": 0,
        }
