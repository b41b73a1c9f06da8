"""Retrieval cache for the fused RAG serving engine.

A policy-driven map from *quantized query embedding* to the finished
retrieval result (filtered subgraph membership + seed ids).  Quantization
(``round(emb / eps)``) makes near-duplicate queries collapse onto one key,
so a hit skips the entire index + BFS + filter stack.  Entries are host-side
numpy (O(budget) ints per query), so the cache never holds device memory.

Eviction policies (capacity pressure): ``lru`` (least recently used),
``lfu`` (fewest per-entry hits, ties least recent), ``ttl`` (oldest
inserted).  Independently, an optional ``ttl`` (seconds) expires entries:
an expired entry is invisible to ``get`` (a miss, counted once in
``expired``) and stays resident until capacity pressure purges it, as in
the reference (whose degradation ladder can still serve it).

The **in-flight registry** records keys whose retrieval was dispatched but
not yet collected (``mark_inflight`` / ``release_inflight``).

With prefix sharing, an entry may **pin** the paged-KV pool blocks that hold
its prefilled prompt (``kv_*`` fields, set by the serving engine).  The
cache releases a pin when its entry leaves (eviction, overwrite, TTL purge)
and, through :meth:`RetrievalCache.reclaim_kv`, under pool pressure, so
cache lifetime, not request lifetime, bounds how long prefilled KV stays.

Not ported yet: stale lookups for the degradation ladder (ROADMAP Queue 1
item 12) and mutation epochs / region invalidation (item 13).
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict

import numpy as np

POLICIES = ("lru", "lfu", "ttl")


@dataclasses.dataclass
class CachedRetrieval:
    """One query's retrieval output, materialized on host, and the
    engine-owned pin of its prefilled prompt's KV blocks (None/defaults
    when unpinned): ``kv_blocks`` the pool block ids (one refcount hold
    each), ``kv_prompt`` the exact token ids they cover, ``kv_first_tok``
    the prefill's argmax, ``kv_release`` the owning engine's release hook."""

    nodes: np.ndarray  # (M,) int32 subgraph node ids (sentinel where ~mask)
    mask: np.ndarray  # (M,) bool
    dist: np.ndarray  # (M,) int32 hop distances
    seeds: np.ndarray  # (S,) int32 seed node ids
    epoch: int = 0  # graph epoch the retrieval ran against (0: frozen corpus)
    kv_blocks: np.ndarray | None = None  # (nblk,) int32 pool block ids
    kv_len: int = 0  # prompt tokens the pinned blocks cover
    kv_first_tok: int = -1  # prefill argmax recorded at pin time
    kv_prompt: np.ndarray | None = None  # (L,) int32 exact pinned prompt
    kv_owner: object = None  # engine whose pool the block ids index
    kv_release: object = None  # hook: entry -> blocks returned to the pool
    cache_key: bytes | None = None  # set by put(); drives is_resident()


@dataclasses.dataclass
class _Slot:
    """Cache bookkeeping around one entry."""

    entry: CachedRetrieval
    hits: int = 0  # per-entry hit count (drives lfu)
    inserted_at: float = 0.0  # ttl expiry + FIFO eviction order
    expired_counted: bool = False  # each expiry counts once in ``expired``


class RetrievalCache:
    """Policy-driven cache keyed on quantized query embeddings.

    ``get`` counts a hit or miss (expired entries count as misses) and
    refreshes recency; ``put`` inserts and evicts per the policy beyond
    ``capacity``.  ``capacity <= 0`` disables caching.  ``now_fn`` is
    injectable so TTL behaviour is testable without sleeping.
    """

    def __init__(self, capacity: int = 256, quant_eps: float = 1e-3, *,
                 policy: str = "lru", ttl: float | None = None, now_fn=time.monotonic):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
        self.capacity = capacity
        self.quant_eps = quant_eps
        self.policy = policy
        self.ttl = ttl
        self._now = now_fn
        self._data: OrderedDict[bytes, _Slot] = OrderedDict()  # recency order
        self._inflight: set[bytes] = set()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.expired = 0

    def __len__(self) -> int:
        return len(self._data)

    def key(self, query_emb) -> bytes:
        q = np.asarray(query_emb, np.float32).ravel()
        return np.round(q / self.quant_eps).astype(np.int32).tobytes()

    # -- in-flight miss registry ----------------------------------------------
    def mark_inflight(self, key: bytes) -> None:
        self._inflight.add(key)

    def is_inflight(self, key: bytes) -> bool:
        return key in self._inflight

    def release_inflight(self, key: bytes) -> None:
        self._inflight.discard(key)

    # -- expiry ---------------------------------------------------------------
    def _is_expired(self, slot: _Slot, now: float) -> bool:
        return self.ttl is not None and now - slot.inserted_at > self.ttl

    def _count_expiry(self, slot: _Slot) -> None:
        if not slot.expired_counted:
            slot.expired_counted = True
            self.expired += 1

    def _purge_expired(self, now: float) -> None:
        dead = [k for k, s in self._data.items() if self._is_expired(s, now)]
        for k in dead:
            slot = self._data.pop(k)
            self._count_expiry(slot)
            self._release_kv(slot.entry)

    # -- lookup / insert ------------------------------------------------------
    def get(self, query_emb) -> CachedRetrieval | None:
        k = self.key(query_emb)
        slot = self._data.get(k)
        if slot is not None and self._is_expired(slot, self._now()):
            self._count_expiry(slot)
            slot = None
        if slot is None:
            self.misses += 1
            return None
        self._data.move_to_end(k)
        slot.hits += 1
        self.hits += 1
        return slot.entry

    def hit_count(self, query_emb) -> int:
        """Per-entry hit count (0 if absent): the lfu eviction signal."""
        slot = self._data.get(self.key(query_emb))
        return slot.hits if slot is not None else 0

    @staticmethod
    def _release_kv(entry: CachedRetrieval) -> int:
        """Release an entry's KV pin (if any) as it leaves the cache; the
        hook is the owning engine's and idempotent."""
        return int(entry.kv_release(entry)) if entry.kv_release is not None else 0

    def _evict_one(self, protect: bytes) -> None:
        # the just-inserted key is never its own victim (else a 0-hit
        # newcomer would be evicted immediately under lfu)
        pool = [k for k in self._data if k != protect]
        if self.policy == "lru":
            victim = pool[0]  # OrderedDict order = least recent first
        elif self.policy == "lfu":
            victim = min(pool, key=lambda k: self._data[k].hits)
        else:  # ttl: oldest inserted first
            victim = min(pool, key=lambda k: self._data[k].inserted_at)
        self._release_kv(self._data.pop(victim).entry)
        self.evictions += 1

    def put(self, query_emb, entry: CachedRetrieval) -> None:
        if self.capacity <= 0:
            return
        now = self._now()
        k = self.key(query_emb)
        prev = self._data.get(k)
        if prev is not None and prev.entry is not entry:
            self._release_kv(prev.entry)  # the displaced entry's pin goes
        # a re-insert keeps the accumulated hits (lfu warmth) but restarts
        # the TTL window: the data is fresh
        self._data[k] = _Slot(entry=entry, inserted_at=now,
                              hits=prev.hits if prev is not None else 0)
        entry.cache_key = k
        self._data.move_to_end(k)
        if len(self._data) > self.capacity:
            self._purge_expired(now)
        while len(self._data) > self.capacity:
            self._evict_one(protect=k)

    # -- prefilled-KV pins ----------------------------------------------------
    def is_resident(self, entry: CachedRetrieval) -> bool:
        """True while ``entry`` occupies its cache slot: the engine's pin
        gate (a pin on a displaced entry would never be released)."""
        slot = self._data.get(entry.cache_key) if entry.cache_key is not None else None
        return slot is not None and slot.entry is entry

    def kv_pinned_entries(self) -> int:
        return sum(1 for s in self._data.values() if s.entry.kv_blocks is not None)

    def reclaim_kv(self, want_blocks: int, owner=None) -> int:
        """Release KV pins until ``want_blocks`` blocks came back to the
        free stack (or no pins remain): TTL-expired pins first, then the
        policy's eviction order.  Entries keep their retrieval results.
        ``owner`` limits it to pins on one engine's pool.  Returns the
        blocks freed."""
        if want_blocks <= 0:
            return 0
        now = self._now()
        pinned = [k for k, s in self._data.items() if s.entry.kv_blocks is not None
                  and (owner is None or s.entry.kv_owner is owner)]
        expired = [k for k in pinned if self._is_expired(self._data[k], now)]
        fresh = [k for k in pinned if k not in set(expired)]
        if self.policy == "lfu":
            fresh.sort(key=lambda k: self._data[k].hits)
        elif self.policy == "ttl":
            fresh.sort(key=lambda k: self._data[k].inserted_at)
        # lru: dict order is already least recent first
        freed = 0
        for k in expired + fresh:
            if freed >= want_blocks:
                break
            freed += self._release_kv(self._data[k].entry)
        return freed

    def stats(self) -> dict:
        total = self.hits + self.misses
        now = self._now()
        resident = len(self._data)
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "expired": self.expired,
            "policy": self.policy,
            "size": resident,
            "resident": resident,
            "live": sum(1 for s in self._data.values() if not self._is_expired(s, now)),
            "kv_pinned_entries": self.kv_pinned_entries(),
            "inflight": len(self._inflight),
            "hit_rate": self.hits / total if total else 0.0,
        }

    def stats_ns(self) -> dict:
        """Namespaced stats: this cache's counters under ``cache.*``."""
        return {"cache": self.stats()}
