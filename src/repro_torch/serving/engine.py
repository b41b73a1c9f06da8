"""Batched serving engine: continuous batching over fixed decode slots.

Each of the B slots holds one in-flight request, and every engine step runs
one decode step for all slots.  Admission is batched: all free slots are
refilled by one masked batched prefill (prompts padded to a shared
power-of-two length bucket, run through one ``tm.prefill`` call), and the
fresh rows go into the KV arena.

Two arenas: the contiguous (B, cache_len) ``tm.KVCache`` (default), or with
``paged_kv`` a shared pool of fixed-size blocks (``tm.PagedKVCache``): a
slot holds only the blocks its cursor has crossed and returns them the step
its request retires.  ``prefix_share`` (paged only) lets a request whose
exact prompt a retrieval-cache entry has pinned alias the pinned blocks
instead of running prefill.  Outputs are the same tokens on either arena.

Two decode modes share the arena: one-token (each step is one
``tm.serve_step``), and self-speculative (``spec_decode`` or
``RGL_SPEC_DECODE=1``): each step drafts ``draft_window - 1`` tokens per
slot from the request's own prompt+output history
(:mod:`repro_torch.serving.drafter`, no second model) and verifies all of
them in one ``tm.verify_step``.  Greedy acceptance keeps the longest draft
prefix that one-token decode would have emitted, so a step commits 1 to
``draft_window`` tokens a slot and the outputs are one-token decode's.
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.transformer import model as tm
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.serving.config import env_flag
from repro_torch.serving.drafter import draft_tokens
from repro_torch.tracing import Totals, span


def _draft_window_default() -> int:
    """``RGL_DRAFT_WINDOW`` (default 4), unclamped: the constructor applies
    the same ``>= 2`` check to it as to ``draft_window=``, so an invalid
    setting fails loudly instead of being rewritten."""
    raw = os.environ.get("RGL_DRAFT_WINDOW", "4")
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"RGL_DRAFT_WINDOW={raw!r} is not an integer") from None


def _auto_block_size(cache_len: int, preferred: int = 16) -> int:
    """Largest block size <= ``preferred`` dividing ``cache_len``."""
    for b in range(min(preferred, cache_len), 0, -1):
        if cache_len % b == 0:
            return b
    return 1


@dataclasses.dataclass
class Request:
    uid: int
    prompt_ids: np.ndarray  # (L,) int32
    max_new_tokens: int = 32
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    # retired early by KV exhaustion (arena full, or paged pool empty):
    # out_tokens is shorter than max_new_tokens and did not end at EOS
    truncated: bool = False
    # retired by ServeEngine.abort(): tokens emitted so far are kept
    failed: bool = False
    error: Optional[str] = None
    # monotonic admission ticket assigned by the submitting front-end
    ticket: int = -1
    # prefix sharing (set by the RAG layer): ``shared_prefix`` names a
    # CachedRetrieval whose pinned blocks cover this exact prompt (admission
    # re-validates, else prefills); ``pin_to`` names the entry that receives
    # this request's freshly prefilled prompt blocks as its pin
    shared_prefix: object = None
    pin_to: object = None
    # the engine's clock when its prefill started, and when its first token
    # reached the host
    t_admitted: Optional[float] = None
    t_first_token: Optional[float] = None


@dataclasses.dataclass
class _SharePlan:
    """Admission-time snapshot of a validated prefix share; the holds the
    engine takes when making it keep the blocks alive until adoption."""

    blocks: np.ndarray  # all ceil(L/bs) donor prompt blocks, table order
    nfull: int  # full leading blocks to alias
    tail: int  # donor's partial tail block to copy, -1 if none
    length: int  # prompt tokens covered
    first_tok: int  # the donor prefill's recorded argmax


def _bucket_len(n: int, cache_len: int, floor: int = 8) -> int:
    """Smallest power-of-two >= n (>= floor), capped at cache_len."""
    b = floor
    while b < n:
        b <<= 1
    return min(b, cache_len)


def _merge_admitted(arena: tm.KVCache, new: tm.KVCache, cur_tok: torch.Tensor,
                    first: torch.Tensor, rows: np.ndarray, newly: np.ndarray):
    """Copy freshly prefilled rows into the slot arena, in place.

    ``rows[i]`` names the prefill-batch row feeding slot i; ``newly[i]``
    masks which slots actually admit.  Returns (arena, cur_tok).
    """
    dev = arena.k.device
    dst = torch.from_numpy(np.flatnonzero(newly)).to(dev)
    src = torch.from_numpy(rows[newly].astype(np.int64)).to(dev)
    for name in ("k", "v", "k_scale", "v_scale"):
        pool = getattr(arena, name)
        if pool is not None:
            pool[:, dst] = getattr(new, name)[:, src]
    arena.pos[dst] = new.pos[src]
    arena.cursor[dst] = new.cursor[src]
    cur_tok = cur_tok.clone()
    cur_tok[dst] = first[src]
    return arena, cur_tok


def _paged_merge_admitted(arena: tm.PagedKVCache, new: tm.KVCache, cur_tok: torch.Tensor,
                          first: torch.Tensor, rows: torch.Tensor, newly: torch.Tensor,
                          tl: torch.Tensor, block_size: int):
    """Paged admission: allocate each admitted slot's ceil(L/bs) prompt
    blocks from the free stack (slot order) and write its freshly
    prefilled rows into the pool, the zero padding of its last block
    included (``pos == -1`` masks it).  ``tl`` (B,) is the per-slot prompt
    length (0 where not admitting).  The pool is updated in place; returns
    (arena, cur_tok)."""
    bs = block_size
    b, sc = arena.pos.shape
    m = arena.table.shape[1]
    target = torch.where(newly, (tl + bs - 1) // bs, 0)
    table, n_free, ref = tm.alloc_blocks(arena.table, arena.free, arena.n_free, arena.ref,
                                         target, newly, m)
    spos = torch.arange(sc, dtype=torch.int32, device=tl.device)[None, :]
    valid = (newly[:, None] & (spos < target[:, None] * bs)).reshape(-1)
    keep = valid.nonzero()[:, 0]
    dst = tm.block_rows(table, bs).reshape(-1)[keep].long()
    src_b, src_s = rows.long()[keep // sc], keep % sc
    for name in ("k", "v", "k_scale", "v_scale"):
        pool = getattr(arena, name)
        if pool is not None:
            pool[:, dst] = getattr(new, name)[:, src_b, src_s]
    pos_new = torch.where(spos < tl[:, None], spos, -1)
    arena = dataclasses.replace(
        arena, table=table, n_free=n_free, ref=ref,
        pos=torch.where(newly[:, None], pos_new, arena.pos),
        cursor=torch.where(newly, tl.to(torch.int32), arena.cursor),
    )
    return arena, torch.where(newly, first[rows.long()], cur_tok)


def _speculate(verify, cache, cur_tok, hist, hist_len, max_new, out_len, n_draft: int):
    """One speculative engine step on the device: prompt-lookup drafts,
    each slot's acceptance room, ``verify(fed, room)`` (the arena's verify
    step), and the append of the accepted tokens to the slots' histories.

    ``max_new`` / ``out_len`` (B,) int32 are device mirrors of each slot's
    token budget and emitted count, so ``room = min(max_new - out_len,
    cache_len - cursor)`` (which keeps a window from overshooting
    ``max_new_tokens`` or the arena) needs no host sync.  Returns (packed
    (B, W + 1): greedy tokens and the accepted count, the step's one host
    transfer; next token, cache, hist, hist_len, out_len)."""
    drafts = draft_tokens(hist, hist_len, n_draft)
    fed = torch.cat([cur_tok[:, None], drafts], dim=1)
    room = torch.minimum(max_new - out_len, cache.pos.shape[1] - cache.cursor).to(torch.int32)
    greedy, accepted, nxt, cache = verify(fed, room)
    h = hist.shape[1]
    cols = torch.arange(h, dtype=torch.int32, device=hist.device)[None, :]
    for i in range(n_draft + 1):
        write = (i < accepted)[:, None] & (cols == (hist_len + i)[:, None])
        hist = torch.where(write, greedy[:, i:i + 1], hist)
    hist_len = torch.clamp(hist_len + accepted, max=h).to(torch.int32)
    packed = torch.cat([greedy, accepted[:, None]], dim=1)
    return packed, nxt, cache, hist, hist_len, (out_len + accepted).to(torch.int32)


def _spec_step(params, cache: tm.KVCache, cur_tok, hist, hist_len, max_new, out_len,
               cfg: TransformerConfig, n_draft: int, eos_id):
    """:func:`_speculate` over the contiguous arena."""
    return _speculate(lambda fed, room: tm.verify_step(params, cache, fed, room, cfg, eos_id),
                      cache, cur_tok, hist, hist_len, max_new, out_len, n_draft)


def _paged_spec_step(params, cache: tm.PagedKVCache, cur_tok, hist, hist_len, max_new, out_len,
                     live, cfg: TransformerConfig, n_draft: int, eos_id, block_size: int):
    """:func:`_speculate` over the paged pool: the same draft, room,
    acceptance and history arithmetic (so the tokens equal the contiguous
    arena's), with ``live`` gating the allocator and the row writes."""
    def verify(fed, room):
        return tm.paged_verify_step(params, cache, fed, room, live, cfg, eos_id=eos_id,
                                    block_size=block_size)
    return _speculate(verify, cache, cur_tok, hist, hist_len, max_new, out_len, n_draft)


class ServeEngine:
    """Continuous-batching decode server over a fixed KV arena.

    Usage::

        eng = ServeEngine(params, cfg, slots=8, cache_len=512, device="cuda")
        eng.submit(Request(uid=0, prompt_ids=ids, max_new_tokens=32))
        finished = eng.run_to_completion()

    ``spec_decode=None`` reads ``RGL_SPEC_DECODE`` (default off);
    ``draft_window=None`` reads ``RGL_DRAFT_WINDOW`` (4), and must be >= 2
    when speculating.

    ``paged_kv=None`` reads ``RGL_PAGED_KV`` (default off).  When paged,
    ``block_size=None`` picks the largest divisor of ``cache_len`` <= 16
    (or ``RGL_KV_BLOCK``) and ``pool_blocks=None`` sizes the pool to
    ``slots * cache_len / block_size`` blocks (never truncates).  A smaller
    pool gates admission on free blocks (FIFO) and, when live slots outgrow
    it mid-decode, first asks the cache to release pins and then retires
    the highest-indexed needy slot with ``truncated=True`` before the step
    runs, so the device allocator never over-pops.

    ``now_fn`` stamps each request's ``t_admitted`` (prefill start) and
    ``t_first_token`` (first token on the host) and times ``admit_seconds``
    and ``decode_seconds``; the RAG engine passes its own clock.
    """

    def __init__(
        self, params, cfg: TransformerConfig, *, slots: int = 8,
        cache_len: int = 512, eos_id: Optional[int] = None,
        spec_decode: Optional[bool] = None, draft_window: Optional[int] = None,
        paged_kv: Optional[bool] = None, block_size: Optional[int] = None,
        pool_blocks: Optional[int] = None, prefix_share: Optional[bool] = None,
        device="cuda", now_fn=time.monotonic,
    ):
        self.device = resolve_device(device)
        self._now = now_fn
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the engine on {self.device}")
        self.spec_decode = env_flag("RGL_SPEC_DECODE") if spec_decode is None else bool(spec_decode)
        self.draft_window = _draft_window_default() if draft_window is None else int(draft_window)
        if self.spec_decode and self.draft_window < 2:
            raise ValueError(f"draft_window must be >= 2 (1 committed token + >= 1 draft), "
                             f"got {self.draft_window}")
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.cache_len = cache_len
        self.eos_id = eos_id
        self.queue: deque = deque()
        self.active: list = [None] * slots
        self.live = np.zeros(slots, bool)
        self.paged_kv = env_flag("RGL_PAGED_KV") if paged_kv is None else bool(paged_kv)
        # prefix sharing is a paged-arena feature: inert on a contiguous arena
        self.prefix_share = (env_flag("RGL_PREFIX_SHARE") if prefix_share is None
                             else bool(prefix_share)) and self.paged_kv
        self.truncations = 0  # requests retired by KV exhaustion
        if block_size is None and os.environ.get("RGL_KV_BLOCK"):
            block_size = int(os.environ["RGL_KV_BLOCK"])
        if self.paged_kv:
            bs = _auto_block_size(cache_len) if block_size is None else int(block_size)
            if bs < 1 or cache_len % bs != 0:
                raise ValueError(f"block_size={bs} must divide cache_len={cache_len}")
            self.block_size = bs
            self.max_blocks = cache_len // bs
            self.pool_blocks = slots * self.max_blocks if pool_blocks is None else int(pool_blocks)
            if self.pool_blocks < self.max_blocks:
                raise ValueError(f"pool_blocks={self.pool_blocks} cannot hold even one "
                                 f"full-length request ({self.max_blocks} blocks)")
            self.cache = tm.init_paged_cache(cfg, slots, cache_len, bs, self.pool_blocks,
                                             device=self.device)
            # content-exact host mirrors of the device allocator: admission
            # and every step replay its arithmetic, so exhaustion checks
            # never read the device
            self._free_stack: list = list(range(self.pool_blocks))
            self._ref_host = np.zeros(self.pool_blocks, np.int32)
            self._slot_blocks: list = [[] for _ in range(slots)]
            self.pool_high_water = 0  # most blocks ever held at once
            self._live_dev = torch.from_numpy(self.live.copy()).to(self.device)
            self._live_dirty = False
        else:
            self.cache = tm.init_cache(cfg, slots, cache_len, device=self.device)
        # host tripwire for the alloc_blocks sum(need) <= n_free contract and
        # for refcount double-frees (tests/conftest.py arms it suite-wide)
        self._kv_debug = env_flag("RGL_KV_DEBUG")
        # prefix-sharing hooks, wired by the RAG layer: kv_pin_gate(entry) ->
        # bool before pinning, kv_pin_reclaim(want_blocks) -> freed under
        # pool pressure (cache pins go before any live request is truncated)
        self.kv_pin_gate = None
        self.kv_pin_reclaim = None
        self.kv_pins = 0  # entries that received a prompt-block pin
        self.kv_releases = 0  # pins released (eviction / reclaim)
        self.kv_pinned_blocks = 0  # blocks currently held by pins
        self.kv_shared_admits = 0  # admissions served by aliased blocks
        self.kv_reused_tokens = 0  # prompt tokens whose prefill was skipped
        self.kv_cow_copies = 0  # partial tail blocks copied at adoption
        self.cur_tok = torch.zeros((slots,), dtype=torch.int32, device=self.device)
        # per-slot token history for the drafter (prompt + every emitted
        # token, left-aligned; prompt < cache_len and decode stops at
        # cursor == cache_len bound it).  The host copy is written at
        # admission and uploaded once a wave; between admissions the device
        # copy evolves inside the spec step and the host copy follows it
        self._hist_cap = cache_len + 1
        self.hist = np.zeros((slots, self._hist_cap), np.int32)
        self.hist_len = np.zeros((slots,), np.int32)
        self._hist_dev = self._ids(self.hist)
        self._hist_len_dev = self._ids(self.hist_len)
        # host mirror of the device cursor: admission pins it to the prompt
        # length and every decode step advances it by the tokens committed,
        # so finish checks and the spec room never sync on the device cursor
        self._cursor = np.zeros((slots,), np.int64)
        # each slot's token budget and emitted count, mirrored on the
        # device for the spec step's room (uploaded at admission only)
        self._max_new = np.ones((slots,), np.int32)
        self._out_len = np.zeros((slots,), np.int32)
        self._max_new_dev = self._ids(self._max_new)
        self._out_len_dev = self._ids(self._out_len)
        self.prefill_batches = 0  # prefill dispatches issued by _admit
        self.prefill_rows = 0  # prompts actually prefilled
        self._admit_t = Totals(now_fn)  # rgl.decode.admit: time inside _admit
        self.decode_steps = 0  # decode dispatches
        self._decode_t = Totals(now_fn)  # rgl.decode.step: decode steps, token sync included
        self.slot_steps = 0  # live-slot decode opportunities (slots x steps)
        self.emitted_tokens = 0  # all tokens committed (incl. prefill firsts)
        self.decode_tokens = 0  # tokens committed by decode dispatches
        self.draft_proposed = 0  # draft tokens fed to verification
        self.draft_accepted = 0  # drafts accepted (the free token excluded)

    @property
    def admit_seconds(self) -> float:
        return self._admit_t.seconds

    @property
    def decode_seconds(self) -> float:
        return self._decode_t.seconds

    @property
    def free_slots(self) -> int:
        """Decode slots that remain free once the admission queue drains."""
        return max(0, int(self.slots - self.live.sum()) - len(self.queue))

    # -- paged-pool host bookkeeping ------------------------------------------
    @property
    def _free_host(self) -> int:
        """Free-stack depth (host mirror)."""
        return len(self._free_stack)

    def _blocks_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.block_size)

    def _ids(self, ids) -> torch.Tensor:
        return torch.from_numpy(np.asarray(ids, np.int32)).to(self.device)

    def _live_mask(self) -> torch.Tensor:
        """Device live mask, uploaded again only when liveness changed."""
        if self._live_dirty:
            self._live_dev = torch.from_numpy(self.live.copy()).to(self.device)
            self._live_dirty = False
        return self._live_dev

    def _guard_alloc(self, need_total: int, where: str) -> None:
        """``RGL_KV_DEBUG`` tripwire: a step that would pop more blocks than
        the stack holds would make two slots share a block on the device."""
        if self._kv_debug and need_total > len(self._free_stack):
            raise RuntimeError(
                f"paged-KV alloc invariant violated at {where}: dispatch would pop "
                f"{need_total} blocks but the free stack holds {len(self._free_stack)} "
                f"(pool_blocks={self.pool_blocks}, pinned={self.kv_pinned_blocks}, "
                f"live={int(self.live.sum())}, "
                f"per-slot blocks={[len(b) for b in self._slot_blocks]})"
            )

    def _pop_host(self, slot: int, n: int) -> list:
        """Replay ``n`` pops for ``slot`` on the host mirrors, in the device
        allocator's order (from the top of the stack)."""
        out = []
        for _ in range(n):
            blk = self._free_stack.pop()
            self._ref_host[blk] = 1
            self._slot_blocks[slot].append(blk)
            out.append(blk)
        return out

    def _host_release(self, drops: dict) -> int:
        """Replay refcount drops on the host mirrors: blocks reaching zero
        go back in ascending id (the device's order).  Returns blocks pushed."""
        pushed = []
        for blk in sorted(drops):
            r = int(self._ref_host[blk]) - drops[blk]
            if r < 0 and self._kv_debug:
                raise RuntimeError(
                    f"double-free of pool block {blk}: dropping {drops[blk]} holds but "
                    f"refcount is {int(self._ref_host[blk])} (pool_blocks={self.pool_blocks}, "
                    f"pinned={self.kv_pinned_blocks})"
                )
            self._ref_host[blk] = max(r, 0)
            if drops[blk] > 0 and r <= 0:
                pushed.append(blk)
        self._free_stack.extend(pushed)
        return len(pushed)

    def _free_slots_paged(self, slot_ids) -> None:
        """Drop the named slots' holds on their blocks (device and mirrors);
        blocks still shared or pinned stay with their other holders."""
        mask = np.zeros(self.slots, bool)
        mask[list(slot_ids)] = True
        self.cache = tm.free_slot_blocks(self.cache, torch.from_numpy(mask).to(self.device))
        drops: dict = {}
        for i in slot_ids:
            for blk in self._slot_blocks[i]:
                drops[blk] = drops.get(blk, 0) + 1
            self._slot_blocks[i] = []
        self._host_release(drops)
        self._live_dirty = True

    def _release_retired(self, live_before: np.ndarray) -> None:
        """Free the blocks of every slot that retired this step, at once."""
        retired = np.where(live_before & ~self.live)[0]
        if retired.size:
            self._free_slots_paged(retired.tolist())

    @property
    def _ntab(self) -> np.ndarray:
        """Per-slot allocated-block counts, from the block-id mirror."""
        return np.array([len(b) for b in self._slot_blocks], np.int64)

    def _paged_step_need(self) -> np.ndarray:
        """Per-slot blocks the next step's allocator pops, replayed on the
        host mirrors: a spec step writes up to ``draft_window`` rows."""
        w = self.draft_window if self.spec_decode else 1
        need = np.zeros(self.slots, np.int64)
        for i in range(self.slots):
            if self.live[i]:
                hi = min(int(self._cursor[i]) + w, self.cache_len)
                need[i] = max(self._blocks_for(hi) - len(self._slot_blocks[i]), 0)
        return need

    def _reclaim_pins(self, deficit: int) -> int:
        """Ask the cache tier to release pinned prompt blocks under pool
        pressure, before any truncation."""
        if self.kv_pin_reclaim is None or deficit <= 0:
            return 0
        return int(self.kv_pin_reclaim(int(deficit)))

    def _retire_pool_exhausted(self) -> list:
        """While the pool cannot cover every live slot's next allocation,
        first release cache pins, then retire the highest-indexed slot that
        needs a block (``truncated=True``) and reclaim its blocks."""
        finished = []
        need = self._paged_step_need()
        self._reclaim_pins(int(need.sum()) - self._free_host)
        while need.sum() > self._free_host:
            i = int(np.where(need > 0)[0][-1])
            req = self.active[i]
            req.done = True
            req.truncated = True
            self.truncations += 1
            finished.append(req)
            self.active[i] = None
            self.live[i] = False
            self._free_slots_paged([i])
            need[i] = 0
        return finished

    def _apply_paged_alloc(self) -> None:
        """Advance the host mirrors by what the step about to run pops."""
        need = self._paged_step_need()
        tot = int(need.sum())
        if tot:
            self._guard_alloc(tot, "decode step")
            for i in np.flatnonzero(need):
                self._pop_host(int(i), int(need[i]))
        self.pool_high_water = max(self.pool_high_water, self.pool_blocks - self._free_host)

    # -- prefix sharing: pins, plans, adoption --------------------------------
    def _acquire_host(self, ids) -> None:
        self.cache = tm.acquire_blocks(self.cache, self._ids(ids))
        for blk in ids:
            self._ref_host[int(blk)] += 1

    def _release_ids(self, ids) -> int:
        """Drop one hold per listed block (device and mirrors); returns how
        many blocks came back to the free stack."""
        self.cache = tm.release_blocks(self.cache, self._ids(ids))
        drops: dict = {}
        for blk in ids:
            drops[int(blk)] = drops.get(int(blk), 0) + 1
        return self._host_release(drops)

    def _pin_entry(self, entry, slot: int, req: Request, tok0: int) -> None:
        """Pin slot ``slot``'s freshly prefilled prompt blocks to ``entry``:
        one hold per block, the exact prompt and first token recorded, and
        a release hook the cache calls on eviction."""
        if getattr(entry, "kv_blocks", None) is not None:
            return  # already pinned (by a wave-mate or earlier)
        if self.kv_pin_gate is not None and not self.kv_pin_gate(entry):
            return  # no longer resident: a pin would leak its blocks
        n = len(req.prompt_ids)
        blocks = np.asarray(self._slot_blocks[slot][:self._blocks_for(n)], np.int32)
        if blocks.size == 0:
            return
        self._acquire_host(blocks)
        entry.kv_blocks = blocks
        entry.kv_len = n
        entry.kv_first_tok = int(tok0)
        entry.kv_prompt = np.asarray(req.prompt_ids, np.int32).copy()
        entry.kv_owner = self
        entry.kv_release = self._release_kv_pin
        self.kv_pins += 1
        self.kv_pinned_blocks += int(blocks.size)

    def _release_kv_pin(self, entry) -> int:
        """Release an entry's pin (eviction hook and pool-pressure reclaim).
        Idempotent; returns the blocks that came back to the free stack."""
        blocks = getattr(entry, "kv_blocks", None)
        if blocks is None:
            return 0
        entry.kv_blocks = None
        entry.kv_prompt = None
        entry.kv_owner = None
        entry.kv_release = None
        self.kv_releases += 1
        self.kv_pinned_blocks -= int(np.asarray(blocks).size)
        return self._release_ids(list(np.asarray(blocks)))

    def _plan_share(self, req: Request) -> Optional[_SharePlan]:
        """Validate ``req.shared_prefix`` against its pin (this pool, the
        same prompt) and snapshot it, taking one hold per donor block until
        adoption.  None (no holds) when the request must prefill."""
        entry = req.shared_prefix
        if entry is None:
            return None
        blocks = getattr(entry, "kv_blocks", None)
        if blocks is None or getattr(entry, "kv_owner", None) is not self:
            return None
        kp = getattr(entry, "kv_prompt", None)
        pi = np.asarray(req.prompt_ids, np.int32)
        if kp is None or len(kp) != len(pi) or not np.array_equal(kp, pi):
            return None
        n = int(entry.kv_len)
        blocks = np.asarray(blocks, np.int32)
        plan = _SharePlan(blocks=blocks, nfull=n // self.block_size,
                          tail=int(blocks[-1]) if n % self.block_size else -1, length=n,
                          first_tok=int(entry.kv_first_tok))
        self._acquire_host(blocks)
        return plan

    def _drop_plan(self, plan: _SharePlan) -> None:
        """Release a plan's holds without admitting it."""
        self._release_ids(list(plan.blocks))

    # -- admission -----------------------------------------------------------
    def submit(self, req: Request) -> None:
        if len(req.prompt_ids) >= self.cache_len:
            raise ValueError(
                f"prompt of {len(req.prompt_ids)} tokens cannot fit "
                f"cache_len={self.cache_len} (need room for >=1 new token)"
            )
        self.queue.append(req)

    def abort(self, reason: str = "aborted") -> list:
        """Retire every queued and live request (``failed=True``, partial
        ``out_tokens`` kept) and return live slots' paged blocks to the
        pool.  The engine is reusable afterwards.  Returns the aborted
        requests."""
        out = []
        live_idx = [i for i in range(self.slots) if self.live[i]]
        for i in live_idx:
            out.append(self.active[i])
            self.active[i] = None
            self.live[i] = False
        if self.paged_kv and live_idx:
            self._free_slots_paged(live_idx)
        out.extend(self.queue)
        self.queue.clear()
        for req in out:
            req.done = True
            req.failed = True
            req.error = reason
        return out

    def _admit(self) -> list:
        def queued_uids() -> str:  # the requests this admission may take
            free = self.slots - int(self.live.sum())
            return "uids=" + ",".join(str(r.uid) for r in list(self.queue)[:free])

        with span("rgl.decode.admit", self._admit_t, queued_uids):
            return self._admit_inner()

    def _paged_take(self, n_free_slots: int) -> tuple[int, dict]:
        """How many queued requests the pool admits now (FIFO: a head that
        does not fit blocks the rest), each needing ceil((L+1)/bs) blocks
        less any it aliases; pins are released before a request is refused.
        Returns (take, {queue position: _SharePlan})."""
        plans: dict = {}
        take = taken = 0
        for r in list(self.queue)[:n_free_slots]:
            full_need = self._blocks_for(min(len(r.prompt_ids) + 1, self.cache_len))
            plan = self._plan_share(r) if self.prefix_share else None
            need = full_need - plan.nfull if plan is not None else full_need
            if need > self._free_host - taken:
                self._reclaim_pins(need - (self._free_host - taken))
            if need > self._free_host - taken:
                if plan is not None:
                    self._drop_plan(plan)
                break
            if plan is not None:
                plans[take] = plan
            taken += need
            take += 1
        return take, plans

    def _admit_inner(self) -> list:
        """Refill free slots: one masked batched prefill for fresh prompts,
        one adoption for shared ones.  Returns the requests that finish AT
        admission (first token hits EOS, or ``max_new_tokens == 1``); they
        never occupy a live slot."""
        free = [i for i in range(self.slots) if not self.live[i]]
        if self.paged_kv:
            take, plans = self._paged_take(len(free))
        else:
            take, plans = min(len(free), len(self.queue)), {}
        if take == 0:
            return []
        reqs = [self.queue.popleft() for _ in range(take)]
        slot_ids = free[:take]
        t_admitted = self._now()
        first_by_slot = np.zeros(self.slots, np.int64)
        fresh_pairs = [(j, i) for j, i in enumerate(slot_ids) if j not in plans]
        if fresh_pairs:
            self._prefill_fresh(reqs, fresh_pairs, first_by_slot)
        if plans:
            self._adopt_shared(slot_ids, plans, first_by_slot)
        t_first = self._now()
        if self.paged_kv:
            self.pool_high_water = max(self.pool_high_water, self.pool_blocks - self._free_host)
        finished = []
        dead_at_admission = []
        for j, (req, i) in enumerate(zip(reqs, slot_ids)):
            req.t_admitted, req.t_first_token = t_admitted, t_first
            tok0 = int(first_by_slot[i])
            req.out_tokens.append(tok0)
            self.emitted_tokens += 1
            self._cursor[i] = len(req.prompt_ids)
            if self.prefix_share and j not in plans and req.pin_to is not None:
                self._pin_entry(req.pin_to, i, req, tok0)  # donor side
            hit_eos = self.eos_id is not None and tok0 == self.eos_id
            if hit_eos or len(req.out_tokens) >= req.max_new_tokens:
                # done at admission: the slot never goes live
                req.done = True
                finished.append(req)
                dead_at_admission.append(i)
                continue
            self.active[i] = req
            self.live[i] = True
            n = len(req.prompt_ids)
            self.hist[i, :n] = np.asarray(req.prompt_ids, np.int32)
            self.hist[i, n] = tok0
            self.hist_len[i] = n + 1
            self._max_new[i] = req.max_new_tokens
            self._out_len[i] = 1
        if self.paged_kv and dead_at_admission:
            self._free_slots_paged(dead_at_admission)
        if self.spec_decode:
            self._hist_dev = self._ids(self.hist)
            self._hist_len_dev = self._ids(self.hist_len)
            self._max_new_dev = self._ids(self._max_new)
            self._out_len_dev = self._ids(self._out_len)
        return finished

    def _prefill_fresh(self, reqs: list, fresh_pairs: list, first_by_slot: np.ndarray) -> None:
        """One batched prefill (batch padded to `slots` rows, lengths to a
        shared power-of-two bucket) merged into the arena."""
        bucket = _bucket_len(max(len(reqs[j].prompt_ids) for j, _ in fresh_pairs),
                             self.cache_len)
        toks = np.zeros((self.slots, bucket), np.int32)
        tl = np.zeros((self.slots,), np.int32)
        for f, (j, _) in enumerate(fresh_pairs):
            n = len(reqs[j].prompt_ids)  # submit() guarantees n < cache_len
            toks[f, :n] = np.asarray(reqs[j].prompt_ids, np.int32)
            tl[f] = n
        with span("rgl.decode.admit.prefill"):
            logits, fresh = tm.prefill(
                self.params, torch.from_numpy(toks).to(self.device),
                torch.from_numpy(tl).to(self.device), self.cfg, self.cache_len,
            )
            first = torch.argmax(logits, dim=-1).to(torch.int32)  # (slots,)
        self.prefill_batches += 1
        self.prefill_rows += len(fresh_pairs)
        rows = np.zeros(self.slots, np.int64)
        newly = np.zeros(self.slots, bool)
        tl_slot = np.zeros(self.slots, np.int32)
        for f, (_, i) in enumerate(fresh_pairs):
            rows[i], newly[i], tl_slot[i] = f, True, tl[f]
        with span("rgl.decode.admit.merge"):
            if self.paged_kv:
                self._guard_alloc(sum(self._blocks_for(int(t)) for t in tl_slot),
                                  "admission prefill merge")
                self.cache, self.cur_tok = _paged_merge_admitted(
                    self.cache, fresh, self.cur_tok, first, self._ids(rows),
                    torch.from_numpy(newly).to(self.device), self._ids(tl_slot), self.block_size,
                )
                for f, (_, i) in enumerate(fresh_pairs):  # slot order, as the device pops
                    self._pop_host(i, self._blocks_for(int(tl[f])))
                self._live_dirty = True
            else:
                self.cache, self.cur_tok = _merge_admitted(self.cache, fresh, self.cur_tok,
                                                           first, rows, newly)
        with span("rgl.decode.admit.first_token"):
            first_np = first.cpu().numpy()
        for f, (_, i) in enumerate(fresh_pairs):
            first_by_slot[i] = int(first_np[f])

    def _adopt_shared(self, slot_ids: list, plans: dict, first_by_slot: np.ndarray) -> None:
        """Alias each planned request's donor blocks into its slot (one
        ``tm.adopt_prefix_blocks`` call) and replay it on the mirrors: tail
        pops in slot order, then the release of the tail sources' holds."""
        mask = np.zeros(self.slots, bool)
        src_table = np.full((self.slots, self.max_blocks), -1, np.int32)
        length = np.zeros(self.slots, np.int32)
        tail = np.full(self.slots, -1, np.int32)
        firsts = np.zeros(self.slots, np.int32)
        for j, plan in plans.items():
            i = slot_ids[j]
            mask[i] = True
            src_table[i, :plan.nfull] = plan.blocks[:plan.nfull]
            length[i], tail[i], firsts[i] = plan.length, plan.tail, plan.first_tok
            first_by_slot[i] = plan.first_tok
        self._guard_alloc(int((tail >= 0).sum()), "prefix-share adopt")
        self.cache, self.cur_tok = tm.adopt_prefix_blocks(
            self.cache, self.cur_tok, torch.from_numpy(mask).to(self.device),
            self._ids(src_table), self._ids(length), self._ids(tail), self._ids(firsts),
            self.block_size,
        )
        tail_drops: dict = {}
        for j in sorted(plans):
            plan, i = plans[j], slot_ids[j]
            self._slot_blocks[i] = [int(b) for b in plan.blocks[:plan.nfull]]
            if plan.tail >= 0:
                self._pop_host(i, 1)
                tail_drops[plan.tail] = tail_drops.get(plan.tail, 0) + 1
                self.kv_cow_copies += 1
            self.kv_shared_admits += 1
            self.kv_reused_tokens += plan.length
        self._host_release(tail_drops)
        self._live_dirty = True

    def _hist_append(self, i: int, toks: list) -> None:
        hl = int(self.hist_len[i])
        n = min(len(toks), self._hist_cap - hl)
        if n > 0:
            self.hist[i, hl:hl + n] = toks[:n]
            self.hist_len[i] = hl + n

    def _finish_check(self, i: int, req: Request, last_tok: int, finished: list) -> None:
        hit_eos = self.eos_id is not None and last_tok == self.eos_id
        budget_full = len(req.out_tokens) >= req.max_new_tokens
        arena_full = self._cursor[i] >= self.cache_len
        if hit_eos or budget_full or arena_full:
            req.done = True
            if arena_full and not (hit_eos or budget_full):
                req.truncated = True
                self.truncations += 1
            finished.append(req)
            self.active[i] = None
            self.live[i] = False

    # -- one decode step for every live slot ----------------------------------
    def step(self) -> list:
        finished = self._admit()
        if self.paged_kv and self.live.any():
            finished.extend(self._retire_pool_exhausted())
        if not self.live.any():
            return finished
        finished.extend(self._step_spec() if self.spec_decode else self._step_one())
        return finished

    def _step_one(self) -> list:
        """One-token decode: one decode step emits one token per slot."""
        with span("rgl.decode.step", self._decode_t):
            if self.paged_kv:
                self._apply_paged_alloc()
                nxt, self.cache = tm.paged_serve_step(self.params, self.cache, self.cur_tok,
                                                      self._live_mask(), self.cfg,
                                                      self.block_size)
            else:
                nxt, self.cache = tm.serve_step(self.params, self.cache, self.cur_tok, self.cfg)
            self.cur_tok = nxt
            with span("rgl.decode.step.token_sync"):
                toks = nxt.cpu().numpy()
        self.decode_steps += 1
        self._cursor += 1  # decode_step advances every slot's cursor
        finished = []
        live_before = self.live.copy()
        for i, req in enumerate(self.active):
            if req is None or not self.live[i]:
                continue
            t = int(toks[i])
            req.out_tokens.append(t)
            self.emitted_tokens += 1
            self.decode_tokens += 1
            self.slot_steps += 1
            self._finish_check(i, req, t, finished)
        if self.paged_kv:
            self._release_retired(live_before)
        return finished

    def _step_spec(self) -> list:
        """Self-speculative decode: draft ``W - 1`` tokens per slot from its
        own history, verify them, and commit the greedy-matching prefix (1
        to W tokens a slot).  Dead slots run with the room their stale
        mirrors give (clamped to >= 1): their writes stay masked at the
        arena's edge (or, paged, are not made) and admission re-pins them."""
        w = self.draft_window
        with span("rgl.decode.step", self._decode_t):
            if self.paged_kv:
                self._apply_paged_alloc()
                (packed, self.cur_tok, self.cache, self._hist_dev, self._hist_len_dev,
                 self._out_len_dev) = _paged_spec_step(
                    self.params, self.cache, self.cur_tok, self._hist_dev, self._hist_len_dev,
                    self._max_new_dev, self._out_len_dev, self._live_mask(), self.cfg, w - 1,
                    self.eos_id, self.block_size)
            else:
                (packed, self.cur_tok, self.cache, self._hist_dev, self._hist_len_dev,
                 self._out_len_dev) = _spec_step(
                    self.params, self.cache, self.cur_tok, self._hist_dev, self._hist_len_dev,
                    self._max_new_dev, self._out_len_dev, self.cfg, w - 1, self.eos_id)
            with span("rgl.decode.step.token_sync"):  # the step's one host transfer
                packed_np = packed.cpu().numpy()
        self.decode_steps += 1
        g_np, acc_np = packed_np[:, :w], packed_np[:, w]
        self._cursor += acc_np  # verify_step advanced every slot by its accepted count
        self._out_len += acc_np
        finished = []
        live_before = self.live.copy()
        for i, req in enumerate(self.active):
            if req is None or not self.live[i]:
                continue
            a = int(acc_np[i])
            emitted = g_np[i, :a].tolist()
            req.out_tokens.extend(emitted)
            self.emitted_tokens += a
            self.decode_tokens += a
            self.slot_steps += 1
            self.draft_proposed += w - 1
            self.draft_accepted += a - 1
            self._hist_append(i, emitted)
            self._finish_check(i, req, emitted[-1], finished)
        if self.paged_kv:
            self._release_retired(live_before)
        return finished

    def decode_stats(self) -> dict:
        """Dispatch-amortization telemetry (the reference's keys, plus the
        wall time of decode steps).  ``tokens_per_step`` is the mean number
        of tokens a live slot commits a step: 1.0 in one-token mode, up to
        ``draft_window`` under speculation."""
        stats = {
            "spec_decode": self.spec_decode,
            "draft_window": self.draft_window if self.spec_decode else 1,
            "decode_steps": self.decode_steps,
            "decode_seconds": self.decode_seconds,
            "emitted_tokens": self.emitted_tokens,
            "decode_tokens": self.decode_tokens,
            "draft_proposed": self.draft_proposed,
            "draft_accepted": self.draft_accepted,
            "tokens_per_step": self.decode_tokens / max(self.slot_steps, 1),
            "draft_accept_rate": (self.draft_accepted / self.draft_proposed
                                  if self.draft_proposed else 0.0),
            "paged_kv": self.paged_kv,
            "truncations": self.truncations,
            "prefix_share": self.prefix_share,
            "prefill_batches": self.prefill_batches,
            "prefill_rows": self.prefill_rows,
            "admit_seconds": self.admit_seconds,
        }
        if self.paged_kv:
            stats.update(
                block_size=self.block_size,
                pool_blocks=self.pool_blocks,
                pool_high_water_blocks=self.pool_high_water,
                pool_free_blocks=self._free_host,
                kv_shared_admits=self.kv_shared_admits,
                kv_reused_tokens=self.kv_reused_tokens,
                kv_cow_copies=self.kv_cow_copies,
                kv_pins=self.kv_pins,
                kv_releases=self.kv_releases,
                kv_pinned_blocks=self.kv_pinned_blocks,
            )
        return stats

    def stats_ns(self) -> dict:
        return {"decode": self.decode_stats()}

    def run_to_completion(self, max_steps: int = 10_000) -> list:
        """Step until every request drains.  Raises if ``max_steps`` elapse
        with work still queued or live."""
        done = []
        for _ in range(max_steps):
            done.extend(self.step())
            if not self.queue and not self.live.any():
                return done
        raise RuntimeError(
            f"run_to_completion: work still pending after {max_steps} steps "
            f"({len(self.queue)} queued, {int(self.live.sum())} live slots)"
        )
