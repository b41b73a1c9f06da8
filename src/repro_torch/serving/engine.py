"""Batched serving engine: continuous batching over fixed decode slots.

A fixed (B, cache_len) KV arena; each of the B slots holds one in-flight
request.  Every engine step runs one decode step for all slots
(``tm.serve_step``).  Admission is batched: all free slots are refilled by
one masked batched prefill — prompts padded to a shared power-of-two length
bucket, run through one ``tm.prefill`` call — and the fresh cache rows are
copied into the arena.

Only the contiguous arena with one-token decode is ported; speculative
decode and the paged arena raise (ROADMAP Queue 1 items 10 and 11).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.transformer import model as tm
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.serving.config import env_flag


@dataclasses.dataclass
class Request:
    uid: int
    prompt_ids: np.ndarray  # (L,) int32
    max_new_tokens: int = 32
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    # retired early by KV exhaustion (arena full): out_tokens is shorter
    # than max_new_tokens and did not end at EOS
    truncated: bool = False
    # retired by ServeEngine.abort(): tokens emitted so far are kept
    failed: bool = False
    error: Optional[str] = None
    # monotonic admission ticket assigned by the submitting front-end
    ticket: int = -1


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
    arena.k[:, dst] = new.k[:, src]
    arena.v[:, dst] = new.v[:, src]
    arena.pos[dst] = new.pos[src]
    arena.cursor[dst] = new.cursor[src]
    cur_tok = cur_tok.clone()
    cur_tok[dst] = first[src]
    return arena, cur_tok


class ServeEngine:
    """Continuous-batching decode server over a fixed KV arena.

    Usage::

        eng = ServeEngine(params, cfg, slots=8, cache_len=512, device="cuda")
        eng.submit(Request(uid=0, prompt_ids=ids, max_new_tokens=32))
        finished = eng.run_to_completion()
    """

    def __init__(
        self, params, cfg: TransformerConfig, *, slots: int = 8,
        cache_len: int = 512, eos_id: Optional[int] = None,
        spec_decode: Optional[bool] = None, paged_kv: Optional[bool] = None,
        prefix_share: Optional[bool] = None, device="cuda",
    ):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the engine on {self.device}")
        for name, flag, env, item in (
            ("spec_decode", spec_decode, "RGL_SPEC_DECODE", "11 (speculative decode)"),
            ("paged_kv", paged_kv, "RGL_PAGED_KV", "10 (paged KV)"),
            ("prefix_share", prefix_share, "RGL_PREFIX_SHARE", "10 (prefix sharing)"),
        ):
            if (env_flag(env) if flag is None else flag):
                raise NotImplementedError(f"{name} is not ported yet: ROADMAP Queue 1 item {item}")
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.cache_len = cache_len
        self.eos_id = eos_id
        self.queue: deque = deque()
        self.active: list = [None] * slots
        self.live = np.zeros(slots, bool)
        self.truncations = 0  # requests retired by KV exhaustion
        self.cache = tm.init_cache(cfg, slots, cache_len, device=self.device)
        self.cur_tok = torch.zeros((slots,), dtype=torch.int32, device=self.device)
        # host mirror of the device cursor: admission pins it to the prompt
        # length and every decode step advances it, so finish checks never
        # sync on the device cursor
        self._cursor = np.zeros((slots,), np.int64)
        self.prefill_batches = 0  # prefill dispatches issued by _admit
        self.prefill_rows = 0  # prompts actually prefilled
        self.admit_seconds = 0.0  # wall time inside _admit
        self.decode_steps = 0  # decode dispatches
        self.decode_seconds = 0.0  # wall time of decode steps, token sync included
        self.slot_steps = 0  # live-slot decode opportunities (slots x steps)
        self.emitted_tokens = 0  # all tokens committed (incl. prefill firsts)
        self.decode_tokens = 0  # tokens committed by decode dispatches

    @property
    def free_slots(self) -> int:
        """Decode slots that remain free once the admission queue drains."""
        return max(0, int(self.slots - self.live.sum()) - len(self.queue))

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
        ``out_tokens`` kept).  The engine is reusable afterwards.  Returns
        the aborted requests."""
        out = []
        for i in range(self.slots):
            if self.live[i]:
                out.append(self.active[i])
                self.active[i] = None
                self.live[i] = False
        out.extend(self.queue)
        self.queue.clear()
        for req in out:
            req.done = True
            req.failed = True
            req.error = reason
        return out

    def _admit(self) -> list:
        t0 = time.perf_counter()
        try:
            return self._admit_inner()
        finally:
            self.admit_seconds += time.perf_counter() - t0

    def _admit_inner(self) -> list:
        """Refill free slots with one masked batched prefill.  Returns the
        requests that finish AT admission (first token hits EOS, or
        ``max_new_tokens == 1``); they never occupy a live slot."""
        free = [i for i in range(self.slots) if not self.live[i]]
        take = min(len(free), len(self.queue))
        if take == 0:
            return []
        reqs = [self.queue.popleft() for _ in range(take)]
        slot_ids = free[:take]
        # one batched prefill: batch padded to `slots` rows, lengths padded
        # to a shared power-of-two bucket
        bucket = _bucket_len(max(len(r.prompt_ids) for r in reqs), self.cache_len)
        toks = np.zeros((self.slots, bucket), np.int32)
        tl = np.zeros((self.slots,), np.int32)
        for f, r in enumerate(reqs):
            toks[f, :len(r.prompt_ids)] = np.asarray(r.prompt_ids, np.int32)
            tl[f] = len(r.prompt_ids)
        logits, fresh = tm.prefill(
            self.params, torch.from_numpy(toks).to(self.device),
            torch.from_numpy(tl).to(self.device), self.cfg, self.cache_len,
        )
        self.prefill_batches += 1
        self.prefill_rows += take
        first = torch.argmax(logits, dim=-1).to(torch.int32)  # (slots,)
        rows = np.zeros(self.slots, np.int64)
        newly = np.zeros(self.slots, bool)
        for f, i in enumerate(slot_ids):
            rows[i] = f
            newly[i] = True
        self.cache, self.cur_tok = _merge_admitted(
            self.cache, fresh, self.cur_tok, first, rows, newly
        )
        first_np = first.cpu().numpy()
        finished = []
        for f, (req, i) in enumerate(zip(reqs, slot_ids)):
            tok0 = int(first_np[f])
            req.out_tokens.append(tok0)
            self.emitted_tokens += 1
            self._cursor[i] = len(req.prompt_ids)
            hit_eos = self.eos_id is not None and tok0 == self.eos_id
            if hit_eos or len(req.out_tokens) >= req.max_new_tokens:
                # done at admission: the arena row was written but the slot
                # never goes live, so the next wave simply reuses it
                req.done = True
                finished.append(req)
                continue
            self.active[i] = req
            self.live[i] = True
        return finished

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
        if not self.live.any():
            return finished
        finished.extend(self._step_one())
        return finished

    def _step_one(self) -> list:
        """One-token decode: one decode step emits one token per slot."""
        t0 = time.perf_counter()
        nxt, self.cache = tm.serve_step(self.params, self.cache, self.cur_tok, self.cfg)
        self.cur_tok = nxt
        toks = nxt.cpu().numpy()  # the step's one host sync
        self.decode_seconds += time.perf_counter() - t0
        self.decode_steps += 1
        self._cursor += 1  # decode_step advances every slot's cursor
        finished = []
        for i, req in enumerate(self.active):
            if req is None or not self.live[i]:
                continue
            t = int(toks[i])
            req.out_tokens.append(t)
            self.emitted_tokens += 1
            self.decode_tokens += 1
            self.slot_steps += 1
            self._finish_check(i, req, t, finished)
        return finished

    def decode_stats(self) -> dict:
        """Dispatch-amortization telemetry (the reference's keys; the
        speculative and paged ones at their one-token, contiguous values)."""
        return {
            "spec_decode": False,
            "draft_window": 1,
            "decode_steps": self.decode_steps,
            "decode_seconds": self.decode_seconds,
            "emitted_tokens": self.emitted_tokens,
            "decode_tokens": self.decode_tokens,
            "draft_proposed": 0,
            "draft_accepted": 0,
            "tokens_per_step": self.decode_tokens / max(self.slot_steps, 1),
            "draft_accept_rate": 0.0,
            "paged_kv": False,
            "truncations": self.truncations,
            "prefix_share": False,
            "prefill_batches": self.prefill_batches,
            "prefill_rows": self.prefill_rows,
            "admit_seconds": self.admit_seconds,
        }

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
