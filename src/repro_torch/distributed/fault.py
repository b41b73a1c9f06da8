"""Fault tolerance and elasticity (the port's copy of the reference's
``repro.distributed.fault``; pure Python, no device):

* StragglerMonitor — windowed step-time tracker; flags hosts whose mean step
  time exceeds ``threshold x`` the fleet median.
* Heartbeat — liveness registry; a host missing ``max_missed`` beats of
  ``interval_s`` is declared dead.
* elastic_shard_assignment — deterministic data-shard -> host map by
  rendezvous hashing, so a host-set change moves only the departed hosts'
  shards.  It hashes ``(shard, host)`` with Python's ``hash()``: stable
  across processes for int hosts, salted per process for str hosts.
* run_with_restart — crash-restart driver: wraps a step function and
  restores from the newest checkpoint after a failure.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Callable, Optional


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 2.0
    window: int = 16
    _times: dict = dataclasses.field(default_factory=lambda: defaultdict(deque))

    def record(self, host: int, step_time: float) -> None:
        dq = self._times[host]
        dq.append(step_time)
        if len(dq) > self.window:
            dq.popleft()

    def median_time(self) -> Optional[float]:
        means = [sum(d) / len(d) for d in self._times.values() if d]
        if not means:
            return None
        means.sort()
        return means[len(means) // 2]

    def stragglers(self) -> list:
        med = self.median_time()
        if med is None:
            return []
        return [
            h for h, d in self._times.items()
            if d and (sum(d) / len(d)) > self.threshold * med
        ]


@dataclasses.dataclass
class Heartbeat:
    max_missed: int = 3
    interval_s: float = 10.0
    _last: dict = dataclasses.field(default_factory=dict)

    def beat(self, host: int, now: Optional[float] = None) -> None:
        self._last[host] = time.monotonic() if now is None else now

    def dead_hosts(self, now: Optional[float] = None) -> list:
        now = time.monotonic() if now is None else now
        return [
            h for h, t in self._last.items()
            if now - t > self.max_missed * self.interval_s
        ]


def elastic_shard_assignment(n_shards: int, hosts: list) -> dict:
    """Deterministic shard->host map, stable under host-set changes
    (rendezvous hashing): only shards owned by departed hosts move."""
    assign = {}
    for s in range(n_shards):
        best, best_h = None, None
        for h in hosts:
            w = hash((s, h)) & 0xFFFFFFFF
            if best is None or w > best:
                best, best_h = w, h
        assign[s] = best_h
    return assign


def run_with_restart(
    step_fn: Callable,  # (state, step) -> state ; may raise
    save_fn: Callable,  # (state, step) -> None
    restore_fn: Callable,  # () -> (state, step)
    state,
    n_steps: int,
    checkpoint_every: int = 10,
    max_restarts: int = 3,
):
    """Crash-restart training driver.  On any exception: restore from the
    newest checkpoint and continue; give up after max_restarts."""
    step = 0
    restarts = 0
    while step < n_steps:
        try:
            state = step_fn(state, step)
            step += 1
            if step % checkpoint_every == 0:
                save_fn(state, step)
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
            state, step = restore_fn()
    return state, restarts
