"""Fault-tolerance monitors that the training loop feeds every step (the
port's copy of ``StragglerMonitor`` and ``Heartbeat`` from the reference's
``repro.distributed.fault``):

* StragglerMonitor — windowed step-time tracker; flags hosts whose mean step
  time exceeds ``threshold x`` the fleet median.
* Heartbeat — liveness registry; a host missing ``max_missed`` beats of
  ``interval_s`` is declared dead.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Optional


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
