"""The program's ``rgl.*`` spans in a traced window, reduced to what ran on
the device inside each of them.

The program opens a ``torch.profiler.record_function`` range named
``rgl.<layer>.<what>`` around each phase of its serve and retrieval path
(``src/repro_torch/tracing.py``), so its spans are host events of the same
kineto trace as the kernels.  A device operation counts under every span
open around the runtime call that launched it; the two are matched by the
correlation id kineto gives both.  The reduction does not change
``trace.reduce``'s numbers: it reads the same events beside it.

For each span name: ``count`` (its ranges in the trace), ``wall_s`` (their
host time, summed), ``device_s`` (the device time of the operations
launched inside them, summed over operations) and ``idle_s`` (the time
inside the union of its ranges that no device operation covers).  Device
operations whose launch lies in no span go under ``unattributed``
(``count``, ``device_s``).
"""
from __future__ import annotations

import bisect

import torch

from perfbench.lib.trace import SPAN_PREFIX as _BENCH_PREFIX  # never device work
from perfbench.lib.trace import _union

PREFIX = "rgl."  # the program's spans


def _flag(e, name: str) -> bool:
    return bool(getattr(e, name, lambda: False)())


def _covered(intervals: list, busy: list, starts: list) -> int:
    """Nanoseconds of the (disjoint, sorted) ``intervals`` that the
    (disjoint, sorted) ``busy`` union covers; ``starts`` are busy's starts."""
    total = 0
    for a, b in intervals:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(busy) and busy[i][0] < b:
            lo, hi = max(a, busy[i][0]), min(b, busy[i][1])
            if hi > lo:
                total += hi - lo
            i += 1
    return total


def device_events(events) -> list:
    """(start_ns, end_ns, correlation id) of the device operations, as
    ``trace.reduce`` takes them: CUDA events that are neither user
    annotations nor ranges named by the benchmark or the program."""
    out = []
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name()
        if _flag(e, "is_user_annotation") or name.startswith((_BENCH_PREFIX, PREFIX)):
            continue
        out.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id()))
    return out


def reduce_spans(events) -> dict:
    """``{name: {count, wall_s, device_s, idle_s}}`` for every ``rgl.``
    span, and ``unattributed``, from a list of kineto events."""
    ranges, calls = [], {}
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA or _flag(e, "is_python_function"):
            continue
        a, b, name = e.start_ns(), e.start_ns() + e.duration_ns(), e.name()
        if name.startswith(PREFIX):
            ranges.append((a, b, name))
        elif name.startswith("cu") and e.correlation_id():
            calls[e.correlation_id()] = a  # a cuda* or cu* API call (a launch, copy or memset)
    dev = device_events(events)
    busy = _union([[a, b] for a, b, _ in dev])
    starts = [a for a, _ in busy]
    ranges.sort()
    range_starts = [a for a, _, _ in ranges]
    out: dict = {}
    by_name: dict = {}
    for a, b, name in ranges:
        by_name.setdefault(name, []).append([a, b])
    for name, iv in by_name.items():
        u = _union(iv)
        total = sum(b - a for a, b in u)
        out[name] = {"count": len(iv), "wall_s": sum(b - a for a, b in iv) / 1e9, "device_s": 0.0,
                     "idle_s": (total - _covered(u, busy, starts)) / 1e9}
    lost = {"count": 0, "device_s": 0.0}
    for a, b, corr in dev:
        t = calls.get(corr)
        names = set()
        if t is not None:
            j = bisect.bisect_right(range_starts, t)
            names = {ranges[k][2] for k in range(j) if ranges[k][1] >= t}
        if not names:
            lost["count"] += 1
            lost["device_s"] += (b - a) / 1e9
        for n in names:
            out[n]["device_s"] += (b - a) / 1e9
    out["unattributed"] = lost
    return out
