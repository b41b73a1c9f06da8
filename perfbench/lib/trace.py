"""The traced run's device timeline: ``torch.profiler`` over part of the
measured window, reduced to busy time, time by device operation, and the
idle gaps labelled by what the host was doing.

Device operations are the trace's CUDA events (kernels, copies, memsets)
other than user annotations; busy time is the length of their union.  An
idle gap is a stretch of the traced window that no device operation
covers; its label is the innermost host-side event (an ATen operator, a
CUDA runtime call or one of the benchmark's own ``pb.*`` ranges) running
at its middle, or ``host`` where none is.  A trace that comes back
without device events (the profiler sometimes records none) is taken
again past the window.
"""
from __future__ import annotations

import bisect
import time

import torch

SPAN_PREFIX = "pb."  # the benchmark's own record_function ranges


def span(name: str):
    """A host range in the trace, named ``pb.<name>``."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


class Tracer:
    """Profiles from ``start`` until ``stop``; ``summary`` reduces the
    trace.  Without a card it records host events only."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.t0 = self.t1 = None
        self.tries = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self) -> None:
        """Profile one small operation, so that the profiler's first start
        (CUPTI's set-up) falls into set-up and not into the window."""
        self.start()
        torch.ones(1, device=self.device).add_(1)
        self.stop()
        self.tries = 0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        self.tries += 1

    def stop(self) -> dict:
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        out = reduce(self.prof.profiler.kineto_results.events(), self.t1 - self.t0)
        self.prof = None
        return out

    def finish(self, work, seconds: float) -> dict:
        """Stop; a trace that holds no device events is taken again (four
        tries in all) over ``seconds`` of ``work()`` calls past the window,
        and so is one that never started (a window of fewer steps than the
        trace's share of it)."""
        out = self.stop() if self.prof is not None else None
        while out is None or (self.device.type == "cuda" and not out["n_device_events"]
                              and self.tries < 4):
            self.start()
            while time.perf_counter() - self.t0 < seconds:
                work()
            out = self.stop()
        return out


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without its argument list (cut at the first '('
    outside template brackets, braces and ``(anonymous namespace)``), at
    most ``width`` characters."""
    name = name.replace("(anonymous namespace)", "{anonymous}")
    depth = 0
    for i, ch in enumerate(name):
        if ch in "<{":
            depth += 1
        elif ch in ">}":
            depth -= 1
        elif ch == "(" and depth == 0 and i:
            name = name[:i].rstrip()
            break
    return name[:width]


def _union(spans: list) -> list:
    out: list = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events, window_s: float) -> dict:
    """Busy seconds, device seconds by operation name, kernel launches by
    name, and idle gaps by host label, from a list of kineto events."""
    dev, host = [], []
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if getattr(e, "is_user_annotation", lambda: False)() or name.startswith(SPAN_PREFIX):
                continue
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), short_name(name)))
        elif not getattr(e, "is_python_function", lambda: False)():
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    by_name: dict = {}
    calls: dict = {}
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
        calls[name] = calls.get(name, 0) + 1
    busy = _union([[a, b] for a, b, _ in dev])
    busy_s = sum(b - a for a, b in busy) / 1e9
    gaps: dict = {}
    if busy:
        lo = min([a for a, _, _ in host] + [busy[0][0]])
        hi = max([b for _, b, _ in host] + [busy[-1][1]])
        edges = [lo] + [x for ab in busy for x in ab] + [hi]
        host.sort()
        starts = [a for a, _, _ in host]
        for i in range(0, len(edges), 2):
            a, b = edges[i], edges[i + 1]
            if b <= a:
                continue
            mid = (a + b) / 2
            label, width = "host", None
            j = bisect.bisect_right(starts, mid)
            for k in range(j - 1, max(-1, j - 400), -1):  # the innermost covering event
                s, e, name = host[k]
                if e >= mid and (width is None or e - s < width):
                    label, width = name, e - s
            gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e9
    return {"window_s": window_s, "busy_s": busy_s, "device_ops": by_name, "launches": calls,
            "idle_gaps": gaps, "n_device_events": len(dev)}


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
