#!/usr/bin/env python3
"""Runs of one cell, read by the metric readers under ``perfbench/metrics/``
that ``BENCHMARK.json`` does not list yet, with the program's ``rgl.*``
spans reduced beside the benchmark's own trace reduction.

    python3 perfbench/trace_spans.py --workload <name> --seeds 1,2,3 --seconds <s> --trace 0|1

From the root of a checkout, on a card.  The cell's stack is built once;
each seed runs the window as ``run.py`` runs it and is checked as a run is
checked.  With ``--trace 1`` the window's last seconds are traced and the
trace's events are also handed to ``perfbench/lib/spans.py``, so the
record's ``trace`` carries ``spans``, which the benchmark's own runs do
not carry yet.  Read the request-time readers in untraced runs: in a traced
one every request of the window waits out the profiler's start.

One JSON line a seed: ``correct``, ``readings`` (``{metric: value}`` of
each unlisted reader that finds something to read in the record) and,
traced, ``spans`` (``{name: {count, wall_s, device_s, idle_s}}`` and
``unattributed``), ``unattributed_share`` (of the traced busy time, in %),
``busy_s`` and ``window_s``.  The script goes once ``trace.reduce``
returns the spans itself and ``BENCHMARK.json`` lists these readers.
"""
from __future__ import annotations

import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def unlisted(s) -> list:
    """Names of the readers in ``metrics/`` that ``BENCHMARK.json`` lists
    under no metric."""
    listed = {m["name"] for m in s.data["end_to_end"] + s.data["per_layer"]}
    return sorted(n for n in (p.name[:-3] for p in (s.pb / "metrics").glob("*.py"))
                  if n not in listed)


def readings(s, rec: dict) -> dict:
    """``{metric: value}`` of the unlisted readers that read a finite value."""
    out = {}
    for name in unlisted(s):
        v = s.reader(name)(rec)
        if v is not None and math.isfinite(v):
            out[name] = v
    return out


def reduce_with_spans(plain):
    """``trace.reduce`` (``plain``) whose summary also carries ``spans``."""
    from perfbench.lib import spans

    return lambda events, window_s: dict(plain(events, window_s),
                                         spans=spans.reduce_spans(events))


def runs(workload: str, seeds: list, seconds: float, trace: bool, device, cache_dir):
    """One line (see the module's docstring) a seed."""
    from perfbench.lib import harness
    from perfbench.lib import trace as tr

    s, cell, _, _, drv = harness.setup(ROOT, workload, device, cache_dir)
    limits = s.limits(cell)
    plain = tr.reduce
    tr.reduce = reduce_with_spans(plain)
    try:
        for seed in seeds:
            rec = drv.run(seed, seconds, trace)
            line = {"workload": workload, "seed": seed, "trace": int(trace),
                    "correct": drv.check(rec, seed, limits)["correct"],
                    "readings": readings(s, rec)}
            t = rec["trace"]
            if t:
                lost = t["spans"]["unattributed"]["device_s"]
                line.update(spans=t["spans"], busy_s=t["busy_s"], window_s=t["window_s"],
                            unattributed_share=100.0 * lost / t["busy_s"] if t["busy_s"]
                            else None)
            yield line
    finally:
        tr.reduce = plain


def main(argv=None) -> int:
    import argparse
    import json

    from perfbench.lib import env

    cache_dir = env.setup(ROOT)  # before torch is imported
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    import torch

    for line in runs(args.workload, [int(x) for x in args.seeds.split(",")], args.seconds,
                     bool(args.trace), torch.device(args.device), cache_dir):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
