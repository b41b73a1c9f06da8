#!/usr/bin/env python3
"""Readings for a cell's limits: the program's comparison numbers and the
control's, over many seeds in one process.

    python3 perfbench/readings.py --workload <name> --seeds 1,2,3 --seconds 8 [--control]

The cell's stack is built once; each seed makes its own weights and
queries, runs a short window at the cell's own load, and is checked as a
run checks it.  With ``--control`` the same answers are also read by the
control: the reference computed one precision below the configuration's
(float8 e4m3 weights for the bf16 decoder, bfloat16 scores for the
retrieval), in the program's place.  One JSON line a seed.  The benchmark's
own runs never run the control.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.lib import env  # noqa: E402

CACHE_DIR = env.setup(ROOT)


def main(argv=None) -> int:
    import argparse

    import torch

    from perfbench.lib import harness, spec

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    s, cell, _, _, drv = harness.setup(ROOT, args.workload, dev, CACHE_DIR)
    limits = s.limits(cell)
    print(json.dumps({"card": harness.card_line(dev)}), flush=True)
    for seed in [int(x) for x in args.seeds.split(",")]:
        rec = drv.run(seed, args.seconds, False)
        n = rec["attempted"]
        v = drv.check(rec, seed, limits, control=args.control)
        print(json.dumps({"seed": seed, "correct": v["correct"], "units": n,
                          "window_s": rec["window_s"],
                          "checks": {k: c["value"] for k, c in v["checks"].items()},
                          "info": v["info"]}), flush=True)
        del rec
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
