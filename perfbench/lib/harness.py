"""One run of one cell: build the driver the cell's traffic names, measure
the window, read the cell's metrics, check the outputs, and assemble the
result line.

A driver is ``perfbench/drivers/<kind>.py``, found by the ``kind`` of the
cell's traffic file; its ``Driver(cfg, traffic, device, cache_dir)`` has
``run(seed, seconds, trace) -> record`` and ``check(record, seed, limits,
control=False) -> verdict``.  The record holds ``window_start`` (on
``time.time()``'s clock), ``window_s``, ``attempted``, ``failed``,
``memory_peak_bytes`` and ``trace`` (the tracer's summary or None), and
whatever the kind's metric readers read; the verdict holds ``correct``,
``checks`` (each number compared with its limit) and ``info``."""
from __future__ import annotations

import math
import subprocess
import sys

import torch

from perfbench.lib import spec as sp
from perfbench.lib import stack as st
from perfbench.lib import trace as tr


def card_line(device: torch.device) -> str:
    """The card's name and power limit (the published peaks assume 700 W)."""
    if device.type != "cuda":
        return "no card"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or torch.cuda.get_device_name(device)


def setup(root, workload: str, device: torch.device, cache_dir, overrides=None):
    """(spec, cell, configuration, traffic, driver instance)."""
    spec = sp.Spec(root)
    cell = spec.cell(workload)
    overrides = overrides or {}
    cfg = st.apply(spec.config(cell), overrides.get("config"))
    traffic = st.apply(spec.traffic(cell), overrides.get("traffic"))
    return spec, cell, cfg, traffic, spec.driver(traffic["kind"])(cfg, traffic, device, cache_dir)


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool, device,
             process_start: float, cache_dir, overrides=None, log=None) -> dict:
    """The result line's dict.  ``process_start`` is the process's start on
    ``time.time()``'s clock; ``log`` prints a line to standard error."""
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    device = torch.device(device)
    log(f"card: {card_line(device)}")
    spec, cell, cfg, traffic, drv = setup(root, workload, device, cache_dir, overrides)
    rec = drv.run(seed, seconds, trace)
    rec["setup_s"] = rec["window_start"] - process_start
    metrics = {}
    for m in spec.metrics(cell, trace):
        v = spec.reader(m["name"])(rec)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    breakdown = None
    if trace and rec["trace"]:
        t = rec["trace"]
        dev["busy_s"], dev["window_s"] = t["busy_s"], t["window_s"]
        breakdown = {"device_ops": tr.top(t["device_ops"]), "idle_gaps": tr.top(t["idle_gaps"])}
    verdict = drv.check(rec, seed, spec.limits(cell))
    for k, v in verdict["info"].items():
        log(f"check info: {k} {v}")
    out = {"correct": verdict["correct"], "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": dev}
    if breakdown:
        out["breakdown"] = breakdown
    out["checks"] = verdict["checks"]
    return out
