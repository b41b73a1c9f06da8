"""The control comes out not correct.

The control is the reference computed one precision below the
configuration's, in the program's place: float8 e4m3 weights (a scale per
output column) for the bf16 decoder, bfloat16 relevance scores for the
retrieval.  On the card it was read at each cell's own size (``python3
perfbench/readings.py --control``); here it runs at a size a test can
hold, over the answers of a short CPU run: the program's numbers stay
within the cell's limits and the control fails at least one of them on
every seed."""
from __future__ import annotations

import pytest
import torch
from conftest import ROOT, tiny

from perfbench.lib import harness, spec

S = spec.Spec(ROOT)
CELLS = [c["name"] for c in S.data["workloads"]]
WIDER = {"n_layers": 4, "d_model": 256, "n_heads": 8, "n_kv_heads": 2, "d_head": 32,
         "d_ff": 1024}


def failed_by_control(checks: dict, info: dict) -> list:
    """The compared numbers whose limit the control's reading exceeds."""
    out = []
    for name, c in checks.items():
        ctl = info.get("control_" + name.removeprefix("served_"))
        if ctl is not None and ctl > c["limit"]:
            out.append(name)
    return out


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_comparison(workload, cache_dir):
    over = tiny(workload)
    if "model" in over["config"]:
        over["config"]["model"].update({k: v for k, v in WIDER.items()
                                        if k != "d_ff" or over["config"]["model"]["d_ff"]})
        over["traffic"].update(check_requests=16, max_new_tokens=8)
    else:
        over["traffic"].update(check_queries=32)
    s, cell, _, _, drv = harness.setup(ROOT, workload, torch.device("cpu"), cache_dir, over)
    limits = s.limits(cell)
    for seed in (2**31 + 1, 2**32 + 7, 2**33 + 9):
        rec = drv.run(seed, 2.0, False)
        v = drv.check(rec, seed, limits, control=True)
        assert v["correct"], v
        assert failed_by_control(v["checks"], v["info"]), v
