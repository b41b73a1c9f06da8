"""Each cell runs end to end on the CPU at a tiny size: its traffic mix
drives the program through a window, the end-to-end metrics (untraced)
and per-layer metrics (traced) come out, and the outputs check out."""
from __future__ import annotations

import math

import pytest
from conftest import ROOT

from perfbench.lib import spec

S = spec.Spec(ROOT)
CELLS = [c["name"] for c in S.data["workloads"]]


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_on_the_cpu(workload, trace, run_tiny):
    out = run_tiny(workload, seconds=1.0, trace=trace)
    assert out["correct"] is True
    assert out["attempted"] > 0 and out["failed"] == 0
    cell = S.cell(workload)
    want = {m["name"] for m in S.metrics(cell, trace)}
    # device readings exist only on the card: the traced run's device
    # metrics stay out of a CPU run's line, everything else is there
    device_only = {m["name"] for m in S.metrics(cell, trace) if m["source"] == "device_trace"}
    assert want - device_only <= set(out["metrics"]) <= want
    for m in out["metrics"].values():
        assert math.isfinite(m["value"])
    assert list(out)[-1] == "checks"
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_same_seed_same_queries():
    import numpy as np

    from perfbench.lib.queries import query_sampler

    t = S.traffic(S.cell(CELLS[0]))
    a = query_sampler(np.random.default_rng(2**33 + 5), 1000, t)(50)
    b = query_sampler(np.random.default_rng(2**33 + 5), 1000, t)(50)
    c = query_sampler(np.random.default_rng(2**33 + 6), 1000, t)(50)
    assert (a == b).all() and not (a == c).all()
