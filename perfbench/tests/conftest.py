"""Shared set-up of the benchmark's CPU tests: the harness on the CPU at a
tiny size (a 3,000-node corpus, two-layer decoders, 8 slots), with the
corpus cached under pytest's temporary directory."""
from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

TINY_MODEL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_head": 16,
              "d_ff": 128}
TINY_MOE = {"d_ff": 0, "sliding_window": None,
            "moe": {"n_experts": 32, "top_k": 8, "d_ff": 32, "capacity_factor": 4.0}}


def tiny(workload: str) -> dict:
    """Overrides that shrink a cell to a CPU test's size (widths, depth,
    corpus and load; never the comparison's limits)."""
    from perfbench.lib import spec

    s = spec.Spec(ROOT)
    cell = s.cell(workload)
    kind = s.traffic(cell)["kind"]
    cfg = s.config(cell)
    over = {"config": {"corpus": {"nodes": 3000}}}
    if kind == "rag_serve_closed_loop":
        model = dict(TINY_MODEL)
        if cfg["model"].get("moe"):
            model.update(TINY_MOE)
        elif cfg["model"].get("sliding_window"):
            model["sliding_window"] = 16
        over["config"]["model"] = model
        over["traffic"] = {"slots": 8, "clients": 12, "max_new_tokens": 4, "check_requests": 3,
                           "trace_seconds": 0.5}
    elif kind == "retrieve_batches":
        over["traffic"] = {"batch": 16, "check_queries": 8, "trace_seconds": 0.5}
    return over


@pytest.fixture(scope="session")
def cache_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("perfbench_cache")


@pytest.fixture
def run_tiny(cache_dir):
    """run_tiny(workload, seconds=1.0, trace=False, seed=...) -> result dict,
    on the CPU: the harness's look for a card is skipped, the rest of a
    run is driven as on the card."""
    from perfbench.lib import harness

    def go(workload, seconds=1.0, trace=False, seed=2**31 + 11, root=ROOT, over=None):
        return harness.run_cell(root, workload, seed, seconds, trace, "cpu", time.time(),
                                cache_dir, overrides=over or tiny(workload), log=lambda s: None)

    return go
