"""On the card (``pytest -m cuda perfbench/tests``): each cell's run.py
prints a result line whose checks hold, at a short window.  Skips
without a card, decided inside the fixture."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import ROOT

from perfbench.lib import spec

CELLS = [c["name"] for c in spec.Spec(ROOT).data["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(card, workload):
    out = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
                          workload, "--seed", str(2**31 + 101), "--seconds", "5", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
