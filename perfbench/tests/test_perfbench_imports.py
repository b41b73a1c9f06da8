"""Nothing under perfbench/ imports JAX, the JAX package or the JAX-era
benchmarks (top-level names compared whole: ``repro_torch`` is not
``repro``), the references import nothing of the program, and a run
leaves none of them loaded."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest
from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
FILES = sorted(p for p in (ROOT / "perfbench").rglob("*.py") if "__pycache__" not in p.parts)


def top_imports(path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_forbidden_import(path):
    assert not top_imports(path) & FORBIDDEN


YARDSTICK = [p for p in FILES if "reference" in p.parts or "counts" in p.parts]


@pytest.mark.parametrize("path", YARDSTICK, ids=lambda p: p.name)
def test_yardstick_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_imports(path)


def test_a_run_loads_none_of_them(tmp_path):
    code = f"""
import sys, time
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
sys.path.insert(0, {str(ROOT / 'perfbench' / 'tests')!r})
from perfbench.lib import env, harness
from conftest import tiny
w = "retrieve.starcoder2-3b.q256"
harness.run_cell({str(ROOT)!r}, w, 7, 0.3, True, "cpu", time.time(), {str(tmp_path)!r},
                 overrides=tiny(w), log=lambda s: None)
loaded = {{m.split('.')[0] for m in sys.modules}}
print(sorted(loaded & set({sorted(FORBIDDEN)!r})), env.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] []"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from perfbench.lib import env

    before = set(env.forbidden_modules())
    monkeypatch.setitem(sys.modules, "reprox", sys)
    monkeypatch.setitem(sys.modules, "repro_torch.fake", sys)
    assert set(env.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert "flax" in env.forbidden_modules()


def test_run_refuses_without_a_card_or_the_program(tmp_path):
    """Without a card (a CPU-only machine), and in a directory that holds only
    BENCHMARK.json and perfbench/, run.py exits non-zero and prints no
    result line."""
    import shutil

    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for root in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, str(root / "perfbench" / "run.py"), "--workload",
                              "retrieve.starcoder2-3b.q256", "--seed", "1", "--seconds", "1",
                              "--trace", "0"], capture_output=True, text=True, cwd=root,
                             timeout=300)
        assert out.returncode != 0 and not out.stdout.strip()
