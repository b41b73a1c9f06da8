"""The port stands alone: no module of ``repro_torch`` loads JAX or the
reference package, and its entry points never fall back to the CPU."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax", "optax"))
assert not bad, bad
print(len(names))
"""


_IMPORT_ONE = """
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax", "optax"))
assert not bad, bad
"""


@pytest.mark.parametrize("module", ["core.naive", "core.rouge", "core.generation",
                                    "configs.rgl_paper", "serving.drafter",
                                    "serving.engine", "serving.rag_engine",
                                    "serving.simulate", "serving.router"])
def test_module_alone_imports_neither_jax_nor_the_reference(module):
    """Each host-copied module (and the engines that use the drafter),
    imported on its own in a fresh interpreter, loads no JAX and nothing of
    ``repro``: its own imports carry no copy of the reference."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_ONE, f"repro_torch.{module}"],
                         env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    src = (ROOT / "src" / "repro_torch" / (module.replace(".", "/") + ".py")).read_text()
    assert "import jax" not in src and "from repro." not in src and "import repro\n" not in src


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src")}


def test_port_imports_neither_jax_nor_the_reference():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 64  # every module of the port was imported


def _entry_points():
    from repro_torch.core.indexing import BruteIndex, IVFIndex
    from repro_torch.core.sharding import ShardedIndex
    from repro_torch.core.pipeline import RGLPipeline
    from repro_torch.graph import generators
    from repro_torch.graph.ell import csr_to_ell
    from repro_torch.launch import train
    from repro_torch.models.transformer import model as tm
    from repro_torch.models.transformer.config import TransformerConfig
    from repro_torch.serving.engine import ServeEngine

    cfg = TransformerConfig(name="t", n_layers=1, d_model=16, n_heads=2, n_kv_heads=1,
                            d_head=8, d_ff=32, vocab=11, dtype="float32")
    g = generators.citation_graph(50, seed=1)
    ell = csr_to_ell(g, device="cpu")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return {
        "init_params": lambda: tm.init_params(cfg, torch.Generator()),
        "init_cache": lambda: tm.init_cache(cfg, 1, 8),
        "init_paged_cache": lambda: tm.init_paged_cache(cfg, 1, 16, 8, 2),
        "csr_to_ell": lambda: csr_to_ell(g),
        "BruteIndex.build": lambda: BruteIndex.build(g.node_feat),
        "IVFIndex.build": lambda: IVFIndex.build(g.node_feat),
        "ShardedIndex.build": lambda: ShardedIndex.build(g.node_feat, n_shards=2, inner="ivf"),
        "RGLPipeline": lambda: RGLPipeline(graph=ell, index=None, node_emb=ell.node_feat),
        "ServeEngine": lambda: ServeEngine(params, cfg, slots=1, cache_len=8),
        "paged ServeEngine": lambda: ServeEngine(params, cfg, slots=1, cache_len=16,
                                                 paged_kv=True, prefix_share=True),
        "launch.train": lambda: train.main(["--arch", "starcoder2-3b", "--steps", "1"]),
    }


@pytest.mark.parametrize("name", ["init_params", "init_cache", "init_paged_cache", "csr_to_ell",
                                  "BruteIndex.build", "IVFIndex.build", "ShardedIndex.build",
                                  "RGLPipeline", "ServeEngine", "paged ServeEngine",
                                  "launch.train"])
def test_entry_points_default_to_cuda_and_raise_without_it(name):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()


def test_rag_engine_and_launcher_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")
    from repro_torch.launch import serve
    from repro_torch.serving import ReplicaRouter
    from repro_torch.serving.rag_engine import RAGServeEngine

    class _Pipe:  # passes the tokenizer check, fails on the device first
        tokenizer = node_text = object()

    with pytest.raises(RuntimeError, match="device='cpu'"):
        RAGServeEngine(_Pipe(), {}, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RAGServeEngine(_Pipe(), {}, None, prefetch=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplicaRouter([RAGServeEngine(_Pipe(), {}, None) for _ in range(2)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "starcoder2-3b", "--rag", "--nodes", "50"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "starcoder2-3b", "--rag", "--nodes", "50", "--prefetch",
                    "--replicas", "2"])


def test_chip_smoke_refuses_to_run_without_a_card_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                           text=True, timeout=120, env={k: v for k, v in os.environ.items()
                                                        if k != "PYTHONPATH"})
    assert alone.returncode != 0 and '"ok"' not in alone.stdout
