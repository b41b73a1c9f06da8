"""The run's environment, fixed before anything imports torch.

Build and kernel caches go to fixed directories inside the checkout, so
that only a cell's first run there builds: the program's kernels already
build into ``build/kernels``; the benchmark's corpus goes to
``build/perfbench``.  The program's ``RGL_*`` switches are cleared, so
every serving knob is the one the cell's files give.  ``USE_FLAX=0`` and
``USE_JAX=0`` keep libraries that could load JAX by themselves from
doing so.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def setup(root: Path) -> Path:
    """Point the caches into ``root``; returns the benchmark's cache dir."""
    build = Path(root) / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for k in [k for k in os.environ if k.startswith("RGL_")]:
        del os.environ[k]
    return build / "perfbench"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
