"""Build the port's CUDA sources into one shared library at first use.

Route: ``nvcc`` by hand into a library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds, not minutes).  One
``nvcc`` per source, all started together, then one link.  The library lands
in ``build/kernels/`` at the repository root (listed in ``.gitignore``),
named by a hash of the sources, the headers they include and the flags, so
an edited source or header never loads a stale library.  Nothing here runs
at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("topk_sim.cu", "bfs_frontier.cu", "frontier_expand.cu", "flash_attn.cu", "ell_spmm.cu",
           "ivf_scan.cu")
HEADERS = ("topk_merge.cuh",)  # included by sources; part of the build's hash
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-lineinfo", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class LaunchCounter:
    """Launches made through one kernel wrapper: ``count`` is a plain int
    that the wrapper bumps once per kernel launch (``bump``) and callers
    reset; ``by_device`` splits it by the card index launched on."""

    def __init__(self) -> None:
        self.count = 0
        self.by_device: dict = {}

    def bump(self, device: torch.device) -> None:
        self.count += 1
        self.by_device[device.index] = self.by_device.get(device.index, 0) + 1

    def reset(self) -> None:
        self.count = 0
        self.by_device = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return str(path)


def _tag() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source (in parallel) and link the shared library, unless
    a library built from the same sources and flags is already there."""
    tag = _tag()
    out = BUILD_DIR / f"librepro_torch_kernels_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for name in SOURCES:
        obj = BUILD_DIR / f"{Path(name).stem}_{tag}.o"
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs.append((name, obj, proc))
    failed = []
    for name, obj, proc in jobs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{Path(name).stem}_{tag}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", *[str(o) for _, o, _ in jobs], "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)
    return out


def build_log() -> str:
    """The compiler's ``-Xptxas -v`` report (registers, shared memory,
    spills) of the current build."""
    tag = _tag()
    return "".join(
        (BUILD_DIR / f"{Path(n).stem}_{tag}.log").read_text() for n in SOURCES
    )


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one Hopper (sm_90) card and is
    contiguous — the kernels take nothing else."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"kernel inputs must share one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    cap = torch.cuda.get_device_capability(dev)
    if cap != (9, 0):
        raise RuntimeError(f"kernels are built for sm_90a; {dev} is sm_{cap[0]}{cap[1]}")


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (persistent grids size
    themselves by it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_status(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error (a launch the card
    refused never runs, and no later synchronize would report it)."""
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err}: {msg}")
