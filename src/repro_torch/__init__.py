"""PyTorch/CUDA port of the RGL system; ``repro`` (JAX) is its reference.

Modules keep ``repro``'s names so each function has a named counterpart.
Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; nothing falls back to the CPU by itself.  Heavy modules are
not re-exported: import them by path (``repro_torch.core.pipeline``,
``repro_torch.serving.rag_engine``, ...).
"""
from __future__ import annotations

import torch

# The reference's float32 paths are full float32.  TF32 keeps 10 mantissa
# bits, which would move similarity scores and logits well past the parity
# tolerances, so both switches stay off for the whole port.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no card
    is visible (the caller must ask for the CPU explicitly), or names a card
    index that is not there."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"{dev} is not there: {torch.cuda.device_count()} "
                               "CUDA device(s) are visible")
    return dev
