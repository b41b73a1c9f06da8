"""Atomic, sharded, asynchronous checkpoints of parameter and optimizer
trees, in the reference's on-disk layout."""
from repro_torch.checkpoint.checkpoint import (
    AsyncCheckpointer, latest_step, restore_checkpoint, save_checkpoint,
)

__all__ = [
    "save_checkpoint", "restore_checkpoint", "latest_step", "AsyncCheckpointer",
]
