"""Sharded, atomic, async checkpointing with restore onto a named device or
a target placement (the reference's ``repro.checkpoint.checkpoint``, same
files).

Layout per step:  <dir>/step_<N:08d>/
    manifest.json          — step, leaf paths/shapes/dtypes, shard layout
    shard_<i>.npz          — leaf arrays, chunked so no single file > ~1 GB

A leaf's path is its dict keys and list indices joined by ``/`` (stored in
the ``.npz`` with ``__`` for ``/``); leaves are taken in sorted-key order, as
``jax.tree_util`` flattens, so a tree's manifest and shard split equal the
reference's.  NumPy has no bfloat16: a bf16 leaf is written by its bits as
two-byte ``V2`` records, which is what the reference's ``np.savez`` writes,
with ``"dtype": "bfloat16"`` in the manifest; restore reads each leaf by the
manifest's dtype, so bf16 comes back as bf16 (the reference hands back the
raw ``V2`` records).

Writes go to step_<N>.tmp then ``os.rename`` (atomic on POSIX), so a crash
never leaves a half checkpoint visible.  ``AsyncCheckpointer`` writes on a
worker thread; its ``save`` copies every leaf to the host before it returns,
because the training step updates parameters and moments in place: a copy
still in flight when the next step writes would save a torn state.  Restore
puts each leaf on ``device``, or on the device of the matching leaf of
``like``: a checkpoint written on one device restores onto another; with a
``sharding_tree``, onto a target placement per leaf (a device, or a piece of
a ``DeviceMesh``).
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.tree import tree_map, tree_map_with_path

_MAX_SHARD_BYTES = 1 << 30
_BF16 = "bfloat16"


def _flatten(tree, prefix: tuple = ()) -> list:
    """(path, leaf) pairs of ``tree`` in sorted-key order; ``None`` is an
    empty subtree, as in ``jax.tree_util``."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in _flatten(v, prefix + (str(i),))]
    if tree is None:
        return []
    return [("/".join(prefix), tree)]


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the host array the ``.npz`` stores, and its dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.cpu().view(torch.int16).numpy().view("V2"), _BF16
        a = t.cpu().numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    """The host tensor of a stored leaf, read by its manifest dtype."""
    a = np.require(a, requirements="C")  # keeps 0-d leaves 0-d
    if dtype == _BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save_checkpoint(ckpt_dir: str, step: int, tree) -> str:
    pairs = _flatten(tree)
    host = [(p, *_to_numpy(a)) for p, a in pairs]
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    # chunk leaves into shard files
    shards, cur, cur_bytes = [], [], 0
    for p, a, dt in host:
        if cur_bytes + a.nbytes > _MAX_SHARD_BYTES and cur:
            shards.append(cur)
            cur, cur_bytes = [], 0
        cur.append((p, a, dt))
        cur_bytes += a.nbytes
    if cur:
        shards.append(cur)
    manifest = {"step": step, "n_shards": len(shards), "leaves": {}}
    for i, shard in enumerate(shards):
        np.savez(os.path.join(tmp, f"shard_{i}.npz"), **{
            p.replace("/", "__"): a for p, a, _ in shard
        })
        for p, a, dt in shard:
            manifest["leaves"][p] = {"shard": i, "shape": list(a.shape), "dtype": dt}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _steps(ckpt_dir: str) -> list:
    return [
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return max(steps) if steps else None


def _is_placement(x) -> bool:
    """A leaf of a sharding tree: None, a device (or its name), or a
    ``(DeviceMesh, placements)`` pair."""
    if x is None or isinstance(x, (str, torch.device)):
        return True
    if isinstance(x, tuple) and len(x) == 2:
        from torch.distributed.device_mesh import DeviceMesh

        return isinstance(x[0], DeviceMesh)
    return False


def _placements(tree, prefix: tuple = ()) -> dict:
    """Leaf path -> placement of a sharding tree (the structure of ``like``)."""
    if _is_placement(tree):
        return {"/".join(prefix): tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        raise TypeError(f"not a placement: {tree!r}")
    return {p: v for k, sub in items for p, v in _placements(sub, prefix + (str(k),)).items()}


def _onto_mesh(t: torch.Tensor, mesh, placements, device) -> torch.Tensor:
    """This rank's piece of the whole leaf ``t`` as a DTensor on ``mesh``
    (on ``device``, default the mesh's device type); no collective runs."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.distributed.constraints import contiguous_stride

    shape = tuple(t.shape)
    local, offset = compute_local_shape_and_global_offset(shape, mesh, placements)
    piece = t[tuple(slice(o, o + n) for o, n in zip(offset, local))]
    piece = piece.to(mesh.device_type if device is None else device).contiguous()
    return DTensor.from_local(piece, mesh, placements, run_check=False, shape=shape,
                              stride=contiguous_stride(shape))


def restore_checkpoint(ckpt_dir: str, like, step: Optional[int] = None, device=None,
                       sharding_tree=None):
    """Restore into the structure of ``like``: each leaf read by its
    manifest dtype, cast to the dtype of the matching tensor leaf of
    ``like`` and put on ``device`` (default: that leaf's device; the CPU for
    a leaf that is not a tensor).  Returns (tree, step).

    ``sharding_tree`` (the structure of ``like``) puts each leaf onto a
    target placement instead, the reference's reshard-on-restore: ``None``
    leaves the leaf to ``device``; a device (or its name) is the twin of a
    ``SingleDeviceSharding``; a ``(DeviceMesh, placements)`` pair, such as
    ``(mesh, policies.named(mesh, spec))``, the twin of a ``NamedSharding``:
    each rank reads the whole leaf and keeps its own piece, a DTensor of the
    leaf's global shape."""
    targets = {} if sharding_tree is None else _placements(sharding_tree)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    cache = {}

    def load_leaf(path, leaf):
        info = manifest["leaves"][path]
        i = info["shard"]
        if i not in cache:
            cache[i] = np.load(os.path.join(d, f"shard_{i}.npz"))
        t = _from_numpy(cache[i][path.replace("/", "__")], info["dtype"])
        if isinstance(leaf, torch.Tensor):
            t = t.to(dtype=leaf.dtype)
        target = targets.get(path)
        if isinstance(target, tuple):
            return _onto_mesh(t, *target, device)
        if target is not None:
            return t.to(target)
        if isinstance(leaf, torch.Tensor):
            return t.to(leaf.device if device is None else device)
        return t if device is None else t.to(device)

    out = tree_map_with_path(lambda p, leaf: None if leaf is None else load_leaf(p, leaf), like)
    for z in cache.values():
        z.close()
    return out, manifest["step"]


def _host_copy(leaf):
    """A host copy of ``leaf`` that later in-place writes cannot reach: CUDA
    tensors are queued into pinned buffers (``_snapshot`` waits for them),
    CPU tensors and arrays are copied."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type == "cpu":
            return t.clone()
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        return buf
    return None if leaf is None else np.array(leaf)


def _snapshot(tree):
    """A host copy of every leaf of ``tree``, complete when this returns."""
    devices = set()

    def copy(leaf):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            devices.add(leaf.device)
        return _host_copy(leaf)

    out = tree_map(copy, tree)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
    return out


class AsyncCheckpointer:
    """Background-thread saver; blocks only on a full queue (depth 2).
    ``save`` returns once the host copy is complete (see the module
    docstring); the worker thread only writes files.  A write error is
    raised on the next ``save`` or on ``close``."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._q = queue.Queue(maxsize=2)
        self._err = None
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tree = item
            del item  # the host copy is freed once written, not at the next save
            try:
                save_checkpoint(self.ckpt_dir, step, tree)
                self._gc()
            except Exception as e:  # surfaced on next save/close
                self._err = e
            finally:
                del tree
                self._q.task_done()

    def _gc(self):
        for s in sorted(_steps(self.ckpt_dir))[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"), True)

    def save(self, step: int, tree) -> None:
        if self._err:
            raise self._err
        self._q.put((step, _snapshot(tree)))

    def close(self) -> None:
        self._q.join()
        self._q.put(None)
        self._t.join()
        if self._err:
            raise self._err
