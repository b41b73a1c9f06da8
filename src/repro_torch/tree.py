"""Nested-dict/list parameter trees: the ``jax.tree`` operations the
training, checkpoint and sharding code needs, and the reference's trees as
tensors."""
from __future__ import annotations

import numpy as np
import torch


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, prefix: tuple = ()):
    """``fn(path, leaf)`` over the leaves of ``tree``, ``path`` being the
    leaf's dict keys and list indices joined by ``/`` (as the reference's
    checkpoint and sharding code name leaves)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(prefix), tree)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``tree_map`` order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def params_from_jax(params_np, device="cuda"):
    """The reference's parameter pytree (numpy leaves; dicts and per-layer
    lists kept) as fp32/int tensors on ``device``, so both compute one
    function (the GNN zoo, Wide & Deep)."""
    from repro_torch import resolve_device

    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), params_np)

