"""Sharding hints usable from model code without threading a mesh through
(the reference's ``repro.distributed.constraints``).

``shard_hint(x, *axes)`` names the placement of ``x``, one entry per
dimension: None, a mesh axis name, or the logical "dp" (the data-parallel
axes, ("pod", "data") as the mesh has them); a name the mesh lacks means
None.  Inside ``active_mesh(mesh)`` (the dry run's twin of the reference's
``with mesh:``) a DTensor ``x`` is redistributed to that placement;
otherwise ``x`` comes back unchanged, so the single-card path is untouched.
``zeros_hint`` is ``shard_hint(torch.zeros(...))`` (the reference's
``shard_hint(jnp.zeros(...))``) that, under a mesh, makes the zeros shard by
shard instead of whole first.

These hints are the reference's memory-term fixes: without them GSPMD
replicated the big per-graph / per-cache intermediates (measured there:
EquiformerV2 x ogb_products at 50 TiB a device).
"""
from __future__ import annotations

import contextlib

import torch

_MESHES: list = []  # the active meshes, innermost last


@contextlib.contextmanager
def active_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the one ``shard_hint`` places on."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def resolve(names: tuple, axes: tuple) -> tuple:
    """``axes`` with "dp" and names outside ``names`` resolved."""
    out = []
    for a in axes:
        if a == "dp":
            dp = tuple(ax for ax in ("pod", "data") if ax in names)
            out.append(dp if dp else None)
        elif a is None or a in names:
            out.append(a)
        else:
            out.append(None)
    return tuple(out)


def shard_hint(x, *axes):
    if not _MESHES:
        return x
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.policies import named

    if not isinstance(x, DTensor):
        return x
    mesh = _MESHES[-1]
    return x.redistribute(mesh, named(mesh, resolve(tuple(mesh.mesh_dim_names), axes)))


def zeros_hint(shape, *axes, dtype=None, device=None):
    """``shard_hint(torch.zeros(shape, dtype=, device=), *axes)``; under an
    active mesh a DTensor whose local shard alone is made, on ``device``
    (the full tensor never exists)."""
    if not _MESHES:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.distributed.policies import named

    mesh, shape = _MESHES[-1], tuple(shape)
    placements = named(mesh, resolve(tuple(mesh.mesh_dim_names), axes))
    local, _ = compute_local_shape_and_global_offset(shape, mesh, placements)
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device), mesh, placements,
                              run_check=False, shape=shape, stride=contiguous_stride(shape))


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (worked out, not
    made: a placeholder tensor of a global shape would count as memory)."""
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= max(d, 1)
    return tuple(reversed(out))
