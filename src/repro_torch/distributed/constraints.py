"""Sharding hints usable from model code without threading a mesh through
(the reference's ``repro.distributed.constraints``).

``shard_hint(x, *axes)`` names the placement of ``x``, one entry per
dimension: None, a mesh axis name, or the logical "dp" (the data-parallel
axes).  The reference applies it as a sharding constraint when a device mesh
is active.  The port has no device mesh yet, so it returns ``x`` unchanged;
the signature stays, so that multi-card placement has one place to change.
"""
from __future__ import annotations


def shard_hint(x, *axes):
    return x
