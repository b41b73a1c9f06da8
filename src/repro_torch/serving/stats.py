"""Unified serving-stats schema: namespaced tree + flat compatibility view.

Every serving layer exposes its counters under one namespace of a nested
``stats_ns()`` dict:

* ``cache.*``    — :class:`repro_torch.serving.cache.RetrievalCache`
* ``engine.*``   — RAGServeEngine-level admission/degradation counters
* ``prefetch.*`` — :class:`repro_torch.serving.prefetch.AdmissionPrefetcher`
* ``decode.*``   — :meth:`repro_torch.serving.engine.ServeEngine.decode_stats`
* ``router.*``   — :class:`repro_torch.serving.router.ReplicaRouter`
* ``mutation.*`` — the online-mutation tier (not ported yet)

:func:`flatten_stats` derives the historical flat dict from the tree.  The
namespaces that predate the schema (``LEGACY_FLAT``) flatten *unprefixed* —
their keys are the exact keys nine PRs of tests and dashboards already
read (``hits``, ``prefetch_waves``, ``decode_steps``, ...).  Namespaces
introduced with the schema (``mutation``, ``router``) flatten with a
``<ns>_`` prefix so they can never collide with a legacy key.
"""
from __future__ import annotations

# namespaces whose keys were already top-level flat keys before the schema
# existed; they stay unprefixed for compatibility.  Flat-merge order (and
# therefore collision-overwrite behavior) follows the tree's insertion
# order, which every stats_ns() builds as cache, engine, prefetch, decode —
# the same order the old flat stats() merged them in.
LEGACY_FLAT = ("cache", "engine", "prefetch", "decode")


def flatten_stats(ns: dict) -> dict:
    """Flat compatibility view of a namespaced ``stats_ns()`` tree."""
    flat: dict = {}
    for name, group in ns.items():
        if not isinstance(group, dict):
            flat[name] = group
            continue
        if name in LEGACY_FLAT:
            flat.update(group)
        else:
            for k, v in group.items():
                flat[f"{name}_{k}"] = v
    return flat
