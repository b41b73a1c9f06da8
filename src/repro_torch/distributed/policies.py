"""Sharding policies per model family, as plain data (the reference's
``repro.distributed.policies``).

Maps parameter-tree paths and step inputs to placements for the production
meshes: (16, 16) ("data", "model") single-pod and (2, 16, 16) ("pod",
"data", "model") multi-pod.  A placement is a tuple with one entry per
dimension — None (replicated), a mesh axis name, or a tuple of names — and
equals ``tuple()`` of the reference's ``PartitionSpec``, whose canonical form
``_spec`` copies (a one-name tuple becomes the name, an empty one None);
``()`` replicates the whole leaf.  The functions that read a mesh take any object with
``axis_names`` and ``shape`` (a dict of axis sizes), such as ``MeshShape``;
``named`` turns a placement into DTensor placements on a ``DeviceMesh``.

LM policy (dense): 2D weight sharding — FSDP over "data" on the contracting
dim + Megatron TP over "model" on heads/d_ff; activations sharded batch x
("pod","data") and model-dim where contracted.  Weights are replicated
across pods (hierarchical DP: reduce-scatter in-pod, all-reduce cross-pod).

LM policy (MoE): "expert" mode shards the E axis over "model" (expert
parallelism) for E >= 16 (granite 32e); "tp" mode shards each expert's d_ff
over "model" (grok 8e < 16 devices).

GNN policy: edge-parallel — edge arrays over DP axes, node feature dim over
"model".

RecSys policy: embedding tables row-sharded over "model", MLP replicated,
batch over DP axes.
"""
from __future__ import annotations

import dataclasses

from repro_torch.tree import tree_map_with_path


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A device mesh's axis names and sizes, without devices."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @classmethod
    def of(cls, mesh) -> "MeshShape":
        """The names and sizes of a ``torch.distributed`` ``DeviceMesh``."""
        return cls(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


SINGLE_POD = MeshShape(("data", "model"), (16, 16))
MULTI_POD = MeshShape(("pod", "data", "model"), (2, 16, 16))


def _spec(*parts) -> tuple:
    """A placement in ``PartitionSpec``'s canonical form."""
    out = []
    for p in parts:
        if isinstance(p, (tuple, list)):
            p = None if len(p) == 0 else p[0] if len(p) == 1 else tuple(p)
        out.append(p)
    return tuple(out)


def dp_axes(mesh):
    """Data-parallel mesh axes: ("pod","data") when a pod axis exists."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def batch_spec(mesh, extra_dims: int = 1) -> tuple:
    return _spec(dp_axes(mesh), *([None] * extra_dims))


def dp_size(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= mesh.shape[a]
    return n


def batch_axes_or_none(mesh, batch: int):
    """DP axes if they divide the global batch, else replicate (b=1 decode)."""
    return dp_axes(mesh) if batch % dp_size(mesh) == 0 else None


# --------------------------------------------------------------------------
# LM transformer
# --------------------------------------------------------------------------
def lm_param_spec(path: str, shape, moe_mode: str = "expert") -> tuple:
    """path: '/'-joined param path, e.g. 'layers/wq'."""
    leaf = path.split("/")[-1]
    if leaf in ("ln1", "ln2", "ln_f"):
        return ()  # tiny
    if leaf == "embed":
        return (None, "model")
    if leaf == "head":
        return (None, "model")
    # MoE expert weights (L, E, D, F) / (L, E, F, D) — match BEFORE the
    # generic w1/w2/w3 rules (same leaf names, different ranks).
    if "moe" in path.split("/"):
        if leaf in ("w1", "w3"):
            return (None, "model", "data", None) if moe_mode == "expert" else (
                None, None, "data", "model"
            )
        if leaf == "w2":
            return (None, "model", None, "data") if moe_mode == "expert" else (
                None, None, "model", "data"
            )
        return ()
    if leaf in ("wq", "wk", "wv", "w1", "w3"):
        return (None, "data", "model")  # (L, D, out)
    if leaf in ("wo", "w2"):
        return (None, "model", "data")  # (L, in, D)
    if leaf == "router":
        return ()
    return ()


def lm_param_specs(param_shapes, moe_mode: str = "expert"):
    return tree_map_with_path(lambda p, x: lm_param_spec(p, x, moe_mode), param_shapes)


def lm_input_specs(mesh) -> dict:
    dp = dp_axes(mesh)
    return {
        "tokens": _spec(dp, None),
        "loss_mask": _spec(dp, None),
    }


def lm_cache_specs(mesh, batch: int, kv_heads: int, kv_shard: str = "seq") -> dict:
    """KV-cache sharding.  Baseline "seq": shard the cache length over
    "model" (flash-decoding style — works for every arch since cache_len is
    always a multiple of 16; softmax stats summed over shards).  "heads"
    mode shards KV heads instead (only when kv_heads % model_size == 0).
    Batch dims replicate when the global batch doesn't divide the DP axes
    (long_500k: batch=1)."""
    dp = dp_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= mesh.shape[a]
    b = dp if batch % dp_size == 0 else None
    if kv_shard == "heads":
        return {
            "k": _spec(None, b, None, "model", None),
            "v": _spec(None, b, None, "model", None),
            "pos": _spec(b, None),
            "cursor": _spec(b),
        }
    return {
        "k": _spec(None, b, "model", None, None),
        "v": _spec(None, b, "model", None, None),
        "pos": _spec(b, "model"),
        "cursor": _spec(b),
    }


# --------------------------------------------------------------------------
# GNN
# --------------------------------------------------------------------------
def gnn_param_specs(param_shapes):
    """GNN params are small (<= 50M); feature-dim shard the big MLP mats,
    replicate the rest."""

    def spec(path, x):
        if len(x.shape) == 2 and x.shape[0] * x.shape[1] >= 1 << 20:
            return (None, "model")
        return ()

    return tree_map_with_path(spec, param_shapes)


def gnn_input_specs(mesh, keys) -> dict:
    dp = dp_axes(mesh)
    table = {
        "node_feat": (None, "model"),
        "pos": (),
        "edge_src": _spec(dp),
        "edge_dst": _spec(dp),
        "edge_mask": _spec(dp),
        "edge_feat": _spec(dp, None),
        "targets": (),
        "node_mask": (),
        "graph_ids": (),
        "wigner_lut": (),
    }
    return {k: table[k] for k in keys}


# --------------------------------------------------------------------------
# RecSys
# --------------------------------------------------------------------------
def recsys_param_specs(param_shapes):
    def spec(path, x):
        if path.endswith("table"):
            return ("model", None)
        if path.endswith("wide"):
            return ("model",)
        return ()

    return tree_map_with_path(spec, param_shapes)


def recsys_input_specs(mesh) -> dict:
    dp = dp_axes(mesh)
    return {
        "dense": _spec(dp, None),
        "sparse_ids": _spec(dp, None, None),
        "labels": _spec(dp),
        "query": (),
        "cand_emb": ("model", None),
    }


def named(mesh, spec) -> tuple:
    """``spec`` (a placement tuple) as DTensor placements on ``mesh`` (a
    ``DeviceMesh``), one per mesh dimension: a mesh axis named on tensor dim
    ``d`` is ``Shard(d)``, every other axis (and any axis of size 1, where
    the two agree) ``Replicate()``.  A tuple of names on one dim shards it
    over each, the first name outermost, as ``PartitionSpec`` orders them
    (DTensor nests shards of one dim in mesh order, so the names must come
    in that order)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx) or any(out[i] != Replicate() for i in idx):
            raise ValueError(f"placement {spec} on mesh axes {names}: each axis once, "
                             "in mesh order within a dim")
        for i in idx:
            if mesh.size(i) > 1:
                out[i] = Shard(d)
    return tuple(out)
