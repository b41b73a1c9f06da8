"""Config framework: the ArchSpec record of an architecture (its published
configuration, its shape set and a tiny same-family config for CPU smoke
runs), the shape sets, and the concrete input builders of the reference's
``repro.configs.common``.

``concretize`` fills a tree of (shape, dtype) leaves with seeded arrays the
way the reference's does: leaves in sorted key order (``jax.tree_util``
visits dict keys sorted), bools all ones, integer leaves from
``rng.integers`` (edge ids and graph ids below ``n_nodes``, tokens and
sparse ids below ``vocab``), every float leaf (``node_mask`` and
``wigner_lut`` included) ``normal * 0.1``.  One seed gives the reference's
arrays.  ``abstract=True`` (the default, as in the reference) gives the same
leaves as tensors on the ``meta`` device instead, the twin of
``jax.ShapeDtypeStruct``: shapes and dtypes, nothing allocated (the dry
run's inputs).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode | long_decode | infer | retrieval
    params: dict


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # lm | gnn | recsys
    model_cfg: object
    shapes: dict
    reduced_cfg: object  # tiny same-family config for CPU smoke tests
    source: str  # citation tag from the assignment
    notes: str = ""


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A model input's shape and dtype (a numpy dtype name), before it is
    filled."""
    shape: tuple
    dtype: str


def ceil_to(x: int, m: int) -> int:
    return -(-int(x) // m) * m


EDGE_CHUNK = 16384  # equiformer edge-scan chunk; edge padding unit for big E


def padded_edges(shape: ShapeSpec) -> int:
    """Edge-array length after chunk-friendly padding (mask-safe)."""
    p = shape.params
    if shape.name == "minibatch_lg":
        e = p["block_edges"]
    elif shape.name == "molecule":
        e = p["n_edges"] * p["batch"] * 2
    else:
        e = p["n_edges"]
    return ceil_to(e, EDGE_CHUNK if e > EDGE_CHUNK else 512)


def lm_shapes(*, sliding_window: Optional[int] = None) -> dict:
    """The 4 assigned LM shapes.  long_500k only for sub-quadratic archs."""
    shapes = {
        "train_4k": ShapeSpec("train_4k", "train", dict(seq_len=4096, global_batch=256)),
        "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                                 dict(seq_len=32768, global_batch=32)),
        "decode_32k": ShapeSpec("decode_32k", "decode", dict(seq_len=32768, global_batch=128)),
    }
    if sliding_window is not None:
        shapes["long_500k"] = ShapeSpec(
            "long_500k", "long_decode",
            dict(seq_len=524288, global_batch=1, cache_len=sliding_window),
        )
    else:
        shapes["long_500k"] = ShapeSpec(
            "long_500k", "skip",
            dict(reason="pure full-attention arch; sub-quadratic attention "
                        "required at 524k context (DESIGN.md §4)"),
        )
    return shapes


GNN_SHAPES = {
    "full_graph_sm": ShapeSpec(
        "full_graph_sm", "train",
        dict(n_nodes=2708, n_edges=10556, d_feat=1433, d_out=40),
    ),
    "minibatch_lg": ShapeSpec(
        "minibatch_lg", "train",
        dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
             fanout=(15, 10), d_feat=602, d_out=41,
             # sampled-block static shapes:
             block_nodes=1024 + 1024 * 15 + 1024 * 150,
             block_edges=1024 * 15 + 1024 * 150),
    ),
    "ogb_products": ShapeSpec(
        "ogb_products", "train",
        dict(n_nodes=2449029, n_edges=61859140, d_feat=100, d_out=47),
    ),
    "molecule": ShapeSpec(
        "molecule", "train",
        dict(n_nodes=30, n_edges=64, batch=128, d_feat=16, d_out=4),
    ),
}

RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "train", dict(batch=65536)),
    "serve_p99": ShapeSpec("serve_p99", "infer", dict(batch=512)),
    "serve_bulk": ShapeSpec("serve_bulk", "infer", dict(batch=262144)),
    "retrieval_cand": ShapeSpec(
        "retrieval_cand", "retrieval", dict(batch=1, n_candidates=1_000_000, k=100)
    ),
}


# ---------------------------------------------------------------------------
# input builders: the (shape, dtype) tree of a cell, filled by concretize
# ---------------------------------------------------------------------------
def _meta(tree: dict) -> dict:
    """Each ``Leaf`` as an empty tensor on the meta device."""
    return {k: torch.empty(x.shape, dtype=getattr(torch, x.dtype), device="meta")
            for k, x in tree.items()}


def lm_inputs(shape: ShapeSpec, cfg, *, abstract: bool = True, device="cuda"):
    p = shape.params
    if shape.kind == "train":
        b, s = p["global_batch"], p["seq_len"]
        out = {"tokens": Leaf((b, s), "int32"), "loss_mask": Leaf((b, s), "bool")}
    elif shape.kind == "prefill":
        b, s = p["global_batch"], p["seq_len"]
        out = {"tokens": Leaf((b, s), "int32"), "true_len": Leaf((b,), "int32")}
    elif shape.kind in ("decode", "long_decode"):
        b = p["global_batch"]
        sc = p.get("cache_len", p["seq_len"])
        L, kv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
        cache_dt = "int8" if cfg.kv_quant else cfg.dtype
        out = {
            "token": Leaf((b,), "int32"),
            "cache_k": Leaf((L, b, sc, kv, dh), cache_dt),
            "cache_v": Leaf((L, b, sc, kv, dh), cache_dt),
            "cache_pos": Leaf((b, sc), "int32"),
            "cursor": Leaf((b,), "int32"),
        }
        if cfg.kv_quant:
            out["k_scale"] = Leaf((L, b, sc, kv), "bfloat16")
            out["v_scale"] = Leaf((L, b, sc, kv), "bfloat16")
    else:
        raise ValueError(shape.kind)
    if abstract:
        return _meta(out)
    return concretize(out, np.random.default_rng(0), vocab=cfg.vocab, device=device)


def gnn_inputs(shape: ShapeSpec, cfg, *, abstract: bool = True, device="cuda"):
    p = shape.params
    if shape.name == "minibatch_lg":
        n = p["block_nodes"]
    elif shape.name == "molecule":
        n = p["n_nodes"] * p["batch"]
    else:
        n = p["n_nodes"]
    e = padded_edges(shape)
    out = {
        "node_feat": Leaf((n, cfg.d_in), "float32"),
        "edge_src": Leaf((e,), "int32"),
        "edge_dst": Leaf((e,), "int32"),
        "edge_mask": Leaf((e,), "bool"),
    }
    if cfg.arch == "equiformer_v2":
        out["pos"] = Leaf((n, 3), "float32")
        out["wigner_lut"] = Leaf((cfg.n_wigner_bins, cfg.sphere_k, cfg.sphere_k), "float32")
    if shape.name == "molecule" and cfg.graph_readout:
        out["targets"] = Leaf((p["batch"], cfg.d_out), "float32")
        out["graph_ids"] = Leaf((n,), "int32")
    else:
        out["targets"] = Leaf((n, cfg.d_out), "float32")
        out["node_mask"] = Leaf((n,), "float32")
    if abstract:
        return _meta(out)
    return concretize(out, np.random.default_rng(0), n_nodes=n, device=device)


def recsys_inputs(shape: ShapeSpec, cfg, *, abstract: bool = True, device="cuda"):
    p = shape.params
    if shape.kind == "retrieval":
        out = {
            "query": Leaf((p["batch"], cfg.mlp[-1]), "float32"),
            "cand_emb": Leaf((p["n_candidates"], cfg.mlp[-1]), "float32"),
        }
    else:
        b = p["batch"]
        out = {
            "dense": Leaf((b, cfg.n_dense), "float32"),
            "sparse_ids": Leaf((b, cfg.n_sparse, cfg.bag_size), "int32"),
        }
        if shape.kind == "train":
            out["labels"] = Leaf((b,), "float32")
    if abstract:
        return _meta(out)
    return concretize(out, np.random.default_rng(0), vocab=cfg.rows_per_field, device=device)


def concretize(tree: dict, rng: np.random.Generator, *, vocab: int = 64, n_nodes: int = 8,
               device="cuda") -> dict:
    """Fill a flat dict of ``Leaf`` with small random tensors on ``device``
    (see the module docstring), in sorted key order."""
    device = resolve_device(device)
    out = {}
    for name in sorted(tree):
        x = tree[name]
        dt = getattr(torch, x.dtype)
        if dt == torch.bool:
            out[name] = torch.ones(x.shape, dtype=torch.bool, device=device)
            continue
        if not dt.is_floating_point:
            if "edge" in name or name == "graph_ids":
                hi = max(n_nodes, 2)
            elif name in ("token", "tokens", "sparse_ids"):
                hi = vocab
            elif name == "cache_pos":
                out[name] = torch.full(x.shape, -1, dtype=torch.int32, device=device)
                continue
            elif name in ("cursor", "true_len"):
                out[name] = torch.full(x.shape, 1, dtype=torch.int32, device=device)
                continue
            else:
                hi = 2
            out[name] = torch.from_numpy(rng.integers(0, hi, x.shape)).to(device=device,
                                                                           dtype=dt)
            continue
        vals = rng.standard_normal(x.shape) * 0.1
        if dt == torch.float32:  # one rounding, float64 -> float32, on the host
            out[name] = torch.from_numpy(vals.astype(np.float32)).to(device)
        else:
            out[name] = torch.from_numpy(vals).to(device=device, dtype=dt)
    return out
