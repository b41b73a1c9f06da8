"""Architecture registry of the port: ``--arch <id>`` resolution and the
per-shape config adaptation (the reference's ``repro.configs``)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    deepseek_7b, deepseek_coder_33b, equiformer_v2, gin_tu, granite_moe_1b, graphcast,
    grok_1_314b, meshgraphnet, starcoder2_3b, wide_deep,
)
from repro_torch.configs.common import (
    ArchSpec, ShapeSpec, ceil_to, gnn_inputs, lm_inputs, recsys_inputs,
)

REGISTRY = {
    spec.arch_id: spec
    for spec in [
        starcoder2_3b.CONFIG, deepseek_7b.CONFIG, deepseek_coder_33b.CONFIG,
        grok_1_314b.CONFIG, granite_moe_1b.CONFIG,
        graphcast.CONFIG, meshgraphnet.CONFIG, gin_tu.CONFIG,
        equiformer_v2.CONFIG, wide_deep.CONFIG,
    ]
}

ARCH_IDS = sorted(REGISTRY)


def get_config(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; ported: {ARCH_IDS}")
    return REGISTRY[arch_id]


def effective_model_cfg(spec: ArchSpec, shape: ShapeSpec):
    """Adapt the published config to the assigned input shape.

    * GNN: d_in/d_out track the shape's feature/target widths (d_in padded to
      a multiple of 16); the arch's depth/width/equivariance stay fixed —
      those are what the config pins.  GraphCast's n_vars and d_out follow
      d_in (it predicts its input stack); at ``molecule`` every arch but
      GraphCast reads out per graph.
    * LM: vocab padded to a multiple of 256.
    """
    cfg = spec.model_cfg
    if spec.family == "lm":
        vp = ceil_to(cfg.vocab, 256)
        if vp != cfg.vocab:
            cfg = dataclasses.replace(cfg, vocab=vp)
    elif spec.family == "gnn":
        p = shape.params
        d_in = ceil_to(p["d_feat"], 16)
        repl = dict(d_in=d_in, d_out=p["d_out"])
        if cfg.arch == "graphcast":
            repl["n_vars"] = d_in
            repl["d_out"] = d_in
        if shape.name == "molecule":
            repl["graph_readout"] = cfg.arch != "graphcast"
        cfg = dataclasses.replace(cfg, **repl)
    return cfg


def input_specs(arch_id: str, shape_name: str, *, abstract: bool = True, device="cuda"):
    """Every model input of the given cell: meta-device tensors of the
    reference's shapes and dtypes (``abstract=True``, the dry run's), or
    seeded tensors on ``device`` (``abstract=False``: the reference's
    ``concretize`` arrays)."""
    spec = get_config(arch_id)
    shape = spec.shapes[shape_name]
    if shape.kind == "skip":
        raise ValueError(
            f"{arch_id} x {shape_name} is a documented skip: {shape.params['reason']}"
        )
    cfg = effective_model_cfg(spec, shape)
    builder = {"lm": lm_inputs, "gnn": gnn_inputs, "recsys": recsys_inputs}[spec.family]
    return builder(shape, cfg, abstract=abstract, device=device)


__all__ = ["REGISTRY", "ARCH_IDS", "get_config", "effective_model_cfg", "input_specs"]
