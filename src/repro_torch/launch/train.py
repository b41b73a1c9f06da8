"""Training launcher: ``--arch <id>`` resolves a registry config and trains
its reduced config, on the card by default: an LM on random tokens, a GNN on
a 200-node citation graph (zero targets), Wide & Deep on random clicks,
each drawn as the reference launcher draws them.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b
    PYTHONPATH=src python -m repro_torch.launch.train --arch meshgraphnet --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch wide-deep --device cpu

The full-width runs are ``chip_smoke.py``'s, through the same
``make_train_step`` and ``TrainLoop`` calls.
"""
from __future__ import annotations

import argparse
import itertools

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch import resolve_device
from repro_torch.training import AdamWConfig, TrainLoop, make_train_step


def _lm_data(cfg, batch: int, seq: int, seed: int = 0, device="cuda"):
    """Random token batches drawn as the reference launcher draws them,
    with an all-ones loss mask."""
    rng = np.random.default_rng(seed)
    while True:
        toks = rng.integers(0, cfg.vocab, size=(batch, seq), dtype=np.int32)
        yield {"tokens": torch.from_numpy(toks).to(device),
               "loss_mask": torch.ones((batch, seq), dtype=torch.bool, device=device)}


def _gnn_inputs(cfg, device="cuda") -> dict:
    """The reference launcher's GNN batch: the 200-node citation graph with
    zero targets; for EquiformerV2 seeded positions and an 8 x 16 LUT."""
    from repro_torch.graph import generators
    from repro_torch.models.gnn.wigner import build_wigner_lut

    g = generators.citation_graph(200, avg_deg=5, d_feat=cfg.d_in, seed=0)
    src, dst = g.edge_list()
    inputs = {
        "node_feat": torch.from_numpy(g.node_feat).to(device),
        "edge_src": torch.from_numpy(src).to(device),
        "edge_dst": torch.from_numpy(dst).to(device),
        "edge_mask": torch.ones(len(src), dtype=torch.bool, device=device),
        "targets": torch.zeros((200, cfg.d_out), device=device),
    }
    if cfg.arch == "equiformer_v2":
        inputs["pos"] = torch.from_numpy(
            np.random.default_rng(0).standard_normal((200, 3)).astype(np.float32)).to(device)
        inputs["wigner_lut"] = torch.from_numpy(
            build_wigner_lut(cfg.l_max, n_theta=8, n_phi=16, n_samples=128)).to(device)
    return inputs


def _recsys_data(cfg, batch: int, seed: int = 0, device="cuda"):
    """Click batches drawn as the reference launcher draws them (ids
    pre-offset per field, then dense features, then labels, from one
    generator)."""
    rng = np.random.default_rng(seed)
    while True:
        ids = rng.integers(0, cfg.rows_per_field, (batch, cfg.n_sparse, cfg.bag_size))
        ids += np.arange(cfg.n_sparse)[None, :, None] * cfg.rows_per_field
        dense = rng.standard_normal((batch, cfg.n_dense)).astype(np.float32)
        labels = rng.integers(0, 2, batch).astype(np.float32)
        yield {"dense": torch.from_numpy(dense).to(device),
               "sparse_ids": torch.from_numpy(ids.astype(np.int32)).to(device),
               "labels": torch.from_numpy(labels).to(device)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=C.ARCH_IDS)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    spec = C.get_config(args.arch)
    cfg = spec.reduced_cfg
    opt = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=args.steps)
    gen = torch.Generator(device=dev).manual_seed(0)

    if spec.family == "lm":
        from repro_torch.models.transformer import model as tm

        params = tm.init_params(cfg, gen, device=dev)

        def loss_fn(p, b):
            return tm.lm_loss(p, b["tokens"], b["loss_mask"], cfg)

        data = _lm_data(cfg, args.batch, args.seq, device=dev)
    elif spec.family == "gnn":
        from repro_torch.models.gnn import gnn_loss, init_gnn

        params = init_gnn(cfg, gen, device=dev)

        def loss_fn(p, b):
            return gnn_loss(p, cfg, b), {}

        data = itertools.repeat(_gnn_inputs(cfg, device=dev))
    else:  # recsys
        from repro_torch.models.recsys import wide_deep as wdm

        params = wdm.init_wide_deep(cfg, gen, device=dev)

        def loss_fn(p, b):
            return wdm.wide_deep_loss(p, cfg, b["dense"], b["sparse_ids"], b["labels"]), {}

        data = _recsys_data(cfg, args.batch * 8, device=dev)

    init_state, step = make_train_step(loss_fn, opt)
    loop = TrainLoop(step_fn=step, data_iter=data, log_every=5)
    state, history = loop.run(init_state(params), args.steps)
    print(f"[{args.arch}] done: " + (
        f"loss {history[0][1]:.4f} -> {history[-1][1]:.4f}" if history else "ok"))
    return history


if __name__ == "__main__":
    main()
