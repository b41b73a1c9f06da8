"""Training launcher: ``--arch <id>`` resolves a registry config and trains
its reduced config on random tokens, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b --device cpu

The full-width run is ``chip_smoke.py``'s, through the same
``make_train_step`` and ``TrainLoop`` calls.
"""
from __future__ import annotations

import argparse

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
    if spec.family != "lm":
        raise NotImplementedError(
            f"training the {spec.family} family is not ported yet: ROADMAP Queue 1 item 16")
    from repro_torch.models.transformer import model as tm

    cfg = spec.reduced_cfg
    opt = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=args.steps)
    params = tm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)

    def loss_fn(p, b):
        return tm.lm_loss(p, b["tokens"], b["loss_mask"], cfg)

    init_state, step = make_train_step(loss_fn, opt)
    loop = TrainLoop(step_fn=step, data_iter=_lm_data(cfg, args.batch, args.seq, device=dev),
                     log_every=5)
    state, history = loop.run(init_state(params), args.steps)
    print(f"[{args.arch}] done: " + (
        f"loss {history[0][1]:.4f} -> {history[-1][1]:.4f}" if history else "ok"))
    return history


if __name__ == "__main__":
    main()
