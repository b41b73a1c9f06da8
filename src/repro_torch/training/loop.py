"""Training loop: micro-batched gradient accumulation, the compression hook
and the fault monitors (the reference's ``repro.training.loop``).

``make_train_step`` builds ``(init_state, step)`` around a loss function
``(params, batch) -> (loss, metrics)``.  A step runs one forward and
backward per micro-batch, then the optional error-feedback compression and
the AdamW update.  PyTorch runs it eagerly; the update is in place, so the
state a step returns holds the same tensors it was given (the reference
donates its buffers to the same effect).

Gradients flow into **per-layer leaves**: the step hands the loss function
a copy of the parameter tree whose stacked ``layers`` leaves are split into
one detached view per layer (sharing storage with the stacked tensor), each
with its ``.grad`` set to the matching slice of a stacked gradient buffer.
Autograd then adds each layer's gradient into that slice in place.
Indexing the stacked leaf itself would make autograd allocate and zero-fill
a full (L, ...) gradient for every layer.  The buffer starts at zero and
accumulates in the parameter dtype, then is divided by the micro-batch
count, as the reference's scan does.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.distributed.compression import CompressionConfig, compress, init_residuals
from repro_torch.distributed.fault import Heartbeat, StragglerMonitor
from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_map


def _leaf(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    t = p.detach().requires_grad_()
    t.grad = g
    return t


def train_view(params: dict, grads: dict) -> dict:
    """``params`` with every leaf a grad-requiring view whose ``.grad`` is
    the matching view of ``grads``; a ``layers`` dict of stacked leaves
    (nested dicts such as ``moe`` included) becomes a list of per-layer
    dicts (see the module docstring).  A ``layers`` list of per-layer dicts
    (the GNNs') keeps its shape, each leaf its own view."""
    out = {}
    for key, val in params.items():
        if key == "layers" and isinstance(val, dict):
            n = tree_leaves(val)[0].shape[0]
            out[key] = [tree_map(lambda v, g, i=i: _leaf(v[i], g[i]), val, grads[key])
                        for i in range(n)]
        else:
            out[key] = tree_map(_leaf, val, grads[key])
    return out


def make_train_step(
    loss_fn: Callable,  # (params, batch) -> (loss, metrics)
    opt_cfg: AdamWConfig,
    comp_cfg: CompressionConfig = CompressionConfig(),
    n_microbatches: int = 1,
):
    """Returns (init_state_fn, step_fn).  State = {params, opt, residuals}."""

    def init_state(params):
        state = {"params": params, "opt": adamw_init(params, opt_cfg)}
        if comp_cfg.kind != "none":
            state["residuals"] = init_residuals(params)
        return state

    def grads_of(params, batch):
        grads = tree_map(torch.zeros_like, params)
        view = train_view(params, grads)
        n = n_microbatches
        total = None
        for i in range(n):
            mb = {k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
                  for k, v in batch.items()} if n > 1 else batch
            loss, metrics = loss_fn(view, mb)
            loss.backward()  # adds into the stacked buffers through the views
            loss = loss.detach()
            total = loss if total is None else total + loss
        if n > 1:
            tree_map(lambda g: g.div_(n), grads)
            total = total / n
        return total, {k: v.detach() for k, v in metrics.items()}, grads

    def step(state, batch):
        loss, metrics, grads = grads_of(state["params"], batch)
        new_state = dict(state)
        if comp_cfg.kind != "none":
            grads, new_state["residuals"] = compress(grads, state["residuals"], comp_cfg)
        params, opt, opt_metrics = adamw_update(grads, state["opt"], state["params"], opt_cfg)
        new_state.update(params=params, opt=opt)
        return new_state, {"loss": loss, **metrics, **opt_metrics}

    return init_state, step


@dataclasses.dataclass
class TrainLoop:
    step_fn: Callable  # (state, batch) -> (state, metrics)
    data_iter: object  # iterator of batches
    checkpointer: Optional[object] = None  # anything with .save(step, state)
    checkpoint_every: int = 100
    monitor: StragglerMonitor = dataclasses.field(default_factory=StragglerMonitor)
    heartbeat: Heartbeat = dataclasses.field(default_factory=Heartbeat)
    host_id: int = 0
    log_every: int = 10
    log_fn: Callable = print

    def run(self, state, n_steps: int, start_step: int = 0):
        history = []
        for step in range(start_step, n_steps):
            t0 = time.monotonic()
            batch = next(self.data_iter)
            state, metrics = self.step_fn(state, batch)
            dt = time.monotonic() - t0
            self.monitor.record(self.host_id, dt)
            self.heartbeat.beat(self.host_id)
            if (step + 1) % self.log_every == 0:
                loss = float(metrics["loss"])
                history.append((step + 1, loss, dt))
                self.log_fn(f"step {step + 1}: loss={loss:.4f} ({dt * 1e3:.0f} ms)")
            if self.checkpointer and (step + 1) % self.checkpoint_every == 0:
                self.checkpointer.save(step + 1, state)
        return state, history
