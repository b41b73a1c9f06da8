"""Mixture-of-Experts FFN (GShard/Mixtral-style) with fixed shapes: the
reference's ``repro.models.transformer.moe`` in plain PyTorch.

Each token's top-k experts (fp32 router, ties to the lower expert id) are
dispatched into an (E, C, D) buffer, C = cf * T * k / E padded to a multiple
of 8 (at least 8), run through (E, C, D) x (E, D, F) grouped products
(SwiGLU experts, fp32 accumulation) and combined back with their gate
weights.  A (token, slot) pair whose rank among the pairs routed to its
expert reaches C is dropped (standard capacity-factor semantics); the
Switch auxiliary loss keeps the router near uniform.

The rank of a pair is the count of earlier pairs (in (token, slot) order)
routed to the same expert: its offset inside its expert's group of the
reference's stable argsort, computed here as a cumulative sum over a
one-hot (E, T*k) mask, so no sort runs.  Dispatch is a scatter of unique
rows (dropped pairs land on one scratch row past the end, cut off); the
combine gathers each pair's row back into a (T, k, D) block and sums over
k, so the forward adds nothing atomically and its bits do not vary between
runs (where ``index_add_`` would add the k rows in atomic order).  Nothing
here reads a value on the host: shapes are static, as in the reference.

``shard_mode`` picks the placements the ``shard_hint`` calls give the
dispatch buffers under a mesh (the dry run's): "expert" puts the E axis on
"model" (expert parallelism), "tp" the capacity rows on the DP axes and d_ff
on "model".  Without a mesh the hints return their input: on one card the
mode changes no arithmetic.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.distributed.constraints import shard_hint
from repro_torch.kernels.topk_sim.ref import stable_topk
from repro_torch.models.transformer.config import MoEConfig


def init_moe_params(generator: torch.Generator, d_model: int, cfg: MoEConfig, dtype,
                    n_layers: int, device) -> dict:
    """One MoE block per layer, stacked on a leading L axis, with the
    reference's shapes and scales: ``router`` (L, D, E) fp32, ``w1`` and
    ``w3`` (L, E, D, F), ``w2`` (L, E, F, D) in ``dtype``."""
    e, f, L = cfg.n_experts, cfg.d_ff, n_layers

    def nrm(shape, scale, dt):
        x = torch.randn(shape, generator=generator, device=generator.device)
        return (x * scale).to(device=device, dtype=dt)

    s_in, s_ff = d_model**-0.5, f**-0.5
    return {
        "router": nrm((L, d_model, e), s_in, torch.float32),
        "w1": nrm((L, e, d_model, f), s_in, dtype),
        "w3": nrm((L, e, d_model, f), s_in, dtype),
        "w2": nrm((L, e, f, d_model), s_ff, dtype),
    }


def capacity(cfg: MoEConfig, t: int) -> int:
    """Rows per expert for ``t`` tokens: ``int(cf * t * k / E)`` rounded up
    to a multiple of 8, at least 8."""
    cap = int(cfg.capacity_factor * t * cfg.top_k / cfg.n_experts)
    return max(8, -(-cap // 8) * 8)


def route(params: dict, x: torch.Tensor, cfg: MoEConfig) -> dict:
    """The router's decisions for x (T, D): ``probs`` (T, E) fp32, ``gate``
    (T, k) renormalized weights, ``expert`` (T, k) int64, ``rank`` (T, k)
    (the pair's offset in its expert's group), ``keep`` (T, k) bool
    (``rank < cap``), ``cap`` and ``aux`` (the Switch loss)."""
    t = x.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, t)
    logits = x.float() @ params["router"].float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, top_e = stable_topk(probs, k)  # (T, k): lax.top_k's order
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat_e = top_e.reshape(-1)  # (T*k,) expert of each (token, slot)
    # (E, T*k): the scan runs along the contiguous axis (PyTorch's scan down
    # the outer axis of a narrow (T*k, E) tensor is slow on the card)
    onehot = (torch.arange(e, device=x.device)[:, None] == flat_e[None, :]).to(torch.int32)
    upto = torch.cumsum(onehot, dim=1)  # pairs so far per expert
    counts = upto[:, -1]  # (E,)
    rank = upto.gather(0, flat_e[None, :])[0] - 1
    # Switch aux loss: E * sum_e f_e * p_e
    aux = e * torch.sum(probs.mean(dim=0) * (counts.float() / (t * k)))
    return {"probs": probs, "gate": gate, "expert": top_e, "rank": rank.reshape(t, k),
            "keep": (rank < cap).reshape(t, k), "cap": cap, "aux": aux}


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b with an fp32 result: the reference's
    ``preferred_element_type=float32`` (exact bf16 products, fp32 sums).

    fp32 operands take ``bmm``.  bf16 operands take ``bmm(out_dtype=fp32)``
    on the card where PyTorch has it and no gradient is wanted (that
    overload has no autograd formula); otherwise both operands are upcast
    to fp32 first, the same function (every bf16 product is exact in fp32)
    at the cost of an fp32 copy of the operands."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    wants_grad = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    if a.is_cuda and not wants_grad and bmm_out_dtype_available():
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


@functools.cache
def bmm_out_dtype_available() -> bool:
    """Whether this PyTorch has a CUDA kernel for ``bmm(..., out_dtype=)``."""
    return ("dtype" in torch.ops.aten.bmm.overloads()
            and torch._C._dispatch_has_kernel_for_dispatch_key("aten::bmm.dtype", "CUDA"))


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """x (T, D) token-major -> (y (T, D) in x's dtype, aux_loss fp32 0-d).

    ``T`` is every row the caller passes (a prefill bucket's padding, dead
    decode slots and a whole verify window count), as in the reference:
    it sets the capacity, so it decides which pairs drop."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    r = route(params, x, cfg)
    cap = r["cap"]
    keep = r["keep"].reshape(-1)
    # dispatch: pair (token, slot) -> row expert * cap + rank, dropped pairs
    # onto the scratch row e * cap
    slot = torch.where(keep, r["expert"].reshape(-1) * cap + r["rank"].reshape(-1), e * cap)
    xg = shard_hint(x[:, None, :].expand(t, k, d).reshape(t * k, d), "dp", None)
    xpad = x.new_zeros((e * cap + 1, d))
    xpad[slot] = xg
    xe = xpad[:e * cap].reshape(e, cap, d)
    # EP: experts over "model"; TP: capacity over dp, d_ff over "model"
    expert = cfg.shard_mode == "expert"
    if expert:
        xe = shard_hint(xe, "model", None, None)
    else:
        xe = shard_hint(xe, None, "dp", None)
    # grouped products (SwiGLU experts), fp32 accumulation
    h = _bmm_f32(xe, params["w1"])  # (E, C, F)
    g = _bmm_f32(xe, params["w3"])
    if expert:
        h = shard_hint(h, "model", None, None)
    else:
        h = shard_hint(h, None, "dp", "model")
    h = (F.silu(h) * g).to(x.dtype)
    ye = _bmm_f32(h, params["w2"])  # (E, C, D) fp32
    ye = shard_hint(ye, *(("model", None, None) if expert else (None, "dp", None)))
    ye = ye.reshape(e * cap, d)
    # combine: each pair's row, gated, summed over its k slots.  The gather
    # is index_select: its backward adds each kept row once (dropped pairs
    # add zeros), where advanced indexing's backward sorts its indices
    yg = shard_hint(
        torch.where(keep[:, None], ye.index_select(0, torch.clamp(slot, max=e * cap - 1)), 0.0),
        "dp", None)
    y = (yg * r["gate"].reshape(-1)[:, None]).reshape(t, k, d).sum(dim=1)
    return y.to(x.dtype), r["aux"]
