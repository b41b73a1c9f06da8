"""Attention: RoPE, dense and chunked (flash) causal/sliding-window attention
for training and prefill, and KV-cache decode and speculative-verify
attention over a contiguous arena or, through a block table, a paged pool
(int8 rows with scales or the working dtype).

Layouts are the reference's (``repro.models.transformer.attention``):
queries (B, S, H, dh), keys/values (B, S, KV, dh), GQA by grouping the H
query heads as (KV, rep).  Scores, softmax and the online-softmax state are
float32 whatever the working dtype, as the reference's
``preferred_element_type=float32``: inputs are upcast before each product,
which is exact for bf16.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attn import ops as fa_ops

NEG = -1e30


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, dh); positions: broadcastable to (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freq  # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class _Flash(torch.autograd.Function):
    """Flash attention with the FlashAttention-2 backward (the counterpart
    of the reference's ``_flash`` custom VJP): the forward saves
    (q, k, v, o, lse) and the backward recomputes score tiles from them."""

    @staticmethod
    def forward(ctx, q, k, v, window, cq, ck, use_kernel):
        o, lse = fa_ops.flash_fwd(q, k, v, window=window, q_chunk=cq, kv_chunk=ck,
                                  use_kernel=use_kernel)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (window, cq, ck, use_kernel)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        window, cq, ck, use_kernel = ctx.args
        dq, dk, dv = fa_ops.flash_bwd(q, k, v, o, lse, do, window=window, q_chunk=cq,
                                      kv_chunk=ck, use_kernel=use_kernel)
        return dq, dk, dv, None, None, None, None


def chunked_attention(q, k, v, *, window: Optional[int] = None, q_chunk: int = 512,
                      kv_chunk: int = 512, use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Differentiable flash attention: q (B,S,H,dh), k/v (B,S,KV,dh).

    The largest intermediate is one (B, KV, rep, Cq, Ck) tile instead of
    (B, H, S, S), forward and backward.  A CUDA tensor runs the hand-written
    kernels (``kernels/flash_attn``), a CPU tensor the plain version tiled by
    (q_chunk, kv_chunk); ``use_kernel=False`` forces the plain version on
    the card."""
    if use_kernel is None:
        use_kernel = q.is_cuda
    return _Flash.apply(q, k, v, window, q_chunk, kv_chunk, use_kernel)


def dense_attention(q, k, v, *, window: Optional[int] = None) -> torch.Tensor:
    """O(S^2)-memory attention (prefill of prompts up to 512 tokens)."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    qg = q.reshape(b, s, kvh, rep, dh)
    s_ = torch.einsum("bqkrd,bckd->bkrqc", qg.float(), k.float()) * (dh**-0.5)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    m = j <= i
    if window is not None:
        m &= (i - j) < window
    p = torch.softmax(torch.where(m, s_, NEG), dim=-1)
    o = torch.einsum("bkrqc,bckd->bqkrd", p.to(v.dtype), v)
    return o.reshape(b, s, h, dh)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, dh) — current-step query (already RoPE'd)
    k_cache: torch.Tensor,  # (B, Sc, KV, dh) — rotated keys at absolute pos
    v_cache: torch.Tensor,  # (B, Sc, KV, dh)
    kv_pos: torch.Tensor,  # (B, Sc) absolute positions, -1 = empty slot
    cur_pos: torch.Tensor,  # (B,) position of the current token
    window: Optional[int] = None,
    k_new: Optional[torch.Tensor] = None,  # (B, 1, KV, dh) current token's k/v,
    v_new: Optional[torch.Tensor] = None,  # attended WITHOUT a cache write
    k_scale: Optional[torch.Tensor] = None,  # (B, Sc, KV) int8-mode absmax scales
    v_scale: Optional[torch.Tensor] = None,  # (dequantization folded into the products)
) -> torch.Tensor:
    b, _, h, dh = q.shape
    kvh = k_cache.shape[2]
    rep = h // kvh
    qg = q.reshape(b, kvh, rep, dh).float()
    s_ = torch.einsum("bkrd,bckd->bkrc", qg, k_cache.float()) * (dh**-0.5)
    if k_scale is not None:  # int8 cache: dequantize the scores
        s_ = s_ * k_scale.permute(0, 2, 1).float()[:, :, None]
    # strict `<` with k_new: the current position is the appended self term,
    # and the ring slot it would overwrite is stale
    lim_ok = kv_pos < cur_pos[:, None] if k_new is not None else kv_pos <= cur_pos[:, None]
    ok = (kv_pos >= 0) & lim_ok
    if window is not None:
        ok &= (cur_pos[:, None] - kv_pos) < window
    s_ = torch.where(ok[:, None, None], s_, NEG)  # (B, KV, rep, Sc)
    if k_new is None:
        p = torch.softmax(s_, dim=-1)
        if v_scale is not None:  # fold the dequantization into p; P·V in fp32
            p = p * v_scale.permute(0, 2, 1).float()[:, :, None]
            o = torch.einsum("bkrc,bckd->bkrd", p, v_cache.float())
            return o.to(q.dtype).reshape(b, 1, h, dh)
        o = torch.einsum("bkrc,bckd->bkrd", p.to(v_cache.dtype), v_cache)
        return o.reshape(b, 1, h, dh)
    s_self = torch.einsum("bkrd,bkd->bkr", qg, k_new[:, 0].float())[..., None] * (dh**-0.5)
    m = torch.maximum(s_.amax(dim=-1, keepdim=True), s_self)
    e_c = torch.exp(s_ - m)
    e_s = torch.exp(s_self - m)
    den = e_c.sum(dim=-1, keepdim=True) + e_s
    o = torch.einsum("bkrc,bckd->bkrd", (e_c / den).to(v_cache.dtype), v_cache)
    o = o + (e_s / den).to(v_new.dtype) * v_new[:, 0][:, :, None, :]
    return o.reshape(b, 1, h, dh)


def verify_attention(
    q: torch.Tensor,  # (B, W, H, dh) RoPE'd queries of W fed tokens
    k_cache: torch.Tensor,  # (B, Sc, KV, dh), the W fresh rows included
    v_cache: torch.Tensor,  # (B, Sc, KV, dh)
    kv_pos: torch.Tensor,  # (B, Sc) absolute positions, -1 = empty slot
    q_pos: torch.Tensor,  # (B, W) absolute position of each fed token
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # (B, Sc, KV) int8-mode absmax scales
    v_scale: Optional[torch.Tensor] = None,  # (dequantization folded into the products)
) -> torch.Tensor:
    """Decode attention for W query positions at once (speculative
    verification).  Query *i* sees ``kv_pos <= q_pos[:, i]``, the rule
    :func:`decode_attention` applies to its one query, so each position
    attends over exactly the cache a sequential decode step there would
    see: fed tokens at later positions are in the arena but masked out."""
    b, w, h, dh = q.shape
    kvh = k_cache.shape[2]
    rep = h // kvh
    qg = q.reshape(b, w, kvh, rep, dh).float()
    s_ = torch.einsum("bwkrd,bckd->bkrwc", qg, k_cache.float()) * (dh**-0.5)
    if k_scale is not None:  # int8 cache: dequantize the scores
        s_ = s_ * k_scale.permute(0, 2, 1).float()[:, :, None, None]
    ok = (kv_pos[:, None, :] >= 0) & (kv_pos[:, None, :] <= q_pos[..., None])  # (B, W, Sc)
    if window is not None:
        ok &= (q_pos[..., None] - kv_pos[:, None, :]) < window
    s_ = torch.where(ok[:, None, None], s_, NEG)  # (B, KV, rep, W, Sc)
    p = torch.softmax(s_, dim=-1)
    if v_scale is not None:  # fold the dequantization into p; P·V in fp32
        p = p * v_scale.permute(0, 2, 1).float()[:, :, None, None]
        o = torch.einsum("bkrwc,bckd->bkrwd", p, v_cache.float()).to(q.dtype)
    else:
        o = torch.einsum("bkrwc,bckd->bkrwd", p.to(v_cache.dtype), v_cache)
    return o.permute(0, 3, 1, 2, 4).reshape(b, w, h, dh)


# --------------------------------------------------------------------------
# paged KV: block-table indirection in front of the decode attention
# --------------------------------------------------------------------------
def paged_gather(pool: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """A per-slot contiguous view out of a shared paged pool: ``pool``
    (P, ...) holds every slot's KV rows, ``rows`` (B, Sc) maps each slot's
    logical row to its pool row (0 under unallocated blocks, see
    ``model.block_rows``).  One gather -> (B, Sc, ...), the layout
    :func:`decode_attention` takes."""
    return pool[rows.long()]


def paged_decode_attention(
    q: torch.Tensor,  # (B, 1, H, dh) current-step query (already RoPE'd)
    k_pool: torch.Tensor,  # (P, KV, dh) this layer's shared block pool
    v_pool: torch.Tensor,  # (P, KV, dh)
    rows: torch.Tensor,  # (B, Sc) block-table row map (see paged_gather)
    kv_pos: torch.Tensor,  # (B, Sc) absolute positions, -1 = empty/unallocated
    cur_pos: torch.Tensor,  # (B,) position of the current token
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # (P, KV) int8-mode scales
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gather the slots' logical views from the pool, then run
    :func:`decode_attention` unchanged.  Rows gathered from unallocated
    blocks (pool row 0) carry ``kv_pos == -1``: the NEG mask makes their
    probabilities exactly 0, so the output equals a contiguous arena's
    holding the same live rows bit for bit (the gathered tensor has the
    arena's shape and layout)."""
    kc = paged_gather(k_pool, rows)
    vc = paged_gather(v_pool, rows)
    ks = paged_gather(k_scale, rows) if k_scale is not None else None
    vs = paged_gather(v_scale, rows) if v_scale is not None else None
    return decode_attention(q, kc, vc, kv_pos, cur_pos, window, k_scale=ks, v_scale=vs)


def paged_verify_attention(
    q: torch.Tensor,  # (B, W, H, dh) RoPE'd queries of W fed tokens
    k_pool: torch.Tensor,  # (P, KV, dh), the W fresh rows included
    v_pool: torch.Tensor,  # (P, KV, dh)
    rows: torch.Tensor,  # (B, Sc) block-table row map
    kv_pos: torch.Tensor,  # (B, Sc) absolute positions, -1 = empty
    q_pos: torch.Tensor,  # (B, W) absolute position of each fed token
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # (P, KV)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`verify_attention` through the block table: the same gather,
    then the contiguous function unchanged (and the same bit-for-bit
    argument as :func:`paged_decode_attention`)."""
    kc = paged_gather(k_pool, rows)
    vc = paged_gather(v_pool, rows)
    ks = paged_gather(k_scale, rows) if k_scale is not None else None
    vs = paged_gather(v_scale, rows) if v_scale is not None else None
    return verify_attention(q, kc, vc, kv_pos, q_pos, window, k_scale=ks, v_scale=vs)
