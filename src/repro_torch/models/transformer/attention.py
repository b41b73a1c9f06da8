"""Attention: RoPE, dense and chunked (online-softmax) causal/sliding-window
attention for prefill, and KV-cache decode attention.

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


def _tile_mask(qi: int, kj: int, cq: int, ck: int, window, device) -> torch.Tensor:
    """(Cq, Ck) causal/windowed mask for the tile at q-offset qi, kv-offset kj."""
    iq = qi + torch.arange(cq, device=device)[:, None]
    jk = kj + torch.arange(ck, device=device)[None, :]
    m = jk <= iq
    if window is not None:
        m &= (iq - jk) < window
    return m


def chunked_attention(q, k, v, *, window: Optional[int] = None, q_chunk: int = 512,
                      kv_chunk: int = 512, use_kernel: bool = False) -> torch.Tensor:
    """Flash-style attention forward: a loop over (q-chunk, kv-chunk) tiles
    with online-softmax accumulators, so the largest intermediate is one
    (B, KV, rep, Cq, Ck) tile instead of (B, H, S, S)."""
    if use_kernel:
        raise NotImplementedError(
            "the flash_attn kernel is not ported yet: ROADMAP Queue 2 item 3"
        )
    s = q.shape[1]
    cq = min(q_chunk, s)
    ck = min(kv_chunk, s)
    if s % cq or s % ck:
        raise ValueError(f"sequence {s} is not a multiple of the chunks ({cq}, {ck})")
    return _flash_fwd(q, k, v, window, cq, ck)


def _flash_fwd(q, k, v, window, cq: int, ck: int) -> torch.Tensor:
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    nq, nk = s // cq, s // ck
    scale = dh**-0.5
    qg = q.reshape(b, nq, cq, kvh, rep, dh)
    kg = k.reshape(b, nk, ck, kvh, dh)
    vg = v.reshape(b, nk, ck, kvh, dh)
    outs = []
    for qi in range(nq):
        qb = qg[:, qi].float()  # (B, Cq, KV, rep, dh)
        m = torch.full((b, kvh, rep, cq), NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kvh, rep, cq), dtype=torch.float32, device=q.device)
        o = torch.zeros((b, kvh, rep, cq, dh), dtype=torch.float32, device=q.device)
        for kj in range(nk):
            kb, vb = kg[:, kj], vg[:, kj]  # (B, Ck, KV, dh)
            s_ = torch.einsum("bqkrd,bckd->bkrqc", qb, kb.float()) * scale
            tm = _tile_mask(qi * cq, kj * ck, cq, ck, window, q.device)
            s_ = torch.where(tm, s_, NEG)
            m_new = torch.maximum(m, s_.amax(dim=-1))
            p = torch.exp(s_ - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum(
                "bkrqc,bckd->bkrqd", p.to(vb.dtype).float(), vb.float()
            )
            m = m_new
        outs.append((o / torch.clamp(l[..., None], min=1e-20)).to(q.dtype))
    out = torch.stack(outs, dim=1)  # (B, nq, KV, rep, Cq, dh)
    return out.permute(0, 1, 4, 2, 3, 5).reshape(b, s, h, dh)


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
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "int8 KV cache (kv_quant) is not ported yet: ROADMAP Queue 1 item 10"
        )
    b, _, h, dh = q.shape
    kvh = k_cache.shape[2]
    rep = h // kvh
    qg = q.reshape(b, kvh, rep, dh).float()
    s_ = torch.einsum("bkrd,bckd->bkrc", qg, k_cache.float()) * (dh**-0.5)
    # strict `<` with k_new: the current position is the appended self term,
    # and the ring slot it would overwrite is stale
    lim_ok = kv_pos < cur_pos[:, None] if k_new is not None else kv_pos <= cur_pos[:, None]
    ok = (kv_pos >= 0) & lim_ok
    if window is not None:
        ok &= (cur_pos[:, None] - kv_pos) < window
    s_ = torch.where(ok[:, None, None], s_, NEG)  # (B, KV, rep, Sc)
    if k_new is None:
        p = torch.softmax(s_, dim=-1)
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
