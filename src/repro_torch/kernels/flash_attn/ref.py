"""Plain PyTorch version of flash attention, forward and backward.

``flash_fwd`` and ``flash_bwd`` repeat the reference's ``_flash_fwd`` and
``_flash_bwd`` (``repro.models.transformer.attention``) tile by tile:
(q-chunk, kv-chunk) loops with an fp32 online softmax, −1e30 masking,
``p`` rounded to v's type before P·V, and a backward whose p, dp, ds and
every product are fp32.  Inputs are upcast before each product, which is
exact for bf16 (the reference's ``preferred_element_type=float32``).
``attention`` is the GQA-aware dense oracle of ``repro.kernels.flash_attn.ref``.
``split_bf16`` is the tensor-core backward kernels' operand split of p and ds.

Layouts: q, o, do (B, S, H, dh); k, v (B, S, KV, dh) with query head h on KV
head h // (H // KV); lse and delta (B, H, S) fp32 — the kernel's layout (the
reference keeps lse per q-chunk, (B, nq, KV, rep, Cq)).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG = -1e30


def attention(q, k, v, *, window: Optional[int] = None) -> torch.Tensor:
    """Causal (optionally sliding-window) attention over the full (S, S)
    score matrix: q (B,S,H,dh), k/v (B,S,KV,dh) -> (B,S,H,dh)."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, dh)
    scores = torch.einsum("bqkrd,bckd->bkrqc", qg.float(), k.float()) * (dh**-0.5)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    m = j <= i
    if window is not None:
        m &= (i - j) < window
    p = torch.softmax(torch.where(m, scores, NEG), dim=-1)
    o = torch.einsum("bkrqc,bckd->bqkrd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype).reshape(b, s, h, dh)


def split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The operand split of the tensor-core backward kernels
    (``csrc/flash_attn.cu``): an fp32 ``x`` as ``hi = bf16(x)`` and
    ``lo = bf16(x - hi)``, each rounded to nearest even.  ``hi + lo`` holds
    x to within 2^-17 |x|, so a product of x with a bf16 operand runs as two
    bf16 products accumulating in fp32 at the reference's accuracy."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def tile_mask(qi: int, kj: int, cq: int, ck: int, window, device) -> torch.Tensor:
    """(Cq, Ck) causal/windowed mask for the tile at q-offset qi, kv-offset kj."""
    iq = qi + torch.arange(cq, device=device)[:, None]
    jk = kj + torch.arange(ck, device=device)[None, :]
    m = jk <= iq
    if window is not None:
        m &= (iq - jk) < window
    return m


def _lse_to_heads(lse: torch.Tensor) -> torch.Tensor:
    """(B, nq, KV, rep, Cq) -> (B, H, S)."""
    b, nq, kvh, rep, cq = lse.shape
    return lse.permute(0, 2, 3, 1, 4).reshape(b, kvh * rep, nq * cq)


def _lse_to_chunks(lse: torch.Tensor, kvh: int, cq: int) -> torch.Tensor:
    """(B, H, S) -> (B, nq, KV, rep, Cq)."""
    b, h, s = lse.shape
    return lse.reshape(b, kvh, h // kvh, s // cq, cq).permute(0, 3, 1, 2, 4)


def flash_fwd(q, k, v, window, cq: int, ck: int):
    """Forward: (o like q, lse (B, H, S) fp32)."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    nq, nk = s // cq, s // ck
    scale = dh**-0.5
    qg = q.reshape(b, nq, cq, kvh, rep, dh)
    kg = k.reshape(b, nk, ck, kvh, dh)
    vg = v.reshape(b, nk, ck, kvh, dh)
    outs, lses = [], []
    for qi in range(nq):
        qb = qg[:, qi].float()  # (B, Cq, KV, rep, dh)
        m = torch.full((b, kvh, rep, cq), NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kvh, rep, cq), dtype=torch.float32, device=q.device)
        o = torch.zeros((b, kvh, rep, cq, dh), dtype=torch.float32, device=q.device)
        for kj in range(nk):
            kb, vb = kg[:, kj], vg[:, kj]  # (B, Ck, KV, dh)
            s_ = torch.einsum("bqkrd,bckd->bkrqc", qb, kb.float()) * scale
            s_ = torch.where(tile_mask(qi * cq, kj * ck, cq, ck, window, q.device), s_, NEG)
            m_new = torch.maximum(m, s_.amax(dim=-1))
            p = torch.exp(s_ - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum(
                "bkrqc,bckd->bkrqd", p.to(vb.dtype).float(), vb.float()
            )
            m = m_new
        den = torch.clamp(l, min=1e-20)
        outs.append((o / den[..., None]).to(q.dtype))
        lses.append(m + torch.log(den))
    out = torch.stack(outs, dim=1)  # (B, nq, KV, rep, Cq, dh)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(b, s, h, dh)
    return out, _lse_to_heads(torch.stack(lses, dim=1))


def _tile_p(qb, kb, lse_q, qi, kj, cq, ck, window, scale):
    """exp(s - lse) of one (q-chunk, kv-chunk) tile: (B, KV, rep, Cq, Ck)."""
    s_ = torch.einsum("bqkrd,bckd->bkrqc", qb.float(), kb.float()) * scale
    s_ = torch.where(tile_mask(qi * cq, kj * ck, cq, ck, window, qb.device), s_, NEG)
    return torch.exp(s_ - lse_q[..., None])


def flash_bwd_dq(q, k, v, o, do, lse, window, cq: int, ck: int):
    """Backward pass 1: (dq like q, delta (B, H, S) fp32), delta = rowsum(do·o)."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    nq, nk = s // cq, s // ck
    scale = dh**-0.5
    qg = q.reshape(b, nq, cq, kvh, rep, dh)
    kg = k.reshape(b, nk, ck, kvh, dh)
    vg = v.reshape(b, nk, ck, kvh, dh)
    dog = do.reshape(b, nq, cq, kvh, rep, dh).float()
    og = o.reshape(b, nq, cq, kvh, rep, dh).float()
    delta = torch.einsum("bnqkrd,bnqkrd->bnkrq", dog, og)  # (B, nq, KV, rep, Cq)
    lse_c = _lse_to_chunks(lse, kvh, cq)
    dqs = []
    for qi in range(nq):
        acc = torch.zeros((b, cq, kvh, rep, dh), dtype=torch.float32, device=q.device)
        for kj in range(nk):
            p = _tile_p(qg[:, qi], kg[:, kj], lse_c[:, qi], qi, kj, cq, ck, window, scale)
            dp = torch.einsum("bqkrd,bckd->bkrqc", dog[:, qi], vg[:, kj].float())
            ds = p * (dp - delta[:, qi][..., None]) * scale
            acc = acc + torch.einsum("bkrqc,bckd->bqkrd", ds, kg[:, kj].float())
        dqs.append(acc)
    dq = torch.stack(dqs, dim=1).reshape(b, s, h, dh).to(q.dtype)
    return dq, _lse_to_heads(delta)


def flash_bwd_dkv(q, k, v, do, lse, delta, window, cq: int, ck: int):
    """Backward pass 2: (dk, dv) like k, summed over each KV head's rep
    query heads."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    nq, nk = s // cq, s // ck
    scale = dh**-0.5
    qg = q.reshape(b, nq, cq, kvh, rep, dh)
    kg = k.reshape(b, nk, ck, kvh, dh)
    vg = v.reshape(b, nk, ck, kvh, dh)
    dog = do.reshape(b, nq, cq, kvh, rep, dh).float()
    lse_c = _lse_to_chunks(lse, kvh, cq)
    delta_c = _lse_to_chunks(delta, kvh, cq)
    dks, dvs = [], []
    for kj in range(nk):
        dk_acc = torch.zeros((b, ck, kvh, dh), dtype=torch.float32, device=q.device)
        dv_acc = torch.zeros_like(dk_acc)
        for qi in range(nq):
            p = _tile_p(qg[:, qi], kg[:, kj], lse_c[:, qi], qi, kj, cq, ck, window, scale)
            dob = dog[:, qi]
            dv_acc = dv_acc + torch.einsum("bkrqc,bqkrd->bckd", p, dob)
            dp = torch.einsum("bqkrd,bckd->bkrqc", dob, vg[:, kj].float())
            ds = p * (dp - delta_c[:, qi][..., None]) * scale
            dk_acc = dk_acc + torch.einsum("bkrqc,bqkrd->bckd", ds, qg[:, qi].float())
        dks.append(dk_acc)
        dvs.append(dv_acc)
    dk = torch.stack(dks, dim=1).reshape(b, s, kvh, dh).to(k.dtype)
    dv = torch.stack(dvs, dim=1).reshape(b, s, kvh, dh).to(v.dtype)
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, window, cq: int, ck: int):
    """FlashAttention-2 backward: (dq, dk, dv)."""
    dq, delta = flash_bwd_dq(q, k, v, o, do, lse, window, cq, ck)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, window, cq, ck)
    return dq, dk, dv
