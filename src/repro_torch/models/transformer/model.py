"""Decoder-only LM: init, train forward with a streamed loss, prefill and
decode over a contiguous KV arena.  Dense SwiGLU FFN, GQA + RoPE, optional
sliding window.

Parameters are a plain dict with the reference's structure and layout:
``embed`` (V, D), ``head`` (D, V), ``ln_f`` (D,), and ``layers`` whose
leaves are stacked on a leading L axis (``wq`` (L, D, H*dh), ...).  Training
may pass ``layers`` as a list of per-layer dicts instead (see
:func:`layer_params`).  A Python loop over layers stands where the reference
scans.  Projections, the FFN and the LM head are plain matmuls (cuBLAS on
the card), as the reference leaves them to XLA.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.models.transformer import attention as attn
from repro_torch.models.transformer.config import TransformerConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def _dtype(cfg: TransformerConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _check_supported(cfg: TransformerConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError("MoE FFN is not ported yet: ROADMAP Queue 1 item 16")
    if cfg.kv_quant:
        raise NotImplementedError("int8 KV cache is not ported yet: ROADMAP Queue 1 item 10")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    s = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * s * w.float()).to(x.dtype)


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------
def init_params(cfg: TransformerConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random weights with the reference's shapes and scales, drawn from
    ``generator`` (on its own device) and stored on ``device``."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    d, h, kv, dh, L = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.n_layers

    def nrm(shape, scale):
        x = torch.randn(shape, generator=generator, device=generator.device)
        return (x * scale).to(device=dev, dtype=dtype)

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    s_d = d**-0.5
    layers = {
        "ln1": ones((L, d)),
        "ln2": ones((L, d)),
        "wq": nrm((L, d, h * dh), s_d),
        "wk": nrm((L, d, kv * dh), s_d),
        "wv": nrm((L, d, kv * dh), s_d),
        "wo": nrm((L, h * dh, d), (h * dh) ** -0.5),
        "w1": nrm((L, d, cfg.d_ff), s_d),
        "w3": nrm((L, d, cfg.d_ff), s_d),
        "w2": nrm((L, cfg.d_ff, d), cfg.d_ff**-0.5),
    }
    return {
        "embed": nrm((cfg.vocab, d), 1.0),
        "layers": layers,
        "ln_f": ones((d,)),
        "head": nrm((d, cfg.vocab), s_d),
    }


def params_from_jax(params_np: dict, cfg: TransformerConfig, device="cuda") -> dict:
    """The reference's parameter pytree (leaves as numpy arrays, layers
    stacked on L) as the port's parameters, so both compute one function."""
    _check_supported(cfg)
    dev = resolve_device(device)

    def conv(x):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16 has no torch twin
            return torch.from_numpy(a.astype(np.float32)).to(device=dev, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(dev)

    return {
        "embed": conv(params_np["embed"]),
        "layers": {name: conv(v) for name, v in params_np["layers"].items()},
        "ln_f": conv(params_np["ln_f"]),
        "head": conv(params_np["head"]),
    }


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s weights: ``params["layers"]`` is either the stacked
    dict (serving, the reference's layout) or a list of per-layer dicts
    (training: indexing a stacked leaf that requires grad would make
    autograd allocate and zero-fill a full (L, ...) gradient per layer)."""
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        return layers[i]
    return {name: v[i] for name, v in layers.items()}


def _attn_proj(p, xn, cfg: TransformerConfig):
    b, s, _ = xn.shape
    q = (xn @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.d_head)
    k = (xn @ p["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = (xn @ p["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    return q, k, v


def _ffn(p, x, cfg: TransformerConfig):
    xn = rms_norm(x, p["ln2"], cfg.norm_eps)
    y = (F.silu(xn @ p["w1"]) * (xn @ p["w3"])) @ p["w2"]
    return x + y.to(x.dtype)


# --------------------------------------------------------------------------
# train-time forward + streamed loss
# --------------------------------------------------------------------------
def _attention(q, k, v, cfg: TransformerConfig, use_kernel):
    if q.shape[1] <= max(cfg.q_chunk, 256):
        return attn.dense_attention(q, k, v, window=cfg.sliding_window)
    return attn.chunked_attention(q, k, v, window=cfg.sliding_window, q_chunk=cfg.q_chunk,
                                  kv_chunk=cfg.kv_chunk, use_kernel=use_kernel)


def _layer_train(x, p, cfg: TransformerConfig, positions, use_kernel=None):
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _attn_proj(p, xn, cfg)
    q = attn.rope(q, positions, cfg.rope_theta)
    k = attn.rope(k, positions, cfg.rope_theta)
    o = _attention(q, k, v, cfg, use_kernel)
    b, s, h, dh = o.shape
    x = x + (o.reshape(b, s, h * dh) @ p["wo"]).to(x.dtype)
    return _ffn(p, x, cfg)


def backbone(params, tokens: torch.Tensor, cfg: TransformerConfig, use_kernel=None):
    """tokens (B, S) -> (hidden (B, S, D), aux_loss).  With ``cfg.remat``
    each layer is recomputed in the backward (non-reentrant
    ``torch.utils.checkpoint``), so only layer inputs are kept."""
    _check_supported(cfg)
    x = params["embed"][tokens.long()]
    positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)[None, :]
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        if remat:  # the layer draws no random numbers: no RNG state to keep
            x = checkpoint(_layer_train, x, p, cfg, positions, use_kernel,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _layer_train(x, p, cfg, positions, use_kernel)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)  # dense FFN: no router loss
    return rms_norm(x, params["ln_f"], cfg.norm_eps), aux


def lm_logits(params, tokens, cfg: TransformerConfig, use_kernel=None):
    """Materialized logits — tests and small shapes only."""
    x, _ = backbone(params, tokens, cfg, use_kernel)
    return x.float() @ params["head"].float()


def lm_loss(params, tokens, loss_mask, cfg: TransformerConfig, aux_weight: float = 0.01,
            use_kernel=None):
    """Next-token cross-entropy, streamed over sequence chunks of
    ``cfg.loss_chunk``: (B, chunk, V) fp32 logit blocks instead of one
    (B, S, V) product (the backward keeps each block for its logsumexp).

    tokens (B, S) int; loss_mask (B, S) — mask[t] gates the prediction of
    token[t+1].  Returns (loss, metrics dict ``nll``, ``aux``, ``tokens``).
    """
    x, aux = backbone(params, tokens, cfg, use_kernel)
    s = x.shape[1]
    n_pred = s - 1
    c = min(cfg.loss_chunk, n_pred)
    head = params["head"].float()
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for st in range(0, n_pred, c):  # nc full chunks, then the remainder
        en = min(st + c, n_pred)
        lg = x[:, st:en].float() @ head  # (B, c, V)
        tgt = torch.gather(lg, -1, tokens[:, st + 1:en + 1, None].long())[..., 0]
        mc = loss_mask[:, st:en].float()
        nll = nll + ((torch.logsumexp(lg, dim=-1) - tgt) * mc).sum()
        cnt = cnt + mc.sum()
    loss = nll / torch.clamp(cnt, min=1.0)
    return loss + aux_weight * aux, {"nll": loss, "aux": aux, "tokens": cnt}


# --------------------------------------------------------------------------
# serving: KV cache, prefill, decode
# --------------------------------------------------------------------------
@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # (L, B, Sc, KV, dh)
    v: torch.Tensor  # (L, B, Sc, KV, dh)
    pos: torch.Tensor  # (B, Sc) int32 absolute position per slot, -1 empty
    cursor: torch.Tensor  # (B,) int32 next absolute position to write


def init_cache(cfg: TransformerConfig, batch: int, cache_len: int, device="cuda") -> KVCache:
    _check_supported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.d_head)
    return KVCache(
        k=torch.zeros(shape, dtype=_dtype(cfg), device=dev),
        v=torch.zeros(shape, dtype=_dtype(cfg), device=dev),
        pos=torch.full((batch, cache_len), -1, dtype=torch.int32, device=dev),
        cursor=torch.zeros((batch,), dtype=torch.int32, device=dev),
    )


@torch.no_grad()
def prefill(params, tokens: torch.Tensor, true_len: torch.Tensor,
            cfg: TransformerConfig, cache_len: int, use_kernel=None):
    """Run the prompt, fill a fresh cache, return (next_token_logits, cache).

    tokens (B, S) left-aligned, padded; true_len (B,).  Requires S <= cache_len.
    Prompts longer than ``max(q_chunk, 256)`` take flash attention
    (``use_kernel`` as in :func:`attention.chunked_attention`).
    """
    _check_supported(cfg)
    b, s = tokens.shape
    if s > cache_len:
        raise ValueError(f"prompt bucket {s} exceeds cache_len {cache_len}")
    dev = tokens.device
    x = params["embed"][tokens.long()]
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None, :]
    shape = (cfg.n_layers, b, cache_len, cfg.n_kv_heads, cfg.d_head)
    kc = torch.zeros(shape, dtype=x.dtype, device=dev)
    vc = torch.zeros(shape, dtype=x.dtype, device=dev)
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        xn = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = _attn_proj(p, xn, cfg)
        q = attn.rope(q, positions, cfg.rope_theta)
        k = attn.rope(k, positions, cfg.rope_theta)
        o = _attention(q, k, v, cfg, use_kernel)
        x = x + (o.reshape(b, s, -1) @ p["wo"]).to(x.dtype)
        x = _ffn(p, x, cfg)
        kc[i, :, :s] = k
        vc[i, :, :s] = v
    slot_pos = torch.arange(cache_len, dtype=torch.int32, device=dev)[None, :]
    pos = torch.where(slot_pos < true_len[:, None], slot_pos, -1).to(torch.int32)
    cache = KVCache(k=kc, v=vc, pos=pos, cursor=true_len.to(torch.int32))
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    last = x[torch.arange(b, device=dev), torch.clamp(true_len - 1, min=0).long()]  # (B, D)
    return last.float() @ params["head"].float(), cache


@torch.no_grad()
def decode_step(params, cache: KVCache, token: torch.Tensor, cfg: TransformerConfig):
    """One decode step.  token (B,) int32 -> (logits (B, V), cache).

    Updates ``cache`` in place and returns it (the reference builds a new
    cache each step): at the serving shape the arena is 0.5 GB, and a copy
    would add a read and a write of all of it to every step.
    """
    _check_supported(cfg)
    b = token.shape[0]
    sc = cache.k.shape[2]
    cur = cache.cursor  # (B,) position of the token being processed
    slot = (cur % sc).long()
    bidx = torch.arange(b, device=token.device)
    pos = cache.pos.clone()
    pos[bidx, slot] = cur
    x = params["embed"][token.long()][:, None]  # (B, 1, D)
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        xn = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = _attn_proj(p, xn, cfg)
        q = attn.rope(q, cur[:, None], cfg.rope_theta)
        k = attn.rope(k, cur[:, None], cfg.rope_theta)
        cache.k[i, bidx, slot] = k[:, 0]
        cache.v[i, bidx, slot] = v[:, 0]
        o = attn.decode_attention(q, cache.k[i], cache.v[i], pos, cur, cfg.sliding_window)
        x = x + (o.reshape(b, 1, -1) @ p["wo"]).to(x.dtype)
        x = _ffn(p, x, cfg)
    cache.pos = pos
    cache.cursor = cur + 1
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x[:, 0].float() @ params["head"].float(), cache


def serve_step(params, cache: KVCache, token: torch.Tensor, cfg: TransformerConfig):
    """Greedy decode step: (next tokens (B,) int32, cache)."""
    logits, cache = decode_step(params, cache, token, cfg)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def _not_ported(name: str, item: str):
    def stub(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet: ROADMAP Queue 1 item {item}")
    stub.__name__ = name
    return stub


verify_window = _not_ported("verify_window", "11 (speculative decode)")
verify_step = _not_ported("verify_step", "11 (speculative decode)")
init_paged_cache = _not_ported("init_paged_cache", "10 (paged KV)")
paged_decode_step = _not_ported("paged_decode_step", "10 (paged KV)")
paged_serve_step = _not_ported("paged_serve_step", "10 (paged KV)")
paged_verify_step = _not_ported("paged_verify_step", "11 (speculative decode over paged KV)")
