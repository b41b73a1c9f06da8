"""Decoder-only LM: init, train forward with a streamed loss, prefill,
decode and speculative verification over a contiguous KV arena or a paged
block pool (optionally int8 with per-row scales).  Dense SwiGLU or MoE FFN
(:mod:`~repro_torch.models.transformer.moe`), GQA + RoPE, optional sliding
window.

Parameters are a plain dict with the reference's structure and layout:
``embed`` (V, D), ``head`` (D, V), ``ln_f`` (D,), and ``layers`` whose
leaves are stacked on a leading L axis (``wq`` (L, D, H*dh), ...; a MoE
config holds a nested ``moe`` dict of stacked leaves instead of ``w1``,
``w3``, ``w2``).  Training may pass ``layers`` as a list of per-layer dicts
instead (see :func:`layer_params`).  A Python loop over layers stands where
the reference scans.  Projections, the FFN and the LM head are plain
matmuls (cuBLAS on the card), as the reference leaves them to XLA.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.distributed.constraints import shard_hint, zeros_hint
from repro_torch.models.transformer import attention as attn
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.models.transformer.moe import init_moe_params, moe_ffn
from repro_torch.tree import tree_map

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def _dtype(cfg: TransformerConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


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
    }
    if cfg.moe is None:
        layers.update(w1=nrm((L, d, cfg.d_ff), s_d), w3=nrm((L, d, cfg.d_ff), s_d),
                      w2=nrm((L, cfg.d_ff, d), cfg.d_ff**-0.5))
    else:
        layers["moe"] = init_moe_params(generator, d, cfg.moe, dtype, L, dev)
    return {
        "embed": nrm((cfg.vocab, d), 1.0),
        "layers": layers,
        "ln_f": ones((d,)),
        "head": nrm((d, cfg.vocab), s_d),
    }


def params_from_jax(params_np: dict, cfg: TransformerConfig, device="cuda") -> dict:
    """The reference's parameter pytree (leaves as numpy arrays, layers
    stacked on L, a MoE config's ``moe`` dict nested in them) as the port's
    parameters, so both compute one function.  Each leaf keeps its dtype
    (the fp32 norms and router stay fp32)."""
    dev = resolve_device(device)

    def conv(x):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16 has no torch twin
            return torch.from_numpy(a.astype(np.float32)).to(device=dev, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(dev)

    return {key: tree_map(conv, params_np[key]) for key in ("embed", "layers", "ln_f", "head")}


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s weights: ``params["layers"]`` is either the stacked
    dict (serving, the reference's layout) or a list of per-layer dicts
    (training: indexing a stacked leaf that requires grad would make
    autograd allocate and zero-fill a full (L, ...) gradient per layer).
    Nested dicts (``moe``) are sliced leaf by leaf."""
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        return layers[i]
    return tree_map(lambda v: v[i], layers)


def _attn_proj(p, xn, cfg: TransformerConfig):
    b, s, _ = xn.shape
    q = (xn @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.d_head)
    k = (xn @ p["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = (xn @ p["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    return q, k, v


def _ffn(p, x, cfg: TransformerConfig):
    """The FFN block with its residual: (x + FFN(norm(x)), aux).  The MoE
    FFN routes every row of ``x`` (the call site's B * S tokens, padding
    and dead slots included, as in the reference); ``aux`` is its Switch
    loss, None for the dense FFN."""
    xn = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe is None:
        y, aux = (F.silu(xn @ p["w1"]) * (xn @ p["w3"])) @ p["w2"], None
    else:
        y, aux = moe_ffn(p["moe"], xn.reshape(-1, xn.shape[-1]), cfg.moe)
        y = y.reshape(xn.shape)
    return x + y.to(x.dtype), aux


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
    x = params["embed"][tokens.long()]
    positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)[None, :]
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        if remat:  # the layer draws no random numbers: no RNG state to keep
            x, a = checkpoint(_layer_train, x, p, cfg, positions, use_kernel,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = _layer_train(x, p, cfg, positions, use_kernel)
        if a is not None:  # the layers' router losses, summed as the reference's scan does
            aux = aux + a
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
    k: torch.Tensor  # (L, B, Sc, KV, dh), int8 when quantized
    v: torch.Tensor  # (L, B, Sc, KV, dh)
    pos: torch.Tensor  # (B, Sc) int32 absolute position per slot, -1 empty
    cursor: torch.Tensor  # (B,) int32 next absolute position to write
    k_scale: Optional[torch.Tensor] = None  # (L, B, Sc, KV) bf16 absmax scales (int8 mode)
    v_scale: Optional[torch.Tensor] = None


def _quant_rows(x: torch.Tensor):
    """Per-(.., KV)-row absmax int8 quantization over d_head: the row is
    divided by its fp32 scale (absmax / 127, at least 1e-8), rounded half to
    even and clipped to +-127; the scale is stored as bf16."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def init_cache(cfg: TransformerConfig, batch: int, cache_len: int, device="cuda") -> KVCache:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.d_head)
    kv_dtype = torch.int8 if cfg.kv_quant else _dtype(cfg)

    def scales():
        return torch.zeros(shape[:-1], dtype=torch.bfloat16, device=dev) if cfg.kv_quant else None

    return KVCache(
        k=torch.zeros(shape, dtype=kv_dtype, device=dev),
        v=torch.zeros(shape, dtype=kv_dtype, device=dev),
        pos=torch.full((batch, cache_len), -1, dtype=torch.int32, device=dev),
        cursor=torch.zeros((batch,), dtype=torch.int32, device=dev),
        k_scale=scales(),
        v_scale=scales(),
    )


@torch.no_grad()
def prefill(params, tokens: torch.Tensor, true_len: torch.Tensor,
            cfg: TransformerConfig, cache_len: int, use_kernel=None):
    """Run the prompt, fill a fresh cache, return (next_token_logits, cache).

    tokens (B, S) left-aligned, padded; true_len (B,).  Requires S <= cache_len.
    Prompts longer than ``max(q_chunk, 256)`` take flash attention
    (``use_kernel`` as in :func:`attention.chunked_attention`).
    """
    b, s = tokens.shape
    if s > cache_len:
        raise ValueError(f"prompt bucket {s} exceeds cache_len {cache_len}")
    dev = tokens.device
    x = params["embed"][tokens.long()]
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None, :]
    shape = (cfg.n_layers, b, cache_len, cfg.n_kv_heads, cfg.d_head)
    quant = cfg.kv_quant
    # cache rows: batch over dp, sequence over "model" (decode layout);
    # unhinted, GSPMD replicated the 257 GB cache in the reference
    kv_dtype = torch.int8 if quant else x.dtype
    kc = zeros_hint(shape, None, "dp", "model", None, None, dtype=kv_dtype, device=dev)
    vc = zeros_hint(shape, None, "dp", "model", None, None, dtype=kv_dtype, device=dev)
    if quant:  # the padding rows quantize to 0 with the floor scale
        ks = torch.full(shape[:-1], 1e-8, dtype=torch.float32, device=dev).to(torch.bfloat16)
        vs = ks.clone()
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        xn = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = _attn_proj(p, xn, cfg)
        q = attn.rope(q, positions, cfg.rope_theta)
        k = attn.rope(k, positions, cfg.rope_theta)
        o = _attention(q, k, v, cfg, use_kernel)
        x = x + (o.reshape(b, s, -1) @ p["wo"]).to(x.dtype)
        x, _ = _ffn(p, x, cfg)
        k = shard_hint(k, "dp", "model", None, None)
        v = shard_hint(v, "dp", "model", None, None)
        if quant:
            kc[i, :, :s], ks[i, :, :s] = _quant_rows(k)
            vc[i, :, :s], vs[i, :, :s] = _quant_rows(v)
        else:
            kc[i, :, :s] = k
            vc[i, :, :s] = v
    slot_pos = torch.arange(cache_len, dtype=torch.int32, device=dev)[None, :]
    pos = torch.where(slot_pos < true_len[:, None], slot_pos, -1).to(torch.int32)
    cache = KVCache(k=kc, v=vc, pos=pos, cursor=true_len.to(torch.int32),
                    k_scale=ks if quant else None, v_scale=vs if quant else None)
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
        ks = vs = None
        if cfg.kv_quant:
            kq, ksc = _quant_rows(k)
            vq, vsc = _quant_rows(v)
            cache.k[i, bidx, slot] = kq[:, 0]
            cache.v[i, bidx, slot] = vq[:, 0]
            cache.k_scale[i, bidx, slot] = ksc[:, 0]
            cache.v_scale[i, bidx, slot] = vsc[:, 0]
            ks, vs = cache.k_scale[i], cache.v_scale[i]
        else:
            cache.k[i, bidx, slot] = k[:, 0]
            cache.v[i, bidx, slot] = v[:, 0]
        o = attn.decode_attention(q, cache.k[i], cache.v[i], pos, cur, cfg.sliding_window,
                                  k_scale=ks, v_scale=vs)
        x = x + (o.reshape(b, 1, -1) @ p["wo"]).to(x.dtype)
        x, _ = _ffn(p, x, cfg)
    cache.pos = pos
    cache.cursor = cur + 1
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x[:, 0].float() @ params["head"].float(), cache


def serve_step(params, cache: KVCache, token: torch.Tensor, cfg: TransformerConfig):
    """Greedy decode step: (next tokens (B,) int32, cache)."""
    logits, cache = decode_step(params, cache, token, cfg)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


# --------------------------------------------------------------------------
# self-speculative verification: score W fed tokens in one step
# --------------------------------------------------------------------------
@torch.no_grad()
def verify_window(params, cache: KVCache, tokens: torch.Tensor, cfg: TransformerConfig):
    """Score a window of fed tokens against the KV arena in one pass.

    tokens (B, W): column 0 is the last committed token, columns 1..W-1
    draft continuations.  Token *i* is processed at absolute position
    ``cursor + i``: all W rows are written first (only positions <
    cache_len, so a window near the arena's end never wraps onto a live
    row), then every query attends under the per-position mask of
    :func:`attention.verify_attention`, so each position sees exactly the
    cache a sequential :func:`decode_step` there would see.

    Returns (greedy (B, W) int32, cache) with all W rows written and the
    cursor unchanged; :func:`verify_step` advances it past the accepted
    prefix.  Rows of rejected positions stay: their ``pos`` exceeds every
    later query position until the cursor catches up, and the next window
    overwrites them before any attention runs.  The arena is updated in
    place, as in :func:`decode_step`.
    """
    b, w = tokens.shape
    sc = cache.k.shape[2]
    cur = cache.cursor  # (B,)
    positions = cur[:, None] + torch.arange(w, dtype=torch.int32, device=cur.device)[None, :]
    writable = positions < sc  # never wrap onto live rows
    slot = (positions % sc).long()  # distinct within a row for W <= Sc
    bidx = torch.arange(b, device=cur.device)[:, None]
    slot_mask = (torch.arange(sc, dtype=torch.int32, device=cur.device)[None, None, :]
                 == slot[..., None]) & writable[..., None]  # (B, W, Sc)
    pos = cache.pos
    for i in range(w):
        pos = torch.where(slot_mask[:, i], positions[:, i:i + 1], pos)
    wr = writable[..., None]

    def put(arena, i, rows):
        """arena[i, b, slot[b, j]] = rows[b, j] where writable (else keep)."""
        old = arena[i, bidx, slot]
        m = wr if rows.dim() == 3 else wr[..., None]
        arena[i, bidx, slot] = torch.where(m, rows, old)

    x = params["embed"][tokens.long()]  # (B, W, D)
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        xn = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = _attn_proj(p, xn, cfg)
        q = attn.rope(q, positions, cfg.rope_theta)
        k = attn.rope(k, positions, cfg.rope_theta)
        ks = vs = None
        if cfg.kv_quant:
            kq, ksc = _quant_rows(k)
            vq, vsc = _quant_rows(v)
            put(cache.k, i, kq)
            put(cache.v, i, vq)
            put(cache.k_scale, i, ksc)
            put(cache.v_scale, i, vsc)
            ks, vs = cache.k_scale[i], cache.v_scale[i]
        else:
            put(cache.k, i, k)
            put(cache.v, i, v)
        o = attn.verify_attention(q, cache.k[i], cache.v[i], pos, positions, cfg.sliding_window,
                                  k_scale=ks, v_scale=vs)
        x = x + (o.reshape(b, w, -1) @ p["wo"]).to(x.dtype)
        x, _ = _ffn(p, x, cfg)
    cache.pos = pos
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = x.float() @ params["head"].float()  # (B, W, V)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def _accept_prefix(greedy: torch.Tensor, tokens: torch.Tensor, room: torch.Tensor, w: int,
                   eos_id):
    """Greedy-exact acceptance, shared by both arenas: position 0 always
    accepts; draft *i* accepts iff it equals the accepted output at *i-1*;
    ``room`` caps the prefix (clamped to >= 1) and ``eos_id`` cuts it just
    past the first EOS.  Returns (accepted (B,) int32, cur_tok (B,))."""
    match = (tokens[:, 1:] == greedy[:, :-1]).to(torch.int32)  # (B, W-1)
    raw = 1 + torch.cumprod(match, dim=1).sum(dim=1)  # (B,) in [1, W]
    accepted = torch.minimum(raw, torch.clamp(room, min=1)).to(torch.int32)
    if eos_id is not None:
        idx = torch.arange(w, dtype=torch.int32, device=greedy.device)[None, :]
        is_eos = (greedy == eos_id) & (idx < accepted[:, None])
        first_eos = torch.where(is_eos, idx, w).amin(dim=1)
        accepted = torch.minimum(accepted, first_eos + 1).to(torch.int32)
    cur_tok = greedy.gather(1, (accepted - 1).long()[:, None])[:, 0]
    return accepted, cur_tok


def verify_step(params, cache: KVCache, tokens: torch.Tensor, room: torch.Tensor,
                cfg: TransformerConfig, eos_id=None):
    """One speculative step: verify W fed tokens, accept the greedy-matching
    prefix, and advance the cursor past it (rejected rows stay behind it).

    tokens (B, W): [last committed token, draft_1 .. draft_{W-1}]; room
    (B,): per-slot cap on accepted tokens (clamped to >= 1, so a dead
    slot's cursor drifts by 1 to W a step until admission re-pins it).
    Returns (greedy (B, W), accepted (B,) in [1, W], next committed token
    (B,), cache with ``cursor += accepted``)."""
    greedy, cache = verify_window(params, cache, tokens, cfg)
    accepted, cur_tok = _accept_prefix(greedy, tokens, room, tokens.shape[1], eos_id)
    cache.cursor = cache.cursor + accepted
    return greedy, accepted, cur_tok, cache


# --------------------------------------------------------------------------
# paged KV pool: block-table indirection over a shared block arena
# --------------------------------------------------------------------------
@dataclasses.dataclass
class PagedKVCache:
    """KV arena as a pool of fixed-size blocks shared by every decode slot.

    ``pos`` / ``cursor`` keep :class:`KVCache`'s per-slot view over a
    virtual (B, Sc) arena; the rows live in a (L, P, KV, dh) pool of
    ``pool_blocks`` blocks of ``block_size`` rows (P = pool_blocks *
    block_size).  ``table[b, j]`` names the block backing slot b's
    positions [j*bs, (j+1)*bs), -1 = none; allocated entries form a prefix
    of the row.  ``free[:n_free]`` is the free-list stack (pops from the
    top, pushes in ascending block id), and ``ref`` counts each block's
    holders: table entries plus retrieval-cache pins.  A block returns to
    the stack only when its count reaches 0, so a shared prompt prefix
    outlives any one holder.  The serving engine replays the same
    arithmetic on host mirrors, so exhaustion checks never read the device.
    """

    k: torch.Tensor  # (L, P, KV, dh), int8 when quantized
    v: torch.Tensor  # (L, P, KV, dh)
    pos: torch.Tensor  # (B, Sc) int32 absolute position per logical row, -1 empty
    cursor: torch.Tensor  # (B,) int32 next absolute position to write
    table: torch.Tensor  # (B, max_blocks) int32 pool block per logical block, -1 none
    free: torch.Tensor  # (pool_blocks,) int32 free-list stack storage
    n_free: torch.Tensor  # () int32 valid stack depth
    ref: torch.Tensor  # (pool_blocks,) int32 holders per block (0 = free)
    k_scale: Optional[torch.Tensor] = None  # (L, P, KV) bf16 absmax scales (int8 mode)
    v_scale: Optional[torch.Tensor] = None


def init_paged_cache(cfg: TransformerConfig, batch: int, cache_len: int, block_size: int,
                     pool_blocks: int, device="cuda") -> PagedKVCache:
    """An empty pool (zeroed, so gathers of unused rows stay finite) with
    every block on the free stack."""
    dev = resolve_device(device)
    if cache_len % block_size != 0:
        raise ValueError(f"block_size={block_size} must divide cache_len={cache_len}")
    shape = (cfg.n_layers, pool_blocks * block_size, cfg.n_kv_heads, cfg.d_head)
    kv_dtype = torch.int8 if cfg.kv_quant else _dtype(cfg)

    def scales():
        return torch.zeros(shape[:-1], dtype=torch.bfloat16, device=dev) if cfg.kv_quant else None

    i32 = dict(dtype=torch.int32, device=dev)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=kv_dtype, device=dev),
        v=torch.zeros(shape, dtype=kv_dtype, device=dev),
        pos=torch.full((batch, cache_len), -1, **i32),
        cursor=torch.zeros((batch,), **i32),
        table=torch.full((batch, cache_len // block_size), -1, **i32),
        free=torch.arange(pool_blocks, **i32),
        n_free=torch.tensor(pool_blocks, **i32),
        ref=torch.zeros((pool_blocks,), **i32),
        k_scale=scales(),
        v_scale=scales(),
    )


def block_rows(table: torch.Tensor, block_size: int) -> torch.Tensor:
    """(B, M) block table -> (B, M*bs) pool-row map.  Rows under
    unallocated blocks map to pool row 0; callers mask them with
    ``pos == -1``."""
    b, m = table.shape
    off = torch.arange(block_size, dtype=torch.int32, device=table.device)
    rows = table[:, :, None] * block_size + off
    return torch.where(rows >= 0, rows, 0).reshape(b, m * block_size)


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    return (torch.cumsum(x, 0, dtype=torch.int32) - x).to(torch.int32)


def _set_where(dst: torch.Tensor, idx: torch.Tensor, keep: torch.Tensor, value) -> torch.Tensor:
    """``dst`` with ``dst[idx[keep]] = value``: the reference's
    ``.at[...].set(mode="drop")`` with its out-of-range index.  Dropped
    entries land in one scratch element past the end, which is cut off."""
    n = dst.shape[0]
    ext = torch.cat([dst, dst.new_zeros(1)])
    ext[torch.where(keep, idx, n).long().reshape(-1)] = value
    return ext[:n]


def _count_drops(idx: torch.Tensor, keep: torch.Tensor, p: int) -> torch.Tensor:
    """(P,) int32 count of ``idx`` entries per block where ``keep``."""
    sel = torch.where(keep, idx, p).long().reshape(-1)
    return torch.bincount(sel, minlength=p + 1)[:p].to(torch.int32)


def alloc_blocks(table, free, n_free, ref, target, live, max_new: int):
    """Grow each live slot's allocated-block prefix to ``target[b]`` blocks
    (at most ``max_new`` new ones), popping from the top of the free stack
    in slot order; each popped block's refcount becomes 1.  Dead slots
    never allocate.  The caller guarantees ``sum(need) <= n_free`` (the
    engine retires slots on the host first).  Returns (table, n_free, ref).

    Column c of slot b takes pop j = c - n_tab[b], block
    ``free[n_free - 1 - offs[b] - j]``: the reference's loop over j, done
    for every column at once."""
    b, m = table.shape
    p = free.shape[0]
    n_tab = (table >= 0).sum(dim=1, dtype=torch.int32)
    need = torch.where(live, torch.clamp(target - n_tab, 0, max_new), 0).to(torch.int32)
    offs = _excl_cumsum(need)
    j = torch.arange(m, dtype=torch.int32, device=table.device)[None, :] - n_tab[:, None]
    take = (j >= 0) & (j < need[:, None])
    src = torch.clamp(n_free - 1 - offs[:, None] - j, 0, p - 1)
    blk = free[src.long()]  # garbage where ~take
    table = torch.where(take, blk, table)
    ref = _set_where(ref, blk, take, 1)
    return table, (n_free - need.sum(dtype=torch.int32)).to(torch.int32), ref


def _release_refs(free, n_free, ref, drops):
    """Drop ``drops`` (P,) holds per block and push every block whose count
    reaches 0 back onto the free stack, in ascending block id."""
    p = free.shape[0]
    ref = ref - drops
    push = (drops > 0) & (ref <= 0)
    npush = torch.cumsum(push, 0, dtype=torch.int32)
    ids = torch.arange(p, dtype=torch.int32, device=free.device)
    ext = torch.cat([free, free.new_zeros(1)])
    ext[torch.where(push, n_free + npush - 1, p).long()] = ids
    return ext[:p], (n_free + npush[-1]).to(torch.int32), torch.clamp(ref, min=0)


def free_slot_blocks(cache: PagedKVCache, mask: torch.Tensor) -> PagedKVCache:
    """Drop every masked slot's hold on its blocks and clear its
    table/pos/cursor.  A block returns to the stack only when its refcount
    reaches 0, so blocks shared with other slots or pinned survive."""
    table = cache.table
    p = cache.free.shape[0]
    drops = _count_drops(table, mask[:, None] & (table >= 0), p)
    free, n_free, ref = _release_refs(cache.free, cache.n_free, cache.ref, drops)
    return dataclasses.replace(
        cache, free=free, n_free=n_free, ref=ref,
        table=torch.where(mask[:, None], -1, table),
        pos=torch.where(mask[:, None], -1, cache.pos),
        cursor=torch.where(mask, 0, cache.cursor),
    )


def acquire_blocks(cache: PagedKVCache, ids: torch.Tensor) -> PagedKVCache:
    """One more hold per listed block (``ids`` int32, -1 ignored): the
    retrieval-cache pin and pending-share side of the refcount protocol."""
    p = cache.free.shape[0]
    return dataclasses.replace(cache, ref=cache.ref + _count_drops(ids, ids >= 0, p))


def release_blocks(cache: PagedKVCache, ids: torch.Tensor) -> PagedKVCache:
    """One hold fewer per listed block (``ids`` int32, -1 ignored), pushing
    blocks that reach 0 back onto the stack."""
    p = cache.free.shape[0]
    free, n_free, ref = _release_refs(cache.free, cache.n_free, cache.ref,
                                      _count_drops(ids, ids >= 0, p))
    return dataclasses.replace(cache, free=free, n_free=n_free, ref=ref)


def _copy_rows(pool: Optional[torch.Tensor], dst: torch.Tensor, src: torch.Tensor) -> None:
    """``pool[:, dst] = pool[:, src]`` in place (a no-op for no pool)."""
    if pool is not None and dst.numel():
        pool[:, dst] = pool[:, src]


def adopt_prefix_blocks(cache: PagedKVCache, cur_tok, mask, src_table, length, tail_src,
                        first, block_size: int):
    """Map an already-prefilled prompt's pool blocks into each masked slot's
    table instead of running prefill.  Slot b aliases the ``length[b] //
    bs`` full leading blocks of ``src_table[b]`` (taking over the holds the
    engine took for it); where the prompt ends mid-block (``tail_src[b] >=
    0``, the donor's partial tail block) it pops a fresh block, copies the
    tail's rows into it (copy on write: the next decode write lands there)
    and drops the engine's hold on the source.  ``pos``/``cursor`` pin to
    the prompt length and ``cur_tok`` takes ``first``.  The pool is
    updated in place; returns (cache, cur_tok)."""
    bs = block_size
    b, sc = cache.pos.shape
    p = cache.free.shape[0]
    m = cache.table.shape[1]
    nfull = torch.where(mask, length // bs, 0)
    has_tail = mask & (tail_src >= 0)
    need = has_tail.to(torch.int32)
    offs = _excl_cumsum(need)
    fresh = cache.free[torch.clamp(cache.n_free - 1 - offs, 0, p - 1).long()]
    n_free = (cache.n_free - need.sum(dtype=torch.int32)).to(torch.int32)
    ref = _set_where(cache.ref, fresh, has_tail, 1)
    free, n_free, ref = _release_refs(cache.free, n_free, ref,
                                      _count_drops(tail_src, has_tail, p))
    cols = torch.arange(m, dtype=torch.int32, device=mask.device)[None, :]
    t = torch.where(cols < nfull[:, None], src_table, -1)
    t = torch.where((cols == nfull[:, None]) & has_tail[:, None], fresh[:, None], t)
    table = torch.where(mask[:, None], t, cache.table)
    # copy on write: all bs rows of each tail block
    sel = has_tail.nonzero()[:, 0]
    off = torch.arange(bs, device=mask.device)
    srows = (tail_src[sel].long()[:, None] * bs + off).reshape(-1)
    drows = (fresh[sel].long()[:, None] * bs + off).reshape(-1)
    for pool in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        _copy_rows(pool, drows, srows)
    spos = torch.arange(sc, dtype=torch.int32, device=mask.device)[None, :]
    pos_new = torch.where(spos < length[:, None], spos, -1)
    cache = dataclasses.replace(
        cache, table=table, free=free, n_free=n_free, ref=ref,
        pos=torch.where(mask[:, None], pos_new, cache.pos),
        cursor=torch.where(mask, length.to(torch.int32), cache.cursor),
    )
    return cache, torch.where(mask, first, cur_tok)


@torch.no_grad()
def paged_decode_step(params, cache: PagedKVCache, token: torch.Tensor, live: torch.Tensor,
                      cfg: TransformerConfig, block_size: int):
    """One decode step over the paged pool: the semantics of
    :func:`decode_step`, and for live slots the same logits bit for bit.

    ``live`` (B,) gates allocation and writes: a dead slot's cursor drifts
    between admissions, but it never pops a block or writes a row.  The
    pool is updated in place; the rows to write are picked once a step
    (one host sync, before the layers run)."""
    b = token.shape[0]
    sc = cache.pos.shape[1]
    bs = block_size
    m = cache.table.shape[1]
    cur = cache.cursor  # (B,) position of the token being processed
    # the block holding position `cur` (at most one new block a step)
    target = torch.where(live, cur // bs + 1, 0)
    table, n_free, ref = alloc_blocks(cache.table, cache.free, cache.n_free, cache.ref,
                                      target, live, 1)
    rows = block_rows(table, bs)
    ent = table.gather(1, torch.clamp(cur // bs, 0, m - 1).long()[:, None])[:, 0]
    ok_w = live & (ent >= 0) & (cur < sc)
    keep = ok_w.nonzero()[:, 0]
    wrow = (ent * bs + cur % bs)[keep].long()
    # live slots never wrap: cur < sc by retirement
    slot_mask = (torch.arange(sc, device=cur.device)[None, :] == cur[:, None]) & live[:, None]
    pos = torch.where(slot_mask, cur[:, None], cache.pos)
    x = params["embed"][token.long()][:, None]  # (B, 1, D)
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        xn = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = _attn_proj(p, xn, cfg)
        q = attn.rope(q, cur[:, None], cfg.rope_theta)
        k = attn.rope(k, cur[:, None], cfg.rope_theta)
        ks = vs = None
        if cfg.kv_quant:
            kq, ksc = _quant_rows(k[keep, 0])
            vq, vsc = _quant_rows(v[keep, 0])
            cache.k[i, wrow], cache.v[i, wrow] = kq, vq
            cache.k_scale[i, wrow], cache.v_scale[i, wrow] = ksc, vsc
            ks, vs = cache.k_scale[i], cache.v_scale[i]
        else:
            cache.k[i, wrow] = k[keep, 0]
            cache.v[i, wrow] = v[keep, 0]
        o = attn.paged_decode_attention(q, cache.k[i], cache.v[i], rows, pos, cur,
                                        cfg.sliding_window, k_scale=ks, v_scale=vs)
        x = x + (o.reshape(b, 1, -1) @ p["wo"]).to(x.dtype)
        x, _ = _ffn(p, x, cfg)
    cache = dataclasses.replace(cache, pos=pos, cursor=cur + 1, table=table, n_free=n_free,
                                ref=ref)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x[:, 0].float() @ params["head"].float(), cache


def paged_serve_step(params, cache: PagedKVCache, token: torch.Tensor, live: torch.Tensor,
                     cfg: TransformerConfig, block_size: int):
    """Greedy paged decode step: (next tokens (B,) int32, cache)."""
    logits, cache = paged_decode_step(params, cache, token, live, cfg, block_size)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


@torch.no_grad()
def paged_verify_window(params, cache: PagedKVCache, tokens: torch.Tensor, live: torch.Tensor,
                        cfg: TransformerConfig, block_size: int):
    """:func:`verify_window` over the paged pool: allocate the blocks the
    W-token window crosses (live slots only), write all W rows into the
    pool, and score every position under the same per-position mask.  The
    rows written and the gathered per-slot view equal the contiguous
    arena's, so the greedy tokens do too.  Returns (greedy (B, W), cache)
    with the cursor unchanged; the pool is updated in place, its rows
    picked once a call (one host sync, before the layers run)."""
    b, w = tokens.shape
    sc = cache.pos.shape[1]
    bs = block_size
    m = cache.table.shape[1]
    cur = cache.cursor  # (B,)
    positions = cur[:, None] + torch.arange(w, dtype=torch.int32, device=cur.device)[None, :]
    writable = (positions < sc) & live[:, None]
    # a W-window starting anywhere inside a block spans at most
    # ceil(W/bs) + 1 blocks
    hi = torch.clamp(cur + w, max=sc)
    target = torch.where(live, (hi + bs - 1) // bs, 0)
    table, n_free, ref = alloc_blocks(cache.table, cache.free, cache.n_free, cache.ref,
                                      target, live, min(m, (w + bs - 1) // bs + 1))
    rows = block_rows(table, bs)  # (B, Sc)
    ent = table.gather(1, torch.clamp(positions // bs, 0, m - 1).long())  # (B, W)
    keep = (writable & (ent >= 0)).reshape(-1).nonzero()[:, 0]
    wrow = (ent * bs + positions % bs).reshape(-1)[keep].long()
    slot_mask = (torch.arange(sc, dtype=torch.int32, device=cur.device)[None, None, :]
                 == torch.clamp(positions, 0, sc - 1)[..., None]) & writable[..., None]
    pos = cache.pos
    for i in range(w):
        pos = torch.where(slot_mask[:, i], positions[:, i:i + 1], pos)
    x = params["embed"][tokens.long()]  # (B, W, D)
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        xn = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = _attn_proj(p, xn, cfg)
        q = attn.rope(q, positions, cfg.rope_theta)
        k = attn.rope(k, positions, cfg.rope_theta)
        k_rows = k.reshape(b * w, *k.shape[2:])[keep]
        v_rows = v.reshape(b * w, *v.shape[2:])[keep]
        ks = vs = None
        if cfg.kv_quant:
            kq, ksc = _quant_rows(k_rows)
            vq, vsc = _quant_rows(v_rows)
            cache.k[i, wrow], cache.v[i, wrow] = kq, vq
            cache.k_scale[i, wrow], cache.v_scale[i, wrow] = ksc, vsc
            ks, vs = cache.k_scale[i], cache.v_scale[i]
        else:
            cache.k[i, wrow] = k_rows
            cache.v[i, wrow] = v_rows
        o = attn.paged_verify_attention(q, cache.k[i], cache.v[i], rows, pos, positions,
                                        cfg.sliding_window, k_scale=ks, v_scale=vs)
        x = x + (o.reshape(b, w, -1) @ p["wo"]).to(x.dtype)
        x, _ = _ffn(p, x, cfg)
    cache = dataclasses.replace(cache, pos=pos, table=table, n_free=n_free, ref=ref)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = x.float() @ params["head"].float()
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def paged_verify_step(params, cache: PagedKVCache, tokens: torch.Tensor, room: torch.Tensor,
                      live: torch.Tensor, cfg: TransformerConfig, eos_id=None, *,
                      block_size: int):
    """:func:`verify_step` over the paged pool: the same acceptance
    arithmetic, the cursor advanced past the accepted prefix."""
    greedy, cache = paged_verify_window(params, cache, tokens, live, cfg, block_size)
    accepted, cur_tok = _accept_prefix(greedy, tokens, room, tokens.shape[1], eos_id)
    return greedy, accepted, cur_tok, dataclasses.replace(cache, cursor=cache.cursor + accepted)
