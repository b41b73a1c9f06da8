"""Plain PyTorch float32 reference of the served decoder, and the control.

The block is the one the configuration file states (its ``departures``
list where it differs from the published model): RMSNorm, grouped-query
attention with rotary embeddings (the half-split rotation), a SwiGLU FFN
or a dropless top-k mixture of SwiGLU experts (softmax router, the chosen
gates renormalized, ties to the lower expert), and an untied output head.
It imports nothing of the program.  Weights are the benchmark's own, in
the layout ``perfbench.lib.weights`` makes (each matrix stored input by
output, layers stacked on a leading axis); each layer is raised to
float32 when it is used, so the reference fits beside the bf16 weights.

The control (``quant="fp8"``) is the same function with every bfloat16
matrix rounded to float8 e4m3 with one scale per output column, the step
below bfloat16.
"""
from __future__ import annotations

import torch


def _fp8(w: torch.Tensor) -> torch.Tensor:
    """w (..., in, out) rounded to e4m3 with a scale per output column."""
    w = w.float()
    amax = w.abs().amax(dim=-2, keepdim=True).clamp(min=1e-12)
    scale = amax / 448.0
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def _w(t: torch.Tensor, quant) -> torch.Tensor:
    if quant == "fp8" and t.dtype == torch.bfloat16:
        return _fp8(t)
    return t.float()


def _rms(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w.float()


def _rope(x, pos, theta):
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float64, device=x.device) / half)
    ang = (pos.double()[:, None] * freq[None, :]).float()  # (S, half)
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, window):
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, dh)
    sc = torch.einsum("bqkrd,bckd->bkrqc", qg, k) * dh ** -0.5
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    ok = j <= i
    if window is not None:
        ok &= (i - j) < window
    p = torch.softmax(sc.masked_fill(~ok, float("-inf")), dim=-1)
    return torch.einsum("bkrqc,bckd->bqkrd", p, v).reshape(b, s, h * dh)


def _moe(x, lw, m: dict, quant):
    t, d = x.shape
    probs = torch.softmax(x @ lw["router"].float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = vals[:, :m["top_k"]], idx[:, :m["top_k"]]
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    y = torch.zeros_like(x)
    for e in range(m["n_experts"]):
        tok, slot = torch.nonzero(expert == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        he = torch.nn.functional.silu(xe @ _w(lw["w1"][e], quant)) * (xe @ _w(lw["w3"][e], quant))
        y.index_add_(0, tok, (he @ _w(lw["w2"][e], quant)) * gate[tok, slot][:, None])
    return y


@torch.no_grad()
def logits(params: dict, cfg: dict, tokens: torch.Tensor, quant=None) -> torch.Tensor:
    """tokens (B, S) int (right-padded rows are fine: attention is causal)
    -> logits (B, S, V) float32."""
    b, s = tokens.shape
    dev = tokens.device
    h, kvh, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]
    pos = torch.arange(s, device=dev)
    x = _w(params["embed"], quant)[tokens.long()]
    lay = params["layers"]
    for i in range(cfg["n_layers"]):
        lw = {k: (v[i] if not isinstance(v, dict) else {kk: vv[i] for kk, vv in v.items()})
              for k, v in lay.items()}
        xn = _rms(x, lw["ln1"], cfg["norm_eps"])
        q = (xn @ _w(lw["wq"], quant)).reshape(b, s, h, dh)
        k = (xn @ _w(lw["wk"], quant)).reshape(b, s, kvh, dh)
        v = (xn @ _w(lw["wv"], quant)).reshape(b, s, kvh, dh)
        q, k = _rope(q, pos, cfg["rope_theta"]), _rope(k, pos, cfg["rope_theta"])
        x = x + _attention(q, k, v, cfg.get("sliding_window")) @ _w(lw["wo"], quant)
        xn = _rms(x, lw["ln2"], cfg["norm_eps"])
        if "moe" in lw:
            x = x + _moe(xn.reshape(b * s, -1), lw["moe"], cfg["moe"], quant).reshape(b, s, -1)
        else:
            x = x + (torch.nn.functional.silu(xn @ _w(lw["w1"], quant))
                     * (xn @ _w(lw["w3"], quant))) @ _w(lw["w2"], quant)
    x = _rms(x, params["ln_f"], cfg["norm_eps"])
    return x @ _w(params["head"], quant)


def served_gaps(params, cfg, seqs: list, quant=None, block: int = 8) -> list:
    """For each (prompt ids, served ids) pair, the gap by which each served
    token's reference logit lies below the reference's best at its position;
    the gap it would read had it been altered to the next id; with
    ``quant``, also the gap of the token the control puts first there.
    Returns a list of dicts ``{"served": [...], "altered": [...],
    "control": [...]}``."""
    dev = params["embed"].device
    out = []
    for st in range(0, len(seqs), block):
        chunk = seqs[st:st + block]
        full = [list(p) + list(t[:-1]) for p, t in chunk]
        s = max(len(f) for f in full)
        toks = torch.zeros((len(chunk), s), dtype=torch.long, device=dev)
        for r, f in enumerate(full):
            toks[r, :len(f)] = torch.tensor(f, device=dev)
        ref = logits(params, cfg, toks)
        ctl = logits(params, cfg, toks, quant=quant) if quant else None
        for r, (p, t) in enumerate(chunk):
            at = torch.arange(len(p) - 1, len(p) - 1 + len(t), device=dev)
            lg = ref[r, at]
            best = lg.max(dim=-1).values
            row = torch.arange(len(t), device=dev)
            tok = torch.tensor(list(t), device=dev)
            served = best - lg[row, tok]
            # the gap a served token would read had it been altered to the
            # next id where it was produced
            altered = best - lg[row, (tok + 1) % lg.shape[-1]]
            rec = {"served": served.tolist(), "altered": altered.tolist()}
            if ctl is not None:
                pick = ctl[r, at].argmax(dim=-1)
                rec["control"] = (best - lg[row, pick]).tolist()
            out.append(rec)
        del ref, ctl
    return out
