"""Seeded random weights for a decoder, made on the device in a few calls.

The layout is the one the program's serving entry points take: ``embed``
(V, D), ``head`` (D, V), ``ln_f`` (D,), and ``layers`` holding each leaf
stacked over the L layers (``wq`` (L, D, H*dh), ``wk``/``wv`` (L, D,
KV*dh), ``wo`` (L, H*dh, D), and ``w1``/``w3`` (L, D, F), ``w2`` (L, F, D),
or a ``moe`` dict of ``router`` (L, D, E) float32 and ``w1``/``w3`` (L, E,
D, F), ``w2`` (L, E, F, D)).  Every matrix is N(0, 1) times
1/sqrt(fan-in) (the embedding N(0, 1)), drawn in bfloat16 as one block
from a generator on the device seeded with ``seed``; norms are ones.
"""
from __future__ import annotations

import math

import torch


def _matrices(cfg: dict) -> list:
    """(path, shape, fan_in) of every bf16 matrix, in draw order."""
    d, h, kv, dh, L, v = (cfg[k] for k in ("d_model", "n_heads", "n_kv_heads", "d_head",
                                          "n_layers", "vocab"))
    out = [(("embed",), (v, d), 1), (("head",), (d, v), d),
           (("layers", "wq"), (L, d, h * dh), d), (("layers", "wk"), (L, d, kv * dh), d),
           (("layers", "wv"), (L, d, kv * dh), d), (("layers", "wo"), (L, h * dh, d), h * dh)]
    m = cfg.get("moe")
    if m is None:
        f = cfg["d_ff"]
        out += [(("layers", "w1"), (L, d, f), d), (("layers", "w3"), (L, d, f), d),
                (("layers", "w2"), (L, f, d), f)]
    else:
        e, f = m["n_experts"], m["d_ff"]
        out += [(("layers", "moe", "w1"), (L, e, d, f), d),
                (("layers", "moe", "w3"), (L, e, d, f), d),
                (("layers", "moe", "w2"), (L, e, f, d), f)]
    return out


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make_params(cfg: dict, seed: int, device) -> dict:
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (2**63))
    mats = _matrices(cfg)
    total = sum(math.prod(shape) for _, shape, _ in mats)
    buf = torch.randn(total, generator=gen, device=dev, dtype=torch.bfloat16)
    params: dict = {}
    at = 0
    for path, shape, fan_in in mats:
        n = math.prod(shape)
        leaf = buf[at:at + n].view(shape)
        if fan_in != 1:
            leaf.mul_(fan_in ** -0.5)
        _put(params, path, leaf)
        at += n
    d, L = cfg["d_model"], cfg["n_layers"]
    ones = torch.ones((2 * L + 1, d), dtype=torch.float32, device=dev)
    params["layers"]["ln1"], params["layers"]["ln2"] = ones[:L], ones[L:2 * L]
    params["ln_f"] = ones[-1]
    m = cfg.get("moe")
    if m is not None:
        router = torch.randn((L, d, m["n_experts"]), generator=gen, device=dev)
        params["layers"]["moe"]["router"] = router.mul_(d ** -0.5)
    return params


def n_params(cfg: dict) -> int:
    """Parameters held (embedding and head included)."""
    total = sum(math.prod(shape) for _, shape, _ in _matrices(cfg))
    if cfg.get("moe"):
        total += cfg["n_layers"] * cfg["d_model"] * cfg["moe"]["n_experts"]
    return total + (2 * cfg["n_layers"] + 1) * cfg["d_model"]
