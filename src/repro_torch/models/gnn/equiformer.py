"""EquiformerV2-style equivariant graph attention via eSCN convolutions (the
reference's ``repro.models.gnn.equiformer``).

Structure per layer (arXiv:2306.12059):

  1. per-edge: gather source irreps features X[src] (K, C), rotate into the
     edge frame with the quantized Wigner LUT (K = (l_max+1)^2);
  2. restrict to |m| <= m_max coefficients and apply the SO(2) linear map
     (the eSCN O(L^3) trick): per-m pair mixing with rotation-equivariant
     (W1, W2) structure, modulated by radial-basis edge scalars;
  3. multi-head attention: logits from the invariant (l=0) channels,
     segment-softmax over incoming edges;
  4. rotate messages back (D^T), scatter-sum to targets;
  5. node update: equivariant RMS norm per l-block, gated FFN (sigmoid gate
     from l=0 channels scales l>0 blocks).

Edges are processed in fixed-size chunks (the reference's three ``lax.scan``s
are Python loops over chunk slices) so the (E, K, K) Wigner gather never
materializes for the whole edge list.  The softmax denominator and the
messages are accumulated additively outside a per-chunk checkpoint, nested
in the per-layer checkpoint, so the backward recomputes each chunk instead of
keeping its (chunk, K, C) intermediates.  The segment max is a softmax
statistic and runs without autograd (the reference's ``stop_gradient``).
Scatters follow the reference's ``.at[seg]`` rules (``common.at_add`` /
``at_max``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.constraints import shard_hint, zeros_hint
from repro_torch.models.gnn.common import apply_mlp, at_add, at_max, init_mlp, take
from repro_torch.models.gnn.config import GNNConfig
from repro_torch.models.gnn.wigner import m_index_sets

N_RBF = 16


def init_equiformer(generator: torch.Generator, cfg: GNNConfig) -> dict:
    C = cfg.d_hidden
    msets = m_index_sets(cfg.l_max, cfg.m_max)
    dev = generator.device

    def normal(dim):
        return torch.randn((dim, dim), generator=generator, device=dev) * dim ** -0.5

    layers = []
    for _ in range(cfg.n_layers):
        so2 = {}
        for m in range(cfg.m_max + 1):
            dim = len(msets[m][0]) * C
            so2[f"w1_{m}"] = normal(dim)
            if m > 0:
                so2[f"w2_{m}"] = normal(dim)
        layers.append({
            "so2": so2,
            "radial": init_mlp(generator, [N_RBF + C, C, cfg.m_max + 1]),
            "attn": init_mlp(generator, [2 * C + N_RBF, C, cfg.n_heads]),
            "gate": init_mlp(generator, [C, C, (cfg.l_max + 1) * C]),
            "ln_scale": torch.ones((cfg.l_max + 1, C), device=dev),
        })
    return {
        "embed": init_mlp(generator, [cfg.d_in, C]),
        "layers": layers,
        "out": init_mlp(generator, [C, C, cfg.d_out]),
    }


def _so2_conv(lp: dict, xm: dict, msets: dict, radial_mod: torch.Tensor) -> dict:
    """Apply the SO(2) linear map in the rotated frame.

    xm: dict m -> (B, n_l, C) cos part [+ (B, n_l, C) sin part for m>0].
    radial_mod: (B, m_max+1) multiplicative radial modulation per m.
    """
    out = {}
    for m in msets:
        w1 = lp["so2"][f"w1_{m}"]
        mod = radial_mod[:, m][:, None, None]
        if m == 0:
            xc = xm[0][0]  # (B, n_l, C)
            yc = (xc.reshape(xc.shape[0], -1) @ w1).reshape(xc.shape)
            out[0] = (yc * mod,)
        else:
            xc, xs = xm[m]
            w2 = lp["so2"][f"w2_{m}"]
            fc, fs = xc.reshape(xc.shape[0], -1), xs.reshape(xs.shape[0], -1)
            yc = (fc @ w1 - fs @ w2).reshape(xc.shape)
            ys = (fc @ w2 + fs @ w1).reshape(xs.shape)
            out[m] = (yc * mod, ys * mod)
    return out


def _equi_rmsnorm(x: torch.Tensor, scale: torch.Tensor, l_max: int) -> torch.Tensor:
    """Per-l-block RMS norm of irreps features x (N, K, C)."""
    outs = []
    for l in range(l_max + 1):
        blk = x[:, l * l:(l + 1) * (l + 1)]
        rms = torch.sqrt(torch.mean(blk * blk, dim=(1, 2), keepdim=True) + 1e-6)
        outs.append(blk / rms * scale[l][None, None, :])
    return torch.cat(outs, 1)


def edge_bins(u: torch.Tensor, n_theta: int, n_phi: int) -> torch.Tensor:
    """LUT bin of each unit direction (E, 3): fp32 arccos / arctan2, then
    truncation toward zero, as the reference bins on the device."""
    theta = torch.arccos(torch.clamp(u[:, 2], -1, 1))
    phi = torch.atan2(u[:, 1], u[:, 0])
    it = torch.clamp((theta / np.pi * n_theta).to(torch.int32), 0, n_theta - 1)
    ip = torch.clamp(((phi + np.pi) / (2 * np.pi) * n_phi).to(torch.int32), 0, n_phi - 1)
    return it * n_phi + ip


def edge_geometry(pos: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, n: int,
                  n_theta: int, n_phi: int):
    """(ebin (E,) int32, rbf (E, N_RBF)): each edge's direction bin and the
    radial basis of its length."""
    pp = torch.cat([pos, pos.new_zeros((1, 3))], 0)
    d_vec = take(pp, torch.clamp(dst, max=n)) - take(pp, torch.clamp(src, max=n))
    dist = torch.linalg.vector_norm(d_vec, dim=-1)
    u = d_vec / torch.clamp(dist, min=1e-6)[:, None]
    centers = torch.linspace(0.0, 4.0, N_RBF, device=pos.device)
    rbf = torch.exp(-((dist[:, None] - centers[None]) ** 2) * 4.0)
    return edge_bins(u, n_theta, n_phi), rbf


def _row_layout(msets: dict, K: int) -> torch.Tensor:
    """For each of the K rows, its place in the concatenation of the (m,
    part) row sets in the order ``_so2_conv`` returns them; rows no part
    holds point one past them, at a zero row appended there."""
    parts = np.concatenate([rows for m in msets for rows in msets[m] if len(rows)])
    inv = np.full(K, len(parts), np.int64)
    inv[parts] = np.arange(len(parts))
    return torch.from_numpy(inv)


@dataclasses.dataclass(frozen=True)
class _Edges:
    """What every layer reads and nothing differentiates: the edge chunks,
    their geometry and the row layout of the SO(2) map.  The checkpointed
    functions below take it and their tensors as arguments; a closure over
    a tensor the autograd graph also reaches would tie that graph into a
    cycle through the checkpoint's frame that outlives the backward."""
    spans: list
    src: torch.Tensor
    dst: torch.Tensor
    emask: torch.Tensor
    ebin: torch.Tensor
    rbf: torch.Tensor
    lut: torch.Tensor
    msets: dict
    mrows: dict
    inv: torch.Tensor
    n: int
    C: int
    K: int
    H: int
    l_max: int


def _sm_partial(lg: torch.Tensor, seg: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    ex = torch.exp(lg - take(mx, seg))
    return at_add(ex.new_zeros(mx.shape), seg, ex)


def _chunk_partial(lg, sp, mx, sm, xp, invp, lp, g: _Edges) -> torch.Tensor:
    n, C, K, H = g.n, g.C, g.K, g.H
    chunk = lg.shape[0]
    s_ = torch.clamp(g.src[sp], max=n)
    seg = torch.clamp(g.dst[sp], max=n)
    D = shard_hint(g.lut.index_select(0, g.ebin[sp]), "dp", None, None)  # (chunk, K, K)
    xs = shard_hint(take(xp, s_), "dp", None, None)
    xr = torch.bmm(D, xs)
    xm = {m: tuple(xr.index_select(1, rows) for rows in g.mrows[m]) for m in g.msets}
    rad_in = torch.cat([g.rbf[sp], take(invp, s_)], -1)
    rmod = apply_mlp(lp["radial"], rad_in)  # (chunk, m_max+1)
    ym = _so2_conv(lp, xm, g.msets, rmod)
    flat = [t for m in g.msets for t in ym[m]]
    y = torch.cat(flat + [xr.new_zeros((chunk, 1, C))], 1).index_select(1, g.inv)
    yb = torch.bmm(D.transpose(1, 2), y)  # rotate back (D^T)
    alpha = torch.exp(lg - take(mx, seg)) / torch.clamp(take(sm, seg), min=1e-20)
    yh = yb.reshape(chunk, K, H, C // H) * alpha[:, None, :, None]
    part = at_add(xp.new_zeros((n + 1, K, C)), seg, yh.reshape(chunk, K, C))
    return shard_hint(part, None, None, "model")


def _layer(x: torch.Tensor, lp: dict, g: _Edges) -> torch.Tensor:
    n, C, K, H = g.n, g.C, g.K, g.H
    inv_ch = x[:, 0, :]  # (N, C) invariant channels
    xp = shard_hint(torch.cat([x, x.new_zeros((1, K, C))], 0), None, None, "model")
    invp = torch.cat([inv_ch, inv_ch.new_zeros((1, C))], 0)

    # ---- pass A: attention logits (invariant-only, no rotation needed)
    all_lg = []
    for sp in g.spans:
        s_, d_ = torch.clamp(g.src[sp], max=n), torch.clamp(g.dst[sp], max=n)
        zi = torch.cat([take(invp, s_), take(invp, d_), g.rbf[sp]], -1)
        lg = apply_mlp(lp["attn"], zi)  # (chunk, H)
        all_lg.append(torch.where(g.emask[sp][:, None], lg, -1e30))

    # segment max: a softmax statistic, outside autograd (the shift cancels
    # in the softmax gradient)
    with torch.no_grad():
        mx = x.new_full((n + 1, H), -1e30)
        for sp, lg in zip(g.spans, all_lg):
            mx = at_max(mx, torch.clamp(g.dst[sp], max=n), lg)

    # denominator: additive accumulation of recomputed chunks
    sm = x.new_zeros((n + 1, H))
    for sp, lg in zip(g.spans, all_lg):
        sm = sm + checkpoint(_sm_partial, lg, torch.clamp(g.dst[sp], max=n), mx,
                             use_reentrant=False)

    # ---- pass B: rotated SO(2) messages, weighted scatter
    acc = zeros_hint((n + 1, K, C), None, None, "model", dtype=x.dtype, device=x.device)
    for sp, lg in zip(g.spans, all_lg):
        acc = acc + checkpoint(_chunk_partial, lg, sp, mx, sm, xp, invp, lp, g,
                               use_reentrant=False)
    h = shard_hint(_equi_rmsnorm(x + acc[:n], lp["ln_scale"], g.l_max), None, None, "model")

    # gated FFN: l=0 through MLP; l>0 scaled by sigmoid gates
    gates = apply_mlp(lp["gate"], h[:, 0, :]).reshape(n, g.l_max + 1, C)
    outs = [h[:, 0:1, :] + F.silu(gates[:, 0:1, :])]
    for l in range(1, g.l_max + 1):
        outs.append(h[:, l * l:(l + 1) * (l + 1), :] * torch.sigmoid(gates[:, l:l + 1, :]))
    return torch.cat(outs, 1)


def apply_equiformer(params: dict, cfg: GNNConfig, inputs: dict, *,
                     edge_chunk: int = 16384) -> torch.Tensor:
    """inputs: node_feat (N,F), pos (N,3), edge_src/dst (E,), edge_mask (E,),
    wigner_lut (n_bins, K, K).  Returns (N, d_out)."""
    C, K, H = cfg.d_hidden, cfg.sphere_k, cfg.n_heads
    msets = m_index_sets(cfg.l_max, cfg.m_max)
    node_feat = inputs["node_feat"]
    n, dev = node_feat.shape[0], node_feat.device
    src, dst = inputs["edge_src"], inputs["edge_dst"]
    emask = inputs.get("edge_mask")
    if emask is None:
        emask = torch.ones(src.shape, dtype=torch.bool, device=dev)
    lut = inputs["wigner_lut"]
    n_theta = int(math.sqrt(lut.shape[0] // 2))
    n_phi = 2 * n_theta

    e_total = src.shape[0]
    chunk = min(edge_chunk, e_total)
    n_chunks = max(e_total // chunk, 1)
    assert n_chunks * chunk == e_total, (e_total, chunk)

    ebin, rbf = edge_geometry(inputs["pos"], src, dst, n, n_theta, n_phi)
    g = _Edges(
        spans=[slice(ci * chunk, (ci + 1) * chunk) for ci in range(n_chunks)],
        src=src, dst=dst, emask=emask, ebin=ebin, rbf=rbf, lut=lut, msets=msets,
        mrows={m: tuple(torch.from_numpy(r.astype(np.int64)).to(dev) for r in msets[m]
                        if len(r)) for m in msets},
        inv=_row_layout(msets, K).to(dev), n=n, C=C, K=K, H=H, l_max=cfg.l_max)

    # initial irreps: invariant embedding in l=0, zeros elsewhere
    h0 = apply_mlp(params["embed"], node_feat)  # (N, C)
    # irreps features are the dominant state (N, K, C): channels over "model"
    x = shard_hint(torch.cat([h0[:, None], h0.new_zeros((n, K - 1, C))], 1), None, None, "model")
    for lp in params["layers"]:
        x = checkpoint(_layer, x, lp, g, use_reentrant=False)
    return apply_mlp(params["out"], x[:, 0, :])
