"""Shared GNN substrate: MLPs and edge-list message passing (the reference's
``repro.models.gnn.common``).

Aggregation is a gather over an edge index plus a scatter, as in the
reference, which builds it from ``jnp.take`` and ``jax.ops.segment_sum`` /
``segment_max`` (XLA compiles those; here they are plain PyTorch:
``index_select`` and ``index_add`` / ``scatter_reduce``).  Edge lists carry a
validity mask so every shape is static (padded edges scatter zeros to a
sentinel row).

Index semantics follow JAX's three rules exactly, since padded and
out-of-range ids are part of the inputs:

- a gather ``x[ids]`` (``take``) wraps a negative id once (-1 is the last
  row) and clamps the rest into range;
- ``jax.ops.segment_*`` (``segment_sum`` / ``segment_max``) **drop** every id
  outside ``[0, num_segments)``;
- ``x.at[ids].add / .max`` (``at_add`` / ``at_max``) wrap a negative id
  once, then drop what is still out of range.

A dropped id is sent to one spare row past the end, which is sliced off: no
host sync, and no out-of-range index reaches ``index_add`` (which raises on
the CPU and device-asserts on the card).  The gathers' backward is an
``index_add`` (atomics on the card), not the sort-based ``index_put_``.
"""
from __future__ import annotations

import os

import torch

# The reference's knob: cast edge-aggregation partial sums to bf16 before the
# (cross-shard) reduction.  Default off.
MSG_BF16 = os.environ.get("REPRO_MSG_BF16") == "1"


def init_mlp(generator: torch.Generator, dims, dtype=torch.float32, device=None) -> dict:
    """Weights ``w{i}`` (dims[i], dims[i+1]) ~ N(0, 1) * dims[i] ** -0.5 and
    zero biases ``b{i}``, in the reference's key order."""
    device = generator.device if device is None else device
    out = {f"w{i}": (torch.randn((dims[i], dims[i + 1]), generator=generator, device=device)
                     * dims[i] ** -0.5).to(dtype)
           for i in range(len(dims) - 1)}
    out.update({f"b{i}": torch.zeros((dims[i + 1],), dtype=dtype, device=device)
                for i in range(len(dims) - 1)})
    return out


def apply_mlp(p: dict, x: torch.Tensor, *, act=torch.relu, final_act: bool = False,
              layernorm: bool = False) -> torch.Tensor:
    n = len([k for k in p if k.startswith("w")])
    for i in range(n):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n - 1 or final_act:
            x = act(x)
    if layernorm:
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
        x = (x - mu) * torch.rsqrt(var + 1e-5)
    return x


def _wrap(ids: torch.Tensor, size: int) -> torch.Tensor:
    return torch.where(ids < 0, ids + size, ids)


def take(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``x[ids]`` as JAX gathers them: a negative id wraps once, then
    ids are clamped into ``[0, len(x))``."""
    return x.index_select(0, _wrap(ids, x.shape[0]).clamp(0, x.shape[0] - 1).reshape(-1)) \
        .reshape(ids.shape + x.shape[1:])


def _dropped(ids: torch.Tensor, size: int) -> torch.Tensor:
    """ids outside ``[0, size)`` sent to the spare row ``size``."""
    return torch.where((ids < 0) | (ids >= size), size, ids)


def segment_sum(data: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: ids outside ``[0, num_segments)`` dropped."""
    out = data.new_zeros((num_segments + 1,) + data.shape[1:])
    return out.index_add(0, _dropped(ids, num_segments), data)[:num_segments]


def _expand(ids: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return ids.long().reshape(ids.shape + (1,) * (like.ndim - 1)).expand_as(like)


def segment_max(data: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_max``: empty segments hold -inf, ids outside
    ``[0, num_segments)`` dropped."""
    out = data.new_full((num_segments + 1,) + data.shape[1:], float("-inf"))
    return out.scatter_reduce(0, _expand(_dropped(ids, num_segments), data), data, "amax",
                              include_self=True)[:num_segments]


def at_add(buf: torch.Tensor, ids: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``buf.at[ids].add(data)`` (out of place): a negative id wraps once,
    ids still out of range dropped."""
    spare = torch.cat([buf, buf.new_zeros((1,) + buf.shape[1:])])
    return spare.index_add(0, _dropped(_wrap(ids, buf.shape[0]), buf.shape[0]), data)[:-1]


def at_max(buf: torch.Tensor, ids: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``buf.at[ids].max(data)`` (out of place), the same id rules."""
    spare = torch.cat([buf, buf.new_full((1,) + buf.shape[1:], float("-inf"))])
    idx = _dropped(_wrap(ids, buf.shape[0]), buf.shape[0])
    return spare.scatter_reduce(0, _expand(idx, data), data, "amax", include_self=True)[:-1]


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.ndim - 1))


def gather_src_dst(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, n: int):
    """Gather endpoint features; sentinel row n (zeros) absorbs padded edges."""
    hp = torch.cat([h, h.new_zeros((1,) + h.shape[1:])], 0)
    return take(hp, torch.clamp(src, max=n)), take(hp, torch.clamp(dst, max=n))


def scatter_sum(msg: torch.Tensor, dst: torch.Tensor, n: int, edge_mask=None) -> torch.Tensor:
    if edge_mask is not None:
        msg = torch.where(_bcast(edge_mask, msg), msg, 0)
    seg = torch.clamp(dst, max=n)
    if MSG_BF16:
        return segment_sum(msg.to(torch.bfloat16), seg, n + 1)[:n].to(msg.dtype)
    return segment_sum(msg, seg, n + 1)[:n]


def scatter_mean(msg: torch.Tensor, dst: torch.Tensor, n: int, edge_mask=None) -> torch.Tensor:
    s = scatter_sum(msg, dst, n, edge_mask)
    ones = msg.new_ones((msg.shape[0],))
    if edge_mask is not None:
        ones = ones * edge_mask.to(msg.dtype)
    cnt = segment_sum(ones, torch.clamp(dst, max=n), n + 1)[:n]
    return s / torch.clamp(_bcast(cnt, s), min=1.0)


def segment_softmax(logits: torch.Tensor, dst: torch.Tensor, n: int, edge_mask=None):
    """Per-destination softmax over incoming edges.  logits (E, ...)."""
    seg = torch.clamp(dst, max=n)
    if edge_mask is not None:
        logits = torch.where(_bcast(edge_mask, logits), logits, -1e30)
    mx = segment_max(logits, seg, n + 1)
    ex = torch.exp(logits - take(mx, seg))
    if edge_mask is not None:
        ex = torch.where(_bcast(edge_mask, ex), ex, 0)
    den = segment_sum(ex, seg, n + 1)
    return ex / torch.clamp(take(den, seg), min=1e-20)
