"""Port flash attention vs the reference on the CPU, same inputs (numpy,
seeded): the plain forward against the Pallas kernel in interpret mode and
against the dense oracle, ``lse`` against the reference's ``_flash_fwd``,
and ``chunked_attention``'s value and gradients against ``jax.vjp`` of the
reference's custom-VJP ``chunked_attention``; the tensor-core kernels'
arithmetic (the backward's hi/lo split, the forward's base-2 online softmax)
against the card's gate; and the kernels' head dims against every config of
the reference.

Tolerances: fp32 ``atol=rtol=2e-5`` for outputs (the reference's own sweep
tolerance: both sides sum the same products in another order) and ``1e-4``
for gradients (each is a sum over S keys of products of recomputed
probabilities, summed in another order).  bf16 outputs within ``1e-2``
absolute: p is rounded to bf16 before P·V on both sides, and a last-bit
difference in an fp32 score can round p the other way, which moves an
output by one bf16 ulp (2^-8 relative to |o| <= ~3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY
from repro.kernels.flash_attn import ops as ref_fops
from repro.kernels.flash_attn import ref as ref_fref
from repro.models.transformer import attention as ref_attn
from repro_torch.kernels.flash_attn import kernel as fa_kernel
from repro_torch.kernels.flash_attn import ops, ref
from repro_torch.models.transformer import attention as attn

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _qkv(seed, b, s, h, kv, dh, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype)
            for shape in ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh))]


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("s,h,kv,dh,w,blk", [
    (128, 4, 4, 32, None, 64),
    (256, 4, 2, 64, None, 128),
    (256, 8, 1, 32, 64, 64),   # MQA + window
    (192, 4, 2, 32, 100, 64),  # window not a multiple of the block
])
def test_plain_forward_matches_pallas_interpret(s, h, kv, dh, w, blk):
    q, k, v = _qkv(s + h, 2, s, h, kv, dh)
    want = ref_fops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    window=w, q_blk=blk, kv_blk=blk)
    got, _ = ops.flash_fwd(*_t(q, k, v), window=w, q_chunk=blk, kv_chunk=blk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    oracle = ref_fref.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=w)
    np.testing.assert_allclose(ref.attention(*_t(q, k, v), window=w).numpy(),
                               np.asarray(oracle), **TOL)


def test_plain_forward_bf16_matches_pallas_interpret():
    q, k, v = _qkv(7, 1, 128, 2, 2, 32)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = ref_fops.flash_attention(jq, jk, jv, q_blk=64, kv_blk=64)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got, _ = ops.flash_fwd(tq, tk, tv, q_chunk=64, kv_chunk=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=1e-2)


@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("rep", [1, 2, 4])
def test_chunked_attention_value_and_grads_match_vjp(window, rep):
    kv, s, dh = 2, 128, 16
    q, k, v = _qkv(rep, 2, s, kv * rep, kv, dh)
    do = np.random.default_rng(50 + rep).standard_normal(q.shape).astype(np.float32)
    fn = lambda a, b, c: ref_attn.chunked_attention(  # noqa: E731
        a, b, c, window=window, q_chunk=32, kv_chunk=64)
    o_ref, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_ref = vjp(jnp.asarray(do))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    o = attn.chunked_attention(tq, tk, tv, window=window, q_chunk=32, kv_chunk=64)
    o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref), **TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


@pytest.mark.parametrize("window", [None, 20])
def test_lse_matches_reference_flash_fwd(window):
    b, s, h, kv, dh, cq = 2, 96, 4, 2, 16, 32
    q, k, v = _qkv(3, b, s, h, kv, dh)
    o_ref, lse_ref = ref_attn._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         window, cq, cq)
    o, lse = ref.flash_fwd(*_t(q, k, v), window, cq, cq)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), **TOL)
    # the reference keeps lse per q-chunk: (B, nq, KV, rep, Cq) -> (B, H, S)
    want = np.asarray(lse_ref).transpose(0, 2, 3, 1, 4).reshape(b, h, s)
    np.testing.assert_allclose(lse.numpy(), want, **TOL)


def test_backward_passes_match_reference_flash_bwd():
    b, s, h, kv, dh, cq = 1, 128, 6, 2, 32, 64
    q, k, v = _qkv(4, b, s, h, kv, dh)
    do = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    o_ref, lse_ref = ref_attn._flash_fwd(jq, jk, jv, 40, cq, cq)
    want = ref_attn._flash_bwd((jq, jk, jv, o_ref, lse_ref), jnp.asarray(do), 40, cq, cq)
    tq, tk, tv, tdo = _t(q, k, v, do)
    o, lse = ref.flash_fwd(tq, tk, tv, 40, cq, cq)
    got = ref.flash_bwd(tq, tk, tv, o, lse, tdo, 40, cq, cq)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_chunk_size_does_not_change_the_plain_result():
    q, k, v = _t(*_qkv(5, 1, 192, 4, 2, 16))
    a = ops.flash_fwd(q, k, v, window=50, q_chunk=64, kv_chunk=32)
    c = ops.flash_fwd(q, k, v, window=50, q_chunk=192, kv_chunk=192)
    for x, y in zip(a, c):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **TOL)


def test_cpu_tensors_take_the_plain_version_and_never_launch():
    q, k, v = _t(*_qkv(6, 1, 64, 2, 1, 16))
    counters = (fa_kernel.fwd_launches, fa_kernel.dq_launches, fa_kernel.dkv_launches)
    before = [c.count for c in counters]
    x = q.clone().requires_grad_()
    attn.chunked_attention(x, k, v, q_chunk=32, kv_chunk=32).sum().backward()
    assert [c.count for c in counters] == before
    with pytest.raises(ValueError, match="CUDA device"):
        attn.chunked_attention(q, k, v, q_chunk=32, kv_chunk=32, use_kernel=True)
    with pytest.raises(ValueError, match="multiple of the chunks"):
        attn.chunked_attention(q, k, v, q_chunk=48, kv_chunk=32)


def test_head_dims_cover_every_reference_config():
    """The card's kernels take every d_head of the reference's configs, full
    and reduced (a config with another one fails here, not on the card)."""
    dims = {cfg.d_head for spec in REGISTRY.values()
            for cfg in (spec.model_cfg, spec.reduced_cfg) if hasattr(cfg, "d_head")}
    assert {8, 16, 64, 128} <= dims, dims
    assert dims <= set(fa_kernel.HEAD_DIMS), sorted(dims - set(fa_kernel.HEAD_DIMS))


def _share_of_card_tolerance(got, want, row_share=2**-10) -> float:
    """The largest share of the card's gate for a bf16 output (``rtol``
    2^-7, ``row_share`` of the element's row's largest magnitude: 2^-10 for
    dq, dk and dv, 2^-7 for o; a floor of 1e-5 of the tensor's;
    ``chip_smoke.py``'s ``flash_close``) that any element uses."""
    got, want = got.float(), want.float()
    mag = want.abs()
    tol = row_share * mag.amax(-1, keepdim=True) + 1e-5 * mag.max() + 2**-7 * mag
    return ((got - want).abs() / tol).max().item()


def _dense_bwd_rounded(q, k, v, o, lse, do, rounding):
    """dq, dk, dv of causal attention with H == KV, dense: s, p, dp and ds in
    fp32 as in the reference, and each product that takes p or ds fed either
    the kernels' split (``split``: hi·y + lo·y, two bf16 products summed in
    fp32) or p and ds rounded once to bf16 (``single``)."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, of, dof = (t.float().transpose(1, 2) for t in (q, k, v, o, do))
    causal = torch.ones(q.shape[1], q.shape[1], dtype=torch.bool).tril()
    p = torch.exp(torch.where(causal, qf @ kf.transpose(-1, -2) * scale, ref.NEG) - lse[..., None])
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - delta) * scale

    def product(x, y):  # x: p or ds (fp32); y: bf16 values
        if rounding == "split":
            hi, lo = ref.split_bf16(x)
            return hi.float() @ y + lo.float() @ y
        return x.to(torch.bfloat16).float() @ y

    grads = (product(ds, kf), product(ds.transpose(-1, -2), qf), product(p.transpose(-1, -2), dof))
    return [g.transpose(1, 2).to(torch.bfloat16) for g in grads]


@pytest.fixture(scope="module")
def split_case():
    """bf16 q, k, v, do at S = 2048, 4 heads, dh 128 (numpy, seeded), the
    plain forward's o and lse, and the plain backward (fp32 p and ds)."""
    q, k, v = _qkv(12, 1, 2048, 4, 4, 128)
    do = np.random.default_rng(13).standard_normal(q.shape).astype(np.float32)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do))
    o, lse = ref.flash_fwd(tq, tk, tv, None, 512, 512)
    return (tq, tk, tv, o, lse, tdo), ref.flash_bwd(tq, tk, tv, o, lse, tdo, None, 512, 512)


@pytest.mark.parametrize("rounding", ["split", "single"])
def test_split_products_hold_the_card_gate(split_case, rounding):
    """Why the tensor-core backward splits p and ds: with the split, dq, dk
    and dv stay within the card's gate against the fp32 plain version; with
    p and ds rounded once to bf16 (as FlashAttention does), each falls out."""
    inputs, want = split_case
    got = _dense_bwd_rounded(*inputs, rounding)
    shares = {n: _share_of_card_tolerance(g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    if rounding == "split":
        assert max(shares.values()) <= 1.0, shares
    else:
        assert min(shares.values()) > 1.0, shares


def _tc_forward_emulated(q, k, v, window):
    """The tensor-core forward's arithmetic (``flash_fwd_kernel_wgmma`` in
    ``csrc/flash_attn.cu``) over 64-key tiles: fp32 scores of the bf16 q and
    k, kept in base 2 (s · c, c = dh^-0.5 · log2 e, in fp32), p = 2^(s·c − m)
    with the running max m, l the sum of the fp32 p, P·V with p rounded once
    to bf16, o = acc / max(l, 1e-20), lse = m · ln 2 + log(max(l, 1e-20)).
    Tiles past the diagonal add p = 0, and masked rows score −1e30 as in the
    reference, so walking every tile equals the kernel's tile skipping."""
    b, s, h, dh = q.shape
    rep = h // k.shape[2]
    c = float(np.float32(dh**-0.5 * np.log2(np.e)))
    qf = q.float().transpose(1, 2)
    kf, vf = (t.float().transpose(1, 2).repeat_interleave(rep, 1) for t in (k, v))
    m = torch.full((b, h, s), ref.NEG)
    l = torch.zeros((b, h, s))
    acc = torch.zeros((b, h, s, dh))
    for k0 in range(0, s, 64):
        ok = ref.tile_mask(0, k0, s, 64, window, q.device)
        s2 = torch.where(ok, (qf @ kf[:, :, k0:k0 + 64].transpose(-1, -2)) * c, ref.NEG)
        m_new = torch.maximum(m, s2.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s2 - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + 64]
        m = m_new
    den = l.clamp(min=1e-20)
    o = (acc / den[..., None]).to(torch.bfloat16).transpose(1, 2)
    return o, m * float(np.log(2)) + torch.log(den)


@pytest.mark.parametrize("window", [None, 300])
def test_tensor_core_forward_arithmetic_holds_the_card_gate(window):
    """The forward kernel's base-2 softmax with its fp32 l and one bf16
    rounding of p gives o within the card's gate (row share 2^-7) and lse
    within its ``atol`` 1e-4 of the plain forward, at S = 2048, 8 query
    heads over 2 KV heads, dh 128."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(14, 1, 2048, 8, 2, 128))
    o, lse = _tc_forward_emulated(q, k, v, window)
    o_p, lse_p = ref.flash_fwd(q, k, v, window, 512, 512)
    assert _share_of_card_tolerance(o, o_p, 2**-7) <= 1.0
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-5)
