"""Port transformer vs the reference with the same weights
(``params_from_jax``): prefill logits (dense and chunked attention), eight
decode steps with and without the sliding window, and the attention
functions on their own.

Tolerance ``atol=rtol=1e-4``: both sides compute in fp32, but the matmuls
and softmax sums run in another order on each side (XLA vs ATen), and the
differences compound over layers and steps.  Greedy tokens must match
exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.transformer import TransformerConfig as RefConfig
from repro.models.transformer import attention as ref_attn
from repro.models.transformer import model as ref_tm
from repro_torch.models.transformer import attention as attn
from repro_torch.models.transformer import model as tm
from repro_torch.models.transformer.config import MoEConfig, TransformerConfig

TOL = dict(atol=1e-4, rtol=1e-4)
BASE = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
            vocab=97, dtype="float32")


def _models(window):
    kw = dict(BASE, sliding_window=window)
    ref_cfg, cfg = RefConfig(**kw), TransformerConfig(**kw)
    ref_params = ref_tm.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = tm.params_from_jax(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    return ref_cfg, ref_params, cfg, params


def _close(a, b):
    np.testing.assert_allclose(b.numpy() if isinstance(b, torch.Tensor) else b,
                               np.asarray(a), **TOL)


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("seq", [24, 1024])  # 1024 > 512 takes chunked attention
def test_prefill_and_decode_match(window, seq):
    ref_cfg, ref_params, cfg, params = _models(window)
    rng = np.random.default_rng(seq)
    toks = rng.integers(1, 97, (2, seq)).astype(np.int32)
    tl = np.array([seq, seq - 5], np.int32)
    cache_len = seq + 16
    lg_a, c_a = ref_tm.prefill(ref_params, jnp.asarray(toks), jnp.asarray(tl), ref_cfg, cache_len)
    lg_b, c_b = tm.prefill(params, torch.from_numpy(toks), torch.from_numpy(tl), cfg, cache_len)
    _close(lg_a, lg_b)
    _close(c_a.k, c_b.k)
    _close(c_a.v, c_b.v)
    np.testing.assert_array_equal(np.asarray(c_a.pos), c_b.pos.numpy())
    np.testing.assert_array_equal(np.asarray(c_a.cursor), c_b.cursor.numpy())
    tok_a = jnp.argmax(lg_a, -1).astype(jnp.int32)
    tok_b = torch.argmax(lg_b, -1).to(torch.int32)
    np.testing.assert_array_equal(np.asarray(tok_a), tok_b.numpy())
    for _ in range(8):  # the ring wraps past cache_len on the 1024 prompt
        lg_a, c_a = ref_tm.decode_step(ref_params, c_a, tok_a, ref_cfg)
        lg_b, c_b = tm.decode_step(params, c_b, tok_b, cfg)
        _close(lg_a, lg_b)
        tok_a = jnp.argmax(lg_a, -1).astype(jnp.int32)
        tok_b = torch.argmax(lg_b, -1).to(torch.int32)
        np.testing.assert_array_equal(np.asarray(tok_a), tok_b.numpy())
    np.testing.assert_array_equal(np.asarray(c_a.pos), c_b.pos.numpy())
    _close(c_a.k, c_b.k)


@pytest.mark.parametrize("window", [None, 48])
def test_chunked_attention_matches(window):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 256, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 256, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 256, 2, 16)).astype(np.float32)
    a = ref_attn.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   window=window, q_chunk=64, kv_chunk=32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    b = attn.chunked_attention(tq, tk, tv, window=window, q_chunk=64, kv_chunk=32)
    _close(a, b)
    _close(ref_attn.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    window=window), b)
    _close(b.numpy(), attn.dense_attention(tq, tk, tv, window=window))
    # a CPU tensor takes the plain version; asking for the kernel needs a card
    with pytest.raises(ValueError, match="CUDA device"):
        attn.chunked_attention(tq, tk, tv, use_kernel=True)


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_both_arms_match(window):
    rng = np.random.default_rng(2)
    b_, sc = 3, 12
    q = rng.standard_normal((b_, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((b_, sc, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((b_, sc, 2, 16)).astype(np.float32)
    kn = rng.standard_normal((b_, 1, 2, 16)).astype(np.float32)
    vn = rng.standard_normal((b_, 1, 2, 16)).astype(np.float32)
    pos = np.tile(np.arange(sc, dtype=np.int32), (b_, 1))
    pos[0, 7:] = -1
    cur = np.array([7, 11, 9], np.int32)
    j = [jnp.asarray(x) for x in (q, kc, vc, pos, cur)]
    t = [torch.from_numpy(x) for x in (q, kc, vc, pos, cur)]
    _close(ref_attn.decode_attention(*j, window), attn.decode_attention(*t, window))
    _close(ref_attn.decode_attention(*j, window, k_new=jnp.asarray(kn), v_new=jnp.asarray(vn)),
           attn.decode_attention(*t, window, k_new=torch.from_numpy(kn),
                                 v_new=torch.from_numpy(vn)))


def test_rope_and_rms_norm_match():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 9)).astype(np.int32)
    _close(ref_attn.rope(jnp.asarray(x), jnp.asarray(pos), 1e5),
           attn.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e5))
    w = rng.standard_normal(16).astype(np.float32)
    _close(ref_tm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5),
           tm.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5))


def test_init_params_shapes_match_reference():
    ref_cfg, ref_params, cfg, _ = _models(16)
    gen = torch.Generator().manual_seed(0)
    params = tm.init_params(dataclasses.replace(cfg, dtype="bfloat16"), gen, device="cpu")
    flat_ref = {"/".join(str(getattr(k, "key", k)) for k in path): v
                for path, v in jax.tree_util.tree_flatten_with_path(ref_params)[0]}
    flat = {"embed": params["embed"], "ln_f": params["ln_f"], "head": params["head"],
            **{f"layers/{k}": v for k, v in params["layers"].items()}}
    assert set(flat) == set(flat_ref)
    for name, v in flat.items():
        assert tuple(v.shape) == flat_ref[name].shape, name
        assert v.dtype == (torch.float32 if name.split("/")[-1].startswith("ln") else torch.bfloat16)
    again = tm.init_params(dataclasses.replace(cfg, dtype="bfloat16"),
                           torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(params["layers"]["wq"], again["layers"]["wq"])


def test_moe_config_builds_params_and_caches():
    """A MoE config builds its parameters (a nested ``moe`` dict stacked on
    L, the router fp32) and both KV arenas, and prefills."""
    _, _, cfg, _ = _models(None)
    mcfg = dataclasses.replace(cfg, moe=MoEConfig(4, 2, 32), d_ff=0)
    params = tm.init_params(mcfg, torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in params["layers"]["moe"].items()} == {
        "router": (2, 64, 4), "w1": (2, 4, 64, 32), "w3": (2, 4, 64, 32), "w2": (2, 4, 32, 64)}
    assert "w1" not in params["layers"]
    assert tm.init_cache(mcfg, 1, 8, device="cpu").k.shape == (2, 1, 8, 2, 16)
    assert tm.init_paged_cache(mcfg, 1, 16, 8, 2, device="cpu").k.shape == (2, 16, 2, 16)
    toks = torch.ones((1, 8), dtype=torch.int32)
    logits, _ = tm.prefill(params, toks, torch.tensor([5], dtype=torch.int32), mcfg, 8)
    assert logits.shape == (1, 97) and bool(torch.isfinite(logits).all())
