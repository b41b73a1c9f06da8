"""Port paged KV arena and int8 KV against the reference on the same inputs
and weights (``params_from_jax``): ``_quant_rows``, ``block_rows``, the
block allocator (``alloc_blocks``, ``_release_refs``, ``free_slot_blocks``),
one paged decode step (against the reference's and against the port's own
contiguous step), and ``ServeEngine`` / ``RAGServeEngine`` over the paged
arena with wave and continuous admission, int8 KV and a pool small enough
to truncate.

Integer state is held exactly: block tables, the free stack, ``n_free``,
refcounts, ``pos``, ``cursor``, int8 rows, bf16 scales and tokens.
Logits and fp32 pool rows within ``atol=rtol=1e-4``, the transformer
tests' tolerance (fp32 on both sides, matmuls summed in another order).
Against the port's own contiguous decode step, logits are bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BruteIndex as RefBruteIndex
from repro.core import GraphTokenizer as RefTokenizer
from repro.core import PipelineConfig as RefPipelineConfig
from repro.core import RGLPipeline as RefPipeline
from repro.core import Vocab as RefVocab
from repro.graph import csr_to_ell as ref_csr_to_ell
from repro.graph import generators as ref_gen
from repro.models.transformer import TransformerConfig as RefConfig
from repro.models.transformer import model as ref_tm
from repro.serving import RAGRequest as RefRAGRequest
from repro.serving import RAGServeEngine as RefRAGServeEngine
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefServeEngine
from repro.serving import engine as ref_engine
from repro_torch.core.indexing import BruteIndex
from repro_torch.core.pipeline import PipelineConfig, RGLPipeline
from repro_torch.core.tokenization import GraphTokenizer, Vocab
from repro_torch.graph import generators
from repro_torch.graph.ell import csr_to_ell
from repro_torch.models.transformer import model as tm
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.serving import engine as port_engine
from repro_torch.serving.engine import Request, ServeEngine, _auto_block_size
from repro_torch.serving.rag_engine import RAGRequest, RAGServeEngine

from _paged_mirrors import assert_mirrors

TOL = dict(atol=1e-4, rtol=1e-4)
BASE = dict(name="paged-t", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_head=16,
            d_ff=64, vocab=64, dtype="float32")


def _models(**kw):
    ref_cfg, cfg = RefConfig(**BASE, **kw), TransformerConfig(**BASE, **kw)
    ref_params = ref_tm.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = tm.params_from_jax(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    return ref_cfg, ref_params, cfg, params


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _equal(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def _same_alloc_state(ref_cache, cache):
    """Integer allocator state, exactly."""
    for name in ("table", "free", "n_free", "ref", "pos", "cursor"):
        _equal(getattr(ref_cache, name), getattr(cache, name))


# ---------------------------------------------------------------- int8 rows ---
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_rows_match(dtype):
    """Absmax scale over d_head, round half to even, clip, bf16 scales; a
    zero row takes the 1e-8 floor, and rows of exact halves round to even."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 2, 16)) * rng.uniform(0.01, 30, (3, 5, 2, 1)))
    x[0, 0, 0] = 0.0
    x[1, 1, 1] = np.arange(16) - 7.5  # scale 7.5/127: halves after the division
    x = x.astype(np.float32)
    jx = jnp.asarray(x, dtype=jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    qa, sa = ref_tm._quant_rows(jx)
    qb, sb = tm._quant_rows(tx)
    assert qb.dtype == torch.int8 and sb.dtype == torch.bfloat16
    _equal(qa, qb)
    _equal(sa, sb)


@pytest.mark.parametrize("seq", [9, 24])
def test_kv_quant_prefill_and_decode_match(seq):
    """int8 on the contiguous arena: prefill's quantized rows and scales (the
    padding at the floor scale), then decode steps with the dequantization
    folded into the scores and the fp32 P·V."""
    ref_cfg, ref_params, cfg, params = _models(kv_quant=True)
    rng = np.random.default_rng(seq)
    toks = rng.integers(1, 64, (2, seq)).astype(np.int32)
    tl = np.array([seq, seq - 4], np.int32)
    lg_a, c_a = ref_tm.prefill(ref_params, jnp.asarray(toks), jnp.asarray(tl), ref_cfg, 40)
    lg_b, c_b = tm.prefill(params, _t(toks), _t(tl), cfg, 40)
    np.testing.assert_allclose(lg_b.numpy(), np.asarray(lg_a), **TOL)
    for name in ("k", "v", "k_scale", "v_scale", "pos", "cursor"):
        _equal(getattr(c_a, name), getattr(c_b, name))
    tok_a, tok_b = jnp.argmax(lg_a, -1).astype(jnp.int32), torch.argmax(lg_b, -1).to(torch.int32)
    for _ in range(6):
        lg_a, c_a = ref_tm.decode_step(ref_params, c_a, tok_a, ref_cfg)
        lg_b, c_b = tm.decode_step(params, c_b, tok_b, cfg)
        np.testing.assert_allclose(lg_b.numpy(), np.asarray(lg_a), **TOL)
        tok_a, tok_b = jnp.argmax(lg_a, -1).astype(jnp.int32), torch.argmax(lg_b, -1).to(torch.int32)
        _equal(tok_a, tok_b)
    for name in ("k", "v", "k_scale", "v_scale", "pos"):
        _equal(getattr(c_a, name), getattr(c_b, name))


# ----------------------------------------------------------- allocator units ---
def test_block_rows_match():
    table = np.array([[3, 0, -1], [-1, -1, -1], [1, 2, 4]], np.int32)
    _equal(ref_tm.block_rows(jnp.asarray(table), 4), tm.block_rows(_t(table), 4))


ALLOC_CASES = {
    # distinct pops, a dead slot that would need blocks
    "dead_slot": (np.full((3, 3), -1), np.arange(6), 6, [2, 3, 1], [True, True, False], 3),
    # incremental: a slot already holding one block gets target - 1 more
    "incremental": (np.array([[7, -1, -1]]), np.r_[np.arange(7), 0], 7, [3], [True], 3),
    # a deep stack, max_new capping the growth, a target below the table
    "capped": (np.array([[0, 5, -1, -1], [2, -1, -1, -1], [-1, -1, -1, -1]]),
               np.array([9, 8, 1, 7, 6, 4, 3, 0, 0, 0]), 7, [4, 4, 0], [True, True, True], 1),
}


@pytest.mark.parametrize("case", sorted(ALLOC_CASES))
def test_alloc_blocks_match(case):
    table, free, n_free, target, live, max_new = ALLOC_CASES[case]
    table, free = np.asarray(table, np.int32), np.asarray(free, np.int32)
    ref0 = np.zeros(free.shape[0], np.int32)
    ref0[table[table >= 0]] = 1
    target, live = np.asarray(target, np.int32), np.asarray(live)
    a = ref_tm.alloc_blocks(jnp.asarray(table), jnp.asarray(free), jnp.asarray(n_free, jnp.int32),
                            jnp.asarray(ref0), jnp.asarray(target), jnp.asarray(live), max_new)
    b = tm.alloc_blocks(_t(table), _t(free), torch.tensor(n_free, dtype=torch.int32), _t(ref0),
                        _t(target), _t(live), max_new)
    for x, y in zip(a, b):
        _equal(x, y)
    got = b[0].numpy()
    held = got[got >= 0]
    assert len(set(held.tolist())) == held.size  # every block held once


def test_release_refs_match():
    rng = np.random.default_rng(1)
    p = 12
    free = np.concatenate([rng.permutation(p)[:5], np.zeros(p - 5)]).astype(np.int32)
    ref0 = rng.integers(0, 3, p).astype(np.int32)
    drops = np.minimum(rng.integers(0, 3, p), ref0 + 1).astype(np.int32)
    a = ref_tm._release_refs(jnp.asarray(free), jnp.asarray(5, jnp.int32), jnp.asarray(ref0),
                             jnp.asarray(drops))
    b = tm._release_refs(_t(free), torch.tensor(5, dtype=torch.int32), _t(ref0), _t(drops))
    for x, y in zip(a, b):
        _equal(x, y)


def test_free_then_realloc_reuses_blocks():
    """free_slot_blocks pushes a retired slot's blocks back (ascending id);
    the next allocation pops exactly those, as the reference does."""
    ref_cfg, _, cfg, _ = _models()
    ca = ref_tm.init_paged_cache(ref_cfg, 2, 32, 16, 4)
    cb = tm.init_paged_cache(cfg, 2, 32, 16, 4, device="cpu")
    for live, target in (([True, False], [2, 0]), ([False, True], [0, 1])):
        ta = ref_tm.alloc_blocks(ca.table, ca.free, ca.n_free, ca.ref,
                                 jnp.asarray(target, jnp.int32), jnp.asarray(live), 2)
        tb = tm.alloc_blocks(cb.table, cb.free, cb.n_free, cb.ref,
                             torch.tensor(target, dtype=torch.int32), torch.tensor(live), 2)
        ca = dataclasses.replace(ca, table=ta[0], n_free=ta[1], ref=ta[2])
        cb = dataclasses.replace(cb, table=tb[0], n_free=tb[1], ref=tb[2])
    held = set(cb.table[0].tolist())
    ca = ref_tm.free_slot_blocks(ca, jnp.asarray([True, False]))
    cb = tm.free_slot_blocks(cb, torch.tensor([True, False]))
    _same_alloc_state(ca, cb)
    assert int(cb.n_free) == 3 and (cb.table[0] == -1).all()
    ta = ref_tm.alloc_blocks(ca.table, ca.free, ca.n_free, ca.ref, jnp.asarray([2, 0], jnp.int32),
                             jnp.asarray([True, False]), 2)
    tb = tm.alloc_blocks(cb.table, cb.free, cb.n_free, cb.ref, torch.tensor([2, 0], dtype=torch.int32),
                         torch.tensor([True, False]), 2)
    for x, y in zip(ta, tb):
        _equal(x, y)
    assert set(tb[0][0].tolist()) == held


# ------------------------------------------------------------ paged decode ---
def _admit_both(ref_cfg, ref_params, cfg, params, prompts, slots, cache_len, bs, pool):
    """Prefill ``prompts`` into slots 0..n-1 of a fresh paged arena on both
    sides, through each engine module's paged merge."""
    n = len(prompts)
    bucket = max(8, max(len(p) for p in prompts))
    toks = np.zeros((slots, bucket), np.int32)
    tl = np.zeros(slots, np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)], tl[i] = p, len(p)
    rows = np.arange(slots, dtype=np.int32)
    newly = np.arange(slots) < n
    lg_a, fresh_a = ref_tm.prefill(ref_params, jnp.asarray(toks), jnp.asarray(tl), ref_cfg,
                                   cache_len)
    first_a = jnp.argmax(lg_a, -1).astype(jnp.int32)
    ca, tok_a = ref_engine._paged_merge_admitted(
        ref_tm.init_paged_cache(ref_cfg, slots, cache_len, bs, pool), fresh_a,
        jnp.zeros(slots, jnp.int32), first_a, jnp.asarray(rows), jnp.asarray(newly),
        jnp.asarray(tl), bs)
    lg_b, fresh_b = tm.prefill(params, _t(toks), _t(tl), cfg, cache_len)
    first_b = torch.argmax(lg_b, -1).to(torch.int32)
    cb, tok_b = port_engine._paged_merge_admitted(
        tm.init_paged_cache(cfg, slots, cache_len, bs, pool, device="cpu"), fresh_b,
        torch.zeros(slots, dtype=torch.int32), first_b, _t(rows), _t(newly), _t(tl), bs)
    _equal(tok_a, tok_b)
    _same_alloc_state(ca, cb)
    return (ca, tok_a), (cb, tok_b), (fresh_b, first_b, tl)


@pytest.mark.parametrize("window,quant", [(None, False), (16, False), (None, True), (16, True)])
def test_paged_decode_step_matches(window, quant):
    """Paged steps against the reference's (logits within tolerance; tokens,
    tables, free stack, refcounts, pos, cursor and int8 rows exact) and
    against the port's own contiguous arena (logits bitwise).  Slot 2 stays
    dead: it never allocates.  Prompts cross block boundaries while
    decoding, and the window (16) is shorter than the sequences."""
    ref_cfg, ref_params, cfg, params = _models(sliding_window=window, kv_quant=quant)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 64, n).astype(np.int32) for n in (13, 8)]
    slots, cache_len, bs, pool = 3, 48, 8, 14
    (ca, tok_a), (cb, tok_b), (fresh, first, tl) = _admit_both(
        ref_cfg, ref_params, cfg, params, prompts, slots, cache_len, bs, pool)
    contig = tm.init_cache(cfg, slots, cache_len, device="cpu")
    newly = np.arange(slots) < len(prompts)
    contig, tok_c = port_engine._merge_admitted(contig, fresh, torch.zeros(slots, dtype=torch.int32),
                                                first, np.arange(slots), newly)
    live = np.array([True, True, False])
    for _ in range(12):
        lg_a, ca = ref_tm.paged_decode_step(ref_params, ca, tok_a, jnp.asarray(live), ref_cfg, bs)
        lg_b, cb = tm.paged_decode_step(params, cb, tok_b, _t(live), cfg, bs)
        lg_c, contig = tm.decode_step(params, contig, tok_c, cfg)
        np.testing.assert_allclose(lg_b.numpy(), np.asarray(lg_a), **TOL)
        assert torch.equal(lg_b[live], lg_c[live])
        tok_a = jnp.argmax(lg_a, -1).astype(jnp.int32)
        tok_b = torch.argmax(lg_b, -1).to(torch.int32)
        tok_c = torch.argmax(lg_c, -1).to(torch.int32)
        _equal(tok_a, tok_b)
        _same_alloc_state(ca, cb)
    assert (cb.table[2] == -1).all()
    if quant:
        for name in ("k", "v", "k_scale", "v_scale"):
            _equal(getattr(ca, name), getattr(cb, name))
    else:
        np.testing.assert_allclose(cb.k.numpy(), np.asarray(ca.k), **TOL)


# bf16: the port's logits and the reference's agree to within the size of the
# reference's own bf16-against-fp32 gap.  On these inputs (4 prompts of 9-30
# tokens, 18 decode steps fed the reference's tokens) that gap is up to 0.034
# on |logits| <= 3.4, and the port's gap to the bf16 reference up to 0.038
# (XLA and PyTorch round bf16 at different points).  The bound is a little
# over twice the reference's own gap.
BF16_ATOL = 0.08


def _bf16_models(**kw):
    ref_cfg, cfg = RefConfig(**{**BASE, "dtype": "bfloat16"}, **kw), \
        TransformerConfig(**{**BASE, "dtype": "bfloat16"}, **kw)
    ref_params = ref_tm.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = tm.params_from_jax(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    return ref_cfg, ref_params, cfg, params


def _bf16_close(a, b):
    np.testing.assert_allclose(_np(b), _np(a), atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("arena,quant", [("contiguous", False), ("paged", False),
                                         ("contiguous", True), ("paged", True)])
def test_bf16_logits_within_tolerance_of_reference(arena, quant):
    """bf16 prefill and decode logits against the reference's, on the
    contiguous arena, the paged pool and with int8 KV (both arenas), within
    ``BF16_ATOL``.  Decode is fed the reference's tokens on both sides, so a
    bf16 near-tie cannot send the two down different paths."""
    ref_cfg, ref_params, cfg, params = _bf16_models(kv_quant=quant)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 64, n).astype(np.int32) for n in (30, 22, 17, 9)]
    slots, cache_len = 4, 48
    if arena == "paged":
        bs, pool = 8, 24
        (ca, tok), (cb, _), _ = _admit_both(ref_cfg, ref_params, cfg, params, prompts, slots,
                                            cache_len, bs, pool)
        live = np.ones(slots, bool)
        step_a = lambda c, t: ref_tm.paged_decode_step(  # noqa: E731
            ref_params, c, t, jnp.asarray(live), ref_cfg, bs)
        step_b = lambda c, t: tm.paged_decode_step(params, c, t, _t(live), cfg, bs)  # noqa: E731
    else:
        toks = np.zeros((slots, 32), np.int32)
        tl = np.array([len(p) for p in prompts], np.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        lg_a, ca = ref_tm.prefill(ref_params, jnp.asarray(toks), jnp.asarray(tl), ref_cfg,
                                  cache_len)
        lg_b, cb = tm.prefill(params, _t(toks), _t(tl), cfg, cache_len)
        _bf16_close(lg_a, lg_b)
        tok = jnp.argmax(lg_a, -1).astype(jnp.int32)
        step_a = lambda c, t: ref_tm.decode_step(ref_params, c, t, ref_cfg)  # noqa: E731
        step_b = lambda c, t: tm.decode_step(params, c, t, cfg)  # noqa: E731
    for _ in range(12):
        lg_a, ca = step_a(ca, tok)
        lg_b, cb = step_b(cb, _t(np.asarray(tok)))
        _bf16_close(lg_a, lg_b)
        tok = jnp.argmax(lg_a, -1).astype(jnp.int32)


@pytest.mark.parametrize("quant", [False, True])
def test_bf16_tokens_equal_across_the_ports_arenas_and_decode_modes(quant):
    """bf16 tokens are held exactly port against port: the paged serve and
    the speculative serves emit the contiguous one-token serve's tokens
    (exact token parity with the reference is an fp32 bar)."""
    _, _, cfg, params = _bf16_models(kv_quant=quant)
    outs = {}
    for paged, spec in ((False, False), (True, False), (False, True), (True, True)):
        eng = ServeEngine(params, cfg, slots=3, cache_len=48, paged_kv=paged, spec_decode=spec,
                          draft_window=4, device="cpu")
        for r in _mixed(Request, seed=5):
            eng.submit(r)
        outs[paged, spec] = {r.uid: r.out_tokens for r in eng.run_to_completion()}
    for key, got in outs.items():
        assert got == outs[False, False], key


def test_paged_serve_step_argmax():
    ref_cfg, ref_params, cfg, params = _models()
    prompts = [np.arange(1, 12, dtype=np.int32)]
    (ca, tok_a), (cb, tok_b), _ = _admit_both(ref_cfg, ref_params, cfg, params, prompts, 2, 32,
                                              8, 8)
    live = np.array([True, False])
    nxt_a, ca = ref_tm.paged_serve_step(ref_params, ca, tok_a, jnp.asarray(live), ref_cfg, 8)
    nxt_b, cb = tm.paged_serve_step(params, cb, tok_b, _t(live), cfg, 8)
    assert nxt_b.dtype == torch.int32
    _equal(nxt_a, nxt_b)
    _same_alloc_state(ca, cb)


# ------------------------------------------------------------ slot engine ---
def _mixed(cls, seed=3):
    """Random and repetitive prompts, mixed lengths, a max_new=1 finish."""
    rng = np.random.default_rng(seed)
    out = []
    for u, mn in enumerate([5, 12, 1, 30, 8, 12, 25]):
        if u % 2:
            pat = rng.integers(1, 64, size=int(rng.integers(2, 4)))
            p = np.tile(pat, 6)[: int(rng.integers(4, 10))]
        else:
            p = rng.integers(1, 64, size=int(rng.integers(3, 10)))
        out.append(cls(uid=u, prompt_ids=p.astype(np.int32), max_new_tokens=mn))
    return out


def _engines(quant=False, **kw):
    ref_cfg, ref_params, cfg, params = _models(kv_quant=quant)
    ref = RefServeEngine(ref_params, ref_cfg, spec_decode=False, **kw)
    port = ServeEngine(params, cfg, device="cpu", **kw)
    return ref, port


def _same_engine_state(ref, port):
    for name in ("table", "free", "n_free", "ref"):
        _equal(getattr(ref.cache, name), getattr(port.cache, name))
    assert ref._free_stack == port._free_stack
    assert ref._ref_host.tolist() == port._ref_host.tolist()
    assert ref._slot_blocks == port._slot_blocks
    sa, sb = ref.decode_stats(), port.decode_stats()
    for key in sa:
        if key != "admit_seconds":
            assert sa[key] == sb[key], key


@pytest.mark.parametrize("quant,pool", [(False, None), (True, None), (False, 4), (True, 4)])
def test_paged_engine_matches_reference(quant, pool):
    """Staggered turnover (retirement frees interleaved with admission
    allocs), int8 KV, and undersized pools that gate admission and truncate
    mid-decode: per-uid tokens, truncated flags, final tables, free stack,
    refcounts and every stats key equal the reference engine's."""
    ref, port = _engines(quant, slots=3, cache_len=48, paged_kv=True, pool_blocks=pool)
    for eng, cls in ((ref, RefRequest), (port, Request)):
        for r in _mixed(cls):
            eng.submit(r)
    a = {r.uid: (r.out_tokens, r.truncated) for r in ref.run_to_completion()}
    b = {r.uid: (r.out_tokens, r.truncated) for r in port.run_to_completion()}
    assert a == b and sorted(b) == list(range(7))
    _same_engine_state(ref, port)
    assert_mirrors(port)
    assert port._free_host == port.pool_blocks and not any(port._slot_blocks)
    if pool is not None:
        assert port.truncations > 0


@pytest.mark.parametrize("quant", [False, True])
def test_paged_engine_equals_contiguous(quant):
    """The port's paged engine emits the port's contiguous engine's tokens."""
    _, _, cfg, params = _models(kv_quant=quant)
    outs = []
    for paged in (False, True):
        eng = ServeEngine(params, cfg, slots=3, cache_len=48, paged_kv=paged, device="cpu")
        for r in _mixed(Request, seed=5):
            eng.submit(r)
        outs.append({r.uid: r.out_tokens for r in eng.run_to_completion()})
    assert outs[0] == outs[1]


def test_engine_churn_keeps_mirrors_exact():
    """Back-to-back batches through a minimal pool: after every step the
    host mirrors equal the device allocator, and each batch drains the pool
    back to full, as on the reference."""
    ref, port = _engines(slots=2, cache_len=32, paged_kv=True, block_size=8, pool_blocks=8)
    rng = np.random.default_rng(9)
    for batch in range(3):
        prompts = [rng.integers(1, 64, size=7).astype(np.int32) for _ in range(4)]
        for eng, cls in ((ref, RefRequest), (port, Request)):
            for u, p in enumerate(prompts):
                eng.submit(cls(uid=batch * 10 + u, prompt_ids=p, max_new_tokens=10))
        done_a, done_b = [], []
        while port.queue or port.live.any():
            done_a += ref.step()
            done_b += port.step()
            assert_mirrors(port)
            assert ref._free_stack == port._free_stack
        assert {r.uid: r.out_tokens for r in done_a} == {r.uid: r.out_tokens for r in done_b}
        assert port._free_host == 8 and int(port.cache.n_free) == 8
    assert port.pool_high_water == ref.pool_high_water <= 8


def test_abort_returns_paged_blocks():
    _, port = _engines(slots=2, cache_len=32, paged_kv=True, block_size=8)
    for r in _mixed(Request)[:4]:
        port.submit(r)
    port.step()
    port.step()
    out = port.abort("test")
    assert len(out) == 4 and all(r.failed for r in out)
    assert port._free_host == port.pool_blocks and (port.cache.ref == 0).all()
    assert_mirrors(port)


def test_env_toggle_and_validation(monkeypatch):
    _, _, cfg, params = _models()

    def make(**kw):
        return ServeEngine(params, cfg, slots=1, cache_len=32, device="cpu", **kw)

    monkeypatch.delenv("RGL_PAGED_KV", raising=False)
    monkeypatch.delenv("RGL_KV_BLOCK", raising=False)
    assert not make().paged_kv
    monkeypatch.setenv("RGL_PAGED_KV", "1")
    eng = make()
    assert eng.paged_kv and eng.block_size == 16 and eng.pool_blocks == 2
    assert not make(paged_kv=False).paged_kv
    monkeypatch.setenv("RGL_KV_BLOCK", "8")
    assert make().block_size == 8
    with pytest.raises(ValueError, match="divide"):
        make(block_size=7)
    with pytest.raises(ValueError, match="pool_blocks"):
        make(block_size=8, pool_blocks=3)
    with pytest.raises(ValueError, match="divide"):
        tm.init_paged_cache(cfg, 1, 32, 7, 8, device="cpu")


def test_auto_block_size_matches_reference():
    for n in (13, 24, 34, 48, 100, 103, 512, 4096):
        assert _auto_block_size(n) == ref_engine._auto_block_size(n)


# ------------------------------------------------------------- RAG engine ---
N_NODES = 100


@pytest.fixture(scope="module")
def rag_stack():
    g_ref = ref_gen.citation_graph(N_NODES, avg_deg=6, seed=11)
    g = generators.citation_graph(N_NODES, avg_deg=6, seed=11)
    pcfg = dict(strategy="bfs", k_seeds=3, max_hops=2, max_nodes=12, filter_budget=6)
    vocab_ref, vocab = RefVocab.build(g_ref.node_text), Vocab.build(g.node_text)
    ref_pipe = RefPipeline(
        graph=ref_csr_to_ell(g_ref), index=RefBruteIndex.build(jnp.asarray(g_ref.node_feat)),
        node_emb=jnp.asarray(g_ref.node_feat),
        tokenizer=RefTokenizer(vocab_ref, max_len=48, node_budget=6),
        node_text=g_ref.node_text, config=RefPipelineConfig(**pcfg))
    ell = csr_to_ell(g, device="cpu")
    pipe = RGLPipeline(
        graph=ell, index=BruteIndex.build(g.node_feat, device="cpu"), node_emb=ell.node_feat,
        tokenizer=GraphTokenizer(vocab, max_len=48, node_budget=6), node_text=g.node_text,
        config=PipelineConfig(**pcfg), device="cpu")
    out = {}
    for quant in (False, True):
        kw = dict(BASE, name="paged-rag-t", vocab=vocab.size, kv_quant=quant)
        ref_cfg, cfg = RefConfig(**kw), TransformerConfig(**kw)
        ref_params = ref_tm.init_params(jax.random.PRNGKey(0), ref_cfg)
        params = tm.params_from_jax(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
        out[quant] = ((ref_pipe, ref_cfg, ref_params), (pipe, cfg, params))
    return g, out


def _rag_run(g, side, is_ref, q_ids=(0, 1, 2, 0, 3, 1), max_new=None, **kw):
    pipe, cfg, params = side
    if is_ref:
        eng = RefRAGServeEngine(pipe, params, cfg, slots=2, cache_len=96, prefetch=False,
                                spec_decode=False, **kw)
        cls = RefRAGRequest
    else:
        eng = RAGServeEngine(pipe, params, cfg, slots=2, cache_len=96, device="cpu", **kw)
        cls = RAGRequest
    for u, qi in enumerate(q_ids):
        eng.submit(cls(uid=u, query_emb=np.asarray(g.node_feat[qi]), query_text=g.node_text[qi],
                       max_new_tokens=max_new or 4 + 2 * (u % 3)))
    return eng, {r.uid: r for r in eng.run_to_completion()}


def _same_rag(a, b, ref, port):
    assert sorted(a) == sorted(b) == sorted(range(len(a)))
    for uid in a:
        assert a[uid].out_tokens == b[uid].out_tokens, uid
        assert a[uid].truncated == b[uid].truncated, uid
        np.testing.assert_array_equal(a[uid].retrieved_nodes, b[uid].retrieved_nodes)
        np.testing.assert_array_equal(a[uid].prompt_ids, b[uid].prompt_ids)
    sa, sb = ref.stats(), port.stats()
    for key in ("hits", "misses", "evictions", "retrieval_batches", "retrieved_queries",
                "decode_steps", "emitted_tokens", "prefill_batches", "prefill_rows",
                "truncations", "admission", "paged_kv", "kv_pinned_entries"):
        assert sa[key] == sb[key], key
    if sb["paged_kv"]:
        _same_engine_state(ref.engine, port.engine)
        assert_mirrors(port.engine)


@pytest.mark.parametrize("admission,paged,quant", [
    ("wave", True, False), ("continuous", False, False), ("continuous", True, False),
    ("continuous", True, True), ("wave", False, True),
])
def test_rag_engine_matches_reference(rag_stack, admission, paged, quant):
    """Wave and continuous admission over both arenas, int8 KV on both:
    tokens, retrievals, prompts, truncated flags, retrieval batches (one a
    request under continuous admission), cache totals and allocator state
    equal the reference's."""
    g, sides = rag_stack
    ref_side, port_side = sides[quant]
    kw = dict(admission=admission, paged_kv=paged)
    ref, a = _rag_run(g, ref_side, True, **kw)
    port, b = _rag_run(g, port_side, False, **kw)
    _same_rag(a, b, ref, port)
    if admission == "continuous":
        assert port.stats()["retrieval_batches"] == port.stats()["misses"]


def test_rag_continuous_equals_wave(rag_stack):
    """Greedy decode is schedule-invariant: continuous admission emits wave
    admission's tokens on the port too."""
    g, sides = rag_stack
    runs = [_rag_run(g, sides[False][1], False, admission=adm, paged_kv=True)[1]
            for adm in ("wave", "continuous")]
    assert {u: r.out_tokens for u, r in runs[0].items()} == \
        {u: r.out_tokens for u, r in runs[1].items()}


def test_rag_pool_exhaustion_matches_reference(rag_stack):
    """An undersized pool: truncated requests, their flags and counts equal
    the reference's, and the pool is whole after the drain."""
    g, sides = rag_stack
    kw = dict(paged_kv=True, kv_block_size=16, kv_pool_blocks=6, cache_capacity=0,
              q_ids=(0, 1, 2, 3), max_new=64)
    ref, a = _rag_run(g, sides[False][0], True, **kw)
    port, b = _rag_run(g, sides[False][1], False, **kw)
    _same_rag(a, b, ref, port)
    assert any(r.truncated for r in b.values())
    assert port.stats()["truncations"] == sum(r.truncated for r in b.values())
    assert port.engine._free_host == 6


def test_launcher_serves_paged_share_continuous(capsys):
    """``launch.serve --rag`` with the paged, prefix-share and continuous
    flags on the CPU: its requests get the tokens of a direct
    ``RAGServeEngine`` run with the same settings, pipeline and weights, and
    it prints the paged-pool and prefix-share lines."""
    from repro_torch.launch import serve

    out = serve.main(["--arch", "starcoder2-3b", "--rag", "--device", "cpu", "--nodes", "300",
                      "--requests", "10", "--max_new", "7", "--paged-kv", "--prefix-share",
                      "--admission", "continuous", "--kv-block", "8"])
    printed = capsys.readouterr().out
    assert "paged KV: block=8 tokens" in printed and "prefix share:" in printed
    s = out["stats"]
    assert s["admission"] == "continuous" and s["paged_kv"] and s["block_size"] == 8
    pipe = out["engine"].pipeline
    direct = RAGServeEngine(pipe, out["params"], out["cfg"], slots=4, cache_len=out["cache_len"],
                            admission="continuous", paged_kv=True, prefix_share=True,
                            kv_block_size=8, device="cpu")
    q_ids = np.random.default_rng(0).choice(300, size=10, replace=True)
    g = generators.citation_graph(300, avg_deg=8, seed=0)
    for u, qi in enumerate(q_ids):
        direct.submit(RAGRequest(uid=u, query_emb=g.node_feat[qi],
                                 query_text=" ".join(g.node_text[qi].split()[:4]),
                                 max_new_tokens=7))
    want = {r.uid: r.out_tokens for r in direct.run_to_completion()}
    assert {r.uid: r.out_tokens for r in out["done"]} == want
    assert direct.stats()["kv_shared_admits"] == s["kv_shared_admits"]
