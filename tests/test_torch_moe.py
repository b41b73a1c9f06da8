"""The port's MoE FFN and MoE LM against the reference on the same inputs and
weights (``params_from_jax``), on the CPU: ``moe_ffn`` at a capacity that
drops and one that does not, with router ties forced, and its gradients;
the MoE LM's prefill, decode, verify and paged logits; greedy tokens through
``ServeEngine`` and ``RAGServeEngine`` (contiguous, paged + share, int8 KV,
speculative), whose padded prefill buckets and dead slots decide the drops;
``lm_loss`` and its gradients, three ``make_train_step`` steps; and bf16
logits.

Tolerances (fp32 unless named):
- which (token, slot) pairs are kept and which experts they go to: exact
  (integer outputs; the tie cases use small integers and dyadic router
  weights, so both sides compute every logit exactly and equal columns tie
  bitwise);
- ``moe_ffn``'s y ``atol=rtol=1e-5`` and aux ``1e-6``: the same fp32 products,
  summed in another order (grouped GEMMs, and the combine sums over k where
  XLA's ``segment_sum`` adds in its own order);
- gradients, logits and losses ``atol=rtol=1e-4``, as the dense model's
  tests: the differences compound over layers, steps and the backward;
- train-step losses ``rtol=1e-3``, as ``tests/test_torch_training.py``
  explains (Adam's division by sqrt(v) + eps);
- bf16 logits: see ``BF16_ATOL``.
Greedy tokens and every integer engine statistic are exact.
"""
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
from repro.models.transformer import MoEConfig as RefMoEConfig
from repro.models.transformer import TransformerConfig as RefConfig
from repro.models.transformer import model as ref_tm
from repro.models.transformer import moe as ref_moe
from repro.serving import RAGRequest as RefRAGRequest
from repro.serving import RAGServeEngine as RefRAGServeEngine
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefServeEngine
from repro.serving import engine as ref_engine
from repro.training import loop as ref_loop
from repro.training import optimizer as ref_opt
from repro_torch.core.indexing import BruteIndex
from repro_torch.core.pipeline import PipelineConfig, RGLPipeline
from repro_torch.core.tokenization import GraphTokenizer, Vocab
from repro_torch.graph import generators
from repro_torch.graph.ell import csr_to_ell
from repro_torch.models.transformer import model as tm
from repro_torch.models.transformer import moe
from repro_torch.models.transformer.config import MoEConfig, TransformerConfig
from repro_torch.serving import engine as port_engine
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.rag_engine import RAGRequest, RAGServeEngine
from repro_torch.training import loop, optimizer
from repro_torch.tree import tree_map

from _paged_mirrors import assert_mirrors

TOL = dict(atol=1e-4, rtol=1e-4)
BASE = dict(name="moe-t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_head=8, d_ff=0,
            vocab=64, dtype="float32")
MOE = dict(n_experts=8, top_k=2, d_ff=32)
_MODELS: dict = {}


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.detach().float() if x.dtype == torch.bfloat16 else x.detach()).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, **tol):
    np.testing.assert_allclose(_np(b), _np(a), **(tol or TOL))


def _equal(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def _models(dtype="float32", moe_kw=(), **kw):
    """(ref_cfg, ref_params, cfg, params) of the MoE LM from one reference
    init, cached."""
    key = (dtype, tuple(moe_kw), tuple(sorted(kw.items())))
    if key not in _MODELS:
        m = dict(MOE, **dict(moe_kw))
        c = dict(BASE, dtype=dtype, **kw)
        ref_cfg = RefConfig(**c, moe=RefMoEConfig(**m))
        cfg = TransformerConfig(**c, moe=MoEConfig(**m))
        ref_params = ref_tm.init_params(jax.random.PRNGKey(0), ref_cfg)
        params = tm.params_from_jax(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
        _MODELS[key] = (ref_cfg, ref_params, cfg, params)
    return _MODELS[key]


# ------------------------------------------------------------------ moe_ffn ---
def _ref_routing(p, x, cfg):
    """The reference's routing decisions (``moe.py:38-63``) in its own
    primitives: (expert (T, k), keep (T, k)) in (token, slot) order."""
    t = x.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = max(8, -(-int(cfg.capacity_factor * t * k / e) // 8) * 8)
    probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    flat_e = top_e.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = jnp.zeros((e,), jnp.int32).at[se].add(1)
    starts = jnp.cumsum(counts) - counts
    rank = jnp.arange(t * k, dtype=jnp.int32) - starts[se]
    keep = jnp.zeros((t * k,), bool).at[order].set(rank < cap)
    return np.asarray(top_e), np.asarray(keep).reshape(t, k)


def _ffn_inputs(cf, ties, t=48, d=16, e=8, k=2):
    ref_cfg = RefMoEConfig(n_experts=e, top_k=k, d_ff=24, capacity_factor=cf)
    cfg = MoEConfig(n_experts=e, top_k=k, d_ff=24, capacity_factor=cf)
    ref_p = jax.tree.map(np.asarray, ref_moe.init_moe_params(jax.random.PRNGKey(3), d, ref_cfg,
                                                             jnp.float32))
    rng = np.random.default_rng(7)
    if ties:  # exact logits: small integers times dyadic weights; columns 5, 7 = 2 and 4 = 1
        x = rng.integers(-3, 4, (t, d)).astype(np.float32)
        router = (rng.integers(-8, 9, (d, e)) / 8).astype(np.float32)
        router[:, 5] = router[:, 7] = router[:, 2]
        router[:, 4] = router[:, 1]
        ref_p["router"] = router
    else:
        x = rng.standard_normal((t, d)).astype(np.float32)
    return ref_cfg, cfg, ref_p, tree_map(_t, ref_p), x


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("cf", [4.0, 0.5])  # 4.0 = E / k: no expert can overflow
def test_moe_ffn_matches_reference(cf, ties):
    ref_cfg, cfg, ref_p, p, x = _ffn_inputs(cf, ties)
    y_a, aux_a = ref_moe.moe_ffn(ref_p, jnp.asarray(x), ref_cfg)
    y_b, aux_b = moe.moe_ffn(p, _t(x), cfg)
    r = moe.route(p, _t(x), cfg)
    top_e, keep = _ref_routing(ref_p, jnp.asarray(x), ref_cfg)
    _equal(top_e, r["expert"])
    _equal(keep, r["keep"])
    assert keep.all() if cf == 4.0 else not keep.all()
    _close(y_a, y_b, atol=1e-5, rtol=1e-5)
    _close(aux_a, aux_b, atol=1e-6, rtol=1e-6)
    assert y_b.dtype == torch.float32 and y_b.shape == (48, 16)
    if ties:  # some token's top-k was decided by the lower-index rule
        probs = _np(r["probs"])
        decided = [(i, a, b) for i in range(48) for a, b in ((2, 5), (2, 7), (1, 4))
                   if probs[i, a] == probs[i, b] and a in top_e[i] and b not in top_e[i]]
        assert decided, "no tie reached the top-k boundary"


def test_capacity_formula():
    cfg = MoEConfig(n_experts=32, top_k=8, d_ff=512)
    # decode at 4 slots, prefill 4 x 128, the training micro-batch of 4096
    assert [moe.capacity(cfg, t) for t in (4, 512, 4096, 1)] == [8, 160, 1280, 8]
    assert moe.capacity(MoEConfig(8, 2, 32, capacity_factor=0.5), 48) == 8


def test_moe_ffn_grads_match_reference():
    ref_cfg, cfg, ref_p, p, x = _ffn_inputs(0.5, False)
    w = np.random.default_rng(1).standard_normal((48, 16)).astype(np.float32)

    def f(params, xx):
        y, aux = ref_moe.moe_ffn(params, xx, ref_cfg)
        return jnp.sum(y * w) + 0.3 * aux

    g_p, g_x = jax.grad(f, argnums=(0, 1))({k: jnp.asarray(v) for k, v in ref_p.items()},
                                          jnp.asarray(x))
    pt = {k: v.clone().requires_grad_() for k, v in p.items()}
    xt = _t(x).requires_grad_()
    y, aux = moe.moe_ffn(pt, xt, cfg)
    (torch.sum(y * _t(w)) + 0.3 * aux).backward()
    _close(g_x, xt.grad)
    for name in ("router", "w1", "w3", "w2"):
        _close(g_p[name], pt[name].grad)


def test_moe_init_and_conversion_keep_the_reference_layout():
    ref_cfg, ref_params, cfg, params = _models()
    own = tm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for tree in (params, own):
        assert set(tree["layers"]) == set(ref_params["layers"])
        for name, leaf in ref_params["layers"]["moe"].items():
            got = tree["layers"]["moe"][name]
            assert tuple(got.shape) == leaf.shape and got.dtype == torch.float32, name
    bf = tm.init_params(TransformerConfig(**dict(BASE, dtype="bfloat16"), moe=MoEConfig(**MOE)),
                        torch.Generator().manual_seed(0), device="cpu")
    assert bf["layers"]["moe"]["router"].dtype == torch.float32
    assert bf["layers"]["moe"]["w1"].dtype == torch.bfloat16
    assert tm.layer_params(params, 1)["moe"]["w2"].shape == (8, 32, 32)


# ------------------------------------------------------------- model steps ---
@pytest.mark.parametrize("quant", [False, True])
def test_moe_prefill_decode_and_verify_match(quant):
    """Prefill of a padded bucket (its padding rows count in T and overflow
    the experts they all pick), six decode steps, then one verify window
    and a verify step, logits and caches against the reference's."""
    ref_cfg, ref_params, cfg, params = _models(kv_quant=quant)
    rng = np.random.default_rng(0)
    toks = np.zeros((3, 16), np.int32)
    tl = np.array([16, 9, 4], np.int32)
    for i, n in enumerate(tl):
        toks[i, :n] = rng.integers(1, 64, n)
    lg_a, ca = ref_tm.prefill(ref_params, jnp.asarray(toks), jnp.asarray(tl), ref_cfg, 40)
    lg_b, cb = tm.prefill(params, _t(toks), _t(tl), cfg, 40)
    _close(lg_a, lg_b)
    tok = jnp.argmax(lg_a, -1).astype(jnp.int32)
    _equal(tok, torch.argmax(lg_b, -1))
    for _ in range(6):
        lg_a, ca = ref_tm.decode_step(ref_params, ca, tok, ref_cfg)
        lg_b, cb = tm.decode_step(params, cb, _t(np.asarray(tok)), cfg)
        _close(lg_a, lg_b)
        tok = jnp.argmax(lg_a, -1).astype(jnp.int32)
    fed = np.concatenate([np.asarray(tok)[:, None], rng.integers(1, 64, (3, 3))], 1)
    fed = fed.astype(np.int32)
    room = np.array([4, 2, 1], np.int32)
    ga, acc_a, cur_a, ca = ref_tm.verify_step(ref_params, ca, jnp.asarray(fed),
                                              jnp.asarray(room), ref_cfg)
    gb, acc_b, cur_b, cb = tm.verify_step(params, cb, _t(fed), _t(room), cfg)
    for a, b in ((ga, gb), (acc_a, acc_b), (cur_a, cur_b), (ca.cursor, cb.cursor), (ca.pos, cb.pos)):
        _equal(a, b)
    if quant:
        _equal(ca.k, cb.k)
    else:
        _close(ca.k, cb.k)
        _close(ca.v, cb.v)


@pytest.mark.parametrize("quant", [False, True])
def test_moe_paged_decode_and_verify_match(quant):
    """Paged decode steps (a dead slot in the batch) and a paged verify step
    against the reference's, logits and allocator state."""
    ref_cfg, ref_params, cfg, params = _models(kv_quant=quant)
    rng = np.random.default_rng(1)
    slots, cache_len, bs, pool = 4, 32, 8, 14
    prompts = [rng.integers(1, 64, n).astype(np.int32) for n in (11, 5, 8)]
    toks = np.zeros((slots, 16), np.int32)
    tl = np.zeros(slots, np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)], tl[i] = p, len(p)
    rows, newly = np.arange(slots, dtype=np.int32), np.arange(slots) < len(prompts)
    lg_a, fresh_a = ref_tm.prefill(ref_params, jnp.asarray(toks), jnp.asarray(tl), ref_cfg,
                                   cache_len)
    ca, tok_a = ref_engine._paged_merge_admitted(
        ref_tm.init_paged_cache(ref_cfg, slots, cache_len, bs, pool), fresh_a,
        jnp.zeros(slots, jnp.int32), jnp.argmax(lg_a, -1).astype(jnp.int32), jnp.asarray(rows),
        jnp.asarray(newly), jnp.asarray(tl), bs)
    lg_b, fresh_b = tm.prefill(params, _t(toks), _t(tl), cfg, cache_len)
    cb, tok_b = port_engine._paged_merge_admitted(
        tm.init_paged_cache(cfg, slots, cache_len, bs, pool, device="cpu"), fresh_b,
        torch.zeros(slots, dtype=torch.int32), torch.argmax(lg_b, -1).to(torch.int32),
        _t(rows), _t(newly), _t(tl), bs)
    _equal(tok_a, tok_b)
    live = newly
    for _ in range(5):
        lg_a, ca = ref_tm.paged_decode_step(ref_params, ca, tok_a, jnp.asarray(live), ref_cfg, bs)
        lg_b, cb = tm.paged_decode_step(params, cb, _t(np.asarray(tok_a)), _t(live), cfg, bs)
        _close(np.asarray(lg_a)[live], lg_b.numpy()[live])
        tok_a = jnp.argmax(lg_a, -1).astype(jnp.int32)
    fed = np.concatenate([np.asarray(tok_a)[:, None], rng.integers(1, 64, (slots, 3))], 1)
    fed = fed.astype(np.int32)
    room = np.full(slots, 4, np.int32)
    ga, acc_a, _, ca = ref_tm.paged_verify_step(ref_params, ca, jnp.asarray(fed),
                                                jnp.asarray(room), jnp.asarray(live), ref_cfg,
                                                block_size=bs)
    gb, acc_b, _, cb = tm.paged_verify_step(params, cb, _t(fed), _t(room), _t(live), cfg,
                                            block_size=bs)
    _equal(np.asarray(ga)[live], gb.numpy()[live])
    _equal(acc_a, acc_b)
    for field in ("table", "free", "n_free", "ref", "cursor", "pos"):
        _equal(getattr(ca, field), getattr(cb, field))


# ------------------------------------------------------------------ engines ---
def _requests(cls, seed=3):
    """Random and repetitive prompts and mixed lengths (staggered turnover,
    so decode batches hold dead slots), one finished at admission."""
    rng = np.random.default_rng(seed)
    out = []
    for u, mn in enumerate([5, 12, 1, 20, 8, 12, 16]):
        if u % 2:
            p = np.tile(rng.integers(1, 64, size=int(rng.integers(2, 4))), 6)[:int(rng.integers(4, 10))]
        else:
            p = rng.integers(1, 64, size=int(rng.integers(3, 14)))
        out.append(cls(uid=u, prompt_ids=p.astype(np.int32), max_new_tokens=mn))
    return out


@pytest.fixture
def drop_counter(monkeypatch):
    """Counts the (token, slot) pairs the port's router drops."""
    dropped = []
    route = moe.route

    def counting(params, x, cfg):
        r = route(params, x, cfg)
        dropped.append(int((~r["keep"]).sum()))
        return r

    monkeypatch.setattr(moe, "route", counting)
    return dropped


@pytest.mark.parametrize("paged,spec,quant", [
    (False, False, False), (True, False, False), (False, True, False), (True, True, False),
    (False, False, True), (True, True, True)])
def test_moe_serve_engine_matches_reference(paged, spec, quant, drop_counter):
    ref_cfg, ref_params, cfg, params = _models(kv_quant=quant)
    kw = dict(slots=3, cache_len=48, paged_kv=paged, spec_decode=spec, draft_window=4)
    if paged:
        kw["block_size"] = 8
    ref = RefServeEngine(ref_params, ref_cfg, **kw)
    port = ServeEngine(params, cfg, device="cpu", **kw)
    outs = []
    for eng, cls in ((ref, RefRequest), (port, Request)):
        for r in _requests(cls):
            eng.submit(r)
        outs.append({r.uid: (r.out_tokens, r.truncated) for r in eng.run_to_completion()})
    assert outs[0] == outs[1]
    sa, sb = ref.decode_stats(), port.decode_stats()
    for key in sa:
        if key not in ("admit_seconds", "decode_seconds"):
            assert sa[key] == sb[key], key
    if paged:
        assert_mirrors(port)
    assert sum(drop_counter) > 0  # padded buckets overflow the experts their rows pick


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
    return g, ref_pipe, pipe, vocab.size


@pytest.mark.parametrize("arena,spec,quant", [
    ("contiguous", False, False), ("paged_share", False, False), ("contiguous", True, False),
    ("paged_share", True, False), ("paged_share", False, True), ("contiguous", True, True)])
def test_moe_rag_engine_matches_reference(rag_stack, arena, spec, quant):
    """The fused RAG engine serving the MoE LM: tokens, retrieved nodes,
    prompts, cache totals, share counters and the paged allocator equal the
    reference's."""
    g, ref_pipe, pipe, vocab_size = rag_stack
    ref_cfg, ref_params, cfg, params = _models(kv_quant=quant, vocab=vocab_size, name="moe-rag")
    kw = dict(slots=2, cache_len=96, paged_kv=arena == "paged_share",
              prefix_share=arena == "paged_share", spec_decode=spec, draft_window=4)
    ref = RefRAGServeEngine(ref_pipe, ref_params, ref_cfg, prefetch=False, **kw)
    port = RAGServeEngine(pipe, params, cfg, device="cpu", **kw)
    runs = []
    for eng, cls in ((ref, RefRAGRequest), (port, RAGRequest)):
        for u, qi in enumerate((0, 1, 2, 0, 3, 1)):
            eng.submit(cls(uid=u, query_emb=np.asarray(g.node_feat[qi]),
                           query_text=g.node_text[qi], max_new_tokens=4 + 3 * (u % 3)))
        runs.append({r.uid: r for r in eng.run_to_completion()})
    a, b = runs
    assert sorted(a) == sorted(b) == list(range(6))
    for uid in a:
        assert (a[uid].out_tokens, a[uid].truncated) == (b[uid].out_tokens, b[uid].truncated)
        _equal(a[uid].retrieved_nodes, b[uid].retrieved_nodes)
        _equal(a[uid].prompt_ids, b[uid].prompt_ids)
    sa, sb = ref.stats(), port.stats()
    keys = ["hits", "misses", "retrieval_batches", "decode_steps", "emitted_tokens",
            "prefill_batches", "prefill_rows", "truncations", "draft_proposed", "draft_accepted"]
    if arena == "paged_share":
        keys += ["kv_shared_admits", "kv_reused_tokens", "kv_cow_copies", "kv_pins",
                 "kv_releases", "kv_pinned_blocks", "pool_high_water_blocks"]
        assert_mirrors(port.engine)
    for key in keys:
        assert sa[key] == sb[key], key
    assert sb["hits"] >= 2


# ----------------------------------------------------------------- training ---
@pytest.mark.parametrize("remat", [True, False])
def test_moe_lm_loss_and_grads_match(remat):
    """``lm_loss`` (its aux term summed over the layers) and every gradient,
    the nested ``moe`` leaves included, through the per-layer training
    view; S = 40 routes 80 rows a micro-batch with drops."""
    ref_cfg, ref_params, cfg, params = _models(remat=remat, moe_kw=(("capacity_factor", 1.0),))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 64, (2, 40)).astype(np.int32)
    mask = rng.random((2, 40)) < 0.8
    (loss_a, met_a), g_a = jax.value_and_grad(ref_tm.lm_loss, has_aux=True)(
        ref_params, jnp.asarray(toks), jnp.asarray(mask), ref_cfg)
    grads = tree_map(torch.zeros_like, params)
    loss_b, met_b = tm.lm_loss(loop.train_view(params, grads), _t(toks), _t(mask), cfg)
    loss_b.backward()
    _close(loss_a, loss_b)
    for key in ("nll", "aux", "tokens"):
        _close(met_a[key], met_b[key])
    assert float(met_b["aux"].detach()) > 1.0  # two layers' Switch losses, each >= 1
    g_a = jax.tree.map(np.asarray, g_a)
    tree_map(lambda got, want: _close(want, got), grads, g_a)


def test_moe_train_steps_match():
    ref_cfg, ref_params, cfg, params = _models()
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    init_a, step_a = ref_loop.make_train_step(
        lambda p, b: ref_tm.lm_loss(p, b["tokens"], b["loss_mask"], ref_cfg),
        ref_opt.AdamWConfig(**kw), n_microbatches=2)
    init_b, step_b = loop.make_train_step(
        lambda p, b: tm.lm_loss(p, b["tokens"], b["loss_mask"], cfg),
        optimizer.AdamWConfig(**kw), n_microbatches=2)
    params = tree_map(torch.clone, params)
    state_a, state_b = init_a(ref_params), init_b(params)
    step_a = jax.jit(step_a)
    for i in range(3):
        rng = np.random.default_rng(100 + i)
        toks = rng.integers(0, 64, (4, 24)).astype(np.int32)
        mask = rng.random((4, 24)) < 0.8
        state_a, m_a = step_a(state_a, {"tokens": jnp.asarray(toks), "loss_mask": jnp.asarray(mask)})
        state_b, m_b = step_b(state_b, {"tokens": _t(toks), "loss_mask": _t(mask)})
        for key in ("loss", "nll", "aux", "grad_norm", "lr"):
            _close(m_a[key], m_b[key], rtol=1e-3, atol=0)
    assert state_b["params"] is params and int(state_b["opt"]["step"]) == 3
    _close(state_a["params"]["layers"]["moe"]["router"], params["layers"]["moe"]["router"],
           rtol=1e-3, atol=1e-5)


# --------------------------------------------------------------------- bf16 ---
# bf16 logits of the MoE LM against the reference's.  On these inputs (one
# 4-prompt prefill, 10 decode steps fed the reference's tokens) the
# reference's own bf16-against-fp32 gap was 0.026 on |logits| <= 3.4, and the
# port's gap to the bf16 reference 0.034: XLA and PyTorch round bf16 at
# different points (the router itself runs in fp32 on both sides).  The
# bound is the dense model's (tests/test_torch_paged_kv.py), a little over
# twice the port's gap.
BF16_ATOL = 0.08


@pytest.mark.parametrize("paged", [False, True])
def test_bf16_logits_within_tolerance_of_reference(paged):
    ref_cfg, ref_params, cfg, params = _models(dtype="bfloat16")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 64, n).astype(np.int32) for n in (30, 22, 17, 9)]
    slots, cache_len, bs = 4, 48, 8
    toks = np.zeros((slots, 32), np.int32)
    tl = np.array([len(p) for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lg_a, ca = ref_tm.prefill(ref_params, jnp.asarray(toks), jnp.asarray(tl), ref_cfg, cache_len)
    lg_b, cb = tm.prefill(params, _t(toks), _t(tl), cfg, cache_len)
    _close(lg_a, lg_b, atol=BF16_ATOL, rtol=0)
    tok = jnp.argmax(lg_a, -1).astype(jnp.int32)
    live = np.ones(slots, bool)
    if paged:
        rows = np.arange(slots, dtype=np.int32)
        ca, _ = ref_engine._paged_merge_admitted(
            ref_tm.init_paged_cache(ref_cfg, slots, cache_len, bs, 24), ca,
            jnp.zeros(slots, jnp.int32), tok, jnp.asarray(rows), jnp.asarray(live),
            jnp.asarray(tl), bs)
        cb, _ = port_engine._paged_merge_admitted(
            tm.init_paged_cache(cfg, slots, cache_len, bs, 24, device="cpu"), cb,
            torch.zeros(slots, dtype=torch.int32), _t(np.asarray(tok)), _t(rows), _t(live),
            _t(tl), bs)
    for _ in range(10):
        if paged:
            lg_a, ca = ref_tm.paged_decode_step(ref_params, ca, tok, jnp.asarray(live), ref_cfg, bs)
            lg_b, cb = tm.paged_decode_step(params, cb, _t(np.asarray(tok)), _t(live), cfg, bs)
        else:
            lg_a, ca = ref_tm.decode_step(ref_params, ca, tok, ref_cfg)
            lg_b, cb = tm.decode_step(params, cb, _t(np.asarray(tok)), cfg)
        _close(lg_a, lg_b, atol=BF16_ATOL, rtol=0)
        tok = jnp.argmax(lg_a, -1).astype(jnp.int32)
