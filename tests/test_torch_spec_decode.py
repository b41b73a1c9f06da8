"""Port self-speculative decode against the reference on the same inputs and
weights (``params_from_jax``, fp32): the drafter, one verify step on both
arenas, the slot engine (windows 2-6, sliding window, int8 KV, EOS inside
the window, the ``max_new`` / ``cache_len`` clamps, ``max_new=1``, the env
knobs, acceptance telemetry), the paged arena's spec legs, the fused RAG
engine over {contiguous, paged + share} x {wave, continuous} x {fp32, int8
KV}, and the launcher's flags.

Tokens, accepted counts, cursors, block tables, the free stack, refcounts
and every integer stat are held exactly, against the reference's spec
serve and against the port's own one-token serve.  Cache rows of the verify
step within ``atol=rtol=1e-4`` (fp32 on both sides, matmuls summed in
another order), int8 rows and scales exactly.
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
from repro.models.transformer import TransformerConfig as RefConfig
from repro.models.transformer import model as ref_tm
from repro.serving import RAGRequest as RefRAGRequest
from repro.serving import RAGServeEngine as RefRAGServeEngine
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefServeEngine
from repro.serving import engine as ref_engine
from repro.serving.drafter import draft_tokens as ref_draft_tokens
from repro_torch.core.indexing import BruteIndex
from repro_torch.core.pipeline import PipelineConfig, RGLPipeline
from repro_torch.core.tokenization import GraphTokenizer, Vocab
from repro_torch.graph import generators
from repro_torch.graph.ell import csr_to_ell
from repro_torch.models.transformer import model as tm
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.serving import engine as port_engine
from repro_torch.serving.drafter import draft_tokens
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.rag_engine import RAGRequest, RAGServeEngine

from _paged_mirrors import assert_mirrors

TOL = dict(atol=1e-4, rtol=1e-4)
BASE = dict(name="spec-t", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_head=16, d_ff=64,
            vocab=64, dtype="float32")
_MODELS: dict = {}


def _models(seed=0, **kw):
    """(ref_cfg, ref_params, cfg, params) from one reference init, cached."""
    key = (seed, tuple(sorted(kw.items())))
    if key not in _MODELS:
        ref_cfg, cfg = RefConfig(**BASE, **kw), TransformerConfig(**BASE, **kw)
        ref_params = ref_tm.init_params(jax.random.PRNGKey(seed), ref_cfg)
        params = tm.params_from_jax(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
        _MODELS[key] = (ref_cfg, ref_params, cfg, params)
    return _MODELS[key]


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _equal(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def _mixed(cls, seed=3):
    """Random and repetitive prompts, mixed generation lengths (staggered
    slot turnover) and a max_new=1 request (finished at admission)."""
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


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return {r.uid: r for r in eng.run_to_completion()}


def _three(reqs_fn, ref_models, slots=3, cache_len=48, **kw):
    """The reference's spec serve, the port's spec serve and the port's
    one-token serve of the same requests.  Returns the engines and
    {uid: (tokens, truncated)} of each."""
    ref_cfg, ref_params, cfg, params = ref_models
    ref = RefServeEngine(ref_params, ref_cfg, slots=slots, cache_len=cache_len,
                         spec_decode=True, **kw)
    port = ServeEngine(params, cfg, slots=slots, cache_len=cache_len, spec_decode=True,
                       device="cpu", **kw)
    one = ServeEngine(params, cfg, slots=slots, cache_len=cache_len, spec_decode=False,
                      device="cpu", **{k: v for k, v in kw.items() if k != "draft_window"})
    outs = []
    for eng, cls in ((ref, RefRequest), (port, Request), (one, Request)):
        outs.append({u: (r.out_tokens, r.truncated) for u, r in _serve(eng, reqs_fn(cls)).items()})
    return (ref, port, one), outs


def _same_stats(ref, port):
    sa, sb = ref.decode_stats(), port.decode_stats()
    for key in sa:
        if key != "admit_seconds":
            assert sa[key] == sb[key], key


# ------------------------------------------------------------------ drafter ---
def _draft_both(hist, hist_len, n_draft):
    a = np.asarray(ref_draft_tokens(jnp.asarray(hist), jnp.asarray(hist_len, np.int32), n_draft))
    b = draft_tokens(_t(hist), _t(np.asarray(hist_len, np.int32)), n_draft)
    assert b.dtype == torch.int32 and tuple(b.shape) == a.shape
    _equal(a, b)
    return b.numpy()


def test_drafter_bigram_cycle_extrapolation():
    """A locked period-3 loop is drafted exactly, wrapping past the end of
    history: [1, 2, 3, 1, 2] -> [3, 1, 2, 3]."""
    hist = np.zeros((1, 16), np.int32)
    hist[0, :5] = [1, 2, 3, 1, 2]
    assert _draft_both(hist, [5], 4)[0].tolist() == [3, 1, 2, 3]


def test_drafter_unigram_fallback_and_repeat_last():
    hist = np.zeros((2, 16), np.int32)
    hist[0, :3] = [7, 9, 9]  # unigram match at j=1, period 1 -> all 9s
    hist[1, :3] = [4, 5, 6]  # no match -> repeat the last token
    out = _draft_both(hist, [3, 3], 3)
    assert out[0].tolist() == [9, 9, 9] and out[1].tolist() == [6, 6, 6]


def test_drafter_prefers_bigram_over_unigram():
    """[2,5, 9,5, 2,5]: the trailing bigram (2,5) continues from j=1, not
    from the more recent unigram 5 at j=3."""
    hist = np.zeros((1, 16), np.int32)
    hist[0, :6] = [2, 5, 9, 5, 2, 5]
    assert _draft_both(hist, [6], 2)[0].tolist() == [9, 5]


def test_drafter_dead_slot_is_harmless():
    out = _draft_both(np.zeros((1, 8), np.int32), [0], 3)
    assert out.shape == (1, 3)


@pytest.mark.parametrize("n_draft", [1, 3, 7])
def test_drafter_matches_reference_on_random_histories(n_draft):
    """Histories over a small alphabet (many matches), cyclic ones, and
    lengths 0, 1, 2 and full."""
    rng = np.random.default_rng(n_draft)
    b, h = 24, 40
    hist = rng.integers(0, 5, (b, h)).astype(np.int32)
    hist[:6] = np.tile(rng.integers(0, 50, (6, 3)), (1, 14))[:, :h]
    hist_len = rng.integers(0, h + 1, b).astype(np.int32)
    hist_len[:4] = [0, 1, 2, h]
    _draft_both(hist, hist_len, n_draft)


# ------------------------------------------------------------- verify step ---
def _prefilled(models, slots=3, cache_len=20):
    ref_cfg, ref_params, cfg, params = models
    rng = np.random.default_rng(11)
    toks = rng.integers(1, 64, (slots, 16)).astype(np.int32)
    toks[1, :12] = np.tile([7, 8, 9], 4)
    tl = np.array([16, 12, 5], np.int32)[:slots]
    lg_a, ca = ref_tm.prefill(ref_params, jnp.asarray(toks), jnp.asarray(tl), ref_cfg, cache_len)
    lg_b, cb = tm.prefill(params, _t(toks), _t(tl), cfg, cache_len)
    tok_a, tok_b = jnp.argmax(lg_a, -1).astype(jnp.int32), torch.argmax(lg_b, -1).to(torch.int32)
    return (ca, tok_a), (cb, tok_b)


@pytest.mark.parametrize("quant,window", [(False, None), (True, None), (False, 16)])
def test_verify_step_matches_reference(quant, window):
    """Contiguous ``verify_step`` steps against the reference's on one
    cache: greedy tokens, accepted counts, next tokens, cursor, ``pos`` and
    the rows (int8 rows and scales exactly).  Slot 0's window runs off the
    arena's end (rows past ``cache_len`` are not written, its room caps the
    accepted count); slot 1 repeats (drafts accepted)."""
    models = _models(kv_quant=quant, sliding_window=window)
    ref_cfg, ref_params, cfg, params = models
    (ca, tok_a), (cb, tok_b) = _prefilled(models)
    rng = np.random.default_rng(2)
    sc = 20
    for step in range(4):
        drafts = rng.integers(1, 64, (3, 4)).astype(np.int32)
        drafts[1] = [7, 8, 9, 7]
        fed_a = jnp.concatenate([tok_a[:, None], jnp.asarray(drafts)], axis=1)
        fed_b = torch.cat([tok_b[:, None], _t(drafts)], dim=1)
        room = np.minimum(sc - np.asarray(ca.cursor), [6, 5, 2]).astype(np.int32)
        ga, acc_a, tok_a, ca = ref_tm.verify_step(ref_params, ca, fed_a, jnp.asarray(room), ref_cfg,
                                                  eos_id=None)
        gb, acc_b, tok_b, cb = tm.verify_step(params, cb, fed_b, _t(room), cfg, eos_id=None)
        for x, y in ((ga, gb), (acc_a, acc_b), (tok_a, tok_b), (ca.cursor, cb.cursor),
                     (ca.pos, cb.pos)):
            _equal(x, y)
        if quant:
            for name in ("k", "v", "k_scale", "v_scale"):
                _equal(getattr(ca, name), getattr(cb, name))
        else:
            np.testing.assert_allclose(_np(cb.k), _np(ca.k), **TOL)
            np.testing.assert_allclose(_np(cb.v), _np(ca.v), **TOL)
    assert int(cb.cursor[0]) >= sc  # slot 0 reached the arena's end (then drifts by 1)


def test_accept_prefix_eos_and_room():
    """``_accept_prefix`` against the reference's: EOS cuts the prefix just
    past the first EOS, room caps it, a room of 0 still accepts one."""
    rng = np.random.default_rng(4)
    greedy = rng.integers(0, 4, (32, 5)).astype(np.int32)
    tokens = np.concatenate([rng.integers(0, 4, (32, 1)), greedy[:, :-1]], 1).astype(np.int32)
    tokens[::3, 2] = 9  # some rejections
    room = rng.integers(0, 7, 32).astype(np.int32)
    for eos in (None, 2):
        a = ref_tm._accept_prefix(jnp.asarray(greedy), jnp.asarray(tokens), jnp.asarray(room), 5,
                                  eos)
        b = tm._accept_prefix(_t(greedy), _t(tokens), _t(room), 5, eos)
        _equal(a[0], b[0])
        _equal(a[1], b[1])


@pytest.mark.parametrize("quant", [False, True])
def test_paged_verify_step_matches_reference(quant):
    """Paged verify steps through each engine module's paged merge: tokens,
    accepted counts, the block tables, free stack, ``n_free``, refcounts,
    ``pos`` and ``cursor`` exactly; slot 2 stays dead (never allocates)."""
    ref_cfg, ref_params, cfg, params = _models(kv_quant=quant)
    slots, cache_len, bs, pool = 3, 32, 4, 20
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 64, n).astype(np.int32) for n in (9, 6)]
    toks = np.zeros((slots, 16), np.int32)
    tl = np.zeros(slots, np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)], tl[i] = p, len(p)
    rows, newly = np.arange(slots, dtype=np.int32), np.arange(slots) < 2
    lg_a, fa = ref_tm.prefill(ref_params, jnp.asarray(toks), jnp.asarray(tl), ref_cfg, cache_len)
    ca, tok_a = ref_engine._paged_merge_admitted(
        ref_tm.init_paged_cache(ref_cfg, slots, cache_len, bs, pool), fa,
        jnp.zeros(slots, jnp.int32), jnp.argmax(lg_a, -1).astype(jnp.int32), jnp.asarray(rows),
        jnp.asarray(newly), jnp.asarray(tl), bs)
    lg_b, fb = tm.prefill(params, _t(toks), _t(tl), cfg, cache_len)
    cb, tok_b = port_engine._paged_merge_admitted(
        tm.init_paged_cache(cfg, slots, cache_len, bs, pool, device="cpu"), fb,
        torch.zeros(slots, dtype=torch.int32), torch.argmax(lg_b, -1).to(torch.int32), _t(rows),
        _t(newly), _t(tl), bs)
    live = np.array([True, True, False])
    for step in range(5):
        drafts = np.tile(np.asarray(prompts[step % 2][:5], np.int32), (slots, 1))
        fed_a = jnp.concatenate([tok_a[:, None], jnp.asarray(drafts)], axis=1)
        fed_b = torch.cat([tok_b[:, None], _t(drafts)], dim=1)
        room = np.full(slots, 6, np.int32)
        ga, acc_a, tok_a, ca = ref_tm.paged_verify_step(
            ref_params, ca, fed_a, jnp.asarray(room), jnp.asarray(live), ref_cfg, eos_id=None,
            block_size=bs)
        gb, acc_b, tok_b, cb = tm.paged_verify_step(params, cb, fed_b, _t(room), _t(live), cfg,
                                                    eos_id=None, block_size=bs)
        for x, y in ((ga, gb), (acc_a, acc_b), (tok_a, tok_b)):
            _equal(x, y)
        for name in ("table", "free", "n_free", "ref", "pos", "cursor"):
            _equal(getattr(ca, name), getattr(cb, name))
    assert (cb.table[2] == -1).all()
    if quant:
        for name in ("k", "v", "k_scale", "v_scale"):
            _equal(getattr(ca, name), getattr(cb, name))


# ----------------------------------------------------------- slot engine ---
@pytest.mark.parametrize("window", [2, 3, 4, 5, 6])
def test_spec_engine_matches_reference_and_one_token(window):
    """Per-uid tokens equal the reference's spec serve and the port's own
    one-token serve at every window; same tokens in fewer or as many steps,
    and every stats key equal to the reference's."""
    (ref, port, one), (a, b, c) = _three(_mixed, _models(), draft_window=window)
    assert a == b == c and sorted(b) == list(range(7))
    _same_stats(ref, port)
    assert port.decode_steps <= one.decode_steps and port.decode_tokens == one.decode_tokens
    ds = port.decode_stats()
    assert ds["spec_decode"] and ds["draft_window"] == window and ds["tokens_per_step"] >= 1.0


def _uniform(n, max_new, seed, length):
    def make(cls):
        r2 = np.random.default_rng(seed)
        return [cls(uid=u, prompt_ids=r2.integers(1, 64, length).astype(np.int32),
                    max_new_tokens=max_new) for u in range(n)]
    return make


@pytest.mark.parametrize("paged", [False, True])
def test_spec_with_sliding_window_attention(paged):
    """Decode well past a 16-token window (30 new tokens)."""
    (ref, port, _), (a, b, c) = _three(_uniform(4, 30, 0, 8), _models(1, sliding_window=16),
                                       slots=2, draft_window=4, paged_kv=paged)
    assert a == b == c
    _same_stats(ref, port)


@pytest.mark.parametrize("paged", [False, True])
def test_spec_with_quantized_kv_cache(paged):
    (ref, port, _), (a, b, c) = _three(_uniform(3, 20, 5, 6), _models(2, kv_quant=True),
                                       slots=2, draft_window=4, paged_kv=paged)
    assert a == b == c
    _same_stats(ref, port)


def test_eos_inside_window_truncates_exactly():
    """An EOS accepted mid-window ends the request at the first EOS, as the
    one-token serve and the reference do; nothing is emitted past it."""
    models = _models()
    _, params, cfg = models[1], models[3], models[2]
    probe = _serve(ServeEngine(params, cfg, slots=3, cache_len=48, device="cpu"),
                   _mixed(Request))
    eos = next(int(t) for u in sorted(probe) for t in probe[u].out_tokens[2:-1])
    (ref, port, _), (a, b, c) = _three(_mixed, models, draft_window=6, eos_id=eos)
    assert a == b == c
    _same_stats(ref, port)
    for toks, _ in b.values():
        if eos in toks:
            assert toks.index(eos) == len(toks) - 1
    assert any(toks and toks[-1] == eos for toks, _ in b.values())


@pytest.mark.parametrize("max_new", [1, 3, 7])
def test_window_never_overshoots_max_new(max_new):
    def make(cls):
        return [cls(uid=u, prompt_ids=np.tile(np.asarray([11, 27], np.int32), 8),
                    max_new_tokens=max_new) for u in range(4)]
    (ref, port, _), (a, b, c) = _three(make, _models(), slots=2, cache_len=64, draft_window=6)
    assert a == b == c and all(len(toks) == max_new for toks, _ in b.values())
    _same_stats(ref, port)


@pytest.mark.parametrize("paged", [False, True])
def test_window_never_overshoots_cache_len(paged):
    """A window that would run past ``cache_len`` commits only the tokens
    that fit: 1 prefill token + decode up to cursor == cache_len."""
    def make(cls):
        return [cls(uid=0, prompt_ids=np.asarray([3, 7] * 4, np.int32), max_new_tokens=1000)]
    kw = dict(paged_kv=True, block_size=8) if paged else {}
    (ref, port, _), (a, b, c) = _three(make, _models(), slots=1, cache_len=24, draft_window=6,
                                       **kw)
    assert a == b == c and len(b[0][0]) == 24 - 8 + 1 and b[0][1]
    _same_stats(ref, port)


def test_max_new_one_finishes_at_admission():
    _, _, cfg, params = _models()
    for spec in (False, True):
        eng = ServeEngine(params, cfg, slots=2, cache_len=32, spec_decode=spec, device="cpu")
        done = _serve(eng, [Request(uid=0, prompt_ids=np.asarray([4, 9], np.int32),
                                    max_new_tokens=1)])
        assert len(done[0].out_tokens) == 1 and eng.decode_steps == 0


def test_spec_env_default_and_override(monkeypatch):
    _, _, cfg, params = _models()

    def make(**kw):
        return ServeEngine(params, cfg, slots=1, cache_len=32, device="cpu", **kw)

    monkeypatch.delenv("RGL_SPEC_DECODE", raising=False)
    monkeypatch.delenv("RGL_DRAFT_WINDOW", raising=False)
    assert not make().spec_decode and make().draft_window == 4
    monkeypatch.setenv("RGL_SPEC_DECODE", "1")
    assert make().spec_decode
    assert not make(spec_decode=False).spec_decode  # explicit beats env
    monkeypatch.setenv("RGL_SPEC_DECODE", "0")
    assert not make().spec_decode
    assert make(spec_decode=True).spec_decode
    monkeypatch.setenv("RGL_DRAFT_WINDOW", "6")
    assert make(spec_decode=True).draft_window == 6
    with pytest.raises(ValueError, match="draft_window"):
        make(spec_decode=True, draft_window=1)


def test_draft_window_env_raises_like_constructor(monkeypatch):
    """``RGL_DRAFT_WINDOW=1`` fails as ``draft_window=1`` does; a window of 1
    is fine without speculation; a non-integer fails naming the variable."""
    _, _, cfg, params = _models()

    def make(**kw):
        return ServeEngine(params, cfg, slots=1, cache_len=32, device="cpu", **kw)

    monkeypatch.setenv("RGL_DRAFT_WINDOW", "1")
    with pytest.raises(ValueError, match="draft_window"):
        make(spec_decode=True)
    assert make(spec_decode=False).draft_window == 1
    monkeypatch.setenv("RGL_DRAFT_WINDOW", "banana")
    with pytest.raises(ValueError, match="RGL_DRAFT_WINDOW"):
        make(spec_decode=True)
    with pytest.raises(ValueError, match="RGL_DRAFT_WINDOW"):
        port_engine._draft_window_default()


def test_acceptance_telemetry_on_repetitive_stream():
    """A cyclic stream commits more than one token a slot-step, and the
    draft counters add up, equal to the reference's."""
    def make(cls):
        return [cls(uid=u, prompt_ids=np.tile(np.asarray([13, 29, 44], np.int32), 8),
                    max_new_tokens=60) for u in range(4)]
    (ref, port, _), (a, b, c) = _three(make, _models(), slots=2, cache_len=96, draft_window=4)
    assert a == b == c
    _same_stats(ref, port)
    ds = port.decode_stats()
    assert ds["tokens_per_step"] > 1.2
    assert ds["draft_accepted"] == ds["decode_tokens"] - port.slot_steps
    assert 0.0 < ds["draft_accept_rate"] <= 1.0


# ----------------------------------------------------------- paged legs ---
@pytest.mark.parametrize("spec", [False, True])
def test_paged_parity_both_decode_modes(spec):
    """The paged arena emits the contiguous arena's tokens and truncation
    flags in both decode modes, in the same steps; the paged spec serve's
    allocator state, host mirrors and stats equal the reference's."""
    ref_cfg, ref_params, cfg, params = _models()
    runs = {}
    for paged in (False, True):
        eng = ServeEngine(params, cfg, slots=3, cache_len=48, paged_kv=paged, spec_decode=spec,
                          draft_window=4, device="cpu")
        runs[paged] = (eng, {u: (r.out_tokens, r.truncated)
                             for u, r in _serve(eng, _mixed(Request)).items()})
    (ce, ct), (pe, pt) = runs[False], runs[True]
    assert ct == pt and sorted(pt) == list(range(7))
    assert (pe.decode_steps, pe.decode_tokens, pe.truncations) == \
        (ce.decode_steps, ce.decode_tokens, ce.truncations)
    ds = pe.decode_stats()
    assert ds["paged_kv"] and ds["block_size"] == 16
    assert ds["pool_blocks"] == 9 and ds["pool_free_blocks"] == 9
    ref = RefServeEngine(ref_params, ref_cfg, slots=3, cache_len=48, paged_kv=True,
                         spec_decode=spec, draft_window=4)
    a = {u: (r.out_tokens, r.truncated) for u, r in _serve(ref, _mixed(RefRequest)).items()}
    assert a == pt
    _same_stats(ref, pe)
    assert_mirrors(pe)


def test_paged_parity_with_sliding_window_attention():
    _, _, cfg, params = _models(1, sliding_window=16)
    outs = {}
    for paged in (False, True):
        eng = ServeEngine(params, cfg, slots=2, cache_len=48, paged_kv=paged, spec_decode=True,
                          draft_window=4, device="cpu")
        outs[paged] = {u: r.out_tokens for u, r in _serve(eng, _uniform(4, 30, 0, 8)(Request))
                       .items()}
    assert outs[True] == outs[False]


@pytest.mark.parametrize("window", [2, 5])
def test_paged_spec_small_pool_matches_reference(window):
    """An undersized pool under speculation: admission gates and live slots
    are retired before a step whose W-row windows the pool cannot cover
    (the host mirrors replay W rows a slot, not 1).  Tokens, truncation
    flags, the allocator and every stat equal the reference's after every
    step."""
    ref_cfg, ref_params, cfg, params = _models()
    kw = dict(slots=3, cache_len=48, paged_kv=True, block_size=4, pool_blocks=14,
              spec_decode=True, draft_window=window)
    ref = RefServeEngine(ref_params, ref_cfg, **kw)
    port = ServeEngine(params, cfg, device="cpu", **kw)
    for eng, cls in ((ref, RefRequest), (port, Request)):
        for r in _mixed(cls):
            eng.submit(r)
    done_a, done_b = [], []
    while port.queue or port.live.any():
        done_a += ref.step()
        done_b += port.step()
        assert_mirrors(port)
        assert ref._free_stack == port._free_stack
        assert ref._slot_blocks == port._slot_blocks
        assert ref._ntab.tolist() == port._ntab.tolist()
    assert {r.uid: (r.out_tokens, r.truncated) for r in done_a} == \
        {r.uid: (r.out_tokens, r.truncated) for r in done_b}
    assert port.truncations > 0 and port._free_host == 14
    _same_stats(ref, port)


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
        kw = dict(BASE, name="spec-rag-t", vocab=vocab.size, kv_quant=quant)
        ref_cfg, cfg = RefConfig(**kw), TransformerConfig(**kw)
        ref_params = ref_tm.init_params(jax.random.PRNGKey(0), ref_cfg)
        params = tm.params_from_jax(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
        out[quant] = ((ref_pipe, ref_cfg, ref_params), (pipe, cfg, params))
    return g, out


def _rag_run(g, side, is_ref, **kw):
    pipe, cfg, params = side
    q_ids = (0, 1, 2, 0, 3, 1, 4, 2)
    if is_ref:
        eng = RefRAGServeEngine(pipe, params, cfg, slots=2, cache_len=96, prefetch=False, **kw)
        cls = RefRAGRequest
    else:
        eng = RAGServeEngine(pipe, params, cfg, slots=2, cache_len=96, device="cpu", **kw)
        cls = RAGRequest
    for u, qi in enumerate(q_ids):
        eng.submit(cls(uid=u, query_emb=np.asarray(g.node_feat[qi]), query_text=g.node_text[qi],
                       max_new_tokens=4 + 3 * (u % 3)))
    return eng, {r.uid: r for r in eng.run_to_completion()}


@pytest.mark.parametrize("arena", ["contiguous", "paged_share"])
@pytest.mark.parametrize("admission", ["wave", "continuous"])
@pytest.mark.parametrize("quant", [False, True])
def test_rag_spec_matches_reference(rag_stack, arena, admission, quant):
    """``RAGServeEngine(spec_decode=True)`` against the reference's: tokens,
    retrieved nodes, prompts, truncation flags, cache totals, share
    counters and (paged) the allocator; the tokens also equal the port's
    one-token serve of the same schedule."""
    g, sides = rag_stack
    ref_side, port_side = sides[quant]
    kw = dict(admission=admission, paged_kv=arena == "paged_share",
              prefix_share=arena == "paged_share", draft_window=4)
    ref, a = _rag_run(g, ref_side, True, spec_decode=True, **kw)
    port, b = _rag_run(g, port_side, False, spec_decode=True, **kw)
    _, one = _rag_run(g, port_side, False, spec_decode=False, **kw)
    assert sorted(a) == sorted(b) == list(range(8))
    for uid in a:
        assert a[uid].out_tokens == b[uid].out_tokens == one[uid].out_tokens, uid
        assert a[uid].truncated == b[uid].truncated, uid
        np.testing.assert_array_equal(a[uid].retrieved_nodes, b[uid].retrieved_nodes)
        np.testing.assert_array_equal(a[uid].prompt_ids, b[uid].prompt_ids)
    sa, sb = ref.stats(), port.stats()
    keys = ["hits", "misses", "retrieval_batches", "decode_steps", "emitted_tokens",
            "decode_tokens", "draft_proposed", "draft_accepted", "truncations", "spec_decode",
            "draft_window", "admission", "paged_kv", "prefix_share"]
    if arena == "paged_share":
        keys += ["kv_shared_admits", "kv_reused_tokens", "kv_cow_copies", "kv_pins",
                 "kv_releases", "kv_pinned_blocks", "pool_high_water_blocks",
                 "pool_free_blocks"]
        assert_mirrors(port.engine)
    for key in keys:
        assert sa[key] == sb[key], key
    assert sb["spec_decode"] and port.cache_hits == ref.cache_hits >= 2
    if arena == "paged_share" and admission == "wave":
        assert sb["kv_shared_admits"] > 0


def test_launcher_spec_flags(capsys):
    """``launch.serve --rag --spec-decode --draft-window 3`` on the CPU
    prints the spec line, and its tokens equal the one-token serve's."""
    from repro_torch.launch import serve

    common = ["--arch", "starcoder2-3b", "--rag", "--device", "cpu", "--nodes", "200",
              "--requests", "6", "--max_new", "9", "--paged-kv"]
    out = serve.main(common + ["--spec-decode", "--draft-window", "3"])
    printed = capsys.readouterr().out
    assert "spec decode: window=3" in printed
    s = out["stats"]
    assert s["spec_decode"] and s["draft_window"] == 3 and s["paged_kv"]
    base = serve.main(common + ["--no-spec-decode"])
    assert "spec decode:" not in capsys.readouterr().out
    assert {r.uid: r.out_tokens for r in out["done"]} == \
        {r.uid: r.out_tokens for r in base["done"]}
