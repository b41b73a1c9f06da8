"""Port serving stack vs the reference on the same graph, queries and
weights: the fused RAG engine (per-uid tokens, retrieved nodes, prompts and
cache totals identical), the slot decode engine, and the retrieval cache."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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
from repro.serving.cache import CachedRetrieval as RefCachedRetrieval
from repro.serving.cache import RetrievalCache as RefRetrievalCache
from repro_torch.core.indexing import BruteIndex
from repro_torch.core.pipeline import PipelineConfig, RGLPipeline
from repro_torch.core.tokenization import GraphTokenizer, Vocab
from repro_torch.graph import generators
from repro_torch.graph.ell import csr_to_ell
from repro_torch.models.transformer import model as tm
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.serving.cache import CachedRetrieval, RetrievalCache
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.rag_engine import RAGRequest, RAGServeEngine

N_NODES = 1000
SLOTS = 4
CACHE_LEN = 128
MAX_NEW = 6
PCFG = dict(strategy="bfs", k_seeds=3, max_hops=2, max_nodes=16, filter_budget=8)
# every reference engine runs the schedule the port has: sync wave admission
# into a contiguous arena with one-token decode
REF_MODES = dict(prefetch=False, admission="wave", spec_decode=False, paged_kv=False,
                 prefix_share=False)


@pytest.fixture(scope="module")
def stack():
    g_ref = ref_gen.citation_graph(N_NODES, avg_deg=6, seed=11)
    g = generators.citation_graph(N_NODES, avg_deg=6, seed=11)
    vocab_ref, vocab = RefVocab.build(g_ref.node_text), Vocab.build(g.node_text)
    ref_pipe = RefPipeline(
        graph=ref_csr_to_ell(g_ref), index=RefBruteIndex.build(jnp.asarray(g_ref.node_feat)),
        node_emb=jnp.asarray(g_ref.node_feat),
        tokenizer=RefTokenizer(vocab_ref, max_len=96, node_budget=8),
        node_text=g_ref.node_text, config=RefPipelineConfig(**PCFG),
    )
    ell = csr_to_ell(g, device="cpu")
    pipe = RGLPipeline(
        graph=ell, index=BruteIndex.build(g.node_feat, device="cpu"), node_emb=ell.node_feat,
        tokenizer=GraphTokenizer(vocab, max_len=96, node_budget=8), node_text=g.node_text,
        config=PipelineConfig(**PCFG), device="cpu",
    )
    kw = dict(name="rag-t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
              d_ff=128, vocab=vocab.size, dtype="float32", sliding_window=16)
    ref_cfg, cfg = RefConfig(**kw), TransformerConfig(**kw)
    ref_params = ref_tm.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = tm.params_from_jax(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    return g, (ref_pipe, ref_cfg, ref_params), (pipe, cfg, params)


def _workload(g):
    """10 distinct queries, then 4 repeats (cache hits) interleaved with 2
    fresh ones, as raw (embedding, text) requests."""
    rng = np.random.default_rng(0)
    distinct = rng.choice(N_NODES, 12, replace=False)
    order = list(distinct[:10]) + [distinct[0], distinct[10], distinct[3], distinct[4],
                                   distinct[11], distinct[7]]
    return [(u, g.node_feat[qi], " ".join(g.node_text[qi].split()[:4]))
            for u, qi in enumerate(order)]


def _serve(engine, req_cls, work, max_new=MAX_NEW):
    for u, emb, text in work:
        engine.submit(req_cls(uid=u, query_emb=emb, query_text=text, max_new_tokens=max_new))
    return {r.uid: r for r in engine.run_to_completion()}


@pytest.mark.parametrize("policy,eos", [("lru", None), ("lfu", "frequent")])
def test_rag_engine_matches_reference(stack, policy, eos):
    g, (ref_pipe, ref_cfg, ref_params), (pipe, cfg, params) = stack
    work = _workload(g)
    ref = RefRAGServeEngine(ref_pipe, ref_params, ref_cfg, slots=SLOTS, cache_len=CACHE_LEN,
                            cache_policy=policy, **REF_MODES)
    if eos == "frequent":  # an EOS the model does emit, so some requests end early
        probe = _serve(ref, RefRAGRequest, work)
        toks = np.concatenate([r.out_tokens[1:] for r in probe.values()])
        eos = int(np.bincount(toks).argmax())
        ref = RefRAGServeEngine(ref_pipe, ref_params, ref_cfg, slots=SLOTS, cache_len=CACHE_LEN,
                                cache_policy=policy, eos_id=eos, **REF_MODES)
    port = RAGServeEngine(pipe, params, cfg, slots=SLOTS, cache_len=CACHE_LEN,
                          cache_policy=policy, eos_id=eos, device="cpu")
    a = _serve(ref, RefRAGRequest, work)
    b = _serve(port, RAGRequest, work)
    assert sorted(a) == sorted(b) == list(range(len(work)))
    for uid in a:
        assert a[uid].out_tokens == b[uid].out_tokens, uid
        np.testing.assert_array_equal(a[uid].retrieved_nodes, b[uid].retrieved_nodes)
        np.testing.assert_array_equal(a[uid].prompt_ids, b[uid].prompt_ids)
        assert (a[uid].cache_hit, a[uid].done, a[uid].truncated) == \
            (b[uid].cache_hit, b[uid].done, b[uid].truncated)
    if eos is not None:
        assert any(len(r.out_tokens) < MAX_NEW for r in b.values())
    sa, sb = ref.stats(), port.stats()
    for key in ("hits", "misses", "evictions", "retrieval_batches", "retrieved_queries",
                "decode_steps", "emitted_tokens", "prefill_batches", "prefill_rows"):
        assert sa[key] == sb[key], key
    assert sb["hits"] >= 4


def test_slot_engine_matches_reference(stack):
    """Token-mode decode: varied prompt lengths (several prefill buckets),
    a request done at admission (max_new_tokens=1) and more requests than
    slots."""
    _, (_, ref_cfg, ref_params), (_, cfg, params) = stack
    rng = np.random.default_rng(5)
    work = [(u, rng.integers(1, cfg.vocab, int(rng.integers(3, 40))).astype(np.int32),
             1 if u == 2 else int(rng.integers(2, 9))) for u in range(7)]
    ref = RefServeEngine(ref_params, ref_cfg, slots=3, cache_len=64, spec_decode=False,
                         paged_kv=False, prefix_share=False)
    port = ServeEngine(params, cfg, slots=3, cache_len=64, device="cpu")
    for eng, cls in ((ref, RefRequest), (port, Request)):
        for u, ids, n in work:
            eng.submit(cls(uid=u, prompt_ids=ids, max_new_tokens=n))
    a = {r.uid: r.out_tokens for r in ref.run_to_completion()}
    b = {r.uid: r.out_tokens for r in port.run_to_completion()}
    assert a == b
    assert len(b[2]) == 1
    for key in ("decode_steps", "emitted_tokens", "prefill_batches", "tokens_per_step"):
        assert ref.decode_stats()[key] == port.decode_stats()[key], key


def test_abort_and_drain(stack):
    g, _, (pipe, cfg, params) = stack
    port = RAGServeEngine(pipe, params, cfg, slots=SLOTS, cache_len=CACHE_LEN, device="cpu")
    work = _workload(g)
    for u, emb, text in work:
        port.submit(RAGRequest(uid=u, query_emb=emb, query_text=text, max_new_tokens=30))
    port.step()
    out = port.abort("test")
    # as in the reference: admitted requests fail, pending ones are shed
    assert len(out) == len(work) and all(r.failed != r.shed for r in out)
    assert sum(r.failed for r in out) == SLOTS and port.stats()["shed"] == len(work) - SLOTS
    assert port._drained()
    for u, emb, text in work[:3]:
        port.submit(RAGRequest(uid=u, query_emb=emb, query_text=text, max_new_tokens=10))
    done = port.drain(max_steps=2)  # too few steps: stragglers come back failed
    assert len(done) == 3 and all(r.failed and 0 < len(r.out_tokens) < 10 for r in done)
    with pytest.raises(ValueError, match="NaN"):
        port.submit(RAGRequest(uid=99, query_emb=np.full(128, np.nan, np.float32),
                               query_text="x"))


@pytest.mark.parametrize("kw,item", [
    (dict(mutation=True, prefetch=True), "item 13"),
    (dict(mutation=True, prefetch=True, admission="continuous"), "item 13"),
    (dict(compact_every=3, default_deadline_s=5.0), "item 13"), (dict(mutation=True), "item 13"),
    (dict(mutation=True, max_retries=2), "item 13"),
    (dict(compact_every=3, prefetch=True, max_pending=4), "item 13"),
    (dict(compact_every=3), "item 13"),
])
def test_unported_serving_modes_raise(stack, kw, item):
    _, _, (pipe, cfg, params) = stack
    with pytest.raises(NotImplementedError, match=item):
        RAGServeEngine(pipe, params, cfg, slots=SLOTS, cache_len=CACHE_LEN, device="cpu", **kw)


@pytest.mark.parametrize("paged", [False, True])
def test_shared_retrieval_cache_matches_reference(stack, paged):
    """Two engines handed one ``retrieval_cache`` share its entries: the
    second engine's repeats hit what the first retrieved.  Hits, misses,
    per-entry hit counts (``hit_count``), ``stats_ns`` and both engines'
    ``cache_hits`` / ``cache_misses`` equal the reference's.  With prefix
    sharing the engines' pin hooks are wired to the injected cache."""
    g, (ref_pipe, ref_cfg, ref_params), (pipe, cfg, params) = stack
    work = _workload(g)
    modes = dict(paged_kv=paged, prefix_share=paged)
    ref_modes = {**REF_MODES, **modes}
    caches = (RefRetrievalCache(capacity=8, policy="lfu"), RetrievalCache(capacity=8, policy="lfu"))
    ref = [RefRAGServeEngine(ref_pipe, ref_params, ref_cfg, slots=SLOTS, cache_len=CACHE_LEN,
                             retrieval_cache=caches[0], **ref_modes) for _ in range(2)]
    port = [RAGServeEngine(pipe, params, cfg, slots=SLOTS, cache_len=CACHE_LEN,
                           retrieval_cache=caches[1], cache_capacity=1, device="cpu", **modes)
            for _ in range(2)]
    assert all(e.cache is caches[1] and e.cache.capacity == 8 for e in port)
    for i, half in enumerate((work[:10], work[10:])):
        a = _serve(ref[i], RefRAGRequest, half)
        b = _serve(port[i], RAGRequest, half)
        assert {u: r.out_tokens for u, r in a.items()} == {u: r.out_tokens for u, r in b.items()}
        assert {u: r.cache_hit for u, r in a.items()} == {u: r.cache_hit for u, r in b.items()}
    assert caches[1].hits == caches[0].hits >= 3  # capacity 8 of 12 keys: lfu evicts
    for er, ep in zip(ref, port):
        assert (er.cache_hits, er.cache_misses) == (ep.cache_hits, ep.cache_misses)
        assert (ep.cache_hits, ep.cache_misses) == (caches[1].hits, caches[1].misses)
    for _, emb, _ in work:
        assert caches[0].hit_count(emb) == caches[1].hit_count(emb)
    assert caches[1].hit_count(np.full(128, 7.0, np.float32)) == 0
    sa, sb = caches[0].stats_ns()["cache"], caches[1].stats_ns()["cache"]
    for key in sb:
        assert sa[key] == sb[key], key
    if paged:
        for e in port:
            assert e.engine.kv_pin_gate.__self__ is caches[1]
        assert caches[1].kv_pinned_entries() == caches[0].kv_pinned_entries() > 0


@pytest.mark.parametrize("policy", ["lru", "lfu", "ttl"])
def test_retrieval_cache_matches_reference(policy):
    """A random get/put sequence under capacity pressure and TTL expiry
    (virtual clock): same answers and counters as the reference cache."""
    clock = [0.0]
    now = lambda: clock[0]  # noqa: E731
    ref = RefRetrievalCache(capacity=3, policy=policy, ttl=5.0, now_fn=now)
    port = RetrievalCache(capacity=3, policy=policy, ttl=5.0, now_fn=now)
    rng = np.random.default_rng(7)
    embs = rng.standard_normal((6, 8)).astype(np.float32)
    for step in range(200):
        clock[0] += float(rng.random())
        i, op = int(rng.integers(6)), rng.random()
        if op < 0.4:
            payload = (np.array([i, step], np.int32), np.ones(2, bool), np.zeros(2, np.int32),
                       np.array([i], np.int32))
            ref.put(embs[i], RefCachedRetrieval(*payload))
            port.put(embs[i], CachedRetrieval(*payload))
            continue
        a, b = ref.get(embs[i]), port.get(embs[i])
        assert (a is None) == (b is None), step
        if a is not None:
            np.testing.assert_array_equal(a.nodes, b.nodes)
    sa, sb = ref.stats(), port.stats()
    for key in sb:
        assert sa[key] == sb[key], key
