"""The two serving stacks that the port's prefetch, fault-tolerance and
router tests hold side by side: the reference (JAX) and the port (PyTorch,
CPU), over the same graph, queries and weights (``params_from_jax``), each
scenario written once and run on both sides with the same virtual clock.

Integers are compared exactly: tokens, node ids, prompts, cache accounting
and every fault, shed, overlap-step and router counter.  Seconds are not.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np

import repro.serving as ref_serving
import repro_torch.serving as port_serving
from repro.core import BruteIndex as RefBruteIndex
from repro.core import GraphTokenizer as RefTokenizer
from repro.core import PipelineConfig as RefPipelineConfig
from repro.core import RGLPipeline as RefPipeline
from repro.core import Vocab as RefVocab
from repro.graph import csr_to_ell as ref_csr_to_ell
from repro.graph import generators as ref_gen
from repro.models.transformer import TransformerConfig as RefConfig
from repro.models.transformer import model as ref_tm
from repro_torch.core.indexing import BruteIndex
from repro_torch.core.pipeline import PipelineConfig, RGLPipeline
from repro_torch.core.tokenization import GraphTokenizer, Vocab
from repro_torch.graph import generators
from repro_torch.graph.ell import csr_to_ell
from repro_torch.models.transformer import model as tm
from repro_torch.models.transformer.config import TransformerConfig

PCFG = dict(strategy="bfs", k_seeds=3, max_hops=2, max_nodes=16, filter_budget=8)
MODEL = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_head=16, d_ff=64,
             dtype="float32")


class Clock:
    """A virtual clock: ``sleep`` advances it, nothing else does."""

    def __init__(self):
        self.t = 0.0

    def now(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.t += s


class _Forced:
    """A reference pipeline whose results are forced to host arrays at
    dispatch.  Under a virtual clock a JAX array's readiness would follow the
    wall clock (a timeout could fire while XLA still runs); the port's CPU
    results are ready at once.  Retrieval results are unchanged."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def retrieve_many(self, query_embs, **kw):
        res = self.inner.retrieve_many(query_embs, **kw)
        sub = types.SimpleNamespace(nodes=np.asarray(res.sub.nodes), mask=np.asarray(res.sub.mask),
                                    dist=np.asarray(res.sub.dist))
        return dataclasses.replace(res, sub=sub, seeds=np.asarray(res.seeds))


class Side:
    """One stack: its pipeline, model and serving module (``mod.RAGServeEngine``,
    ``mod.FaultyRetrieval``, ...).  ``engine`` builds a RAG engine on the
    stack (the port's on the CPU)."""

    def __init__(self, is_ref: bool, g, pipe, cfg, params):
        self.is_ref, self.g, self.pipe, self.cfg, self.params = is_ref, g, pipe, cfg, params
        self.mod = ref_serving if is_ref else port_serving

    def engine(self, pipe=None, **kw):
        if not self.is_ref:
            kw["device"] = "cpu"
        return self.mod.RAGServeEngine(self.pipe if pipe is None else pipe, self.params,
                                       self.cfg, **kw)

    def req(self, qi, uid=0, max_new=4, **kw):
        return self.mod.RAGRequest(uid=uid, query_emb=np.asarray(self.g.node_feat[qi]),
                                   query_text=self.g.node_text[qi], max_new_tokens=max_new, **kw)


def sides_of(g, ref: tuple, port: tuple):
    """(reference side, port side) from ``(pipe, cfg, params)`` triples
    built elsewhere over one graph ``g``."""
    return Side(True, g, _Forced(ref[0]), *ref[1:]), Side(False, g, *port)


def ticking(eng, clock: Clock, seconds: float, events=None) -> None:
    """Each decode step of a live arena advances ``clock`` by ``seconds``
    (and logs a ``("decode", t)`` event): the decode work a retrieval in
    flight overlaps, on the virtual clock."""
    inner_step = eng.engine.step

    def step():
        was_live = eng.engine.live.any()
        out = inner_step()
        if was_live:
            clock.sleep(seconds)
            if events is not None:
                events.append(("decode", clock.now()))
        return out

    eng.engine.step = step


def make_sides(name: str, n_nodes: int = 120, seed: int = 7, max_len: int = 64,
               node_budget: int = 6, pcfg: dict = PCFG, model: dict = MODEL):
    """(reference side, port side) over one seeded citation graph."""
    g_ref = ref_gen.citation_graph(n_nodes, avg_deg=6, seed=seed)
    g = generators.citation_graph(n_nodes, avg_deg=6, seed=seed)
    vocab_ref, vocab = RefVocab.build(g_ref.node_text), Vocab.build(g.node_text)
    emb = jnp.asarray(g_ref.node_feat)
    ref_pipe = RefPipeline(
        graph=ref_csr_to_ell(g_ref), index=RefBruteIndex.build(emb), node_emb=emb,
        tokenizer=RefTokenizer(vocab_ref, max_len=max_len, node_budget=node_budget),
        node_text=g_ref.node_text, config=RefPipelineConfig(**pcfg))
    ell = csr_to_ell(g, device="cpu")
    pipe = RGLPipeline(
        graph=ell, index=BruteIndex.build(g.node_feat, device="cpu"), node_emb=ell.node_feat,
        tokenizer=GraphTokenizer(vocab, max_len=max_len, node_budget=node_budget),
        node_text=g.node_text, config=PipelineConfig(**pcfg), device="cpu")
    kw = dict(model, name=name, vocab=vocab.size)
    ref_cfg, cfg = RefConfig(**kw), TransformerConfig(**kw)
    ref_params = ref_tm.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = tm.params_from_jax(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    return (Side(True, g_ref, _Forced(ref_pipe), ref_cfg, ref_params),
            Side(False, g, pipe, cfg, params))


def outcome(r) -> tuple:
    """Everything a served request carries that both sides must agree on."""
    nodes = None if r.retrieved_nodes is None else np.asarray(r.retrieved_nodes).tolist()
    prompt = None if r.prompt_ids is None else np.asarray(r.prompt_ids).tolist()
    return (list(r.out_tokens), nodes, prompt, r.cache_hit, r.done, r.truncated, r.stale,
            r.degraded, r.failed, r.shed, r.error, r.deadline_at)


def same_outcomes(a: dict, b: dict) -> None:
    """Per-uid outcomes of a reference run ``a`` and a port run ``b``."""
    assert sorted(a) == sorted(b)
    for uid in a:
        assert outcome(a[uid]) == outcome(b[uid]), uid


COUNTERS = ("hits", "misses", "evictions", "expired", "stale_hits", "stale_misses", "inflight",
            "retrieval_batches", "retrieved_queries", "prefetch", "admission", "shed", "failed",
            "degraded", "stale_served", "prefetch_waves", "overlap_steps", "overlap_tokens",
            "retries", "timeouts", "retrieval_failures", "decode_steps", "emitted_tokens",
            "decode_tokens", "draft_proposed", "draft_accepted", "prefill_batches",
            "prefill_rows", "truncations")


def same_stats(ref_eng, port_eng) -> None:
    """Every integer counter of two engines' stats (no seconds)."""
    sa, sb = ref_eng.stats(), port_eng.stats()
    for key in COUNTERS:
        assert sa[key] == sb[key], (key, sa[key], sb[key])
    assert ref_eng.health() == port_eng.health()


def twin(scenario, ref: Side, port: Side):
    """Run ``scenario(side)`` -> (engine or None, {uid: request}) on both
    sides; hold outcomes and counters equal; return the port's result."""
    eng_a, a = scenario(ref)
    eng_b, b = scenario(port)
    same_outcomes(a, b)
    if eng_a is not None:
        same_stats(eng_a, eng_b)
    return eng_b, b


def assert_clean(eng) -> None:
    """No leaked state in any layer of a port engine once it settles."""
    assert eng.cache.inflight_count == 0
    assert eng.prefetcher.in_flight == 0
    assert not eng._inflight and not eng._terminal
    assert not eng.engine.queue and not eng.engine.live.any()
    inner = eng.engine
    if inner.paged_kv:
        # every block is back except those held by cache pins
        assert inner._free_host == inner.pool_blocks - inner.kv_pinned_blocks
        assert int(inner._ntab.sum()) == 0
