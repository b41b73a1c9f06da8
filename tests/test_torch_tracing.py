"""The port's spans and serving counters (``repro_torch.tracing``), on the
CPU with a tiny stack: a span touches the profiler only while one records
and always feeds its totals; a serve step and a retrieval record every
``rgl.*`` span, nested; ``auto``'s compact pass and dense re-run; the
pipeline's ``retrieval.*`` counters; the engine's request times and
times to first token on a virtual clock; and every stats key the
engine had before the spans, unchanged."""
import copy
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.core import graph_retrieval
from repro_torch.core.indexing import BruteIndex
from repro_torch.core.pipeline import PipelineConfig, RGLPipeline
from repro_torch.core.tokenization import GraphTokenizer, Vocab
from repro_torch.graph import generators
from repro_torch.graph.ell import csr_to_ell
from repro_torch.models.transformer import model as tm
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.serving import RAGRequest, RAGServeEngine, flatten_stats, rag_engine

PCFG = dict(strategy="bfs", k_seeds=3, max_hops=2, max_nodes=16, filter_budget=8)

# every span and the span it opens inside
PARENT = {
    "rgl.serve.retrieval": "rgl.serve.step",
    "rgl.retrieve": "rgl.serve.retrieval",
    "rgl.retrieve.seeds": "rgl.retrieve",
    "rgl.retrieve.subgraph": "rgl.retrieve",
    "rgl.retrieve.subgraph.compact": "rgl.retrieve.subgraph",
    "rgl.retrieve.subgraph.rerun": "rgl.retrieve.subgraph",
    "rgl.retrieve.filter": "rgl.retrieve",
    "rgl.serve.tokenize": "rgl.serve.step",
    "rgl.decode.admit": "rgl.serve.step",
    "rgl.decode.admit.prefill": "rgl.decode.admit",
    "rgl.decode.admit.merge": "rgl.decode.admit",
    "rgl.decode.admit.first_token": "rgl.decode.admit",
    "rgl.decode.step": "rgl.serve.step",
    "rgl.decode.step.token_sync": "rgl.decode.step",
}

# the stats the engine had before the spans (a contiguous arena)
OLD_NS_KEYS = {
    "cache": ["evictions", "expired", "graph_epoch", "hit_rate", "hits", "inflight", "invalidated",
              "kv_pinned_entries", "live", "misses", "policy", "resident", "size", "stale_hits",
              "stale_misses", "stale_rejects"],
    "engine": ["admission", "degraded", "degraded_mode", "failed", "prefetch",
               "retrieval_batches", "retrieval_seconds", "retrieved_queries", "shed",
               "stale_served"],
    "prefetch": ["collect_block_seconds", "hidden_frac", "launch_seconds", "overlap_seconds",
                 "overlap_steps", "overlap_tokens", "prefetch_waves", "retries",
                 "retrieval_failures", "timeouts"],
    "decode": ["admit_seconds", "decode_seconds", "decode_steps", "decode_tokens",
               "draft_accept_rate", "draft_accepted", "draft_proposed", "draft_window",
               "emitted_tokens", "paged_kv", "prefill_batches", "prefill_rows", "prefix_share",
               "spec_decode", "tokens_per_step", "truncations"],
    "mutation": ["batches", "invalidated"],
}
OLD_PAGED_DECODE = ["block_size", "kv_cow_copies", "kv_pinned_blocks", "kv_pins", "kv_releases",
                    "kv_reused_tokens", "kv_shared_admits", "pool_blocks", "pool_free_blocks",
                    "pool_high_water_blocks"]


class Stack:
    def __init__(self):
        self.g = generators.citation_graph(120, avg_deg=6, seed=7)
        self.vocab = Vocab.build(self.g.node_text)
        self.ell = csr_to_ell(self.g, device="cpu")
        self.index = BruteIndex.build(self.g.node_feat, device="cpu")
        self.cfg = TransformerConfig(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_head=16,
                                     d_ff=64, dtype="float32", name="tracing-t",
                                     vocab=self.vocab.size)
        self.params = tm.init_params(self.cfg, torch.Generator().manual_seed(0), device="cpu")

    def pipe(self, **kw):
        return RGLPipeline(
            graph=self.ell, index=self.index, node_emb=self.ell.node_feat,
            tokenizer=GraphTokenizer(self.vocab, max_len=64, node_budget=6),
            node_text=self.g.node_text, config=PipelineConfig(**{**PCFG, **kw}), device="cpu")

    def engine(self, pipe=None, **kw):
        kw = {"slots": 2, "cache_len": 96, **kw}
        return RAGServeEngine(pipe or self.pipe(), self.params, self.cfg, device="cpu", **kw)

    def req(self, qi, uid, max_new=3):
        return RAGRequest(uid=uid, query_emb=np.asarray(self.g.node_feat[qi]),
                          query_text=self.g.node_text[qi], max_new_tokens=max_new)


@pytest.fixture(scope="module")
def stack():
    return Stack()


@pytest.fixture
def compact_everywhere(monkeypatch):
    """``auto`` picks the compact pass on the 120-node graph."""
    monkeypatch.setattr(graph_retrieval, "AUTO_COMPACT_MIN_NODES", 1)


def recorded(fn) -> list:
    """(name, start_ns, end_ns) of the ``rgl.`` ranges ``fn()`` records
    under a CPU profiler, in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.name().startswith("rgl.")]
    return sorted(out, key=lambda x: x[1])


def assert_nested(events: list) -> None:
    for name, a, b in events:
        parent = PARENT.get(name)
        if parent is None:
            continue
        assert any(n == parent and pa <= a and b <= pb for n, pa, pb in events), (name, parent)


# ------------------------------------------------------------- the helper ----
def test_span_without_profiler_touches_no_profiler_but_feeds_totals(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    calls = []
    t = [0.0]

    def tick():
        t[0] += 1.0
        return t[0]

    totals = tracing.Totals(tick)
    for _ in range(3):
        with tracing.span("rgl.test.off", totals, args=lambda: calls.append(1) or "uids=1"):
            pass
    assert totals.seconds == 3.0
    assert calls == []  # args are built only for a recording profiler


def test_span_on_a_clock_and_under_the_profiler():
    t = [10.0]
    totals = tracing.Totals(lambda: t[0])
    with tracing.span("rgl.test.clock", totals):
        t[0] += 2.5
    assert totals.seconds == 2.5

    def body():
        with tracing.span("rgl.test.outer", args="uids=7"):
            with tracing.span("rgl.test.inner", tracing.Totals(time.perf_counter),
                              args=tracing.uids([])):
                torch.ones(3).add_(1)

    ev = recorded(body)
    assert [n for n, _, _ in ev] == ["rgl.test.outer", "rgl.test.inner"]
    (_, oa, ob), (_, ia, ib) = ev
    assert oa <= ia and ib <= ob


def test_span_totals_count_a_raise():
    t = [0.0]
    totals = tracing.Totals(lambda: t[0])
    with pytest.raises(ValueError):
        with tracing.span("rgl.test.raise", totals):
            t[0] += 1.5
            raise ValueError("inside")
    assert totals.seconds == 1.5


# ------------------------------------------------ spans of the serve path ----
def test_serve_step_records_every_span_nested(stack, compact_everywhere):
    eng = stack.engine(stack.pipe(workset_cap=4), prefetch=False)
    eng.submit(stack.req(0, uid=0))
    eng.submit(stack.req(5, uid=1))
    ev = recorded(eng.step)
    names = {n for n, _, _ in ev}
    assert names == set(PARENT) | {"rgl.serve.step"}
    assert_nested(ev)
    assert sum(n == "rgl.serve.step" for n, _, _ in ev) == 1
    # one launch and one collect of the wave, one retrieval
    assert sum(n == "rgl.serve.retrieval" for n, _, _ in ev) == 2
    assert sum(n == "rgl.retrieve" for n, _, _ in ev) == 1


def test_prefetched_step_records_the_same_spans(stack, compact_everywhere):
    eng = stack.engine(stack.pipe(workset_cap=4), prefetch=True)
    for u in range(4):
        eng.submit(stack.req(u, uid=u))
    names = set()
    for _ in range(4):
        names |= {n for n, _, _ in recorded(eng.step)}
    assert names == set(PARENT) | {"rgl.serve.step"}


def test_retrieve_records_seeds_subgraph_filter(stack):
    pipe = stack.pipe(retrieval_mode="dense")
    ev = recorded(lambda: pipe.retrieve(stack.g.node_feat[:3]))
    assert [n for n, _, _ in ev] == ["rgl.retrieve", "rgl.retrieve.seeds", "rgl.retrieve.subgraph",
                                     "rgl.retrieve.subgraph.dense", "rgl.retrieve.filter"]
    parent = dict(PARENT, **{"rgl.retrieve.subgraph.dense": "rgl.retrieve.subgraph"})
    for name, a, b in ev:
        if name != "rgl.retrieve":
            assert any(n == parent[name] and pa <= a and b <= pb for n, pa, pb in ev)


@pytest.mark.parametrize("cap,max_hops,want", [
    (16, 2, ["rgl.retrieve.subgraph.compact", "rgl.retrieve.subgraph.rerun"]),
    (64, 1, ["rgl.retrieve.subgraph.compact"]),
], ids=["overflow", "fits"])
def test_auto_records_compact_then_rerun(stack, compact_everywhere, cap, max_hops, want):
    seeds = stack.index.search(torch.from_numpy(np.asarray(stack.g.node_feat[:4])), 3)[1]
    flags = graph_retrieval.retrieve_subgraph(stack.ell, seeds, mode="compact", workset_cap=cap,
                                              max_hops=max_hops, max_nodes=8).overflow
    assert bool(flags.any()) == (len(want) == 2)
    counters = {}
    ev = recorded(lambda: graph_retrieval.retrieve_subgraph(
        stack.ell, seeds, mode="auto", workset_cap=cap, max_hops=max_hops, max_nodes=8,
        counters=counters))
    assert [n for n, _, _ in ev] == want
    assert counters == {"batches": 1, "rows": 4, "compact_runs": 1,
                        "overflowed_queries": int(flags.sum()), **({"dense_reruns": 1}
                                                                  if len(want) == 2 else {})}


# ------------------------------------------------------------- counters ----
def test_retrieval_counters_are_exact(stack, compact_everywhere):
    pipe = stack.pipe(workset_cap=16)
    assert pipe.stats() == dict.fromkeys(["batches", "rows", "valid_rows", "compact_runs",
                                          "dense_reruns", "overflowed_queries"], 0)
    q = np.asarray(stack.g.node_feat[:3])
    seeds = pipe.retrieve_seeds(torch.from_numpy(np.concatenate([q, np.zeros((5, q.shape[1]),
                                                                             np.float32)])))[1]
    over = int(graph_retrieval.retrieve_subgraph(stack.ell, seeds, mode="compact",
                                                 workset_cap=16, max_hops=2,
                                                 max_nodes=16).overflow.sum())
    assert over > 0
    res = pipe.retrieve_many(q, batch_size=8)
    assert res.n_valid == 3
    pipe.retrieve(q[:2])
    s = pipe.stats()
    seeds2 = pipe.retrieve_seeds(torch.from_numpy(q[:2]))[1]
    over2 = int(graph_retrieval.retrieve_subgraph(stack.ell, seeds2, mode="compact",
                                                  workset_cap=16, max_hops=2,
                                                  max_nodes=16).overflow.sum())
    assert s == {"batches": 2, "rows": 10, "valid_rows": 5, "compact_runs": 2,
                 "dense_reruns": 1 + (over2 > 0), "overflowed_queries": over + over2}
    s["rows"] = -1  # a copy
    assert pipe.stats()["rows"] == 10


def test_dense_pipeline_counts_no_compact_pass(stack):
    pipe = stack.pipe(retrieval_mode="dense")
    pipe.retrieve_many(np.asarray(stack.g.node_feat[:2]), batch_size=4)
    assert pipe.stats() == {"batches": 1, "rows": 4, "valid_rows": 2, "compact_runs": 0,
                            "dense_reruns": 0, "overflowed_queries": 0}


class Clock:
    def __init__(self):
        self.t = 0.0

    def now(self) -> float:
        return self.t


def test_request_times_on_a_virtual_clock(stack):
    """Two requests, one slot's worth each step: the second waits a step.
    Each engine step starts at a whole second and its decode takes 0.25."""
    clock = Clock()
    eng = stack.engine(now_fn=clock.now, prefetch=False, slots=1)
    inner_step = eng.engine.step

    def decode_takes_a_quarter():
        out = inner_step()
        clock.t += 0.25
        return out

    eng.engine.step = decode_takes_a_quarter
    a, b = stack.req(0, uid=0, max_new=2), stack.req(5, uid=1, max_new=2)
    clock.t = 0.5
    eng.submit(a)
    eng.submit(b)
    done = {}
    for step in (1, 2):
        clock.t = float(step)
        done.update({r.uid: r for r in eng.step()})
    assert sorted(done) == [0, 1] and all(r.done for r in done.values())
    for r, k in ((a, 1.0), (b, 2.0)):
        assert (r.t_submit, r.t_dispatched, r.t_admitted, r.t_first_token, r.t_done) == \
            (0.5, k, k, k, k + 0.25)
    req = eng.stats_ns()["requests"]
    assert req["finished"] == 2
    assert req["queue_seconds"] == (1.0 - 0.5) + (2.0 - 0.5)
    assert req["latency_seconds"] == (1.25 - 0.5) + (2.25 - 0.5)
    assert req["ttft_s"] == [1.0 - 0.5, 2.0 - 0.5]  # each request's, exact


def test_ttft_keeps_the_newest(stack, monkeypatch):
    monkeypatch.setattr(rag_engine, "TTFT_KEEP", 2)
    clock = Clock()
    eng = stack.engine(now_fn=clock.now, prefetch=False, slots=1)
    for u in range(3):
        clock.t = float(u)
        eng.submit(stack.req(u, uid=u, max_new=1))
        clock.t += 0.5 * (u + 1)
        eng.run_to_completion()
    req = eng.stats_ns()["requests"]
    assert req["finished"] == 3 and req["ttft_s"] == [1.0, 1.5]


def test_stats_keep_every_old_key(stack):
    for paged in (False, True):
        eng = stack.engine(paged_kv=paged)
        eng.submit(stack.req(0, uid=0))
        eng.run_to_completion()
        ns = eng.stats_ns()
        for name, keys in OLD_NS_KEYS.items():
            want = keys + (OLD_PAGED_DECODE if paged and name == "decode" else [])
            assert set(want) <= set(ns[name]), name
        flat = eng.stats()
        for name in ("cache", "engine", "prefetch", "decode"):
            for k in ns[name]:
                assert k in flat
        assert {"mutation_batches", "mutation_invalidated"} <= set(flat)
        # the pipeline's batch count stays in the tree: the flat key is the engine's
        assert flat["retrieval_batches"] == ns["engine"]["retrieval_batches"]
        assert flat["retrieval_rows"] == ns["retrieval"]["rows"]
        assert flat["requests_finished"] == 1
        assert ns["decode"]["admit_seconds"] > 0 and ns["decode"]["decode_seconds"] > 0
        assert ns["prefetch"]["launch_seconds"] >= 0 and ns["engine"]["retrieval_seconds"] > 0


def test_flatten_never_shadows_a_key():
    flat = flatten_stats({"engine": {"retrieval_batches": 3}, "retrieval": {"batches": 9,
                                                                            "rows": 4}})
    assert flat == {"retrieval_batches": 3, "retrieval_rows": 4}


def test_a_snapshot_does_not_move(stack):
    eng = stack.engine(prefetch=False)
    for u in range(4):
        eng.submit(stack.req(u, uid=u))
    eng.step()
    snap = eng.stats_ns()
    kept = copy.deepcopy(snap)
    eng.run_to_completion()
    assert snap == kept
    assert eng.stats_ns()["requests"]["finished"] == 4 != snap["requests"]["finished"]
