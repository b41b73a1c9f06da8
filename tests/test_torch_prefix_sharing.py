"""Port prefix-shared paged KV against the reference: the refcounted
allocator under random churn (against a plain-Python allocator and the
reference's device functions), copy-on-write adoption, the ``RGL_KV_DEBUG``
tripwires, shared admission in ``ServeEngine`` and ``RAGServeEngine``
(wave and continuous admission, int8 KV, an undersized pool), and the
retrieval cache's KV-pin lifecycle.  Weights from ``params_from_jax``.

Exact throughout: tokens, retrievals, prompts, truncated flags, block
tables, the free stack, refcounts, pin counters, cache stats, and the
rows a copy on write moved (bit for bit).
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
from repro.serving import CachedRetrieval as RefCachedRetrieval
from repro.serving import RAGRequest as RefRAGRequest
from repro.serving import RAGServeEngine as RefRAGServeEngine
from repro.serving import Request as RefRequest
from repro.serving import RetrievalCache as RefRetrievalCache
from repro.serving import ServeEngine as RefServeEngine
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

from _paged_mirrors import assert_mirrors
from _serving_twins import Clock, sides_of, twin

BASE = dict(name="share-t", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_head=16,
            d_ff=64, vocab=64, dtype="float32")


def _models(**kw):
    ref_cfg, cfg = RefConfig(**BASE, **kw), TransformerConfig(**BASE, **kw)
    ref_params = ref_tm.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = tm.params_from_jax(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    return ref_cfg, ref_params, cfg, params


def _ints(x) -> list:
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x).tolist()


def _blank(cls):
    z = np.empty(0, np.int32)
    return cls(nodes=z, mask=np.empty(0, bool), dist=z, seeds=z)


# ------------------------------------------------- allocator churn oracle ----
def test_refcount_allocator_churn_oracle():
    """Random alloc / retire / pin / unpin churn: after every operation the
    port's free stack (contents, not just depth), refcounts and tables equal
    a plain-Python allocator's and the reference's device state."""
    ref_cfg, _, cfg, _ = _models()
    pool, slots, m, bs = 10, 3, 4, 4
    ca = ref_tm.init_paged_cache(ref_cfg, slots, m * bs, bs, pool)
    cb = tm.init_paged_cache(cfg, slots, m * bs, bs, pool, device="cpu")
    py_free, py_ref = list(range(pool)), [0] * pool
    py_tab = [[] for _ in range(slots)]
    pins = []
    rng = np.random.default_rng(0)

    def py_release(ids):
        drops = {}
        for blk in ids:
            drops[blk] = drops.get(blk, 0) + 1
        for blk in sorted(drops):  # pushes go in ascending id
            py_ref[blk] -= drops[blk]
            if py_ref[blk] <= 0:
                py_free.append(blk)

    def check():
        depth = len(py_free)
        for c in (ca, cb):
            assert int(c.n_free) == depth
            assert _ints(c.free)[:depth] == py_free
            assert _ints(c.ref) == py_ref
            tab = np.asarray(_ints(c.table))
            for i in range(slots):
                assert tab[i, :len(py_tab[i])].tolist() == py_tab[i]
                assert (tab[i, len(py_tab[i]):] == -1).all()
        assert _ints(ca.free) == _ints(cb.free)

    for _ in range(60):
        op = int(rng.integers(0, 4))
        i = int(rng.integers(slots))
        one = np.arange(slots) == i
        if op == 0:  # grow one slot's table toward a random target
            tgt = int(min(m, len(py_tab[i]) + rng.integers(0, 3)))
            need = tgt - len(py_tab[i])
            if need <= 0 or need > len(py_free):
                continue
            target = np.where(one, tgt, 0).astype(np.int32)
            ta = ref_tm.alloc_blocks(ca.table, ca.free, ca.n_free, ca.ref, jnp.asarray(target),
                                     jnp.asarray(one), m)
            tb = tm.alloc_blocks(cb.table, cb.free, cb.n_free, cb.ref, torch.from_numpy(target),
                                 torch.from_numpy(one), m)
            ca = dataclasses.replace(ca, table=ta[0], n_free=ta[1], ref=ta[2])
            cb = dataclasses.replace(cb, table=tb[0], n_free=tb[1], ref=tb[2])
            for _ in range(need):
                blk = py_free.pop()
                py_ref[blk] = 1
                py_tab[i].append(blk)
        elif op == 1:  # retire one slot
            ca = ref_tm.free_slot_blocks(ca, jnp.asarray(one))
            cb = tm.free_slot_blocks(cb, torch.from_numpy(one))
            py_release(py_tab[i])
            py_tab[i] = []
        elif op == 2:  # pin a prefix of a slot's blocks
            if not py_tab[i]:
                continue
            ids = py_tab[i][:int(rng.integers(1, len(py_tab[i]) + 1))]
            ca = ref_tm.acquire_blocks(ca, jnp.asarray(ids, jnp.int32))
            cb = tm.acquire_blocks(cb, torch.tensor(ids, dtype=torch.int32))
            for blk in ids:
                py_ref[blk] += 1
            pins.append(list(ids))
        elif pins:  # release a pin
            ids = pins.pop(int(rng.integers(len(pins))))
            ca = ref_tm.release_blocks(ca, jnp.asarray(ids, jnp.int32))
            cb = tm.release_blocks(cb, torch.tensor(ids, dtype=torch.int32))
            py_release(ids)
        check()
    for ids in pins:
        cb = tm.release_blocks(cb, torch.tensor(ids, dtype=torch.int32))
    cb = tm.free_slot_blocks(cb, torch.ones(slots, dtype=torch.bool))
    assert int(cb.n_free) == pool and (cb.ref == 0).all()


def test_acquire_release_ignore_negative_ids():
    """Holds on allocated blocks, -1 entries ignored; a block whose last
    hold goes returns to the stack."""
    ref_cfg, _, cfg, _ = _models()
    ca = ref_tm.init_paged_cache(ref_cfg, 1, 16, 4, 6)
    cb = tm.init_paged_cache(cfg, 1, 16, 4, 6, device="cpu")
    ta = ref_tm.alloc_blocks(ca.table, ca.free, ca.n_free, ca.ref, jnp.asarray([3], jnp.int32),
                             jnp.asarray([True]), 4)
    tb = tm.alloc_blocks(cb.table, cb.free, cb.n_free, cb.ref, torch.tensor([3], dtype=torch.int32),
                         torch.tensor([True]), 4)
    ca = dataclasses.replace(ca, table=ta[0], n_free=ta[1], ref=ta[2])
    cb = dataclasses.replace(cb, table=tb[0], n_free=tb[1], ref=tb[2])
    b0, _, b2 = _ints(cb.table)[0][:3]
    ids = np.array([b0, -1, b0, b2], np.int32)
    ca = ref_tm.acquire_blocks(ca, jnp.asarray(ids))
    cb = tm.acquire_blocks(cb, torch.from_numpy(ids))
    assert _ints(ca.ref) == _ints(cb.ref) and _ints(cb.ref)[b0] == 3
    ca = ref_tm.free_slot_blocks(ca, jnp.asarray([True]))
    cb = tm.free_slot_blocks(cb, torch.tensor([True]))
    for rel in (ids[1:], ids[:1]):
        ca = ref_tm.release_blocks(ca, jnp.asarray(rel))
        cb = tm.release_blocks(cb, torch.from_numpy(rel))
        for name in ("free", "n_free", "ref"):
            assert _ints(getattr(ca, name)) == _ints(getattr(cb, name)), name
    assert int(cb.n_free) == 6 and (cb.ref == 0).all()


# --------------------------------------------------------- adoption + COW ----
@pytest.mark.parametrize("quant", [False, True])
def test_adopt_prefix_blocks_matches_reference(quant):
    """Slot 1 adopts slot 0's 10-token prompt: two full blocks aliased, the
    partial tail copied into a fresh block (rows and, for int8, scales bit
    for bit), holds as the engine protocol leaves them, pos/cursor pinned,
    the donor's first token taken; slot 2 adopts a 12-token prompt with no
    tail.  Tables, free stack, refcounts and pools equal the reference's."""
    ref_cfg, _, cfg, _ = _models(kv_quant=quant)
    bs, m, pool, slots = 4, 4, 10, 3
    ca = ref_tm.init_paged_cache(ref_cfg, slots, m * bs, bs, pool)
    cb = tm.init_paged_cache(cfg, slots, m * bs, bs, pool, device="cpu")
    target, live = np.array([3, 0, 0], np.int32), np.array([True, False, False])
    ta = ref_tm.alloc_blocks(ca.table, ca.free, ca.n_free, ca.ref, jnp.asarray(target),
                             jnp.asarray(live), 3)
    tb = tm.alloc_blocks(cb.table, cb.free, cb.n_free, cb.ref, torch.from_numpy(target),
                         torch.from_numpy(live), 3)
    rng = np.random.default_rng(2)
    shape = tuple(ca.k.shape)
    k = rng.integers(-127, 128, shape) if quant else rng.standard_normal(shape)
    k = k.astype(np.int8 if quant else np.float32)
    ca = dataclasses.replace(ca, table=ta[0], n_free=ta[1], ref=ta[2], k=jnp.asarray(k))
    cb = dataclasses.replace(cb, table=tb[0], n_free=tb[1], ref=tb[2], k=torch.from_numpy(k.copy()))
    if quant:
        sc = rng.uniform(0.01, 1, shape[:-1]).astype(np.float32)
        ca = dataclasses.replace(ca, k_scale=jnp.asarray(sc, jnp.bfloat16))
        cb = dataclasses.replace(cb, k_scale=torch.from_numpy(sc).to(torch.bfloat16))
    donor = _ints(tb[0])[0][:3]
    for _ in range(2):  # engine protocol: the pin's hold, then the plan's
        ca = ref_tm.acquire_blocks(ca, jnp.asarray(donor, jnp.int32))
        cb = tm.acquire_blocks(cb, torch.tensor(donor, dtype=torch.int32))
    src_table = np.full((slots, m), -1, np.int32)
    src_table[1, :2] = donor[:2]
    src_table[2, :3] = donor
    length = np.array([0, 10, 12], np.int32)
    tail = np.array([-1, donor[2], -1], np.int32)
    mask, first = np.array([False, True, True]), np.array([0, 7, 9], np.int32)
    na, cur_a = ref_tm.adopt_prefix_blocks(ca, jnp.zeros(slots, jnp.int32), jnp.asarray(mask),
                                           jnp.asarray(src_table), jnp.asarray(length),
                                           jnp.asarray(tail), jnp.asarray(first), bs)
    nb, cur_b = tm.adopt_prefix_blocks(cb, torch.zeros(slots, dtype=torch.int32),
                                       torch.from_numpy(mask), torch.from_numpy(src_table),
                                       torch.from_numpy(length), torch.from_numpy(tail),
                                       torch.from_numpy(first), bs)
    for name in ("table", "free", "n_free", "ref", "pos", "cursor"):
        assert _ints(getattr(na, name)) == _ints(getattr(nb, name)), name
    assert _ints(cur_a) == _ints(cur_b) == [0, 7, 9]
    np.testing.assert_array_equal(np.asarray(na.k), nb.k.numpy())
    if quant:
        np.testing.assert_array_equal(np.asarray(na.k_scale).astype(np.float32),
                                      nb.k_scale.float().numpy())
    fresh = _ints(nb.table)[1][2]
    assert fresh not in donor and _ints(nb.ref)[fresh] == 1
    assert torch.equal(nb.k[:, fresh * bs:(fresh + 1) * bs], nb.k[:, donor[2] * bs:(donor[2] + 1) * bs])


# ----------------------------------------------------------------- tripwires ----
def _share_engine(params, cfg, **kw):
    kw = dict(dict(slots=3, cache_len=48, paged_kv=True, block_size=8, device="cpu"), **kw)
    return ServeEngine(params, cfg, **kw)


def test_alloc_guard_and_double_free_tripwire():
    _, _, cfg, params = _models()
    eng = _share_engine(params, cfg)
    assert eng._kv_debug  # tests/conftest.py arms RGL_KV_DEBUG suite-wide
    with pytest.raises(RuntimeError, match="alloc invariant"):
        eng._guard_alloc(eng.pool_blocks + 1, "unit test")
    blk = eng._pop_host(0, 1)[0]
    with pytest.raises(RuntimeError, match="double-free"):
        eng._host_release({blk: 2})


# -------------------------------------------- engine-tier sharing + parity ----
@pytest.mark.parametrize("quant", [False, True])
def test_shared_admission_matches_reference_and_fresh(quant):
    """A donor pins its prompt blocks to an entry; the same prompt later
    adopts them and skips prefill.  Tokens equal the reference engine's
    under sharing and the port's own engine that prefills everything;
    counters, tables, free stack and refcounts equal the reference's after
    every wave, and releasing every pin returns the whole pool."""
    ref_cfg, ref_params, cfg, params = _models(kv_quant=quant)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 64, n).astype(np.int32) for n in (13, 16, 9)]

    def run(eng, req_cls, entry_cls, share):
        entries, outs, uid = {}, {}, 0
        for _ in range(3):  # each wave serves every prompt again
            for pi, p in enumerate(prompts):
                e = entries.setdefault(pi, _blank(entry_cls))
                r = req_cls(uid=uid, prompt_ids=p, max_new_tokens=8)
                if share:
                    r.pin_to = e
                    if e.kv_blocks is not None:
                        r.shared_prefix = e
                eng.submit(r)
                uid += 1
            for r in eng.run_to_completion():
                outs[r.uid] = list(r.out_tokens)
            yield outs, entries

    ref = RefServeEngine(ref_params, ref_cfg, slots=3, cache_len=48, paged_kv=True, block_size=8,
                         prefix_share=True, spec_decode=False)
    port = _share_engine(params, cfg, prefix_share=True)
    fresh = _share_engine(params, cfg, prefix_share=False)
    for (a, _), (b, entries), (c, _) in zip(run(ref, RefRequest, RefCachedRetrieval, True),
                                            run(port, Request, CachedRetrieval, True),
                                            run(fresh, Request, CachedRetrieval, False)):
        assert a == b == c
        assert ref._free_stack == port._free_stack and ref._slot_blocks == port._slot_blocks
        assert _ints(ref.cache.ref) == _ints(port.cache.ref)
        assert_mirrors(port)
    sa, sb = ref.decode_stats(), port.decode_stats()
    for key in sa:
        if key != "admit_seconds":
            assert sa[key] == sb[key], key
    assert sb["kv_shared_admits"] >= 6 and sb["kv_cow_copies"] >= 1
    assert sb["prefill_rows"] < fresh.decode_stats()["prefill_rows"]
    assert port.kv_pins == 3 and port.kv_pinned_blocks > 0
    for e in entries.values():
        e.kv_release(e)
    assert port._free_host == port.pool_blocks and (port.cache.ref == 0).all()
    assert_mirrors(port)


def test_share_plan_falls_back_on_prompt_mismatch():
    """An entry pinning another prompt is re-validated at admission and
    ignored: fresh prefill, the unshared engine's tokens, no shared admit."""
    _, _, cfg, params = _models()
    rng = np.random.default_rng(7)
    pa, pb = (rng.integers(1, 64, 12).astype(np.int32) for _ in range(2))
    eng = _share_engine(params, cfg, prefix_share=True)
    entry = _blank(CachedRetrieval)
    eng.submit(Request(uid=0, prompt_ids=pa, max_new_tokens=6, pin_to=entry))
    eng.run_to_completion()
    assert entry.kv_blocks is not None and entry.kv_len == 12
    eng.submit(Request(uid=1, prompt_ids=pb, max_new_tokens=6, shared_prefix=entry))
    got = eng.run_to_completion()[0].out_tokens
    plain = _share_engine(params, cfg)
    plain.submit(Request(uid=1, prompt_ids=pb, max_new_tokens=6))
    assert got == plain.run_to_completion()[0].out_tokens
    assert eng.kv_shared_admits == 0
    assert_mirrors(eng)
    entry.kv_release(entry)
    assert eng._free_host == eng.pool_blocks


def test_pin_gate_rejects_non_resident_entry():
    _, _, cfg, params = _models()
    eng = _share_engine(params, cfg, prefix_share=True)
    cache = RetrievalCache(capacity=1, policy="lru")
    eng.kv_pin_gate = cache.is_resident
    evicted = _blank(CachedRetrieval)
    cache.put(np.zeros(4, np.float32), evicted)
    cache.put(np.ones(4, np.float32), _blank(CachedRetrieval))  # evicts `evicted`
    assert not cache.is_resident(evicted)
    eng.submit(Request(uid=0, prompt_ids=np.arange(1, 13, dtype=np.int32), max_new_tokens=4,
                       pin_to=evicted))
    eng.run_to_completion()
    assert evicted.kv_blocks is None and eng.kv_pins == 0
    assert eng._free_host == eng.pool_blocks


# ------------------------------------------------------- RAG-tier sharing ----
N_NODES = 120


@pytest.fixture(scope="module")
def stack():
    g_ref = ref_gen.citation_graph(N_NODES, avg_deg=6, seed=7)
    g = generators.citation_graph(N_NODES, avg_deg=6, seed=7)
    pcfg = dict(strategy="bfs", k_seeds=3, max_hops=2, max_nodes=16, filter_budget=8)
    vocab_ref, vocab = RefVocab.build(g_ref.node_text), Vocab.build(g.node_text)
    ref_pipe = RefPipeline(
        graph=ref_csr_to_ell(g_ref), index=RefBruteIndex.build(jnp.asarray(g_ref.node_feat)),
        node_emb=jnp.asarray(g_ref.node_feat),
        tokenizer=RefTokenizer(vocab_ref, max_len=64, node_budget=6),
        node_text=g_ref.node_text, config=RefPipelineConfig(**pcfg))
    ell = csr_to_ell(g, device="cpu")
    pipe = RGLPipeline(
        graph=ell, index=BruteIndex.build(g.node_feat, device="cpu"), node_emb=ell.node_feat,
        tokenizer=GraphTokenizer(vocab, max_len=64, node_budget=6), node_text=g.node_text,
        config=PipelineConfig(**pcfg), device="cpu")
    sides = {}
    for quant in (False, True):
        kw = dict(BASE, name="share-rag", vocab=vocab.size, kv_quant=quant)
        ref_cfg, cfg = RefConfig(**kw), TransformerConfig(**kw)
        ref_params = ref_tm.init_params(jax.random.PRNGKey(0), ref_cfg)
        params = tm.params_from_jax(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
        sides[quant] = ((ref_pipe, ref_cfg, ref_params), (pipe, cfg, params))
    return g, sides


def _rag_run(g, side, is_ref, n=12, uniq=4, **kw):
    pipe, cfg, params = side
    if is_ref:
        eng = RefRAGServeEngine(pipe, params, cfg, slots=3, cache_len=96, prefetch=False,
                                spec_decode=False, **kw)
        cls = RefRAGRequest
    else:
        eng = RAGServeEngine(pipe, params, cfg, slots=3, cache_len=96, device="cpu", **kw)
        cls = RAGRequest
    for u in range(n):  # repeat-heavy: the sharing regime
        qi = u % uniq
        eng.submit(cls(uid=u, query_emb=np.asarray(g.node_feat[qi]), query_text=g.node_text[qi],
                       max_new_tokens=4))
    done = {r.uid: r for r in eng.drain()}
    outs = {u: (list(r.out_tokens), np.asarray(r.retrieved_nodes).tolist(),
                np.asarray(r.prompt_ids).tolist(), r.truncated)
            for u, r in done.items() if r.done and not r.failed}
    return eng, outs


def _assert_share_clean(eng):
    """Drained: every remaining hold is a cache pin, and reclaiming every
    pin returns the whole pool."""
    inner = eng.engine
    assert not inner.queue and not inner.live.any()
    assert_mirrors(inner)
    assert inner._free_host == inner.pool_blocks - inner.kv_pinned_blocks
    assert int(inner._ref_host.sum()) == sum(
        s.entry.kv_blocks.size for s in eng.cache._data.values() if s.entry.kv_blocks is not None)
    eng.cache.reclaim_kv(10 ** 9)
    assert inner._free_host == inner.pool_blocks and (inner._ref_host == 0).all()
    assert_mirrors(inner)


def _same_counters(ref, port):
    sa, sb = ref.stats(), port.stats()
    for key in ("hits", "misses", "retrieval_batches", "prefill_rows", "truncations",
                "kv_shared_admits", "kv_reused_tokens", "kv_cow_copies", "kv_pins",
                "kv_releases", "kv_pinned_blocks", "kv_pinned_entries", "pool_high_water_blocks",
                "pool_free_blocks", "admission"):
        assert sa[key] == sb[key], key
    assert ref.engine._free_stack == port.engine._free_stack
    assert _ints(ref.engine.cache.table) == _ints(port.engine.cache.table)
    assert _ints(ref.engine.cache.ref) == _ints(port.engine.cache.ref)


@pytest.mark.parametrize("admission,quant", [("wave", False), ("continuous", False),
                                             ("continuous", True)])
def test_rag_prefix_share_matches_reference(stack, admission, quant):
    """Sharing on: per-uid tokens, retrievals, prompts and truncated flags
    equal the reference's and the port's unshared run; sharing fires; every
    counter and the allocator state equal the reference's; nothing leaks."""
    g, sides = stack
    ref_side, port_side = sides[quant]
    kw = dict(paged_kv=True, prefix_share=True, admission=admission)
    ref, a = _rag_run(g, ref_side, True, **kw)
    port, b = _rag_run(g, port_side, False, **kw)
    _, c = _rag_run(g, port_side, False, **dict(kw, prefix_share=False))
    assert a == b == c
    _same_counters(ref, port)
    ds = port.engine.decode_stats()
    assert ds["kv_shared_admits"] > 0 and ds["prefill_rows"] < len(b)
    assert port.cache.kv_pinned_entries() > 0
    _assert_share_clean(port)


def test_chaos_soak_with_prefix_sharing(stack):
    """Seeded retrieval chaos (all four fault types at 25%, one retry, a
    0.05 s timeout on a virtual clock) with sharing on: every request
    reaches a terminal state, equal to the reference's, the fault-free
    subset equals a clean unshared run, and the pool shows no leaked or
    double-freed block (``RGL_KV_DEBUG`` is armed suite-wide)."""
    g, sides = stack
    ref_side, port_side = sides_of(g, *sides[False])

    def run(share, faults):
        def scenario(side):
            clock = Clock()
            src = side.mod.FaultyRetrieval(side.pipe, seed=23, fault_rate=0.25,
                                           now_fn=clock.now, sleep_fn=clock.sleep) \
                if faults else None
            kw = dict(max_retries=1, retrieval_timeout_s=0.05) if faults else {}
            eng = side.engine(src, slots=3, cache_len=96, paged_kv=True, prefix_share=share,
                              now_fn=clock.now, sleep_fn=clock.sleep, **kw)
            for u in range(14):
                eng.submit(side.req(u % 7, uid=u, max_new=4))
            return eng, {r.uid: r for r in eng.drain()}
        return twin(scenario, ref_side, port_side)

    _, clean = run(False, False)
    sched = port_side.mod.FaultyRetrieval(port_side.pipe, seed=23, fault_rate=0.25)
    bad_q = {qi for qi in range(7)
             if sched.fault_of(np.asarray(g.node_feat[qi])) is not None}
    assert bad_q and len(bad_q) < 7
    eng, got = run(True, True)
    assert set(got) == set(range(14)) and all(r.done or r.failed or r.shed for r in got.values())
    for u, r in got.items():
        if (u % 7) not in bad_q:
            assert r.done and not r.degraded and r.out_tokens == clean[u].out_tokens
            np.testing.assert_array_equal(r.retrieved_nodes, clean[u].retrieved_nodes)
    assert eng.engine.decode_stats()["kv_shared_admits"] > 0
    _assert_share_clean(eng)


def test_rag_prefix_share_contiguous_fallback(stack):
    """prefix_share on a contiguous arena is inert, as in the reference."""
    g, sides = stack
    _, a = _rag_run(g, sides[False][1], False, paged_kv=False)
    eng, b = _rag_run(g, sides[False][1], False, paged_kv=False, prefix_share=True)
    assert a == b and not eng.engine.prefix_share
    assert eng.engine.decode_stats()["prefill_rows"] == len(b)


@pytest.mark.parametrize("admission", ["wave", "continuous"])
def test_pool_exhaustion_under_sharing_matches_reference(stack, admission):
    """An undersized pool with sharing: pins are reclaimed before live
    requests are truncated, every request ends, and tokens, truncations,
    pin counters and the allocator equal the reference's."""
    g, sides = stack
    kw = dict(paged_kv=True, prefix_share=True, kv_pool_blocks=8, n=10, uniq=3,
              admission=admission)
    ref, a = _rag_run(g, sides[False][0], True, **kw)
    port, b = _rag_run(g, sides[False][1], False, **kw)
    assert a == b and set(b) == set(range(10))
    _same_counters(ref, port)
    assert port.engine.kv_pins > 0 and port.engine.kv_releases > 0
    _assert_share_clean(port)


# --------------------------------------------------- cache pin lifecycle ----
def _emb(i):
    return np.full(4, float(i), np.float32)


def _pinned(cls, owner, blocks, released):
    e = _blank(cls)
    e.kv_blocks = np.asarray(blocks, np.int32)
    e.kv_owner = owner

    def rel(entry):
        n = int(entry.kv_blocks.size)
        entry.kv_blocks = None
        entry.kv_release = None
        released.append(blocks[0])
        return n

    e.kv_release = rel
    return e


def _both_caches(**kw):
    clock = {"t": 0.0}
    now = lambda: clock["t"]  # noqa: E731
    return clock, (RefRetrievalCache(now_fn=now, **kw), RetrievalCache(now_fn=now, **kw)), \
        (RefCachedRetrieval, CachedRetrieval)


def test_cache_releases_pins_on_eviction_overwrite_and_ttl_purge():
    """Eviction, overwrite of a live key and the TTL purge each release the
    leaving entry's pin once, in the reference's order; residency, pinned
    entries and stats follow."""
    clock, caches, classes = _both_caches(capacity=2, policy="lru", ttl=5.0)
    logs = []
    for cache, cls in zip(caches, classes):
        released = []
        e0, e1, e2 = (_pinned(cls, "eng", [b], released) for b in (10, 11, 12))
        clock["t"] = 0.0
        cache.put(_emb(0), e0)
        cache.put(_emb(1), e1)
        assert cache.is_resident(e0) and cache.kv_pinned_entries() == 2
        cache.put(_emb(2), _blank(cls))  # evicts e0
        assert not cache.is_resident(e0)
        cache.put(_emb(1), _blank(cls))  # overwrite releases e1
        cache.put(_emb(3), e2)  # evicts key 2 (no pin)
        clock["t"] = 10.0
        cache.put(_emb(4), _blank(cls))  # purge of the expired releases e2
        logs.append((released, cache.stats()))
    (ra, sa), (rb, sb) = logs
    assert ra == rb == [10, 11, 12]
    for key in sb:
        assert sa[key] == sb[key], key


@pytest.mark.parametrize("policy", ["lru", "lfu", "ttl"])
def test_reclaim_kv_order_and_owner_filter(policy):
    """Expired pins first, then the policy's eviction order; an owner filter
    leaves other engines' pins; entries keep their results."""
    clock, caches, classes = _both_caches(capacity=8, policy=policy, ttl=10.0)
    logs = []
    for cache, cls in zip(caches, classes):
        released = []
        clock["t"] = 0.0
        entries = [_pinned(cls, "eng" if b != 5 else "other", [b, b + 10], released)
                   for b in range(6)]
        for i, e in enumerate(entries):
            if i == 1:
                clock["t"] = 11.0  # only entry 0 is expired from here on
            cache.put(_emb(i), e)
        for i in (2, 2, 4, 1, 3, 2):
            cache.get(_emb(i))
        freed = [cache.reclaim_kv(3, owner="eng"), cache.reclaim_kv(100, owner="eng")]
        freed.append(cache.reclaim_kv(100))
        logs.append((released, freed, len(cache), cache.kv_pinned_entries()))
    assert logs[0] == logs[1]
    released, freed, size, pinned = logs[1]
    assert released[0] == 0 and released[-1] == 5 and size == 6 and pinned == 0
