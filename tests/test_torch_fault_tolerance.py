"""Port fault-tolerant serving against the reference, case for case with
``tests/test_fault_tolerance.py`` (all but the online-mutation soak, ROADMAP
Queue 1 item 13): the seeded fault schedule, retry isolation, the
degradation ladder, deadlines and load shedding, abort / drain
reconciliation and the chaos soak over the admission/decode matrix.

Each scenario runs on the reference and on the port (CPU) with the same
graph, queries, weights and virtual clock (timeouts poll it, backoff and
simulated latency advance it): per-uid tokens, node ids, prompts, flags and
error reasons, cache accounting and every retry, timeout, failure, shed,
degraded and stale counter are held equal.  Nothing sleeps on the wall
clock.  The soak's (prefetch, continuous, paged) cell runs in tier 1; the
other cells are ``slow``, as the whole matrix is in the reference.
"""
import numpy as np
import pytest

from _serving_twins import Clock, assert_clean, make_sides, twin

CACHE_LEN = 96
SLOTS = 3


@pytest.fixture(scope="module")
def sides():
    return make_sides("fault-t")


def _engine(side, src=None, clock=None, **kw):
    if clock is not None:
        kw.update(now_fn=clock.now, sleep_fn=clock.sleep)
    return side.engine(src, **kw)


def _faulty(side, clock, **kw):
    return side.mod.FaultyRetrieval(side.pipe, now_fn=clock.now, sleep_fn=clock.sleep, **kw)


# -------------------------------------------------------- fault scheduling ----
def test_fault_schedule_is_seeded_and_deterministic(sides):
    """The port's schedule is the reference's, embedding for embedding."""
    ref, port = sides
    rows = [np.asarray(port.g.node_feat[i]) for i in range(40)]
    for seed, rate in ((3, 0.5), (4, 0.5), (23, 0.25), (3, 0.0)):
        a = [ref.mod.FaultyRetrieval(ref.pipe, seed=seed, fault_rate=rate).fault_of(r) for r in rows]
        b = [port.mod.FaultyRetrieval(port.pipe, seed=seed, fault_rate=rate).fault_of(r)
             for r in rows]
        assert a == b, seed
    mod = port.mod
    a = mod.FaultyRetrieval(port.pipe, seed=3, fault_rate=0.5)
    b = mod.FaultyRetrieval(port.pipe, seed=3, fault_rate=0.5)
    c = mod.FaultyRetrieval(port.pipe, seed=4, fault_rate=0.5)
    sched_a = [a.fault_of(r) for r in rows]
    assert sched_a == [b.fault_of(r) for r in rows]
    assert sched_a != [c.fault_of(r) for r in rows]
    hit = [s for s in sched_a if s is not None]
    assert hit and len(hit) < len(rows)
    assert set(hit) <= set(mod.FaultyRetrieval.FAULT_TYPES)
    none = mod.FaultyRetrieval(port.pipe, seed=3, fault_rate=0.0)
    assert all(none.fault_of(r) is None for r in rows)
    with pytest.raises(ValueError, match="fault_rate"):
        mod.FaultyRetrieval(port.pipe, fault_rate=1.5)
    with pytest.raises(ValueError, match="unknown fault types"):
        mod.FaultyRetrieval(port.pipe, fault_types=("gremlin",))


# ------------------------------------------------------------ retry layer ----
def test_transient_fault_recovers_via_retry_bitwise(sides):
    """A row that faults once and heals recovers through the retry path:
    every request completes undegraded, bitwise equal to a no-fault run."""
    ref, port = sides

    def run(faults, retries):
        def scenario(side):
            clock = Clock()
            src = _faulty(side, clock, seed=11, fault_rate=0.5, fails_per_row=1) if faults \
                else None
            eng = _engine(side, src, clock, slots=SLOTS, cache_len=CACHE_LEN, prefetch=True,
                          max_retries=retries, retrieval_timeout_s=0.05)
            for u in range(6):
                eng.submit(side.req(u, uid=u))
            done = {r.uid: r for r in eng.run_to_completion()}
            if not side.is_ref:
                assert_clean(eng)
            return eng, done
        return twin(scenario, ref, port)

    _, clean = run(False, 0)
    sched = port.mod.FaultyRetrieval(port.pipe, seed=11, fault_rate=0.5)
    assert any(sched.fault_of(np.asarray(port.g.node_feat[u])) for u in range(6))
    eng, done = run(True, 2)
    assert len(done) == 6
    for u in range(6):
        assert done[u].done and not done[u].failed and not done[u].degraded
        assert done[u].out_tokens == clean[u].out_tokens
        np.testing.assert_array_equal(done[u].retrieved_nodes, clean[u].retrieved_nodes)
    s = eng.stats()
    assert s["retries"] > 0 and s["retrieval_failures"] == 0
    assert s["failed"] == s["degraded"] == 0


def test_permanent_fault_isolated_to_its_own_request(sides):
    """One permanently poisoned row degrades only its own request; its
    wave-mates match a no-fault run bit for bit."""
    ref, port = sides
    sched = port.mod.FaultyRetrieval(port.pipe, seed=11, fault_rate=0.5, fault_types=("corrupt",))
    bad = {u for u in range(6) if sched.fault_of(np.asarray(port.g.node_feat[u])) is not None}
    assert bad and len(bad) < 6

    def run(faults):
        def scenario(side):
            clock = Clock()
            src = _faulty(side, clock, seed=11, fault_rate=0.5, fault_types=("corrupt",)) \
                if faults else None
            eng = _engine(side, src, clock, slots=SLOTS, cache_len=CACHE_LEN, prefetch=True,
                          max_retries=1, retrieval_timeout_s=0.05)
            for u in range(6):
                eng.submit(side.req(u, uid=u))
            done = {r.uid: r for r in eng.run_to_completion()}
            if not side.is_ref:
                assert_clean(eng)
            return eng, done
        return twin(scenario, ref, port)

    _, clean = run(False)
    eng, done = run(True)
    for u in range(6):
        if u in bad:
            assert done[u].degraded and done[u].done and done[u].retrieved_nodes.size == 0
        else:
            assert not done[u].degraded
            assert done[u].out_tokens == clean[u].out_tokens
            np.testing.assert_array_equal(done[u].retrieved_nodes, clean[u].retrieved_nodes)
    assert eng.stats()["degraded"] == len(bad)


# ----------------------------------------------------- degradation ladder ----
def test_ladder_rung_stale_cache_entry(sides):
    """Retry exhaustion falls back to a TTL-expired but resident entry
    before degraded mode."""
    ref, port = sides

    def scenario(side):
        now = [0.0]
        cache = side.mod.RetrievalCache(capacity=8, ttl=10.0, now_fn=lambda: now[0])
        ok = side.engine(slots=2, cache_len=CACHE_LEN, retrieval_cache=cache)
        ok.submit(side.req(0, uid=0))
        clean = ok.run_to_completion()[0]
        assert cache.peek_stale(np.asarray(side.g.node_feat[0])) is not None
        now[0] = 100.0  # the entry is TTL-expired but resident
        boom = side.mod.FaultyRetrieval(side.pipe, seed=0, fault_rate=1.0,
                                        fault_types=("dispatch",))
        eng = side.engine(boom, slots=2, cache_len=CACHE_LEN, retrieval_cache=cache)
        eng.submit(side.req(0, uid=1))
        r = eng.run_to_completion()[0]
        return eng, {0: clean, 1: r}

    eng, done = twin(scenario, ref, port)
    clean, r = done[0], done[1]
    assert r.done and r.stale and not r.degraded and not r.failed
    assert r.out_tokens == clean.out_tokens
    np.testing.assert_array_equal(r.retrieved_nodes, clean.retrieved_nodes)
    assert eng.stats()["stale_served"] == 1 and eng.stats()["degraded"] == 0
    assert_clean(eng)


@pytest.mark.parametrize("ftype", ["dispatch", "force", "stuck", "corrupt"])
def test_ladder_rung_degraded_per_fault_type(sides, ftype):
    """With no cache fallback, every fault type exhausts into a query-only
    prompt."""
    ref, port = sides
    injected = {}

    def scenario(side):
        clock = Clock()
        boom = _faulty(side, clock, seed=0, fault_rate=1.0, fault_types=(ftype,))
        eng = _engine(side, boom, clock, slots=2, cache_len=CACHE_LEN, prefetch=True,
                      max_retries=1, retrieval_timeout_s=0.05)
        eng.submit(side.req(0, uid=0, max_new=3))
        done = {r.uid: r for r in eng.run_to_completion()}
        injected[side.is_ref] = dict(boom.injected)
        return eng, done

    eng, done = twin(scenario, ref, port)
    r = done[0]
    assert r.done and r.degraded and not r.failed
    assert len(r.out_tokens) == 3 and r.retrieved_nodes.size == 0
    s = eng.stats()
    assert s["degraded"] == 1 and s["retrieval_failures"] >= 1
    assert injected[False] == injected[True] and injected[False][ftype] > 0
    assert_clean(eng)


def test_ladder_rung_failed_when_degraded_disabled(sides):
    ref, port = sides

    def scenario(side):
        boom = side.mod.FaultyRetrieval(side.pipe, seed=0, fault_rate=1.0,
                                        fault_types=("corrupt",))
        eng = side.engine(boom, slots=2, cache_len=CACHE_LEN, degraded_mode=False)
        eng.submit(side.req(0, uid=7))
        return eng, {r.uid: r for r in eng.run_to_completion()}

    eng, done = twin(scenario, ref, port)
    r = done[7]
    assert r.failed and not r.done and not r.degraded
    assert "corrupt" in r.error and "node id out of range" in r.error
    assert eng.stats()["failed"] == 1
    assert_clean(eng)


def test_stuck_row_without_timeout_fails_loud_not_hung(sides, monkeypatch):
    """With no timeout a never-ready row does not hang the engine: forcing
    it raises, and the ladder contains that."""
    ref, port = sides
    monkeypatch.delenv("RGL_RETRIEVAL_TIMEOUT", raising=False)
    monkeypatch.delenv("RGL_RETRIES", raising=False)

    def scenario(side):
        boom = side.mod.FaultyRetrieval(side.pipe, seed=0, fault_rate=1.0, fault_types=("stuck",))
        eng = side.engine(boom, slots=2, cache_len=CACHE_LEN)
        eng.submit(side.req(0, uid=0))
        done = {r.uid: r for r in eng.run_to_completion()}
        with pytest.raises(side.mod.RetrievalFault, match="stuck"):
            np.asarray(boom.retrieve_many(np.asarray(side.g.node_feat[0])).seeds)
        return eng, done

    _, done = twin(scenario, ref, port)
    assert done[0].done and done[0].degraded


# ------------------------------------------------- deadlines & overload ----
def test_deadline_expired_requests_shed_never_dispatched(sides):
    ref, port = sides

    def scenario(side):
        now = [0.0]
        eng = side.engine(slots=2, cache_len=CACHE_LEN, now_fn=lambda: now[0])
        eng.submit(side.req(0, uid=0, deadline_s=5.0))
        eng.submit(side.req(1, uid=1))  # no deadline: must still complete
        now[0] = 6.0  # past uid 0's deadline before any step ran
        return eng, {r.uid: r for r in eng.run_to_completion()}

    eng, done = twin(scenario, ref, port)
    assert done[0].shed and not done[0].done and "deadline" in done[0].error
    assert done[1].done and not done[1].shed
    assert eng.prefetcher.queries == 1 and eng.stats()["shed"] == 1
    assert_clean(eng)


def test_default_deadline_env_and_kwarg(sides, monkeypatch):
    ref, port = sides
    for side in (ref, port):
        now = [0.0]
        monkeypatch.delenv("RGL_DEADLINE", raising=False)
        eng = side.engine(slots=2, cache_len=CACHE_LEN, default_deadline_s=2.0,
                          now_fn=lambda: now[0])
        eng.submit(side.req(0, uid=0))
        assert eng.pending[0].deadline_at == 2.0
        monkeypatch.setenv("RGL_DEADLINE", "7.5")
        assert side.engine(slots=2, cache_len=CACHE_LEN, now_fn=lambda: now[0]) \
            .default_deadline_s == 7.5
        monkeypatch.setenv("RGL_DEADLINE", "junk")
        with pytest.raises(ValueError, match="RGL_DEADLINE"):
            side.engine(slots=2, cache_len=CACHE_LEN)


def test_bounded_pending_queue_shed_policies(sides):
    ref, port = sides

    def reject(side):
        eng = side.engine(slots=2, cache_len=CACHE_LEN, max_pending=2, shed_policy="reject")
        assert eng.submit(side.req(0, uid=0)) and eng.submit(side.req(1, uid=1))
        assert not eng.submit(side.req(2, uid=2))  # queue full: shed on arrival
        return eng, {r.uid: r for r in eng.run_to_completion()}

    eng, done = twin(reject, ref, port)
    assert done[0].done and done[1].done
    assert done[2].shed and "reject" in done[2].error
    assert eng.stats()["shed"] == 1

    def evict(side):
        eng = side.engine(slots=2, cache_len=CACHE_LEN, max_pending=2, shed_policy="evict-oldest")
        for u in range(3):
            eng.submit(side.req(u, uid=u))
        return eng, {r.uid: r for r in eng.run_to_completion()}

    _, done2 = twin(evict, ref, port)
    assert done2[0].shed and "evict-oldest" in done2[0].error
    assert done2[1].done and done2[2].done
    with pytest.raises(ValueError, match="shed_policy"):
        port.engine(slots=2, cache_len=CACHE_LEN, shed_policy="drop-newest")


def test_submit_validation_rejects_poison_requests(sides):
    _, port = sides
    eng = port.engine(slots=2, cache_len=CACHE_LEN)
    good = np.asarray(port.g.node_feat[0])
    nan = good.copy()
    nan[0] = np.nan
    R = port.mod.RAGRequest
    with pytest.raises(ValueError, match="request 3.*NaN"):
        eng.submit(R(uid=3, query_emb=nan, query_text="q"))
    with pytest.raises(ValueError, match="request 4.*1-D"):
        eng.submit(R(uid=4, query_emb=np.stack([good, good]), query_text="q"))
    with pytest.raises(ValueError, match="request 5.*dim"):
        eng.submit(R(uid=5, query_emb=good[:3], query_text="q"))
    with pytest.raises(ValueError, match="request 6.*query_text"):
        eng.submit(R(uid=6, query_emb=good, query_text="   "))
    with pytest.raises(ValueError, match="request 7.*max_new_tokens"):
        eng.submit(R(uid=7, query_emb=good, query_text="q", max_new_tokens=0))
    with pytest.raises(ValueError, match="request 8.*deadline_s"):
        eng.submit(R(uid=8, query_emb=good, query_text="q", deadline_s=-1.0))
    assert not eng.pending and eng.run_to_completion() == []


# ------------------------------------------------------- abort & recovery ----
@pytest.mark.parametrize("paged", [False, True])
def test_abort_reconciles_all_layers_and_engine_reusable(sides, paged):
    """abort() mid-flight retires live slots, drops in-flight waves, sheds
    the queue, and leaves the engine serving a fresh workload correctly."""
    ref, port = sides

    def scenario(side):
        eng = side.engine(slots=2, cache_len=CACHE_LEN, prefetch=True, prefetch_depth=2,
                          paged_kv=paged)
        for u in range(6):
            eng.submit(side.req(u, uid=u, max_new=8))
        eng.step()  # some admitted and decoding, some in flight, some pending
        out = {r.uid: r for r in eng.abort(reason="test teardown")}
        assert set(out) == set(range(6))
        assert all((r.failed or r.shed) and r.error is not None for r in out.values())
        if not side.is_ref:
            assert_clean(eng)
        for u in range(3):
            eng.submit(side.req(u, uid=100 + u))
        out.update({r.uid: r for r in eng.run_to_completion()})
        return eng, out

    eng, done = twin(scenario, ref, port)
    assert_clean(eng)

    def fresh(side):
        e = side.engine(slots=2, cache_len=CACHE_LEN, paged_kv=paged)
        for u in range(3):
            e.submit(side.req(u, uid=100 + u))
        return e, {r.uid: r for r in e.run_to_completion()}

    _, want = twin(fresh, ref, port)
    for uid in want:
        assert done[uid].done and done[uid].out_tokens == want[uid].out_tokens


def test_recovery_after_run_to_completion_exhaustion(sides):
    """abort() reconciles after a run_to_completion RuntimeError; drain()
    never raises."""
    ref, port = sides

    def scenario(side):
        eng = side.engine(slots=2, cache_len=CACHE_LEN, prefetch=True)
        for u in range(4):
            eng.submit(side.req(u, uid=u, max_new=20))
        with pytest.raises(RuntimeError, match="still pending"):
            eng.run_to_completion(max_steps=2)
        out = {r.uid: r for r in eng.abort(reason="exhausted")}
        assert out and all(r.failed or r.shed for r in out.values())
        eng.submit(side.req(0, uid=50))
        out.update({r.uid: r for r in eng.run_to_completion()})
        return eng, out

    eng, done = twin(scenario, ref, port)
    assert done[50].done
    assert_clean(eng)

    def drained(side):
        eng = side.engine(slots=2, cache_len=CACHE_LEN)
        for u in range(4):
            eng.submit(side.req(u, uid=u, max_new=20))
        return eng, {r.uid: r for r in eng.drain(max_steps=2)}

    eng2, out = twin(drained, ref, port)
    assert len(out) == 4 and any(r.failed or r.shed for r in out.values())
    assert_clean(eng2)


def test_mid_flight_fault_then_fresh_workload(sides):
    """After a contained fault the same engine serves a fresh workload with
    clean outputs."""
    ref, port = sides

    def scenario(side):
        faulty = side.mod.FaultyRetrieval(side.pipe, seed=5, fault_rate=1.0,
                                          fault_types=("force",), fails_per_row=1)
        eng = side.engine(faulty, slots=2, cache_len=CACHE_LEN, prefetch=True, max_retries=0)
        eng.submit(side.req(0, uid=0))
        out = {r.uid: r for r in eng.run_to_completion()}
        eng.submit(side.req(0, uid=1))  # the row healed (fails_per_row=1)
        out.update({r.uid: r for r in eng.run_to_completion()})
        return eng, out

    eng, done = twin(scenario, ref, port)
    assert done[0].done and done[0].degraded
    assert done[1].done and not done[1].degraded and done[1].retrieved_nodes.size > 0
    assert_clean(eng)


def test_abort_mid_launch_continuous_wave(sides):
    """abort() while continuous-admission waves sit between launch and
    collect: every layer reconciles and the engine serves afterwards."""
    ref, port = sides

    def scenario(side):
        clock = Clock()
        feat0 = np.asarray(side.g.node_feat[0], np.float32)

        def cost(row):  # row 0 lands at once; every other row never does
            return 0.0 if np.allclose(row, feat0) else np.inf

        delayed = side.mod.DelayedRetrieval(side.pipe, cost_s=0.0, cost_fn=cost,
                                            now_fn=clock.now, sleep_fn=clock.sleep)
        eng = _engine(side, delayed, clock, slots=SLOTS, cache_len=CACHE_LEN, prefetch=True,
                      admission="continuous")
        for u in range(3):
            eng.submit(side.req(u, uid=u))
        eng.step()
        assert int(eng.engine.live.sum()) == 1
        assert eng.prefetcher.in_flight == 2 and eng.cache.inflight_count == 2
        out = {r.uid: r for r in eng.abort(reason="mid-launch abort")}
        assert set(out) == {0, 1, 2} and all(r.failed or r.shed for r in out.values())
        eng.submit(side.req(0, uid=9))
        out.update({r.uid: r for r in eng.run_to_completion()})
        return eng, out

    eng, done = twin(scenario, ref, port)
    assert done[9].done
    assert_clean(eng)


def test_cache_stale_counters(sides):
    """peek_stale counts stale hits and misses and touches neither the
    hit/miss counters nor recency, as the reference's does."""
    ref, port = sides
    emb = np.asarray(port.g.node_feat[0])
    stats = []
    for side, cls in ((ref, ref.mod.CachedRetrieval), (port, port.mod.CachedRetrieval)):
        now = [0.0]
        cache = side.mod.RetrievalCache(capacity=4, ttl=10.0, now_fn=lambda: now[0])
        assert cache.peek_stale(emb) is None
        s = cache.stats()
        assert s["stale_misses"] == 1 and s["stale_hits"] == 0
        entry = cls(nodes=np.arange(4, dtype=np.int32), mask=np.ones(4, bool),
                    dist=np.zeros(4, np.int32), seeds=np.arange(2, dtype=np.int32))
        cache.put(emb, entry)
        assert cache.peek_stale(emb) is entry
        now[0] = 100.0  # expired: invisible to get, served by peek_stale
        assert cache.get(emb) is None and cache.peek_stale(emb) is entry
        s = cache.stats()
        assert s["stale_hits"] == 2 and s["stale_misses"] == 1
        assert s["hits"] == 0 and s["misses"] == 1
        stats.append(s)
    assert all(stats[0][k] == v for k, v in stats[1].items())


# -------------------------------------------------------------- chaos soak ----
_SLOW = pytest.mark.slow
SOAK_CELLS = [pytest.param(p, a, pg, marks=() if (p, a, pg) == (True, "continuous", True)
                           else _SLOW, id=f"{'prefetch' if p else 'sync'}-{a}-"
                                          f"{'paged' if pg else 'contiguous'}")
              for p in (False, True) for a in ("wave", "continuous") for pg in (False, True)]


@pytest.mark.parametrize("prefetch,admission,paged", SOAK_CELLS)
def test_chaos_soak_matrix(sides, prefetch, admission, paged):
    """All four fault types at a 25% rate over a repeat-heavy stream: no
    raise, exactly one terminal state a request, no leak, counters that
    account for every request, the fault-free subset bitwise equal to a
    no-fault run, and the port equal to the reference throughout."""
    ref, port = sides
    n = 14
    q_ids = [u % 7 for u in range(n)]  # repeats: cache hits, dedup, stale

    def run(faults):
        def scenario(side):
            clock = Clock()
            src = _faulty(side, clock, seed=23, fault_rate=0.25) if faults else None
            eng = _engine(side, src, clock, slots=SLOTS, cache_len=CACHE_LEN, prefetch=prefetch,
                          admission=admission, paged_kv=paged, max_retries=1,
                          retrieval_timeout_s=0.05)
            for u, qi in enumerate(q_ids):
                eng.submit(side.req(qi, uid=u, max_new=4))
            done = {r.uid: r for r in eng.drain()}
            if not side.is_ref:
                assert_clean(eng)
            return eng, done
        return twin(scenario, ref, port)

    _, clean = run(False)
    sched = port.mod.FaultyRetrieval(port.pipe, seed=23, fault_rate=0.25)
    bad_q = {qi for qi in set(q_ids)
             if sched.fault_of(np.asarray(port.g.node_feat[qi])) is not None}
    assert bad_q and len(bad_q) < 7
    eng, done = run(True)
    assert set(done) == set(range(n))
    s = eng.stats()
    n_done = sum(r.done and not r.failed for r in done.values())
    assert n_done + s["failed"] + s["shed"] == n and n_done > 0
    for u, qi in enumerate(q_ids):
        r = done[u]
        assert r.done or r.failed or r.shed
        if qi not in bad_q:  # never collateral damage of faulty wave-mates
            assert r.done and not r.failed and not r.degraded and not r.stale
            assert r.out_tokens == clean[u].out_tokens
            np.testing.assert_array_equal(r.retrieved_nodes, clean[u].retrieved_nodes)
