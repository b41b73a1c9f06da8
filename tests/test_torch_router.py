"""Port multi-replica serving against the reference, case for case with
``tests/test_router.py``: health-aware routing, circuit breaking, crash
failover with bitwise parity, front-door shedding, the shared retrieval
tier's cross-replica single flight and the replica chaos soaks.

Each scenario runs on the reference and on the port (CPU) with the same
graph, queries, weights and virtual clock: per-uid outcomes, every router
counter (failovers, re-dispatches, strandings, sheds) and each replica's
circuit, trips, crashes, dispatch and delivery counts and health snapshot
are held equal.  Nothing sleeps on the wall clock.
"""
import numpy as np
import pytest

from _serving_twins import Clock, make_sides, same_outcomes
from repro_torch.serving import FaultyReplica

CACHE_LEN = 96
SLOTS = 3


@pytest.fixture(scope="module")
def sides():
    return make_sides("fault-t")


def _engine(side, clock, src=None, **kw):
    kw.setdefault("slots", SLOTS)
    kw.setdefault("cache_len", CACHE_LEN)
    kw.setdefault("max_pending", 0)
    kw.setdefault("max_retries", 1)
    kw.setdefault("retrieval_timeout_s", 1.0)
    return side.engine(src, now_fn=clock.now, sleep_fn=clock.sleep, **kw)


def _fleet(side, clock, n, cache=None, **kw):
    cache = cache if cache is not None else side.mod.RetrievalCache(capacity=256)
    return [_engine(side, clock, retrieval_cache=cache, **kw) for _ in range(n)], cache


def _reference(side, reqs):
    """One clean engine with its own cache: the parity oracle."""
    eng = _engine(side, Clock())
    for r in reqs:
        eng.submit(r)
    return {r.uid: r for r in eng.run_to_completion()}


def _assert_fleet_clean(router, cache):
    """No leaked state in any layer of any replica, crashed ones included."""
    assert cache.inflight_count == 0
    assert not router.pending and not router._terminal
    for st in router.replicas:
        eng = st.engine.engine if isinstance(st.engine, FaultyReplica) else st.engine
        assert not st.assigned
        assert eng.prefetcher.in_flight == 0
        assert not eng._inflight and not eng._terminal
        assert not eng.engine.queue and not eng.engine.live.any()
        inner = eng.engine
        if inner.paged_kv:
            assert inner._free_host == inner.pool_blocks - inner.kv_pinned_blocks
            assert int(inner._ntab.sum()) == 0


def _fleet_twin(scenario, ref, port):
    """Run ``scenario(side)`` -> (router, cache, {uid: request}) on both
    sides; hold outcomes, router stats and the shared cache's counters
    equal; check the port's fleet is clean; return the port's result."""
    ra, ca, a = scenario(ref)
    rb, cb, b = scenario(port)
    same_outcomes(a, b)
    sa, sb = ra.stats(), rb.stats()
    assert sa == sb
    for key in ("hits", "misses", "stale_hits", "stale_misses", "inflight", "size"):
        assert ca.stats()[key] == cb.stats()[key], key
    _assert_fleet_clean(rb, cb)
    return rb, cb, b


# ------------------------------------------------------------- validation ----
def test_router_and_faulty_replica_validation(sides):
    _, port = sides
    mod = port.mod
    eng = _engine(port, Clock())
    with pytest.raises(ValueError, match="at least one replica"):
        mod.ReplicaRouter([])
    with pytest.raises(ValueError, match="shed_policy"):
        mod.ReplicaRouter([eng], shed_policy="drop-newest")
    with pytest.raises(ValueError, match="max_pending"):
        mod.ReplicaRouter([eng], max_pending=-1)
    with pytest.raises(ValueError, match="trip_threshold"):
        mod.ReplicaRouter([eng], trip_threshold=0)
    with pytest.raises(ValueError, match="mode"):
        mod.FaultyReplica(eng, mode="gremlin")
    with pytest.raises(ValueError, match="heal_step"):
        mod.FaultyReplica(eng, mode="flap", crash_step=3, heal_step=2)
    with pytest.raises(ValueError, match="heal_step"):
        mod.FaultyReplica(eng, mode="crash", heal_step=5)
    router = mod.ReplicaRouter([eng])
    bad = np.asarray(port.g.node_feat[0]).copy()
    bad[0] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        router.submit(mod.RAGRequest(uid=0, query_emb=bad, query_text="q"))
    assert not router.pending


def test_faulty_replica_modes(sides):
    _, port = sides
    mod = port.mod
    eng = _engine(port, Clock())
    crash = mod.FaultyReplica(eng, mode="crash", crash_step=1)
    assert crash.slots == SLOTS  # delegation
    crash.step()  # step 0: healthy
    with pytest.raises(mod.ReplicaFault, match="crash fault at replica step 1"):
        crash.step()
    with pytest.raises(mod.ReplicaFault):
        crash.step()  # permanent
    assert crash.steps == 3 and crash.faults_injected == 2
    flap = mod.FaultyReplica(eng, mode="flap", crash_step=0, heal_step=2)
    for _ in range(2):
        with pytest.raises(mod.ReplicaFault):
            flap.step()
    flap.step()  # healed
    assert flap.faults_injected == 2
    clock = Clock()
    grey = mod.FaultyReplica(eng, mode="grey", slow_s=0.5, sleep_fn=clock.sleep)
    grey.step()
    assert clock.t == 0.5 and grey.faults_injected == 0


# ------------------------------------------------------- routing & parity ----
def test_load_balanced_routing_matches_single_replica_bitwise(sides):
    """A healthy 3-replica fleet spreads load and matches one clean engine."""
    ref, port = sides
    n = 9

    def scenario(side):
        clock = Clock()
        replicas, cache = _fleet(side, clock, 3)
        router = side.mod.ReplicaRouter(replicas, now_fn=clock.now)
        for u in range(n):
            router.submit(side.req(u % 6, uid=u))
        return router, cache, {r.uid: r for r in router.run_to_completion()}

    router, _, done = _fleet_twin(scenario, ref, port)
    want = _reference(port, [port.req(u % 6, uid=u) for u in range(n)])
    assert set(done) == set(range(n))
    for u in range(n):
        assert done[u].done and not done[u].failed
        assert done[u].out_tokens == want[u].out_tokens
        np.testing.assert_array_equal(done[u].retrieved_nodes, want[u].retrieved_nodes)
    s = router.stats()
    assert s["duplicate_deliveries"] == 0 and s["failovers"] == 0
    assert all(r["dispatched"] > 0 for r in s["per_replica"])


def test_crash_failover_redispatches_bitwise(sides):
    """A replica crashes mid-run: its requests are re-dispatched onto the
    survivors and complete bitwise equal to a clean single-replica run."""
    ref, port = sides
    n = 9

    def scenario(side):
        clock = Clock()
        replicas, cache = _fleet(side, clock, 3)
        replicas[1] = side.mod.FaultyReplica(replicas[1], mode="crash", crash_step=2)
        router = side.mod.ReplicaRouter(replicas, cooldown_steps=50, now_fn=clock.now)
        for u in range(n):
            router.submit(side.req(u % 6, uid=u, max_new=12))
        return router, cache, {r.uid: r for r in router.run_to_completion()}

    router, _, done = _fleet_twin(scenario, ref, port)
    want = _reference(port, [port.req(u % 6, uid=u, max_new=12) for u in range(n)])
    assert set(done) == set(range(n))
    for u in range(n):
        assert done[u].done and not done[u].failed, done[u].error
        assert done[u].out_tokens == want[u].out_tokens
        np.testing.assert_array_equal(done[u].retrieved_nodes, want[u].retrieved_nodes)
    s = router.stats()
    assert s["failovers"] == 1 and s["redispatched"] > 0
    assert s["stranded"] == 0 and s["duplicate_deliveries"] == 0
    assert s["per_replica"][1]["circuit"] == "crashed" and s["per_replica"][1]["crashes"] == 1


def test_naive_router_strands_crashed_replicas_requests(sides):
    """failover=False delivers the crashed replica's requests failed."""
    ref, port = sides
    n = 9

    def scenario(side):
        clock = Clock()
        replicas, cache = _fleet(side, clock, 3)
        replicas[1] = side.mod.FaultyReplica(replicas[1], mode="crash", crash_step=2)
        router = side.mod.ReplicaRouter(replicas, failover=False, cooldown_steps=50,
                                        now_fn=clock.now)
        for u in range(n):
            router.submit(side.req(u % 6, uid=u, max_new=12))
        return router, cache, {r.uid: r for r in router.run_to_completion()}

    router, _, done = _fleet_twin(scenario, ref, port)
    assert set(done) == set(range(n))
    stranded = [r for r in done.values() if r.failed]
    served = [r for r in done.values() if r.done]
    assert stranded and len(stranded) == router.stats()["stranded"]
    assert all("crashed" in r.error for r in stranded)
    assert len(served) + len(stranded) == n
    assert router.stats()["redispatched"] == 0


def test_flapping_replica_heals_and_rejoins_through_half_open(sides):
    """A flapping replica crashes, is probed back, passes a half-open probe
    and re-closes its circuit."""
    ref, port = sides

    def scenario(side):
        clock = Clock()
        replicas, cache = _fleet(side, clock, 2)
        replicas[1] = side.mod.FaultyReplica(replicas[1], mode="flap", crash_step=1, heal_step=4)
        router = side.mod.ReplicaRouter(replicas, cooldown_steps=2, now_fn=clock.now)
        for u in range(6):
            router.submit(side.req(u % 4, uid=u))
        done = {r.uid: r for r in router.run_to_completion()}
        assert set(done) == set(range(6)) and all(r.done for r in done.values())
        assert router.stats()["failovers"] == 1
        for u in range(10, 18):  # the healed replica is back in rotation
            router.submit(side.req(u % 4, uid=u))
        done.update({r.uid: r for r in router.run_to_completion()})
        return router, cache, done

    router, _, done = _fleet_twin(scenario, ref, port)
    assert set(done) == set(range(6)) | set(range(10, 18))
    assert all(r.done for r in done.values())
    s = router.stats()
    assert s["per_replica"][1]["circuit"] == "closed"
    assert s["per_replica"][1]["delivered"] > 0 and s["duplicate_deliveries"] == 0


def test_grey_replica_trips_circuit_and_traffic_routes_around(sides):
    """A degraded-but-alive replica trips its breaker; later traffic goes to
    the healthy replica only."""
    ref, port = sides
    first = {}

    def scenario(side):
        clock = Clock()
        cache = side.mod.RetrievalCache(capacity=256)
        healthy = _engine(side, clock, retrieval_cache=cache)
        sick_pipe = side.mod.FaultyRetrieval(side.pipe, seed=0, fault_rate=1.0,
                                             fault_types=("dispatch",), now_fn=clock.now,
                                             sleep_fn=clock.sleep)
        sick = _engine(side, clock, sick_pipe, retrieval_cache=cache, max_retries=0,
                       degraded_mode=True)
        grey = side.mod.FaultyReplica(sick, mode="grey", slow_s=0.0, sleep_fn=clock.sleep)
        router = side.mod.ReplicaRouter([healthy, grey], trip_threshold=2, cooldown_steps=500,
                                        now_fn=clock.now)
        for u in range(4):
            router.submit(side.req(u, uid=u))
        done = {r.uid: r for r in router.run_to_completion()}
        assert len(done) == 4 and all(r.done for r in done.values())
        s = router.stats()
        assert s["per_replica"][1]["circuit"] == "open" and s["per_replica"][1]["trips"] == 1
        first[side.is_ref] = s["per_replica"][1]["dispatched"]
        for u in range(10, 16):  # post-trip traffic bypasses the grey replica
            router.submit(side.req(u % 6, uid=u))
        done2 = {r.uid: r for r in router.run_to_completion()}
        assert all(r.done and not r.degraded for r in done2.values())
        return router, cache, {**done, **done2}

    router, _, _ = _fleet_twin(scenario, ref, port)
    assert first[False] == first[True] > 0
    s2 = router.stats()
    assert s2["per_replica"][1]["dispatched"] == first[False]
    assert s2["per_replica"][1]["circuit"] == "open"


# --------------------------------------------------------- front-door shed ----
def test_front_door_shed_reject_and_evict_oldest(sides):
    ref, port = sides

    def reject(side):
        clock = Clock()
        replicas, cache = _fleet(side, clock, 1)
        router = side.mod.ReplicaRouter(replicas, max_pending=2, shed_policy="reject",
                                        now_fn=clock.now)
        assert router.submit(side.req(0, uid=0)) and router.submit(side.req(1, uid=1))
        assert not router.submit(side.req(2, uid=2))
        return router, cache, {r.uid: r for r in router.run_to_completion()}

    router, _, done = _fleet_twin(reject, ref, port)
    assert done[0].done and done[1].done
    assert done[2].shed and "reject" in done[2].error
    assert router.stats()["front_door_shed"] == 1

    def evict(side):
        clock = Clock()
        replicas, cache = _fleet(side, clock, 1)
        router = side.mod.ReplicaRouter(replicas, max_pending=2, shed_policy="evict-oldest",
                                        now_fn=clock.now)
        for u in range(3):
            router.submit(side.req(u, uid=u))
        return router, cache, {r.uid: r for r in router.run_to_completion()}

    _, _, done2 = _fleet_twin(evict, ref, port)
    assert done2[0].shed and "evict-oldest" in done2[0].error
    assert done2[1].done and done2[2].done


def test_router_deadline_pinned_across_failover(sides):
    """A failover re-dispatch keeps the absolute deadline pinned at the
    front door; an expired orphan is shed, not re-served."""
    ref, port = sides

    def scenario(side):
        clock = Clock()
        replicas, cache = _fleet(side, clock, 2)
        replicas[1] = side.mod.FaultyReplica(replicas[1], mode="crash", crash_step=1)
        router = side.mod.ReplicaRouter(replicas, cooldown_steps=50, now_fn=clock.now)
        router.submit(side.req(0, uid=0, max_new=12, deadline_s=5.0))
        router.submit(side.req(1, uid=1, max_new=12, deadline_s=5.0))
        assert all(r.deadline_at == 5.0 for r in router.pending)
        done = {r.uid: r for r in router.step()}  # dispatch; replica 1 dies
        clock.t = 6.0  # past both deadlines
        done.update({r.uid: r for r in router.drain()})
        return router, cache, done

    _, _, done = _fleet_twin(scenario, ref, port)
    assert set(done) == {0, 1}
    for r in done.values():
        assert r.done or (r.shed and "deadline" in r.error)
        if r.shed:
            assert r.deadline_at == 5.0
    assert any(r.shed for r in done.values())


# ----------------------------------------------- shared retrieval tier -------
def test_shared_cache_single_flight_across_replicas(sides):
    """The same query sent to two replicas dispatches ONE retrieval for the
    fleet: the second replica defers to the first's in-flight wave through
    the shared cache and resolves as a hit."""
    ref, port = sides
    dispatches = {}

    def scenario(side):
        clock = Clock()
        delayed = side.mod.DelayedRetrieval(side.pipe, cost_s=0.01, now_fn=clock.now,
                                            sleep_fn=clock.sleep)
        cache = side.mod.RetrievalCache(capacity=256)
        replicas = [_engine(side, clock, delayed, retrieval_cache=cache, prefetch=True,
                            admission="wave") for _ in range(2)]
        router = side.mod.ReplicaRouter(replicas, now_fn=clock.now)
        # warm-up: one request a replica so both arenas are busy
        router.submit(side.req(1, uid=10))
        router.submit(side.req(2, uid=11))
        router.step()
        assert delayed.dispatches == 2
        router.submit(side.req(0, uid=0))  # the contended query, one copy each
        router.submit(side.req(0, uid=1))
        done = {r.uid: r for r in router.run_to_completion()}
        dispatches[side.is_ref] = delayed.dispatches
        return router, cache, done

    _, cache, done = _fleet_twin(scenario, ref, port)
    assert set(done) == {0, 1, 10, 11} and all(r.done for r in done.values())
    assert dispatches[False] == dispatches[True] == 3  # query 0 dispatched once
    assert done[0].out_tokens == done[1].out_tokens
    assert sorted([done[0].cache_hit, done[1].cache_hit]) == [False, True]
    assert cache.stats()["hits"] >= 1


# ------------------------------------------------------------- chaos soak ----
def test_replica_chaos_soak_small(sides):
    """Crash + flap in one 3-replica fleet over a repeat-heavy stream:
    exactly one terminal a request, no leak, and every request bitwise
    equal to a clean single-replica run."""
    ref, port = sides
    n = 15

    def scenario(side):
        clock = Clock()
        replicas, cache = _fleet(side, clock, 3)
        replicas[1] = side.mod.FaultyReplica(replicas[1], mode="crash", crash_step=3)
        replicas[2] = side.mod.FaultyReplica(replicas[2], mode="flap", crash_step=2, heal_step=6)
        router = side.mod.ReplicaRouter(replicas, cooldown_steps=2, now_fn=clock.now)
        for u in range(n):
            router.submit(side.req(u % 5, uid=u))
        return router, cache, {r.uid: r for r in router.drain()}

    router, _, done = _fleet_twin(scenario, ref, port)
    want = _reference(port, [port.req(u % 5, uid=u) for u in range(n)])
    assert set(done) == set(range(n))
    s = router.stats()
    assert s["duplicate_deliveries"] == 0 and s["failovers"] >= 2
    for u in range(n):
        assert done[u].done and not done[u].failed, done[u].error
        assert done[u].out_tokens == want[u].out_tokens
        np.testing.assert_array_equal(done[u].retrieved_nodes, want[u].retrieved_nodes)


@pytest.mark.parametrize("paged", [False, True])
def test_replica_chaos_soak_with_retrieval_faults(sides, paged):
    """Replica crashes and flaps on top of a 25% seeded retrieval fault
    schedule, shared cache, failover on: exactly one terminal a request,
    accounting that closes, no leak, and the fault-free subset bitwise
    equal to a no-fault run."""
    ref, port = sides
    n = 24
    q_ids = [u % 8 for u in range(n)]

    def scenario(side):
        clock = Clock()
        faulty = side.mod.FaultyRetrieval(side.pipe, seed=23, fault_rate=0.25, now_fn=clock.now,
                                          sleep_fn=clock.sleep)
        cache = side.mod.RetrievalCache(capacity=256)
        replicas = [_engine(side, clock, faulty, retrieval_cache=cache, paged_kv=paged,
                            retrieval_timeout_s=0.05) for _ in range(3)]
        replicas[1] = side.mod.FaultyReplica(replicas[1], mode="crash", crash_step=4)
        replicas[2] = side.mod.FaultyReplica(replicas[2], mode="flap", crash_step=3, heal_step=8)
        router = side.mod.ReplicaRouter(replicas, cooldown_steps=2, now_fn=clock.now)
        for u, qi in enumerate(q_ids):
            router.submit(side.req(qi, uid=u))
        return router, cache, {r.uid: r for r in router.drain()}

    router, _, done = _fleet_twin(scenario, ref, port)
    want = _reference(port, [port.req(qi, uid=u) for u, qi in enumerate(q_ids)])
    sched = port.mod.FaultyRetrieval(port.pipe, seed=23, fault_rate=0.25)
    bad_q = {qi for qi in set(q_ids)
             if sched.fault_of(np.asarray(port.g.node_feat[qi])) is not None}
    assert bad_q and len(bad_q) < 8
    assert set(done) == set(range(n))
    assert router.stats()["duplicate_deliveries"] == 0
    n_done = sum(r.done and not r.failed for r in done.values())
    n_failed = sum(bool(r.failed) for r in done.values())
    n_shed = sum(bool(r.shed) for r in done.values())
    assert n_done + n_failed + n_shed == n and n_done > 0
    for u, qi in enumerate(q_ids):
        r = done[u]
        if qi not in bad_q and r.done and not r.degraded and not r.stale:
            assert r.out_tokens == want[u].out_tokens
            np.testing.assert_array_equal(r.retrieved_nodes, want[u].retrieved_nodes)


# ---------------------------------------------------------------- launcher ----
def test_launcher_fleet_and_fault_flags(capsys, monkeypatch):
    """``launch.serve --rag --prefetch --fault-rate 0.25 --retries 2
    --replicas 2 --crash-replica 3`` on the CPU prints the reference
    launcher's router, shared-cache and per-replica lines with the same
    counts (retrieval and the step schedule do not depend on the weights,
    which the two launchers draw from different generators)."""
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve

    flags = ["--arch", "starcoder2-3b", "--rag", "--nodes", "300", "--prefetch",
             "--fault-rate", "0.25", "--retries", "2", "--replicas", "2", "--crash-replica", "3"]
    out = serve.main(flags + ["--device", "cpu"])
    port_lines = capsys.readouterr().out.splitlines()
    monkeypatch.setattr("sys.argv", ["serve"] + flags)
    ref_serve.main()
    ref_lines = capsys.readouterr().out.splitlines()
    assert port_lines[0].startswith("[starcoder2-3b] fleet of 2 replicas RAG-served")
    assert port_lines[1:] == ref_lines[1:]
    s = out["router_stats"]
    assert s["failovers"] == 1 and s["redispatched"] > 0 and s["duplicate_deliveries"] == 0
    assert len(out["done"]) == 8 and all(r.done or r.failed or r.shed for r in out["done"])


def test_launcher_single_engine_fault_lines_and_item_13_flags(capsys):
    """One engine with faults and prefetch prints the fault-tolerance and
    prefetch lines; the online-mutation flags (item 13, once stubs) serve:
    ``--mutate-rate`` prints the mutation line, ``--compact-every`` alone
    serves a frozen corpus."""
    from repro_torch.launch import serve

    common = ["--arch", "starcoder2-3b", "--rag", "--nodes", "300", "--device", "cpu"]
    out = serve.main(common + ["--prefetch", "--fault-rate", "0.5", "--retries", "1",
                               "--deadline", "1000"])
    printed = capsys.readouterr().out
    assert "fault tolerance:" in printed and "prefetch:" in printed
    s = out["stats"]
    assert s["prefetch"] and s["retries"] > 0 and s["shed"] == 0
    assert all(r.deadline_at is not None for r in out["done"])
    out = serve.main(common + ["--mutate-rate", "0.2"])
    assert "  mutation: " in capsys.readouterr().out
    assert out["stats"]["mutation_batches"] > 0 and out["engine"].pipeline.mutation_store
    out = serve.main(common + ["--compact-every", "3"])
    assert "mutation:" not in capsys.readouterr().out
    assert out["engine"].compact_every == 3 and out["engine"].pipeline.mutation_store is None
