"""Port async admission prefetch against the reference, case for case with
``tests/test_async_serving.py``: sync/prefetch parity at depth 1 and 2, the
overlap oracle, in-flight dedup and deferral, contained retrieval failures,
admission tickets, ``run_to_completion`` exhaustion and the env knobs.

Each scenario runs on the reference and on the port (CPU) with the same
graph, queries, weights (``params_from_jax``) and virtual clock: per-uid
tokens, node ids, prompts and flags, cache accounting, the overlap step
and token counts and every fault counter are held equal.  Simulated
retrieval latency advances the virtual clock; each decode step of a live
arena advances it by ``DECODE_S``.  Nothing sleeps on the wall clock.
"""
import numpy as np
import pytest
import torch

from _serving_twins import Clock, make_sides, ticking, twin
from repro_torch.serving import prefetch as port_prefetch

CACHE_LEN = 96
SLOTS = 3
DECODE_S = 0.01  # virtual seconds a decode step of a live arena takes


@pytest.fixture(scope="module")
def sides():
    return make_sides("async-t")


def _stream(side):
    """More requests than slots, exact repeats across waves (cache hits),
    duplicates inside one wave (dedup) and mixed generation lengths."""
    q_ids = [0, 1, 2, 0, 3, 3, 4, 1, 5, 0]
    max_new = [4, 6, 4, 5, 4, 4, 6, 4, 4, 5]
    return [side.req(qi, uid=u, max_new=mn) for u, (qi, mn) in enumerate(zip(q_ids, max_new))]


def _run(side, **kw):
    eng = side.engine(slots=SLOTS, cache_len=CACHE_LEN, **kw)
    for r in _stream(side):
        eng.submit(r)
    done = {r.uid: r for r in eng.run_to_completion()}
    assert len(done) == 10 and all(r.done for r in done.values())
    return eng, done


# ------------------------------------------------------------------ parity ----
@pytest.mark.parametrize("depth", [1, 2])
def test_sync_prefetch_parity(sides, depth):
    """The same stream through sync and prefetched admission: identical
    per-request outputs and cache accounting, on both sides and across them."""
    ref, port = sides
    runs = {}
    for prefetch in (False, True):
        kw = dict(prefetch=prefetch, prefetch_depth=depth)
        runs[prefetch] = twin(lambda side: _run(side, **kw), ref, port)
    (sync_eng, sync_done), (pf_eng, pf_done) = runs[False], runs[True]
    for uid in sync_done:
        assert pf_done[uid].out_tokens == sync_done[uid].out_tokens
        np.testing.assert_array_equal(pf_done[uid].retrieved_nodes, sync_done[uid].retrieved_nodes)
        np.testing.assert_array_equal(pf_done[uid].prompt_ids, sync_done[uid].prompt_ids)
        assert pf_done[uid].cache_hit == sync_done[uid].cache_hit
    assert (pf_eng.cache_hits, pf_eng.cache_misses) == (sync_eng.cache_hits, sync_eng.cache_misses)
    assert pf_eng.retrieval_batches == sync_eng.retrieval_batches
    assert pf_eng.retrieved_queries == sync_eng.retrieved_queries
    assert (sync_eng.cache_hits, sync_eng.cache_misses) == (3, 7)
    assert sync_eng.retrieved_queries == 6  # dedup collapsed the dup pair
    s_sync, s_pf = sync_eng.stats(), pf_eng.stats()
    assert s_sync["prefetch_waves"] == 0 and s_sync["overlap_seconds"] == 0.0
    assert s_pf["prefetch_waves"] > 0
    assert s_pf["prefetch"] and not s_sync["prefetch"]
    assert pf_eng.prefetcher.side_stream() is None  # a CPU pipeline has no stream


# ----------------------------------------------------------- overlap oracle ----
def test_overlap_oracle_decode_between_launch_and_collect(sides):
    """With a simulated retrieval latency, decode steps run between a wave's
    launch and its collect and the overlap telemetry sees the window; the
    sync schedule reports zero overlap and blocks for the whole latency."""
    ref, port = sides
    cost = 0.05
    logs = {}

    def prefetched(side):
        clock, events = Clock(), []
        delayed = side.mod.DelayedRetrieval(side.pipe, cost_s=cost, events=events,
                                            now_fn=clock.now, sleep_fn=clock.sleep)
        eng = side.engine(delayed, slots=2, cache_len=CACHE_LEN, prefetch=True,
                          now_fn=clock.now, sleep_fn=clock.sleep)
        ticking(eng, clock, DECODE_S, events)
        for u in range(4):  # 2 waves of 2 distinct queries each
            eng.submit(side.req(u, uid=u, max_new=8))
        done = {r.uid: r for r in eng.run_to_completion()}
        logs[side.is_ref] = events
        return eng, done

    eng, done = twin(prefetched, ref, port)
    assert len(done) == 4
    s = eng.stats()
    assert s["prefetch_waves"] >= 1 and s["overlap_seconds"] > 0.0 and s["overlap_steps"] >= 1
    assert 0.0 < s["hidden_frac"] <= 1.0
    events = logs[False]
    assert [tag for tag, _ in events] == [tag for tag, _ in logs[True]]
    launches = [t for tag, t in events if tag == "launch"]
    forces = [t for tag, t in events if tag == "force"]
    decodes = [t for tag, t in events if tag == "decode"]
    assert len(launches) == len(forces) == 2
    assert any(any(lt < dt < ft for dt in decodes) for lt, ft in zip(launches, forces))

    def sync(side):
        clock = Clock()
        delayed = side.mod.DelayedRetrieval(side.pipe, cost_s=cost, now_fn=clock.now,
                                            sleep_fn=clock.sleep)
        eng = side.engine(delayed, slots=2, cache_len=CACHE_LEN, prefetch=False,
                          now_fn=clock.now, sleep_fn=clock.sleep)
        for u in range(4):
            eng.submit(side.req(u, uid=u, max_new=8))
        return eng, {r.uid: r for r in eng.run_to_completion()}

    eng, _ = twin(sync, ref, port)
    ss = eng.stats()
    assert ss["overlap_seconds"] == 0.0 and ss["prefetch_waves"] == 0
    assert ss["retrieval_seconds"] >= 2 * cost * 0.9


def test_inflight_key_not_redispatched(sides):
    """A query whose key is retrieved but not yet collected defers to the
    in-flight wave instead of dispatching again (depth 2)."""
    ref, port = sides
    dispatches = {}

    def scenario(side):
        clock = Clock()
        delayed = side.mod.DelayedRetrieval(side.pipe, cost_s=0.02, now_fn=clock.now,
                                            sleep_fn=clock.sleep)
        eng = side.engine(delayed, slots=2, cache_len=CACHE_LEN, prefetch=True,
                          prefetch_depth=2, now_fn=clock.now, sleep_fn=clock.sleep)
        ticking(eng, clock, DECODE_S)
        for u, qi in enumerate([0, 1, 0, 2]):  # wave0 = {0, 1}; wave1 = {0 (in flight), 2}
            eng.submit(side.req(qi, uid=u, max_new=4))
        done = {r.uid: r for r in eng.run_to_completion()}
        dispatches[side.is_ref] = delayed.dispatches
        return eng, done

    eng, done = twin(scenario, ref, port)
    assert len(done) == 4
    assert dispatches[False] == dispatches[True] == 2  # wave1 dispatched only query 2
    assert eng.retrieved_queries == 3
    assert (eng.cache_hits, eng.cache_misses) == (1, 3)
    assert done[2].cache_hit and not done[0].cache_hit
    assert done[2].out_tokens == done[0].out_tokens
    np.testing.assert_array_equal(done[2].retrieved_nodes, done[0].retrieved_nodes)
    assert eng.cache.inflight_count == 0


def test_deferred_fallback_when_owner_entry_evicted(sides):
    """The owner wave's entry is evicted before the deferring wave collects
    (capacity 1): the deferred request is served the owner's result, counted
    as a miss as sync would count it, with one dispatch fewer than sync."""
    ref, port = sides

    def run(prefetch):
        def scenario(side):
            eng = side.engine(slots=2, cache_len=CACHE_LEN, cache_capacity=1, prefetch=prefetch,
                              prefetch_depth=2)
            for u, qi in enumerate([0, 1, 0, 2]):
                eng.submit(side.req(qi, uid=u, max_new=4))
            return eng, {r.uid: r for r in eng.run_to_completion()}
        return twin(scenario, ref, port)

    sync_eng, sync_done = run(False)
    pf_eng, pf_done = run(True)
    for uid in sync_done:
        assert pf_done[uid].out_tokens == sync_done[uid].out_tokens
        np.testing.assert_array_equal(pf_done[uid].retrieved_nodes, sync_done[uid].retrieved_nodes)
        assert pf_done[uid].cache_hit == sync_done[uid].cache_hit
    assert pf_eng.cache_hits == sync_eng.cache_hits == 0
    assert pf_eng.cache_misses == sync_eng.cache_misses == 4
    assert not pf_done[2].cache_hit
    assert sync_eng.retrieved_queries == 4 and pf_eng.retrieved_queries == 3
    assert pf_eng.cache.inflight_count == 0


def test_stale_inflight_marker_from_shared_cache_redispatches(sides):
    """An in-flight marker with no owning wave anywhere falls through to a
    normal re-dispatch instead of deferring forever."""
    ref, port = sides

    def scenario(side):
        cache = side.mod.RetrievalCache(capacity=8)
        cache.mark_inflight(cache.key(np.asarray(side.g.node_feat[0])))
        eng = side.engine(slots=2, cache_len=CACHE_LEN, retrieval_cache=cache, prefetch=True)
        eng.submit(side.req(0, uid=0, max_new=4))
        return eng, {r.uid: r for r in eng.run_to_completion()}

    eng, done = twin(scenario, ref, port)
    assert len(done) == 1 and done[0].retrieved_nodes is not None
    assert eng.retrieved_queries == 1


class _BoomArray:
    def __array__(self, dtype=None, copy=None):
        raise RuntimeError("device boom")


class _BoomSub:
    nodes, mask, dist = _BoomArray(), _BoomArray(), _BoomArray()


class _BoomPipe:
    """Its results raise when forced."""

    def __init__(self, inner, result_cls):
        self.inner, self.result_cls = inner, result_cls

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def retrieve_many(self, q, *, batch_size=None, encoder=None):
        return self.result_cls(sub=_BoomSub(), seeds=_BoomArray(), n_valid=int(q.shape[0]))


class _BoomDispatch(_BoomPipe):
    def retrieve_many(self, q, **kw):
        raise RuntimeError("dispatch boom")


def _result_cls(side):
    if side.is_ref:
        from repro.core.pipeline import RetrievalResult
    else:
        from repro_torch.core.pipeline import RetrievalResult
    return RetrievalResult


def test_inflight_keys_released_on_retrieval_failure(sides):
    """A force-time failure is contained (degraded admission instead of a
    raise) and releases the wave's keys; a dispatch-time failure marks
    nothing, and with the degraded rung off fails its request alone."""
    ref, port = sides

    def forced(side):
        eng = side.engine(_BoomPipe(side.pipe, _result_cls(side)), slots=2,
                          cache_len=CACHE_LEN, prefetch=True)
        eng.submit(side.req(0, uid=0, max_new=2))
        return eng, {r.uid: r for r in eng.run_to_completion()}

    eng, done = twin(forced, ref, port)
    assert len(done) == 1 and done[0].done and done[0].degraded
    assert not done[0].failed and len(done[0].out_tokens) == 2
    assert eng.cache.inflight_count == 0 and eng.stats()["retrieval_failures"] == 1

    def dispatched(side):
        eng = side.engine(_BoomDispatch(side.pipe, _result_cls(side)), slots=2,
                          cache_len=CACHE_LEN, prefetch=True, degraded_mode=False)
        eng.submit(side.req(1, uid=1, max_new=2))
        return eng, {r.uid: r for r in eng.run_to_completion()}

    eng2, done2 = twin(dispatched, ref, port)
    assert len(done2) == 1 and done2[1].failed and not done2[1].done
    assert "dispatch boom" in done2[1].error
    assert eng2.cache.inflight_count == 0


def test_device_errors_are_not_data_plane_faults(sides):
    """A CUDA error out of ``retrieve_many`` raises through the prefetcher
    and the engine (no retry, no degradation), unlike the reference's
    data-plane faults."""
    _, port = sides
    accel = getattr(torch, "AcceleratorError", None)
    errors = [RuntimeError("CUDA error: an illegal memory access was encountered")]
    if isinstance(accel, type):
        errors.append(accel.__new__(accel))
    assert all(port_prefetch.device_error(e) for e in errors)
    assert not port_prefetch.device_error(RuntimeError("dispatch boom"))

    class Dead(_BoomPipe):
        def retrieve_many(self, q, **kw):
            raise errors[0]

    eng = port.engine(Dead(port.pipe, None), slots=2, cache_len=CACHE_LEN, prefetch=True,
                      max_retries=2)
    eng.submit(port.req(0, uid=0, max_new=2))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        eng.run_to_completion()
    assert eng.stats()["retries"] == 0 and eng.cache.inflight_count == 0


# -------------------------------------------------------- admission tickets ----
def test_admission_tickets_survive_request_churn(sides):
    """Many short requests through few slots: every completion maps back to
    its RAGRequest through a monotonic ticket."""
    ref, port = sides
    n = 30

    def scenario(side):
        eng = side.engine(slots=2, cache_len=CACHE_LEN)
        seen = {}
        for u in range(n):
            eng.submit(side.req(u % 5, uid=u, max_new=2))
            if u % 3 == 2:  # churn: drain between small bursts
                seen.update({r.uid: r for r in eng.run_to_completion()})
        seen.update({r.uid: r for r in eng.run_to_completion()})
        assert eng._next_ticket == n and not eng._inflight
        return eng, seen

    _, seen = twin(scenario, ref, port)
    assert set(seen) == set(range(n))
    for u in range(5, n):
        assert seen[u].out_tokens == seen[u % 5].out_tokens


def test_inner_requests_carry_distinct_tickets(sides):
    ref, port = sides
    tickets = {}

    def scenario(side):
        eng = side.engine(slots=2, cache_len=CACHE_LEN)
        for u in range(4):
            eng.submit(side.req(u, uid=u, max_new=6))
        eng.step()  # admits the first wave; nothing finishes yet
        tickets[side.is_ref] = [q.ticket for q in list(eng.engine.queue)] + \
            [q.ticket for q in eng.engine.active if q is not None]
        return eng, {r.uid: r for r in eng.run_to_completion()}

    twin(scenario, ref, port)
    assert tickets[False] == tickets[True]
    assert len(tickets[False]) == len(set(tickets[False])) == 2 and min(tickets[False]) >= 0


# ------------------------------------------------- run_to_completion limits ----
def test_serve_engine_run_to_completion_raises_on_exhaustion(sides):
    from repro.serving import Request as RefRequest
    from repro.serving import ServeEngine as RefServeEngine
    from repro_torch.serving import Request, ServeEngine

    ref, port = sides
    outs = []
    for (eng_cls, req_cls), side, kw in (((RefServeEngine, RefRequest), ref, {}),
                                         ((ServeEngine, Request), port, dict(device="cpu"))):
        eng = eng_cls(side.params, side.cfg, slots=1, cache_len=48, **kw)
        eng.submit(req_cls(uid=0, prompt_ids=np.asarray([3, 5], np.int32), max_new_tokens=30))
        with pytest.raises(RuntimeError, match="still pending"):
            eng.run_to_completion(max_steps=3)
        done = eng.run_to_completion()  # a clean drain picks up where it stopped
        assert [r.uid for r in done] == [0]
        assert not eng.queue and not eng.live.any()
        assert eng.run_to_completion() == []
        outs.append(done[0].out_tokens)
    assert outs[0] == outs[1]


def test_rag_engine_run_to_completion_raises_on_exhaustion(sides):
    ref, port = sides
    for prefetch in (False, True):
        def scenario(side):
            eng = side.engine(slots=2, cache_len=CACHE_LEN, prefetch=prefetch)
            for u in range(3):
                eng.submit(side.req(u, uid=u, max_new=20))
            with pytest.raises(RuntimeError, match="still pending"):
                eng.run_to_completion(max_steps=2)
            done = {r.uid: r for r in eng.run_to_completion()}
            assert set(done) == {0, 1, 2} and eng._drained()
            return eng, done
        twin(scenario, ref, port)


# ----------------------------------------------------------- configuration ----
def test_prefetch_env_default_and_override(sides, monkeypatch):
    ref, port = sides

    def make(side, **kw):
        return side.engine(slots=2, cache_len=CACHE_LEN, **kw)

    for side in (ref, port):
        monkeypatch.delenv("RGL_PREFETCH", raising=False)
        assert not make(side).prefetch
        monkeypatch.setenv("RGL_PREFETCH", "1")
        assert make(side).prefetch
        assert not make(side, prefetch=False).prefetch  # explicit beats env
        monkeypatch.setenv("RGL_PREFETCH", "0")
        assert not make(side).prefetch
        assert make(side, prefetch=True).prefetch
        with pytest.raises(ValueError, match="depth"):
            make(side, prefetch=True, prefetch_depth=0)
    monkeypatch.delenv("RGL_PREFETCH")
    for kw, want in ((dict(), 1), (dict(admission="continuous"), 2), (dict(prefetch_depth=3), 3)):
        assert make(port, prefetch=True, **kw).prefetcher.depth == \
            make(ref, prefetch=True, **kw).prefetcher.depth == want


def test_free_slots_backpressure_signal(sides):
    from repro.serving import Request as RefRequest
    from repro.serving import ServeEngine as RefServeEngine
    from repro_torch.serving import Request, ServeEngine

    ref, port = sides
    for (eng_cls, req_cls), side, kw in (((RefServeEngine, RefRequest), ref, {}),
                                         ((ServeEngine, Request), port, dict(device="cpu"))):
        eng = eng_cls(side.params, side.cfg, slots=2, cache_len=48, **kw)
        assert eng.free_slots == 2
        eng.submit(req_cls(uid=0, prompt_ids=np.asarray([3], np.int32), max_new_tokens=4))
        assert eng.free_slots == 1  # queued work claims a future slot
        eng.step()
        assert eng.free_slots == 1  # admitted: one live slot, empty queue
        eng.run_to_completion()
        assert eng.free_slots == 2


def test_prefetcher_keeps_abandoned_landings_until_their_copies_end():
    """Handles whose event has not completed stay referenced after their wave
    is dropped, and leave once it completes (the pinned-buffer rule, here
    with a stand-in event; the card test drives a real one)."""

    class Event:
        done = False

        def query(self):
            return self.done

    ev = Event()
    arrs = tuple(port_prefetch._Landed(torch.zeros(2), ev) for _ in range(4))
    p = port_prefetch.AdmissionPrefetcher(None, None, wave_size=1)
    p._drop(arrs)
    assert p._abandoned == [arrs]
    p._prune_abandoned()
    assert p._abandoned == [arrs]
    ev.done = True
    p._prune_abandoned()
    assert p._abandoned == []
    p._drop(tuple(port_prefetch._Landed(torch.zeros(2)) for _ in range(4)))  # CPU: ready at once
    assert p._abandoned == []


def test_cpu_landing_is_ready_and_forces_to_the_result(sides):
    """A CPU pipeline's wave lands at once: ``is_ready`` is true and the
    force returns the result's values."""
    _, port = sides
    res = port.pipe.retrieve_many(np.asarray(port.g.node_feat[:2]), batch_size=3)
    arrs = port_prefetch._land(res, None)
    assert all(a.is_ready() for a in arrs)
    for a, t in zip(arrs, (res.sub.nodes, res.sub.mask, res.sub.dist, res.seeds)):
        np.testing.assert_array_equal(np.asarray(a), t.numpy())
