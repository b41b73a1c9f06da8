"""Multi-replica serving front end: health-aware routing + replica failover.

One :class:`~repro_torch.serving.rag_engine.RAGServeEngine` — however
fault-tolerant — is one fault domain and one arena's worth of throughput.
:class:`ReplicaRouter` fans requests across N engine replicas and makes
**replica failure a first-class, survived event**:

* **Health-aware routing** — each step the router reads every replica's
  :meth:`~repro_torch.serving.rag_engine.RAGServeEngine.health` snapshot and
  scores the *delta* of its fault counters (retries + timeouts +
  retrieval failures + failed requests) over a sliding window of steps.  A
  replica whose faults are climbing trips a per-replica circuit breaker:

  - ``closed``    — normal rotation; new requests routed by least load.
  - ``open``      — no new dispatches; in-flight work keeps draining.
    After ``cooldown_steps`` the breaker moves to half-open.
  - ``half_open`` — at most one outstanding *probe* request.  A probe that
    completes cleanly (done, not degraded/stale/failed) closes the
    breaker; any fresh fault while half-open re-opens it.

* **Crash containment + failover** — a replica whose ``step()`` raises is
  marked crashed.  The router calls ``abort()`` on it (host-side
  reconciliation still works on a wedged replica: slots retired, paged KV
  blocks freed, in-flight cache keys released so no survivor ever defers
  to a dead wave) and — with ``failover=True`` (default) — **re-dispatches
  the crashed replica's un-finished requests onto survivors**.  Retrieval
  is cached/deterministic and greedy decode is schedule-invariant, so a
  re-dispatched request produces bitwise-identical output to the run it
  lost (asserted in ``tests/test_torch_router.py``).  ``failover=False`` is the
  naive baseline: the crashed replica's requests are delivered ``failed``
  (stranded).  A crashed replica is re-probed every ``cooldown_steps`` (one
  ``step()`` attempt); a flapping replica that heals rejoins through the
  half-open path.

* **Front-door shedding** — ``max_pending`` bounds the *router* queue with
  the same ``reject`` / ``evict-oldest`` policies as the per-engine
  admission control, and expired deadlines are shed before dispatch, so
  overload is refused at the fleet edge before it costs any replica work.

* **Shared retrieval tier** — every replica should be constructed with the
  same :class:`~repro_torch.serving.cache.RetrievalCache` instance.  The cache's
  in-flight key registry then gives the fleet single-flight semantics: a
  query dispatched by one replica is never re-dispatched by another — the
  later request defers to the owner's wave across the replica boundary
  (see :mod:`repro_torch.serving.cache` / :mod:`repro_torch.serving.prefetch`).

Delivery contract: every submitted request reaches **exactly one** terminal
state through :meth:`step`'s return (done / failed / shed), no matter which
replicas crash when — the chaos soak asserts exactly-once accounting and
zero leaked slots / blocks / cache keys across the whole fleet.

The router is single-threaded and steps replicas round-robin.  Replicas on
one card share one set of weight tensors (pass the same ``params`` to each
engine); each keeps only its own KV arena.  A replica fault is an
exception out of ``step()``; a CUDA error (:func:`device_error`) is not a
replica fault and raises, since every replica on the card shares the
failed context.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

from repro_torch.serving.prefetch import device_error
from repro_torch.serving.rag_engine import RAGRequest


@dataclasses.dataclass
class _ReplicaState:
    """Router-side bookkeeping around one replica engine."""

    engine: object  # RAGServeEngine (or a FaultyReplica wrapping one)
    name: str
    circuit: str = "closed"  # closed | open | half_open
    crashed: bool = False
    opened_at: int = 0  # router step the circuit opened / replica crashed
    window: deque = dataclasses.field(default_factory=deque)  # fault deltas
    last_faults: int = 0  # cumulative fault score at last health read
    assigned: dict = dataclasses.field(default_factory=dict)  # uid -> req
    probe_uid: Optional[int] = None  # outstanding half-open probe
    # counters
    dispatched: int = 0
    delivered: int = 0
    crashes: int = 0
    trips: int = 0  # closed -> open transitions

    @property
    def load(self) -> int:
        return len(self.assigned)

    def fault_delta_sum(self) -> int:
        return sum(self.window)


class ReplicaRouter:
    """Fan requests across N ``RAGServeEngine`` replicas; survive replica
    failure.

    Usage::

        cache = RetrievalCache(capacity=512)
        replicas = [RAGServeEngine(pipe, params, cfg, retrieval_cache=cache)
                    for _ in range(3)]
        router = ReplicaRouter(replicas)
        router.submit(RAGRequest(uid=0, query_emb=emb, query_text="..."))
        finished = router.run_to_completion()

    Knobs:

    * ``failover`` — re-dispatch a crashed replica's unfinished requests
      onto survivors (True, default) or deliver them ``failed`` (False,
      the naive baseline).
    * ``max_pending`` / ``shed_policy`` — front-door overload control on
      the router queue (0 = unbounded; ``reject`` refuses the newcomer,
      ``evict-oldest`` sheds the oldest queued request).
    * ``replica_depth`` — max requests outstanding on one replica before
      the router stops routing to it (default ``2 * slots``): bounds how
      much work a crash can strand and keeps the queue at the front door
      where shedding is cheap.
    * ``trip_threshold`` / ``health_window`` — circuit opens when a
      replica accrues >= ``trip_threshold`` fault-counter deltas within
      the last ``health_window`` router steps.
    * ``cooldown_steps`` — steps an open circuit waits before half-open,
      and between revival probes of a crashed replica.
    * ``default_deadline_s`` — deadline applied to requests that carry
      none.  The router pins the *absolute* deadline at submit, so a
      failover re-dispatch never restarts a request's deadline budget.
    """

    def __init__(
        self,
        replicas: list,
        *,
        failover: bool = True,
        max_pending: int = 0,
        shed_policy: str = "reject",
        replica_depth: Optional[int] = None,
        health_window: int = 8,
        trip_threshold: int = 3,
        cooldown_steps: int = 8,
        default_deadline_s: Optional[float] = None,
        now_fn=time.monotonic,
    ):
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        if max_pending < 0:
            raise ValueError(f"max_pending must be >= 0, got {max_pending}")
        if shed_policy not in ("reject", "evict-oldest"):
            raise ValueError(
                f"shed_policy={shed_policy!r}: expected 'reject' or "
                f"'evict-oldest'"
            )
        if health_window < 1:
            raise ValueError(f"health_window must be >= 1, got {health_window}")
        if trip_threshold < 1:
            raise ValueError(
                f"trip_threshold must be >= 1, got {trip_threshold}"
            )
        if cooldown_steps < 1:
            raise ValueError(
                f"cooldown_steps must be >= 1, got {cooldown_steps}"
            )
        self.replicas = [
            _ReplicaState(engine=e, name=f"replica{i}")
            for i, e in enumerate(replicas)
        ]
        for st in self.replicas:
            st.window = deque(maxlen=health_window)
        self.failover = failover
        self.max_pending = max_pending
        self.shed_policy = shed_policy
        self.replica_depth = replica_depth
        self.trip_threshold = trip_threshold
        self.cooldown_steps = cooldown_steps
        self.default_deadline_s = default_deadline_s
        self._now = now_fn
        self.pending: deque = deque()
        self._terminal: list = []  # front-door terminal (shed) requests
        self._delivered_uids: set = set()
        self._step_no = 0
        self._rr = 0  # round-robin tiebreak cursor
        # fleet counters
        self.submitted = 0
        self.shed_count = 0  # front-door sheds (router queue/deadline)
        self.failovers = 0  # crash events that triggered re-dispatch
        self.redispatched = 0  # requests resurrected onto survivors
        self.stranded = 0  # crashed-replica requests delivered failed
        self.duplicate_deliveries = 0  # exactly-once violations (bug tripwire)

    # -- capacity -------------------------------------------------------------
    def _depth(self, st: _ReplicaState) -> int:
        if self.replica_depth is not None:
            return self.replica_depth
        return 2 * st.engine.slots

    def _routable(self, st: _ReplicaState) -> bool:
        """May NEW work be routed to this replica right now?"""
        if st.crashed or st.circuit == "open":
            return False
        if st.circuit == "half_open":
            # one probe at a time: the breaker closes on its clean finish
            return st.probe_uid is None
        return st.load < self._depth(st)

    # -- front door -----------------------------------------------------------
    def _shed(self, req: RAGRequest, reason: str) -> None:
        req.shed = True
        req.error = reason
        self.shed_count += 1
        self._terminal.append(req)

    def submit(self, req: RAGRequest) -> bool:
        """Validate and enqueue at the front door.  Returns False when
        overload control sheds the request on arrival (it is still handed
        back by the next :meth:`step`).  Malformed requests raise
        ``ValueError`` and never enter the system."""
        self.replicas[0].engine._validate(req)
        self.submitted += 1
        # pin the ABSOLUTE deadline here: replicas must not restart the
        # budget when a failover re-submits the request
        if req.deadline_at is None:
            deadline = req.deadline_s if req.deadline_s is not None \
                else self.default_deadline_s
            if deadline is not None:
                req.deadline_at = self._now() + float(deadline)
        req.deadline_s = None
        if self.max_pending and len(self.pending) >= self.max_pending:
            if self.shed_policy == "reject":
                self._shed(req, "router queue full (shed_policy=reject)")
                return False
            victim = self.pending.popleft()
            self._shed(victim, "router queue full (shed_policy=evict-oldest)")
        self.pending.append(req)
        return True

    def _expired(self, req: RAGRequest) -> bool:
        return req.deadline_at is not None and self._now() > req.deadline_at

    # -- health scoring / circuit breaker -------------------------------------
    @staticmethod
    def _fault_score(h: dict) -> int:
        """Cumulative badness from the replica's own counters: every retry,
        timeout, exhausted retrieval, and failed request counts one."""
        return (h["retries"] + h["timeouts"] + h["retrieval_failures"]
                + h["failed"])

    def _update_health(self, st: _ReplicaState) -> None:
        if st.crashed:
            return
        h = st.engine.health()
        score = self._fault_score(h)
        delta = score - st.last_faults
        st.last_faults = score
        st.window.append(delta)
        if st.circuit == "closed":
            if st.fault_delta_sum() >= self.trip_threshold:
                st.circuit = "open"
                st.opened_at = self._step_no
                st.trips += 1
        elif st.circuit == "open":
            if self._step_no - st.opened_at >= self.cooldown_steps:
                st.circuit = "half_open"
                st.probe_uid = None
        elif st.circuit == "half_open":
            if delta > 0:
                # the probe (or draining work) faulted: back to open
                st.circuit = "open"
                st.opened_at = self._step_no
                st.probe_uid = None

    def _on_probe_result(self, st: _ReplicaState, req: RAGRequest) -> None:
        if st.circuit != "half_open" or req.uid != st.probe_uid:
            return
        st.probe_uid = None
        if req.done and not (req.failed or req.degraded or req.stale):
            st.circuit = "closed"
            st.window.clear()
        else:
            st.circuit = "open"
            st.opened_at = self._step_no

    # -- crash handling / failover --------------------------------------------
    @staticmethod
    def _reset_for_redispatch(req: RAGRequest) -> None:
        """Strip every per-attempt field so a survivor replica serves the
        request from scratch.  ``deadline_at`` survives on purpose — a
        failover must not extend the request's deadline budget."""
        req.out_tokens = []
        req.prompt_ids = None
        req.retrieved_nodes = None
        req.cache_hit = False
        req.done = req.failed = req.shed = False
        req.stale = req.degraded = req.truncated = False
        req.error = None

    def _handle_crash(self, st: _ReplicaState, exc: Exception) -> None:
        st.crashed = True
        st.circuit = "open"
        st.opened_at = self._step_no
        st.crashes += 1
        st.window.clear()
        st.probe_uid = None
        # host-side reconciliation works even on a wedged replica: slots
        # retired, paged blocks freed, in-flight cache keys released (so no
        # survivor defers to a dead wave), every outstanding request handed
        # back exactly once
        orphans = st.engine.abort(reason=f"{st.name} crashed: {exc}")
        orphan_uids = {r.uid for r in orphans}
        # defensive: anything assigned but not reported by abort() is failed
        for uid, req in list(st.assigned.items()):
            if uid not in orphan_uids and uid not in self._delivered_uids:
                req.failed = True
                req.error = f"{st.name} crashed: lost by abort"
                orphans.append(req)
        st.assigned.clear()
        if self.failover:
            self.failovers += 1
            for req in orphans:
                if self._expired(req):
                    self._reset_for_redispatch(req)
                    self._shed(req, "deadline expired during failover")
                    continue
                self._reset_for_redispatch(req)
                self.pending.appendleft(req)  # oldest work restarts first
                self.redispatched += 1
        else:
            # naive baseline: the crashed replica's requests stay stranded
            self.stranded += len(orphans)
            self._terminal.extend(orphans)

    def _probe_crashed(self, st: _ReplicaState) -> None:
        """Periodic revival attempt: one bare ``step()`` on an (empty,
        aborted) crashed replica.  A flapping replica that healed comes
        back through half-open; a still-dead one just resets the clock."""
        if self._step_no - st.opened_at < self.cooldown_steps:
            return
        try:
            st.engine.step()
        except Exception as exc:
            if device_error(exc):
                raise
            st.opened_at = self._step_no  # still dead, wait another cooldown
            return
        st.crashed = False
        st.circuit = "half_open"
        st.probe_uid = None
        st.last_faults = self._fault_score(st.engine.health())
        st.window.clear()

    # -- dispatch -------------------------------------------------------------
    def _pick_replica(self) -> Optional[_ReplicaState]:
        """Least-loaded routable replica; round-robin breaks ties so equal
        replicas share work instead of piling onto index 0."""
        n = len(self.replicas)
        best = None
        best_key = None
        for off in range(n):
            st = self.replicas[(self._rr + off) % n]
            if not self._routable(st):
                continue
            key = st.load
            if best is None or key < best_key:
                best, best_key = st, key
        return best

    def _dispatch(self) -> None:
        while self.pending:
            req = self.pending[0]
            if self._expired(req):
                self.pending.popleft()
                self._shed(req, "deadline expired before dispatch")
                continue
            st = self._pick_replica()
            if st is None:
                return  # no routable capacity this step; keep queued
            self.pending.popleft()
            st.assigned[req.uid] = req
            st.dispatched += 1
            if st.circuit == "half_open":
                st.probe_uid = req.uid
            self._rr = (self.replicas.index(st) + 1) % len(self.replicas)
            # the replica re-validates cheaply; deadline_s is None so the
            # absolute deadline_at pinned at the front door stands
            st.engine.submit(req)

    # -- stepping -------------------------------------------------------------
    def _deliver(self, st: _ReplicaState, finished: list, out: list) -> None:
        for req in finished:
            st.assigned.pop(req.uid, None)
            st.delivered += 1
            if req.uid in self._delivered_uids:
                # exactly-once tripwire: never hand the caller a duplicate
                self.duplicate_deliveries += 1
                continue
            self._delivered_uids.add(req.uid)
            self._on_probe_result(st, req)
            out.append(req)

    def step(self) -> list:
        """One fleet step: revive/score replicas, dispatch front-door work,
        step every live replica (containing crashes), and hand back every
        request that reached a terminal state.  Never raises for a replica
        fault."""
        out: list = []
        for st in self.replicas:
            if st.crashed:
                self._probe_crashed(st)
        self._dispatch()
        for st in self.replicas:
            if st.crashed:
                continue
            try:
                finished = st.engine.step()
            except Exception as exc:
                if device_error(exc):
                    raise
                self._handle_crash(st, exc)
                continue
            self._deliver(st, finished, out)
            self._update_health(st)
        self._step_no += 1
        if self._terminal:
            for req in self._terminal:
                if req.uid in self._delivered_uids:
                    self.duplicate_deliveries += 1
                    continue
                self._delivered_uids.add(req.uid)
                out.append(req)
            self._terminal.clear()
        return out

    @property
    def outstanding(self) -> int:
        """Requests accepted but not yet delivered: queued at the front
        door, pending terminal hand-back, or assigned out to a replica."""
        return (len(self.pending) + len(self._terminal)
                + sum(st.load for st in self.replicas))

    def _drained(self) -> bool:
        return self.outstanding == 0

    def run_to_completion(self, max_steps: int = 10_000) -> list:
        done = []
        for _ in range(max_steps):
            done.extend(self.step())
            if self._drained():
                return done
        raise RuntimeError(
            f"run_to_completion: work still pending after {max_steps} steps "
            f"({len(self.pending)} queued at the router, "
            f"{sum(st.load for st in self.replicas)} assigned to replicas)"
        )

    def abort(self, reason: str = "aborted") -> list:
        """Fail/shed everything outstanding across the whole fleet and
        reconcile every replica.  Exactly-once delivery still holds: only
        requests not yet handed back are returned."""
        while self.pending:
            self._shed(self.pending.popleft(), f"shed: {reason}")
        out: list = []
        for st in self.replicas:
            try:
                orphans = st.engine.abort(reason=reason)
            except Exception as exc:
                if device_error(exc):
                    raise
                orphans = list(st.assigned.values())
                for r in orphans:
                    r.failed = True
                    r.error = f"{st.name} abort failed: {reason}"
            st.assigned.clear()
            self._deliver(st, orphans, out)
        for req in self._terminal:
            if req.uid not in self._delivered_uids:
                self._delivered_uids.add(req.uid)
                out.append(req)
        self._terminal.clear()
        return out

    def drain(self, max_steps: int = 10_000) -> list:
        """``run_to_completion`` that never raises: leftovers are aborted
        and returned alongside the completed requests."""
        done = []
        for _ in range(max_steps):
            done.extend(self.step())
            if self._drained():
                return done
        done.extend(self.abort(reason=f"drain gave up after {max_steps} steps"))
        return done

    # -- telemetry ------------------------------------------------------------
    def stats(self) -> dict:
        per_replica = []
        for st in self.replicas:
            h = None if st.crashed else st.engine.health()
            per_replica.append({
                "name": st.name,
                "circuit": "crashed" if st.crashed else st.circuit,
                "crashes": st.crashes,
                "trips": st.trips,
                "dispatched": st.dispatched,
                "delivered": st.delivered,
                "assigned": st.load,
                "fault_score": st.last_faults,
                "health": h,
            })
        return {
            "replicas": len(self.replicas),
            "submitted": self.submitted,
            "delivered": len(self._delivered_uids),
            "router_pending": len(self.pending),
            "front_door_shed": self.shed_count,
            "failovers": self.failovers,
            "redispatched": self.redispatched,
            "stranded": self.stranded,
            "duplicate_deliveries": self.duplicate_deliveries,
            "failover": self.failover,
            "per_replica": per_replica,
        }

    def stats_ns(self) -> dict:
        """Namespaced stats (unified serving schema): the router's own
        counters under ``router.*`` — see :mod:`repro_torch.serving.stats`."""
        return {"router": self.stats()}
