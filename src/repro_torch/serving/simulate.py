"""Retrieval-latency and retrieval-fault simulation for the serving stack.

Host code, copied from the reference (``repro_torch.serving.simulate``) so the
port stands alone; the seeded fault schedule is byte for byte the
reference's, so the same embedding faults the same way in both.

A real ``retrieve_many`` on the card overlaps decode through the
prefetcher's side stream, but on a tiny CPU test graph its latency is
microseconds: too small to measure scheduling against.
:class:`DelayedRetrieval` wraps a real pipeline and emulates a configurable
retrieval cost with the blocking semantics of an in-flight device result:

* the ``retrieve_many`` call returns at once (dispatch is cheap),
* forcing a result to host (``np.asarray`` -> ``__array__``) blocks until
  ``cost_s`` seconds after dispatch, and ``is_ready()`` reports whether it
  would still block.

The wrapped pipeline's real tensors are forced to the host at dispatch
(``.cpu().numpy()``; the reference forces with ``np.asarray``) and re-wrapped
as :class:`LazyHostArray` views gated on the simulated deadline.

:class:`FaultyRetrieval` extends the idea to *failure* injection: a seeded
per-row fault schedule (each exact query embedding maps to one fault type
or to "clean") makes every failure mode reproducible on the CPU:

* ``dispatch`` — ``retrieve_many`` raises before returning,
* ``force``    — dispatch succeeds but forcing the result raises (an async
  device error surfacing at the host sync),
* ``stuck``    — the result never becomes ready (``is_ready()`` stays False;
  a force before readiness raises instead of hanging),
* ``corrupt``  — the result lands but carries out-of-range node ids under
  the valid mask.

``fails_per_row`` bounds how many dispatches a faulty row poisons before it
heals (None = permanent).

:class:`FaultyReplica` lifts fault injection to the **replica fault
domain**: it wraps a whole ``RAGServeEngine`` and makes ``step()`` fail on
a seeded step schedule — ``crash`` (raises from ``crash_step`` on),
``flap`` (raises over ``[crash_step, heal_step)``, then works) or ``grey``
(works, each call paying ``slow_s``).  Everything else passes through, so
:class:`repro_torch.serving.router.ReplicaRouter` drives it like a healthy
replica until the schedule fires.  All clocks are injectable
(``now_fn`` / ``sleep_fn``), so tests never sleep on the wall clock.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable, Optional

import numpy as np
import torch


class RetrievalFault(RuntimeError):
    """An injected retrieval failure (see :class:`FaultyRetrieval`)."""


class ReplicaFault(RuntimeError):
    """An injected replica-level failure (see :class:`FaultyReplica`)."""


def _host(a) -> np.ndarray:
    """Force one retrieval field to a host array: a tensor through
    ``.cpu()`` (which waits for the stream it was made on), anything else
    (a simulator's lazy array) through ``np.asarray``."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class LazyHostArray:
    """A host array that pretends to still be computing until ``ready_at``.

    ``np.asarray`` (via ``__array__``) blocks until the deadline passes —
    the same contract as forcing an in-flight device result.  ``events``
    (if given) receives ``(tag, payload)`` tuples at force time, so tests
    can prove *when* the collect-phase block happened relative to decode.

    ``exc`` (if given) is raised at force time instead of returning data —
    the async-device-error-surfacing-at-host-sync failure mode.  An infinite
    ``ready_at`` models a stuck computation: ``is_ready()`` never flips, and
    forcing raises immediately (a real device array would block forever;
    raising keeps an unconfigured-timeout bug loud instead of hung).
    """

    def __init__(self, data: np.ndarray, ready_at: float,
                 sleep: Callable[[float], None] = time.sleep,
                 now: Callable[[], float] = time.perf_counter,
                 events: Optional[list] = None, tag: str = "force",
                 exc: Optional[Exception] = None):
        self._data = np.asarray(data)
        self._ready_at = ready_at
        self._sleep = sleep
        self._now = now
        self._events = events
        self._tag = tag
        self._exc = exc

    def __array__(self, dtype=None, copy=None):
        if np.isinf(self._ready_at):
            raise RetrievalFault(
                "stuck retrieval row forced before ready (configure "
                "retrieval_timeout_s to shed it instead)"
            )
        remaining = self._ready_at - self._now()
        if remaining > 0:
            self._sleep(remaining)
        if self._events is not None:
            self._events.append((self._tag, self._now()))
            self._events = None  # log the first force only
        if self._exc is not None:
            raise self._exc
        a = self._data
        return a.astype(dtype) if dtype is not None else a

    def is_ready(self) -> bool:
        """True once forcing would not block (the contract of the
        prefetcher's landed device results).  This is what lets
        ``AdmissionPrefetcher.ready_index`` skip past a still-computing wave
        in continuous admission."""
        return self._now() >= self._ready_at


@dataclasses.dataclass
class _LazySubgraph:
    """Duck-typed stand-in for ``Subgraph`` whose fields force lazily."""

    nodes: LazyHostArray
    mask: LazyHostArray
    dist: LazyHostArray


class DelayedRetrieval:
    """Pipeline proxy: real retrieval results, simulated device latency.

    Forwards everything to ``inner`` but rewrites ``retrieve_many`` so the
    returned arrays only become forceable ``cost_s`` seconds after dispatch.
    ``events`` receives ``("launch", t)`` per dispatch and ``("force", t)``
    on the first field forced per wave.

    ``cost_fn`` (optional) prices each *row*: it maps one query embedding to
    that row's retrieval cost in seconds, and the wave's deadline is the max
    over its rows — a batched dispatch finishes when its slowest member
    does.  This is the knob that makes wave admission's head-of-line
    blocking measurable: one expensive row holds every wave-mate's
    admission, while continuous (per-request) admission pays it on that
    request alone.  When ``cost_fn`` is None every wave costs ``cost_s``.
    """

    def __init__(self, inner, cost_s: float,
                 events: Optional[list] = None,
                 cost_fn: Optional[Callable[[np.ndarray], float]] = None,
                 now_fn: Callable[[], float] = time.perf_counter,
                 sleep_fn: Callable[[float], None] = time.sleep):
        self.inner = inner
        self.cost_s = cost_s
        self.events = events
        self.cost_fn = cost_fn
        self.now_fn = now_fn
        self.sleep_fn = sleep_fn
        self.dispatches = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def retrieve_many(self, query_embs, *, batch_size=None, encoder=None):
        res = self.inner.retrieve_many(
            query_embs, batch_size=batch_size, encoder=encoder
        )
        sub, seeds, n_valid = res.sub, res.seeds, res.n_valid
        self.dispatches += 1
        now = self.now_fn()
        if self.events is not None:
            self.events.append(("launch", now))
        if self.cost_fn is not None:
            qe = np.asarray(query_embs)
            cost = max((float(self.cost_fn(row)) for row in qe), default=0.0)
        else:
            cost = self.cost_s
        ready_at = now + cost
        # force the real results NOW (the tiny graph's true cost is
        # negligible) and re-wrap as host arrays gated on the deadline
        kw = dict(sleep=self.sleep_fn, now=self.now_fn)
        lazy = _LazySubgraph(
            nodes=LazyHostArray(_host(sub.nodes), ready_at,
                                events=self.events, **kw),
            mask=LazyHostArray(_host(sub.mask), ready_at, **kw),
            dist=LazyHostArray(_host(sub.dist), ready_at, **kw),
        )
        return dataclasses.replace(
            res, sub=lazy,
            seeds=LazyHostArray(_host(seeds), ready_at, **kw),
            n_valid=n_valid,
        )


class FaultyRetrieval:
    """Pipeline proxy with a seeded, per-row, reproducible fault schedule.

    Each exact query embedding deterministically maps (via a keyed hash of
    its float32 bytes + ``seed``) to one of ``fault_types`` with probability
    ``fault_rate``, or to "clean".  The same embedding therefore faults the
    same way in every run, every wave composition, and every admission
    schedule — which is what lets the chaos tests compare a faulted run's
    fault-free subset bitwise against a no-fault run.

    Fault semantics per dispatch (a dispatch is doomed by ANY scheduled
    fault among its rows; per-request isolation is the *retry layer's* job —
    it re-dispatches failed miss-groups one by one, see
    :class:`repro_torch.serving.prefetch.AdmissionPrefetcher`):

    * ``dispatch`` — ``retrieve_many`` raises :class:`RetrievalFault`.
    * ``force``    — arrays return, but forcing them raises.
    * ``stuck``    — arrays never become ready (``is_ready()`` False
      forever); forcing one raises instead of hanging.
    * ``corrupt``  — arrays force fine but the faulty row's node ids are
      rewritten out of range (``>= n_nodes``) under the valid mask.

    ``fails_per_row``: how many dispatches each faulty row poisons before it
    heals (None = permanent).  ``fails_per_row=1`` + retries makes transient
    recovery testable; permanent faults exercise the degradation ladder.
    ``cost_s`` adds the usual simulated latency on clean dispatches.
    """

    FAULT_TYPES = ("dispatch", "force", "stuck", "corrupt")

    def __init__(self, inner, *, seed: int = 0, fault_rate: float = 0.2,
                 cost_s: float = 0.0,
                 fault_types: tuple = FAULT_TYPES,
                 fails_per_row: Optional[int] = None,
                 events: Optional[list] = None,
                 now_fn: Callable[[], float] = time.perf_counter,
                 sleep_fn: Callable[[float], None] = time.sleep):
        if not 0.0 <= fault_rate <= 1.0:
            raise ValueError(f"fault_rate must be in [0, 1], got {fault_rate}")
        unknown = [t for t in fault_types if t not in self.FAULT_TYPES]
        if unknown:
            raise ValueError(
                f"unknown fault types {unknown}; expected from "
                f"{self.FAULT_TYPES}"
            )
        self.inner = inner
        self.seed = int(seed)
        self.fault_rate = float(fault_rate)
        self.cost_s = float(cost_s)
        self.fault_types = tuple(fault_types)
        self.fails_per_row = fails_per_row
        self.events = events
        self.now_fn = now_fn
        self.sleep_fn = sleep_fn
        self.dispatches = 0
        self.injected = {t: 0 for t in self.FAULT_TYPES}
        self._fail_left: dict = {}  # row key -> remaining faulty dispatches

    def __getattr__(self, name):
        return getattr(self.inner, name)

    @staticmethod
    def _row_key(row: np.ndarray) -> bytes:
        return np.ascontiguousarray(
            np.asarray(row, np.float32)
        ).ravel().tobytes()

    def fault_of(self, query_emb) -> Optional[str]:
        """The *scheduled* fault type for this exact embedding (ignoring
        ``fails_per_row`` healing), or None if the row is clean.  Tests use
        this to partition requests into faulty / fault-free subsets."""
        h = hashlib.blake2b(
            self._row_key(query_emb), digest_size=8,
            key=str(self.seed).encode(),
        ).digest()
        rng = np.random.default_rng(int.from_bytes(h, "little"))
        if not self.fault_types or rng.random() >= self.fault_rate:
            return None
        return self.fault_types[int(rng.integers(len(self.fault_types)))]

    def _active_fault(self, row: np.ndarray) -> Optional[str]:
        """Scheduled fault, unless the row has already spent its
        ``fails_per_row`` budget (healed)."""
        ft = self.fault_of(row)
        if ft is None or self.fails_per_row is None:
            return ft
        left = self._fail_left.get(self._row_key(row), self.fails_per_row)
        return ft if left > 0 else None

    def _consume(self, row: np.ndarray, ft: str) -> None:
        self.injected[ft] += 1
        if self.fails_per_row is not None:
            k = self._row_key(row)
            self._fail_left[k] = \
                self._fail_left.get(k, self.fails_per_row) - 1

    def retrieve_many(self, query_embs, *, batch_size=None, encoder=None):
        q = np.asarray(query_embs, np.float32)
        if q.ndim == 1:
            q = q[None]
        self.dispatches += 1
        faults = [(q[i], self._active_fault(q[i])) for i in range(q.shape[0])]
        now = self.now_fn()
        if self.events is not None:
            self.events.append(("launch", now))

        # a dispatch fault kills the call before the inner pipeline runs
        dispatch_rows = [r for r, ft in faults if ft == "dispatch"]
        if dispatch_rows:
            for r in dispatch_rows:
                self._consume(r, "dispatch")
            raise RetrievalFault(
                f"injected dispatch fault ({len(dispatch_rows)} row(s))"
            )

        res = self.inner.retrieve_many(
            q, batch_size=batch_size, encoder=encoder
        )
        sub, seeds, n_valid = res.sub, res.seeds, res.n_valid
        nodes = _host(sub.nodes).copy()
        mask = _host(sub.mask)
        dist = _host(sub.dist)
        seeds_np = _host(seeds)

        corrupt_rows = [i for i, (_, ft) in enumerate(faults)
                        if ft == "corrupt"]
        if corrupt_rows:
            n_nodes = int(self.inner.node_emb.shape[0])
            for i in corrupt_rows:
                # out-of-range ids under the valid mask: exactly what a
                # wrong-shard answer or a memory stomp would hand back
                nodes[i, mask[i]] = n_nodes + 1 + i
                self._consume(q[i], "corrupt")

        ready_at = now + self.cost_s
        exc = None
        stuck_rows = [r for r, ft in faults if ft == "stuck"]
        force_rows = [r for r, ft in faults if ft == "force"]
        if stuck_rows:
            for r in stuck_rows:
                self._consume(r, "stuck")
            ready_at = np.inf  # never ready; a batched result is one unit
        elif force_rows:
            for r in force_rows:
                self._consume(r, "force")
            exc = RetrievalFault(
                f"injected force fault ({len(force_rows)} row(s))"
            )

        kw = dict(sleep=self.sleep_fn, now=self.now_fn)
        lazy = _LazySubgraph(
            nodes=LazyHostArray(nodes, ready_at, events=self.events, exc=exc,
                                **kw),
            mask=LazyHostArray(mask, ready_at, exc=exc, **kw),
            dist=LazyHostArray(dist, ready_at, exc=exc, **kw),
        )
        return dataclasses.replace(
            res, sub=lazy,
            seeds=LazyHostArray(seeds_np, ready_at, exc=exc, **kw),
            n_valid=n_valid,
        )


class FaultyReplica:
    """Replica-level fault domain: a ``RAGServeEngine`` whose ``step()``
    fails on a seeded step schedule (see the module docstring for the three
    modes).  Everything but ``step()`` delegates to the wrapped engine, so a
    router drives this exactly like a healthy replica — and ``abort()`` on a
    crashed replica still works (abort is host-side reconciliation; the
    injected fault only poisons the step path, like a wedged event loop over
    an otherwise reachable process).

    ``steps`` counts every ``step()`` *attempt* (faulting calls included),
    so a ``flap`` replica heals after ``heal_step - crash_step`` failed
    attempts regardless of how often the router probes it.
    """

    MODES = ("crash", "flap", "grey")

    def __init__(self, engine, *, mode: str = "crash", crash_step: int = 0,
                 heal_step: Optional[int] = None, slow_s: float = 0.0,
                 sleep_fn: Callable[[float], None] = time.sleep):
        if mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES}, got {mode!r}")
        if mode == "flap":
            if heal_step is None or heal_step <= crash_step:
                raise ValueError(
                    f"flap needs heal_step > crash_step, got "
                    f"crash_step={crash_step} heal_step={heal_step}"
                )
        elif heal_step is not None:
            raise ValueError(f"heal_step only applies to flap, not {mode!r}")
        self.engine = engine
        self.mode = mode
        self.crash_step = int(crash_step)
        self.heal_step = None if heal_step is None else int(heal_step)
        self.slow_s = float(slow_s)
        self.sleep_fn = sleep_fn
        self.steps = 0  # step() attempts, faulting ones included
        self.faults_injected = 0

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def _faulting(self, at: int) -> bool:
        if self.mode == "grey":
            return False
        if at < self.crash_step:
            return False
        return self.heal_step is None or at < self.heal_step

    def step(self) -> list:
        at = self.steps
        self.steps += 1
        if self._faulting(at):
            self.faults_injected += 1
            raise ReplicaFault(
                f"injected {self.mode} fault at replica step {at}"
            )
        if self.mode == "grey" and self.slow_s > 0 and at >= self.crash_step:
            self.sleep_fn(self.slow_s)  # degraded-but-alive host
        return self.engine.step()
