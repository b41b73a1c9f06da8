"""Named host spans of the serving and retrieval path, on the device trace's
clock.

``with span("rgl.<layer>.<what>", totals, args):`` encloses one phase.
While a ``torch.profiler`` records, the span is also a
``torch.profiler.record_function`` range, so it lands in the same kineto
trace as the kernels its code launches: a trace reduction can charge each
kernel to the spans open around the runtime call that launched it, with no
clock conversion.  When no profiler records, the span never touches the
profiler.  Either way it adds its duration to ``totals`` when given (a
:class:`Totals` the owning object exposes as stats counters), timed on the
owner's clock that the totals hold.

A span adds no device synchronisation: it reads the host clock only.

Names are ``rgl.<layer>.<what>`` paths; a child's name extends its
parent's (``rgl.decode.admit`` -> ``rgl.decode.admit.prefill``).  The
spans and what they enclose:

=================================  ===========================================
``rgl.serve.step``                 one ``RAGServeEngine.step``
``rgl.serve.retrieval``            an admission wave's launch (cache lookups,
                                   the dispatch) and its collect's force to
                                   the host; args = the wave's uids
``rgl.serve.tokenize``             linearize and hand-off to the decode engine
``rgl.decode.admit``               ``ServeEngine._admit``; args = the uids
``rgl.decode.admit.prefill``       the batched ``tm.prefill``
``rgl.decode.admit.merge``         the fresh rows' merge into the arena
``rgl.decode.admit.first_token``   the first tokens' copy to the host
``rgl.decode.step``                one decode step
``rgl.decode.step.token_sync``     the step's tokens to the host
``rgl.retrieve``                   ``RGLPipeline.retrieve``
``rgl.retrieve.seeds``             the index search
``rgl.retrieve.subgraph``          subgraph construction
``rgl.retrieve.subgraph.compact``  the compact pass, its overflow check included
``rgl.retrieve.subgraph.rerun``    ``auto``'s dense re-run after an overflow
``rgl.retrieve.subgraph.dense``    a dense pass chosen up front
``rgl.retrieve.filter``            the dynamic filter
=================================  ===========================================
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.autograd.profiler as _autograd_profiler


class Totals:
    """Seconds of the spans that named this object, on its owner's clock
    (``clock()`` in seconds: a virtual clock in tests)."""

    __slots__ = ("clock", "seconds")

    def __init__(self, clock: Callable[[], float]):
        self.clock = clock
        self.seconds = 0.0


class span:
    """Context manager of one named span (see the module's docstring).

    ``args`` is a string, or a callable returning one, that the profiler's
    range carries (request uids); a callable runs only while a profiler
    records."""

    __slots__ = ("name", "totals", "args", "_t0", "_range")

    def __init__(self, name: str, totals: Totals | None = None, args=None):
        self.name, self.totals, self.args = name, totals, args
        self._range = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            args = self.args() if callable(self.args) else self.args
            self._range = torch.profiler.record_function(self.name, args)
            self._range.__enter__()
        if self.totals is not None:
            self._t0 = self.totals.clock()
        return self

    def __exit__(self, *exc):
        if self.totals is not None:
            self.totals.seconds += self.totals.clock() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


def uids(reqs) -> Callable[[], str]:
    """``args`` naming the requests' uids, built only when a profiler
    records."""
    return lambda: "uids=" + ",".join(str(r.uid) for r in reqs)
