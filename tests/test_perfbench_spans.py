"""The benchmark's reading of the program's spans and counters, on the CPU:
``perfbench/lib/spans.py`` against a hand-built kineto event list
(correlation, nesting, idle time, ``unattributed``), ``trace.reduce``'s
numbers with and without the program's ``rgl.`` ranges, and the serve
cells' readers of the program's request and retrieval counters."""
import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench.lib import spans, spec  # noqa: E402
from perfbench.lib import trace as tr  # noqa: E402

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
S = spec.Spec(ROOT)


class Ev:
    """A kineto event as ``trace.reduce`` and ``spans.reduce_spans`` read it."""

    def __init__(self, name, dev, start, dur, corr=0, link=0, annotation=False):
        self._v = (name, dev, start, dur, corr, link, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]

    def is_python_function(self):
        return False


def events(with_spans: bool) -> list:
    """A serve step [0, 100) with a decode step [50, 100) and its token sync
    [90, 100); kernels launched at 10 (in the step), 60 (in decode) and 92
    (a copy in the token sync), and one launched at 120 outside any span,
    whose correlation id an ATen operator inside the step also carries."""
    host = [
        Ev("aten::mm", CPU, 5, 10, corr=9),
        Ev("cudaLaunchKernel", CPU, 10, 2, corr=101, link=9),
        Ev("cudaLaunchKernel", CPU, 60, 2, corr=102),
        Ev("cudaMemcpyAsync", CPU, 92, 7, corr=103),
        Ev("aten::add", CPU, 55, 3, corr=104),
        Ev("cuLaunchKernel", CPU, 120, 2, corr=104),
        Ev("pb.engine_step", CPU, 0, 130, annotation=True),
    ]
    dev = [
        Ev("gemm_kernel", CUDA, 20, 20, corr=101, link=9),
        Ev("decode_kernel", CUDA, 70, 10, corr=102),
        Ev("Memcpy DtoH", CUDA, 96, 3, corr=103),
        Ev("late_kernel", CUDA, 125, 5, corr=104),
        Ev("pb.engine_step", CUDA, 20, 110, annotation=True),
    ]
    rgl = [
        Ev("rgl.serve.step", CPU, 0, 100, annotation=True),
        Ev("rgl.decode.step", CPU, 50, 50, annotation=True),
        Ev("rgl.decode.step.token_sync", CPU, 90, 10, annotation=True),
        Ev("rgl.serve.step", CUDA, 20, 79, annotation=True),
        Ev("rgl.decode.step", CUDA, 70, 29, annotation=True),
    ]
    return host + dev + (rgl if with_spans else [])


def test_spans_sum_to_the_hand_built_list():
    sp = spans.reduce_spans(events(True))
    assert set(sp) == {"rgl.serve.step", "rgl.decode.step", "rgl.decode.step.token_sync",
                       "unattributed"}
    assert sp["rgl.serve.step"] == pytest.approx({"count": 1, "wall_s": 100e-9,
                                                  "device_s": 33e-9, "idle_s": 67e-9})
    assert sp["rgl.decode.step"] == pytest.approx({"count": 1, "wall_s": 50e-9,
                                                   "device_s": 13e-9, "idle_s": 37e-9})
    assert sp["rgl.decode.step.token_sync"] == pytest.approx({"count": 1, "wall_s": 10e-9,
                                                              "device_s": 3e-9, "idle_s": 7e-9})
    # matched by its runtime call, not by the ATen operator that shares its id
    assert sp["unattributed"] == {"count": 1, "device_s": 5e-9}


def test_spans_of_repeated_and_unmatched_ranges():
    ev = [Ev("rgl.retrieve", CPU, 0, 10), Ev("rgl.retrieve", CPU, 20, 10),
          Ev("cudaLaunchKernel", CPU, 1, 1, corr=1), Ev("cudaLaunchKernel", CPU, 21, 1, corr=2),
          Ev("k", CUDA, 5, 10, corr=1), Ev("k", CUDA, 25, 2, corr=2),
          Ev("k", CUDA, 40, 2, corr=3)]  # its launch is not in the trace
    sp = spans.reduce_spans(ev)
    assert sp["rgl.retrieve"] == pytest.approx({"count": 2, "wall_s": 20e-9, "device_s": 12e-9,
                                                "idle_s": 13e-9})
    assert sp["unattributed"] == {"count": 1, "device_s": 2e-9}
    assert spans.reduce_spans([])["unattributed"] == {"count": 0, "device_s": 0.0}


def test_reduce_keeps_its_numbers_with_the_program_ranges():
    a, b = tr.reduce(events(False), 1.0), tr.reduce(events(True), 1.0)
    for key in ("window_s", "busy_s", "device_ops", "launches", "n_device_events"):
        assert a[key] == b[key], key
    assert a["busy_s"] == 38e-9 and a["n_device_events"] == 4
    # a device-side rgl. annotation is never busy time
    assert "rgl.serve.step" not in b["device_ops"]
    # the same gaps; a gap whose middle no host event but the benchmark's
    # range covered is labelled by the innermost program range instead
    assert a["idle_gaps"] == {"cudaLaunchKernel": 20e-9, "aten::add": 30e-9,
                              "pb.engine_step": 16e-9 + 26e-9}
    assert b["idle_gaps"] == {"cudaLaunchKernel": 20e-9, "aten::add": 30e-9,
                              "rgl.decode.step": 16e-9, "pb.engine_step": 26e-9}
    assert math.isclose(sum(a["idle_gaps"].values()), sum(b["idle_gaps"].values()))


def test_device_events_skip_program_ranges_even_unflagged():
    ev = [Ev("rgl.x", CUDA, 0, 5), Ev("pb.y", CUDA, 0, 5), Ev("k", CUDA, 0, 5, corr=1)]
    assert spans.device_events(ev) == [(0, 5, 1)]


def test_reduce_on_a_recorded_profile_with_and_without_spans():
    from repro_torch.core.indexing import BruteIndex
    from repro_torch.core.pipeline import PipelineConfig, RGLPipeline
    from repro_torch.graph import generators
    from repro_torch.graph.ell import csr_to_ell

    g = generators.citation_graph(150, avg_deg=6, seed=3)
    ell = csr_to_ell(g, device="cpu")
    pipe = RGLPipeline(graph=ell, index=BruteIndex.build(g.node_feat, device="cpu"),
                       node_emb=ell.node_feat, config=PipelineConfig(max_nodes=16),
                       device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.retrieve(np.asarray(g.node_feat[:4]))
    ev = list(prof.profiler.kineto_results.events())
    plain = [e for e in ev if not e.name().startswith("rgl.")]
    assert len(plain) < len(ev)
    assert tr.reduce(ev, 0.5) == tr.reduce(plain, 0.5)
    sp = spans.reduce_spans(ev)
    assert {"rgl.retrieve", "rgl.retrieve.seeds", "rgl.retrieve.subgraph",
            "rgl.retrieve.filter"} <= set(sp)
    assert all(v["device_s"] == 0.0 for v in sp.values())


# --------------------------------------------------------------- readers ----
def serve_rec(stats0: dict, stats1: dict) -> dict:
    return {"kind": "serve", "stats0": stats0, "stats1": stats1}


def req(ttft=(), q=0.0, lat=0.0):
    return {"finished": len(ttft), "queue_seconds": q, "latency_seconds": lat,
            "ttft_s": list(ttft)}


def ret(batches=0, rows=0, valid=0, compact=0, reruns=0):
    return {"batches": batches, "rows": rows, "valid_rows": valid, "compact_runs": compact,
            "dense_reruns": reruns, "overflowed_queries": 0}


@pytest.mark.parametrize("name,rec,want", [
    # the window's 20 (the 30 s before it is not): nearest rank 19 of 1..20 s
    ("ttft_ms_p95.serve", serve_rec({"requests": req([30.0])},
                                    {"requests": req([30.0] + [float(20 - i) for i in range(20)])}),
     19000.0),
    # one request: its own time, unrounded
    ("ttft_ms_p95.serve", serve_rec({"requests": req()}, {"requests": req([17.125])}), 17125.0),
    ("queue_wait_share.serve", serve_rec({"requests": req(q=1.0, lat=2.0)},
                                         {"requests": req(q=4.0, lat=14.0)}), 25.0),
    ("wave_fill_share.serve", serve_rec({"retrieval": ret(rows=256, valid=3)},
                                        {"retrieval": ret(rows=512, valid=8)}), 1.953125),
    # over the batches: a batch that ran dense up front re-ran nothing
    ("dense_rerun_share.serve", serve_rec({"retrieval": ret(batches=1, compact=1, reruns=1)},
                                          {"retrieval": ret(batches=5, compact=3, reruns=3)}),
     50.0),
])
def test_reader_reads_its_counters(name, rec, want):
    assert S.reader(name)(rec) == want


@pytest.mark.parametrize("name", ["ttft_ms_p95.serve", "queue_wait_share.serve",
                                  "wave_fill_share.serve", "dense_rerun_share.serve"])
def test_reader_is_silent_without_its_counters(name):
    read = S.reader(name)
    old = {"cache": {"hits": 1, "misses": 1}, "decode": {}}  # the program before its counters
    assert read(serve_rec(old, old)) is None
    assert read({"kind": "retrieve", "trace": None, "batches": []}) is None
    empty = {"requests": req(), "retrieval": ret()}
    assert read(serve_rec(empty, empty)) is None


def test_ttft_is_silent_where_the_window_outran_the_kept_times():
    ring = dict(req([1.0, 2.0]), finished=5)  # 5 served, the newest 2 kept
    assert S.reader("ttft_ms_p95.serve")(serve_rec({"requests": req()},
                                                   {"requests": ring})) is None


SPAN_METRICS = {"serve": ("retrieval_device_ms_per_wave.serve",
                          "prefill_device_ms_per_wave.serve", "decode_idle_share.serve"),
                "retrieve": ("compact_wasted_share.retrieve",
                             "subgraph_device_ms_per_batch.retrieve")}


def load_trace_spans():
    path = ROOT / "perfbench" / "trace_spans.py"
    mod_spec = importlib.util.spec_from_file_location("perfbench_trace_spans", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def test_the_tool_reads_the_unlisted_readers():
    ts = load_trace_spans()
    assert ts.unlisted(S) == sorted([m for ms in SPAN_METRICS.values() for m in ms]
                                    + ["ttft_ms_p95.serve", "queue_wait_share.serve"])


def test_span_readings_of_the_tool():
    ts = load_trace_spans()
    sp = {"rgl.retrieve": {"count": 4, "wall_s": 1.0, "device_s": 0.8, "idle_s": 0.2},
          "rgl.decode.admit.prefill": {"count": 2, "wall_s": 1.0, "device_s": 1.2, "idle_s": 0},
          "rgl.decode.step": {"count": 5, "wall_s": 0.5, "device_s": 0.1, "idle_s": 0.2}}
    rq = {"requests": req([2.0, 1.0], q=1.0, lat=4.0)}
    serve = {"kind": "serve", "trace": {"spans": sp}, "stats0": {"requests": req()},
             "stats1": rq}
    assert ts.readings(S, serve) == pytest.approx({
        "retrieval_device_ms_per_wave.serve": 200.0, "prefill_device_ms_per_wave.serve": 600.0,
        "decode_idle_share.serve": 40.0, "ttft_ms_p95.serve": 2000.0,
        "queue_wait_share.serve": 25.0})
    sp = {"rgl.retrieve": {"count": 10, "wall_s": 3.0, "device_s": 2.0, "idle_s": 0.3},
          "rgl.retrieve.subgraph": {"count": 10, "wall_s": 2.9, "device_s": 1.9, "idle_s": 0.3},
          "rgl.retrieve.subgraph.compact": {"count": 10, "wall_s": 2.8, "device_s": 1.6,
                                            "idle_s": 0.3},
          "rgl.retrieve.subgraph.rerun": {"count": 5, "wall_s": 0.1, "device_s": 0.3,
                                          "idle_s": 0.0}}
    retrieve = {"kind": "retrieve", "trace": {"spans": sp}}
    assert ts.readings(S, retrieve) == pytest.approx({
        "compact_wasted_share.retrieve": 40.0, "subgraph_device_ms_per_batch.retrieve": 190.0})
    # no re-run: nothing was thrown away
    del sp["rgl.retrieve.subgraph.rerun"]
    assert ts.readings(S, retrieve)["compact_wasted_share.retrieve"] == 0.0
    assert ts.readings(S, {"kind": "retrieve", "trace": None}) == {}


def test_the_tools_reduction_adds_spans_alone():
    ts = load_trace_spans()
    ev = [Ev("rgl.retrieve", CPU, 0, 100), Ev("cudaLaunchKernel", CPU, 10, 5, corr=7),
          Ev("k", CUDA, 20, 30, corr=7)]
    assert ts.reduce_with_spans(tr.reduce)(ev, 1e-6) == dict(tr.reduce(ev, 1e-6),
                                                              spans=spans.reduce_spans(ev))


@pytest.mark.parametrize("name", [m for ms in SPAN_METRICS.values() for m in ms])
def test_span_reader_is_silent_without_spans(name):
    """As the benchmark's trace reduction hands them over today: no spans."""
    read = S.reader(name)
    kind = "retrieve" if name.endswith(".retrieve") else "serve"
    trace = {"window_s": 1.0, "busy_s": 0.5, "device_ops": {}, "launches": {},
             "idle_gaps": {}, "n_device_events": 3}
    assert read({"kind": kind, "trace": trace}) is None
    assert read({"kind": kind, "trace": None}) is None
    assert read({"kind": kind, "trace": dict(trace, spans={"unattributed": {}})}) is None
