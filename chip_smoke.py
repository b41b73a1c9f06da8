#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

1. card: the card's name and power limit (``nvidia-smi``); fails without CUDA;
2. build: compile the hand-written kernels (``src/repro_torch/csrc``);
3. kernels: each kernel against its plain PyTorch version on the card, at the
   main path's shapes (the 169,343-node Arxiv-scale graph, D = 128, K = 1016,
   a 2048-slot workset; ``topk_sim`` also at Q = 64, k = 32) and on edge
   cases, with times of the kernel, the plain version and one library call
   (CUDA events over back-to-back calls, ``time_ms``; the profiler's sum
   beside them as ``profiler_ms``), and the least time the card could take
   (``bound_ms``); the two scan kernels' launch plans on their own lines;
4. strategies: one Q = 4 wave of each of bfs, dense, steiner and ppr on the
   same graph through the compact and the dense backend; rows that did not
   overflow must agree exactly;
4b. naive oracle: 16 seeded queries of 4 seeds per strategy through the
   batched retrieval on the card (bfs 3 hops, dense 2, steiner 4, at most
   32 nodes; ppr 24 nodes, 8 iterations) against the pure-Python baselines
   of ``repro_torch.core.naive`` on the host (the first 16, 16, 4 and 2
   queries; steiner and ppr were 8 and 4 until phase 12 needed the time):
   bfs lists equal, ppr's top-12 sets equal up to float ties, steiner and
   dense by their properties; both sides' seconds printed;
5. main path: ``repro_torch.launch.serve._serve_rag`` serves 8 distinct
   requests plus 4 repeats through ``RAGServeEngine`` with the full-width,
   full-depth StarCoder2-3B config in bf16 (random weights from a seed), the
   brute index and the reference's default ``retrieval="auto"`` (compact
   workset BFS, and a dense re-run of any wave with an overflowing query),
   counting each kernel's launches; then a few decode steps and one
   retrieval wave (auto, compact alone, dense alone) are timed and profiled,
   and small fp32 runs check the card's outputs against the CPU's exactly
   (serving in auto and compact mode, every strategy in both backends);
5b. paged KV: the same mix and weights through the paged arena with prefix
   sharing (16-token blocks, the default 1,024-block pool): wave admission
   (tokens equal the contiguous serve's, the 4 repeats share), continuous
   admission, int8 KV (pool bytes against bf16's) and a pool that decode
   growth exhausts (truncations after pin reclaims); each run's launches
   asserted, its allocator checked after the drain, its decode profiled;
   then reduced fp32 paged serves (share + continuous, int8, a small pool)
   on the card against the CPU, allocator state and pin counters included;
5c. speculative decode: the same mix and weights at ``draft_window`` 4
   over the contiguous arena, the paged arena with prefix sharing, and
   paged + share with int8 KV, each run's tokens compared with the
   one-token serve of the same arena (bf16: agreement reported; each uid
   that differs shows its first divergent step and the one-token serve's
   logit margins there, and must be a near-tie), launches asserted, decode
   profiled; then the reduced fp32 gate: spec tokens equal one-token tokens
   on the card exactly, and the card equals the CPU (contiguous, paged +
   share, paged + share + int8 under continuous admission);
5d. (after the prefetch, fault, router and mutation phases) Granite-MoE:
   Granite-3.0-1B-A400M's ``model_cfg`` at full width and depth (bf16,
   random weights from a seed, the tokenizer's vocabulary) serves the same
   mix over the same graph and pipeline contiguous, paged + prefix sharing
   and speculative (``draft_window`` 4), the retrieval launches asserted
   as above; paged and spec tokens are reported as agreement with the
   contiguous serve, each divergence a bf16 near-tie or after a verify
   window that dropped one of its slot's pairs; each serve's decode
   profiled and its MoE device time split (router, grouped products,
   dispatch + SwiGLU + combine) beside the weight bound; the first prefill
   wave's dropped pairs; ``RGLPipeline.run`` ending in the LM generator on
   one wave; token mode (``_serve_tokens``) at the full vocabulary;
6. ell_spmm: the ``ell_aggregate`` op driven at the regime of the TPU
   kernel it replaces (Q = 64, M = 1024, K = 32 and Q = 32, M = 256, K = 16,
   D = 128; its launches counted), and the kernel against its plain version
   there and on edge cases (D = 48 and 200, M = 1000, K = 1, M = 3000 with
   16-column slabs, M = 5000 and 8000 with the l2 variant, sentinel
   and out-of-range ids with the mask set, all-masked rows, bf16, features
   not 16-byte aligned), bit for bit; the slab widths timed against each
   other and the narrower slabs against the l2 variant, the slab kernel's
   registers (no spills allowed) and its plans on lines of their own;
7. indexes: the IVF index (64 clusters, nprobe 4) built twice on the card
   from the 169,343-node graph's features (the builds must match bit for
   bit); the ``ivf_scan`` kernel against both plain arms on that index's
   candidates (Q = 4, k = 3 and Q = 64, k = 32) and on edge cases, bit for
   bit; brute, IVF, sharded (S = 4) and sharded IVF (S = 4) searches timed
   with their launch counts asserted, sharded brute ids equal to brute ids,
   IVF recall against brute; the main path again with ``index="ivf"`` (the
   same weights; ``ivf_scan`` once per wave); IVF and sharded IVF built on
   the CPU searched on the card against the CPU, kmeans on both devices from
   the same initial centroids, and a reduced IVF serve on both devices;
8. flash attention: the forward kernel and the two backward kernels (bf16
   at dh 128: all three on the tensor cores) against their plain versions
   at the training shape (B = 1, S = 4096, 24/2 heads, dh = 128, window
   4096, bf16), timed beside the plain version and
   ``scaled_dot_product_attention``, with each kernel's registers, spills
   (none allowed), shared memory and blocks per SM, and the forward's head
   group;
9. training: three steps of ``make_train_step`` + ``TrainLoop`` on the
   full-width, full-depth StarCoder2-3B config (bf16, vocab 49152, remat)
   at S = 4096, global batch 2 as 2 micro-batches, AdamW as the reference
   launcher sets it; every step profiled, the flash launch counts asserted
   (2 * L * n_micro forwards, L * n_micro of each backward kernel); then a
   1024-token prefill through the forward kernel against the plain
   attention, one 2-layer full-width step with the kernels against the
   plain version, and three reduced fp32 steps on the card against the CPU;
10. Granite-MoE again: the three flash kernels at its shape (16/8 heads,
   dh 64, no window) as in 8, two training steps as in 9 (96 forward and
   48 of each backward launch a step), a token-mode serve of DeepSeek-7B
   at full width and depth (4 requests x 8 tokens), and the MoE gate:
   Granite's reduced fp32 config on the card against the CPU (tokens of
   contiguous, paged + share and spec serves, the router's kept pairs,
   three training losses);
11. the GNN zoo and Wide & Deep (fp32, published width and depth through
   ``effective_model_cfg``, weights from a seed): two profiled (three
   until phase 13 needed the time)
   ``make_train_step`` + ``TrainLoop`` steps each of MeshGraphNet (15 x
   128), GraphCast (16 x 512, n_vars 608) and GIN (5 x 64) on the
   ``minibatch_lg`` cell's concrete inputs (169,984 nodes x 608 features,
   180,224 edges), EquiformerV2 (12 x 128, l_max 6, m_max 2) on 128
   molecule graphs joined by ``batch_graphs`` (16,384 padded edges, the
   32 x 64 Wigner LUT) and Wide & Deep (40 fields x 1M rows x 32) at batch
   65,536; each a ``gnn_run`` / ``recsys_run`` line (losses, wall ms, device
   ms split GEMM / gather-scatter / optimizer / other, peak GB); Wide &
   Deep's forward at batch 512 and 262,144 timed, and ``retrieval_scores``
   at Q 1 x N 1M x D 256, k 100 through the ``topk_sim`` kernel (its
   launch counted, its record ``topk_sim_retrieval_cand``); then the five
   reduced fp32 configs on the card against the CPU (``zoo_cross_device``)
   and a ``zoo_phase`` summary;
12. (after the Granite phase, over the main path's graph, ELL and brute
   index) the RAG-LM trainer of ``examples/torch_train_rag_lm.py`` at its
   card size (``100m``: 12 x 768, bf16, 105 M parameters; batch 8 x 192 as
   2 micro-batches): 20 batches (40 until phase 13 needed the time) of
   ``rag_token_stream`` precomputed and
   timed (one ``auto`` retrieval wave each, with the ``topk_sim``,
   ``ws_mark`` and ``bfs_frontier`` launches asserted against the waves and
   their dense re-runs), 20 steps of ``make_train_step`` + ``TrainLoop``
   with ``AsyncCheckpointer`` (saves at 10 and 20, each save's stall and
   background write timed), the newest checkpoint restored onto the card bit
   for bit, ``run_with_restart`` over the same batches with a failure after
   the first save (one restart, the final step count equal, losses within
   ``rtol`` 1e-2), the torn-save probe (save, one in-place step at once,
   close: the restored leaves equal the pre-update values), and the reduced
   fp32 gate (the ``2m`` config on the example's 1,500-node graph, 3 steps
   on the card and the CPU: batches equal, losses within 1e-5, checkpoints
   crossing both ways bit for bit); one ``rag_lm_run`` line, a
   ``rag_lm_cross_device`` line and a ``rag_lm_phase`` summary.

13. (after phase 11) the card against ``launch.mesh``'s constants (a
   ``mesh_constants`` line: a bf16 matmul at 8192^3 and a 1 GiB copy, each
   as a share of its constant), then the dry run (``launch.dryrun``) on a
   1 x 1 mesh for phase 11's eight cells (Wide & Deep's four, the three
   GNNs at ``minibatch_lg``, EquiformerV2 at ``molecule``): each cell's
   predicted per-device bytes against the card's peak of its first step or
   call above the allocation that stood before its own arguments were
   made (the ratio must lie in [0.8, 1.25]), and its FLOPs over the
   measured device ms as a share of the fp32 peak; one ``dryrun_vs_card``
   line;
14. (after phase 13, over the main path's graph and pipeline) the index
   over the host's cards: ``ShardedIndex`` with S = 4 over every visible
   card, or two mesh positions on the one card where there is one, on the
   serving table (169,343 x 128, Q 4, k 3) and Wide & Deep's
   ``retrieval_cand`` table (1M x 256 fp32, Q 1, k 100), brute and IVF:
   brute ids equal ``BruteIndex``'s, scores and ids bit-equal to the same S
   on one device, S op calls a search, each on its position's card; wall
   and device ms (split by card) beside the one-device index's
   (``sharded_devices`` line); then the main path's mix served once with
   ``index_kind="sharded"`` over those devices, the weights drawn again
   from the main path's seed: tokens equal the brute serve's, uid by uid
   (``sharded_serve`` line).

A ``script_s`` line gives the script's own seconds, and each stretch's
between the main phases (``phases_s``).  Then come
``{"kernels": [...]}`` (one record per kernel), the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import itertools
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
# H100 SXM data-sheet peaks (the roofline the bounds are taken against), from
# the port's one set of constants
from repro_torch.launch.mesh import FP32_FLOPS, INT_OPS  # noqa: E402
from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_BF16 as BF16_TENSOR_FLOPS  # noqa: E402

N_NODES = 169_343  # OGBN-Arxiv's node count
DEV = "cuda"  # the device of the training phases


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps: int = 5, batch: int = 10) -> float:
    """Median over ``reps`` of the CUDA-event time of ``batch`` back-to-back
    calls, per call: the call as a caller sees it, host gaps included."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    samples = []
    for _ in range(reps):
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / batch)
    return statistics.median(samples)


# traced's calls, the traces taken, those that came back empty, and the
# most that came back empty in a row within one call
PROFILER_TRACES = {"traced_calls": 0, "traces": 0, "empty_traces": 0, "most_empty_in_a_row": 0}


def traced(fn, calls: int, traces: int = 8):
    """A ``torch.profiler`` trace of ``calls`` back-to-back calls of ``fn``
    that holds device events.  A trace that comes back without them
    (``torch.profiler`` sometimes records none) is taken again, up to
    ``traces`` times; ``PROFILER_TRACES`` counts them."""
    from torch.profiler import ProfilerActivity, profile

    PROFILER_TRACES["traced_calls"] += 1
    for empty in range(traces):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        PROFILER_TRACES["traces"] += 1
        if kernel_ms_by_name(prof, calls):
            return prof
        PROFILER_TRACES["empty_traces"] += 1
        PROFILER_TRACES["most_empty_in_a_row"] = max(PROFILER_TRACES["most_empty_in_a_row"],
                                                     empty + 1)
    raise RuntimeError(f"the profiler recorded no device time in {traces} traces")


def device_ms(fn, calls: int = 10) -> tuple[float, dict]:
    """Time the card spends running ``fn``'s kernels, per call (the sum of
    their durations in a :func:`traced` trace, host gaps excluded), and
    that time split by kernel name."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    by_name = kernel_ms_by_name(traced(fn, calls), calls)
    return sum(by_name.values()), by_name


def kernel_events(prof) -> list:
    """The kernels' device events of a profiler trace.  The device-side
    spans of ``record_function`` ranges (``optimizer_annotated``,
    ``moe_annotated``) are not kernels and are left out."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not (getattr(e, "is_user_annotation", False) or e.name in ANNOTATIONS)]


def kernel_ms_by_name(prof, per: int) -> dict:
    """Device time of the kernels in a profiler trace, ms per ``per``."""
    by_name: dict = {}
    for e in kernel_events(prof):
        by_name[e.name[:48]] = by_name.get(e.name[:48], 0.0) + e.device_time / 1e3 / per
    return by_name


def bound(n_bytes: float, *work: tuple[float, float]) -> tuple[float, str]:
    """Least time (ms) for moving ``n_bytes`` and doing each ``(operations,
    rate)`` of ``work`` at the card's peaks, and which of the two bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = sum(n / rate for n, rate in work)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def to_device(params: dict, device) -> dict:
    """A copy of a parameter tree (nested dicts, a MoE config's ``moe``
    included) on ``device``."""
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.to(device), params)


# the record_function ranges the profiled phases wrap around package calls
MOE_RANGES = ("moe_ffn", "moe_route", "moe_products")
ANNOTATIONS = MOE_RANGES + ("adamw_update",)


# kernel-name fragments of the port's hand-written kernels in a trace (the
# bfs_frontier pack kernel also zeroes the reach for the bulk hop)
KERNEL_GROUPS = (("frontier_expand", "ws_mark_kernel"), ("bfs_frontier", "frontier_hop_"),
                 ("bfs_frontier", "pack_frontier_kernel"), ("topk_sim", "topk_sim_scan_kernel"),
                 ("ivf_scan", "ivf_scan_kernel"), ("sorts", "ort"), ("sorts", "adix"))


def split_kernels(by_name: dict) -> dict:
    """Device ms of a trace grouped as the port's retrieval kernels,
    PyTorch's sorts and everything else."""
    out: dict = {}
    for name, ms in by_name.items():
        group = next((g for g, frag in KERNEL_GROUPS if frag in name), "other")
        out[group] = out.get(group, 0.0) + ms
    return out


def query_seeds(emb: torch.Tensor, k: int = 3) -> torch.Tensor:
    """The seeds of the main path's first wave: the 4 first query nodes'
    top-k neighbours by embedding, as the brute index finds them."""
    from repro_torch.kernels.topk_sim import ops

    q_nodes = np.random.default_rng(0).choice(emb.shape[0], 8, replace=False)[:4]
    q = emb[torch.from_numpy(q_nodes).to(emb.device)]
    return ops.topk_similarity(q, emb, k, use_kernel=False)[1]


# ---------------------------------------------------------------- kernels ----
def no_sorts(kernels: dict, name: str) -> None:
    """A scan op's trace holds its own kernels and no sort (its merge is a
    hand kernel too)."""
    sorts = [k_ for k_ in kernels if "ort" in k_ or "adix" in k_]
    assert not sorts, f"{name} ran sort kernels: {sorts}"


def check_topk_sim(emb: torch.Tensor, rng: np.random.Generator) -> dict:
    """The kernel (through the op) against its plain version: the serving
    wave (Q = 4, k = 3) and the IVF recall check's brute shape (Q = 64,
    k = 32) on the Arxiv-scale index, and edge cases -- query groups, tiny
    N, k at and past the 256-entry lists (the tree merge), ties across block
    boundaries and in the last block, the plain-load variant.  Times at both
    shapes, registers and spills."""
    from repro_torch.core.indexing import l2_normalize
    from repro_torch.kernels import build
    from repro_torch.kernels.topk_sim import kernel, ops, ref

    dev = emb.device
    k = 3
    n, d = emb.shape
    plans = {}  # the plans the wrapper passed to the C entry point

    def queries(q):
        rows = emb[torch.from_numpy(rng.choice(n, q)).to(dev)]
        noise = torch.from_numpy(rng.standard_normal((q, d)).astype(np.float32)).to(dev)
        return l2_normalize(rows + 0.05 * noise)

    def compare(q, e, kk, name=None, variant=kernel.BULK, neighbours=False):
        """Scores within 1e-5; ids exact in every row whose k-th score is
        clear of the (k+1)-th.  With ``neighbours`` (the cases of k >= 32,
        where two of a row's top k scores often lie within the two sums'
        rounding of each other) such a row must hold the same ids, each at
        the same place wherever its score is clear of both neighbours."""
        s_k, i_k = ops.topk_similarity(q, e, kk, use_kernel=True)
        torch.cuda.synchronize()
        assert kernel.last_plan.variant == variant, (name, kernel.last_plan)
        if name:
            plans[name] = dataclasses.asdict(kernel.last_plan)
        s_p, i_p = ref.topk_similarity(q, e, min(kk + 1, e.shape[0]))
        err = (s_k - s_p[:, :kk]).abs().max().item()
        assert err <= 1e-5, f"topk_sim scores off by {err}"
        clear = (s_p[:, kk - 1] - s_p[:, kk]) > 1e-5 if s_p.shape[1] > kk else \
            torch.ones(q.shape[0], dtype=torch.bool, device=dev)
        got, want = i_k[clear], i_p[clear, :kk]
        if neighbours:
            sw = s_p[clear, :kk]
            gap = torch.minimum(F.pad(sw[:, :-1] - sw[:, 1:], (1, 0), value=1.0),
                                F.pad(sw[:, :-1] - sw[:, 1:], (0, 1), value=1.0))
            fixed = gap > 1e-5
            assert torch.equal(got.sort(1).values, want.sort(1).values), f"{name}: id sets differ"
            assert torch.equal(got[fixed], want[fixed]), f"{name}: ids differ"
        else:
            bad = (got != want).nonzero()[:8].tolist()
            assert not bad, f"{name}: ids differ at {bad}"
        return err

    errs = [compare(queries(q), emb, k, f"q{q}_k3") for q in (1, 4, 5, 9, 64)]
    errs += [compare(queries(64), emb, 32, "q64_k32", neighbours=True),
             compare(queries(2), emb, 256, "q2_k256", neighbours=True),
             compare(queries(2), emb, 300, "q2_k300", neighbours=True)]
    small = emb[:1000]  # N not a multiple of the 64-row tile, under one block's range
    errs.append(compare(queries(5)[:, :d], small, 7, "n1000"))
    errs += [compare(queries(3), emb[:100], 32, "n100_k32", neighbours=True),
             compare(queries(2), emb[:1], 1, "n1"),
             compare(queries(9), emb[:5000], 300, "n5000_k300", neighbours=True)]
    # an emb[:, :3] view (D % 4 != 0) and a table 4 bytes off 16: plain loads
    errs.append(compare(queries(5)[:, :3].contiguous(), emb[:, :3], 7, "d3_view", kernel.PLAIN))
    flat = torch.zeros(n * d + 4, device=dev)
    errs.append(compare(queries(4), flat[1:1 + n * d].view(n, d).copy_(emb), k, "unaligned",
                        kernel.PLAIN))
    del flat
    # duplicate rows: equal scores, ids lowest first, across tiles too
    dup = emb.clone()
    far = n - 343
    dup[[5, 700, far]] = emb[3]
    s_k, i_k = ops.topk_similarity(dup[3:4].clone(), dup, 4, use_kernel=True)
    torch.cuda.synchronize()
    assert i_k[0, :4].tolist() == [3, 5, 700, far], f"tie order {i_k.tolist()}"
    # ... on both sides of block-range boundaries and in the last block
    plan = kernel.launch_plan(1, n, d, 8, dup.data_ptr(), build.sm_count(dev))
    rows_t = kernel.tile_rows(d)
    tiles = -(-n // rows_t)
    cuts = [x * tiles // plan.grid_x * rows_t for x in range(1, plan.grid_x)]
    rows = sorted({3, cuts[0] - 1, cuts[0], cuts[1] - 1, cuts[1], cuts[-1] - 1, cuts[-1], n - 1})
    dup.copy_(emb)
    dup[rows] = emb[3]
    s_k, i_k = ops.topk_similarity(dup[3:4].clone(), dup, 8, use_kernel=True)
    torch.cuda.synchronize()
    assert i_k[0].tolist() == rows, f"tie order across blocks {i_k.tolist()} != {rows}"
    del dup

    log = build.build_log()
    shapes = {}
    for q, kq in ((4, k), (64, 32)):
        qv = queries(q)
        run = lambda: ops.topk_similarity(qv, emb, kq, use_kernel=True)  # noqa: E731
        library = lambda: torch.topk(qv @ emb.T, kq)  # noqa: E731
        profiler_ms, kernels = device_ms(run)
        no_sorts(kernels, "topk_sim")
        b_ms, b_by = bound(4 * (qv.numel() + emb.numel()) + 8 * q * kq,
                           (2 * q * n * d, FP32_FLOPS))
        shapes[q] = {
            "ms": time_ms(run),
            "plain_ms": time_ms(lambda: ops.topk_similarity(qv, emb, kq, use_kernel=False)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": time_ms(library),
            "profiler_ms": profiler_ms, "library_profiler_ms": device_ms(library)[0],
            "device_kernels_ms": kernels, "shape": f"Q={q} N={n} D={d} k={kq}",
            "ptxas": ptxas_report(log, f"topk_sim_scan_kernelILi{kernel.last_plan.qw}ELi0E"),
            "merge_ptxas": ptxas_report(log, "topk_merge_kernel")}
        plans[f"timed_q{q}"] = dataclasses.asdict(kernel.last_plan)
    print(json.dumps({"topk_sim_launch_plans": plans}), flush=True)
    return {"name": "topk_sim", "route": "cuda", "source": "src/repro_torch/csrc/topk_sim.cu",
            "replaces": "src/repro/kernels/topk_sim/kernel.py:80", "max_abs_err": max(errs),
            **shapes[4], "batch_shape": shapes[64]}


def check_bfs_frontier(nbr: torch.Tensor, mask: torch.Tensor, rng: np.random.Generator) -> dict:
    from repro_torch.kernels.bfs_frontier import kernel, ops

    dev = nbr.device
    n, kd = nbr.shape
    rand = torch.from_numpy(rng.random((4, n)) < 1e-3).to(dev)
    front = torch.cat([rand, torch.zeros((1, n), dtype=torch.bool, device=dev),
                       torch.ones((1, n), dtype=torch.bool, device=dev)])
    got = ops.frontier_hop(front, nbr, mask, use_kernel=True)
    torch.cuda.synchronize()
    want = ops.frontier_hop(front, nbr, mask, use_kernel=False)
    assert torch.equal(got, want), "bfs_frontier differs from its plain version"
    plans = {}  # the plans the wrapper passed to the C entry point

    def hold(name, fr, nb, mk, variant):
        out = ops.frontier_hop(fr, nb, mk, use_kernel=True)
        torch.cuda.synchronize()
        assert kernel.last_plan.variant == variant, (name, kernel.last_plan)
        assert torch.equal(out, ops.frontier_hop(fr, nb, mk, use_kernel=False)), name
        plans[name] = dataclasses.asdict(kernel.last_plan)
        return fr

    # at scale: two query groups (Q = 33, 64); the mask 8 and 1 bytes off
    # 16-byte alignment (the row variants); a random non-prefix mask with
    # live sentinel slots (bulk)
    groups = {q: hold(f"q{q}", torch.from_numpy(rng.random((q, n)) < 1e-3).to(dev), nbr, mask,
                      kernel.BULK) for q in (33, 64)}
    flat = torch.zeros(n * kd + 16, dtype=torch.bool, device=dev)
    for off, variant in ((8, kernel.ROWS8), (1, kernel.ROWS)):
        view = flat[off:off + n * kd].view(n, kd)
        view.copy_(mask)
        hold(f"mask_offset_{off}", rand, nbr, view, variant)
    del flat, view
    gen = torch.Generator(device=dev).manual_seed(3)
    rmask = torch.rand((n, kd), generator=gen, device=dev) < 0.008
    rnbr = torch.randint(0, n + 1, (n, kd), generator=gen, device=dev, dtype=torch.int32)
    rnbr[::3, 5] = n
    rmask[::3, 5] = True
    hold("random_mask_live_sentinels", front, rnbr, rmask, kernel.BULK)
    del rmask, rnbr
    # small shapes: odd width (one slot a lane), a last tile 8 bytes past
    # 16 (K = 24, N odd), rows too wide for the ring
    for name, sn, sk, variant in (("k13", 3000, 13, kernel.ROWS), ("tail8", 3001, 24, kernel.BULK),
                                  ("wide_rows", 40, 120_000, kernel.ROWS8)):
        snbr = torch.from_numpy(rng.integers(0, sn + 1, (sn, sk)).astype(np.int32)).to(dev)
        smask = torch.from_numpy(rng.random((sn, sk)) < 0.7).to(dev)
        sfront = torch.from_numpy(rng.random((3, sn)) < 0.05).to(dev)
        hold(name, sfront, snbr, smask, variant)

    f4 = rand
    run = lambda: ops.frontier_hop(f4, nbr, mask, use_kernel=True)  # noqa: E731
    profiler_ms, kernels = device_ms(run)
    plans["main_ell_q4"] = dataclasses.asdict(kernel.last_plan)
    print(json.dumps({"bfs_frontier_launch_plans": plans}), flush=True)
    plain_ms = time_ms(lambda: ops.frontier_hop(f4, nbr, mask, use_kernel=False), reps=3, batch=3)
    # library yardstick: the same hop as one sparse-matrix product, A (N, N)
    # CSR times the (N, Q) frontier; reach = product > 0
    live = mask.nonzero()
    adj = torch.sparse_coo_tensor(
        torch.stack([live[:, 0], nbr[mask].long()]), torch.ones(len(live), device=dev),
        (n, n + 1)).coalesce().to_sparse_csr()
    ff = torch.cat([f4, torch.zeros((4, 1), dtype=torch.bool, device=dev)], 1).T.float().contiguous()
    assert torch.equal((torch.sparse.mm(adj, ff) > 0).T, got[:4])
    library = lambda: torch.sparse.mm(adj, ff)  # noqa: E731
    # bytes the hop must move: every mask byte, the id of every live slot,
    # the frontier in and the reach out
    nnz = len(live)
    b_ms, b_by = bound(n * kd + 4 * nnz + 2 * 4 * n, (4 * nnz, INT_OPS))
    return {"name": "bfs_frontier", "route": "cuda", "source": "src/repro_torch/csrc/bfs_frontier.cu",
            "replaces": "src/repro/kernels/bfs_frontier/kernel.py:49",
            "max_abs_err": 0.0, "ms": time_ms(run), "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": time_ms(library), "profiler_ms": profiler_ms,
            "library_profiler_ms": device_ms(library)[0],
            "device_kernels_ms": kernels, "profiler_split_ms": {  # pack: and reach zeroing
                "pack": sum(v for k_, v in kernels.items() if "pack_frontier" in k_),
                "hop": sum(v for k_, v in kernels.items() if "frontier_hop_" in k_)},
            "q64_ms": time_ms(lambda: ops.frontier_hop(groups[64], nbr, mask, use_kernel=True)),
            "q64_profiler_ms": device_ms(
                lambda: ops.frontier_hop(groups[64], nbr, mask, use_kernel=True))[0],
            "shape": f"Q=4 N={n} K={kd} live_slots={nnz}",
            "full_ell_bound_ms": 1e3 * (5 * n * kd + 8 * n) / HBM_BYTES_PER_S}


def check_frontier_expand(nbr: torch.Tensor, mask: torch.Tensor, seeds: torch.Tensor,
                          rng: np.random.Generator) -> dict:
    """The mark kernel on a real wave: the workset after two hops of the
    main path's seeds, and the third hop's C * K candidates."""
    from repro_torch.core.workset import build_workset
    from repro_torch.kernels.frontier_expand import ops

    dev = nbr.device
    n, kd = nbr.shape
    cap, hops = 2048, 3
    ws = build_workset(nbr, mask, seeds, max_hops=hops - 1, cap=cap, use_kernel=False)
    cand = ops.hop_candidates(ws.ids, nbr, mask)
    got = ops.ws_member(ws.ids, cand, use_kernel=True)
    torch.cuda.synchronize()
    assert torch.equal(got, ops.ws_member(ws.ids, cand, use_kernel=False)), "frontier_expand differs"
    # edge cases: repeats, sentinel and int32-max candidates, C = 1, C not a
    # power of two, a row past 48 KB of shared memory, a ragged W, an
    # unaligned candidate row
    for q, c, w in ((1, 1, 7), (3, 1000, 1001), (2, 20_000, 4099), (4, 2048, 65_536)):
        rows = np.sort(rng.integers(0, 3 * c, (q, c)), axis=1).astype(np.int32)
        rows[:, c // 2:] = 3 * c  # sentinel padding: the pad value 3c, repeated
        wsr = torch.from_numpy(rows).to(dev)
        cd = torch.from_numpy(rng.integers(0, 3 * c + 1, (q, w)).astype(np.int32)).to(dev)
        cd[:, 0] = 3 * c
        cd[:, 1] = torch.iinfo(torch.int32).max
        for x in (cd, cd[:, 1:]):
            assert torch.equal(ops.ws_member(wsr, x, use_kernel=True),
                               ops.ws_member(wsr, x, use_kernel=False)), (q, c, w)
    # the main path's candidates with one lane of a sentinel run changed
    # (to an id of the workset, then to n - 1): a warp's 128 candidates that
    # are all the sentinel but that one
    groups = cand[0, :cand.shape[1] // 128 * 128].view(-1, 128).eq(n).all(1).nonzero().flatten()
    at = int(groups[len(groups) // 2]) * 128 + 37
    for new in (int(ws.ids[0, 0]), n - 1):
        c2 = cand.clone()
        c2[0, at] = new
        assert torch.equal(ops.ws_member(ws.ids, c2, use_kernel=True),
                           ops.ws_member(ws.ids, c2, use_kernel=False)), ("one lane", new)
    del c2
    # a real hop's candidates under a workset row past 48 KB of shared memory
    big = build_workset(nbr, mask, seeds, max_hops=hops - 1, cap=13_000, use_kernel=False)
    bcand = ops.hop_candidates(big.ids, nbr, mask)
    assert torch.equal(ops.ws_member(big.ids, bcand, use_kernel=True),
                       ops.ws_member(big.ids, bcand, use_kernel=False)), "C = 13,000"
    del big, bcand
    # the whole third hop: mark arm (the kernel) against the sort arm, bitwise
    hop = lambda uk: ops.expand_hop(ws.ids, ws.dist, nbr, mask, hops, band=hops + 2,  # noqa: E731
                                    use_kernel=uk)
    mark_out, sort_out = hop(True), hop(False)
    for a, b in zip(mark_out, sort_out):
        assert torch.equal(a, b), "expand_hop's mark arm differs from its sort arm"

    ids, w = ws.ids, cand.shape[1]
    run = lambda: ops.ws_member(ids, cand, use_kernel=True)  # noqa: E731
    profiler_ms, kernels = device_ms(run)

    def library():  # searchsorted, then the gather and compare
        pos = torch.searchsorted(ids, cand)
        return (pos < cap) & (torch.gather(ids, 1, pos.clamp(max=cap - 1)) == cand)

    q = ids.shape[0]
    rounds = max(1, (cap - 1).bit_length()) + 1
    b_ms, b_by = bound(5 * q * w + 4 * q * cap, (4 * rounds * q * w, INT_OPS))
    hop_mark_ms, hop_kernels = device_ms(lambda: hop(True), calls=5)
    hop_sort_ms, _ = device_ms(lambda: hop(False), calls=5)
    live = int((cand < n).sum())
    return {"name": "frontier_expand", "route": "cuda", "source": "src/repro_torch/csrc/frontier_expand.cu",
            "replaces": "src/repro/kernels/frontier_expand/kernel.py:61",
            "max_abs_err": 0.0, "ms": time_ms(run),
            "plain_ms": time_ms(lambda: ops.ws_member(ids, cand, use_kernel=False)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": time_ms(library),
            "profiler_ms": profiler_ms, "library_profiler_ms": device_ms(library)[0],
            "device_kernels_ms": kernels,
            "shape": f"Q={q} C={cap} W={w} (C*K, K={kd}) live_candidates={live}",
            "workset_overflow_after_2_hops": int(ws.overflow.sum()),
            "hop3_dropped": int(mark_out[3].sum()),
            "hop_ms": {"mark_arm": hop_mark_ms, "sort_arm": hop_sort_ms,
                       "mark_arm_split": split_kernels(hop_kernels)}}


# ------------------------------------------------------------- strategies ----
def strategy_phase(ell, seeds: torch.Tensor) -> None:
    """One wave of every strategy through both backends on the full graph;
    rows that did not overflow must agree exactly."""
    from repro_torch.core import graph_retrieval as gr

    for strategy in ("bfs", "dense", "steiner", "ppr"):
        for radius in ((1, 10) if strategy == "ppr" else (1, 3)):
            kw = {"n_iter" if strategy == "ppr" else "max_hops": radius, "max_nodes": 16}
            subs, wall = {}, {}
            for mode in ("compact", "dense"):
                run = lambda: gr.retrieve_subgraph(ell, seeds, strategy, mode=mode, **kw)  # noqa: E731
                subs[mode] = run()
                wall[mode] = time_ms(run, reps=3, batch=1)
            ok = ~subs["compact"].overflow
            for name in ("nodes", "mask", "dist"):
                a, b = getattr(subs["compact"], name), getattr(subs["dense"], name)
                assert torch.equal(a[ok], b[ok]), (strategy, radius, name)
            line = {"strategy": strategy, **kw, "overflow_rows": int((~ok).sum()),
                    "rows_compared": int(ok.sum()), "compact_ms": wall["compact"],
                    "dense_ms": wall["dense"]}
            print(json.dumps({"strategy_wave": line}), flush=True)


# ------------------------------------------------------------ naive oracle ----
# the paper's scaling comparison at its own scale: bfs, dense and steiner at
# the hops and sizes of the reference's retrieval-scaling benchmark, ppr as
# its PPR test runs it; the naive side runs the first NAIVE_QUERIES[s] of
# the 16 queries (steiner and ppr take seconds a query in Python)
NAIVE_KW = {"bfs": dict(max_hops=3, max_nodes=32), "dense": dict(max_hops=2, max_nodes=32),
            "steiner": dict(max_hops=4, max_nodes=32), "ppr": dict(max_nodes=24, n_iter=8)}
NAIVE_QUERIES = {"bfs": 16, "dense": 16, "steiner": 4, "ppr": 2}


def naive_call(adj: dict, strategy: str, seeds: list) -> list:
    from repro_torch.core import naive

    kw = NAIVE_KW[strategy]
    if strategy == "ppr":
        return naive.ppr_subgraph(adj, seeds, kw["max_nodes"], n_iter=kw["n_iter"])
    fn = {"bfs": naive.bfs_subgraph, "dense": naive.dense_subgraph,
          "steiner": naive.steiner_subgraph}[strategy]
    return fn(adj, seeds, kw["max_hops"], kw["max_nodes"])


def connected_within(nodes: set, adj: dict) -> set:
    """The members of ``nodes`` reachable from one of them inside it."""
    start = next(iter(nodes))
    seen, frontier = {start}, [start]
    while frontier:
        nxt = []
        for u in frontier:
            for w in adj[u]:
                if w in nodes and w not in seen:
                    seen.add(w)
                    nxt.append(w)
        frontier = nxt
    return seen


def naive_oracle_phase(card: str, g, ell, n_queries: int = 16) -> dict:
    """The port's batched retrieval on the card (``retrieve_subgraph``,
    ``retrieval_mode="auto"``, 4 queries a call) against the pure-Python
    baselines of ``repro_torch.core.naive`` on the host, on the same graph
    and seeded queries.  Held where the reference's own tests hold them:
    bfs lists equal; ppr's top-12 set equal up to float ties (nodes scored
    above the 12th naive score by more than 1e-9 of it are in both sets, and
    every batched member scores within that of it); steiner keeps the
    terminals and is at most 2x + 4 the naive tree's size; dense keeps the
    seeds and is no sparser than bfs at the same radius less 2 edges.  How
    many steiner outputs connect their terminals is counted, not held: at 4
    hops on a large graph terminals further apart than the Voronoi cells
    reach stay apart, in the reference's batched Steiner (which the port's
    equals on the CPU) and in the naive tree alike.  Times are reported, not
    claimed."""
    from repro_torch.core import graph_retrieval as gr
    from repro_torch.core import naive

    t0 = time.perf_counter()
    adj = g.to_adj_dict()
    adj_s = time.perf_counter() - t0
    seeds = np.random.default_rng(21).integers(0, g.num_nodes, (n_queries, 4)).astype(np.int32)
    chunks = [torch.from_numpy(seeds[i:i + 4]).cuda() for i in range(0, n_queries, 4)]

    def batched(strategy, **kw):
        subs = [gr.retrieve_subgraph(ell, c, strategy, **kw) for c in chunks]
        torch.cuda.synchronize()
        return [[int(v) for v, m in zip(n, k) if m] for s in subs
                for n, k in zip(s.nodes.cpu().tolist(), s.mask.cpu().tolist())]

    lines = {}
    for strategy, kw in NAIVE_KW.items():
        batched(strategy, **kw)  # warm
        t0 = time.perf_counter()
        got = batched(strategy, **kw)
        batched_s = time.perf_counter() - t0
        nq = NAIVE_QUERIES[strategy]
        t0 = time.perf_counter()
        want = [naive_call(adj, strategy, sorted(set(row.tolist()))) for row in seeds[:nq]]
        naive_s = time.perf_counter() - t0
        checks = {}
        if strategy == "bfs":
            assert got[:nq] == want, "batched bfs differs from the naive baseline"
            checks["lists_equal"] = nq
        elif strategy == "ppr":
            exact = 0
            for row, a, b in zip(seeds, got, want):
                p = naive.ppr_scores(adj, sorted(set(row.tolist())), n_iter=kw["n_iter"])
                kth = p[b[min(11, len(b) - 1)]]
                tol = 1e-9 * kth
                must = {u for u in b[:12] if p[u] > kth + tol}
                assert must <= set(a[:12]), ("ppr", row.tolist())
                assert all(p.get(u, 0.0) >= kth - tol for u in a[:12]), ("ppr", row.tolist())
                exact += set(a[:12]) == set(b[:12])
            checks["top12_sets_equal"] = exact
            checks["top12_equal_up_to_ties"] = nq
        elif strategy == "steiner":
            conn = {"batched": 0, "naive": 0}
            for row, a, b in zip(seeds, got, want):
                terminals = set(row.tolist())
                assert terminals <= set(a), ("steiner terminals", row.tolist())
                assert len(a) <= 2 * len(b) + 4, ("steiner size", len(a), len(b))
                conn["batched"] += terminals <= connected_within(set(a), adj)
                conn["naive"] += terminals <= connected_within(set(b), adj)
            checks["terminals_kept"] = nq
            checks["terminals_connected"] = conn
        else:
            bfs_kw = dict(max_hops=kw["max_hops"], max_nodes=kw["max_nodes"])
            ball = batched("bfs", **bfs_kw)

            def internal(nodes):
                members = set(nodes)
                return sum(1 for u in members for w in adj[u] if w in members)

            for row, a, b in zip(seeds, got, ball):
                assert set(row.tolist()) <= set(a), ("dense seeds", row.tolist())
                assert internal(a) >= internal(b) - 2, ("dense density", row.tolist())
            checks["seeds_kept_and_dense"] = n_queries
        lines[strategy] = {**kw, "naive_queries": nq, "naive_s": naive_s,
                           "naive_s_per_query": naive_s / nq, "batched_queries": n_queries,
                           "batched_s": batched_s, "batched_s_per_query": batched_s / n_queries,
                           **checks}
    rec = {"naive_oracle": f"{g.num_nodes} nodes, {n_queries} seeded queries of 4 seeds",
           "card": card, "adj_dict_s": adj_s, "strategies": lines}
    print(json.dumps(rec), flush=True)
    return rec


# -------------------------------------------------------------- main path ----
def serve_args(**kw) -> argparse.Namespace:
    base = dict(requests=12, slots=4, max_new=12, nodes=N_NODES, index="brute", shards=None,
                retrieval="auto", cache_policy="lru", device="cuda")
    base.update(kw)
    return argparse.Namespace(**base)


def serve_counters() -> dict:
    """The launch counters of every kernel a serve can reach."""
    from repro_torch.kernels.bfs_frontier import kernel as bfs_kernel
    from repro_torch.kernels.frontier_expand import kernel as fe_kernel
    from repro_torch.kernels.ivf_scan import kernel as ivf_kernel
    from repro_torch.kernels.topk_sim import kernel as topk_kernel

    return {"topk_sim": topk_kernel.launches, "ivf_scan": ivf_kernel.launches,
            "bfs_frontier": bfs_kernel.launches, "frontier_expand": fe_kernel.launches}


@contextlib.contextmanager
def recorded_overflow():
    """Yields a list to which each compact BFS wave run inside the block
    appends its overflowing rows."""
    from repro_torch.core import graph_retrieval as gr

    overflow_rows: list = []
    compact_bfs = gr.COMPACT_STRATEGIES["bfs"]

    def recording(*a, **kw):
        sub = compact_bfs(*a, **kw)
        overflow_rows.append(int(sub.overflow.sum()))
        return sub

    gr.COMPACT_STRATEGIES["bfs"] = recording
    try:
        yield overflow_rows
    finally:
        gr.COMPACT_STRATEGIES["bfs"] = compact_bfs


def counted_serve(cfg, args: argparse.Namespace, q_ids: np.ndarray, params=None, stack=None,
                  **clock):
    """``_serve_rag`` with every kernel launch counted (counts set to 0 just
    before, read just after) and each compact wave's overflowing rows
    observed; ``stack`` reuses a built graph, pipeline and weights.
    Returns (serve summary, launches, overflowing rows per wave)."""
    from repro_torch.launch.serve import _serve_rag

    counters = serve_counters()
    gc.collect()  # an earlier serve's engine and graph may sit in reference cycles
    with recorded_overflow() as overflow_rows:
        torch.cuda.reset_peak_memory_stats()
        for counter in counters.values():
            counter.reset()
        out = _serve_rag(cfg, args, q_ids=q_ids, params=params, stack=stack, **clock)
        launches = {name: c.count for name, c in counters.items()}
    return out, launches, overflow_rows


def check_serve_launches(out: dict, launches: dict, overflow_rows: list, index: str,
                         mode: str = "auto", topk_waves: int | None = None,
                         shards: int = 1) -> int:
    """The retrieval kernels ran on the serve as ``check_wave_launches``
    says.  Returns the waves that ran dense hops."""
    return check_wave_launches(out["retrieval_batches"], out["engine"].pipeline.config.max_hops,
                               launches, overflow_rows, index, mode, topk_waves, shards)


def check_wave_launches(waves: int, hops: int, launches: dict, overflow_rows: list, index: str,
                        mode: str = "auto", topk_waves: int | None = None,
                        shards: int = 1) -> int:
    """The retrieval kernels ran on ``waves`` waves of ``hops`` hops:
    ``topk_sim`` (brute) or ``ivf_scan`` once a wave (``shards`` times for a
    sharded index), ``frontier_expand`` once a hop of every wave,
    ``bfs_frontier`` once a hop of every dense re-run (under
    ``mode="dense"``: no compact hop, ``bfs_frontier`` once a hop of every
    wave).  ``topk_waves`` is the waves that searched a ``BruteIndex`` where
    not all did (a mutation store's active brute index scans without the
    kernel).  Returns the waves that ran dense hops."""
    if topk_waves is None:
        topk_waves = waves if index == "brute" else 0
    assert launches["topk_sim"] == shards * topk_waves, (launches, waves, topk_waves, shards)
    assert launches["ivf_scan"] == (shards * waves if index == "ivf" else 0), (launches, waves)
    if mode == "dense":
        assert waves > 0 and not overflow_rows, (overflow_rows, waves)
        assert launches["frontier_expand"] == 0, launches
        assert launches["bfs_frontier"] == hops * waves, (launches, waves)
        return waves
    reruns = sum(1 for r in overflow_rows if r > 0)  # waves that re-ran dense
    assert waves > 0 and len(overflow_rows) == waves, (overflow_rows, waves)
    assert launches["frontier_expand"] == hops * waves, (launches, waves)
    assert launches["bfs_frontier"] == hops * reruns, (launches, overflow_rows)
    return reruns


def main_path(cfg, index: str = "brute", params=None):
    """Serve 8 distinct requests plus 4 repeats through the port's entry
    points with ``cfg`` and the ``index`` kind on the card; every kernel
    launch is counted.  ``params`` reuses the weights of an earlier serve.
    Returns (summary, params, per-uid tokens, the serve's graph and pipeline
    stack)."""
    args = serve_args(index=index)
    distinct = np.random.default_rng(0).choice(args.nodes, 8, replace=False)
    q_ids = np.concatenate([distinct, distinct[:4]])
    out, launches, overflow_rows = counted_serve(cfg, args, q_ids, params)
    done, s = out["done"], out["stats"]
    assert len(done) == 12 and all(r.done and not r.failed for r in done), "requests lost or failed"
    vocab = out["cfg"].vocab
    for r in done:
        assert len(r.out_tokens) == args.max_new, (r.uid, len(r.out_tokens))
        assert all(0 <= t < vocab for t in r.out_tokens)
    assert s["hits"] >= 4 and all(r.cache_hit for r in done if r.uid >= 8), s["hits"]
    out["stack"]["served_nodes"] = {r.uid: r.retrieved_nodes for r in done}
    waves = out["retrieval_batches"]
    pipe = out["engine"].pipeline
    print(f"main path ({index} index): {waves} retrieval waves, overflowing rows per wave "
          f"{overflow_rows}, launches {launches}", flush=True)
    reruns = check_serve_launches(out, launches, overflow_rows, index)
    decode_profile = profile_decode(out["engine"].engine) if index == "brute" else None
    # one warm retrieval wave (4 fresh queries) on its own, through auto (and
    # for the brute index compact alone and dense alone): wall time and
    # device time by kernel
    fresh = torch.from_numpy((q_ids[:4] + 1) % args.nodes).to(pipe.device)
    qw = pipe.node_emb[fresh].cpu().numpy()
    retrieval_wave = {}
    for mode in (("auto", "compact", "dense") if index == "brute" else ("auto",)):
        p = dataclasses.replace(pipe, config=dataclasses.replace(pipe.config, retrieval_mode=mode))
        wave = lambda: p.retrieve_many(qw, batch_size=args.slots).nodes.cpu()  # noqa: E731
        ov = p.retrieve_many(qw, batch_size=args.slots).overflow
        wave_dev, wave_kernels = device_ms(wave, calls=3)
        retrieval_wave[mode] = {
            "wall_ms": time_ms(wave, reps=3, batch=2), "device_ms": wave_dev,
            "overflow_rows": None if ov is None else int(ov.sum()),
            "device_ms_split": split_kernels(wave_kernels),
            "top_kernels_ms": dict(sorted(wave_kernels.items(), key=lambda kv: -kv[1])[:6])}
    summary = {"index": index, "launches": launches, "waves": waves,
               "overflow_rows_per_wave": overflow_rows, "dense_reruns": reruns,
               "tok_per_s": out["tok_per_s"], "tokens": out["tokens"], "serve_s": out["serve_s"],
               "setup_s": out["setup_s"], "retrieval_s": out["retrieval_s"],
               "decode_ms_per_step": out["decode_ms_per_step"],
               "decode_steps": s["decode_steps"], "prefill_batches": s["prefill_batches"],
               "admit_s": s["admit_seconds"], "cache_hits": s["hits"],
               "cache_misses": s["misses"], "n_layers": cfg.n_layers,
               "cache_len": out["cache_len"],
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "decode_profile": decode_profile, "retrieval_wave": retrieval_wave}
    return summary, out["params"], {r.uid: r.out_tokens for r in done}, out["stack"]


# ------------------------------------------------------------- paged KV ----
def pool_bytes(cache) -> int:
    """Bytes of the K/V pool with its int8 scales."""
    return sum(t.numel() * t.element_size()
               for t in (cache.k, cache.v, cache.k_scale, cache.v_scale) if t is not None)


def check_allocator(eng) -> None:
    """Drained: the free stack holds every block no cache pin holds, and the
    host mirrors equal the device ``table``, ``free[:n_free]`` and ``ref``."""
    assert not eng.live.any() and not eng.queue
    assert eng._free_host == eng.pool_blocks - eng.kv_pinned_blocks, \
        (eng._free_host, eng.pool_blocks, eng.kv_pinned_blocks)
    depth = len(eng._free_stack)
    assert int(eng.cache.n_free) == depth
    assert eng.cache.free[:depth].cpu().tolist() == eng._free_stack
    assert eng.cache.ref.cpu().tolist() == eng._ref_host.tolist()
    table = eng.cache.table.cpu().numpy()
    for i, blks in enumerate(eng._slot_blocks):
        assert table[i, :len(blks)].tolist() == blks and (table[i, len(blks):] == -1).all()


def token_agreement(a: dict, b: dict) -> dict:
    """Share of uids whose tokens are all equal, and of token positions."""
    pos = sum(len(a[u]) for u in a)
    same = sum(x == y for u in a for x, y in zip(a[u], b[u]))
    return {"uids_equal": sum(a[u] == b[u] for u in a) / len(a), "tokens_equal": same / pos}


def paged_run(card: str, name: str, cfg, params, q_ids, reclaims: list | None = None,
              **kw) -> tuple[dict, dict]:
    """One counted serve of the main path's mix over the paged arena, its
    launch counts asserted, the allocator checked after the drain, and one
    line of numbers printed.  Returns (record, requests by uid)."""
    args = serve_args(paged_kv=True, prefix_share=True, **kw)
    out, launches, overflow_rows = counted_serve(cfg, args, q_ids, params)
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_serve_launches(out, launches, overflow_rows, "brute")
    done, s, eng = out["done"], out["stats"], out["engine"].engine
    assert len(done) == len(q_ids) and all(r.done and not r.failed for r in done), name
    check_allocator(eng)
    rec = {"paged_run": name, "card": card, "admission": s["admission"],
           "kv_quant": cfg.kv_quant, "cache_len": out["cache_len"], "max_new": args.max_new,
           "tok_per_s": out["tok_per_s"], "decode_ms_per_step": out["decode_ms_per_step"],
           "decode_steps": s["decode_steps"], "prefill_batches": s["prefill_batches"],
           "prefill_rows": s["prefill_rows"], "retrieval_batches": s["retrieval_batches"],
           "launches": launches, "peak_mem_gb": peak, "kv_pool_bytes": pool_bytes(eng.cache),
           "truncations": s["truncations"], "truncated": sum(r.truncated for r in done),
           **{k: s[k] for k in ("block_size", "pool_blocks", "pool_high_water_blocks",
                                "pool_free_blocks", "kv_shared_admits", "kv_reused_tokens",
                                "kv_cow_copies", "kv_pins", "kv_releases", "kv_pinned_blocks")}}
    if reclaims is not None:  # reclaim_kv calls: the first one's truncation count, blocks freed
        rec["pin_reclaims"] = {"calls": len(reclaims),
                               "truncations_at_first": reclaims[0]["truncations_before"],
                               "blocks_freed": sum(r["freed"] for r in reclaims)}
    rec["decode_profile"] = profile_decode(eng)
    print(json.dumps(rec), flush=True)
    return rec, {r.uid: r for r in done}


def tokens(done: dict) -> dict:
    return {u: r.out_tokens for u, r in done.items()}


def paged_phase(card: str, cfg, params, contiguous_tokens: dict) -> dict:
    """The main path's mix (8 distinct + 4 repeated queries, 12 new tokens,
    4 slots, the 169,343-node graph, brute index, auto retrieval) through
    the paged arena with prefix sharing, with the main path's weights:

    1. wave admission, the automatic 16-token blocks and the default pool:
       tokens equal the contiguous serve's, the 4 repeats share;
    2. continuous admission: the share of tokens equal to run 1's;
    3. int8 KV: the pool's bytes against run 1's, the share of tokens equal;
    4. a pool that decode growth exhausts (cache_len 128, 24 new tokens: at
       96-token prompts 12 cannot cross a 16-token block boundary, 24
       always do; the pool holds the first wave's admission and no more):
       truncations, pins reclaimed first, and the rest served."""
    from repro_torch.serving import cache as cache_mod

    distinct = np.random.default_rng(0).choice(N_NODES, 8, replace=False)
    q_ids = np.concatenate([distinct, distinct[:4]])
    run1, done1 = paged_run(card, "paged_share_wave", cfg, params, q_ids)
    toks1 = tokens(done1)
    assert toks1 == contiguous_tokens, "paged serve's tokens differ from the contiguous serve's"
    assert run1["kv_shared_admits"] == 4, run1["kv_shared_admits"]
    assert run1["block_size"] == 16 and run1["pool_blocks"] == 1024, run1
    run2, done2 = paged_run(card, "paged_share_continuous", cfg, params, q_ids,
                            admission="continuous")
    assert run2["truncated"] == 0
    run2["agreement_with_wave"] = token_agreement(toks1, tokens(done2))
    run3, done3 = paged_run(card, "paged_share_int8", dataclasses.replace(cfg, kv_quant=True),
                            params, q_ids)
    run3["agreement_with_bf16"] = token_agreement(toks1, tokens(done3))
    run3["pool_bytes_ratio"] = run3["kv_pool_bytes"] / run1["kv_pool_bytes"]
    # int8 rows plus one bf16 scale a row, against rows of cfg.dtype
    want = (1 + 2 / cfg.d_head) / torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    assert abs(run3["pool_bytes_ratio"] - want) < 1e-9, (run3["pool_bytes_ratio"], want)
    # run 4: the pool holds exactly the first wave's admission (uids 0-3)
    pool = max(128 // 16, sum(-(-(len(done1[u].prompt_ids) + 1) // 16) for u in range(4)))
    reclaims: list = []
    reclaim_kv = cache_mod.RetrievalCache.reclaim_kv

    def recording(self, want_blocks, owner=None):
        freed = reclaim_kv(self, want_blocks, owner)
        reclaims.append({"truncations_before": owner.truncations, "want": want_blocks,
                         "freed": freed})
        return freed

    cache_mod.RetrievalCache.reclaim_kv = recording
    try:
        run4, _ = paged_run(card, "paged_share_pool_exhaustion", cfg, params, q_ids, reclaims,
                            cache_len=128, max_new=24, pool_blocks=pool)
    finally:
        cache_mod.RetrievalCache.reclaim_kv = reclaim_kv
    assert run4["truncations"] >= 1 and run4["truncated"] == run4["truncations"], run4
    assert run4["pin_reclaims"]["truncations_at_first"] == 0 and run4["kv_releases"] >= 1
    return {"runs": [run1, run2, run3, run4],
            "tokens": {"share_wave": toks1, "share_int8": tokens(done3)}}


def cross_device_check(reduced_cfg) -> int:
    """The whole main path at a small size on the card (kernels) and on the
    CPU (plain versions), with the same weights, in auto and in compact
    mode with the brute index and in auto mode with the IVF index (each
    device builds its own): retrieved nodes, prompts and tokens must agree.  Then every
    strategy through both backends on the same graph: seeds, nodes, mask,
    dist and overflow flags must agree.  Returns the number of overflowing
    rows the compact runs met."""
    from repro_torch.core.indexing import BruteIndex
    from repro_torch.core.pipeline import PipelineConfig, RGLPipeline
    from repro_torch.graph import generators
    from repro_torch.graph.ell import csr_to_ell
    from repro_torch.launch.serve import _serve_rag

    for retrieval, index in (("auto", "brute"), ("compact", "brute"), ("auto", "ivf")):
        kw = dict(nodes=3000, requests=8, retrieval=retrieval, index=index)
        card = _serve_rag(reduced_cfg, serve_args(**kw))
        params = card["params"]
        host = to_device(params, "cpu")
        cpu = _serve_rag(reduced_cfg, serve_args(device="cpu", **kw), params=host)
        runs = [{r.uid: r for r in out["done"]} for out in (card, cpu)]
        for uid, a in runs[0].items():
            b = runs[1][uid]
            assert np.array_equal(a.retrieved_nodes, b.retrieved_nodes), (retrieval, index, uid)
            assert np.array_equal(a.prompt_ids, b.prompt_ids), (retrieval, index, uid)
            assert a.out_tokens == b.out_tokens, (retrieval, index, uid, a.out_tokens,
                                                  b.out_tokens)
    g = generators.citation_graph(3000, avg_deg=8, seed=0)
    q = g.node_feat[np.random.default_rng(5).choice(3000, 4, replace=False)]
    pipes = []
    for d in ("cuda", "cpu"):
        ell = csr_to_ell(g, device=d)
        pipes.append(RGLPipeline(graph=ell, index=BruteIndex.build(g.node_feat, device=d),
                                 node_emb=ell.node_feat, device=d,
                                 config=PipelineConfig(k_seeds=3, max_nodes=16, filter_budget=6)))
    overflowed = 0
    for strategy in ("bfs", "dense", "steiner", "ppr"):
        for mode in ("dense", "compact"):
            res = []
            for p in pipes:
                cfg = dataclasses.replace(p.config, strategy=strategy, retrieval_mode=mode)
                r = dataclasses.replace(p, config=cfg).retrieve_many(q, batch_size=4)
                res.append(r)
            a, b = res
            for name in ("seeds", "nodes", "mask", "dist"):
                assert torch.equal(getattr(a, name).cpu(), getattr(b, name)), (strategy, mode, name)
            if mode == "compact":
                assert torch.equal(a.overflow.cpu(), b.overflow), (strategy, "overflow")
                overflowed += int(b.overflow.sum())
    return overflowed


def paged_cross_device_check(reduced_cfg) -> dict:
    """The reduced fp32 serve of the main path's mix on the card and on the
    CPU with the same weights, under paged + share + continuous admission,
    paged + int8 KV, and a small pool that truncates: tokens, retrieved
    nodes, prompts, truncated flags, the final block tables, free stack and
    refcounts, and the pin counters must agree exactly."""
    from repro_torch.launch.serve import _serve_rag

    distinct = np.random.default_rng(0).choice(3000, 8, replace=False)
    q_ids = np.concatenate([distinct, distinct[:4]])
    # cache_len 112: 16-token blocks (the default length, 103, is prime)
    cases = {"share_continuous": (reduced_cfg, dict(prefix_share=True, admission="continuous",
                                                    pool_blocks=96)),
             "int8": (dataclasses.replace(reduced_cfg, kv_quant=True), {}),
             "small_pool": (reduced_cfg, dict(prefix_share=True, pool_blocks=14))}
    summary = {}
    for name, (cfg, kw) in cases.items():
        kw = dict(nodes=3000, paged_kv=True, cache_len=112, **kw)
        card = _serve_rag(cfg, serve_args(**kw), q_ids=q_ids)
        host = to_device(card["params"], "cpu")
        cpu = _serve_rag(cfg, serve_args(device="cpu", **kw), q_ids=q_ids, params=host)
        runs = [{r.uid: r for r in out["done"]} for out in (card, cpu)]
        assert sorted(runs[0]) == sorted(runs[1]) == list(range(12)), name
        for uid, a in runs[0].items():
            b = runs[1][uid]
            assert np.array_equal(a.retrieved_nodes, b.retrieved_nodes), (name, uid)
            assert np.array_equal(a.prompt_ids, b.prompt_ids), (name, uid)
            assert (a.out_tokens, a.truncated) == (b.out_tokens, b.truncated), (name, uid)
        ea, eb = card["engine"].engine, cpu["engine"].engine
        for field in ("table", "free", "n_free", "ref"):
            assert torch.equal(getattr(ea.cache, field).cpu(), getattr(eb.cache, field)), \
                (name, field)
        keys = ("truncations", "kv_shared_admits", "kv_reused_tokens", "kv_cow_copies",
                "kv_pins", "kv_releases", "kv_pinned_blocks", "pool_high_water_blocks")
        for key in keys:
            assert card["stats"][key] == cpu["stats"][key], (name, key)
        summary[name] = {key: card["stats"][key] for key in keys}
    assert summary["share_continuous"]["kv_shared_admits"] == 4, summary
    assert summary["small_pool"]["truncations"] >= 1, summary
    return summary


# ------------------------------------------------------------ spec decode ----
# bf16 near-tie bound: a spec token that leaves the one-token serve's must
# sit within this of that serve's top logit at that step (a faulty verify
# step would put its token anywhere in the distribution)
NEAR_TIE = 0.25


def one_token_margins(cfg, params, q_ids, wanted: dict, one_token: dict, stack=None,
                      **kw) -> dict:
    """Re-serve the one-token run of an arena (same batches, so the same
    GEMM kernels as the serve it repeats) and read its logits at each
    diverged uid's first divergent step: ``wanted`` maps uid -> (step, spec
    token).  Returns per uid the step, the one-token serve's top-2 logit
    gap there and how far below its top logit the spec token was, and
    whether the re-serve reproduced the one-token tokens.  ``stack`` reuses
    a built graph, pipeline and weights (``params`` is then unused)."""
    from repro_torch.launch.serve import _serve_rag
    from repro_torch.models.transformer import model as tm
    from repro_torch.serving.engine import ServeEngine

    last, found = {}, {}
    decode_fns = {"decode_step": tm.decode_step, "paged_decode_step": tm.paged_decode_step}
    step_one = ServeEngine._step_one

    def keep_logits(name):
        def fn(*a, **k):
            logits, cache = decode_fns[name](*a, **k)
            last["logits"] = logits
            return logits, cache
        return fn

    def recording_step_one(self):
        before = {i: (r.uid, len(r.out_tokens)) for i, r in enumerate(self.active)
                  if r is not None and self.live[i]}
        finished = step_one(self)
        for i, (uid, n) in before.items():
            if uid in wanted and wanted[uid][0] == n:
                row = last["logits"][i].float()
                top = torch.topk(row, 2).values
                found[uid] = {"step": n, "one_token_top2_gap": float(top[0] - top[1]),
                              "spec_token_below_top": float(top[0] - row[wanted[uid][1]])}
        return finished

    for name in decode_fns:
        setattr(tm, name, keep_logits(name))
    ServeEngine._step_one = recording_step_one
    try:
        out = _serve_rag(cfg, serve_args(spec_decode=False, **kw), q_ids=q_ids, params=params,
                         stack=stack)
    finally:
        for name, fn in decode_fns.items():
            setattr(tm, name, fn)
        ServeEngine._step_one = step_one
    again = {r.uid: r.out_tokens for r in out["done"]}
    return {"reproduces_one_token": again == one_token, "uids": found}


def spec_run(card: str, name: str, cfg, params, q_ids, one_token: dict, **kw) -> dict:
    """One counted serve of the main path's mix with self-speculative decode
    (``draft_window`` 4): launches asserted (the retrieval kernels run per
    wave as in one-token decode), the allocator checked after the drain
    (paged), the decode profiled, and one line of numbers printed.  Its
    tokens are compared with ``one_token`` (the one-token serve of the same
    arena) and the agreement reported.  In bf16 a 16-row verify GEMM runs
    another cuBLAS kernel than a 4-row decode GEMM, so a near-tie may flip
    an argmax: each uid that leaves the one-token tokens gets its first
    divergent step and that serve's logit margins there on the line, and
    the run fails unless every such step is a near-tie (the spec token
    within ``NEAR_TIE`` of the top logit) and the dtype is bf16."""
    args = serve_args(spec_decode=True, draft_window=4, **kw)
    out, launches, overflow_rows = counted_serve(cfg, args, q_ids, params)
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_serve_launches(out, launches, overflow_rows, "brute")
    done, s, eng = out["done"], out["stats"], out["engine"].engine
    assert len(done) == len(q_ids) and all(r.done and not r.failed for r in done), name
    assert s["spec_decode"] and s["draft_window"] == 4, name
    if eng.paged_kv:
        check_allocator(eng)
    by_uid = {r.uid: r for r in done}
    toks = tokens(by_uid)
    rec = {"spec_run": name, "card": card, "draft_window": 4, "paged_kv": s["paged_kv"],
           "prefix_share": s["prefix_share"], "kv_quant": cfg.kv_quant,
           "cache_len": out["cache_len"], "max_new": args.max_new,
           "tok_per_s": out["tok_per_s"], "decode_ms_per_step": out["decode_ms_per_step"],
           "decode_steps": s["decode_steps"], "decode_tokens": s["decode_tokens"],
           "tokens_per_step": s["tokens_per_step"], "draft_accept_rate": s["draft_accept_rate"],
           "draft_proposed": s["draft_proposed"], "draft_accepted": s["draft_accepted"],
           "retrieval_batches": s["retrieval_batches"], "launches": launches,
           "peak_mem_gb": peak, "agreement_with_one_token": token_agreement(one_token, toks)}
    if eng.paged_kv:
        rec.update({k: s[k] for k in ("pool_high_water_blocks", "pool_blocks", "kv_shared_admits",
                                      "kv_reused_tokens", "kv_cow_copies")})
    diverged = sorted(u for u in one_token if one_token[u] != toks[u])
    if diverged:  # bf16: W-row GEMMs run other cuBLAS kernels than 1-row ones
        wanted = {}
        for u in diverged:
            k = next(i for i, (a, b) in enumerate(zip(one_token[u], toks[u])) if a != b)
            wanted[u] = (k, toks[u][k])
        rec["divergence"] = one_token_margins(cfg, params, q_ids, wanted, one_token, **kw)
    rec["decode_profile"] = profile_decode(eng)
    print(json.dumps(rec), flush=True)
    if diverged:
        div = rec["divergence"]
        assert cfg.dtype == "bfloat16" and div["reproduces_one_token"], (name, div)
        assert sorted(div["uids"]) == diverged, (name, div)
        assert all(d["spec_token_below_top"] <= NEAR_TIE for d in div["uids"].values()), (name, div)
    return rec


def spec_phase(card: str, cfg, params, one_token: dict) -> dict:
    """The main path's mix (8 distinct + 4 repeated queries, 12 new tokens,
    4 slots, cache_len 4096, the 169,343-node graph, the main path's
    weights) with self-speculative decode at ``draft_window`` 4 over the
    contiguous arena, the paged arena with prefix sharing, and the paged
    arena with prefix sharing and int8 KV, each held to the one-token serve
    of the same arena (``one_token``: per-uid tokens by arena)."""
    distinct = np.random.default_rng(0).choice(N_NODES, 8, replace=False)
    q_ids = np.concatenate([distinct, distinct[:4]])
    runs = [spec_run(card, "spec_contiguous_wave", cfg, params, q_ids, one_token["contiguous"]),
            spec_run(card, "spec_paged_share_wave", cfg, params, q_ids, one_token["share_wave"],
                     paged_kv=True, prefix_share=True),
            spec_run(card, "spec_paged_share_int8", dataclasses.replace(cfg, kv_quant=True),
                     params, q_ids, one_token["share_int8"], paged_kv=True, prefix_share=True)]
    assert runs[1]["kv_shared_admits"] == 4 and runs[2]["kv_shared_admits"] == 4, runs
    return {"runs": runs}


def spec_cross_device_check(reduced_cfg) -> dict:
    """The gate of speculative decode: the reduced fp32 serve of the main
    path's mix (24 new tokens) at ``draft_window`` 4 on the card and on the
    CPU with the same weights, over the contiguous arena, the paged arena
    with prefix sharing, and paged + share + int8 KV under continuous
    admission.  On the card the spec tokens must equal the one-token serve's
    of the same arena exactly; across devices tokens, retrieved nodes,
    prompts, truncated flags, the decode and draft counters, the share
    counters and (paged) the final block tables, free stack and refcounts
    must agree exactly."""
    from repro_torch.launch.serve import _serve_rag

    distinct = np.random.default_rng(0).choice(3000, 8, replace=False)
    q_ids = np.concatenate([distinct, distinct[:4]])
    # paged pools of 96 blocks: room for the pins beside 4 live slots
    share = dict(paged_kv=True, prefix_share=True, pool_blocks=96)
    cases = {"contiguous": (reduced_cfg, {}),
             "paged_share": (reduced_cfg, share),
             "paged_share_int8_continuous": (dataclasses.replace(reduced_cfg, kv_quant=True),
                                             dict(share, admission="continuous"))}
    summary = {}
    for name, (cfg, kw) in cases.items():
        # cache_len 128: 96-token prompts plus 24 new tokens, 16-token blocks
        kw = dict(nodes=3000, cache_len=128, max_new=24, **kw)
        spec = dict(spec_decode=True, draft_window=4)
        card = _serve_rag(cfg, serve_args(**spec, **kw), q_ids=q_ids)
        one = _serve_rag(cfg, serve_args(spec_decode=False, **kw), q_ids=q_ids,
                         params=card["params"])
        host = to_device(card["params"], "cpu")
        cpu = _serve_rag(cfg, serve_args(device="cpu", **spec, **kw), q_ids=q_ids, params=host)
        runs = [{r.uid: r for r in out["done"]} for out in (card, one, cpu)]
        assert sorted(runs[0]) == sorted(runs[1]) == sorted(runs[2]) == list(range(12)), name
        for uid, a in runs[0].items():
            o, b = runs[1][uid], runs[2][uid]
            assert (a.out_tokens, a.truncated) == (o.out_tokens, o.truncated), \
                (name, "1-token", uid)
            assert np.array_equal(a.retrieved_nodes, b.retrieved_nodes), (name, uid)
            assert np.array_equal(a.prompt_ids, b.prompt_ids), (name, uid)
            assert (a.out_tokens, a.truncated) == (b.out_tokens, b.truncated), (name, "cpu", uid)
        keys = ["decode_steps", "decode_tokens", "draft_proposed", "draft_accepted",
                "truncations"]
        if kw.get("paged_kv"):
            ea, eb = card["engine"].engine, cpu["engine"].engine
            for field in ("table", "free", "n_free", "ref"):
                assert torch.equal(getattr(ea.cache, field).cpu(), getattr(eb.cache, field)), \
                    (name, field)
            keys += ["kv_shared_admits", "kv_reused_tokens", "kv_cow_copies", "kv_pins",
                     "kv_releases", "kv_pinned_blocks", "pool_high_water_blocks"]
        for key in keys:
            assert card["stats"][key] == cpu["stats"][key], (name, key)
        summary[name] = {"tokens_per_step": card["stats"]["tokens_per_step"],
                         "draft_accept_rate": card["stats"]["draft_accept_rate"],
                         "decode_steps_spec_one_token": [card["stats"]["decode_steps"],
                                                         one["stats"]["decode_steps"]],
                         **{k: card["stats"][k] for k in keys}}
    assert summary["paged_share"]["kv_shared_admits"] == 4, summary
    assert summary["paged_share_int8_continuous"]["kv_shared_admits"] == 4, summary
    return summary


# ------------------------------------------ prefetch, faults and the router ----
# kernel-name fragments of the retrieval path's hand-written kernels
RETRIEVAL_KERNELS = ("topk_sim_scan_kernel", "topk_merge_kernel", "ws_mark_kernel",
                     "frontier_hop_", "pack_frontier_kernel", "ivf_scan_kernel")
TRACE_DIR = Path(__file__).resolve().parent / "build" / "traces"


def hybrid_clock():
    """Wall time plus the seconds slept: what runs is timed on the wall
    clock, while a stuck row's timeout poll and the retry backoff pass at
    once instead of sleeping."""
    slept = [0.0]
    return {"now_fn": lambda: time.monotonic() + slept[0],
            "sleep_fn": lambda s: slept.__setitem__(0, slept[0] + s)}


def virtual_clock():
    """A clock that only ``sleep_fn`` advances (the same on two devices)."""
    t = [0.0]
    return {"now_fn": lambda: t[0], "sleep_fn": lambda s: t.__setitem__(0, t[0] + s)}


def _union(spans: list) -> list:
    out: list = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap_us(xs: list, ys: list) -> float:
    """Length of the intersection of two sorted unions of spans."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def stream_split(trace: Path) -> dict:
    """Kernels of a ``torch.profiler`` chrome trace by CUDA stream: the
    decode stream is the one with the most kernel time and no retrieval
    kernel; every stream with a retrieval kernel is a retrieval stream.
    Returns the streams, the device ms of all kernels and copies on the
    retrieval streams and of the retrieval kernels alone, the decode
    stream's kernel ms, and the ms in which retrieval-stream work overlaps
    decode-stream kernels."""
    events = json.loads(trace.read_text())["traceEvents"]
    by_stream: dict = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        stream = (e.get("args") or {}).get("stream")
        by_stream.setdefault(stream, []).append(
            (e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["cat"]))
    retrieval = sorted(s for s, evs in by_stream.items()
                       if any(f in n for n, *_ in evs for f in RETRIEVAL_KERNELS))
    others = [s for s in by_stream if s not in retrieval]
    assert retrieval and others, sorted(by_stream)
    decode = max(others, key=lambda s: sum(b - a for _, a, b, c in by_stream[s] if c == "kernel"))
    side = [ev for s in retrieval for ev in by_stream[s]]
    dec = [ev for ev in by_stream[decode] if ev[3] == "kernel"]
    return {"decode_stream": decode, "retrieval_streams": retrieval,
            "retrieval_on_decode_stream": decode in retrieval,
            "side_stream_device_ms": sum(b - a for _, a, b, _ in side) / 1e3,
            "retrieval_kernel_ms": sum(b - a for n, a, b, _ in side
                                       if any(f in n for f in RETRIEVAL_KERNELS)) / 1e3,
            "decode_stream_kernel_ms": sum(b - a for _, a, b, _ in dec) / 1e3,
            "overlap_ms": _overlap_us(_union([(a, b) for _, a, b, _ in side]),
                                      _union([(a, b) for _, a, b, _ in dec])) / 1e3}


def profiled_streams(name: str, cfg, args, q_ids, stack) -> dict:
    """One more serve of ``args`` under ``torch.profiler`` (device activity
    only; every launch of the serve and the decode steps around it), its
    trace split by stream (:func:`stream_split`)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import _serve_rag

    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = _serve_rag(cfg, args, q_ids=q_ids, stack=stack)
        torch.cuda.current_stream().synchronize()
    path = TRACE_DIR / f"{name}.json"
    prof.export_chrome_trace(str(path))
    split = stream_split(path)
    path.unlink()
    split["decode_steps"] = out["stats"]["decode_steps"]
    return split


def item12_serve(cfg, stack, q_ids, **kw) -> tuple[dict, dict, list]:
    """One counted serve of the main path's mix on ``stack``, its retrieval
    launches asserted; returns (summary, requests by uid, overflow rows)."""
    args = serve_args(**kw)
    out, launches, overflow_rows = counted_serve(cfg, args, q_ids, stack=stack)
    check_serve_launches(out, launches, overflow_rows, "brute", mode=args.retrieval)
    done = {r.uid: r for r in out["done"]}
    assert sorted(done) == list(range(len(q_ids))), sorted(done)
    assert all(r.done and not r.failed for r in done.values()), kw
    out["launches"] = launches
    return out, done, overflow_rows


def wave_host_ms(stack, q_ids, reps: int = 10) -> dict:
    """Host ms of one warm 4-query retrieval wave (all misses), median of
    ``reps`` taken in turns: the prefetcher's launch + collect (side stream,
    pinned landing, one event) against ``retrieve_many`` on the current
    stream with its four results copied to the host by ``.cpu()`` (the work
    of a sync wave before the side stream), both under ``auto`` and
    ``dense``."""
    from repro_torch.serving.cache import RetrievalCache
    from repro_torch.serving.prefetch import AdmissionPrefetcher
    from repro_torch.serving.rag_engine import RAGRequest

    out = {}
    for mode in ("auto", "dense"):
        pipe = dataclasses.replace(stack["pipe"], config=dataclasses.replace(
            stack["pipe"].config, retrieval_mode=mode))
        qe = stack["g"].node_feat[q_ids[:4]]
        reqs = [RAGRequest(uid=u, query_emb=e, query_text="q") for u, e in enumerate(qe)]
        p = AdmissionPrefetcher(pipe, RetrievalCache(capacity=0), wave_size=4)

        def prefetcher():
            p.launch(reqs)
            p.collect()

        def current_stream():
            res = pipe.retrieve_many(qe, batch_size=4)
            for t in (res.nodes, res.mask, res.dist, res.seeds):
                t.cpu()

        samples = {"prefetcher": [], "current_stream": []}
        for i in range(2 * reps + 2):
            name, fn = (("prefetcher", prefetcher), ("current_stream", current_stream))[i % 2]
            t0 = time.perf_counter()
            fn()
            if i >= 2:  # the first pair warms up
                samples[name].append(1e3 * (time.perf_counter() - t0))
        out[mode] = {k: statistics.median(v) for k, v in samples.items()}
    return out


def prefetch_phase(card: str, cfg, stack, q_ids) -> dict:
    """The main path's mix on the main path's graph, index and weights with
    async admission prefetch (retrieval on the prefetcher's side stream),
    each run beside the sync serve of the same schedule: wave admission at
    depth 1, continuous admission (depth = slots), paged + share, and
    ``retrieval="dense"``.  Tokens a uid, cache hits and misses equal the
    sync serve's; launches asserted a wave; a profiled repeat of each
    prefetched serve shows the retrieval kernels on a stream other than
    decode's and how long they overlapped decode's kernels."""
    runs = {"prefetch_wave": {}, "prefetch_continuous": dict(admission="continuous"),
            "prefetch_paged_share": dict(paged_kv=True, prefix_share=True),
            "prefetch_dense": dict(retrieval="dense")}
    recs, tokens_by, misses_by = [], {}, {}
    for name, kw in runs.items():
        sync, sync_done, _ = item12_serve(cfg, stack, q_ids, **kw)
        pf, pf_done, overflow_rows = item12_serve(cfg, stack, q_ids, prefetch=True, **kw)
        ss, sp = sync["stats"], pf["stats"]
        for uid, r in pf_done.items():
            assert r.out_tokens == sync_done[uid].out_tokens, (name, uid)
            assert np.array_equal(r.retrieved_nodes, sync_done[uid].retrieved_nodes), (name, uid)
        assert (sp["hits"], sp["misses"]) == (ss["hits"], ss["misses"]), (name, sp, ss)
        assert sp["prefetch"] and sp["prefetch_waves"] > 0, name
        if kw.get("paged_kv"):
            check_allocator(pf["engine"].engine)
            assert sp["kv_shared_admits"] == ss["kv_shared_admits"], name
        streams = profiled_streams(name, cfg, serve_args(prefetch=True, **kw), q_ids, stack)
        assert not streams["retrieval_on_decode_stream"], (name, streams)
        rec = {"prefetch_run": name, "card": card, "admission": sp["admission"],
               "retrieval": kw.get("retrieval", "auto"), "paged_kv": sp["paged_kv"],
               "depth": pf["engine"].prefetcher.depth, "tok_per_s": pf["tok_per_s"],
               "sync_tok_per_s": sync["tok_per_s"],
               "wall_ms_per_step": 1e3 * pf["serve_s"] / sp["decode_steps"],
               "sync_wall_ms_per_step": 1e3 * sync["serve_s"] / ss["decode_steps"],
               "launch_seconds": sp["launch_seconds"],
               "collect_block_seconds": sp["collect_block_seconds"],
               "sync_retrieval_seconds": ss["retrieval_seconds"],
               "sync_launch_seconds": ss["launch_seconds"],
               "sync_collect_block_seconds": ss["collect_block_seconds"],
               **{k: sp[k] for k in ("overlap_seconds", "overlap_steps", "overlap_tokens",
                                     "hidden_frac", "prefetch_waves", "retrieval_batches",
                                     "hits", "misses", "decode_steps")},
               "overflow_rows_per_wave": overflow_rows, "launches": pf["launches"],
               "tokens_equal_sync": True, "streams": streams}
        print(json.dumps(rec), flush=True)
        recs.append(rec)
        tokens_by[name] = {u: r.out_tokens for u, r in sync_done.items()}
        misses_by[name] = ss["misses"]
    return {"runs": recs, "sync_tokens": tokens_by, "sync_misses": misses_by}


def assert_engine_clean(eng) -> None:
    """No slot, KV block or in-flight key left once a serve settles."""
    assert eng.cache.inflight_count == 0 and eng.prefetcher.in_flight == 0
    assert not eng._inflight and not eng._terminal
    assert not eng.engine.queue and not eng.engine.live.any()
    if eng.engine.paged_kv:
        check_allocator(eng.engine)


def terminal_once(done: list, n: int) -> None:
    """Every uid came back once, in exactly one of done, failed or shed."""
    assert sorted(r.uid for r in done) == list(range(n)), sorted(r.uid for r in done)
    for r in done:
        assert (r.done and not r.failed) + r.failed + r.shed == 1, (r.uid, r.done, r.failed,
                                                                   r.shed)


FAULT_COUNTERS = ("retries", "timeouts", "retrieval_failures", "failed", "degraded",
                  "stale_served", "shed")


def fault_phase(card: str, cfg, stack, q_ids, no_fault: dict) -> dict:
    """The main path's mix through ``FaultyRetrieval(seed=23,
    fault_rate=0.25)`` (all four fault types) with 2 retries and a 5 s
    timeout, sync and prefetched.  A warm wave of this mix takes
    milliseconds (the kernels are built), so no healthy wave comes near the
    timeout; the clock is the wall clock plus the seconds slept, so a stuck
    row's timeout passes without sleeping.  Every uid ends once, nothing
    leaks, and the fault-free uids' tokens equal the no-fault serve's."""
    from repro_torch.launch.serve import _serve_rag
    from repro_torch.serving.simulate import FaultyRetrieval

    sched = FaultyRetrieval(None, seed=23, fault_rate=0.25)
    faulty = {u for u, q in enumerate(q_ids) if sched.fault_of(stack["g"].node_feat[q])}
    recs = []
    for prefetch in (False, True):
        args = serve_args(prefetch=prefetch, fault_rate=0.25, fault_seed=23, retries=2,
                          retrieval_timeout=5.0)
        out = _serve_rag(cfg, args, q_ids=q_ids, stack=stack, **hybrid_clock())
        terminal_once(out["done"], len(q_ids))
        assert_engine_clean(out["engine"])
        want = no_fault["prefetch_wave"]
        for r in out["done"]:
            if r.uid not in faulty:
                assert r.done and not (r.degraded or r.stale), r.uid
                assert r.out_tokens == want[r.uid], r.uid
        s = out["stats"]
        rec = {"fault_run": "prefetch" if prefetch else "sync", "card": card,
               "faults_by_uid": {str(u): sched.fault_of(stack["g"].node_feat[q_ids[u]])
                                 for u in sorted(faulty)},
               "tok_per_s": out["tok_per_s"],
               **{k: s[k] for k in FAULT_COUNTERS + ("hits", "misses", "retrieval_batches")},
               "injected": dict(out["engine"].pipeline.injected)}
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return {"runs": recs}


def router_phase(card: str, cfg, stack, q_ids, single: dict) -> dict:
    """Two replicas on the card sharing the main path's weights and one
    retrieval cache, the second crashing at its step 3, failover on, sync
    and prefetched: every request is delivered once, tokens equal the
    single engine's, one failover re-dispatches exactly the requests the
    crashed replica held, and the fleet misses as often as one engine
    (single flight across replicas)."""
    from repro_torch.launch.serve import _serve_rag

    recs = []
    for prefetch in (False, True):
        torch.cuda.reset_peak_memory_stats()
        args = serve_args(prefetch=prefetch, replicas=2, crash_replica=3)
        out = _serve_rag(cfg, args, q_ids=q_ids, stack=stack)
        peak = torch.cuda.max_memory_allocated() / 1e9
        rs = out["router_stats"]
        terminal_once(out["done"], len(q_ids))
        assert all(r.done and not r.failed for r in out["done"]), "a request was lost"
        assert rs["delivered"] == len(q_ids) and rs["duplicate_deliveries"] == 0, rs
        crashed = rs["per_replica"][1]
        assert rs["failovers"] == 1 and crashed["circuit"] == "crashed", rs
        assert rs["redispatched"] == crashed["dispatched"] - crashed["delivered"] > 0, rs
        for r in out["done"]:
            assert r.out_tokens == single["tokens"][r.uid], r.uid
        for eng in out["engines"]:
            assert_engine_clean(eng)
        cache = out["engine"].cache.stats()
        assert cache["misses"] == single["misses"], (cache, single["misses"])
        rec = {"router_run": "prefetch" if prefetch else "sync", "card": card,
               "tok_per_s": out["tok_per_s"], "peak_mem_gb": peak,
               "weights_shared": all(e.engine.params is stack["params"] for e in out["engines"]),
               **{k: rs[k] for k in ("submitted", "delivered", "failovers", "redispatched",
                                     "stranded", "duplicate_deliveries")},
               "per_replica": [{k: p[k] for k in ("name", "circuit", "dispatched", "delivered",
                                                  "crashes", "trips")}
                               for p in rs["per_replica"]],
               "cache_hits": cache["hits"], "cache_misses": cache["misses"]}
        assert rec["weights_shared"]
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return {"runs": recs}


def outcome(r) -> tuple:
    return (list(r.out_tokens), np.asarray(r.retrieved_nodes).tolist(),
            np.asarray(r.prompt_ids).tolist(), r.cache_hit, r.done, r.failed, r.shed, r.stale,
            r.degraded, r.truncated, r.error)


def fleet_cross_device_check(reduced_cfg) -> dict:
    """The gate of item 12: reduced fp32, the 3,000-node graph, a virtual
    clock.  The faulty serve (``FaultyRetrieval`` seed 37 at 25%: the
    3,000-node mix meets all four fault types at that seed, and none at
    seed 23; 2 retries, a 0.05 s timeout) and the 2-replica crash serve,
    each sync and prefetched, on the card and on the CPU with the same
    weights: per-uid outcomes (tokens, nodes, prompts, flags, errors), every
    engine's fault and cache counters and the router's counters agree."""
    from repro_torch.launch.serve import _serve_rag

    distinct = np.random.default_rng(0).choice(3000, 8, replace=False)
    q_ids = np.concatenate([distinct, distinct[:4]])
    faults = dict(fault_rate=0.25, fault_seed=37, retries=2, retrieval_timeout=0.05)
    cases = {f"{kind}_{'prefetch' if pf else 'sync'}": dict(kw, prefetch=pf)
             for kind, kw in (("fault", faults), ("router", dict(replicas=2, crash_replica=3)))
             for pf in (False, True)}
    summary, params = {}, None
    for name, kw in cases.items():
        kw = dict(nodes=3000, cache_len=112, **kw)
        card = _serve_rag(reduced_cfg, serve_args(**kw), q_ids=q_ids, params=params,
                          **virtual_clock())
        params = card["params"]
        host = to_device(params, "cpu")
        cpu = _serve_rag(reduced_cfg, serve_args(device="cpu", **kw), q_ids=q_ids, params=host,
                         **virtual_clock())
        runs = [{r.uid: r for r in out["done"]} for out in (card, cpu)]
        assert sorted(runs[0]) == sorted(runs[1]) == list(range(12)), name
        for uid, a in runs[0].items():
            assert outcome(a) == outcome(runs[1][uid]), (name, uid)
        keys = FAULT_COUNTERS + ("hits", "misses", "retrieval_batches", "retrieved_queries",
                                 "prefetch_waves", "overlap_steps", "overlap_tokens",
                                 "decode_steps", "emitted_tokens")
        for ea, eb in zip(card["engines"], cpu["engines"]):
            sa, sb = ea.stats(), eb.stats()
            for key in keys:
                assert sa[key] == sb[key], (name, key, sa[key], sb[key])
        if "router_stats" in card:
            assert card["router_stats"] == cpu["router_stats"], name
        s = card["stats"]
        summary[name] = {k: s[k] for k in keys}
        if "router_stats" in card:
            summary[name].update({k: card["router_stats"][k]
                                  for k in ("failovers", "redispatched", "delivered")})
        else:
            summary[name]["injected"] = dict(card["engine"].pipeline.injected)
    assert all(summary[f"fault_{m}"]["injected"][t] > 0 for m in ("sync", "prefetch")
               for t in ("dispatch", "force", "stuck", "corrupt")), summary
    assert all(summary[f"router_{m}"]["failovers"] == 1 for m in ("sync", "prefetch")), summary
    return summary


def item12_phases(card: str, cfg, stack, brute_tokens: dict) -> dict:
    """The prefetch, fault and router phases on the main path's stack, and
    one summary line: each prefetched schedule against its sync serve."""
    t0 = time.perf_counter()
    distinct = np.random.default_rng(0).choice(N_NODES, 8, replace=False)
    q_ids = np.concatenate([distinct, distinct[:4]])
    pf = prefetch_phase(card, cfg, stack, q_ids)
    assert pf["sync_tokens"]["prefetch_wave"] == brute_tokens, "sync serve left the main path"
    wave_ms = wave_host_ms(stack, q_ids)
    faults = fault_phase(card, cfg, stack, q_ids, pf["sync_tokens"])
    single = {"tokens": brute_tokens, "misses": pf["sync_misses"]["prefetch_wave"]}
    router = router_phase(card, cfg, stack, q_ids, single)
    summary = {"card": card, "phase_s": time.perf_counter() - t0,
               "wave_host_ms": wave_ms, "runs": {
        r["prefetch_run"]: {k: r[k] for k in ("tok_per_s", "sync_tok_per_s", "hidden_frac",
                                              "launch_seconds", "collect_block_seconds",
                                              "sync_retrieval_seconds", "overlap_steps")}
        | {"overlap_ms": r["streams"]["overlap_ms"],
           "side_stream_device_ms": r["streams"]["side_stream_device_ms"]}
        for r in pf["runs"]}}
    print(json.dumps({"item12_phase": summary}), flush=True)
    return {"prefetch": pf["runs"], "faults": faults["runs"], "router": router["runs"]}


# -------------------------------------------------------- online mutation ----
SLEEP_CYCLES = 1_000_000_000  # torch.cuda._sleep: ~0.5 s at the H100's clocks


def tier_bytes(store) -> int:
    """Bytes of a store's active-tier device tensors: the fold's resident
    inputs, the merged view, the embeddings and the index (0 while
    pristine)."""
    if not store.active:
        return 0
    g, idx = store.graph, store.index
    tensors = [*store.delta._dev.values(), g.nbr, g.nbr_mask, store.node_emb,
               *[v for v in vars(idx).values() if isinstance(v, torch.Tensor)],
               *(getattr(idx, "_dev", None) or ())]
    return sum({t.data_ptr(): t.numel() * t.element_size() for t in tensors}.values())


def mutation_serve(card: str, name: str, cfg, stack, q_ids, frozen: dict, **kw) -> dict:
    """The main path's mix on the main path's graph and weights through a
    fresh ``MutableGraphStore`` while the launcher's seeded writer
    (``--mutate-rate 0.1``) mutates it between steps, under continuous
    admission: wave admission retrieves the whole mix in its first three
    steps, before the writer's first batch (after step 9), so no wave would
    read the merged graph; one request a free slot retrieves throughout the
    serve.  ``frozen`` is the frozen serve of the same schedule.  Each apply is timed
    on the host up to the end of its current-stream work, each fold by CUDA
    events; every wave's tier (pristine or active) is recorded, and the
    launches are asserted: ``topk_sim`` once a pristine brute wave and never
    once the store is active, ``ivf_scan`` once an IVF wave, the hop kernels
    over the merged graph as on the frozen path."""
    from repro_torch.core.pipeline import RGLPipeline
    from repro_torch.graph import delta
    from repro_torch.serving.rag_engine import RAGServeEngine

    apply_ms, fold_ms, bytes_seen, tiers = [], [], [], []
    apply0, fold0, retrieve0 = (RAGServeEngine.apply_mutations, delta._fold_merged,
                                RGLPipeline.retrieve)

    def timed_apply(self, batch):
        t0 = time.perf_counter()
        report = apply0(self, batch)
        torch.cuda.current_stream().synchronize()  # the apply's own stream, not the side one
        apply_ms.append(1e3 * (time.perf_counter() - t0))
        bytes_seen.append(tier_bytes(self.pipeline.mutation_store))
        return report

    def timed_fold(*a, **k):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fold0(*a, **k)
        end.record()
        end.synchronize()
        fold_ms.append(start.elapsed_time(end))
        return out

    def recorded_retrieve(self, *a, **k):
        tiers.append(self.mutation_store.active)
        return retrieve0(self, *a, **k)

    args = serve_args(mutate_rate=0.1, admission="continuous", prefetch_depth=1, **kw)
    RAGServeEngine.apply_mutations, delta._fold_merged = timed_apply, timed_fold
    RGLPipeline.retrieve = recorded_retrieve
    try:
        out, launches, overflow_rows = counted_serve(cfg, args, q_ids, stack=stack)
    finally:
        RAGServeEngine.apply_mutations, delta._fold_merged = apply0, fold0
        RGLPipeline.retrieve = retrieve0
    done, s = out["done"], out["stats"]
    assert len(done) == 12 and all(r.done and not r.failed for r in done), name
    store = out["engine"].pipeline.mutation_store
    waves = out["retrieval_batches"]
    assert len(tiers) == waves and s["mutation_batches"] == len(apply_ms) > 0, (tiers, s)
    pristine = tiers.count(False)
    assert pristine < waves, ("no wave read the merged graph", tiers)
    check_serve_launches(out, launches, overflow_rows, args.index,
                         topk_waves=pristine if args.index == "brute" else 0)
    rec = {"mutation_run": name, "card": card, "index": args.index, "prefetch": s["prefetch"],
           "batches": s["mutation_batches"], "epoch": s["mutation_epoch"],
           "compactions": s["mutation_compactions"], "invalidated": s["invalidated"],
           "stale_rejects": s["stale_rejects"], "nodes": store.n_nodes,
           "capacity": store.capacity, "merged_width": store.graph.max_deg,
           "apply_ms_median": statistics.median(apply_ms), "apply_ms_max": max(apply_ms),
           "apply_ms": apply_ms, "fold_ms_median": statistics.median(fold_ms),
           "fold_ms_max": max(fold_ms), "folds": len(fold_ms),
           "active_tier_bytes": max(bytes_seen), "tok_per_s": out["tok_per_s"],
           "frozen_tok_per_s": frozen["tok_per_s"],
           "decode_ms_per_step": out["decode_ms_per_step"],
           "frozen_decode_ms_per_step": frozen["decode_ms_per_step"], "waves": waves,
           "pristine_waves": pristine, "launches": launches,
           "launches_a_wave": {k: v / waves for k, v in launches.items()},
           "hits": s["hits"], "misses": s["misses"]}
    print(json.dumps(rec), flush=True)
    return {"record": rec, "store": store, "done": {r.uid: r for r in done}}


def zero_mutation_serve(cfg, stack, q_ids) -> dict:
    """A pristine store-backed serve of the main path's mix: tokens and
    retrieved nodes equal the frozen brute serve's, ``topk_sim`` launched
    once a wave, the store never activated."""
    from repro_torch.core.mutation import MutableGraphStore

    store = MutableGraphStore.build(stack["g"], index_kind="brute", device="cuda")
    pipe = store.make_pipeline(tokenizer=stack["pipe"].tokenizer, config=stack["pipe"].config)
    out, launches, overflow_rows = counted_serve(cfg, serve_args(), q_ids,
                                                 stack={**stack, "pipe": pipe})
    check_serve_launches(out, launches, overflow_rows, "brute")
    done = {r.uid: r for r in out["done"]}
    for uid, r in done.items():
        assert r.out_tokens == stack["frozen_tokens"][uid], uid
        assert np.array_equal(r.retrieved_nodes, stack["served_nodes"][uid]), uid
    assert store.epoch == 0 and not store.active and pipe.graph is store._pristine_ell
    return {"tokens_equal_frozen": True, "nodes_equal_frozen": True, "launches": launches,
            "waves": out["retrieval_batches"], "tok_per_s": out["tok_per_s"]}


def steady_applies(store, rng, n: int = 24) -> dict:
    """``n`` batches of the launcher's writer mix on an active store, each
    timed on the host to the end of its current-stream work (its fold
    included, which an attached pipeline's re-pointing runs), each fold by
    CUDA events: the steady state a serve's few batches do not show."""
    from repro_torch.graph import delta
    from repro_torch.launch.serve import _writer_batch

    fold_ms, apply_ms = [], []
    fold0 = delta._fold_merged

    def timed_fold(*a, **k):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fold0(*a, **k)
        end.record()
        end.synchronize()
        fold_ms.append(start.elapsed_time(end))
        return out

    delta._fold_merged = timed_fold
    try:
        for _ in range(n):
            batch = _writer_batch(rng, store)
            t0 = time.perf_counter()
            store.apply(batch)
            store.graph
            torch.cuda.current_stream().synchronize()
            apply_ms.append(1e3 * (time.perf_counter() - t0))
    finally:
        delta._fold_merged = fold0
    return {"batches": n, "apply_ms_median": statistics.median(apply_ms),
            "apply_ms_max": max(apply_ms), "fold_ms_median": statistics.median(fold_ms),
            "fold_ms_max": max(fold_ms), "folds": len(fold_ms)}


def crafted_batch(store, rng):
    """A batch that kills base slots (two live slots of 32 rows), fills the
    free slack of 8 rows exactly (no overflow), tombstones 32 nodes and adds
    8 wired to live ones; applied and checked: no compaction ran."""
    from repro_torch.core.mutation import MutationBatch

    d = store.delta
    n = store.n_nodes
    alive = np.flatnonzero(store.alive)
    picks = rng.choice(alive, 200, replace=False)
    kill_rows, fill_rows, dead = picks[:32], picks[32:40], picks[40:72]
    deletes = []  # two live base slots of each kill row
    for u in kill_rows:
        live = d.h_base_nbr[u][d.h_base_mask[u] & ~d.h_kill[u]]
        deletes += [(int(u), int(v)) for v in live[:2]]
    fills = []
    for u in fill_rows:  # exactly the free slack of each row: no overflow
        have = set(d.h_base_nbr[u][d.h_base_mask[u]].tolist())  # a killed slot would revive
        have |= set(d.h_extra[u, :d.h_extra_cnt[u]].tolist()) | {int(u)}
        free = d.extra_deg - int(d.h_extra_cnt[u])
        targets = [int(v) for v in rng.choice(alive, 4 * d.extra_deg) if int(v) not in have]
        fills += [(int(u), v) for v in list(dict.fromkeys(targets))[:free]]
    feat = rng.standard_normal((8, store.h_feat.shape[1])).astype(np.float32)
    batch = MutationBatch(add_node_feat=feat, add_node_text=[f"new {n + i}" for i in range(8)],
                          add_edges=np.array(fills + [(n + i, int(alive[i])) for i in range(8)]),
                          del_edges=np.array(deletes), del_nodes=dead, symmetric=False)
    before = store.compactions
    t0 = time.perf_counter()
    report = store.apply(batch)
    torch.cuda.current_stream().synchronize()
    apply_ms = 1e3 * (time.perf_counter() - t0)
    assert store.compactions == before, "the crafted batch overflowed and compacted"
    assert report.edges_deleted == len(deletes) and int(d.h_kill.sum()) >= len(deletes)
    assert report.edges_added == len(fills) + 8
    assert (d.h_extra_cnt[fill_rows] == d.extra_deg).all() and d.tomb[dead].all()
    return np.concatenate([kill_rows, fill_rows, dead]), alive, apply_ms


def merged_hops(store, frozen_ell, rng) -> dict:
    """After :func:`crafted_batch`: ``bfs_frontier`` and ``ws_mark`` on the
    store's merged graph, bit for bit against their plain versions; the
    hop's plan and time beside the frozen graph's."""
    from repro_torch.core.workset import build_workset
    from repro_torch.kernels.bfs_frontier import kernel as bfs_kernel
    from repro_torch.kernels.bfs_frontier import ops as bfs_ops
    from repro_torch.kernels.frontier_expand import ops as fe_ops

    rows, alive, apply_ms = crafted_batch(store, rng)
    d = store.delta
    g = store.graph
    nbr, mask = g.nbr, g.nbr_mask
    cap, width = nbr.shape
    assert width == d.base_deg + d.extra_deg, width
    frontier = torch.from_numpy(rng.random((4, cap)) < 1e-3).to(nbr.device)
    frontier[:, torch.from_numpy(rows).to(nbr.device)] = True
    got = bfs_ops.frontier_hop(frontier, nbr, mask, use_kernel=True)
    torch.cuda.synchronize()
    plan = dataclasses.asdict(bfs_kernel.last_plan)
    assert torch.equal(got, bfs_ops.frontier_hop(frontier, nbr, mask, use_kernel=False)), \
        ("bfs_frontier differs from its plain version on the merged graph", width)
    fn, fk = frozen_ell.nbr, frozen_ell.nbr_mask
    ffront = frontier[:, :fn.shape[0]].contiguous()
    bfs_ops.frontier_hop(ffront, fn, fk, use_kernel=True)
    torch.cuda.synchronize()
    frozen_plan = dataclasses.asdict(bfs_kernel.last_plan)
    if width == 1032:  # 16-row tiles, where K = 1016 takes 32
        assert plan["rows"] == 16 and frozen_plan["rows"] == 32, (plan, frozen_plan)
    hop_ms, frozen_hop_ms = [], []
    for _ in range(2):  # in turns: merged, frozen, merged, frozen
        hop_ms.append(time_ms(lambda: bfs_ops.frontier_hop(frontier, nbr, mask, use_kernel=True)))
        frozen_hop_ms.append(time_ms(lambda: bfs_ops.frontier_hop(ffront, fn, fk,
                                                                   use_kernel=True)))
    seeds = torch.from_numpy(np.stack([rng.choice(alive, 3) for _ in range(4)])
                             .astype(np.int32)).to(nbr.device)
    ws = build_workset(nbr, mask, seeds, max_hops=2, cap=2048, use_kernel=False)
    cand = fe_ops.hop_candidates(ws.ids, nbr, mask)
    marks = fe_ops.ws_member(ws.ids, cand, use_kernel=True)
    torch.cuda.synchronize()
    assert torch.equal(marks, fe_ops.ws_member(ws.ids, cand, use_kernel=False)), \
        ("ws_mark differs from its plain version on the merged graph", width)
    return {"merged_shape": [cap, width], "killed_slots": int(d.h_kill.sum()),
            "full_slack_rows": int((d.h_extra_cnt == d.extra_deg).sum()),
            "tombstones": int(d.tomb.sum()), "crafted_apply_ms": apply_ms,
            "bfs_plan": plan, "bfs_plan_frozen": frozen_plan, "hop_ms": hop_ms,
            "frozen_hop_ms": frozen_hop_ms, "ws_mark_candidates": list(cand.shape)}


def merged_kernels_check(card: str, store, ivf_store, stack, rng) -> dict:
    """The retrieval kernels on inputs only mutation makes: after
    :func:`crafted_batch`, ``bfs_frontier`` and ``ws_mark`` on two merged
    graphs, the serve's store (its canonical base is 1000 wide: the
    generator's duplicate arcs go at activation, so the merged view is
    1000 + 16 = 1016 wide) and a store built with ``max_deg=1016`` (the
    frozen width: merged 1032, 16-row hop tiles), bit for bit against their
    plain versions, each hop timed beside the frozen graph's in turns; and
    ``ivf_scan`` on the IVF store's candidates with deleted rows masked out,
    against both plain arms."""
    from repro_torch.core import indexing as ix
    from repro_torch.core.mutation import MutableGraphStore, MutationBatch
    from repro_torch.kernels.ivf_scan import ops as ivf_ops

    frozen_ell = stack["pipe"].graph
    steady = steady_applies(store, rng)
    hops = {"serve_store": merged_hops(store, frozen_ell, rng)}
    wide = MutableGraphStore.build(stack["g"], index_kind="brute", max_deg=frozen_ell.max_deg,
                                   device="cuda")
    wide.apply(MutationBatch(add_edges=np.array([[0, 1]])))  # activate
    hops["fixed_width_store"] = merged_hops(wide, frozen_ell, rng)
    del wide

    gone = np.flatnonzero(ivf_store.alive)[:4]
    qn = ix.l2_normalize(torch.from_numpy(ivf_store.h_feat[gone]).cuda())
    ivf_store.apply(MutationBatch(del_nodes=gone))  # the queries' own rows go
    idx = ivf_store.index
    lists, lmask = idx._device_lists()
    cand_i, open_ = ix.ivf_candidates(idx.centroids, lists, lmask, qn, idx.nprobe)
    cmask = open_ & idx.valid[cand_i.clamp(max=idx.emb.shape[0] - 1)]
    masked = int((open_ & ~cmask).sum())
    assert masked >= 1, masked
    s_k, i_k = ivf_ops.ivf_candidate_scan(qn, idx.emb, cand_i, cmask, 3, use_kernel=True)
    torch.cuda.synchronize()
    for tiled in (False, True):
        s_p, i_p = ivf_ops.ivf_candidate_scan(qn, idx.emb, cand_i, cmask, 3, tiled=tiled,
                                              use_kernel=False)
        assert torch.equal(s_k, s_p) and torch.equal(i_k, i_p), ("ivf_scan", tiled)
    assert not np.isin(i_k.cpu().numpy(), gone).any()
    rec = {"merged_kernels": "bit for bit against the plain versions", "card": card,
           "steady_applies": steady, "hops": hops, "ivf_masked_candidate_slots": masked,
           "ivf_candidates": list(cand_i.shape)}
    print(json.dumps(rec), flush=True)
    return rec


def torn_read_probe(card: str, cfg, stack, store) -> dict:
    """A prefetched wave (dense mode: its launch syncs nothing) queued on the
    side stream behind ``torch.cuda._sleep``; then, before it runs, a batch
    deleting its queried nodes, a compaction and a large ``torch.full`` on
    the current stream, where the allocator would reuse the old snapshot's
    memory were the wave not holding it.  The served nodes equal the
    launch-time snapshot's retrieval on the CPU, and the cache's put-gate
    refuses the superseded results."""
    from repro_torch.core.mutation import MutationBatch
    from repro_torch.core.pipeline import RGLPipeline
    from repro_torch.serving.rag_engine import RAGRequest, RAGServeEngine

    g = stack["g"]
    pipe = store.make_pipeline(tokenizer=stack["pipe"].tokenizer, config=dataclasses.replace(
        stack["pipe"].config, retrieval_mode="dense"))
    eng = RAGServeEngine(pipe, stack["params"], stack["cfg"], slots=4,
                         cache_len=max(cfg.sliding_window or 0, 96 + 2 + 1), prefetch=True,
                         device="cuda")
    alive = np.flatnonzero(store.alive)
    qs = alive[np.random.default_rng(31).choice(alive.size, 4, replace=False)]
    qe = store.h_feat[qs]
    # the launch-time snapshot, on the CPU
    snap = RGLPipeline(graph=dataclasses.replace(pipe.graph, nbr=pipe.graph.nbr.cpu(),
                                                 nbr_mask=pipe.graph.nbr_mask.cpu()),
                       index=dataclasses.replace(pipe.index, emb=pipe.index.emb.cpu(),
                                                 valid=pipe.index.valid.cpu()),
                       node_emb=pipe.node_emb.cpu(), config=pipe.config, device="cpu")
    t0 = time.perf_counter()
    want = snap.retrieve_many(qe, batch_size=4)
    cpu_s = time.perf_counter() - t0
    old_ptr = pipe.graph.nbr.data_ptr()
    old_shape, old_bytes = tuple(pipe.graph.nbr.shape), pipe.graph.nbr.numel() * 4
    side = eng.prefetcher.side_stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(4 * SLEEP_CYCLES)
    for u, q in enumerate(qs):
        eng.submit(RAGRequest(uid=u, query_emb=qe[u], query_text=" ".join(
            g.node_text[int(q)].split()[:4]) if int(q) < len(g.node_text) else "new node",
            max_new_tokens=2))
    eng._launch_pending()
    assert eng.prefetcher.in_flight == 1 and eng.prefetcher.ready_index() is None
    eng.apply_mutations(MutationBatch(del_nodes=qs))  # fold on the current stream
    junk = [torch.full(old_shape, -7, dtype=torch.int32, device="cuda") for _ in range(3)]
    waiting = not eng.prefetcher._waves[0].arrs[0].event.query()
    store.compact()  # new base, index and embeddings on the current stream
    junk += [torch.full(old_shape, -7, dtype=torch.int32, device="cuda") for _ in range(3)]
    reused = any(j.data_ptr() == old_ptr for j in junk)
    done = {r.uid: r for r in eng.run_to_completion()}
    for u in range(4):
        row = want.nodes[u][want.mask[u]].numpy()
        assert np.array_equal(done[u].retrieved_nodes, row), ("torn read", u)
    s = eng.cache.stats()
    assert s["stale_rejects"] >= 1, s
    del junk
    rec = {"torn_read_probe": "served nodes equal the launch-time snapshot's CPU retrieval",
           "card": card, "wave_waiting_at_overwrite": waiting,
           "old_snapshot_memory_reused": reused, "snapshot_nbr_bytes": old_bytes,
           "stale_rejects": s["stale_rejects"], "invalidated": s["invalidated"],
           "cpu_reference_s": cpu_s}
    print(json.dumps(rec), flush=True)
    assert waiting, "the wave ran before the overwrite: the probe tested nothing"
    return rec


def compaction_check(card: str, store) -> dict:
    """``compact()`` of a mutated full-scale IVF store against
    ``MutableGraphStore.build(..., active=True, alive=...)`` on the merged
    corpus with the same quantizer: merged graph, embeddings, index rows,
    lists and counts bit for bit; the compaction timed in seconds."""
    from repro_torch.core.mutation import MutableGraphStore
    from repro_torch.graph.csr import CSRGraph

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store.compact()
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    n = store.n_nodes
    src, dst = store.delta.live_edge_list()
    g2 = CSRGraph.from_edges(src, dst, n, node_feat=store.h_feat[:n].copy(),
                             node_text=list(store.node_text[:n]))
    t0 = time.perf_counter()
    fresh = MutableGraphStore.build(
        g2, index_kind="ivf", alive=store.alive, active=True, device="cuda",
        index_kw={"centroids": store.index.centroids.cpu().numpy(),
                  "nprobe": store.index.nprobe})
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    a, b = store.index, fresh.index
    for name, x, y in (("nbr", store.graph.nbr, fresh.graph.nbr),
                       ("nbr_mask", store.graph.nbr_mask, fresh.graph.nbr_mask),
                       ("node_emb", store.node_emb, fresh.node_emb), ("index.emb", a.emb, b.emb),
                       ("valid", a.valid, b.valid)):
        assert torch.equal(x, y), name
    assert np.array_equal(a.h_lists, b.h_lists) and np.array_equal(a.h_counts, b.h_counts)
    rec = {"compaction": "bitwise equal to a from-scratch build", "card": card,
           "compact_s": compact_s, "from_scratch_build_s": build_s, "nodes": n,
           "alive": int(store.alive.sum()), "capacity": store.capacity,
           "base_width": store.delta.base_deg, "lists": list(a.h_lists.shape),
           "active_tier_bytes": tier_bytes(store)}
    print(json.dumps(rec), flush=True)
    return rec


def mutation_cross_device_check(reduced_cfg) -> dict:
    """The gate of item 13: reduced fp32, the 3,000-node graph, the
    launcher's seeded writer (``--mutate-rate 0.3 --compact-every 2``),
    continuous admission (so that retrieval runs between batches), sync and
    prefetched (depth = slots) on a virtual clock, on the card and on the
    CPU with the same weights: per-uid outcomes, cache hits and misses, and
    the epoch, compactions, invalidations and stale rejects agree."""
    from repro_torch.launch.serve import _serve_rag

    distinct = np.random.default_rng(0).choice(3000, 8, replace=False)
    q_ids = np.concatenate([distinct, distinct[:4]])
    keys = ("hits", "misses", "retrieval_batches", "mutation_batches", "mutation_epoch",
            "mutation_compactions", "mutation_n_nodes", "mutation_alive_nodes", "invalidated",
            "stale_rejects", "graph_epoch", "prefetch_waves", "decode_steps")
    summary, params = {}, None
    for name, pf in (("sync", False), ("prefetch", True)):
        kw = dict(nodes=3000, cache_len=112, mutate_rate=0.3, compact_every=2, prefetch=pf,
                  admission="continuous")
        card = _serve_rag(reduced_cfg, serve_args(**kw), q_ids=q_ids, params=params,
                          **virtual_clock())
        params = card["params"]
        host = to_device(params, "cpu")
        cpu = _serve_rag(reduced_cfg, serve_args(device="cpu", **kw), q_ids=q_ids, params=host,
                         **virtual_clock())
        runs = [{r.uid: r for r in out["done"]} for out in (card, cpu)]
        assert sorted(runs[0]) == sorted(runs[1]) == list(range(12)), name
        for uid, a in runs[0].items():
            assert outcome(a) == outcome(runs[1][uid]), (name, uid)
        sa, sb = card["stats"], cpu["stats"]
        for key in keys:
            assert sa[key] == sb[key], (name, key, sa[key], sb[key])
        summary[name] = {k: sa[k] for k in keys}
    assert all(summary[m]["mutation_batches"] > 0 for m in summary), summary
    return summary


def mutation_phase(card: str, cfg, stack) -> dict:
    """Queue 1 item 13 at full width: (a) a pristine store-backed serve equal
    to the frozen one; (b) mutating serves (brute sync, brute prefetched,
    IVF sync), each beside the frozen serve of its schedule; (c) steady
    applies timed, then the retrieval kernels on merged graphs and
    delete-masked candidates; (d) the torn-read probe; (e) a full-scale
    compaction against a from-scratch build.  One summary line."""
    from repro_torch.core.pipeline import index_from_config

    t0 = time.perf_counter()
    rng = np.random.default_rng(13)
    distinct = np.random.default_rng(0).choice(N_NODES, 8, replace=False)
    q_ids = np.concatenate([distinct, distinct[:4]])
    zero = zero_mutation_serve(cfg, stack, q_ids)
    frozen = {}  # the frozen serves of the mutating serves' schedule
    pipe = stack["pipe"]
    ivf_cfg = dataclasses.replace(pipe.config, index_kind="ivf")
    ivf_pipe = dataclasses.replace(pipe, config=ivf_cfg, index=index_from_config(
        pipe.node_emb, ivf_cfg, device=pipe.device))
    for index, p in (("brute", pipe), ("ivf", ivf_pipe)):
        args = serve_args(admission="continuous", prefetch_depth=1, index=index)
        out, launches, overflow_rows = counted_serve(cfg, args, q_ids, stack={**stack, "pipe": p})
        check_serve_launches(out, launches, overflow_rows, index)
        frozen[index] = {"tok_per_s": out["tok_per_s"],
                         "decode_ms_per_step": out["decode_ms_per_step"]}
    runs = {"brute_sync": mutation_serve(card, "brute_sync", cfg, stack, q_ids, frozen["brute"]),
            "brute_prefetch": mutation_serve(card, "brute_prefetch", cfg, stack, q_ids,
                                             frozen["brute"], prefetch=True),
            "ivf_sync": mutation_serve(card, "ivf_sync", cfg, stack, q_ids, frozen["ivf"],
                                       index="ivf")}
    del runs["brute_sync"]["store"]
    gc.collect()
    torch.cuda.empty_cache()
    kernels = merged_kernels_check(card, runs["brute_prefetch"]["store"],
                                   runs["ivf_sync"]["store"], stack, rng)
    probe = torn_read_probe(card, cfg, stack, runs["brute_prefetch"]["store"])
    compaction = compaction_check(card, runs["ivf_sync"]["store"])
    summary = {"card": card, "phase_s": time.perf_counter() - t0, "zero_mutation": zero,
               "runs": {k: {f: v["record"][f] for f in (
                   "batches", "epoch", "compactions", "invalidated", "stale_rejects",
                   "apply_ms_median", "apply_ms_max", "fold_ms_median", "active_tier_bytes",
                   "tok_per_s", "frozen_tok_per_s", "launches_a_wave")}
                   for k, v in runs.items()},
               "steady_applies": kernels["steady_applies"],
               "hop_ms_frozen_merged": {
                   k: [v["frozen_hop_ms"], v["hop_ms"], v["merged_shape"][1], v["bfs_plan"]["rows"]]
                   for k, v in kernels["hops"].items()},
               "torn_read_unchanged": True,
               "probe_memory_reused": probe["old_snapshot_memory_reused"],
               "compact_s": compaction["compact_s"]}
    print(json.dumps({"mutation_phase": summary}), flush=True)
    return summary


def profile_decode(engine, steps: int = 5) -> dict:
    """Where a decode step's time goes: host wall time per step (timed
    without the profiler) against the summed time of the kernels a step
    runs on the card (from a ``torch.profiler`` trace of the next steps)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(1)
    for u in range(engine.slots):
        engine.submit(Request(uid=1000 + u, prompt_ids=rng.integers(6, engine.cfg.vocab, 90)
                              .astype(np.int32), max_new_tokens=2 * steps + 3))
    engine.step()  # admission + first decode step, outside both windows
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
    by_name = kernel_ms_by_name(prof, steps)
    n_kernels = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    engine.run_to_completion()
    if not by_name:
        return {"wall_ms_per_step": wall, "device_busy_ms_per_step": "not measured"}
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms_per_step": wall, "device_busy_ms_per_step": busy,
            "device_idle_share": 1 - busy / wall, "kernels_per_step": n_kernels / steps,
            "top_kernels_ms_per_step": dict(top)}



# ------------------------------------------------------------ Granite-MoE ----
GRANITE = "granite-moe-1b-a400m"


@contextlib.contextmanager
def moe_annotated():
    """``moe_ffn``, the router and the grouped products wrapped in
    ``record_function`` ranges for one profiled window (the package carries
    no annotation of its own)."""
    from torch.profiler import record_function

    from repro_torch.models.transformer import model as tm
    from repro_torch.models.transformer import moe

    def wrap(name, fn):
        def inner(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return inner

    saved = (tm.moe_ffn, moe.route, moe._bmm_f32)
    tm.moe_ffn = wrap("moe_ffn", saved[0])
    moe.route = wrap("moe_route", saved[1])
    moe._bmm_f32 = wrap("moe_products", saved[2])
    try:
        yield
    finally:
        tm.moe_ffn, moe.route, moe._bmm_f32 = saved


def range_device(prof, name: str, per: int) -> tuple[float, float]:
    """(device ms, kernels) per ``per`` of the kernels launched inside the
    CPU ranges called ``name`` (their own and their children's)."""
    def kernels(ev):
        return len(ev.kernels) + sum(kernels(c) for c in ev.cpu_children)

    evs = [e for e in prof.events()
           if e.name == name and e.device_type == torch.autograd.DeviceType.CPU]
    return (sum(e.device_time_total for e in evs) / 1e3 / per,
            sum(kernels(e) for e in evs) / per)


def moe_decode_split(engine, steps: int = 5, traces: int = 3) -> dict:
    """The MoE FFN's device ms a decode step: the router (fp32 logits,
    softmax, top-k, ranks, aux), the grouped products (three bmms) and the
    rest (dispatch scatter, SwiGLU, combine), from a profiled window of
    ``steps`` steps with the MoE functions annotated; its kernels a step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(2)
    for u in range(engine.slots):  # 30 + 70 tokens: the windows' steps fit any arena here
        engine.submit(Request(uid=2000 + u, prompt_ids=rng.integers(6, engine.cfg.vocab, 30)
                              .astype(np.int32), max_new_tokens=70))
    engine.step()
    for _ in range(traces):
        torch.cuda.synchronize()
        with moe_annotated(), profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                engine.step()
            torch.cuda.synchronize()
        (ffn, n_ffn), (route, _), (prods, _) = (range_device(prof, n, steps) for n in MOE_RANGES)
        if ffn > 0:
            break
    engine.abort(reason="profile window over")
    if ffn <= 0:
        return {"moe_device_ms_per_step": "not measured"}
    return {"moe_device_ms_per_step": ffn, "router_ms": route, "grouped_products_ms": prods,
            "dispatch_swiglu_combine_ms": ffn - route - prods, "moe_kernels_per_step": n_ffn}


def weight_bounds(cfg, params) -> dict:
    """Bytes a decode step must read at 4 slots x top-8 (cap 8: every
    expert is fed, so every weight is read; the embedding only for 4 rows)
    and the least time they take at the card's memory rate."""
    from repro_torch.tree import tree_leaves

    nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
    moe_bytes = sum(nbytes(t) for t in tree_leaves(params["layers"]["moe"]))
    step_bytes = (sum(nbytes(t) for t in tree_leaves(params)) - nbytes(params["embed"])
                  + 4 * cfg.d_model * params["embed"].element_size())
    return {"moe_weight_bytes": moe_bytes, "moe_bound_ms": 1e3 * moe_bytes / HBM_BYTES_PER_S,
            "step_weight_bytes": step_bytes,
            "step_bound_ms": 1e3 * step_bytes / HBM_BYTES_PER_S}


@contextlib.contextmanager
def first_prefill_routes(n_layers: int):
    """Records the router's ``keep`` masks of the first prefill call (one
    a layer) and that call's ``true_len``, without a host sync."""
    from repro_torch.models.transformer import model as tm
    from repro_torch.models.transformer import moe

    rec: dict = {"keep": [], "true_len": None}
    route, prefill = moe.route, tm.prefill

    def recording_prefill(params, tokens, true_len, *a, **kw):
        if rec["true_len"] is None:
            rec["true_len"] = true_len
            rec["active"] = True
        try:
            return prefill(params, tokens, true_len, *a, **kw)
        finally:
            rec["active"] = False

    def recording_route(params, x, cfg):
        r = route(params, x, cfg)
        if rec.get("active") and len(rec["keep"]) < n_layers:
            rec["keep"].append(r["keep"])
        return r

    moe.route, tm.prefill = recording_route, recording_prefill
    try:
        yield rec
    finally:
        moe.route, tm.prefill = route, prefill


def drop_shares(rec: dict, moe_cfg) -> dict:
    """Shares of dropped (token, slot) pairs over the first prefill's
    layers: of every row (padding included) and of the prompts' rows."""
    from repro_torch.models.transformer import moe

    keep = torch.stack(rec["keep"]).cpu()  # (L, B*S, k)
    tl = rec["true_len"].cpu()
    b = tl.shape[0]
    s = keep.shape[1] // b
    real = (torch.arange(s)[None, :] < tl[:, None]).reshape(-1)
    dropped = ~keep
    return {"rows": b * s, "prompt_rows": int(real.sum()), "cap": moe.capacity(moe_cfg, b * s),
            "dropped_share_all_pairs": float(dropped.float().mean()),
            "dropped_share_prompt_pairs": float(dropped[:, real].float().mean()),
            "dropped_pairs_by_layer": dropped.sum(dim=(1, 2)).tolist()}


@contextlib.contextmanager
def prefill_batches():
    """Records, per uid, the prefill batch that gave it its first token and
    KV rows: (bucket, the batch's prompts in row order).  The MoE's capacity
    is set by every row of the batch, so a uid prefilled in batches of other
    contents may be given other drops.  A uid whose prompt was adopted
    (prefix sharing) takes its donor's batch, after the serve."""
    from repro_torch.serving import engine as engine_mod

    log: dict = {}
    prefill_fresh = engine_mod.ServeEngine._prefill_fresh

    def recording(self, reqs, fresh_pairs, first_by_slot):
        prompts = [np.asarray(reqs[j].prompt_ids, np.int32) for j, _ in fresh_pairs]
        key = (engine_mod._bucket_len(max(len(p) for p in prompts), self.cache_len),
               tuple(p.tobytes() for p in prompts))
        for j, _ in fresh_pairs:
            log[reqs[j].uid] = key
        return prefill_fresh(self, reqs, fresh_pairs, first_by_slot)

    engine_mod.ServeEngine._prefill_fresh = recording
    try:
        yield log
    finally:
        engine_mod.ServeEngine._prefill_fresh = prefill_fresh


def adopted_batches(log: dict, done) -> dict:
    """``log`` with each adopted uid given the batch of the uid whose
    prompt it shares."""
    by_prompt = {np.asarray(r.prompt_ids, np.int32).tobytes(): log[r.uid]
                 for r in done if r.uid in log}
    return {r.uid: log.get(r.uid, by_prompt.get(np.asarray(r.prompt_ids, np.int32).tobytes()))
            for r in done}


def spec_drop_log(stack, q_ids, **kw) -> tuple[dict, dict]:
    """Re-serve a speculative run with the router recorded: per uid, each
    spec step's (tokens before, tokens after, whether any pair of that
    slot's verify rows was dropped).  Returns (log, the re-serve's tokens)."""
    from repro_torch.launch.serve import _serve_rag
    from repro_torch.models.transformer import moe
    from repro_torch.serving.engine import ServeEngine

    calls: list = []
    log: dict = {}
    route, step_spec = moe.route, ServeEngine._step_spec

    def recording_route(params, x, cfg):
        r = route(params, x, cfg)
        calls.append(r["keep"])
        return r

    def recording_step(self):
        before = [(i, r, len(r.out_tokens)) for i, r in enumerate(self.active)
                  if r is not None and self.live[i]]
        calls.clear()
        finished = step_spec(self)
        windows = [~c.reshape(self.slots, -1).all(dim=1) for c in calls
                   if c.shape[0] == self.slots * self.draft_window]
        assert windows, "a spec step ran no verify window through the MoE"
        lost = torch.stack(windows).any(dim=0).cpu()
        for i, req, n in before:
            log.setdefault(req.uid, []).append((n, len(req.out_tokens), bool(lost[i])))
        return finished

    moe.route, ServeEngine._step_spec = recording_route, recording_step
    try:
        out = _serve_rag(stack["cfg"], serve_args(**kw), q_ids=q_ids, stack=stack)
    finally:
        moe.route, ServeEngine._step_spec = route, step_spec
    return log, {r.uid: r.out_tokens for r in out["done"]}


def granite_run(card: str, name: str, stack, q_ids, contiguous: tuple | None = None,
                **kw) -> tuple[dict, tuple]:
    """One counted full-width Granite serve of the main path's mix: the
    retrieval kernels' launches asserted as on the StarCoder2 path, the
    allocator checked (paged), the decode profiled and the MoE's device time
    split.  Against ``contiguous`` (the one-token contiguous serve's tokens
    and prefill batches) the agreement is reported, and each uid that
    differs must be explained, at its first divergent position, as one of:
    ``prefill_batch`` (its prefill batch held other prompts, so the MoE's
    capacity differed), ``verify_drop`` (a verify window dropped one of its
    slot's pairs at or before it: a window's W rows a slot set the capacity,
    where a 4-row decode step drops nothing; ``spec_drop_log``), or
    ``near_tie`` (a bf16 near-tie in the contiguous serve's logits,
    ``one_token_margins``).  MoE speculation and prefix sharing are not
    one-token contiguous decode's function, in the reference too.  Returns
    (record, (tokens, prefill batches))."""
    args = serve_args(**kw)
    cfg, params = stack["cfg"], stack["params"]
    with first_prefill_routes(cfg.n_layers) as routes, prefill_batches() as batches:
        out, launches, overflow_rows = counted_serve(cfg, args, q_ids, stack=stack)
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_serve_launches(out, launches, overflow_rows, "brute")
    done, s, eng = out["done"], out["stats"], out["engine"].engine
    assert len(done) == len(q_ids) and all(r.done and not r.failed for r in done), name
    for r in done:
        assert len(r.out_tokens) == args.max_new and all(0 <= t < cfg.vocab for t in r.out_tokens)
    if eng.paged_kv:
        check_allocator(eng)
    toks = {r.uid: r.out_tokens for r in done}
    batches = adopted_batches(batches, done)
    rec = {"granite_run": name, "card": card, "paged_kv": s["paged_kv"],
           "prefix_share": s["prefix_share"], "spec_decode": s["spec_decode"],
           "cache_len": out["cache_len"], "max_new": args.max_new,
           "tok_per_s": out["tok_per_s"], "serve_s": out["serve_s"],
           "decode_ms_per_step": out["decode_ms_per_step"], "decode_steps": s["decode_steps"],
           "tokens_per_step": s["tokens_per_step"], "draft_accept_rate": s["draft_accept_rate"],
           "prefill_batches": s["prefill_batches"], "prefill_rows": s["prefill_rows"],
           "retrieval_batches": s["retrieval_batches"], "cache_hits": s["hits"],
           "launches": launches, "peak_mem_gb": peak,
           "first_prefill_drops": drop_shares(routes, cfg.moe)}
    if eng.paged_kv:
        rec["kv_shared_admits"] = s["kv_shared_admits"]
    if contiguous is not None:
        base, base_batches = contiguous
        rec["agreement_with_contiguous"] = token_agreement(base, toks)
        diverged = sorted(u for u in base if base[u] != toks[u])
        if diverged:
            first = {u: next(i for i, (a, b) in enumerate(zip(base[u], toks[u])) if a != b)
                     for u in diverged}
            decode = {u: (k, toks[u][k]) for u, k in first.items() if k > 0}
            margins = one_token_margins(cfg, params, q_ids, decode, base, stack=stack)
            assert margins["reproduces_one_token"], (name, margins)
            drops: dict = {}
            if s["spec_decode"]:
                log, again = spec_drop_log(stack, q_ids, **kw)
                assert again == toks, (name, "the recorded re-serve changed the tokens")
                drops = {u: any(lost for n0, _, lost in log[u] if n0 <= first[u])
                         for u in diverged}
            rec["divergence"] = {}
            for u in diverged:
                m = margins["uids"].get(u, {})
                why = [reason for reason, ok in (
                    ("prefill_batch", batches[u] != base_batches[u]),
                    ("verify_drop", drops.get(u, False)),
                    ("near_tie", m.get("spec_token_below_top", NEAR_TIE + 1) <= NEAR_TIE)) if ok]
                rec["divergence"][u] = {"first_position": first[u], **m, "explained_by": why}
    rec["decode_profile"] = profile_decode(eng)
    rec["moe_split"] = moe_decode_split(eng)
    print(json.dumps(rec), flush=True)
    unexplained = {u: d for u, d in rec.get("divergence", {}).items() if not d["explained_by"]}
    assert not unexplained, (name, unexplained)
    return rec, (toks, batches)


def lm_generator_run(stack, q_ids, engine_tokens: dict, max_new: int = 12) -> dict:
    """Stage 5 through ``RGLPipeline.run`` ending in the LM generator
    (``make_lm_generator``, greedy) on the first Q = 4 wave of the mix, with
    the serve's weights: its strings equal those of ``generate_tokens`` on
    the pipeline's prompts, whose tokens are compared with the engine's
    (the engine prefills a padded bucket of another length, so the MoE's
    capacity, and with it the drops, may differ)."""
    from repro_torch.core.generation import make_lm_generator
    from repro_torch.models.transformer import generate

    g, pipe, cfg, params = stack["g"], stack["pipe"], stack["cfg"], stack["params"]
    cache_len = pipe.tokenizer.max_len + max_new + 1
    gen = make_lm_generator(params, cfg, pipe.tokenizer.vocab, cache_len=cache_len)
    assert type(gen) is generate.LMGenerator
    qi = np.asarray(q_ids[:4])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = dataclasses.replace(pipe, generator=gen).run(
        g.node_feat[qi], [" ".join(g.node_text[i].split()[:4]) for i in qi],
        max_new_tokens=max_new)
    wall = time.perf_counter() - t0
    ids, mask = np.asarray(out["prompt_ids"]), np.asarray(out["prompt_mask"])
    toks = generate.generate_tokens(
        params, torch.from_numpy(ids).to(DEV), torch.from_numpy(mask.sum(1).astype(np.int32))
        .to(DEV), cfg, max_new=max_new, cache_len=cache_len).cpu().tolist()
    words = [" ".join(w for w in (gen.id_to_word.get(t, "") for t in row) if w) for row in toks]
    assert out["outputs"] == words, (out["outputs"], words)
    ours = {u: toks[u] for u in range(4)}
    return {"queries": 4, "max_new": max_new, "run_wall_s": wall,
            "agreement_with_engine": token_agreement({u: engine_tokens[u] for u in range(4)}, ours),
            "outputs_nonempty": sum(bool(o) for o in out["outputs"])}


def token_mode_run(card: str, arch: str, requests: int, max_new: int) -> dict:
    """``launch.serve``'s token mode (``_serve_tokens``) with the arch's
    full-width, full-depth config in bf16, seeded random weights and its own
    vocabulary: random prompts of 4-15 tokens, ``cache_len`` 128."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import _serve_tokens
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch).model_cfg
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = argparse.Namespace(requests=requests, slots=4, max_new=max_new, device=DEV)
    out = _serve_tokens(cfg, args)
    done = out["done"]
    assert len(done) == requests and all(r.done and len(r.out_tokens) == max_new for r in done)
    assert all(0 <= t < cfg.vocab for r in done for t in r.out_tokens)
    rec = {"token_mode": arch, "card": card, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab, "params": sum(t.numel() for t in tree_leaves(out["params"])),
           "requests": requests, "max_new": max_new, "cache_len": out["cache_len"],
           "setup_s": out["setup_s"], "serve_s": out["serve_s"], "tok_per_s": out["tok_per_s"],
           "decode_ms_per_step": out["decode_ms_per_step"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "decode_profile": profile_decode(out["engine"])}
    print(json.dumps(rec), flush=True)
    del out
    return rec


def granite_phase(card: str, stack) -> dict:
    """Granite-3.0-1B-A400M at full width and depth (bf16, random weights
    from seed 0, the tokenizer's vocabulary) over the main path's graph and
    pipeline: the mix served contiguous, paged + prefix sharing, and
    speculative at ``draft_window`` 4 (tokens held to the contiguous serve's
    as ``granite_run`` says); the LM generator on one wave; token mode at
    the full vocabulary (49,155).  One summary line."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import model as tm
    from repro_torch.models.transformer import moe

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(GRANITE).model_cfg, vocab=stack["cfg"].vocab)
    params = tm.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    gstack = {**stack, "cfg": cfg, "params": params}
    distinct = np.random.default_rng(0).choice(N_NODES, 8, replace=False)
    q_ids = np.concatenate([distinct, distinct[:4]])
    # one arena length for all three, so their prefill buckets (which set the
    # MoE's capacity) match: 128 takes 16-token blocks, and 64 blocks hold
    # the 4 live slots beside the 4 pinned prompts
    contiguous, toks = granite_run(card, "granite_contiguous", gstack, q_ids, cache_len=128)
    paged, _ = granite_run(card, "granite_paged_share", gstack, q_ids, toks, cache_len=128,
                           paged_kv=True, prefix_share=True, pool_blocks=64)
    assert paged["kv_shared_admits"] == 4, paged
    spec, _ = granite_run(card, "granite_spec", gstack, q_ids, toks, cache_len=128,
                          spec_decode=True, draft_window=4)
    lm = lm_generator_run(gstack, q_ids, toks[0])
    bounds = weight_bounds(cfg, params)
    del gstack, params
    tokens = token_mode_run(card, GRANITE, requests=8, max_new=12)
    runs = (contiguous, paged, spec)
    summary = {
        "card": card, "config": GRANITE, "n_layers": cfg.n_layers, "vocab": cfg.vocab,
        "bmm_out_dtype": moe.bmm_out_dtype_available(), **bounds,
        "tok_per_s": {r["granite_run"]: r["tok_per_s"] for r in runs},
        "decode_ms_per_step": {r["granite_run"]: r["decode_ms_per_step"] for r in runs},
        "device_busy_ms_per_step": {r["granite_run"]: r["decode_profile"]["device_busy_ms_per_step"]
                                    for r in runs},
        "kernels_per_step": {r["granite_run"]: r["decode_profile"].get("kernels_per_step")
                             for r in runs},
        "moe_split": {r["granite_run"]: r["moe_split"] for r in runs},
        "first_prefill_drops": contiguous["first_prefill_drops"],
        "agreement_with_contiguous": {r["granite_run"]: r["agreement_with_contiguous"]
                                      for r in runs[1:]},
        "spec_tokens_per_step": spec["tokens_per_step"], "lm_generator": lm,
        "token_mode_tok_per_s": tokens["tok_per_s"], "phase_s": time.perf_counter() - t0}
    print(json.dumps({"granite_phase": summary}), flush=True)
    return summary


def granite_cross_device_check(reduced_cfg) -> dict:
    """The MoE gate: Granite's reduced fp32 config on the card and on the
    CPU with the same weights.  The main path's mix served contiguous,
    paged + share and speculative (``draft_window`` 4): tokens, retrieved
    nodes, prompts and the decode, draft and share counters equal; the
    router of layer 0 on 512 rows (200 of them one repeated row, so its
    experts overflow): experts and kept pairs equal, ``moe_ffn``'s output
    within 1e-5 (the same fp32 sums in another order); three training
    losses within the training gate's ``rtol`` 1e-4."""
    from repro_torch.launch.serve import _serve_rag
    from repro_torch.models.transformer import model as tm
    from repro_torch.models.transformer import moe

    distinct = np.random.default_rng(0).choice(3000, 8, replace=False)
    q_ids = np.concatenate([distinct, distinct[:4]])
    cases = {"contiguous": {}, "paged_share": dict(paged_kv=True, prefix_share=True, pool_blocks=96),
             "spec": dict(spec_decode=True, draft_window=4)}
    summary, params = {}, None
    for name, kw in cases.items():
        kw = dict(nodes=3000, cache_len=112, **kw)
        card = _serve_rag(reduced_cfg, serve_args(**kw), q_ids=q_ids, params=params)
        params = card["params"]
        cpu = _serve_rag(reduced_cfg, serve_args(device="cpu", **kw), q_ids=q_ids,
                         params=to_device(params, "cpu"))
        runs = [{r.uid: r for r in out["done"]} for out in (card, cpu)]
        assert sorted(runs[0]) == sorted(runs[1]) == list(range(12)), name
        for uid, a in runs[0].items():
            b = runs[1][uid]
            assert np.array_equal(a.retrieved_nodes, b.retrieved_nodes), (name, uid)
            assert np.array_equal(a.prompt_ids, b.prompt_ids), (name, uid)
            assert (a.out_tokens, a.truncated) == (b.out_tokens, b.truncated), (name, uid)
        keys = ["decode_steps", "decode_tokens", "draft_proposed", "draft_accepted",
                "prefill_rows", "truncations"]
        if kw.get("paged_kv"):
            keys += ["kv_shared_admits", "kv_reused_tokens", "kv_cow_copies", "kv_pins",
                     "pool_high_water_blocks"]
        for key in keys:
            assert card["stats"][key] == cpu["stats"][key], (name, key)
        summary[name] = {key: card["stats"][key] for key in keys}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((512, reduced_cfg.d_model)).astype(np.float32)
    x[:200] = x[0]
    layer0 = {dev: tm.layer_params(to_device(params, dev), 0)["moe"] for dev in (DEV, "cpu")}
    routes = {dev: moe.route(layer0[dev], torch.from_numpy(x).to(dev), reduced_cfg.moe)
              for dev in (DEV, "cpu")}
    for key in ("expert", "keep", "rank"):
        assert torch.equal(routes[DEV][key].cpu(), routes["cpu"][key]), key
    ys = {dev: moe.moe_ffn(layer0[dev], torch.from_numpy(x).to(dev), reduced_cfg.moe)[0]
          for dev in (DEV, "cpu")}
    torch.testing.assert_close(ys[DEV].cpu(), ys["cpu"], atol=1e-5, rtol=1e-5)
    summary["router"] = {"rows": 512, "dropped_pairs": int((~routes["cpu"]["keep"]).sum()),
                         "y_max_abs_err": (ys[DEV].cpu() - ys["cpu"]).abs().max().item()}
    assert summary["router"]["dropped_pairs"] > 0
    summary["train_losses"] = train_cross_device_check(reduced_cfg)
    return summary


# ------------------------------------------------------------ ell_spmm ----
ELL_SHAPES = ((64, 1024, 32, 128), (32, 256, 16, 128))  # (Q, M, K, D)
# partial last slabs (D = 48, 200, 33), K past 32 slots, M = 1, K = 1, and M
# where only 16-column slabs fit, or none (the l2 variant)
ELL_EDGES = ((3, 100, 12, 48), (2, 50, 4, 200), (4, 1000, 40, 64), (5, 17, 1, 33), (3, 1, 3, 8),
             (3, 3000, 24, 128), (2, 5000, 16, 40), (2, 8000, 16, 128))
ELL_WIDTHS = (32, 16)  # fp32 slab widths timed against each other at the first regime shape
# M where only a 16-column fp32 slab fits (Q, K, D of the first regime
# shape): that slab timed against the l2 variant
ELL_NARROW = ((3000, 16),)


def ell_inputs(rng, q, m, k, d, dtype=torch.float32):
    """Features, ids in [0, M] (M the sentinel) and a 70% mask, with ids of
    M and past M under a set mask, all-masked rows and an all-masked query."""
    feat = torch.from_numpy(rng.standard_normal((q, m, d)).astype(np.float32)).to(DEV, dtype)
    nbr = torch.from_numpy(rng.integers(0, m + 1, (q, m, k)).astype(np.int32)).to(DEV)
    msk = torch.from_numpy(rng.random((q, m, k)) < 0.7).to(DEV)
    nbr[:, ::7, 0] = m
    nbr[:, ::5, -1] = m + 3
    msk[:, ::7, 0] = True
    msk[:, ::11] = False
    msk[-1, :, :] = False
    return feat, nbr, msk


def ell_path(rng) -> int:
    """The ``ell_aggregate`` op driven at the regime of the TPU kernel it
    replaces (many queries over subgraphs of M <= 1k nodes, K = 8..64
    slots); returns the launches counted in that run."""
    from repro_torch.kernels.ell_spmm import kernel, ops

    inputs = [ell_inputs(rng, *shape) for shape in ELL_SHAPES]
    kernel.launches.reset()
    outs = [ops.ell_aggregate(*x) for x in inputs]
    torch.cuda.synchronize()
    launched = kernel.launches.count
    for out, (feat, _, _) in zip(outs, inputs):
        assert out.shape == feat.shape and bool(torch.isfinite(out).all())
    assert launched == len(ELL_SHAPES), launched
    return launched


def check_ell_spmm(rng) -> dict:
    """The kernel against its plain version, bit for bit (both add the same
    fp32 values in slot order and round once), at the regime shapes and on
    edge cases (every slab width and the l2 variant, bf16, features not
    16-byte aligned); times of the kernel, the plain version and CSR
    ``torch.sparse.mm`` at both regime shapes, of each slab width at the
    first, and of the narrower slabs against the l2 variant where only they
    fit; the slab kernel's registers and spills (none allowed); the plans,
    with the blocks an SM holds, on a line of their own."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ell_spmm import kernel, ops

    plans = {}  # the plans the wrapper passed to the C entry point

    def compare(feat, nbr, msk, name):
        got = ops.ell_aggregate(feat, nbr, msk, use_kernel=True)
        torch.cuda.synchronize()
        plans[name] = dataclasses.asdict(kernel.last_plan)
        assert torch.equal(got, ops.ell_aggregate(feat, nbr, msk, use_kernel=False)), name
        assert not got[-1].any() and not got[:, ::11].any(), name

    cases = [(s, torch.float32) for s in ELL_SHAPES + ELL_EDGES]
    cases += [((8, 256, 16, 128), torch.bfloat16), ((2, 50, 4, 200), torch.bfloat16),
              ((2, 3000, 8, 96), torch.bfloat16), ((2, 7000, 8, 128), torch.bfloat16)]
    for shape, dtype in cases:
        compare(*ell_inputs(rng, *shape, dtype=dtype), f"{shape} {str(dtype)[6:]}")
    for dtype in (torch.float32, torch.bfloat16):  # slab staged by element copies
        feat, nbr, msk = ell_inputs(rng, 3, 300, 12, 128, dtype=dtype)
        unaligned = torch.empty(feat.numel() + 1, dtype=dtype, device=DEV)[1:].view_as(feat)
        compare(unaligned.copy_(feat), nbr, msk, f"(3, 300, 12, 128) {str(dtype)[6:]} unaligned")
    assert plans["(2, 8000, 16, 128) float32"]["variant"] == kernel.L2
    assert plans["(2, 7000, 8, 128) bfloat16"]["variant"] == kernel.L2
    assert [plans[f"{s} float32"]["cols"]
            for s in ((3, 3000, 24, 128), (2, 5000, 16, 40))] == [16, 0]

    def by_plan(feat, nbr, msk, cols, want) -> dict:
        """The kernel with ``cols`` slab columns forced (0: the l2 variant),
        checked against ``want`` and timed."""
        q, m, d = feat.shape
        forced = kernel.ell_plan(q, m, nbr.shape[2], d, feat.dtype, cols=cols)
        run = lambda: kernel.ell_aggregate_kernel(feat, nbr, msk, plan=forced)  # noqa: E731
        assert torch.equal(run(), want), (q, m, d, cols)
        return {"profiler_ms": device_ms(run)[0], "ms": time_ms(run), "plan": str(forced)}

    timed, widths = [], {}
    for q, m, k, d in ELL_SHAPES:
        feat, nbr, msk = ell_inputs(rng, q, m, k, d)
        run = lambda: ops.ell_aggregate(feat, nbr, msk, use_kernel=True)  # noqa: E731
        profiler_ms, kernels = device_ms(run)
        plan = kernel.last_plan
        plain_ms = time_ms(lambda: ops.ell_aggregate(feat, nbr, msk, use_kernel=False),
                           reps=3, batch=3)
        # library yardstick: one block-diagonal (Q*M) x (Q*(M+1)) CSR matrix
        # of the live slots times the features with their zero rows (built
        # untimed)
        live = msk & (nbr < m)
        qi, ri, _ = live.nonzero(as_tuple=True)
        adj = torch.sparse_coo_tensor(
            torch.stack([qi * m + ri, qi * (m + 1) + nbr[live].long()]),
            torch.ones(len(qi), device=DEV), (q * m, q * (m + 1))).coalesce().to_sparse_csr()
        dense = torch.cat([feat, feat.new_zeros((q, 1, d))], 1).reshape(q * (m + 1), d)
        lib_err = (torch.sparse.mm(adj, dense).reshape(q, m, d) - run()).abs().max().item()
        assert lib_err <= 1e-4, lib_err  # the same sums in cuSPARSE's order
        library = lambda: torch.sparse.mm(adj, dense)  # noqa: E731
        n_live = int(live.sum())
        # each input read once, the output written once; the adds at the fp32 rate
        b_ms, b_by = bound(2 * 4 * q * m * d + 5 * q * m * k, (n_live * d, FP32_FLOPS))
        shape = f"Q={q} M={m} K={k} D={d} fp32"
        timed.append({"ms": time_ms(run), "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": time_ms(library), "library_max_abs_diff": lib_err,
                      "profiler_ms": profiler_ms, "library_profiler_ms": device_ms(library)[0],
                      "device_kernels_ms": kernels, "live_slots": n_live,
                      "gather_bytes_ms": 1e3 * 4 * n_live * d / HBM_BYTES_PER_S,
                      "shape": shape})
        # the plan and, from the card, the blocks of it an SM holds (not measured)
        plans[f"timed {shape}"] = {**dataclasses.asdict(plan), "threads_per_block": kernel.THREADS,
                                   "blocks_per_sm": kernel.slab_occupancy(plan, feat.dtype)}
        if not widths:  # the slab widths against each other, at the first shape
            want = run()
            widths[shape] = {f"{cols} columns": by_plan(feat, nbr, msk, cols, want)
                             for cols in ELL_WIDTHS}
        del feat, nbr, msk, adj, dense
    q, k, d = ELL_SHAPES[0][0], ELL_SHAPES[0][2], ELL_SHAPES[0][3]
    for m, cols in ELL_NARROW:  # the narrower slabs against the l2 variant
        feat, nbr, msk = ell_inputs(rng, q, m, k, d)
        assert kernel.ell_plan(q, m, k, d, feat.dtype).cols == cols, (m, cols)
        want = ops.ell_aggregate(feat, nbr, msk, use_kernel=False)
        widths[f"Q={q} M={m} K={k} D={d} fp32"] = {
            f"{cols} columns": by_plan(feat, nbr, msk, cols, want),
            "l2": by_plan(feat, nbr, msk, 0, want)}
        del feat, nbr, msk, want
    print(json.dumps({"ell_spmm_launch_plans": plans}), flush=True)
    print(json.dumps({"ell_slab_widths": widths}), flush=True)
    # the slab kernel's registers and spills from this run's build (none
    # allowed in any instantiation)
    log = build.build_log()
    slab_build = {f"{name} RB={rb}": ptxas_report(log, f"ell_slab_kernelI{frag}Li{rb}E")
                  for name, frag in (("fp32", "f"), ("bf16", "13__nv_bfloat16"))
                  for rb in (128, 64)}
    print(json.dumps({"ell_slab_build": slab_build}), flush=True)
    for name, rep in slab_build.items():
        assert rep["spill_store_bytes"] == 0 == rep["spill_load_bytes"], (name, rep)
    return {"name": "ell_aggregate", "route": "cuda", "source": "src/repro_torch/csrc/ell_spmm.cu",
            "replaces": "src/repro/kernels/ell_spmm/kernel.py:40", "max_abs_err": 0.0,
            "library": "CSR torch.sparse.mm", **timed[0], "second_shape": timed[1],
            "kernel_build": slab_build["fp32 RB=128"]}


# --------------------------------------------------------------- indexes ----
def index_queries(emb: torch.Tensor, q: int, rng) -> torch.Tensor:
    """``q`` node features plus a little noise (the index normalizes)."""
    rows = emb[torch.from_numpy(rng.choice(emb.shape[0], q)).to(emb.device)]
    noise = torch.from_numpy(rng.standard_normal(rows.shape).astype(np.float32)).to(emb.device)
    return rows + 0.05 * rows.norm(dim=1, keepdim=True) * noise / np.sqrt(rows.shape[1])


def ivf_candidates(ivf, q: torch.Tensor):
    """The normalized queries and the (cand, cmask) that ``IVFIndex.search``
    hands the scan."""
    from repro_torch.core.indexing import ivf_candidates, l2_normalize

    qn = l2_normalize(q)
    return (qn, *ivf_candidates(ivf.centroids, ivf.lists, ivf.list_mask, qn, ivf.nprobe))


def check_ivf_scan(ivf, emb_raw: torch.Tensor, rng) -> dict:
    """The kernel (through the op) against both plain arms, bit for bit (the
    plain versions sum every dot product in the kernel's order): on the
    Arxiv-scale IVF index's candidates at Q = 4, k = 3 (a serving wave) and
    Q = 64, k = 32, and on edge cases.  Times at both shapes, registers and
    spills."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ivf_scan import kernel, ops

    plans = {}  # the plans the wrapper passed to the C entry point

    def compare(q, e, cand, cmask, k, name):
        s_k, i_k = ops.ivf_candidate_scan(q, e, cand, cmask, k, use_kernel=True)
        torch.cuda.synchronize()
        plans[name] = dataclasses.asdict(kernel.last_plan)
        for tiled in (False, True):
            s_p, i_p = ops.ivf_candidate_scan(q, e, cand, cmask, k, tiled=tiled, use_kernel=False)
            assert torch.equal(s_k, s_p) and torch.equal(i_k, i_p), (tuple(cand.shape), k, tiled)
        return s_k, i_k

    # edge cases: a row with no live slot (real ids at masked slots), W < k,
    # W not a multiple of c_blk or of a run, duplicate rows and duplicate ids
    # (exact ties), k past the 256-entry lists (the tree merge), W under one
    # warp's run, a row whose live slots all lie in its last block
    n, d = 5000, 128
    e = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(DEV)
    e[2500:3000] = e[:500].clone()
    for q, w, k in ((3, 1500, 7), (2, 5, 9), (4, 3000, 300), (1, 1, 1), (5, 2049, 32),
                    (3, 20, 7), (4, 3000, 256), (3, 14_916, 12)):
        qv = torch.from_numpy(rng.standard_normal((q, d)).astype(np.float32)).to(DEV)
        cand = torch.from_numpy(rng.integers(0, n + 1, (q, w)).astype(np.int32)).to(DEV)
        cand[:, : w // 3] = cand[:, w // 3: 2 * (w // 3)]
        cmask = torch.from_numpy(rng.random((q, w)) < 0.5).to(DEV) & (cand < n)
        cmask[-1] = False
        plan = kernel.launch_plan(q, w, min(k, w), build.sm_count(e.device))
        if q > 2:  # row 0: live slots only past its last block's start
            cmask[0, :(plan.grid_x - 1) * plan.span] = False
        _, i_k = compare(qv, e, cand, cmask, k, f"q{q}_w{w}_k{k}")
        assert torch.equal(i_k[-1, :min(k, w)], cand[-1, :min(k, w)])

    emb = ivf.emb
    shapes = {}
    log = build.build_log()
    for q, k in ((4, 3), (64, 32)):
        qn, cand, cmask = ivf_candidates(ivf, index_queries(emb_raw, q, rng))
        compare(qn, emb, cand, cmask, k, f"index_q{q}_k{k}")
        run = lambda: ops.ivf_candidate_scan(qn, emb, cand, cmask, k, use_kernel=True)  # noqa: E731
        profiler_ms, kernels = device_ms(run)
        no_sorts(kernels, "ivf_scan")
        plain_ms = time_ms(
            lambda: ops.ivf_candidate_scan(qn, emb, cand, cmask, k, use_kernel=False),
            reps=3, batch=3)

        def library():
            ce = emb[cand.clamp(max=emb.shape[0] - 1)]
            sc = torch.bmm(ce, qn[..., None]).squeeze(-1).masked_fill(~cmask, float("-inf"))
            return torch.topk(sc, k)

        w = cand.shape[1]
        live = int(cmask.sum())
        # every slot's id and mask, every live row, the queries; the output
        b_ms, b_by = bound(5 * q * w + 4 * live * d + 4 * q * d + 8 * q * k,
                           (2 * live * d, FP32_FLOPS))
        shapes[(q, k)] = {
            "ms": time_ms(run), "plain_ms": plain_ms, "library_ms": time_ms(library),
            "bound_ms": b_ms, "bound_by": b_by, "profiler_ms": profiler_ms,
            "library_profiler_ms": device_ms(library)[0],
            "device_kernels_ms": kernels, "live_rows": live,
            "all_slots_bound_ms": 1e3 * q * w * (4 * d + 5) / HBM_BYTES_PER_S,
            "shape": f"Q={q} W={w} D={d} k={k}", "ptxas": ptxas_report(log, "ivf_scan_kernel")}
    print(json.dumps({"ivf_scan_launch_plans": plans}), flush=True)
    serve, batch = shapes[(4, 3)], shapes[(64, 32)]
    return {"name": "ivf_scan", "route": "cuda", "source": "src/repro_torch/csrc/ivf_scan.cu",
            "replaces": "src/repro/kernels/ivf_scan/kernel.py:38", "max_abs_err": 0.0,
            "library": "torch.topk(torch.bmm(emb[cand], q)) with the mask",
            **serve, "batch_shape": batch}


def index_phase(feat: torch.Tensor, rng) -> tuple[dict, dict]:
    """The four index kinds at Arxiv scale (N = 169,343, D = 128): IVF built
    twice (bit for bit), the ``ivf_scan`` kernel check, each kind's search of
    a Q = 4, k = 3 wave timed with its launch counts asserted, sharded brute
    against brute, IVF recall against brute over 64 queries."""
    from repro_torch.core import indexing as ix
    from repro_torch.core.sharding import ShardedIndex

    counters = serve_counters()
    builds = {}

    def timed_build(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        idx = fn()
        torch.cuda.synchronize()
        builds[name] = time.perf_counter() - t
        return idx

    ivf = timed_build("ivf", lambda: ix.IVFIndex.build(feat, n_clusters=64, nprobe=4, device=DEV))
    again = ix.IVFIndex.build(feat, n_clusters=64, nprobe=4, device=DEV)
    for f in ("emb", "centroids", "lists", "list_mask"):
        assert torch.equal(getattr(ivf, f), getattr(again, f)), f"IVF builds differ in {f}"
    del again
    sizes = ivf.list_mask.sum(1)
    print(f"IVF index: 64 lists of {int(sizes.min())}..{int(sizes.max())} members, padded to "
          f"{ivf.lists.shape[1]}; two builds bit for bit equal ({builds['ivf']:.2f}s)", flush=True)
    record = check_ivf_scan(ivf, feat, rng)
    print("kernel check: ivf_scan matches both plain arms bit for bit", flush=True)

    s4 = 4
    indexes = {"brute": timed_build("brute", lambda: ix.BruteIndex.build(feat, device=DEV)),
               "ivf": ivf,
               "sharded": timed_build("sharded", lambda: ShardedIndex.build(
                   feat, n_shards=s4, device=DEV)),
               "sharded_ivf": timed_build("sharded_ivf", lambda: ShardedIndex.build(
                   feat, n_shards=s4, inner="ivf", device=DEV))}
    want = {"brute": {"topk_sim": 1, "ivf_scan": 0}, "ivf": {"topk_sim": 0, "ivf_scan": 1},
            "sharded": {"topk_sim": s4, "ivf_scan": 0},
            "sharded_ivf": {"topk_sim": 0, "ivf_scan": s4}}
    q4 = index_queries(feat, 4, rng)
    searches, results = {}, {}
    for name, idx in indexes.items():
        for c in counters.values():
            c.reset()
        results[name] = idx.search(q4, 3)
        torch.cuda.synchronize()
        got = {n: counters[n].count for n in ("topk_sim", "ivf_scan")}
        assert got == want[name], (name, got)
        run = lambda: idx.search(q4, 3)[1].cpu()  # noqa: E731
        dev_ms, kernels = device_ms(run)
        wall = time_ms(run)
        searches[name] = {"wall_ms": wall, "device_ms": dev_ms,
                          "device_idle_share": 1 - dev_ms / wall, "launches": got,
                          "device_ms_split": split_kernels(kernels)}
    (bs, bi), (ss, si) = results["brute"], results["sharded"]
    assert torch.equal(bi, si), "sharded brute ids differ from brute ids"
    ulps = (bs.view(torch.int32) - ss.view(torch.int32)).abs().max().item()
    assert ulps <= 4, f"sharded brute scores {ulps} ulp from brute"
    q64 = index_queries(feat, 64, rng)
    _, b32 = indexes["brute"].search(q64, 32)
    recall = {}
    for name in ("ivf", "sharded_ivf"):
        _, i32 = indexes[name].search(q64, 32)
        recall[name] = {f"recall@{k}": float(np.mean([
            len(set(i32[r, :k].tolist()) & set(b32[r, :k].tolist())) / k for r in range(64)]))
            for k in (3, 32)}
    out = {"build_s": builds, "search_q4_k3": searches, "sharded_brute_max_ulp": ulps,
           "recall_vs_brute_64_queries": recall, "ivf_lists": ivf.lists.shape[1]}
    del indexes, ivf, results
    return out, record


def cross_device_index_check(feat_cpu: np.ndarray, rng) -> dict:
    """IVF and sharded IVF built on the CPU and moved to the card: the
    card's search (the kernels) equals the CPU's (the plain versions), ids
    exactly, scores within 1e-6 (the probe's q . centroids is a cuBLAS
    product on the card).  Then Lloyd's iterations on both devices from the
    same normalized rows and initial centroids: the largest centroid gap and
    the number of assignments that differ (a reading)."""
    from repro_torch.core import indexing as ix
    from repro_torch.core.sharding import ShardedIndex

    q = index_queries(torch.from_numpy(feat_cpu), 64, rng)
    out = {}
    for name, build in (("ivf", lambda: ix.IVFIndex.build(feat_cpu, device="cpu")),
                        ("sharded_ivf", lambda: ShardedIndex.build(
                            feat_cpu, n_shards=4, inner="ivf", device="cpu"))):
        cpu = build()
        card = cpu.to(DEV) if isinstance(cpu, ShardedIndex) else type(cpu)(
            **{f: (v.to(DEV) if torch.is_tensor(v) else v) for f, v in vars(cpu).items()})
        s_h, i_h = cpu.search(q, 32)
        s_c, i_c = card.search(q.to(DEV), 32)
        assert torch.equal(i_c.cpu(), i_h), f"{name}: card ids differ from the CPU's"
        gap = (s_c.cpu() - s_h).abs().max().item()
        assert gap <= 1e-6, (name, gap)
        out[name] = {"max_score_gap": gap}
    x = ix.l2_normalize(torch.from_numpy(feat_cpu))
    init = x[torch.from_numpy(np.random.default_rng(0).choice(x.shape[0], 64, replace=False))]
    cent_h, a_h = ix._lloyd(x, init, 10)
    cent_c, a_c = ix._lloyd(x.to(DEV), init.to(DEV), 10)
    out["kmeans"] = {"max_centroid_gap": (cent_c.cpu() - cent_h).abs().max().item(),
                     "assignments_differing": int((a_c.cpu() != a_h).sum())}
    return out


# ------------------------------------------------------- flash attention ----
FLASH_KERNELS = (("flash_attn_fwd", "fwd_launches", "src/repro/kernels/flash_attn/kernel.py:86"),
                 ("flash_attn_bwd_dq", "dq_launches", "src/repro/models/transformer/attention.py:143"),
                 ("flash_attn_bwd_dkv", "dkv_launches", "src/repro/models/transformer/attention.py:143"))


def flash_counters() -> dict:
    from repro_torch.kernels.flash_attn import kernel

    return {name: getattr(kernel, attr) for name, attr, _ in FLASH_KERNELS}


def valid_pairs(s: int, window) -> int:
    """(q, k) pairs with k <= q and q - k < window, per head."""
    w = s if window is None else min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def sdpa(q, k, v):
    """The library yardstick on (B, H, S, dh) tensors: causal attention with
    GQA (timed only; the port never calls it)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)


def flash_close(got, want, row_share: float, name: str) -> float:
    """Asserts ``|got - want| <= row_share * (the row's max |want|) + 1e-5 *
    max |want| + 2^-7 * |want|`` element by element, rows along the last
    axis (see ``check_flash``); returns the largest share of that tolerance
    any element used."""
    mag = want.abs()
    tol = row_share * mag.amax(-1, keepdim=True) + 1e-5 * mag.max() + 2**-7 * mag
    ratio = (got - want).abs() / tol
    worst = ratio.max().item()
    assert worst <= 1.0, (f"{name}: {int((ratio > 1).sum())} of {ratio.numel()} elements "
                          f"outside the tolerance, worst at {worst:.3g} of it")
    return worst


def ptxas_report(log: str, fragment: str) -> dict:
    """Registers and spill bytes of the kernel whose mangled name holds
    ``fragment``, from nvcc's ``-Xptxas -v`` report (``build.build_log()``),
    and whether ptxas serialized its wgmmas."""
    lines = log.splitlines()
    start = next(i for i, line in enumerate(lines)
                 if "Compiling entry function" in line and fragment in line)
    end = next((i for i in range(start + 1, len(lines))
                if "Compiling entry function" in lines[i]), len(lines))
    body = "\n".join(lines[start:end])
    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
    return {"registers": int(re.search(r"Used (\d+) registers", body).group(1)),
            "spill_store_bytes": int(spill.group(1)), "spill_load_bytes": int(spill.group(2)),
            "wgmma_serialized": any("serialized" in line and fragment in line for line in lines)}


def check_flash(cfg, rng: np.random.Generator) -> list:
    """The three flash kernels against their plain versions at the training
    shape (B = 1, S = 4096, StarCoder2-3B's heads, window 4096, bf16), with
    times of the kernel, the plain version and SDPA.

    Tolerances: lse and delta are fp32 (``atol`` 1e-4: the same products
    summed in another order over 4096 keys).  o, dq, dk and dv are bf16 and
    are held element by element (``flash_close``): ``rtol`` 2^-7, one bf16
    ulp, since both sides round an fp32 result once; plus an ``atol`` scaled
    to the element's own row (the last axis: a query row of o and dq, a key
    row of dk and dv), not to the whole tensor, whose largest rows (the
    first queries, the first keys) are many times the typical row at 4096
    keys.  o's row share is 2^-7: p is rounded to bf16 before P·V, and a
    last-bit difference in an fp32 score can round one p the other way,
    moving o by at most 2^-8·(p/l)·|v|, under 2^-7 of the row's largest
    element for every row with two or more keys.  The backward keeps p, dp
    and ds in fp32 (the tensor-core kernels feed p and ds to their products
    as hi/lo bf16 pairs, exact to 2^-17), so only the summation order
    differs: its row share is 2^-10.  A floor of 1e-5 of the tensor's
    largest element covers rows that cancel to zero (dq's first row, where
    ds = p·(dp − delta) = 0).  On the H100 the largest share of the
    tolerance any element used read, with the tensor-core kernels, o 0.50,
    dq 0.86, dk 0.85, dv 0.83 (0.49, 0.82, 0.85, 0.79 with the CUDA-core
    kernels): one-ulp rounding differences of elements just above a power
    of two.  A dv with one rep head's share dropped, or an o off by 2%,
    fails it (checked on the plain versions on the CPU); so does rounding p
    and ds to one bf16 each (``tests/test_torch_flash_attn.py``)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attn import kernel, ref

    b, s, h, kv, dh, w = 1, 4096, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.sliding_window
    assert w is None or w >= s  # SDPA's is_causal is then the same function
    cq = cfg.q_chunk
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                   .to(DEV, torch.bfloat16)
                   for shape in ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh), (b, s, h, dh)))
    use = {}  # the largest share of its tolerance that any element used

    def close(got, want, name, exact_f32=False):
        got, want = got.float(), want.float()
        err = (got - want).abs().max().item()
        if exact_f32:
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5, msg=name)
        else:
            use[name] = flash_close(got, want, 2**-7 if name == "o" else 2**-10, name)
        return err

    o_k, lse_k = kernel.flash_fwd_kernel(q, k, v, w)
    torch.cuda.synchronize()
    o_p, lse_p = ref.flash_fwd(q, k, v, w, cq, cq)
    errs = {"o": close(o_k, o_p, "o"), "lse": close(lse_k, lse_p, "lse", True)}
    dq_k, delta_k = kernel.flash_bwd_dq_kernel(q, k, v, o_p, do, lse_p, w)
    dk_k, dv_k = kernel.flash_bwd_dkv_kernel(q, k, v, do, lse_p, delta_k, w)
    torch.cuda.synchronize()
    dq_p, delta_p = ref.flash_bwd_dq(q, k, v, o_p, do, lse_p, w, cq, cq)
    dk_p, dv_p = ref.flash_bwd_dkv(q, k, v, do, lse_p, delta_p, w, cq, cq)
    errs.update(delta=close(delta_k, delta_p, "delta", True), dq=close(dq_k, dq_p, "dq"),
                dk=close(dk_k, dk_p, "dk"), dv=close(dv_k, dv_p, "dv"))
    print(f"flash kernels match their plain versions at B={b} S={s} H={h} KV={kv} dh={dh} "
          f"window={w} bf16: max abs err {errs}, largest share of the tolerance used {use}",
          flush=True)

    # times: kernel, plain version, SDPA (on (B, H, S, dh) copies, GQA).  The
    # kernels and SDPA are timed with CUDA events: here, late in this script,
    # the profiler's sums have read these kernels as low as 0.47x of their
    # event times on an H100 (dq 0.205 ms: faster than the bf16 peak allows),
    # while the training step's profiled launches agree with the events.  The
    # profiler's sum stays beside them as ``profiler_ms``, with its split.
    fns = (lambda: kernel.flash_fwd_kernel(q, k, v, w),
           lambda: kernel.flash_bwd_dq_kernel(q, k, v, o_p, do, lse_p, w),
           lambda: kernel.flash_bwd_dkv_kernel(q, k, v, do, lse_p, delta_p, w))
    fwd_ms, dq_ms, dkv_ms = (time_ms(fn) for fn in fns)
    (fwd_prof, fwd_k), (dq_prof, dq_k_ms), (dkv_prof, dkv_k_ms) = (device_ms(fn) for fn in fns)
    plain_fwd, _ = device_ms(lambda: ref.flash_fwd(q, k, v, w, cq, cq), calls=3)
    plain_dq, _ = device_ms(lambda: ref.flash_bwd_dq(q, k, v, o_p, do, lse_p, w, cq, cq), calls=3)
    plain_dkv, _ = device_ms(lambda: ref.flash_bwd_dkv(q, k, v, do, lse_p, delta_p, w, cq, cq),
                             calls=3)
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    lib_fwd = time_ms(lambda: sdpa(qt, kt, vt))
    _, lib_fwd_k = device_ms(lambda: sdpa(qt, kt, vt))
    qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))
    o_lib = sdpa(qg, kg, vg)
    lib_bwd = time_ms(lambda: torch.autograd.grad(o_lib, (qg, kg, vg), dot, retain_graph=True))
    lib_err = (o_lib.detach().transpose(1, 2).float() - o_k.float()).abs().max().item()

    pairs = h * valid_pairs(s, w)
    q_bytes, kv_bytes, row_bytes = 2 * q.numel(), 2 * k.numel(), 4 * b * h * s
    prod = 2 * dh * pairs  # flops of one (q, k)-pair product over dh
    dq_bytes = 4 * q_bytes + 2 * kv_bytes + 2 * row_bytes
    dkv_bytes = 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes
    # the backward kernels run every product as bf16 wgmmas: s, dp and each
    # product with an fp32 operand (p or ds) as its hi/lo split, two bf16
    # products (dq: s, dp, hi(ds)·k, lo(ds)·k; dk/dv: s, dp and the split
    # pᵀ·do and dsᵀ·q)
    bounds = {
        "flash_attn_fwd": bound(2 * q_bytes + 2 * kv_bytes + row_bytes, (2 * prod, BF16_TENSOR_FLOPS)),
        "flash_attn_bwd_dq": bound(dq_bytes, (4 * prod, BF16_TENSOR_FLOPS)),
        "flash_attn_bwd_dkv": bound(dkv_bytes, (6 * prod, BF16_TENSOR_FLOPS)),
    }
    # the same with the products that take p or ds on fp32 FMAs at fp32's rate
    fp32_operand = {"flash_attn_bwd_dq": bound(dq_bytes, (2 * prod, BF16_TENSOR_FLOPS),
                                               (prod, FP32_FLOPS))[0],
                    "flash_attn_bwd_dkv": bound(dkv_bytes, (2 * prod, BF16_TENSOR_FLOPS),
                                                (2 * prod, FP32_FLOPS))[0]}
    times = {"flash_attn_fwd": (fwd_ms, plain_fwd, lib_fwd, max(errs["o"], errs["lse"])),
             "flash_attn_bwd_dq": (dq_ms, plain_dq, lib_bwd, max(errs["dq"], errs["delta"])),
             "flash_attn_bwd_dkv": (dkv_ms, plain_dkv, lib_bwd, max(errs["dk"], errs["dv"]))}
    records = []
    for name, _, replaces in FLASH_KERNELS:
        ms, plain_ms, lib_ms, err = times[name]
        b_ms, b_by = bounds[name]
        records.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/csrc/flash_attn.cu",
            "replaces": replaces, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "library": ("scaled_dot_product_attention forward" if name.endswith("fwd") else
                        "scaled_dot_product_attention backward (dq, dk and dv together)"),
            "bound_fp32_all_ms": 1e3 * (2 if name.endswith("fwd") else
                                        3 if name.endswith("dq") else 4) * prod / FP32_FLOPS,
            **({"bound_fp32_operand_ms": fp32_operand[name]} if name in fp32_operand else {}),
            "shape": f"B={b} S={s} H={h} KV={kv} dh={dh} window={w} bf16 pairs={pairs}",
        })
    for rec, names in zip(records, (("o",), ("dq",), ("dk", "dv"))):
        rec["tolerance_share_used"] = max(use[n] for n in names)
    records[0]["sdpa_vs_kernel_max_abs_diff"] = lib_err
    records[0]["library_kernels_ms"] = lib_fwd_k
    # the tensor-core kernels' registers, spills, shared memory and blocks an
    # SM, and the backward's split bf16 products at the tensor rate
    # (bound_ms's operations term).  The forward's head group (query heads of
    # one KV head a block) is its threads / 128; its template names dh, then
    # the head group.
    log = build.build_log()
    head_group = kernel.tc_occupancy(2, dh, h // kv)[0] // 128
    for rec, n_prod, pass_, frag in (
            (records[0], None, 2, f"flash_fwd_kernel_wgmmaILi{dh}ELi{head_group}E"),
            (records[1], 4, 0, f"flash_bwd_dq_kernel_wgmmaILi{dh}E"),
            (records[2], 6, 1, f"flash_bwd_dkv_kernel_wgmmaILi{dh}E")):
        if n_prod:
            rec["bound_designed_ms"] = 1e3 * n_prod * prod / BF16_TENSOR_FLOPS
        threads, smem, blocks = kernel.tc_occupancy(pass_, dh, h // kv)
        rec["kernel_build"] = {**ptxas_report(log, frag), "threads_per_block": threads,
                               "dynamic_smem_bytes": smem, "blocks_per_sm": blocks}
        assert rec["kernel_build"]["spill_store_bytes"] == 0, (frag, rec["kernel_build"])
    records[0]["head_group"] = head_group
    records[2]["reduce_build"] = ptxas_report(log, "flash_bwd_dkv_reduce_kernel")
    records[2]["head_groups"] = kernel.dkv_plan(q.device.index, b, s, h, kv, dh, w or 0, 1)[0]
    for rec, prof_ms, by_name in zip(records, (fwd_prof, dq_prof, dkv_prof),
                                     (fwd_k, dq_k_ms, dkv_k_ms)):
        rec["profiler_ms"], rec["device_kernels_ms"] = prof_ms, by_name
    del qg, kg, vg, o_lib
    return records


# -------------------------------------------------------------- training ----
STEP_GROUPS = (("flash_fwd", "flash_fwd_kernel"), ("flash_bwd_dq", "flash_bwd_dq_kernel"),
               ("flash_bwd_dkv", "flash_bwd_dkv_kernel"), ("flash_bwd_dkv", "flash_bwd_dkv_reduce"),
               ("gemm", "nvjet"), ("gemm", "gemm"), ("gemm", "xmma"), ("gemm", "cutlass"))


def split_step(by_name: dict) -> dict:
    """Device ms of a training step grouped as the three flash kernels,
    cuBLAS GEMMs and everything else (elementwise, reductions, copies)."""
    out: dict = {}
    for name, ms in by_name.items():
        group = next((g for g, frag in STEP_GROUPS if frag in name), "other")
        out[group] = out.get(group, 0.0) + ms
    return out

def opt_config(steps: int):
    """AdamW as the reference launcher configures it."""
    from repro_torch.training import AdamWConfig

    return AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=steps)


def train_step_fn(cfg, n_micro: int, steps: int, use_kernel=None):
    from repro_torch.models.transformer import model as tm
    from repro_torch.training import make_train_step

    return make_train_step(
        lambda p, b: tm.lm_loss(p, b["tokens"], b["loss_mask"], cfg, use_kernel=use_kernel),
        opt_config(steps), n_microbatches=n_micro)


def train_phase(cfg, steps: int = 3, batch: int = 2, n_micro: int = 2, seq: int = 4096):
    """The training main path: ``make_train_step`` + ``TrainLoop`` on the
    full-width, full-depth config at the train_4k sequence length, random
    tokens; every step profiled.  Returns (summary, the trained params)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.train import _lm_data
    from repro_torch.models.transformer import model as tm
    from repro_torch.training import TrainLoop

    t0 = time.perf_counter()
    params = tm.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    init_state, step = train_step_fn(cfg, n_micro, steps)
    state = init_state(params)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    counters = flash_counters()
    traces: list = []

    def profiled_step(state, batch_):
        before = {n: c.count for n, c in counters.items()}
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, m = step(state, batch_)
            torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
        traces.append((prof, m, wall, torch.cuda.max_memory_allocated() / 1e9,
                       {n: c.count - before[n] for n, c in counters.items()}))
        return state, m

    data = _lm_data(cfg, batch, seq, seed=0, device=DEV)
    for c in counters.values():
        c.reset()
    state, history = TrainLoop(step_fn=profiled_step, data_iter=data, log_every=1).run(state, steps)
    launches = {n: c.count for n, c in counters.items()}
    per_step = []
    for i, (prof, m, wall, peak, counts) in enumerate(traces):
        by_name = kernel_ms_by_name(prof, 1)
        rec = {"step": i + 1, "loss": float(m["loss"]), "nll": float(m["nll"]),
               "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]), "wall_ms": wall,
               "device_ms": sum(by_name.values()), "device_ms_split": split_step(by_name),
               "peak_mem_gb": peak, "launches": counts}
        if i == 0:
            rec["top_kernels_ms"] = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12])
        per_step.append(rec)
        print(json.dumps({"train_step": rec}), flush=True)
    del traces
    L = cfg.n_layers
    for rec in per_step:  # remat runs each layer's forward twice
        assert rec["launches"] == {"flash_attn_fwd": 2 * L * n_micro,
                                   "flash_attn_bwd_dq": L * n_micro,
                                   "flash_attn_bwd_dkv": L * n_micro}, rec["launches"]
        assert np.isfinite(rec["loss"]) and np.isfinite(rec["grad_norm"]), rec
    assert launches == {"flash_attn_fwd": 2 * L * n_micro * steps,
                        "flash_attn_bwd_dq": L * n_micro * steps,
                        "flash_attn_bwd_dkv": L * n_micro * steps}, launches
    assert [h[0] for h in history] == list(range(1, steps + 1))
    # one more step without the profiler, after the counted run: host wall time
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, _ = step(state, next(data))
    torch.cuda.synchronize()
    unprofiled_ms = 1e3 * (time.perf_counter() - t)
    # the optimizer update alone (fresh zero gradients), device time
    from repro_torch.training.optimizer import adamw_update
    from repro_torch.tree import tree_leaves, tree_map

    zeros = tree_map(torch.zeros_like, state["params"])
    upd_ms, _ = device_ms(lambda: adamw_update(zeros, state["opt"], state["params"],
                                               opt_config(steps)), calls=2)
    del zeros
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    summary = {"config": cfg.name, "n_layers": L, "d_model": cfg.d_model, "vocab": cfg.vocab,
               "seq": seq, "global_batch": batch, "n_microbatches": n_micro, "steps": steps,
               "params": n_params, "setup_s": setup_s, "launches": launches,
               "unprofiled_step_wall_ms": unprofiled_ms,
               "optimizer_update_device_ms": upd_ms, "steps_detail": per_step}
    return summary, state["params"]



def per_layer_leaves(tree: dict, prefix: str = "") -> dict:
    """Name -> tensor, the stacked ``layers`` leaves (nested ``moe`` ones
    included) split per layer."""
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(per_layer_leaves(val, f"{name}."))
        elif name.startswith("layers."):
            out.update({f"{name}.{i}": val[i] for i in range(val.shape[0])})
        else:
            out[name] = val
    return out


def kernels_vs_plain_step(cfg, n_layers: int = 2, seq: int = 4096) -> dict:
    """One full-width train step with ``n_layers`` layers, run twice from
    the same weights and data: the flash kernels, then the plain version.

    At random init the loss sits near ln V whatever attention computes, so
    the step is held by its gradients, leaf by leaf and layer by layer: after
    the first step AdamW's fp32 first moment is (1 − b1) times the clipped
    gradient, and the relative L2 gap ``|m_k − m_p| / |m_p|`` of every leaf
    must stay under 2e-2; a wrong attention moves the gradients of wq, wk
    and wv by a share of order one.  Loss ``rtol`` 2e-5, grad norm ``rtol``
    1e-4.  On the H100 the gaps read 0.0022–0.0090 per leaf, 5.1e-6 in the
    loss and 1.2e-6 in the grad norm.  The two attentions compute the same
    fp32 arithmetic in another order, so where a p or an output element sits
    at a bf16 rounding boundary the two round it apart by one ulp; those
    flips pass through the bf16 residual stream and the bf16 gradient
    accumulation, so the bf16 gradients differ by ~1% where the fp32
    reduced config's differ by ~5e-7 (``tests/test_torch_cuda.py``)."""
    from repro_torch.launch.train import _lm_data
    from repro_torch.models.transformer import model as tm
    from repro_torch.tree import tree_map

    small = dataclasses.replace(cfg, n_layers=n_layers)
    base = tm.init_params(small, torch.Generator(device=DEV).manual_seed(1), device=DEV)
    batch = next(_lm_data(small, 2, seq, seed=1, device=DEV))
    out, moments = {}, {}
    for use_kernel in (True, False):
        params = tree_map(torch.clone, base)
        init, step = train_step_fn(small, 2, 3, use_kernel=use_kernel)
        state = init(params)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        out[use_kernel] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                           "wall_ms": 1e3 * (time.perf_counter() - t)}
        moments[use_kernel] = per_layer_leaves(state["opt"]["m"])
        del state, params
    grad_gap = {name: ((moments[True][name] - want).norm() / want.norm()).item()
                for name, want in moments[False].items()}
    del moments
    k, p = out[True], out[False]
    assert abs(k["loss"] - p["loss"]) <= 2e-5 * abs(p["loss"]), out
    assert abs(k["grad_norm"] - p["grad_norm"]) <= 1e-4 * p["grad_norm"], out
    worst = max(grad_gap, key=grad_gap.get)
    assert grad_gap[worst] <= 2e-2, grad_gap
    return {"n_layers": n_layers, "seq": seq, "kernels": k, "plain": p,
            "grad_rel_gap": grad_gap, "worst_grad_rel_gap": [worst, grad_gap[worst]]}


def prefill_check(params, cfg, bucket: int = 1024) -> dict:
    """One serving prefill of a ``bucket``-token prompt at full width through
    the forward kernel (S > 512 takes flash attention), against the same
    prefill with the plain attention.  Logits within 2e-2 of their largest
    magnitude: bf16 activations round apart by one ulp where an attention
    output sits at a rounding boundary, through every layer."""
    from repro_torch.models.transformer import model as tm

    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (1, bucket)).astype(np.int32)).to(DEV)
    true_len = torch.tensor([bucket - 7], dtype=torch.int32, device=DEV)
    fwd = flash_counters()["flash_attn_fwd"]
    fwd.reset()
    lg_k, _ = tm.prefill(params, tokens, true_len, cfg, bucket)
    torch.cuda.synchronize()
    launched = fwd.count
    lg_p, _ = tm.prefill(params, tokens, true_len, cfg, bucket, use_kernel=False)
    assert launched == cfg.n_layers, launched
    assert bool(torch.isfinite(lg_k).all())
    err = (lg_k - lg_p).abs().max().item()
    scale = lg_p.abs().max().item()
    assert err <= 2e-2 * scale, (err, scale)
    return {"bucket": bucket, "launches": launched, "max_abs_err": err, "max_abs_logit": scale,
            "same_argmax": bool(torch.equal(lg_k.argmax(-1), lg_p.argmax(-1)))}


def train_cross_device_check(reduced_cfg, steps: int = 3, seq: int = 1024) -> dict:
    """Three training steps of the reduced (fp32) config at ``seq`` tokens
    (the chunked branch: the kernels on the card, the plain version on the
    CPU) from the same weights and data.  Losses within ``rtol`` 1e-4: fp32
    everywhere (no TF32), sums in another order, and Adam's division by
    sqrt(v) + eps amplifies last-bit gradient differences where |g| ~ eps."""
    from repro_torch.launch.train import _lm_data
    from repro_torch.models.transformer import model as tm
    from repro_torch.training import TrainLoop

    host = tm.init_params(reduced_cfg, torch.Generator().manual_seed(0), device="cpu")
    losses = {}
    for dev in (DEV, "cpu"):
        params = to_device(host, dev)
        init, step = train_step_fn(reduced_cfg, 2, steps)
        loop = TrainLoop(step_fn=step, data_iter=_lm_data(reduced_cfg, 2, seq, device=dev),
                         log_every=1, log_fn=lambda *_: None)
        losses[dev] = [h[1] for h in loop.run(init(params), steps)[1]]
    np.testing.assert_allclose(losses[DEV], losses["cpu"], rtol=1e-4)
    return losses


# ------------------------------------------------- GNN zoo and Wide & Deep ----
# the four GNN runs: (arch, shape); EquiformerV2 at minibatch_lg does not
# fit one card (PERF.md section 7)
GNN_RUNS = (("meshgraphnet", "minibatch_lg"), ("graphcast", "minibatch_lg"),
            ("gin-tu", "minibatch_lg"), ("equiformer-v2", "molecule"))
ZOO_ARCHS = ("gin-tu", "meshgraphnet", "graphcast", "equiformer-v2", "wide-deep")
GEMM_FRAGMENTS = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitk")
GATHER_SCATTER_FRAGMENTS = ("index", "scatter", "gather")


@contextlib.contextmanager
def optimizer_annotated():
    """``adamw_update`` wrapped in a ``record_function`` range (as the train
    step calls it) for the profiled steps."""
    from torch.profiler import record_function

    from repro_torch.training import loop

    saved = loop.adamw_update

    def inner(*a, **kw):
        with record_function("adamw_update"):
            return saved(*a, **kw)

    loop.adamw_update = inner
    try:
        yield
    finally:
        loop.adamw_update = saved


def zoo_split(by_name: dict, optimizer_ms: float) -> dict:
    """Device ms of a training step: cuBLAS GEMMs and gathers/scatters by
    kernel name, the optimizer's kernels by their range, the rest other."""
    gemm = sum(ms for n, ms in by_name.items() if any(f in n.lower() for f in GEMM_FRAGMENTS))
    gs = sum(ms for n, ms in by_name.items()
             if not any(f in n.lower() for f in GEMM_FRAGMENTS)
             and any(f in n.lower() for f in GATHER_SCATTER_FRAGMENTS))
    return {"gemm": gemm, "gather_scatter": gs, "optimizer": optimizer_ms,
            "other": sum(by_name.values()) - gemm - gs - optimizer_ms}


def alloc_bytes(tensors) -> int:
    """What the caching allocator holds for ``tensors``' storages (each
    rounded up to its 512-byte blocks)."""
    seen = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in tensors}
    return sum(-(-n // 512) * 512 for n in seen.values())


def profiled_train(params, loss_fn, data, steps: int, base: int | None = None
                   ) -> tuple[list, dict]:
    """``steps`` steps of ``make_train_step`` + ``TrainLoop`` (AdamW as the
    reference launcher sets it), each profiled: loss, wall ms, device ms
    split by ``zoo_split``, kernels, peak GB.  With ``base`` (the bytes
    allocated before the step's own arguments were made), each record also
    holds ``peak_above_base_bytes``: the step's peak less ``base``.
    Returns (per-step records, the state)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.training import TrainLoop, make_train_step

    init_state, step = make_train_step(loss_fn, opt_config(steps))
    state = init_state(params)
    recs: list = []

    def profiled_step(state, batch):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with optimizer_annotated(), profile(activities=[ProfilerActivity.CPU,
                                                        ProfilerActivity.CUDA]) as prof:
            state, m = step(state, batch)
            torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
        by_name = kernel_ms_by_name(prof, 1)
        opt_ms, _ = range_device(prof, "adamw_update", 1)
        rec = {"step": len(recs) + 1, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "wall_ms": wall, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               **({} if base is None else
                  {"peak_above_base_bytes": torch.cuda.max_memory_allocated() - base}),
               "kernels": sum(1 for e in prof.events()
                              if e.device_type == torch.autograd.DeviceType.CUDA)}
        if by_name:
            rec.update(device_ms=sum(by_name.values()), device_ms_split=zoo_split(by_name, opt_ms))
            if not recs:
                rec["top_kernels_ms"] = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
        else:
            rec["device_ms"] = "not measured (the trace held no device events)"
        recs.append(rec)
        return state, m

    state, history = TrainLoop(step_fn=profiled_step, data_iter=data, log_every=1,
                               log_fn=lambda *_: None).run(state, steps)
    assert [h[0] for h in history] == list(range(1, steps + 1))
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in recs), recs
    return recs, state


def molecule_inputs(cfg, shape, device) -> dict:
    """The ``molecule`` cell on real molecule-like graphs: 128 graphs of 30
    nodes from ``generators.molecule_graphs`` joined by ``batch_graphs``,
    positions ``node_feat[:, :3]``, the edges padded with masked sentinel
    edges to ``padded_edges``, the LUT ``build_wigner_lut(l_max)`` (32 x 64
    bins), seeded graph-level targets."""
    from repro_torch.configs.common import padded_edges
    from repro_torch.graph import generators
    from repro_torch.graph.batch import batch_graphs
    from repro_torch.models.gnn.wigner import build_wigner_lut

    p = shape.params
    big, gids = batch_graphs(generators.molecule_graphs(p["batch"], p["n_nodes"], p["n_edges"],
                                                        d_feat=p["d_feat"]))
    src, dst = big.edge_list()
    n, e = big.num_nodes, padded_edges(shape)
    assert len(src) <= e and big.node_feat.shape[1] == cfg.d_in, (len(src), e)
    pad = np.full(e - len(src), n, np.int32)
    lut = build_wigner_lut(cfg.l_max)
    assert lut.shape[0] == cfg.n_wigner_bins, lut.shape
    rng = np.random.default_rng(0)
    host = {"node_feat": big.node_feat, "pos": np.ascontiguousarray(big.node_feat[:, :3]),
            "edge_src": np.concatenate([src, pad]), "edge_dst": np.concatenate([dst, pad]),
            "edge_mask": np.arange(e) < len(src), "wigner_lut": lut, "graph_ids": gids,
            "targets": rng.standard_normal((p["batch"], cfg.d_out)).astype(np.float32)}
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in host.items()}


def gnn_run(card: str, arch: str, shape_name: str, inputs: dict, steps: int = 2) -> dict:
    """One GNN at its published width and depth (``effective_model_cfg``),
    fp32, weights from seed 0, ``steps`` profiled train steps."""
    from repro_torch.configs import effective_model_cfg, get_config
    from repro_torch.models.gnn import gnn_loss, init_gnn
    from repro_torch.tree import tree_leaves

    spec = get_config(arch)
    cfg = effective_model_cfg(spec, spec.shapes[shape_name])
    t0 = time.perf_counter()
    # the inputs were made before: the step's arguments are they, the
    # weights and the optimizer state
    base = torch.cuda.memory_allocated() - alloc_bytes(inputs.values())
    params = init_gnn(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    n_params = sum(t.numel() for t in tree_leaves(params))
    recs, state = profiled_train(params, lambda p, b: (gnn_loss(p, cfg, b), {}),
                                 itertools.repeat(inputs), steps, base=base)
    del state, params
    out = {"arch": arch, "shape": shape_name, "n_layers": cfg.n_layers,
           "d_hidden": cfg.d_hidden, "d_in": cfg.d_in, "d_out": cfg.d_out,
           "n_nodes": inputs["node_feat"].shape[0], "n_edges": inputs["edge_src"].shape[0],
           "live_edges": int(inputs["edge_mask"].sum()), "params": n_params,
           "graph_readout": cfg.graph_readout, "phase_s": time.perf_counter() - t0,
           "losses": [r["loss"] for r in recs], "steps": recs, "card": card}
    print(json.dumps({"gnn_run": out}), flush=True)
    return out


def retrieval_record(query: torch.Tensor, cand: torch.Tensor, launches: int, k: int = 100) -> dict:
    """The ``topk_sim`` kernel at ``retrieval_cand`` against its plain
    version (scores within 1e-5; the same id set, and every id at the plain
    version's place where its score is clear of both neighbours by 1e-6)
    and ``torch.topk(q @ emb.T, k)``, each timed; the bound from this run's
    shapes."""
    from repro_torch.kernels.topk_sim import ops
    from repro_torch.models.recsys.wide_deep import retrieval_scores

    s_k, i_k = retrieval_scores(query, cand, k)
    s_p, i_p = ops.topk_similarity(query, cand, k + 1, use_kernel=False)
    torch.cuda.synchronize()
    err = (s_k - s_p[:, :k]).abs().max().item()
    assert err <= 1e-5, f"retrieval scores off by {err}"
    assert torch.equal(i_k.sort(1).values, i_p[:, :k].sort(1).values), "retrieval id sets differ"
    sw = s_p[0]
    gaps = sw[:-1] - sw[1:]
    clear = torch.minimum(F.pad(gaps[:k - 1], (1, 0), value=1.0), gaps[:k]) > 1e-6
    assert torch.equal(i_k[0, clear], i_p[0, :k][clear]), "retrieval ids differ"
    q, (n, d) = query.shape[0], cand.shape
    b_ms, b_by = bound(4 * (query.numel() + cand.numel()) + 8 * q * k, (2 * q * n * d, FP32_FLOPS))
    run = lambda: retrieval_scores(query, cand, k)  # noqa: E731
    library = lambda: torch.topk(query @ cand.T, k)  # noqa: E731
    return {"name": "topk_sim_retrieval_cand", "route": "cuda",
            "source": "src/repro_torch/csrc/topk_sim.cu",
            "replaces": "src/repro/kernels/topk_sim/kernel.py:80", "launches": launches,
            "max_abs_err": err, "ids_equal_plain": bool(torch.equal(i_k, i_p[:, :k])),
            "ms": time_ms(run),
            "plain_ms": time_ms(lambda: ops.topk_similarity(query, cand, k, use_kernel=False)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": time_ms(library),
            "profiler_ms": device_ms(run)[0], "library_profiler_ms": device_ms(library)[0],
            "shape": f"Q={q} N={n} D={d} k={k}"}


def wide_deep_run(card: str, steps: int = 2) -> tuple[dict, dict]:
    """Wide & Deep at its published size (40 fields x 1M rows x 32, MLP
    1024-512-256), fp32, weights from seed 0: ``steps`` profiled train
    steps at ``train_batch`` (the launcher's pre-offset click batches),
    forward logits at ``serve_p99`` and ``serve_bulk`` timed, and
    ``retrieval_scores`` at ``retrieval_cand`` (the ``topk_sim`` kernel;
    its launches counted over this path).  Returns (the run, the kernel
    record)."""
    from repro_torch.configs import get_config, input_specs
    from repro_torch.kernels.topk_sim import kernel
    from repro_torch.launch.train import _recsys_data
    from repro_torch.models.recsys import wide_deep as wdm
    from repro_torch.tree import tree_leaves

    spec = get_config("wide-deep")
    cfg = spec.model_cfg
    shapes = {k: v.params for k, v in spec.shapes.items()}
    t0 = time.perf_counter()
    kernel.launches.reset()
    base = torch.cuda.memory_allocated()  # before the weights
    params = wdm.init_wide_deep(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    n_params = sum(t.numel() for t in tree_leaves(params))
    recs, state = profiled_train(
        params, lambda p, b: (wdm.wide_deep_loss(p, cfg, b["dense"], b["sparse_ids"],
                                                 b["labels"]), {}),
        _recsys_data(cfg, shapes["train_batch"]["batch"], device=DEV), steps, base=base)
    del state
    torch.cuda.empty_cache()
    serve = {}
    with torch.no_grad():
        for name in ("serve_p99", "serve_bulk"):
            b = next(_recsys_data(cfg, shapes[name]["batch"], seed=1, device=DEV))
            fwd = lambda b=b: wdm.wide_deep_logits(params, cfg, b["dense"], b["sparse_ids"])  # noqa: E731
            torch.cuda.reset_peak_memory_stats()
            lg = fwd()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base  # the weights and the batch
            assert lg.shape == (shapes[name]["batch"],) and bool(torch.isfinite(lg).all())
            serve[name] = {"batch": shapes[name]["batch"], "peak_above_base_bytes": peak,
                           "ms": time_ms(fwd, reps=3, batch=3),
                           "device_ms": device_ms(fwd, calls=3)[0],
                           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
            del b, lg
    base_r = torch.cuda.memory_allocated()  # before the query and the candidates
    cell = input_specs("wide-deep", "retrieval_cand", abstract=False, device=DEV)
    k = shapes["retrieval_cand"]["k"]
    torch.cuda.reset_peak_memory_stats()
    s, i = wdm.retrieval_scores(cell["query"], cell["cand_emb"], k)
    torch.cuda.synchronize()
    retrieval_peak = torch.cuda.max_memory_allocated() - base_r
    launches = kernel.launches.count
    assert launches == 1 and i.shape == (1, k) and bool(torch.isfinite(s).all()), launches
    del params
    gc.collect()
    torch.cuda.empty_cache()
    record = retrieval_record(cell["query"], cell["cand_emb"], launches, k)
    out = {"arch": "wide-deep", "fields": cfg.n_sparse, "rows_per_field": cfg.rows_per_field,
           "embed_dim": cfg.embed_dim, "mlp": list(cfg.mlp), "params": n_params,
           "train_batch": shapes["train_batch"]["batch"], "losses": [r["loss"] for r in recs],
           "steps": recs, "serve": serve, "phase_s": time.perf_counter() - t0,
           "retrieval": {key: record[key] for key in ("shape", "ms", "plain_ms", "library_ms",
                                                      "bound_ms", "launches", "ids_equal_plain")},
           "retrieval_peak_above_base_bytes": retrieval_peak,
           "retrieval_profiler_ms": record["profiler_ms"],
           "card": card}
    print(json.dumps({"recsys_run": out}), flush=True)
    return out, record


def zoo_cross_device_check(steps: int = 3) -> dict:
    """The five archs' reduced fp32 configs, ``steps`` train steps on the
    card and on the CPU from the same weights and the launcher's batch:
    losses within ``rtol`` 1e-5 (``index_add`` on the card adds in atomic
    order, so not bit for bit).  Then reduced-width retrieval (Q 2, N 5000,
    D 16, k 100): the card's kernel ids equal the CPU's exactly."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import _gnn_inputs, _recsys_data
    from repro_torch.models.gnn import gnn_loss, init_gnn
    from repro_torch.models.recsys import wide_deep as wdm
    from repro_torch.training import TrainLoop, make_train_step

    out = {}
    for arch in ZOO_ARCHS:
        spec = get_config(arch)
        cfg = spec.reduced_cfg
        if spec.family == "recsys":
            host = wdm.init_wide_deep(cfg, torch.Generator().manual_seed(0), device="cpu")
            loss_fn = lambda p, b, cfg=cfg: (wdm.wide_deep_loss(  # noqa: E731
                p, cfg, b["dense"], b["sparse_ids"], b["labels"]), {})
            data = lambda d, cfg=cfg: _recsys_data(cfg, 32, device=d)  # noqa: E731
        else:
            host = init_gnn(cfg, torch.Generator().manual_seed(0), device="cpu")
            loss_fn = lambda p, b, cfg=cfg: (gnn_loss(p, cfg, b), {})  # noqa: E731
            data = lambda d, cfg=cfg: itertools.repeat(_gnn_inputs(cfg, device=d))  # noqa: E731
        losses = {}
        for dev in (DEV, "cpu"):
            init, step = make_train_step(loss_fn, opt_config(steps))
            loop = TrainLoop(step_fn=step, data_iter=data(dev), log_every=1,
                             log_fn=lambda *_: None)
            losses[dev] = [h[1] for h in loop.run(init(to_device(host, dev)), steps)[1]]
        np.testing.assert_allclose(losses[DEV], losses["cpu"], rtol=1e-5)
        out[arch] = losses
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32))
    cand = torch.from_numpy(rng.standard_normal((5000, 16)).astype(np.float32))
    s_c, i_c = wdm.retrieval_scores(q.to(DEV), cand.to(DEV), 100)
    s_h, i_h = wdm.retrieval_scores(q, cand, 100)
    assert torch.equal(i_c.cpu(), i_h), "reduced retrieval ids differ between card and CPU"
    out["retrieval_max_abs_err"] = (s_c.cpu() - s_h).abs().max().item()
    assert out["retrieval_max_abs_err"] <= 1e-5, out
    return out


def zoo_phase(card: str) -> dict:
    """Phase 11: the four GNNs and Wide & Deep at full width, then the
    reduced card-vs-CPU gate.  Returns the ``topk_sim_retrieval_cand``
    kernel record."""
    from repro_torch.configs import effective_model_cfg, get_config, input_specs

    t0 = time.perf_counter()
    runs = []
    lg_inputs = None
    for arch, shape_name in GNN_RUNS:
        spec = get_config(arch)
        if shape_name == "molecule":
            shape = spec.shapes[shape_name]
            inputs = molecule_inputs(effective_model_cfg(spec, shape), shape, DEV)
        elif arch == "graphcast":  # d_out is its input stack: its own targets
            inputs = input_specs(arch, shape_name, abstract=False, device=DEV)
        else:  # gin and meshgraphnet share the cell's arrays (d_in 608, d_out 41)
            lg_inputs = lg_inputs or input_specs(arch, shape_name, abstract=False, device=DEV)
            inputs = lg_inputs
        runs.append(gnn_run(card, arch, shape_name, inputs))
        del inputs
        gc.collect()
        torch.cuda.empty_cache()
    del lg_inputs
    gc.collect()
    torch.cuda.empty_cache()
    wd, record = wide_deep_run(card)
    measured = zoo_measured(runs, wd)
    gate = zoo_cross_device_check()
    print(json.dumps({"zoo_cross_device": gate}), flush=True)
    print(json.dumps({"zoo_phase": {
        "card": card, "phase_s": time.perf_counter() - t0,
        "step_wall_ms": {r["arch"]: [s["wall_ms"] for s in r["steps"]] for r in runs + [wd]},
        "step_device_ms": {r["arch"]: [s.get("device_ms") for s in r["steps"]]
                           for r in runs + [wd]},
        "peak_mem_gb": {r["arch"]: max(s["peak_mem_gb"] for s in r["steps"]) for r in runs + [wd]},
        "wide_deep_serve_ms": {k: v["ms"] for k, v in wd["serve"].items()},
        "retrieval_ms": [record["ms"], record["plain_ms"], record["library_ms"],
                         record["bound_ms"]]}}), flush=True)
    return record, measured


def zoo_measured(runs: list, wd: dict) -> dict:
    """Phase 11's cells as phase 13 reads them: (arch, shape) -> the first
    step's (or call's) peak above the bytes allocated before its own
    arguments were made, and its device ms (a training step's: the median
    of its profiled steps)."""
    def step_ms(steps):
        ms = [s["device_ms"] for s in steps if isinstance(s.get("device_ms"), float)]
        return statistics.median(ms) if ms else None

    out = {(r["arch"], r["shape"]): {"peak_bytes": r["steps"][0]["peak_above_base_bytes"],
                                     "device_ms": step_ms(r["steps"])} for r in runs}
    out[("wide-deep", "train_batch")] = {"peak_bytes": wd["steps"][0]["peak_above_base_bytes"],
                                         "device_ms": step_ms(wd["steps"])}
    for name, v in wd["serve"].items():
        out[("wide-deep", name)] = {"peak_bytes": v["peak_above_base_bytes"],
                                    "device_ms": v["device_ms"]}
    out[("wide-deep", "retrieval_cand")] = {"peak_bytes": wd["retrieval_peak_above_base_bytes"],
                                            "device_ms": wd["retrieval_profiler_ms"]}
    return out


# ------------------------------------------ mesh constants and the dry run (13) ----
DRYRUN_RATIO = (0.8, 1.25)  # predicted over measured peak bytes, per cell


def mesh_constants(card: str, n: int = 8192) -> dict:
    """``launch.mesh``'s constants beside what this card does: a bf16
    ``torch.matmul`` at n^3 and a device-to-device copy of 1 GiB (read and
    written: 2 GiB moved), each as a share of its constant."""
    from repro_torch.launch import mesh

    a = torch.randn(n, n, device=DEV, dtype=torch.bfloat16)
    b = torch.randn(n, n, device=DEV, dtype=torch.bfloat16)
    mm_ms = time_ms(lambda: torch.matmul(a, b), reps=5, batch=10)
    src = torch.empty(1 << 28, dtype=torch.float32, device=DEV)
    dst = torch.empty_like(src)
    cp_ms = time_ms(lambda: dst.copy_(src), reps=5, batch=10)
    mm_rate, cp_rate = 2 * n**3 / (mm_ms * 1e-3), 2 * src.nbytes / (cp_ms * 1e-3)
    del a, b, src, dst
    out = {"card": card, "source": "NVIDIA H100 SXM5 data sheet",
           **{k: getattr(mesh, k) for k in ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_BW", "NVLINK_BW",
                                            "FP32_FLOPS", "INT_OPS")},
           "bf16_matmul_8192_ms": mm_ms, "bf16_matmul_flops_per_s": mm_rate,
           "bf16_matmul_share_of_PEAK_FLOPS_BF16": mm_rate / mesh.PEAK_FLOPS_BF16,
           "copy_1gib_ms": cp_ms, "copy_bytes_per_s": cp_rate,
           "copy_share_of_HBM_BW": cp_rate / mesh.HBM_BW}
    print(json.dumps({"mesh_constants": out}), flush=True)
    return out


def dryrun_phase(card: str, measured: dict) -> dict:
    """Phase 13: the dry run on a 1 x 1 mesh (world size 1, fake tensors on
    the host: nothing of it runs on the card) for each cell phase 11 ran at
    full width, its predicted per-device bytes against the card's measured
    peak (``zoo_measured``) and its FLOPs over the measured device ms as a
    share of the fp32 peak (these cells are fp32, TF32 off).  Fails if a
    ratio leaves ``DRYRUN_RATIO``."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    consts = mesh_constants(card)
    cells = {}
    for (arch, shape), m in measured.items():
        rec = dryrun.run_cell(arch, shape, mesh_shape=(1, 1), skip_analysis=True)
        assert rec["status"] == "ok" and not dist.is_initialized(), rec
        pred, flops = rec["memory"]["per_device_total"], rec["cost_full_program"]["flops"]
        cells[f"{arch}/{shape}"] = {
            "predicted_bytes": pred, "measured_peak_bytes": m["peak_bytes"],
            "ratio": pred / m["peak_bytes"], "memory": rec["memory"], "flops": flops,
            "device_ms": m["device_ms"],
            "flops_share_of_fp32_peak": (flops / (m["device_ms"] * 1e-3) / FP32_FLOPS
                                         if m["device_ms"] else "not measured"),
            "dryrun_s": rec["compile_s_total"]}
    out = {"card": card, "mesh": "1x1", "cells": cells, "band": list(DRYRUN_RATIO),
           "bf16_matmul_share": consts["bf16_matmul_share_of_PEAK_FLOPS_BF16"],
           "copy_share": consts["copy_share_of_HBM_BW"], "phase_s": time.perf_counter() - t0}
    print(json.dumps({"dryrun_vs_card": out}), flush=True)
    lo, hi = DRYRUN_RATIO
    bad = {k: c["ratio"] for k, c in cells.items() if not lo <= c["ratio"] <= hi}
    assert not bad, f"dry-run bytes off the card's peaks: {bad}"
    return out


# ------------------------------------- the index over the host's cards (14) ----
SHARDS = 4  # phase 14's n_shards
SHARDED_TABLES = {"serving": (4, 3), "retrieval_cand": (1, 100)}  # table -> (Q, k)


def phase_devices() -> list:
    """Phase 14's mesh positions: every visible card where there are two or
    more, else two positions on the one card (the twin of the reference's
    tests, which force several host devices on one CPU)."""
    n = torch.cuda.device_count()
    return [f"cuda:{i}" for i in range(n)] if n >= 2 else ["cuda:0", "cuda:0"]


def sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def device_ms_by_card(fn, calls: int = 10) -> tuple[float, dict]:
    """``device_ms`` of ``fn`` (which ends by reading its result on the
    host), and that time split by card index."""
    for _ in range(3):
        fn()
    sync_all()
    by_card: dict = {}
    for e in kernel_events(traced(fn, calls)):
        by_card[e.device_index] = by_card.get(e.device_index, 0.0) + e.device_time / 1e3 / calls
    return sum(by_card.values()), by_card


def sharded_devices_check(card: str, cards: list, feat: torch.Tensor, devs: list,
                          home: torch.device) -> dict:
    """Phase 14 (a): ``ShardedIndex`` with S = 4 over ``devs`` on the serving
    cell's table (169,343 x 128, Q 4, k 3) and Wide & Deep's
    ``retrieval_cand`` table (1M x 256 fp32, Q 1, k 100), brute and IVF:
    brute ids equal ``BruteIndex``'s; scores and ids bit-equal to the same
    S on one device; S op calls a search, each on its position's card
    (``LaunchCounter.by_device``); wall and device ms beside the one-device
    index's.  One ``sharded_devices`` line."""
    from collections import Counter

    from repro_torch.core.indexing import BruteIndex
    from repro_torch.core.sharding import ShardedIndex
    from repro_torch.kernels.ivf_scan import kernel as ivf_kernel
    from repro_torch.kernels.topk_sim import kernel as topk_kernel

    rng = np.random.default_rng(14)
    gen = torch.Generator(device=home).manual_seed(14)
    tables = {"serving": feat,
              "retrieval_cand": torch.randn((1_000_000, 256), generator=gen, device=home)}
    runs, mesh_size = {}, None
    for name, table in tables.items():
        nq, k = SHARDED_TABLES[name]
        q = index_queries(table, nq, rng)
        _, brute_ids = BruteIndex.build(table, device=home).search(q, k)
        for inner in ("brute", "ivf"):
            builds = {}
            for where, on in (("mesh", devs), ("one_device", [home])):
                sync_all()
                t = time.perf_counter()
                builds[where] = ShardedIndex.build(table, n_shards=SHARDS, inner=inner,
                                                   devices=on, device=home)
                sync_all()
                builds[where + "_build_s"] = time.perf_counter() - t
            mesh, one = builds["mesh"], builds["one_device"]
            mesh_size = mesh.mesh_size
            counter = topk_kernel.launches if inner == "brute" else ivf_kernel.launches
            counter.reset()
            s_m, i_m = mesh.search(q, k)
            sync_all()
            launches, by_device = counter.count, dict(counter.by_device)
            want = Counter(d.index for d in mesh.devices for _ in range(SHARDS // mesh_size))
            assert launches == SHARDS and by_device == dict(want), (name, inner, launches,
                                                                    by_device)
            s_1, i_1 = one.search(q, k)
            assert torch.equal(i_m, i_1) and torch.equal(s_m.view(torch.int32),
                                                         s_1.view(torch.int32)), (name, inner)
            if inner == "brute":
                assert torch.equal(i_m, brute_ids), f"{name}: sharded ids differ from brute ids"
            timing = {}
            for where, idx in (("mesh", mesh), ("one_device", one)):
                run = lambda: idx.search(q, k)[1].cpu()  # noqa: E731
                dev_ms, by_card = device_ms_by_card(run)
                timing[where] = {"wall_ms": time_ms(run), "device_ms": dev_ms,
                                 "device_ms_by_card": by_card,
                                 "build_s": builds[where + "_build_s"]}
            runs[f"{name}/{inner}"] = {"shape": f"N={table.shape[0]} D={table.shape[1]} "
                                                f"Q={nq} k={k}",
                                       "launches": launches, "launches_by_card": by_device,
                                       "ids_equal_brute": inner == "brute" or None,
                                       "bit_equal_one_device": True, **timing}
            del builds, mesh, one
    return {"devices": [str(d) for d in devs], "mesh_size": mesh_size, "n_shards": SHARDS,
            "card": card, "cards": cards, "runs": runs}


def sharded_serve(card: str, stack: dict, devs: list, brute_tokens: dict) -> dict:
    """Phase 14 (b): the main path's mix (StarCoder2-3B bf16, full width and
    depth, the 169,343-node graph, 12 requests, 12 new tokens) served once
    with ``index_kind="sharded"`` (S = 4) over ``devs``, the weights drawn
    again from the main path's seed: tokens equal the brute serve's, uid by
    uid; S ``topk_sim`` op calls a wave, on the positions' cards."""
    from collections import Counter

    from repro_torch.core.pipeline import index_from_config
    from repro_torch.models.transformer import model as tm

    pipe, cfg = stack["pipe"], stack["cfg"]
    scfg = dataclasses.replace(pipe.config, index_kind="sharded", index_shards=SHARDS)
    spipe = dataclasses.replace(pipe, config=scfg, index=index_from_config(
        pipe.node_emb, scfg, device=pipe.device, devices=devs))
    params = tm.init_params(cfg, torch.Generator(device=pipe.device).manual_seed(0),
                            device=pipe.device)
    args = serve_args(index="sharded", shards=SHARDS)
    distinct = np.random.default_rng(0).choice(args.nodes, 8, replace=False)
    q_ids = np.concatenate([distinct, distinct[:4]])
    out, launches, overflow_rows = counted_serve(cfg, args, q_ids,
                                                 stack={**stack, "pipe": spipe, "params": params})
    by_device = dict(serve_counters()["topk_sim"].by_device)
    done = out["done"]
    assert len(done) == 12 and all(r.done and not r.failed for r in done), "requests lost"
    waves = out["retrieval_batches"]
    check_serve_launches(out, launches, overflow_rows, "brute", shards=SHARDS)
    mesh = spipe.index
    per_wave = Counter(d.index for d in mesh.devices for _ in range(SHARDS // mesh.mesh_size))
    assert by_device == {i: n * waves for i, n in per_wave.items()}, (by_device, waves)
    tokens = {r.uid: r.out_tokens for r in done}
    assert tokens == brute_tokens, {u: (tokens[u], brute_tokens[u]) for u in tokens
                                    if tokens[u] != brute_tokens[u]}
    return {"card": card, "devices": [str(d) for d in mesh.devices], "n_shards": SHARDS,
            "waves": waves, "retrieval_launches": launches, "topk_sim_by_card": by_device,
            "tokens_equal_brute_serve": True, "tok_per_s": out["tok_per_s"],
            "serve_s": out["serve_s"], "retrieval_s": out["retrieval_s"]}


def sharded_phase(card: str, stack: dict, brute_tokens: dict) -> dict:
    """Phase 14: the index over the host's cards (``sharded_devices``, then
    ``sharded_serve``), each check raising; the phase's seconds."""
    t0 = time.perf_counter()
    devs = phase_devices()
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    rec = sharded_devices_check(card, cards, stack["pipe"].node_emb, devs,
                                stack["pipe"].device)
    print(json.dumps({"sharded_devices": rec}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    serve = sharded_serve(card, stack, devs, brute_tokens)
    serve["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"sharded_serve": serve}), flush=True)
    return {"devices": rec, "serve": serve}


# ------------------------------------------------ the RAG-LM trainer (12) ----
RAG_LM_STEPS = 20  # steps of the uninterrupted run (and of the restart run)
RAG_LM_EVERY = 10  # checkpoint interval: saves at steps 10 and 20
RAG_LM_CRASH_AT = 15  # the restart run fails here once, after its first save
# bf16 losses of the restart run against the uninterrupted run's.  The
# restored state is held bit for bit; the steps after it are held to a
# tolerance because nothing promises that bf16 training (cuBLAS, the
# embedding's accumulate) repeats its bits from run to run
RAG_LM_LOSS_RTOL = 1e-2
CKPT_DIR = Path(__file__).resolve().parent / "build"


def rag_lm_example():
    """``examples/torch_train_rag_lm.py``, whose functions phase 12 drives."""
    import importlib.util

    path = Path(__file__).resolve().parent / "examples" / "torch_train_rag_lm.py"
    spec = importlib.util.spec_from_file_location("torch_train_rag_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_copy(tree):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.detach().cpu().clone(), tree)


def bits_equal(got, want) -> int:
    """Every leaf of ``got`` equals ``want``'s bit for bit (dtype and shape
    too); returns the leaves compared."""
    from repro_torch.tree import tree_leaves

    a, b = tree_leaves(got), tree_leaves(want)
    assert len(a) == len(b), (len(a), len(b))
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, (x.dtype, y.dtype, x.shape, y.shape)
        assert torch.equal(x.cpu(), y.cpu()), "a restored leaf differs from the saved state"
    return len(a)


def count_kernels(fn) -> int:
    """Kernels one call of ``fn`` launches, from a :func:`traced` trace."""
    prof = traced(fn, 1)
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not (getattr(e, "is_user_annotation", False) or e.name in ANNOTATIONS))


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def rag_lm_batches(twin, g, pipe, n: int, batch: int, seq: int) -> tuple[list, dict]:
    """``n`` batches of the example's RAG token stream over ``pipe``, each
    timed as the example's loop takes it (``next`` on the stream: one
    retrieval wave on the card, then the host's linearization), with every
    retrieval kernel launch counted (counts set to 0 just before, read just
    after) and each compact wave's overflowing rows observed."""
    wave_ms: list = []
    retrieve = pipe.retrieve

    def timed_retrieve(q, encoder=None):
        t = time.perf_counter()
        res = retrieve(q, encoder=encoder)
        torch.cuda.synchronize()
        wave_ms.append(1e3 * (time.perf_counter() - t))
        return res

    pipe.retrieve = timed_retrieve
    stream = twin.token_stream(pipe, g, batch, seq)
    counters = serve_counters()
    batches, data_ms = [], []
    try:
        with recorded_overflow() as overflow_rows:
            for c in counters.values():
                c.reset()
            for _ in range(n):
                torch.cuda.synchronize()
                t = time.perf_counter()
                batches.append(next(stream))
                torch.cuda.synchronize()
                data_ms.append(1e3 * (time.perf_counter() - t))
            launches = {name: c.count for name, c in counters.items()}
    finally:
        del pipe.retrieve
    assert len(wave_ms) == n, (len(wave_ms), n)
    reruns = check_wave_launches(n, pipe.config.max_hops, launches, overflow_rows, "brute")
    for b in batches:
        assert b["tokens"].device.type == torch.device(DEV).type, b["tokens"].device
        assert b["tokens"].shape == (batch, seq)
        assert b["loss_mask"].any(), "a batch without a target token"
    return batches, {"data_ms": data_ms, "wave_ms": wave_ms, "launches": launches, "waves": n,
                     "overflow_rows_per_wave": overflow_rows, "dense_reruns": reruns}


class TimedCheckpointer:
    """An ``AsyncCheckpointer`` whose ``save`` calls are timed (the stall the
    training loop sees)."""

    def __init__(self, inner):
        self.inner = inner
        self.stall_ms: list = []

    def save(self, step: int, tree) -> None:
        t = time.perf_counter()
        self.inner.save(step, tree)
        self.stall_ms.append(1e3 * (time.perf_counter() - t))


@contextlib.contextmanager
def timed_writes(write_s: list):
    """Times every ``save_checkpoint`` the checkpointer's worker runs."""
    from repro_torch.checkpoint import checkpoint as ck

    inner = ck.save_checkpoint

    def timed(*a, **kw):
        t = time.perf_counter()
        out = inner(*a, **kw)
        write_s.append(time.perf_counter() - t)
        return out

    ck.save_checkpoint = timed
    try:
        yield
    finally:
        ck.save_checkpoint = inner


def rag_lm_restart_run(step, batches, like, ckpt_dir: Path) -> dict:
    """``run_with_restart`` over the uninterrupted run's batches, from the
    same initial weights, with a failure injected at step ``RAG_LM_CRASH_AT``
    (after the first checkpoint): synchronous saves every ``RAG_LM_EVERY``
    steps, restore of the newest onto the card.  Returns the losses by step,
    the restart count and the final state."""
    from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
    from repro_torch.distributed.fault import run_with_restart

    losses: dict = {}
    injected = {"done": False}
    restored_from: list = []

    def step_fn(state, i):
        if i == RAG_LM_CRASH_AT and not injected["done"]:
            injected["done"] = True
            raise RuntimeError("injected failure")
        state, m = step(state, batches[i])
        losses[i] = float(m["loss"])
        return state

    def save_fn(state, i):
        save_checkpoint(str(ckpt_dir), i, state)

    def restore_fn():
        s = latest_step(str(ckpt_dir))
        restored_from.append(s)
        state, _ = restore_checkpoint(str(ckpt_dir), like, step=s, device=DEV)
        return state, s

    state, restarts = run_with_restart(step_fn, save_fn, restore_fn, like,
                                       n_steps=RAG_LM_STEPS, checkpoint_every=RAG_LM_EVERY)
    return {"losses": [losses[i] for i in range(RAG_LM_STEPS)], "restarts": restarts,
            "restored_from": restored_from, "state": state}


def rag_lm_cross_device_check(twin, steps: int = 3) -> dict:
    """The reduced fp32 gate: the ``2m`` config on the example's 1,500-node
    graph, ``steps`` steps on the card and on the CPU from the same weights:
    batches equal, losses within ``rtol`` 1e-5 (fp32, sums in another
    order); a checkpoint saved on the card restores on the CPU with equal
    bits, and one saved on the CPU on the card."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.core.indexing import BruteIndex
    from repro_torch.graph import generators
    from repro_torch.graph.ell import csr_to_ell
    from repro_torch.models.transformer import model as tm
    from repro_torch.training import TrainLoop
    from repro_torch.tree import tree_leaves

    g = generators.citation_graph(1500, avg_deg=8, seed=0)
    batches, losses, states = {}, {}, {}
    host = None
    for dev in (DEV, "cpu"):
        ell = csr_to_ell(g, device=dev)
        pipe = twin.build_pipeline(g, ell, BruteIndex.build(g.node_feat, device=dev), 192)
        cfg = twin.model_config("2m", pipe.tokenizer.vocab.size)
        if host is None:
            host = tm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        data = twin.token_stream(pipe, g, 8, 192)
        batches[dev] = [next(data) for _ in range(steps)]
        init, step = twin.trainer(cfg, 200)
        loop = TrainLoop(step_fn=step, data_iter=iter(batches[dev]), log_every=1,
                         log_fn=lambda *_: None)
        states[dev], hist = loop.run(init(to_device(host, dev)), steps)
        losses[dev] = [h[1] for h in hist]
    for a, b in zip(batches[DEV], batches["cpu"]):
        assert torch.equal(a["tokens"].cpu(), b["tokens"]), "card and CPU batches differ"
        assert torch.equal(a["loss_mask"].cpu(), b["loss_mask"]), "card and CPU masks differ"
    np.testing.assert_allclose(losses[DEV], losses["cpu"], rtol=1e-5)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses[DEV], losses["cpu"]))
    with tempfile.TemporaryDirectory(dir=CKPT_DIR) as tmp:
        save_checkpoint(f"{tmp}/card", steps, states[DEV])
        save_checkpoint(f"{tmp}/cpu", steps, states["cpu"])
        on_cpu, _ = restore_checkpoint(f"{tmp}/card", states["cpu"])
        leaves = bits_equal(on_cpu, host_copy(states[DEV]))
        assert all(t.device.type == "cpu" for t in tree_leaves(on_cpu))
        on_card, _ = restore_checkpoint(f"{tmp}/cpu", states[DEV])
        assert all(t.device.type == torch.device(DEV).type for t in tree_leaves(on_card))
        bits_equal(on_card, states["cpu"])
    return {"config": cfg.name, "nodes": g.num_nodes, "steps": steps, "losses": losses,
            "max_rel_loss_diff": rel, "batches_equal": True,
            "checkpoints_bit_equal_both_ways": True, "leaves": leaves}


def rag_lm_phase(card: str, stack) -> dict:
    """Phase 12: the example's RAG-LM trainer at its card size (``100m``,
    bf16, batch 8 x 192) over the main path's graph, ELL and brute index:
    20 precomputed stream batches (retrieval launches asserted), 20 steps
    through ``TrainLoop`` with ``AsyncCheckpointer`` (saves at 10 and 20),
    the newest checkpoint restored bit for bit, ``run_with_restart`` with a
    failure after the first save, the torn-save probe, and the reduced fp32
    gate.  One ``rag_lm_run`` line and a ``rag_lm_phase`` summary."""
    from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
    from repro_torch.models.transformer import model as tm
    from repro_torch.training import TrainLoop
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    twin = rag_lm_example()
    batch, seq = 8, 192  # the example's defaults
    pipe0 = stack["pipe"]
    pipe = twin.build_pipeline(stack["g"], pipe0.graph, pipe0.index, seq)
    batches, data = rag_lm_batches(twin, stack["g"], pipe, RAG_LM_STEPS, batch, seq)
    cfg = twin.model_config("100m", pipe.tokenizer.vocab.size)
    params = tm.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    init_host = host_copy(params)
    n_params = sum(t.numel() for t in tree_leaves(params))
    init_state, step = twin.trainer(cfg, RAG_LM_STEPS)
    state = init_state(params)
    walls, losses = [], []

    def timed_step(state, b):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        walls.append(1e3 * (time.perf_counter() - t))
        return state, m

    gc.collect()
    torch.cuda.synchronize()
    CKPT_DIR.mkdir(exist_ok=True)
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    write_s: list = []
    with tempfile.TemporaryDirectory(dir=CKPT_DIR) as tmp:
        tmp = Path(tmp)
        ckpt = TimedCheckpointer(AsyncCheckpointer(str(tmp / "run"), keep=2))
        loop = TrainLoop(step_fn=timed_step, data_iter=iter(batches), checkpointer=ckpt,
                         checkpoint_every=RAG_LM_EVERY, log_every=10)
        with timed_writes(write_s):
            state, history = loop.run(state, RAG_LM_STEPS)
            ckpt.inner.close()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        assert [h[0] for h in history] == list(range(10, RAG_LM_STEPS + 1, 10))
        assert len(ckpt.stall_ms) == 2 and len(write_s) == 2, (ckpt.stall_ms, write_s)
        assert latest_step(str(tmp / "run")) == RAG_LM_STEPS
        saved = sorted(p.name for p in (tmp / "run").iterdir())
        assert saved == [f"step_{RAG_LM_EVERY:08d}", f"step_{RAG_LM_STEPS:08d}"], saved
        ckpt_bytes = dir_bytes(tmp / "run" / f"step_{RAG_LM_STEPS:08d}")
        assert all(np.isfinite(losses)), losses
        # (a) the newest checkpoint onto the card, bit for bit
        want = host_copy(state)
        torch.cuda.synchronize()
        t = time.perf_counter()
        got, st = restore_checkpoint(str(tmp / "run"), state, device=DEV)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        assert st == RAG_LM_STEPS
        leaves = bits_equal(got, want)
        assert got["params"]["embed"].dtype == torch.bfloat16
        assert got["params"]["embed"].device.type == torch.device(DEV).type
        assert got["opt"]["m"]["embed"].dtype == torch.float32
        del got
        # (b) crash-restart over the same batches from the same weights
        like = init_state(to_device(init_host, DEV))
        rr = rag_lm_restart_run(step, batches, like, tmp / "restart")
        del like
        assert rr["restarts"] == 1 and rr["restored_from"] == [RAG_LM_EVERY], rr["restored_from"]
        assert int(rr["state"]["opt"]["step"]) == int(state["opt"]["step"]) == RAG_LM_STEPS
        np.testing.assert_allclose(rr["losses"], losses, rtol=RAG_LM_LOSS_RTOL)
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(rr["losses"], losses))
        same_params = all(torch.equal(a, b) for a, b in zip(tree_leaves(rr["state"]["params"]),
                                                             tree_leaves(state["params"])))
        del rr["state"]
        # (c) the torn-save probe: save, one in-place step at once, close
        probe = AsyncCheckpointer(str(tmp / "probe"), keep=1)
        probe.save(RAG_LM_STEPS + 1, state)
        state, _ = step(state, batches[0])
        probe.close()
        torch.cuda.synchronize()
        restored, _ = restore_checkpoint(str(tmp / "probe"), state, device=DEV)
        bits_equal(restored, want)
        assert not torch.equal(state["params"]["embed"].cpu(), want["params"]["embed"]), \
            "the probe's update changed nothing"
        del restored, want
    gc.collect()
    # the step's device time and kernel count, after the checks (the state
    # is not compared again)
    step_dev, by_name = device_ms(lambda: step(state, batches[1]), calls=2)
    step_kernels = count_kernels(lambda: step(state, batches[1]))
    del state, params
    gate = rag_lm_cross_device_check(twin)
    print(json.dumps({"rag_lm_cross_device": gate}), flush=True)
    warm = walls[1:]  # the first step builds cuBLAS handles and plans
    step_ms = statistics.median(warm)
    data_ms = statistics.median(data["data_ms"][1:])
    tokens = batch * seq
    rec = {
        "rag_lm_run": "examples/torch_train_rag_lm.py --model_scale 100m (bf16), batch 8 x 192, "
                      f"{N_NODES}-node graph, bfs auto, brute index", "card": card,
        "params": n_params, "checkpoint_bytes": ckpt_bytes, "leaves": leaves,
        "step_wall_ms": {"median": step_ms, "first": walls[0], "all": walls},
        "step_device_ms": step_dev, "step_kernels": step_kernels,
        "step_top_kernels_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6]),
        "data_ms": {"median": data_ms, "first": data["data_ms"][0], "all": data["data_ms"]},
        "retrieval_wave_ms_median": statistics.median(data["wave_ms"][1:]),
        "linearize_ms_median": statistics.median(
            [d - w for d, w in zip(data["data_ms"][1:], data["wave_ms"][1:])]),
        "data_share": data_ms / (data_ms + step_ms),
        "tok_per_s_step": tokens / step_ms * 1e3,
        "tok_per_s_with_data": tokens / (step_ms + data_ms) * 1e3,
        "save_stall_ms": ckpt.stall_ms, "save_write_s": write_s, "restore_s": restore_s,
        "peak_gb": peak_gb, "peak_gb_above_phase_start": peak_gb - base_gb,
        "launches": {k: data["launches"][k] for k in ("topk_sim", "frontier_expand",
                                                      "bfs_frontier")},
        "waves": data["waves"], "dense_reruns": data["dense_reruns"],
        "losses": losses, "restart": {"restarts": rr["restarts"],
                                      "restored_from": rr["restored_from"],
                                      "crash_at": RAG_LM_CRASH_AT, "loss_rtol": RAG_LM_LOSS_RTOL,
                                      "max_rel_loss_diff": loss_rel,
                                      "final_params_bit_equal": same_params},
        "torn_save_probe": "restored leaves equal the pre-update values"}
    print(json.dumps(rec), flush=True)
    summary = {"card": card, "phase_s": time.perf_counter() - t0, "params": n_params,
               "step_wall_ms": step_ms, "step_device_ms": step_dev,
               "step_kernels": step_kernels, "data_ms": data_ms,
               "data_share": rec["data_share"], "save_stall_ms": ckpt.stall_ms,
               "save_write_s": write_s, "restore_s": restore_s, "launches": rec["launches"],
               "loss_first_last": [losses[0], losses[-1]],
               "gate_max_rel_loss_diff": gate["max_rel_loss_diff"]}
    print(json.dumps({"rag_lm_phase": summary}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    t_script = time.perf_counter()
    phases_s: dict = {}
    last = [t_script]

    def mark(name: str) -> None:  # seconds since the previous mark, for the script_s line
        now = time.perf_counter()
        phases_s[name] = now - last[0]
        last[0] = now
    from repro_torch.configs import get_config
    from repro_torch.graph import generators
    from repro_torch.graph.ell import csr_to_ell
    from repro_torch.kernels import build

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f}s")
    mark("build")
    print("\n".join(line for line in build.build_log().splitlines()
                    if "registers" in line or "spill" in line), flush=True)

    spec = get_config("starcoder2-3b")
    t0 = time.perf_counter()
    g = generators.citation_graph(N_NODES, avg_deg=8, seed=0)
    ell = csr_to_ell(g, device="cuda")
    print(f"graph: {g.num_nodes} nodes, ELL width {ell.max_deg}, "
          f"{g.num_edges} arcs ({time.perf_counter() - t0:.1f}s)", flush=True)
    from repro_torch.core.indexing import l2_normalize
    rng = np.random.default_rng(0)
    emb = l2_normalize(ell.node_feat).contiguous()
    seeds = query_seeds(emb)
    records = [check_topk_sim(emb, rng), check_bfs_frontier(ell.nbr, ell.nbr_mask, rng),
               check_frontier_expand(ell.nbr, ell.nbr_mask, seeds, rng)]
    for rec in records:
        print(f"kernel check: {rec['name']} matches its plain version "
              f"(max abs err {rec['max_abs_err']:.3g})", flush=True)
    mark("graph_and_kernels")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    strategy_phase(ell, seeds)
    print(f"strategies: compact and dense agree on every row that did not overflow "
          f"({time.perf_counter() - t0:.1f}s, peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB)",
          flush=True)
    t0 = time.perf_counter()
    naive_oracle_phase(card, g, ell)
    print(f"naive oracle: the batched retrieval agrees with the pure-Python baselines "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    mark("strategies_and_naive_oracle")
    ell_launches = ell_path(rng)
    ell_record = check_ell_spmm(rng)
    print(f"ell_spmm path: {ell_launches} launches at {ELL_SHAPES} (Q, M, K, D); kernel check: "
          f"ell_aggregate matches its plain version bit for bit", flush=True)
    t0 = time.perf_counter()
    indexes, ivf_record = index_phase(ell.node_feat, rng)
    print(json.dumps({"indexes": "169343 x 128, Q = 4, k = 3", "card": card, **indexes,
                      "phase_s": time.perf_counter() - t0}), flush=True)
    feat_cpu = g.node_feat
    del g, ell, emb
    torch.cuda.empty_cache()
    mark("ell_and_indexes")

    mp, params, brute_tokens, stack = main_path(spec.model_cfg)
    print(json.dumps({"main_path": "starcoder2-3b bf16, 169343-node graph, retrieval auto",
                      "card": card, **mp}), flush=True)
    mp_ivf = main_path(spec.model_cfg, index="ivf", params=params)[0]
    mark("main_paths")
    paged = paged_phase(card, spec.model_cfg, params, brute_tokens)
    spec_runs = spec_phase(card, spec.model_cfg, params,
                           {"contiguous": brute_tokens, **paged["tokens"]})["runs"]
    mark("paged_and_spec")
    item12_phases(card, spec.model_cfg, stack, brute_tokens)
    mark("item12")
    stack["frozen_tokens"] = brute_tokens
    mutation_phase(card, spec.model_cfg, stack)
    mark("mutation")
    granite = granite_phase(card, stack)
    mark("granite_serving")
    rag_lm_phase(card, stack)
    mark("rag_lm")
    del params  # phase 14 keeps the stack's graph and pipeline, and draws the weights again
    stack["params"] = None
    print(json.dumps({"main_path": "the same with the IVF index (64 lists, nprobe 4)",
                      "card": card, **mp_ivf}), flush=True)
    print(json.dumps({"ivf_vs_brute_serve": {
        "tok_per_s": [mp["tok_per_s"], mp_ivf["tok_per_s"]],
        "warm_wave_wall_ms": [mp["retrieval_wave"]["auto"]["wall_ms"],
                              mp_ivf["retrieval_wave"]["auto"]["wall_ms"]],
        "warm_wave_device_ms": [mp["retrieval_wave"]["auto"]["device_ms"],
                                mp_ivf["retrieval_wave"]["auto"]["device_ms"]]}}), flush=True)
    run1, run2, run3, run4 = paged["runs"]
    print(json.dumps({"paged_phase": {
        "card": card, "tokens_equal_contiguous": True, "shared_admits": run1["kv_shared_admits"],
        "decode_ms_per_step_contiguous_paged": [mp["decode_ms_per_step"],
                                                run1["decode_ms_per_step"]],
        "device_busy_ms_per_step_contiguous_paged": [
            mp["decode_profile"]["device_busy_ms_per_step"],
            run1["decode_profile"]["device_busy_ms_per_step"]],
        "continuous_agreement_with_wave": run2["agreement_with_wave"],
        "int8_agreement_with_bf16": run3["agreement_with_bf16"],
        "int8_pool_bytes_ratio": run3["pool_bytes_ratio"],
        "kv_pool_bytes_bf16_int8": [run1["kv_pool_bytes"], run3["kv_pool_bytes"]],
        "peak_mem_gb_bf16_int8": [run1["peak_mem_gb"], run3["peak_mem_gb"]],
        "exhaustion": {k: run4[k] for k in ("pool_blocks", "truncations", "kv_releases",
                                            "pool_high_water_blocks", "pin_reclaims")}}}),
          flush=True)
    print(json.dumps({"spec_phase": {
        "card": card, "draft_window": 4,
        "runs": {r["spec_run"]: {k: r[k] for k in ("tok_per_s", "decode_ms_per_step",
                                                   "tokens_per_step", "draft_accept_rate",
                                                   "draft_proposed", "agreement_with_one_token")}
                 for r in spec_runs},
        "one_token_decode_ms_per_step_contiguous_paged_int8": [
            mp["decode_ms_per_step"], run1["decode_ms_per_step"], run3["decode_ms_per_step"]],
        "one_token_device_busy_ms_per_step_contiguous_paged_int8": [
            r["decode_profile"]["device_busy_ms_per_step"] for r in (mp, run1, run3)]}}),
          flush=True)
    torch.cuda.empty_cache()
    print(json.dumps({"paged_cross_device": paged_cross_device_check(spec.reduced_cfg)}),
          flush=True)
    print(json.dumps({"spec_cross_device": spec_cross_device_check(spec.reduced_cfg)}),
          flush=True)
    print(json.dumps({"fleet_cross_device": fleet_cross_device_check(spec.reduced_cfg)}),
          flush=True)
    print(json.dumps({"mutation_cross_device": mutation_cross_device_check(spec.reduced_cfg)}),
          flush=True)
    overflowed = cross_device_check(spec.reduced_cfg)
    print(f"cross-device check: card and CPU agree on nodes, prompts and tokens (auto, "
          f"compact, auto with IVF) and on every strategy in both backends ({overflowed} "
          f"overflowing rows)", flush=True)
    print(json.dumps({"cross_device_indexes": cross_device_index_check(feat_cpu, rng)}),
          flush=True)
    mark("cross_device_gates")
    for rec in records:
        rec["launches"] = mp["launches"][rec["name"]]
    ell_record["launches"] = ell_launches
    ivf_record["launches"] = mp_ivf["launches"]["ivf_scan"]
    torch.cuda.empty_cache()

    cfg = spec.model_cfg
    flash_records = check_flash(cfg, rng)
    train, params = train_phase(cfg)
    print(json.dumps({"training": "starcoder2-3b bf16 full width and depth, train_4k, "
                      "global batch 2 as 2 micro-batches", "card": card,
                      **{k: v for k, v in train.items() if k != "steps_detail"}}), flush=True)
    prefill = prefill_check(params, cfg)
    print(json.dumps({"prefill_1024": prefill}), flush=True)
    del params
    torch.cuda.empty_cache()
    both = kernels_vs_plain_step(cfg)
    print(json.dumps({"kernels_vs_plain_step": both}), flush=True)
    losses = train_cross_device_check(spec.reduced_cfg)
    print(f"cross-device training check: card and CPU losses agree over 3 steps {losses}",
          flush=True)
    for rec in flash_records:
        rec["launches"] = train["launches"][rec["name"]]
    mark("flash_and_training")

    # Granite-MoE: the flash kernels at dh 64, two training steps, the
    # deepseek-7b token-mode serve and the reduced fp32 gate
    gspec = get_config(GRANITE)
    flash64 = check_flash(gspec.model_cfg, rng)
    gtrain, _ = train_phase(gspec.model_cfg, steps=2)
    print(json.dumps({"training": "granite-moe-1b-a400m bf16 full width and depth, train_4k, "
                      "global batch 2 as 2 micro-batches", "card": card,
                      **{k: v for k, v in gtrain.items() if k != "steps_detail"}}), flush=True)
    for rec in flash64:
        rec["launches"] = gtrain["launches"][rec["name"]]
        rec["name"] += "_dh64"
    gc.collect()
    torch.cuda.empty_cache()
    deepseek = token_mode_run(card, "deepseek-7b", requests=4, max_new=8)
    gate = granite_cross_device_check(gspec.reduced_cfg)
    print(json.dumps({"granite_cross_device": gate}), flush=True)
    print(json.dumps({"granite_summary": {
        "card": card, "moe_device_ms_per_step": {
            k: v["moe_device_ms_per_step"] for k, v in granite["moe_split"].items()},
        "moe_bound_ms": granite["moe_bound_ms"], "step_bound_ms": granite["step_bound_ms"],
        "kernels_per_step": granite["kernels_per_step"],
        "first_prefill_dropped_share": granite["first_prefill_drops"]["dropped_share_all_pairs"],
        "flash_dh64_ms": {r["name"]: [r["ms"], r["library_ms"], r["bound_ms"]] for r in flash64},
        "train_step_wall_ms": [d["wall_ms"] for d in gtrain["steps_detail"]],
        "deepseek_7b_tok_per_s": deepseek["tok_per_s"]}}), flush=True)
    mark("granite_training_and_gate")
    records += flash_records + flash64 + [ell_record, ivf_record]
    gc.collect()
    torch.cuda.empty_cache()
    zoo_record, measured = zoo_phase(card)
    records.append(zoo_record)
    mark("zoo")
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_phase(card, measured)
    mark("dryrun")
    gc.collect()
    torch.cuda.empty_cache()
    sharded_phase(card, stack, brute_tokens)
    del stack
    mark("sharded_over_cards")

    for rec in records:
        print(json.dumps({"kernel": rec["name"], "card": card, **rec}))
    print(json.dumps({"profiler_traces": PROFILER_TRACES}))
    print(json.dumps({"script_s": time.perf_counter() - t_script, "card": card,
                      "phases_s": phases_s}))
    print(json.dumps({"kernels": records}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
