#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

1. card: the card's name and power limit (``nvidia-smi``); fails without CUDA;
2. build: compile the hand-written kernels (``src/repro_torch/csrc``);
3. kernels: each kernel against its plain PyTorch version on the card, at the
   main path's shapes (the 169,343-node Arxiv-scale graph, D = 128, K = 1016)
   and on edge cases, with times of the kernel, the plain version and one
   library call, and the least time the card could take (``bound_ms``);
4. main path: ``repro_torch.launch.serve._serve_rag`` serves 8 distinct
   requests plus 4 repeats through ``RAGServeEngine`` with the full-width,
   full-depth StarCoder2-3B config in bf16 (random weights from a seed), the
   brute index and dense BFS, counting each kernel's launches; then a few
   decode steps and one retrieval wave are timed and profiled, and a small
   fp32 run checks the card's outputs against the CPU's exactly.

The second-to-last line is ``{"kernels": [...]}`` (one record per kernel);
the last is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM data-sheet peaks (the roofline the bounds are taken against)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
INT_OPS = 67e12  # 32-bit integer ops on the CUDA cores, same rate as fp32
N_NODES = 169_343  # OGBN-Arxiv's node count


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


def device_ms(fn, calls: int = 10) -> tuple[float, dict]:
    """Time the card spends running ``fn``'s kernels, per call (the sum of
    their durations in a ``torch.profiler`` trace, host gaps excluded), and
    that time split by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = kernel_ms_by_name(prof, calls)
    if not by_name:
        raise RuntimeError("the profiler recorded no device time")
    return sum(by_name.values()), by_name


def kernel_ms_by_name(prof, per: int) -> dict:
    """Device time of the kernels in a profiler trace, ms per ``per``."""
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name[:48]] = by_name.get(e.name[:48], 0.0) + e.device_time / 1e3 / per
    return by_name


def bound(n_bytes: float, n_ops: float, ops_rate: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_rate
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------- kernels ----
def check_topk_sim(emb: torch.Tensor, rng: np.random.Generator) -> dict:
    from repro_torch.core.indexing import l2_normalize
    from repro_torch.kernels.topk_sim import ops, ref

    dev = emb.device
    k = 3
    n, d = emb.shape

    def queries(q):
        rows = emb[torch.from_numpy(rng.choice(n, q)).to(dev)]
        noise = torch.from_numpy(rng.standard_normal((q, d)).astype(np.float32)).to(dev)
        return l2_normalize(rows + 0.05 * noise)

    def compare(q, e, kk):
        s_k, i_k = ops.topk_similarity(q, e, kk, use_kernel=True)
        torch.cuda.synchronize()
        s_p, i_p = ref.topk_similarity(q, e, min(kk + 1, e.shape[0]))
        err = (s_k - s_p[:, :kk]).abs().max().item()
        assert err <= 1e-5, f"topk_sim scores off by {err}"
        if s_p.shape[1] > kk:  # ids exact where the k-th score is clear of the (k+1)-th
            clear = (s_p[:, kk - 1] - s_p[:, kk]) > 1e-5
            assert torch.equal(i_k[clear], i_p[clear, :kk]), "topk_sim ids differ"
        else:
            assert torch.equal(i_k, i_p), "topk_sim ids differ"
        return err

    errs = [compare(queries(q), emb, k) for q in (1, 4)]
    small = emb[:1000]  # N not a multiple of the 256-row tile
    errs.append(compare(queries(5)[:, :d], small, 7))
    # duplicate rows: equal scores, ids lowest first, across tiles too
    dup = emb.clone()
    far = n - 343
    dup[[5, 700, far]] = emb[3]
    s_k, i_k = ops.topk_similarity(dup[3:4].clone(), dup, 4, use_kernel=True)
    torch.cuda.synchronize()
    assert i_k[0, :4].tolist() == [3, 5, 700, far], f"tie order {i_k.tolist()}"

    q4 = queries(4)
    run = lambda: ops.topk_similarity(q4, emb, k, use_kernel=True)  # noqa: E731
    ms, kernels = device_ms(run)
    plain_ms, _ = device_ms(lambda: ops.topk_similarity(q4, emb, k, use_kernel=False))
    library_ms, _ = device_ms(lambda: torch.topk(q4 @ emb.T, k))
    b_ms, b_by = bound(4 * (q4.numel() + emb.numel()) + 8 * 4 * k, 2 * 4 * n * d, FP32_FLOPS)
    return {"name": "topk_sim", "route": "cuda", "source": "src/repro_torch/csrc/topk_sim.cu",
            "replaces": "src/repro/kernels/topk_sim/kernel.py:80",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms, "call_ms": time_ms(run),
            "device_kernels_ms": kernels, "shape": f"Q=4 N={n} D={d} k={k}"}


def check_bfs_frontier(nbr: torch.Tensor, mask: torch.Tensor, rng: np.random.Generator) -> dict:
    from repro_torch.kernels.bfs_frontier import ops

    dev = nbr.device
    n, kd = nbr.shape
    rand = torch.from_numpy(rng.random((4, n)) < 1e-3).to(dev)
    front = torch.cat([rand, torch.zeros((1, n), dtype=torch.bool, device=dev),
                       torch.ones((1, n), dtype=torch.bool, device=dev)])
    got = ops.frontier_hop(front, nbr, mask, use_kernel=True)
    torch.cuda.synchronize()
    want = ops.frontier_hop(front, nbr, mask, use_kernel=False)
    assert torch.equal(got, want), "bfs_frontier differs from its plain version"
    # odd width (one-slot-per-lane path) on a small ELL with sentinel slots live
    sn, sk = 3000, 13
    snbr = torch.from_numpy(rng.integers(0, sn + 1, (sn, sk)).astype(np.int32)).to(dev)
    smask = torch.from_numpy(rng.random((sn, sk)) < 0.7).to(dev)
    sfront = torch.from_numpy(rng.random((3, sn)) < 0.05).to(dev)
    assert torch.equal(ops.frontier_hop(sfront, snbr, smask, use_kernel=True),
                       ops.frontier_hop(sfront, snbr, smask, use_kernel=False))

    f4 = rand
    run = lambda: ops.frontier_hop(f4, nbr, mask, use_kernel=True)  # noqa: E731
    ms, kernels = device_ms(run)
    plain_ms, _ = device_ms(lambda: ops.frontier_hop(f4, nbr, mask, use_kernel=False), calls=3)
    # library yardstick: the same hop as one sparse-matrix product, A (N, N)
    # CSR times the (N, Q) frontier; reach = product > 0
    live = mask.nonzero()
    adj = torch.sparse_coo_tensor(
        torch.stack([live[:, 0], nbr[mask].long()]), torch.ones(len(live), device=dev),
        (n, n + 1)).coalesce().to_sparse_csr()
    ff = torch.cat([f4, torch.zeros((4, 1), dtype=torch.bool, device=dev)], 1).T.float().contiguous()
    assert torch.equal((torch.sparse.mm(adj, ff) > 0).T, got[:4])
    library_ms, _ = device_ms(lambda: torch.sparse.mm(adj, ff))
    # bytes the hop must move: every mask byte, the id of every live slot,
    # the frontier in and the reach out
    nnz = len(live)
    b_ms, b_by = bound(n * kd + 4 * nnz + 2 * 4 * n, 4 * nnz, INT_OPS)
    return {"name": "bfs_frontier", "route": "cuda", "source": "src/repro_torch/csrc/bfs_frontier.cu",
            "replaces": "src/repro/kernels/bfs_frontier/kernel.py:49",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms, "call_ms": time_ms(run),
            "device_kernels_ms": kernels, "shape": f"Q=4 N={n} K={kd} live_slots={nnz}",
            "full_ell_bound_ms": 1e3 * (5 * n * kd + 8 * n) / HBM_BYTES_PER_S}


# -------------------------------------------------------------- main path ----
def serve_args(**kw) -> argparse.Namespace:
    base = dict(requests=12, slots=4, max_new=12, nodes=N_NODES, index="brute",
                retrieval="dense", cache_policy="lru", device="cuda")
    base.update(kw)
    return argparse.Namespace(**base)


def main_path(cfg) -> dict:
    """Serve 8 distinct requests plus 4 repeats through the port's entry
    points with ``cfg`` on the card; every kernel launch is counted."""
    from repro_torch.kernels.bfs_frontier import kernel as bfs_kernel
    from repro_torch.kernels.topk_sim import kernel as topk_kernel
    from repro_torch.launch.serve import _serve_rag

    args = serve_args()
    distinct = np.random.default_rng(0).choice(args.nodes, 8, replace=False)
    q_ids = np.concatenate([distinct, distinct[:4]])
    torch.cuda.reset_peak_memory_stats()
    topk_kernel.launches.reset()
    bfs_kernel.launches.reset()
    out = _serve_rag(cfg, args, q_ids=q_ids)
    launches = {"topk_sim": topk_kernel.launches.count, "bfs_frontier": bfs_kernel.launches.count}
    done, s = out["done"], out["stats"]
    assert len(done) == 12 and all(r.done and not r.failed for r in done), "requests lost or failed"
    vocab = out["cfg"].vocab
    for r in done:
        assert len(r.out_tokens) == args.max_new, (r.uid, len(r.out_tokens))
        assert all(0 <= t < vocab for t in r.out_tokens)
    assert s["hits"] >= 4 and all(r.cache_hit for r in done if r.uid >= 8), s["hits"]
    waves = out["retrieval_batches"]
    assert launches["topk_sim"] == waves > 0, (launches, waves)
    assert launches["bfs_frontier"] == 3 * waves, (launches, waves)
    decode_profile = profile_decode(out["engine"].engine)
    # one warm retrieval wave (4 fresh queries) on its own: wall time and
    # the device time of its kernels
    pipe = out["engine"].pipeline
    fresh = torch.from_numpy((q_ids[:4] + 1) % args.nodes).to(pipe.device)
    qw = pipe.node_emb[fresh].cpu().numpy()
    wave = lambda: pipe.retrieve_many(qw, batch_size=args.slots).nodes.cpu()  # noqa: E731
    wave_dev, wave_kernels = device_ms(wave, calls=3)
    retrieval_wave = {"wall_ms": time_ms(wave, reps=3, batch=2), "device_ms": wave_dev,
                      "top_kernels_ms": dict(sorted(wave_kernels.items(),
                                                    key=lambda kv: -kv[1])[:6])}
    return {"launches": launches, "waves": waves, "tok_per_s": out["tok_per_s"],
            "tokens": out["tokens"], "serve_s": out["serve_s"], "setup_s": out["setup_s"],
            "retrieval_s": out["retrieval_s"], "decode_ms_per_step": out["decode_ms_per_step"],
            "decode_steps": s["decode_steps"], "prefill_batches": s["prefill_batches"],
            "admit_s": s["admit_seconds"], "cache_hits": s["hits"], "cache_misses": s["misses"],
            "n_layers": cfg.n_layers, "cache_len": out["cache_len"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "decode_profile": decode_profile, "retrieval_wave": retrieval_wave}


def cross_device_check(reduced_cfg) -> None:
    """The whole main path at a small size on the card (kernels) and on the
    CPU (plain versions), with the same weights: retrieved nodes, prompts
    and tokens must agree."""
    from repro_torch.launch.serve import _serve_rag

    card = _serve_rag(reduced_cfg, serve_args(nodes=3000, requests=8))
    params = card["params"]
    host = {"embed": params["embed"].cpu(), "ln_f": params["ln_f"].cpu(),
            "head": params["head"].cpu(),
            "layers": {k: v.cpu() for k, v in params["layers"].items()}}
    cpu = _serve_rag(reduced_cfg, serve_args(nodes=3000, requests=8, device="cpu"), params=host)
    runs = [{r.uid: r for r in out["done"]} for out in (card, cpu)]
    for uid, a in runs[0].items():
        b = runs[1][uid]
        assert np.array_equal(a.retrieved_nodes, b.retrieved_nodes), uid
        assert np.array_equal(a.prompt_ids, b.prompt_ids), uid
        assert a.out_tokens == b.out_tokens, (uid, a.out_tokens, b.out_tokens)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
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
    records = [check_topk_sim(l2_normalize(ell.node_feat).contiguous(), rng),
               check_bfs_frontier(ell.nbr, ell.nbr_mask, rng)]
    del g, ell
    for rec in records:
        print(f"kernel check: {rec['name']} matches its plain version "
              f"(max abs err {rec['max_abs_err']:.3g})", flush=True)

    mp = main_path(spec.model_cfg)
    print(json.dumps({"main_path": "starcoder2-3b bf16, 169343-node graph, dense BFS",
                      "card": card, **mp}), flush=True)
    cross_device_check(spec.reduced_cfg)
    print("cross-device check: card and CPU agree on nodes, prompts and tokens", flush=True)

    for rec in records:
        rec["launches"] = mp["launches"][rec["name"]]
        print(json.dumps({"kernel": rec["name"], "card": card, **rec}))
    print(json.dumps({"kernels": records}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
