"""Serving launcher (``--rag``): a synthetic citation graph + a vector index
(brute, IVF, sharded or sharded IVF) feed raw (query embedding, query text)
requests through ``RAGServeEngine`` (batched retrieval admission + retrieval
cache + decode), on the card by default.  ``--prefetch`` overlaps the next
wave's retrieval with decode on a side CUDA stream; ``--fault-rate`` injects
seeded retrieval faults (``--retries``, ``--retrieval-timeout`` and the
degradation ladder contain them); ``--replicas N`` serves through N engines
behind ``ReplicaRouter`` with a shared retrieval cache, and
``--crash-replica STEP`` crashes the last one mid-run (failover).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b --rag
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b --rag \
        --nodes 169343
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b --rag \
        --index sharded_ivf --shards 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b --rag \
        --paged-kv --prefix-share --admission continuous --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b --rag \
        --spec-decode --draft-window 4 --paged-kv --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b --rag \
        --device cpu --prefetch --fault-rate 0.25 --retries 2 --replicas 2 --crash-replica 3

The CLI serves the arch's reduced config, as the reference launcher does;
:func:`_serve_rag` takes any config (``chip_smoke.py`` passes the full one).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch import resolve_device
from repro_torch.core.pipeline import PipelineConfig, RGLPipeline, index_from_config
from repro_torch.core.tokenization import GraphTokenizer, Vocab
from repro_torch.graph import generators
from repro_torch.graph.ell import csr_to_ell
from repro_torch.models.transformer import model as tm
from repro_torch.serving import (
    FaultyReplica, FaultyRetrieval, RAGRequest, RAGServeEngine, ReplicaRouter, RetrievalCache,
    ServingConfig,
)


def _build_rag(cfg, args, params: Optional[dict] = None) -> dict:
    """The graph, index, pipeline and model named by ``args`` on
    ``args.device``: a dict of ``g``, ``pipe``, ``cfg`` (the vocabulary set
    to the tokenizer's) and ``params`` (seeded random weights unless given;
    a CPU and a CUDA generator draw different numbers from one seed)."""
    dev = resolve_device(args.device)
    g = generators.citation_graph(args.nodes, avg_deg=8, seed=0)
    ell = csr_to_ell(g, device=dev)
    emb = ell.node_feat
    vocab = Vocab.build(g.node_text)
    # the arch LM decodes the graph tokenizer's vocabulary
    cfg = dataclasses.replace(cfg, vocab=vocab.size)
    tok = GraphTokenizer(vocab, max_len=96, node_budget=8)
    pcfg = PipelineConfig(strategy="bfs", k_seeds=3, max_nodes=16, filter_budget=6,
                          index_kind=args.index, index_shards=args.shards,
                          retrieval_mode=args.retrieval,
                          workset_cap=getattr(args, "workset_cap", None) or 2048)
    index = index_from_config(emb, pcfg, device=dev)
    pipe = RGLPipeline(graph=ell, index=index, node_emb=emb, tokenizer=tok,
                       node_text=g.node_text, config=pcfg, device=dev)
    if params is None:
        params = tm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    return {"g": g, "pipe": pipe, "cfg": cfg, "params": params}


def _serving_config(args, cache_len: int) -> ServingConfig:
    """One ServingConfig for every serving flag of ``args`` (flag > RGL_*
    env > default); the flags are optional attributes of ``args``."""
    opt = lambda name: getattr(args, name, None)  # noqa: E731
    return ServingConfig.resolve(
        None, slots=args.slots, cache_len=cache_len, cache_policy=args.cache_policy,
        cache_ttl=opt("cache_ttl"), prefetch=opt("prefetch"),
        prefetch_depth=opt("prefetch_depth"), admission=opt("admission"),
        paged_kv=opt("paged_kv"), prefix_share=opt("prefix_share"),
        kv_block_size=opt("kv_block"), kv_pool_blocks=opt("pool_blocks"),
        spec_decode=opt("spec_decode"), draft_window=opt("draft_window"),
        retrieval_timeout_s=opt("retrieval_timeout"), max_retries=opt("retries"),
        retry_backoff_s=opt("retry_backoff"), degraded_mode=opt("degraded"),
        compact_every=opt("compact_every"))


def _serve_rag(cfg, args, q_ids: Optional[np.ndarray] = None,
               params: Optional[dict] = None, stack: Optional[dict] = None,
               now_fn=time.monotonic, sleep_fn=time.sleep) -> dict:
    """Serve ``args.requests`` requests through ``RAGServeEngine`` (or, with
    ``args.replicas`` > 1, a fleet behind ``ReplicaRouter``) and return a
    summary.  ``stack`` (from :func:`_build_rag`) reuses a graph, pipeline
    and weights; otherwise they are built from ``args`` (``params`` replaces
    the seeded weights).  ``q_ids`` picks the query nodes (default: drawn as
    the reference does).  The serving, fault-tolerance and router flags and
    ``cache_len`` (the arena length; default: the window, or the longest
    prompt plus ``max_new``) are optional attributes of ``args``.
    ``now_fn`` / ``sleep_fn`` are the clock of the engines, the fault
    simulator and the router (a virtual clock makes a faulty serve
    reproducible across devices)."""
    t_setup = time.perf_counter()
    if stack is None:
        stack = _build_rag(cfg, args, params)
    g, pipe, cfg, params = stack["g"], stack["pipe"], stack["cfg"], stack["params"]
    dev = pipe.device
    if pipe.config.retrieval_mode != args.retrieval:
        pipe = dataclasses.replace(pipe, config=dataclasses.replace(
            pipe.config, retrieval_mode=args.retrieval))
    if getattr(args, "mutate_rate", 0.0):
        raise NotImplementedError("--mutate-rate is not ported yet: ROADMAP Queue 1 item 13 "
                                  "(online mutation)")
    fault_rate = getattr(args, "fault_rate", 0.0)
    if fault_rate > 0:
        # a seeded share of retrieval rows raise, stall or corrupt, through
        # the retry and degradation path
        pipe = FaultyRetrieval(pipe, seed=getattr(args, "fault_seed", 0), fault_rate=fault_rate,
                               now_fn=now_fn, sleep_fn=sleep_fn)
    # the linearized graph prompt (<= tokenizer max_len) plus generated
    # tokens must fit the arena; sliding_window only bounds attention reach
    cache_len = getattr(args, "cache_len", None) or max(cfg.sliding_window or 0,
                                                        96 + args.max_new + 1)
    serve_cfg = _serving_config(args, cache_len)
    replicas = getattr(args, "replicas", 1)
    if replicas > 1:
        # the shed and deadline knobs move to the router's front door; the
        # replicas share the weights and one retrieval cache
        cache = RetrievalCache(capacity=256 * replicas, policy=args.cache_policy,
                               ttl=getattr(args, "cache_ttl", None))
        engines = [RAGServeEngine(pipe, params, cfg, config=serve_cfg, retrieval_cache=cache,
                                  device=dev, now_fn=now_fn, sleep_fn=sleep_fn)
                   for _ in range(replicas)]
        if getattr(args, "crash_replica", None) is not None:
            engines[-1] = FaultyReplica(engines[-1], mode="crash", crash_step=args.crash_replica)
        server = ReplicaRouter(
            engines, failover=getattr(args, "failover", True),
            max_pending=getattr(args, "max_pending", None) or 0,
            shed_policy=getattr(args, "shed_policy", None) or "reject",
            replica_depth=getattr(args, "router_depth", None),
            health_window=getattr(args, "router_window", 8),
            trip_threshold=getattr(args, "router_trip", 3),
            cooldown_steps=getattr(args, "router_cooldown", 8),
            default_deadline_s=getattr(args, "deadline", None), now_fn=now_fn)
    else:
        engines = [RAGServeEngine(pipe, params, cfg, config=serve_cfg, device=dev,
                                  now_fn=now_fn, sleep_fn=sleep_fn,
                                  max_pending=getattr(args, "max_pending", None),
                                  shed_policy=getattr(args, "shed_policy", None),
                                  default_deadline_s=getattr(args, "deadline", None))]
        server = engines[0]
    if q_ids is None:
        q_ids = np.random.default_rng(0).choice(args.nodes, size=args.requests, replace=True)
    emb_np = g.node_feat
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()  # the set-up's work, before the clock
    setup_s = time.perf_counter() - t_setup
    t0 = time.perf_counter()
    for u, qi in enumerate(q_ids):
        server.submit(RAGRequest(
            uid=u, query_emb=emb_np[qi],
            query_text=" ".join(g.node_text[qi].split()[:4]),
            max_new_tokens=args.max_new,
        ))
    # drain() never raises: under fault injection or tight deadlines the
    # stragglers are aborted and reported instead of crashing the launcher
    done = server.drain()
    dt = time.perf_counter() - t0
    ok = [r for r in done if r.done and not r.failed]
    toks = sum(len(r.out_tokens) for r in ok)
    inner = [e.engine if isinstance(e, FaultyReplica) else e for e in engines]
    s = inner[0].stats()
    out = {
        "engine": inner[0], "engines": inner, "server": server, "done": done, "cfg": cfg,
        "params": params, "stack": stack, "cache_len": cache_len,
        "setup_s": setup_s, "serve_s": dt, "tokens": toks, "ok": len(ok),
        "tok_per_s": toks / dt, "retrieval_s": sum(e.retrieval_seconds for e in inner),
        "retrieval_batches": sum(e.retrieval_batches for e in inner),
        "decode_ms_per_step": 1e3 * s["decode_seconds"] / max(s["decode_steps"], 1),
        "stats": s,
    }
    if replicas > 1:
        out["router_stats"] = server.stats()
    return out


def _print_kv_stats(s: dict) -> None:
    """The spec decode, paged pool, prefix-share and truncation lines of
    the reference launcher's printout."""
    if s["spec_decode"]:
        print(f"  spec decode: window={s['draft_window']}, {s['tokens_per_step']:.2f} accepted "
              f"tokens/step, accept rate {s['draft_accept_rate']:.2f} "
              f"({s['decode_steps']} verify dispatches)")
    if s["paged_kv"]:
        print(f"  paged KV: block={s['block_size']} tokens, pool={s['pool_blocks']} blocks, "
              f"high water {s['pool_high_water_blocks']} blocks")
    if s["prefix_share"]:
        print(f"  prefix share: {s['kv_shared_admits']} shared admits / "
              f"{s['kv_reused_tokens']} prompt tokens reused, {s['kv_cow_copies']} COW tail "
              f"copies, {s['kv_pins']} pins ({s['kv_pinned_blocks']} blocks held, "
              f"{s['kv_releases']} released)")
    if s["truncations"]:
        print(f"  truncations: {s['truncations']} request(s) retired by KV exhaustion before "
              f"reaching max_new_tokens")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=C.ARCH_IDS)
    ap.add_argument("--rag", action="store_true",
                    help="serve end-to-end through the fused RAG engine (the mode ported)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max_new", type=int, default=12)
    ap.add_argument("--nodes", type=int, default=1000, help="synthetic graph size")
    ap.add_argument("--index", default="brute", choices=["brute", "ivf", "sharded", "sharded_ivf"],
                    help="stage-1 vector index backend")
    ap.add_argument("--shards", type=int, default=None,
                    help="shard count for the sharded index kinds (default: one per device)")
    ap.add_argument("--retrieval", default="auto", choices=["dense", "compact", "auto"],
                    help="stage-3 subgraph construction backend")
    ap.add_argument("--cache-policy", default="lru", choices=["lru", "lfu", "ttl"])
    ap.add_argument("--admission", default=None, choices=["wave", "continuous"],
                    help="admission granularity: whole waves, or one retrieval launch and "
                         "collect per free slot (default honors RGL_ADMISSION, 'wave')")
    ap.add_argument("--paged-kv", action=argparse.BooleanOptionalAction, default=None,
                    help="paged KV pool: block-table indirection over fixed-size blocks; "
                         "slots return blocks the step they retire (--no-paged-kv forces "
                         "the contiguous arena; default honors RGL_PAGED_KV)")
    ap.add_argument("--prefix-share", action=argparse.BooleanOptionalAction, default=None,
                    help="pin cached entries' prefilled prompt blocks and alias them into "
                         "later identical prompts (refcounted copy on write; needs "
                         "--paged-kv; default honors RGL_PREFIX_SHARE)")
    ap.add_argument("--kv-block", type=int, default=None,
                    help="tokens per KV block (must divide cache_len; default: largest "
                         "divisor <= 16, or RGL_KV_BLOCK)")
    ap.add_argument("--pool-blocks", type=int, default=None,
                    help="blocks in the shared KV pool (default slots*cache_len/block, full "
                         "capacity; fewer save memory and may truncate generations)")
    ap.add_argument("--spec-decode", action=argparse.BooleanOptionalAction, default=None,
                    help="self-speculative multi-token decode: verify a window of "
                         "prompt-lookup drafts per step (--no-spec-decode forces one-token "
                         "decode; default honors RGL_SPEC_DECODE)")
    ap.add_argument("--draft-window", type=int, default=None,
                    help="fed tokens per speculative step (1 committed + W-1 drafts; default "
                         "honors RGL_DRAFT_WINDOW, 4)")
    ap.add_argument("--workset-cap", type=int, default=2048,
                    help="compact backend candidate capacity per query")
    ap.add_argument("--cache-ttl", type=float, default=None,
                    help="retrieval-cache entry expiry in seconds")
    ap.add_argument("--prefetch", action=argparse.BooleanOptionalAction, default=None,
                    help="async admission: overlap the next wave's retrieval (on a side CUDA "
                         "stream) with the current decode steps (--no-prefetch forces sync; "
                         "default honors RGL_PREFETCH)")
    ap.add_argument("--prefetch-depth", type=int, default=None,
                    help="max launched-but-uncollected admission waves (default: slots under "
                         "--admission continuous, else 1)")
    ap.add_argument("--retrieval-timeout", type=float, default=None,
                    help="seconds before an unready retrieval wave is timed out (default "
                         "honors RGL_RETRIEVAL_TIMEOUT; unset = wait forever)")
    ap.add_argument("--retries", type=int, default=None,
                    help="retry budget of a failed retrieval miss-group (size-1 relaunches; "
                         "default honors RGL_RETRIES, 0)")
    ap.add_argument("--retry-backoff", type=float, default=None,
                    help="base seconds of the exponential retry backoff (default honors "
                         "RGL_RETRY_BACKOFF, 0)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline in seconds from submit; expired requests are "
                         "shed, never dispatched (default honors RGL_DEADLINE; unset = none)")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="pending-queue bound; overflow triggers --shed-policy (default honors "
                         "RGL_MAX_PENDING, 0 = unbounded)")
    ap.add_argument("--shed-policy", default=None, choices=["reject", "evict-oldest"],
                    help="overflow victim: the new request or the oldest pending one (default "
                         "honors RGL_SHED_POLICY, 'reject')")
    ap.add_argument("--degraded", action=argparse.BooleanOptionalAction, default=None,
                    help="retrieval-free (query-only) decode when retries and the stale cache "
                         "are exhausted (--no-degraded fails such requests; default honors "
                         "RGL_DEGRADED, on)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through N engine replicas behind ReplicaRouter with a shared "
                         "retrieval cache (1 = one engine, no router)")
    ap.add_argument("--failover", action=argparse.BooleanOptionalAction, default=True,
                    help="re-dispatch a crashed replica's requests onto survivors "
                         "(--no-failover strands them failed)")
    ap.add_argument("--crash-replica", type=int, default=None, metavar="STEP",
                    help="failover demo: the last replica crashes after STEP engine steps")
    ap.add_argument("--router-depth", type=int, default=None,
                    help="max assigned requests a replica before the router stops routing "
                         "to it (default 2x slots)")
    ap.add_argument("--router-window", type=int, default=8,
                    help="router health window: fault-counter deltas of the last N steps")
    ap.add_argument("--router-trip", type=int, default=3,
                    help="fault-delta sum over the window that trips a replica's circuit")
    ap.add_argument("--router-cooldown", type=int, default=8,
                    help="router steps an open circuit waits before a half-open probe (also "
                         "the crashed-replica revival interval)")
    ap.add_argument("--mutate-rate", type=float, default=0.0,
                    help="online mutation (not ported yet: ROADMAP Queue 1 item 13)")
    ap.add_argument("--compact-every", type=int, default=None,
                    help="online mutation compaction (not ported yet: ROADMAP Queue 1 item 13)")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="inject seeded retrieval faults on this share of query rows (0 = off)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the per-row fault schedule")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not args.rag:
        raise SystemExit("token mode is not ported yet (ROADMAP Queue 1 item 15); pass --rag")
    out = _serve_rag(C.get_config(args.arch).reduced_cfg, args)
    if args.replicas > 1:
        _print_fleet(args, out)
        return out
    s = out["stats"]
    print(f"[{args.arch}] RAG-served {out['ok']}/{len(out['done'])} requests / "
          f"{out['tokens']} tokens in {out['serve_s']:.2f}s ({out['tok_per_s']:.1f} tok/s) "
          f"on {args.device}; {s['retrieval_batches']} retrieval batches, "
          f"cache {s['hits']}/{s['hits'] + s['misses']} hits")
    _print_fault_stats(s, args.fault_rate)
    _print_kv_stats(s)
    return out


def _print_fault_stats(s: dict, fault_rate: float) -> None:
    """The fault-tolerance and prefetch lines of the reference launcher."""
    ft = (s["retries"], s["timeouts"], s["failed"], s["shed"], s["degraded"],
          s["stale_served"])
    if any(ft) or fault_rate > 0:
        print(f"  fault tolerance: {s['retries']} retries, {s['timeouts']} timeouts, "
              f"{s['failed']} failed, {s['shed']} shed, {s['degraded']} degraded-served, "
              f"{s['stale_served']} stale-served")
    if s["prefetch"]:
        print(f"  prefetch: {s['prefetch_waves']} waves, {s['overlap_seconds'] * 1e3:.1f}ms "
              f"overlapped ({s['overlap_steps']} decode steps / {s['overlap_tokens']} accepted "
              f"tokens), hidden_frac={s['hidden_frac']:.2f}")


def _print_fleet(args, out: dict) -> None:
    """The reference launcher's fleet printout."""
    s, cs = out["router_stats"], out["engine"].cache.stats()
    print(f"[{args.arch}] fleet of {args.replicas} replicas RAG-served "
          f"{out['ok']}/{len(out['done'])} requests / {out['tokens']} tokens in "
          f"{out['serve_s']:.2f}s ({out['tok_per_s']:.1f} tok/s) on {args.device}")
    print(f"  router: {s['submitted']} submitted, {s['front_door_shed']} shed, "
          f"{s['failovers']} failover(s), {s['redispatched']} re-dispatched, "
          f"{s['stranded']} stranded")
    print(f"  shared cache: {cs['hits']}/{cs['hits'] + cs['misses']} hits, "
          f"{cs['stale_hits']} stale hits, {cs['size']} entries")
    for pr in s["per_replica"]:
        line = (f"  {pr['name']}: circuit={pr['circuit']}, dispatched={pr['dispatched']}, "
                f"delivered={pr['delivered']}, crashes={pr['crashes']}, trips={pr['trips']}")
        h = pr["health"]  # None for a crashed replica
        if h is not None:
            line += (f"; retries={h['retries']}, timeouts={h['timeouts']}, "
                     f"failed={h['failed']}, degraded={h['degraded']}")
        print(line)


if __name__ == "__main__":
    main()
