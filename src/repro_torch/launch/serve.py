"""Serving launcher (``--rag``): a synthetic citation graph + a vector index
(brute, IVF, sharded or sharded IVF) feed raw (query embedding, query text)
requests through ``RAGServeEngine`` (batched retrieval admission + retrieval
cache + decode), on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b --rag
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b --rag \
        --nodes 169343
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b --rag \
        --index sharded_ivf --shards 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b --rag \
        --paged-kv --prefix-share --admission continuous --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b --rag \
        --spec-decode --draft-window 4 --paged-kv --device cpu

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
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.rag_engine import RAGRequest, RAGServeEngine


def _serve_rag(cfg, args, q_ids: Optional[np.ndarray] = None,
               params: Optional[dict] = None) -> dict:
    """Build the graph, index, pipeline and model named by ``args`` on
    ``args.device``, serve ``args.requests`` requests, and return a summary.
    ``q_ids`` picks the query nodes (default: drawn as the reference does);
    ``params`` replaces the seeded random weights (a CPU and a CUDA
    generator draw different numbers from one seed).  The serving flags
    (``admission``, ``paged_kv``, ``prefix_share``, ``kv_block``,
    ``pool_blocks``, ``spec_decode``, ``draft_window``) and ``cache_len`` (the arena length; default: the
    window, or the longest prompt plus ``max_new``) are optional
    attributes of ``args``."""
    dev = resolve_device(args.device)
    t_setup = time.perf_counter()
    g = generators.citation_graph(args.nodes, avg_deg=8, seed=0)
    ell = csr_to_ell(g, device=dev)
    emb = ell.node_feat
    vocab = Vocab.build(g.node_text)
    # the arch LM decodes the graph tokenizer's vocabulary
    cfg = dataclasses.replace(cfg, vocab=vocab.size)
    tok = GraphTokenizer(vocab, max_len=96, node_budget=8)
    pcfg = PipelineConfig(strategy="bfs", k_seeds=3, max_nodes=16, filter_budget=6,
                          index_kind=args.index, index_shards=args.shards,
                          retrieval_mode=args.retrieval)
    index = index_from_config(emb, pcfg, device=dev)
    pipe = RGLPipeline(graph=ell, index=index, node_emb=emb, tokenizer=tok,
                       node_text=g.node_text, config=pcfg, device=dev)
    if params is None:
        params = tm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    # the linearized graph prompt (<= tokenizer max_len) plus generated
    # tokens must fit the arena; sliding_window only bounds attention reach
    cache_len = getattr(args, "cache_len", None) or max(cfg.sliding_window or 0,
                                                        96 + args.max_new + 1)
    serve_cfg = ServingConfig.resolve(
        None, slots=args.slots, cache_len=cache_len, cache_policy=args.cache_policy,
        admission=getattr(args, "admission", None), paged_kv=getattr(args, "paged_kv", None),
        prefix_share=getattr(args, "prefix_share", None),
        kv_block_size=getattr(args, "kv_block", None),
        kv_pool_blocks=getattr(args, "pool_blocks", None),
        spec_decode=getattr(args, "spec_decode", None),
        draft_window=getattr(args, "draft_window", None))
    eng = RAGServeEngine(pipe, params, cfg, config=serve_cfg, device=dev)
    if q_ids is None:
        q_ids = np.random.default_rng(0).choice(args.nodes, size=args.requests, replace=True)
    emb_np = g.node_feat
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_setup
    t0 = time.perf_counter()
    for u, qi in enumerate(q_ids):
        eng.submit(RAGRequest(
            uid=u, query_emb=emb_np[qi],
            query_text=" ".join(g.node_text[qi].split()[:4]),
            max_new_tokens=args.max_new,
        ))
    done = eng.drain()
    dt = time.perf_counter() - t0
    ok = [r for r in done if r.done and not r.failed]
    toks = sum(len(r.out_tokens) for r in ok)
    s = eng.stats()
    return {
        "engine": eng, "done": done, "cfg": cfg, "params": params, "cache_len": cache_len,
        "setup_s": setup_s, "serve_s": dt, "tokens": toks, "ok": len(ok),
        "tok_per_s": toks / dt, "retrieval_s": s["retrieval_seconds"],
        "retrieval_batches": s["retrieval_batches"],
        "decode_ms_per_step": 1e3 * s["decode_seconds"] / max(s["decode_steps"], 1),
        "stats": s,
    }


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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not args.rag:
        raise SystemExit("token mode is not ported yet (ROADMAP Queue 1 item 15); pass --rag")
    out = _serve_rag(C.get_config(args.arch).reduced_cfg, args)
    s = out["stats"]
    print(f"[{args.arch}] RAG-served {out['ok']}/{len(out['done'])} requests / "
          f"{out['tokens']} tokens in {out['serve_s']:.2f}s ({out['tok_per_s']:.1f} tok/s) "
          f"on {args.device}; {s['retrieval_batches']} retrieval batches, "
          f"cache {s['hits']}/{s['hits'] + s['misses']} hits")
    _print_kv_stats(s)
    return out


if __name__ == "__main__":
    main()
