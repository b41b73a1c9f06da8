"""Serve a small RAG-LM end to end with the port's fused engine (the twin of
``examples/serve_rag.py``), on the card by default.

Raw (query embedding, query text) requests go through the whole RGL stack
(index -> seed retrieval -> subgraph -> dynamic filter -> tokenization ->
batched prefill -> continuous-batching decode) inside one RAGServeEngine.
Retrieval is batched across each admission wave and cached (LRU on quantized
query embeddings), so repeated queries skip index + BFS entirely.

    PYTHONPATH=src python examples/torch_serve_rag.py --requests 12
    PYTHONPATH=src python examples/torch_serve_rag.py --device cpu --repeat 3
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.indexing import BruteIndex
from repro_torch.core.pipeline import PipelineConfig, RGLPipeline
from repro_torch.core.tokenization import N_SPECIAL, GraphTokenizer, Vocab
from repro_torch.graph import generators
from repro_torch.graph.ell import csr_to_ell
from repro_torch.models.transformer import TransformerConfig
from repro_torch.models.transformer import model as tm
from repro_torch.serving import RAGRequest, RAGServeEngine


def lm_config(vocab_size: int) -> TransformerConfig:
    return TransformerConfig(name="serve-lm", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                             d_head=16, d_ff=256, vocab=vocab_size, dtype="float32")


def run(args, params=None) -> dict:
    """Serve ``args.requests`` distinct queries plus ``args.repeat``
    duplicates on ``args.device``; ``params`` replaces the LM's seeded
    weights.  Returns the finished requests, the engine's stats, the
    vocabulary and the serve's seconds."""
    g = generators.citation_graph(1000, avg_deg=8, seed=0)
    ell = csr_to_ell(g, device=args.device)
    vocab = Vocab.build(g.node_text)
    tok = GraphTokenizer(vocab, max_len=160, node_budget=10)
    pipe = RGLPipeline(
        graph=ell, index=BruteIndex.build(g.node_feat, device=args.device),
        node_emb=ell.node_feat, tokenizer=tok, node_text=g.node_text, device=args.device,
        config=PipelineConfig(strategy="bfs", k_seeds=3, max_nodes=16, filter_budget=6),
    )
    cfg = lm_config(vocab.size)
    if params is None:
        dev = ell.nbr.device
        params = tm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    eng = RAGServeEngine(pipe, params, cfg, slots=args.slots, cache_len=224, device=args.device)

    rng = np.random.default_rng(0)
    q_ids = rng.choice(1000, size=args.requests, replace=False)
    t0 = time.time()
    for qi in q_ids:
        eng.submit(RAGRequest(uid=int(qi), query_emb=g.node_feat[qi],
                              query_text=" ".join(g.node_text[qi].split()[:4]),
                              max_new_tokens=args.max_new))
    for _ in range(args.repeat):  # duplicates, served from the cache
        qi = q_ids[int(rng.integers(len(q_ids)))]
        eng.submit(RAGRequest(uid=10_000 + int(qi), query_emb=g.node_feat[qi],
                              query_text=" ".join(g.node_text[qi].split()[:4]),
                              max_new_tokens=args.max_new))
    done = eng.run_to_completion()
    return {"done": done, "stats": eng.stats(), "vocab": vocab, "seconds": time.time() - t0}


def report(args, out: dict) -> None:
    done, s, dt = out["done"], out["stats"], out["seconds"]
    toks = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests / {toks} tokens in {dt:.1f}s "
          f"({toks / dt:.1f} tok/s, {args.slots} slots)")
    print(f"retrieval: {s['retrieval_batches']} batched calls for "
          f"{s['retrieved_queries']} queries in {s['retrieval_seconds']:.2f}s; "
          f"cache {s['hits']} hits / {s['misses']} misses")
    id2w = {v + N_SPECIAL: k for k, v in out["vocab"].word_to_id.items()}
    sample = done[0]
    words = " ".join(id2w.get(t, "?") for t in sample.out_tokens[:10])
    print(f"request {sample.uid} -> {words} ...")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max_new", type=int, default=16)
    ap.add_argument("--repeat", type=int, default=0,
                    help="extra duplicate requests (exercise the cache)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    report(args, run(args))


if __name__ == "__main__":
    main()
