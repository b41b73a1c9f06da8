"""RGL quickstart on the PyTorch/CUDA port: the 5-stage pipeline on a
synthetic citation graph (the twin of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --generator lm

``--generator lm`` ends the same pipeline in the LM generator
(``make_lm_generator``: a 2-layer LM with seeded random weights, greedy)
instead of the extractive one.
"""
import argparse

import numpy as np
import torch

from repro_torch.core.generation import ExtractiveGenerator, make_lm_generator
from repro_torch.core.indexing import BruteIndex
from repro_torch.core.pipeline import PipelineConfig, RGLPipeline
from repro_torch.core.tokenization import GraphTokenizer, Vocab
from repro_torch.graph import generators
from repro_torch.graph.ell import csr_to_ell
from repro_torch.models.transformer import TransformerConfig
from repro_torch.models.transformer import model as tm

Q_IDS = [10, 500, 1500]
LM_NEW_TOKENS = 16


def lm_config(vocab_size: int) -> TransformerConfig:
    """The LM ``--generator lm`` decodes with (``examples/serve_rag.py``'s)."""
    return TransformerConfig(name="quickstart-lm", n_layers=2, d_model=64, n_heads=4,
                             n_kv_heads=2, d_head=16, d_ff=256, vocab=vocab_size,
                             dtype="float32")


def run(device="cuda", generator: str = "extractive", params=None) -> dict:
    """Build the pipeline on ``device`` and run the three queries.  With
    ``generator="lm"``, ``params`` replaces the LM's seeded weights.
    Returns the pipeline's output dict plus ``q_ids``."""
    # 1) data + index (stage 1: indexing)
    g = generators.citation_graph(2000, avg_deg=8, seed=0)
    ell = csr_to_ell(g, device=device)
    index = BruteIndex.build(g.node_feat, device=device)

    # tokenizer + generator (stages 4-5)
    vocab = Vocab.build(g.node_text)
    tok = GraphTokenizer(vocab, max_len=384, node_budget=24)
    if generator == "lm":
        cfg = lm_config(vocab.size)
        if params is None:
            dev = ell.nbr.device
            params = tm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        gen = make_lm_generator(params, cfg, vocab, cache_len=384 + LM_NEW_TOKENS + 1)
    else:
        gen = ExtractiveGenerator(vocab, max_words=32)

    pipe = RGLPipeline(
        graph=ell, index=index, node_emb=ell.node_feat, tokenizer=tok, generator=gen,
        node_text=g.node_text, device=device,
        config=PipelineConfig(strategy="steiner", k_seeds=4, max_hops=3, max_nodes=48,
                              filter_budget=16),
    )

    # a batch of queries = noisy versions of some node embeddings
    qe = g.node_feat[np.asarray(Q_IDS)] + np.float32(0.05)
    out = pipe.run(qe, [" ".join(g.node_text[i].split()[:5]) for i in Q_IDS],
                   max_new_tokens=LM_NEW_TOKENS if generator == "lm" else 0)
    return {**out, "q_ids": Q_IDS}


def report(out: dict) -> None:
    for r, qi in enumerate(out["q_ids"]):
        print(f"query node {qi}")
        print(f"  seeds: {out['seeds'][r].tolist()}")
        kept = int(out["subgraph"].mask[r].sum())
        print(f"  retrieved subgraph: {kept} nodes (steiner, filtered)")
        print(f"  generated: {out['outputs'][r][:100]}...")
    print("\npipeline stages: index -> node retrieval -> graph retrieval "
          "-> dynamic filter -> tokenize -> generate  [OK]")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--generator", default="extractive", choices=["extractive", "lm"])
    args = ap.parse_args(argv)
    report(run(args.device, args.generator))


if __name__ == "__main__":
    main()
