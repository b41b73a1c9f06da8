"""End-to-end driver on the PyTorch/CUDA port: train an LM on RAG-augmented
citation data (the twin of ``examples/train_rag_lm.py``), on the card by
default.

Retrieval (the RGL pipeline) runs inside the data path — each batch's
prompts are retrieved subgraph linearizations, and the LM learns to generate
the node text given its retrieved context (the paper's abstract-generation
setup as a *training* task).  Full substrate stack: AdamW + microbatching +
async checkpointing + straggler monitor + resume from the newest checkpoint.

Defaults are CPU-sized (~2M params, 200 steps).  --model_scale 100m selects
the ~105M-parameter bf16 configuration for the card.

    PYTHONPATH=src python examples/torch_train_rag_lm.py --steps 200
    PYTHONPATH=src python examples/torch_train_rag_lm.py --device cpu --steps 20
    PYTHONPATH=src python examples/torch_train_rag_lm.py --model_scale 100m --nodes 169343
"""
import argparse
import os
import time

import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.core.indexing import BruteIndex
from repro_torch.core.pipeline import PipelineConfig, RGLPipeline
from repro_torch.core.tokenization import GraphTokenizer, Vocab
from repro_torch.data import rag_token_stream
from repro_torch.graph import generators
from repro_torch.graph.ell import csr_to_ell
from repro_torch.models.transformer import TransformerConfig
from repro_torch.models.transformer import model as tm
from repro_torch.training import AdamWConfig, TrainLoop, make_train_step
from repro_torch.tree import tree_leaves

DEFAULT_CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "build",
                                "rag_lm_ckpt")


def model_config(scale: str, vocab: int) -> TransformerConfig:
    if scale == "100m":
        return TransformerConfig(
            name="rag-lm-100m", n_layers=12, d_model=768, n_heads=12,
            n_kv_heads=4, d_head=64, d_ff=3072, vocab=vocab, dtype="bfloat16",
        )
    return TransformerConfig(  # ~2M params: CPU-friendly
        name="rag-lm-2m", n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
        d_head=32, d_ff=512, vocab=vocab, dtype="float32",
    )


def build_pipeline(g, ell, index, seq: int) -> RGLPipeline:
    """The retrieval pipeline (stages 1-4) over a built graph ``g`` (host
    CSR with node texts), its ELL layout and a vector index, on the ELL's
    device."""
    vocab = Vocab.build(g.node_text)
    return RGLPipeline(
        graph=ell, index=index, node_emb=ell.node_feat,
        tokenizer=GraphTokenizer(vocab, max_len=seq, node_budget=12),
        node_text=g.node_text,
        config=PipelineConfig(strategy="bfs", k_seeds=3, max_nodes=24,
                              filter_budget=8),
        device=ell.nbr.device,
    )


def token_stream(pipe: RGLPipeline, g, batch: int, seq: int):
    """The RAG token stream of the example: titles as queries, node texts
    as targets."""
    titles = [" ".join(t.split()[:4]) for t in g.node_text]
    return rag_token_stream(pipe, titles, g.node_feat, g.node_text, batch=batch, max_len=seq)


def trainer(cfg: TransformerConfig, steps: int):
    """``(init_state, step)`` of the example: AdamW, 2 micro-batches."""
    def loss_fn(p, batch):
        return tm.lm_loss(p, batch["tokens"], batch["loss_mask"], cfg)

    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=steps)
    return make_train_step(loss_fn, opt_cfg, n_microbatches=2)


def run(args, params=None) -> dict:
    """Build the pipeline and the LM on ``args.device`` and train
    ``args.steps`` steps (from the newest checkpoint under ``--resume``);
    ``params`` replaces the seeded weights.  Returns the loss history, the
    final state and the loop's monitor."""
    # ---- RGL retrieval pipeline (stages 1-4) -------------------------------
    g = generators.citation_graph(args.nodes, avg_deg=8, seed=0)
    ell = csr_to_ell(g, device=args.device)
    pipe = build_pipeline(g, ell, BruteIndex.build(g.node_feat, device=args.device), args.seq)
    data = token_stream(pipe, g, args.batch, args.seq)

    # ---- LM + training substrate -------------------------------------------
    vocab = pipe.tokenizer.vocab
    cfg = model_config(args.model_scale, vocab.size)
    dev = pipe.device
    if params is None:
        params = tm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"model: {cfg.name}  params={n_params/1e6:.1f}M  vocab={vocab.size}")

    init_state, step = trainer(cfg, args.steps)
    state = init_state(params)
    start = 0
    if args.resume and latest_step(args.ckpt_dir) is not None:
        state, start = restore_checkpoint(args.ckpt_dir, state)
        print(f"resumed from step {start}")

    os.makedirs(args.ckpt_dir, exist_ok=True)
    loop = TrainLoop(
        step_fn=step,
        data_iter=data,
        checkpointer=AsyncCheckpointer(args.ckpt_dir, keep=2),
        checkpoint_every=50,
        log_every=10,
    )
    t0 = time.time()
    state, history = loop.run(state, args.steps, start_step=start)
    loop.checkpointer.close()
    if history:
        print(f"loss: {history[0][1]:.3f} -> {history[-1][1]:.3f} "
              f"({args.steps} steps, {time.time() - t0:.0f}s)")
    if loop.monitor.stragglers():
        print("stragglers detected:", loop.monitor.stragglers())
    return {"history": history, "state": state, "start": start, "monitor": loop.monitor}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=192)
    ap.add_argument("--nodes", type=int, default=1500)
    ap.add_argument("--model_scale", default="2m", choices=["2m", "100m"])
    ap.add_argument("--ckpt_dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    main()
