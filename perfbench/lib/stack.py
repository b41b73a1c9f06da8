"""The system under test, built from a configuration file: the corpus
(made by the benchmark) handed to the program as CSR arrays, the program's
retrieval pipeline over it, and the program's model configuration."""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import corpus as ref_corpus


def load_corpus(cfg: dict, cache_dir) -> dict:
    arrays = ref_corpus.load(cfg["corpus"], cache_dir)
    arrays["texts"] = ref_corpus.node_texts(arrays["text_ids"])
    return arrays


def pipeline(cfg: dict, corpus: dict, device: torch.device, with_tokenizer: bool = True):
    """The program's ``RGLPipeline`` over the corpus (brute index, the
    configuration's retriever settings)."""
    from repro_torch.core.pipeline import PipelineConfig, RGLPipeline, index_from_config
    from repro_torch.core.tokenization import GraphTokenizer, Vocab
    from repro_torch.graph.csr import CSRGraph
    from repro_torch.graph.ell import csr_to_ell

    rc = cfg["retriever"]
    n = corpus["indptr"].shape[0] - 1
    g = CSRGraph(indptr=corpus["indptr"], indices=corpus["indices"], num_nodes=n,
                 node_feat=corpus["feat"], node_text=corpus["texts"])
    ell = csr_to_ell(g, device=device)
    pcfg = PipelineConfig(strategy=rc["strategy"], k_seeds=rc["k_seeds"], max_hops=rc["max_hops"],
                          max_nodes=rc["max_nodes"], filter_budget=rc["filter_budget"],
                          index_kind=rc["index"], retrieval_mode=rc["retrieval_mode"],
                          workset_cap=rc["workset_cap"])
    index = index_from_config(ell.node_feat, pcfg, device=device)
    tok = None
    if with_tokenizer:
        vocab = Vocab.build(corpus["texts"])
        tok = GraphTokenizer(vocab, max_len=rc["max_len"], node_budget=rc["node_budget"])
    return RGLPipeline(graph=ell, index=index, node_emb=ell.node_feat, tokenizer=tok,
                       node_text=corpus["texts"], config=pcfg, device=device)


def model_dims(cfg: dict) -> dict:
    """The decoder's sizes as run, under the names the benchmark's weights,
    counts and reference use."""
    m = cfg["model"]
    out = {k: m[k] for k in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head", "d_ff",
                             "vocab", "rope_theta", "norm_eps")}
    out["sliding_window"] = m.get("sliding_window")
    out["moe"] = m.get("moe")
    return out


def transformer_config(dims: dict):
    from repro_torch.models.transformer.config import MoEConfig, TransformerConfig

    moe = None
    if dims["moe"]:
        mo = dims["moe"]
        moe = MoEConfig(n_experts=mo["n_experts"], top_k=mo["top_k"], d_ff=mo["d_ff"],
                        capacity_factor=mo["capacity_factor"])
    return TransformerConfig(
        name="perfbench", n_layers=dims["n_layers"], d_model=dims["d_model"],
        n_heads=dims["n_heads"], n_kv_heads=dims["n_kv_heads"], d_head=dims["d_head"],
        d_ff=dims["d_ff"], vocab=dims["vocab"], rope_theta=dims["rope_theta"],
        sliding_window=dims["sliding_window"], moe=moe, dtype="bfloat16",
        norm_eps=dims["norm_eps"])


def apply(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s keys replaced, nested dicts merged (the CPU
    tests shrink a configuration this way)."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = apply(out.get(k) or {}, v) if isinstance(v, dict) else v
    return out

