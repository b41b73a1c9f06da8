"""RGL Functional API (paper §2.3.2; the reference's
``repro.core.functional``).

Every pipeline stage as a composable, injectable function — "for advanced
scenarios, such as meta-learning or dynamic parameterization, where
developers may need to inject custom logic at various stages".  Stages share
a plain-dict context so custom stages can be spliced anywhere:

    run = compose(
        stage_embed(index),
        stage_seeds(k=4),
        stage_subgraph(graph, "steiner", max_hops=3, max_nodes=48),
        my_custom_rerank_stage,           # any ctx -> ctx callable
        stage_filter(node_emb, budget=16),
        stage_tokenize(tokenizer, node_text),
    )
    ctx = run({"query_emb": qe, "query_texts": titles})

The stages are the port's: ``stage_embed`` puts the queries on the index's
device as fp32 tensors, the retrieval stages run there, ``stage_tokenize``
linearizes on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import filters, graph_retrieval, tokenization

Stage = Callable[[dict], dict]


def compose(*stages: Stage) -> Stage:
    def run(ctx: dict) -> dict:
        for s in stages:
            ctx = s(ctx)
        return ctx

    return run


def _index_device(index):
    """The device of the index's first tensor field (None if it has none)."""
    if dataclasses.is_dataclass(index):
        for f in dataclasses.fields(index):
            v = getattr(index, f.name)
            if isinstance(v, torch.Tensor):
                return v.device
    return None


def stage_embed(index, encoder=None) -> Stage:
    def fn(ctx):
        q = torch.as_tensor(ctx["query_emb"], dtype=torch.float32, device=_index_device(index))
        ctx["query_emb"] = encoder(q) if encoder is not None else q
        ctx["index"] = index
        return ctx

    return fn


def stage_seeds(k: int = 4) -> Stage:
    def fn(ctx):
        scores, seeds = ctx["index"].search(ctx["query_emb"], k)
        ctx["seed_scores"], ctx["seeds"] = scores, seeds
        return ctx

    return fn


def stage_subgraph(graph, strategy: str = "bfs", **kw) -> Stage:
    def fn(ctx):
        ctx["subgraph"] = graph_retrieval.retrieve_subgraph(
            graph, ctx["seeds"], strategy, **kw
        )
        return ctx

    return fn


def stage_filter(node_emb, budget: int) -> Stage:
    def fn(ctx):
        scores = filters.similarity_scores(node_emb, ctx["query_emb"])
        ctx["subgraph"] = filters.dynamic_filter(
            ctx["subgraph"], scores, torch.as_tensor(ctx["seeds"], device=node_emb.device),
            budget=budget,
        )
        return ctx

    return fn


def stage_tokenize(tokenizer, node_text) -> Stage:
    def fn(ctx):
        texts = tokenization.subgraph_texts(ctx["subgraph"], node_text)
        ids, mask = tokenizer.batch_linearize(ctx["query_texts"], texts)
        ctx["prompt_ids"], ctx["prompt_mask"] = ids, mask
        return ctx

    return fn


def stage_generate(generator, max_new_tokens: int = 0) -> Stage:
    def fn(ctx):
        ctx["outputs"] = generator.generate(
            ctx["prompt_ids"], ctx["prompt_mask"], max_new_tokens
        )
        return ctx

    return fn
