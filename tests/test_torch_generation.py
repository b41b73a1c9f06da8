"""The port's paper metrics and generation stage against the reference's:
ROUGE-1/2/L (``core/rouge.py``), the extractive generator and the LM
generator registry (``core/generation.py``; the LM generator itself is held
to the reference in ``tests/test_torch_lm_generate.py``), and the paper's
configuration
(``configs/rgl_paper.py``).

ROUGE dicts must be equal (the same float operations in the same order).
Generator outputs must be equal on prompts both sides' ``GraphTokenizer``
build in this one process: out-of-vocabulary ids come from Python's salted
``hash()``, the same within a process only.
"""
import dataclasses

import numpy as np
import pytest

from repro.configs import rgl_paper as ref_paper
from repro.core import GraphTokenizer as RefTokenizer
from repro.core import Vocab as RefVocab
from repro.core import rouge as ref_rouge
from repro.core.generation import ExtractiveGenerator as RefExtractive
from repro.graph import generators as ref_gen
from repro_torch.configs import rgl_paper
from repro_torch.core import generation, rouge
from repro_torch.core.tokenization import GraphTokenizer, Vocab
from repro_torch.graph import generators

WORDS = "graph node retrieval model query paper the a of neural citation abstract".split()


def _texts(rng, n):
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 14))
        out.append(" ".join(rng.choice(WORDS, k)) if k else "")
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rouge_equals_reference(seed):
    rng = np.random.default_rng(seed)
    hyps, refs = _texts(rng, 40), _texts(rng, 40)
    hyps[:4] = ["", "Graph Node", "graph", "a a a a"]
    refs[:4] = ["graph node", "", "graph", "a a"]
    for h, r in zip(hyps, refs):
        assert rouge.rouge(h, r) == ref_rouge.rouge(h, r)
    assert rouge.rouge_corpus(hyps, refs) == ref_rouge.rouge_corpus(hyps, refs)
    assert rouge.rouge_corpus([], []) == ref_rouge.rouge_corpus([], []) == {}


def test_rouge_values():
    assert rouge.rouge("the graph model", "the graph model") == \
        {"rouge1": 1.0, "rouge2": 1.0, "rougeL": 1.0}
    assert rouge.rouge("", "x") == {"rouge1": 0.0, "rouge2": 0.0, "rougeL": 0.0}


@pytest.mark.parametrize("max_words,max_new", [(48, 0), (5, 0), (48, 3)])
def test_extractive_generator_equals_reference(max_words, max_new):
    """Prompts linearized from the same graph text by each side's tokenizer
    (queries with out-of-vocabulary words included): equal prompts, equal
    extracted strings."""
    g_ref = ref_gen.citation_graph(120, avg_deg=6, seed=3)
    g = generators.citation_graph(120, avg_deg=6, seed=3)
    ref_vocab, vocab = RefVocab.build(g_ref.node_text[:60]), Vocab.build(g.node_text[:60])
    ref_tok = RefTokenizer(ref_vocab, max_len=64, node_budget=6)
    tok = GraphTokenizer(vocab, max_len=64, node_budget=6)
    queries = [g.node_text[i] + " unseenword zzqx" for i in range(90, 96)]
    nodes = [[g.node_text[j] for j in range(i, i + 5)] for i in range(60, 66)]
    ids_a, mask_a = ref_tok.batch_linearize(queries, nodes)
    ids_b, mask_b = tok.batch_linearize(queries, nodes)
    np.testing.assert_array_equal(np.asarray(ids_a), np.asarray(ids_b))
    np.testing.assert_array_equal(np.asarray(mask_a), np.asarray(mask_b))
    a = RefExtractive(ref_vocab, max_words=max_words).generate(ids_a, mask_a, max_new)
    b = generation.ExtractiveGenerator(vocab, max_words=max_words).generate(ids_b, mask_b,
                                                                           max_new)
    assert a == b and len(b) == 6 and any(b)
    budget = max_words if max_new == 0 else max_new
    assert all(len(s.split()) <= budget for s in b)


def test_make_lm_generator_returns_the_ports_lm_generator():
    """``make_lm_generator`` wires the port's ``LMGenerator`` on first use
    (it imports nothing of the reference); ``register_lm_generator``
    replaces the factory."""
    import torch

    from repro_torch.models.transformer import generate
    from repro_torch.models.transformer import model as tm
    from repro_torch.models.transformer.config import TransformerConfig

    cfg = TransformerConfig(name="t", n_layers=1, d_model=16, n_heads=2, n_kv_heads=1, d_head=8,
                            d_ff=32, vocab=11, dtype="float32")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    vocab = Vocab.build(["graph node"])
    try:
        generation.register_lm_generator(None)
        gen = generation.make_lm_generator(params, cfg, vocab, temperature=0.5, seed=9)
        assert type(gen) is generate.LMGenerator and gen.temperature == 0.5
        assert gen.id_to_word == {6: "graph", 7: "node"}
        ids = np.array([[1, 6, 7, 4, 0]], np.int32)
        assert len(gen.generate(ids, ids > 0, 3)) == 1
        generation.register_lm_generator(lambda *a, **kw: ("made", a, kw))
        assert generation.make_lm_generator(1, x=2) == ("made", (1,), {"x": 2})
    finally:
        generation.register_lm_generator(None)


def test_rgl_paper_config_equals_reference():
    ours, ref = dataclasses.asdict(rgl_paper.CONFIG), dataclasses.asdict(ref_paper.CONFIG)
    assert ours == ref
    assert [f.name for f in dataclasses.fields(rgl_paper.RGLPaperConfig)] == \
        [f.name for f in dataclasses.fields(ref_paper.RGLPaperConfig)]
    assert rgl_paper.CONFIG.arxiv_nodes == 169_343
    with pytest.raises(dataclasses.FrozenInstanceError):
        rgl_paper.CONFIG.k_seeds = 1
