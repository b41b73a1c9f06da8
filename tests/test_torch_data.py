"""The port's data pipeline (``repro_torch.data``) against the reference's
``repro.data``: the synthetic corpus, ``TokenDataset`` and its sharded
batches, ``host_shard_iter`` and the RAG token stream, batch for batch.
Out-of-vocabulary words and str hosts hash with Python's salted ``hash()``,
so every comparison runs in one process."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BruteIndex as RefBruteIndex
from repro.core import GraphTokenizer as RefTokenizer
from repro.core import PipelineConfig as RefPipelineConfig
from repro.core import RGLPipeline as RefPipeline
from repro.core import Vocab as RefVocab
from repro.data import pipeline as ref_data
from repro.graph import csr_to_ell as ref_csr_to_ell
from repro_torch.core.indexing import BruteIndex
from repro_torch.core.pipeline import PipelineConfig, RGLPipeline
from repro_torch.core.tokenization import GraphTokenizer, Vocab
from repro_torch.data import (
    TokenDataset, host_shard_iter, rag_token_stream, synthetic_corpus,
)
from repro_torch.graph import generators
from repro_torch.graph.ell import csr_to_ell


@pytest.mark.parametrize("n,seed,length", [(50, 0, 32), (7, 3, 5)])
def test_synthetic_corpus_equals_reference(n, seed, length):
    assert synthetic_corpus(n, seed, length) == ref_data.synthetic_corpus(n, seed, length)


def _datasets(max_len=24):
    texts = synthetic_corpus(40, seed=1, length=30) + ["unseen words zzz qqq graph"]
    vocab_texts = synthetic_corpus(40, seed=1, length=10)
    vocab, ref_vocab = Vocab.build(vocab_texts, max_words=20), RefVocab.build(vocab_texts, max_words=20)
    return (TokenDataset.from_texts(texts, vocab, max_len),
            ref_data.TokenDataset.from_texts(texts, ref_vocab, max_len))


def test_token_dataset_from_texts_equals_reference():
    mine, ref = _datasets()
    np.testing.assert_array_equal(mine.ids, ref.ids)
    np.testing.assert_array_equal(mine.mask, ref.mask)
    assert mine.ids.dtype == np.int32 and mine.mask.dtype == bool
    assert (mine.ids >= 6 + 20).any()  # some words took hashed OOV buckets


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_token_dataset_batches_equal_reference(seed, shard):
    mine, ref = _datasets()
    ours, theirs = mine.batches(4, seed=seed, shard=shard), ref.batches(4, seed=seed, shard=shard)
    for _ in range(12):  # past the end of an epoch (a shard holds 20 or 21 rows)
        a, b = next(ours), next(theirs)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["loss_mask"], b["loss_mask"])


@pytest.mark.parametrize("hosts", [[0, 1, 2, 3], ["a", "b", "c"]])
def test_host_shard_iter_equals_reference(hosts):
    files = [f"shard-{i:03d}.tfrecord" for i in range(37)]
    owned = [host_shard_iter(files, h, hosts) for h in hosts]
    assert owned == [ref_data.host_shard_iter(files, h, hosts) for h in hosts]
    assert sorted(f for o in owned for f in o) == files


def _pipelines(n=200, seed=8, tok_len=128):
    """The port's pipeline (CPU) and the reference's over one graph, as
    ``tests/test_system.py::test_rag_token_stream`` builds it."""
    g = generators.citation_graph(n, seed=seed)
    ell = csr_to_ell(g, device="cpu")
    vocab = Vocab.build(g.node_text)
    pipe = RGLPipeline(
        graph=ell, index=BruteIndex.build(g.node_feat, device="cpu"), node_emb=ell.node_feat,
        tokenizer=GraphTokenizer(vocab, max_len=tok_len, node_budget=8), node_text=g.node_text,
        config=PipelineConfig(k_seeds=2, max_nodes=16, filter_budget=8), device="cpu")
    emb = jnp.asarray(g.node_feat)
    ref = RefPipeline(
        graph=ref_csr_to_ell(g), index=RefBruteIndex.build(emb), node_emb=emb,
        tokenizer=RefTokenizer(RefVocab.build(g.node_text), max_len=tok_len, node_budget=8),
        node_text=g.node_text, config=RefPipelineConfig(k_seeds=2, max_nodes=16, filter_budget=8))
    return g, pipe, ref


@pytest.mark.parametrize("tok_len,max_len,batch,seed", [(128, 128, 4, 0), (40, 48, 3, 2)])
def test_rag_token_stream_equals_reference(tok_len, max_len, batch, seed):
    """The first three batches: tokens and loss masks equal the reference's
    (the second case truncates targets to the room left after the prompt)."""
    g, pipe, ref = _pipelines(tok_len=tok_len)
    titles = [" ".join(t.split()[:4]) for t in g.node_text]
    ours = rag_token_stream(pipe, titles, g.node_feat, g.node_text, batch=batch,
                            max_len=max_len, seed=seed)
    theirs = ref_data.rag_token_stream(ref, titles, np.asarray(g.node_feat), g.node_text,
                                       batch=batch, max_len=max_len, seed=seed)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert a["tokens"].dtype == torch.int32 and a["loss_mask"].dtype == torch.bool
        assert a["tokens"].shape == (batch, max_len)
        np.testing.assert_array_equal(a["tokens"].numpy(), b["tokens"])
        np.testing.assert_array_equal(a["loss_mask"].numpy(), b["loss_mask"])
        assert a["loss_mask"].any()
    if max_len == 48:  # some row's target was cut at the end of the sequence
        assert bool(a["loss_mask"][:, -2].any()) or bool(b["loss_mask"][:, -2].any())


def test_rag_token_stream_takes_tensor_queries_and_a_device():
    """Query embeddings as a tensor on the pipeline's device give the same
    batches as the host array; ``device`` places the batch."""
    g, pipe, _ = _pipelines()
    host = rag_token_stream(pipe, g.node_text, g.node_feat, g.node_text, batch=4, max_len=128)
    dev = rag_token_stream(pipe, g.node_text, torch.from_numpy(g.node_feat), g.node_text,
                           batch=4, max_len=128, device=torch.device("cpu"))
    for _ in range(2):
        a, b = next(host), next(dev)
        assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["loss_mask"], b["loss_mask"])
        assert b["tokens"].device == torch.device("cpu")


# ------------------------------------------------------ the example twin ---
def _example(name):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_rag_lm_twin_configs_equal_reference():
    import dataclasses

    twin, ref = _example("torch_train_rag_lm"), _example("train_rag_lm")
    for scale in ("2m", "100m"):
        assert dataclasses.asdict(twin.model_config(scale, 1066)) == dataclasses.asdict(
            ref.model_config(scale, 1066))


def test_train_rag_lm_twin_resumes_on_the_cpu(tmp_path, capsys):
    """``--resume`` restores the newest checkpoint (here one written at step
    1 from the twin's own state) and trains on to ``--steps``."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.models.transformer import model as tm

    twin = _example("torch_train_rag_lm")
    g = generators.citation_graph(300, avg_deg=8, seed=0)
    cfg = twin.model_config("2m", Vocab.build(g.node_text).size)
    init_state, _ = twin.trainer(cfg, 3)
    state = init_state(tm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))
    save_checkpoint(str(tmp_path), 1, state)
    out = twin.main(["--device", "cpu", "--steps", "3", "--nodes", "300", "--batch", "4",
                     "--seq", "96", "--ckpt_dir", str(tmp_path), "--resume"])
    assert "resumed from step 1" in capsys.readouterr().out
    # the saved state had taken no update: steps 2 and 3 are its first two
    assert out["start"] == 1 and int(out["state"]["opt"]["step"]) == 2
