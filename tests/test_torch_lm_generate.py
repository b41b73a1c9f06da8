"""The port's LM generation and LM entry points against the reference on the
CPU, with the same weights (``params_from_jax``, fp32): ``generate_tokens``
(dense and MoE), ``LMGenerator`` through ``make_lm_generator`` (greedy
strings equal), offline greedy against the slot engine and speculative
decode, seeded sampling, the LM configs, the token-mode launcher for every
LM architecture's reduced config, the training launcher on a MoE config,
and the two example twins (``examples/torch_quickstart.py``,
``examples/torch_serve_rag.py``) against the reference examples.

Tokens, strings, seeds, subgraph sizes and engine counters are exact.
Prompts are compared within one process: out-of-vocabulary ids come from
Python's salted ``hash()``.
"""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core import GraphTokenizer as RefTokenizer
from repro.core import Vocab as RefVocab
from repro.core.generation import make_lm_generator as ref_make_lm_generator
from repro.graph import generators as ref_gen
from repro.models.transformer import MoEConfig as RefMoEConfig
from repro.models.transformer import TransformerConfig as RefConfig
from repro.models.transformer import model as ref_tm
from repro.models.transformer.generate import generate_tokens as ref_generate_tokens
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefServeEngine
from repro_torch import configs
from repro_torch.core import generation
from repro_torch.core.tokenization import GraphTokenizer, Vocab
from repro_torch.graph import generators
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models.transformer import generate
from repro_torch.models.transformer import model as tm
from repro_torch.models.transformer.config import MoEConfig, TransformerConfig
from repro_torch.serving.engine import Request, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
BASE = dict(name="gen-t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_head=8, d_ff=64,
            vocab=64, dtype="float32")


def _models(moe: bool, **kw):
    c = dict(BASE, **kw)
    if moe:
        c["d_ff"] = 0
        ref_cfg = RefConfig(**c, moe=RefMoEConfig(8, 2, 32))
        cfg = TransformerConfig(**c, moe=MoEConfig(8, 2, 32))
    else:
        ref_cfg, cfg = RefConfig(**c), TransformerConfig(**c)
    ref_params = ref_tm.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = tm.params_from_jax(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    return ref_cfg, ref_params, cfg, params


def _prompts(vocab, seed=0, lens=(9, 5, 14)):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), max(lens)), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, vocab, n)
    return toks, np.array(lens, np.int32)


# --------------------------------------------------------- generate_tokens ---
@pytest.mark.parametrize("moe", [False, True])
def test_generate_tokens_greedy_equals_reference(moe):
    ref_cfg, ref_params, cfg, params = _models(moe)
    toks, tl = _prompts(64)
    a = ref_generate_tokens(ref_params, jnp.asarray(toks), jnp.asarray(tl), jax.random.PRNGKey(0),
                            ref_cfg, max_new=10, cache_len=32)
    b = generate.generate_tokens(params, torch.from_numpy(toks), torch.from_numpy(tl), cfg,
                                 max_new=10, cache_len=32)
    assert b.dtype == torch.int32 and tuple(b.shape) == (3, 10)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_offline_greedy_equals_spec_decode_and_the_slot_engine():
    """The twin of the reference's ``test_parity_matches_offline_greedy``:
    the slot engine's one-token and speculative serves emit offline greedy
    generation's tokens (MoE model)."""
    _, _, cfg, params = _models(True)
    prompt = np.asarray([5, 9, 3, 22, 41], np.int32)
    offline = generate.generate_tokens(params, torch.from_numpy(prompt)[None],
                                       torch.tensor([len(prompt)], dtype=torch.int32), cfg,
                                       max_new=8, cache_len=32)
    for spec in (False, True):
        eng = ServeEngine(params, cfg, slots=2, cache_len=32, spec_decode=spec, draft_window=4,
                          device="cpu")
        eng.submit(Request(uid=0, prompt_ids=prompt, max_new_tokens=8))
        done = eng.run_to_completion()
        assert done[0].out_tokens[:8] == offline[0].tolist(), spec


def test_sampling_is_seeded_and_advances():
    _, _, cfg, params = _models(True)
    toks, tl = (torch.from_numpy(x) for x in _prompts(64))
    with pytest.raises(ValueError, match="Generator"):
        generate.generate_tokens(params, toks, tl, cfg, max_new=4, cache_len=32, temperature=0.7)
    draws = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(3)
        first = generate.generate_tokens(params, toks, tl, cfg, max_new=12, cache_len=32,
                                         temperature=5.0, generator=gen)
        second = generate.generate_tokens(params, toks, tl, cfg, max_new=12, cache_len=32,
                                          temperature=5.0, generator=gen)
        draws.append((first, second))
    assert torch.equal(draws[0][0], draws[1][0]) and torch.equal(draws[0][1], draws[1][1])
    assert not torch.equal(draws[0][0], draws[0][1])  # the generator moved on
    greedy = generate.generate_tokens(params, toks, tl, cfg, max_new=12, cache_len=32)
    assert not torch.equal(draws[0][0], greedy)


# -------------------------------------------------------------- LMGenerator ---
@pytest.mark.parametrize("moe", [False, True])
def test_lm_generator_strings_equal_reference(moe):
    """Prompts linearized by each side's tokenizer from one graph's text,
    with a small hash range so most generated ids are words; the strings of
    ``make_lm_generator``'s generator equal the reference's (unknown ids
    dropped), at 12 new tokens and at ``max_new_tokens=0`` (one token)."""
    g_ref = ref_gen.citation_graph(120, avg_deg=6, seed=3)
    g = generators.citation_graph(120, avg_deg=6, seed=3)
    ref_vocab, vocab = RefVocab.build(g_ref.node_text, n_hash=4), Vocab.build(g.node_text, n_hash=4)
    ref_cfg, ref_params, cfg, params = _models(moe, vocab=vocab.size)
    queries = [g.node_text[i] + " zzqx" for i in range(90, 94)]
    nodes = [[g.node_text[j] for j in range(i, i + 4)] for i in range(40, 44)]
    ids_a, mask_a = RefTokenizer(ref_vocab, max_len=48, node_budget=6).batch_linearize(queries, nodes)
    ids_b, mask_b = GraphTokenizer(vocab, max_len=48, node_budget=6).batch_linearize(queries, nodes)
    np.testing.assert_array_equal(np.asarray(ids_a), np.asarray(ids_b))
    ref_gen_ = ref_make_lm_generator(ref_params, ref_cfg, ref_vocab, cache_len=64)
    gen = generation.make_lm_generator(params, cfg, vocab, cache_len=64)
    assert isinstance(gen, generate.LMGenerator) and gen.device.type == "cpu"
    for n in (12, 0):
        a = ref_gen_.generate(ids_a, mask_a, n)
        b = gen.generate(ids_b, mask_b, n)
        assert a == b and len(b) == 4, n
    assert any(b)


# ----------------------------------------------------------------- configs ---
LM_ARCHS = ["starcoder2-3b", "deepseek-7b", "deepseek-coder-33b", "grok-1-314b",
            "granite-moe-1b-a400m"]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_configs_equal_reference(arch):
    ours, ref = configs.get_config(arch), ref_configs.get_config(arch)
    assert (ours.arch_id, ours.family, ours.source) == (ref.arch_id, ref.family, ref.source)
    assert dataclasses.asdict(ours.model_cfg) == dataclasses.asdict(ref.model_cfg)
    assert dataclasses.asdict(ours.reduced_cfg) == dataclasses.asdict(ref.reduced_cfg)


def test_registry_holds_the_reference_lm_archs_in_its_order():
    ref_lm = [a for a in ref_configs.REGISTRY if ref_configs.REGISTRY[a].family == "lm"]
    ours_lm = [a for a in configs.REGISTRY if configs.REGISTRY[a].family == "lm"]
    assert ours_lm == ref_lm == LM_ARCHS
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS  # the gnn and recsys archs too


# -------------------------------------------------------------- launchers ---
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_token_mode_launcher_equals_reference_engine(arch):
    """``launch.serve``'s token mode on the arch's reduced config with the
    reference's weights: the prompts the launcher draws, and its tokens,
    equal a reference ``ServeEngine``'s on those prompts."""
    ref_cfg = ref_configs.get_config(arch).reduced_cfg
    cfg = configs.get_config(arch).reduced_cfg
    ref_params = ref_tm.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = tm.params_from_jax(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    args = serve_launch.argparse.Namespace(requests=5, slots=2, max_new=6, device="cpu")
    out = serve_launch._serve_tokens(cfg, args, params=params)
    cache_len = cfg.sliding_window or 128
    assert out["cache_len"] == cache_len
    ref = RefServeEngine(ref_params, ref_cfg, slots=2, cache_len=cache_len)
    rng = np.random.default_rng(0)
    for u in range(5):
        ref.submit(RefRequest(uid=u, prompt_ids=rng.integers(
            1, ref_cfg.vocab, size=int(rng.integers(4, 16))).astype(np.int32), max_new_tokens=6))
    want = {r.uid: (r.prompt_ids.tolist(), r.out_tokens, r.truncated)
            for r in ref.run_to_completion()}
    got = {r.uid: (r.prompt_ids.tolist(), r.out_tokens, r.truncated) for r in out["done"]}
    assert got == want
    assert out["tokens"] == sum(len(v[1]) for v in want.values()) > 0


def test_token_mode_cli_serves_with_flags(capsys):
    out = serve_launch.main(["--arch", "granite-moe-1b-a400m", "--device", "cpu", "--requests",
                             "4", "--max_new", "6", "--spec-decode", "--paged-kv",
                             "--kv-block", "8"])
    text = capsys.readouterr().out
    assert "[granite-moe-1b-a400m] served 4 requests / 24 tokens" in text
    assert "spec decode: window=4" in text and "paged KV: block=8 tokens" in text
    assert out["stats"]["spec_decode"] and out["stats"]["paged_kv"]
    with pytest.raises(SystemExit):  # only the LM archs are choices
        serve_launch.main(["--arch", "gin-tu", "--device", "cpu"])


def test_train_launcher_trains_a_moe_config(capsys):
    history = train_launch.main(["--arch", "granite-moe-1b-a400m", "--device", "cpu",
                                 "--steps", "10", "--batch", "2", "--seq", "32"])
    assert [h[0] for h in history] == [5, 10]
    assert all(np.isfinite(h[1]) and 3.0 < h[1] < 6.0 for h in history)  # ~log(128) = 4.85
    assert "done: loss" in capsys.readouterr().out


# ---------------------------------------------------------------- examples ---
def _load(name):
    spec = importlib.util.spec_from_file_location(f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_twin_prints_the_reference_quickstart(capsys):
    """Seeds, subgraph sizes and extractive outputs line for line."""
    _load("quickstart").main()
    want = capsys.readouterr().out
    twin = _load("torch_quickstart")
    twin.main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want and got.count("query node") == 3


def test_quickstart_twin_lm_generator_equals_reference():
    """``--generator lm``: the same pipeline ending in the LM generator, with
    the reference's weights, gives the reference pipeline's seeds, subgraph
    and strings when the reference ends in its own ``make_lm_generator``."""
    from repro.core import BruteIndex as RefBruteIndex
    from repro.core import PipelineConfig as RefPipelineConfig
    from repro.core import RGLPipeline as RefPipeline
    from repro.graph import csr_to_ell as ref_csr_to_ell

    twin = _load("torch_quickstart")
    g = ref_gen.citation_graph(2000, avg_deg=8, seed=0)
    vocab = RefVocab.build(g.node_text)
    ref_cfg = RefConfig(**dataclasses.asdict(twin.lm_config(vocab.size)))
    ref_params = ref_tm.init_params(jax.random.PRNGKey(0), ref_cfg)
    emb = jnp.asarray(g.node_feat)
    pipe = RefPipeline(
        graph=ref_csr_to_ell(g), index=RefBruteIndex.build(emb), node_emb=emb,
        tokenizer=RefTokenizer(vocab, max_len=384, node_budget=24),
        generator=ref_make_lm_generator(ref_params, ref_cfg, vocab,
                                        cache_len=384 + twin.LM_NEW_TOKENS + 1),
        node_text=g.node_text,
        config=RefPipelineConfig(strategy="steiner", k_seeds=4, max_hops=3, max_nodes=48,
                                 filter_budget=16))
    qe = emb[jnp.asarray(twin.Q_IDS)] + 0.05
    want = pipe.run(qe, [" ".join(g.node_text[i].split()[:5]) for i in twin.Q_IDS],
                    max_new_tokens=twin.LM_NEW_TOKENS)
    params = tm.params_from_jax(jax.tree.map(np.asarray, ref_params), twin.lm_config(vocab.size),
                                device="cpu")
    got = twin.run("cpu", "lm", params=params)
    np.testing.assert_array_equal(want["seeds"], got["seeds"])
    np.testing.assert_array_equal(np.asarray(want["subgraph"].mask), got["subgraph"].mask.numpy())
    np.testing.assert_array_equal(np.asarray(want["prompt_ids"]), np.asarray(got["prompt_ids"]))
    assert want["outputs"] == got["outputs"]


def test_serve_rag_twin_equals_reference_example(capsys, monkeypatch):
    """The same requests, duplicates and weights: requests, tokens,
    retrieval batches, cache hits and the sample line equal the reference
    example's printout (the timing line aside)."""
    monkeypatch.setattr(sys, "argv", ["serve_rag.py", "--requests", "6", "--max_new", "6",
                                      "--repeat", "3"])
    _load("serve_rag").main()
    want = capsys.readouterr().out.splitlines()
    twin = _load("torch_serve_rag")
    args = twin.argparse.Namespace(requests=6, slots=4, max_new=6, repeat=3, device="cpu")
    vocab = Vocab.build(generators.citation_graph(1000, avg_deg=8, seed=0).node_text)
    ref_cfg = RefConfig(**dataclasses.asdict(twin.lm_config(vocab.size)))
    ref_params = ref_tm.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = tm.params_from_jax(jax.tree.map(np.asarray, ref_params), twin.lm_config(vocab.size),
                                device="cpu")
    out = twin.run(args, params=params)
    twin.report(args, out)
    got = capsys.readouterr().out.splitlines()
    assert got[0].split(" in ")[0] == want[0].split(" in ")[0] == "served 9 requests / 54 tokens"
    assert got[1].split(" in ")[0] == want[1].split(" in ")[0]
    assert got[1].split(";")[1] == want[1].split(";")[1]
    assert got[2] == want[2]
