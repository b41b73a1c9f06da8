"""LM generation: prefill + KV-cache greedy or temperature decoding (the
reference's ``repro.models.transformer.generate``).

Implements the RGL generation interface
(:class:`repro_torch.core.generation.Generator`) on any
:class:`TransformerConfig`: the offline stand-in for the paper's hosted
LLM backends.  Greedy decoding is the reference's function token for token;
temperature sampling draws its Gumbel noise from a ``torch.Generator``
(jax.random's bits cannot be reproduced), so only greedy is held to the
reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.tokenization import N_SPECIAL
from repro_torch.models.transformer import model as tm
from repro_torch.models.transformer.config import TransformerConfig


def _sample(logits: torch.Tensor, temperature: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Greedy at temperature 0, else the argmax of ``logits / T`` plus
    Gumbel noise ``-log(-log(u + 1e-9) + 1e-9)``, ``u`` uniform from
    ``generator`` (on the logits' device)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    g = -torch.log(-torch.log(u + 1e-9) + 1e-9)
    return torch.argmax(logits / temperature + g, dim=-1).to(torch.int32)


@torch.no_grad()
def generate_tokens(params, prompt: torch.Tensor, true_len: torch.Tensor, cfg: TransformerConfig,
                    max_new: int, cache_len: int, temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """prompt (B, S) left-aligned, true_len (B,) -> generated (B, max_new)
    int32.  The first token comes from prefill's logits; then ``max_new``
    decode steps run, each fed the token before it, and the output is the
    tokens they were fed (the last step's sample is dropped), as the
    reference's scan carries them.  ``generator`` must be given above
    temperature 0."""
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs an explicit torch.Generator")
    logits, cache = tm.prefill(params, prompt, true_len, cfg, cache_len)
    tok = _sample(logits, temperature, generator)
    out = []
    for _ in range(max_new):
        out.append(tok)
        logits, cache = tm.decode_step(params, cache, tok, cfg)
        tok = _sample(logits, temperature, generator)
    return torch.stack(out, dim=1)


class LMGenerator:
    """:class:`~repro_torch.core.generation.Generator` backend over the
    port's LM stack, on the device the weights live on.  Ids map back to
    words with the tokenizer's offset (``N_SPECIAL``); special and unknown
    ids are dropped.  One ``torch.Generator`` seeded from ``seed`` is
    advanced across calls."""

    def __init__(self, params, cfg: TransformerConfig, vocab, *, cache_len: int = 1024,
                 temperature: float = 0.0, seed: int = 0):
        self.params = params
        self.cfg = cfg
        self.vocab = vocab
        self.cache_len = cache_len
        self.temperature = temperature
        self.device = params["embed"].device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.id_to_word = {v + N_SPECIAL: k for k, v in vocab.word_to_id.items()}

    def generate(self, prompt_ids, prompt_mask, max_new_tokens: int = 32) -> list:
        prompt = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.int32).to(self.device)
        true_len = torch.as_tensor(np.asarray(prompt_mask).sum(axis=1),
                                   dtype=torch.int32).to(self.device)
        toks = generate_tokens(self.params, prompt, true_len, self.cfg,
                               max_new=max(max_new_tokens, 1), cache_len=self.cache_len,
                               temperature=self.temperature, generator=self.generator)
        out = []
        for row in toks.cpu().numpy():
            words = [self.id_to_word.get(int(t), "") for t in row]
            out.append(" ".join(w for w in words if w))
        return out
