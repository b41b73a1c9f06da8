"""Stage 5 of the RGL pipeline: the generation interface (paper §2.1.4).

The paper calls hosted LLMs; offline, the interface targets an in-repo
backend instead:

* :class:`ExtractiveGenerator`: an LM-free summarizer (budgeted extraction
  from the retrieved context, in retrieval-priority order).  Deterministic
  host code; the cheap default of the abstract-generation benchmark.
* :class:`~repro_torch.models.transformer.generate.LMGenerator`: any of
  the LM architectures, greedy or temperature sampling through prefill and
  KV decode.  It lives in ``models/transformer/generate.py`` to avoid a
  circular import; :func:`make_lm_generator` registers it on first use
  (:func:`register_lm_generator` replaces it).
"""
from __future__ import annotations

from typing import Protocol

import numpy as np

from repro_torch.core.tokenization import N_SPECIAL


class Generator(Protocol):
    def generate(self, prompt_ids: np.ndarray, prompt_mask: np.ndarray,
                 max_new_tokens: int) -> list:  # -> list[str]
        ...


class ExtractiveGenerator:
    """Budgeted extraction: emit context words in retrieval-priority order,
    each once.  ROUGE against a true abstract rewards overlapping content
    words, which the retrieved neighbourhood's text supplies."""

    def __init__(self, vocab, max_words: int = 48):
        self.vocab = vocab
        self.max_words = max_words
        self.id_to_word = {v + N_SPECIAL: k for k, v in vocab.word_to_id.items()}

    def generate(self, prompt_ids, prompt_mask, max_new_tokens: int = 0) -> list:
        out = []
        budget = self.max_words if max_new_tokens == 0 else max_new_tokens
        for ids, m in zip(np.asarray(prompt_ids), np.asarray(prompt_mask)):
            words = [self.id_to_word[int(t)] for t in ids[m] if int(t) in self.id_to_word]
            seen, uniq = set(), []
            for w in words:
                if w not in seen:
                    seen.add(w)
                    uniq.append(w)
            out.append(" ".join(uniq[:budget]))
        return out


_LM_GENERATOR_FACTORY = None


def register_lm_generator(factory) -> None:
    global _LM_GENERATOR_FACTORY
    _LM_GENERATOR_FACTORY = factory


def make_lm_generator(*args, **kw):
    if _LM_GENERATOR_FACTORY is None:
        from repro_torch.models.transformer import generate as _g  # lazy wiring

        register_lm_generator(_g.LMGenerator)
    return _LM_GENERATOR_FACTORY(*args, **kw)
