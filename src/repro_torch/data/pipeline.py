"""Data pipeline: byte-level tokenizer + synthetic LM corpora + batching,
the PyTorch counterpart of ``repro/data/pipeline.py``.

``ByteTokenizer`` and ``markov_corpus`` are copies (pure numpy), and
``TokenPipeline`` makes the same numpy draws as the reference's, so both
packages see the same batches from a seed; the batches come out as
torch tensors on an explicit device.

For the end-to-end training example we synthesize a corpus with real
(learnable) statistical structure — a char-level Markov source over a
fixed transition table — so the ~100M-model example shows an actual loss
curve rather than noise-floor flatlining on uniform random tokens.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device


class ByteTokenizer:
    """Trivial byte-level tokenizer (vocab 256 + specials)."""
    PAD, BOS, EOS = 256, 257, 258
    vocab_size = 259

    def encode(self, text: str, add_bos: bool = True) -> np.ndarray:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [self.BOS] + ids
        return np.asarray(ids, np.int32)

    def decode(self, ids) -> str:
        return bytes(int(i) for i in ids if int(i) < 256).decode(
            "utf-8", errors="replace")


def markov_corpus(num_tokens: int, vocab: int, order_state: int = 64,
                  seed: int = 0, temperature: float = 1.0) -> np.ndarray:
    """Synthetic corpus from a random sparse Markov chain over ``vocab``."""
    rng = np.random.default_rng(seed)
    states = order_state
    # sparse transition: each state strongly prefers ~8 tokens
    prefs = rng.integers(0, vocab, size=(states, 8))
    logits = rng.normal(0, 1, size=(states, 8)) / temperature
    probs = np.exp(logits)
    probs /= probs.sum(1, keepdims=True)
    out = np.empty(num_tokens, np.int32)
    s = 0
    choice_buf = rng.random(num_tokens)
    for i in range(num_tokens):
        c = np.searchsorted(np.cumsum(probs[s]), choice_buf[i])
        tok = prefs[s, min(c, 7)]
        out[i] = tok
        s = int(tok) % states
    return out


class TokenPipeline:
    """Chunked LM batches from a flat token stream, with shift labels,
    as int32 ``tokens``/``labels`` and float32 ``weights`` on ``device``
    (the card unless one is named)."""

    def __init__(self, tokens: np.ndarray, batch: int, seq: int,
                 num_codebooks: int = 0, seed: int = 0, device=None):
        self.tokens = tokens
        self.batch, self.seq = batch, seq
        self.num_codebooks = num_codebooks
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        n = len(self.tokens) - self.seq - 1
        while True:
            starts = self.rng.integers(0, n, size=self.batch)
            toks = np.stack([self.tokens[s:s + self.seq] for s in starts])
            labels = np.stack([self.tokens[s + 1:s + self.seq + 1]
                               for s in starts])
            if self.num_codebooks:
                k = self.num_codebooks
                toks = np.stack([np.roll(toks, i, -1) for i in range(k)], -1)
                labels = np.stack([np.roll(labels, i, -1)
                                   for i in range(k)], -1)
            yield {"tokens": torch.from_numpy(toks).to(self.device),
                   "labels": torch.from_numpy(labels).to(self.device),
                   "weights": torch.ones((self.batch, self.seq),
                                         dtype=torch.float32,
                                         device=self.device)}


def synthetic_lm_batches(vocab: int, batch: int, seq: int,
                         num_codebooks: int = 0, seed: int = 0,
                         corpus_tokens: int = 200_000, device=None):
    """Infinite iterator of learnable synthetic LM batches on ``device``
    (the card unless one is named)."""
    corpus = markov_corpus(corpus_tokens, vocab, seed=seed)
    return iter(TokenPipeline(corpus, batch, seq,
                              num_codebooks=num_codebooks, seed=seed,
                              device=device))
