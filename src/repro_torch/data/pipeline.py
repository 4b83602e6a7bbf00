"""Synthetic token pipeline for LM training (a copy of ``repro/data/pipeline.py``;
numpy only, so both packages draw the same batches bit for bit).

Generates a deterministic mixture of Zipf-distributed tokens with planted
n-gram structure, so a model CAN reduce loss below the unigram entropy —
enough signal for the end-to-end training examples and throughput benches.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


class TokenStream:
    """Deterministic synthetic corpus with learnable bigram structure."""

    def __init__(self, vocab_size: int, seed: int = 0, zipf_a: float = 1.2):
        self.vocab = vocab_size
        self.rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        self.unigram = ranks**-zipf_a
        self.unigram /= self.unigram.sum()
        # planted bigram: each token has a preferred successor
        self.successor = self.rng.permutation(vocab_size)

    def sample(self, batch: int, seq_len: int) -> np.ndarray:
        base = self.rng.choice(self.vocab, size=(batch, seq_len), p=self.unigram)
        out = base.copy()
        # with prob 0.5, token t+1 = successor(token t): learnable structure
        follow = self.rng.random((batch, seq_len - 1)) < 0.5
        out[:, 1:] = np.where(follow, self.successor[out[:, :-1]], base[:, 1:])
        return out.astype(np.int32)


def make_lm_batches(
    vocab_size: int,
    batch: int,
    seq_len: int,
    *,
    seed: int = 0,
    prefix: Optional[tuple] = None,   # (prefix_len, d_model) for VLM stubs
    frames: Optional[tuple] = None,   # (enc_len, d_model) for audio stubs
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite iterator of {tokens, labels[, prefix, frames]} host batches."""
    stream = TokenStream(vocab_size, seed)
    rng = np.random.default_rng(seed + 1)
    while True:
        toks = stream.sample(batch, seq_len + 1)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
        if prefix is not None:
            p, d = prefix
            b["prefix"] = rng.normal(size=(batch, p, d)).astype(np.float32)
        if frames is not None:
            f, d = frames
            b["frames"] = rng.normal(size=(batch, f, d)).astype(np.float32)
        yield b
