"""Deterministic synthetic token pipeline for LM training: the port of
``repro.data.tokens``, a numpy copy, so that both packages draw the same
batches bit for bit from one seed.

A Zipfian unigram stream with short-range Markov structure gives the
model something learnable (loss drops measurably within a few hundred
steps) while staying fully offline and reproducible. Batches are
prepared host-side in numpy; the caller moves them to its device.
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    """Infinite deterministic (seeded) token batch source."""

    def __init__(self, vocab_size: int, seq_len: int, batch_size: int, *,
                 seed: int = 0, zipf_a: float = 1.2, markov: float = 0.7,
                 period: int = 16):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = batch_size
        self.rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = ranks ** (-zipf_a)
        self.p = p / p.sum()
        self.markov = markov
        self.period = period

    def next_batch(self) -> dict:
        B, S = self.batch, self.seq
        base = self.rng.choice(self.vocab, size=(B, S), p=self.p)
        # learnable structure: with prob `markov`, token repeats the one
        # `period` positions earlier.
        rep = self.rng.random((B, S)) < self.markov
        for t in range(self.period, S):
            base[:, t] = np.where(rep[:, t], base[:, t - self.period],
                                  base[:, t])
        tokens = base.astype(np.int32)
        labels = np.concatenate(
            [tokens[:, 1:], np.full((B, 1), -100, np.int32)], axis=1)
        return {"tokens": tokens, "labels": labels}

    def batches(self, n: int):
        for _ in range(n):
            yield self.next_batch()
