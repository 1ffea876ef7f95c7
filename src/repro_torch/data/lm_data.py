"""Synthetic LM token stream (numpy only).

A copy of ``repro.data.lm_data.TokenStream``: a fixed random motif repeated
with a random phase, plus token noise. The same seed gives the same tokens
as the JAX package's stream, call for call.
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab: int, seed: int = 0, noise: float = 0.02, period: int = 8):
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        self.noise = noise
        # position i carries motif[(i + phase) % period]
        self.motif = self.rng.integers(0, vocab, period)
        self.period = period

    def batch(self, batch_size: int, seq_len: int) -> np.ndarray:
        phase = self.rng.integers(0, self.period, batch_size)[:, None]
        idx = (np.arange(seq_len)[None, :] + phase) % self.period
        out = self.motif[idx].astype(np.int32)
        flip = self.rng.random(out.shape) < self.noise
        out = np.where(flip, self.rng.integers(0, self.vocab, out.shape), out)
        return out.astype(np.int32)

    def batches(self, n: int, batch_size: int, seq_len: int):
        for _ in range(n):
            yield {"tokens": self.batch(batch_size, seq_len)}
