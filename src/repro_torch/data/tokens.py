"""Deterministic synthetic token pipeline (reference: ``repro.data.tokens``;
numpy, so it gives the reference's tokens, ``==``, for each seed at the
reference's default shard 0).

Generates a Markov-ish token stream with learnable structure (a sparse
bigram transition table shared by every document, drawn from ``seed``) so
language-model training loss actually decreases — a flat-random stream
would make convergence tests meaningless. The reference's shard options
come with a data-parallel trainer (ROADMAP.md queue 1 item 16).
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = batch
        self.rng = np.random.default_rng(seed)
        # shared sparse bigram transition structure
        g = np.random.default_rng(seed)
        self.n_next = min(8, vocab)
        self.table = g.integers(0, vocab, size=(min(vocab, 4096), self.n_next))

    def _doc(self, length: int) -> np.ndarray:
        out = np.empty(length, np.int64)
        out[0] = self.rng.integers(0, self.vocab)
        for i in range(1, length):
            prev = out[i - 1] % self.table.shape[0]
            if self.rng.random() < 0.85:
                out[i] = self.table[prev, self.rng.integers(0, self.n_next)]
            else:
                out[i] = self.rng.integers(0, self.vocab)
        return out

    def __iter__(self):
        return self

    def __next__(self):
        toks = np.stack([self._doc(self.seq_len) for _ in range(self.batch)])
        return {"tokens": toks.astype(np.int32), "labels": toks.astype(np.int32)}
