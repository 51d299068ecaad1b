"""Synthetic LM token stream (numpy copy of ``repro.data.lm_data``): Zipf
unigrams + deterministic bigram templates, so a training run has a
learnable next-token structure without any corpus.  Batches are
bit-identical to the reference's for the same seed and index.
"""
from __future__ import annotations

import numpy as np


class LMGenerator:
    def __init__(self, vocab_size: int, seed: int = 0, n_patterns: int = 512):
        self.vocab = vocab_size
        rng = np.random.default_rng(seed)
        # deterministic successor for a subset of tokens (learnable bigrams)
        self.successor = rng.integers(0, vocab_size, vocab_size)
        self.is_patterned = rng.random(vocab_size) < 0.7
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks
        self.unigram = p / p.sum()
        self.perm = rng.permutation(vocab_size)

    def batch(self, batch_size: int, seq_len: int, batch_idx: int) -> dict:
        rng = np.random.default_rng((batch_idx, 0x1A))
        toks = np.empty((batch_size, seq_len + 1), np.int32)
        toks[:, 0] = self.perm[
            rng.choice(self.vocab, batch_size, p=self.unigram)]
        for t in range(seq_len):
            prev = toks[:, t]
            follow = self.is_patterned[prev] & (rng.random(batch_size) < 0.8)
            rand = self.perm[rng.choice(self.vocab, batch_size, p=self.unigram)]
            toks[:, t + 1] = np.where(follow, self.successor[prev], rand)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
