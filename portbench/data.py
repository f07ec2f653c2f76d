"""The benchmark's inputs, made from ``--seed``: training batches and
serving requests.

:class:`TokenStream` is a copy of the port's ``train/data.SyntheticLM``
(a Markov-ish token stream with learnable bigram structure, a pure
function of (seed, step)), kept here so that the program cannot change
its own inputs.  Serving prompts are drawn by :func:`submission`: every
submission holds the same set of prompt lengths, log-uniform over the
mix's range by strata, in an order the seed chooses, so that every seed
sends the same work.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np


class TokenStream:
    """Batches (tokens, labels) of ``batch`` rows of ``seq`` tokens."""

    def __init__(self, vocab: int, seq: int, batch: int, seed: int):
        self.V, self.S, self.B, self.seed = vocab, seq, batch, seed

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed,
                                                            step]))
        B, S, V = self.B, self.S, self.V
        base = rng.integers(0, V, size=(B, 1))
        mult = rng.integers(3, 11, size=(B, 1))
        noise = rng.integers(0, max(2, V // 64), size=(B, S + 1))
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0:1] = base
        for t in range(1, S + 1):
            toks[:, t] = (toks[:, t - 1] * mult[:, 0] + noise[:, t]) % V
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def prompt_lengths(n: int, lo: int, hi: int) -> List[int]:
    """``n`` lengths, one at the middle of each of ``n`` equal strata of
    log(length) over [lo, hi]."""
    a, b = math.log(lo), math.log(hi)
    return [int(round(math.exp(a + (i + 0.5) / n * (b - a))))
            for i in range(n)]


def submission(seed: int, stream: int, index: int, n: int, lo: int,
               hi: int, vocab: int) -> List[np.ndarray]:
    """The prompts of one submission: :func:`prompt_lengths` in a seeded
    order, tokens uniform over [1, vocab)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, stream,
                                                        index]))
    lengths = prompt_lengths(n, lo, hi)
    order = rng.permutation(n)
    return [rng.integers(1, vocab, size=lengths[i]).astype(np.int32)
            for i in order]
