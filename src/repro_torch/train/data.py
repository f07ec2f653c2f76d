"""Deterministic, seekable synthetic token pipeline (numpy only).

Port of ``repro/train/data.py``: the same code, so the batches of a
(seed, step) are bit-equal to the JAX package's.

Batches are a pure function of (seed, step) — restart from a checkpoint at
step k reproduces byte-identical data without replaying the stream.  Per-
host sharded feeding slices the global batch by host id (multi-host
jax.make_array_from_process_local_data pattern); on one host it degrades to
the full batch.

The generator produces Zipf-ish token ids with short-range structure (so
the LM loss actually decreases) plus shifted labels; for enc-dec models it
also derives deterministic 'frame embeddings' (the stubbed modality
frontend).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

__all__ = ["SyntheticLM", "host_slice"]


@dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    encdec: bool = False
    d_model: int = 0
    enc_ratio: int = 8

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng(step)
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        # Markov-ish stream: next token = (prev * a + noise) % V with
        # regime switches -> learnable bigram structure.
        base = rng.integers(0, V, size=(B, 1))
        mult = rng.integers(3, 11, size=(B, 1))
        noise = rng.integers(0, max(2, V // 64), size=(B, S + 1))
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0:1] = base
        for t in range(1, S + 1):
            toks[:, t] = (toks[:, t - 1] * mult[:, 0] + noise[:, t]) % V
        out = {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
        if self.encdec:
            Se = max(1, S // self.enc_ratio)
            emb = rng.standard_normal((B, Se, self.d_model)).astype(np.float32)
            out["src_embeds"] = emb
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def host_slice(batch: Dict[str, np.ndarray], host_id: int,
               num_hosts: int) -> Dict[str, np.ndarray]:
    """Per-host shard of the global batch (batch dim 0)."""
    def sl(x):
        b = x.shape[0]
        assert b % num_hosts == 0, (b, num_hosts)
        k = b // num_hosts
        return x[host_id * k:(host_id + 1) * k]
    return {k: sl(v) for k, v in batch.items()}
