"""Batched serving engine: prefill + greedy decode with fixed-shape steps
and slot-based continuous batching (finished sequences are replaced from
the request queue; the decode step's shapes never change).

When a slot frees mid-decode, the request that takes it over is
**re-prefilled**: all slots refilled in the same step share one batched
prefill call, and their rows of the KV cache, per-slot position vector and
last-token vector are spliced in while the other slots keep decoding
undisturbed.  (``cache['pos']`` is a (B,) vector and attention masks/RoPE
are per-row, so a freshly prefilled slot decodes exactly as it would in a
batch of its own.)

The engine runs on the device its parameters live on.  Mapping-plan warmup
(the JAX engine's ``warm_plans``) is not ported yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.model import Model
from ..models.param import tree_leaves

__all__ = ["Request", "ServeEngine"]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    # wall-clock decode budget from slot admission; a request that blows
    # it is force-finished (``timed_out``) so it cannot pin a slot until
    # the engine-global ``max_steps``
    deadline_s: Optional[float] = None
    # filled by the engine:
    output: List[int] = field(default_factory=list)
    done: bool = False
    timed_out: bool = False


class ServeEngine:
    """Fixed batch of decode slots; requests stream through them.

    Per-request guards: ``Request.max_new_tokens`` (optionally clamped
    by the engine's ``max_new_cap``) bounds tokens, and
    ``Request.deadline_s`` (default ``default_deadline_s``) bounds wall
    time per slot occupancy — one runaway request degrades to a
    truncated answer instead of holding a decode slot hostage."""

    def __init__(self, model: Model, params, *, batch_size: int,
                 cache_len: int, prompt_len: int,
                 max_new_cap: Optional[int] = None,
                 default_deadline_s: Optional[float] = None):
        self.model = model
        self.params = params
        self.device = tree_leaves(params)[0].device
        self.B = batch_size
        self.cache_len = cache_len
        self.prompt_len = prompt_len
        self.max_new_cap = max_new_cap
        self.default_deadline_s = default_deadline_s
        self.stats: Dict[str, float] = {"prefill_calls": 0, "decode_steps": 0,
                                        "tokens_out": 0, "timeouts": 0}

    # ------------------------------------------------------------- serving
    def _pad_prompts(self, rows: Sequence[Optional[Request]]) -> np.ndarray:
        """(B, prompt_len) token rows, right-aligned; ``None`` rows (empty
        or not-being-refilled slots) stay zero."""
        toks = np.zeros((self.B, self.prompt_len), np.int32)
        for i, r in enumerate(rows):
            if r is None:
                continue
            t = r.prompt[-self.prompt_len:]
            toks[i, -len(t):] = t          # right-aligned
        return toks

    def _prefill_batch(self, rows: Sequence[Optional[Request]]):
        """One batched prefill over ``rows`` (None rows carry zeros).
        Returns (last-token vector, cache with per-slot positions)."""
        tokens = torch.from_numpy(self._pad_prompts(rows)).long().to(self.device)
        logits, cache = self.model.prefill(self.params, {"tokens": tokens},
                                           self.cache_len)
        self.stats["prefill_calls"] += 1
        last = logits[:, -1, :self.model.cfg.vocab_size].argmax(-1)
        return last, cache

    def _refill_prefill(self, active: Sequence[Optional[Request]],
                        idxs: List[int], cache, last):
        """Prefill the newly refilled slots (one batched call however many
        freed this step) and splice their rows — KV cache, position, last
        token — into the live decode state."""
        rows = [r if i in idxs else None for i, r in enumerate(active)]
        fresh_last, fresh = self._prefill_batch(rows)
        if cache is None:                  # initial fill: take it wholesale
            return fresh_last, fresh
        sel = torch.zeros(self.B, dtype=torch.bool, device=self.device)
        sel[idxs] = True
        # spliced in place: the live cache belongs to this engine alone
        cache["pos"][sel] = fresh["pos"][sel]
        for old, new in zip(tree_leaves(cache["layers"]),
                            tree_leaves(fresh["layers"])):
            old[:, sel] = new[:, sel]      # stacked leaves: batch axis 1
        return torch.where(sel, fresh_last, last), cache

    def _token_budget(self, r: Request) -> int:
        return (r.max_new_tokens if self.max_new_cap is None
                else min(r.max_new_tokens, self.max_new_cap))

    @torch.no_grad()
    def run(self, requests: List[Request], *, max_steps: int = 10_000
            ) -> List[Request]:
        """Process all requests with continuous slot reuse."""
        queue = list(requests)
        active: List[Optional[Request]] = [None] * self.B
        admitted: List[float] = [0.0] * self.B    # slot admission times

        def refill() -> List[int]:
            new = []
            for i in range(self.B):
                if active[i] is None and queue:
                    active[i] = queue.pop(0)
                    admitted[i] = time.monotonic()
                    new.append(i)
            return new

        last, cache = self._refill_prefill(active, refill(), None, None)

        for _step in range(max_steps):
            if all(r is None or r.done for r in active) and not queue:
                break
            # the decode step updates the cache's tensors in place (the JAX
            # engine donates the cache to its jitted step)
            logits, cache = self.model.decode(self.params, cache, last[:, None])
            self.stats["decode_steps"] += 1
            last = logits[:, -1, :self.model.cfg.vocab_size].argmax(-1)
            host = last.cpu().numpy()
            now = time.monotonic()
            for i, r in enumerate(active):
                if r is None or r.done:
                    continue
                r.output.append(int(host[i]))
                self.stats["tokens_out"] += 1
                deadline = (r.deadline_s if r.deadline_s is not None
                            else self.default_deadline_s)
                if deadline is not None and now - admitted[i] >= deadline:
                    # runaway guard: force-finish instead of pinning the
                    # slot until the engine-global max_steps
                    r.timed_out = True
                    self.stats["timeouts"] += 1
                elif not (len(r.output) >= self._token_budget(r)
                          or (r.eos_id is not None and host[i] == r.eos_id)):
                    continue
                r.done = True
                active[i] = None           # slot freed (continuous batching)
            new = refill()
            if new:
                last, cache = self._refill_prefill(active, new, cache, last)
        return [r for r in requests]
