"""Batched serving engine: prefill + greedy decode with fixed-shape steps
and slot-based continuous batching (finished sequences are replaced from
the request queue; the decode step's shapes never change).

When a slot frees mid-decode, the request that takes it over is
**re-prefilled**: all slots refilled in the same step share one batched
prefill call, and their rows of the KV cache, per-slot position vector and
last-token vector are spliced in while the other slots keep decoding
undisturbed.  (``cache['pos']`` is a (B,) vector and attention masks/RoPE
are per-row, so a freshly prefilled slot decodes exactly as it would in a
batch of its own.  Every stacked cache leaf of every stack, the attention
``k``/``v``/``kpos``, MLA's ``ckv``/``kr``, the ssm ``conv``/``state``,
DeepSeek's ``dense`` stack and the enc-dec ``self``/``cross`` caches
alike, has its batch on axis 1.)  An enc-dec model's prefill gets zero
frame embeddings (``src_embeds``), as the JAX engine feeds it.

``stats`` counts the engine's work: prefill calls, decode steps, tokens
out, timeouts, and the tokens the prefills compute against the refilled
requests' prompt tokens (the share of a prefill that is prompt, not
padding).  With ``repro_torch.tracing`` on, ``run`` records the spans
``serve/run``, ``serve/queue`` (one a request), ``serve/prefill``,
``serve/splice``, ``serve/decode`` and ``serve/sync``.

The engine runs on the device its parameters live on.  At startup it warms
the COMET mapping plans of its kernel shapes (``warm_plans``) through the
port's plan cache, so no prefill solves a plan.

On a ``(data, model)`` or ``(pod, data, model)`` mesh (``mesh=``;
``params`` this rank's shards, by ``param_shardings``) the engine is
SPMD: every rank runs the same ``run(requests)``.  The slots are split
over the data axes (``batch_spec``: ``(pod, data)`` in row-major order;
replicated over an axis B does not divide), each rank prefills and
decodes its rows through ``Model.prefill``/``decode(mesh=)``, and each
step's greedy tokens are All-Gathered over those axes in one collective
(``serve/tokens``), so that every rank holds the same B tokens and makes
the same refill decisions.  A decision taken from a clock (a request's
deadline) is agreed by a MAX All-Reduce of the flags over the whole mesh
(``serve/deadline``).  ``plan_shapes`` and the warmup are the global
shapes', as in the JAX engine; the returned requests are the same on
every rank.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import tracing
from ..models.layers import greedy_token
from ..models.model import Model
from ..models.param import tree_leaves
from torch.distributed.tensor import Shard

from ..parallel.collective_planner import collective, data_group, mesh_group
from ..parallel.sharding import batch_spec, shard_bounds

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
                 mesh=None,
                 plan_warmup: bool = True,
                 max_new_cap: Optional[int] = None,
                 default_deadline_s: Optional[float] = None):
        self.model = model
        self.params = params
        self.device = tree_leaves(params)[0].device
        self.B = batch_size
        self.cache_len = cache_len
        self.prompt_len = prompt_len
        self.mesh = mesh
        # this rank's slots [r0, r1) and their placement over the data axes
        self.rows = None if mesh is None else batch_spec(mesh, batch_size)
        self.r0, self.r1 = (0, batch_size) if mesh is None else \
            shard_bounds((batch_size,), self.rows, mesh)[0]
        self.max_new_cap = max_new_cap
        self.default_deadline_s = default_deadline_s
        # prefill_prompt_tokens: the refilled requests' prompt tokens (at
        # most prompt_len each, unpadded); prefill_tokens: the tokens the
        # prefills compute, every global slot at prompt_len
        self.stats: Dict[str, float] = {
            "prefill_calls": 0, "decode_steps": 0, "tokens_out": 0,
            "timeouts": 0, "prefill_prompt_tokens": 0, "prefill_tokens": 0}
        if plan_warmup:
            self.warm_plans()

    # ------------------------------------------------------------- plans
    def plan_shapes(self) -> Dict[str, List]:
        """The kernel shapes this engine's prefill/decode steps can ask
        the autotuner for (``PAPER_KERNEL_SHAPES``-style table): the
        prefill self-attention block (prompt_len x prompt_len), the
        decode block over the full cache (1 x cache_len: decode runs
        dense einsums, but a flash-decoding kernel would ask for exactly
        this shape, so the plan is pre-solved either way), and, for SSD
        families, the chunk sweep for the prompt length."""
        cfg = self.model.cfg
        shapes: Dict[str, List] = {}
        if not cfg.has_ssm or cfg.family == "hybrid":
            shapes["attention_blocks"] = [
                (self.prompt_len, self.prompt_len, cfg.hd),   # prefill
                (1, self.cache_len, cfg.hd),                  # decode
            ]
        if cfg.has_ssm:
            shapes["ssd_chunk_len"] = [
                (self.prompt_len, cfg.ssm_headdim, cfg.ssm_state)]
        return shapes

    def warm_plans(self) -> Dict[str, int]:
        """Pre-solve the plans of this engine's kernel shapes in one
        ``search_many`` sweep and persist them (the PlanCache's store), so
        neither this process nor any later one solves them in a
        prefill."""
        from ..core.plan import get_plan_cache
        from ..kernels.autotune import plan_jobs

        t0 = time.time()
        stats = get_plan_cache().warmup(plan_jobs(self.plan_shapes()),
                                        sweep_id="serve-warmup")
        self.stats["plan_warmup_hits"] = stats["hits"]
        self.stats["plan_warmup_solved"] = stats["solved"]
        self.stats["plan_warmup_s"] = time.time() - t0
        return stats

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

    def _greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """The (B,) greedy tokens of every slot from this rank's rows of the
        last position's logits (on a mesh: gathered over the data axes)."""
        last = greedy_token(self.model.cfg, logits[:, -1], self.mesh)
        if self.mesh is None:
            return last
        axes = [a for a, n, p in zip(self.mesh.mesh_dim_names,
                                     self.mesh.shape, self.rows)
                if isinstance(p, Shard) and n > 1]
        if not axes:
            return last
        return collective("AllGather", "serve/tokens", last,
                          data_group(self.mesh, axes), dim=0)

    def _prefill_batch(self, rows: Sequence[Optional[Request]]):
        """One batched prefill over ``rows`` (None rows carry zeros).
        Returns (last-token vector, cache with per-slot positions)."""
        cfg = self.model.cfg
        toks = self._pad_prompts(rows)[self.r0:self.r1]
        batch = {"tokens": torch.from_numpy(toks).long().to(self.device)}
        if cfg.is_encdec:     # the stub frontend: zero frame embeddings
            Se = max(1, self.prompt_len // cfg.enc_ratio)
            batch["src_embeds"] = torch.zeros((len(toks), Se, cfg.d_model),
                                              device=self.device)
        logits, cache = self.model.prefill(self.params, batch, self.cache_len,
                                           self.mesh)
        self.stats["prefill_calls"] += 1
        return self._greedy(logits), cache

    def _refill_prefill(self, active: Sequence[Optional[Request]],
                        idxs: List[int], cache, last):
        """Prefill the newly refilled slots (one batched call however many
        freed this step) and splice their rows — cache, position, last
        token — into the live decode state."""
        with tracing.span("serve/prefill", device=True):
            rows = [r if i in idxs else None for i, r in enumerate(active)]
            self.stats["prefill_prompt_tokens"] += sum(
                min(len(active[i].prompt), self.prompt_len) for i in idxs)
            self.stats["prefill_tokens"] += self.B * self.prompt_len
            fresh_last, fresh = self._prefill_batch(rows)
            if cache is None:              # initial fill: take it wholesale
                return fresh_last, fresh
            with tracing.span("serve/splice", device=True):
                sel = torch.zeros(self.B, dtype=torch.bool,
                                  device=self.device)
                sel[idxs] = True
                mine = sel[self.r0:self.r1]    # this rank's rows of the cache
                # spliced in place: the live cache belongs to this engine
                cache["pos"][mine] = fresh["pos"][mine]
                for key in cache:
                    if key == "pos":
                        continue
                    for old, new in zip(tree_leaves(cache[key]),
                                        tree_leaves(fresh[key])):
                        old[:, mine] = new[:, mine]  # batch axis 1
                return torch.where(sel, fresh_last, last), cache

    def _late(self, active: Sequence[Optional[Request]],
              admitted: List[float]) -> List[bool]:
        """Each slot's request past its deadline.  On a mesh the flags are
        agreed by a MAX All-Reduce over every rank (``serve/deadline``)
        whenever a live request has a deadline, so that no rank finishes a
        request another keeps."""
        now = time.monotonic()
        late, timed = [False] * self.B, False
        for i, r in enumerate(active):
            if r is None or r.done:
                continue
            deadline = (r.deadline_s if r.deadline_s is not None
                        else self.default_deadline_s)
            if deadline is not None:
                timed = True
                late[i] = now - admitted[i] >= deadline
        if self.mesh is None or not timed:
            return late
        flags = collective("AllReduce", "serve/deadline",
                           torch.tensor(late, dtype=torch.int32,
                                        device=self.device),
                           mesh_group(self.mesh), op=dist.ReduceOp.MAX)
        return [bool(f) for f in flags.tolist()]

    def _token_budget(self, r: Request) -> int:
        return (r.max_new_tokens if self.max_new_cap is None
                else min(r.max_new_tokens, self.max_new_cap))

    @torch.no_grad()
    def run(self, requests: List[Request], *, max_steps: int = 10_000
            ) -> List[Request]:
        """Process all requests with continuous slot reuse."""
        with tracing.span("serve/run"):
            return self._run(requests, max_steps)

    def _run(self, requests: List[Request], max_steps: int
             ) -> List[Request]:
        queue = list(requests)
        # each queued request's wait for a slot (while tracing is on)
        waits = [tracing.start("serve/queue") for _ in queue] \
            if tracing.on() else None
        active: List[Optional[Request]] = [None] * self.B
        admitted: List[float] = [0.0] * self.B    # slot admission times

        def refill() -> List[int]:
            new = []
            for i in range(self.B):
                if active[i] is None and queue:
                    active[i] = queue.pop(0)
                    admitted[i] = time.monotonic()
                    if waits:
                        tracing.stop(waits.pop(0))
                    new.append(i)
            return new

        last, cache = self._refill_prefill(active, refill(), None, None)

        for _step in range(max_steps):
            if all(r is None or r.done for r in active) and not queue:
                break
            # the decode step updates the cache's tensors in place (the JAX
            # engine donates the cache to its jitted step)
            with tracing.span("serve/decode", device=True):
                logits, cache = self.model.decode(
                    self.params, cache, last[self.r0:self.r1, None],
                    self.mesh, self.cache_len)
            self.stats["decode_steps"] += 1
            with tracing.span("serve/sync"):
                last = self._greedy(logits)
                host = last.cpu().numpy()
            late = self._late(active, admitted)
            for i, r in enumerate(active):
                if r is None or r.done:
                    continue
                r.output.append(int(host[i]))
                self.stats["tokens_out"] += 1
                if late[i]:
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
