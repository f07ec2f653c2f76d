"""AdamW with global-norm clipping, a cosine LR schedule and optional int8
gradient compression with error feedback.

Port of ``repro/train/optimizer.py``, in the same f32 math and order: f32
moments over bf16 params (master-less mixed-precision AdamW: the update
is computed in f32 and cast back).  Where the JAX update builds new
arrays, this one updates the params and the moments in place, under
``torch.no_grad()``: at glm4-9b's width a second copy of them would not
fit beside the first.  ZeRO-1 sharding of the moments is not ported
(ROADMAP A.5, slice 13).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..models.param import tree_leaves, tree_map, tree_zip
from ..parallel.compression import compress_with_feedback

F32 = torch.float32

__all__ = ["OptConfig", "OptState", "init_opt_state", "adamw_update",
           "cosine_lr", "global_norm"]


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    grad_compression: bool = False      # int8 + error feedback


class OptState(NamedTuple):
    step: torch.Tensor       # () int32
    m: Any                   # nested dict of f32 tensors, like params
    v: Any                   # nested dict of f32 tensors, like params
    err: Any                 # error-feedback tree (or None)


def init_opt_state(params, *, compression: bool = False) -> OptState:
    """Zero moments (and error feedback) in f32 beside each param."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)
    device = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m=tree_map(zeros, params), v=tree_map(zeros, params),
                    err=tree_map(zeros, params) if compression else None)


def cosine_lr(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac`` (f32)."""
    s = torch.as_tensor(step).to(F32)
    warm = torch.clamp((s + 1.0) / max(1, cfg.warmup_steps), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 \
        * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: OptConfig, params, grads, state: OptState, *,
                 grad_norm: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step; returns (params, new state, metrics).

    The params' tensors and the state's moments (and error feedback) are
    updated in place, one leaf at a time, and returned; ``grads`` is left
    as it is.  ``grad_norm`` is the global norm when ``grads`` holds only
    this rank's shard of a leaf (the mesh step); otherwise it is computed
    from ``grads``."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    compress = cfg.grad_compression and state.err is not None

    step = state.step + 1
    lr = cosine_lr(cfg, state.step)
    b1, b2 = cfg.betas
    bc1 = 1.0 - b1 ** step.to(F32)
    bc2 = 1.0 - b2 ** step.to(F32)
    for p, g, m, v, err in tree_zip(params, grads, state.m, state.v,
                                    state.err if compress else params):
        g = g.to(F32, copy=True).mul_(scale)
        if compress:
            g, new_err = compress_with_feedback(g, err)
            err.copy_(new_err)
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        pf = p.to(F32)
        delta.add_(pf, alpha=cfg.weight_decay)
        p.copy_(pf - lr * delta)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(step, state.m, state.v, state.err), metrics
