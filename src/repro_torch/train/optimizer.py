"""AdamW with global-norm clipping, a cosine LR schedule and optional int8
gradient compression with error feedback.

Port of ``repro/train/optimizer.py``, in the same f32 math and order: f32
moments over bf16 params (master-less mixed-precision AdamW: the update
is computed in f32 and cast back).  Where the JAX update builds new
arrays, this one updates the params and the moments in place, under
``torch.no_grad()``: at glm4-9b's width a second copy of them would not
fit beside the first.

ZeRO-1 on a mesh (``zero1=`` the moments' placements, ``zero1_shardings``,
and ``mesh=``): each moment (and the error feedback) holds this rank's
data-axis slice of its parameter's shard, ``1 / dp`` of it where the rule
splits the leaf (over ``(pod, data)`` in row-major order on a pod mesh);
:func:`adamw_update` updates the matching slice of the parameter from the
whole reduced gradient, with the norm of the whole gradients, and
All-Gathers the updated slices over the data axes, one group
(``zero1/params``: GSPMD's gather in the JAX package, where it is not
declared).  With ``grad_compression`` the int8 error feedback is kept
the same way and compressed in the update, not in a collective, as in
the JAX step.  Under ZeRO-3 the params are those slices already: the
step passes no ``zero1``, and each param is updated in place from its
gradient's slice, with no gather.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..models.param import tree_leaves, tree_map, tree_zip
from ..parallel import sharding
from ..parallel.collective_planner import collective, data_group, mesh_group
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


def _zero1_slice(t: torch.Tensor, placements, mesh) -> torch.Tensor:
    """The view of a parameter's shard ``t`` that this rank's ZeRO-1
    moment covers: the data-axis shards of its ``zero1_spec``
    placements."""
    if placements is None:
        return t
    return sharding.local_shard(t, placements, mesh,
                                axes=sharding.dp_axes(mesh))


def init_opt_state(params, *, compression: bool = False, zero1=None,
                   mesh=None) -> OptState:
    """Zero moments (and error feedback) in f32 beside each param; with
    ``zero1`` (a tree of placements like ``params``) and ``mesh``, each the
    size of this rank's ZeRO-1 slice of the param."""
    def zeros_tree():
        pairs = iter(tree_zip(params, zero1) if zero1 is not None
                     else [(p, None) for p in tree_leaves(params)])

        def zeros(_):
            p, z = next(pairs)
            return torch.zeros(_zero1_slice(p, z, mesh).shape, dtype=F32,
                               device=p.device)
        return tree_map(zeros, params)
    device = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m=zeros_tree(), v=zeros_tree(),
                    err=zeros_tree() if compression else None)


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


def _compress_scales(leaves, scale, mesh):
    """Each leaf's int8 scale input on a mesh, in the order of ``leaves``
    (``adamw_update``'s (param, grad, m, v, err, zero1) tuples): the
    largest |g * clip + err| over the whole leaf (as the JAX package's
    GSPMD step takes it), from one MAX All-Reduce of this rank's maxima
    over the mesh (``grads/compress-scale``)."""
    local = torch.stack([
        (_zero1_slice(g, z, mesh).to(F32) * scale + e).abs().max()
        for _, g, _, _, e, z in leaves])
    return collective("AllReduce", "grads/compress-scale", local,
                      mesh_group(mesh), op=torch.distributed.ReduceOp.MAX)


@torch.no_grad()
def adamw_update(cfg: OptConfig, params, grads, state: OptState, *,
                 grad_norm: Optional[torch.Tensor] = None, zero1=None,
                 mesh=None) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step; returns (params, new state, metrics).

    The params' tensors and the state's moments (and error feedback) are
    updated in place, one leaf at a time, and returned; ``grads`` is left
    as it is.  ``grad_norm`` is the global norm when ``grads`` holds only
    this rank's shard of a leaf (the mesh step); otherwise it is computed
    from ``grads``.  With ``zero1`` and ``mesh`` the moments are ZeRO-1
    slices (:func:`init_opt_state`): each rank updates its slice of the
    param and the slices are All-Gathered over ``data``.  Where ``params``
    are ZeRO-3 slices, ``zero1`` is None and ``grads`` are their slices:
    each leaf is updated as it is, ``mesh`` giving only the int8 scales'
    group."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    compress = cfg.grad_compression and state.err is not None
    if zero1 is None:
        zero1 = tree_map(lambda _: None, params)
    leaves = tree_zip(params, grads, state.m, state.v,
                      state.err if compress else params, zero1)
    amax = iter(_compress_scales(leaves, scale, mesh)
                if compress and mesh is not None else [])

    step = state.step + 1
    lr = cosine_lr(cfg, state.step)
    b1, b2 = cfg.betas
    bc1 = 1.0 - b1 ** step.to(F32)
    bc2 = 1.0 - b2 ** step.to(F32)
    for p, g, m, v, err, z in leaves:
        ps, g = _zero1_slice(p, z, mesh), _zero1_slice(g, z, mesh)
        g = g.to(F32, copy=True).mul_(scale)
        if compress:
            g, new_err = compress_with_feedback(g, err,
                                                amax=next(amax, None))
            err.copy_(new_err)
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        pf = ps.to(F32)
        delta.add_(pf, alpha=cfg.weight_decay)
        new = pf - lr * delta
        if ps.shape != p.shape:
            new = collective("AllGather", "zero1/params", new.to(p.dtype),
                             data_group(mesh), dim=sharding.data_dim(z, mesh))
        p.copy_(new)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(step, state.m, state.v, state.err), metrics
