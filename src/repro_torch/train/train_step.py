"""Train-step factory: loss, gradients and the AdamW update.

Port of ``repro/train/train_step.py``.  Gradients come from
``torch.autograd.grad`` over the parameter leaves; microbatch gradients
are summed into f32 zeros and divided by their count, as the JAX step's
``lax.scan`` does.  A mesh (data and model sharding, and with it the
COMET-planned explicit-collective loss) is not ported: with ``mesh=None``
``use_planner_loss`` is the plain loss, exactly as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from ..models.model import Model
from ..models.param import tree_leaves, tree_map
from .optimizer import OptConfig, OptState, adamw_update

__all__ = ["TrainState", "make_train_step", "make_loss_fn",
           "value_and_grad"]


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def make_loss_fn(model: Model, mesh=None, use_planner_loss: bool = False):
    """loss_fn(params, batch) -> f32 scalar.  The planner loss needs a mesh,
    so without one it is the plain loss (as in the JAX package)."""
    if mesh is not None:
        raise NotImplementedError(
            "training on a mesh (sharded params, ZeRO-1 moments, the "
            "planner loss) is not ported yet: ROADMAP A.5")

    def loss_fn(params, batch):
        return model.loss(params, batch)

    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)`` by autograd over the
    param leaves; grads a tree like ``params``, in the params' dtypes."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    with torch.enable_grad():
        loss = loss_fn(tree_map(lambda _: next(it), params), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(model: Model, opt_cfg: OptConfig, mesh=None, *,
                    microbatches: int = 1, use_planner_loss: bool = False):
    """Returns train_step(state, batch) -> (state, metrics).  The step
    updates ``state``'s tensors in place (the JAX step donates its state)."""
    loss_fn = make_loss_fn(model, mesh, use_planner_loss)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if microbatches > 1:
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            for i in range(microbatches):
                mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                   + v.shape[1:])[i] for k, v in batch.items()}
                l, g = value_and_grad(loss_fn, state.params, mb)
                loss = loss + l
                for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(gi)
            loss = loss / microbatches
            for acc in tree_leaves(grads):
                acc.div_(microbatches)
        else:
            loss, grads = value_and_grad(loss_fn, state.params, batch)

        new_params, new_opt, metrics = adamw_update(opt_cfg, state.params,
                                                    grads, state.opt)
        metrics = dict(metrics, loss=loss)
        return TrainState(new_params, new_opt), metrics

    return train_step
