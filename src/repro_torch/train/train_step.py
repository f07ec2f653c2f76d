"""Train-step factory: loss, gradients and the AdamW update, on one device
or on a ``(data, model)`` mesh.

Port of ``repro/train/train_step.py``.  Gradients come from
``torch.autograd.grad`` over the parameter leaves; microbatch gradients
are summed into f32 zeros and divided by their count, as the JAX step's
``lax.scan`` does.

On a mesh (a ``DeviceMesh`` from ``launch/mesh.py``, called on every
rank) the batch is split over ``data``.  With ``use_planner_loss`` an
untied, non-enc-dec model takes the COMET-planned explicit-collective
loss (``cfg.softmax_strategy``: 'dist'/'gather'/'auto' via the planner;
'gspmd' reads as 'auto'): the stack's output goes through
``sharded_softmax_xent`` with the unembed vocab-sharded over ``model``
(:func:`shard_params`).  Every other parameter is replicated, and its
gradient is SUM-all-reduced over ``data`` before AdamW (the unembed's is
reduced inside the loss); the global gradient norm adds the unembed
shards' squares over ``model``.  That is numerically the step GSPMD
computes for the JAX package's mesh step with replicated parameters.
Tensor-parallel shardings of the stack, ZeRO-1 moments and int8
compression on a mesh wait for ROADMAP A.5's next slice (13).  With
``mesh=None`` ``use_planner_loss`` is the plain loss, as in the JAX
package.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from ..models import transformer
from ..models.model import Model
from ..models.param import tree_leaves, tree_map
from ..parallel import sharding
from ..parallel.collective_planner import (_flatten_sorted, collective,
                                           sharded_softmax_xent,
                                           split_cotangent, sum_over)
from .optimizer import F32, OptConfig, OptState, adamw_update

__all__ = ["TrainState", "make_train_step", "make_loss_fn",
           "value_and_grad", "shard_params", "uses_planner_loss"]


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def uses_planner_loss(cfg, mesh, use_planner_loss: bool) -> bool:
    """Whether the step takes the planner loss (and a vocab-sharded
    unembed): on a mesh, for an untied, non-enc-dec model."""
    return bool(use_planner_loss and mesh is not None
                and not cfg.tie_embeddings and not cfg.is_encdec)


def _data_axis(mesh) -> str:
    dp = sharding.dp_axes(mesh)
    if len(dp) != 1:
        raise NotImplementedError(
            f"a train step over data axes {dp} is not ported (one 'data' "
            f"axis only): ROADMAP A.5, slice 13")
    return dp[0]


def _local_rows(batch: Dict[str, torch.Tensor], mesh
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of the global batch: dim 0 split over ``data``."""
    B = next(iter(batch.values())).shape[0]
    n = sharding.dp_size(mesh)
    if B % n:
        raise ValueError(f"batch {B} does not split over {n} data ranks")
    spec = sharding.batch_spec(mesh, B)
    return {k: sharding.local_shard(v, spec, mesh) for k, v in batch.items()}


def shard_params(model: Model, params, mesh, use_planner_loss: bool):
    """This rank's parameters for the mesh step: with the planner loss,
    the unembed's block of vocab columns (``spec_for``'s ``model`` shard),
    a copy; every other leaf as it is (replicated)."""
    cfg = model.cfg
    if not uses_planner_loss(cfg, mesh, use_planner_loss):
        return params
    w = params["unembed"]
    spec = sharding.spec_for(("embed", "vocab"), tuple(w.shape), mesh)
    if sharding.partition_spec(spec, mesh) != (None, "model") \
            and sharding.mesh_axes(mesh)["model"] > 1:
        raise ValueError(f"padded vocab {w.shape[1]} does not split over "
                         f"the model axis")
    return dict(params, unembed=sharding.local_shard(w, spec, mesh).clone())


def make_loss_fn(model: Model, mesh=None, use_planner_loss: bool = False):
    """loss_fn(params, batch) -> the f32 mean loss over the whole batch.
    On a mesh, ``batch`` is the global batch (every rank passes the same)
    and ``params`` this rank's (:func:`shard_params`); the loss is the
    same on every rank."""
    cfg = model.cfg
    if mesh is None:
        def loss_fn(params, batch):
            return model.loss(params, batch)
        return loss_fn

    axis = _data_axis(mesh)
    if uses_planner_loss(cfg, mesh, use_planner_loss):
        strategy = cfg.softmax_strategy if cfg.softmax_strategy != "gspmd" \
            else "auto"

        def loss_fn(params, batch):
            # explicit-collective loss: forward to hidden states, then the
            # COMET-planned sharded softmax-xent (dist vs gather)
            b = _local_rows(batch, mesh)
            x = transformer.hidden(cfg, params, b["tokens"])
            return sharded_softmax_xent(
                x, params["unembed"], b["labels"], mesh,
                real_vocab=cfg.vocab_size, strategy=strategy)
        return loss_fn

    n = sharding.dp_size(mesh)
    group = mesh.get_group(axis)

    def loss_fn(params, batch):
        # this rank's share of the mean, summed over data: the global mean,
        # its cotangent split over the data replicas
        share = model.loss(params, _local_rows(batch, mesh)) / n
        return split_cotangent(sum_over(share, group, "loss/mean"), n)
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


def _reduce_grads(grads, mesh, sharded_unembed: bool):
    """SUM-all-reduce every gradient leaf over ``data`` (one collective a
    leaf, labelled as ``train_collective_schedule``'s ``grads/...``), but
    the unembed's when the loss reduced it; returns the reduced tree (in
    sorted key order; ``adamw_update`` matches leaves by name) and the
    global norm (the unembed shards' squares summed over ``model``)."""
    group = mesh.get_group(_data_axis(mesh))
    out = {}
    sq = torch.zeros((), dtype=F32, device=tree_leaves(grads)[0].device)
    unembed_sq = None
    for keys, g in _flatten_sorted(grads):
        if sharded_unembed and "unembed" in keys:
            r = g
            unembed_sq = torch.sum(torch.square(g.to(F32)))
        else:
            r = collective("AllReduce", "grads/" + ".".join(keys), g, group)
            sq = sq + torch.sum(torch.square(r.to(F32)))
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = r
    if unembed_sq is not None:
        sq = sq + collective("AllReduce", "grads/norm", unembed_sq,
                             mesh.get_group("model"))
    return out, torch.sqrt(sq)


def make_train_step(model: Model, opt_cfg: OptConfig, mesh=None, *,
                    microbatches: int = 1, use_planner_loss: bool = False):
    """Returns train_step(state, batch) -> (state, metrics).  The step
    updates ``state``'s tensors in place (the JAX step donates its state).
    On a mesh every rank calls it with the same global batch and its own
    state (``shard_params``' params)."""
    if mesh is not None and opt_cfg.grad_compression:
        raise NotImplementedError(
            "int8 gradient compression on a mesh is not ported: ROADMAP "
            "A.5, slice 13")
    loss_fn = make_loss_fn(model, mesh, use_planner_loss)
    sharded = uses_planner_loss(model.cfg, mesh, use_planner_loss)

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

        gnorm = None
        if mesh is not None:
            grads, gnorm = _reduce_grads(grads, mesh, sharded)
        new_params, new_opt, metrics = adamw_update(
            opt_cfg, state.params, grads, state.opt, grad_norm=gnorm)
        metrics = dict(metrics, loss=loss)
        return TrainState(new_params, new_opt), metrics

    return train_step
