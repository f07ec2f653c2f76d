"""Train-step factory: loss, gradients and the AdamW update, on one device
or on a ``(data, model)`` or ``(pod, data, model)`` mesh.  With
``repro_torch.tracing`` on, a step records ``train/step`` over
``train/forward``, ``train/backward``, ``train/reduce`` (on a mesh) and
``train/optimizer``.

Port of ``repro/train/train_step.py``.  Gradients come from
``torch.autograd.grad`` over the parameter leaves; microbatch gradients
are summed into f32 zeros and divided by their count, as the JAX step's
``lax.scan`` does.

On a mesh (a ``DeviceMesh`` from ``launch/mesh.py``, called on every
rank with the same global batch) each rank holds the shards that
``param_shardings`` gives it (:func:`init_train_state`) and ZeRO-1
moments (``zero1_shardings``); the batch is split over the data axes,
``(pod, data)`` in row-major order (an enc-dec model's ``src_embeds``
frames with its tokens; replicated over an axis it does not divide, as
``batch_spec`` falls back).  Every family's
layers are tensor-parallel (GQA and MLA attention, cross-attention, the
SSM mixer, the dense MLP, the shared experts, the embedding and the
unembed) and MoE layers expert-parallel over ``model`` (``models/``).  With ``use_planner_loss`` an untied, non-enc-dec model
takes the COMET-planned explicit-collective loss (``cfg.softmax_strategy``:
'dist'/'gather'/'auto' via the planner; 'gspmd' reads as 'auto') on the
vocab-sharded unembed; the plain loss gathers the unembed's columns
(``tp/unembed-gather``).  Every gradient that the loss or the MoE layers
did not reduce is SUM-All-Reduced over the data axes, one group of ``pod
x data`` ranks (``grads/...``, this rank's shard of the leaf), as the JAX
declaration prices one collective of ``P_dp`` participants; under
``seq_shard`` the leaves that act on the residual's rows (the norms,
hymba's mixing weights) hold a partial sum over ``model`` too and are
All-Reduced over every axis at once.  The global norm adds the
model-sharded leaves' squares over ``model`` (``grads/norm``, where a
leaf is model-sharded); with ``grad_compression`` the
reduced gradients are int8-compressed on each rank's slices with the
scale of the whole leaf.  That is numerically the step GSPMD computes for
the JAX package's mesh step.  With ``mesh=None`` ``use_planner_loss`` is
the plain loss, as in the JAX package.

ZeRO-3 (``cfg.fsdp``) on a mesh: :func:`state_placements` puts each
param at its ZeRO-1 slice, the moments' placement, the one place that
says where a param lives.  The model gathers each slice over the data
axes where it is used (``params/...``, a layer's inside its remat body)
and the gather's backward Reduce-Scatters the gradient (``grads/...``),
so :func:`_reduce_grads` reduces only the leaves that the data axes keep
whole; the global norm sums each leaf's squares over the axes that split
it, and AdamW updates the slices in place, with no ``zero1/params``
gather.  That is the step GSPMD compiles for the JAX package from its
``state_specs``' ZeRO-3 shardings.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from .. import tracing
from ..models import transformer
from ..models.model import Model
from ..models.moe import reduced_on_mesh
from ..models.param import tree_leaves, tree_map
from ..parallel import sharding
from ..parallel.collective_planner import (_flatten_sorted, collective,
                                           data_group, mesh_group,
                                           sharded_softmax_xent,
                                           split_cotangent, sum_over)
from .optimizer import F32, OptConfig, OptState, adamw_update, init_opt_state

__all__ = ["TrainState", "make_train_step", "make_loss_fn",
           "value_and_grad", "shard_params", "init_train_state",
           "state_placements", "uses_planner_loss"]


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def uses_planner_loss(cfg, mesh, use_planner_loss: bool) -> bool:
    """Whether the step takes the planner loss (and a vocab-sharded
    unembed): on a mesh, for an untied, non-enc-dec model."""
    return bool(use_planner_loss and mesh is not None
                and not cfg.tie_embeddings and not cfg.is_encdec)


def _local_rows(batch: Dict[str, torch.Tensor], mesh
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of the global batch: dim 0 of every leaf (the
    tokens, the labels, an enc-dec model's frames) split over the data
    axes that divide it (``batch_spec``), ``pod`` outer: the rows the JAX
    ``batch_sharding`` gives the rank."""
    B = next(iter(batch.values())).shape[0]
    spec = sharding.batch_spec(mesh, B)
    return {k: sharding.local_shard(v, spec, mesh) for k, v in batch.items()}


def state_placements(model: Model, mesh, *, compression: bool = False
                     ) -> TrainState:
    """The placements of a mesh step's state, a tree like
    :class:`TrainState`: the params' ``param_shardings`` (under ``fsdp``,
    ZeRO-3, their ``zero1_shardings``), the moments' (and error
    feedback's) ``zero1_shardings``, the step replicated (``()``).  Every
    placement of a param, in training, checkpoints and serving, is read
    here."""
    specs, tp = model.specs, model.cfg.tensor_parallel
    z = sharding.zero1_shardings(specs, mesh, tp)
    params = z if model.cfg.fsdp else sharding.param_shardings(specs, mesh,
                                                               tp)
    return TrainState(params, OptState(step=(), m=z, v=z,
                                       err=z if compression else None))


def _moment_slices(placed: TrainState):
    """The moments' placements where a moment is a slice of its param
    (ZeRO-1), None where the params are at those placements already
    (ZeRO-3): AdamW then updates them in place."""
    return None if placed.params == placed.opt.m else placed.opt.m


def shard_params(model: Model, params, mesh):
    """This rank's shards of the full ``params`` under
    :func:`state_placements` (copies where a leaf is split)."""
    return sharding.shard_tree(params, state_placements(model, mesh).params,
                               mesh)


def init_train_state(model: Model, params, mesh=None, *,
                     compression: bool = False) -> TrainState:
    """The state a step starts from, given the full ``params``: on a mesh,
    this rank's parameter shards and its ZeRO-1 moments, as the JAX
    package's ``train_loop`` places them (its ZeRO-3 step's
    ``state_specs`` under ``fsdp``)."""
    if mesh is None:
        return TrainState(params, init_opt_state(params,
                                                 compression=compression))
    params = shard_params(model, params, mesh)
    return TrainState(params, init_opt_state(
        params, compression=compression,
        zero1=_moment_slices(state_placements(model, mesh)), mesh=mesh))


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

    if uses_planner_loss(cfg, mesh, use_planner_loss):
        strategy = cfg.softmax_strategy if cfg.softmax_strategy != "gspmd" \
            else "auto"
        spec = sharding.spec_for(("embed", "vocab"),
                                 (cfg.d_model, cfg.padded_vocab), mesh)
        if sharding.mesh_axes(mesh)["model"] > 1 and \
                sharding.partition_spec(spec, mesh) != (None, "model"):
            raise ValueError(f"padded vocab {cfg.padded_vocab} does not "
                             f"split over the model axis")
        dims = transformer.zero3_dims(cfg, mesh)

        def loss_fn(params, batch):
            # explicit-collective loss: forward to hidden states, then the
            # COMET-planned sharded softmax-xent (dist vs gather)
            b = _local_rows(batch, mesh)
            x = transformer.hidden(cfg, params, b["tokens"], mesh)
            return sharded_softmax_xent(
                x, params["unembed"], b["labels"], mesh,
                real_vocab=cfg.vocab_size, strategy=strategy,
                vocab=cfg.padded_vocab,
                zero3_dim=dims["unembed"] if dims else None)
        return loss_fn

    n = sharding.dp_size(mesh)
    group = data_group(mesh)

    def loss_fn(params, batch):
        # this rank's share of the mean, summed over data: the global mean,
        # its cotangent split over the data replicas
        share = model.loss(params, _local_rows(batch, mesh), mesh) / n
        return split_cotangent(sum_over(share, group, "loss/mean"), n)
    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)`` by autograd over the
    param leaves; grads a tree like ``params``, in the params' dtypes."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    with torch.enable_grad():
        with tracing.span("train/forward", device=True):
            loss = loss_fn(tree_map(lambda _: next(it), params), batch)
        with tracing.span("train/backward", device=True):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def _reduced_in_step(keys, cfg, sharded_unembed: bool) -> bool:
    """Whether the loss or an MoE layer reduced this leaf's gradient over
    ``data`` already (``xent/unembed-grad``, ``moe/...``)."""
    if sharded_unembed and "unembed" in keys:
        return True
    return cfg.is_moe and reduced_on_mesh(keys)


def _reduce_grads(grads, mesh, placements, cfg, sharded_unembed: bool,
                  seq: bool = False):
    """SUM-all-reduce every gradient leaf over the data axes (one
    collective a leaf, labelled as ``train_collective_schedule``'s
    ``grads/...``, of this rank's shard; ``pod`` and ``data`` as one
    group) but those the step reduced already: the loss's and the MoE
    layers', and under ZeRO-3 every leaf that the data axes split, whose
    gather's backward Reduce-Scattered it.  With ``seq`` (the residual's
    sequence split over ``model``) a leaf that acts on the residual's rows
    is reduced over every axis of the mesh (under ZeRO-3, its
    Reduce-Scattered slice over ``model``).  Returns the reduced tree (in
    sorted key order; ``adamw_update`` matches leaves by name) and the
    global norm: each leaf's squares summed, those of the leaves that
    ``model`` splits over ``model``, of those that the data axes split
    over them, of those that both split over the mesh (``grads/norm``,
    one sum a group that some leaf needs), in that order."""
    group = data_group(mesh)
    model_dim = mesh.mesh_dim_names.index("model")
    where = dict(_flatten_sorted(placements))
    out = {}
    sq = {}
    for keys, g in _flatten_sorted(grads):
        label = "grads/" + ".".join(keys)
        rows = seq and transformer.acts_on_rows(keys)
        split_data = sharding.data_dim(where[keys], mesh) is not None
        if split_data:
            r = collective("AllReduce", label, g, mesh.get_group("model")) \
                if rows else g
        elif _reduced_in_step(keys, cfg, sharded_unembed):
            r = g
        else:
            r = collective("AllReduce", label, g,
                           mesh_group(mesh) if rows else group)
        s = torch.sum(torch.square(r.to(F32)))
        split = (isinstance(where[keys][model_dim], sharding.Shard),
                 split_data)
        sq[split] = sq[split] + s if split in sq else s
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = r
    groups = {(False, False): None, (True, False): mesh.get_group("model"),
              (False, True): group, (True, True): mesh_group(mesh)}
    total = None
    for split, g in groups.items():
        if split in sq:
            s = sq[split] if g is None else collective(
                "AllReduce", "grads/norm", sq[split], g)
            total = s if total is None else total + s
    return out, torch.sqrt(total)


def make_train_step(model: Model, opt_cfg: OptConfig, mesh=None, *,
                    microbatches: int = 1, use_planner_loss: bool = False):
    """Returns train_step(state, batch) -> (state, metrics).  The step
    updates ``state``'s tensors in place (the JAX step donates its state).
    On a mesh every rank calls it with the same global batch and its own
    state (:func:`init_train_state`)."""
    loss_fn = make_loss_fn(model, mesh, use_planner_loss)
    sharded = uses_planner_loss(model.cfg, mesh, use_planner_loss)
    placed = state_placements(model, mesh) if mesh is not None else None

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        with tracing.span("train/step", device=True):
            return step(state, batch)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
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
            seq = transformer.splits_sequence(model.cfg, mesh,
                                              batch["tokens"].shape[1])
            with tracing.span("train/reduce", device=True):
                grads, gnorm = _reduce_grads(grads, mesh, placed.params,
                                             model.cfg, sharded, seq)
        with tracing.span("train/optimizer", device=True):
            new_params, new_opt, metrics = adamw_update(
                opt_cfg, state.params, grads, state.opt, grad_norm=gnorm,
                zero1=_moment_slices(placed) if placed else None, mesh=mesh)
        metrics = dict(metrics, loss=loss)
        return TrainState(new_params, new_opt), metrics

    return train_step
