"""Shape-only inputs of every (architecture x shape x mesh) dry-run cell.

Port of ``repro/launch/specs.py``.  Where the JAX package builds
``ShapeDtypeStruct``s with shardings, the port builds tensors of this
rank's shards, made in the caller's ``FakeTensorMode``
(``analysis.counts.fake_mode``): shapes, dtypes and devices with no
memory, so the dry run's step runs as the rank would run it.  The state
is made leaf by leaf at its shard's size under the train step's
placements (``train_step.state_placements``); the whole tree is never
made, not even as fake tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..configs.registry import Shape
from ..models import encdec, transformer
from ..models.config import ModelConfig
from ..models.model import Model
from ..models.param import torch_dtype
from ..parallel import sharding
from ..train.optimizer import OptState
from ..train.train_step import TrainState, state_placements

__all__ = ["batch_specs", "state_specs", "cache_specs", "local_shape",
           "tree_bytes", "model_shard_bytes"]

F32 = torch.float32


def local_shape(shape: Sequence[int], placements, mesh,
                axes: Optional[Sequence[str]] = None) -> Tuple[int, ...]:
    """The shape of this rank's shard of a tensor of ``shape`` under
    ``placements`` (``sharding.local_shard``'s, with no tensor): each mesh
    dim that shards tensor dim d divides it; ``axes`` keeps only those
    mesh axes' shards."""
    out = list(shape)
    if mesh is None or placements is None:
        return tuple(out)
    for name, size, p in zip(mesh.mesh_dim_names, mesh.shape, placements):
        if axes is not None and name not in axes:
            continue
        if isinstance(p, sharding.Shard) and size > 1:
            if out[p.dim] % size:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split into {size} shards")
            out[p.dim] //= size
    return tuple(out)


def _zip_map(fn, specs, places):
    if isinstance(specs, dict):
        return {k: _zip_map(fn, specs[k], places[k]) for k in specs}
    return fn(specs, places)


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a nested dict / NamedTuple tree."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def model_shard_bytes(model: Model, mesh) -> Dict[str, float]:
    """Each param leaf's bytes on one rank of ``mesh`` under
    ``param_shardings``, by its dotted key path: the size of the
    ``model`` shard that the rank reduces (``grads/...``) or gathers over
    the data axes (``params/...``)."""
    placed = sharding.param_shardings(model.specs, mesh,
                                      model.cfg.tensor_parallel)
    out: Dict[str, float] = {}

    def walk(specs, places, path):
        if isinstance(specs, dict):
            for k in specs:
                walk(specs[k], places[k], path + (k,))
            return
        n = 1
        for d in local_shape(specs.shape, places, mesh):
            n *= d
        out[".".join(path)] = float(n * torch_dtype(specs.dtype).itemsize)
    walk(model.specs, placed, ())
    return out


def batch_specs(cfg: ModelConfig, shape: Shape, mesh, *,
                with_labels: bool = True, local: bool = False,
                device="cuda") -> Dict[str, torch.Tensor]:
    """The batch of a cell: tokens (B, S) (S 1 for decode), labels, and an
    enc-dec model's frames.  The global batch, as the train step takes
    it on every rank; with ``local`` this rank's rows (``batch_spec``), as
    prefill and decode take them."""
    B = shape.global_batch
    if local and mesh is not None:
        spec = sharding.batch_spec(mesh, B)
        B = local_shape((B,), spec, mesh)[0]
    S = shape.seq_len if shape.kind != "decode" else 1
    out = {"tokens": torch.empty((B, S), dtype=torch.int32, device=device)}
    if with_labels:
        out["labels"] = torch.empty((B, S), dtype=torch.int32, device=device)
    if cfg.is_encdec and shape.kind != "decode":
        Se = max(1, shape.seq_len // cfg.enc_ratio)
        out["src_embeds"] = torch.empty((B, Se, cfg.d_model), dtype=F32,
                                        device=device)
    return out


def state_specs(model: Model, mesh, *, with_opt: bool = True,
                device="cuda") -> Tuple[Any, Any]:
    """(this rank's TrainState-or-params, their placements): each
    parameter at its ``state_placements`` shard (``param_shardings``; its
    ZeRO-1 slice under ``fsdp``, ZeRO-3), each AdamW moment (f32) at its
    ZeRO-1 slice, the step replicated; the JAX package's
    ``state_specs``."""
    if mesh is None:
        placed = None
        params = _zip_map(lambda s, _: torch.empty(
            s.shape, dtype=torch_dtype(s.dtype), device=device),
            model.specs, model.specs)
    else:
        placed = state_placements(model, mesh)
        params = _zip_map(lambda s, p: torch.empty(
            local_shape(s.shape, p, mesh), dtype=torch_dtype(s.dtype),
            device=device), model.specs, placed.params)
    if not with_opt:
        return params, (placed.params if placed else None)

    def moment(s, z):
        return torch.empty(local_shape(s.shape, z, mesh), dtype=F32,
                           device=device)
    zero1 = placed.opt.m if placed else _zip_map(lambda s, _: None,
                                                 model.specs, model.specs)
    opt = OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                   m=_zip_map(moment, model.specs, zero1),
                   v=_zip_map(moment, model.specs, zero1), err=None)
    return TrainState(params, opt), placed


def cache_specs(model: Model, shape: Shape, mesh, device="cuda"):
    """(this rank's empty decode cache of ``shape``, None): the model's
    own ``init_cache`` (on a mesh its shards, each made at its size),
    run in the caller's fake mode."""
    init = (encdec.encdec_init_cache if model.cfg.is_encdec
            else transformer.init_cache)
    return init(model.cfg, shape.global_batch, shape.seq_len,
                torch.device(device), mesh), None
