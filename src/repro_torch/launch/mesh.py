"""The process group a single host runs on, and the meshes built on it.

Port of ``repro/launch/mesh.py``.  Where the JAX package builds a mesh
over the devices present, the port builds a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the world
group, with the JAX package's axis names (``("data", "model")`` or
``("pod", "data", "model")``), so that every collective of a mesh axis
runs in that axis's process group.  :func:`host_group` makes the world group when nothing is initialised: a
one-rank group, NCCL on ``cuda`` and gloo on ``cpu``; under ``torchrun``
(or any caller that initialised ``torch.distributed``) the mesh spans its
ranks.  Functions, so that importing this module initialises nothing.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.parallel.collective_planner import forget_mesh_groups

__all__ = ["host_group", "destroy", "make_auto_mesh", "make_host_mesh",
           "make_production_mesh", "POD_SHAPE"]

POD_SHAPE = (16, 16)


def _store_dir() -> Path:
    """The directory of this process's one-rank ``FileStore``, under the
    temporary directory ($TMPDIR)."""
    return Path(tempfile.gettempdir()) / f"repro_torch_host_group_{os.getpid()}"


def host_group(device: Optional[Union[str, torch.device]] = None
               ) -> dist.ProcessGroup:
    """The world group if ``torch.distributed`` is initialised already (as
    under ``torchrun``); otherwise a one-rank group that this call creates
    through a ``FileStore`` in a temporary directory, NCCL on ``cuda`` (the
    default) and gloo on ``cpu``.  :func:`destroy` ends a group made here."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return dist.group.WORLD
    d = _store_dir()
    shutil.rmtree(d, ignore_errors=True)   # left by a dead process of this pid
    d.mkdir(parents=True)
    store = dist.FileStore(str(d / "store"), 1)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=store, rank=0, world_size=1)
    return dist.group.WORLD


def destroy() -> None:
    """End the group :func:`host_group` made in this process and remove its
    store, and forget the meshes' all-ranks groups made on it; a group it
    did not make (``torchrun``'s) is left alone."""
    d = _store_dir()
    if not d.exists():
        return
    if dist.is_initialized():
        dist.destroy_process_group()
    forget_mesh_groups()
    shutil.rmtree(d, ignore_errors=True)


def make_auto_mesh(shape: Sequence[int], axes: Sequence[str],
                   device: Optional[Union[str, torch.device]] = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the world group
    (:func:`host_group` makes it if nothing is initialised): the ranks in
    row-major order, so rank r sits at the coordinate ``np.unravel_index(r,
    shape)``.  The mesh's size must be the world's."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    host_group(dev)
    n = 1
    for s in shape:
        n *= int(s)
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {n} ranks; "
                         f"the world has {world}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return init_device_mesh(dev.type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[Union[str, torch.device]] = None):
    """The production mesh: ``(16, 16)`` ``("data", "model")`` over 256
    ranks, or ``(2, 16, 16)`` ``("pod", "data", "model")`` over 512 with
    ``multi_pod``, through :func:`make_auto_mesh` (which raises its
    ``ValueError`` on a world of another size, as ``jax.make_mesh`` does).
    The train step and the engine reduce over ``(pod, data)`` as one
    group (``collective_planner.data_group``)."""
    shape = (2,) + POD_SHAPE if multi_pod else POD_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_auto_mesh(shape, axes, device)


def make_host_mesh(model_parallel: Optional[int] = None,
                   device: Optional[Union[str, torch.device]] = None):
    """Largest ``(data, model)`` mesh on the world's ranks: ``model`` the
    largest divisor of the world size not above ``model_parallel``
    (default 1).  On one card it is ``(1, 1)`` over NCCL."""
    dev = resolve_device(device)
    host_group(dev)
    n = dist.get_world_size()
    mp = model_parallel or 1
    while n % mp:
        mp -= 1
    return make_auto_mesh((n // mp, mp), ("data", "model"), dev)
