"""The process group a single host runs on.

Counterpart of ``repro/launch/mesh.py::make_host_mesh``: where the JAX
package builds a mesh over the devices present, the port needs a
``torch.distributed`` process group to gather over.  Functions, so that
importing this module initialises nothing.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path
from typing import Optional, Union

import torch
import torch.distributed as dist

from repro_torch import resolve_device

__all__ = ["host_group", "destroy"]


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
    store; a group it did not make (``torchrun``'s) is left alone."""
    d = _store_dir()
    if not d.exists():
        return
    if dist.is_initialized():
        dist.destroy_process_group()
    shutil.rmtree(d, ignore_errors=True)
