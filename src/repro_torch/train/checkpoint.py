"""Fault-tolerant checkpointing: atomic manifest + per-leaf npy files,
keep-last-k retention and an async writer thread.

Port of ``repro/train/checkpoint.py``, in its layout, so that a checkpoint
written by either package restores in the other:
    <dir>/step_000123/
        manifest.json      # step, extra metadata, each leaf's name/shape/dtype
        leaf_00000.npy ... # one file per leaf
    <dir>/LATEST           # atomic pointer file

Leaves follow JAX's flatten order (dict keys sorted, NamedTuple fields in
order, ``None`` no leaf) and are named as ``jax.tree_util.keystr`` names
them (``.params['layers']['mlp']['wi']``).  A bf16 leaf is written as the
JAX package writes it, 2-byte words under the npy descr ``'<V2'`` with
``"dtype": "bfloat16"`` in the manifest, and read back as those words
viewed as ``torch.bfloat16``.

On a mesh (``placements=`` a tree of placements like the state's, from
``train_step.state_placements``, and ``mesh=``) every rank gathers the
leaves whole one at a time (``sharding.gather_leaf``; rank 0 copies each
to the host and frees it before the next, so that a card holds its shards
and one whole leaf, not the whole state), rank 0 writes the same layout
and every rank waits on a barrier; ``restore_checkpoint(..., shardings=,
mesh=)`` reads the whole leaves and gives each rank its shard under the
new mesh's placements, so that a checkpoint written on one mesh restores
on another, or on none, bit for bit (elastic restore).
"""
from __future__ import annotations

import collections
import json
import os
import queue
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.collective_planner import mesh_group
from ..parallel.sharding import gather_leaf, local_shard

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "AsyncCheckpointer", "flatten_with_names"]

_MANIFEST = "manifest.json"
_LATEST = "LATEST"
_BF16 = "bfloat16"


def flatten_with_names(tree, path: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) pairs of a tree of dicts and NamedTuples in JAX's
    flatten order, named as ``jax.tree_util.keystr`` names them."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flatten_with_names(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in flatten_with_names(getattr(tree, f), f"{path}.{f}")]
    return [(path, tree)]


def _unflatten(like, leaves) -> Any:
    """The structure of ``like`` with its leaves taken in order from the
    iterator ``leaves`` (dicts keep ``like``'s key order)."""
    if like is None:
        return None
    if isinstance(like, dict):
        vals = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, f), leaves)
                            for f in like._fields))
    return next(leaves)


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array on the host; a bf16 tensor as its 16-bit
    words (``np.uint16``)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _save_leaf(path: str, leaf) -> Tuple[List[int], str]:
    """Write one leaf's npy file; returns its shape and manifest dtype."""
    is_bf16 = torch.is_tensor(leaf) and leaf.dtype == torch.bfloat16
    arr = _host(leaf)
    if not is_bf16:
        np.save(path, arr)
        return list(arr.shape), str(arr.dtype)
    with open(path, "wb") as f:      # np.save of an ml_dtypes bf16 array
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())
    return list(arr.shape), _BF16


def _snapshot(leaf):
    """A copy of a leaf in host memory."""
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _host_leaves(tree, placements, mesh, keep: bool):
    """(name, host copy of the leaf) of ``tree`` in flatten order, made as
    it is drawn; None for the copy where not ``keep`` (a rank that does
    not write).  On a mesh each leaf is first gathered whole, and freed
    before the next one is gathered; every rank of the mesh draws every
    leaf (the gathers are collectives)."""
    named = flatten_with_names(tree)
    where = ([p for _, p in flatten_with_names(placements)]
             if mesh is not None else [None] * len(named))
    if len(where) != len(named):
        raise ValueError(f"{len(where)} placements for {len(named)} leaves")
    for (name, leaf), p in zip(named, where):
        whole = leaf if mesh is None else gather_leaf(leaf, p, mesh)
        host = _snapshot(whole) if keep else None
        del whole
        yield name, host


def _is_writer(mesh) -> bool:
    """Whether this rank writes a mesh's checkpoint: rank 0 of the mesh."""
    return tuple(mesh.get_coordinate() or (1,)) == (0,) * mesh.ndim


def _barrier(mesh) -> None:
    """Every rank of ``mesh`` waits for the others (on NCCL, on this
    rank's card)."""
    group = mesh_group(mesh)
    kw = ({"device_ids": [torch.cuda.current_device()]}
          if dist.get_backend(group) == "nccl" else {})
    dist.barrier(group=group, **kw)


def save_checkpoint(ckpt_dir: str, step: int, tree, *,
                    extra: Optional[Dict] = None, keep: int = 3,
                    placements=None, mesh=None) -> str:
    """Synchronous atomic save; returns the checkpoint path.  On a mesh
    (``placements`` and ``mesh``, every rank calls it) the leaves are
    gathered whole one at a time, rank 0 of the mesh writes each, and
    every rank waits for it."""
    if mesh is None:
        return _write(ckpt_dir, step, flatten_with_names(tree), extra, keep)
    writer = _is_writer(mesh)
    leaves = _host_leaves(tree, placements, mesh, writer)
    try:
        if writer:
            _write(ckpt_dir, step, leaves, extra, keep)
    finally:
        collections.deque(leaves, maxlen=0)   # every rank gathers them all
    _barrier(mesh)
    return os.path.join(ckpt_dir, f"step_{step:09d}")


def _write(ckpt_dir: str, step: int, leaves, extra: Optional[Dict],
           keep: int) -> str:
    """Write the (name, leaf) pairs ``leaves``, drawn one at a time."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (name, leaf) in enumerate(leaves):
        fname = f"leaf_{i:05d}.npy"
        shape, dtype = _save_leaf(os.path.join(tmp, fname), leaf)
        del leaf
        manifest["leaves"].append({"name": name, "file": fname,
                                   "shape": shape, "dtype": dtype})
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    latest_tmp = os.path.join(ckpt_dir, _LATEST + ".tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(final))
    os.replace(latest_tmp, os.path.join(ckpt_dir, _LATEST))
    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, _LATEST)
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(ckpt_dir, name, _MANIFEST)):
        return None
    return int(name.split("_")[1])


def _load_leaf(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == _BF16:                # 2-byte words, descr '<V2'
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    want = np.dtype(dtype)
    return torch.from_numpy(arr if arr.dtype == want else arr.view(want))


def restore_checkpoint(ckpt_dir: str, tree_like, *, step: Optional[int] = None,
                       shardings=None, mesh=None) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``tree_like``: each leaf as the file
    holds it, on the device of ``tree_like``'s leaf in its place.  With
    ``shardings`` (a tree of placements like ``tree_like``, for ``mesh``)
    each leaf is this rank's shard of the whole one: a checkpoint written
    on any mesh, or none, restores onto any other (elastic restore).
    Returns (tree, step, extra)."""
    if (shardings is None) != (mesh is None):
        raise ValueError("shardings= and mesh= go together")
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    like = [leaf for _, leaf in flatten_with_names(tree_like)]
    if len(like) != len(manifest["leaves"]):
        raise ValueError(f"{path} holds {len(manifest['leaves'])} leaves, "
                         f"the tree to restore into {len(like)}")
    placed = ([p for _, p in flatten_with_names(shardings)]
              if shardings is not None else [None] * len(like))
    if len(placed) != len(like):
        raise ValueError(f"{len(placed)} placements for {len(like)} leaves")
    leaves = []
    for entry, ref, pl in zip(manifest["leaves"], like, placed):
        t = _load_leaf(os.path.join(path, entry["file"]), entry["dtype"])
        if pl is not None:
            t = local_shard(t, pl, mesh).clone()
        leaves.append(t.to(ref.device) if torch.is_tensor(ref) else t)
    return (_unflatten(tree_like, iter(leaves)), step,
            manifest.get("extra", {}))


class AsyncCheckpointer:
    """Background writer thread: training never blocks on I/O.  ``save``
    snapshots to host memory synchronously (a copy, since the train step
    updates its tensors in place) and enqueues the disk write; ``wait``
    drains the queue and joins the thread (call before exit).  On a mesh
    (``placements``, ``mesh``; every rank makes one and calls ``save`` and
    ``wait`` in step) ``save`` gathers the leaves whole one at a time in
    the calling thread, rank 0 of the mesh alone copies and writes them,
    and ``wait`` ends on a barrier of every rank."""

    def __init__(self, ckpt_dir: str, keep: int = 3, *, placements=None,
                 mesh=None):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.placements, self.mesh = placements, mesh
        self.writer = mesh is None or _is_writer(mesh)
        self._q: "queue.Queue" = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self.errors: List[str] = []

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            step, leaves, extra = item
            try:
                _write(self.ckpt_dir, step, leaves, extra, self.keep)
            except Exception as e:  # noqa: BLE001 — surfaced via .errors
                self.errors.append(f"step {step}: {e}")

    def save(self, step: int, tree, extra: Optional[Dict] = None) -> None:
        snap = list(_host_leaves(tree, self.placements, self.mesh,
                                 self.writer))
        if self.writer:
            self._q.put((step, snap, extra))

    def wait(self) -> None:
        self._q.put(None)
        self._worker.join()
        if self.mesh is not None:
            _barrier(self.mesh)
