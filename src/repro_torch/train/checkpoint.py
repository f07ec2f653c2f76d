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
viewed as ``torch.bfloat16``.  Restoring onto a mesh (``shardings=``)
needs a mesh and is not ported.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

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


def save_checkpoint(ckpt_dir: str, step: int, tree, *,
                    extra: Optional[Dict] = None, keep: int = 3) -> str:
    """Synchronous atomic save; returns the checkpoint path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (name, leaf) in enumerate(flatten_with_names(tree)):
        fname = f"leaf_{i:05d}.npy"
        shape, dtype = _save_leaf(os.path.join(tmp, fname), leaf)
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
                       shardings=None) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``tree_like``: each leaf as the file
    holds it, on the device of ``tree_like``'s leaf in its place.  Returns
    (tree, step, extra)."""
    if shardings is not None:
        raise NotImplementedError("restoring onto a mesh (elastic restore) "
                                  "is not ported yet: ROADMAP A.5")
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
    leaves = []
    for entry, ref in zip(manifest["leaves"], like):
        t = _load_leaf(os.path.join(path, entry["file"]), entry["dtype"])
        leaves.append(t.to(ref.device) if torch.is_tensor(ref) else t)
    return (_unflatten(tree_like, iter(leaves)), step,
            manifest.get("extra", {}))


class AsyncCheckpointer:
    """Background writer thread: training never blocks on I/O.  ``save``
    snapshots to host memory synchronously (a copy, since the train step
    updates its tensors in place) and enqueues the disk write; ``wait``
    drains the queue and joins the thread (call before exit)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self.errors: List[str] = []

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_tree, extra = item
            try:
                save_checkpoint(self.ckpt_dir, step, host_tree, extra=extra,
                                keep=self.keep)
            except Exception as e:  # noqa: BLE001 — surfaced via .errors
                self.errors.append(f"step {step}: {e}")

    def save(self, step: int, tree, extra: Optional[Dict] = None) -> None:
        snap = [leaf.detach().to("cpu", copy=True) if torch.is_tensor(leaf)
                else np.array(leaf) for _, leaf in flatten_with_names(tree)]
        self._q.put((step, _unflatten(tree, iter(snap)), extra))

    def wait(self) -> None:
        self._q.put(None)
        self._worker.join()
