"""Logical-axis sharding rules -> ``DeviceMesh`` placements.

Port of ``repro/parallel/sharding.py``.  Every parameter carries logical
axis names (``models/param.py``); this module maps them onto a mesh:
tensor-parallel axes (vocab / heads / ff / experts / inner) shard over
``model``; batch shards over ``(pod, data)``; anything non-divisible
falls back to replication (e.g. MQA's single KV head, Hymba's 25 heads),
so that parameter shards divide evenly.

ZeRO-1: optimizer moments additionally shard over the data axes on the
largest divisible dimension not already sharded.  With
``tensor_parallel=False`` no logical axis maps onto ``model``: every
parameter is replicated and its moments split over the data axes only,
as the JAX package's ``launch/specs.py::state_specs`` places them.

Where the JAX package returns a ``PartitionSpec`` (one entry a tensor
dim), the port returns DTensor placements (one a mesh dim: ``Shard(d)``
or ``Replicate()``); :func:`partition_spec` turns placements back into
the JAX form.  Every rule is a pure function of the mesh's axis names and
sizes (``mesh.mesh_dim_names``, ``mesh.shape``): a ``DeviceMesh`` or a
:class:`MeshShape` with no process group behind it.  The mesh train step
applies them through :func:`shard_tree` (each rank's shard of every leaf,
``jax.device_put`` onto a sharding's counterpart) and :func:`local_shard`;
:func:`gather_leaf` and :func:`gather_tree` put the full leaves back
together (checkpoints, elastic resharding, tests).  For serving on a
mesh, :func:`shard_bounds` gives a rank's block of a placed tensor,
:func:`cache_block` the block of one layer's cache leaf (sequence or ring
slots, kv heads, SSM heads, conv channels) by :func:`cache_shardings`'
rule, and :func:`local_cache` makes a rank's cache shards at their own
size.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

from ..models.param import tree_map, tree_zip

__all__ = ["LOGICAL_RULES", "MeshShape", "mesh_axes", "dp_axes", "dp_size",
           "spec_for", "param_shardings", "zero1_spec", "zero1_shardings",
           "data_dim", "batch_spec", "cache_shardings", "split_over", "shard_bounds",
           "cache_block", "local_cache", "partition_spec", "local_shard", "shard_leaf", "shard_tree",
           "gather_leaf", "gather_tree"]

# logical axis -> mesh axis (None = replicate)
LOGICAL_RULES: Dict[Optional[str], Optional[str]] = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "experts": "model",
    "inner": "model",
    "embed": None,       # residual stream replicated (seq-parallel is a knob)
    "layer": None,
    None: None,
}


class MeshShape(NamedTuple):
    """A mesh's axis sizes and names, the two attributes of a
    ``DeviceMesh`` that the rules read."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's order."""
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def dp_axes(mesh) -> Tuple[str, ...]:
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)


def dp_size(mesh) -> int:
    sizes = mesh_axes(mesh)
    n = 1
    for a in dp_axes(mesh):
        n *= sizes[a]
    return n


def _placements(entries: Sequence, mesh) -> Tuple:
    """JAX-form entries (one a tensor dim: a mesh axis, a tuple of them or
    None) -> placements (one a mesh dim)."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, e in enumerate(entries)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def partition_spec(placements: Sequence, mesh) -> Tuple:
    """Placements -> the JAX ``PartitionSpec``'s entries: a mesh axis, a
    tuple of axes (outer first) or None for each tensor dim up to the last
    sharded one."""
    by_dim: Dict[int, list] = {}
    for name, p in zip(mesh.mesh_dim_names, placements):
        if isinstance(p, Shard):
            by_dim.setdefault(p.dim, []).append(name)
    if not by_dim:
        return ()
    return tuple(None if i not in by_dim else
                 by_dim[i][0] if len(by_dim[i]) == 1 else tuple(by_dim[i])
                 for i in range(max(by_dim) + 1))


def _spec_entries(axes, shape, mesh, tensor_parallel: bool = True) -> list:
    sizes = mesh_axes(mesh)
    entries = []
    for ax, dim in zip(axes, shape):
        mesh_ax = LOGICAL_RULES.get(ax) if tensor_parallel else None
        if mesh_ax is not None and mesh_ax in sizes \
                and dim % sizes[mesh_ax] == 0:
            entries.append(mesh_ax)
        else:
            entries.append(None)
    return entries


def spec_for(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
             mesh) -> Tuple:
    """Placements for one param: LOGICAL_RULES with divisibility fallback
    (replicate non-divisible dims)."""
    return _placements(_spec_entries(axes, shape, mesh), mesh)


def param_shardings(specs, mesh, tensor_parallel: bool = True):
    """Placements for every leaf of a ``ParamSpec`` tree (all replicated
    without ``tensor_parallel``)."""
    return tree_map(lambda s: _placements(_spec_entries(
        s.axes, s.shape, mesh, tensor_parallel), mesh), specs)


def zero1_spec(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
               mesh, tensor_parallel: bool = True) -> Tuple:
    """Param placements + data-axis sharding on the largest free divisible
    dim."""
    base = _spec_entries(axes, shape, mesh, tensor_parallel)
    dp = dp_axes(mesh)
    if dp:
        n = dp_size(mesh)
        # largest unsharded dim divisible by the full dp size
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in order:
            if base[i] is None and shape[i] % n == 0 and shape[i] >= n:
                base[i] = dp if len(dp) > 1 else dp[0]
                break
    return _placements(base, mesh)


def zero1_shardings(specs, mesh, tensor_parallel: bool = True):
    return tree_map(lambda s: zero1_spec(s.axes, s.shape, mesh,
                                         tensor_parallel), specs)


def data_dim(placements: Sequence, mesh) -> Optional[int]:
    """The tensor dim that the data axes split under ``placements`` (a
    ZeRO-1 moment's, or a ZeRO-3 parameter's), or None where they keep it
    whole.  ``zero1_spec`` puts every data axis on the same dim."""
    for name, p in zip(mesh.mesh_dim_names, placements):
        if name in dp_axes(mesh) and isinstance(p, Shard):
            return p.dim
    return None


def _batch_axes(mesh, batch: int) -> Tuple[str, ...]:
    dp = dp_axes(mesh)
    if not dp or batch % dp_size(mesh) != 0:
        # decode long_500k (batch=1): replicate
        sizes = mesh_axes(mesh)
        usable = []
        n = 1
        for a in dp:
            if batch % (n * sizes[a]) == 0:
                usable.append(a)
                n *= sizes[a]
        dp = tuple(usable)
    return dp


def batch_spec(mesh, batch: int) -> Tuple:
    """Placements of a batch-leading tensor: dim 0 over the data axes that
    divide ``batch``."""
    dp = _batch_axes(mesh, batch)
    return _placements([dp if len(dp) > 1 else (dp[0] if dp else None)],
                       mesh)


def _key_path(path: Tuple[str, ...]) -> str:
    """The JAX ``keystr`` of a dict path, e.g. ``['layers']['attn']['k']``."""
    return "".join(f"['{k}']" for k in path)


def cache_shardings(cache, mesh, batch: int):
    """KV/SSM cache placements (path-aware) for a nested dict of tensors
    (or anything with ``.shape``).  Layout is (L, B, ...) for
    layer-stacked entries.  Batch shards over dp.  Attention caches:
    kv-heads over ``model`` when divisible, otherwise the **sequence** dim
    shards over ``model`` (the paper's distSM mapping for the decode
    softmax: stats All-Reduces across the seq shards).  The MLA latent
    cache always shards seq over model (its feature dim is the
    contraction rank)."""
    dp = _batch_axes(mesh, batch)
    b_ax = dp if len(dp) > 1 else (dp[0] if dp else None)
    m = mesh_axes(mesh).get("model", 1)

    def one(path, leaf):
        name = _key_path(path)
        shp = tuple(leaf.shape)
        entries = [None] * len(shp)
        # batch dim: index 1 for stacked (L, B, ...) entries
        for i, d in enumerate(shp[:2]):
            if d == batch:
                entries[i] = b_ax
                break
        if m > 1 and len(shp) >= 3:
            if ("'k'" in name or "'v'" in name) and len(shp) == 5:
                L_, B_, S_, H_, hd_ = shp
                if H_ % m == 0:
                    entries[3] = "model"          # kv-heads TP
                elif S_ % m == 0:
                    entries[2] = "model"          # seq-sharded -> distSM
            elif "'ckv'" in name or "'kr'" in name:
                if shp[2] % m == 0:
                    entries[2] = "model"          # MLA latent: seq over model
            elif "'conv'" in name and shp[-1] % m == 0:
                entries[-1] = "model"             # conv channels TP
            elif "'state'" in name and shp[2] % m == 0:
                entries[2] = "model"              # ssm heads TP
        return _placements(entries, mesh)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return one(path, tree)

    return walk(cache, ())


def split_over(local: int, full: int, m: int) -> bool:
    """Whether a dim of ``full`` with ``local`` of it on this rank is split
    over ``m`` ranks (``spec_for`` split it), not kept whole on each; on a
    one-rank axis a dim is split into one block."""
    return local * m == full


def shard_bounds(shape: Sequence[int], placements: Sequence, mesh
                 ) -> Tuple[Tuple[int, int], ...]:
    """This rank's (start, stop) on every dim of a tensor of ``shape``
    under ``placements``: the block :func:`local_shard` takes, outer mesh
    dims first."""
    bounds = [(0, int(n)) for n in shape]
    for name, size, p in zip(mesh.mesh_dim_names, mesh.shape, placements):
        if isinstance(p, Shard) and size > 1:
            a, b = bounds[p.dim]
            if (b - a) % size:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split into {size} shards")
            n = (b - a) // size
            c = mesh.get_local_rank(name)
            bounds[p.dim] = (a + c * n, a + (c + 1) * n)
    return tuple(bounds)


def cache_block(name: str, shape: Sequence[int], mesh
                ) -> Tuple[Tuple[int, int], ...]:
    """This rank's (start, stop) on each dim of one layer's cache leaf
    ``name`` (``"k"``, ``"v"``, ``"ckv"``, ``"kr"``, ``"conv"``,
    ``"state"``) of shape ``shape`` (batch first), by
    :func:`cache_shardings`' rule over ``model``; the batch is left whole
    (the caller holds its own rows).  A ring cache is split by slot
    index, as any other sequence."""
    stacked = (1,) + tuple(int(n) for n in shape)
    placed = cache_shardings({name: SimpleNamespace(shape=stacked)}, mesh,
                             batch=0)[name]
    return shard_bounds(stacked, placed, mesh)[1:]


def local_cache(cache, mesh, batch: int, device):
    """This rank's shards of ``cache`` (a tree of tensors on the ``meta``
    device: the whole cache's shapes and dtypes) under
    :func:`cache_shardings`, each made at its shard's size and never
    whole: zeros, ``kpos`` -1 (an empty slot)."""
    placed = cache_shardings(cache, mesh, batch)

    def make(t, p, key):
        if isinstance(t, dict):
            return {k: make(t[k], p[k], k) for k in t}
        shape = [b - a for a, b in shard_bounds(t.shape, p, mesh)]
        return torch.full(shape, -1 if key == "kpos" else 0, dtype=t.dtype,
                          device=device)
    return make(cache, placed, None)


def local_shard(t, placements: Sequence, mesh,
                axes: Optional[Sequence[str]] = None):
    """This rank's shard of the global tensor ``t`` under ``placements``
    (a view; no collective): each mesh dim that shards tensor dim d keeps
    the block of d at this rank's coordinate, outer mesh dims first.
    ``axes`` keeps only those mesh axes' shards (e.g. the data axes, to
    take a ZeRO-1 moment's slice of a parameter's shard)."""
    coord = mesh.get_coordinate()
    for name, size, c, p in zip(mesh.mesh_dim_names, mesh.shape, coord,
                                placements):
        if axes is not None and name not in axes:
            continue
        if isinstance(p, Shard) and size > 1:
            n = t.shape[p.dim]
            if n % size:
                raise ValueError(f"dim {p.dim} of {tuple(t.shape)} does not "
                                 f"split into {size} shards")
            t = t.narrow(p.dim, c * (n // size), n // size)
    return t


def shard_leaf(t, placement, mesh):
    """This rank's shard of the full tensor ``t`` under ``placement``: a
    copy where it is split, ``t`` itself where it is whole (replicated, or
    on a one-rank mesh)."""
    s = local_shard(t, placement, mesh)
    return s.clone() if s.shape != t.shape else s


def shard_tree(tree, placements, mesh):
    """:func:`shard_leaf` of every leaf of ``tree`` under the matching tree
    of ``placements``."""
    pairs = iter(tree_zip(tree, placements))
    return tree_map(lambda _: shard_leaf(*next(pairs), mesh), tree)


def gather_leaf(t, placement, mesh, label: str = "tree/gather"):
    """The full tensor of this rank's shard ``t`` under ``placement``:
    every sharded mesh dim's All-Gather over its axis's group (inner mesh
    dims first), called on every rank of ``mesh``; a leaf that is whole
    comes back as it is.  The collectives go through
    ``collective_planner.collective`` (``label``)."""
    from .collective_planner import collective
    for name, size, p in reversed(list(zip(mesh.mesh_dim_names, mesh.shape,
                                           placement))):
        if isinstance(p, Shard) and size > 1:
            t = collective("AllGather", label, t, mesh.get_group(name),
                           dim=p.dim)
    return t


def gather_tree(tree, placements, mesh):
    """The full leaves of a tree of this rank's shards (:func:`gather_leaf`
    of each), called on every rank of ``mesh``."""
    pairs = iter(tree_zip(tree, placements))
    return tree_map(lambda _: gather_leaf(*next(pairs), mesh), tree)
