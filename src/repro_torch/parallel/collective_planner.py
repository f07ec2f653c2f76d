"""COMET-driven collective planning (model-level use of the paper's
central case study).

The paper's distSM-vs-SM choice for a softmax whose reduction dimension is
sharded occurs wherever the vocabulary-sharded logits feed the
cross-entropy loss (every training cell) and in TP/flash-decoding
attention merges.  Port of ``repro/parallel/collective_planner.py``:

1. ``plan_softmax_strategy``: costs both mappings with the COMET collective
   model (Eq. 3/4) on the actual mesh/tensor shapes and returns the
   cheaper one — 'dist' (All-Reduces over M×1 stats, operate in place)
   or 'gather' (All-Gather the sharded rows, compute locally).  Priced on
   ``tpu_v5e()``, as in the JAX package, bit for bit.
2. ``sharded_softmax_xent``: both strategies over a ``DeviceMesh``'s
   process groups (``torch.distributed``), each collective an autograd
   ``Function`` whose backward is the JAX transpose rule — the port's
   explicit-collective realization of Fig. 4(c).
3. ``softmax_collective_schedule`` / ``train_collective_schedule`` /
   ``price_collective_schedule``: the declared schedules, copies of the
   JAX package's.
4. The tensor-parallel operators of the mesh train step: Megatron's *f*
   and *g* (:func:`enter_parallel`, :func:`leave_parallel`),
   :func:`gather_shards`, :func:`gather_replicated`, :func:`scatter_shards`
   and :func:`take_block`, and the two ends of a tensor-parallel block
   (:func:`enter_region`, :func:`leave_region`) with the residual whole
   or split over the sequence (``seq_shard``), which the model layers
   call where GSPMD partitions the JAX package's step; the process group
   over the data axes, ``(pod, data)`` as one group (:func:`data_group`);
   and ZeRO-3's gather of a parameter's data slice (:func:`gather_param`).

Every collective goes through :func:`collective`, which
:func:`record_collectives` can count and time, and which opens a
``collective/<label>`` span of ``repro_torch.tracing``.
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device, tracing
from ..core.collectives import collective_cost, noc_latency
from ..core.hardware import tpu_v5e
from ..models.param import torch_dtype
from .sharding import dp_axes, dp_size, mesh_axes

F32 = torch.float32

__all__ = ["softmax_collective_schedule", "plan_softmax_strategy",
           "sharded_softmax_xent", "DeclaredCollective",
           "train_collective_schedule", "price_collective_schedule",
           "collective", "record_collectives", "recompute_region",
           "CollectiveRecord", "sum_over", "sum_cotangent", "split_cotangent",
           "model_axis", "make_submesh", "mesh_group", "data_group",
           "forget_mesh_groups", "enter_parallel", "leave_parallel",
           "gather_shards", "gather_replicated", "scatter_shards",
           "take_block", "gather_param", "enter_region", "leave_region",
           "SEQ_GATHER"]


def softmax_collective_schedule(strategy: str, rows: int, cols: int,
                                participants: int, *,
                                dp_participants: int = 1):
    """The DECLARED collective schedule of :func:`sharded_softmax_xent` —
    the single source of truth that both the planner (which costs it) and
    the static contract checker (the JAX package's ``analysis/contracts.py``,
    which audits the traced jaxpr against it) consume; in the port, the
    collectives :func:`sharded_softmax_xent` emits in its forward pass
    (:func:`record_collectives`) equal it.  If the implementation
    gains or loses a collective, this list must change with it or the
    contract check fails.

    Returns ``[(col_type, dv_bytes, participants, count), ...]`` with DV
    in the cost model's convention (full tensor for All-Reduce, gathered
    result for All-Gather).  Stats and logits are f32 on the wire:
    ``_local_logits`` upcasts before the gather, so the gather arm is
    charged at 4 B/elem regardless of the input dtype.

    distSM: three (rows,) f32 stat All-Reduces over the model axis — the
    pmax of the running max, the psum of the exp-sums, and the psum of
    the label logits.  SM/gather: one All-Gather of the (rows, cols/P)
    f32 logit shards.  Both arms add two scalar loss-normalization
    All-Reduces over the data axis when it exists.
    """
    calls = []
    if participants > 1:
        if strategy == "dist":
            calls.append(("AllReduce", rows * 4.0, participants, 3))
        else:
            calls.append(("AllGather", rows * cols * 4.0, participants, 1))
    if dp_participants > 1:
        calls.append(("AllReduce", 4.0, dp_participants, 2))
    return calls


@functools.lru_cache(maxsize=1024)
def plan_softmax_strategy(rows: int, cols: int, participants: int,
                          dtype_bytes: int = 2) -> str:
    """COMET Eq. 3/4 comparison of the two softmax collective mappings.

    rows=M (tokens), cols=N (sharded softmax dim, e.g. padded vocab),
    participants=#shards on the reduction axis.  Costs exactly the
    collectives :func:`softmax_collective_schedule` declares (the data-
    axis scalar psums are common to both arms and cancel).  dtype_bytes
    is kept for call compatibility; the wire dtype is f32 either way
    (see the schedule's docstring).
    """
    if participants <= 1:
        return "dist"
    arch = tpu_v5e()
    noc = arch.cluster_noc

    def lat(schedule) -> float:
        total = 0.0
        for col_type, dv, P, count in schedule:
            cc = collective_cost(col_type, dv, P, noc)
            total += count * (cc.volume_bytes / noc.channel_bandwidth
                              + noc_latency(cc, noc))
        return total

    dist = lat(softmax_collective_schedule("dist", rows, cols, participants))
    gather = lat(softmax_collective_schedule("gather", rows, cols,
                                             participants))
    return "dist" if dist <= gather else "gather"


# ---------------------------------------------------------------------------
# Explicit collectives over a mesh's process groups.
# ---------------------------------------------------------------------------

class CollectiveRecord(list):
    """The collectives of a :func:`record_collectives` block, each
    ``(label, col_type, dv_bytes, participants)``; those issued while a
    checkpointed layer is recomputed in the backward pass (remat) are kept
    apart, in ``.recompute``.  A block recorded with ``timed`` also keeps
    each collective's ``collective/<label>`` span (``.spans``: record and
    :class:`~repro_torch.tracing.Span`, in call order; :meth:`times`)."""

    def __init__(self, timed: bool = False):
        super().__init__()
        self.recompute: List[Tuple[str, str, float, int]] = []
        self.timed = timed
        self.spans: List[Tuple[Tuple[str, str, float, int],
                               tracing.Span]] = []

    def times(self) -> List[Tuple[Tuple[str, str, float, int], float]]:
        """(record, ms) of every collective of a ``timed`` block, the
        recompute's among them, in issue order: on the card CUDA events
        around the backend call on the current stream (which waits for
        NCCL's), synchronised here; on the CPU the host clock."""
        tracing.settle(s for _, s in self.spans)
        return [(r, s.ms()) for r, s in self.spans]


_RECORDS: Optional[CollectiveRecord] = None
_IN_RECOMPUTE = False


@contextlib.contextmanager
def record_collectives(timed: bool = False):
    """Within the block, every collective emitted through :func:`collective`
    (in this process, forward or backward) appends ``(label, col_type,
    dv_bytes, participants)`` to the :class:`CollectiveRecord` this
    yields, or to its ``.recompute`` inside :func:`recompute_region`.
    Participants-1 collectives are recorded too: they run (a copy in a
    one-rank group), but a declared schedule leaves them out.  With
    ``timed`` each collective is also timed (``CollectiveRecord.times``:
    two CUDA events a call on the card)."""
    global _RECORDS
    prev, _RECORDS = _RECORDS, CollectiveRecord(timed)
    try:
        yield _RECORDS
    finally:
        _RECORDS = prev


@contextlib.contextmanager
def recompute_region():
    """Marks the collectives of the block as a remat recompute's: they
    repeat forward collectives that the declared schedules count once
    (the JAX package counts them on the traced program, where
    ``jax.checkpoint`` adds none)."""
    global _IN_RECOMPUTE
    prev, _IN_RECOMPUTE = _IN_RECOMPUTE, True
    try:
        yield
    finally:
        _IN_RECOMPUTE = prev


def collective(col_type: str, label: str, x: torch.Tensor, group, *,
               op=dist.ReduceOp.SUM, dim: int = -1) -> torch.Tensor:
    """The one place this package emits a collective, over ``group``; the
    result is a new tensor.  ``AllReduce``: ``op`` over the whole tensor.
    ``AllGather``: the participants' tensors concatenated along ``dim``, in
    group-rank order.  ``ReduceScatter``: ``dim`` split into one block a
    participant, summed, this rank's block kept.  DV is recorded in the
    cost model's convention: the full tensor of an All-Reduce, the
    gathered result of an All-Gather, the full input of a Reduce-Scatter.
    A one-rank group's collective is the identity (the JAX package's
    one-participant ``psum``): it returns a copy, issues no call to the
    backend, and is recorded all the same.  A failed collective raises."""
    P = dist.get_world_size(group)
    x = x.contiguous()
    if col_type not in ("AllReduce", "AllGather", "ReduceScatter"):
        raise ValueError(f"unknown collective {col_type!r}")
    timed = _RECORDS is not None and _RECORDS.timed
    # no profiler range: the process group opens its own
    with tracing.span("collective/" + label, device=x.is_cuda, always=timed,
                      annotate=False) as sp:
        if P == 1:
            out = dv = x.clone()
        elif col_type == "AllReduce":
            out = x.clone()
            dist.all_reduce(out, op=op, group=group)
            dv = out
        elif col_type == "AllGather":
            parts = [torch.empty_like(x) for _ in range(P)]
            dist.all_gather(parts, x, group=group)
            out = dv = torch.cat(parts, dim=dim)
        else:
            if x.shape[dim] % P:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"split into {P} blocks")
            parts = [p.contiguous() for p in x.chunk(P, dim=dim)]
            out = torch.empty_like(parts[0])
            dist.reduce_scatter(out, parts, group=group)
            dv = x
    if _RECORDS is not None:
        rec = (label, col_type, float(dv.numel() * dv.element_size()), P)
        (_RECORDS.recompute if _IN_RECOMPUTE else _RECORDS).append(rec)
        if timed:
            _RECORDS.spans.append((rec, sp))
    return out


class _SumOver(torch.autograd.Function):
    """SUM All-Reduce; its transpose is again a SUM All-Reduce (of the
    cotangent, which the ranks hold as partial sums)."""

    @staticmethod
    def forward(ctx, x, group, label):
        ctx.group, ctx.label = group, label
        return collective("AllReduce", label, x, group)

    @staticmethod
    def backward(ctx, g):
        return collective("AllReduce", ctx.label, g, ctx.group), None, None


class _SumCotangent(torch.autograd.Function):
    """Identity forward for an input replicated over the group; its
    cotangent, partial on each rank, is SUM-All-Reduced."""

    @staticmethod
    def forward(ctx, x, group, label):
        ctx.group, ctx.label = group, label
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collective("AllReduce", ctx.label, g, ctx.group), None, None


class _GatherColumns(torch.autograd.Function):
    """All-Gather along ``dim``; its transpose is a Reduce-Scatter of the
    gathered cotangent, which the ranks hold as partial sums."""

    @staticmethod
    def forward(ctx, x, group, label, grad_label, dim):
        ctx.group, ctx.label, ctx.dim = group, grad_label, dim
        return collective("AllGather", label, x, group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (collective("ReduceScatter", ctx.label, g, ctx.group,
                           dim=ctx.dim), None, None, None, None)


class _GatherReplicated(torch.autograd.Function):
    """All-Gather along ``dim`` of a value whose every use is replicated
    over the group (the whole cotangent on every rank, Megatron's
    convention): its transpose is this rank's block of the cotangent, with
    no collective."""

    @staticmethod
    def forward(ctx, x, group, label, dim):
        ctx.rank, ctx.n, ctx.dim = dist.get_rank(group), x.shape[dim], dim
        return collective("AllGather", label, x, group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None


class _ScatterShards(torch.autograd.Function):
    """Reduce-Scatter along ``dim`` of the ranks' partial sums; its
    transpose is an All-Gather of the cotangent's blocks, whole on every
    rank after it."""

    @staticmethod
    def forward(ctx, x, group, label, dim):
        ctx.group, ctx.label, ctx.dim = group, label, dim
        return collective("ReduceScatter", label, x, group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (collective("AllGather", ctx.label, g, ctx.group,
                           dim=ctx.dim), None, None, None)


class _TakeBlock(torch.autograd.Function):
    """This rank's block along ``dim`` of a value replicated over the
    group, with no collective; its transpose is an All-Gather of the
    ranks' blocks of the cotangent."""

    @staticmethod
    def forward(ctx, x, group, label, dim):
        ctx.group, ctx.label, ctx.dim = group, label, dim
        n = x.shape[dim] // dist.get_world_size(group)
        return x.narrow(dim, dist.get_rank(group) * n, n).clone()

    @staticmethod
    def backward(ctx, g):
        return (collective("AllGather", ctx.label, g, ctx.group,
                           dim=ctx.dim), None, None, None)


class _EnterParallel(torch.autograd.Function):
    """Megatron's *f*: identity forward into a tensor-parallel region; the
    ranks' partial cotangents SUM-All-Reduced backward."""

    @staticmethod
    def forward(ctx, x, group, label):
        ctx.group, ctx.label = group, label
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collective("AllReduce", ctx.label, g, ctx.group), None, None


class _LeaveParallel(torch.autograd.Function):
    """Megatron's *g*: the ranks' partial outputs SUM-All-Reduced forward;
    the cotangent, whole on every rank, passes through backward."""

    @staticmethod
    def forward(ctx, x, group, label):
        return collective("AllReduce", label, x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SplitCotangent(torch.autograd.Function):
    """Identity forward for a value replicated on ``n`` ranks; each rank's
    cotangent is divided by ``n``, so that the ranks hold it as partial
    sums (what ``shard_map`` does to a replicated output's cotangent)."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def sum_over(x: torch.Tensor, group, label: str) -> torch.Tensor:
    """``psum``: SUM All-Reduce over ``group`` under autograd."""
    return _SumOver.apply(x, group, label)


def sum_cotangent(x: torch.Tensor, group, label: str) -> torch.Tensor:
    """``x`` as it is; its gradient SUM-All-Reduced over ``group``."""
    return _SumCotangent.apply(x, group, label)


def split_cotangent(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` as it is; its gradient divided by ``n`` (its replicas)."""
    return _SplitCotangent.apply(x, n)


def model_axis(mesh) -> Tuple[int, int, object]:
    """(size, this rank's index, process group) of ``mesh``'s ``model``
    axis."""
    return (mesh_axes(mesh)["model"], mesh.get_local_rank("model"),
            mesh.get_group("model"))


# the all-ranks groups of meshes over part of the world, by their ranks
_SUBMESH_GROUPS: Dict[Tuple[int, ...], dist.ProcessGroup] = {}
# each mesh's group over two data axes at this rank's coordinate, by the
# mesh's ranks, shape and names and the axes
_DATA_GROUPS: Dict[tuple, Optional[dist.ProcessGroup]] = {}


def make_submesh(ranks: Sequence[int], shape: Sequence[int],
                 axes: Sequence[str],
                 device: Optional[Union[str, torch.device]] = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ``ranks`` of the
    world (row-major), with its all-ranks group for :func:`mesh_group`.
    Every rank of the world calls it, in the same order, kept or not
    (``torch.distributed.new_group``'s rule); a rank outside ``ranks``
    gets the mesh with no coordinate."""
    from torch.distributed.device_mesh import DeviceMesh
    dev = resolve_device(device)
    ranks = tuple(int(r) for r in ranks)
    mesh = DeviceMesh(dev.type, torch.tensor(ranks).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))
    _SUBMESH_GROUPS[ranks] = dist.new_group(list(ranks))
    if len(dp_axes(mesh)) > 1:
        _new_data_groups(mesh, dp_axes(mesh))
    return mesh


def _mesh_ranks(mesh) -> np.ndarray:
    """The world ranks of ``mesh``'s coordinates, as numpy, read outside
    any ``FakeTensorMode`` of the caller (the dry run's), in which the
    mesh's own tensor would be made fake."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        return mesh.mesh.numpy().copy()


def mesh_group(mesh) -> dist.ProcessGroup:
    """The process group of all of ``mesh``'s ranks (every axis at once,
    such as the MoE router's gradient): the world's for a mesh over the
    whole world, else the one :func:`make_submesh` made."""
    ranks = tuple(int(r) for r in _mesh_ranks(mesh).reshape(-1))
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    if ranks not in _SUBMESH_GROUPS:
        raise ValueError(f"no all-ranks group for the mesh over {ranks}: "
                         f"build it with make_submesh")
    return _SUBMESH_GROUPS[ranks]


def _data_key(mesh, axes) -> tuple:
    return (tuple(int(r) for r in _mesh_ranks(mesh).reshape(-1)),
            tuple(mesh.mesh.shape), tuple(mesh.mesh_dim_names), axes)


def _new_data_groups(mesh, axes: Tuple[str, ...]) -> None:
    """Make the groups over ``axes`` of ``mesh``, one at each coordinate of
    the other axes, in row-major order (every rank of the world makes
    each, ``new_group``'s rule), and keep this rank's."""
    names = list(mesh.mesh_dim_names)
    keep = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in keep]
    n = int(np.prod([mesh.mesh.shape[i] for i in keep]))
    me, mine = dist.get_rank(), None
    for row in _mesh_ranks(mesh).transpose(rest + keep).reshape(
            -1, n).tolist():
        if row != sorted(row):
            # a group's ranks are in the order of their world ranks; the
            # blocks of a tensor split over the axes are in the mesh's
            raise ValueError(f"ranks {row} of the axes {axes} are not in "
                             f"the order of the world's")
        group = dist.new_group(row)
        if me in row:
            mine = group
    _DATA_GROUPS[_data_key(mesh, axes)] = mine


def data_group(mesh, axes: Optional[Sequence[str]] = None):
    """The process group over ``axes`` (default: the data axes,
    ``dp_axes``) at this rank's coordinate on the others: the axis's own
    group for one axis, None for none.  Two axes, ``(pod, data)``, are one
    group of ``pod x data`` ranks in row-major order, so that a tensor
    split over both (the batch, a ZeRO-1 moment) is gathered and reduced
    in one collective; it is made on first use, by every rank of a mesh
    over the whole world at once (as the SPMD step reaches it), or by
    :func:`make_submesh`, and kept until :func:`forget_mesh_groups`."""
    axes = dp_axes(mesh) if axes is None else tuple(axes)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = _data_key(mesh, axes)
    if key not in _DATA_GROUPS:
        if len(key[0]) != dist.get_world_size():
            raise ValueError(f"no group over {axes} for the mesh over "
                             f"{key[0]}: build it with make_submesh")
        _new_data_groups(mesh, axes)
    return _DATA_GROUPS[key]


def forget_mesh_groups() -> None:
    """Drop :func:`make_submesh`'s and :func:`data_group`'s groups, once
    the world that made them is destroyed."""
    _SUBMESH_GROUPS.clear()
    _DATA_GROUPS.clear()


def enter_parallel(x: torch.Tensor, group, label: str) -> torch.Tensor:
    """Megatron's *f* over ``group``: ``x`` as it is, its cotangent
    SUM-All-Reduced (one collective, backward)."""
    return _EnterParallel.apply(x, group, label)


def leave_parallel(x: torch.Tensor, group, label: str) -> torch.Tensor:
    """Megatron's *g* over ``group``: the partial ``x`` SUM-All-Reduced (one
    collective, forward); the cotangent passes through."""
    return _LeaveParallel.apply(x, group, label)


def gather_shards(x: torch.Tensor, group, label: str, grad_label: str, *,
                  dim: int = -1) -> torch.Tensor:
    """All-Gather of ``x``'s shards along ``dim`` under autograd; its
    transpose is a Reduce-Scatter of the cotangent, labelled
    ``grad_label``."""
    return _GatherColumns.apply(x, group, label, grad_label, dim)


def gather_replicated(x: torch.Tensor, group, label: str, *,
                      dim: int = -1) -> torch.Tensor:
    """All-Gather of ``x``'s shards along ``dim`` under autograd, for a
    result that every rank uses the same way (each holds the whole
    cotangent): its transpose is this rank's block of the cotangent, with
    no collective."""
    return _GatherReplicated.apply(x, group, label, dim)


def scatter_shards(x: torch.Tensor, group, label: str, *,
                   dim: int = -1) -> torch.Tensor:
    """Reduce-Scatter of the ranks' partial ``x`` along ``dim`` under
    autograd (this rank's block of the sum); its transpose is an
    All-Gather of the cotangent, labelled ``label`` too."""
    return _ScatterShards.apply(x, group, label, dim)


def take_block(x: torch.Tensor, group, label: str, *,
               dim: int = -1) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x``, which every rank of
    ``group`` holds whole, with no collective; its transpose is an
    All-Gather of the cotangent's blocks (``label``)."""
    return _TakeBlock.apply(x, group, label, dim)


def gather_param(x: torch.Tensor, mesh, name: str, dim: int, *,
                 reduced: bool = False) -> torch.Tensor:
    """A ZeRO-3 (``fsdp``) parameter's data slice ``x`` gathered whole over
    the data axes (:func:`data_group`) along ``dim`` under autograd,
    labelled ``params/<name>`` as ``train_collective_schedule`` declares
    it.  Its transpose Reduce-Scatters the gradient, which each rank holds
    as its rows' partial sum (``grads/<name>``), and keeps the rank's
    block.  ``reduced``: the step sums this leaf's gradient over the data
    axes itself (the MoE layer's router and experts, the planner loss's
    unembed), so the transpose takes the rank's block of it, with no
    collective."""
    group = data_group(mesh)
    if reduced:
        return gather_replicated(x, group, "params/" + name, dim=dim)
    return gather_shards(x, group, "params/" + name, "grads/" + name,
                         dim=dim)


# the All-Gather of the residual's rows at a block's entry under seq_shard
SEQ_GATHER = "tp/seq-gather"


def enter_region(x: torch.Tensor, group, label: str, *, partial: bool,
                 seq: Optional[str] = None) -> torch.Tensor:
    """``x`` on its way into a tensor-parallel block over ``group`` (the
    ``model`` axis).  ``partial``: the block's output is a partial sum over
    the ranks (its weights split), so the cotangent of its input is one
    too; otherwise every rank computes the whole output.  ``seq``: None,
    the residual is whole on every rank (Megatron's *f*, ``label``, where
    the block is partial, else ``x`` as it is); "rows", ``x`` is this
    rank's block of the sequence (dim 1, ``seq_shard``): the rows are
    All-Gathered (``tp/seq-gather``), transposed to a Reduce-Scatter of
    the partial cotangent, or to this rank's block of a whole one;
    "gathered", the caller gathered them already."""
    if seq == "gathered":
        return x
    if seq == "rows":
        if partial:
            return gather_shards(x, group, SEQ_GATHER, SEQ_GATHER, dim=1)
        return gather_replicated(x, group, SEQ_GATHER, dim=1)
    return enter_parallel(x, group, label) if partial else x


def leave_region(y: torch.Tensor, group, label: str, *, partial: bool,
                 seq: Optional[str] = None) -> torch.Tensor:
    """A tensor-parallel block's output ``y`` (B, S, d) on its way back to
    the residual: with ``seq`` None, Megatron's *g* (``label``) where it is
    partial, else as it is; with ``seq`` (the residual split over the
    sequence), this rank's rows: a Reduce-Scatter of the partial sums
    (``label``; transposed to an All-Gather), or the rank's block of a
    whole output (transposed to an All-Gather)."""
    if seq:
        if partial:
            return scatter_shards(y, group, label, dim=1)
        return take_block(y, group, label, dim=1)
    return leave_parallel(y, group, label) if partial else y


def _mask_pad(lg: torch.Tensor, v0: int, real_vocab: int) -> torch.Tensor:
    idx = v0 + torch.arange(lg.shape[-1], device=lg.device)
    return lg.masked_fill(idx[None, :] >= real_vocab, -1e30)


def sharded_softmax_xent(h: torch.Tensor, unembed: torch.Tensor,
                         labels: torch.Tensor, mesh, *, real_vocab: int,
                         strategy: str = "auto",
                         vocab: Optional[int] = None,
                         zero3_dim: Optional[int] = None) -> torch.Tensor:
    """Cross-entropy over vocab-sharded logits with explicit collectives,
    called on every rank of ``mesh`` (a ``DeviceMesh`` with a ``model``
    axis and the data axes, ``data`` or ``(pod, data)``, or none).

    This rank's shards: h (B_l, S, D), its rows of the batch, replicated
    over ``model``; unembed (D, Vp / P), its block of the padded vocab
    (P = the ``model`` axis's size), replicated over the data axes; labels
    (B_l, S).  Given the padded ``vocab``, an unembed that is whole on
    every rank (``tensor_parallel=False``) is cut to the rank's block here,
    with no collective (its transpose All-Gathers the blocks of the
    cotangent, ``xent/unembed-block``), as the JAX ``shard_map`` slices a
    replicated input.  Under ZeRO-3 (``zero3_dim``) the unembed is the
    rank's data slice of that, split along ``zero3_dim``: it is gathered
    first (:func:`gather_param`, ``params/unembed``), its transpose the
    rank's block of the cotangent that ``xent/unembed-grad`` summed.
    Returns the scalar mean NLL over the whole batch,
    the same on every rank.  'dist' computes the global max/logsumexp via
    All-Reduces of per-shard statistics (the paper's distSM); 'gather'
    All-Gathers the f32 logit shards and computes locally (the paper's
    SM).  'auto' asks the COMET planner with this rank's rows.

    Gradients follow ``shard_map``'s transpose rules, so the backward
    pass emits the loss's collectives that ``train_collective_schedule``
    declares: each SUM All-Reduce transposes to a SUM All-Reduce, the
    All-Gather to a Reduce-Scatter; h's cotangent is SUM-All-Reduced over
    ``model`` and the unembed's over the data axes (each enters
    replicated there; the data axes as one group, :func:`data_group`);
    the row max is gradient-free (its MAX All-Reduce has no transpose);
    the loss's cotangent is split over its replicas.  The forward pass
    emits exactly ``softmax_collective_schedule``'s collectives, and the
    participants-1 ones that it leaves out.
    """
    B, S, D = h.shape
    dp = dp_axes(mesh)
    P_model = mesh_axes(mesh)["model"]
    g_model = mesh.get_group("model")
    if zero3_dim is not None:
        unembed = gather_param(unembed, mesh, "unembed", zero3_dim,
                               reduced=True)
    if vocab is not None and P_model > 1 and unembed.shape[1] == vocab:
        unembed = take_block(unembed, g_model, "xent/unembed-block")
    v_local = unembed.shape[1]
    Vp = v_local * P_model
    if strategy == "auto":
        strategy = plan_softmax_strategy(B * S, Vp, P_model)
    if strategy not in ("dist", "gather"):
        raise ValueError(f"unknown softmax strategy {strategy!r}")
    g_dp = data_group(mesh)
    v0 = mesh.get_local_rank("model") * v_local

    h = sum_cotangent(h, g_model, "xent/hidden-cotangent")
    if dp:
        unembed = sum_cotangent(unembed, g_dp, "xent/unembed-grad")
    lg = (h.reshape(-1, D) @ unembed).to(F32)                 # (T_l, V_l)
    y = labels.reshape(-1).long()
    if strategy == "dist":
        lg = _mask_pad(lg, v0, real_vocab)
        # stability max is gradient-free (MAX has no transpose; the exact
        # gradient flows through the logsumexp below regardless of m)
        with torch.no_grad():
            m = collective("AllReduce", "xent/stats", lg.max(-1).values,
                           g_model, op=dist.ReduceOp.MAX)        # CO_1^0
        e = torch.exp(lg - m[:, None])
        s = sum_over(e.sum(-1), g_model, "xent/stats")        # CO_1^1: AR(add)
        in_shard = (y >= v0) & (y < v0 + v_local)
        safe = torch.clamp(y - v0, 0, v_local - 1)
        ll_local = torch.where(in_shard, lg.gather(1, safe[:, None])[:, 0],
                               0.0)
        ll = sum_over(ll_local, g_model, "xent/stats")
    else:
        lg_full = gather_shards(lg, g_model, "xent/logit-gather",
                                "xent/logit-gather-grad")
        lg_full = _mask_pad(lg_full, 0, real_vocab)
        m = lg_full.max(-1).values
        s = torch.exp(lg_full - m[:, None]).sum(-1)
        ll = lg_full.gather(1, y[:, None])[:, 0]
    nll = (torch.log(s) + m - ll).sum()
    if dp:
        total = collective("AllReduce", "xent/loss-norm",
                           torch.tensor(float(y.shape[0]), dtype=F32,
                                        device=lg.device), g_dp)
        loss = sum_over(nll, g_dp, "xent/loss-norm") / total
    else:
        loss = nll / y.shape[0]
    return split_cotangent(loss, dp_size(mesh) * P_model)


# ---------------------------------------------------------------------------
# Declared train-step collective schedule.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DeclaredCollective:
    """One declared collective of the train step.

    ``dv_bytes`` is the per-occurrence logical data volume in the cost
    model's convention (full tensor for All-Reduce, gathered result for
    All-Gather, full input for Reduce-Scatter) — the same convention
    :func:`collective` records, so declared and emitted entries compare
    directly.  ``origin`` partitions the schedule into the two
    audit regimes:

    * ``"explicit"`` — emitted by our shard_map bodies (softmax-xent, MoE
      combine) and their AD transposes.  These appear as collective
      primitives in the traced jaxpr and the contract checker asserts
      exact (type, participants, count, DV) equality.
    * ``"gspmd"`` — left to XLA's sharding propagation (data-axis grad
      all-reduces, tensor-parallel activation reductions in attention and
      the dense FFN).  Invisible in the jaxpr by construction; they are
      priced by the cost model and reconciled against the compiled HLO
      (the JAX package's ``analysis/reconcile.py``), not jaxpr-audited.
    """

    label: str
    col_type: str
    dv_bytes: float
    participants: int
    count: float
    origin: str = "explicit"

    def to_dict(self) -> dict:
        return {"label": self.label, "type": self.col_type,
                "dv_bytes": self.dv_bytes, "participants": self.participants,
                "count": self.count, "origin": self.origin}


def _dp_axes_size(mesh):
    return dp_axes(mesh), dp_size(mesh)


def _flatten_sorted(tree, path=()):
    """(key path, leaf) of a nested dict in sorted key order, the order
    in which the JAX package flattens a parameter tree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten_sorted(tree[k], path + (k,))]
    return [(path, tree)]


def _itemsize(dtype) -> int:
    """Bytes of one element of a dtype name or a torch dtype."""
    return (torch_dtype(dtype) if isinstance(dtype, str) else dtype).itemsize


def train_collective_schedule(cfg, mesh, batch: int, seq: int, *,
                              microbatches: int = 1, params=None,
                              planner_loss: bool = True):
    """The DECLARED per-layer collective schedule of one planner-loss
    training step — the single source of truth that the cost model prices
    (:func:`price_collective_schedule`) and the static contract checker
    (the JAX package's ``analysis/contracts.py`` train arm) audits against
    the traced jaxpr and, through ``analysis/reconcile.py``, against the
    compiled HLO.  If ``make_train_step``'s implementation gains or loses a
    collective, this declaration must change with it or the audit fails.

    The explicit entries encode the empirically pinned shard_map AD rules
    (regression-tested in the JAX package's tests):

    * every differentiable forward ``psum`` appears twice in the traced
      grad jaxpr — the forward op plus its transpose, which is again a
      psum of the same shape (``pmax`` under ``stop_gradient`` has no
      transpose);
    * an ``all_gather`` transposes to one ``reduce_scatter`` of the full
      gathered cotangent;
    * every shard_map *input* that is replicated over a mesh-axis set A
      (its in_spec leaves A unmentioned) and lies on the differentiation
      path contributes one cotangent ``psum`` over A, sized as the local
      operand (sharded inputs instead get a trivial ``psum(axes=())``
      which the audit ignores as participants == 1);
    * ``jax.checkpoint``/remat does NOT change traced collective counts;
      ``lax.scan`` multiplies its body counts by the trip count.

    Returns a list of :class:`DeclaredCollective`.  ``params`` is the
    parameter tree (tensors, or the ``ParamSpec`` tree) used to size the
    data-axis gradient all-reduces; when None it is ``Model(cfg).specs``.
    ``mesh`` is a ``DeviceMesh`` or a ``sharding.MeshShape``.  The port's
    copy returns the JAX package's list entry for entry; the port's
    autograd collectives of the loss follow the rules above (see
    :func:`sharded_softmax_xent`).
    """
    if params is None:
        from ..models.model import Model
        params = Model(cfg).specs

    dp, P_dp = _dp_axes_size(mesh)
    P_m = mesh_axes(mesh).get("model", 1)
    dtype_b = _itemsize(cfg.dtype)
    D = cfg.d_model
    Vp = cfg.padded_vocab
    v_local = Vp // max(P_m, 1)
    m = int(microbatches)
    b = batch // m                       # per-microbatch global batch
    B_local = b // max(P_dp, 1)
    rows = B_local * seq                 # local token rows per microbatch
    sched = []

    # ---- softmax-xent (explicit; composes softmax_collective_schedule's
    #      forward declaration with its AD transposes) -------------------
    if planner_loss and not cfg.tie_embeddings and not cfg.is_encdec:
        strategy = cfg.softmax_strategy
        if strategy in ("auto", "gspmd"):
            strategy = plan_softmax_strategy(rows, Vp, P_m)
        if P_m > 1:
            if strategy == "dist":
                # fwd: pmax + 2 psums (softmax_collective_schedule);
                # bwd: the 2 psums transpose, pmax is stop_gradient'd.
                sched.append(DeclaredCollective(
                    "xent/stats", "AllReduce", rows * 4.0, P_m, 5 * m))
            else:
                sched.append(DeclaredCollective(
                    "xent/logit-gather", "AllGather",
                    rows * Vp * 4.0, P_m, 1 * m))
                sched.append(DeclaredCollective(
                    "xent/logit-gather-grad", "ReduceScatter",
                    rows * Vp * 4.0, P_m, 1 * m))
            # h enters the shard_map replicated over 'model' -> one
            # cotangent psum of the local (B_local, S, D) activation.
            sched.append(DeclaredCollective(
                "xent/hidden-cotangent", "AllReduce",
                B_local * seq * D * dtype_b, P_m, 1 * m))
        if P_dp > 1:
            # fwd: token-count + nll psums; bwd: nll transpose (the token
            # count is constant under AD, so no fourth op).
            sched.append(DeclaredCollective(
                "xent/loss-norm", "AllReduce", 4.0, P_dp, 3 * m))
            # unembed enters replicated over dp -> cotangent psum of the
            # local (D, Vp/P_m) shard.
            sched.append(DeclaredCollective(
                "xent/unembed-grad", "AllReduce",
                D * v_local * dtype_b, P_dp, 1 * m))

    # ---- MoE combine + expert/router grads (explicit) ------------------
    n_moe = (cfg.n_layers - cfg.first_dense_layers) if cfg.is_moe else 0
    if n_moe and P_m > 1:
        E = cfg.n_experts
        e_local = E // P_m
        f = cfg.moe_d_ff
        t_local = (b * seq) // max(P_dp, 1)
        # combine psum (fwd) + its transpose + the x cotangent psum
        # (x enters replicated over 'model'): the checked realization of
        # the "no token all-to-all" claim in models/moe.py.
        sched.append(DeclaredCollective(
            "moe/combine", "AllReduce",
            t_local * D * dtype_b, P_m, 3 * n_moe * m))
        if P_dp > 1:
            # wi/wg/wo enter sharded over 'model', replicated over dp ->
            # one cotangent psum each of the local (e_local, d, f) shard.
            sched.append(DeclaredCollective(
                "moe/expert-grad", "AllReduce",
                e_local * D * f * dtype_b, P_dp, 3 * n_moe * m))
        if P_dp * P_m > 1:
            # router enters fully replicated -> cotangent psum over ALL
            # mesh axes (f32 by spec).
            sched.append(DeclaredCollective(
                "moe/router-grad", "AllReduce",
                D * E * 4.0, P_dp * P_m, 1 * n_moe * m))
            if cfg.router_type == "sigmoid":
                sched.append(DeclaredCollective(
                    "moe/router-bias-grad", "AllReduce",
                    E * 4.0, P_dp * P_m, 1 * n_moe * m))

    # ---- GSPMD-owned collectives (priced + HLO-reconciled only) --------
    # Data-axis gradient all-reduces, sized from the real param tree.
    # Leaves whose gradients are already reduced by an explicit cotangent
    # psum above (unembed under the planner loss, the MoE expert stack)
    # are excluded — declaring them twice would double-charge.
    if P_dp > 1:
        explicit = []
        if planner_loss and not cfg.tie_embeddings and not cfg.is_encdec:
            explicit.append("unembed")
        if n_moe and P_m > 1:
            explicit.append("moe")
        rs = bool(cfg.fsdp)
        for keys, leaf in _flatten_sorted(params):
            if any(k in explicit for k in keys):
                continue
            nbytes = float(np.prod(leaf.shape)) * _itemsize(leaf.dtype)
            sched.append(DeclaredCollective(
                "grads/" + ".".join(keys),
                "ReduceScatter" if rs else "AllReduce",
                nbytes, P_dp, 1, origin="gspmd"))
            if rs:  # ZeRO-3: fwd + bwd param regathers
                sched.append(DeclaredCollective(
                    "params/" + ".".join(keys), "AllGather",
                    nbytes, P_dp, 2, origin="gspmd"))
    # Tensor-parallel activation reductions: one AR after the attention
    # out-projection and one after the dense-FFN down-projection, forward
    # and backward (Megatron f/g) — the MoE FFN's reduction is the
    # explicit combine psum above.
    if cfg.tensor_parallel and P_m > 1:
        act = B_local * seq * D * dtype_b
        sched.append(DeclaredCollective(
            "tp/attn-out", "AllReduce", act, P_m,
            2 * cfg.n_layers * m, origin="gspmd"))
        n_dense_ffn = cfg.n_layers - n_moe
        if n_dense_ffn:
            sched.append(DeclaredCollective(
                "tp/ffn-out", "AllReduce", act, P_m,
                2 * n_dense_ffn * m, origin="gspmd"))
    return sched


def price_collective_schedule(schedule, noc=None) -> float:
    """COMET Eq. 3/4 latency of a declared schedule (seconds)."""
    if noc is None:
        noc = tpu_v5e().cluster_noc
    total = 0.0
    for d in schedule:
        if d.participants <= 1:
            continue
        cc = collective_cost(d.col_type, d.dv_bytes, d.participants, noc)
        total += d.count * (cc.volume_bytes / noc.channel_bandwidth
                            + noc_latency(cc, noc))
    return total
