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

Every collective goes through :func:`collective`, which
:func:`record_collectives` can count.
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.collectives import collective_cost, noc_latency
from ..core.hardware import tpu_v5e
from ..models.param import torch_dtype
from .sharding import dp_axes, dp_size, mesh_axes

F32 = torch.float32

__all__ = ["softmax_collective_schedule", "plan_softmax_strategy",
           "sharded_softmax_xent", "DeclaredCollective",
           "train_collective_schedule", "price_collective_schedule",
           "collective", "record_collectives", "sum_over", "sum_cotangent",
           "split_cotangent"]


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

_RECORDS: Optional[List[Tuple[str, str, float, int]]] = None


@contextlib.contextmanager
def record_collectives():
    """Within the block, every collective emitted through :func:`collective`
    (in this process, forward or backward) appends ``(label, col_type,
    dv_bytes, participants)`` to the list this yields.  Participants-1
    collectives are recorded too: they run (a copy in a one-rank group),
    but a declared schedule leaves them out."""
    global _RECORDS
    prev, _RECORDS = _RECORDS, []
    try:
        yield _RECORDS
    finally:
        _RECORDS = prev


def collective(col_type: str, label: str, x: torch.Tensor, group, *,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The one place this package emits a collective, over ``group``; the
    result is a new tensor.  ``AllReduce``: ``op`` over the whole tensor.
    ``AllGather``: the participants' tensors concatenated along the last
    dim, in group-rank order.  ``ReduceScatter``: the last dim split into
    one block a participant, summed, this rank's block kept.  DV is
    recorded in the cost model's convention: the full tensor of an
    All-Reduce, the gathered result of an All-Gather, the full input of a
    Reduce-Scatter.  A failed collective raises."""
    P = dist.get_world_size(group)
    x = x.contiguous()
    if col_type == "AllReduce":
        out = x.clone()
        dist.all_reduce(out, op=op, group=group)
        dv = out
    elif col_type == "AllGather":
        parts = [torch.empty_like(x) for _ in range(P)]
        dist.all_gather(parts, x, group=group)
        out = dv = torch.cat(parts, dim=-1)
    elif col_type == "ReduceScatter":
        if x.shape[-1] % P:
            raise ValueError(f"last dim of {tuple(x.shape)} does not split "
                             f"into {P} blocks")
        parts = [p.contiguous() for p in x.chunk(P, dim=-1)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=group)
        dv = x
    else:
        raise ValueError(f"unknown collective {col_type!r}")
    if _RECORDS is not None:
        _RECORDS.append((label, col_type,
                         float(dv.numel() * dv.element_size()), P))
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
    """All-Gather along the last dim; its transpose is a Reduce-Scatter of
    the gathered cotangent."""

    @staticmethod
    def forward(ctx, x, group, label):
        ctx.group, ctx.label = group, label
        return collective("AllGather", label, x, group)

    @staticmethod
    def backward(ctx, g):
        return (collective("ReduceScatter", ctx.label + "-grad", g,
                           ctx.group), None, None)


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


def _mask_pad(lg: torch.Tensor, v0: int, real_vocab: int) -> torch.Tensor:
    idx = v0 + torch.arange(lg.shape[-1], device=lg.device)
    return lg.masked_fill(idx[None, :] >= real_vocab, -1e30)


def sharded_softmax_xent(h: torch.Tensor, unembed: torch.Tensor,
                         labels: torch.Tensor, mesh, *, real_vocab: int,
                         strategy: str = "auto") -> torch.Tensor:
    """Cross-entropy over vocab-sharded logits with explicit collectives,
    called on every rank of ``mesh`` (a ``DeviceMesh`` with a ``model``
    axis and at most one data axis).

    This rank's shards: h (B_l, S, D), its rows of the batch, replicated
    over ``model``; unembed (D, Vp / P), its block of the padded vocab
    (P = the ``model`` axis's size), replicated over the data axis; labels
    (B_l, S).  Returns the scalar mean NLL over the whole batch, the same
    on every rank.  'dist' computes the global max/logsumexp via
    All-Reduces of per-shard statistics (the paper's distSM); 'gather'
    All-Gathers the f32 logit shards and computes locally (the paper's
    SM).  'auto' asks the COMET planner.

    Gradients follow ``shard_map``'s transpose rules, so the backward
    pass emits the loss's collectives that ``train_collective_schedule``
    declares: each SUM All-Reduce transposes to a SUM All-Reduce, the
    All-Gather to a Reduce-Scatter; h's cotangent is SUM-All-Reduced over
    ``model`` and the unembed's over the data axis (each enters
    replicated there); the row max is gradient-free (its MAX All-Reduce
    has no transpose); the loss's cotangent is split over its replicas.
    The forward pass emits exactly ``softmax_collective_schedule``'s
    collectives, and the participants-1 ones that it leaves out.
    """
    B, S, D = h.shape
    v_local = unembed.shape[1]
    dp = dp_axes(mesh)
    if len(dp) > 1:
        raise NotImplementedError(
            "sharded_softmax_xent over two data axes (pod, data) is not "
            "ported: ROADMAP A.5, slice 13")
    P_model = mesh_axes(mesh)["model"]
    Vp = v_local * P_model
    if strategy == "auto":
        strategy = plan_softmax_strategy(B * S, Vp, P_model)
    if strategy not in ("dist", "gather"):
        raise ValueError(f"unknown softmax strategy {strategy!r}")
    g_model = mesh.get_group("model")
    g_dp = mesh.get_group(dp[0]) if dp else None
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
        lg_full = _GatherColumns.apply(lg, g_model, "xent/logit-gather")
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
