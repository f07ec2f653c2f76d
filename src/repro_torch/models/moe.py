"""Mixture-of-Experts FFN: top-k routing, capacity-bounded dispatch in token
order (GShard-style dropping), the expert SwiGLU FFNs as batched products,
and the gate-weighted combine.

Port of ``repro/models/moe.py``.  Without a mesh every expert is local.
On a ``(data, model)`` mesh the experts are split over ``model`` (the JAX
package's ``shard_map``): each rank routes its rows of tokens with the
replicated router, runs its ``E / m`` experts at the capacity of its own
token count, and the partial outputs are SUM-All-Reduced over ``model``
(``moe/combine``), with ``shard_map``'s transpose rules for the
gradients (see :func:`moe_apply`).  Shared experts are tensor-parallel
over ``ff`` (Megatron's *f* and *g*, ``moe/shared-out``), or whole where
``ff`` does not split.  The data axes, ``data`` or ``(pod, data)``, are
one group (``collective_planner.data_group``).  With
``tensor_parallel=False`` the expert stack is whole on every rank and
each rank cuts its ``E / m`` experts from it, as the JAX ``shard_map``
slices a replicated input.  Under ``seq_shard`` (``seq=``) the layer
gathers the rows of the sequence in and Reduce-Scatters them out.

Routing: softmax top-k over the selected logits (Qwen3-style, renormalized)
or sigmoid + bias (DeepSeek-V3 aux-free: the bias picks the experts, the
unbiased scores weight them) per ``cfg.router_type``.  The router's matmul
runs in f32; on the card TF32 must be off for it to pick the experts the
plain path picks.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.collective_planner import (data_group, enter_region,
                                           leave_region, mesh_group,
                                           model_axis, split_cotangent,
                                           sum_cotangent, sum_over,
                                           take_block)
from ..parallel.sharding import split_over
from .config import ModelConfig
from .param import ParamSpec

F32 = torch.float32

__all__ = ["moe_specs", "moe_apply", "moe_local", "router_weights",
           "capacity", "slot_positions", "MESH_REDUCED", "reduced_on_mesh"]

# the leaves whose gradients moe_apply reduces itself on a mesh
# (moe/expert-grad, moe/router-grad, moe/router-bias-grad)
MESH_REDUCED = ("router", "router_bias", "wi", "wg", "wo")


def reduced_on_mesh(keys) -> bool:
    """Whether the param at key path ``keys`` is one of an MoE layer's
    :data:`MESH_REDUCED` leaves, whose gradient :func:`moe_apply` sums
    over the data axes itself on a mesh."""
    return len(keys) >= 2 and keys[-2] == "moe" and keys[-1] in MESH_REDUCED


def moe_specs(cfg: ModelConfig, L: int) -> Dict[str, ParamSpec]:
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    s = {
        "router": ParamSpec((L, d, E), ("layer", "embed", None), dtype="float32"),
        "wi": ParamSpec((L, E, d, f), ("layer", "experts", "embed", None), dtype=cfg.dtype),
        "wg": ParamSpec((L, E, d, f), ("layer", "experts", "embed", None), dtype=cfg.dtype),
        "wo": ParamSpec((L, E, f, d), ("layer", "experts", None, "embed"), dtype=cfg.dtype),
    }
    if cfg.router_type == "sigmoid":
        s["router_bias"] = ParamSpec((L, E), ("layer", None), init="zeros",
                                     dtype="float32")
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        s["shared_wi"] = ParamSpec((L, d, fs), ("layer", "embed", "ff"), dtype=cfg.dtype)
        s["shared_wg"] = ParamSpec((L, d, fs), ("layer", "embed", "ff"), dtype=cfg.dtype)
        s["shared_wo"] = ParamSpec((L, fs, d), ("layer", "ff", "embed"), dtype=cfg.dtype)
    return s


class _PicksOnly(torch.autograd.Function):
    """``scores`` as they are, with the router's bias carried along: the
    bias only picks experts, so its cotangent is zero, as in the JAX
    package; keeping it on the differentiation path lets that zero
    cotangent reach the bias's All-Reduce on a mesh
    (``moe/router-bias-grad``), as the JAX transpose of a replicated
    ``shard_map`` input issues it."""

    @staticmethod
    def forward(ctx, scores, bias):
        ctx.bias = (bias.shape, bias.dtype)
        return scores.view_as(scores)

    @staticmethod
    def backward(ctx, g):
        shape, dtype = ctx.bias
        return g, g.new_zeros(shape, dtype=dtype)


def router_weights(cfg: ModelConfig, p: Dict, x2d: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gates (T, k) f32, idx (T, k) int64), experts in descending score
    order as ``jax.lax.top_k`` gives them."""
    logits = x2d.to(F32) @ p["router"].to(F32)
    if cfg.router_type == "sigmoid":
        scores = _PicksOnly.apply(torch.sigmoid(logits), p["router_bias"])
        sel = scores + p["router_bias"].to(F32)       # bias only for routing
        idx = torch.topk(sel, cfg.top_k, dim=-1).indices
        gates = torch.gather(scores, -1, idx)
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    else:
        top, idx = torch.topk(logits, cfg.top_k, dim=-1)
        gates = torch.softmax(top, dim=-1)            # over the selected
    return gates, idx


def capacity(cfg: ModelConfig, T: int) -> int:
    """Slots an expert takes for T tokens: the expected load times the
    capacity factor (truncated), never below min(T, 32), so that small
    token counts (decode steps, smoke tests) drop nothing."""
    return max(int(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor),
               min(T, 32))


def slot_positions(cfg: ModelConfig, idx: torch.Tensor) -> torch.Tensor:
    """(T * k,) position of each (token, choice) assignment within its
    expert's slots, in token order (a stable sort by expert); an
    assignment at ``capacity`` or beyond is dropped."""
    flat_e = idx.reshape(-1)
    dev = idx.device
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(cfg.n_experts, device=dev, dtype=flat_e.dtype))
    pos_sorted = torch.arange(flat_e.numel(), device=dev) \
        - seg_start[sorted_e]
    return torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)


def moe_local(cfg: ModelConfig, x2d: torch.Tensor, gates: torch.Tensor,
              idx: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
              wo: torch.Tensor, e_offset: int, e_local: int,
              capacity: int) -> torch.Tensor:
    """The contribution of experts [e_offset, e_offset + e_local) to tokens
    x2d (T, d).  wi/wg: (e_local, d, f); wo: (e_local, f, d).

    Each (token, choice) assignment takes the next slot of its expert in
    token order (a stable sort by expert); those past ``capacity`` are
    dropped.  The dispatch writes each kept assignment's token into its
    own slot, (e_local * capacity + 1 overflow row, d), so it is a set, not
    an accumulation.  The combine sums each token's k gate-weighted
    contributions in choice order, the same on every run (a scatter-add
    would add them in an order that varies on the card)."""
    T, d = x2d.shape
    k = idx.shape[1]
    dev = x2d.device
    flat_e = idx.reshape(-1)                              # (T*k,)
    flat_g = gates.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    pos = slot_positions(cfg, idx)

    local = (flat_e >= e_offset) & (flat_e < e_offset + e_local) \
        & (pos < capacity)
    slot = torch.where(local, (flat_e - e_offset) * capacity + pos,
                       e_local * capacity)

    # dispatch: every kept slot set once; the overflow row takes zeros only
    src = torch.where(local[:, None], x2d[flat_t], 0)
    buf = torch.zeros((e_local * capacity + 1, d), dtype=x2d.dtype,
                      device=dev).index_copy_(0, slot, src)
    xe = buf[:-1].reshape(e_local, capacity, d)

    h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wi)
    ye = torch.bmm(h, wo).reshape(e_local * capacity, d)
    ye = torch.cat([ye, ye.new_zeros((1, d))], 0)

    # combine: gate-weighted, each token's k contributions summed in order
    contrib = ye[slot] * torch.where(local, flat_g, 0.0)[:, None].to(ye.dtype)
    return contrib.view(T, k, d).sum(1)


def _shared_ffn(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                mesh=None, seq=None) -> torch.Tensor:
    """The shared experts' SwiGLU of x (B, S, d).  On a mesh where their
    ``ff`` splits, this rank's columns and rows give a partial product,
    SUM-All-Reduced over ``model`` (*f* before, *g* after, both
    ``moe/shared-out``; with ``seq`` the rows gathered in and
    Reduce-Scattered out); otherwise the weights are whole and so is the
    product."""
    def ffn(v):
        return (F.silu(v @ p["shared_wg"]) * (v @ p["shared_wi"])) \
            @ p["shared_wo"]
    if mesh is None:
        return ffn(x)
    m, _, group = model_axis(mesh)
    partial = split_over(p["shared_wi"].shape[-1],
                         cfg.moe_d_ff * cfg.n_shared_experts, m)
    x = enter_region(x, group, "moe/shared-out", partial=partial, seq=seq)
    return leave_region(ffn(x), group, "moe/shared-out", partial=partial,
                        seq=seq)


def moe_apply(cfg: ModelConfig, p: Dict, x: torch.Tensor,
              mesh: Optional[object] = None, seq=None) -> torch.Tensor:
    """MoE FFN.  x: (B, S, d).  Without a mesh every expert is on x's
    device.  On a mesh, x is this rank's rows (replicated over ``model``)
    and ``wi``/``wg``/``wo`` its ``E / m`` experts, from expert ``r * E /
    m`` (cut here from the whole stack where it is not split); the
    capacity is that of the rank's ``B * S`` tokens, as the JAX package's
    ``_cap(t_local)``.  The collectives follow ``shard_map``'s transpose
    rules, as ``train_collective_schedule`` declares them:
    ``moe/combine`` three times a layer (the forward SUM, its transpose,
    and x's cotangent, since x enters replicated over ``model``);
    ``moe/expert-grad`` over the data axes for each expert weight
    (replicated there); ``moe/router-grad`` (and
    ``moe/router-bias-grad``) over every axis of the mesh.  With ``seq``
    ("rows": x is this rank's block of the sequence) the rows are
    gathered in (``tp/seq-gather``, its transpose a Reduce-Scatter of x's
    partial cotangent) and the output's Reduce-Scattered out
    (``moe/combine``, its transpose an All-Gather); the shared experts
    gather and scatter their own (:func:`_shared_ffn`)."""
    E = cfg.n_experts
    if mesh is None:
        B, S, d = x.shape
        x2d = x.reshape(B * S, d)
        gates, idx = router_weights(cfg, p, x2d)
        out = moe_local(cfg, x2d, gates, idx, p["wi"], p["wg"], p["wo"], 0,
                        E, capacity(cfg, B * S)).reshape(B, S, d)
        if cfg.n_shared_experts:
            out = out + _shared_ffn(cfg, p, x)
        return out

    m, r, g_model = model_axis(mesh)
    if E % m:
        raise ValueError(f"{E} experts do not split over {m} model ranks")
    e_local = E // m
    g_data = data_group(mesh)
    g_all = mesh_group(mesh)
    pp = {"router": sum_cotangent(p["router"], g_all, "moe/router-grad")}
    if cfg.router_type == "sigmoid":
        pp["router_bias"] = sum_cotangent(p["router_bias"], g_all,
                                          "moe/router-bias-grad")
    w = {k: p[k] for k in ("wi", "wg", "wo")}
    if not split_over(w["wi"].shape[0], E, m):
        w = {k: take_block(v, g_model, "moe/expert-block", dim=0)
             for k, v in w.items()}
    if g_data is not None:
        w = {k: sum_cotangent(v, g_data, "moe/expert-grad")
             for k, v in w.items()}
    if seq:
        x_l = enter_region(x, g_model, "moe/combine", partial=True, seq=seq)
        B, S, d = x_l.shape
        x_l = x_l.reshape(B * S, d)
    else:
        B, S, d = x.shape
        x_l = sum_cotangent(x.reshape(B * S, d), g_model, "moe/combine")
    gates, idx = router_weights(cfg, pp, x_l)
    y = moe_local(cfg, x_l, gates, idx, w["wi"], w["wg"], w["wo"],
                  r * e_local, e_local, capacity(cfg, B * S)).reshape(B, S, d)
    if seq:
        out = leave_region(y, g_model, "moe/combine", partial=True, seq=seq)
    else:
        out = split_cotangent(sum_over(y, g_model, "moe/combine"), m)
    if cfg.n_shared_experts:
        out = out + _shared_ffn(cfg, p, x, mesh, seq)
    return out
