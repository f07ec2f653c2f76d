"""Mixture-of-Experts FFN: top-k routing, capacity-bounded dispatch in token
order (GShard-style dropping), the expert SwiGLU FFNs as batched products,
and the gate-weighted combine.

Port of ``repro/models/moe.py`` on one device: every expert is local.
Expert parallelism over a mesh (the JAX package's ``shard_map`` with one
``psum``) is not ported yet; ``moe_apply(mesh=...)`` raises.

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

from .config import ModelConfig
from .param import ParamSpec

F32 = torch.float32

__all__ = ["moe_specs", "moe_apply", "moe_local", "router_weights",
           "capacity"]


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


def router_weights(cfg: ModelConfig, p: Dict, x2d: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gates (T, k) f32, idx (T, k) int64), experts in descending score
    order as ``jax.lax.top_k`` gives them."""
    logits = x2d.to(F32) @ p["router"].to(F32)
    if cfg.router_type == "sigmoid":
        scores = torch.sigmoid(logits)
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

    # position of each assignment within its expert (stable by token order)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(cfg.n_experts, device=dev, dtype=flat_e.dtype))
    pos_sorted = torch.arange(T * k, device=dev) - seg_start[sorted_e]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)

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


def _shared_ffn(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["shared_wg"]) * (x @ p["shared_wi"])) @ p["shared_wo"]


def moe_apply(cfg: ModelConfig, p: Dict, x: torch.Tensor,
              mesh: Optional[object] = None) -> torch.Tensor:
    """MoE FFN.  x: (B, S, d); every expert on x's device."""
    if mesh is not None:
        raise NotImplementedError("expert parallelism over a mesh is not "
                                  "ported yet: ROADMAP A.5")
    B, S, d = x.shape
    E = cfg.n_experts
    x2d = x.reshape(B * S, d)
    gates, idx = router_weights(cfg, p, x2d)
    out = moe_local(cfg, x2d, gates, idx, p["wi"], p["wg"], p["wo"], 0, E,
                    capacity(cfg, B * S))
    if cfg.n_shared_experts:
        out = out + _shared_ffn(p, x2d)
    return out.reshape(B, S, d)
