"""Mamba-2 (SSD) mixer: in-proj -> causal conv1d -> SSD chunk scan ->
gated norm -> out-proj, with a constant-size recurrent state for decode.

Port of ``repro/models/ssm.py``.  Train/prefill route through the chunked
algorithm (the SSD kernel with ``use_kernels``, else the chunked
reference) at the chunk the COMET plan chooses (:func:`plan_chunk`);
decode is the O(1) recurrence h' = exp(dA) h + B ⊗ x·dt.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from ..kernels.autotune import ssd_chunk_len
from .config import ModelConfig
from .param import ParamSpec

F32 = torch.float32

__all__ = ["ssm_specs", "ssm_train", "ssm_prefill", "ssm_decode",
           "init_ssm_cache", "plan_chunk"]


def ssm_specs(cfg: ModelConfig, L: int) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    di, ng, ns, nh = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    cd = cfg.conv_dim
    proj_out = 2 * di + 2 * ng * ns + nh     # z, x, B, C, dt
    return {
        "in_proj": ParamSpec((L, d, proj_out), ("layer", "embed", "inner"), dtype=cfg.dtype),
        "conv_w": ParamSpec((L, cfg.conv_kernel, cd), ("layer", None, "inner"),
                            scale=1.0, dtype=cfg.dtype),
        "conv_b": ParamSpec((L, cd), ("layer", "inner"), init="zeros", dtype=cfg.dtype),
        "A_log": ParamSpec((L, nh), ("layer", None), init="zeros", dtype="float32"),
        "dt_bias": ParamSpec((L, nh), ("layer", None), init="zeros", dtype="float32"),
        "D": ParamSpec((L, nh), ("layer", None), init="ones", dtype="float32"),
        "norm_scale": ParamSpec((L, di), ("layer", "inner"), init="ones", dtype=cfg.dtype),
        "out_proj": ParamSpec((L, di, d), ("layer", "inner", "embed"), dtype=cfg.dtype),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    di, ng, ns = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    z = proj[..., :di]
    xin = proj[..., di:2 * di]
    Bm = proj[..., 2 * di:2 * di + ng * ns]
    Cm = proj[..., 2 * di + ng * ns:2 * di + 2 * ng * ns]
    dt = proj[..., 2 * di + 2 * ng * ns:]
    return z, xin, Bm, Cm, dt


def _gated_norm(cfg: ModelConfig, scale: torch.Tensor, y: torch.Tensor,
                z: torch.Tensor) -> torch.Tensor:
    yf = (y * F.silu(z)).to(F32)
    ms = (yf * yf).mean(-1, keepdim=True)
    return (yf * torch.rsqrt(ms + cfg.norm_eps) * scale.to(F32)).to(y.dtype)


def _conv1d(cfg: ModelConfig, w: torch.Tensor, b: torch.Tensor,
            u: torch.Tensor, prev: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Causal depthwise conv over (B, S, C).  w: (K, C).  A sum of K
    shifted elementwise products, as in the JAX package (``F.conv1d`` would
    run f32 through cuDNN in TF32 on the card)."""
    K, S = cfg.conv_kernel, u.shape[1]
    pad = prev if prev is not None else torch.zeros(
        (u.shape[0], K - 1, u.shape[2]), dtype=u.dtype, device=u.device)
    up = torch.cat([pad, u], dim=1)
    out = sum(up[:, i:i + S] * w[i] for i in range(K))
    return F.silu(out + b)


def _ssd_inputs(cfg: ModelConfig, p, xbc_conv: torch.Tensor,
                dt_raw: torch.Tensor):
    """Split conv output & build (xh, xdt, dA, B, C) for the SSD scan.  B
    and C stay in group form, (B, S, ngroups, ns) views of ``xbc_conv``:
    the scan reads each group once for its heads (the JAX package repeats
    them to every head, ``jnp.repeat``, which ``_group_heads`` does for
    the one-token decode step)."""
    di, ng, ns, nh, hp = (cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state,
                          cfg.ssm_nheads, cfg.ssm_headdim)
    B_, S = dt_raw.shape[0], dt_raw.shape[1]
    xin = xbc_conv[..., :di]
    Bm = xbc_conv[..., di:di + ng * ns].unflatten(-1, (ng, ns))
    Cm = xbc_conv[..., di + ng * ns:].unflatten(-1, (ng, ns))
    dt = F.softplus(dt_raw.to(F32) + p["dt_bias"].to(F32))       # (B,S,nh)
    A = -torch.exp(p["A_log"].to(F32))                            # (nh,)
    dA = dt * A                                                   # (B,S,nh)
    xh = xin.reshape(B_, S, nh, hp)
    xdt = xh.to(F32) * dt[..., None]
    return xh, xdt, dA, Bm, Cm


def _group_heads(cfg: ModelConfig, Bm: torch.Tensor) -> torch.Tensor:
    """(..., ngroups, ns) -> (..., nheads, ns), each group's heads adjacent
    (``jnp.repeat``)."""
    return Bm.repeat_interleave(cfg.ssm_nheads // cfg.ssm_ngroups, dim=-2)


def plan_chunk(cfg: ModelConfig, S: int) -> int:
    """The SSD chunk for a sequence of S rows: the COMET plan's choice
    (``kernels/autotune.py::ssd_chunk_len`` on the card's preset), as the
    JAX model asks its own plan.  A warm call still looks the plans up in
    the plan cache, so the model resolves it once a forward or prefill
    call and hands it to every layer."""
    return ssd_chunk_len(S, cfg.ssm_headdim, cfg.ssm_state)


def _ssd_scan(cfg: ModelConfig, xdt, dA, Bm, Cm, chunk: int
              ) -> torch.Tensor:
    """(B,S,nh,hp) x (B,S,nh) x (B,S,ng,ns) -> y (B,S,nh,hp) in bf16.

    B and C go to the scan in group form, (B*ng, S, ns): at ng = 1 a view
    of the conv output with no copy in a bf16 model.  ``chunk`` is the
    plan's (:func:`plan_chunk`), clipped to S by the scan.  The JAX model
    cuts a ragged S's chunk to a divisor of S; here the kernel and the
    chunked reference zero-pad the ragged tail instead."""
    B_, S, nh, hp = xdt.shape
    ng, ns = Bm.shape[-2:]
    # flatten batch x heads (and batch x groups) for the kernel layout
    xk = xdt.transpose(1, 2).reshape(B_ * nh, S, hp)
    dk = dA.transpose(1, 2).reshape(B_ * nh, S)
    bk = Bm.transpose(1, 2).reshape(B_ * ng, S, ns)
    ck = Cm.transpose(1, 2).reshape(B_ * ng, S, ns)
    bf16 = torch.bfloat16
    y = kops.ssd(xk.to(bf16).contiguous(), dk.contiguous(), bk.to(bf16),
                 ck.to(bf16), chunk=chunk, use_kernel=cfg.use_kernels)
    return y.reshape(B_, nh, S, hp).transpose(1, 2)


def ssm_train(cfg: ModelConfig, p, x: torch.Tensor,
              chunk: Optional[int] = None) -> torch.Tensor:
    """Full-sequence forward.  ``chunk``: the SSD chunk, resolved through
    :func:`plan_chunk` when not given."""
    B_, S, _ = x.shape
    di = cfg.d_inner
    proj = x @ p["in_proj"]
    z, xin, Bm, Cm, dt_raw = _split_proj(cfg, proj)
    xbc = torch.cat([xin, Bm, Cm], dim=-1)
    xbc = _conv1d(cfg, p["conv_w"], p["conv_b"], xbc)
    xh, xdt, dA, Bm, Cm = _ssd_inputs(cfg, p, xbc, dt_raw)
    y = _ssd_scan(cfg, xdt, dA, Bm, Cm,
                  plan_chunk(cfg, S) if chunk is None else chunk)
    y = y + xh.to(F32) * p["D"].to(F32)[None, None, :, None]
    y = y.reshape(B_, S, di).to(x.dtype)
    y = _gated_norm(cfg, p["norm_scale"], y, z)
    return y @ p["out_proj"]


def init_ssm_cache(cfg: ModelConfig, B: int, dtype: torch.dtype,
                   device: torch.device) -> Dict:
    return {
        "conv": torch.zeros((B, cfg.conv_kernel - 1, cfg.conv_dim),
                            dtype=dtype, device=device),
        "state": torch.zeros((B, cfg.ssm_nheads, cfg.ssm_state,
                              cfg.ssm_headdim), dtype=F32, device=device),
    }


def ssm_prefill(cfg: ModelConfig, p, x: torch.Tensor,
                chunk: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """Full-seq forward + final recurrent state for decode continuation.
    ``chunk``: the SSD chunk, resolved through :func:`plan_chunk` when not
    given."""
    B_, S, _ = x.shape
    di = cfg.d_inner
    proj = x @ p["in_proj"]
    z, xin, Bm, Cm, dt_raw = _split_proj(cfg, proj)
    xbc_raw = torch.cat([xin, Bm, Cm], dim=-1)
    xbc = _conv1d(cfg, p["conv_w"], p["conv_b"], xbc_raw)
    xh, xdt, dA, Bm, Cm = _ssd_inputs(cfg, p, xbc, dt_raw)
    y = _ssd_scan(cfg, xdt, dA, Bm, Cm,
                  plan_chunk(cfg, S) if chunk is None else chunk)
    y = y + xh.to(F32) * p["D"].to(F32)[None, None, :, None]
    yo = _gated_norm(cfg, p["norm_scale"], y.reshape(B_, S, di).to(x.dtype),
                     z)
    out = yo @ p["out_proj"]
    # final state: h_S = sum_t exp(sum_{u>t} dA_u) B_t xdt_t^T  (per head),
    # one f32 einsum over the whole sequence as in the JAX package, with
    # each group's B shared by its heads: (B,S,ng,r,hp) against (B,S,ng,ns).
    # The cumsum runs along the contiguous dim (a scan across the middle
    # dim of (B,S,nh) is the card's slowest pass of the prefill)
    ng, ns = Bm.shape[-2:]
    cs = torch.cumsum(dA.transpose(1, 2).contiguous(), dim=-1)  # (B,nh,S)
    decay = torch.exp(cs[..., -1:] - cs).transpose(1, 2)      # (B,S,nh)
    xd = (decay[..., None] * xdt).unflatten(2, (ng, -1))      # (B,S,ng,r,hp)
    state = torch.einsum("bsgn,bsgrp->bgrnp", Bm.to(F32), xd) \
        .reshape(B_, -1, ns, xdt.shape[-1])                   # (B,nh,ns,hp)
    conv_state = xbc_raw[:, -(cfg.conv_kernel - 1):, :]
    return out, {"conv": conv_state, "state": state}


def ssm_decode(cfg: ModelConfig, p, x: torch.Tensor, cache: Dict
               ) -> Tuple[torch.Tensor, Dict]:
    """One-token step.  x: (B, 1, d).

    The cache's tensors are updated in place (the JAX engine donates its
    cache to the decode step), after every read of their old values, and
    are returned in a new dict."""
    B_ = x.shape[0]
    di = cfg.d_inner
    proj = x @ p["in_proj"]
    z, xin, Bm, Cm, dt_raw = _split_proj(cfg, proj)
    xbc1 = torch.cat([xin, Bm, Cm], dim=-1)                   # (B,1,cd)
    conv_prev = cache["conv"]
    xbc = _conv1d(cfg, p["conv_w"], p["conv_b"], xbc1, prev=conv_prev)
    new_conv = torch.cat([conv_prev, xbc1], dim=1)[:, 1:, :]  # a new tensor
    xh, xdt, dA, Bm, Cm = _ssd_inputs(cfg, p, xbc, dt_raw)
    Bh, Ch = _group_heads(cfg, Bm[:, 0]), _group_heads(cfg, Cm[:, 0])
    # recurrence: h' = exp(dA) h + B ⊗ xdt
    h = torch.exp(dA[:, 0, :, None, None]) * cache["state"] \
        + torch.einsum("bhn,bhp->bhnp", Bh.to(F32), xdt[:, 0])
    y = torch.einsum("bhn,bhnp->bhp", Ch.to(F32), h)          # (B,nh,hp)
    y = y + xh[:, 0].to(F32) * p["D"].to(F32)[None, :, None]
    y = y.reshape(B_, 1, di).to(x.dtype)
    y = _gated_norm(cfg, p["norm_scale"], y, z)
    cache["conv"].copy_(new_conv)
    cache["state"].copy_(h)
    return y @ p["out_proj"], {"conv": cache["conv"], "state": cache["state"]}
