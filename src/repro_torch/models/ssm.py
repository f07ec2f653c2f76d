"""Mamba-2 (SSD) mixer: in-proj -> causal conv1d -> SSD chunk scan ->
gated norm -> out-proj, with a constant-size recurrent state for decode.

Port of ``repro/models/ssm.py``.  Train/prefill route through the chunked
algorithm (the SSD kernel with ``use_kernels``, else the chunked
reference) at the chunk the COMET plan chooses (:func:`plan_chunk`);
decode is the O(1) recurrence h' = exp(dA) h + B ⊗ x·dt.

Training, prefill and decode take a ``(data, model)`` mesh (``mesh=``; x
is this rank's rows, the params its shards).  ``in_proj`` packs
z|x|B|C|dt and ``conv_w`` x|B|C, so a rank's column blocks mix the parts:
the in_proj output is All-Gathered over ``model``, the depthwise conv runs
on the rank's own channel block (its shard of the conv cache), and the
conv output is All-Gathered (both ``tp/ssm-gather``).  The rank's SSM
heads (its shard of the state cache) run through the scan, B/C in group
form; the gated norm's partial sums of squares are SUM-All-Reduced over
``model`` (``tp/ssm-norm``: the distributed-norm epilogue of the paper's
GEMM-LayerNorm) and ``out_proj``'s rows give a partial product reduced
the same way (``tp/ssm-out``).  Weights kept whole run whole.  Under
autograd the mixer is a Megatron region (:func:`_enter`): *f* before it
(``tp/ssm-out``), each gather's transpose a Reduce-Scatter of the ranks'
partial cotangents, the norm's sum transposed to a sum, and the
cotangents of the weights every rank uses whole (the per-head
``A_log``/``dt_bias``/``D``, and ``in_proj`` or the conv where they do
not split) SUM-All-Reduced (``tp/ssm-param-grad``).  Where ``out_proj``'s
rows do not split, every rank computes the whole output: no *f* or *g*,
and a gather's transpose is the rank's block.  Under ``seq_shard``
(``seq=``) x is this rank's block of the sequence: the mixer gathers the
rows in (``tp/seq-gather``, in place of *f*) and Reduce-Scatters its
output's rows out (``tp/ssm-out``, in place of *g*); between the two it
runs on the whole sequence as above.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from ..kernels import ssd
from ..kernels.autotune import ssd_chunk_len
from ..parallel.collective_planner import (enter_region, gather_replicated,
                                           gather_shards, leave_region,
                                           model_axis, sum_cotangent,
                                           sum_over)
from ..parallel.sharding import cache_block, split_over
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
                dt_raw: torch.Tensor, h0: int = 0, n: Optional[int] = None):
    """Split conv output & build (xh, xdt, dA, B, C) for the SSD scan of
    heads [h0, h0 + n) (default all).  B and C stay in group form, (B, S,
    groups, ns) views of ``xbc_conv``: the scan reads each group once for
    its heads (the JAX package repeats them to every head, ``jnp.repeat``,
    which ``_per_head`` does for the one-token decode step)."""
    di, ng, ns, nh, hp = (cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state,
                          cfg.ssm_nheads, cfg.ssm_headdim)
    n = nh if n is None else n
    B_, S = dt_raw.shape[0], dt_raw.shape[1]
    xin = xbc_conv[..., h0 * hp:(h0 + n) * hp]
    Bm = xbc_conv[..., di:di + ng * ns].unflatten(-1, (ng, ns))
    Cm = xbc_conv[..., di + ng * ns:].unflatten(-1, (ng, ns))
    if n < nh:
        Bm, Cm = _head_groups(cfg, Bm, h0, n), _head_groups(cfg, Cm, h0, n)
    heads = slice(h0, h0 + n)
    dt = F.softplus(dt_raw[..., heads].to(F32)
                    + p["dt_bias"][heads].to(F32))                # (B,S,n)
    A = -torch.exp(p["A_log"][heads].to(F32))                     # (n,)
    dA = dt * A                                                   # (B,S,n)
    xh = xin.reshape(B_, S, n, hp)
    xdt = xh.to(F32) * dt[..., None]
    return xh, xdt, dA, Bm, Cm


def _head_groups(cfg: ModelConfig, Bm: torch.Tensor, h0: int, n: int
                 ) -> torch.Tensor:
    """B or C (..., ngroups, ns) in group form for heads [h0, h0 + n): the
    groups they read, or, where their heads do not tile whole groups or
    one group, one row a head."""
    r = cfg.ssm_nheads // cfg.ssm_ngroups
    if n % r == 0 or r % n == 0:
        return Bm[..., h0 // r:h0 // r + max(1, n // r), :]
    return _per_head(Bm, cfg.ssm_nheads)[..., h0:h0 + n, :]


def _per_head(Bm: torch.Tensor, n: int) -> torch.Tensor:
    """(..., groups, ns) -> (..., n heads, ns), each group's heads adjacent
    (``jnp.repeat``)."""
    return Bm.repeat_interleave(n // Bm.shape[-2], dim=-2)


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
    of the conv output with no copy in a bf16 model (a state dim below
    the kernel's least is zero-padded to it).  ``chunk`` is the
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
    pad = ssd.STATE_DIMS[0] - ns
    if cfg.use_kernels and pad > 0:
        # below the kernel's least state dim (hymba's smoke config, N 8):
        # zero columns of B and C add nothing to C B^T, to the state or to
        # C h, so y is the scan's at N
        bk, ck = F.pad(bk, (0, pad)), F.pad(ck, (0, pad))
    bf16 = torch.bfloat16
    y = kops.ssd(xk.to(bf16).contiguous(), dk.contiguous(), bk.to(bf16),
                 ck.to(bf16), chunk=chunk, use_kernel=cfg.use_kernels)
    return y.reshape(B_, nh, S, hp).transpose(1, 2)


def ssm_train(cfg: ModelConfig, p, x: torch.Tensor,
              chunk: Optional[int] = None, mesh=None, seq=None
              ) -> torch.Tensor:
    """Full-sequence forward.  ``chunk``: the SSD chunk, resolved through
    :func:`plan_chunk` when not given.  On a mesh, tensor-parallel over
    ``model`` on the rank's heads (:func:`_enter`, :func:`_mix`); ``seq``
    as ``collective_planner.enter_region`` takes it."""
    p, x = _enter(cfg, p, x, mesh, seq)
    return _mix(cfg, p, x, chunk, mesh, seq)[0]


def init_ssm_cache(cfg: ModelConfig, B: int, dtype: torch.dtype,
                   device: torch.device) -> Dict:
    return {
        "conv": torch.zeros((B, cfg.conv_kernel - 1, cfg.conv_dim),
                            dtype=dtype, device=device),
        "state": torch.zeros((B, cfg.ssm_nheads, cfg.ssm_state,
                              cfg.ssm_headdim), dtype=F32, device=device),
    }


def _partial(cfg: ModelConfig, p, mesh) -> bool:
    """Whether the mixer's output on a mesh is a partial sum over
    ``model`` (``out_proj``'s rows split), not whole on every rank."""
    return split_over(p["out_proj"].shape[0], cfg.d_inner,
                      model_axis(mesh)[0])


def _enter(cfg: ModelConfig, p, x: torch.Tensor, mesh, seq=None):
    """(params, x) of the mixer's tensor-parallel region: where its output
    is partial, *f* on x (``tp/ssm-out``; with ``seq``, the rows'
    gather) and a SUM-All-Reduced cotangent for the weights that every
    rank uses whole (``tp/ssm-param-grad``: one collective for the three
    per-head leaves, one for each whole weight); as they are without a
    mesh, and where the output is whole but for a gather of the rows."""
    if mesh is None:
        return p, x
    m, _, group = model_axis(mesh)
    if not _partial(cfg, p, mesh):
        return p, enter_region(x, group, "tp/ssm-out", partial=False,
                               seq=seq)
    p = dict(p)
    heads = ("A_log", "dt_bias", "D")
    per_head = sum_cotangent(torch.stack([p[k] for k in heads]), group,
                             "tp/ssm-param-grad")
    p.update(zip(heads, per_head.unbind(0)))
    di, cd = cfg.d_inner, cfg.conv_dim
    whole = [] if split_over(p["in_proj"].shape[-1],
                             di + cd + cfg.ssm_nheads, m) else ["in_proj"]
    if not split_over(p["conv_w"].shape[-1], cd, m):
        whole += ["conv_w", "conv_b"]
    for k in whole:
        p[k] = sum_cotangent(p[k], group, "tp/ssm-param-grad")
    return p, enter_region(x, group, "tp/ssm-out", partial=True, seq=seq)


def _mesh_conv(cfg: ModelConfig, p, proj: torch.Tensor, mesh,
               prev: Optional[torch.Tensor] = None):
    """On a mesh: (the whole in_proj output, this rank's block of the conv
    input channels x|B|C, the whole conv output).  ``proj`` holds this
    rank's in_proj columns and is All-Gathered where they are split; the
    depthwise conv runs on the rank's channel block (``prev``: its rows of
    the conv cache), and its output is All-Gathered where the channels
    are split (both ``tp/ssm-gather``; under autograd each transposes to
    a Reduce-Scatter where the mixer's output is partial, else to the
    rank's block)."""
    m, r, group = model_axis(mesh)
    di, cd = cfg.d_inner, cfg.conv_dim

    def gather(t):
        if _partial(cfg, p, mesh):
            return gather_shards(t, group, "tp/ssm-gather", "tp/ssm-gather")
        return gather_replicated(t, group, "tp/ssm-gather")
    if split_over(proj.shape[-1], di + cd + cfg.ssm_nheads, m):
        proj = gather(proj)
    c = p["conv_w"].shape[-1]
    split = split_over(c, cd, m)
    c0 = r * c if split else 0
    raw = proj[..., di + c0:di + c0 + c]
    xbc = _conv1d(cfg, p["conv_w"], p["conv_b"], raw, prev=prev)
    if split:
        xbc = gather(xbc)
    return proj, raw, xbc


def _mixer_out(cfg: ModelConfig, p, y: torch.Tensor, z: torch.Tensor,
               h0: int, mesh=None, seq=None) -> torch.Tensor:
    """The gated RMS norm (over all of d_inner) and ``out_proj`` of heads
    [h0, h0 + n)'s y (B, S, n hp) in the model dtype, gated by their
    columns of the whole z.  On a mesh the rank's partial sums of squares
    are SUM-All-Reduced (``tp/ssm-norm``) where it holds part of the
    heads, and its rows of ``out_proj`` give a partial product,
    SUM-All-Reduced (``tp/ssm-out``; with ``seq`` Reduce-Scattered over
    the sequence); weights kept whole run whole."""
    di, rows = cfg.d_inner, p["out_proj"].shape[0]
    c0, cols = h0 * cfg.ssm_headdim, y.shape[-1]
    zl = z[..., c0:c0 + cols]
    if mesh is None:
        return _gated_norm(cfg, p["norm_scale"], y, zl) @ p["out_proj"]
    m, r, group = model_axis(mesh)
    # whole out_proj rows: d_inner does not split, nor do the heads
    if not _partial(cfg, p, mesh):
        return leave_region(
            _gated_norm(cfg, p["norm_scale"], y, zl) @ p["out_proj"], group,
            "tp/ssm-out", partial=False, seq=seq)
    yf = (y * F.silu(zl)).to(F32)
    if cols < di:
        ms = sum_over((yf * yf).sum(-1, keepdim=True), group,
                      "tp/ssm-norm") / di
    else:
        ms = (yf * yf).mean(-1, keepdim=True)
    yn = yf * torch.rsqrt(ms + cfg.norm_eps)
    c = r * rows - c0
    yo = (yn[..., c:c + rows] * p["norm_scale"].to(F32)).to(y.dtype)
    return leave_region(yo @ p["out_proj"], group, "tp/ssm-out",
                        partial=True, seq=seq)


def _mix(cfg: ModelConfig, p, x: torch.Tensor, chunk: Optional[int],
         mesh=None, seq=None):
    """(the mixer's output, the conv input block of the cache, and the
    scan's xdt, dA and B for the final state) of the full sequence x; on
    a mesh over this rank's heads and channel block (every head where the
    weights are whole), the output's rows this rank's with ``seq``."""
    B_, S, _ = x.shape
    nh, ns, hp = cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_headdim
    proj = x @ p["in_proj"]
    h0, n = 0, nh
    if mesh is None:
        z, xin, Bm, Cm, dt_raw = _split_proj(cfg, proj)
        xbc_raw = torch.cat([xin, Bm, Cm], dim=-1)
        xbc = _conv1d(cfg, p["conv_w"], p["conv_b"], xbc_raw)
    else:
        proj, xbc_raw, xbc = _mesh_conv(cfg, p, proj, mesh)
        z, _, _, _, dt_raw = _split_proj(cfg, proj)
        if _partial(cfg, p, mesh):
            h0, h1 = cache_block("state", (B_, nh, ns, hp), mesh)[1]
            n = h1 - h0
    xh, xdt, dA, Bm, Cm = _ssd_inputs(cfg, p, xbc, dt_raw, h0, n)
    y = _ssd_scan(cfg, xdt, dA, Bm, Cm,
                  plan_chunk(cfg, S) if chunk is None else chunk)
    y = y + xh.to(F32) * p["D"][h0:h0 + n].to(F32)[None, None, :, None]
    out = _mixer_out(cfg, p, y.reshape(B_, S, n * hp).to(x.dtype), z, h0,
                     mesh, seq)
    return out, xbc_raw, xdt, dA, Bm


def ssm_prefill(cfg: ModelConfig, p, x: torch.Tensor,
                chunk: Optional[int] = None, mesh=None, seq=None
                ) -> Tuple[torch.Tensor, Dict]:
    """Full-seq forward + final recurrent state for decode continuation.
    ``chunk``: the SSD chunk, resolved through :func:`plan_chunk` when not
    given.  On a mesh the cache is this rank's shard (its conv channels,
    its heads' state), built from the whole sequence (with ``seq``,
    gathered first)."""
    if mesh is not None and seq:
        x = enter_region(x, model_axis(mesh)[2], "tp/ssm-out",
                         partial=_partial(cfg, p, mesh), seq=seq)
    B_ = x.shape[0]
    ns = cfg.ssm_state
    out, xbc_raw, xdt, dA, Bm = _mix(cfg, p, x, chunk, mesh, seq)
    # final state: h_S = sum_t exp(sum_{u>t} dA_u) B_t xdt_t^T  (per head),
    # one f32 einsum over the whole sequence as in the JAX package, with
    # each group's B shared by its heads: (B,S,ng,r,hp) against (B,S,ng,ns).
    # The cumsum runs along the contiguous dim (a scan across the middle
    # dim of (B,S,nh) is the card's slowest pass of the prefill)
    ng = Bm.shape[-2]
    cs = torch.cumsum(dA.transpose(1, 2).contiguous(), dim=-1)  # (B,nh,S)
    decay = torch.exp(cs[..., -1:] - cs).transpose(1, 2)      # (B,S,nh)
    xd = (decay[..., None] * xdt).unflatten(2, (ng, -1))      # (B,S,ng,r,hp)
    state = torch.einsum("bsgn,bsgrp->bgrnp", Bm.to(F32), xd) \
        .reshape(B_, -1, ns, xdt.shape[-1])                   # (B,nh,ns,hp)
    conv_state = xbc_raw[:, -(cfg.conv_kernel - 1):, :]
    return out, {"conv": conv_state, "state": state}


def ssm_decode(cfg: ModelConfig, p, x: torch.Tensor, cache: Dict,
               mesh=None) -> Tuple[torch.Tensor, Dict]:
    """One-token step.  x: (B, 1, d).

    The cache's tensors are updated in place (the JAX engine donates its
    cache to the decode step), after every read of their old values, and
    are returned in a new dict.  On a mesh the cache is this rank's shard
    (its conv channels, its heads' state)."""
    B_ = x.shape[0]
    nh, hp = cfg.ssm_nheads, cfg.ssm_headdim
    proj = x @ p["in_proj"]
    conv_prev = cache["conv"]
    n = cache["state"].shape[1]
    h0 = 0
    if mesh is None:
        z, xin, Bm, Cm, dt_raw = _split_proj(cfg, proj)
        xbc1 = torch.cat([xin, Bm, Cm], dim=-1)               # (B,1,cd)
        xbc = _conv1d(cfg, p["conv_w"], p["conv_b"], xbc1, prev=conv_prev)
    else:
        proj, xbc1, xbc = _mesh_conv(cfg, p, proj, mesh, conv_prev)
        z, _, _, _, dt_raw = _split_proj(cfg, proj)
        if n < nh:
            h0 = model_axis(mesh)[1] * n
    new_conv = torch.cat([conv_prev, xbc1], dim=1)[:, 1:, :]  # a new tensor
    xh, xdt, dA, Bm, Cm = _ssd_inputs(cfg, p, xbc, dt_raw, h0, n)
    Bh, Ch = _per_head(Bm[:, 0], n), _per_head(Cm[:, 0], n)
    # recurrence: h' = exp(dA) h + B ⊗ xdt
    h = torch.exp(dA[:, 0, :, None, None]) * cache["state"] \
        + torch.einsum("bhn,bhp->bhnp", Bh.to(F32), xdt[:, 0])
    y = torch.einsum("bhn,bhnp->bhp", Ch.to(F32), h)          # (B,n,hp)
    y = y + xh[:, 0].to(F32) * p["D"][h0:h0 + n].to(F32)[None, :, None]
    y = y.reshape(B_, 1, n * hp).to(x.dtype)
    cache["conv"].copy_(new_conv)
    cache["state"].copy_(h)
    return (_mixer_out(cfg, p, y, z, h0, mesh),
            {"conv": cache["conv"], "state": cache["state"]})
