"""Attention: GQA/MQA (optionally sliding-window, qk-norm), MLA (DeepSeek)
and cross-attention, with train (full-seq), prefill (cache-building) and
decode (cached, fixed-shape) paths.

Training/prefill uses a *blocked* online-softmax implementation (a loop
over KV blocks, so the S×S score matrix is never materialized);
``use_kernels=True`` routes through the FlashAttention kernel instead
where q and v share a head dim (MLA's do not: it takes the blocked loop,
as in the JAX package).  Decode uses dense einsums over the cache; MLA's
runs absorbed, in the latent space of its compressed cache.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from ..kernels.ref import attention_ref
from ..parallel.collective_planner import (enter_parallel, gather_shards,
                                           leave_parallel, model_axis,
                                           sum_cotangent)
from .config import ModelConfig
from .layers import apply_norm, apply_rope, rope_cos_sin
from .param import ParamSpec

F32 = torch.float32
NEG = -1e30

__all__ = [
    "gqa_specs", "mla_specs", "cross_specs",
    "attn_train", "attn_prefill", "attn_decode",
    "cross_train", "cross_decode", "make_cross_cache",
    "init_attn_cache", "blocked_attention", "banded_window_attention",
]


# ============================================================ blocked attn


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: Optional[int],
                      scale: float, block_k: int = 512,
                      q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention, looping over KV blocks.

    q: (B, Hq, Sq, Dq); k: (B, Hkv, Skv, Dq); v: (B, Hkv, Skv, Dv).
    ``q_offset``: absolute position of q[0] minus absolute position of k[0].
    Returns (B, Hq, Sq, Dv) in q.dtype.
    """
    B, Hq, Sq, Dq = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    group = Hq // Hkv
    bk = min(block_k, Skv)
    pad = (-Skv) % bk
    k = F.pad(k, (0, 0, 0, pad))
    v = F.pad(v, (0, 0, 0, pad))
    dev = q.device
    q_pos = torch.arange(Sq, device=dev) + q_offset
    # grouped-query layout (B, Hkv, group, Sq, D): no KV repeat
    qg = q.to(F32).reshape(B, Hkv, group, Sq, Dq)
    m = torch.full((B, Hkv, group, Sq), NEG, dtype=F32, device=dev)
    l = torch.zeros((B, Hkv, group, Sq), dtype=F32, device=dev)
    acc = torch.zeros((B, Hkv, group, Sq, Dv), dtype=F32, device=dev)
    for start in range(0, Skv + pad, bk):
        kf = k[:, :, start:start + bk].to(F32)
        vf = v[:, :, start:start + bk].to(F32)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf) * scale
        k_pos = start + torch.arange(bk, device=dev)
        mask = (k_pos < Skv)[None, :].expand(Sq, bk).clone()   # padding
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        s = torch.where(mask, s, torch.tensor(NEG, dtype=F32, device=dev))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
        m = m_new
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / l[..., None]).reshape(B, Hq, Sq, Dv)
    return out.to(q.dtype)


def banded_window_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, window: int,
                            scale: float) -> torch.Tensor:
    """Causal sliding-window self-attention in O(S·2W) instead of O(S²):
    queries are processed in blocks of W; each block attends only its
    [iW−W, iW+W) key band.  Requires Sq == Skv (training/prefill self-attn)."""
    B, Hq, S, Dq = q.shape
    Hkv, Dv = k.shape[1], v.shape[-1]
    group = Hq // Hkv
    W = window
    pad = (-S) % W
    Sp = S + pad
    dev = q.device
    qp = F.pad(q, (0, 0, 0, pad))
    kp = F.pad(k, (0, 0, W, pad))      # front band pad
    vp = F.pad(v, (0, 0, W, pad))
    qf = qp.to(F32).reshape(B, Hkv, group, Sp, Dq)
    ar_w = torch.arange(W, device=dev)
    ar_2w = torch.arange(2 * W, device=dev)
    rel = W + ar_w[:, None] - ar_2w[None, :]        # q-k distance
    band_ok = (rel >= 0) & (rel < W)
    outs = []
    for i in range(Sp // W):
        qi = qf[:, :, :, i * W:(i + 1) * W]                 # (B,Hkv,g,W,D)
        ki = kp[:, :, i * W:i * W + 2 * W].to(F32)          # (B,Hkv,2W,D)
        vi = vp[:, :, i * W:i * W + 2 * W].to(F32)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qi, ki) * scale
        k_pos = i * W - W + ar_2w
        q_pos = i * W + ar_w
        mask = band_ok & (k_pos[None, :] >= 0) & (k_pos[None, :] < S) \
            & (q_pos[:, None] < S)
        s = torch.where(mask, s, torch.tensor(NEG, dtype=F32, device=dev))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhgqk,bhkd->bhgqd", p, vi))
    out = torch.cat(outs, dim=3).reshape(B, Hq, Sp, Dv)
    return out[:, :, :S].to(q.dtype)


def _attend(cfg: ModelConfig, q, k, v, *, causal, window, scale,
            q_offset=0):
    """Dispatch: banded-window / FlashAttention kernel / blocked loop /
    reference."""
    Dq, Dv = q.shape[-1], v.shape[-1]
    Sq, Skv = q.shape[2], k.shape[2]
    if (window is not None and causal and Sq == Skv and q_offset == 0
            and Skv >= 2 * window and cfg.banded_attention):
        return banded_window_attention(q, k, v, window=window, scale=scale)
    if cfg.use_kernels and Dq == Dv:
        return kops.mha(q, k, v, causal=causal, scale=scale, window=window,
                        use_kernel=True)
    if Skv > 1024:
        return blocked_attention(q, k, v, causal=causal, window=window,
                                 scale=scale, q_offset=q_offset)
    if Dq == Dv and q_offset == 0:
        return attention_ref(q, k, v, causal=causal, scale=scale,
                             window=window)
    return blocked_attention(q, k, v, causal=causal, window=window,
                             scale=scale, q_offset=q_offset)


# ================================================================= specs


def gqa_specs(cfg: ModelConfig, L: int) -> Dict[str, ParamSpec]:
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = {
        "wq": ParamSpec((L, d, H * hd), ("layer", "embed", "heads"), dtype=cfg.dtype),
        "wk": ParamSpec((L, d, Hkv * hd), ("layer", "embed", "kv_heads"), dtype=cfg.dtype),
        "wv": ParamSpec((L, d, Hkv * hd), ("layer", "embed", "kv_heads"), dtype=cfg.dtype),
        "wo": ParamSpec((L, H * hd, d), ("layer", "heads", "embed"), dtype=cfg.dtype),
    }
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((L, hd), ("layer", None), init="ones", dtype=cfg.dtype)
        s["k_norm"] = ParamSpec((L, hd), ("layer", None), init="ones", dtype=cfg.dtype)
    return s


def mla_specs(cfg: ModelConfig, L: int) -> Dict[str, ParamSpec]:
    d, H = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.hd, cfg.rope_head_dim, cfg.v_head_dim
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    return {
        "wdq": ParamSpec((L, d, qr), ("layer", "embed", None), dtype=cfg.dtype),
        "q_norm": ParamSpec((L, qr), ("layer", None), init="ones", dtype=cfg.dtype),
        "wuq": ParamSpec((L, qr, H * (dn + dr)), ("layer", None, "heads"), dtype=cfg.dtype),
        "wdkv": ParamSpec((L, d, kvr + dr), ("layer", "embed", None), dtype=cfg.dtype),
        "kv_norm": ParamSpec((L, kvr), ("layer", None), init="ones", dtype=cfg.dtype),
        "wuk": ParamSpec((L, kvr, H * dn), ("layer", None, "heads"), dtype=cfg.dtype),
        "wuv": ParamSpec((L, kvr, H * dv), ("layer", None, "heads"), dtype=cfg.dtype),
        "wo": ParamSpec((L, H * dv, d), ("layer", "heads", "embed"), dtype=cfg.dtype),
    }


def cross_specs(cfg: ModelConfig, L: int) -> Dict[str, ParamSpec]:
    return gqa_specs(cfg, L)


# =============================================================== GQA paths


def _qkv(cfg: ModelConfig, p, x, positions, mesh=None):
    B, S, d = x.shape
    hd = cfg.hd
    if mesh is None:
        q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, hd)
        k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
        v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    else:
        q, k, v, p = _qkv_local(cfg, p, x, mesh)
    if cfg.qk_norm:
        qn = {"scale": p["q_norm"]}
        kn = {"scale": p["k_norm"]}
        if cfg.norm_type == "layernorm":
            qn["bias"] = torch.zeros_like(p["q_norm"])
            kn["bias"] = torch.zeros_like(p["k_norm"])
        q = apply_norm(cfg, qn, q)
        k = apply_norm(cfg, kn, k)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return q, k, v


def _kv_heads(H: int, Hkv: int, h0: int, n: int):
    """The kv heads that q heads [h0, h0 + n) read, as a slice of the kv
    heads when the local GQA group is uniform, else an index a q head."""
    g = H // Hkv
    if n % g == 0:
        return slice(h0 // g, (h0 + n) // g)
    if g % n == 0:
        return slice(h0 // g, h0 // g + 1)
    return torch.arange(h0, h0 + n) // g


def _qkv_local(cfg: ModelConfig, p, x, mesh):
    """This rank's q heads and the kv heads they read, for the
    tensor-parallel layer (``x`` already through *f*).  ``wq`` holds the
    rank's ``H / m`` whole q heads.  ``wk``/``wv`` are split by columns,
    which ``spec_for`` does whenever ``Hkv * hd`` divides, mid-head too:
    when ``Hkv`` itself divides, the rank's columns are exactly the kv
    heads its q heads read; otherwise the k and v projections are
    All-Gathered over ``model`` (``tp/kv-gather``, a Reduce-Scatter
    backward) and the needed heads picked.  q/k-norm scales act on the
    rank's heads only, so their cotangents are SUM-All-Reduced over
    ``model`` (``tp/qk-norm-grad``).  Returns q, k, v and ``p`` with the
    norm scales so wrapped."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    m, r, group = model_axis(mesh)
    if H % m or p["wq"].shape[-1] * m != H * hd:
        raise NotImplementedError(
            f"{H} q heads over {m} model ranks split a q head: ROADMAP "
            f"A.5, slice 14")
    if p["wk"].shape[-1] * m != Hkv * hd:
        raise NotImplementedError(
            f"kv columns {Hkv * hd} that do not split over {m} model ranks "
            f"(whole kv weights under tensor parallelism): ROADMAP A.5, "
            f"slice 14")
    n = H // m
    q = (x @ p["wq"]).reshape(B, S, n, hd)
    kp, vp = x @ p["wk"], x @ p["wv"]
    if Hkv % m == 0:
        nk = Hkv // m
        k, v = kp.reshape(B, S, nk, hd), vp.reshape(B, S, nk, hd)
    else:
        sel = _kv_heads(H, Hkv, r * n, n)
        k = gather_shards(kp, group, "tp/kv-gather", "tp/kv-gather").reshape(
            B, S, Hkv, hd)[:, :, sel]
        v = gather_shards(vp, group, "tp/kv-gather", "tp/kv-gather").reshape(
            B, S, Hkv, hd)[:, :, sel]
    if cfg.qk_norm:
        p = dict(p, q_norm=sum_cotangent(p["q_norm"], group,
                                         "tp/qk-norm-grad"),
                 k_norm=sum_cotangent(p["k_norm"], group,
                                      "tp/qk-norm-grad"))
    return q, k, v, p


def attn_train(cfg: ModelConfig, p, x, *, causal: bool = True, mesh=None
               ) -> torch.Tensor:
    """Full-sequence self-attention.  On a mesh (GQA only) it is
    tensor-parallel over ``model``: *f* before the q/k/v projections, this
    rank's heads through the attention (the FlashAttention kernel with
    ``use_kernels``), its rows of ``wo``, and *g* after (both
    ``tp/attn-out``)."""
    if cfg.attn_type == "mla":
        if mesh is not None and model_axis(mesh)[0] > 1:
            raise NotImplementedError(
                "tensor-parallel MLA is not ported: ROADMAP A.5, slice 14")
        return _mla_train(cfg, p, x)
    B, S, d = x.shape
    if mesh is not None:
        group = model_axis(mesh)[2]
        x = enter_parallel(x, group, "tp/attn-out")
    q, k, v = _qkv(cfg, p, x, torch.arange(S, device=x.device), mesh)
    scale = 1.0 / math.sqrt(cfg.hd)
    o = _attend(cfg, q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=causal, window=cfg.window, scale=scale)
    o = o.transpose(1, 2).reshape(B, S, q.shape[2] * cfg.hd)
    if mesh is None:
        return o @ p["wo"]
    return leave_parallel(o @ p["wo"], group, "tp/attn-out")


def init_attn_cache(cfg: ModelConfig, B: int, cache_len: int,
                    dtype: torch.dtype, device: torch.device) -> Dict:
    """Fixed-shape cache.  Windowed layers use a ring buffer of width
    min(window, cache_len); global layers use the full length.  ``kpos``
    is per-row (B, W): decode positions are per-slot so a serving engine
    can re-prefill one slot while the others keep decoding.  MLA caches
    its compressed latent ``ckv`` and the shared RoPE key ``kr``."""
    if cfg.attn_type == "mla":
        return {
            "ckv": torch.zeros((B, cache_len, cfg.kv_lora_rank), dtype=dtype,
                               device=device),
            "kr": torch.zeros((B, cache_len, cfg.rope_head_dim), dtype=dtype,
                              device=device),
        }
    W = min(cfg.window, cache_len) if cfg.window else cache_len
    return {
        "k": torch.zeros((B, W, cfg.n_kv_heads, cfg.hd), dtype=dtype, device=device),
        "v": torch.zeros((B, W, cfg.n_kv_heads, cfg.hd), dtype=dtype, device=device),
        "kpos": torch.full((B, W), -1, dtype=torch.int32, device=device),
    }


def attn_prefill(cfg: ModelConfig, p, x) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward that also returns the populated cache."""
    B, S, d = x.shape
    dev = x.device
    if cfg.attn_type == "mla":
        o, ckv, kr = _mla_train(cfg, p, x, return_cache=True)
        return o, {"ckv": ckv, "kr": kr}
    q, k, v = _qkv(cfg, p, x, torch.arange(S, device=dev))
    scale = 1.0 / math.sqrt(cfg.hd)
    # (B, H, S, hd) views of the (B, S, H, hd) projections: the kernel reads
    # them through their strides, no copy
    o = _attend(cfg, q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=True, window=cfg.window, scale=scale)
    o = o.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.hd)
    if cfg.window and cfg.window < S:
        W = cfg.window
        # last W positions land at ring slots (pos % W)
        pos = torch.arange(S - W, S, device=dev)
        slots = pos % W
        k_ring = torch.zeros((B, W) + tuple(k.shape[2:]), dtype=k.dtype, device=dev)
        v_ring = torch.zeros((B, W) + tuple(v.shape[2:]), dtype=v.dtype, device=dev)
        k_ring[:, slots] = k[:, S - W:]
        v_ring[:, slots] = v[:, S - W:]
        kpos = torch.full((W,), -1, dtype=torch.int32, device=dev)
        kpos[slots] = pos.to(torch.int32)
        cache = {"k": k_ring, "v": v_ring,
                 "kpos": kpos.expand(B, W).contiguous()}
    else:
        cache = {"k": k, "v": v,
                 "kpos": torch.arange(S, dtype=torch.int32, device=dev)
                 .expand(B, S).contiguous()}
    return o @ p["wo"], cache


def attn_decode(cfg: ModelConfig, p, x, cache: Dict, pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode.  x: (B, 1, d); pos: per-row (B,) int positions
    (continuous-batching engines re-prefill individual slots, so rows may
    sit at different depths).

    The cache's tensors are updated in place (the JAX engine donates its
    cache to the decode step, so nothing reads the old values) and are
    returned in a new dict."""
    if cfg.attn_type == "mla":
        return _mla_decode(cfg, p, x, cache, pos)
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pos = pos.to(torch.int32).expand(B)
    q, k1, v1 = _qkv(cfg, p, x, pos[:, None])      # per-row RoPE positions
    k, v, kpos = cache["k"], cache["v"], cache["kpos"]
    W = k.shape[1]
    slot = (pos % W).long()
    rows = torch.arange(B, device=x.device)
    k[rows, slot] = k1[:, 0]
    v[rows, slot] = v1[:, 0]
    kpos[rows, slot] = pos
    scale = 1.0 / math.sqrt(hd)
    group = H // Hkv
    qg = q.to(F32).reshape(B, Hkv, group, hd)     # grouped layout
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.to(F32)) * scale
    valid = (kpos >= 0) & (kpos <= pos[:, None])
    if cfg.window:
        valid = valid & (kpos > (pos - cfg.window)[:, None])
    s = torch.where(valid[:, None, None, :], s,
                    torch.tensor(NEG, dtype=F32, device=x.device))
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", pr, v.to(F32)).to(x.dtype)
    o = o.reshape(B, 1, H * hd)
    return o @ p["wo"], {"k": k, "v": v, "kpos": kpos}


# =============================================================== MLA paths


def _mla_q(cfg, p, x, positions):
    B, S, _ = x.shape
    H, dn, dr = cfg.n_heads, cfg.hd, cfg.rope_head_dim
    cq = x @ p["wdq"]
    cq = apply_norm(cfg.with_(norm_type="rmsnorm"), {"scale": p["q_norm"]}, cq)
    q = (cq @ p["wuq"]).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    cos, sin = rope_cos_sin(positions, dr, cfg.rope_theta)
    return q_nope, apply_rope(q_rope, cos, sin)


def _mla_kv_compress(cfg, p, x, positions):
    kvr, dr = cfg.kv_lora_rank, cfg.rope_head_dim
    ckv_full = x @ p["wdkv"]                                   # (B,S,kvr+dr)
    ckv, kr = ckv_full[..., :kvr], ckv_full[..., kvr:]
    ckv = apply_norm(cfg.with_(norm_type="rmsnorm"), {"scale": p["kv_norm"]},
                     ckv)
    cos, sin = rope_cos_sin(positions, dr, cfg.rope_theta)
    kr = apply_rope(kr[:, :, None, :], cos, sin)[:, :, 0, :]   # shared by heads
    return ckv, kr


def _mla_train(cfg, p, x, *, return_cache: bool = False):
    B, S, _ = x.shape
    H, dn, dr, dv = cfg.n_heads, cfg.hd, cfg.rope_head_dim, cfg.v_head_dim
    positions = torch.arange(S, device=x.device)
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    ckv, kr = _mla_kv_compress(cfg, p, x, positions)
    k_nope = (ckv @ p["wuk"]).reshape(B, S, H, dn)
    v = (ckv @ p["wuv"]).reshape(B, S, H, dv)
    q = torch.cat([q_nope, q_rope], -1)                        # (B,S,H,dn+dr)
    k = torch.cat([k_nope, kr[:, :, None, :].expand(B, S, H, dr)], -1)
    scale = 1.0 / math.sqrt(dn + dr)
    o = _attend(cfg, q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=True, window=None, scale=scale)
    out = o.transpose(1, 2).reshape(B, S, H * dv) @ p["wo"]
    if return_cache:
        return out, ckv, kr
    return out


def _mla_decode(cfg, p, x, cache, pos):
    """Absorbed MLA decode: attention runs in the latent (kv_lora) space,
    the compressed cache is never decompressed.  ``pos``: per-row (B,).
    The cache's tensors are updated in place; a row at or past the cache's
    length writes nothing, as JAX drops an out-of-bounds scatter."""
    B = x.shape[0]
    H, dn, dr, dv = cfg.n_heads, cfg.hd, cfg.rope_head_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    pos = pos.to(torch.int32).expand(B)
    q_nope, q_rope = _mla_q(cfg, p, x, pos[:, None])          # (B,1,H,*)
    ckv1, kr1 = _mla_kv_compress(cfg, p, x, pos[:, None])     # (B,1,kvr),(B,1,dr)
    ckv, kr = cache["ckv"], cache["kr"]
    S = ckv.shape[1]
    rows = torch.arange(B, device=x.device)
    slot = pos.clamp(max=S - 1).long()
    keep = (pos < S)[:, None]
    ckv[rows, slot] = torch.where(keep, ckv1[:, 0], ckv[rows, slot])
    kr[rows, slot] = torch.where(keep, kr1[:, 0], kr[rows, slot])
    wuk = p["wuk"].reshape(kvr, H, dn)
    # absorb: q_lat[b,h,:] = W_uk[:,h,:] @ q_nope[b,h,:]
    q_lat = torch.einsum("bhd,khd->bhk", q_nope[:, 0].to(F32), wuk.to(F32))
    s = torch.einsum("bhk,bsk->bhs", q_lat, ckv.to(F32))
    s = s + torch.einsum("bhr,bsr->bhs", q_rope[:, 0].to(F32), kr.to(F32))
    s = s * (1.0 / math.sqrt(dn + dr))
    mask = torch.arange(S, device=x.device)[None, :] <= pos[:, None]  # (B,S)
    s = torch.where(mask[:, None, :], s,
                    torch.tensor(NEG, dtype=F32, device=x.device))
    pr = torch.softmax(s, dim=-1)
    ctx_lat = torch.einsum("bhs,bsk->bhk", pr, ckv.to(F32))   # (B,H,kvr)
    wuv = p["wuv"].reshape(kvr, H, dv)
    o = torch.einsum("bhk,khd->bhd", ctx_lat, wuv.to(F32)).to(x.dtype)
    return o.reshape(B, 1, H * dv) @ p["wo"], {"ckv": ckv, "kr": kr}


# ============================================================ cross-attn


def cross_train(cfg: ModelConfig, p, x, enc: torch.Tensor) -> torch.Tensor:
    """Decoder cross-attention over encoder output ``enc`` (B, Se, d):
    non-causal, no RoPE."""
    B, S, d = x.shape
    Se = enc.shape[1]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (enc @ p["wk"]).reshape(B, Se, Hkv, hd)
    v = (enc @ p["wv"]).reshape(B, Se, Hkv, hd)
    o = _attend(cfg, q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=False, window=None, scale=1.0 / math.sqrt(hd))
    return o.transpose(1, 2).reshape(B, S, H * hd) @ p["wo"]


def make_cross_cache(cfg: ModelConfig, p, enc: torch.Tensor) -> Dict:
    B, Se, _ = enc.shape
    Hkv, hd = cfg.n_kv_heads, cfg.hd
    return {"k": (enc @ p["wk"]).reshape(B, Se, Hkv, hd),
            "v": (enc @ p["wv"]).reshape(B, Se, Hkv, hd)}


def cross_decode(cfg: ModelConfig, p, x, cross_cache: Dict) -> torch.Tensor:
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    group = H // Hkv
    q = (x @ p["wq"]).reshape(B, H, hd)
    kf, vf = cross_cache["k"].to(F32), cross_cache["v"].to(F32)
    if group > 1:
        kf = kf.repeat_interleave(group, dim=2)
        vf = vf.repeat_interleave(group, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.to(F32), kf) / math.sqrt(hd)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhs,bshd->bhd", pr, vf).to(x.dtype).reshape(B, 1, H * hd)
    return o @ p["wo"]
