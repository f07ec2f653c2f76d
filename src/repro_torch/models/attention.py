"""Attention, GQA/MQA paths (optionally sliding-window, qk-norm): train
(full-seq), prefill (cache-building) and decode (cached, fixed-shape).

Training/prefill uses a *blocked* online-softmax implementation (a loop
over KV blocks, so the S×S score matrix is never materialized);
``use_kernels=True`` routes through the FlashAttention kernel instead.
Decode uses dense einsums over the cache.  MLA and cross-attention are not
ported yet (``transformer.check_supported`` refuses those models).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from ..kernels.ref import attention_ref
from .config import ModelConfig
from .layers import apply_norm, apply_rope, rope_cos_sin
from .param import ParamSpec

F32 = torch.float32
NEG = -1e30

__all__ = [
    "gqa_specs", "attn_train", "attn_prefill", "attn_decode",
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


# =============================================================== GQA paths


def _qkv(cfg: ModelConfig, p, x, positions):
    B, S, d = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, Hkv, hd)
    v = (x @ p["wv"]).reshape(B, S, Hkv, hd)
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


def attn_train(cfg: ModelConfig, p, x, *, causal: bool = True
               ) -> torch.Tensor:
    B, S, d = x.shape
    q, k, v = _qkv(cfg, p, x, torch.arange(S, device=x.device))
    scale = 1.0 / math.sqrt(cfg.hd)
    o = _attend(cfg, q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=causal, window=cfg.window, scale=scale)
    o = o.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.hd)
    return o @ p["wo"]


def init_attn_cache(cfg: ModelConfig, B: int, cache_len: int,
                    dtype: torch.dtype, device: torch.device) -> Dict:
    """Fixed-shape cache.  Windowed layers use a ring buffer of width
    min(window, cache_len); global layers use the full length.  ``kpos``
    is per-row (B, W): decode positions are per-slot so a serving engine
    can re-prefill one slot while the others keep decoding."""
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
