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
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..kernels import ops as kops
from ..kernels.ref import attention_ref
from ..parallel.collective_planner import (collective, enter_parallel,
                                           enter_region, gather_replicated,
                                           gather_shards, leave_parallel,
                                           leave_region, model_axis,
                                           sum_cotangent)
from ..parallel.sharding import cache_block, split_over
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


class _Heads(NamedTuple):
    """q of the heads [h0, h0 + n), (B, S, n, hd), and k/v of the kv heads
    [kv0, kv0 + nk), (B, Skv, nk, hd)."""
    q: torch.Tensor
    h0: int
    k: torch.Tensor
    v: torch.Tensor
    kv0: int


def _q_proj(cfg: ModelConfig, p, x, mesh=None, *, all_heads: bool = False):
    """(q (B, S, n, hd), h0): every head without a mesh.  On a mesh ``wq``
    holds this rank's ``H / m`` whole heads where H splits; where its
    columns cut a head, or with ``all_heads``, the q projection is
    All-Gathered over ``model`` (``tp/q-gather``) and q holds every head.
    Weights kept whole give every head."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    qp, h0 = x @ p["wq"], 0
    if mesh is not None:
        m, r, group = model_axis(mesh)
        if split_over(qp.shape[-1], H * hd, m):
            if H % m or (all_heads and m > 1):
                qp = gather_shards(qp, group, "tp/q-gather", "tp/q-gather")
            else:
                h0 = r * (H // m)
    return qp.reshape(B, S, -1, hd), h0


def _kv_proj(cfg: ModelConfig, p, src, mesh=None):
    """(k, v (B, Skv, nk, hd), kv0) of ``src``: every kv head without a
    mesh.  On a mesh ``wk``/``wv`` hold this rank's whole kv heads where
    Hkv splits; otherwise their projections are All-Gathered over
    ``model`` (``tp/kv-gather``) and every kv head kept.  Weights kept
    whole give every kv head."""
    B, Skv, _ = src.shape
    Hkv, hd = cfg.n_kv_heads, cfg.hd
    kp, vp, kv0 = src @ p["wk"], src @ p["wv"], 0
    if mesh is not None:
        m, r, group = model_axis(mesh)
        if split_over(kp.shape[-1], Hkv * hd, m):
            if Hkv % m:
                kp = gather_shards(kp, group, "tp/kv-gather", "tp/kv-gather")
                vp = gather_shards(vp, group, "tp/kv-gather", "tp/kv-gather")
            else:
                kv0 = r * (Hkv // m)
    return kp.reshape(B, Skv, -1, hd), vp.reshape(B, Skv, -1, hd), kv0


def _heads(cfg: ModelConfig, p, x, positions, mesh=None, *,
           all_heads: bool = False) -> _Heads:
    """The q heads this rank attends and the kv heads it holds
    (:func:`_q_proj`, :func:`_kv_proj`; each gather's transpose is a
    Reduce-Scatter of its cotangent), q/k-normed and roped at
    ``positions``.  On a mesh the norm scales act on the rank's heads, so
    their cotangents are SUM-All-Reduced over ``model``
    (``tp/qk-norm-grad``) where the block's output is partial."""
    q, h0 = _q_proj(cfg, p, x, mesh, all_heads=all_heads)
    k, v, kv0 = _kv_proj(cfg, p, x, mesh)
    if cfg.qk_norm:
        qs, ks = p["q_norm"], p["k_norm"]
        if mesh is not None and _partial(cfg, p, mesh):
            group = model_axis(mesh)[2]
            qs = sum_cotangent(qs, group, "tp/qk-norm-grad")
            ks = sum_cotangent(ks, group, "tp/qk-norm-grad")
        qn, kn = {"scale": qs}, {"scale": ks}
        if cfg.norm_type == "layernorm":
            qn["bias"] = torch.zeros_like(qs)
            kn["bias"] = torch.zeros_like(ks)
        q = apply_norm(cfg, qn, q)
        k = apply_norm(cfg, kn, k)
    cos, sin = rope_cos_sin(positions, cfg.hd, cfg.rope_theta)
    return _Heads(apply_rope(q, cos, sin), h0, apply_rope(k, cos, sin), v,
                  kv0)


def _kv_heads(H: int, Hkv: int, h0: int, n: int):
    """The kv heads that q heads [h0, h0 + n) read, as a slice of the kv
    heads when the local GQA group is uniform, else an index a q head."""
    g = H // Hkv
    if n % g == 0:
        return slice(h0 // g, (h0 + n) // g)
    if g % n == 0:
        return slice(h0 // g, h0 // g + 1)
    return torch.arange(h0, h0 + n) // g


def _attend_heads(cfg: ModelConfig, hs: _Heads, *, causal: bool,
                  window: Optional[int]) -> torch.Tensor:
    """``hs``'s q heads over the kv heads they read (the FlashAttention
    kernel with ``use_kernels``): (B, S, n * hd).  Where the rank holds its
    own kv heads they are exactly those its q heads read."""
    B, S, n = hs.q.shape[:3]
    sel = (slice(None) if hs.k.shape[2] < cfg.n_kv_heads
           else _kv_heads(cfg.n_heads, cfg.n_kv_heads, hs.h0, n))
    # (B, H, S, hd) views of the (B, S, H, hd) projections: the kernel
    # reads them through their strides, no copy
    o = _attend(cfg, hs.q.transpose(1, 2), hs.k[:, :, sel].transpose(1, 2),
                hs.v[:, :, sel].transpose(1, 2), causal=causal,
                window=window, scale=1.0 / math.sqrt(cfg.hd))
    return o.transpose(1, 2).reshape(B, S, n * cfg.hd)


def _partial(cfg: ModelConfig, p, mesh) -> bool:
    """Whether the attention's output on a mesh is a partial sum over
    ``model`` (``wo``'s rows split), not whole on every rank."""
    dv = cfg.v_head_dim if cfg.attn_type == "mla" else cfg.hd
    return split_over(p["wo"].shape[0], cfg.n_heads * dv,
                      model_axis(mesh)[0])


def _heads_out(o: torch.Tensor, c0: int, wo: torch.Tensor, full: int,
               mesh=None, seq=None) -> torch.Tensor:
    """The output projection of heads' outputs ``o`` (..., columns from
    global column ``c0`` on).  On a mesh where ``wo``'s ``full`` rows are
    split, this rank's rows take their columns of ``o`` and the partial
    products are SUM-All-Reduced over ``model`` (Megatron's *g*,
    ``tp/attn-out``), or Reduce-Scattered over the sequence with ``seq``;
    ``wo`` kept whole takes all of ``o`` (every head), with no collective
    (with ``seq``, the rank's rows of it)."""
    if mesh is None:
        return o @ wo
    m, r, group = model_axis(mesh)
    rows = wo.shape[0]
    partial = split_over(rows, full, m)
    c = r * rows - c0
    y = o[..., c:c + rows] @ wo if partial else o @ wo
    if seq:
        return leave_region(y, group, "tp/attn-out", partial=partial,
                            seq=seq)
    return leave_parallel(y, group, "tp/attn-out") if partial else y


def attn_train(cfg: ModelConfig, p, x, *, causal: bool = True, mesh=None,
               seq=None) -> torch.Tensor:
    """Full-sequence self-attention.  On a mesh it is tensor-parallel over
    ``model``: GQA's *f* before the q/k/v projections, this rank's heads
    (:func:`_heads`) through the attention (the FlashAttention kernel with
    ``use_kernels``), its rows of ``wo``, and *g* after (both
    ``tp/attn-out``); MLA's as :func:`_mla_train` says.  With ``seq``
    ("rows": x is this rank's block of the sequence; "gathered": the
    caller gathered it) the rows are gathered in (``tp/seq-gather``) and
    the output's rows Reduce-Scattered out (``tp/attn-out``)."""
    if cfg.attn_type == "mla":
        return _mla_train(cfg, p, x, mesh=mesh, seq=seq)
    if mesh is not None:
        x = enter_region(x, model_axis(mesh)[2], "tp/attn-out",
                         partial=_partial(cfg, p, mesh), seq=seq)
    S = x.shape[1]
    hs = _heads(cfg, p, x, torch.arange(S, device=x.device), mesh)
    o = _attend_heads(cfg, hs, causal=causal, window=cfg.window)
    return _heads_out(o, hs.h0 * cfg.hd, p["wo"], cfg.n_heads * cfg.hd, mesh,
                      seq)


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


def _slot_positions(S: int, W: int, s0: int, s1: int, device
                    ) -> torch.Tensor:
    """The position that each of the slots [s0, s1) of a W-slot cache holds
    after a prefill of S positions: the latest with ``pos % W == slot``
    (a ring when W < S), -1 for an empty slot."""
    s = torch.arange(s0, s1, device=device)
    return torch.where(s < S, s + W * ((S - 1 - s).clamp(min=0) // W), -1)


def _cache_rows(t: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The positions ``src`` of t (B, S, ...), zeros where ``src`` is -1."""
    keep = (src >= 0).view((1, -1) + (1,) * (t.ndim - 2))
    return torch.where(keep, t[:, src.clamp(min=0)], 0)


def _kv_cache(cfg: ModelConfig, k, v, kv0: int, W: int, mesh=None, *,
              kpos: bool = True) -> Dict:
    """The W-slot cache of a prefill's k/v (B, S, nk, hd): without a mesh
    the whole cache; on a mesh this rank's block of it
    (``sharding.cache_block``: its kv heads, or its slots of a
    sequence-sharded cache).  ``kpos`` (B, W) is whole on every rank."""
    B, S, nk, hd = k.shape
    (s0, s1), (a, b) = ((0, W), (kv0, kv0 + nk)) if mesh is None else \
        cache_block("k", (B, W, cfg.n_kv_heads, hd), mesh)[1:3]
    src = _slot_positions(S, W, 0, W, k.device)
    heads = slice(a - kv0, b - kv0)
    out = {"k": _cache_rows(k[:, :, heads], src[s0:s1]),
           "v": _cache_rows(v[:, :, heads], src[s0:s1])}
    if kpos:
        out["kpos"] = src.to(torch.int32).expand(B, W).contiguous()
    return out


def attn_prefill(cfg: ModelConfig, p, x, cache_len: Optional[int] = None,
                 mesh=None, seq=None) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward that also returns the populated cache, of
    ``cache_len`` slots (default the prompt's S; a window's ring holds
    min(window, cache_len)).  On a mesh the heads are tensor-parallel as in
    :func:`attn_train` (``seq`` as there) and the cache is this rank's
    shard of it, built from the whole sequence's k/v."""
    if cfg.attn_type == "mla":
        return _mla_prefill(cfg, p, x, cache_len, mesh, seq)
    if mesh is not None and seq:
        x = enter_region(x, model_axis(mesh)[2], "tp/attn-out",
                         partial=_partial(cfg, p, mesh), seq=seq)
    B, S, d = x.shape
    L = cache_len or S
    hs = _heads(cfg, p, x, torch.arange(S, device=x.device), mesh)
    o = _attend_heads(cfg, hs, causal=True, window=cfg.window)
    W = min(cfg.window, L) if cfg.window else L
    return (_heads_out(o, hs.h0 * cfg.hd, p["wo"], cfg.n_heads * cfg.hd,
                       mesh, seq),
            _kv_cache(cfg, hs.k, hs.v, hs.kv0, W, mesh))


def _softmax_apply(s: torch.Tensor, valid: torch.Tensor, apply,
                   group=None) -> torch.Tensor:
    """``apply(softmax(s))``, the softmax over the last dim of the scores
    ``s`` where ``valid``, and ``apply`` the product of the probabilities
    with the values (..., D).  With ``group``, ``s`` holds this rank's
    shard of the keys and the partials merge over ``group`` in f32 with
    explicit collectives (the paper's distSM): a MAX All-Reduce of the
    rows' maxima (``serve/attn-max``), then one SUM All-Reduce of the
    exp-sums and the outputs at that max, in one buffer
    (``serve/attn-sum``).  A masked slot adds exactly zero, and a row no
    rank sees gives zeros, not NaN."""
    s = torch.where(valid, s, NEG)
    if group is None:
        return apply(torch.softmax(s, dim=-1))
    mx = collective("AllReduce", "serve/attn-max", s.amax(-1), group,
                    op=dist.ReduceOp.MAX)
    pr = torch.where(valid, torch.exp(s - mx[..., None]), 0.0)
    both = collective("AllReduce", "serve/attn-sum",
                      torch.cat([apply(pr), pr.sum(-1)[..., None]], -1),
                      group)
    l = both[..., -1:]
    return both[..., :-1] / torch.where(l == 0, 1.0, l)


def attn_decode(cfg: ModelConfig, p, x, cache: Dict, pos: torch.Tensor,
                mesh=None, cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode.  x: (B, 1, d); pos: per-row (B,) int positions
    (continuous-batching engines re-prefill individual slots, so rows may
    sit at different depths).

    The cache's tensors are updated in place (the JAX engine donates its
    cache to the decode step, so nothing reads the old values) and are
    returned in a new dict.  On a mesh the cache is this rank's shard:
    where it holds the rank's kv heads, its q heads attend them; where it
    holds the rank's slots of every kv head (a sequence-sharded cache),
    every q head is gathered, attends the rank's slots, and the partials
    merge by distSM (:func:`_softmax_apply`); only the rank that holds the
    new token's slot writes it.  ``cache_len``: MLA's cache length on a
    mesh (its shard does not show whether it was split)."""
    if cfg.attn_type == "mla":
        return _mla_decode(cfg, p, x, cache, pos, mesh, cache_len)
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pos = pos.to(torch.int32).expand(B)
    k, v, kpos = cache["k"], cache["v"], cache["kpos"]
    W, Wl = kpos.shape[1], k.shape[1]
    # per-row RoPE positions
    hs = _heads(cfg, p, x, pos[:, None], mesh,
                all_heads=k.shape[2] == Hkv)
    slot = (pos % W).long()
    rows = torch.arange(B, device=x.device)
    kpos[rows, slot] = pos
    s0, group = 0, None
    if Wl < W:                     # this rank's slots of every kv head
        _, r, group = model_axis(mesh)
        s0 = r * Wl
        mine = ((slot >= s0) & (slot < s0 + Wl))[:, None, None]
        ls = (slot - s0).clamp(0, Wl - 1)
        k[rows, ls] = torch.where(mine, hs.k[:, 0], k[rows, ls])
        v[rows, ls] = torch.where(mine, hs.v[:, 0], v[rows, ls])
    else:
        k[rows, slot] = hs.k[:, 0]
        v[rows, slot] = hs.v[:, 0]
    kp = kpos[:, s0:s0 + Wl]
    valid = (kp >= 0) & (kp <= pos[:, None])
    if cfg.window:
        valid = valid & (kp > (pos - cfg.window)[:, None])
    qg = hs.q.to(F32).reshape(B, k.shape[2], -1, hd)   # grouped layout
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.to(F32)) * (1.0 / math.sqrt(hd))
    vf = v.to(F32)
    o = _softmax_apply(s, valid[:, None, None, :],
                       lambda pr: torch.einsum("bhgs,bshd->bhgd", pr, vf),
                       group)
    o = o.to(x.dtype).reshape(B, 1, -1)
    return (_heads_out(o, hs.h0 * hd, p["wo"], H * hd, mesh),
            {"k": k, "v": v, "kpos": kpos})


# =============================================================== MLA paths


def _mla_split(cfg: ModelConfig, p, mesh) -> bool:
    """Whether this rank holds whole heads of MLA's up projections and
    ``wo``: H splits over ``model`` and so do the weights (not kept whole,
    as ``tensor_parallel=False`` keeps them)."""
    m = model_axis(mesh)[0]
    return cfg.n_heads % m == 0 and _partial(cfg, p, mesh)


def _mla_heads(cfg: ModelConfig, p, mesh=None):
    """(weights, h0): the MLA weights this rank runs and its first head.
    Without a mesh, or where H and the weights split over ``model``, the
    weights as they are (``wuq``/``wuk``/``wuv``'s columns and ``wo``'s
    rows this rank's whole heads); otherwise each split one is
    All-Gathered whole (``tp/mla-gather``; every rank uses it whole, so its
    transpose is the rank's block) and every rank runs every head."""
    if mesh is None:
        return p, 0
    m, r, group = model_axis(mesh)
    H = cfg.n_heads
    if _mla_split(cfg, p, mesh):
        return p, r * (H // m)
    dn, dr, dv = cfg.hd, cfg.rope_head_dim, cfg.v_head_dim
    p = dict(p)
    for key, cols, dim in (("wuq", H * (dn + dr), -1), ("wuk", H * dn, -1),
                           ("wuv", H * dv, -1), ("wo", H * dv, 0)):
        if split_over(p[key].shape[dim], cols, m):
            p[key] = gather_replicated(p[key], group, "tp/mla-gather",
                                       dim=dim)
    return p, 0


def _mla_latents(cfg, p, x, positions, mesh=None):
    """(the normed q latent, the normed kv latent, the roped shared key) of
    x, which every rank computes whole from the replicated down
    projections.  Where the heads split over ``model`` each rank reads
    them for its heads only: their cotangents are partial, SUM-All-Reduced
    in one buffer (*f* at the latents, ``tp/mla-latent``), so that the
    down projections' and norms' gradients are whole on every rank."""
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    cq = _mla_q_latent(cfg, p, x)
    ckv, kr = _mla_kv_compress(cfg, p, x, positions)
    if mesh is not None and _mla_split(cfg, p, mesh):
        both = enter_parallel(torch.cat([cq, ckv, kr], -1),
                              model_axis(mesh)[2], "tp/mla-latent")
        cq, ckv, kr = both.split([qr, kvr, kr.shape[-1]], -1)
    return cq, ckv, kr


def _mla_q_latent(cfg, p, x):
    """x's normed q latent (..., q_lora_rank)."""
    return apply_norm(cfg.with_(norm_type="rmsnorm"), {"scale": p["q_norm"]},
                      x @ p["wdq"])


def _mla_q(cfg, p, cq, positions):
    """(q_nope, roped q_rope) of the heads, from the q latent ``cq``."""
    B, S, _ = cq.shape
    dn, dr = cfg.hd, cfg.rope_head_dim
    q = (cq @ p["wuq"]).reshape(B, S, -1, dn + dr)
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


def _mla_train(cfg, p, x, *, return_cache: bool = False, mesh=None,
               seq=None):
    """MLA over the full sequence; on a mesh its heads are this rank's
    (:func:`_mla_heads`), the output reduced by :func:`_heads_out` (*g*,
    ``tp/attn-out``) and the latents' cotangents by
    :func:`_mla_latents`.  With ``seq`` ("rows") x's rows are gathered in
    (``tp/seq-gather``; the latents' *f* makes its cotangent whole, so the
    gather transposes to the rank's block) and the output's rows
    Reduce-Scattered out."""
    if mesh is not None and seq:
        x = enter_region(x, model_axis(mesh)[2], "tp/attn-out",
                         partial=False, seq=seq)
    B, S, _ = x.shape
    H, dn, dr, dv = cfg.n_heads, cfg.hd, cfg.rope_head_dim, cfg.v_head_dim
    p, h0 = _mla_heads(cfg, p, mesh)
    positions = torch.arange(S, device=x.device)
    cq, ckv, kr = _mla_latents(cfg, p, x, positions, mesh)
    q_nope, q_rope = _mla_q(cfg, p, cq, positions)
    n = q_nope.shape[2]
    k_nope = (ckv @ p["wuk"]).reshape(B, S, n, dn)
    v = (ckv @ p["wuv"]).reshape(B, S, n, dv)
    q = torch.cat([q_nope, q_rope], -1)                        # (B,S,n,dn+dr)
    k = torch.cat([k_nope, kr[:, :, None, :].expand(B, S, n, dr)], -1)
    scale = 1.0 / math.sqrt(dn + dr)
    o = _attend(cfg, q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=True, window=None, scale=scale)
    out = _heads_out(o.transpose(1, 2).reshape(B, S, n * dv), h0 * dv,
                     p["wo"], H * dv, mesh, seq)
    if return_cache:
        return out, ckv, kr
    return out


def _mla_prefill(cfg, p, x, cache_len: Optional[int], mesh=None, seq=None):
    """MLA's prefill: the output and its latent cache of ``cache_len``
    slots (default the prompt's), on a mesh this rank's slots
    (``sharding.cache_block``)."""
    out, ckv, kr = _mla_train(cfg, p, x, return_cache=True, mesh=mesh,
                              seq=seq)
    B, S, _ = ckv.shape
    cache_len = cache_len or S
    s0, s1 = (0, cache_len) if mesh is None else cache_block(
        "ckv", (B, cache_len, cfg.kv_lora_rank), mesh)[1]
    src = _slot_positions(S, cache_len, s0, s1, x.device)
    return out, {"ckv": _cache_rows(ckv, src), "kr": _cache_rows(kr, src)}


def _mla_decode(cfg, p, x, cache, pos, mesh=None, cache_len=None):
    """Absorbed MLA decode: attention runs in the latent (kv_lora) space,
    the compressed cache is never decompressed.  ``pos``: per-row (B,).
    The cache's tensors are updated in place; a row at or past the cache's
    length writes nothing, as JAX drops an out-of-bounds scatter.  On a
    mesh the heads are this rank's (:func:`_mla_heads`) and the cache its
    shard of ``cache_len`` slots: on its slots of a sequence-sharded cache
    every head's latent query is gathered (``tp/q-gather``) and the
    partials merge by distSM."""
    B = x.shape[0]
    H, dn, dr, dv = cfg.n_heads, cfg.hd, cfg.rope_head_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    pos = pos.to(torch.int32).expand(B)
    ckv, kr = cache["ckv"], cache["kr"]
    Sl = ckv.shape[1]
    S, s0, group = Sl, 0, None
    if mesh is not None:
        if cache_len is None:
            raise ValueError("MLA's decode on a mesh needs the cache's "
                             "length (cache_len)")
        S = cache_len
        s0 = cache_block("ckv", (B, S, kvr), mesh)[1][0]
        if Sl < S:
            group = model_axis(mesh)[2]
    p, h0 = _mla_heads(cfg, p, mesh)
    q_nope, q_rope = _mla_q(cfg, p, _mla_q_latent(cfg, p, x),
                            pos[:, None])                     # (B,1,n,*)
    n = q_nope.shape[2]
    ckv1, kr1 = _mla_kv_compress(cfg, p, x, pos[:, None])     # (B,1,kvr),(B,1,dr)
    rows = torch.arange(B, device=x.device)
    slot = (pos - s0).clamp(0, Sl - 1).long()
    keep = ((pos < S) & (pos >= s0) & (pos < s0 + Sl))[:, None]
    ckv[rows, slot] = torch.where(keep, ckv1[:, 0], ckv[rows, slot])
    kr[rows, slot] = torch.where(keep, kr1[:, 0], kr[rows, slot])
    wuk = p["wuk"].reshape(kvr, n, dn)
    # absorb: q_lat[b,h,:] = W_uk[:,h,:] @ q_nope[b,h,:]
    q_lat = torch.einsum("bhd,khd->bhk", q_nope[:, 0].to(F32), wuk.to(F32))
    q_r = q_rope[:, 0].to(F32)
    if group is not None:          # every head over this rank's slots
        both = collective("AllGather", "tp/q-gather",
                          torch.cat([q_lat, q_r], -1), group, dim=1)
        q_lat, q_r = both[..., :kvr], both[..., kvr:]
    ckvf = ckv.to(F32)
    s = torch.einsum("bhk,bsk->bhs", q_lat, ckvf)
    s = s + torch.einsum("bhr,bsr->bhs", q_r, kr.to(F32))
    s = s * (1.0 / math.sqrt(dn + dr))
    mask = (s0 + torch.arange(Sl, device=x.device))[None, :] <= pos[:, None]
    ctx_lat = _softmax_apply(s, mask[:, None, :],
                             lambda pr: torch.einsum("bhs,bsk->bhk", pr,
                                                     ckvf), group)
    if group is not None:
        ctx_lat = ctx_lat[:, h0:h0 + n]                        # (B,n,kvr)
    wuv = p["wuv"].reshape(kvr, n, dv)
    o = torch.einsum("bhk,khd->bhd", ctx_lat, wuv.to(F32)).to(x.dtype)
    return (_heads_out(o.reshape(B, 1, n * dv), h0 * dv, p["wo"], H * dv,
                       mesh), {"ckv": ckv, "kr": kr})


# ============================================================ cross-attn


def cross_train(cfg: ModelConfig, p, x, enc: torch.Tensor, mesh=None
                ) -> torch.Tensor:
    """Decoder cross-attention over encoder output ``enc`` (B, Se, d):
    non-causal, no RoPE; on a mesh heads-parallel as :func:`attn_train`
    (*f* on x).  ``enc`` is replicated over ``model`` and read for the
    rank's heads: under autograd its cotangent is partial, and the caller
    reduces it (``encdec.encdec_forward``, once for every layer)."""
    if mesh is not None and _partial(cfg, p, mesh):
        x = enter_parallel(x, model_axis(mesh)[2], "tp/attn-out")
    q, h0 = _q_proj(cfg, p, x, mesh)
    k, v, kv0 = _kv_proj(cfg, p, enc, mesh)
    o = _attend_heads(cfg, _Heads(q, h0, k, v, kv0), causal=False,
                      window=None)
    return _heads_out(o, h0 * cfg.hd, p["wo"], cfg.n_heads * cfg.hd, mesh)


def make_cross_cache(cfg: ModelConfig, p, enc: torch.Tensor, mesh=None
                     ) -> Dict:
    """The encoder output's k/v, on a mesh this rank's block of them."""
    k, v, kv0 = _kv_proj(cfg, p, enc, mesh)
    if mesh is None:
        return {"k": k, "v": v}
    return _kv_cache(cfg, k, v, kv0, enc.shape[1], mesh, kpos=False)


def cross_decode(cfg: ModelConfig, p, x, cross_cache: Dict, mesh=None
                 ) -> torch.Tensor:
    """One token's cross-attention over the cached encoder k/v.  On a mesh
    the cache is this rank's block: its kv heads, attended by its q heads;
    or else every kv head over its share of the frames, attended by every
    q head, merged by distSM over ``model``.  The block does not show
    whether the frames were split or kept whole on every rank; the merge
    is right for both (m equal partials scale both sums by m)."""
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if mesh is None:
        group = H // Hkv
        q = (x @ p["wq"]).reshape(B, H, hd)
        kf, vf = cross_cache["k"].to(F32), cross_cache["v"].to(F32)
        if group > 1:
            kf = kf.repeat_interleave(group, dim=2)
            vf = vf.repeat_interleave(group, dim=2)
        s = torch.einsum("bhd,bshd->bhs", q.to(F32), kf) / math.sqrt(hd)
        pr = torch.softmax(s, dim=-1)
        o = torch.einsum("bhs,bshd->bhd", pr, vf).to(x.dtype).reshape(
            B, 1, H * hd)
        return o @ p["wo"]
    kc, vc = cross_cache["k"], cross_cache["v"]
    m, _, g_model = model_axis(mesh)
    whole_heads = kc.shape[2] == Hkv
    q, h0 = _q_proj(cfg, p, x, mesh, all_heads=whole_heads)
    qg = q[:, 0].to(F32).reshape(B, kc.shape[2], -1, hd)
    s = torch.einsum("bhgd,bshd->bhgs", qg, kc.to(F32)) / math.sqrt(hd)
    vf = vc.to(F32)
    o = _softmax_apply(s, torch.ones_like(s, dtype=torch.bool),
                       lambda pr: torch.einsum("bhgs,bshd->bhgd", pr, vf),
                       g_model if whole_heads and m > 1 else None)
    return _heads_out(o.to(x.dtype).reshape(B, 1, -1), h0 * hd, p["wo"],
                      H * hd, mesh)
