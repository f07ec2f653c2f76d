"""Shared model layers: norms, RoPE, MLP, embeddings."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .param import ParamSpec

__all__ = [
    "norm_specs", "apply_norm", "rope_cos_sin", "apply_rope",
    "mlp_specs", "mlp_apply", "embed_specs", "embed_apply", "unembed_apply",
]

F32 = torch.float32


# ------------------------------------------------------------------- norms


def norm_specs(cfg: ModelConfig, stacked: Optional[int] = None,
               dim: Optional[int] = None) -> Dict[str, ParamSpec]:
    d = dim or cfg.d_model
    shape = (stacked, d) if stacked else (d,)
    axes = ("layer", "embed") if stacked else ("embed",)
    out = {"scale": ParamSpec(shape, axes, init="ones", dtype=cfg.dtype)}
    if cfg.norm_type == "layernorm":
        out["bias"] = ParamSpec(shape, axes, init="zeros", dtype=cfg.dtype)
    return out


def apply_norm(cfg: ModelConfig, p: Dict[str, torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
    xf = x.to(F32)
    if cfg.norm_type == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].to(F32) + p["bias"].to(F32)
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"].to(F32)
    return y.to(x.dtype)


# -------------------------------------------------------------------- RoPE


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int -> cos/sin (..., dim//2) f32."""
    half = dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=F32,
                                          device=positions.device) / half))
    ang = positions.to(F32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., S, H, D); cos/sin: (S, D//2) (broadcast over batch/heads)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    c = cos[..., None, :]   # (S, 1, D/2) -> broadcast over heads
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# --------------------------------------------------------------------- MLP


def mlp_specs(cfg: ModelConfig, stacked: Optional[int] = None,
              d_ff: Optional[int] = None) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    L = (stacked,) if stacked else ()
    la = ("layer",) if stacked else ()
    return {
        "wi": ParamSpec(L + (d, f), la + ("embed", "ff"), dtype=cfg.dtype),
        "wg": ParamSpec(L + (d, f), la + ("embed", "ff"), dtype=cfg.dtype),
        "wo": ParamSpec(L + (f, d), la + ("ff", "embed"), dtype=cfg.dtype),
    }


def mlp_apply(cfg: ModelConfig, p: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: silu(x@wg) * (x@wi) @ wo."""
    h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    return h @ p["wo"]


# -------------------------------------------------------------- embeddings


def embed_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    V, d = cfg.padded_vocab, cfg.d_model
    out = {"embedding": ParamSpec((V, d), ("vocab", "embed"), scale=1.0,
                                  dtype=cfg.dtype)}
    if not cfg.tie_embeddings:
        out["unembed"] = ParamSpec((d, V), ("embed", "vocab"), dtype=cfg.dtype)
    return out


def embed_apply(p: Dict[str, torch.Tensor], tokens: torch.Tensor
                ) -> torch.Tensor:
    return p["embedding"][tokens]


def unembed_apply(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                  h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h @ p["embedding"].T
    return h @ p["unembed"]
