"""Shared model layers: norms, RoPE, MLP, embeddings, the LM loss.

On a ``(data, model)`` mesh (``mesh=``) the MLP, the embedding and the
unembed take this rank's shards of their weights (``spec_for``'s
placements) and the Megatron collectives of ``parallel/collective_planner``:
the MLP is column-parallel over ``ff`` into its product and row-parallel
out of it (*f* before, *g* after, both ``tp/ffn-out``); the embedding
looks up the rank's block of the vocab and SUM-All-Reduces (``tp/embed``);
the unembed gathers its vocab columns (``tp/unembed-gather``).  A weight
that ``spec_for`` keeps whole (``d_ff`` or the vocab does not split) is
used whole on every rank, with no collective.  Under ``seq_shard``
(``seq=``) the residual is this rank's block of the sequence: the MLP
All-Gathers its rows in and Reduce-Scatters its partial product out
(``collective_planner.enter_region``/``leave_region``), and the
embedding Reduce-Scatters its partial rows (``tp/embed``).  Serving takes
each rank's block of the vocab-sharded logits and :func:`greedy_token`
picks the token over all of them (``serve/argmax``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.collective_planner import (collective, enter_region,
                                           gather_replicated, leave_parallel,
                                           leave_region, model_axis,
                                           scatter_shards, take_block)
from ..parallel.sharding import split_over
from .config import ModelConfig
from .param import ParamSpec

__all__ = [
    "norm_specs", "apply_norm", "rope_cos_sin", "apply_rope",
    "mlp_specs", "mlp_apply", "embed_specs", "embed_apply", "unembed_apply",
    "greedy_token", "cross_entropy_loss",
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
              x: torch.Tensor, mesh=None, seq=None) -> torch.Tensor:
    """SwiGLU MLP: silu(x@wg) * (x@wi) @ wo.  On a mesh ``wi``/``wg`` are
    this rank's ``ff`` columns and ``wo`` its rows: the product is partial
    and SUM-All-Reduced over ``model``; where ``d_ff`` does not split, the
    weights are whole and every rank computes the whole product.  With
    ``seq`` ("rows": x is this rank's rows of the sequence) the rows are
    gathered in and the product's rows scattered out."""
    if mesh is None:
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
        return h @ p["wo"]
    m, _, group = model_axis(mesh)
    partial = split_over(p["wi"].shape[-1], cfg.d_ff, m)
    x = enter_region(x, group, "tp/ffn-out", partial=partial, seq=seq)
    h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    return leave_region(h @ p["wo"], group, "tp/ffn-out", partial=partial,
                        seq=seq)


# -------------------------------------------------------------- embeddings


def embed_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    V, d = cfg.padded_vocab, cfg.d_model
    out = {"embedding": ParamSpec((V, d), ("vocab", "embed"), scale=1.0,
                                  dtype=cfg.dtype)}
    if not cfg.tie_embeddings:
        out["unembed"] = ParamSpec((d, V), ("embed", "vocab"), dtype=cfg.dtype)
    return out


def embed_apply(p: Dict[str, torch.Tensor], tokens: torch.Tensor,
                mesh=None, vocab: Optional[int] = None,
                seq: bool = False) -> torch.Tensor:
    """Token embeddings.  On a mesh the table is this rank's block of the
    padded vocab: each rank looks up the tokens that fall in it (zeros
    elsewhere) and the rows are SUM-All-Reduced over ``model``, exact (one
    nonzero term a row).  Given the padded ``vocab``, a table kept whole
    (``vocab`` does not split) is looked up whole, with no collective.
    With ``seq`` (``seq_shard``) each rank keeps its block of the sequence
    (dim 1): the partial rows Reduce-Scattered (``tp/embed``), a whole
    table's rows cut to the rank's block; both transpose to an
    All-Gather."""
    table = p["embedding"]
    if mesh is None:
        return table[tokens]
    m, r, group = model_axis(mesh)
    v = table.shape[0]
    if vocab is not None and not split_over(v, vocab, m):
        return take_block(table[tokens], group, "tp/embed", dim=1) if seq \
            else table[tokens]
    idx = tokens - r * v
    mine = (idx >= 0) & (idx < v)
    rows = torch.where(mine[..., None], table[idx.clamp(0, v - 1)], 0)
    if seq:
        return scatter_shards(rows, group, "tp/embed", dim=1)
    return leave_parallel(rows, group, "tp/embed")


def unembed_apply(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                  h: torch.Tensor, mesh=None) -> torch.Tensor:
    """Logits over the padded vocab.  On a mesh the vocab-sharded weight is
    gathered whole first (``tp/unembed-gather``): every model rank then
    computes the same logits and holds their whole cotangent, so the
    gather's transpose is the rank's block, with no collective.  A weight
    kept whole is used as it is."""
    w = p["embedding"] if cfg.tie_embeddings else p["unembed"]
    if mesh is not None and split_over(
            w.shape[0 if cfg.tie_embeddings else 1], cfg.padded_vocab,
            model_axis(mesh)[0]):
        _, _, group = model_axis(mesh)
        w = gather_replicated(w, group, "tp/unembed-gather",
                              dim=0 if cfg.tie_embeddings else 1)
    return h @ w.T if cfg.tie_embeddings else h @ w


def greedy_token(cfg: ModelConfig, logits: torch.Tensor, mesh=None
                 ) -> torch.Tensor:
    """The greedy token of each row of ``logits`` (..., V): the argmax over
    the real vocab, ties to the lowest index (``jnp.argmax`` over the
    padded logits cut to ``vocab_size``).  On a mesh ``logits`` are this
    rank's block of the padded vocab; each rank's best (value, index)
    pair is All-Gathered over ``model`` (``serve/argmax``, 8 bytes a row
    and rank, where gathering the logits would move 4 V) and the largest
    value wins, the lowest rank's on a tie, so the lowest index."""
    cols = logits.shape[-1]
    if mesh is None or not split_over(cols, cfg.padded_vocab,
                                      model_axis(mesh)[0]):
        return logits[..., :cfg.vocab_size].argmax(-1)
    m, r, group = model_axis(mesh)
    real = torch.arange(r * cols, (r + 1) * cols,
                        device=logits.device) < cfg.vocab_size
    lf = logits.float().masked_fill(~real, float("-inf"))
    best, idx = lf.max(-1)
    pairs = collective("AllGather", "serve/argmax",
                       torch.stack([best, (idx + r * cols).float()]), group,
                       dim=0).unflatten(0, (m, 2))
    win = pairs[:, 0].argmax(0, keepdim=True)
    return pairs[:, 1].gather(0, win)[0].long()


# -------------------------------------------------------------------- loss


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       real_vocab: int) -> torch.Tensor:
    """Mean token NLL in f32.  logits (B, S, Vp): padded vocab entries are
    masked with -1e30; labels (B, S) int in [0, real_vocab)."""
    lf = logits.to(F32)
    Vp = lf.shape[-1]
    if Vp > real_vocab:
        pad_mask = torch.arange(Vp, device=lf.device) >= real_vocab
        lf = lf.masked_fill(pad_mask, -1e30)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll)
