"""Decoder-LM engine, dense GQA/MQA path.  Layer parameters are stacked
``(L, ...)`` leaves as in the JAX package; where JAX scans over the stack,
the port loops over layer slices.

Paths: ``forward`` (full-seq causal logits), ``prefill`` (builds the
cache), ``decode`` (one token, fixed shapes).  The moe, mla, ssm, hybrid
and encdec families are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from . import attention as attn
from .config import ModelConfig
from .layers import (apply_norm, embed_apply, embed_specs, mlp_apply,
                     mlp_specs, norm_specs, unembed_apply)
from .param import torch_dtype, tree_leaves, tree_map

__all__ = ["decoder_specs", "forward", "prefill", "decode", "init_cache",
           "check_supported"]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the family for a model this
    port does not run yet."""
    family = ("encdec" if cfg.is_encdec else "moe" if cfg.is_moe
              else "mla" if cfg.attn_type == "mla"
              else "hybrid" if cfg.family == "hybrid"
              else "ssm" if cfg.has_ssm or not cfg.has_attention else None)
    if family is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {family} family (config family "
            f"{cfg.family!r}) is not ported yet; only dense GQA decoders are")


def _layer(params: Dict, l: int) -> Dict:
    """Layer ``l``'s slice of the stacked ``(L, ...)`` leaves (views)."""
    return tree_map(lambda a: a[l], params)


def _n_layers(stacked: Dict) -> int:
    return tree_leaves(stacked)[0].shape[0]


# ------------------------------------------------------------------ specs


def _layer_specs(cfg: ModelConfig, L: int) -> Dict[str, Any]:
    s: Dict[str, Any] = {"norm1": norm_specs(cfg, L),
                         "attn": attn.gqa_specs(cfg, L)}
    if cfg.d_ff > 0:
        s["norm2"] = norm_specs(cfg, L)
        s["mlp"] = mlp_specs(cfg, L)
    return s


def decoder_specs(cfg: ModelConfig) -> Dict[str, Any]:
    check_supported(cfg)
    s: Dict[str, Any] = dict(embed_specs(cfg))
    s["layers"] = _layer_specs(cfg, cfg.n_layers)
    s["final_norm"] = norm_specs(cfg)
    return s


# ------------------------------------------------------------------ layer


def _mlp_residual(cfg: ModelConfig, pl: Dict, x: torch.Tensor
                  ) -> torch.Tensor:
    if cfg.d_ff > 0:
        x = x + mlp_apply(cfg, pl["mlp"], apply_norm(cfg, pl["norm2"], x))
    return x


def _layer_train(cfg: ModelConfig, x: torch.Tensor, pl: Dict
                 ) -> torch.Tensor:
    x = x + attn.attn_train(cfg, pl["attn"], apply_norm(cfg, pl["norm1"], x))
    return _mlp_residual(cfg, pl, x)


# ---------------------------------------------------------------- forward


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor
            ) -> torch.Tensor:
    """Full-sequence forward: tokens (B, S) -> logits (B, S, Vp)."""
    check_supported(cfg)
    x = embed_apply(params, tokens).to(torch_dtype(cfg.dtype))
    for l in range(_n_layers(params["layers"])):
        x = _layer_train(cfg, x, _layer(params["layers"], l))
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed_apply(cfg, params, x)


# ------------------------------------------------------------------ cache


def init_cache(cfg: ModelConfig, B: int, cache_len: int,
               device: torch.device) -> Dict:
    check_supported(cfg)
    one = attn.init_attn_cache(cfg, B, cache_len, torch_dtype(cfg.dtype),
                               device)
    # per-row positions from the start (see decode)
    return {"pos": torch.zeros((B,), dtype=torch.int32, device=device),
            "layers": {"attn": {k: a.expand((cfg.n_layers,) + a.shape).clone()
                                for k, a in one.items()}}}


# ---------------------------------------------------------------- prefill


def _layer_prefill(cfg, x, pl):
    mix, ca = attn.attn_prefill(cfg, pl["attn"], apply_norm(cfg, pl["norm1"], x))
    return _mlp_residual(cfg, pl, x + mix), {"attn": ca}


def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            cache_len: int) -> Tuple[torch.Tensor, Dict]:
    """Process the prompt; returns (logits for last position, cache).

    The cache is padded/relaid to ``cache_len`` slots.
    """
    check_supported(cfg)
    B, S = tokens.shape
    x = embed_apply(params, tokens).to(torch_dtype(cfg.dtype))
    per_layer = []
    for l in range(_n_layers(params["layers"])):
        x, c = _layer_prefill(cfg, x, _layer(params["layers"], l))
        per_layer.append(c)
    stacked = {"attn": {k: torch.stack([c["attn"][k] for c in per_layer])
                        for k in per_layer[0]["attn"]}}
    cache: Dict[str, Any] = {
        "pos": torch.full((B,), S, dtype=torch.int32, device=tokens.device),
        "layers": _pad_cache(cfg, stacked, cache_len)}
    x = apply_norm(cfg, params["final_norm"], x[:, -1:, :])
    return unembed_apply(cfg, params, x), cache


def _pad_cache(cfg: ModelConfig, c: Dict, cache_len: int) -> Dict:
    """Grow stacked prefill caches (seq dim S or ring W, axis 2 of
    (L, B, S, ...)) to the serving cache_len; ``kpos`` pads with -1."""
    W = min(cfg.window, cache_len) if cfg.window else cache_len

    def pad_leaf(a):
        pad = W - a.shape[2]
        if pad <= 0:
            return a
        return F.pad(a, [0, 0] * (a.ndim - 3) + [0, pad],
                     value=-1 if a.dtype == torch.int32 else 0)

    return {"attn": {k: pad_leaf(a) for k, a in c["attn"].items()}}


# ----------------------------------------------------------------- decode


def _layer_decode(cfg, x, pl, cl, pos):
    mix, _ = attn.attn_decode(cfg, pl["attn"], apply_norm(cfg, pl["norm1"], x),
                              cl["attn"], pos)
    return _mlp_residual(cfg, pl, x + mix)


def decode(cfg: ModelConfig, params: Dict, cache: Dict, tokens: torch.Tensor
           ) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  tokens: (B, 1) -> (logits (B, 1, Vp), new cache).

    ``cache['pos']`` may be a scalar (every row at the same depth) or a
    per-row (B,) vector (continuous batching); it is normalized to (B,)
    here so attention layers always see per-row positions.

    The stacked cache tensors are updated in place, layer slice by layer
    slice (the JAX engine donates the cache to this step); the returned
    dict holds the same tensors and the advanced positions."""
    check_supported(cfg)
    B = tokens.shape[0]
    pos = torch.as_tensor(cache["pos"], dtype=torch.int32,
                          device=tokens.device).expand(B)
    x = embed_apply(params, tokens).to(torch_dtype(cfg.dtype))
    for l in range(_n_layers(params["layers"])):
        x = _layer_decode(cfg, x, _layer(params["layers"], l),
                          _layer(cache["layers"], l), pos)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed_apply(cfg, params, x)
    return logits, {"pos": pos + 1, "layers": cache["layers"]}
