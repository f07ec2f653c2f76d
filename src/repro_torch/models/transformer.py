"""Decoder-LM engine: dense GQA/MQA decoders and attention-free Mamba-2
(ssm) decoders.  Layer parameters are stacked ``(L, ...)`` leaves as in
the JAX package; where JAX scans over the stack, the port loops over layer
slices.

Paths: ``forward`` (full-seq causal logits), ``prefill`` (builds the
cache), ``decode`` (one token, fixed shapes).  The moe, mla, hybrid and
encdec families are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from . import attention as attn
from . import ssm as ssm_mod
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
              or (cfg.has_ssm and cfg.has_attention) else None)
    if family is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {family} family (config family "
            f"{cfg.family!r}) is not ported yet; only dense GQA decoders "
            f"and ssm (Mamba-2) decoders are")


def _layer(params: Dict, l: int) -> Dict:
    """Layer ``l``'s slice of the stacked ``(L, ...)`` leaves (views)."""
    return tree_map(lambda a: a[l], params)


def _n_layers(stacked: Dict) -> int:
    return tree_leaves(stacked)[0].shape[0]


# ------------------------------------------------------------------ specs


def _layer_specs(cfg: ModelConfig, L: int) -> Dict[str, Any]:
    s: Dict[str, Any] = {"norm1": norm_specs(cfg, L)}
    if cfg.has_ssm:
        s["ssm"] = ssm_mod.ssm_specs(cfg, L)
    else:
        s["attn"] = attn.gqa_specs(cfg, L)
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


def _ssd_chunk(cfg: ModelConfig, S: int):
    """The SSD chunk of a call over S positions, resolved once for all its
    layers (None for a model with no SSD mixer)."""
    return ssm_mod.plan_chunk(cfg, S) if cfg.has_ssm else None


def _layer_train(cfg: ModelConfig, x: torch.Tensor, pl: Dict,
                 chunk) -> torch.Tensor:
    h = apply_norm(cfg, pl["norm1"], x)
    if cfg.has_ssm:
        x = x + ssm_mod.ssm_train(cfg, pl["ssm"], h, chunk)
    else:
        x = x + attn.attn_train(cfg, pl["attn"], h)
    return _mlp_residual(cfg, pl, x)


# ---------------------------------------------------------------- forward


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor
            ) -> torch.Tensor:
    """Full-sequence forward: tokens (B, S) -> logits (B, S, Vp)."""
    check_supported(cfg)
    x = embed_apply(params, tokens).to(torch_dtype(cfg.dtype))
    chunk = _ssd_chunk(cfg, tokens.shape[1])
    for l in range(_n_layers(params["layers"])):
        x = _layer_train(cfg, x, _layer(params["layers"], l), chunk)
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed_apply(cfg, params, x)


# ------------------------------------------------------------------ cache


def _layer_cache(cfg: ModelConfig, B: int, cache_len: int,
                 device: torch.device) -> Dict:
    dt = torch_dtype(cfg.dtype)
    if cfg.has_ssm:
        return {"ssm": ssm_mod.init_ssm_cache(cfg, B, dt, device)}
    return {"attn": attn.init_attn_cache(cfg, B, cache_len, dt, device)}


def init_cache(cfg: ModelConfig, B: int, cache_len: int,
               device: torch.device) -> Dict:
    check_supported(cfg)
    one = _layer_cache(cfg, B, cache_len, device)
    # per-row positions from the start (see decode)
    return {"pos": torch.zeros((B,), dtype=torch.int32, device=device),
            "layers": tree_map(lambda a: a.expand((cfg.n_layers,) + a.shape)
                               .clone(), one)}


# ---------------------------------------------------------------- prefill


def _layer_prefill(cfg, x, pl, chunk):
    h = apply_norm(cfg, pl["norm1"], x)
    if cfg.has_ssm:
        mix, cs = ssm_mod.ssm_prefill(cfg, pl["ssm"], h, chunk)
        new_c = {"ssm": cs}
    else:
        mix, ca = attn.attn_prefill(cfg, pl["attn"], h)
        new_c = {"attn": ca}
    return _mlp_residual(cfg, pl, x + mix), new_c


def _stack(trees):
    """Per-layer caches (a list of equal nested dicts) -> one nested dict
    of stacked ``(L, ...)`` leaves."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            cache_len: int) -> Tuple[torch.Tensor, Dict]:
    """Process the prompt; returns (logits for last position, cache).

    The cache is padded/relaid to ``cache_len`` slots.
    """
    check_supported(cfg)
    B, S = tokens.shape
    x = embed_apply(params, tokens).to(torch_dtype(cfg.dtype))
    chunk = _ssd_chunk(cfg, S)
    per_layer = []
    for l in range(_n_layers(params["layers"])):
        x, c = _layer_prefill(cfg, x, _layer(params["layers"], l), chunk)
        per_layer.append(c)
    stacked = _stack(per_layer)
    cache: Dict[str, Any] = {
        "pos": torch.full((B,), S, dtype=torch.int32, device=tokens.device),
        "layers": _pad_cache(cfg, stacked, cache_len)}
    x = apply_norm(cfg, params["final_norm"], x[:, -1:, :])
    return unembed_apply(cfg, params, x), cache


def _pad_cache(cfg: ModelConfig, c: Dict, cache_len: int) -> Dict:
    """Grow stacked attention caches (seq dim S or ring W, axis 2 of
    (L, B, S, ...)) to the serving cache_len; ``kpos`` pads with -1.  The
    ssm cache has no sequence axis and passes through unchanged."""
    W = min(cfg.window, cache_len) if cfg.window else cache_len

    def pad_leaf(a):
        pad = W - a.shape[2]
        if pad <= 0:
            return a
        return F.pad(a, [0, 0] * (a.ndim - 3) + [0, pad],
                     value=-1 if a.dtype == torch.int32 else 0)

    out = dict(c)
    if "attn" in c:
        out["attn"] = {k: pad_leaf(a) for k, a in c["attn"].items()}
    return out


# ----------------------------------------------------------------- decode


def _layer_decode(cfg, x, pl, cl, pos):
    h = apply_norm(cfg, pl["norm1"], x)
    if cfg.has_ssm:
        mix, _ = ssm_mod.ssm_decode(cfg, pl["ssm"], h, cl["ssm"])
    else:
        mix, _ = attn.attn_decode(cfg, pl["attn"], h, cl["attn"], pos)
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
