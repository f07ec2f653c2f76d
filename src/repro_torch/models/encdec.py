"""Encoder-decoder model (Seamless-M4T backbone).

Port of ``repro/models/encdec.py``.  The speech/text frontend is a stub:
precomputed frame embeddings (B, S_enc, d) go straight into the encoder.
Encoder layers are bidirectional; decoder layers add causal self-attention
and cross-attention over the encoder output.  Layer parameters are stacked
``(L, ...)`` leaves; the port loops over layer slices where JAX scans.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from . import attention as attn
from .config import ModelConfig
from .layers import (apply_norm, embed_apply, embed_specs, mlp_apply,
                     mlp_specs, norm_specs, unembed_apply)
from .param import torch_dtype, tree_map
from .transformer import _layer, _n_layers, _remat, _stack, _unbind_layers

__all__ = ["encdec_specs", "encdec_forward", "encdec_prefill",
           "encdec_decode", "encdec_init_cache"]


def _enc_layer_specs(cfg: ModelConfig, L: int) -> Dict[str, Any]:
    return {"norm1": norm_specs(cfg, L), "attn": attn.gqa_specs(cfg, L),
            "norm2": norm_specs(cfg, L), "mlp": mlp_specs(cfg, L)}


def _dec_layer_specs(cfg: ModelConfig, L: int) -> Dict[str, Any]:
    return {"norm1": norm_specs(cfg, L), "attn": attn.gqa_specs(cfg, L),
            "norm_x": norm_specs(cfg, L), "cross": attn.cross_specs(cfg, L),
            "norm2": norm_specs(cfg, L), "mlp": mlp_specs(cfg, L)}


def encdec_specs(cfg: ModelConfig) -> Dict[str, Any]:
    s: Dict[str, Any] = dict(embed_specs(cfg))
    s["enc_layers"] = _enc_layer_specs(cfg, cfg.n_enc_layers)
    s["dec_layers"] = _dec_layer_specs(cfg, cfg.n_layers)
    s["enc_final_norm"] = norm_specs(cfg)
    s["final_norm"] = norm_specs(cfg)
    return s


# ---------------------------------------------------------------- encoder


def _enc_layer(cfg: ModelConfig, x: torch.Tensor, pl: Dict) -> torch.Tensor:
    x = x + attn.attn_train(cfg, pl["attn"], apply_norm(cfg, pl["norm1"], x),
                            causal=False)
    return x + mlp_apply(cfg, pl["mlp"], apply_norm(cfg, pl["norm2"], x))


def _encode(cfg: ModelConfig, params: Dict, src: torch.Tensor
            ) -> torch.Tensor:
    x = src.to(torch_dtype(cfg.dtype))
    layer = _remat(cfg, functools.partial(_enc_layer, cfg))
    for pl in _unbind_layers(params["enc_layers"]):
        x = layer(x, pl)
    return apply_norm(cfg, params["enc_final_norm"], x)


# ---------------------------------------------------------------- forward


def _dec_layer(cfg: ModelConfig, x: torch.Tensor, pl: Dict,
               enc: torch.Tensor) -> torch.Tensor:
    x = x + attn.attn_train(cfg, pl["attn"], apply_norm(cfg, pl["norm1"], x))
    x = x + attn.cross_train(cfg, pl["cross"],
                             apply_norm(cfg, pl["norm_x"], x), enc)
    return x + mlp_apply(cfg, pl["mlp"], apply_norm(cfg, pl["norm2"], x))


def encdec_forward(cfg: ModelConfig, params: Dict, src_embeds: torch.Tensor,
                   tokens: torch.Tensor) -> torch.Tensor:
    """src_embeds (B, Se, d), tokens (B, S) -> logits (B, S, Vp)."""
    enc = _encode(cfg, params, src_embeds)
    x = embed_apply(params, tokens).to(torch_dtype(cfg.dtype))
    layer = _remat(cfg, functools.partial(_dec_layer, cfg))
    for pl in _unbind_layers(params["dec_layers"]):
        x = layer(x, pl, enc)
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed_apply(cfg, params, x)


# ------------------------------------------------------------------ cache


def encdec_init_cache(cfg: ModelConfig, B: int, cache_len: int,
                      device: torch.device) -> Dict:
    dt = torch_dtype(cfg.dtype)
    Se = max(1, cache_len // cfg.enc_ratio)
    self_c = attn.init_attn_cache(cfg, B, cache_len, dt, device)
    cross_c = {k: torch.zeros((B, Se, cfg.n_kv_heads, cfg.hd), dtype=dt,
                              device=device) for k in ("k", "v")}

    def stack(c):
        return tree_map(lambda a: a.expand((cfg.n_layers,) + a.shape)
                        .clone(), c)

    return {"pos": torch.zeros((B,), dtype=torch.int32, device=device),
            "self": stack(self_c), "cross": stack(cross_c)}


def encdec_prefill(cfg: ModelConfig, params: Dict, src_embeds: torch.Tensor,
                   tokens: torch.Tensor, cache_len: int
                   ) -> Tuple[torch.Tensor, Dict]:
    """Encode, run the decoder over the prompt; returns (logits for the last
    position, cache): the self-attention cache grown to ``cache_len``, and
    each layer's cross-attention K/V of the encoder output."""
    enc = _encode(cfg, params, src_embeds)
    x = embed_apply(params, tokens).to(torch_dtype(cfg.dtype))
    B, S = tokens.shape
    caches = []
    for l in range(_n_layers(params["dec_layers"])):
        pl = _layer(params["dec_layers"], l)
        h, ca = attn.attn_prefill(cfg, pl["attn"],
                                  apply_norm(cfg, pl["norm1"], x))
        x = x + h
        x = x + attn.cross_train(cfg, pl["cross"],
                                 apply_norm(cfg, pl["norm_x"], x), enc)
        x = x + mlp_apply(cfg, pl["mlp"], apply_norm(cfg, pl["norm2"], x))
        caches.append({"self": ca,
                       "cross": attn.make_cross_cache(cfg, pl["cross"], enc)})
    caches = _stack(caches)
    pad = cache_len - S

    def grow(a):
        # stacked self-attention leaves: k/v (L, B, S, H, hd) and the
        # per-row kpos (L, B, S) pad the sequence axis 2; kpos with -1
        # (an empty slot)
        return F.pad(a, [0, 0] * (a.ndim - 3) + [0, pad],
                     value=-1 if a.dtype == torch.int32 else 0)

    x = apply_norm(cfg, params["final_norm"], x[:, -1:, :])
    return unembed_apply(cfg, params, x), {
        "pos": torch.full((B,), S, dtype=torch.int32, device=tokens.device),
        "self": tree_map(grow, caches["self"]), "cross": caches["cross"]}


def encdec_decode(cfg: ModelConfig, params: Dict, cache: Dict,
                  tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """One decode step; the self-attention cache is updated in place (see
    ``transformer.decode``), the cross cache only read."""
    B = tokens.shape[0]
    pos = torch.as_tensor(cache["pos"], dtype=torch.int32,
                          device=tokens.device).expand(B)
    x = embed_apply(params, tokens).to(torch_dtype(cfg.dtype))
    for l in range(_n_layers(params["dec_layers"])):
        pl = _layer(params["dec_layers"], l)
        h, _ = attn.attn_decode(cfg, pl["attn"],
                                apply_norm(cfg, pl["norm1"], x),
                                _layer(cache["self"], l), pos)
        x = x + h
        x = x + attn.cross_decode(cfg, pl["cross"],
                                  apply_norm(cfg, pl["norm_x"], x),
                                  _layer(cache["cross"], l))
        x = x + mlp_apply(cfg, pl["mlp"], apply_norm(cfg, pl["norm2"], x))
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed_apply(cfg, params, x), {
        "pos": pos + 1, "self": cache["self"], "cross": cache["cross"]}
