"""Decoder-LM engine: every non-enc-dec architecture (dense GQA/MQA,
MLA + MoE, softmax MoE, Mamba-2 SSD, the Hymba hybrid) is a configuration
of this module.  Layer parameters are stacked ``(L, ...)`` leaves as in
the JAX package; where JAX scans over the stack, the port loops over layer
slices, and DeepSeek's leading dense layers are a second, small stack
(``dense_layers``; its cache is ``dense``).  Under autograd, ``forward``
checkpoints each layer as the config's ``remat``/``remat_policy`` say
(``torch.utils.checkpoint``, the counterpart of the JAX package's
``jax.checkpoint``).

Paths: ``forward`` (full-seq causal logits; ``hidden`` stops before the
unembed, for the planner loss), ``prefill`` (builds the cache),
``decode`` (one token, fixed shapes).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .config import ModelConfig
from .layers import (apply_norm, embed_apply, embed_specs, mlp_apply,
                     mlp_specs, norm_specs, unembed_apply)
from .param import ParamSpec, torch_dtype, tree_leaves, tree_map

__all__ = ["decoder_specs", "hidden", "forward", "prefill", "decode",
           "init_cache"]


def _layer(params: Dict, l: int) -> Dict:
    """Layer ``l``'s slice of the stacked ``(L, ...)`` leaves (views)."""
    return tree_map(lambda a: a[l], params)


def _n_layers(stacked: Dict) -> int:
    return tree_leaves(stacked)[0].shape[0]


def _unbind_layers(stacked: Dict) -> List[Dict]:
    """Every layer's slice of the stacked leaves, from one ``unbind`` a
    leaf: under autograd each leaf's gradient is then one stack of the
    layers' gradients, where a separate index view a layer would add L
    full-size zero tensors."""
    cols = tree_map(lambda a: a.unbind(0), stacked)
    return [tree_map(lambda t: t[l], cols)
            for l in range(_n_layers(stacked))]


# 2-D matmuls (``x @ w`` reaches ``aten.mm``): the outputs that remat policy
# "dots" keeps, as ``dots_with_no_batch_dims_saveable`` does in JAX; batched
# products (``bmm``) and everything else are recomputed
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def _remat(cfg: ModelConfig, body):
    """``body`` checkpointed while grad is enabled: ``remat_policy`` "full"
    saves nothing of it and recomputes it in the backward pass, "dots"
    saves its 2-D matmuls' outputs; "none" or ``remat=False``, and any call
    without grad (prefill, decode), run it as it is."""
    if not cfg.remat or cfg.remat_policy == "none" \
            or not torch.is_grad_enabled():
        return body
    kw = {} if cfg.remat_policy == "full" else {
        "context_fn": functools.partial(create_selective_checkpoint_contexts,
                                        _DOTS)}
    return functools.partial(checkpoint, body, use_reentrant=False, **kw)


# ------------------------------------------------------------------ specs


def _mixer_specs(cfg: ModelConfig, L: int) -> Dict[str, Any]:
    s: Dict[str, Any] = {}
    if cfg.has_attention:
        s["attn"] = (attn.mla_specs(cfg, L) if cfg.attn_type == "mla"
                     else attn.gqa_specs(cfg, L))
    if cfg.has_ssm:
        s["ssm"] = ssm_mod.ssm_specs(cfg, L)
    if cfg.family == "hybrid":
        s["alpha_attn"] = ParamSpec((L, cfg.d_model), ("layer", "embed"),
                                    init="ones", dtype=cfg.dtype)
        s["alpha_ssm"] = ParamSpec((L, cfg.d_model), ("layer", "embed"),
                                   init="ones", dtype=cfg.dtype)
    return s


def _layer_specs(cfg: ModelConfig, L: int) -> Dict[str, Any]:
    s: Dict[str, Any] = {"norm1": norm_specs(cfg, L)}
    s.update(_mixer_specs(cfg, L))
    if cfg.is_moe:
        s["norm2"] = norm_specs(cfg, L)
        s["moe"] = moe_mod.moe_specs(cfg, L)
    elif cfg.d_ff > 0:
        s["norm2"] = norm_specs(cfg, L)
        s["mlp"] = mlp_specs(cfg, L)
    return s


def _stacks(cfg: ModelConfig) -> List[Tuple[str, str, ModelConfig, int]]:
    """(params key, cache key, config, layers) of each layer stack, in
    order: DeepSeek's leading dense stack first (its config has no
    experts), then the main one."""
    n_dense = cfg.first_dense_layers
    if n_dense > 0:
        return [("dense_layers", "dense", cfg.with_(n_experts=0), n_dense),
                ("layers", "layers", cfg, cfg.n_layers - n_dense)]
    return [("layers", "layers", cfg, cfg.n_layers)]


def decoder_specs(cfg: ModelConfig) -> Dict[str, Any]:
    s: Dict[str, Any] = dict(embed_specs(cfg))
    for key, _, c, n in _stacks(cfg):
        s[key] = _layer_specs(c, n)
    s["final_norm"] = norm_specs(cfg)
    return s


# ------------------------------------------------------------------ layer


def _ffn_residual(cfg: ModelConfig, pl: Dict, x: torch.Tensor
                  ) -> torch.Tensor:
    if cfg.is_moe:
        x = x + moe_mod.moe_apply(cfg, pl["moe"],
                                  apply_norm(cfg, pl["norm2"], x))
    elif cfg.d_ff > 0:
        x = x + mlp_apply(cfg, pl["mlp"], apply_norm(cfg, pl["norm2"], x))
    return x


def _hybrid_mix(pl: Dict, a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Hymba's parallel heads: 0.5 * (a * alpha_attn + s * alpha_ssm), each
    product and sum rounded in the model dtype, in the JAX order."""
    return 0.5 * (a * pl["alpha_attn"] + s * pl["alpha_ssm"])


def _ssd_chunk(cfg: ModelConfig, S: int):
    """The SSD chunk of a call over S positions, resolved once for all its
    layers (None for a model with no SSD mixer)."""
    return ssm_mod.plan_chunk(cfg, S) if cfg.has_ssm else None


def _layer_train(cfg: ModelConfig, x: torch.Tensor, pl: Dict,
                 chunk) -> torch.Tensor:
    h = apply_norm(cfg, pl["norm1"], x)
    if cfg.family == "hybrid":
        mix = _hybrid_mix(pl, attn.attn_train(cfg, pl["attn"], h),
                          ssm_mod.ssm_train(cfg, pl["ssm"], h, chunk))
    elif cfg.has_ssm:
        mix = ssm_mod.ssm_train(cfg, pl["ssm"], h, chunk)
    else:
        mix = attn.attn_train(cfg, pl["attn"], h)
    return _ffn_residual(cfg, pl, x + mix)


# ---------------------------------------------------------------- forward


def hidden(cfg: ModelConfig, params: Dict, tokens: torch.Tensor
           ) -> torch.Tensor:
    """Full-sequence forward up to the unembed: tokens (B, S) -> the final
    norm's output (B, S, d)."""
    x = embed_apply(params, tokens).to(torch_dtype(cfg.dtype))
    chunk = _ssd_chunk(cfg, tokens.shape[1])
    for key, _, c, _ in _stacks(cfg):
        layer = _remat(c, functools.partial(_layer_train, c))
        for pl in _unbind_layers(params[key]):
            x = layer(x, pl, chunk)
    return apply_norm(cfg, params["final_norm"], x)


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor
            ) -> torch.Tensor:
    """Full-sequence forward: tokens (B, S) -> logits (B, S, Vp)."""
    return unembed_apply(cfg, params, hidden(cfg, params, tokens))


# ------------------------------------------------------------------ cache


def _layer_cache(cfg: ModelConfig, B: int, cache_len: int,
                 device: torch.device) -> Dict:
    dt = torch_dtype(cfg.dtype)
    c: Dict[str, Any] = {}
    if cfg.has_attention:
        c["attn"] = attn.init_attn_cache(cfg, B, cache_len, dt, device)
    if cfg.has_ssm:
        c["ssm"] = ssm_mod.init_ssm_cache(cfg, B, dt, device)
    return c


def init_cache(cfg: ModelConfig, B: int, cache_len: int,
               device: torch.device) -> Dict:
    # per-row positions from the start (see decode)
    out: Dict[str, Any] = {"pos": torch.zeros((B,), dtype=torch.int32,
                                              device=device)}
    for _, ckey, c, n in _stacks(cfg):
        one = _layer_cache(c, B, cache_len, device)
        out[ckey] = tree_map(lambda a: a.expand((n,) + a.shape).clone(), one)
    return out


# ---------------------------------------------------------------- prefill


def _layer_prefill(cfg, x, pl, chunk):
    h = apply_norm(cfg, pl["norm1"], x)
    if cfg.family == "hybrid":
        a, ca = attn.attn_prefill(cfg, pl["attn"], h)
        s, cs = ssm_mod.ssm_prefill(cfg, pl["ssm"], h, chunk)
        mix, new_c = _hybrid_mix(pl, a, s), {"attn": ca, "ssm": cs}
    elif cfg.has_ssm:
        mix, cs = ssm_mod.ssm_prefill(cfg, pl["ssm"], h, chunk)
        new_c = {"ssm": cs}
    else:
        mix, ca = attn.attn_prefill(cfg, pl["attn"], h)
        new_c = {"attn": ca}
    return _ffn_residual(cfg, pl, x + mix), new_c


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
    B, S = tokens.shape
    x = embed_apply(params, tokens).to(torch_dtype(cfg.dtype))
    chunk = _ssd_chunk(cfg, S)
    cache: Dict[str, Any] = {
        "pos": torch.full((B,), S, dtype=torch.int32, device=tokens.device)}
    for key, ckey, c, _ in _stacks(cfg):
        per_layer = []
        for l in range(_n_layers(params[key])):
            x, lc = _layer_prefill(c, x, _layer(params[key], l), chunk)
            per_layer.append(lc)
        cache[ckey] = _pad_cache(c, _stack(per_layer), cache_len)
    x = apply_norm(cfg, params["final_norm"], x[:, -1:, :])
    return unembed_apply(cfg, params, x), cache


def _pad_cache(cfg: ModelConfig, c: Dict, cache_len: int) -> Dict:
    """Grow stacked attention caches (seq dim S or ring W, axis 2 of
    (L, B, S, ...)) to the serving cache_len; ``kpos`` pads with -1.  MLA's
    ``ckv``/``kr`` (no window) grow to cache_len.  The ssm cache has no
    sequence axis and passes through unchanged."""
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
    if cfg.family == "hybrid":
        a, _ = attn.attn_decode(cfg, pl["attn"], h, cl["attn"], pos)
        s, _ = ssm_mod.ssm_decode(cfg, pl["ssm"], h, cl["ssm"])
        mix = _hybrid_mix(pl, a, s)
    elif cfg.has_ssm:
        mix, _ = ssm_mod.ssm_decode(cfg, pl["ssm"], h, cl["ssm"])
    else:
        mix, _ = attn.attn_decode(cfg, pl["attn"], h, cl["attn"], pos)
    return _ffn_residual(cfg, pl, x + mix)


def decode(cfg: ModelConfig, params: Dict, cache: Dict, tokens: torch.Tensor
           ) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  tokens: (B, 1) -> (logits (B, 1, Vp), new cache).

    ``cache['pos']`` may be a scalar (every row at the same depth) or a
    per-row (B,) vector (continuous batching); it is normalized to (B,)
    here so attention layers always see per-row positions.

    The stacked cache tensors are updated in place, layer slice by layer
    slice (the JAX engine donates the cache to this step); the returned
    dict holds the same tensors and the advanced positions."""
    B = tokens.shape[0]
    pos = torch.as_tensor(cache["pos"], dtype=torch.int32,
                          device=tokens.device).expand(B)
    x = embed_apply(params, tokens).to(torch_dtype(cfg.dtype))
    out: Dict[str, Any] = {"pos": pos + 1}
    for key, ckey, c, _ in _stacks(cfg):
        for l in range(_n_layers(params[key])):
            x = _layer_decode(c, x, _layer(params[key], l),
                              _layer(cache[ckey], l), pos)
        out[ckey] = cache[ckey]
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed_apply(cfg, params, x), out
