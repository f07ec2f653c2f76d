"""Encoder-decoder model (Seamless-M4T backbone).

Port of ``repro/models/encdec.py``.  The speech/text frontend is a stub:
precomputed frame embeddings (B, S_enc, d) go straight into the encoder.
Encoder layers are bidirectional; decoder layers add causal self-attention
and cross-attention over the encoder output.  Layer parameters are stacked
``(L, ...)`` leaves; the port loops over layer slices where JAX scans.

The forward, prefill and decode take a ``(data, model)`` mesh as
``transformer``'s do: the encoder pass, the decoder's self- and
cross-attention and the MLPs are tensor-parallel over ``model``, the
``src_embeds`` frames are this rank's rows, and the caches (self and
cross) this rank's shards.  Under autograd every decoder layer's
cross-attention reads the encoder output, replicated over ``model``, on
the rank's heads: its cotangent is the sum of the layers' partial ones
over the ranks, one *f* for all of them (``tp/cross-kv``).  The
``seq_shard`` knob leaves an enc-dec model as it is: the JAX package
keeps its residual at ``P(dp, None, None)`` and never reads the knob.
Under ZeRO-3 (``fsdp``) both stacks gather their layers' slices inside
the checkpointed bodies, and the embedding, the unembed and the two
final norms are gathered where they are read, as in ``transformer``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch

from . import attention as attn
from ..parallel.collective_planner import enter_parallel, model_axis
from .config import ModelConfig
from .layers import (apply_norm, embed_specs, mlp_apply, mlp_specs,
                     norm_specs, unembed_apply)
from .param import torch_dtype, tree_map
from ..parallel.sharding import local_cache
from .transformer import (_embed, _gather_layer, _gather_stack, _gather_top,
                          _gathering, _layer, _n_layers, _remat, _stack,
                          _unbind_layers, _unembed_key, zero3_dims)

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


def _enc_layer(cfg: ModelConfig, mesh, x: torch.Tensor, pl: Dict
               ) -> torch.Tensor:
    x = x + attn.attn_train(cfg, pl["attn"], apply_norm(cfg, pl["norm1"], x),
                            causal=False, mesh=mesh)
    return x + mlp_apply(cfg, pl["mlp"], apply_norm(cfg, pl["norm2"], x),
                         mesh)


def _encode(cfg: ModelConfig, params: Dict, src: torch.Tensor, mesh=None
            ) -> torch.Tensor:
    x = src.to(torch_dtype(cfg.dtype))
    dims = zero3_dims(cfg, mesh)
    layer = _remat(cfg, _gathering(functools.partial(_enc_layer, cfg, mesh),
                                   dims, mesh, "enc_layers"))
    for pl in _unbind_layers(_gather_stack(params, dims, mesh, "enc_layers")):
        x = layer(x, pl)
    return apply_norm(cfg, _gather_top(params, dims, mesh, "enc_final_norm")[
        "enc_final_norm"], x)


# ---------------------------------------------------------------- forward


def _dec_layer(cfg: ModelConfig, mesh, x: torch.Tensor, pl: Dict,
               enc: torch.Tensor) -> torch.Tensor:
    x = x + attn.attn_train(cfg, pl["attn"], apply_norm(cfg, pl["norm1"], x),
                            mesh=mesh)
    x = x + attn.cross_train(cfg, pl["cross"],
                             apply_norm(cfg, pl["norm_x"], x), enc, mesh)
    return x + mlp_apply(cfg, pl["mlp"], apply_norm(cfg, pl["norm2"], x),
                         mesh)


def encdec_forward(cfg: ModelConfig, params: Dict, src_embeds: torch.Tensor,
                   tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """src_embeds (B, Se, d), tokens (B, S) -> logits (B, S, Vp); on a mesh
    this rank's rows, its shards of the params."""
    enc = _encode(cfg, params, src_embeds, mesh)
    if mesh is not None and cfg.tensor_parallel:
        enc = enter_parallel(enc, model_axis(mesh)[2], "tp/cross-kv")
    dims = zero3_dims(cfg, mesh)
    x = _embed(cfg, _gather_top(params, dims, mesh, "embedding"), tokens,
               mesh)
    layer = _remat(cfg, _gathering(functools.partial(_dec_layer, cfg, mesh),
                                   dims, mesh, "dec_layers"))
    for pl in _unbind_layers(_gather_stack(params, dims, mesh, "dec_layers")):
        x = layer(x, pl, enc)
    x = apply_norm(cfg, _gather_top(params, dims, mesh, "final_norm")[
        "final_norm"], x)
    return unembed_apply(cfg, _gather_top(params, dims, mesh,
                                          _unembed_key(cfg)), x, mesh)


# ------------------------------------------------------------------ cache


def encdec_init_cache(cfg: ModelConfig, B: int, cache_len: int,
                      device: torch.device, mesh=None) -> Dict:
    """The empty cache; on a mesh this rank's shards of it, each made at
    its own size."""
    if mesh is not None:
        return local_cache(encdec_init_cache(cfg, B, cache_len, "meta"),
                           mesh, B, device)
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
                   tokens: torch.Tensor, cache_len: int, mesh=None
                   ) -> Tuple[torch.Tensor, Dict]:
    """Encode, run the decoder over the prompt; returns (logits for the last
    position, cache): the self-attention cache of ``cache_len`` slots, and
    each layer's cross-attention K/V of the encoder output."""
    enc = _encode(cfg, params, src_embeds, mesh)
    dims = zero3_dims(cfg, mesh)
    x = _embed(cfg, _gather_top(params, dims, mesh, "embedding"), tokens,
               mesh)
    B, S = tokens.shape
    caches = []
    stack = _gather_stack(params, dims, mesh, "dec_layers")
    for l in range(_n_layers(stack)):
        pl = _gather_layer(_layer(stack, l), dims, mesh, "dec_layers")
        h, ca = attn.attn_prefill(cfg, pl["attn"],
                                  apply_norm(cfg, pl["norm1"], x), cache_len,
                                  mesh)
        x = x + h
        x = x + attn.cross_train(cfg, pl["cross"],
                                 apply_norm(cfg, pl["norm_x"], x), enc, mesh)
        x = x + mlp_apply(cfg, pl["mlp"], apply_norm(cfg, pl["norm2"], x),
                          mesh)
        caches.append({"self": ca, "cross": attn.make_cross_cache(
            cfg, pl["cross"], enc, mesh)})
    caches = _stack(caches)
    params = _gather_top(params, dims, mesh, "final_norm", _unembed_key(cfg))
    x = apply_norm(cfg, params["final_norm"], x[:, -1:, :])
    return unembed_apply(cfg, params, x), {
        "pos": torch.full((B,), S, dtype=torch.int32, device=tokens.device),
        "self": caches["self"], "cross": caches["cross"]}


def encdec_decode(cfg: ModelConfig, params: Dict, cache: Dict,
                  tokens: torch.Tensor, mesh=None
                  ) -> Tuple[torch.Tensor, Dict]:
    """One decode step; the self-attention cache is updated in place (see
    ``transformer.decode``), the cross cache only read."""
    B = tokens.shape[0]
    pos = torch.as_tensor(cache["pos"], dtype=torch.int32,
                          device=tokens.device).expand(B)
    dims = zero3_dims(cfg, mesh)
    x = _embed(cfg, _gather_top(params, dims, mesh, "embedding"), tokens,
               mesh)
    stack = _gather_stack(params, dims, mesh, "dec_layers")
    for l in range(_n_layers(stack)):
        pl = _gather_layer(_layer(stack, l), dims, mesh, "dec_layers")
        h, _ = attn.attn_decode(cfg, pl["attn"],
                                apply_norm(cfg, pl["norm1"], x),
                                _layer(cache["self"], l), pos, mesh)
        x = x + h
        x = x + attn.cross_decode(cfg, pl["cross"],
                                  apply_norm(cfg, pl["norm_x"], x),
                                  _layer(cache["cross"], l), mesh)
        x = x + mlp_apply(cfg, pl["mlp"], apply_norm(cfg, pl["norm2"], x),
                          mesh)
    params = _gather_top(params, dims, mesh, "final_norm", _unembed_key(cfg))
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed_apply(cfg, params, x), {
        "pos": pos + 1, "self": cache["self"], "cross": cache["cross"]}
