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

``hidden``/``forward`` take a ``(data, model)`` or ``(pod, data,
model)`` mesh (``mesh=``; the tokens are this rank's rows, the params its
shards): the embedding, the attention (GQA and MLA), the SSM mixer, the
dense MLP, the shared experts and the unembed are tensor-parallel and
the MoE FFN expert-parallel over ``model`` (``layers``, ``attention``,
``ssm``, ``moe``), in every family and in both of DeepSeek's stacks.  A
weight kept whole (``tensor_parallel=False`` keeps every one whole) runs
whole, with no ``tp/`` collective.  With ``seq_shard`` the residual is
this rank's block of the sequence wherever the JAX package constrains it
to ``P(dp, "model", None)`` (:func:`splits_sequence`): the embedding
Reduce-Scatters its rows, the norms run on the local rows, each mixer and
FFN gathers the rows in and Reduce-Scatters its output's rows out (a
hybrid layer's two mixers share one gather), and the final hidden state
is gathered whole before the loss or the logits.  The recompute of a
checkpointed layer runs in ``collective_planner.recompute_region``, so
that its repeated forward collectives are recorded apart.

``prefill``/``decode`` serve every family on a mesh: each rank runs its
rows (``batch_spec``) and its shards of the params (``param_shardings``)
and of the cache (``cache_shardings``; ``init_cache(mesh=)`` makes the
shards at their own size), and returns its block of the vocab-sharded
logits (``layers.greedy_token`` picks the token across them).  The
prefill splits the sequence under ``seq_shard`` as the training forward
does; decode's one token is never split.

ZeRO-3 (``fsdp``) on a mesh: each param is this rank's ZeRO-1 slice, its
``param_shardings`` shard split over the data axes as well
(``zero1_shardings``; :func:`zero3_dims`), and every path gathers it
(``collective_planner.gather_param``) where it is used.  A layer's
slices are gathered inside the body that ``_remat`` checkpoints, so the
gathered weights are not saved for the backward pass: the recompute
gathers them again (in ``recompute_region``) and a rank holds one
layer's gathered weights at a time.  A stacked leaf that the data axes
split on its layer dim is gathered whole once, before the layer loop;
the embedding, the unembed and the final norms where they are read.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..parallel import sharding
from ..parallel.collective_planner import (SEQ_GATHER, enter_region,
                                           gather_param, gather_replicated,
                                           model_axis, recompute_region)

from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .config import ModelConfig
from ..parallel.sharding import local_cache, mesh_axes
from .layers import (apply_norm, embed_apply, embed_specs, mlp_apply,
                     mlp_specs, norm_specs, unembed_apply)
from .param import ParamSpec, torch_dtype, tree_leaves, tree_map

__all__ = ["decoder_specs", "hidden", "forward", "prefill", "decode",
           "init_cache", "splits_sequence", "acts_on_rows", "zero3_dims"]


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


def _remat_contexts(policy: str):
    """(forward, recompute) contexts of a checkpointed layer: the policy's,
    the recompute's inside ``recompute_region``."""
    if policy == "full":
        fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
    else:
        fwd, rec = create_selective_checkpoint_contexts(_DOTS)

    @contextlib.contextmanager
    def recompute():
        with rec, recompute_region():
            yield
    return fwd, recompute()


def _remat(cfg: ModelConfig, body):
    """``body`` checkpointed while grad is enabled: ``remat_policy`` "full"
    saves nothing of it and recomputes it in the backward pass, "dots"
    saves its 2-D matmuls' outputs; "none" or ``remat=False``, and any call
    without grad (prefill, decode), run it as it is."""
    if not cfg.remat or cfg.remat_policy == "none" \
            or not torch.is_grad_enabled():
        return body
    return functools.partial(
        checkpoint, body, use_reentrant=False,
        context_fn=functools.partial(_remat_contexts, cfg.remat_policy))


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
    experts), then the main one.  A stack of no layers is left out (a
    depth cut to the dense layers has no main stack)."""
    n_dense = min(cfg.first_dense_layers, cfg.n_layers)
    stacks = [("layers", "layers", cfg, cfg.n_layers - n_dense)]
    if n_dense > 0:
        stacks.insert(0, ("dense_layers", "dense", cfg.with_(n_experts=0),
                          n_dense))
    return [s for s in stacks if s[3] > 0]


def decoder_specs(cfg: ModelConfig) -> Dict[str, Any]:
    s: Dict[str, Any] = dict(embed_specs(cfg))
    for key, _, c, n in _stacks(cfg):
        s[key] = _layer_specs(c, n)
    s["final_norm"] = norm_specs(cfg)
    return s


# ------------------------------------------------------------------ ZeRO-3


@functools.lru_cache(maxsize=64)
def _zero3_dims(cfg: ModelConfig, mesh: sharding.MeshShape):
    from .model import Model
    placed = sharding.zero1_shardings(Model(cfg).specs, mesh,
                                      cfg.tensor_parallel)
    return tree_map(lambda p: sharding.data_dim(p, mesh), placed)


def zero3_dims(cfg: ModelConfig, mesh):
    """Under ``fsdp`` on a mesh, a tree like the params: the dim of each
    leaf that the data axes split (its ``zero1_shardings`` placement),
    None where they keep it whole; None without ``fsdp`` or a mesh."""
    if not cfg.fsdp or mesh is None:
        return None
    return _zero3_dims(cfg, sharding.MeshShape(
        tuple(int(n) for n in mesh.shape), tuple(mesh.mesh_dim_names)))


def _map_keys(fn, tree, dims, path):
    if isinstance(tree, dict):
        return {k: _map_keys(fn, v, dims[k], path + (k,))
                for k, v in tree.items()}
    return fn(tree, path, dims)


def _gather_leaf(mesh, x, keys, dim: int):
    """One leaf gathered along ``dim``; the MoE layer's router and
    experts, whose gradients it sums over the data axes itself, take the
    rank's block of the gradient back."""
    return gather_param(x, mesh, ".".join(keys), dim,
                        reduced=moe_mod.reduced_on_mesh(keys))


def _gather_top(params: Dict, dims, mesh, *keys) -> Dict:
    """``params`` with the unstacked subtrees ``keys`` (the embedding,
    the unembed, a final norm) gathered whole under ZeRO-3."""
    if dims is None:
        return params
    return dict(params, **{k: _map_keys(
        lambda x, p, d: x if d is None else _gather_leaf(mesh, x, p, d),
        params[k], dims[k], (k,)) for k in keys})


def _gather_stack(params: Dict, dims, mesh, key: str) -> Dict:
    """The stack ``key`` with each leaf that the data axes split on its
    layer dim gathered whole (a layer's slice of it lives on one data
    rank); the others stay this rank's slices, for :func:`_gather_layer`."""
    if dims is None:
        return params[key]
    return _map_keys(lambda x, p, d: _gather_leaf(mesh, x, p, 0)
                     if d == 0 else x, params[key], dims[key], (key,))


def _gather_layer(pl: Dict, dims, mesh, key: str) -> Dict:
    """One layer's slices of the stack ``key`` gathered whole (a leaf
    split on the stack's dim d is a layer's slice split on d - 1)."""
    if dims is None:
        return pl
    return _map_keys(lambda x, p, d: _gather_leaf(mesh, x, p, d - 1)
                     if d else x, pl, dims[key], (key,))


def _gathering(body, dims, mesh, key: str):
    """``body(x, pl, ...)`` with the layer's slices ``pl`` gathered first,
    inside whatever checkpoints it."""
    if dims is None:
        return body

    def run(x, pl, *args):
        return body(x, _gather_layer(pl, dims, mesh, key), *args)
    return run


# ------------------------------------------------------------------ layer


def _ffn_residual(cfg: ModelConfig, pl: Dict, x: torch.Tensor,
                  mesh=None, seq=None) -> torch.Tensor:
    if cfg.is_moe:
        x = x + moe_mod.moe_apply(cfg, pl["moe"],
                                  apply_norm(cfg, pl["norm2"], x), mesh, seq)
    elif cfg.d_ff > 0:
        x = x + mlp_apply(cfg, pl["mlp"], apply_norm(cfg, pl["norm2"], x),
                          mesh, seq)
    return x


def _embed(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, mesh=None,
           seq=None) -> torch.Tensor:
    return embed_apply(params, tokens, mesh, cfg.padded_vocab,
                       bool(seq)).to(torch_dtype(cfg.dtype))


def splits_sequence(cfg: ModelConfig, mesh, S: int) -> bool:
    """Whether the residual of a forward over S positions is split over
    ``model`` (``seq_shard``): on a mesh with a ``model`` axis that divides
    S, in a decoder (the JAX package's enc-dec model never reads the
    knob).  GSPMD replicates a dim the axis does not divide, as decode's
    one token."""
    return bool(cfg.seq_shard and not cfg.is_encdec and mesh is not None
                and S % mesh_axes(mesh).get("model", S + 1) == 0)


# the leaves that act on the residual's rows: under seq_shard each rank's
# gradient of them is a partial sum over its rows
_ROW_NORMS = ("norm1", "norm2", "final_norm")
_ROW_WEIGHTS = ("alpha_attn", "alpha_ssm")


def acts_on_rows(keys) -> bool:
    """Whether the parameter at key path ``keys`` acts on the residual's
    rows: a layer norm or the final norm, hymba's mixing weights."""
    return (len(keys) >= 2 and keys[-2] in _ROW_NORMS) \
        or keys[-1] in _ROW_WEIGHTS


def _gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The whole sequence of the residual's rows, which every rank then
    uses the same way (``tp/seq-gather``; its transpose is the rank's
    block)."""
    return gather_replicated(x, model_axis(mesh)[2], SEQ_GATHER, dim=1)


def _hybrid_mix(pl: Dict, a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Hymba's parallel heads: 0.5 * (a * alpha_attn + s * alpha_ssm), each
    product and sum rounded in the model dtype, in the JAX order."""
    return 0.5 * (a * pl["alpha_attn"] + s * pl["alpha_ssm"])


def _ssd_chunk(cfg: ModelConfig, S: int):
    """The SSD chunk of a call over S positions, resolved once for all its
    layers (None for a model with no SSD mixer)."""
    return ssm_mod.plan_chunk(cfg, S) if cfg.has_ssm else None


def _hybrid_seq(cfg: ModelConfig, pl: Dict, h: torch.Tensor, mesh, seq):
    """(h, seq) for a hybrid layer's two mixers: with ``seq`` "rows" and
    both mixers' outputs partial sums (or both whole), h's rows gathered
    once for both ("gathered": each mixer Reduce-Scatters its own output);
    otherwise as they are, each mixer gathering its own."""
    if seq != "rows":
        return h, seq
    a = attn._partial(cfg, pl["attn"], mesh)
    if a != ssm_mod._partial(cfg, pl["ssm"], mesh):
        return h, seq
    return enter_region(h, model_axis(mesh)[2], "tp/attn-out", partial=a,
                        seq=seq), "gathered"


def _dense_mesh(cfg: ModelConfig, mesh, seq):
    """The mesh the training forward's dense layers (all but the MoE FFN)
    take: none with ``tensor_parallel=False`` and the sequence whole, so
    that they run on their whole weights with no ``tp/`` collective, as
    the JAX package runs them, a one-rank model axis included."""
    return mesh if cfg.tensor_parallel or seq else None


def _layer_train(cfg: ModelConfig, mesh, x: torch.Tensor, pl: Dict,
                 chunk, seq=None) -> torch.Tensor:
    dm = _dense_mesh(cfg, mesh, seq)
    h = apply_norm(cfg, pl["norm1"], x)
    if cfg.family == "hybrid":
        h, s = _hybrid_seq(cfg, pl, h, dm, seq)
        mix = _hybrid_mix(pl, attn.attn_train(cfg, pl["attn"], h, mesh=dm,
                                              seq=s),
                          ssm_mod.ssm_train(cfg, pl["ssm"], h, chunk, dm, s))
    elif cfg.has_ssm:
        mix = ssm_mod.ssm_train(cfg, pl["ssm"], h, chunk, dm, seq)
    else:
        mix = attn.attn_train(cfg, pl["attn"], h, mesh=dm, seq=seq)
    x = x + mix
    if cfg.is_moe:
        return x + moe_mod.moe_apply(cfg, pl["moe"],
                                     apply_norm(cfg, pl["norm2"], x), mesh,
                                     seq)
    return _ffn_residual(cfg, pl, x, dm, seq)


# ---------------------------------------------------------------- forward


def hidden(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
           mesh=None) -> torch.Tensor:
    """Full-sequence forward up to the unembed: tokens (B, S) -> the final
    norm's output (B, S, d).  On a mesh, tokens are this rank's rows and
    ``params`` its shards; the output is replicated over ``model`` (under
    ``seq_shard`` the final norm runs on the rank's rows, then they are
    gathered)."""
    seq = "rows" if splits_sequence(cfg, mesh, tokens.shape[1]) else None
    dims = zero3_dims(cfg, mesh)
    x = _embed(cfg, _gather_top(params, dims, mesh, "embedding"), tokens,
               _dense_mesh(cfg, mesh, seq), seq)
    chunk = _ssd_chunk(cfg, tokens.shape[1])
    for key, _, c, _ in _stacks(cfg):
        layer = _remat(c, _gathering(functools.partial(_layer_train, c, mesh),
                                     dims, mesh, key))
        for pl in _unbind_layers(_gather_stack(params, dims, mesh, key)):
            x = layer(x, pl, chunk, seq)
    x = apply_norm(cfg, _gather_top(params, dims, mesh,
                                    "final_norm")["final_norm"], x)
    return _gather_rows(x, mesh) if seq else x


def _unembed_key(cfg: ModelConfig) -> str:
    return "embedding" if cfg.tie_embeddings else "unembed"


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            mesh=None) -> torch.Tensor:
    """Full-sequence forward: tokens (B, S) -> logits (B, S, Vp).  Under
    ZeRO-3 a tied table is gathered again for the unembed."""
    x = hidden(cfg, params, tokens, mesh)
    return unembed_apply(cfg, _gather_top(params, zero3_dims(cfg, mesh), mesh,
                                          _unembed_key(cfg)),
                         x, _dense_mesh(cfg, mesh, False))


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
               device: torch.device, mesh=None) -> Dict:
    """The empty cache of B rows and ``cache_len`` slots; on a mesh this
    rank's shards of it (``cache_shardings``), each made at its own
    size."""
    if mesh is not None:
        return local_cache(init_cache(cfg, B, cache_len, "meta"), mesh, B,
                           device)
    # per-row positions from the start (see decode)
    out: Dict[str, Any] = {"pos": torch.zeros((B,), dtype=torch.int32,
                                              device=device)}
    for _, ckey, c, n in _stacks(cfg):
        one = _layer_cache(c, B, cache_len, device)
        out[ckey] = tree_map(lambda a: a.expand((n,) + a.shape).clone(), one)
    return out


# ---------------------------------------------------------------- prefill


def _layer_prefill(cfg, x, pl, chunk, cache_len=None, mesh=None, seq=None):
    h = apply_norm(cfg, pl["norm1"], x)
    if cfg.family == "hybrid":
        h, sq = _hybrid_seq(cfg, pl, h, mesh, seq)
        a, ca = attn.attn_prefill(cfg, pl["attn"], h, cache_len, mesh, sq)
        s, cs = ssm_mod.ssm_prefill(cfg, pl["ssm"], h, chunk, mesh, sq)
        mix, new_c = _hybrid_mix(pl, a, s), {"attn": ca, "ssm": cs}
    elif cfg.has_ssm:
        mix, cs = ssm_mod.ssm_prefill(cfg, pl["ssm"], h, chunk, mesh, seq)
        new_c = {"ssm": cs}
    else:
        mix, ca = attn.attn_prefill(cfg, pl["attn"], h, cache_len, mesh, seq)
        new_c = {"attn": ca}
    return _ffn_residual(cfg, pl, x + mix, mesh, seq), new_c


def _stack(trees):
    """Per-layer caches (a list of equal nested dicts) -> one nested dict
    of stacked ``(L, ...)`` leaves."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            cache_len: int, mesh=None) -> Tuple[torch.Tensor, Dict]:
    """Process the prompt; returns (logits for last position, cache of
    ``cache_len`` slots).  On a mesh: this rank's rows of tokens, its
    block of the logits and its shard of the cache."""
    B, S = tokens.shape
    seq = "rows" if splits_sequence(cfg, mesh, S) else None
    dims = zero3_dims(cfg, mesh)
    x = _embed(cfg, _gather_top(params, dims, mesh, "embedding"), tokens,
               mesh, seq)
    chunk = _ssd_chunk(cfg, S)
    cache: Dict[str, Any] = {
        "pos": torch.full((B,), S, dtype=torch.int32, device=tokens.device)}
    for key, ckey, c, _ in _stacks(cfg):
        stack = _gather_stack(params, dims, mesh, key)
        per_layer = []
        for l in range(_n_layers(stack)):
            pl = _gather_layer(_layer(stack, l), dims, mesh, key)
            x, lc = _layer_prefill(c, x, pl, chunk, cache_len, mesh, seq)
            per_layer.append(lc)
        cache[ckey] = _stack(per_layer)
    x = x[:, -1:, :]
    if seq:
        # the last position is the last model rank's last row
        x = _gather_rows(x, mesh)[:, -1:, :]
    params = _gather_top(params, dims, mesh, "final_norm", _unembed_key(cfg))
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed_apply(cfg, params, x), cache


# ----------------------------------------------------------------- decode


def _layer_decode(cfg, x, pl, cl, pos, mesh=None, cache_len=None):
    h = apply_norm(cfg, pl["norm1"], x)
    if cfg.family == "hybrid":
        a, _ = attn.attn_decode(cfg, pl["attn"], h, cl["attn"], pos, mesh)
        s, _ = ssm_mod.ssm_decode(cfg, pl["ssm"], h, cl["ssm"], mesh)
        mix = _hybrid_mix(pl, a, s)
    elif cfg.has_ssm:
        mix, _ = ssm_mod.ssm_decode(cfg, pl["ssm"], h, cl["ssm"], mesh)
    else:
        mix, _ = attn.attn_decode(cfg, pl["attn"], h, cl["attn"], pos, mesh,
                                  cache_len)
    return _ffn_residual(cfg, pl, x + mix, mesh)


def decode(cfg: ModelConfig, params: Dict, cache: Dict, tokens: torch.Tensor,
           mesh=None, cache_len=None) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  tokens: (B, 1) -> (logits (B, 1, Vp), new cache).

    ``cache['pos']`` may be a scalar (every row at the same depth) or a
    per-row (B,) vector (continuous batching); it is normalized to (B,)
    here so attention layers always see per-row positions.

    The stacked cache tensors are updated in place, layer slice by layer
    slice (the JAX engine donates the cache to this step); the returned
    dict holds the same tensors and the advanced positions.  On a mesh:
    this rank's rows, its block of the logits and its shard of the cache
    (``cache_len``, the cache's slots, is read by MLA's layers only)."""
    B = tokens.shape[0]
    pos = torch.as_tensor(cache["pos"], dtype=torch.int32,
                          device=tokens.device).expand(B)
    dims = zero3_dims(cfg, mesh)
    x = _embed(cfg, _gather_top(params, dims, mesh, "embedding"), tokens,
               mesh)
    out: Dict[str, Any] = {"pos": pos + 1}
    for key, ckey, c, _ in _stacks(cfg):
        stack = _gather_stack(params, dims, mesh, key)
        for l in range(_n_layers(stack)):
            pl = _gather_layer(_layer(stack, l), dims, mesh, key)
            x = _layer_decode(c, x, pl, _layer(cache[ckey], l), pos, mesh,
                              cache_len)
        out[ckey] = cache[ckey]
    params = _gather_top(params, dims, mesh, "final_norm", _unembed_key(cfg))
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed_apply(cfg, params, x), out
