"""The parameter layout of a decoder configuration and the seeded weights.

The benchmark makes the weights itself, from ``--seed``, on the device and
in the configuration's dtype, one call a leaf, and hands the same tensors
to the program and to the reference.  The layout (names, shapes, stacked
``(L, ...)`` layer leaves) is the one the program takes; the draws are
normal with a std of 1/sqrt(fan in) (fan in: the second-to-last dim),
norm scales and the SSM's ``D`` ones, biases and ``A_log``/``dt_bias``
zeros.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

# (shape, init, scale, dtype key) a leaf; dtype "model" is the config's
Spec = Tuple[Tuple[int, ...], str, float, str]


def dims(cfg: Dict) -> Dict[str, int]:
    """The sizes the layout and the reference derive from a config."""
    d, H = cfg["d_model"], cfg["n_heads"]
    out = {"d": d, "H": H, "Hkv": cfg["n_kv_heads"],
           "hd": cfg.get("head_dim") or d // H, "L": cfg["n_layers"],
           "V": cfg["vocab_size"],
           "Vp": -(-cfg["vocab_size"] // cfg.get("vocab_pad", 128))
           * cfg.get("vocab_pad", 128)}
    if cfg.get("ssm_state"):
        di = cfg["ssm_expand"] * d
        out.update(di=di, ng=cfg["ssm_ngroups"], ns=cfg["ssm_state"],
                   hp=cfg["ssm_headdim"], nh=di // cfg["ssm_headdim"],
                   K=cfg["conv_kernel"],
                   cd=di + 2 * cfg["ssm_ngroups"] * cfg["ssm_state"])
    return out


def param_specs(cfg: Dict) -> Dict:
    """Nested dict of :data:`Spec` leaves, in the program's key order."""
    z = dims(cfg)
    d, L, hd, H, Hkv = z["d"], z["L"], z["hd"], z["H"], z["Hkv"]
    layer: Dict = {"norm1": {"scale": ((L, d), "ones", 1.0, "model")}}
    if cfg.get("attn_type", "gqa") != "none":
        layer["attn"] = {
            "wq": ((L, d, H * hd), "normal", 1.0, "model"),
            "wk": ((L, d, Hkv * hd), "normal", 1.0, "model"),
            "wv": ((L, d, Hkv * hd), "normal", 1.0, "model"),
            "wo": ((L, H * hd, d), "normal", 1.0, "model")}
    if cfg.get("ssm_state"):
        di, cd, nh = z["di"], z["cd"], z["nh"]
        layer["ssm"] = {
            "in_proj": ((L, d, 2 * di + 2 * z["ng"] * z["ns"] + nh),
                        "normal", 1.0, "model"),
            "conv_w": ((L, z["K"], cd), "normal", 1.0, "model"),
            "conv_b": ((L, cd), "zeros", 1.0, "model"),
            "A_log": ((L, nh), "zeros", 1.0, "float32"),
            "dt_bias": ((L, nh), "zeros", 1.0, "float32"),
            "D": ((L, nh), "ones", 1.0, "float32"),
            "norm_scale": ((L, di), "ones", 1.0, "model"),
            "out_proj": ((L, di, d), "normal", 1.0, "model")}
        if "attn" in layer:          # the hybrid's parallel heads
            layer["alpha_attn"] = ((L, d), "ones", 1.0, "model")
            layer["alpha_ssm"] = ((L, d), "ones", 1.0, "model")
    if cfg["d_ff"]:
        f = cfg["d_ff"]
        layer["norm2"] = {"scale": ((L, d), "ones", 1.0, "model")}
        layer["mlp"] = {"wi": ((L, d, f), "normal", 1.0, "model"),
                        "wg": ((L, d, f), "normal", 1.0, "model"),
                        "wo": ((L, f, d), "normal", 1.0, "model")}
    return {"embedding": ((z["Vp"], d), "normal", 1.0, "model"),
            "unembed": ((d, z["Vp"]), "normal", 1.0, "model"),
            "layers": layer,
            "final_norm": {"scale": ((d,), "ones", 1.0, "model")}}


def leaves(tree, path=()):
    """(key path, leaf) pairs of a nested dict, in key order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    else:
        yield path, tree


def build(tree_paths, make):
    """A nested dict holding ``make(path)`` at each of ``tree_paths``."""
    out: Dict = {}
    for path in tree_paths:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = make(path)
    return out


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def make_weights(cfg: Dict, seed: int, device) -> Dict:
    """The seeded weights of ``cfg``: a ``torch.Generator`` on ``device``
    seeded with ``seed``, one draw a leaf in key order, in the leaf's
    dtype."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model_dt = getattr(torch, cfg["dtype"])
    specs = dict(leaves(param_specs(cfg)))

    def make(path):
        shape, init, scale, dt = specs[path]
        dtype = model_dt if dt == "model" else getattr(torch, dt)
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=device)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=device)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        out = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        return out.mul_(scale / math.sqrt(max(1, fan_in)))
    return build(specs, make)


def leaf_names(cfg: Dict):
    """Every leaf's dotted name, in key order."""
    return [".".join(p) for p, _ in leaves(param_specs(cfg))]


SKETCH = 8     # random directions a leaf's gradient is projected on, where
#                the mix sets no `directions` of its own


def blocks_of(path, shape):
    """(blocks, block shape) a leaf is cut into: its layers where
    stacked, else one."""
    if path[0] == "layers":
        return shape[0], tuple(shape[1:])
    return 1, tuple(shape)


def direction(seed: int, leaf: int, block: int, k: int, shape, device
              ) -> torch.Tensor:
    """The ``k``-th random direction (standard normal, float32) of a block
    of leaf number ``leaf``: the same on every process that asks."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1000003 + leaf * 4099 + block * 131 + k)
                    % (2 ** 63))
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)
