"""Parameter specs: one source of truth for shapes, dtypes, logical axes
and initializers.  Parameters are plain nested dicts of tensors with the
JAX package's nesting and names; stacked per-layer leaves keep their
leading ``(L, ...)`` axis.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["ParamSpec", "init_tree", "count_params", "torch_dtype",
           "tree_map", "tree_leaves"]


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]       # logical axis names, len == ndim
    init: str = "normal"                  # normal | zeros | ones | small_normal
    scale: float = 1.0                    # stddev multiplier for normal init
    dtype: str = "bfloat16"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` / ``ParamSpec.dtype`` string -> torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def tree_map(fn, tree):
    """Map ``fn`` over the leaves of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree):
    """Leaves of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def _init_one(spec: ParamSpec, gen: torch.Generator,
              device: torch.device) -> torch.Tensor:
    dt = torch_dtype(spec.dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = spec.scale / math.sqrt(max(1, fan_in))
    out = torch.empty(spec.shape, dtype=dt, device=device)
    # stacked leaves are drawn one layer slice at a time: the f32 draw of a
    # whole (L, d, f) leaf would be L times larger than the leaf's slice
    # (9 GB for glm4-9b's MLP)
    slices = [out] if spec.axes[0] != "layer" else list(out)
    for s in slices:
        s.copy_(torch.randn(s.shape, generator=gen, device=device,
                            dtype=torch.float32) * std)
    return out


def init_tree(specs, gen: torch.Generator):
    """Initialize a nested dict of tensors from a nested dict of ParamSpecs,
    on the generator's device."""
    device = gen.device
    return tree_map(lambda s: _init_one(s, gen, device), specs)


def count_params(specs) -> int:
    return int(sum(int(np.prod(s.shape)) for s in tree_leaves(specs)))
