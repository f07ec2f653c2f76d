"""Entry points the model code calls for its kernels.

Only ``mha`` so far: the other entries of the JAX package's ``ops`` come
with their kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .flash_attention import flash_attention

__all__ = ["mha", "flash_attention"]


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, scale: Optional[float] = None,
        window: Optional[int] = None, use_kernel: bool = False
        ) -> torch.Tensor:
    """Multi-head attention (GQA): the FlashAttention kernel or the plain
    reference."""
    if use_kernel:
        return flash_attention(q, k, v, causal, scale, window)
    return ref.attention_ref(q, k, v, causal=causal, scale=scale,
                             window=window)
