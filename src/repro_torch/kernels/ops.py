"""Entry points the model code calls for its kernels.

``mha`` (FlashAttention) and ``ssd`` (the Mamba-2 SSD chunk scan).  The
fused GEMM-epilogue entries of the JAX package's ``ops`` come with their
kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .flash_attention import flash_attention
from .ssd import ssd_scan

__all__ = ["mha", "ssd", "flash_attention", "ssd_scan"]


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


def ssd(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, *, chunk: Optional[int] = None,
        use_kernel: bool = False) -> torch.Tensor:
    """Mamba-2 SSD chunk scan: the kernel, else the chunked reference when
    a chunk is given, else the sequential recurrence."""
    if use_kernel:
        return ssd_scan(xdt, dA, B, C, chunk)
    if chunk:
        return ref.ssd_chunked_ref(xdt, dA, B, C, chunk=chunk)
    return ref.ssd_ref(xdt, dA, B, C)
